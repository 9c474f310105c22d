"""``python -m odh_kubeflow_tpu_torch.analysis`` — run graftlint over the
package (or given paths) and exit non-zero on findings."""

import sys

from odh_kubeflow_tpu_torch.analysis.graftlint import main

if __name__ == "__main__":
    sys.exit(main())
