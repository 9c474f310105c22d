"""The platform's controllers (the port's copy of the JAX package's
``controllers/``): the runtime, and on GPU node pools the notebook,
profile, culler and kfam logic, the tensorboard controller
(``tensorboard.py``: the profiles a notebook captures on the card,
served over their PVC) and the exposure controller (``exposure.py``:
routes, auth materials, network policies and the release of the
notebook webhook's lock)."""

from odh_kubeflow_tpu_torch.controllers.runtime import (  # noqa: F401
    Controller,
    Manager,
    Request,
    Result,
)
