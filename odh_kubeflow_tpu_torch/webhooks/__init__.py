from odh_kubeflow_tpu_torch.webhooks.poddefault import (  # noqa: F401
    PodDefaultWebhook,
    gpu_runtime_poddefault,
)
from odh_kubeflow_tpu_torch.webhooks.notebook import NotebookWebhook  # noqa: F401
