"""The platform's controllers (the port's copy of the JAX package's
``controllers/``): the runtime, and the notebook, profile, culler and
kfam logic on GPU node pools."""

from odh_kubeflow_tpu_torch.controllers.runtime import (  # noqa: F401
    Controller,
    Manager,
    Request,
    Result,
)
