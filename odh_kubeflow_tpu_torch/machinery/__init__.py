"""The control plane's API machinery (the port's copy of the JAX
package's ``machinery/``): the embedded apiserver, object helpers,
events, RBAC and the kubelet simulator."""

from odh_kubeflow_tpu_torch.machinery.store import (  # noqa: F401
    APIServer,
    Conflict,
    Denied,
    NotFound,
    AlreadyExists,
    Invalid,
)
