"""The control plane's API machinery (the port's copy of the JAX
package's ``machinery/``): the embedded apiserver and its write-ahead
log, object helpers, events, RBAC, the kubelet simulator, fault
injection and the GPU-second usage meter."""

from odh_kubeflow_tpu_torch.machinery.store import (  # noqa: F401
    APIServer,
    Conflict,
    Denied,
    NotFound,
    AlreadyExists,
    Invalid,
)
