"""The control plane's API machinery (the port's copy of the JAX
package's ``machinery/``): the embedded apiserver and its write-ahead
log, object helpers, events, RBAC, the kubelet simulator, fault
injection, the GPU-second usage meter, and the wire: the REST façade on
an event-loop server, its remote client, overload defense and the
``/debug`` pages."""

from odh_kubeflow_tpu_torch.machinery.store import (  # noqa: F401
    APIServer,
    Conflict,
    Denied,
    NotFound,
    AlreadyExists,
    Invalid,
)
