"""The control plane's API machinery (the port's copy of the JAX
package's ``machinery/``): the embedded apiserver and its write-ahead
log, object helpers, events, RBAC, the kubelet simulator, fault
injection, the GPU-second usage meter, the wire (the REST façade on an
event-loop server, its remote client, overload defense and the
``/debug`` pages) and high availability (leader election with fencing,
the informer cache, WAL-shipped read replicas with their promotion
watchdog, the split-process runner)."""

from odh_kubeflow_tpu_torch.machinery.store import (  # noqa: F401
    APIServer,
    Conflict,
    Denied,
    NotFound,
    AlreadyExists,
    Invalid,
)
