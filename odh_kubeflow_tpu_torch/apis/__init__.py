"""CRD schemas for the notebook platform on GPU node pools (the port's
copy of the JAX package's ``apis/__init__.py``).

Mirrors the reference's API groups:
- ``Notebook``    kubeflow.org/v1beta1, namespaced
- ``Profile``     kubeflow.org/v1, cluster-scoped
- ``Tensorboard`` tensorboard.kubeflow.org/v1alpha1, namespaced
- ``PodDefault``  kubeflow.org/v1alpha1, namespaced

Objects are dict-shaped; this package contributes registration,
validation (as validating-admission hooks), and typed builders.

The JAX package schedules Cloud TPU slices; the port schedules NVIDIA
GPU node pools. ``ACCELERATOR_MAPPING`` below is the one table of what
each TPU-side name became (README.md documents it).
"""

from odh_kubeflow_tpu_torch.machinery.store import APIServer, Denied, Invalid  # noqa: F401

GROUP = "kubeflow.org"

NOTEBOOK_API_VERSION = f"{GROUP}/v1beta1"
PROFILE_API_VERSION = f"{GROUP}/v1"
TENSORBOARD_API_VERSION = f"tensorboard.{GROUP}/v1alpha1"
PODDEFAULT_API_VERSION = f"{GROUP}/v1alpha1"

# annotations shared across controllers (reference: culler.go:40-41,
# notebook_controller.go:420-422, jwa patch.py:18-75)
STOP_ANNOTATION = "kubeflow-resource-stopped"
LAST_ACTIVITY_ANNOTATION = "notebooks.kubeflow.org/last-activity"
LAST_ACTIVITY_CHECK_ANNOTATION = (
    "notebooks.kubeflow.org/last_activity_check_timestamp"
)

# suspend-to-checkpoint contract (sessions/): SUSPENDED_AT alongside
# STOP_ANNOTATION means "suspended, resumable" — the session manager
# checkpoints kernel state before the GPUs are released, and the JWA
# offers resume instead of a cold start. RESUME_REQUESTED stamps when
# the user reopened, feeding the warm-resume latency histogram.
SUSPENDED_AT_ANNOTATION = "notebooks.kubeflow.org/suspended-at"
SUSPEND_REASON_ANNOTATION = "notebooks.kubeflow.org/suspend-reason"
RESUME_REQUESTED_ANNOTATION = "notebooks.kubeflow.org/resume-requested-at"

# audit trail for duty-cycle-aware culling: the GPU duty sample the
# culler observed last (value + probe timestamp), stamped every probe so
# a cull/keep decision is explainable after the fact
GPU_DUTY_CYCLE_ANNOTATION = "notebooks.kubeflow.org/last-observed-duty-cycle"

# GPU scheduling contract (the counterpart of the JAX package's TPU one)
GPU_RESOURCE = "nvidia.com/gpu"
GPU_ACCELERATOR_ANNOTATION = "notebooks.kubeflow.org/gpu-accelerator"
GPU_COUNT_ANNOTATION = "notebooks.kubeflow.org/gpu-count"
# node labels of a GPU node pool: the GKE accelerator type
# (``nvidia-h100-80gb``) and the GPUs each node of the pool holds
GPU_ACCEL_NODE_LABEL = "cloud.google.com/gke-accelerator"
GPU_COUNT_NODE_LABEL = "cloud.google.com/gke-accelerator-count"
# the env the notebook controller injects into a GPU pod: every GPU of
# the pod's limit visible to the container, and the worker identity that
# ``utils/distributed.py`` reads to start one NCCL process per GPU
# (TPU_WORKER_HOSTNAMES, TPU_WORKER_ID, JAX_COORDINATOR_ADDRESS: the
# platform's names, kept as they are)
GPU_VISIBLE_ENV = "NVIDIA_VISIBLE_DEVICES"
GPU_NODES_ENV = "NUM_GPU_NODES"
# pod-label opt-in for the GPU-runtime PodDefault (webhooks/poddefault
# injects the runtime env into pods carrying it; the JWA stamps it on
# GPU notebooks)
GPU_RUNTIME_LABEL = "gpu-runtime"

# The accelerator mapping: each TPU-side name of the JAX package's
# platform → its GPU counterpart here. Values of the request change
# form as well: a (TPU type, topology) pair becomes a (GKE accelerator,
# GPU count) pair, and a multi-host slice's hosts become
# ``ceil(gpus / gpus_per_node)`` StatefulSet replicas
# (``utils/gpu.py``). The libtpu/XLA env becomes NVIDIA_VISIBLE_DEVICES
# beside the same worker-identity env, and the TPU-runtime PodDefault's
# rows become the GPU-runtime PodDefault's (README.md).
ACCELERATOR_MAPPING: dict[str, str] = {
    "google.com/tpu": GPU_RESOURCE,
    "requests.google.com/tpu": f"requests.{GPU_RESOURCE}",
    "notebooks.kubeflow.org/tpu-accelerator": GPU_ACCELERATOR_ANNOTATION,
    "notebooks.kubeflow.org/tpu-topology": GPU_COUNT_ANNOTATION,
    "cloud.google.com/gke-tpu-accelerator": GPU_ACCEL_NODE_LABEL,
    "cloud.google.com/gke-tpu-topology": GPU_COUNT_NODE_LABEL,
    "NUM_TPU_HOSTS": GPU_NODES_ENV,
    "tpu-runtime": GPU_RUNTIME_LABEL,
    "http-tpu-activity": "http-gpu-activity",
    "/api/tpu/activity": "/api/gpu/activity",
}


def notebook_agent_url(
    notebook, cluster_domain: str = "cluster.local", port: int = 8890
) -> str:
    """Base URL of the in-pod agent sidecar family behind the notebook
    Service (the gpu-activity probe, the session snapshot/restore
    hooks) — ONE
    addressing convention, shared by the culler and the session
    manager so the two can't drift."""
    from odh_kubeflow_tpu_torch.machinery import objects as obj_util

    name = obj_util.name_of(notebook)
    ns = obj_util.namespace_of(notebook)
    return f"http://{name}.{ns}.svc.{cluster_domain}:{port}"


def pod_spec_gpus(pod_spec) -> float:
    """Summed ``nvidia.com/gpu`` container limits of a pod spec — THE
    GPU-accounting primitive (kubelet ledger, quota, workload derivation
    all count the same way; the counterpart of ``pod_spec_tpu_chips``)."""
    from odh_kubeflow_tpu_torch.machinery import objects as obj_util

    total = 0.0
    for c in (pod_spec or {}).get("containers") or []:
        limits = obj_util.get_path(c, "resources", "limits", default={}) or {}
        total += obj_util.parse_quantity(limits.get(GPU_RESOURCE, 0))
    return total


def pod_gpus(pod) -> float:
    return pod_spec_gpus((pod or {}).get("spec"))


def _validate_notebook(req):
    if req.operation not in ("CREATE", "UPDATE"):
        return
    spec = req.obj.get("spec") or {}
    template = spec.get("template") or {}
    containers = (template.get("spec") or {}).get("containers")
    if not containers:
        raise Invalid("Notebook spec.template.spec.containers must be non-empty")


def _validate_profile(req):
    if req.operation not in ("CREATE", "UPDATE"):
        return
    owner = (req.obj.get("spec") or {}).get("owner") or {}
    if not owner.get("name"):
        raise Invalid("Profile spec.owner.name is required")


def _validate_tensorboard(req):
    if req.operation not in ("CREATE", "UPDATE"):
        return
    if not (req.obj.get("spec") or {}).get("logspath"):
        raise Invalid("Tensorboard spec.logspath is required")


def install_default_cluster_roles(api: APIServer) -> None:
    """The kubeflow-admin/edit/view ClusterRoles every profile
    RoleBinding references (the reference ships these via manifests;
    kfam maps its role names onto them, bindings.go:39-46). Idempotent."""
    kf_groups = [
        "kubeflow.org",
        "tensorboard.kubeflow.org",
        # sessions/: users see their own suspend/resume checkpoints
        "sessions.kubeflow.org",
        # warmup/: warm pools + compile-cache entries are visible so
        # the spawner can explain a warm (or cold) handout
        "warmup.kubeflow.org",
    ]
    kf_resources = [
        "notebooks",
        "poddefaults",
        "tensorboards",
        "profiles",
        "sessioncheckpoints",
        "warmpools",
        "compilecacheentries",
    ]
    core_resources = [
        "persistentvolumeclaims",
        "pods",
        "pods/log",
        "services",
        "events",
        "configmaps",
        "nodes",
        # the spawner shows used/hard GPUs from kf-resource-quota
        "resourcequotas",
    ]
    # secrets deliberately excluded from view (upstream view roles do the
    # same: a read-only observer must not hold credentials)
    roles = {
        "kubeflow-admin": [
            {"apiGroups": kf_groups + [""],
             "resources": kf_resources + core_resources + ["secrets"],
             "verbs": ["*"]},
        ],
        "kubeflow-edit": [
            {"apiGroups": kf_groups, "resources": kf_resources, "verbs": ["*"]},
            {"apiGroups": [""], "resources": core_resources + ["secrets"],
             "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"]},
        ],
        "kubeflow-view": [
            {"apiGroups": kf_groups + [""], "resources": kf_resources + core_resources,
             "verbs": ["get", "list", "watch"]},
        ],
    }
    for name, rules in roles.items():
        api.create_or_get(
            {
                "apiVersion": "rbac.authorization.k8s.io/v1",
                "kind": "ClusterRole",
                "metadata": {"name": name},
                "rules": rules,
            }
        )


def register_crds(api: APIServer) -> None:
    api.register_kind(NOTEBOOK_API_VERSION, "Notebook", "notebooks", True)
    api.register_kind(PROFILE_API_VERSION, "Profile", "profiles", False)
    api.register_kind(TENSORBOARD_API_VERSION, "Tensorboard", "tensorboards", True)
    api.register_kind(PODDEFAULT_API_VERSION, "PodDefault", "poddefaults", True)
    api.register_admission_hook(
        {"Notebook"}, _validate_notebook, mutating=False, name="validate-notebook"
    )
    api.register_admission_hook(
        {"Profile"}, _validate_profile, mutating=False, name="validate-profile"
    )
    api.register_admission_hook(
        {"Tensorboard"},
        _validate_tensorboard,
        mutating=False,
        name="validate-tensorboard",
    )
