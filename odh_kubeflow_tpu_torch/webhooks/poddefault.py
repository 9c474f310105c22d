"""PodDefault mutating webhook: merge pod-level defaults into new Pods (the
port's copy of the JAX package's ``webhooks/poddefault.py``).

Reference parity (components/admission-webhook/main.go): selector filter
:70-95, mutatePods :470-574, exclusion annotation :496-504, merge
semantics — env :153-188 (conflict on same-name-different-value),
envFrom :190-198, volumeMounts by name AND mountPath :202-253, volumes
:257-296, tolerations :300-339, labels/annotations :343-364,
command/args only-if-unset + istio-proxy skip :453-468.

GPU addition: ``gpu_runtime_poddefault()`` builds the platform's
built-in PodDefault that injects the GPU runtime contract into any pod
labelled ``gpu-runtime=enabled`` (the counterpart of the JAX package's
``tpu_runtime_poddefault``): the JWA stamps the label on GPU notebooks,
and admission delivers the env instead of every image baking it in."""

from __future__ import annotations

from typing import Any, Optional

from odh_kubeflow_tpu_torch.apis import GPU_RUNTIME_LABEL
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import (
    AdmissionRequest,
    APIServer,
    Denied,
)
from odh_kubeflow_tpu_torch.ops._build import KERNEL_CACHE_ENV

Obj = dict[str, Any]

EXCLUDE_ANNOTATION = "poddefaults.admission.kubeflow.org/exclude"
APPLIED_ANNOTATION_PREFIX = "poddefaults.admission.kubeflow.org/poddefault-"

# where the kernels' nvcc builds live on the workspace volume
KERNEL_CACHE_DIR = "/home/jovyan/.cache/torch_kernels"


# env a container's own entry keeps over a PodDefault's: the kernels'
# build directory. The notebook controller sets it on the container when
# the platform mounts the compile cache (``compile_cache_mount``); the
# GPU-runtime PodDefault's value is the default for a pod without one.
# (JAX's webhook refuses the pod when its TPU-runtime PodDefault and the
# compile-cache mount both set JAX_COMPILATION_CACHE_DIR.)
CONTAINER_WINS_ENV = frozenset({KERNEL_CACHE_ENV})


class MergeConflict(Denied):
    pass


def _merge_env(existing: list[Obj], extra: list[Obj], source: str) -> list[Obj]:
    by_name = {e.get("name"): e for e in existing}
    out = list(existing)
    for env in extra:
        name = env.get("name")
        if name in by_name:
            if by_name[name] != env and name not in CONTAINER_WINS_ENV:
                raise MergeConflict(
                    f"PodDefault {source}: env {name!r} conflicts with an "
                    "existing, non-identical entry"
                )
            continue
        out.append(obj_util.deepcopy(env))
    return out


def _merge_named(
    existing: list[Obj], extra: list[Obj], source: str, what: str
) -> list[Obj]:
    by_name = {v.get("name"): v for v in existing}
    out = list(existing)
    for item in extra:
        name = item.get("name")
        if name in by_name:
            if by_name[name] != item:
                raise MergeConflict(
                    f"PodDefault {source}: {what} {name!r} conflicts with an "
                    "existing, non-identical entry"
                )
            continue
        out.append(obj_util.deepcopy(item))
    return out


def _merge_volume_mounts(
    existing: list[Obj], extra: list[Obj], source: str
) -> list[Obj]:
    # conflict key: name AND mountPath (main.go:202-253)
    seen = {(m.get("name"), m.get("mountPath")): m for m in existing}
    by_name = {m.get("name"): m for m in existing}
    by_path = {m.get("mountPath"): m for m in existing}
    out = list(existing)
    for mount in extra:
        key = (mount.get("name"), mount.get("mountPath"))
        if key in seen:
            if seen[key] != mount:
                raise MergeConflict(
                    f"PodDefault {source}: volumeMount {key} conflicts"
                )
            continue
        if mount.get("name") in by_name or mount.get("mountPath") in by_path:
            raise MergeConflict(
                f"PodDefault {source}: volumeMount "
                f"{mount.get('name')}@{mount.get('mountPath')} collides with "
                "an existing mount"
            )
        out.append(obj_util.deepcopy(mount))
    return out


def _merge_tolerations(existing: list[Obj], extra: list[Obj]) -> list[Obj]:
    out = list(existing)
    for tol in extra:
        if tol not in out:
            out.append(obj_util.deepcopy(tol))
    return out


def _merge_maps(dst: Obj, extra: Obj, source: str, what: str) -> None:
    for k, v in (extra or {}).items():
        if k in dst and dst[k] != v:
            raise MergeConflict(
                f"PodDefault {source}: {what} {k!r} conflicts "
                f"({dst[k]!r} != {v!r})"
            )
        dst[k] = v


class PodDefaultWebhook:
    """Register with the APIServer admission chain for kind Pod."""

    def __init__(self, api: APIServer):
        self.api = api

    def register(self) -> None:
        self.api.register_admission_hook(
            {"Pod"}, self.mutate, mutating=True, name="poddefault-webhook"
        )

    # -- selection ----------------------------------------------------------

    def _matching_poddefaults(self, pod: Obj) -> list[Obj]:
        ns = obj_util.namespace_of(pod)
        if not ns:
            return []
        labels = obj_util.labels_of(pod)
        out = []
        for pd in self.api.list("PodDefault", namespace=ns):
            selector = (pd.get("spec") or {}).get("selector")
            if obj_util.match_label_selector(selector, labels):
                out.append(pd)
        return sorted(out, key=obj_util.name_of)

    # -- mutation -----------------------------------------------------------

    def mutate(self, req: AdmissionRequest) -> Optional[Obj]:
        if req.operation != "CREATE":
            return None
        pod = req.obj
        ann = obj_util.annotations_of(pod)
        # protocol-ok: user-set opt-out; no package writer
        if ann.get(EXCLUDE_ANNOTATION) == "true":
            return None
        defaults = self._matching_poddefaults(pod)
        if not defaults:
            return None
        for pd in defaults:
            self._apply(pod, pd)
            obj_util.set_annotation(
                pod,
                # protocol-ok: applied-PodDefault audit trail for operators
                APPLIED_ANNOTATION_PREFIX + obj_util.name_of(pd),
                (pd.get("spec") or {}).get("desc", obj_util.name_of(pd)),
            )
        return pod

    def _apply(self, pod: Obj, pd: Obj) -> None:
        spec = pd.get("spec") or {}
        name = obj_util.name_of(pd)
        pod_spec = pod.setdefault("spec", {})

        _merge_maps(
            obj_util.meta(pod).setdefault("labels", {}),
            spec.get("labels") or {},
            name,
            "label",
        )
        _merge_maps(
            obj_util.meta(pod).setdefault("annotations", {}),
            spec.get("annotations") or {},
            name,
            "annotation",
        )
        if spec.get("serviceAccountName"):
            pod_spec["serviceAccountName"] = spec["serviceAccountName"]
        if spec.get("automountServiceAccountToken") is not None:
            pod_spec["automountServiceAccountToken"] = spec[
                "automountServiceAccountToken"
            ]
        if spec.get("volumes"):
            pod_spec["volumes"] = _merge_named(
                pod_spec.get("volumes") or [], spec["volumes"], name, "volume"
            )
        if spec.get("tolerations"):
            pod_spec["tolerations"] = _merge_tolerations(
                pod_spec.get("tolerations") or [], spec["tolerations"]
            )

        for container in pod_spec.get("containers") or []:
            # never mutate the service-mesh sidecar (main.go:453-468)
            if container.get("name") == "istio-proxy":
                continue
            if spec.get("env"):
                container["env"] = _merge_env(
                    container.get("env") or [], spec["env"], name
                )
            if spec.get("envFrom"):
                container["envFrom"] = _merge_named(
                    container.get("envFrom") or [],
                    spec["envFrom"],
                    name,
                    "envFrom",
                )
            if spec.get("volumeMounts"):
                container["volumeMounts"] = _merge_volume_mounts(
                    container.get("volumeMounts") or [], spec["volumeMounts"], name
                )
            # command/args: only if the container doesn't set its own
            if spec.get("command") and not container.get("command"):
                container["command"] = list(spec["command"])
            if spec.get("args") and not container.get("args"):
                container["args"] = list(spec["args"])



# ---------------------------------------------------------------------------
# built-in GPU runtime PodDefault


def gpu_runtime_poddefault(namespace: str) -> Obj:
    """The platform-provided PodDefault injecting the GPU runtime
    contract. Pods opt in with the ``gpu-runtime: enabled`` label — the
    JWA spawner sets it when a GPU type is selected.

    Row by row against the TPU-runtime PodDefault (README.md has the
    table): a row stays only where the port, PyTorch or CUDA reads it.
    ``JAX_PLATFORMS`` has no counterpart (the port's entry points default
    to the card); the libtpu log levels become PyTorch's C++ log level,
    ``TF_CPP_MIN_LOG_LEVEL`` goes (no TensorFlow); the ICI buffer size
    and the XLA flag go (NCCL sizes its own buffers, nothing compiles
    through XLA); ``JAX_COORDINATOR_PORT`` stays (``utils/distributed.py``
    reads it); the XLA compilation cache on the workspace volume becomes
    the kernels' build directory there, with no minimum-compile-time row
    (every nvcc build is kept); ``/dev/shm`` stays (NCCL and DataLoader
    workers use it)."""
    return {
        "apiVersion": "kubeflow.org/v1alpha1",
        "kind": "PodDefault",
        "metadata": {"name": "gpu-runtime", "namespace": namespace},
        "spec": {
            "desc": "GPU runtime (PyTorch/NCCL env, kernel cache on the workspace)",
            "selector": {"matchLabels": {GPU_RUNTIME_LABEL: "enabled"}},
            "env": [
                {"name": "TORCH_CPP_LOG_LEVEL", "value": "ERROR"},
                # utils/distributed.py's rendezvous port
                {"name": "JAX_COORDINATOR_PORT", "value": "8476"},
                # the kernels' nvcc builds on the workspace volume:
                # survive stop/cull/restart cycles, so a re-spawned
                # notebook's first request builds nothing
                {"name": KERNEL_CACHE_ENV, "value": KERNEL_CACHE_DIR},
            ],
            "volumes": [
                {"name": "dshm", "emptyDir": {"medium": "Memory"}},
            ],
            "volumeMounts": [
                {"name": "dshm", "mountPath": "/dev/shm"},
            ],
        },
    }
