"""Suspend-to-checkpoint sessions: the ``SessionCheckpoint`` kind and its
pure helpers (the port's copy of the JAX package's
``sessions/__init__.py``).

A ``SessionCheckpoint`` records one notebook's durable kernel snapshot:
where it lives, its digest and size, and the suspend/resume state
machine (``Suspending → Suspended → Resuming → Restored``). The quota
pools (``scheduling/queue.py``) read the committed-session ledger here:
a suspended session holds a checkpoint, not GPUs, so a pool with an
oversubscription factor may commit more sessions than its quota.

The spec keys are the JAX package's renamed as the Workload's are:
``chips`` → ``gpus``, ``topology`` → ``acceleratorCount``
(``checkpoint_chips`` → ``checkpoint_gpus``). The ``SessionManager``,
which takes the snapshots and drives the state machine, is in
``sessions/manager.py``; the checkpoint byte store in
``sessions/checkpoint.py``.
"""

from __future__ import annotations

from typing import Any, Optional

from odh_kubeflow_tpu_torch.apis import SUSPENDED_AT_ANNOTATION
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import NotFound

Obj = dict[str, Any]

GROUP = "sessions.kubeflow.org"
SESSION_API_VERSION = f"{GROUP}/v1alpha1"

NOTEBOOK_UID_LABEL = f"{GROUP}/notebook-uid"

# SessionCheckpoint status.phase state machine
PHASE_SUSPENDING = "Suspending"
PHASE_SUSPENDED = "Suspended"
PHASE_RESUMING = "Resuming"
PHASE_RESTORED = "Restored"


def register_sessions(api: Any) -> None:
    """Register the SessionCheckpoint kind on an APIServer-shaped api
    (embedded store or RemoteAPIServer)."""
    api.register_kind(
        SESSION_API_VERSION, "SessionCheckpoint", "sessioncheckpoints", True
    )


def checkpoint_of(api: Any, notebook: Obj) -> Optional[Obj]:
    """The notebook's SessionCheckpoint (named after it), or None when
    it has none — or the sessions kind isn't registered at all.

    The checkpoint rides the notebook NAME, but a deleted-and-recreated
    notebook reuses the name with a fresh uid — the ``notebook-uid``
    label stamped at checkpoint creation fences a leftover checkpoint
    out of the new notebook's resume path."""
    try:
        ckpt = api.get(
            "SessionCheckpoint",
            obj_util.name_of(notebook),
            obj_util.namespace_of(notebook),
        )
    except NotFound:
        return None
    want = obj_util.meta(notebook).get("uid", "")
    have = obj_util.labels_of(ckpt).get(NOTEBOOK_UID_LABEL, "")
    if want and have and want != have:
        return None
    return ckpt


def checkpoint_durable(ckpt: Optional[Obj], suspended_at: str) -> bool:
    """Whether ``ckpt`` holds the snapshot for THIS suspend epoch
    (``suspended_at`` is the annotation value — a re-suspend stamps a
    new timestamp and needs a fresh snapshot)."""
    if ckpt is None:
        return False
    status = ckpt.get("status") or {}
    return (
        status.get("phase") == PHASE_SUSPENDED
        and status.get("suspendedAt") == suspended_at
    )


def suspend_pending(
    api: Any,
    notebook: Obj,
    grace_seconds: float = 600.0,
    now: Optional[float] = None,
) -> bool:
    """True while a requested suspend still needs its snapshot taken —
    the notebook controller holds the scale-down (pods stay up, the
    Workload keeps its reservation) until this turns false.

    ``grace_seconds`` is the wedge-breaker: if no session manager
    completes the checkpoint within the grace window (missing deploy,
    snapshot endpoint dead), the suspend degrades to a plain stop —
    losing state is better than leaking a node pool's GPUs forever."""
    suspended_at = obj_util.annotations_of(notebook).get(
        SUSPENDED_AT_ANNOTATION
    )
    if not suspended_at:
        return False
    if checkpoint_durable(checkpoint_of(api, notebook), suspended_at):
        return False
    if grace_seconds is not None:
        import time

        now = time.time() if now is None else now
        if now - obj_util.parse_rfc3339(suspended_at) > grace_seconds:
            return False
    return True


def committed_checkpoints(api: Any, namespace: Optional[str] = None) -> list[Obj]:
    """THE committed-session ledger: SessionCheckpoints whose GPUs are
    committed to the pool but not occupying inventory — phase
    ``Suspended`` or ``Resuming``, EXCLUDING any whose Workload is
    currently Admitted (those GPUs live in the active charge; counting
    the checkpoint too would double-book them). Shared by admission
    (``scheduling/queue.py``), the JWA quota block, and the dashboard
    occupancy panel so the three surfaces cannot drift."""
    try:
        rows = api.list("SessionCheckpoint", namespace=namespace)  # uncached-ok: committed-ledger snapshot over a small kind
    except NotFound:  # sessions subsystem not installed
        return []
    out = []
    for ck in rows:
        if obj_util.get_path(ck, "status", "phase", default="") not in (
            PHASE_SUSPENDED,
            PHASE_RESUMING,
        ):
            continue
        try:
            wl = api.get(
                "Workload", obj_util.name_of(ck), obj_util.namespace_of(ck)
            )
            if (
                obj_util.get_path(wl, "status", "state", default="")
                == "Admitted"
            ):
                continue
        except NotFound:
            pass
        out.append(ck)
    return out


def checkpoint_gpus(ckpt: Obj) -> int:
    return int(obj_util.get_path(ckpt, "spec", "gpus", default=0) or 0)


def checkpoint_spec_of(notebook: Obj, accel: str = "") -> tuple[int, str, str]:
    """(GPUs, accelerator type, GPUs a node) of the notebook's GPU
    request — a SessionCheckpoint's spec (the JAX package's chips,
    accelerator type and topology). Without a valid request: no GPUs,
    ``accel`` and its node shape (a warm pool's template), or empty."""
    from odh_kubeflow_tpu_torch.controllers.notebook import gpu_request_of
    from odh_kubeflow_tpu_torch.utils.gpu import GPU_ACCELERATORS

    try:
        gpu = gpu_request_of(notebook)
    except ValueError:
        gpu = None
    if gpu is not None:
        return gpu.gpus, gpu.accelerator_type, str(gpu.node_gpus)
    known = GPU_ACCELERATORS.get(accel)
    return 0, accel, str(known.gpus_per_node) if known else ""


def new_checkpoint(notebook: Obj, gpus: int, accel: str, accel_count: str) -> Obj:
    """A fresh SessionCheckpoint shell for ``notebook`` (the manager
    fills status as the state machine advances). Not owner-referenced:
    the manager GCs it explicitly so it can also delete the stored
    bytes (cascade would drop the object before the UID is read)."""
    return {
        "apiVersion": SESSION_API_VERSION,
        "kind": "SessionCheckpoint",
        "metadata": {
            "name": obj_util.name_of(notebook),
            "namespace": obj_util.namespace_of(notebook),
            "labels": {
                NOTEBOOK_UID_LABEL: obj_util.meta(notebook).get("uid", "")
            },
        },
        "spec": {
            "notebook": obj_util.name_of(notebook),
            "notebookUID": obj_util.meta(notebook).get("uid", ""),
            "gpus": int(gpus),
            "acceleratorType": accel,
            "acceleratorCount": accel_count,
        },
    }
