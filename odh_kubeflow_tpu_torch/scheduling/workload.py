"""Workload derivation: StatefulSet shape → gang Workload object (the
port's copy of the JAX package's ``scheduling/workload.py``).

A Workload is the unit of admission — the whole gang, never a pod. It
is derived from the exact StatefulSet the notebook controller generates
(replicas == nodes, per-node ``nvidia.com/gpu`` limits, accelerator +
GPU-count nodeSelector), so admission and placement always agree with
what the workload controller will actually create. Its spec keys are
the JAX package's renamed: ``hosts`` → ``nodes``, ``chipsPerHost`` →
``gpusPerNode``, ``chips`` → ``gpus``, ``topology`` →
``acceleratorCount`` (the GPUs a node of the pool holds).
"""

from __future__ import annotations

from typing import Any, Optional

from odh_kubeflow_tpu_torch.apis import (
    GPU_ACCEL_NODE_LABEL,
    GPU_COUNT_NODE_LABEL,
    pod_spec_gpus,
)
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import NotFound
from odh_kubeflow_tpu_torch.scheduling import (
    PRIORITY_CLASS_ANNOTATION,
    STATE_ADMITTED,
    WORKLOAD_API_VERSION,
    WORKLOAD_LABEL,
)

Obj = dict[str, Any]


def resolve_priority(api: Any, notebook: Obj) -> tuple[int, str, bool]:
    """PriorityClass semantics (scheduling.k8s.io/v1): the Notebook's
    ``PRIORITY_CLASS_ANNOTATION`` names a cluster-scoped PriorityClass
    whose integer ``value`` orders the queue. No annotation → the
    cluster's ``globalDefault`` class if one exists, else 0. Returns
    ``(priority, class_name, resolved)`` — an unknown class name comes
    back as (0, name, False) so the caller can surface the warning
    without a second lookup."""
    name = obj_util.annotations_of(notebook).get(PRIORITY_CLASS_ANNOTATION, "")
    if not name:
        try:
            for pc in api.list("PriorityClass"):
                if pc.get("globalDefault"):
                    return int(pc.get("value", 0)), obj_util.name_of(pc), True
        except NotFound:
            pass
        return 0, "", True
    try:
        pc = api.get("PriorityClass", name)
    except NotFound:
        return 0, name, False
    return int(pc.get("value", 0)), name, True


def workload_from_statefulset(
    sts: Obj,
    *,
    priority: int = 0,
    priority_class: str = "",
    preferred_pool: str = "",
) -> Optional[Obj]:
    """Derive the gang Workload from a generated StatefulSet: node
    count from replicas, GPUs per node from the container's
    ``nvidia.com/gpu`` limit, the accelerator/count selector from the
    pod template's nodeSelector. Returns None when the shape is not a
    GPU gang (no accelerator selector or no GPU limit) or the
    StatefulSet is scaled to zero (stopped — nothing to admit)."""
    pod_spec = (
        obj_util.get_path(sts, "spec", "template", "spec", default={}) or {}
    )
    selector = pod_spec.get("nodeSelector") or {}
    accel = selector.get(GPU_ACCEL_NODE_LABEL, "")
    node_gpus = selector.get(GPU_COUNT_NODE_LABEL, "")
    gpus_per_node = int(pod_spec_gpus(pod_spec))
    nodes = int(obj_util.get_path(sts, "spec", "replicas", default=0) or 0)
    if not accel or gpus_per_node <= 0 or nodes <= 0:
        return None
    name = obj_util.name_of(sts)
    spec: Obj = {
        "nodes": nodes,
        "gpusPerNode": gpus_per_node,
        "gpus": nodes * gpus_per_node,
        "acceleratorType": accel,
        "acceleratorCount": node_gpus,
        "priority": priority,
        "priorityClassName": priority_class,
        # the quota pool this workload draws from — one per profile
        # namespace, matching kf-resource-quota's scope
        "queue": obj_util.namespace_of(sts),
    }
    if preferred_pool:
        # warm-pool claim placement hint: land on the pool the claimed
        # standby just freed
        spec["preferredPool"] = preferred_pool
    return {
        "apiVersion": WORKLOAD_API_VERSION,
        "kind": "Workload",
        "metadata": {
            "name": name,
            "namespace": obj_util.namespace_of(sts),
            "labels": {WORKLOAD_LABEL: name},
        },
        "spec": spec,
    }


# -- status accessors (the scheduler and every integration read these) ------


def state_of(wl: Obj) -> str:
    return obj_util.get_path(wl, "status", "state", default="") or ""


def is_admitted(wl: Obj) -> bool:
    return state_of(wl) == STATE_ADMITTED


def assigned_nodes(wl: Obj) -> list[str]:
    return list(
        obj_util.get_path(wl, "status", "assignment", "nodes", default=[]) or []
    )


def nodes_of(wl: Obj) -> int:
    return int(obj_util.get_path(wl, "spec", "nodes", default=0) or 0)


def gpus_per_node_of(wl: Obj) -> int:
    return int(obj_util.get_path(wl, "spec", "gpusPerNode", default=0) or 0)


def gpus_of(wl: Obj) -> int:
    return int(obj_util.get_path(wl, "spec", "gpus", default=0) or 0)


def priority_of(wl: Obj) -> int:
    return int(obj_util.get_path(wl, "spec", "priority", default=0) or 0)


def admitted_reservations(api: Any) -> dict[str, dict[str, Any]]:
    """The scheduler's whole reservation picture, re-derived from the
    store alone: per queue, the admitted workload names, committed GPU
    count, and assigned nodes (everything lives in Workload status)."""
    out: dict[str, dict[str, Any]] = {}
    for wl in api.list("Workload"):  # cold path: recovery audit, not reconcile
        if not is_admitted(wl):
            continue
        queue = (
            obj_util.get_path(wl, "spec", "queue", default="") or ""
        )
        bucket = out.setdefault(
            queue, {"workloads": [], "gpus": 0, "nodes": []}
        )
        key = f"{obj_util.namespace_of(wl)}/{obj_util.name_of(wl)}"
        bucket["workloads"].append(key)
        bucket["gpus"] += gpus_of(wl)
        bucket["nodes"].extend(assigned_nodes(wl))
    for bucket in out.values():
        bucket["workloads"].sort()
        bucket["nodes"].sort()
    return out
