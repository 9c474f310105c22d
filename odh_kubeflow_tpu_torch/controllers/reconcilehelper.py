"""Create-or-update helpers with field-copy semantics (the port's copy of
the JAX package's ``controllers/reconcilehelper.py``).

Parity with the reference's common/reconcilehelper/util.go:18-219:
create if missing; otherwise copy only the fields a controller owns
(labels, annotations, replicas, pod template / spec) so server-managed
fields (clusterIP, status) survive, and only write when something
changed (level-triggered idempotence)."""

from __future__ import annotations

from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.machinery import backoff, objects as obj_util
from odh_kubeflow_tpu_torch.machinery.objects import FrozenObjectError, mutable
from odh_kubeflow_tpu_torch.machinery.store import APIServer, Conflict, NotFound

Obj = dict[str, Any]


def _copy_meta(dst: Obj, src: Obj) -> bool:
    changed = False
    for field in ("labels", "annotations"):
        want = obj_util.meta(src).get(field) or {}
        have = obj_util.meta(dst).get(field) or {}
        if want != have:
            obj_util.meta(dst)[field] = dict(want)
            changed = True
    return changed


def copy_statefulset_fields(desired: Obj, current: Obj) -> bool:
    changed = _copy_meta(current, desired)
    for path in (("spec", "replicas"), ("spec", "template"), ("spec", "serviceName")):
        want = obj_util.get_path(desired, *path)
        have = obj_util.get_path(current, *path)
        if want != have:
            cur = current
            for p in path[:-1]:
                cur = cur.setdefault(p, {})
            cur[path[-1]] = want
            changed = True
    return changed


def copy_deployment_fields(desired: Obj, current: Obj) -> bool:
    return copy_statefulset_fields(desired, current)


def copy_service_fields(desired: Obj, current: Obj) -> bool:
    """Service: keep clusterIP (server-assigned), copy ports/selector."""
    changed = _copy_meta(current, desired)
    want_spec = dict(desired.get("spec") or {})
    have_spec = current.setdefault("spec", {})
    if "clusterIP" in have_spec:
        want_spec["clusterIP"] = have_spec["clusterIP"]
    if want_spec != have_spec:
        current["spec"] = want_spec
        changed = True
    return changed


def copy_spec_wholesale(desired: Obj, current: Obj) -> bool:
    changed = _copy_meta(current, desired)
    if desired.get("spec") != current.get("spec"):
        current["spec"] = obj_util.deepcopy(desired.get("spec") or {})
        changed = True
    return changed


_COPIERS: dict[str, Callable[[Obj, Obj], bool]] = {
    "StatefulSet": copy_statefulset_fields,
    "Deployment": copy_deployment_fields,
    "Service": copy_service_fields,
}


def update_status_level_triggered(api: APIServer, obj: Obj) -> Optional[Obj]:
    """Level-triggered status-mirror write: a Conflict means the
    object moved under us — the conflicting write's own watch event
    re-enqueues the key and the next reconcile mirrors from fresh
    state, so retrying the stale resourceVersion in place cannot land
    and the Conflict is absorbed (``None`` returned) instead of
    surfacing as a reconcile error. On success the in-hand object's
    resourceVersion is refreshed for follow-up status writes in the
    same reconcile, and the updated object is returned."""
    try:
        updated = api.update_status(obj)
    except Conflict:
        return None
    obj["metadata"]["resourceVersion"] = updated["metadata"]["resourceVersion"]
    return updated


def _reconcile_attempt(
    api: APIServer, desired: Obj, copier: Callable[[Obj, Obj], bool]
) -> tuple[Obj, bool]:
    """One full create-or-update pass: read fresh, copy owned fields,
    write. A Conflict re-runs the WHOLE pass (fresh read included) via
    the retry wrapper in :func:`reconcile_object` — retrying just the
    write would re-send the stale resourceVersion forever."""
    kind = desired.get("kind", "")
    meta = desired.get("metadata", {})
    try:
        current = api.get(kind, meta.get("name", ""), meta.get("namespace"))
    except NotFound:
        return api.create(desired), True
    # copy-on-write against the shared cache: run the copier on the
    # (possibly frozen) cached object; the steady state — nothing
    # to change — completes with ZERO copies. Only when the copier
    # actually needs to write does the frozen object raise, and we
    # retry on a private mutable copy.
    try:
        changed = copier(desired, current)
    except FrozenObjectError:
        current = mutable(current)
        changed = copier(desired, current)
    if changed:
        return api.update(current), False
    return current, False


def reconcile_object(
    api: APIServer,
    desired: Obj,
    owner: Optional[Obj] = None,
    copier: Optional[Callable[[Obj, Obj], bool]] = None,
) -> tuple[Obj, bool]:
    """Create ``desired`` (with controller ownerReference) or update the
    existing object using the kind-appropriate field copier. Conflicts
    re-run the read-merge-write through ``machinery.backoff`` (jittered
    exponential delays, capped attempts). Returns
    ``(object, created)`` — the flag lets callers count/emit on first
    materialisation without a pre-flight existence GET."""
    if owner is not None:
        obj_util.set_controller_reference(desired, owner)
    copier = copier or _COPIERS.get(desired.get("kind", ""), copy_spec_wholesale)
    return backoff.retry(
        lambda: _reconcile_attempt(api, desired, copier),
        retryable=Conflict,
        attempts=4,
        base=0.01,
        cap=0.5,
    )
