"""Kubernetes EventRecorder with real count/dedup semantics (the port's
copy of the JAX package's ``machinery/events.py``).

client-go's ``record.EventRecorder`` (the reference controllers take
one from the manager: ``mgr.GetEventRecorderFor(...)``) aggregates
repeat emissions of the same (involvedObject uid, reason, message,
type) into ONE Event whose ``count`` climbs and whose
``lastTimestamp`` advances. The embedded store's ``emit_event`` dedupes
to the existing object but never bumps it; this recorder adds the bump
so ``kubectl describe`` shows ``Culled x12 over 3h`` instead of twelve
rows — and so controllers can emit on every reconcile pass without
flooding the store.

Controllers emit state transitions through it (Created / Started /
Culled / FailedCreate and the warning paths, plus the slice
scheduler's admission lifecycle: Queued / Admitted / Preempted /
NodeLost / FailedScheduling-with-reason); watch-driven reconcilers
stay quiescent because a pure re-emission in the same reconcile state
only happens when something re-triggered the reconcile.
"""

from __future__ import annotations

from typing import Any, Optional

from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.cache import list_by_index
from odh_kubeflow_tpu_torch.machinery.store import Conflict, NotFound

Obj = dict[str, Any]


class EventRecorder:
    """Record events against any ``APIServer``-shaped api (embedded or
    remote). One instance per component (its name lands in
    ``source.component``)."""

    def __init__(self, api: Any, component: str = ""):
        self.api = api
        self.component = component
        # (ns, kind, name, uid, reason, message, type) -> event name;
        # a local fast path so the common repeat-emission skips the
        # namespace list scan
        self._index: dict[tuple, str] = {}

    # -- public surface ------------------------------------------------------

    def event(
        self,
        involved: Obj,
        reason: str,
        message: str,
        event_type: str = "Normal",
    ) -> Obj:
        ns = involved.get("metadata", {}).get("namespace") or "default"
        uid = involved.get("metadata", {}).get("uid", "")
        key = (
            ns,
            involved.get("kind", ""),
            obj_util.name_of(involved),
            uid,
            reason,
            message,
            event_type,
        )
        existing = self._find(key, ns)
        if existing is not None:
            return self._bump(existing, ns, key)
        created = self.api.emit_event(
            involved,
            reason,
            message,
            event_type=event_type,
            component=self.component,
        )
        self._index[key] = created["metadata"]["name"]
        return created

    def normal(self, involved: Obj, reason: str, message: str) -> Obj:
        return self.event(involved, reason, message, "Normal")

    def warning(self, involved: Obj, reason: str, message: str) -> Obj:
        return self.event(involved, reason, message, "Warning")

    # -- internals -----------------------------------------------------------

    def _find(self, key: tuple, ns: str) -> Optional[Obj]:
        name = self._index.get(key)
        if name is not None:
            try:
                return self.api.get("Event", name, ns)
            except NotFound:
                self._index.pop(key, None)  # pruned/expired server-side
        _, kind, obj_name, uid, reason, message, event_type = key
        for ev in list_by_index(
            self.api, "Event", "involved", f"{kind}/{obj_name}", namespace=ns
        ):
            io = ev.get("involvedObject") or {}
            if (
                io.get("kind") == kind
                and io.get("name") == obj_name
                and io.get("uid", "") == uid
                and ev.get("reason") == reason
                and ev.get("message") == message
                and ev.get("type") == event_type
            ):
                self._index[key] = ev["metadata"]["name"]
                return ev
        return None

    def _bump(self, event: Obj, ns: str, key: tuple) -> Obj:
        # the event may be a shared frozen cache hit; bump a private copy
        event = obj_util.mutable(event)
        event["count"] = int(event.get("count", 1)) + 1
        event["lastTimestamp"] = obj_util.now_rfc3339()
        try:
            return self.api.update(event)
        except Conflict:
            # another worker bumped it concurrently; their write told
            # the same story
            try:
                return self.api.get("Event", event["metadata"]["name"], ns)
            except NotFound:
                self._index.pop(key, None)
                return event
        except NotFound:
            self._index.pop(key, None)
            return event
