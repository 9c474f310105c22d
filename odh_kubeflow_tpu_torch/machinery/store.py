"""In-memory Kubernetes-compatible API server (the port's copy of the JAX
package's ``machinery/store.py``, the part the conformance path runs).

The embedded apiserver the controllers are tested against. It keeps the
API-machinery semantics the controllers rely on:

- typed registration (apiVersion/kind/plural, namespaced or cluster)
- CRUD with uid / resourceVersion / generation / creationTimestamp
- optimistic concurrency (Conflict on stale resourceVersion)
- finalizers + deletionTimestamp two-phase delete
- ownerReference cascade deletion (foreground, synchronous)
- label-selector list filtering
- watch streams (queue-backed, per-watcher, a slow consumer closed with
  410 past a bounded backlog)
- admission chain: mutating + validating hooks run on create/update
- status subresource (update_status does not bump generation)
- Events with dedupe and a bounded retention per namespace

Every mutation applies inline under one re-entrant lock and reaches
every watcher synchronously (read-your-writes). The JAX module's
durability and scale machinery is not ported here: the write-ahead log
and its group-commit pipeline, snapshots and recovery, fencing tokens,
the replication feed, sharded watch dispatch, kube-style pagination
(``list_chunk``), watch resume from a resourceVersion (the watch cache)
and request deadlines (ROADMAP.md lists them). A CREATE made inside a
traced request stamps the trace id on the object
(``utils/tracing.TRACE_ANNOTATION``), so the reconciles it triggers
join the request's trace.
"""

from __future__ import annotations

import queue
import threading
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.machinery import backoff, objects as obj_util
from odh_kubeflow_tpu_torch.utils import tracing

Obj = dict[str, Any]


class APIError(Exception):
    code = 500


class NotFound(APIError):
    code = 404


class AlreadyExists(APIError):
    code = 409


class Conflict(APIError):
    code = 409


class Invalid(APIError):
    code = 422


class Denied(APIError):
    """Raised by admission (validating webhook semantics)."""

    code = 403


class Expired(APIError):
    """HTTP 410 Gone: the watch cannot go on — the client must relist
    and watch from the fresh state (kube-apiserver's ``status.reason:
    Expired`` contract)."""

    code = 410


@dataclass
class TypeInfo:
    api_version: str
    kind: str
    plural: str
    namespaced: bool = True


@dataclass
class AdmissionRequest:
    operation: str  # CREATE | UPDATE | DELETE
    obj: Obj
    old_obj: Optional[Obj] = None
    dry_run: bool = False


@dataclass
class _Hook:
    kinds: set[str]
    fn: Callable[[AdmissionRequest], Optional[Obj]]
    mutating: bool = True
    name: str = ""


# Kinds every API surface knows about.
BUILTIN_KINDS: list[tuple[str, str, str, bool]] = [
    ("v1", "Namespace", "namespaces", False),
    ("v1", "Pod", "pods", True),
    ("v1", "Service", "services", True),
    ("v1", "ServiceAccount", "serviceaccounts", True),
    ("v1", "Secret", "secrets", True),
    ("v1", "ConfigMap", "configmaps", True),
    ("v1", "PersistentVolumeClaim", "persistentvolumeclaims", True),
    ("v1", "Event", "events", True),
    ("v1", "Node", "nodes", False),
    ("v1", "ResourceQuota", "resourcequotas", True),
    ("apps/v1", "StatefulSet", "statefulsets", True),
    ("apps/v1", "Deployment", "deployments", True),
    ("rbac.authorization.k8s.io/v1", "Role", "roles", True),
    ("rbac.authorization.k8s.io/v1", "RoleBinding", "rolebindings", True),
    ("rbac.authorization.k8s.io/v1", "ClusterRole", "clusterroles", False),
    ("rbac.authorization.k8s.io/v1", "ClusterRoleBinding", "clusterrolebindings", False),
    ("networking.k8s.io/v1", "NetworkPolicy", "networkpolicies", True),
    ("networking.istio.io/v1beta1", "VirtualService", "virtualservices", True),
    ("security.istio.io/v1beta1", "AuthorizationPolicy", "authorizationpolicies", True),
    ("gateway.networking.k8s.io/v1", "HTTPRoute", "httproutes", True),
    (
        "admissionregistration.k8s.io/v1",
        "MutatingWebhookConfiguration",
        "mutatingwebhookconfigurations",
        False,
    ),
    ("coordination.k8s.io/v1", "Lease", "leases", True),
    ("scheduling.k8s.io/v1", "PriorityClass", "priorityclasses", False),
]


class Watch:
    """A stream of (event_type, obj) with a bounded drain queue.

    ``maxsize`` bounds the undrained event backlog (kube "too old"
    semantics): a consumer that falls more than ``maxsize`` events
    behind is CLOSED with 410 Expired (``evicted = True``, ``ended =
    True``, ``error`` set) instead of growing server memory without
    bound; the consumer relists. 0 disables."""

    def __init__(
        self,
        server: "APIServer",
        kind: str,
        namespace: Optional[str],
        maxsize: int = 0,
    ):
        self._q: "queue.Queue[Optional[tuple[str, Obj]]]" = queue.Queue()
        self._server = server
        self.kind = kind
        self.namespace = namespace
        self.maxsize = maxsize
        self._stopped = False
        self.ended = False
        self.evicted = False
        self.error: Optional[Exception] = None

    def _enqueue(self, event: tuple[str, Obj]) -> None:
        if self._stopped or self.evicted:
            return
        if self.maxsize and self._q.qsize() >= self.maxsize:
            # slow consumer: close with 410 rather than buffer without
            # bound; the error is set BEFORE the sentinel so the drain
            # sees a dead stream with a reason
            self.evicted = True
            self.error = Expired(
                f"watch consumer fell more than {self.maxsize} events "
                "behind and was evicted; relist and re-watch"
            )
            self.ended = True
            self._q.put(None)
            self._server._evict_watch(self)
            return
        self._q.put(event)

    def stop(self) -> None:
        self._stopped = True
        self._q.put(None)
        self._server._remove_watch(self)

    def get(self, timeout: Optional[float] = None) -> Optional[tuple[str, Obj]]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def try_get(self) -> Optional[tuple[str, Obj]]:
        """Non-blocking ``get``: the next pending event, or None when
        the queue is empty (or the stop sentinel is next)."""
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None


class APIServer:
    # a watch consumer may fall this many live events behind before it
    # is closed with 410
    WATCH_CACHE_SIZE = 2048

    # events per namespace kept after pruning (kube-apiserver expires
    # events by TTL; a bounded ring is the embedded equivalent)
    EVENT_RETENTION = 1000

    def __init__(self):
        self._lock = threading.RLock()
        self.watch_evictions = 0
        self._types: dict[str, TypeInfo] = {}
        self._store: dict[str, dict[tuple[str, str], Obj]] = {}
        # kind → namespace → {key: obj}: the same objects as _store,
        # bucketed so namespaced lists touch only their namespace
        self._ns_buckets: dict[str, dict[str, dict[tuple[str, str], Obj]]] = {}
        self._rv = 0
        self._watches: list[Watch] = []
        self._hooks: list[_Hook] = []
        self._event_index: dict[tuple, str] = {}
        for api_version, kind, plural, namespaced in BUILTIN_KINDS:
            self.register_kind(api_version, kind, plural, namespaced)

    # -- type registry ------------------------------------------------------

    def register_kind(
        self, api_version: str, kind: str, plural: str, namespaced: bool = True
    ) -> None:
        with self._lock:
            self._types[kind] = TypeInfo(api_version, kind, plural, namespaced)
            self._store.setdefault(kind, {})
            self._ns_buckets.setdefault(kind, {})

    def type_info(self, kind: str) -> TypeInfo:
        try:
            return self._types[kind]
        except KeyError:
            raise NotFound(f"kind {kind!r} not registered") from None

    # -- admission ----------------------------------------------------------

    def register_admission_hook(
        self,
        kinds,
        fn: Callable[[AdmissionRequest], Optional[Obj]],
        mutating: bool = True,
        name: str = "",
    ) -> None:
        """Hooks run on CREATE/UPDATE inside the API call, mutating
        first (may return a replacement object), then validating (may
        raise Denied). This is the in-process stand-in for the
        MutatingWebhookConfiguration HTTPS hop."""
        with self._lock:
            self._hooks.append(_Hook(set(kinds), fn, mutating, name))

    def _run_admission(self, req: AdmissionRequest) -> Obj:
        obj = req.obj
        for hook in [h for h in self._hooks if h.mutating]:
            if req.obj.get("kind") in hook.kinds:
                out = hook.fn(
                    AdmissionRequest(req.operation, obj, req.old_obj, req.dry_run)
                )
                if out is not None:
                    obj = out
        for hook in [h for h in self._hooks if not h.mutating]:
            if obj.get("kind") in hook.kinds:
                hook.fn(AdmissionRequest(req.operation, obj, req.old_obj, req.dry_run))
        return obj

    # -- keys ---------------------------------------------------------------

    def _key(self, info: TypeInfo, namespace: Optional[str], name: str):
        if info.namespaced:
            if not namespace:
                raise Invalid(f"{info.kind} is namespaced; namespace required")
            return (namespace, name)
        return ("", name)

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _put(self, kind: str, key: tuple[str, str], obj: Obj) -> None:
        self._store[kind][key] = obj
        self._ns_buckets[kind].setdefault(key[0], {})[key] = obj

    def _drop(self, kind: str, key: tuple[str, str]) -> None:
        self._store[kind].pop(key, None)
        bucket = self._ns_buckets[kind].get(key[0])
        if bucket is not None:
            bucket.pop(key, None)
            if not bucket:
                del self._ns_buckets[kind][key[0]]

    def _apply(self, event_type: str, kind: str, key: tuple[str, str], obj: Obj) -> None:
        """Apply one mutation to the maps and fan out its watch event
        (under the store lock)."""
        if event_type == "DELETED":
            self._drop(kind, key)
        else:
            self._put(kind, key, obj)
        self._notify(event_type, obj)

    # -- CRUD ---------------------------------------------------------------

    def create(self, obj: Obj, dry_run: bool = False) -> Obj:
        kind = obj.get("kind", "")
        info = self.type_info(kind)
        obj = obj_util.deepcopy(obj)
        obj.setdefault("apiVersion", info.api_version)
        meta = obj.setdefault("metadata", {})
        if not meta.get("name") and meta.get("generateName"):
            meta["name"] = meta["generateName"] + uuid.uuid4().hex[:5]
        if not meta.get("name"):
            raise Invalid("metadata.name required")
        with self._lock:
            # admission first: a mutating hook may rewrite name/namespace,
            # and the store key must reflect what admission returns
            obj = self._run_admission(AdmissionRequest("CREATE", obj, None, dry_run))
            meta = obj["metadata"]
            name = meta["name"]
            namespace = meta.get("namespace") if info.namespaced else None
            key = self._key(info, namespace, name)
            if self._store[kind].get(key) is not None:
                raise AlreadyExists(f"{kind} {namespace or ''}/{name} exists")
            if dry_run:
                return obj
            # stamp the creating request's trace id so the async hop to
            # the controller (watch event → reconcile) stays in one
            # trace. CREATE only — updates never rewrite it, so
            # level-triggered no-op detection is untouched. Excluded:
            # Events (they'd re-trace every dedupe lookup) and
            # reconcile-span writes (children a controller creates —
            # reconcilehelper owns their annotations and would strip
            # the stamp on the next pass, churning a write).
            span = tracing.current()
            if span is not None and kind != "Event" and "controller" not in span.attrs:
                ann = meta.get("annotations")
                if not isinstance(ann, dict):
                    ann = meta["annotations"] = {}
                ann.setdefault(tracing.TRACE_ANNOTATION, span.trace_id)
            meta["uid"] = str(uuid.uuid4())
            meta["creationTimestamp"] = obj_util.now_rfc3339()
            meta["generation"] = 1
            meta["resourceVersion"] = self._next_rv()
            self._apply("ADDED", kind, key, obj)
            return obj_util.deepcopy(obj)

    def get(self, kind: str, name: str, namespace: Optional[str] = None) -> Obj:
        info = self.type_info(kind)
        with self._lock:
            key = self._key(info, namespace, name)
            found = self._store[kind].get(key)
            if found is None:
                raise NotFound(f"{kind} {namespace or ''}/{name} not found")
            return obj_util.deepcopy(found)

    @staticmethod
    def _matches(stored: Obj, label_selector, field_matches) -> bool:
        if not obj_util.match_label_selector(
            label_selector, obj_util.labels_of(stored)
        ):
            return False
        return not (field_matches and any(
            obj_util.get_path(stored, *path.split(".")) != want
            for path, want in field_matches.items()
        ))

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
    ) -> list[Obj]:
        info = self.type_info(kind)
        with self._lock:
            if info.namespaced and namespace:
                candidates = list(
                    self._ns_buckets[kind].get(namespace, {}).values()
                )
            else:
                candidates = list(self._store[kind].values())
            return [
                obj_util.deepcopy(stored)
                for stored in candidates
                if self._matches(stored, label_selector, field_matches)
            ]

    def _update_inner(self, obj: Obj, status_only: bool) -> Obj:
        kind = obj.get("kind", "")
        info = self.type_info(kind)
        obj = obj_util.deepcopy(obj)
        meta = obj.get("metadata", {})
        name = meta.get("name", "")
        namespace = meta.get("namespace") if info.namespaced else None
        with self._lock:
            key = self._key(info, namespace, name)
            current = self._store[kind].get(key)
            if current is None:
                raise NotFound(f"{kind} {namespace or ''}/{name} not found")
            sent_rv = meta.get("resourceVersion")
            if sent_rv and sent_rv != current["metadata"]["resourceVersion"]:
                raise Conflict(
                    f"{kind} {name}: resourceVersion {sent_rv} is stale "
                    f"(current {current['metadata']['resourceVersion']})"
                )
            if status_only:
                merged = obj_util.deepcopy(current)
                if "status" in obj or "status" in current:
                    merged["status"] = obj.get("status", {})
                obj = merged
            else:
                # keep server-owned fields
                obj["metadata"]["uid"] = current["metadata"]["uid"]
                obj["metadata"]["creationTimestamp"] = current["metadata"][
                    "creationTimestamp"
                ]
                obj["metadata"]["generation"] = current["metadata"].get(
                    "generation", 1
                )
                if "status" not in obj and "status" in current:
                    obj["status"] = obj_util.deepcopy(current["status"])
                obj = self._run_admission(
                    AdmissionRequest("UPDATE", obj, obj_util.deepcopy(current))
                )
                if obj.get("spec") != current.get("spec"):
                    obj["metadata"]["generation"] = (
                        current["metadata"].get("generation", 1) + 1
                    )

            # no-op writes don't bump rv or emit events (apiserver skips
            # the storage write when nothing changed) — this is what lets
            # level-triggered reconcilers quiesce
            def _cmp_view(o: Obj):
                top = {k: v for k, v in o.items() if k != "metadata"}
                m = {
                    k: v
                    for k, v in o.get("metadata", {}).items()
                    if k != "resourceVersion"
                }
                return top, m

            if _cmp_view(obj) == _cmp_view(current):
                return obj_util.deepcopy(current)
            obj["metadata"]["resourceVersion"] = self._next_rv()
            self._apply("MODIFIED", kind, key, obj)
            # a finalizer removal may release a pending delete
            if obj["metadata"].get("deletionTimestamp") and not obj[
                "metadata"
            ].get("finalizers"):
                self._remove(info, obj)
            return obj_util.deepcopy(obj)

    def update(self, obj: Obj) -> Obj:
        return self._update_inner(obj, status_only=False)

    def update_status(self, obj: Obj) -> Obj:
        return self._update_inner(obj, status_only=True)

    def patch(
        self,
        kind: str,
        name: str,
        patch: Obj,
        namespace: Optional[str] = None,
    ) -> Obj:
        """JSON merge patch as read-merge-write with server-side Conflict
        retries (the kube-apiserver guaranteedUpdate shape)."""

        def attempt() -> Obj:
            current = self.get(kind, name, namespace)
            merged = obj_util.json_merge_patch(current, patch)
            # merge patches cannot move server-owned metadata
            for k in ("uid", "creationTimestamp", "resourceVersion", "generation"):
                if k in current.get("metadata", {}):
                    merged["metadata"][k] = current["metadata"][k]
            return self.update(merged)

        return backoff.retry(
            attempt,
            retryable=lambda e: isinstance(e, Conflict),
            attempts=16,
            base=0.001,
            cap=0.05,
        )

    def delete(self, kind: str, name: str, namespace: Optional[str] = None) -> None:
        with self._lock:
            self._delete_locked(kind, name, namespace)

    def _delete_locked(self, kind: str, name: str, namespace: Optional[str]) -> None:
        info = self.type_info(kind)
        key = self._key(info, namespace, name)
        current = self._store[kind].get(key)
        if current is None:
            raise NotFound(f"{kind} {namespace or ''}/{name} not found")
        if current["metadata"].get("finalizers"):
            if not current["metadata"].get("deletionTimestamp"):
                current = obj_util.deepcopy(current)
                current["metadata"]["deletionTimestamp"] = obj_util.now_rfc3339()
                current["metadata"]["resourceVersion"] = self._next_rv()
                self._apply("MODIFIED", kind, key, current)
            return
        self._remove(info, current)

    def _remove(self, info: TypeInfo, current: Obj) -> None:
        key = self._key(
            info,
            current["metadata"].get("namespace") if info.namespaced else None,
            current["metadata"]["name"],
        )
        # a deletion is a new cluster state: stamp a FRESH rv so the
        # watch cache orders it after the last modification
        current = obj_util.deepcopy(current)
        current["metadata"]["resourceVersion"] = self._next_rv()
        self._apply("DELETED", info.kind, key, current)
        self._cascade(current)

    def _cascade(self, owner: Obj) -> None:
        """Foreground GC: delete dependents referencing the owner uid."""
        owner_uid = owner["metadata"].get("uid")
        if not owner_uid:
            return
        for kind in list(self._store):
            for stored in list(self._store[kind].values()):
                refs = stored["metadata"].get("ownerReferences") or []
                if any(r.get("uid") == owner_uid for r in refs):
                    try:
                        self._delete_locked(
                            kind,
                            stored["metadata"]["name"],
                            stored["metadata"].get("namespace"),
                        )
                    except NotFound:
                        pass

    # -- watches ------------------------------------------------------------

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        send_initial: bool = True,
    ) -> Watch:
        """Open a watch stream: an ADDED event for each current object
        (unless ``send_initial`` is False), then every live event."""
        info = self.type_info(kind)
        with self._lock:
            w = Watch(self, kind, namespace)
            if send_initial:
                # frozen shared replay: watch consumers are readers
                if info.namespaced and namespace:
                    items = self._ns_buckets[kind].get(namespace, {}).values()
                else:
                    items = self._store[kind].values()
                for item in items:
                    w._enqueue(("ADDED", obj_util.freeze(item)))
            # the slow-consumer bound covers the LIVE backlog on top of
            # whatever the initial dump just queued
            w.maxsize = w._q.qsize() + self.WATCH_CACHE_SIZE
            self._watches.append(w)
            return w

    def _remove_watch(self, w: Watch) -> None:
        with self._lock:
            if w in self._watches:
                self._watches.remove(w)

    def _evict_watch(self, w: Watch) -> None:
        """A slow consumer was closed with 410 by its own `_enqueue`;
        deregister it and count the eviction."""
        self._remove_watch(w)
        with self._lock:
            self.watch_evictions += 1

    def _notify(self, event_type: str, obj: Obj) -> None:
        kind = obj.get("kind", "")
        meta = obj.get("metadata", {})
        ns = meta.get("namespace", "")
        # ONE frozen snapshot per event, shared by every watcher: later
        # store mutations cannot leak into delivered events, and a reader
        # that tries to mutate gets FrozenObjectError instead of
        # corruption
        shared = obj_util.freeze(obj)
        for w in list(self._watches):
            if w.kind == kind and (not w.namespace or w.namespace == ns):
                w._enqueue((event_type, shared))

    # -- convenience --------------------------------------------------------

    def create_or_get(self, obj: Obj) -> Obj:
        try:
            return self.create(obj)
        except AlreadyExists:
            meta = obj.get("metadata", {})
            return self.get(obj["kind"], meta["name"], meta.get("namespace"))

    def emit_event(
        self,
        involved: Obj,
        reason: str,
        message: str,
        event_type: str = "Normal",
        component: str = "",
    ) -> Obj:
        """Create a v1 Event pointing at ``involved``. Identical repeat
        emissions — same involved uid/kind/name, reason, message AND
        type — dedupe to the existing Event with no write and no watch
        notification; this is what keeps reconcilers that emit-and-watch
        events from feeding themselves."""
        ns = involved.get("metadata", {}).get("namespace") or "default"
        dedupe_key = (
            ns,
            involved.get("kind", ""),
            obj_util.name_of(involved),
            involved.get("metadata", {}).get("uid", ""),
            reason,
            message,
            event_type,
        )
        with self._lock:
            cached_name = self._event_index.get(dedupe_key)
        if cached_name is not None:
            try:
                return self.get("Event", cached_name, ns)
            except NotFound:
                with self._lock:
                    self._event_index.pop(dedupe_key, None)
        event = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {
                "generateName": f"{obj_util.name_of(involved)}.",
                "namespace": ns,
            },
            "involvedObject": {
                "apiVersion": involved.get("apiVersion", ""),
                "kind": involved.get("kind", ""),
                "name": obj_util.name_of(involved),
                "namespace": ns,
                "uid": involved.get("metadata", {}).get("uid", ""),
            },
            "reason": reason,
            "message": message,
            "type": event_type,
            "source": {"component": component},
            "firstTimestamp": obj_util.now_rfc3339(),
            "lastTimestamp": obj_util.now_rfc3339(),
            "count": 1,
        }
        created = self.create(event)
        with self._lock:
            self._event_index[dedupe_key] = created["metadata"]["name"]
        self._prune_events(ns)
        return created

    def _prune_events(self, namespace: str) -> None:
        with self._lock:
            info = self.type_info("Event")
            bucket = self._ns_buckets["Event"].get(namespace, {})
            names = [
                # resourceVersion is the store's monotonic clock
                (int(obj["metadata"]["resourceVersion"]), name)
                for (_, name), obj in bucket.items()
            ]
            if len(names) <= self.EVENT_RETENTION:
                return
            names.sort()  # oldest first
            drop = names[: len(names) - self.EVENT_RETENTION]
            for _, name in drop:
                key = self._key(info, namespace, name)
                expired = self._store["Event"].get(key)
                if expired is not None:
                    # watchers must see the expiry (DELETED, fresh rv)
                    expired = obj_util.deepcopy(expired)
                    expired["metadata"]["resourceVersion"] = self._next_rv()
                    self._apply("DELETED", "Event", key, expired)
            dead = {name for _, name in drop}
            self._event_index = {
                k: v for k, v in self._event_index.items() if v not in dead
            }
