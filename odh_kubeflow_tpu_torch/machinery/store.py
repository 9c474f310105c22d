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

Without a write-ahead log every mutation applies inline under one
re-entrant lock and reaches every watcher synchronously
(read-your-writes). With one (``APIServer(wal=WriteAheadLog(dir))``,
``machinery/wal.py``) the lock serialises mutation PREPARES (validation,
admission, rv assignment); prepared records flow through a group-commit
pipeline: a committer thread covers each batch of concurrent writers
with one fsync, applies in rv order, and releases each waiter only
after the fsync that covers its record (ack-after-durable). A failed
fsync makes the store fail-stop for mutations. Snapshots (every
``SNAPSHOT_INTERVAL`` records or ``SNAPSHOT_BYTES`` of log) are cut
under the lock and written off it; ``APIServer.recover(wal)`` rebuilds
objects, the rv counter, dynamic kind registrations, the Event dedupe
index and the bounded watch cache, from which ``watch(kind,
resource_version=)`` resumes (410 ``Expired`` below the retained
window, never an empty stream). A CREATE made inside a traced request
stamps the trace id on the object (``utils/tracing.TRACE_ANNOTATION``),
so the reconciles it triggers join the request's trace.

Kube-style pagination: ``list_chunk`` serves a page in (namespace,
name) order with an opaque continue token that pins the first page's rv;
a token older than the compacted watch-cache window is 410 ``Expired``.
``Watch.set_notify`` is the event-loop server's wake hook. Under an
ambient request deadline (``machinery/overload.py``) the group-commit
ack wait gives up with 504 ``DeadlineExceeded`` (the record stays
enqueued and may still commit).

Fencing: a mutation made under ``set_fence`` (``machinery/leader.py``
``fenced``, or the façade's ``X-Fencing-Token`` header) is checked
against the named Lease's current ``fencingToken`` under the store lock,
atomically with the apply; a deposed epoch raises ``FencedOut``.
Replication: ``replication_watch`` is the follower feed (every kind, rv
order, dynamic kind registrations as ``REGISTER`` records) and
``replication_cut`` the cold catch-up cut; ``replication_epoch`` is the
epoch the store ships under. Watch delivery: in-process consumers are
enqueued at apply time (read-your-writes); serving-tier streams
(``watch(inline=False)``, replication feeds) are fanned out by
``WATCH_DISPATCH_SHARDS`` dispatcher threads, rendezvous-hashed per
watcher, so a mutation pays one queue put per shard. ``kind_version`` is
the per-kind rv the façade's list-payload cache keys on. The store lock
comes from the lock-order sanitizer's factory (``analysis/sanitizer.py``,
a raw ``RLock`` unless ``GRAFT_SANITIZE=1``), and the commit pipeline and
snapshot cut carry the schedule explorer's yield markers
(``analysis/schedule.py``; no-ops outside an exploration).
"""

from __future__ import annotations

import base64
import contextvars
import datetime
import hashlib
import json
import logging
import os
import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.analysis import sanitizer as _sanitizer
from odh_kubeflow_tpu_torch.analysis import schedule as _schedule
from odh_kubeflow_tpu_torch.machinery import backoff, objects as obj_util, overload, serialize
from odh_kubeflow_tpu_torch.utils import tracing

Obj = dict[str, Any]

log = logging.getLogger("apiserver")

# the calling context's fencing token — set by machinery.leader.fenced()
# around controller work (and by the REST façade from the
# X-Fencing-Token header), validated by the store on every mutation.
# (namespace, lease_name, token) — None means the write is unfenced.
_FENCE: contextvars.ContextVar[Optional[tuple[str, str, int]]] = (
    contextvars.ContextVar("odh_fence", default=None)
)


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


class BadRequest(APIError):
    """Malformed request (e.g. body metadata contradicting the URL —
    kube-apiserver rejects these with 400, not 422)."""

    code = 400


class Denied(APIError):
    """Raised by admission (validating webhook semantics)."""

    code = 403


class Unauthorized(APIError):
    """Missing/invalid credentials (kube's authn 401 — distinct from
    the authz 403)."""

    code = 401


class TooManyRequests(APIError):
    """Server-side load shedding (kube's APF 429). Carries the
    Retry-After hint clients must honour before retrying — unlike the
    other errors, a 429 means the request was never executed, so every
    verb is safe to retry after the wait."""

    code = 429

    def __init__(self, message: str = "", retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = retry_after


class DeadlineExceeded(APIError):
    """HTTP 504: the request's end-to-end deadline
    (``X-Request-Deadline`` / the ``machinery.overload`` contextvar)
    expired before the work completed — the caller already gave up, so
    the server sheds instead of finishing dead work. NOT retryable: the
    time budget is spent. On a mutation path the write may still become
    durable (the group-commit pipeline does not unwind an enqueued
    record) — the ack is what timed out, the kube-apiserver 504
    contract."""

    code = 504


class Expired(APIError):
    """HTTP 410 Gone: the requested resourceVersion has been compacted
    out of the watch cache, or the watch fell too far behind. It cannot
    go on — the client must relist and watch from the fresh state
    (kube-apiserver's ``status.reason: Expired`` contract)."""

    code = 410


class FencedOut(APIError):
    """The write carried a fencing token from a deposed lease epoch; the
    caller must stand down. 403, not 409: an authority failure, not a
    data race."""

    code = 403


class NotLeader(APIError):
    """A mutation was sent to a read replica; the client must retry the
    write against the leader, whose URL rides in ``leader_url`` (the
    REST façade answers with a kube-style 307 + ``Location``)."""

    code = 307

    def __init__(self, message: str = "", leader_url: str = ""):
        super().__init__(message)
        self.leader_url = leader_url


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


@dataclass
class _WalEntry:
    """One mutation in flight through the group-commit pipeline:
    prepared (validated, rv-stamped) under the store lock, made durable
    by the committer thread's batched fsync, applied to the in-memory
    maps in rv order, then acked by releasing ``done``. ``etype`` is the
    watch event type ("register" entries carry no apply)."""

    record: Obj
    etype: str
    kind: str
    key: Optional[tuple[str, str]]
    obj: Optional[Obj]
    rv: int
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[BaseException] = None
    # prepare instant (monotonic): feeds the commit-pipeline ack-latency
    # histogram when store metrics are attached
    prepared_at: float = field(default_factory=time.perf_counter)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


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

_BUILTIN_KIND_NAMES = frozenset(k for _, k, _, _ in BUILTIN_KINDS)


def current_fence() -> Optional[tuple[str, str, int]]:
    """The calling context's ``(namespace, lease_name, token)`` fence,
    or None when the caller is unfenced."""
    return _FENCE.get()


def set_fence(fence: Optional[tuple[str, str, int]]):
    """Install a fence on the calling context; returns the reset token
    for ``contextvars.ContextVar.reset``. Use ``machinery.leader.
    fenced()`` instead of calling this directly."""
    return _FENCE.set(fence)


def reset_fence(token) -> None:
    _FENCE.reset(token)


def encode_continue(payload: Obj) -> str:
    """Opaque kube-style continue token: URL-safe base64 of a JSON
    payload. Clients must treat it as a black box."""
    return base64.urlsafe_b64encode(serialize.dumps(payload)).decode()


def decode_continue(token: str) -> Obj:
    """Inverse of :func:`encode_continue`; raises :class:`BadRequest`
    on garbage (a forged or truncated token is a client error)."""
    try:
        out = json.loads(base64.urlsafe_b64decode(token.encode()).decode())
    except (ValueError, TypeError):
        raise BadRequest(f"malformed continue token {token!r}") from None
    if not isinstance(out, dict):
        raise BadRequest(f"malformed continue token {token!r}")
    return out


def paged_list_all(
    chunk_fn: Callable[..., tuple[list[Obj], str]],
    kind: str,
    page_size: int,
    fallback_fn: Callable[[], list[Obj]],
    restarts: int = 3,
    on_restart: Optional[Callable[[], None]] = None,
) -> list[Obj]:
    """Walk a full collection in ``page_size`` chunks via
    ``chunk_fn(kind, limit=…, continue_token=…)``. A continue token
    that 410s mid-walk restarts the whole walk (``on_restart`` surfaces
    it — a metric, a log); after ``restarts`` failed walks
    ``fallback_fn`` is the last resort."""
    for _ in range(restarts):
        out: list[Obj] = []
        token: Optional[str] = None
        try:
            while True:
                items, token = chunk_fn(kind, limit=page_size, continue_token=token)
                out.extend(items)
                if not token:
                    return out
        except Expired:
            if on_restart is not None:
                on_restart()
    return fallback_fn()


def parse_micro_time(s: str) -> float:
    """RFC3339-micro (kube MicroTime, the Lease spec's format) → epoch
    seconds. Shared with machinery.leader (which writes the format)."""
    return (
        datetime.datetime.strptime(s, "%Y-%m-%dT%H:%M:%S.%fZ")
        .replace(tzinfo=datetime.timezone.utc)
        .timestamp()
    )


class Watch:
    """A stream of (event_type, obj) with a bounded drain queue.

    ``maxsize`` bounds the undrained event backlog (kube "too old"
    semantics): a consumer that falls more than ``maxsize`` events
    behind is CLOSED with 410 Expired (``evicted = True``, ``ended =
    True``, ``error`` set) instead of growing server memory without
    bound; the consumer relists. 0 disables. ``kind`` of ``None`` is the
    replication feed: every kind, every namespace."""

    def __init__(
        self,
        server: "APIServer",
        kind: Optional[str],
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
        self._notify_cb: Optional[Callable[[], None]] = None
        # dispatcher shard index (None = inline delivery at apply time)
        self._shard: Optional[int] = None
        # burst-dispatch scratch flag, touched only by the one
        # dispatcher thread that owns this watch's shard
        self._burst_mark = False

    def set_notify(self, fn: Optional[Callable[[], None]]) -> None:
        """Register a wake callback fired (from the enqueuing thread)
        whenever an event or the end/stop sentinel lands: the event-loop
        server's pump parks on an ``asyncio.Event`` the callback sets via
        ``call_soon_threadsafe`` instead of pinning a thread on a
        blocking ``get``. Fired once on registration so events already
        queued are never missed."""
        self._notify_cb = fn
        if fn is not None:
            self._wake()

    def _wake(self) -> None:
        cb = self._notify_cb
        if cb is not None:
            try:
                cb()
            except RuntimeError:
                pass  # the consumer's event loop is shutting down

    def _enqueue(self, event: tuple[str, Obj], wake: bool = True) -> None:
        """``wake=False`` defers the notify callback: the dispatch shards
        deliver bursts and wake each touched consumer once per burst."""
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
            self._wake()
            self._server._evict_watch(self)
            return
        self._q.put(event)
        if wake:
            self._wake()

    def stop(self) -> None:
        self._stopped = True
        self._q.put(None)
        self._wake()
        self._server._remove_watch(self)

    def get(self, timeout: Optional[float] = None) -> Optional[tuple[str, Obj]]:
        if timeout is None or timeout > 0:
            # a blocking wait on the event queue must never run while
            # holding a store/cache lock (sanitizer probe; no-op when
            # GRAFT_SANITIZE is off)
            _sanitizer.note_blocking("Watch.get")
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


class _WatchShard:
    """One watch-dispatch shard: a FIFO of applied events and the
    dispatcher thread that fans them out to this shard's watchers.
    ``watchers`` is a copy-on-write tuple (replaced under the store
    lock, read lock-free by the dispatcher) so fanout never contends
    with registration."""

    __slots__ = ("q", "thread", "watchers")

    def __init__(self):
        self.q: "queue.Queue[Optional[list]]" = queue.Queue()
        self.thread: Optional[threading.Thread] = None
        self.watchers: tuple[Watch, ...] = ()


def _rendezvous_shard(token: str, shards: int) -> int:
    """Highest-random-weight choice of dispatch shard for a watcher —
    the same rendezvous scheme ``machinery.leader`` uses for namespace
    ownership, so adding a shard moves only 1/K of the watchers."""
    best, best_w = 0, -1
    for i in range(shards):
        w = int.from_bytes(
            hashlib.blake2b(f"{token}|{i}".encode(), digest_size=8).digest(),
            "big",
        )
        if w > best_w:
            best, best_w = i, w
    return best


class APIServer:
    # retained watch-cache window (events, not seconds): a watch may
    # resume from any resourceVersion still inside it; older resumes get
    # 410 Expired, as kube-apiserver's compacted etcd window. A watch
    # consumer may also fall this many live events behind before it is
    # closed with 410. The WATCH_CACHE_SIZE env var overrides it per
    # process.
    WATCH_CACHE_SIZE = 2048

    # events per namespace kept after pruning (kube-apiserver expires
    # events by TTL; a bounded ring is the embedded equivalent)
    EVENT_RETENTION = 1000

    # watch-dispatch shards (K dispatcher threads): serving-tier watches
    # (HTTP streams, replication feeds) are rendezvous-hashed across K
    # dispatcher threads, so a mutation enqueues at most K items instead
    # of one per subscriber. In-process consumers (informer caches,
    # controller tests) stay inline: their synchronous enqueue at apply
    # is what gives read-your-writes through CachedClient.poke. 0 =
    # everything inline. Env: WATCH_DISPATCH_SHARDS.
    WATCH_DISPATCH_SHARDS = 4

    # dispatcher coalescing window (ms): after picking up work, a
    # dispatch shard sleeps this long so one fanout pass covers the
    # whole commit burst. 0 disables. Env: WATCH_DISPATCH_COALESCE_MS.
    WATCH_DISPATCH_COALESCE_MS = 2

    # mutations between WAL snapshots (when a WAL is attached)
    SNAPSHOT_INTERVAL = 1024

    # page size of ``list_chunk`` when the caller gives no limit
    LIST_DEFAULT_LIMIT = 500

    # byte-based snapshot cadence: cut when the WAL tail exceeds this
    # many bytes since the last snapshot, whichever threshold trips
    # first. 0 disables. Env: SNAPSHOT_BYTES.
    SNAPSHOT_BYTES = 0

    # committer linger per drain round (seconds): how long the group
    # committer waits for just-released writers to re-enqueue before
    # fsyncing the batch (postgres commit_delay)
    GROUP_COMMIT_LINGER = 0.0002

    def __init__(
        self,
        wal: Optional[Any] = None,
        snapshot_interval: Optional[int] = None,
        snapshot_bytes: Optional[int] = None,
        group_commit: bool = True,
    ):
        self._lock = _sanitizer.new_rlock("apiserver.store")
        # durability: with a WriteAheadLog attached, every mutation is
        # prepared under the store lock, enqueued to the committer thread
        # which covers whole batches of concurrent writers with ONE fsync,
        # applied in rv order AFTER the covering fsync, and only then
        # acked. No WAL (the default) = the in-memory store, inline.
        self._wal = wal
        self._wal_broken = False
        self._wal_dead: Optional[BaseException] = None
        self._replaying = False
        # group_commit=False pins the committer to one fsync per record
        # (semantics identical, batching off)
        self.group_commit = group_commit
        self._commitq: "queue.Queue[Optional[_WalEntry]]" = queue.Queue()
        self._committer: Optional[threading.Thread] = None
        self._closed = False
        self._batch_hwm = 1  # committer linger target (last batch size)
        # commit-pipeline instruments (attach_metrics): None until a
        # registry is attached, so the bare store pays nothing
        self._m_batch = None
        self._m_ack = None
        self._wal_fsync_seen = 0
        self._evictions_seen = 0
        self._wal_metrics_lock = threading.Lock()
        # records logged-but-not-yet-applied, keyed (kind, key) → newest
        # in-flight entry. Mutation-path validation reads THROUGH this
        # overlay (_effective); public reads serve only applied — i.e.
        # durable — state.
        self._pending: dict[tuple[str, tuple[str, str]], _WalEntry] = {}
        # highest APPLIED record rv (== _rv except while records are in
        # flight through the committer); snapshots are cut at it
        self._applied_rv = 0
        if snapshot_interval is not None:
            self.SNAPSHOT_INTERVAL = int(snapshot_interval)
        if snapshot_bytes is not None:
            self.SNAPSHOT_BYTES = int(snapshot_bytes)
        else:
            self.SNAPSHOT_BYTES = _env_int("SNAPSHOT_BYTES", type(self).SNAPSHOT_BYTES)
        self.WATCH_CACHE_SIZE = _env_int("WATCH_CACHE_SIZE", type(self).WATCH_CACHE_SIZE)
        self.EVENT_RETENTION = _env_int("EVENT_RETENTION", type(self).EVENT_RETENTION)
        self.WATCH_DISPATCH_SHARDS = _env_int(
            "WATCH_DISPATCH_SHARDS", type(self).WATCH_DISPATCH_SHARDS
        )
        self.WATCH_DISPATCH_COALESCE_MS = _env_int(
            "WATCH_DISPATCH_COALESCE_MS", type(self).WATCH_DISPATCH_COALESCE_MS
        )
        # sharded watch dispatch (started lazily on the first
        # dispatcher-delivered watch); _inline_watches is the subset of
        # _watches delivered synchronously at apply time. The delivery
        # buffer batches shard puts across one group-commit apply.
        self._shards: list[_WatchShard] = []
        self._inline_watches: list[Watch] = []
        self._delivery_buffer: Optional[list[tuple]] = None
        self._watch_seq = 0  # stable per-watch shard-hash token
        # slow consumers closed with 410
        self.watch_evictions = 0
        # replication: the epoch this store ships under (a promoted
        # leader's fencing token; 0 = never fenced). Followers reject
        # streams from a lower epoch (FencedOut).
        self.replication_epoch = 0
        # clock for fence-expiry validation; injectable so fake-clock
        # leader-election tests and the store agree on "now"
        self.fence_now_fn: Callable[[], float] = time.time
        self._types: dict[str, TypeInfo] = {}
        self._store: dict[str, dict[tuple[str, str], Obj]] = {}
        # kind → namespace → {key: obj}: the same objects as _store,
        # bucketed so namespaced lists touch only their namespace
        self._ns_buckets: dict[str, dict[str, dict[tuple[str, str], Obj]]] = {}
        self._rv = 0
        # kind → rv of its last mutation (see kind_version): the serving
        # tier's whole-list-payload cache key
        self._kind_rv: dict[str, int] = {}
        self._watches: list[Watch] = []
        self._hooks: list[_Hook] = []
        self._event_index: dict[tuple, str] = {}
        # bounded watch cache: (rv, kind, namespace, etype, frozen obj) —
        # the resume window behind watch(resource_version=…)
        self._event_log: deque[tuple[int, str, str, str, Obj]] = deque()
        # highest rv dropped from the log; resuming BELOW it is Expired
        # (a gap we can no longer fill) — resuming exactly at it is fine:
        # that client saw the newest dropped event
        self._compacted_rv = 0
        for api_version, kind, plural, namespaced in BUILTIN_KINDS:
            self.register_kind(api_version, kind, plural, namespaced)

    # -- type registry ------------------------------------------------------

    def register_kind(
        self, api_version: str, kind: str, plural: str, namespaced: bool = True
    ) -> None:
        entry = None
        with self._lock:
            fresh = kind not in self._types
            self._types[kind] = TypeInfo(api_version, kind, plural, namespaced)
            self._store.setdefault(kind, {})
            self._ns_buckets.setdefault(kind, {})
            # a dynamic registration must also reach follower replicas,
            # or replicated objects of the kind would hit an unknown
            # type on apply — same reason the WAL logs it below
            if fresh and not self._replaying and kind not in _BUILTIN_KIND_NAMES:
                self._deliver_event(
                    "REGISTER",
                    {
                        "apiVersion": api_version,
                        "kind": kind,
                        "plural": plural,
                        "namespaced": namespaced,
                    },
                    kind=None,
                    ns="",
                )
            # dynamic (CRD) registrations must survive a restart or the
            # replay of their objects would hit an unknown kind; builtin
            # kinds re-register from code, so only log the rest
            if (
                fresh
                and self._wal is not None
                and not self._replaying
                and kind not in _BUILTIN_KIND_NAMES
            ):
                entry = self._enqueue_entry(
                    _WalEntry(
                        record={
                            "op": "register",
                            "rv": self._rv,
                            "apiVersion": api_version,
                            "kind": kind,
                            "plural": plural,
                            "namespaced": namespaced,
                        },
                        etype="register",
                        kind=kind,
                        key=None,
                        obj=None,
                        rv=self._rv,
                    )
                )
        self._await(entry)

    def type_info(self, kind: str) -> TypeInfo:
        try:
            return self._types[kind]
        except KeyError:
            raise NotFound(f"kind {kind!r} not registered") from None

    def kind_for_plural(self, plural: str) -> str:
        for kind, info in self._types.items():
            if info.plural == plural:
                return kind
        raise NotFound(f"no kind with plural {plural!r}")

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

    # -- durability (group-commit write-ahead log) ---------------------------

    def _check_wal_alive(self) -> None:
        """Fail fast at prepare time when the WAL can no longer make
        writes durable: fail-stop after an IO failure, CrashPoint replay
        after a simulated process death."""
        from odh_kubeflow_tpu_torch.machinery.wal import CrashPoint

        if self._wal_dead is not None:
            raise CrashPoint(f"process already dead ({self._wal_dead})")
        if self._closed:
            raise APIError("store is closed; mutations rejected")
        if self._wal_broken:
            raise APIError(
                "write-ahead log failed earlier; store is fail-stop for mutations"
            )

    def attach_metrics(self, registry) -> None:
        """Expose the write path's durability pipeline: ``wal_fsync_total``
        (one per group-commit batch), ``wal_group_commit_batch_size``
        (records covered by each fsync) and ``wal_commit_ack_seconds``
        (prepare → durable ack, the latency every writer waits), plus
        ``watch_consumers_evicted_total``. The WAL pipeline metrics are a
        no-op without a WAL."""
        self._m_evicted = registry.counter(
            "watch_consumers_evicted_total",
            "Watch consumers closed with 410 Expired after falling "
            "more than the bounded backlog behind",
        )
        registry.register_collector(self._flush_eviction_counter)
        if self._wal is None:
            return
        self._m_fsync = registry.counter(
            "wal_fsync_total",
            "WAL fsyncs issued (one covers a whole group-commit batch)",
        )
        self._m_batch = registry.histogram(
            "wal_group_commit_batch_size",
            "Records made durable by one group-commit fsync",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
        )
        self._m_ack = registry.histogram(
            "wal_commit_ack_seconds",
            "Commit pipeline latency: mutation prepared to durable ack",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
        )
        registry.register_collector(self._flush_wal_counters)

    def _flush_wal_counters(self):
        wal = self._wal
        if wal is not None:
            with self._wal_metrics_lock:
                n = wal.fsync_total
                delta = n - self._wal_fsync_seen
                if delta > 0:
                    self._m_fsync.inc(by=delta)
                    self._wal_fsync_seen = n
        return ()

    def _flush_eviction_counter(self):
        with self._wal_metrics_lock:
            n = self.watch_evictions
            delta = n - self._evictions_seen
            if delta > 0:
                self._m_evicted.inc(by=delta)
                self._evictions_seen = n
        return ()

    def debug_queues(self) -> Obj:
        """Live pipeline depths for the /debug/queues zpage."""
        with self._lock:
            pending = len(self._pending)
        out: Obj = {
            "groupCommit": {
                "queueDepth": self._commitq.qsize(),
                "pending": pending,
                "batchHighWater": self._batch_hwm,
                "groupCommit": self.group_commit,
                "failStop": self._wal_broken,
            },
            "watchDispatch": {
                "shards": len(self._shards),
                "queueDepths": [s.q.qsize() for s in self._shards],
                "watchersPerShard": [len(s.watchers) for s in self._shards],
                "inlineWatchers": len(self._inline_watches),
                "evictedTotal": self.watch_evictions,
            },
            "wal": None,
        }
        wal = self._wal
        if wal is not None:
            out["wal"] = {
                "fsyncTotal": wal.fsync_total,
                "appendedTotal": wal.appended_total,
                "recordsSinceSnapshot": wal.records_since_snapshot,
                "bytesSinceSnapshot": wal.bytes_since_snapshot,
            }
        return out

    def _enqueue_entry(self, entry: _WalEntry) -> _WalEntry:
        """Hand a prepared entry to the committer (called under the store
        lock, so queue order == rv order)."""
        self._check_wal_alive()
        if self._committer is None:
            self._committer = threading.Thread(
                target=self._committer_loop, name="apiserver-wal-committer", daemon=True
            )
            self._committer.start()
            # under the schedule explorer: wait for the committer to
            # register so the schedulable set is deterministic (no-op
            # in production)
            _schedule.thread_started(self._committer)
        self._commitq.put(entry)
        # explorer yield marker: a prepared-but-unlogged record is in
        # flight; racing writers/committer/snapshot interleave here
        _schedule.sched_point("store.commit.enqueue")
        return entry

    def _commit_mutation(
        self, event_type: str, kind: str, key: tuple[str, str], obj: Obj
    ) -> Optional[_WalEntry]:
        """Commit one prepared mutation (under the store lock). With a WAL
        the record is enqueued to the group committer and the (kind, key)
        marked pending — later prepares see it through ``_effective``,
        public reads do not until it is durable AND applied. Without a
        WAL it applies inline. Returns the entry the caller must
        ``_await`` after releasing the lock (None when applied inline)."""
        try:
            rv = int(obj["metadata"]["resourceVersion"])
        except (KeyError, TypeError, ValueError):
            rv = self._rv
        if self._wal is None or self._replaying:
            self._apply_record(event_type, kind, key, obj, rv)
            return None
        entry = _WalEntry(
            record={"rv": rv, "etype": event_type, "obj": obj},
            etype=event_type,
            kind=kind,
            key=key,
            obj=obj,
            rv=rv,
        )
        # enqueue BEFORE marking pending: a dead/fail-stop/closed store
        # raises here, and a phantom pending entry would make later
        # validations answer for a record that was never durable
        self._enqueue_entry(entry)
        self._pending[(kind, key)] = entry
        return entry

    def _await(self, entry: Optional[_WalEntry]) -> None:
        """Block until the entry's covering fsync + apply completed — the
        ack-after-durable wait. Never called while holding the store lock
        (the committer needs it to apply)."""
        if entry is None:
            return
        if not entry.done.is_set():
            # the ambient request deadline bounds the wait: a caller that
            # already timed out gets 504 instead of parking a handler
            # thread on an ack it will never read (the record stays
            # enqueued and may still commit — see DeadlineExceeded)
            # a durability wait must never run under a store/cache lock
            # (sanitizer probe); schedule.wait_event takes part in an
            # exploration and is a plain Event.wait otherwise
            _sanitizer.note_blocking("wal.commit-wait")
            rem = overload.remaining()
            if rem is None:
                _schedule.wait_event(entry.done)
            elif rem <= 0 or not _schedule.wait_event(entry.done, timeout=rem):
                raise DeadlineExceeded(
                    "deadline expired awaiting the commit ack (the "
                    "write may still become durable)"
                )
        if entry.error is not None:
            raise entry.error

    def _effective(
        self, kind: str, key: tuple[str, str]
    ) -> tuple[Optional[Obj], Optional[_WalEntry]]:
        """The (object, in-flight entry) a mutation-path validation must
        see: the newest pending record for the key when one exists, else
        the applied store state."""
        entry = self._pending.get((kind, key))
        if entry is not None:
            return (None if entry.etype == "DELETED" else entry.obj), entry
        return self._store[kind].get(key), None

    def _iter_effective(self, kind: str) -> list[Obj]:
        """Every live object of ``kind`` through the pending overlay
        (mutation-path scans: cascade deletion)."""
        per_kind = self._store[kind]
        if not self._pending:
            return list(per_kind.values())
        out = []
        for key, obj in per_kind.items():
            entry = self._pending.get((kind, key))
            if entry is None:
                out.append(obj)
            elif entry.etype != "DELETED":
                out.append(entry.obj)
        for (pkind, key), entry in self._pending.items():
            if pkind == kind and key not in per_kind and entry.etype != "DELETED":
                out.append(entry.obj)
        return out

    def _apply_record(
        self, event_type: str, kind: str, key: tuple[str, str], obj: Obj, rv: int
    ) -> None:
        """Apply one durable record to the maps and fan out its watch
        event (under the store lock): inline for the in-memory store, on
        the committer thread (in rv order) for the durable one."""
        if event_type == "DELETED":
            self._drop(kind, key)
        else:
            self._put(kind, key, obj)
        if rv > self._applied_rv:
            self._applied_rv = rv
        self._notify(event_type, obj, rv)

    def _committer_loop(self) -> None:
        """The group committer: drain every queued entry, cover the batch
        with ONE fsync (or one per record when ``group_commit`` is off),
        apply in rv order under the store lock, then release the waiters.
        IO failure is fail-stop for all current and future mutations;
        CrashPoint (the drills' simulated process death) is replayed to
        every waiter."""
        from odh_kubeflow_tpu_torch.machinery.wal import CrashPoint

        while True:
            entry = _schedule.queue_get(self._commitq)
            if entry is None:
                return
            batch = [entry]

            def _drain() -> int:
                n = 0
                while True:
                    try:
                        nxt = self._commitq.get_nowait()
                    except queue.Empty:
                        return n
                    if nxt is None:  # shutdown sentinel: finish batch
                        self._commitq.put(None)
                        return n
                    batch.append(nxt)
                    n += 1

            _drain()
            if self.group_commit:
                # bounded linger: writers just released by the previous
                # batch need a moment to re-prepare; keep absorbing while
                # arrivals continue, up to the last batch's size (a lone
                # serial writer, hwm 1, pays no linger); four empty rounds
                # in a row mean the writers are gone
                empty = 0
                for _ in range(8 + 2 * self._batch_hwm):
                    if len(batch) >= self._batch_hwm:
                        break
                    time.sleep(self.GROUP_COMMIT_LINGER)
                    if _drain():
                        empty = 0
                    else:
                        empty += 1
                        if empty >= 4:
                            break
                self._batch_hwm = len(batch)
            groups = [batch] if self.group_commit else [[e] for e in batch]
            for gi, group in enumerate(groups):
                # explorer yield marker: batch collected, fsync not yet
                # issued — the window racing writers re-enqueue into
                _schedule.sched_point("store.commit.fsync")
                try:
                    with self._wal.io_lock:
                        for e in group:
                            self._wal.write_record(e.record)
                        self._wal.sync()  # graftlint: disable=blocking-reachable-under-lock the group fsync under wal.io IS the commit; only snapshot rotation contends it, and rotation is O(1)
                except BaseException as e:  # noqa: BLE001 — incl. CrashPoint
                    rest = [x for g in groups[gi + 1:] for x in g]
                    self._commit_failed(group + rest, e)
                    return
                # explorer yield marker: durable but not yet applied —
                # the log→fsync→apply→ack ordering's critical window
                _schedule.sched_point("store.commit.apply")
                with self._lock:
                    # buffer sharded watch delivery across the whole batch
                    # apply: one shard put per batch, not per record
                    self._delivery_buffer = []
                    try:
                        for e in group:
                            if e.etype != "register":
                                self._apply_record(e.etype, e.kind, e.key, e.obj, e.rv)
                            if self._pending.get((e.kind, e.key)) is e:
                                del self._pending[(e.kind, e.key)]
                    finally:
                        buffered = self._delivery_buffer
                        self._delivery_buffer = None
                        if buffered:
                            self._flush_delivery(buffered)
                if self._m_batch is not None:
                    self._m_batch.observe(len(group))
                ack_t = time.perf_counter()
                for e in group:
                    if self._m_ack is not None:
                        self._m_ack.observe(max(ack_t - e.prepared_at, 0.0))
                    e.done.set()
            # snapshot cadence at the batch boundary: every record on disk
            # is applied here, so the cut covers the whole log. Waiters
            # were already released — the snapshot delays no ack.
            try:
                self._maybe_snapshot()
            except CrashPoint as e:
                self._commit_failed([], e)
                return

    def _commit_failed(self, entries: list[_WalEntry], exc: BaseException) -> None:
        """Fail every in-flight and queued waiter and stop committing:
        CrashPoint replays the simulated death to each waiter (and to
        every later mutation); any other failure is fail-stop with an
        APIError (the write was never acked)."""
        from odh_kubeflow_tpu_torch.machinery.wal import CrashPoint

        crashed = isinstance(exc, CrashPoint)
        # stop-the-world flag FIRST (under the lock every enqueue also
        # holds): after this no new entry can enter the queue, so the
        # drain below catches every waiter that ever got in
        with self._lock:
            if crashed:
                self._wal_dead = exc
            else:
                self._wal_broken = True
                log.error("WAL append failed; store is now fail-stop: %s", exc)
        while True:
            try:
                queued = self._commitq.get_nowait()
            except queue.Empty:
                break
            if queued is not None:
                entries = entries + [queued]
        with self._lock:
            for e in entries:
                e.error = exc if crashed else APIError(f"write-ahead log append failed: {exc}")
                if self._pending.get((e.kind, e.key)) is e:
                    del self._pending[(e.kind, e.key)]
        for e in entries:
            e.done.set()

    def close(self) -> None:
        """Stop the committer thread and reject later mutations. Joins the
        thread so in-flight batches finish first — a mutation that slipped
        in before close still acks durable; one issued after close raises.
        Flushes nothing: every acked write is already durable."""
        with self._lock:
            self._closed = True
            committer, self._committer = self._committer, None
            shards, self._shards = self._shards, []
        if committer is not None:
            self._commitq.put(None)
            committer.join(timeout=30)
        for shard in shards:
            shard.q.put(None)
        for shard in shards:
            if shard.thread is not None:
                shard.thread.join(timeout=10)

    def _maybe_snapshot(self) -> None:
        """Snapshot cadence check on the committer thread at a batch
        boundary: SNAPSHOT_INTERVAL records or SNAPSHOT_BYTES of WAL tail,
        whichever trips first. A failure is logged and retried after
        another interval: the WAL still holds every acked write."""
        if self._wal is None or self._replaying or self._wal_broken:
            return
        due = (
            self.SNAPSHOT_INTERVAL > 0
            and self._wal.records_since_snapshot >= self.SNAPSHOT_INTERVAL
        ) or (
            self.SNAPSHOT_BYTES > 0
            and self._wal.bytes_since_snapshot >= self.SNAPSHOT_BYTES
        )
        if not due:
            return
        from odh_kubeflow_tpu_torch.machinery.wal import CrashPoint

        try:
            self.snapshot_now()
        except CrashPoint:
            raise
        except Exception as e:  # noqa: BLE001 — disk full, injected fault
            log.warning("snapshot failed (will retry next interval): %s", e)
            self._wal.records_since_snapshot = 0
            self._wal.bytes_since_snapshot = 0

    def _snapshot_cut(self) -> Obj:
        """A consistent cut of the APPLIED store, collected under the lock
        as shallow references — stored objects are never mutated in place
        once written, so the serialization can run OFF the lock."""
        with self._lock:
            return {
                "rv": self._applied_rv,
                "kind_rv": dict(self._kind_rv),
                "compacted_rv": self._compacted_rv,
                "types": [
                    [t.api_version, t.kind, t.plural, t.namespaced]
                    for t in self._types.values()
                    if t.kind not in _BUILTIN_KIND_NAMES
                ],
                "objects": [
                    obj for per_kind in self._store.values() for obj in per_kind.values()
                ],
                # the bounded watch cache rides along so rv resumes keep
                # working across a restart beyond the WAL tail
                "events": [list(e) for e in self._event_log],
            }

    def snapshot_now(self) -> None:
        """Write a full-state snapshot and rotate/GC the WAL. The cut is
        pointer collection under the store lock; the serialization and
        the snapshot-file IO run off it (the WAL's max-rv segment GC keeps
        concurrent appends safe)."""
        if self._wal is None:
            raise APIError("no write-ahead log attached")
        # explorer yield markers around the cut: the snapshot racing
        # the group-commit pipeline is one of the drilled interleavings
        _schedule.sched_point("store.snapshot.cut")
        state = self._snapshot_cut()
        _schedule.sched_point("store.snapshot.persist")
        self._wal.snapshot(state, state["rv"])

    @classmethod
    def recover(
        cls,
        wal: Any,
        snapshot_interval: Optional[int] = None,
        snapshot_bytes: Optional[int] = None,
        group_commit: bool = True,
    ) -> "APIServer":
        """Rebuild a store from its WAL directory: newest snapshot, then
        the WAL tail (records with rv above the snapshot), restoring the
        objects, the rv counter, dynamic kind registrations, the Event
        dedupe index and the bounded watch cache. ``_compacted_rv`` is
        raised to the recovered window's floor so rv resumes below it
        surface 410 Expired — never a silent restart from empty."""
        snap, records = wal.recover()
        srv = cls(
            snapshot_interval=snapshot_interval,
            snapshot_bytes=snapshot_bytes,
            group_commit=group_commit,
        )
        srv._replaying = True
        try:
            snap_rv = 0
            if snap is not None:
                snap_rv = int(snap.get("rv", 0))
                for api_version, kind, plural, namespaced in snap.get("types", []):
                    srv.register_kind(api_version, kind, plural, namespaced)
                for obj in snap.get("objects", []):
                    info = srv.type_info(obj.get("kind", ""))
                    meta = obj.get("metadata", {})
                    key = srv._key(
                        info,
                        meta.get("namespace") if info.namespaced else None,
                        meta.get("name", ""),
                    )
                    srv._put(info.kind, key, obj)
                srv._rv = snap_rv
                srv._compacted_rv = int(snap.get("compacted_rv", 0))
                srv._kind_rv = {k: int(v) for k, v in snap.get("kind_rv", {}).items()}
                for rv, kind, ns, etype, obj in snap.get("events", []):
                    srv._event_log.append((int(rv), kind, ns, etype, obj_util.freeze(obj)))
            for rec in records:
                if rec.get("op") == "register":
                    srv.register_kind(
                        rec["apiVersion"],
                        rec["kind"],
                        rec["plural"],
                        bool(rec.get("namespaced", True)),
                    )
                    continue
                rv = int(rec.get("rv", 0))
                if rv <= snap_rv:
                    continue  # the snapshot already covers it
                etype, obj = rec.get("etype", ""), rec.get("obj") or {}
                kind = obj.get("kind", "")
                info = srv.type_info(kind)  # loud NotFound on unknown kind
                meta = obj.get("metadata", {})
                ns = meta.get("namespace") if info.namespaced else None
                key = srv._key(info, ns, meta.get("name", ""))
                if etype == "DELETED":
                    srv._drop(kind, key)
                else:
                    srv._put(kind, key, obj_util.deepcopy(obj))
                srv._rv = max(srv._rv, rv)
                srv._kind_rv[kind] = rv
                srv._event_log.append(
                    (rv, kind, meta.get("namespace", ""), etype, obj_util.freeze(obj))
                )
                while len(srv._event_log) > srv.WATCH_CACHE_SIZE:
                    srv._compacted_rv = max(srv._compacted_rv, srv._event_log.popleft()[0])
            # resume-window floor: a resume needs every event after its
            # rv; below (oldest retained − 1) must 410. An empty window
            # (fresh log) stays at the snapshot floor; a non-empty history
            # with no retained events can only resume from the present.
            if srv._event_log:
                srv._compacted_rv = max(srv._compacted_rv, srv._event_log[0][0] - 1)
            elif srv._rv:
                srv._compacted_rv = max(srv._compacted_rv, srv._rv)
            # Event dedupe index: rebuilt from the recovered Events so
            # repeat emissions keep deduping instead of duplicating
            for ev in srv._store.get("Event", {}).values():
                inv = ev.get("involvedObject", {})
                srv._event_index[
                    (
                        ev.get("metadata", {}).get("namespace", "default"),
                        inv.get("kind", ""),
                        inv.get("name", ""),
                        inv.get("uid", ""),
                        ev.get("reason", ""),
                        ev.get("message", ""),
                        ev.get("type", "Normal"),
                    )
                ] = ev.get("metadata", {}).get("name", "")
        finally:
            srv._replaying = False
        srv._applied_rv = srv._rv
        srv._wal = wal
        return srv

    # -- CRUD ---------------------------------------------------------------

    # -- fencing -------------------------------------------------------------

    def _check_fence(self, kind: str) -> None:
        """Reject mutations carrying a deposed lease epoch. Validated
        under the store lock, atomically with the apply — this closes
        the leader-election TOCTOU where a paused holder finishes an
        in-flight write after a peer took the lease over. Lease writes
        themselves are exempt (acquire/renew/release must work while
        contested; they are already serialized by optimistic
        concurrency)."""
        fence = _FENCE.get()
        if fence is None or kind == "Lease":
            return
        ns, name, token = fence
        lease = self._store.get("Lease", {}).get((ns, name))
        if lease is None:
            raise FencedOut(
                f"fencing lease {ns}/{name} no longer exists; epoch "
                f"{token} is deposed"
            )
        spec = lease.get("spec") or {}
        try:
            current = int(spec.get("fencingToken", -1))
        except (TypeError, ValueError):
            current = -1
        if current != int(token):
            raise FencedOut(
                f"fencing token {token} for lease {ns}/{name} is stale "
                f"(current epoch {current}); the holder was deposed"
            )
        renew = spec.get("renewTime")
        duration = float(spec.get("leaseDurationSeconds") or 0)
        if renew and duration:
            try:
                age = self.fence_now_fn() - parse_micro_time(renew)
            except ValueError:
                age = 0.0
            if age > duration:
                raise FencedOut(
                    f"fencing lease {ns}/{name} expired "
                    f"{age - duration:.3f}s ago; epoch {token} may not "
                    "write until it re-acquires"
                )

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
            self._check_fence(kind)
            # admission first: a mutating hook may rewrite name/namespace,
            # and the store key must reflect what admission returns
            obj = self._run_admission(AdmissionRequest("CREATE", obj, None, dry_run))
            meta = obj["metadata"]
            name = meta["name"]
            namespace = meta.get("namespace") if info.namespaced else None
            key = self._key(info, namespace, name)
            current, _ = self._effective(kind, key)
            if current is not None:
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
            # durable before applied or acked (log → fsync → apply →
            # ack); inline apply when no WAL is attached
            entry = self._commit_mutation("ADDED", kind, key, obj)
        self._await(entry)
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
        limit: Optional[int] = None,
    ) -> list[Obj]:
        if limit:
            # bounded read: the first page of the stable paginated order
            # (kube's limit-without-continue shape)
            items, _ = self.list_chunk(
                kind,
                namespace=namespace,
                label_selector=label_selector,
                field_matches=field_matches,
                limit=limit,
            )
            return items
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

    def list_chunk(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
        continue_token: Optional[str] = None,
    ) -> tuple[list[Obj], str]:
        """One page of a kube-style paginated list: up to ``limit``
        matching objects in stable (namespace, name) order plus an
        opaque ``continue`` token ("" when the list is exhausted).

        The token pins the resourceVersion of the FIRST page; a
        continuation whose token predates the compacted watch-cache
        window raises :class:`Expired` (410) — the client restarts from
        a fresh list (kube-apiserver's continue-token contract). Pages
        are served from current state, so a walk concurrent with writers
        is at-least-as-fresh per page, as kube documents."""
        info = self.type_info(kind)
        limit = max(int(limit) if limit else self.LIST_DEFAULT_LIMIT, 1)
        start_after: Optional[tuple[str, str]] = None
        with self._lock:
            if continue_token:
                payload = decode_continue(continue_token)
                if payload.get("kind") != kind or payload.get("ns", "") != (
                    namespace or ""
                ):
                    raise BadRequest(
                        "continue token does not match this list's "
                        f"kind/namespace ({payload.get('kind')}/"
                        f"{payload.get('ns')} vs {kind}/{namespace or ''})"
                    )
                token_rv = int(payload.get("rv", 0))
                if token_rv < self._compacted_rv:
                    raise Expired(
                        f"continue token at resourceVersion {token_rv} "
                        f"predates the compacted window (oldest resumable "
                        f"is {self._compacted_rv}); restart the list"
                    )
                k = payload.get("k") or []
                if len(k) != 2:
                    raise BadRequest("malformed continue token key")
                start_after = (str(k[0]), str(k[1]))
            else:
                token_rv = self._applied_rv
            if info.namespaced and namespace:
                src = self._ns_buckets[kind].get(namespace, {})
            else:
                src = self._store[kind]
            out: list[Obj] = []
            last_key: Optional[tuple[str, str]] = None
            more = False
            for key in sorted(src):
                if start_after is not None and key <= start_after:
                    continue
                stored = src[key]
                if not self._matches(stored, label_selector, field_matches):
                    continue
                if len(out) == limit:
                    more = True
                    break
                out.append(obj_util.deepcopy(stored))
                last_key = key
            token = ""
            if more and last_key is not None:
                token = encode_continue(
                    {"rv": token_rv, "kind": kind, "ns": namespace or "",
                     "k": list(last_key)}
                )
            return out, token

    def _update_inner(self, obj: Obj, status_only: bool) -> Obj:
        kind = obj.get("kind", "")
        info = self.type_info(kind)
        obj = obj_util.deepcopy(obj)
        meta = obj.get("metadata", {})
        name = meta.get("name", "")
        namespace = meta.get("namespace") if info.namespaced else None
        with self._lock:
            self._check_fence(kind)
            key = self._key(info, namespace, name)
            current, cur_entry = self._effective(kind, key)
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
                result = obj_util.deepcopy(current)
                # the matched state may itself still be in flight through
                # the committer: ack only after ITS covering fsync
                entry = cur_entry
            else:
                obj["metadata"]["resourceVersion"] = self._next_rv()
                entry = self._commit_mutation("MODIFIED", kind, key, obj)
                # a finalizer removal may release a pending delete
                if obj["metadata"].get("deletionTimestamp") and not obj[
                    "metadata"
                ].get("finalizers"):
                    entry = self._remove(info, obj) or entry
                result = obj_util.deepcopy(obj)
        self._await(entry)
        return result

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
        retries (the kube-apiserver guaranteedUpdate shape). Not under one
        lock hold: the update's ack-after-durable wait never runs under
        the store lock, so a racing writer surfaces as Conflict and the
        merge is re-applied to the fresh object."""

        def attempt() -> Obj:
            current = self.get(kind, name, namespace)
            merged = obj_util.json_merge_patch(current, patch)
            # merge patches cannot move server-owned metadata
            for k in ("uid", "creationTimestamp", "resourceVersion", "generation"):
                if k in current.get("metadata", {}):
                    merged["metadata"][k] = current["metadata"][k]
            return self.update(merged)

        return backoff.retry(  # budget-ok: in-process optimistic-concurrency merge — retries re-run a local read-modify-write, no remote amplification
            attempt,
            retryable=lambda e: isinstance(e, Conflict),
            attempts=16,
            base=0.001,
            cap=0.05,
        )

    def delete(self, kind: str, name: str, namespace: Optional[str] = None) -> None:
        with self._lock:
            entry = self._delete_locked(kind, name, namespace)
        self._await(entry)

    def _delete_locked(
        self, kind: str, name: str, namespace: Optional[str]
    ) -> Optional[_WalEntry]:
        info = self.type_info(kind)
        self._check_fence(kind)
        key = self._key(info, namespace, name)
        current, _ = self._effective(kind, key)
        if current is None:
            raise NotFound(f"{kind} {namespace or ''}/{name} not found")
        if current["metadata"].get("finalizers"):
            if not current["metadata"].get("deletionTimestamp"):
                # on a private copy, so log-then-apply holds: nothing
                # visible changes if the append fails
                current = obj_util.deepcopy(current)
                current["metadata"]["deletionTimestamp"] = obj_util.now_rfc3339()
                current["metadata"]["resourceVersion"] = self._next_rv()
                return self._commit_mutation("MODIFIED", kind, key, current)
            return None
        return self._remove(info, current)

    def _remove(self, info: TypeInfo, current: Obj) -> Optional[_WalEntry]:
        key = self._key(
            info,
            current["metadata"].get("namespace") if info.namespaced else None,
            current["metadata"]["name"],
        )
        # a deletion is a new cluster state: stamp a FRESH rv so the
        # watch cache orders it after the last modification (on a
        # private copy: a failed append leaves the stored object as it was)
        current = obj_util.deepcopy(current)
        current["metadata"]["resourceVersion"] = self._next_rv()
        entry = self._commit_mutation("DELETED", info.kind, key, current)
        return self._cascade(current) or entry

    def _cascade(self, owner: Obj) -> Optional[_WalEntry]:
        """Foreground GC: delete dependents referencing the owner uid, at
        prepare time under the store lock, reading through the pending
        overlay; returns the last enqueued entry so the outermost verb
        can await the whole cascade's covering fsync."""
        owner_uid = owner["metadata"].get("uid")
        if not owner_uid:
            return None
        last: Optional[_WalEntry] = None
        for kind in list(self._store):
            for stored in self._iter_effective(kind):
                refs = stored["metadata"].get("ownerReferences") or []
                if any(r.get("uid") == owner_uid for r in refs):
                    try:
                        last = (
                            self._delete_locked(
                                kind,
                                stored["metadata"]["name"],
                                stored["metadata"].get("namespace"),
                            )
                            or last
                        )
                    except NotFound:
                        pass
        return last

    # -- watches ------------------------------------------------------------

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        send_initial: bool = True,
        resource_version: Optional[str] = None,
        inline: bool = True,
    ) -> Watch:
        """Open a watch stream: an ADDED event for each current object
        (unless ``send_initial`` is False), then every live event.
        ``resource_version`` resumes from a previously observed rv: the
        events after it replay from the watch cache, then the stream goes
        live — no initial dump. A resume point below the retained window
        raises :class:`Expired` (410); resuming exactly AT the compaction
        floor is fine. The caller relists on 410.

        ``inline=False`` routes live delivery through the sharded watch
        dispatcher (the serving tier's posture — the REST façade passes
        it for every HTTP stream); the replay still runs synchronously
        under the lock, and shard registration happens under the same
        hold, so no event can land between them."""
        info = self.type_info(kind)
        with self._lock:
            w = Watch(self, kind, namespace)
            if resource_version is not None:
                try:
                    rv = int(resource_version)
                except (TypeError, ValueError):
                    raise Invalid(
                        f"resourceVersion {resource_version!r} is not numeric"
                    ) from None
                if rv < self._compacted_rv:
                    raise Expired(
                        f"resourceVersion {rv} is too old (oldest resumable "
                        f"is {self._compacted_rv})"
                    )
                for erv, ekind, ens, etype, obj in self._event_log:
                    if erv <= rv or ekind != kind:
                        continue
                    if namespace and ens != namespace:
                        continue
                    w._enqueue((etype, obj))
            elif send_initial:
                # frozen shared replay: watch consumers are readers
                if info.namespaced and namespace:
                    items = self._ns_buckets[kind].get(namespace, {}).values()
                else:
                    items = self._store[kind].values()
                for item in items:
                    w._enqueue(("ADDED", obj_util.freeze(item)))
            # the slow-consumer bound covers the LIVE backlog on top of
            # whatever the replay/initial dump just queued
            w.maxsize = w._q.qsize() + self.WATCH_CACHE_SIZE
            self._register_watch(w, inline=inline)
            return w

    def replication_watch(self, from_rv: int = 0, inline: bool = False) -> Watch:
        """A follower replica's feed: every committed record of every
        kind, in rv order — replayed from the watch cache above
        ``from_rv``, then live. The same 410 contract as a watch resume:
        ``from_rv`` below the compaction floor raises :class:`Expired`
        and the follower catches up from a snapshot
        (``replication_cut``) instead. Dynamic kind registrations arrive
        as ``("REGISTER", typeinfo)`` records. Delivery is
        dispatcher-sharded: shipping costs the write path one queue put."""
        with self._lock:
            if from_rv < self._compacted_rv:
                raise Expired(
                    f"replication resume rv {from_rv} predates the "
                    f"compacted window (oldest resumable is "
                    f"{self._compacted_rv}); catch up from a snapshot"
                )
            w = Watch(self, None, None)
            # non-builtin registrations first: replayed objects of a
            # dynamic kind must find their type registered
            for t in self._types.values():
                if t.kind not in _BUILTIN_KIND_NAMES:
                    w._enqueue(
                        (
                            "REGISTER",
                            {
                                "apiVersion": t.api_version,
                                "kind": t.kind,
                                "plural": t.plural,
                                "namespaced": t.namespaced,
                            },
                        )
                    )
            for erv, _kind, _ns, etype, obj in self._event_log:
                if erv > from_rv:
                    w._enqueue((etype, obj))
            w.maxsize = w._q.qsize() + self.WATCH_CACHE_SIZE
            # inline=True is the deterministic in-process shipper's mode
            self._register_watch(w, inline=inline)
            return w

    def replication_cut(self) -> Obj:
        """A consistent full-state cut for follower cold catch-up — the
        snapshot shape (``rv``, ``types``, ``objects``, ``kind_rv``,
        ``compacted_rv``, ``events``) plus the shipping epoch. Pointer
        collection under the lock; serialization is the caller's."""
        state = self._snapshot_cut()
        state["epoch"] = self.replication_epoch
        return state

    def applied_rv(self) -> int:
        """The durable-and-applied rv horizon reads are served at."""
        with self._lock:
            return self._applied_rv

    def state_digest(self) -> str:
        """sha256 over the canonical serialization of every applied object
        in (kind, key) order: two stores with equal digests serve
        byte-identical reads."""
        h = hashlib.sha256()
        with self._lock:
            for kind in sorted(self._store):
                per_kind = self._store[kind]
                for key in sorted(per_kind):
                    h.update(serialize.dumps(per_kind[key]))
        return h.hexdigest()


    @staticmethod
    def compose_digests(parts: list[tuple[int, str, int]]) -> str:
        """One fleet digest from per-partition ``(partition, digest,
        rv)`` tuples: sha256 over their canonical serialization in
        sorted order. Equal fleet digests mean every partition (and its
        replicas) serves byte-identical reads at matching horizons."""
        h = hashlib.sha256()
        for partition, digest, rv in sorted(parts):
            h.update(f"{partition}\x00{digest}\x00{rv}\x00".encode())
        return h.hexdigest()

    # -- identity-preserving writes ------------------------------------------
    #
    # Data-plane verbs for moving a namespace between stores whose rv
    # spaces are independent: they flow through the normal commit
    # pipeline (durable before acked, watch events emitted, replicated
    # to followers) but skip the user-facing lifecycle — admission ran
    # in the source store, and finalizers/cascade belong to whichever
    # store owns the namespace.

    def import_object(self, obj: Obj) -> Obj:
        """Upsert ``obj`` preserving its identity (uid, creation
        timestamp, generation, finalizers, ownerReferences) under a
        fresh LOCAL resourceVersion."""
        kind = obj.get("kind", "")
        info = self.type_info(kind)
        obj = obj_util.deepcopy(obj)
        obj.setdefault("apiVersion", info.api_version)
        meta = obj.setdefault("metadata", {})
        if not meta.get("name"):
            raise Invalid("metadata.name required")
        namespace = meta.get("namespace") if info.namespaced else None
        with self._lock:
            self._check_fence(kind)
            key = self._key(info, namespace, name=meta["name"])
            current, _ = self._effective(kind, key)
            meta["resourceVersion"] = self._next_rv()
            etype = "ADDED" if current is None else "MODIFIED"
            entry = self._commit_mutation(etype, kind, key, obj)
        self._await(entry)
        return obj_util.deepcopy(obj)

    def purge_object(self, kind: str, name: str, namespace: Optional[str] = None) -> bool:
        """Remove one object directly — no finalizer two-phase, no
        ownerReference cascade — through the commit pipeline (a DELETED
        record, durable before acked). Returns False when the object is
        already gone, so a resumed purge is idempotent."""
        info = self.type_info(kind)
        with self._lock:
            self._check_fence(kind)
            key = self._key(info, namespace, name)
            current, _ = self._effective(kind, key)
            if current is None:
                return False
            current = obj_util.deepcopy(current)
            current["metadata"]["resourceVersion"] = self._next_rv()
            entry = self._commit_mutation("DELETED", kind, key, current)
        self._await(entry)
        return True

    # -- watch dispatch (sharded fanout) ------------------------------------

    def _register_watch(self, w: Watch, inline: bool) -> None:
        """Called under the store lock. Inline watches join the
        synchronous fanout; dispatcher watches are rendezvous-hashed onto
        a shard (started lazily) by a stable per-watch token, their
        registration ordinal."""
        self._watches.append(w)
        if inline or self.WATCH_DISPATCH_SHARDS <= 0:
            self._inline_watches.append(w)
            return
        self._ensure_shards()
        if not self._shards:
            # racing close(): no dispatcher will ever run — deliver
            # inline so the registration degrades cleanly
            self._inline_watches.append(w)
            return
        self._watch_seq += 1
        sid = _rendezvous_shard(f"w{self._watch_seq}", len(self._shards))
        w._shard = sid
        shard = self._shards[sid]
        shard.watchers = shard.watchers + (w,)

    def _ensure_shards(self) -> None:
        if self._shards or self._closed:
            return
        for i in range(self.WATCH_DISPATCH_SHARDS):
            shard = _WatchShard()
            shard.thread = threading.Thread(
                target=self._dispatch_loop,
                args=(shard,),
                name=f"apiserver-watch-dispatch-{i}",
                daemon=True,
            )
            self._shards.append(shard)
        for shard in self._shards:
            shard.thread.start()

    def _dispatch_loop(self, shard: _WatchShard) -> None:
        """One dispatch shard: pop applied events in rv order, fan out
        to this shard's watchers. No store lock on the fast path — the
        watcher tuple is copy-on-write and per-watcher queues are
        thread-safe; eviction of a slow consumer (inside ``_enqueue``)
        is the only re-entry into the store. Events are drained in
        bursts and each touched consumer is woken once per burst."""
        while True:
            item = shard.q.get()
            if item is None:
                return
            if self.WATCH_DISPATCH_COALESCE_MS:
                # coalesce: let the commit burst finish landing so one
                # fanout pass + one wake per consumer covers it all
                time.sleep(self.WATCH_DISPATCH_COALESCE_MS / 1000.0)
            burst = [item]  # each item is a LIST of events (one batch)
            done = False
            while True:
                try:
                    nxt = shard.q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    done = True
                    break
                burst.append(nxt)
            touched: list[Watch] = []
            for events in burst:
                for etype, obj, kind, ns in events:
                    for w in shard.watchers:
                        if self._watch_match(w, kind, ns):
                            w._enqueue((etype, obj), wake=False)
                            if not w._burst_mark:
                                w._burst_mark = True
                                touched.append(w)
            for w in touched:
                w._burst_mark = False
                w._wake()
            if done:
                return
    def _remove_watch(self, w: Watch) -> None:
        with self._lock:
            if w in self._watches:
                self._watches.remove(w)
            if w in self._inline_watches:
                self._inline_watches.remove(w)
            if w._shard is not None and w._shard < len(self._shards):
                shard = self._shards[w._shard]
                shard.watchers = tuple(x for x in shard.watchers if x is not w)

    def _evict_watch(self, w: Watch) -> None:
        """A slow consumer was closed with 410 by its own `_enqueue`;
        deregister it and count the eviction."""
        self._remove_watch(w)
        with self._lock:
            self.watch_evictions += 1

    def kind_version(self, kind: str) -> int:
        """The resourceVersion of the last mutation that touched ``kind``
        (0 if never touched): the serving tier's list-payload cache key.
        Per-kind list output is immutable between bumps, so ``(kind,
        namespace, selector, kind_version)`` identifies a whole
        serialized list response."""
        with self._lock:
            return self._kind_rv.get(kind, 0)

    def _notify(self, event_type: str, obj: Obj, rv: Optional[int] = None) -> None:
        kind = obj.get("kind", "")
        meta = obj.get("metadata", {})
        ns = meta.get("namespace", "")
        if rv is None:
            try:
                rv = int(meta.get("resourceVersion", self._rv))
            except (TypeError, ValueError):
                rv = self._rv
        # the list-payload cache key moves with the record's OWN rv (the
        # applied horizon), never self._rv, which may already cover
        # prepared-but-unapplied records in flight through the committer
        self._kind_rv[kind] = rv
        # ONE frozen snapshot per event, shared by every watcher and the
        # watch cache: later store mutations cannot leak into delivered
        # events, and a reader that tries to mutate gets
        # FrozenObjectError instead of corruption
        shared = obj_util.freeze(obj)
        self._event_log.append((rv, kind, ns, event_type, shared))
        while len(self._event_log) > self.WATCH_CACHE_SIZE:
            self._compacted_rv = max(self._compacted_rv, self._event_log.popleft()[0])
        self._deliver_event(event_type, shared, kind, ns)

    @staticmethod
    def _watch_match(w: Watch, kind: Optional[str], ns: str) -> bool:
        if w.kind is None:
            return True  # replication feed: every kind, every namespace
        if kind is None:
            return False  # control records (REGISTER) are feed-only
        if w.kind != kind:
            return False
        return not w.namespace or w.namespace == ns

    def _deliver_event(
        self, event_type: str, obj: Obj, kind: Optional[str], ns: str
    ) -> None:
        """Fan one applied event out (under the store lock, so delivery
        order == rv order). Inline watchers are enqueued synchronously;
        dispatcher-delivered watchers cost the mutator one queue put per
        nonempty shard — one per shard per BATCH while the group
        committer applies (``_delivery_buffer``)."""
        for w in list(self._inline_watches):
            if self._watch_match(w, kind, ns):
                w._enqueue((event_type, obj))
        item = (event_type, obj, kind, ns)
        if self._delivery_buffer is not None:
            self._delivery_buffer.append(item)
        else:
            self._flush_delivery([item])

    def _flush_delivery(self, items: list[tuple]) -> None:
        for shard in self._shards:
            if shard.watchers:
                shard.q.put(items)

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
        last: Optional[_WalEntry] = None
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
                # through the pending overlay: a concurrent emitter's
                # prune may already have a DELETED in flight for this key
                expired, entry = self._effective("Event", key)
                if expired is not None:
                    # watchers must see the expiry (DELETED, fresh rv on a
                    # private copy)
                    expired = obj_util.deepcopy(expired)
                    expired["metadata"]["resourceVersion"] = self._next_rv()
                    last = self._commit_mutation("DELETED", "Event", key, expired) or last
                elif entry is None:
                    self._drop("Event", key)
            dead = {name for _, name in drop}
            self._event_index = {
                k: v for k, v in self._event_index.items() if v not in dead
            }
        self._await(last)
