"""Informer-backed shared cache: indexed, zero-copy reads for every
controller and web hot path (the port's copy of the JAX package's
``machinery/cache.py``).

The controller-runtime cache layer: the manager feeds all reconcilers
from ONE watch-fed shared informer per kind with field indexers.

- **one watch per kind** feeds an in-memory mirror of the store;
- **indexes** (namespace buckets, labels-of-interest, registrable
  field indexers: Pods by owner UID, StatefulSets by owner, Workloads
  by queue, Nodes by nodepool, Pods by PVC claim / GPU request) turn
  selector lists into dict lookups;
- **zero-copy reads**: cached objects are deep-frozen
  (``objects.FrozenDict``) so ``get``/``list`` return shared references
  safely; mutation raises ``FrozenObjectError`` and the ``mutable()``
  escape hatch gives a private copy-on-write copy;
- **``CachedClient``** fronts an APIServer-shaped api with the same
  read interface, serving cached kinds from the cache (hits) and
  falling through to the store for everything else (misses), with
  hit/miss/staleness metrics;
- **rv-guarded applies + tombstones** keep concurrent drainers (live
  pump threads and opportunistic read-time pokes) order-safe;
- **resync** re-lists from the source of truth, healing any dropped
  event; a kind whose stream breaks is served **degraded** (last-known
  state, ``informer_degraded``) until the heal re-lists it.

Event handlers let controllers source their watch streams from the
informer instead of opening private per-controller watches — one
frozen copy per store event serves the cache AND every controller.
``list_by_index`` degrades to a selector list on a plain api, and
``SerializedBytesCache`` is the REST façade's bytes cache. Its locks
come from the lock-order sanitizer's factory (``analysis/sanitizer.py``)
and the heal carries the schedule explorer's yield markers
(``analysis/schedule.py``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Iterable, Optional

from odh_kubeflow_tpu_torch.analysis import sanitizer as _sanitizer
from odh_kubeflow_tpu_torch.analysis import schedule as _schedule
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery import serialize
from odh_kubeflow_tpu_torch.machinery.objects import (  # noqa: F401 — public API
    FrozenDict,
    FrozenList,
    FrozenObjectError,
    freeze,
    is_frozen,
    mutable,
)
from odh_kubeflow_tpu_torch.machinery.store import (
    APIError,
    NotFound,
    Watch,
    paged_list_all,
)
from odh_kubeflow_tpu_torch.utils import prometheus

log = logging.getLogger("machinery.cache")

Obj = dict[str, Any]
Key = tuple[str, str]  # (namespace, name); "" for cluster-scoped

IndexFn = Callable[[Obj], Iterable[str]]
Handler = Callable[[str, Obj], None]

# The kinds every in-process component reads on a hot path. CRD kinds
# (Notebook/Workload/...) must be registered with the api before the
# cache starts; ``for_platform`` filters to what's actually registered.
DEFAULT_CACHED_KINDS: tuple[str, ...] = (
    "Pod",
    "StatefulSet",
    "Deployment",
    "Service",
    "Event",
    "Node",
    "ResourceQuota",
    "PersistentVolumeClaim",
    "Namespace",
    "Secret",
    "ServiceAccount",
    "Role",
    "RoleBinding",
    "ClusterRole",
    "ClusterRoleBinding",
    "PriorityClass",
    "Notebook",
    "Workload",
    "SessionCheckpoint",
    "Profile",
    "Tensorboard",
    "PodDefault",
    "WarmPool",
    "CompileCacheEntry",
)

_TOMBSTONE_LIMIT = 4096


def _kind_registered(api: Any, kind: str) -> bool:
    type_info = getattr(api, "type_info", None)
    if type_info is None:
        return True  # duck api without a registry — let the watch decide
    try:
        type_info(kind)
    except NotFound:
        return False
    return True


def _owner_uids(obj: Obj) -> list[str]:
    return [
        r["uid"]
        for r in (obj_util.meta(obj).get("ownerReferences") or [])
        if r.get("uid")
    ]


class _KindCache:
    __slots__ = (
        "objects",
        "by_ns",
        "indexes",
        "indexers",
        "label_indexes",
        "synced",
        "tombstones",
        "last_event",
        "degraded",
        "retry_at",
        "version",
    )

    def __init__(self):
        self.objects: dict[Key, Obj] = {}
        self.by_ns: dict[str, dict[Key, Obj]] = {}
        self.indexes: dict[str, dict[str, dict[Key, Obj]]] = {}
        self.indexers: dict[str, IndexFn] = {}
        self.label_indexes: set[str] = set()
        self.synced = False
        self.tombstones: dict[Key, int] = {}
        self.last_event = 0.0
        # degraded = the watch stream is down and a relist hasn't
        # succeeded yet; reads keep serving last-known-good state
        self.degraded = False
        self.retry_at = 0.0  # earliest next reestablish attempt
        # monotonic mutation counter for THIS mirror's visible state —
        # bumped on every insert/evict/rebuild, so consumers can key
        # memoized derivations (listing memo, bytes caches) on exactly
        # what the cache serves rather than the store's rv (which may
        # be ahead of an unapplied event)
        self.version = 0


class InformerCache:
    """Watch-fed read mirror of an APIServer-shaped api.

    Deterministic tests drive it with ``drain_once()`` (and every read
    through ``CachedClient`` pokes pending events first, giving
    read-your-writes against the in-process store); live deployments
    call ``start()`` which spawns one pump thread per kind.
    """

    def __init__(
        self,
        api: Any,
        kinds: Iterable[str] = DEFAULT_CACHED_KINDS,
        registry: Optional[prometheus.Registry] = None,
        time_fn: Callable[[], float] = time.time,
    ):
        self.api = api
        self.now = time_fn
        if kinds is DEFAULT_CACHED_KINDS:
            # the implicit platform set adapts to what's registered
            # (optional subsystems like sessions/ may be absent); an
            # EXPLICIT kind list stays strict — a typo there is a
            # configuration error the failing watch should surface
            kinds = [k for k in kinds if _kind_registered(api, k)]
        self._lock = _sanitizer.new_rlock("informer.cache")
        self._kinds: dict[str, _KindCache] = {k: _KindCache() for k in kinds}
        # per-kind heal mutex: stream-loss recovery can be triggered by
        # the pump thread AND read-path pokes at once; only one may
        # swap the watch + relist (taken non-blocking — a loser returns
        # immediately instead of stacking up). The heal body BLOCKS by
        # design (watch re-open + relist over HTTP on a remote api), and
        # nothing can ever wait on this lock (try-acquire only).
        self._heal_locks: dict[str, Any] = {
            k: _sanitizer.new_lock("informer.heal", allow_blocking=True)
            for k in self._kinds
        }
        self._handlers: dict[str, list[Handler]] = {}
        self._watches: dict[str, Watch] = {}
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._started = False
        # live = pump threads own stream healing; in drain mode (tests,
        # pre-start platforms) the read path heals instead
        self._live = False

        reg = registry or prometheus.default_registry
        self.m_hits = reg.counter(
            "cache_hits_total",
            "Reads served zero-copy from the informer cache",
            labelnames=("kind",),
        )
        self.m_misses = reg.counter(
            "cache_misses_total",
            "Reads that fell through to the backing store",
            labelnames=("kind",),
        )
        self.m_resync = reg.counter(
            "cache_resync_total",
            "Full re-lists of a kind from the backing store",
        )
        self.m_relists = reg.counter(
            "cache_relists_total",
            "Relists forced by watch-stream loss or resourceVersion "
            "expiry (the degraded-mode healing path)",
        )
        # floor between reestablish attempts while the backend stays
        # down, so degraded reads don't hammer it (tests set 0)
        self.reestablish_backoff = 0.5
        self.m_coalesced = reg.counter(
            "watch_events_coalesced_total",
            "Watch events superseded by a newer event for the same "
            "object before the cache applied them",
        )
        self.m_staleness = reg.gauge(
            "cache_staleness_seconds",
            "Seconds since the kind last observed a watch event or "
            "resync, sampled at read time",
            labelnames=("kind",),
        )
        # hot-path counters are plain MONOTONIC ints (a Counter.inc per
        # read — lock + label-key sort — would cost more than the
        # read); they flush into the registered families lazily (at
        # scrape time via the collector below, or flush_metrics()) by
        # folding the delta past a watermark — readers never contend
        # with the flush, and concurrent flushes can't double-count
        self._hits: dict[str, int] = {}
        self._misses: dict[str, int] = {}
        self._flushed_hits: dict[str, int] = {}
        self._flushed_misses: dict[str, int] = {}
        self._flush_lock = _sanitizer.new_lock("informer.metrics-flush")
        self._stale_mark: dict[str, float] = {}
        reg.register_collector(self._flush_collector)

    def flush_metrics(self) -> None:
        """Fold the hot-path int counters into the registered Prometheus
        families (also runs automatically at scrape time)."""
        with self._flush_lock:
            for counts, flushed, family in (
                (self._hits, self._flushed_hits, self.m_hits),
                (self._misses, self._flushed_misses, self.m_misses),
            ):
                for kind, n in list(counts.items()):
                    delta = n - flushed.get(kind, 0)
                    if delta > 0:
                        family.inc({"kind": kind}, by=delta)
                        flushed[kind] = n

    def _flush_collector(self):
        self.flush_metrics()
        return ()

    # -- registration --------------------------------------------------------

    def kinds(self) -> list[str]:
        return list(self._kinds)

    def has_kind(self, kind: str) -> bool:
        return kind in self._kinds

    def synced(self, kind: str) -> bool:
        kc = self._kinds.get(kind)
        return kc is not None and kc.synced

    def degraded(self, kind: str) -> bool:
        """True while the kind's watch stream is down and unhealed —
        reads still serve, but from last-known-good state (the staleness
        gauge quantifies how old). Consumers surface this as the
        ``degraded: true`` marker on listings."""
        kc = self._kinds.get(kind)
        return kc is not None and kc.degraded

    def mirror_version(self, kind: str) -> int:
        """Monotonic counter of THIS mirror's visible mutations for
        ``kind`` (0 before any apply). Unlike the store's rv, it moves
        exactly when a read of this cache could observe different
        state, so memoized derivations (the web tier's listing memo)
        key on it: equal versions ⇒ byte-identical list output."""
        with self._lock:
            kc = self._kinds.get(kind)
            return 0 if kc is None else kc.version

    def any_degraded(self) -> bool:
        with self._lock:
            return any(kc.degraded for kc in self._kinds.values())

    def register_indexer(self, kind: str, name: str, fn: IndexFn) -> None:
        """Register a field indexer (controller-runtime
        ``FieldIndexer.IndexWith`` equivalent). ``fn(obj)`` returns the
        index keys the object files under. Registering after sync
        rebuilds the index from the cached objects."""
        with self._lock:
            kc = self._kinds[kind]
            kc.indexers[name] = fn
            index: dict[str, dict[Key, Obj]] = {}
            for key, obj in kc.objects.items():
                for ik in fn(obj) or ():
                    index.setdefault(ik, {})[key] = obj
            kc.indexes[name] = index

    def register_label_index(self, kind: str, label: str) -> str:
        """Index a kind by the value of one label-of-interest; selector
        lists on exactly that label become dict lookups."""
        name = f"label:{label}"

        def fn(obj: Obj, _label=label) -> list[str]:
            v = obj_util.labels_of(obj).get(_label)
            return [v] if v is not None else []

        self.register_indexer(kind, name, fn)
        with self._lock:
            self._kinds[kind].label_indexes.add(label)
        return name

    def add_handler(self, kind: str, fn: Handler) -> None:
        """Subscribe to the kind's event stream (informer event handler).
        The current cache contents replay as ADDED first, so a handler
        added after sync still sees every live object — the same
        contract a fresh watch with send_initial gives."""
        with self._lock:
            replay = list(self._kinds[kind].objects.values())
            self._handlers.setdefault(kind, []).append(fn)
        for obj in replay:
            fn("ADDED", obj)

    # -- lifecycle -----------------------------------------------------------

    def start(self, live: bool = True) -> None:
        """Open one watch per kind and prime from a full list (the
        informer's initial sync). With ``live`` a pump thread per kind
        applies events as they arrive; without, events apply on
        ``drain_once()`` / read-time pokes (deterministic test mode)."""
        with self._lock:
            opening = not self._started
            self._started = True
            if opening:
                for kind in self._kinds:
                    # watch first, then list-prime: anything written in
                    # between arrives as a (rv-guarded) event
                    self._watches[kind] = self.api.watch(
                        kind, send_initial=False
                    )
        if opening:
            from odh_kubeflow_tpu_torch.machinery import backoff, overload

            def transient(e: BaseException) -> bool:
                # 4xx (Denied/NotFound/Invalid) is a configuration
                # error — surface it immediately, don't mask it as a
                # flaky backend
                if isinstance(e, APIError):
                    return e.code >= 500 or e.code == 429
                return isinstance(e, OSError)

            for kind in self._kinds:
                # the initial prime must survive a flaky apiserver
                # (transient 429/5xx/network): capped jittered retries,
                # then fail loudly — starting without ANY state would
                # serve wrong empty listings, worse than not starting
                backoff.retry(
                    lambda k=kind: self.resync(k, count=False),
                    retryable=transient,
                    attempts=5,
                    base=0.02,
                    cap=0.5,
                    # one shared bucket with the client's own retries:
                    # a fleet-wide brownout must not let every cache
                    # prime retry independently on top of the client
                    budget=overload.shared_budget(),
                )
        if live:
            with self._lock:
                spawn = not self._threads
                if spawn:
                    self._threads = [
                        threading.Thread(
                            target=self._pump, args=(kind,), daemon=True
                        )
                        for kind in self._kinds
                    ]
            if spawn:
                # a drain-mode cache upgrades to live when the manager
                # later starts for real (Platform tests drain first)
                self._live = True
                for t in self._threads:
                    t.start()

    def stop(self) -> None:
        self._stop.set()
        for w in self._watches.values():
            w.stop()

    def wait_for_sync(self, timeout: float = 30.0) -> bool:
        """The start/sync barrier the Manager honours before running
        controllers. Priming is synchronous, so this only guards
        exotic start orderings."""
        deadline = self.now() + timeout
        while self.now() < deadline:
            if all(kc.synced for kc in self._kinds.values()):
                return True
            time.sleep(0.01)
        return all(kc.synced for kc in self._kinds.values())

    def _rebuild(self, kind: str, objs: list[Obj]) -> list[tuple[str, Obj]]:
        """Replace the kind's mirror + indexes with a listed snapshot
        (shared by resync and stream-loss healing). Queued events older
        than the snapshot are ignored afterwards by the rv guard.

        Returns what the snapshot changed against the old mirror, as the
        events a handler would have seen (client-go's ``Replace``): ADDED
        for a new key, MODIFIED for a new rv, DELETED for a key that is
        gone. An object written while the stream was down reaches the
        handlers through these, or its controller never learns of it.
        (The JAX package's cache rebuilds silently.)"""
        with self._lock:
            kc = self._kinds[kind]
            old = kc.objects
            # own bump: an empty snapshot inserts nothing, yet evicts
            # everything — the version must still move
            kc.version += 1
            kc.objects = {}
            kc.by_ns = {}
            kc.indexes = {name: {} for name in kc.indexers}
            for obj in objs:
                self._insert(kc, self._key_of(obj), freeze(obj))
            kc.synced = True
            kc.last_event = self.now()
            kc.degraded = False
            kc.retry_at = 0.0
            changed = [
                ("ADDED" if key not in old else "MODIFIED", obj)
                for key, obj in kc.objects.items()
                if key not in old or self._rv_of(old[key]) != self._rv_of(obj)
            ]
            changed += [("DELETED", obj) for key, obj in old.items()
                        if key not in kc.objects]
        return changed

    def _dispatch(self, kind: str, events: list[tuple[str, Obj]]) -> None:
        """Hand ``events`` to the kind's handlers, outside the lock."""
        for fn in self._handlers.get(kind, ()):
            for etype, obj in events:
                fn(etype, obj)

    # informer prime/resync page size (kube reflector's default chunk
    # limit posture): the mirror needs the full set either way, but no
    # single list RESPONSE carries the whole fleet. Env-tunable;
    # INFORMER_PAGE_SIZE=0 disables chunking.
    PAGE_SIZE = int(os.environ.get("INFORMER_PAGE_SIZE", "1000") or 0)

    def _list_all(self, kind: str) -> list[Obj]:
        """Full listing for prime/resync, walked in PAGE_SIZE chunks
        when the api paginates. A continue token that 410s mid-walk
        restarts the walk (same move as the watch 410 relist); after
        repeated expiry we defer to ``api.list`` — one request against
        the embedded store, or the client's own pager (which carries
        its own 410-restart policy and unpaginated last resort) on a
        remote api."""
        chunk = getattr(self.api, "list_chunk", None)
        if chunk is None or not self.PAGE_SIZE:
            return self.api.list(kind)  # unbounded-ok: api without pagination
        return paged_list_all(
            chunk,
            kind,
            self.PAGE_SIZE,
            lambda: self.api.list(kind),  # unbounded-ok: last-resort fallback after repeated 410s
            on_restart=lambda: log.warning(
                "informer %s: continue token expired mid-prime; "
                "restarting the paginated walk", kind,
            ),
        )

    def resync(self, kind: str, count: bool = True) -> None:
        """Re-list the kind from the backing store and rebuild the
        mirror + indexes — heals any dropped watch event. The list is
        walked in pages (``_list_all``) so fleet-sized primes never
        build one giant payload."""
        self._dispatch(kind, self._rebuild(kind, self._list_all(kind)))
        if count:
            self.m_resync.inc()

    def _degrade(self, kind: str, why: str, e: Exception) -> bool:
        log.warning(
            "informer %s: %s (%s); serving last-known-good degraded",
            kind, why, e,
        )
        with self._lock:
            kc = self._kinds[kind]
            kc.degraded = True
            kc.retry_at = self.now() + self.reestablish_backoff
        return False

    def _reestablish(self, kind: str) -> bool:
        """Heal a dead watch stream: open a fresh watch, then full
        relist (watch-first-then-list, same ordering as ``start()``, so
        nothing written in between is missed). A relist — not an rv
        resume — because deletions during the outage would otherwise
        survive in the mirror forever. The old stream is only torn down
        AFTER the new one is up, so a failed attempt changes nothing
        and the next read retries (past the backoff floor). Failure
        leaves the kind degraded; reads keep serving last-known-good."""
        kc = self._kinds[kind]
        if self.now() < kc.retry_at:
            return False
        if not self._heal_locks[kind].acquire(blocking=False):
            return False  # another thread is already healing this kind
        try:
            current = self._watches.get(kind)
            if (
                current is not None
                and not current.ended
                and not current._stopped
                and not kc.degraded
            ):
                return False  # the previous lock holder already healed
            try:
                w = self.api.watch(kind, send_initial=False)
            except Exception as e:  # noqa: BLE001 — Expired/APIError/OSError
                return self._degrade(kind, "watch re-open failed", e)
            # explorer yield marker: fresh watch open, relist not yet
            # taken — writes landing here must arrive as events
            _schedule.sched_point("informer.heal.relist")
            try:
                objs = self._list_all(kind)
            except Exception as e:  # noqa: BLE001 — backend still flapping
                try:
                    w.stop()
                except (APIError, OSError, RuntimeError):
                    pass  # best-effort teardown of the half-opened stream
                return self._degrade(kind, "relist after stream loss failed", e)
            # explorer yield marker: listed snapshot in hand, mirror
            # not yet rebuilt — reads racing the heal interleave here
            _schedule.sched_point("informer.heal.rebuild")
            with self._lock:
                old = self._watches.get(kind)
                self._watches[kind] = w
            self._dispatch(kind, self._rebuild(kind, objs))
            if old is not None and old is not w and not old._stopped:
                try:
                    old.stop()
                except (APIError, OSError, RuntimeError):
                    pass  # the stream is already dead; nothing to release
            self.m_relists.inc()
            log.warning(
                "informer %s: watch re-established after relist", kind
            )
            return True
        finally:
            self._heal_locks[kind].release()

    # -- event application ---------------------------------------------------

    @staticmethod
    def _key_of(obj: Obj) -> Key:
        m = obj.get("metadata", {})
        return (m.get("namespace") or "", m.get("name", ""))

    @staticmethod
    def _rv_of(obj: Obj) -> int:
        try:
            return int(obj.get("metadata", {}).get("resourceVersion", 0))
        except (TypeError, ValueError):
            return 0

    def _insert(self, kc: _KindCache, key: Key, obj: Obj) -> None:
        kc.version += 1
        kc.objects[key] = obj
        kc.by_ns.setdefault(key[0], {})[key] = obj
        for name, fn in kc.indexers.items():
            index = kc.indexes.setdefault(name, {})
            for ik in fn(obj) or ():
                index.setdefault(ik, {})[key] = obj

    def _evict(self, kc: _KindCache, key: Key) -> None:
        old = kc.objects.pop(key, None)
        if old is None:
            return
        kc.version += 1
        bucket = kc.by_ns.get(key[0])
        if bucket is not None:
            bucket.pop(key, None)
            if not bucket:
                del kc.by_ns[key[0]]
        for name, fn in kc.indexers.items():
            index = kc.indexes.get(name, {})
            for ik in fn(old) or ():
                entry = index.get(ik)
                if entry is not None:
                    entry.pop(key, None)
                    if not entry:
                        del index[ik]

    def _apply(self, kind: str, etype: str, obj: Obj) -> Optional[Obj]:
        """Apply one watch event under the lock; returns the frozen
        object when state changed (for handler dispatch — built ONCE
        here, never re-frozen per subscriber) or None for
        guard-rejected stale events. Caller dispatches handlers
        OUTSIDE the lock."""
        frozen = freeze(obj)
        key = self._key_of(frozen)
        rv = self._rv_of(frozen)
        with self._lock:
            kc = self._kinds[kind]
            kc.last_event = self.now()
            current = kc.objects.get(key)
            cur_rv = self._rv_of(current) if current is not None else -1
            tomb = kc.tombstones.get(key, -1)
            if etype == "DELETED":
                # record the tombstone even when there is nothing to
                # evict: a DELETED drained ahead of its ADDED (two
                # concurrent drainers) must still block the resurrect
                kc.tombstones[key] = max(rv, tomb)
                if len(kc.tombstones) > _TOMBSTONE_LIMIT:
                    # drop the oldest half (insertion ≈ rv order)
                    for k in list(kc.tombstones)[: _TOMBSTONE_LIMIT // 2]:
                        del kc.tombstones[k]
                if current is None or rv < cur_rv:
                    return None
                self._evict(kc, key)
                return frozen
            # ADDED / MODIFIED: ignore anything older than what we hold
            # or than a deletion we already applied (out-of-order drain)
            if rv < cur_rv or rv <= tomb:
                return None
            if current is not None:
                self._evict(kc, key)
            self._insert(kc, key, frozen)
            return frozen

    def _heal_on_read(self, w: Watch, kind: str) -> bool:
        """Drain-mode healing: a stream that DIED (ended, not stopped
        by us) or a kind still marked degraded relists here. With live
        pumps running, healing is the pump thread's job — a read must
        serve last-known-good instantly, not block a request behind
        watch/list timeouts against a sick backend."""
        if (
            not self._live
            and not self._stop.is_set()
            and ((w.ended and not w._stopped) or self._kinds[kind].degraded)
        ):
            return self._reestablish(kind)
        return False

    def _drain_kind(self, kind: str, budget: int = 10_000) -> bool:
        """Pull every pending event for ``kind``, coalesce runs for the
        same object (each event carries the full object, so only the
        newest matters for cache state), apply, dispatch handlers."""
        w = self._watches.get(kind)
        if w is None:
            return False
        if not w._q.qsize():
            # empty-queue fast path: reads poke before every lookup, so
            # this must cost nanoseconds, not a queue.Empty exception
            return self._heal_on_read(w, kind)
        pending: list[tuple[str, Obj]] = []
        resync_needed = False
        for _ in range(budget):
            item = w.try_get()
            if item is None:
                break
            if item[0] == "CONTROL":
                # merged-stream control frames (machinery.partition):
                # a partition leg that 410'd past its compaction floor,
                # or a namespace that moved partitions mid-stream —
                # either way the fix is a relist of the kind. Plain
                # heartbeat frames are dropped.
                frame = item[1]
                if frame.get("expired") or frame.get("moved"):
                    resync_needed = True
                continue
            pending.append(item)
        if not pending and not resync_needed:
            # the nonzero qsize was the dead stream's None sentinel
            return self._heal_on_read(w, kind)
        if len(pending) > 1:
            latest: dict[Key, int] = {}
            for i, (_etype, obj) in enumerate(pending):
                latest[self._key_of(obj)] = i
            kept = [
                ev
                for i, ev in enumerate(pending)
                if latest[self._key_of(ev[1])] == i
            ]
            if len(kept) < len(pending):
                self.m_coalesced.inc(by=len(pending) - len(kept))
            pending = kept
        handlers = self._handlers.get(kind, ())
        for etype, obj in pending:
            frozen = self._apply(kind, etype, obj)
            if frozen is not None:
                for fn in handlers:
                    fn(etype, frozen)
        if resync_needed:
            # AFTER the drained events: they predate the relist, and a
            # moved namespace's objects carry rvs from a different
            # partition's rv space — per-object rv guards cannot order
            # them, only a rebuild can
            log.warning(
                "informer %s: partition control frame (move/410) on the "
                "merged stream; resyncing the kind", kind,
            )
            self.resync(kind)
        return True

    def drain_once(self) -> bool:
        """Apply all pending events across kinds (deterministic drain)."""
        moved = False
        for kind in self._kinds:
            while self._drain_kind(kind):
                moved = True
        return moved

    def poke(self, kind: str) -> None:
        """Opportunistically apply the kind's pending events before a
        read. Against the in-process store (whose watch enqueue is
        synchronous) this gives read-your-writes; rv guards keep
        concurrent pump threads order-safe."""
        self._drain_kind(kind)

    def _pump(self, kind: str) -> None:
        handlers_of = self._handlers
        while not self._stop.is_set():
            # refetch per iteration: _reestablish swaps the watch out
            # from under us after a stream loss
            w = self._watches.get(kind)
            if w is None:
                return
            item = w.get(timeout=0.2)
            if item is None:
                if self._stop.is_set():
                    return
                if w._stopped:
                    if self._watches.get(kind) is not w:
                        continue  # swapped out by a heal — refetch
                    return  # our registered watch was stopped: shutdown
                if w.ended:
                    # the stream died (dropped connection, 410, chaos):
                    # mark degraded, heal via fresh watch + relist, and
                    # keep serving last-known-good state meanwhile
                    self._kinds[kind].degraded = True
                    if not self._reestablish(kind):
                        time.sleep(self.reestablish_backoff or 0.05)
                continue
            etype, obj = item
            frozen = self._apply(kind, etype, obj)
            if frozen is not None:
                for fn in handlers_of.get(kind, ()):
                    fn(etype, frozen)
            self._drain_kind(kind)

    # -- reads (zero-copy) ---------------------------------------------------

    def _observe_staleness(self, kc: _KindCache, kind: str) -> None:
        if not kc.last_event:
            return
        # throttled: the gauge is a scrape-resolution signal; setting it
        # (lock + label sort) on EVERY read would tax the hot path
        now = self.now()
        if now - self._stale_mark.get(kind, 0.0) < 0.25:
            return
        self._stale_mark[kind] = now
        self.m_staleness.set(
            max(now - kc.last_event, 0.0), labels={"kind": kind}
        )

    def get(self, kind: str, name: str, namespace: Optional[str] = None) -> Obj:
        with self._lock:
            kc = self._kinds[kind]
            self._observe_staleness(kc, kind)
            found = kc.objects.get((namespace or "", name))
            if found is None:
                raise NotFound(f"{kind} {namespace or ''}/{name} not found")
            return found

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
    ) -> list[Obj]:
        with self._lock:
            kc = self._kinds[kind]
            self._observe_staleness(kc, kind)
            candidates, ns_filtered = self._candidates(
                kc, namespace, label_selector
            )
            if label_selector is None and not field_matches and ns_filtered:
                # plain namespace (or full) list: the bucket IS the
                # answer — no per-object work at all (limit is a
                # truncation of the zero-copy result; the mirror holds
                # no payload to bound)
                return candidates[:limit] if limit else candidates
            out = []
            for obj in candidates:
                if not ns_filtered and namespace and self._key_of(obj)[0] != namespace:
                    continue
                if not obj_util.match_label_selector(
                    label_selector, obj_util.labels_of(obj)
                ):
                    continue
                if field_matches and any(
                    obj_util.get_path(obj, *path.split(".")) != want
                    for path, want in field_matches.items()
                ):
                    continue
                out.append(obj)
                if limit and len(out) >= limit:
                    break
            return out

    def _candidates(
        self,
        kc: _KindCache,
        namespace: Optional[str],
        selector: Optional[Obj],
    ) -> tuple[list[Obj], bool]:
        """Smallest candidate set (plus whether it is already
        namespace-exact): a label index bucket when the selector names
        an indexed label (equality or Exists), else the namespace
        bucket, else everything."""
        if selector:
            for k, v in (selector.get("matchLabels") or {}).items():
                if k in kc.label_indexes:
                    return (
                        list(
                            kc.indexes.get(f"label:{k}", {}).get(v, {}).values()
                        ),
                        False,
                    )
            for expr in selector.get("matchExpressions") or []:
                k = expr.get("key", "")
                if k not in kc.label_indexes:
                    continue
                index = kc.indexes.get(f"label:{k}", {})
                op = expr.get("operator", "In")
                if op == "Exists":
                    return (
                        [o for bucket in index.values() for o in bucket.values()],
                        False,
                    )
                if op == "In":
                    return (
                        [
                            o
                            for v in expr.get("values") or []
                            for o in index.get(v, {}).values()
                        ],
                        False,
                    )
        if namespace:
            return list(kc.by_ns.get(namespace, {}).values()), True
        return list(kc.objects.values()), True

    def by_index(
        self,
        kind: str,
        index: str,
        key: str,
        namespace: Optional[str] = None,
    ) -> list[Obj]:
        """Field-index lookup: every cached object of ``kind`` filed
        under ``key`` by the ``index`` indexer."""
        with self._lock:
            kc = self._kinds[kind]
            self._observe_staleness(kc, kind)
            bucket = kc.indexes.get(index, {}).get(key, {})
            if namespace:
                return [
                    o for k, o in bucket.items() if k[0] == namespace
                ]
            return list(bucket.values())

    def index_buckets(self, kind: str, index: str) -> dict[str, list[Obj]]:
        """Every (key → objects) bucket of a field index — for passes
        that aggregate over the whole index (the gang-bookkeeping
        charge walks ``tpu`` buckets, whose KEYS are the precomputed
        chip counts, so no per-pod resource parsing at read time)."""
        with self._lock:
            kc = self._kinds[kind]
            self._observe_staleness(kc, kind)
            return {
                k: list(bucket.values())
                for k, bucket in kc.indexes.get(index, {}).items()
            }


class SerializedBytesCache:
    """Bounded LRU of serialized response bytes keyed by on-the-wire
    identity: ``(kind, namespace, name, resourceVersion)``.

    The apiserver's object contents are immutable per resourceVersion
    (every change stamps a fresh rv — deletions included), so the key
    IS the content hash: nothing ever needs explicit invalidation, a
    changed object simply serializes under its new rv while the stale
    entry ages out of the LRU. One instance per serving tier (RestAPI)
    — rv counters are per-store, so a process-global cache could alias
    objects across the independent stores tests create.

    Two views share the underlying object bytes:

    - ``obj_bytes(obj)``: the object itself (single GETs, write
      responses, and the items of a composed list — a cached namespace
      list is a memcpy-join of these on a hit, zero serialization);
    - ``event_bytes(etype, obj)``: the full watch wire line
      ``{"type": ..., "object": ...}\\n``, composed from ``obj_bytes``
      and cached per event type — every subscriber of the same event
      fans out the SAME bytes object, so an event is serialized exactly
      once no matter how many watchers are connected.

    Objects without kind/name/resourceVersion (Status docs, synthetic
    bodies) bypass the cache and serialize directly.
    """

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._lock = _sanitizer.new_lock("serialized-bytes-cache")
        self._data: "OrderedDict[tuple, bytes]" = OrderedDict()
        # plain monotonic ints (same posture as the informer's hot-path
        # counters): a lock+label Counter.inc per response would cost
        # more than the serialization it saves
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(obj: Obj, variant: str = "") -> Optional[tuple]:
        m = obj.get("metadata")
        if not isinstance(m, dict):
            return None
        rv = m.get("resourceVersion")
        name = m.get("name")
        if not rv or not name:
            return None
        return (
            variant,
            obj.get("kind", ""),
            m.get("namespace") or "",
            name,
            rv,
        )

    def _get(self, key: tuple) -> Optional[bytes]:
        with self._lock:
            data = self._data.get(key)
            if data is not None:
                self._data.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return data

    def _put(self, key: tuple, data: bytes) -> None:
        with self._lock:
            self._data[key] = data
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def obj_bytes(self, obj: Obj) -> bytes:
        key = self._key(obj)
        if key is None:
            return serialize.dumps(obj)
        data = self._get(key)
        if data is None:
            data = serialize.dumps(obj)  # outside the lock
            self._put(key, data)
        return data

    def event_bytes(self, etype: str, obj: Obj) -> bytes:
        key = self._key(obj, variant=etype)
        if key is None:
            return (
                b'{"type": ' + serialize.dumps(etype)
                + b', "object": ' + serialize.dumps(obj) + b"}\n"
            )
        data = self._get(key)
        if data is None:
            # composed, not re-serialized: the object bytes are shared
            # with obj_bytes consumers (list items, single GETs)
            data = (
                b'{"type": "' + etype.encode() + b'", "object": '
                + self.obj_bytes(obj) + b"}\n"
            )
            self._put(key, data)
        return data

    def list_bytes(
        self,
        kind: str,
        items: Iterable[Obj],
        continue_token: Optional[str] = None,
    ) -> bytes:
        """The full ``{kind}List`` response payload, byte-identical to
        ``json.dumps({"kind": f"{kind}List", "apiVersion": "v1",
        "items": [...]})``, composed from per-object cached bytes.
        Paginated responses (``continue_token`` not None, may be "")
        additionally carry kube's ListMeta ``metadata.continue``."""
        inner = b", ".join(self.obj_bytes(o) for o in items)
        meta = b""
        if continue_token is not None:
            meta = (
                b'"metadata": {"continue": '
                + serialize.dumps(continue_token)
                + b"}, "
            )
        return (
            b'{"kind": "' + kind.encode() + b'List", "apiVersion": "v1", '
            + meta
            + b'"items": [' + inner + b"]}"
        )

    # whole-list payloads, keyed by the store's per-kind mutation
    # version (``APIServer.kind_version``): between bumps a kind's list
    # output is immutable, so a repeat list request serves the SAME
    # bytes without touching the store — no per-object deepcopy, no
    # selector walk, no serialization. This is what makes a cached
    # namespace list "one C call end-to-end" on a hit.

    def list_payload(self, key: tuple) -> Optional[bytes]:
        return self._get(("LIST",) + key)

    def store_list_payload(self, key: tuple, payload: bytes) -> None:
        self._put(("LIST",) + key, payload)


class CachedClient:
    """APIServer-duck-typed façade: reads served from the informer
    cache (zero-copy hits), writes and uncached kinds delegated to the
    wrapped api. Handing this to a controller or web backend converts
    its whole read path without touching its code."""

    def __init__(self, api: Any, cache: InformerCache):
        self.api = api
        self.cache = cache
        self._ready: set[str] = set()  # kinds seen synced (never unsync)

    # -- reads ---------------------------------------------------------------

    def _serving(self, kind: str) -> bool:
        c = self.cache
        if kind not in self._ready:
            if not (c.has_kind(kind) and c.synced(kind)):
                return False
            self._ready.add(kind)
        c.poke(kind)
        return True

    def get(self, kind: str, name: str, namespace: Optional[str] = None) -> Obj:
        c = self.cache
        if self._serving(kind):
            try:
                obj = c.get(kind, name, namespace)
                c._hits[kind] = c._hits.get(kind, 0) + 1
                return obj
            except NotFound:
                # fall through: read-your-writes for an object created
                # a moment ago whose event hasn't landed, and a uniform
                # NotFound surface for genuinely absent objects
                pass
        c._misses[kind] = c._misses.get(kind, 0) + 1
        return self.api.get(kind, name, namespace)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
    ) -> list[Obj]:
        c = self.cache
        if self._serving(kind):
            c._hits[kind] = c._hits.get(kind, 0) + 1
            return c.list(kind, namespace, label_selector, field_matches, limit)
        c._misses[kind] = c._misses.get(kind, 0) + 1
        if limit:
            return self.api.list(
                kind,
                namespace=namespace,
                label_selector=label_selector,
                field_matches=field_matches,
                limit=limit,
            )
        # legacy call shape: duck apis (test fakes) predate `limit`
        return self.api.list(
            kind,
            namespace=namespace,
            label_selector=label_selector,
            field_matches=field_matches,
        )

    def by_index(
        self,
        kind: str,
        index: str,
        key: str,
        namespace: Optional[str] = None,
    ) -> Optional[list[Obj]]:
        """Indexed lookup, or None when the kind isn't cache-served yet
        (callers fall back to a selector list)."""
        c = self.cache
        if self._serving(kind):
            c._hits[kind] = c._hits.get(kind, 0) + 1
            return c.by_index(kind, index, key, namespace)
        return None

    def index_buckets(self, kind: str, index: str) -> Optional[dict[str, list[Obj]]]:
        """All buckets of a field index, or None when uncached."""
        c = self.cache
        if self._serving(kind):
            c._hits[kind] = c._hits.get(kind, 0) + 1
            return c.index_buckets(kind, index)
        return None

    def listing_versions(self, kinds: tuple[str, ...]) -> Optional[tuple]:
        """Mirror versions for a listing's whole read set, or None when
        any kind is still store-served (unsynced, unregistered) — a
        memo key must cover every kind the rows derive from, and store
        reads have no cheap version to key on. ``_serving`` pokes each
        kind first, so pending events are applied (and counted) before
        the version is read: read-your-writes holds for the memo
        exactly as it does for the reads themselves."""
        if not kinds:
            return None
        versions = []
        for kind in kinds:
            if not self._serving(kind):
                return None
            versions.append(self.cache.mirror_version(kind))
        return tuple(versions)

    # -- everything else (writes, watches, registry) -------------------------

    def __getattr__(self, name: str):
        return getattr(self.api, name)


def list_by_index(
    api: Any,
    kind: str,
    index: str,
    key: str,
    namespace: Optional[str] = None,
    fallback_selector: Optional[Obj] = None,
) -> list[Obj]:
    """Index lookup against a CachedClient, degrading to a selector
    list on a plain api (tests constructing controllers with the raw
    store keep working)."""
    fn = getattr(api, "by_index", None)
    if fn is not None:
        out = fn(kind, index, key, namespace=namespace)
        if out is not None:
            return out
    return api.list(kind, namespace=namespace, label_selector=fallback_selector)


def register_platform_indexers(cache: InformerCache) -> None:
    """The platform's standing indexes — every converted hot path reads
    through one of these:

    - Pods by controller owner UID (``owner-uid``), by gang workload
      label, by StatefulSet-member label, by PVC claim (``pvc``), and
      by requested GPUs (the ``tpu`` index keeps its name; its key is
      ``apis.pod_gpus`` as a string, precomputed at write time so
      bookkeeping passes never re-parse pod resources);
    - StatefulSets by owner UID and by the ``notebook-name`` label;
    - Workloads by queue (the profile namespace — quota pools are
      per-namespace);
    - Nodes by GKE nodepool (one pool == one GPU node pool);
    - Events by involved object (``"<kind>/<name>"``).
    """
    from odh_kubeflow_tpu_torch.apis import pod_gpus
    from odh_kubeflow_tpu_torch.scheduling import WORKLOAD_LABEL

    def pod_tpu(obj: Obj) -> list[str]:
        gpus = int(pod_gpus(obj))
        return [str(gpus)] if gpus > 0 else []

    def pod_pvcs(obj: Obj) -> list[str]:
        return [
            claim
            for vol in obj_util.get_path(obj, "spec", "volumes", default=[]) or []
            if (claim := obj_util.get_path(vol, "persistentVolumeClaim", "claimName"))
        ]

    def event_involved(obj: Obj) -> list[str]:
        inv = obj.get("involvedObject") or {}
        name = inv.get("name", "")
        return [f"{inv.get('kind', '')}/{name}"] if name else []

    def node_pool(obj: Obj) -> list[str]:
        pool = obj_util.labels_of(obj).get("cloud.google.com/gke-nodepool")
        return [pool] if pool else []

    def workload_queue(obj: Obj) -> list[str]:
        ns = obj_util.namespace_of(obj)
        return [ns] if ns else []

    if cache.has_kind("Pod"):
        cache.register_indexer("Pod", "owner-uid", _owner_uids)
        cache.register_indexer("Pod", "tpu", pod_tpu)
        cache.register_indexer("Pod", "pvc", pod_pvcs)
        cache.register_label_index("Pod", "statefulset")
        cache.register_label_index("Pod", "notebook-name")
        cache.register_label_index("Pod", WORKLOAD_LABEL)
    if cache.has_kind("StatefulSet"):
        cache.register_indexer("StatefulSet", "owner-uid", _owner_uids)
        cache.register_label_index("StatefulSet", "notebook-name")
    if cache.has_kind("Workload"):
        cache.register_indexer("Workload", "queue", workload_queue)
    if cache.has_kind("Node"):
        cache.register_indexer("Node", "nodepool", node_pool)
    if cache.has_kind("Event"):
        cache.register_indexer("Event", "involved", event_involved)
    if cache.has_kind("Tensorboard"):
        cache.register_label_index("Tensorboard", "tensorboard")
