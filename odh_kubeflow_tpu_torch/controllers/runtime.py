"""Controller runtime: level-triggered reconciliation over the APIServer
(the port's copy of the JAX package's ``controllers/runtime.py``).

A from-scratch controller-runtime equivalent:

- ``Controller``: owns a workqueue of (namespace, name) requests; a
  reconcile function is invoked per key, never concurrently for the
  same key, with rate-limited error backoff and ``Result.requeue_after``.
- ``For/Owns/Watches`` wiring: the primary kind enqueues itself; owned
  kinds map back through the controller ownerReference; arbitrary
  watches use a mapping function (the reference uses this for
  Event→Notebook re-emission and Pod→Notebook by label).
- ``Manager``: starts each controller's watch pumps + worker, exposes
  ``drain()`` for deterministic single-threaded tests (process every
  pending event/request until quiescent — the envtest idiom without
  sleeps).

Each reconcile runs in a ``reconcile`` span (``utils/tracing.py``) on
the trace its triggering object carries (the store's CREATE stamp), so
a web request's spawn assembles into one trace, and under one
end-to-end deadline (``machinery/overload.py``,
``REQUEST_DEADLINE_DEFAULT``): an attempt whose deadline expires goes
to the error-backoff requeue.

High availability: a Manager built with the shared informer cache
(``machinery/cache.py``) feeds its controllers through event handlers
and waits for the cache's sync before reconciling; with a
``LeaderElector`` or a ``ShardMembership`` (``machinery/leader.py``)
every reconcile runs inside the holder's fence, a write rejected by
fencing latches ``fenced_out`` and drops the key (the elector decides
the stand-down), and a shard member reconciles only the namespaces it
owns. The rate limiter's and the workqueue's locks come from the
lock-order sanitizer's factory (``analysis/sanitizer.py``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.analysis import sanitizer as _sanitizer
from odh_kubeflow_tpu_torch.machinery import objects as obj_util, overload
from odh_kubeflow_tpu_torch.machinery.store import (
    APIServer,
    FencedOut,
    NotLeader,
    Watch,
)
from odh_kubeflow_tpu_torch.utils import prometheus, tracing

log = logging.getLogger("controller-runtime")

Obj = dict[str, Any]

# workqueue latencies span µs (drain tests) to many seconds (backoff)
_QUEUE_BUCKETS = (
    0.0001, 0.001, 0.01, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
)
_RECONCILE_BUCKETS = (
    0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0,
)


class RuntimeMetrics:
    """The controller-runtime metric surface (its exact metric names,
    so reference dashboards/alerts port over), labelled per controller.
    One instance per Manager; registering twice against one shared
    registry converges on the same series (Registry is get-or-create)."""

    def __init__(self, registry: prometheus.Registry):
        self.depth = registry.gauge(
            "workqueue_depth",
            "Current depth of the workqueue",
            labelnames=("name",),
        )
        self.adds = registry.counter(
            "workqueue_adds_total",
            "Total number of adds handled by the workqueue",
            labelnames=("name",),
        )
        self.queue_duration = registry.histogram(
            "workqueue_queue_duration_seconds",
            "How long a request stays in the workqueue before processing",
            buckets=_QUEUE_BUCKETS,
            labelnames=("name",),
        )
        self.reconcile_time = registry.histogram(
            "controller_runtime_reconcile_time_seconds",
            "Length of time per reconciliation",
            buckets=_RECONCILE_BUCKETS,
            labelnames=("controller",),
        )
        self.reconcile_errors = registry.counter(
            "controller_runtime_reconcile_errors_total",
            "Total number of reconciliations that returned an error",
            labelnames=("controller",),
        )
        self.reconcile_total = registry.counter(
            "controller_runtime_reconcile_total",
            "Total number of reconciliations per controller and result",
            labelnames=("controller", "result"),
        )


@dataclass(frozen=True)
class Request:
    namespace: str
    name: str


@dataclass
class Result:
    requeue_after: Optional[float] = None  # seconds


@dataclass
class _WatchSpec:
    kind: str
    map_fn: Callable[[str, Obj], list[Request]]
    predicate: Optional[Callable[[str, Obj], bool]] = None


class _RateLimiter:
    """Per-key exponential backoff: 5ms * 2^failures, capped at 16s.
    ``when``/``forget`` run from every worker thread (``_process``), so
    the failure map is guarded by its own lock."""

    def __init__(self, base: float = 0.005, cap: float = 16.0):
        self.base = base
        self.cap = cap
        self.failures: dict[Request, int] = {}
        # the backoff sleep stays OUT of this critical section; the
        # sanitizer's blocking-under-lock probe guards the invariant at
        # runtime (tests/test_torch_schedule.py)
        self._lock = _sanitizer.new_lock("controller.ratelimiter")

    def when(self, req: Request) -> float:
        with self._lock:
            n = self.failures.get(req, 0)
            self.failures[req] = n + 1
        return min(self.base * (2**n), self.cap)

    def forget(self, req: Request) -> None:
        with self._lock:
            self.failures.pop(req, None)


class Controller:
    def __init__(
        self,
        name: str,
        api: APIServer,
        reconcile: Callable[[Request], Optional[Result]],
        for_kind: str,
        time_fn: Callable[[], float] = time.monotonic,
        workers: int = 1,
        metrics: Optional[RuntimeMetrics] = None,
        for_map: Optional[Callable[[str, Obj], list[Request]]] = None,
        informer: Optional[Any] = None,
        fence_fn: Optional[Callable[[], Any]] = None,
        shard: Optional[Any] = None,
    ):
        self.name = name
        self.api = api
        self.reconcile = reconcile
        self.for_kind = for_kind
        self.time_fn = time_fn
        # fence_fn() returns a context manager installing the replica's
        # current lease epoch around the reconcile body, so every store
        # write it issues is fencing-token checked (a deposed replica's
        # in-flight writes are rejected, not applied). None = unfenced.
        self.fence_fn = fence_fn
        # shard (machinery.leader.ShardMembership): when set, this
        # replica only reconciles namespaces it owns under the current
        # membership — two replicas never reconcile the same object.
        self.shard = shard
        # shared informer cache (Manager-owned): kinds it serves feed
        # this controller through event handlers — one frozen copy per
        # store event for ALL controllers — instead of a private watch
        self.informer = informer
        # a standalone Controller gets a private sink registry; the
        # Manager path shares its RuntimeMetrics across controllers
        self.metrics = metrics or RuntimeMetrics(prometheus.Registry())
        self._m_depth = self.metrics.depth.labels(name=name)
        self._m_adds = self.metrics.adds.labels(name=name)
        self._m_queue_duration = self.metrics.queue_duration.labels(name=name)
        self._m_reconcile_time = self.metrics.reconcile_time.labels(
            controller=name
        )
        self._m_reconcile_errors = self.metrics.reconcile_errors.labels(
            controller=name
        )
        # MaxConcurrentReconciles: workers share the queue but a key is
        # never reconciled by two workers at once (controller-runtime
        # semantics). >1 keeps one slow reconcile — e.g. a culler probe
        # against a dead notebook burning its 5s timeout — from
        # stalling every other notebook.
        self.workers = max(int(workers), 1)
        self._inflight: set[Request] = set()
        self._watch_specs: list[_WatchSpec] = []
        self._watches: list[Watch] = []
        self._queue: list[Request] = []
        self._queued: set[Request] = set()
        self._delayed: list[tuple[float, Request]] = []
        # per-request enqueue instant (workqueue_queue_duration), under
        # _cv with the queue itself
        self._enqueued_at: dict[Request, float] = {}
        # the trace id carried from the triggering watch object, popped
        # when the request is processed
        self._req_trace: dict[Request, str] = {}
        self._lock = _sanitizer.new_lock(f"workqueue.{name}")
        self._cv = threading.Condition(self._lock)
        self._limiter = _RateLimiter()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # latched when a reconcile write is rejected by the fencing
        # check — the observable trace of a deposed (or stalled-past-
        # expiry) epoch between the rejection and the elector's verdict
        self.fenced_out = False

        # ``for_map`` maps the kind's own events (by default, one request
        # per object)
        self.watches(
            for_kind,
            for_map or (lambda _etype, obj: [
                Request(obj_util.namespace_of(obj), obj_util.name_of(obj))
            ]),
        )

    # -- wiring -------------------------------------------------------------

    def owns(self, kind: str) -> "Controller":
        """Enqueue the owner (of ``for_kind``) of changed child objects."""

        def map_owner(_etype: str, obj: Obj) -> list[Request]:
            for ref in obj_util.meta(obj).get("ownerReferences") or []:
                if ref.get("kind") == self.for_kind and ref.get("controller", True):
                    return [Request(obj_util.namespace_of(obj), ref.get("name", ""))]
            return []

        return self.watches(kind, map_owner)

    def watches(
        self,
        kind: str,
        map_fn: Callable[[str, Obj], list[Request]],
        predicate: Optional[Callable[[str, Obj], bool]] = None,
    ) -> "Controller":
        self._watch_specs.append(_WatchSpec(kind, map_fn, predicate))
        return self

    # -- queue --------------------------------------------------------------

    def enqueue(
        self,
        req: Request,
        after: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> None:
        with self._cv:
            if trace_id:
                self._req_trace[req] = trace_id
            if after:
                self._delayed.append((self.time_fn() + after, req))
            elif req not in self._queued:
                self._queue.append(req)
                self._queued.add(req)
                self._enqueued_at.setdefault(req, self.time_fn())
                self._m_adds.inc()
                self._m_depth.set(len(self._queue))
            self._cv.notify_all()

    def _pop(self, timeout: Optional[float]) -> Optional[Request]:
        deadline = self.time_fn() + timeout if timeout is not None else None
        with self._cv:
            while True:
                now = self.time_fn()
                ready = [d for d in self._delayed if d[0] <= now]
                for d in ready:
                    self._delayed.remove(d)
                    if d[1] not in self._queued:
                        self._queue.append(d[1])
                        self._queued.add(d[1])
                        # queue duration measures READY time: a delayed
                        # requeue starts its clock when it becomes due
                        self._enqueued_at.setdefault(d[1], now)
                        self._m_adds.inc()
                        self._m_depth.set(len(self._queue))
                # hand out the first key not currently being reconciled
                # by another worker (per-key exclusion)
                for i, req in enumerate(self._queue):
                    if req not in self._inflight:
                        self._queue.pop(i)
                        self._queued.discard(req)
                        self._inflight.add(req)
                        self._m_depth.set(len(self._queue))
                        t0 = self._enqueued_at.pop(req, None)
                        if t0 is not None:
                            self._m_queue_duration.observe(
                                max(self.time_fn() - t0, 0.0)
                            )
                        return req
                if self._stop.is_set():
                    return None
                waits = [0.05]
                if deadline is not None:
                    if now >= deadline:
                        return None
                    waits.append(deadline - now)
                if self._delayed:
                    waits.append(max(min(d[0] for d in self._delayed) - now, 0.001))
                self._cv.wait(timeout=min(waits))

    def _process(self, req: Request) -> None:
        with self._cv:
            trace_id = self._req_trace.pop(req, None)
        if self.shard is not None and not self.shard.owns(req.namespace):
            # not ours under the current membership: the owning replica
            # sees the same watch events and reconciles it. Checked at
            # process time (not enqueue) so a reshard between the two
            # re-routes instead of dropping.
            self.metrics.reconcile_total.inc(
                {"controller": self.name, "result": "sharded_out"}
            )
            self._done(req)
            self._limiter.forget(req)
            return
        key = f"{req.namespace}/{req.name}"
        start = self.time_fn()
        with tracing.span(
            "reconcile", trace_id=trace_id, controller=self.name, reconcile_key=key
        ):
            try:
                # one reconcile runs under one end-to-end deadline: every
                # API call it makes carries the remaining budget, so a
                # wedged apiserver cannot pin a worker forever — the
                # attempt 504s and the error-backoff requeue takes over
                fence = self.fence_fn() if self.fence_fn else contextlib.nullcontext()
                with fence, overload.deadline_scope():
                    result = self.reconcile(req) or Result()
            except (FencedOut, NotLeader) as e:
                self._m_reconcile_time.observe(self.time_fn() - start)
                self.metrics.reconcile_total.inc(
                    {"controller": self.name, "result": "fenced_out"}
                )
                tracing.set_status("error", f"{type(e).__name__}: {e}")
                self.fenced_out = True  # recorded for operators/drills
                log.error(
                    "%s: reconcile %s rejected by fencing (%s); dropping "
                    "the key without requeue — the elector owns the "
                    "stand-down decision",
                    self.name,
                    req,
                    e,
                )
                self._done(req)
                self._limiter.forget(req)
                return
            except Exception as e:
                self._m_reconcile_time.observe(self.time_fn() - start)
                self._m_reconcile_errors.inc()
                self.metrics.reconcile_total.inc(
                    {"controller": self.name, "result": "error"}
                )
                # handled here, inside the span: mark it, or the
                # collector's keep-error-traces rule cannot fire
                tracing.set_status("error", f"{type(e).__name__}: {e}")
                log.exception("%s: reconcile %s failed", self.name, req)
                self._done(req)
                # the retry is the same unit of work: it keeps the trace
                self.enqueue(req, after=self._limiter.when(req), trace_id=trace_id)
                return
            elapsed = self.time_fn() - start
            self._m_reconcile_time.observe(elapsed)
            self.metrics.reconcile_total.inc(
                {
                    "controller": self.name,
                    "result": "requeue_after" if result.requeue_after else "success",
                }
            )
            log.debug(
                "%s: reconciled %s in %.6fs%s",
                self.name,
                key,
                elapsed,
                f" (requeue after {result.requeue_after}s)"
                if result.requeue_after
                else "",
            )
        self._done(req)
        self._limiter.forget(req)
        if result.requeue_after:
            self.enqueue(req, after=result.requeue_after)

    def _done(self, req: Request) -> None:
        with self._cv:
            self._inflight.discard(req)
            self._cv.notify_all()

    # -- event pumping ------------------------------------------------------

    def _start_watches(self) -> None:
        for spec in self._watch_specs:
            if self.informer is not None and self.informer.has_kind(spec.kind):
                # informer-fed: the shared cache pushes events (with an
                # ADDED replay of current state) — no private watch, no
                # per-controller event copy
                self.informer.add_handler(
                    spec.kind,
                    lambda etype, obj, _spec=spec: self._handle_event(_spec, etype, obj),
                )
                self._watches.append(None)
            else:
                self._watches.append(self.api.watch(spec.kind))

    def _handle_event(self, spec: _WatchSpec, etype: str, obj: Obj) -> None:
        if spec.predicate and not spec.predicate(etype, obj):
            return
        # the store stamps the creating request's trace id onto the
        # object; carry it so the reconcile joins that trace
        trace_id = tracing.trace_id_of(obj)
        for req in spec.map_fn(etype, obj):
            if req.name:
                self.enqueue(req, trace_id=trace_id)

    def _pump_once(self, spec_idx: int, timeout: float = 0.0) -> bool:
        """Drain one event from watch ``spec_idx``; returns False if none."""
        w = self._watches[spec_idx]
        if w is None:  # informer-fed spec: events arrive via handler
            return False
        spec = self._watch_specs[spec_idx]
        item = w.get(timeout=timeout) if timeout else w.try_get()
        if item is None:
            return False
        etype, obj = item
        self._handle_event(spec, etype, obj)
        return True

    # -- execution ----------------------------------------------------------

    def start(self) -> None:
        self._start_watches()

        def pump(i: int):
            while not self._stop.is_set():
                self._pump_once(i, timeout=0.2)

        for i in range(len(self._watch_specs)):
            if self._watches[i] is None:
                continue  # informer-fed: the cache's pump delivers
            t = threading.Thread(target=pump, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)
        for _ in range(self.workers):
            worker = threading.Thread(target=self._worker, daemon=True)
            worker.start()
            self._threads.append(worker)

    def _worker(self) -> None:
        while not self._stop.is_set():
            req = self._pop(timeout=0.2)
            if req is not None:
                self._process(req)

    def stop(self) -> None:
        self._stop.set()
        for w in self._watches:
            if w is not None:
                w.stop()
        with self._cv:
            self._cv.notify_all()

    # -- deterministic drain (tests) ----------------------------------------

    def drain_once(self) -> bool:
        """Pump all watch events, process all due requests. Returns True
        if anything happened."""
        if not self._watches:
            self._start_watches()
        moved = False
        if self.informer is not None and self.informer.drain_once():
            moved = True
        for i in range(len(self._watch_specs)):
            while self._pump_once(i):
                moved = True
        while True:
            with self._cv:
                has = bool(self._queue) or any(
                    d[0] <= self.time_fn() for d in self._delayed
                )
            if not has:
                break
            req = self._pop(timeout=0)
            if req is None:
                break
            self._process(req)
            moved = True
        return moved


class Manager:
    def __init__(
        self,
        api: APIServer,
        time_fn: Callable[[], float] = time.monotonic,
        registry: Optional[prometheus.Registry] = None,
        cache: Optional[Any] = None,
        elector: Optional[Any] = None,
        shard: Optional[Any] = None,
    ):
        self.api = api
        self.time_fn = time_fn
        self.controllers: list[Controller] = []
        # every controller the manager runs instruments into this one
        # registry (controller-runtime's metrics.Registry equivalent)
        self.metrics_registry = registry or prometheus.Registry()
        self._runtime_metrics = RuntimeMetrics(self.metrics_registry)
        self.cache = cache
        self._cache_started = False
        self.elector = elector
        self.shard = shard
        if shard is not None and hasattr(shard, "add_on_change"):
            shard.add_on_change(self._reshard_resync)

    def _reshard_resync(self, old: list[str], new: list[str]) -> None:
        """Membership changed: re-enqueue every primary object so keys
        in namespaces this replica NEWLY owns get reconciled. A peer
        that expired left no watch event behind; without this resync
        its slice would sit unreconciled until the next organic event.
        Keys still owned elsewhere are filtered at process time."""
        log.info(
            "shard membership changed %s -> %s; resyncing %d controllers",
            old,
            new,
            len(self.controllers),
        )
        for c in self.controllers:
            try:
                objs = self.api.list(c.for_kind)
            except Exception:  # noqa: BLE001 — API blip; next change retries
                log.exception("reshard resync list %s failed", c.for_kind)
                continue
            for obj in objs:
                c.enqueue(Request(obj_util.namespace_of(obj), obj_util.name_of(obj)))

    def _fence_fn(self) -> Optional[Callable[[], Any]]:
        if self.shard is not None:
            return self.shard.fence
        if self.elector is not None:
            return self.elector.fence
        return None

    def new_controller(
        self,
        name: str,
        for_kind: str,
        reconcile: Callable[[Request], Optional[Result]],
        workers: Optional[int] = None,
        for_map: Optional[Callable[[str, Obj], list[Request]]] = None,
    ) -> Controller:
        if workers is None:
            workers = int(os.environ.get("MAX_CONCURRENT_RECONCILES", "1"))
        ctrl = Controller(
            name,
            self.api,
            reconcile,
            for_kind,
            time_fn=self.time_fn,
            workers=workers,
            metrics=self._runtime_metrics,
            for_map=for_map,
            informer=self.cache,
            fence_fn=self._fence_fn(),
            shard=self.shard,
        )
        self.controllers.append(ctrl)
        return ctrl

    def _ensure_cache(self, live: bool) -> None:
        if self.cache is None:
            return
        # informer start + sync barrier: controllers must never see a
        # half-primed cache (controller-runtime's WaitForCacheSync
        # contract). start() is idempotent and upgrades a drain-mode
        # cache to live pumps.
        if not self._cache_started or live:
            self.cache.start(live=live)
        if not self._cache_started:
            self.cache.wait_for_sync()
            self._cache_started = True

    def start(self) -> None:
        self._ensure_cache(live=True)
        for c in self.controllers:
            c.start()

    def stop(self) -> None:
        for c in self.controllers:
            c.stop()
        if self.cache is not None and self._cache_started:
            self.cache.stop()

    def drain(self, max_rounds: int = 60) -> None:
        """Run controllers synchronously until no controller has pending
        work (the deterministic test idiom — no sleeps, no races)."""
        self._ensure_cache(live=False)
        for _ in range(max_rounds):
            cache_moved = self.cache.drain_once() if self.cache is not None else False
            if not any(c.drain_once() for c in self.controllers) and not cache_moved:
                return
        raise RuntimeError("manager did not quiesce; reconcile livelock?")
