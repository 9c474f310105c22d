"""Deterministic fault injection for the control plane (the port's copy
of the JAX package's ``machinery/faults.py``).

The reference platform inherits its fault tolerance from kube-apiserver
and client-go; this rebuild has to *prove* the equivalent machinery
works, which needs an API path that misbehaves on demand and
reproducibly. :class:`FaultInjector` wraps any ``APIServer``-shaped
object (the embedded store, ``RemoteAPIServer``, ``CachedClient``) and
injects faults per a seeded :class:`FaultSchedule`:

- transient ``Conflict`` on mutating verbs (optimistic-concurrency
  races under contention);
- ``TooManyRequests`` (429) with a Retry-After hint (APF load shed);
- 5xx ``APIError`` (apiserver blips);
- added latency;
- watch-stream drops (a live watch "dies" mid-stream: ``ended`` is set
  and the ``None`` sentinel delivered, exactly what a broken HTTP
  stream looks like to consumers);
- resourceVersion expiry (``Expired``/410) on watch resume.

Every decision comes from a ``random.Random`` derived from the seed —
one per consumer thread, keyed by thread registration order — so a
single-threaded chaos run (the test suite) replays exactly from its
seed, and a multi-threaded soak is seed-stable per thread (cross-thread
interleaving belongs to the OS scheduler). ``GRAFT_CHAOS=<seed>`` turns
injection on for live processes via :func:`maybe_wrap` (the runner
calls it); unset means zero overhead — consumers get the raw api.

``set_offline(True)`` simulates a full partition: every call raises a
5xx and all live watch streams drop, until ``set_offline(False)``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.machinery.store import (
    AlreadyExists,
    APIError,
    Conflict,
    Expired,
    TooManyRequests,
    Watch,
)
from odh_kubeflow_tpu_torch.machinery.wal import CrashPoint, FileIO
from odh_kubeflow_tpu_torch.utils import prometheus

Obj = dict[str, Any]

CHAOS_ENV = "GRAFT_CHAOS"


# ---------------------------------------------------------------------------
# disk faults (the WAL's IO layer)


@dataclass
class DiskFaultSchedule:
    """Per-IO fault probabilities for the WAL's :class:`FileIO`
    surface, drawn from a seeded rng in a fixed order (same replay
    contract as :class:`FaultSchedule`)."""

    torn_write: float = 0.0  # write a random prefix, then die
    fsync_fail: float = 0.0  # fsync raises OSError (write never acked)
    short_read: float = 0.0  # read returns a truncated prefix once
    slow_disk: float = 0.0  # added latency before the IO
    slow_seconds: float = 0.002

    @classmethod
    def default(cls) -> "DiskFaultSchedule":
        return cls(torn_write=0.02, fsync_fail=0.02, short_read=0.05, slow_disk=0.05)

    @classmethod
    def none(cls) -> "DiskFaultSchedule":
        return cls()


class FaultyFileIO(FileIO):
    """WAL IO layer with seeded disk faults. A torn write raises
    :class:`~odh_kubeflow_tpu_torch.machinery.wal.CrashPoint` after flushing
    a random prefix (the classic power-cut shape recovery must
    truncate); a failed fsync raises OSError (the store goes
    fail-stop: the write was never acked); a short read returns a
    truncated prefix exactly once per draw (recovery's stable-read
    confirm pass must catch it instead of truncating acked history).
    ``counts`` records what fired, for drill assertions."""

    def __init__(
        self,
        seed: int = 1,
        schedule: Optional[DiskFaultSchedule] = None,
        sleep_fn: Optional[Callable[[float], None]] = None,
    ):
        self.rng = random.Random(seed)
        self.schedule = schedule if schedule is not None else DiskFaultSchedule.default()
        self._sleep = sleep_fn
        self.counts: dict[str, int] = {}

    def _count(self, kind: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def write(self, f, data: bytes) -> None:
        s = self.schedule
        if s.slow_disk and self.rng.random() < s.slow_disk:
            self._count("slow_disk")
            (self._sleep or time.sleep)(s.slow_seconds)
        if s.torn_write and self.rng.random() < s.torn_write:
            self._count("torn_write")
            keep = self.rng.randrange(len(data) + 1) if data else 0
            f.write(data[:keep])
            f.flush()
            raise CrashPoint(f"torn write: {keep}/{len(data)} bytes hit disk")
        super().write(f, data)

    def fsync(self, f) -> None:
        s = self.schedule
        if s.slow_disk and self.rng.random() < s.slow_disk:
            self._count("slow_disk")
            (self._sleep or time.sleep)(s.slow_seconds)
        if s.fsync_fail and self.rng.random() < s.fsync_fail:
            self._count("fsync_fail")
            raise OSError("injected fsync failure")
        super().fsync(f)

    def read_bytes(self, path: str) -> bytes:
        data = super().read_bytes(path)
        s = self.schedule
        if data and s.short_read and self.rng.random() < s.short_read:
            self._count("short_read")
            return data[: self.rng.randrange(len(data))]
        return data


class KillPointIO(FileIO):
    """Deterministic process-death injection: dies with
    :class:`CrashPoint` at the N-th WAL IO op (write/fsync calls,
    counted in order), so a drill can enumerate every commit point —
    mid-append (torn record), pre-fsync (record in page cache only),
    post-fsync pre-ack (durable but unacked). On death the un-fsynced
    tail of the file is cut to a seeded random length, simulating the
    page cache partially reaching disk. ``after_op=True`` performs the
    fatal op first, then dies (the crash-after-fsync-before-ack
    point)."""

    def __init__(self, kill_at_op: int, seed: int = 1, after_op: bool = False):
        self.kill_at = kill_at_op
        self.after_op = after_op
        self.rng = random.Random(seed)
        self.ops = 0
        self.dead = False
        # path → bytes known durable (fsync high-water mark)
        self._durable: dict[str, int] = {}

    def _tick(self) -> bool:
        self.ops += 1
        return self.ops >= self.kill_at

    def _die(self, f, partial: Optional[bytes] = None) -> None:
        self.dead = True
        if partial is not None:
            keep = self.rng.randrange(len(partial) + 1) if partial else 0
            f.write(partial[:keep])
        f.flush()
        # drop a seeded suffix of the un-fsynced page-cache tail
        name = getattr(f, "name", None)
        if name is not None:
            size = os.path.getsize(name)
            durable = self._durable.get(name, 0)
            if size > durable:
                keep_to = durable + self.rng.randrange(size - durable + 1)
                with open(name, "r+b") as trunc:
                    trunc.truncate(keep_to)
        raise CrashPoint(f"injected process death at io op {self.ops}")

    def write(self, f, data: bytes) -> None:
        if self.dead:
            raise CrashPoint("process already dead")
        if self._tick() and not self.after_op:
            self._die(f, partial=data)
        super().write(f, data)
        if self.ops >= self.kill_at and self.after_op:
            self._die(f)

    def fsync(self, f) -> None:
        if self.dead:
            raise CrashPoint("process already dead")
        fatal = self._tick()
        if fatal and not self.after_op:
            self._die(f)
        super().fsync(f)
        name = getattr(f, "name", None)
        if name is not None:
            self._durable[name] = os.path.getsize(name)
        if fatal and self.after_op:
            self._die(f)


@dataclass
class FaultSchedule:
    """Per-call fault probabilities (independent gates, evaluated in a
    fixed order so a seed fully determines the run)."""

    conflict: float = 0.0  # mutating verbs only
    too_many_requests: float = 0.0
    server_error: float = 0.0
    latency: float = 0.0
    latency_seconds: float = 0.002
    watch_drop: float = 0.0  # per faultable call: kill one live watch
    expire: float = 0.0  # watch resume from an rv → 410
    retry_after: float = 0.02  # hint carried on injected 429s

    @classmethod
    def default(cls) -> "FaultSchedule":
        """The CI chaos mix: frequent transient failures, occasional
        stream loss and expiry — rough but survivable weather."""
        return cls(
            conflict=0.05,
            too_many_requests=0.05,
            server_error=0.03,
            latency=0.05,
            watch_drop=0.02,
            expire=0.2,
        )

    @classmethod
    def none(cls) -> "FaultSchedule":
        return cls()


class FaultInjector:
    """APIServer-duck-typed wrapper that injects scheduled faults in
    front of the wrapped api's verbs. Everything non-verb (registries,
    admission, convenience helpers it doesn't wrap) delegates through
    ``__getattr__`` untouched."""

    def __init__(
        self,
        api: Any,
        seed: int = 1,
        schedule: Optional[FaultSchedule] = None,
        registry: Optional[prometheus.Registry] = None,
        sleep_fn: Optional[Callable[[float], None]] = None,
    ):
        self.api = api
        self.seed = seed
        # per-thread rngs derived from (seed, thread-registration
        # order): a single-threaded chaos run replays exactly from
        # its seed; a multi-threaded soak is seed-stable per thread
        # (interleaving across threads is the OS scheduler's, not ours)
        self._rng_local = threading.local()
        self._rng_lock = threading.Lock()
        self._thread_seq = 0
        self.schedule = schedule if schedule is not None else FaultSchedule.default()
        self._sleep = sleep_fn
        self._offline = False
        # tracked live streams (drop candidates); guarded — fault
        # points run on every consumer thread — and pruned of
        # consumer-stopped/dead watches so a long chaos soak doesn't
        # pin every Watch ever opened
        self._watches: list[Watch] = []
        self._watch_lock = threading.Lock()
        reg = registry or prometheus.default_registry
        self.m_faults = reg.counter(
            "faults_injected_total",
            "Faults injected into the API path by the chaos layer",
            labelnames=("kind",),
        )

    # -- control surface ----------------------------------------------------

    def set_offline(self, offline: bool) -> None:
        """Simulate a network partition: every call errors and every
        live watch stream drops until the partition heals."""
        self._offline = offline
        if offline:
            for w in self._live_watches():
                self._kill_watch(w)

    def set_schedule(self, schedule: FaultSchedule) -> None:
        self.schedule = schedule

    # -- fault machinery ----------------------------------------------------

    def _rng(self) -> random.Random:
        r = getattr(self._rng_local, "rng", None)
        if r is None:
            with self._rng_lock:
                n = self._thread_seq
                self._thread_seq += 1
            # int-derived sub-seed (tuple seeding is deprecated)
            r = self._rng_local.rng = random.Random(
                self.seed * 1_000_003 + n
            )
        return r

    def _count(self, kind: str) -> None:
        self.m_faults.inc({"kind": kind})

    def _live_watches(self) -> list[Watch]:
        """Current drop candidates; prunes consumer-stopped and dead
        streams from the tracked list as a side effect."""
        with self._watch_lock:
            self._watches = [
                w for w in self._watches if not (w._stopped or w.ended)
            ]
            return list(self._watches)

    def _kill_watch(self, w: Watch) -> None:
        if w._stopped or w.ended:
            self._forget_watch(w)
            return
        w.ended = True
        # the stream is gone: stop delivery from the source, then the
        # sentinel — consumers see exactly a broken HTTP watch
        try:
            w._server._remove_watch(w)
        except (AttributeError, OSError):
            pass  # duck-typed server without watch bookkeeping
        w._q.put(None)
        w._wake()  # event-loop consumers parked on set_notify
        self._forget_watch(w)
        self._count("watch_drop")

    def _forget_watch(self, w: Watch) -> None:
        with self._watch_lock:
            if w in self._watches:
                self._watches.remove(w)

    def _fault_point(self, verb: str, mutating: bool) -> None:
        """One gate per configured fault, drawn in fixed order from the
        calling thread's seeded rng — a single-threaded run's fault
        sequence is fully determined by the seed."""
        if self._offline:
            self._count("outage")
            raise APIError(f"injected outage: {verb} unreachable")
        s = self.schedule
        rng = self._rng()
        if s.latency and rng.random() < s.latency:
            self._count("latency")
            (self._sleep or time.sleep)(s.latency_seconds)
        if s.watch_drop and rng.random() < s.watch_drop:
            live = self._live_watches()
            if live:
                self._kill_watch(rng.choice(live))
        if s.too_many_requests and rng.random() < s.too_many_requests:
            self._count("too_many_requests")
            raise TooManyRequests(
                f"injected 429 on {verb}", retry_after=s.retry_after
            )
        if s.server_error and rng.random() < s.server_error:
            self._count("server_error")
            raise APIError(f"injected server error on {verb}")
        if mutating and s.conflict and rng.random() < s.conflict:
            self._count("conflict")
            raise Conflict(f"injected conflict on {verb}")

    # -- wrapped verbs (APIServer duck type) --------------------------------

    def create(self, obj: Obj, dry_run: bool = False) -> Obj:
        self._fault_point("create", mutating=True)
        return self.api.create(obj, dry_run=dry_run)

    def get(self, kind: str, name: str, namespace: Optional[str] = None) -> Obj:
        self._fault_point("get", mutating=False)
        return self.api.get(kind, name, namespace)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
    ) -> list[Obj]:
        self._fault_point("list", mutating=False)
        if limit:
            return self.api.list(
                kind,
                namespace=namespace,
                label_selector=label_selector,
                field_matches=field_matches,
                limit=limit,
            )
        return self.api.list(
            kind,
            namespace=namespace,
            label_selector=label_selector,
            field_matches=field_matches,
        )

    def list_chunk(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
        continue_token: Optional[str] = None,
    ) -> tuple[list[Obj], str]:
        self._fault_point("list", mutating=False)
        return self.api.list_chunk(
            kind,
            namespace=namespace,
            label_selector=label_selector,
            field_matches=field_matches,
            limit=limit,
            continue_token=continue_token,
        )

    def update(self, obj: Obj) -> Obj:
        self._fault_point("update", mutating=True)
        return self.api.update(obj)

    def update_status(self, obj: Obj) -> Obj:
        self._fault_point("update_status", mutating=True)
        return self.api.update_status(obj)

    def patch(
        self, kind: str, name: str, patch: Obj, namespace: Optional[str] = None
    ) -> Obj:
        self._fault_point("patch", mutating=True)
        return self.api.patch(kind, name, patch, namespace)

    def delete(self, kind: str, name: str, namespace: Optional[str] = None) -> None:
        self._fault_point("delete", mutating=True)
        return self.api.delete(kind, name, namespace)

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        send_initial: bool = True,
        resource_version: Optional[str] = None,
        inline: bool = True,
    ) -> Watch:
        if self._offline:
            self._count("outage")
            raise APIError(f"injected outage: watch {kind} unreachable")
        if (
            resource_version is not None
            and self.schedule.expire
            and self._rng().random() < self.schedule.expire
        ):
            self._count("expired")
            raise Expired(
                f"injected expiry: resourceVersion {resource_version} is "
                "too old"
            )
        # in-process stores take ``inline``; a wrapped RemoteAPIServer
        # does not (it always pumps via a reader thread)
        try:
            w = self.api.watch(
                kind,
                namespace=namespace,
                send_initial=send_initial,
                resource_version=resource_version,
                inline=inline,
            )
        except TypeError:
            w = self.api.watch(
                kind,
                namespace=namespace,
                send_initial=send_initial,
                resource_version=resource_version,
            )
        with self._watch_lock:
            self._watches.append(w)
        return w

    def create_or_get(self, obj: Obj) -> Obj:
        # route through the wrapped verbs so both legs hit fault points
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
        self._fault_point("emit_event", mutating=True)
        return self.api.emit_event(
            involved,
            reason,
            message,
            event_type=event_type,
            component=component,
        )

    # -- digest surface (explicit pass-throughs: a duck served only by
    #    __getattr__ is invisible to conformance checks, and a
    #    chaos-wrapped store must not silently lose the surface the
    #    drills compare) ------------------------------------------------------

    def applied_rv(self) -> Optional[int]:
        return self.api.applied_rv()

    def state_digest(self) -> str:
        return self.api.state_digest()

    def kind_version(self, kind: str) -> int:
        return self.api.kind_version(kind)

    # -- everything else (registry, admission, helpers) ---------------------

    def __getattr__(self, name: str):
        return getattr(self.api, name)


def kill_zone(
    cluster: Any, checkpoint_store: Optional[Any], zone: str
) -> dict[str, Any]:
    """The zone-outage drill's one-call failure injection: every node
    in ``zone`` is preempted (kubelet sim — Node objects deleted,
    bound pods Failed, container memory lost) AND the zone's
    checkpoint-store arm goes dark, in the same instant — the
    correlated failure a real zone loss is. Returns what was killed so
    the drill can assert against it; ``heal`` with
    ``cluster.add_gpu_node_pool(...)`` + ``checkpoint_store.
    heal_zone(zone)``."""
    nodes = cluster.kill_zone(zone)
    if checkpoint_store is not None and hasattr(
        checkpoint_store, "fail_zone"
    ):
        checkpoint_store.fail_zone(zone)
    return {"zone": zone, "nodes": nodes}


def chaos_seed() -> Optional[int]:
    """The ``GRAFT_CHAOS`` seed, or None when chaos is off."""
    raw = os.environ.get(CHAOS_ENV, "")
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def maybe_wrap(api: Any, registry: Optional[prometheus.Registry] = None) -> Any:
    """Wrap ``api`` in a default-schedule :class:`FaultInjector` when
    ``GRAFT_CHAOS=<seed>`` is set (the runner's chaos gate); otherwise
    return it untouched."""
    seed = chaos_seed()
    if seed is None:
        return api
    return FaultInjector(
        api, seed=seed, schedule=FaultSchedule.default(), registry=registry
    )
