"""Follower read replicas: WAL-shipped copies of the leader store that
serve list/watch (the port's copy of the JAX package's
``machinery/replica.py``).

The leader streams its committed records (``/replication/stream``, rv
order, the same frozen bytes every watch subscriber gets) and a
:class:`ReplicaStore` applies them into its own ``APIServer``-duck copy.

Contract:

- **reads only**: mutations on a replica raise :class:`NotLeader`
  (HTTP: kube-style 307 + ``Location`` + Status reason ``NotLeader``);
- **bounded staleness, never time travel**: every read is a consistent
  prefix of the leader's history at the replica's applied rv (shipped
  in ``X-Served-RV``); ``resourceVersion=``-pinned reads wait — up to
  ``REPLICA_RV_WAIT`` — for the horizon, then 410 exactly as the
  leader 410s below its compaction floor;
- **observable lag**: ``replica_lag_records`` (leader rv high-water −
  applied rv) and ``replica_staleness_seconds`` (time since last
  provably-caught-up moment) gauges, fed by the stream's CONTROL
  frames;
- **fenced promotion**: streams carry the leader's fencing epoch
  (``ShardMembership`` token). A follower promoted under a newer epoch
  rejects the deposed leader's still-flowing stream with
  :class:`FencedOut` — never a silent merge.

Catch-up: a cold joiner loads ``/replication/snapshot`` (the snapshot
cut shape) and streams from its rv; a follower that falls behind the
leader's compacted window gets 410 on resume and re-snapshots — the
same too-old contract watch consumers already live by.

A comma-separated ``REPLICA_OF`` or ``STORE_PARTITIONS`` > 1 runs the
partition-aware follower: one follower per partition behind a
reads-only partition router (``machinery/partition.py``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.analysis import sanitizer as _sanitizer
from odh_kubeflow_tpu_torch.machinery import backoff, objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import (
    APIServer,
    Expired,
    FencedOut,
    NotLeader,
    Watch,
)
from odh_kubeflow_tpu_torch.utils import prometheus

Obj = dict[str, Any]

log = logging.getLogger("machinery.replica")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


class ReplicaStore(APIServer):
    """An ``APIServer``-duck follower: applies the leader's shipped
    records into its own maps and serves list/watch from them.
    Everything a reader touches — namespace buckets, the per-kind rv
    cache keys, the bounded watch cache and its
    410 floor, the sharded watch dispatcher — is the leader's own
    machinery, inherited; only the write surface differs (mutations
    raise :class:`NotLeader` until :meth:`promote`)."""

    # how long an rv-pinned read waits for replication to reach its
    # horizon before 410ing (seconds); env REPLICA_RV_WAIT
    RV_WAIT_SECONDS = 2.5

    def __init__(self, leader_url: str = "", registry: Optional[Any] = None):
        super().__init__()  # no WAL: durability lives on the leader
        self.leader_url = leader_url.rstrip("/")
        self.is_follower = True
        # the newest shipping epoch observed/adopted; records from a
        # lower epoch are a deposed leader's zombie stream
        self.leader_epoch = 0
        # leader rv high-water from CONTROL frames (lag denominator)
        self.leader_rv_seen = 0
        self._last_caught_up = time.time()
        self.RV_WAIT_SECONDS = _env_float(
            "REPLICA_RV_WAIT", type(self).RV_WAIT_SECONDS
        )
        # signalled on every applied record; rv-pinned reads park here.
        # A dedicated plain Condition (NOT built over the store lock:
        # waiters must never hold the store lock while parked). The
        # waiter reads `_applied_rv` without the store lock — an int
        # attribute read is atomic, and taking the store lock under
        # the condition lock would be an ABBA order against the
        # notifier (store lock → condition lock).
        self._rv_cond = threading.Condition()
        if registry is not None:
            self.attach_replica_metrics(registry)

    # -- metrics -------------------------------------------------------------

    def attach_replica_metrics(self, registry: prometheus.Registry) -> None:
        m_lag = registry.gauge(
            "replica_lag_records",
            "Records the follower is behind the leader's observed rv "
            "high-water mark",
        )
        m_stale = registry.gauge(
            "replica_staleness_seconds",
            "Seconds since this follower was last provably caught up "
            "with the leader",
        )

        def sample():
            m_lag.set(float(self.lag_records()))
            m_stale.set(self.staleness_seconds())
            return ()

        registry.register_collector(sample)

    def lag_records(self) -> int:
        with self._lock:
            return max(self.leader_rv_seen - self._applied_rv, 0)

    def staleness_seconds(self) -> float:
        with self._lock:
            if self.leader_rv_seen <= self._applied_rv:
                return 0.0
            return max(time.time() - self._last_caught_up, 0.0)

    # -- the write surface (leader-only) -------------------------------------

    def _reject_writes(self, verb: str) -> None:
        if self.is_follower:
            raise NotLeader(
                f"{verb} rejected: this replica serves reads only; "
                f"send mutations to the leader"
                + (f" at {self.leader_url}" if self.leader_url else ""),
                leader_url=self.leader_url,
            )

    def create(self, obj: Obj, dry_run: bool = False) -> Obj:
        self._reject_writes("create")
        return super().create(obj, dry_run)

    def update(self, obj: Obj) -> Obj:
        self._reject_writes("update")
        return super().update(obj)

    def update_status(self, obj: Obj) -> Obj:
        self._reject_writes("update_status")
        return super().update_status(obj)

    def patch(
        self, kind: str, name: str, patch: Obj, namespace: Optional[str] = None
    ) -> Obj:
        self._reject_writes("patch")
        return super().patch(kind, name, patch, namespace)

    def delete(self, kind: str, name: str, namespace: Optional[str] = None) -> None:
        self._reject_writes("delete")
        return super().delete(kind, name, namespace)

    def create_or_get(self, obj: Obj) -> Obj:
        self._reject_writes("create_or_get")
        return super().create_or_get(obj)

    def emit_event(
        self,
        involved: Obj,
        reason: str,
        message: str,
        event_type: str = "Normal",
        component: str = "",
    ) -> Obj:
        self._reject_writes("emit_event")
        return super().emit_event(
            involved,
            reason,
            message,
            event_type=event_type,
            component=component,
        )

    # -- promotion ------------------------------------------------------------

    def promote(self, epoch: int) -> None:
        """Turn this follower into a leader under ``epoch`` (the
        promoted process's ShardMembership fencing token). From here
        on mutations are served locally AND any record still arriving
        from the deposed leader's stream (a lower epoch) is rejected
        with :class:`FencedOut` — the rail that makes failover a
        handover, not a merge."""
        with self._lock:
            self.is_follower = False
            self.leader_epoch = max(self.leader_epoch, int(epoch))
            self.replication_epoch = self.leader_epoch

    # -- applying the shipped stream ------------------------------------------

    def _check_epoch(self, epoch: int) -> None:
        if epoch < self.leader_epoch:
            raise FencedOut(
                f"replication record from deposed epoch {epoch} "
                f"(current {self.leader_epoch}); the sender must stand "
                "down"
            )
        self.leader_epoch = epoch

    def observe_leader(self, rv: int, epoch: int, ts: float) -> None:
        """Apply one CONTROL frame: adopt the epoch (or reject a
        deposed one), advance the lag denominator, and mark the
        caught-up instant when the stream proves we hold everything
        the leader has committed."""
        with self._lock:
            self._check_epoch(int(epoch))
            self.leader_rv_seen = max(self.leader_rv_seen, int(rv))
            if self._applied_rv >= self.leader_rv_seen:
                self._last_caught_up = time.time()

    def apply_register(self, rec: Obj, epoch: int = 0) -> None:
        with self._lock:
            self._check_epoch(int(epoch))
        self.register_kind(
            rec.get("apiVersion", "v1"),
            rec["kind"],
            rec.get("plural", rec["kind"].lower() + "s"),
            bool(rec.get("namespaced", True)),
        )

    def apply_replicated(self, etype: str, obj: Obj, epoch: int = 0) -> bool:
        """Apply one shipped record. Idempotent on reconnect overlap:
        records at or below the applied horizon are skipped, so a
        stream resumed from ``applied_rv`` can never double-apply.
        Returns whether the record moved state."""
        kind = obj.get("kind", "")
        meta = obj.get("metadata", {})
        try:
            rv = int(meta.get("resourceVersion", 0))
        except (TypeError, ValueError):
            rv = 0
        with self._lock:
            self._check_epoch(int(epoch))
            if rv <= self._applied_rv:
                return False  # reconnect overlap / duplicate
            info = self.type_info(kind)  # loud NotFound on unknown kind
            ns = meta.get("namespace") if info.namespaced else None
            key = self._key(info, ns, meta.get("name", ""))
            if etype == "DELETED":
                self._drop(kind, key)
            else:
                self._put(kind, key, obj_util.deepcopy(obj))
            self._rv = max(self._rv, rv)
            self._applied_rv = rv
            if self._applied_rv >= self.leader_rv_seen:
                self._last_caught_up = time.time()
            # feeds this replica's OWN watch cache + subscribers (the
            # replica serves watches with the same resume/410 contract
            # the leader does) and bumps the per-kind rv the serving
            # tier's bytes cache keys on
            self._notify(etype, obj, rv)
        with self._rv_cond:
            self._rv_cond.notify_all()
        return True

    def load_snapshot(self, state: Obj) -> None:
        """Cold catch-up from a leader snapshot cut (the
        ``/replication/snapshot`` payload): replaces all local state —
        objects, types, the rv counter, per-kind versions, the watch
        cache and its compaction floor — then resumes streaming from
        the cut's rv."""
        with self._lock:
            self._check_epoch(int(state.get("epoch", 0)))
            if self._applied_rv > 0:
                # a RE-snapshot (we fell behind the leader's window):
                # the gap between our old state and the cut is history
                # our own watch subscribers can never be shown, so
                # their streams end with 410 and they relist — the
                # same contract an evicted slow consumer gets
                for w in list(self._watches):
                    w.error = Expired(
                        "replica re-snapshotted past this stream's "
                        "position; relist and re-watch"
                    )
                    w.ended = True
                    self._remove_watch(w)
                    w._q.put(None)
                    w._wake()
            self._replaying = True
            try:
                for kind in self._store:
                    self._store[kind] = {}
                self._ns_buckets = {k: {} for k in self._store}
                self._event_log.clear()
                for api_version, kind, plural, namespaced in state.get(
                    "types", []
                ):
                    self.register_kind(api_version, kind, plural, namespaced)
                for obj in state.get("objects", []):
                    info = self.type_info(obj.get("kind", ""))
                    meta = obj.get("metadata", {})
                    key = self._key(
                        info,
                        meta.get("namespace") if info.namespaced else None,
                        meta.get("name", ""),
                    )
                    self._put(info.kind, key, obj_util.deepcopy(obj))
                rv = int(state.get("rv", 0))
                self._rv = max(self._rv, rv)
                self._applied_rv = rv
                self.leader_rv_seen = max(self.leader_rv_seen, rv)
                self._kind_rv = {
                    k: int(v) for k, v in state.get("kind_rv", {}).items()
                }
                self._compacted_rv = int(state.get("compacted_rv", 0))
                for erv, kind, ns, etype, obj in state.get("events", []):
                    self._event_log.append(
                        (int(erv), kind, ns, etype, obj_util.freeze(obj))
                    )
                if self._event_log:
                    self._compacted_rv = max(
                        self._compacted_rv, self._event_log[0][0] - 1
                    )
                elif rv:
                    self._compacted_rv = max(self._compacted_rv, rv)
            finally:
                self._replaying = False
            self._last_caught_up = time.time()
        with self._rv_cond:
            self._rv_cond.notify_all()

    def _apply_record(self, event_type, kind, key, obj, rv) -> None:
        # a PROMOTED follower serves writes through the normal apply
        # path; rv-pinned readers parked in wait_for_rv must see those
        # horizons too, not only replicated ones
        super()._apply_record(event_type, kind, key, obj, rv)
        with self._rv_cond:
            self._rv_cond.notify_all()

    # -- bounded-staleness reads ----------------------------------------------

    def wait_for_rv(self, rv: int, timeout: Optional[float] = None) -> None:
        """Block until replication applies ``rv`` (the wait half of
        wait-or-410); :class:`Expired` when the horizon doesn't arrive
        within the bound — the client relists, exactly as it would on
        a compacted resume."""
        deadline = time.monotonic() + (
            self.RV_WAIT_SECONDS if timeout is None else timeout
        )
        with self._rv_cond:
            # `_applied_rv` read WITHOUT the store lock (atomic int
            # read; see _rv_cond construction for the order argument)
            while self._applied_rv < rv:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise Expired(
                        f"resourceVersion {rv} is ahead of this "
                        f"replica's horizon ({self._applied_rv}) and "
                        "replication did not catch up within "
                        f"{self.RV_WAIT_SECONDS}s; retry or read the "
                        "leader"
                    )
                self._rv_cond.wait(remaining)

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        send_initial: bool = True,
        resource_version: Optional[str] = None,
        inline: bool = True,
    ) -> Watch:
        if resource_version is not None:
            try:
                pinned = int(resource_version)
            except (TypeError, ValueError):
                pinned = None  # super() raises the proper Invalid
            if pinned is not None and pinned > self.applied_rv():
                # a resume point the leader issued but we haven't
                # applied yet: wait-or-410, never silently replay a
                # stream with a hole in it
                self.wait_for_rv(pinned)
        return super().watch(
            kind,
            namespace=namespace,
            send_initial=send_initial,
            resource_version=resource_version,
            inline=inline,
        )


class ReplicationClient:
    """The follower's pull loop: snapshot catch-up when cold (or told
    410), then a long-lived ``/replication/stream`` read applying
    records as they arrive. Reconnects with jittered backoff from the
    applied rv — the idempotent apply makes overlap harmless. A
    :class:`FencedOut` from the store (this stream's epoch was
    deposed) ends the loop for good: the leader we were following
    lost its lease, and a newer stream owns this replica now."""

    def __init__(
        self,
        replica: ReplicaStore,
        leader_url: Optional[str] = None,
        reconnect_base: float = 0.05,
        reconnect_cap: float = 2.0,
        timeout: float = 30.0,
        chaos_drop: Optional[Callable[[], bool]] = None,
        partition: Optional[int] = None,
    ):
        self.replica = replica
        self.leader_url = (leader_url or replica.leader_url).rstrip("/")
        if not self.leader_url:
            raise ValueError("ReplicationClient needs a leader URL")
        # replicate ONE partition of a PartitionRouter-fronted leader:
        # ?partition=<i> scopes snapshot + stream to that partition's
        # backend (rv spaces are per-partition)
        self.partition = partition
        self.reconnect_base = reconnect_base
        self.reconnect_cap = reconnect_cap
        self.timeout = timeout
        # test hook: a seeded predicate that severs the stream after a
        # record (the chaos drills' drop/reconnect schedules)
        self.chaos_drop = chaos_drop
        self.fenced = False
        self.connected = False  # one successful snapshot/stream sync
        self.records_applied = 0
        self.snapshots_loaded = 0
        self.reconnects = 0
        # monotonic instant of the last frame (CONTROL included) the
        # stream delivered — the promotion watchdog's is-the-leader-
        # really-dead veto reads this
        self.last_frame_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def stream_recently_active(self, window: float = 5.0) -> bool:
        """Whether the replication stream delivered ANY frame within
        ``window`` seconds. CONTROL heartbeats arrive every second on
        a healthy stream, so a quiet window longer than the leader's
        lease means the leader (or the path to it) is gone — the
        promotion watchdog's second signal."""
        if self.fenced or self.last_frame_at is None:
            return False
        return time.monotonic() - self.last_frame_at < window

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ReplicationClient":
        self._thread = threading.Thread(
            target=self._run, name="replication-pull", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def wait_caught_up(
        self, timeout: float = 30.0, target_rv: Optional[int] = None
    ) -> bool:
        """Block until the replica has applied everything the leader
        had committed when this call started (a barrier for drills and
        benches, not part of the serving path). Pass ``target_rv``
        when the caller already knows the horizon — probing it remotely
        costs a full snapshot serialization on the leader."""
        deadline = time.monotonic() + timeout
        target = target_rv
        while time.monotonic() < deadline and not self.fenced:
            if not self.connected:
                # never synced yet: "caught up" must mean the leader
                # has actually been reached, even at rv 0
                time.sleep(0.01)
                continue
            if target is None:
                target = self._leader_rv()
                if target is None:
                    time.sleep(0.05)
                    continue
            if self.replica.applied_rv() >= target:
                return True
            time.sleep(0.01)
        return False

    def _snapshot_url(self) -> str:
        url = self.leader_url + "/replication/snapshot"
        if self.partition is not None:
            url += f"?partition={self.partition}"
        return url

    def _leader_rv(self) -> Optional[int]:
        try:
            with urllib.request.urlopen(
                self._snapshot_url(),
                timeout=self.timeout,
            ) as r:
                return int(json.loads(r.read().decode()).get("rv", 0))
        except (OSError, ValueError, urllib.error.HTTPError):
            return None

    # -- the pull loop -------------------------------------------------------

    def _run(self) -> None:
        delay: Optional[float] = None
        need_snapshot = self.replica.applied_rv() == 0
        while not self._stop.is_set():
            try:
                if need_snapshot:
                    self._load_snapshot()
                    need_snapshot = False
                self._stream_once()
                delay = None  # a healthy stream resets the backoff
            except FencedOut as e:
                # our leader was deposed; a newer epoch owns this
                # replica. Stop pulling — promotion (or a new client
                # at the new leader) takes over.
                self.fenced = True
                log.warning("replication stream fenced out: %s", e)
                return
            except Expired:
                # fell behind the leader's compacted window: the
                # stream cannot fill the gap, a snapshot can
                log.warning(
                    "replication resume rv %d predates the leader's "
                    "window; catching up from a snapshot",
                    self.replica.applied_rv(),
                )
                need_snapshot = True
                continue
            except (OSError, ValueError, json.JSONDecodeError) as e:
                if self._stop.is_set():
                    return
                log.warning(
                    "replication stream broke (%s: %s); reconnecting "
                    "from rv=%d",
                    type(e).__name__, e, self.replica.applied_rv(),
                )
            self.reconnects += 1
            delay = backoff.next_delay(  # budget-ok: the long-lived replication stream MUST reconnect forever — a drained budget silencing replication would be an availability bug
                delay, base=self.reconnect_base, cap=self.reconnect_cap
            )
            self._stop.wait(delay)

    def _load_snapshot(self) -> None:
        _sanitizer.note_blocking("replication snapshot fetch")
        with urllib.request.urlopen(
            self._snapshot_url(), timeout=self.timeout
        ) as r:
            state = json.loads(r.read().decode())
        self.replica.load_snapshot(state)
        self.snapshots_loaded += 1
        self.connected = True
        log.warning(
            "replica caught up from snapshot at rv=%d (%d objects)",
            int(state.get("rv", 0)), len(state.get("objects", [])),
        )

    def _stream_once(self) -> None:
        from_rv = self.replica.applied_rv()
        url = f"{self.leader_url}/replication/stream?from={from_rv}"
        if self.partition is not None:
            url += f"&partition={self.partition}"
        _sanitizer.note_blocking("replication stream read")
        resp = None
        try:
            try:
                # the read timeout doubles as the liveness bound:
                # CONTROL frames arrive every
                # REPLICATION_HEARTBEAT_SECONDS, so a stream silent
                # for `timeout` seconds is a dead leader (or a
                # blackholed connect) and the caller reconnects
                resp = urllib.request.urlopen(url, timeout=self.timeout)
                # a warm start (applied_rv > 0) never loads a snapshot;
                # a successfully opened stream is the sync barrier then
                self.connected = True
            except urllib.error.HTTPError as e:
                body = b""
                try:
                    body = e.read()
                except (OSError, ValueError):
                    pass
                if e.code == 410:
                    raise Expired(body.decode(errors="replace")) from None
                raise OSError(f"replication stream HTTP {e.code}") from None
            # the stream's epoch comes ONLY from its own CONTROL
            # frames (the greeting is one). Records arriving before an
            # epoch is established are refused — attributing them to
            # the replica's current epoch would let a deposed leader's
            # stream bypass the fence whenever no CONTROL preceded the
            # data, which is exactly the split-brain merge the fence
            # exists to stop.
            epoch: Optional[int] = None
            for line in resp:
                if self._stop.is_set():
                    return
                try:
                    frame = json.loads(line.decode())
                except ValueError:
                    continue
                if not isinstance(frame, dict):
                    continue
                self.last_frame_at = time.monotonic()
                ftype = frame.get("type")
                if ftype == "CONTROL":
                    epoch = int(frame.get("epoch", 0))
                    self.replica.observe_leader(
                        int(frame.get("rv", 0)),
                        epoch,
                        float(frame.get("ts", 0.0)),
                    )
                    continue
                if epoch is None:
                    raise OSError(
                        "replication record arrived before any CONTROL "
                        "frame; dropping the unattributable stream"
                    )
                obj = frame.get("object")
                if not isinstance(obj, dict):
                    continue
                if ftype == "REGISTER":
                    self.replica.apply_register(obj, epoch=epoch)
                    continue
                if self.replica.apply_replicated(ftype, obj, epoch=epoch):
                    self.records_applied += 1
                if self.chaos_drop is not None and self.chaos_drop():
                    raise OSError("chaos: injected stream drop")
        finally:
            if resp is not None:
                try:
                    resp.close()
                except OSError:
                    pass


class InProcessReplication:
    """Deterministic shipping for drills and property tests: pulls the
    leader's replication feed without sockets or threads, applying on
    explicit :meth:`step` calls. ``drop_stream()`` severs the feed
    (the chaos schedules' injected disconnect) and the next step
    re-opens from the applied rv — through a snapshot when the resume
    point was compacted away, exactly like the HTTP client."""

    def __init__(self, leader: APIServer, replica: ReplicaStore):
        self.leader = leader
        self.replica = replica
        self._feed: Optional[Watch] = None
        self.snapshots_loaded = 0
        self.reconnects = 0

    def _epoch(self) -> int:
        return getattr(self.leader, "replication_epoch", 0)

    def _ensure_feed(self) -> None:
        if self._feed is not None and not self._feed.ended:
            return
        try:
            self._feed = self.leader.replication_watch(
                self.replica.applied_rv(), inline=True
            )
        except Expired:
            self.replica.load_snapshot(self.leader.replication_cut())
            self.snapshots_loaded += 1
            self._feed = self.leader.replication_watch(
                self.replica.applied_rv(), inline=True
            )
        self.reconnects += 1

    def drop_stream(self) -> None:
        if self._feed is not None:
            self._feed.stop()
            self._feed = None

    def step(self, budget: int = 10_000) -> int:
        """Apply up to ``budget`` pending records; returns how many
        moved replica state."""
        self._ensure_feed()
        epoch = self._epoch()
        moved = 0
        for _ in range(budget):
            item = self._feed.try_get()
            if item is None:
                if self._feed.ended:  # evicted mid-drain: reconnect
                    self._ensure_feed()
                    continue
                break
            etype, obj = item
            if etype == "REGISTER":
                self.replica.apply_register(dict(obj), epoch=epoch)
                moved += 1
            elif self.replica.apply_replicated(etype, obj, epoch=epoch):
                moved += 1
        return moved

    def sync(self, timeout: float = 30.0) -> None:
        """Drain until the replica holds everything the leader has
        applied (quiesced-writer barrier for tests). A feed that stops
        yielding records while still behind — a fenced or wedged
        stream — raises instead of spinning forever."""
        deadline = time.monotonic() + timeout
        while self.replica.applied_rv() < self.leader.applied_rv():
            if self.step() == 0 and time.monotonic() > deadline:
                raise RuntimeError(
                    "replication sync stalled at rv "
                    f"{self.replica.applied_rv()} (leader at "
                    f"{self.leader.applied_rv()})"
                )


class ReadSplitAPI:
    """APIServer-duck façade splitting the platform's traffic: reads
    (get/list/list_chunk/watch) served by a follower replica, writes
    and everything else passed to the leader. Handing this to a
    controller, informer cache, or web app converts its read path to
    replica-served without touching its code — the ``READ_FROM_REPLICA``
    runner env builds exactly this.

    ``get`` falls back to the leader on NotFound so read-your-writes
    holds for just-created objects whose record is still in flight
    (the same fall-through CachedClient applies over any api). Lists
    and watches stay replica-served: bounded staleness is the deal."""

    def __init__(self, write_api: Any, read_api: Any):
        self.write_api = write_api
        self.read_api = read_api

    def get(self, kind: str, name: str, namespace: Optional[str] = None) -> Obj:
        from odh_kubeflow_tpu_torch.machinery.store import NotFound

        try:
            return self.read_api.get(kind, name, namespace)
        except NotFound:
            return self.write_api.get(kind, name, namespace)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
    ) -> list[Obj]:
        return self.read_api.list(
            kind,
            namespace=namespace,
            label_selector=label_selector,
            field_matches=field_matches,
            limit=limit,
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
        return self.read_api.list_chunk(
            kind,
            namespace=namespace,
            label_selector=label_selector,
            field_matches=field_matches,
            limit=limit,
            continue_token=continue_token,
        )

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        send_initial: bool = True,
        resource_version: Optional[str] = None,
        inline: bool = True,
    ) -> Watch:
        # in-process read arms (ReplicaStore) take ``inline``; remote
        # fanout arms do not — same degradation the partition router's
        # _leg_watch applies
        try:
            return self.read_api.watch(
                kind,
                namespace=namespace,
                send_initial=send_initial,
                resource_version=resource_version,
                inline=inline,
            )
        except TypeError:
            return self.read_api.watch(
                kind,
                namespace=namespace,
                send_initial=send_initial,
                resource_version=resource_version,
            )

    def applied_rv(self) -> Optional[int]:
        fn = getattr(self.read_api, "applied_rv", None)
        return fn() if fn is not None else None

    def kind_version(self, kind: str) -> int:
        # freshness keys must describe the arm that SERVES the reads —
        # keying a bytes-cache on the leader's version while rows come
        # from the replica would advance keys ahead of content
        fn = getattr(self.read_api, "kind_version", None)
        if fn is None:
            fn = self.write_api.kind_version
        return fn(kind)

    def state_digest(self) -> str:
        fn = getattr(self.read_api, "state_digest", None)
        if fn is None:
            fn = self.write_api.state_digest
        return fn()

    def register_kind(
        self,
        api_version: str,
        kind: str,
        plural: str,
        namespaced: bool = True,
    ) -> None:
        self.write_api.register_kind(api_version, kind, plural, namespaced)
        reg = getattr(self.read_api, "register_kind", None)
        if reg is not None:
            reg(api_version, kind, plural, namespaced)

    def __getattr__(self, name: str):
        # writes, type registry, admission, emit_event, … — the leader
        return getattr(self.write_api, name)


def serve_replica() -> None:
    """``REPLICA_OF=<leader-url>`` entrypoint: run a follower replica
    process — pull the leader's stream, serve list/watch (and 307
    mutations back at the leader) on ``PORT``. The deployment shape is
    leader + N of these behind a read load balancer.

    ``PROMOTION_WATCHDOG=true`` additionally runs the hands-off
    failover sidecar (:mod:`machinery.promoter`): when the replicated
    leader Lease expires beyond ``PROMOTION_GRACE_WINDOWS`` extra
    windows AND the stream has gone silent, this follower promotes
    itself under the bumped fencing epoch, starts serving writes, and
    fences the deposed leader's stream out — zero manual
    ``promote()`` calls."""
    from odh_kubeflow_tpu_torch.machinery import httpapi

    leader_url = os.environ["REPLICA_OF"]
    if "," in leader_url or int(os.environ.get("STORE_PARTITIONS", "1")) > 1:
        # partition-aware follower: REPLICA_OF=<url0>,<url1>,... (one
        # URL per partition leader), or one router URL with
        # STORE_PARTITIONS=N (?partition=<i>-scoped pulls), runs one
        # follower per partition behind a PartitionRouter — merged
        # fleet-wide reads, every mutation 307'd to the owning
        # partition's leader. Promotion stays per-partition (run a
        # classic single-URL watchdog follower next to each leader);
        # this fleet-read shape deliberately does not self-promote.
        _serve_partitioned_replica()
        return
    registry = prometheus.Registry()
    replica = ReplicaStore(leader_url, registry=registry)
    replica.attach_metrics(registry)
    # platform CRD kinds registered at boot (the api_from_env move):
    # a cold replica answers empty lists instead of 404ing on known
    # kinds while the first snapshot is in flight
    from odh_kubeflow_tpu_torch.apis import register_crds

    register_crds(replica)
    client = ReplicationClient(replica).start()
    watchdog = None
    if os.environ.get("PROMOTION_WATCHDOG", "").lower() == "true":
        from odh_kubeflow_tpu_torch.machinery.promoter import PromotionWatchdog

        lease_duration = float(os.environ.get("LEASE_DURATION", "15"))

        def on_promoted(epoch: int) -> None:
            client.stop()
            print(
                f"replica promoted to leader (epoch {epoch}); "
                "replication pull stopped, serving writes",
                flush=True,
            )

        namespace = os.environ.get("LEADER_ELECTION_NAMESPACE", "kubeflow")
        group = os.environ.get("SHARD_GROUP", "")
        watchdog = PromotionWatchdog(
            replica,
            lease_name=os.environ.get(
                "LEADER_ELECTION_ID", "control-plane-leader"
            ),
            namespace=namespace,
            identity=os.environ.get("SHARD_IDENTITY", ""),
            lease_duration=lease_duration,
            grace_windows=float(
                os.environ.get("PROMOTION_GRACE_WINDOWS", "1")
            ),
            membership_group=group,
            stream_alive_fn=lambda: client.stream_recently_active(
                lease_duration
            ),
            on_promoted=on_promoted,
            registry=registry,
        ).run()
        if group:
            # the one-promoter rendezvous ranks the SURVIVING watchdog
            # identities — which each watchdog can only see if its
            # peers heartbeat their membership leases THROUGH the
            # leader (replication then ships them to every follower).
            # The heartbeat deliberately tolerates a dead leader: the
            # frozen replicated membership at death is exactly what
            # the survivors rank against.
            from odh_kubeflow_tpu_torch.machinery.client import api_from_env
            from odh_kubeflow_tpu_torch.machinery.leader import ShardMembership

            member = ShardMembership(
                api_from_env(leader_url),
                group,
                identity=watchdog.identity,
                namespace=namespace,
                lease_duration=lease_duration,
            )

            def heartbeat():
                while True:
                    try:
                        member.join()
                    except Exception as e:  # noqa: BLE001 — leader down is expected here
                        log.warning(
                            "watchdog membership heartbeat failed "
                            "(%s: %s); leader unreachable", type(e).__name__, e,
                        )
                    time.sleep(member.renew_period)

            threading.Thread(
                target=heartbeat, name="watchdog-membership", daemon=True
            ).start()
    host = os.environ.get("HOST", "0.0.0.0")
    port = int(os.environ.get("PORT", "8002"))
    _, bound, srv = httpapi.serve(
        replica, host=host, port=port, metrics_registry=registry
    )
    print(f"replica of {leader_url} serving reads on :{bound}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        client.stop()
        if watchdog is not None:
            watchdog.stop()
        srv.shutdown()


def _serve_partitioned_replica() -> None:
    """The ``REPLICA_OF=<url0>,<url1>,…`` arm of :func:`serve_replica`:
    one follower ReplicaStore per partition leader, assembled into the
    reads-only PartitionRouter :func:`machinery.partition.
    replica_router_from_env` builds. Cluster-spanning lists/watches
    merge across the follower fleet with the same composite-token
    semantics the leader-side router serves.

    Beyond the JAX arm, ``/metrics`` carries each partition's follower
    state, labelled ``partition``: ``replica_applied_rv``,
    ``replica_snapshots_loaded`` (1 after the cold join; one more each
    time a resume fell below the leader's compaction floor and the
    follower re-snapshotted) and ``replica_reconnects``."""
    from odh_kubeflow_tpu_torch.apis import register_crds
    from odh_kubeflow_tpu_torch.machinery import httpapi
    from odh_kubeflow_tpu_torch.machinery.partition import replica_router_from_env

    built = replica_router_from_env()
    assert built is not None  # caller checked for the comma
    router, clients = built
    registry = prometheus.Registry()
    _attach_partition_metrics(registry, clients)
    # CRD kinds on every partition follower: cold followers answer
    # empty lists instead of 404ing while the first snapshots land
    register_crds(router)
    host = os.environ.get("HOST", "0.0.0.0")
    port = int(os.environ.get("PORT", "8002"))
    _, bound, srv = httpapi.serve(
        router, host=host, port=port, metrics_registry=registry
    )
    print(
        f"partitioned replica of {router.partition_count} leaders "
        f"serving merged reads on :{bound}",
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        for c in clients:
            c.stop()
        srv.shutdown()


def _attach_partition_metrics(registry: prometheus.Registry, clients: list) -> None:
    """Per-partition follower gauges, sampled at scrape time."""
    gauges = {
        "replica_applied_rv": ("The rv this partition's follower has applied",
                               lambda c: c.replica.applied_rv() or 0),
        "replica_snapshots_loaded": ("Snapshots this partition's follower has loaded",
                                     lambda c: c.snapshots_loaded),
        "replica_reconnects": ("Stream (re)connects of this partition's follower",
                               lambda c: c.reconnects),
    }
    made = {name: registry.gauge(name, help_, labelnames=("partition",))
            for name, (help_, _) in gauges.items()}

    def sample():
        for i, c in enumerate(clients):
            labels = {"partition": str(i)}
            for name, (_, read) in gauges.items():
                made[name].set(float(read(c)), labels)
        return ()

    registry.register_collector(sample)


if __name__ == "__main__":
    serve_replica()
