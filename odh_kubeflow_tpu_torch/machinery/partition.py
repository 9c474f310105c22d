"""Partitioned write path: the store sharded by namespace into N
independent leaders behind one coherent client-facing contract (the
port's copy of the JAX package's ``machinery/partition.py``).

Reads scale out with replicas (machinery/replica.py); every mutation
still funnels through ONE leader's group-commit pipeline — the hard
ceiling between here and fleet scale. This module shards the WRITE
path kube-style, by namespace (all platform CRs are namespaced):

- **assignment** (:func:`partition_of`, :class:`PartitionMap`):
  rendezvous (HRW) hashing of namespaces over partition ids — the
  ``ShardMembership`` discipline extended to store partitions.
  Resizing from N to N+1 partitions moves only the ~1/(N+1) slice the
  new partition wins; every other namespace stays put. Cluster-scoped
  kinds (``PriorityClass``, ``CompileCacheEntry``, Leases' cluster
  peers…) pin to partition 0, the meta partition.
- **routing** (:class:`PartitionRouter`): a stateless ``APIServer``
  duck that maps every namespaced verb to its owning partition. Each
  partition is a full WAL + group-commit + read-replica stack with
  its own fencing epoch, rv space, and compaction window. A mutation
  for a partition this router does not lead answers with the existing
  ``NotLeader`` 307 contract (``leader_url`` = that partition's
  advertised URL). Cluster-spanning lists and watches are
  scatter-gather merges over the store's pagination contract: composite
  continue tokens pin a per-partition rv vector, one partition's 410
  restarts only that partition's walk, and merged watch streams
  preserve per-partition rv order while re-framing CONTROL heartbeats
  with their partition of origin.
- **live moves** (:class:`PartitionMover`): a namespace ships between
  partitions with the replicas' snapshot/catch-up protocol as the data
  plane — consistent cut, tail replay from the source's replication
  feed, a bounded freeze window behind a fencing bump, takeover under
  a fresh destination epoch. Zero lost acks: every acked write is in
  the cut, the tail, or lands after retargeting; writes inside the
  freeze window are refused with a retryable 429 and were never
  acked.

rv spaces are per-partition. A composite resume/continue token
therefore carries a ``{partition: rv}`` vector, never one scalar —
the same reason promotion needs epochs, applied
fleet-wide.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
import weakref
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.analysis import schedule as _schedule
from odh_kubeflow_tpu_torch.machinery import objects as obj_util, overload
from odh_kubeflow_tpu_torch.machinery.leader import (
    _hrw_weight,
    fenced,
    lease_expired,
)
from odh_kubeflow_tpu_torch.machinery.store import (
    APIError,
    APIServer,
    BadRequest,
    DeadlineExceeded,
    Expired,
    FencedOut,
    Invalid,
    NotFound,
    NotLeader,
    TooManyRequests,
    Watch,
    current_fence,
    decode_continue,
    encode_continue,
    reset_fence,
    set_fence,
)

Obj = dict[str, Any]

log = logging.getLogger("machinery.partition")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def partitions_from_env() -> int:
    """``STORE_PARTITIONS``: how many write partitions the platform
    runs (1 = the classic single-leader store, no router)."""
    return max(1, _env_int("STORE_PARTITIONS", 1))


# ---------------------------------------------------------------------------
# assignment


def partition_of(namespace: str, n_partitions: int) -> int:
    """The partition that owns ``namespace``: the highest-random-weight
    winner among partition ids, scored with the same keyed blake2b the
    shard membership ranks controller replicas with. Stable
    across processes, and minimal movement on resize — growing from N
    to N+1 partitions reassigns only the namespaces the new id wins
    (~1/(N+1) of them)."""
    if n_partitions <= 1:
        return 0
    return max(
        range(n_partitions),
        key=lambda p: _hrw_weight(f"partition-{p}", namespace),
    )


class PartitionMap:
    """Live namespace→partition assignment: HRW by default, plus the
    explicit overrides a :class:`PartitionMover` records when it ships
    a namespace away from its hash-assigned home. Reads are lock-free
    (overrides is replaced, never mutated in place)."""

    def __init__(
        self, n_partitions: int, overrides: Optional[dict[str, int]] = None
    ):
        self.n = max(1, int(n_partitions))
        self._overrides: dict[str, int] = dict(overrides or {})

    def owner_of(self, namespace: str) -> int:
        p = self._overrides.get(namespace)
        if p is not None:
            return p
        return partition_of(namespace, self.n)

    def override(self, namespace: str, partition: int) -> None:
        if not 0 <= partition < self.n:
            raise Invalid(
                f"partition {partition} out of range (0..{self.n - 1})"
            )
        fresh = dict(self._overrides)
        if partition_of(namespace, self.n) == partition:
            fresh.pop(namespace, None)  # moved back home: no override
        else:
            fresh[namespace] = partition
        self._overrides = fresh

    def overrides(self) -> dict[str, int]:
        return dict(self._overrides)


# ---------------------------------------------------------------------------
# composite tokens
#
# Same wire shape as the store's continue tokens (urlsafe-b64 JSON via
# encode_continue/decode_continue) so they travel every surface plain
# tokens already do — HTTP query params, the web tier, the client's
# paged walks — but the payload pins a PER-PARTITION rv vector and a
# per-partition cursor, because one scalar rv cannot describe N
# independent histories.

_FLEET = "fleet"


def is_composite_token(token: str) -> bool:
    try:
        return bool(decode_continue(token).get(_FLEET))
    except BadRequest:  # foreign/opaque token shapes are not fleet tokens
        return False


def encode_fleet_rvs(kind: str, rvs: dict[int, int]) -> str:
    """A merged watch's resume token: the per-partition rv vector the
    stream has delivered through."""
    return encode_continue(
        {_FLEET: 1, "kind": kind, "rv": {str(p): int(v) for p, v in rvs.items()}}
    )


def decode_fleet_rvs(token: str, kind: str) -> dict[int, int]:
    payload = decode_continue(token)
    if not payload.get(_FLEET):
        raise BadRequest("not a fleet resume token")
    if payload.get("kind") not in (None, kind):
        raise BadRequest(
            f"fleet resume token is for kind {payload.get('kind')!r}, "
            f"not {kind!r}"
        )
    return {int(p): int(v) for p, v in (payload.get("rv") or {}).items()}


# ---------------------------------------------------------------------------
# merged watch


class MergedWatch(Watch):
    """A cluster-spanning watch assembled from one leg per partition.

    Legs pump into the merged queue from their own notify hooks (the
    enqueuing thread — mutator or dispatcher — drives the pump, same
    zero-extra-threads posture as the event-loop server). A small pump
    lock serializes legs, so each partition's events land in ITS rv
    order; no global order across partitions exists or is promised.

    CONTROL frames are re-framed with their partition of origin, and
    two partition-local conditions become CONTROL frames instead of
    stream death:

    - a leg that 410s (resume below that partition's compaction floor,
      or a mid-stream eviction) surfaces as ``{"partition": p,
      "expired": True}`` — the consumer relists THAT partition;
      the other legs keep streaming (one partition's 410 must not
      poison the merged stream);
    - a namespace move surfaces as ``{"partition": dst, "moved": ns}``
      at takeover — event-level continuity across a move is by relist,
      not by replaying the handover's internal writes.

    ``resume_rvs()``/``resume_token()`` expose the delivered-through
    per-partition rv vector for composite resumes."""

    def __init__(
        self,
        router: "PartitionRouter",
        kind: Optional[str],
        namespace: Optional[str],
    ):
        super().__init__(router, kind, namespace)
        self._legs: dict[int, Watch] = {}
        self._pump_lock = threading.Lock()
        self._last_rvs: dict[int, int] = {}
        self._leg_closed: set[int] = set()
        self.expired_partitions: set[int] = set()

    def attach_leg(self, partition: int, leg: Watch) -> None:
        self._legs[partition] = leg
        self._last_rvs.setdefault(partition, 0)
        leg.set_notify(lambda p=partition: self._pump(p))

    def mark_expired(self, partition: int, reason: str) -> None:
        """A leg that could not even open (resume below that
        partition's floor): surfaced as a CONTROL frame, stream lives."""
        with self._pump_lock:
            self._note_expired(partition, reason)

    def control(self, frame: Obj) -> None:
        """Router-injected CONTROL (move takeover, epoch bumps)."""
        with self._pump_lock:
            self._enqueue(("CONTROL", dict(frame)))

    def _note_expired(self, partition: int, reason: str) -> None:
        if partition in self.expired_partitions:
            return
        self.expired_partitions.add(partition)
        self._leg_closed.add(partition)
        self._enqueue(
            (
                "CONTROL",
                {
                    "partition": partition,
                    "expired": True,
                    "reason": reason,
                    "rv": self._last_rvs.get(partition, 0),
                },
            )
        )

    def _pump(self, partition: int) -> None:
        with self._pump_lock:
            leg = self._legs.get(partition)
            if leg is None or self._stopped:
                return
            owner_of = self._server._map.owner_of
            while True:
                item = leg.try_get()
                if item is None:
                    break
                etype, obj = item
                if etype == "CONTROL":
                    obj = dict(obj)
                    obj["partition"] = partition
                else:
                    meta = obj.get("metadata", {})
                    ns = meta.get("namespace")
                    try:
                        rv = int(meta.get("resourceVersion", 0) or 0)
                    except (TypeError, ValueError):
                        rv = 0
                    if rv > self._last_rvs.get(partition, 0):
                        self._last_rvs[partition] = rv
                    # ownership filter at delivery time: a partition
                    # only contributes events for namespaces it OWNS —
                    # mid-move imports and post-move source garbage
                    # never leak into the merged stream
                    if ns and owner_of(ns) != partition:
                        continue
                self._enqueue((etype, obj))
            if (leg.ended or leg.evicted) and partition not in self._leg_closed:
                if isinstance(leg.error, Expired):
                    self._note_expired(partition, str(leg.error))
                else:
                    self._leg_closed.add(partition)
                    if self._leg_closed >= set(self._legs):
                        self.ended = True
                        self._q.put(None)
                        self._wake()

    def resume_rvs(self) -> dict[int, int]:
        with self._pump_lock:
            return dict(self._last_rvs)

    def resume_token(self) -> str:
        return encode_fleet_rvs(self.kind or "", self.resume_rvs())

    def stop(self) -> None:
        for leg in self._legs.values():
            try:
                leg.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                log.debug("merged watch: leg stop failed", exc_info=True)
        super().stop()


# ---------------------------------------------------------------------------
# router


class PartitionRouter:
    """Stateless namespace→partition request router, ``APIServer``
    duck (the same duck ``ReadSplitAPI`` plays, so the REST façade,
    clients, controllers, and the informer cache work unchanged).

    ``backends`` maps partition id → an APIServer duck (an in-process
    store, a :class:`~odh_kubeflow_tpu_torch.machinery.replica.ReplicaStore`,
    or a remote client). ``owned`` names the partitions THIS process
    leads — a mutation routed to any other partition raises
    :class:`NotLeader` carrying that partition's ``urls`` entry, the
    existing 307 redirect contract. The default (owned = everything)
    is the single-process in-memory fleet the tests and platform run.
    """

    LIST_DEFAULT_LIMIT = APIServer.LIST_DEFAULT_LIMIT

    # per-partition page size for scatter-gather merges (0 = the
    # request's own limit). Smaller pages trade merge over-fetch for
    # per-call latency.
    MERGE_PAGE_LIMIT = _env_int("PARTITION_MERGE_PAGE_LIMIT", 0)
    # Retry-After (seconds) on writes refused inside a move's freeze
    # window — the client-visible cost of a live partition move.
    MOVE_RETRY_AFTER = _env_float("PARTITION_MOVE_RETRY_AFTER", 0.05)

    def __init__(
        self,
        backends: dict[int, Any] | list[Any],
        pmap: Optional[PartitionMap] = None,
        owned: Optional[set[int]] = None,
        urls: Optional[dict[int, str]] = None,
    ):
        if isinstance(backends, list):
            backends = dict(enumerate(backends))
        if 0 not in backends:
            raise Invalid("partition 0 (the meta partition) is required")
        self.backends = dict(backends)
        self._map = pmap or PartitionMap(len(self.backends))
        self.owned = set(self.backends) if owned is None else set(owned)
        self.urls = dict(urls or {})
        self._frozen: set[str] = set()
        self._freeze_lock = threading.Lock()
        # per-namespace in-flight mutation counts: registered BEFORE
        # the frozen check, so freeze + quiesce_writes is a real
        # barrier — after it returns, every ack the namespace will
        # ever get is already in its source store's applied horizon
        self._inflight: dict[str, int] = {}
        self._inflight_cv = threading.Condition()
        self._merged: "weakref.WeakSet[MergedWatch]" = weakref.WeakSet()
        self.merge_page_limit = self.MERGE_PAGE_LIMIT
        self.move_retry_after = self.MOVE_RETRY_AFTER
        # one circuit breaker per partition (machinery.overload): a
        # sick partition sheds fast instead of dragging every
        # scatter-gather merge and routed write down with it
        self._breakers: dict[int, overload.CircuitBreaker] = {
            p: overload.CircuitBreaker() for p in self.backends
        }

    # -- assignment surface --------------------------------------------------

    @property
    def partition_count(self) -> int:
        return self._map.n

    def owner_of(self, namespace: str) -> int:
        return self._map.owner_of(namespace)

    def backend(self, partition: int) -> Any:
        try:
            return self.backends[partition]
        except KeyError:
            raise NotFound(f"no partition {partition}") from None

    partition_backend = backend  # the REST façade's ?partition= hook

    def retarget(self, namespace: str, partition: int) -> None:
        """Point ``namespace`` at ``partition`` (the mover's takeover
        step) and tell every merged stream to relist it."""
        self._map.override(namespace, partition)
        for w in list(self._merged):
            w.control({"partition": partition, "moved": namespace})

    # -- freeze window -------------------------------------------------------

    def freeze(self, namespace: str) -> None:
        with self._freeze_lock:
            self._frozen = self._frozen | {namespace}

    def unfreeze(self, namespace: str) -> None:
        with self._freeze_lock:
            self._frozen = self._frozen - {namespace}

    def _check_frozen(self, namespace: Optional[str]) -> None:
        if namespace and namespace in self._frozen:
            raise TooManyRequests(
                f"namespace {namespace} is mid-move between partitions; "
                "retry after the handover window",
                retry_after=self.move_retry_after,
            )

    def quiesce_writes(self, namespace: str, timeout: float = 1.0) -> bool:
        """Wait until no mutation for ``namespace`` is in flight.
        Called AFTER :meth:`freeze`: a mutation that slipped past the
        frozen check before the freeze landed is still counted here,
        so once this returns True every ack the namespace will ever
        get is covered by the source's applied horizon."""
        deadline = time.monotonic() + timeout
        with self._inflight_cv:
            while self._inflight.get(namespace, 0):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cv.wait(remaining)
        return True

    # -- routing helpers -----------------------------------------------------

    def type_info(self, kind: str):
        return self.backends[0].type_info(kind)

    def kind_for_plural(self, plural: str) -> str:
        return self.backends[0].kind_for_plural(plural)

    def _ns_of_obj(self, obj: Obj) -> Optional[str]:
        info = self.type_info(obj.get("kind", ""))
        if not info.namespaced:
            return None
        return (obj.get("metadata") or {}).get("namespace")

    def _route(self, namespace: Optional[str]) -> int:
        # cluster-scoped objects (namespace None) live on the meta
        # partition; namespaced ones go to their HRW/override owner
        return self._map.owner_of(namespace) if namespace else 0

    # -- overload defense ----------------------------------------------------

    @staticmethod
    def _shed_expired(stage: str) -> None:
        if overload.expired():
            raise DeadlineExceeded(
                f"request deadline expired before {stage}"
            )

    def _breaker_for(self, p: int) -> overload.CircuitBreaker:
        try:
            return self._breakers[p]
        except KeyError:
            return self._breakers.setdefault(p, overload.CircuitBreaker())

    def _call_backend(self, p: int, call: Callable[[Any], Any]):
        """One breaker-guarded backend call. An open breaker sheds
        with a retryable 429 before touching the partition; outcomes
        and latency feed the rolling window. Expected client errors
        (4xx) and the caller's own expired deadline (504) are not
        endpoint sickness."""
        breaker = self._breaker_for(p)
        if not breaker.allow():
            raise TooManyRequests(
                f"partition {p} circuit breaker open; shedding until the "
                "endpoint proves healthy",
                retry_after=max(breaker.retry_after(), 0.01),
            )
        healthy = True
        t0 = time.monotonic()
        try:
            return call(self.backends[p])
        except DeadlineExceeded:
            raise
        except APIError as e:
            healthy = e.code < 500
            raise
        except Exception:
            healthy = False
            raise
        finally:
            breaker.record(healthy, time.monotonic() - t0)

    # -- cross-partition fencing --------------------------------------------
    #
    # A fencing Lease lives in ONE partition (its namespace's owner).
    # A fenced write landing in the SAME partition keeps the store's
    # atomic under-the-lock check. A fenced write to ANOTHER partition
    # would spuriously FencedOut (that store has no copy of the
    # lease), so the router validates the fence against the lease's
    # owning partition FIRST, then forwards the write unfenced —
    # check-then-act, the documented weakening for cross-partition
    # writes.

    def _validate_fence_at_owner(self, fence: tuple[str, str, int]) -> None:
        ns, name, token = fence
        owner = self.backends[self._route(ns)]
        try:
            lease = owner.get("Lease", name, ns)
        except NotFound:
            raise FencedOut(
                f"fencing lease {ns}/{name} no longer exists; epoch "
                f"{token} is deposed"
            ) from None
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
        now_fn = getattr(owner, "fence_now_fn", time.time)
        if lease_expired(lease, now_fn(), default_duration=0) and spec.get(
            "leaseDurationSeconds"
        ):
            raise FencedOut(
                f"fencing lease {ns}/{name} expired; epoch {token} may "
                "not write until it re-acquires"
            )

    def _fence_for(self, partition: int):
        """Context manager preparing the calling context's fence for a
        write to ``partition``: same-partition fences pass through
        untouched (atomic store-side check), cross-partition fences
        are validated at the lease's owner here and CLEARED for the
        downstream call."""
        fence = current_fence()
        if fence is None or self._route(fence[0]) == partition:
            return contextlib.nullcontext()
        self._validate_fence_at_owner(fence)

        @contextlib.contextmanager
        def cleared():
            tok = set_fence(None)
            try:
                yield
            finally:
                reset_fence(tok)

        return cleared()

    # -- mutations (routed, 307 on the wrong leader) -------------------------

    def _mutate(self, namespace: Optional[str], call: Callable[[Any], Any]):
        # an already-expired deadline sheds before ANY bookkeeping —
        # the caller gave up, so the cheapest outcome is no work at all
        self._shed_expired("partition write dispatch")
        # register in flight BEFORE the frozen check: quiesce_writes
        # sees this mutation even if it races the freeze, closing the
        # acked-but-unshipped window in the move protocol
        if namespace:
            with self._inflight_cv:
                self._inflight[namespace] = (
                    self._inflight.get(namespace, 0) + 1
                )
        try:
            self._check_frozen(namespace)
            p = self._route(namespace)
            if p not in self.owned:
                raise NotLeader(
                    f"partition {p} (namespace {namespace or '<cluster>'}) "
                    "is led elsewhere",
                    leader_url=self.urls.get(p, ""),
                )
            with self._fence_for(p):
                return self._call_backend(p, call)
        finally:
            if namespace:
                with self._inflight_cv:
                    n = self._inflight.get(namespace, 1) - 1
                    if n:
                        self._inflight[namespace] = n
                    else:
                        self._inflight.pop(namespace, None)
                    self._inflight_cv.notify_all()

    def _ns_of(self, kind: str, namespace: Optional[str]) -> Optional[str]:
        return namespace if self.type_info(kind).namespaced else None

    def create(self, obj: Obj, dry_run: bool = False) -> Obj:
        return self._mutate(
            self._ns_of_obj(obj), lambda b: b.create(obj, dry_run=dry_run)
        )

    def update(self, obj: Obj) -> Obj:
        return self._mutate(self._ns_of_obj(obj), lambda b: b.update(obj))

    def update_status(self, obj: Obj) -> Obj:
        return self._mutate(
            self._ns_of_obj(obj), lambda b: b.update_status(obj)
        )

    def patch(
        self,
        kind: str,
        name: str,
        patch: Obj,
        namespace: Optional[str] = None,
    ) -> Obj:
        return self._mutate(
            self._ns_of(kind, namespace),
            lambda b: b.patch(kind, name, patch, namespace=namespace),
        )

    def delete(
        self, kind: str, name: str, namespace: Optional[str] = None
    ) -> None:
        return self._mutate(
            self._ns_of(kind, namespace),
            lambda b: b.delete(kind, name, namespace=namespace),
        )

    def create_or_get(self, obj: Obj) -> Obj:
        return self._mutate(
            self._ns_of_obj(obj), lambda b: b.create_or_get(obj)
        )

    def emit_event(
        self,
        involved: Obj,
        reason: str,
        message: str,
        event_type: str = "Normal",
        component: str = "",
    ) -> Obj:
        ns = (involved.get("metadata") or {}).get("namespace") or "default"
        return self._mutate(
            ns,
            lambda b: b.emit_event(
                involved,
                reason,
                message,
                event_type=event_type,
                component=component,
            ),
        )

    def import_object(self, obj: Obj) -> Obj:
        return self._mutate(
            self._ns_of_obj(obj), lambda b: b.import_object(obj)
        )

    def purge_object(
        self, kind: str, name: str, namespace: Optional[str] = None
    ) -> bool:
        return self._mutate(
            self._ns_of(kind, namespace),
            lambda b: b.purge_object(kind, name, namespace=namespace),
        )

    # -- registry / admission (broadcast: every partition serves every
    #    kind, exactly like every kube apiserver replica serves every
    #    resource) ----------------------------------------------------------

    def register_kind(
        self,
        api_version: str,
        kind: str,
        plural: str,
        namespaced: bool = True,
    ) -> None:
        for b in self.backends.values():
            b.register_kind(api_version, kind, plural, namespaced)

    def register_admission_hook(
        self, kinds, fn, mutating: bool = True, name: str = ""
    ) -> None:
        for b in self.backends.values():
            b.register_admission_hook(kinds, fn, mutating=mutating, name=name)

    # -- reads ---------------------------------------------------------------

    def get(self, kind: str, name: str, namespace: Optional[str] = None) -> Obj:
        self._shed_expired("partition read dispatch")
        info = self.type_info(kind)
        p = self._route(namespace if info.namespaced else None)
        return self._call_backend(
            p, lambda b: b.get(kind, name, namespace=namespace)
        )

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
    ) -> list[Obj]:
        info = self.type_info(kind)
        if not info.namespaced or namespace:
            p = self._route(namespace if info.namespaced else None)
            return self.backends[p].list(
                kind,
                namespace=namespace,
                label_selector=label_selector,
                field_matches=field_matches,
                limit=limit,
            )
        if limit:
            items, _ = self.list_chunk(
                kind,
                label_selector=label_selector,
                field_matches=field_matches,
                limit=limit,
            )
            return items
        # cluster-spanning gather, ownership-filtered and re-merged
        # into the single-store (namespace, name) order
        rows: list[tuple[tuple[str, str], Obj]] = []
        for p, b in self.backends.items():
            for item in b.list(  # unbounded-ok: mirrors APIServer.list's unpaginated contract; bounded callers pass limit= and take the paged path above
                kind,
                label_selector=label_selector,
                field_matches=field_matches,
            ):
                ns = item.get("metadata", {}).get("namespace", "")
                if self._map.owner_of(ns) != p:
                    continue
                rows.append(((ns, item["metadata"].get("name", "")), item))
        rows.sort(key=lambda kv: kv[0])
        return [item for _, item in rows]

    # -- scatter-gather pagination ------------------------------------------

    def list_chunk(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
        continue_token: Optional[str] = None,
    ) -> tuple[list[Obj], str]:
        """One page of a paginated list. Namespaced walks route to the
        owning partition and carry that partition's own tokens
        untouched. Cluster-spanning walks are a k-way merge: each
        merged page holds the globally smallest (namespace, name) keys
        across every partition's cursor, and the composite token pins
        each partition's rv and cursor independently — so one
        partition compacting past its pin 410s ONLY that partition's
        leg, which restarts at a fresh rv pin from its saved cursor
        (kube's inconsistent-continuation semantics, applied
        per-partition) while every other leg resumes exactly where it
        stood."""
        info = self.type_info(kind)
        if info.namespaced and namespace:
            p = self._route(namespace)
            return self.backends[p].list_chunk(
                kind,
                namespace=namespace,
                label_selector=label_selector,
                field_matches=field_matches,
                limit=limit,
                continue_token=continue_token,
            )
        if not info.namespaced:
            return self.backends[0].list_chunk(
                kind,
                namespace=namespace,
                label_selector=label_selector,
                field_matches=field_matches,
                limit=limit,
                continue_token=continue_token,
            )
        return self._merged_list_chunk(
            kind, label_selector, field_matches, limit, continue_token
        )

    def _merged_list_chunk(
        self,
        kind: str,
        label_selector: Optional[Obj],
        field_matches: Optional[dict[str, Any]],
        limit: Optional[int],
        continue_token: Optional[str],
    ) -> tuple[list[Obj], str]:
        limit = max(int(limit) if limit else self.LIST_DEFAULT_LIMIT, 1)
        per_page = self.merge_page_limit or limit
        parts = sorted(self.backends)
        # cross-call walk state is ONLY the per-partition (rv pin,
        # cursor) vector. The cursor is the last key this walk
        # CONSUMED from that partition — emitted or ownership-filtered;
        # rows fetched but not emitted before the merged page filled
        # are simply refetched next call. "done" is call-local: a
        # partition whose cursor sits at its last key answers the next
        # call with one cheap empty page.
        rvs: dict[int, int] = {}
        cursors: dict[int, Optional[list[str]]] = {p: None for p in parts}
        done: set[int] = set()
        if continue_token:
            payload = decode_continue(continue_token)
            if not payload.get(_FLEET):
                raise BadRequest(
                    "continue token is not a fleet token; it belongs to a "
                    "single-partition walk"
                )
            if payload.get("kind") != kind or payload.get("ns", ""):
                raise BadRequest(
                    "fleet continue token does not match this list's kind"
                )
            rvs = {int(p): int(v) for p, v in (payload.get("rv") or {}).items()}
            for p, k in (payload.get("k") or {}).items():
                cursors[int(p)] = list(k) if k else None

        def fetch(p: int) -> list[Obj]:
            """One ownership-filtered page from partition ``p``'s
            cursor; advances the cursor past filtered rows and 410s by
            re-pinning ONLY this partition (partial restart)."""
            b = self.backends[p]
            while True:
                # every leg of the scatter-gather re-checks the
                # deadline: a merge over N partitions must not keep
                # paging N-1 healthy legs after the caller gave up
                self._shed_expired(f"the partition {p} merge leg")
                if p not in rvs:
                    # a remote backend reports None before its first
                    # response carried X-Served-RV; pin 0 and let the
                    # first page's serve establish the horizon
                    rvs[p] = int(b.applied_rv() or 0)
                ptoken = None
                if cursors[p] is not None:
                    ptoken = encode_continue(
                        {"rv": rvs[p], "kind": kind, "ns": "", "k": cursors[p]}
                    )
                try:
                    items, _ = self._call_backend(
                        p,
                        lambda b: b.list_chunk(
                            kind,
                            label_selector=label_selector,
                            field_matches=field_matches,
                            limit=per_page,
                            continue_token=ptoken,
                        ),
                    )
                except Expired:
                    # partial restart: fresh rv pin, SAME cursor — the
                    # other partitions' legs are untouched
                    del rvs[p]
                    continue
                if len(items) < per_page:
                    done.add(p)
                keep: list[Obj] = []
                for item in items:
                    meta = item.get("metadata", {})
                    key = [meta.get("namespace", ""), meta.get("name", "")]
                    if self._map.owner_of(key[0]) != p:
                        cursors[p] = key  # never emitted: skip past it
                        continue
                    keep.append(item)
                if keep or p in done:
                    return keep
                # a full page of not-owned rows (mid-move garbage):
                # cursor advanced a page, fetch the next one

        heads: dict[int, list[Obj]] = {}
        out: list[Obj] = []

        def key_of(item: Obj) -> tuple[str, str]:
            meta = item.get("metadata", {})
            return (meta.get("namespace", ""), meta.get("name", ""))

        while len(out) < limit:
            for p in parts:
                if p not in heads and p not in done:
                    heads[p] = fetch(p)
                if p in heads and not heads[p]:
                    if p in done:
                        del heads[p]
                    else:
                        heads[p] = fetch(p)
                        if not heads[p]:
                            del heads[p]
            live = {p: h for p, h in heads.items() if h}
            if not live:
                break
            p_min = min(live, key=lambda p: key_of(live[p][0]))
            item = heads[p_min].pop(0)
            meta = item.get("metadata", {})
            cursors[p_min] = [meta.get("namespace", ""), meta.get("name", "")]
            out.append(item)

        exhausted = all(
            p in done and not heads.get(p) for p in parts
        )
        token = ""
        if not exhausted:
            token = encode_continue(
                {
                    _FLEET: 1,
                    "kind": kind,
                    "ns": "",
                    "rv": {str(p): rvs[p] for p in parts if p in rvs},
                    "k": {str(p): cursors[p] for p in parts},
                }
            )
        return out, token

    # -- watches -------------------------------------------------------------

    @staticmethod
    def _leg_watch(b: Any, **kw: Any) -> Watch:
        # in-process APIServer/ReplicaStore take an ``inline`` kwarg;
        # RemoteAPIServer (HTTP legs under the bench/runner) does not —
        # it always pumps via a reader thread
        try:
            return b.watch(**kw)
        except TypeError:
            kw.pop("inline", None)
            return b.watch(**kw)

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        send_initial: bool = True,
        resource_version: Optional[str] = None,
        inline: bool = True,
    ) -> Watch:
        info = self.type_info(kind)
        if info.namespaced and namespace:
            return self._leg_watch(
                self.backends[self._route(namespace)],
                kind=kind,
                namespace=namespace,
                send_initial=send_initial,
                resource_version=resource_version,
                inline=inline,
            )
        if not info.namespaced:
            return self._leg_watch(
                self.backends[0],
                kind=kind,
                send_initial=send_initial,
                resource_version=resource_version,
                inline=inline,
            )
        # cluster-spanning merged stream, one leg per partition
        rvs: dict[int, int] = {}
        if resource_version is not None:
            if is_composite_token(str(resource_version)):
                rvs = decode_fleet_rvs(str(resource_version), kind)
            else:
                raise Invalid(
                    "a cluster-spanning watch on a partitioned store "
                    "resumes with a composite fleet token "
                    "(MergedWatch.resume_token()), not a scalar rv — "
                    "per-partition rv spaces are independent"
                )
        w = MergedWatch(self, kind, namespace)
        for p, b in sorted(self.backends.items()):
            try:
                leg = self._leg_watch(
                    b,
                    kind=kind,
                    send_initial=(send_initial and resource_version is None),
                    resource_version=(
                        str(rvs[p]) if p in rvs else None
                    ),
                    inline=inline,
                )
            except Expired as e:
                w.mark_expired(p, str(e))
                continue
            w.attach_leg(p, leg)
        # the slow-consumer bound covers the LIVE backlog on top of the
        # merged initial dump the legs just pumped in (same posture as
        # APIServer.watch — the dump must not evict its own consumer)
        w.maxsize = w._q.qsize() + getattr(
            self.backends[0], "WATCH_CACHE_SIZE", APIServer.WATCH_CACHE_SIZE
        )
        self._merged.add(w)
        return w

    # MergedWatch's Watch plumbing calls back into its "server"
    def _remove_watch(self, w: Watch) -> None:
        self._merged.discard(w)  # legs are stopped by MergedWatch.stop

    def _evict_watch(self, w: Watch) -> None:
        self._merged.discard(w)
        if isinstance(w, MergedWatch):
            for leg in w._legs.values():
                try:
                    leg.stop()
                except Exception:  # noqa: BLE001 — eviction is best-effort
                    log.debug(
                        "merged watch: leg stop failed on evict",
                        exc_info=True,
                    )

    # -- fleet surfaces ------------------------------------------------------

    def applied_rv(self) -> int:
        """Monotone fleet horizon: the SUM of per-partition applied
        rvs (each is monotone, so the sum is). A staleness surface,
        not a resume point — resumes carry the per-partition vector."""
        return sum(int(b.applied_rv() or 0) for b in self.backends.values())

    def applied_rvs(self) -> dict[int, int]:
        return {p: int(b.applied_rv() or 0) for p, b in self.backends.items()}

    def kind_version(self, kind: str) -> int:
        return sum(int(b.kind_version(kind) or 0) for b in self.backends.values())

    def state_digest(self) -> str:
        """The fleet digest: per-partition digests composed as sorted
        ``(partition, digest, rv)`` tuples (the replicas' bit-identity
        check, fleet-wide)."""
        return APIServer.compose_digests(self.partition_digests())

    def partition_digests(self) -> list[tuple[int, str, int]]:
        return [
            (p, b.state_digest(), int(b.applied_rv() or 0))
            for p, b in sorted(self.backends.items())
        ]

    def replication_cut(self) -> Obj:
        raise Invalid(
            "a partitioned store replicates PER PARTITION (rv spaces "
            "are independent); scope the pull with ?partition=<i> / "
            "partition_backend(i)"
        )

    def replication_watch(self, *args, **kwargs) -> Watch:
        raise Invalid(
            "a partitioned store replicates PER PARTITION (rv spaces "
            "are independent); scope the pull with ?partition=<i> / "
            "partition_backend(i)"
        )

    def replication_control(self) -> Obj:
        """The merged stream's CONTROL heartbeat: per-partition
        (rv, epoch) vector instead of one scalar horizon."""
        return {
            "type": "CONTROL",
            "partitions": [
                {
                    "partition": p,
                    "rv": int(b.applied_rv() or 0),
                    "epoch": getattr(b, "replication_epoch", 0),
                }
                for p, b in sorted(self.backends.items())
            ],
            "ts": time.time(),
        }

    def debug_queues(self) -> Obj:
        return {
            str(p): b.debug_queues()
            for p, b in sorted(self.backends.items())
            if hasattr(b, "debug_queues")
        }

    def snapshot_now(self) -> None:
        for b in self.backends.values():
            if getattr(b, "_wal", None) is not None:
                b.snapshot_now()

    def close(self) -> None:
        for b in self.backends.values():
            if hasattr(b, "close"):
                b.close()

    def attach_metrics(self, registry) -> None:
        for b in self.backends.values():
            if hasattr(b, "attach_metrics"):
                b.attach_metrics(registry)

    def __getattr__(self, name: str):
        # everything else (fence clocks, watch-eviction counters, …)
        # falls through to the meta partition, the ReadSplitAPI move
        return getattr(self.backends[0], name)


# ---------------------------------------------------------------------------
# live partition move


MOVE_LEASE_NS = "kube-system"


class PartitionMover:
    """Ship one namespace between partitions, live, with zero lost
    acks — the replicas' snapshot/catch-up protocol as the data plane.

    Protocol (sched_point-marked for the schedule explorer):

    1. **cut** — a consistent ``replication_cut`` of the source and a
       tail feed (``replication_watch``) opened AT the cut's rv, while
       writes keep flowing.
    2. **ship** — the cut's objects for the moving namespace are
       ``import_object``-ed into the destination (identity preserved,
       fresh local rvs), under the move lease's fencing token: a
       second mover racing this one is FencedOut atomically with its
       first apply.
    3. **tail** — the feed's records for the namespace replay onto the
       destination until the backlog is small, still live.
    4. **freeze** — the router refuses new writes for the namespace
       (retryable 429; never acked, so never lost) while the last tail
       records drain up to the source's frozen horizon.
    5. **takeover** — the destination's fencing epoch bumps past the
       source's, the router retargets the namespace (merged streams
       get a CONTROL ``moved`` frame), and the freeze lifts.
    6. **scrub** — the source's now-unowned copies are purged (WAL'd
       DELETEs; ownership filtering already hides them from every
       merged read, so the scrub is garbage collection, not
       correctness).

    ``run()`` is idempotent: a crash at ANY point (the kill-point
    drills sweep the destination's WAL ops) re-runs to completion —
    imports upsert, purges tolerate absence, and the router override
    is recorded only at takeover."""

    # seconds the freeze window may wait for the frozen tail to drain
    QUIESCE_TIMEOUT = _env_float("PARTITION_MOVE_QUIESCE_TIMEOUT", 5.0)
    # records applied per live catch-up round before re-checking the
    # backlog (bounds the time the feed is drained without yielding)
    TAIL_BUDGET = _env_int("PARTITION_MOVE_TAIL_BUDGET", 10000)
    # live catch-up stops chasing when the un-drained backlog is below
    # this many records — small enough to drain inside the freeze
    FREEZE_BACKLOG = _env_int("PARTITION_MOVE_FREEZE_BACKLOG", 64)

    def __init__(
        self,
        router: PartitionRouter,
        namespace: str,
        destination: int,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.router = router
        self.namespace = namespace
        self.destination = int(destination)
        self.source = router.owner_of(namespace)
        self.clock = clock
        self.lease_name = f"partition-move-{namespace}"
        self.stats: Obj = {}

    # -- fencing -------------------------------------------------------------

    def _acquire_move_token(self, dst: Any) -> int:
        """Create-or-bump the move Lease IN THE DESTINATION partition
        (the partition the handover writes land in, so the fence check
        is atomic with each apply) and return the fresh epoch."""
        try:
            lease = dst.get("Lease", self.lease_name, MOVE_LEASE_NS)
        except NotFound:
            lease = dst.create(  # unfenced-ok: creates the fencing lease itself (Lease writes are fence-exempt, like the elector's)
                {
                    "apiVersion": "coordination.k8s.io/v1",
                    "kind": "Lease",
                    "metadata": {
                        "name": self.lease_name,
                        "namespace": MOVE_LEASE_NS,
                    },
                    "spec": {"fencingToken": 0},
                }
            )
        spec = lease.setdefault("spec", {})
        token = int(spec.get("fencingToken", 0) or 0) + 1
        spec["fencingToken"] = token
        spec["holderIdentity"] = f"mover-{self.source}-{self.destination}"
        dst.update(lease)  # unfenced-ok: the epoch bump that CREATES the new fence; serialized by optimistic concurrency
        return token

    # -- data plane ----------------------------------------------------------

    def _in_namespace(self, obj: Obj) -> bool:
        return (obj.get("metadata") or {}).get("namespace") == self.namespace

    def _apply(self, dst: Any, etype: str, obj: Obj) -> None:
        meta = obj.get("metadata", {})
        if etype == "DELETED":
            dst.purge_object(
                obj.get("kind", ""), meta.get("name", ""), self.namespace
            )
        else:  # ADDED / MODIFIED — identity-preserving upsert
            dst.import_object(obj)

    def _drain_tail(
        self, feed: Watch, dst: Any, budget: int, block: bool
    ) -> tuple[int, int]:
        """Apply up to ``budget`` namespace records from the feed;
        returns (applied, last rv seen — any namespace)."""
        applied, last_rv = 0, 0
        while applied < budget:
            item = feed.get(timeout=0.05) if block else feed.try_get()
            if item is None:
                break
            etype, obj = item
            if etype in ("REGISTER", "CONTROL"):
                continue
            try:
                last_rv = int(
                    obj.get("metadata", {}).get("resourceVersion", 0) or 0
                )
            except (TypeError, ValueError):
                pass
            if self._in_namespace(obj):
                self._apply(dst, etype, obj)
                applied += 1
        return applied, last_rv

    # -- protocol ------------------------------------------------------------

    def run(self) -> Obj:
        if self.destination == self.source:
            return {"moved": 0, "noop": True}
        src = self.router.backend(self.source)
        dst = self.router.backend(self.destination)
        token = self._acquire_move_token(dst)
        t_start = self.clock()

        _schedule.sched_point("partition.move.cut")
        cut = src.replication_cut()
        cut_rv = int(cut.get("rv", 0))
        feed = src.replication_watch(from_rv=cut_rv, inline=True)
        moving = [o for o in cut.get("objects", []) if self._in_namespace(o)]

        shipped = tailed = 0
        frozen_ms = 0.0
        try:
            with fenced(MOVE_LEASE_NS, self.lease_name, token):
                _schedule.sched_point("partition.move.ship")
                for obj in moving:
                    dst.import_object(obj)
                    shipped += 1

                # live catch-up: chase the tail until the backlog is
                # small enough to drain inside the freeze window
                last_rv = cut_rv
                while True:
                    horizon = int(src.applied_rv())
                    if horizon - last_rv <= self.FREEZE_BACKLOG:
                        break
                    n, rv = self._drain_tail(
                        feed, dst, self.TAIL_BUDGET, block=False
                    )
                    tailed += n
                    last_rv = max(last_rv, rv)
                    if n == 0:
                        # feed is drained but the horizon moved: the
                        # gap is non-namespace traffic already seen
                        if rv == 0:
                            break

                _schedule.sched_point("partition.move.freeze")
                self.router.freeze(self.namespace)
                t_freeze = self.clock()
                try:
                    # barrier: writes that slipped past the frozen
                    # check before the freeze landed must commit (or
                    # reject) before the horizon below is trustworthy
                    if not self.router.quiesce_writes(
                        self.namespace, timeout=self.QUIESCE_TIMEOUT
                    ):
                        raise TooManyRequests(
                            f"partition move of {self.namespace}: in-"
                            "flight writes did not quiesce inside "
                            f"{self.QUIESCE_TIMEOUT}s; aborted before "
                            "takeover — retry",
                            retry_after=1.0,
                        )
                    # frozen horizon: nothing new for the namespace can
                    # be acked past this; drain the feed up to it
                    horizon = int(src.applied_rv())
                    deadline = self.clock() + self.QUIESCE_TIMEOUT
                    _schedule.sched_point("partition.move.tail")
                    while last_rv < horizon and self.clock() < deadline:
                        n, rv = self._drain_tail(
                            feed, dst, self.TAIL_BUDGET, block=True
                        )
                        tailed += n
                        last_rv = max(last_rv, rv)
                    if last_rv < horizon:
                        raise TooManyRequests(
                            f"partition move of {self.namespace} could not "
                            f"quiesce inside {self.QUIESCE_TIMEOUT}s "
                            f"(tail at rv {last_rv}, horizon {horizon}); "
                            "aborted before takeover — retry",
                            retry_after=1.0,
                        )
                    _schedule.sched_point("partition.move.takeover")
                    dst.replication_epoch = (
                        max(
                            int(getattr(dst, "replication_epoch", 0)),
                            int(getattr(src, "replication_epoch", 0)),
                        )
                        + 1
                    )
                    self.router.retarget(self.namespace, self.destination)
                finally:
                    self.router.unfreeze(self.namespace)
                    frozen_ms = (self.clock() - t_freeze) * 1000.0
                    _schedule.sched_point("partition.move.unfreeze")
        finally:
            feed.stop()

        scrubbed = self._scrub(src)
        self.stats = {
            "namespace": self.namespace,
            "from": self.source,
            "to": self.destination,
            "token": token,
            "shipped": shipped,
            "tailed": tailed,
            "scrubbed": scrubbed,
            "frozen_ms": round(frozen_ms, 3),
            "total_ms": round((self.clock() - t_start) * 1000.0, 3),
        }
        return self.stats

    def _scrub(self, src: Any) -> int:
        """Post-takeover garbage collection of the source's copies.
        Ownership filtering already hides them from every merged read
        and stream, so a crash mid-scrub leaves garbage, not
        incorrectness; the purge goes through the source's WAL so its
        own read replicas converge too."""
        scrubbed = 0
        for kind in list(getattr(src, "_store", {})):
            info = src.type_info(kind)
            if not info.namespaced:
                continue
            for obj in src.list(kind, namespace=self.namespace):  # unbounded-ok: post-takeover scrub of one namespace bucket, off every serving path
                # direct source access: the router now routes this
                # namespace to the destination, and the move lease
                # lives there — the scrub is the one deliberately
                # unfenced leg of the move protocol
                if src.purge_object(  # unfenced-ok: source-side GC after takeover; the namespace is already unowned and invisible
                    kind, obj["metadata"]["name"], self.namespace
                ):
                    scrubbed += 1
        return scrubbed


# ---------------------------------------------------------------------------
# fleet assembly


def build_partitions(
    n: int,
    wal_dir: str = "",
    wal_factory: Optional[Callable[[int], Any]] = None,
    **apiserver_kwargs,
) -> PartitionRouter:
    """N in-process partitions behind a router — the platform's
    ``STORE_PARTITIONS`` shape. With ``wal_dir`` set each partition
    recovers from (or creates) its own WAL under ``<wal_dir>/p<i>``;
    ``wal_factory(i)`` overrides WAL construction (the drills inject
    fault IO per partition)."""
    from odh_kubeflow_tpu_torch.machinery.wal import WriteAheadLog

    backends: dict[int, APIServer] = {}
    for i in range(max(1, int(n))):
        if wal_factory is not None:
            backends[i] = APIServer.recover(wal_factory(i), **apiserver_kwargs)
        elif wal_dir:
            backends[i] = APIServer.recover(
                WriteAheadLog(os.path.join(wal_dir, f"p{i}")),
                **apiserver_kwargs,
            )
        else:
            backends[i] = APIServer(**apiserver_kwargs)
    return PartitionRouter(backends)


def replica_router_from_env() -> Optional[tuple[Any, list[Any]]]:
    """Partition-aware ``REPLICA_OF``: run one follower ReplicaStore
    per partition behind a reads-only router (reads merge fleet-wide;
    mutations 307 to the owning partition's leader). Two shapes:

    - ``REPLICA_OF=<url0>,<url1>,…`` — one URL per partition leader
      (partition i replicates from url i);
    - ``REPLICA_OF=<router-url>`` + ``STORE_PARTITIONS=N`` — every
      partition replicates through ONE router-fronted endpoint,
      scoping each pull with ``?partition=<i>``.

    Returns (router, replication clients), or None when ``REPLICA_OF``
    is a single URL with no partitioning (the classic follower path).
    """
    raw = os.environ.get("REPLICA_OF", "")
    n_env = partitions_from_env()
    if "," not in raw and n_env <= 1:
        return None
    from odh_kubeflow_tpu_torch.machinery.replica import (
        ReplicaStore,
        ReplicationClient,
    )

    urls = [u.strip() for u in raw.split(",") if u.strip()]
    backends: dict[int, Any] = {}
    clients: list[Any] = []
    if len(urls) > 1:
        for i, url in enumerate(urls):
            rep = ReplicaStore(url)
            backends[i] = rep
            clients.append(ReplicationClient(rep).start())
        router_urls = dict(enumerate(urls))
    else:
        for i in range(n_env):
            rep = ReplicaStore(urls[0])
            backends[i] = rep
            clients.append(ReplicationClient(rep, partition=i).start())
        router_urls = {i: urls[0] for i in range(n_env)}
    router = PartitionRouter(
        backends,
        owned=set(),  # a follower fleet leads nothing: every write 307s
        urls=router_urls,
    )
    return router, clients
