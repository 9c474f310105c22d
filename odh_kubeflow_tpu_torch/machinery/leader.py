"""Lease-based leader election for split-process controllers (the
port's copy of the JAX package's ``machinery/leader.py``).

The reference's controllers run with controller-runtime leader election
(`--leader-elect`, notebook-controller/main.go:56-70): replicas > 1 are
safe because only the Lease holder reconciles. Same contract here over
the coordination.k8s.io/v1 Lease API the embedded apiserver serves:

- acquire: create the Lease, or take it over when the recorded
  renewTime is older than leaseDurationSeconds (holder died), bumping
  leaseTransitions;
- renew: update renewTime every renew_period while holding;
- lose: a conflicting update or an observed foreign holder stops the
  elector, and the runner exits the process — exactly what
  controller-runtime does, because continuing without the lease risks
  two actors reconciling the same keys.

Beyond the reference: **fencing tokens**. Leader election alone has a
TOCTOU — a holder paused (GC, SIGSTOP, network stall) after starting a
write can complete it *after* a peer legitimately took the lease over,
clobbering the new epoch's state. Every acquisition therefore bumps a
monotonic ``spec.fencingToken``; controller writes made inside
:func:`fenced` carry the epoch, and the store rejects writes whose
token is no longer current (``FencedOut``, validated atomically with
the apply). Remote clients propagate the fence in the
``X-Fencing-Token`` header.

**Namespace sharding** (:class:`ShardMembership`) layers horizontal
scale on the same Lease machinery: N manager replicas each hold a
membership lease in a named shard group, and each namespace is owned
by exactly one live member via rendezvous (highest-random-weight)
hashing — resharding on membership change moves only the dead
member's slice. A reconcile gate built from ``owns()`` keeps two
replicas from ever reconciling the same object, and per-member
fencing keeps a deposed replica's in-flight writes out of the store.

Times are stored RFC3339-micro like real kube (Lease spec uses
MicroTime).
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import logging
import os
import socket
import threading
import time
from typing import Any, Callable, Iterator, Optional

from odh_kubeflow_tpu_torch.machinery.store import (
    AlreadyExists,
    Conflict,
    NotFound,
    parse_micro_time,
    reset_fence,
    set_fence,
)

Obj = dict[str, Any]

log = logging.getLogger("machinery.leader")


def _fmt_micro(t: float) -> str:
    return datetime.datetime.fromtimestamp(
        t, datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


_parse_micro = parse_micro_time


@contextlib.contextmanager
def fenced(
    namespace: str, lease_name: str, token: int
) -> Iterator[None]:
    """Run the body with a fencing token installed on the calling
    context: every store mutation inside it is validated against the
    named Lease's current epoch and rejected with ``FencedOut`` when
    the epoch is stale or the lease has expired. The Manager wraps
    each reconcile in this automatically when built with an elector."""
    tok = set_fence((namespace, lease_name, int(token)))
    try:
        yield
    finally:
        reset_fence(tok)


def default_identity() -> str:
    return f"{socket.gethostname()}_{os.getpid()}"


def lease_expired(
    lease: Optional[Obj], now: float, default_duration: float = 15.0
) -> bool:
    """THE lease-freshness rule, shared by the elector's takeover, the
    shard heartbeat's rejoin-epoch bump, and the promotion watchdog's
    leader-death detection: a lease with no parseable renewTime, or
    one older than its own leaseDurationSeconds, is expired."""
    spec = (lease or {}).get("spec") or {}
    renew = spec.get("renewTime")
    if not renew:
        return True
    try:
        age = now - _parse_micro(renew)
    except (ValueError, TypeError):
        return True
    return age > float(
        spec.get("leaseDurationSeconds", default_duration) or default_duration
    )


class LeaderElector:
    def __init__(
        self,
        api,
        lease_name: str,
        namespace: str = "kubeflow",
        identity: Optional[str] = None,
        lease_duration: float = 15.0,
        renew_period: float = 5.0,
        retry_period: float = 2.0,
        now_fn: Callable[[], float] = time.time,
    ):
        self.api = api
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity or default_identity()
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self.retry_period = retry_period
        self.now = now_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the fencing token of our CURRENT epoch: set on every
        # successful acquisition (monotonic across holders — each
        # acquire bumps it), stale the moment anyone else acquires.
        # 0 = never held.
        self.token = 0

    # -- lease mechanics ----------------------------------------------------

    def _lease_obj(self, transitions: int, token: int) -> Obj:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.lease_name, "namespace": self.namespace},
            "spec": {
                "holderIdentity": self.identity,
                # whole seconds like kube's int32 field; never 0 (a
                # sub-second duration would read as instantly expired
                # AND disable the store's fence-freshness check)
                "leaseDurationSeconds": max(1, int(self.lease_duration)),
                "acquireTime": _fmt_micro(self.now()),
                "renewTime": _fmt_micro(self.now()),
                "leaseTransitions": transitions,
                "fencingToken": token,
            },
        }

    def fence(self):
        """Context manager installing this elector's current epoch on
        the calling context (see :func:`fenced`)."""
        return fenced(self.namespace, self.lease_name, self.token)

    def try_acquire(self) -> bool:
        """One acquire-or-renew attempt. True iff we hold the lease."""
        try:
            lease = self.api.get("Lease", self.lease_name, self.namespace)
        except NotFound:
            try:
                created = self.api.create(self._lease_obj(0, 1))
                self.token = int(created["spec"]["fencingToken"])
                return True
            except (AlreadyExists, Conflict):
                return False
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity")
        if holder == self.identity:
            spec["renewTime"] = _fmt_micro(self.now())
            try:
                self.api.update(lease)
                self.token = int(spec.get("fencingToken", self.token) or 0)
                return True
            except Conflict:
                return False  # someone raced us: treat as lost
        if not lease_expired(lease, self.now(), self.lease_duration):
            return False
        # take over a dead holder's lease; the bumped fencing token
        # deposes every write still in flight from the old epoch
        lease["spec"] = self._lease_obj(
            int(spec.get("leaseTransitions", 0)) + 1,
            int(spec.get("fencingToken", 0) or 0) + 1,
        )["spec"]
        try:
            updated = self.api.update(lease)
            self.token = int(updated["spec"]["fencingToken"])
            return True
        except Conflict:
            return False

    # -- lifecycle ----------------------------------------------------------

    def acquire(self, timeout: Optional[float] = None) -> bool:
        """Block until leadership is acquired (or timeout)."""
        deadline = None if timeout is None else self.now() + timeout
        while not self._stop.is_set():
            if self.try_acquire():
                return True
            if deadline is not None and self.now() >= deadline:
                return False
            time.sleep(self.retry_period)
        return False

    def run(self, on_lost: Callable[[], None]) -> None:
        """Start the renew loop (after a successful acquire).

        A transient API error (apiserver blip → URLError, timeout) must
        NOT kill the loop silently — that would leave the process
        reconciling while never renewing, the exact split-brain leader
        election exists to prevent. Errors are retried until the renew
        deadline (80% of lease_duration since the last successful
        renew); only a definitive loss (foreign holder / conflict) or a
        blown deadline fires on_lost."""

        def loop():
            last_renew = self.now()
            while not self._stop.is_set():
                time.sleep(self.renew_period)
                if self._stop.is_set():
                    return
                try:
                    if self.try_acquire():
                        last_renew = self.now()
                        continue
                    on_lost()  # definitive: someone else holds it
                    return
                except Exception:  # noqa: BLE001 — transient API error
                    if self.now() - last_renew > 0.8 * self.lease_duration:
                        on_lost()
                        return
                    time.sleep(self.retry_period)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def release(self) -> None:
        """Graceful handoff: drop holderIdentity so a peer can acquire
        without waiting out the lease duration. The fencing token is
        bumped too — a voluntary stand-down deposes our own epoch, so
        a write we somehow still have in flight cannot land after a
        peer takes over."""
        self._stop.set()
        try:
            lease = self.api.get("Lease", self.lease_name, self.namespace)
            if (lease.get("spec") or {}).get("holderIdentity") == self.identity:
                lease["spec"]["holderIdentity"] = ""
                lease["spec"]["renewTime"] = None
                lease["spec"]["fencingToken"] = (
                    int(lease["spec"].get("fencingToken", 0) or 0) + 1
                )
                self.api.update(lease)
        except (NotFound, Conflict):
            pass


# ---------------------------------------------------------------------------
# namespace-sharded membership


SHARD_LABEL = "odh.dev/shard-group"


def _hrw_weight(member: str, namespace: str) -> int:
    """Rendezvous (highest-random-weight) score of ``member`` for
    ``namespace``: stable across processes (no PYTHONHASHSEED), and
    minimal movement on membership change — only the slice owned by a
    departed member reshards."""
    return int.from_bytes(
        hashlib.blake2b(
            f"{member}\x00{namespace}".encode(), digest_size=8
        ).digest(),
        "big",
    )


class ShardMembership:
    """One manager replica's membership in a named shard group.

    Each replica heartbeats its own Lease (labelled with the group);
    the live-lease set IS the membership, and every namespace is owned
    by exactly one live member via rendezvous hashing. A dead replica
    stops renewing, ages out of ``members()`` within the lease
    duration, and its namespaces rendezvous to the survivors — no
    coordinator, no handoff protocol. A rejoin after expiry starts a
    NEW fencing epoch (peers may have reassigned our slice while we
    were presumed dead; writes from the old epoch must not land)."""

    def __init__(
        self,
        api,
        group: str,
        identity: Optional[str] = None,
        namespace: str = "kubeflow",
        lease_duration: float = 15.0,
        renew_period: float = 5.0,
        retry_period: float = 2.0,
        now_fn: Callable[[], float] = time.time,
    ):
        self.api = api
        self.group = group
        self.identity = identity or default_identity()
        self.namespace = namespace
        self.lease_name = f"shard-{group}-{self.identity}"
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self.retry_period = retry_period
        self.now = now_fn
        self.token = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # members() runs on the reconcile path; cache the lease scan
        # for a fraction of the renew period so sharding costs O(1)
        # per reconcile, not a Lease list
        self._members_cache: tuple[float, list[str]] = (-1.0, [])
        # membership-change callbacks (Manager resync): a member that
        # expires leaves NO watch event behind, so reshard detection
        # must poll — the heartbeat loop compares the live set each
        # period and fires these with (old, new)
        self._on_change: list[Callable[[list[str], list[str]], None]] = []
        self._last_members: Optional[list[str]] = None

    def _lease_obj(self, token: int) -> Obj:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {
                "name": self.lease_name,
                "namespace": self.namespace,
                "labels": {SHARD_LABEL: self.group},
            },
            "spec": {
                "holderIdentity": self.identity,
                # whole seconds like kube's int32 field; never 0 (a
                # sub-second duration would read as instantly expired)
                "leaseDurationSeconds": max(1, int(self.lease_duration)),
                "renewTime": _fmt_micro(self.now()),
                "leaseTransitions": 0,
                "fencingToken": token,
            },
        }

    def fence(self):
        """Context manager installing this member's current epoch (see
        :func:`fenced`) — the Manager wraps reconciles in it."""
        return fenced(self.namespace, self.lease_name, self.token)

    # -- heartbeat -----------------------------------------------------------

    def join(self) -> bool:
        """Create-or-renew our membership lease (one heartbeat). A
        renew after our lease already expired bumps the fencing token:
        the group treated us as dead, so our old epoch is over."""
        try:
            lease = self.api.get("Lease", self.lease_name, self.namespace)
        except NotFound:
            try:
                created = self.api.create(self._lease_obj(1))
                self.token = int(created["spec"]["fencingToken"])
                self._members_cache = (-1.0, [])
                return True
            except (AlreadyExists, Conflict):
                return False
        spec = lease.get("spec") or {}
        token = int(spec.get("fencingToken", 0) or 0)
        if lease_expired(lease, self.now(), self.lease_duration):
            token += 1
        lease["spec"] = self._lease_obj(token)["spec"]
        try:
            self.api.update(lease)
            self.token = token
            return True
        except Conflict:
            return False

    def add_on_change(
        self, cb: Callable[[list[str], list[str]], None]
    ) -> None:
        """Register a membership-change callback (fired from the
        heartbeat thread with the old and new sorted member lists).
        The Manager hooks its reshard resync here: namespaces this
        replica newly owns get their objects re-enqueued, because an
        expired peer leaves no watch event to trigger them."""
        self._on_change.append(cb)

    def _check_membership_change(self) -> None:
        current = self.members(fresh=True)
        if self._last_members is None:
            self._last_members = current
            return
        if current != self._last_members:
            old, self._last_members = self._last_members, current
            for cb in self._on_change:
                try:
                    cb(old, current)
                except Exception:  # noqa: BLE001 — a bad cb must not kill the heartbeat
                    log.exception(
                        "shard %s: membership-change callback failed",
                        self.group,
                    )

    def run(self, on_lost: Callable[[], None]) -> None:
        """Start the heartbeat loop. Transient API errors are retried;
        a renew gap longer than 80% of the lease duration fires
        ``on_lost`` (the replica must stop reconciling — peers already
        consider it dead)."""

        def loop():
            last = self.now()
            while not self._stop.is_set():
                time.sleep(self.renew_period)
                if self._stop.is_set():
                    return
                try:
                    if self.join():
                        last = self.now()
                        self._check_membership_change()
                        continue
                except Exception as e:  # noqa: BLE001 — transient API error
                    log.warning(
                        "shard %s: heartbeat failed (%s); retrying",
                        self.lease_name,
                        e,
                    )
                if self.now() - last > 0.8 * self.lease_duration:
                    on_lost()
                    return
                time.sleep(self.retry_period)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def leave(self) -> None:
        """Graceful departure: delete our lease so peers reshard
        immediately instead of waiting out the lease duration."""
        self._stop.set()
        try:
            self.api.delete("Lease", self.lease_name, self.namespace)
        except (NotFound, Conflict):
            pass

    # -- membership & ownership ---------------------------------------------

    def members(self, fresh: bool = False) -> list[str]:
        """Sorted identities of live members (leases in the group with
        an unexpired renewTime). Cached for a fraction of the renew
        period unless ``fresh``."""
        now = self.now()
        cached_at, cached = self._members_cache
        if not fresh and cached_at >= 0 and now - cached_at < min(
            self.renew_period, 1.0
        ) * 0.5:
            return cached
        leases = self.api.list(
            "Lease",
            namespace=self.namespace,
            label_selector={"matchLabels": {SHARD_LABEL: self.group}},
        )
        out = []
        for lease in leases:
            spec = lease.get("spec") or {}
            renew = spec.get("renewTime")
            ident = spec.get("holderIdentity")
            if not renew or not ident:
                continue
            try:
                age = now - _parse_micro(renew)
            except ValueError:
                continue
            if age > float(
                spec.get("leaseDurationSeconds", self.lease_duration)
            ):
                continue
            out.append(ident)
        out.sort()
        self._members_cache = (now, out)
        return out

    def owner_of(
        self, namespace: str, members: Optional[list[str]] = None
    ) -> Optional[str]:
        if members is None:
            members = self.members()
        if not members:
            return None
        return max(members, key=lambda m: _hrw_weight(m, namespace))

    def owns(self, namespace: str) -> bool:
        """Whether THIS replica owns ``namespace`` under the current
        membership. Cluster-scoped objects (empty namespace) hash the
        empty string, so exactly one member owns them too."""
        return self.owner_of(namespace) == self.identity
