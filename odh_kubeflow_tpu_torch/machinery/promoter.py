"""Promotion watchdog: hands-off control-plane failover (the port's
copy of the JAX package's ``machinery/promoter.py``).

Replica failover's mechanical pieces — WAL-shipped followers, the leader
Lease's monotonic fencing token, epoch-checked stream rejection
(``FencedOut``), ``ReplicaStore.promote`` — need someone to notice the
leader died and call ``promote()``. This module is the sidecar that
composes those pieces into an automatic failover:

- **liveness** comes from the lease machinery the leader already
  heartbeats: the leader renews its Lease (and, in sharded
  deployments, its ShardMembership lease) into its own store, and
  replication ships every renewal to the follower. The watchdog reads
  that REPLICATED lease from the follower's local store — when the
  leader zone dies, the renewals stop arriving and the local copy
  goes stale by exactly the lease-expiry rule every other consumer
  uses (:func:`machinery.leader.lease_expired`).
- **takeover** is the elector's fencing-token bump: the watchdog
  promotes the follower under ``fencingToken + 1`` and immediately
  writes the takeover Lease through a :class:`LeaderElector` pointed
  at the now-writable store. The deposed leader's still-flowing
  stream (lower epoch) is rejected with ``FencedOut`` — the split
  never merges.
- **one promoter**: with several followers, each watchdog ranks the
  SURVIVING watchdog identities (the shard group's replicated
  membership leases, minus the dead leader) by rendezvous hash; only
  the top-ranked survivor promotes, the rest stand by for the new
  leader's stream. With a single follower (the common HA pair) the
  rank is trivially ours.

The watchdog is deliberately a state machine driven by :meth:`step`
(the drills advance it with an injected clock); :meth:`run` wraps it
in the usual daemon-thread poll loop for the ``PROMOTION_WATCHDOG``
deployment shape.

False-positive guard: a stale *replicated* lease can also mean OUR
replication is wedged while the leader is healthy. Promoting then
would be split-brain by watchdog. The ``stream_alive_fn`` hook (wired
to the ReplicationClient's connection state) vetoes promotion while
the stream still delivers; a wedged stream AND a stale lease together
are indistinguishable from leader death at this layer — which is the
correct failover trigger, because either way nobody is serving writes
to this replica's clients.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.machinery.leader import (
    LeaderElector,
    SHARD_LABEL,
    _hrw_weight,
    default_identity,
    lease_expired,
    parse_micro_time,
)
from odh_kubeflow_tpu_torch.machinery.store import APIError, NotFound
from odh_kubeflow_tpu_torch.utils import prometheus

Obj = dict[str, Any]

log = logging.getLogger("machinery.promoter")


class PromotionWatchdog:
    """Watch the replicated leader Lease; when the leader provably
    died, promote the follower under a bumped fencing epoch with zero
    manual steps.

    States (:attr:`state` / :meth:`step` return value):

    - ``leader-alive``  — the replicated lease is fresh;
    - ``no-lease``      — no leader lease has ever replicated (a cold
      pair still bootstrapping; never promote into that);
    - ``stream-alive``  — lease stale but the replication stream is
      still delivering (our lease view is lagging, not the leader);
    - ``grace``         — lease expired, waiting out the confirmation
      window (``grace_windows`` extra lease durations);
    - ``standby``       — leader dead but a better-ranked surviving
      watchdog owns the promotion;
    - ``promoted``      — this follower is the leader now (terminal;
      further steps renew the takeover lease)."""

    def __init__(
        self,
        replica: Any,
        *,
        lease_name: str,
        namespace: str = "kubeflow",
        identity: str = "",
        lease_duration: float = 15.0,
        grace_windows: float = 1.0,
        membership_group: str = "",
        stream_alive_fn: Optional[Callable[[], bool]] = None,
        on_promoted: Optional[Callable[[int], None]] = None,
        now_fn: Callable[[], float] = time.time,
        registry: Optional[prometheus.Registry] = None,
    ):
        self.replica = replica
        self.lease_name = lease_name
        self.namespace = namespace
        # per-process unique (hostname_pid) by default: two followers'
        # watchdogs sharing one constant identity would BOTH win the
        # one-promoter rendezvous and promote under the same epoch —
        # dual leaders whose equal tokens cannot fence each other
        self.identity = identity or default_identity()
        self.lease_duration = lease_duration
        # extra lease windows the lease must stay expired before the
        # takeover fires — one renew blip must not fail the leader over
        self.grace_windows = max(float(grace_windows), 0.0)
        self.membership_group = membership_group
        self.stream_alive_fn = stream_alive_fn
        self.on_promoted = on_promoted
        self.now = now_fn
        self.state = "no-lease"
        self.promoted_epoch = 0
        self._expired_since: Optional[float] = None
        self._elector: Optional[LeaderElector] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = registry or prometheus.default_registry
        self.m_promotions = reg.counter(
            "replica_promotions_total",
            "Followers promoted to leader by the promotion watchdog",
        )
        self.m_lease_age = reg.gauge(
            "promotion_watchdog_lease_age_seconds",
            "Age of the replicated leader lease as seen by the watchdog",
        )

    # -- liveness reads (all against the follower's local store) -------------

    def _leader_lease(self) -> Optional[Obj]:
        try:
            return self.replica.get("Lease", self.lease_name, self.namespace)
        except (NotFound, APIError):
            return None

    def _surviving_watchdogs(
        self, dead_holder: str, as_of: Optional[float]
    ) -> list[str]:
        """Identities eligible to promote: the watchdog shard group's
        members as REPLICATED to this follower (each watchdog
        heartbeats its membership lease THROUGH the leader while it
        lives — ``serve_replica`` wires this — so peers see each
        other), minus the dead leader's own identity, minus members
        whose lease had ALREADY expired as of the leader's last renew
        (they died first; ranking a corpse would park every live
        watchdog in standby forever), plus always ourselves (a
        watchdog that never joined — the single-follower pair — still
        promotes). The replicated renewTimes froze when the stream
        died, so freshness is judged against ``as_of`` (the dead
        leader lease's own frozen renew instant), never wall-now."""
        survivors = {self.identity}
        if not self.membership_group:
            return sorted(survivors)
        try:
            leases = self.replica.list(
                "Lease",
                namespace=self.namespace,
                label_selector={
                    "matchLabels": {SHARD_LABEL: self.membership_group}
                },
            )
        except (NotFound, APIError):
            return sorted(survivors)
        for lease in leases:
            ident = ((lease.get("spec") or {}).get("holderIdentity")) or ""
            if not ident or ident == dead_holder:
                continue
            if as_of is not None and lease_expired(
                lease, as_of, self.lease_duration
            ):
                continue  # dead before the leader died — not a survivor
            survivors.add(ident)
        return sorted(survivors)

    def _chosen_promoter(self, survivors: list[str]) -> str:
        return max(
            survivors,
            key=lambda m: _hrw_weight(m, f"{self.namespace}/{self.lease_name}"),
        )

    # -- the state machine ----------------------------------------------------

    def step(self) -> str:
        """Advance once; returns (and records) the state."""
        if self.state == "promoted":
            # keep the takeover lease renewed so a future watchdog
            # generation sees a live leader
            if self._elector is not None:
                self._elector.try_acquire()
            return self.state
        lease = self._leader_lease()
        if lease is None:
            self.state = "no-lease"
            return self.state
        now = self.now()
        spec = lease.get("spec") or {}
        renew = spec.get("renewTime")
        if renew:
            try:
                self.m_lease_age.set(
                    max(now - parse_micro_time(renew), 0.0)
                )
            except (ValueError, TypeError):
                pass
        if not lease_expired(lease, now, self.lease_duration):
            self._expired_since = None
            self.state = "leader-alive"
            return self.state
        if self.stream_alive_fn is not None and self.stream_alive_fn():
            # records still arriving: the leader is alive and OUR view
            # of its lease is what lags — never promote on that
            self._expired_since = None
            self.state = "stream-alive"
            return self.state
        if self._expired_since is None:
            self._expired_since = now
        if now - self._expired_since < self.grace_windows * self.lease_duration:
            self.state = "grace"
            return self.state
        as_of: Optional[float] = None
        if renew:
            try:
                as_of = parse_micro_time(renew)
            except (ValueError, TypeError):
                pass
        survivors = self._surviving_watchdogs(
            str(spec.get("holderIdentity") or ""), as_of
        )
        if self._chosen_promoter(survivors) != self.identity:
            self.state = "standby"
            return self.state
        self._promote(int(spec.get("fencingToken", 0) or 0) + 1)
        return self.state

    def _promote(self, epoch: int) -> None:
        """The composed takeover: promote the store under the bumped
        epoch FIRST (the follower must accept writes before the lease
        can be written into it), then take the Lease over through the
        elector — whose acquire bumps the fencing token to exactly
        this epoch, deposing every write still in flight from the old
        leader."""
        self.replica.promote(epoch)
        self._elector = LeaderElector(
            self.replica,
            self.lease_name,
            namespace=self.namespace,
            identity=self.identity,
            lease_duration=self.lease_duration,
        )
        if not self._elector.try_acquire():
            # the only writer to this store is us, so a failed acquire
            # means a racing epoch arrived via replication — the old
            # leader is alive after all. Stay promoted (the fence now
            # protects both sides) but say so loudly.
            log.warning(
                "promotion watchdog %s: lease takeover conflicted after "
                "promote(%d); continuing under the bumped epoch",
                self.identity,
                epoch,
            )
        elif self._elector.token != epoch:
            # the live lease's token moved under us; adopt the higher
            # epoch so the store fence and the lease agree
            epoch = max(epoch, self._elector.token)
            self.replica.promote(epoch)
        self.promoted_epoch = epoch
        self.state = "promoted"
        self.m_promotions.inc()
        log.warning(
            "promotion watchdog %s: leader lease %s/%s expired beyond "
            "%.1f lease window(s); follower promoted under epoch %d",
            self.identity,
            self.namespace,
            self.lease_name,
            self.grace_windows,
            epoch,
        )
        if self.on_promoted is not None:
            self.on_promoted(epoch)

    # -- sidecar lifecycle ----------------------------------------------------

    def run(self, poll_period: Optional[float] = None) -> "PromotionWatchdog":
        """Poll :meth:`step` forever on a daemon thread (the sidecar
        deployment shape). Default cadence is a third of the lease
        duration — detection within one window, promotion bounded by
        ``1 + grace_windows`` windows."""
        period = poll_period or max(self.lease_duration / 3.0, 0.05)

        def loop():
            while not self._stop.is_set():
                try:
                    self.step()
                except Exception:  # noqa: BLE001 — the watchdog must outlive blips
                    log.exception("promotion watchdog step failed; retrying")
                self._stop.wait(period)

        self._thread = threading.Thread(
            target=loop, name="promotion-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
