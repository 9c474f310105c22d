"""The admission cycle: all-or-nothing gang admission with priority
preemption over the GPU quota pools + node-pool inventory (the port's
copy of the JAX package's ``scheduling/scheduler.py``).

Kueue-shaped semantics, sized for this platform:

- **gang admission** — a Workload is admitted only when GPU quota AND
  a matching node pool with enough free nodes exist for the whole
  gang; the node assignment is decided here, atomically, and recorded
  on the Workload so the kubelet sim binds all nodes or none.
- **strict priority order** — pending Workloads are scanned priority
  desc / age asc; when one cannot be admitted, every lower-priority
  workload contending for the same pool (same profile-namespace quota
  or same accelerator/GPUs-a-node flavor) is blocked behind it. No
  queue jumping.
- **preemption** — a starved higher-priority workload evicts the
  minimal set of lower-priority admitted workloads (lowest priority
  first, newest admission first) whose release lets it fit. Eviction
  is gang-atomic: every pod of the victim is deleted and the victim
  requeues.
- **requeue with backoff** — unschedulable workloads retry on an
  exponential backoff (and on any Workload/Node/Pod/quota change,
  since every watch event re-triggers the cycle).
- **zone awareness** — pools carry their failure domain
  (``topology.kubernetes.io/zone``) and spot class; the fit spreads
  gangs across the least-committed zone and prefers on-demand
  capacity. ``drain_zone`` runs checkpoint-then-preempt as
  **checkpoint-then-migrate**: every gang in the zone suspends to its
  (zone-replicated) checkpoint, its Workload re-enqueues with the
  drained zone excluded, and the session resumes in a surviving zone
  — hard-evict only for non-suspendable gangs. A NodeLost storm (≥
  ``zone_storm_threshold`` gangs losing nodes in one zone in one
  cycle) escalates per-node eviction into exactly that zone drain.

With a ``suspender`` (the ``SessionManager``) preemption is
checkpoint-then-preempt and an overcommitted pool asks idle sessions to
yield (``_plan_suspend_reclaim``); without one every preemption and
every drain is a hard kill, as the JAX scheduler's is. The usage meter
and the admission spans are not ported yet (ROADMAP.md).

The cycle is a pure function of cluster state: snapshot, charge
admitted, scan pending, write statuses. Re-running it with no state
change writes nothing (the store suppresses no-op updates), which is
what lets the level-triggered runtime quiesce.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.apis import GPU_RESOURCE, pod_gpus
from odh_kubeflow_tpu_torch.controllers.runtime import Manager, Request, Result
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.cache import list_by_index
from odh_kubeflow_tpu_torch.machinery.events import EventRecorder
from odh_kubeflow_tpu_torch.machinery.objects import mutable
from odh_kubeflow_tpu_torch.machinery.store import Conflict, NotFound
from odh_kubeflow_tpu_torch.scheduling import (
    STATE_ADMITTED,
    STATE_PENDING,
    WORKLOAD_LABEL,
)
from odh_kubeflow_tpu_torch.scheduling import workload as wlutil
from odh_kubeflow_tpu_torch.scheduling.queue import (
    QuotaSnapshot,
    SliceInventory,
    pending_order,
)
from odh_kubeflow_tpu_torch.utils import prometheus

Obj = dict[str, Any]

COMPONENT = "gpu-gang-scheduler"

# admission waits span sub-second (sim) to hours (a busy H100 pool)
_WAIT_BUCKETS = (
    0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 900.0, 3600.0, 14400.0,
)
_BACKOFF_BASE = 0.5
_BACKOFF_CAP = 30.0


def _flavor(wl: Obj) -> tuple[str, str]:
    spec = wl.get("spec") or {}
    return spec.get("acceleratorType", ""), spec.get("acceleratorCount", "")


class SliceScheduler:
    def __init__(
        self,
        api: Any,
        registry: Optional[prometheus.Registry] = None,
        time_fn: Callable[[], float] = time.time,
        suspender: Optional[Any] = None,
        zone_storm_threshold: int = 2,
        zone_drain_cooldown: float = 60.0,
    ):
        self.api = api
        self.now = time_fn
        # gangs losing nodes in ONE zone in ONE cycle before per-node
        # eviction escalates to a full zone drain
        self.zone_storm_threshold = max(int(zone_storm_threshold), 1)
        # how long a storm-triggered drain outlives the last loss
        # before a zone with live capacity is trusted again
        self.zone_drain_cooldown = zone_drain_cooldown
        # zone → {"trigger": operator|node-storm, "since": ts}; fit
        # excludes these failure domains and the drain pass migrates
        # everything already placed in them
        self._drained_zones: dict[str, dict[str, Any]] = {}
        # whether zone-drain suspends may be outstanding — gates the
        # per-cycle migration scan off the hot path. Starts True: a
        # restarted scheduler must scan once to pick up suspends a
        # previous incarnation requested (its memory died with it).
        self._zone_migrations_pending = True
        # checkpoint-then-preempt hooks (sessions.manager.SessionManager
        # duck: is_suspendable / suspend_in_flight / request_suspend).
        # None → every preemption is a hard kill.
        self.suspender = suspender
        self.recorder = EventRecorder(api, COMPONENT)
        reg = registry or prometheus.default_registry
        self.m_pending = reg.gauge(
            "pending_workloads",
            "Workloads queued and not yet admitted, per quota pool",
            labelnames=("queue",),
        )
        self.m_attempts = reg.counter(
            "admission_attempts_total",
            "Workload admission attempts by result",
            labelnames=("result",),
        )
        self.m_wait = reg.histogram(
            "admission_wait_seconds",
            "Time from workload queued to admitted",
            buckets=_WAIT_BUCKETS,
        )
        self.m_preemptions = reg.counter(
            "workload_preemptions_total",
            "Admitted workloads evicted, by cause",
            labelnames=("reason",),
        )
        self.m_zone_drains = reg.counter(
            "zone_drains_total",
            "Zone drains started, by trigger",
            labelnames=("trigger",),
        )
        self.m_migrations = reg.counter(
            "zone_migrations_total",
            "Suspended sessions re-enqueued out of a drained zone",
        )
        self.m_drained = reg.gauge(
            "drained_zones",
            "Failure domains currently excluded from placement",
        )
        # per-workload failed-admission streak (in memory: backoff is
        # scheduler-local state, not API truth — a restarted scheduler
        # retrying immediately is correct, not a bug)
        self._attempts: dict[tuple[str, str], int] = {}
        self._known_queues: set[str] = set()

    # -- wiring -------------------------------------------------------------

    def register(self, mgr: Manager) -> None:
        """Any Workload / Node / gang-Pod / quota change re-triggers an
        admission cycle; the cycle itself is global (ordering across
        workloads is the whole point), so every event maps to one
        reconcile of the full queue. (The JAX scheduler's Workload
        events map to one request per Workload, so a pass that changed
        N Workloads ran N full cycles.)"""
        ctrl = mgr.new_controller(
            "gpu-scheduler", "Workload", self.reconcile, for_map=self._map_cycle
        )
        ctrl.watches("Node", self._map_cycle)
        ctrl.watches("ResourceQuota", self._map_cycle)
        ctrl.watches("Pod", self._map_cycle, predicate=self._pod_is_relevant)
        if self.suspender is not None:
            # a checkpoint turning Suspended frees committed capacity;
            # a workload waiting on AwaitingSuspend admits on this watch
            ctrl.watches("SessionCheckpoint", self._map_cycle)

    @staticmethod
    def _pod_is_relevant(_etype: str, pod: Obj) -> bool:
        """Gang pods, and ANY pod holding GPUs — a non-gang pod binding
        onto reserved capacity must wake the cycle so the colliding
        reservation re-places instead of wedging."""
        return WORKLOAD_LABEL in obj_util.labels_of(pod) or pod_gpus(pod) > 0

    def _map_cycle(self, _etype: str, _obj: Obj) -> list[Request]:
        return [Request("", "admission-cycle")]

    def reconcile(self, _req: Request) -> Result:
        return self.run_cycle()

    # -- the cycle ----------------------------------------------------------

    def run_cycle(self) -> Result:
        inventory = SliceInventory.snapshot(self.api)
        quotas = QuotaSnapshot.snapshot(self.api)
        # global by design: admission ORDER across every queue is the
        # cycle's whole job. mutable(): the cycle writes statuses onto
        # these in-hand objects.
        workloads = [mutable(w) for w in self.api.list("Workload")]

        admitted: list[Obj] = []
        pending: list[Obj] = []
        # NodeLost-storm ledger: gangs that lost assigned nodes this
        # cycle, per failure domain (the zone recorded at admission)
        lost_zones: dict[str, int] = {}
        for wl in workloads:
            if wlutil.is_admitted(wl) and not self._assignment_lost(
                wl, inventory
            ):
                admitted.append(wl)
            elif wlutil.is_admitted(wl):
                # gang atomicity under node loss: one lost node
                # invalidates the whole gang — evict every pod and
                # requeue it, never leave a partial binding. A spec
                # edit under an old assignment reads differently from
                # an actual node loss.
                lost = [
                    n
                    for n in wlutil.assigned_nodes(wl)
                    if not inventory.has_node(n)
                ]
                if lost:
                    reason, metric_reason = "NodeLost", "node_lost"
                    message = (
                        f"assigned GPU node(s) {', '.join(lost)} lost; "
                        "gang requeued"
                    )
                    zone = obj_util.get_path(
                        wl, "status", "assignment", "zone", default=""
                    )
                    if zone:
                        lost_zones[zone] = lost_zones.get(zone, 0) + 1
                else:
                    reason, metric_reason = (
                        "AssignmentInvalid",
                        "assignment_invalid",
                    )
                    message = (
                        "node-pool assignment no longer matches the "
                        "workload spec; gang requeued"
                    )
                self._evict(
                    wl,
                    reason=reason,
                    message=message,
                    metric_reason=metric_reason,
                )
                pending.append(wl)
            else:
                pending.append(wl)

        # zone failure handling BEFORE capacity is charged: a NodeLost
        # storm escalates to a drain, healed storm-drains expire, and
        # the drain pass migrates gangs still placed in drained zones
        self._detect_zone_storms(lost_zones)
        self._expire_storm_drains(inventory, lost_zones)
        if self._drained_zones:
            self._drain_pass(admitted, pending)
        self.m_drained.set(len(self._drained_zones))

        # charge what's already admitted (workload-level reservation)…
        for wl in admitted:
            inventory.charge_workload(wl)
            quotas.charge(obj_util.namespace_of(wl), wlutil.gpus_of(wl))
        # …and GPU pods outside the workload system (legacy / direct
        # creations): bound pods hold real GPUs the fit must respect
        self._charge_foreign_pods(inventory, quotas)

        # a foreign pod that bound onto reserved capacity over-commits
        # the node and would wedge the gang in SchedulingGated forever
        # (the kubelet refuses a bind that doesn't fit); evict the
        # colliding reservation so it re-admits somewhere that fits
        for wl in self._overcommitted_victims(admitted, inventory):
            self._evict(
                wl,
                reason="AssignmentInvalid",
                message=(
                    "assigned node capacity taken by pods outside the "
                    "gang; requeuing for a fresh placement"
                ),
                metric_reason="assignment_invalid",
            )
            admitted.remove(wl)
            inventory.release_workload(wl)
            quotas.release(obj_util.namespace_of(wl), wlutil.gpus_of(wl))
            pending.append(wl)

        # per-zone committed GPUs — the zone-spread preference's load
        # axis (admissions below keep it current as they land)
        zone_load: dict[str, int] = {}
        for wl in admitted:
            zone = obj_util.get_path(
                wl, "status", "assignment", "zone", default=""
            ) or inventory.zone_of_pool(
                obj_util.get_path(
                    wl, "status", "assignment", "pool", default=""
                )
            )
            if zone:
                zone_load[zone] = zone_load.get(zone, 0) + wlutil.gpus_of(wl)

        # strict priority scan with head-of-line blocking per pool
        blocked_ns: set[str] = set()
        blocked_flavor: set[tuple[str, str]] = set()
        pending_counts: dict[str, int] = {}
        any_unadmitted = False
        position = 0
        for wl in pending_order(pending):
            ns = obj_util.namespace_of(wl)
            key = (ns, obj_util.name_of(wl))
            flavor = _flavor(wl)
            outcome = self._try_admit(
                wl,
                inventory,
                quotas,
                admitted,
                blocked=(ns in blocked_ns or flavor in blocked_flavor),
                zone_load=zone_load,
            )
            if outcome is None:  # admitted — wl's status was written in place
                self._attempts.pop(key, None)
                admitted.append(wl)
                zone = obj_util.get_path(
                    wl, "status", "assignment", "zone", default=""
                )
                if zone:
                    zone_load[zone] = zone_load.get(zone, 0) + wlutil.gpus_of(wl)
                continue
            reason, message = outcome
            any_unadmitted = True
            position += 1  # place among workloads still waiting
            pending_counts[ns] = pending_counts.get(ns, 0) + 1
            self._attempts[key] = self._attempts.get(key, 0) + 1
            # head-of-line: everything lower-priority contending for
            # this workload's pools queues behind it
            if quotas.cap(ns) is not None:
                blocked_ns.add(ns)
            blocked_flavor.add(flavor)
            self._write_pending(wl, reason, message, position)

        self._gc_attempts(workloads)
        for queue in self._known_queues | set(pending_counts):
            self.m_pending.set(
                pending_counts.get(queue, 0), labels={"queue": queue}
            )
        self._known_queues |= set(pending_counts)

        # checkpoint-then-migrate, the resume half: zone-drain suspends
        # whose checkpoint is durable re-enqueue their Workload (the
        # scan above — and every later cycle — places them with the
        # drained zone excluded)
        migrations_pending = self._advance_zone_migrations()

        if any_unadmitted:
            streak = max(self._attempts.values(), default=1)
            return Result(
                requeue_after=min(
                    _BACKOFF_BASE * (2 ** min(streak - 1, 8)), _BACKOFF_CAP
                )
            )
        if migrations_pending or self._drained_zones:
            # drains settle asynchronously (snapshots landing, storm
            # cooldowns expiring) — keep the cycle coming back even
            # when no watch event fires
            return Result(requeue_after=2.0)
        return Result()

    # -- admission ----------------------------------------------------------

    def _try_admit(
        self,
        wl: Obj,
        inventory: SliceInventory,
        quotas: QuotaSnapshot,
        admitted: list[Obj],
        blocked: bool,
        zone_load: Optional[dict[str, int]] = None,
    ) -> Optional[tuple[str, str]]:
        """Admit ``wl`` (returns None) or return the (reason, message)
        it stays pending with."""
        ns = obj_util.namespace_of(wl)
        accel, count = _flavor(wl)
        nodes = wlutil.nodes_of(wl)
        gpus_per_node = wlutil.gpus_per_node_of(wl)
        gpus = wlutil.gpus_of(wl)
        exclude = set(self._drained_zones)

        if blocked:
            self.m_attempts.inc({"result": "blocked"})
            return (
                "Blocked",
                "queued behind a higher-priority workload contending "
                "for the same pool",
            )

        prefer_pool = (wl.get("spec") or {}).get("preferredPool") or None

        def place():
            session_ok = quotas.fits_sessions(ns, obj_util.name_of(wl), gpus)
            quota_ok = quotas.fits(ns, gpus)
            fit = (
                inventory.fit(
                    accel,
                    count,
                    nodes,
                    gpus_per_node,
                    exclude_zones=exclude,
                    zone_load=zone_load,
                    prefer_pool=prefer_pool,
                )
                if quota_ok and session_ok
                else None
            )
            return session_ok, quota_ok, fit

        session_ok, quota_ok, fit = place()
        suspends_pending = 0
        if not session_ok or not quota_ok or fit is None:
            victims = self._plan_preemption(wl, inventory, quotas, admitted)
            if victims is not None:
                hard: list[Obj] = []
                soft: list[Obj] = []
                in_flight: list[Obj] = []
                for victim in victims:
                    if self.suspender is None:
                        hard.append(victim)
                    elif self.suspender.suspend_in_flight(victim):
                        # its snapshot is being taken NOW — killing the
                        # pods here would destroy the very state the
                        # suspend exists to save; its release is coming
                        in_flight.append(victim)
                    elif session_ok and self.suspender.is_suspendable(victim):
                        soft.append(victim)
                    else:
                        # hard kill — including when the SESSION CAP is
                        # the blocker: a suspended victim still counts
                        # as committed, only eviction (victim requeues
                        # Pending, holding no checkpoint) frees the cap
                        hard.append(victim)
                for victim in hard:
                    self._evict(
                        victim,
                        reason="Preempted",
                        message=(
                            f"preempted by higher-priority workload "
                            f"{ns}/{obj_util.name_of(wl)}"
                        ),
                        metric_reason="evict",
                    )
                    admitted.remove(victim)
                # checkpoint-then-preempt: suspendable victims keep
                # their pods until the snapshot is durable — re-charge
                # their trial release and wait for the suspend to free
                # the reservation for real
                for victim in soft + in_flight:
                    inventory.charge_workload(victim)
                    quotas.charge(obj_util.namespace_of(victim), wlutil.gpus_of(victim))
                suspends_pending += len(in_flight)
                for victim in soft:
                    if self.suspender.request_suspend(
                        victim,
                        f"preempted by higher-priority workload "
                        f"{ns}/{obj_util.name_of(wl)}; suspending "
                        "session to checkpoint",
                    ):
                        # only a request that actually landed counts as
                        # a pending release — a failed stamp must fall
                        # through to the real quota/fit verdict
                        self.m_preemptions.inc({"reason": "suspend"})
                        suspends_pending += 1
                session_ok, quota_ok, fit = place()

        # oversubscription reclaim: still starved with no hard-kill
        # plan — ask idle suspendable sessions (equal priority allowed;
        # this is the NotebookOS density move) to yield via checkpoint.
        # Skipped when the preemption plan above already has releases
        # in flight (the reclaim would recount those victims) and when
        # the session cap is the blocker (suspends don't lower it).
        if (
            session_ok
            and (not quota_ok or fit is None)
            and self.suspender is not None
            and not suspends_pending
        ):
            suspends_pending = self._plan_suspend_reclaim(wl, inventory, quotas, admitted)

        if not session_ok:
            cap = quotas.session_cap(ns)
            self.m_attempts.inc({"result": "session_cap"})
            return (
                "SessionCapExhausted",
                f"session cap reached in {ns}: running+suspended "
                f"sessions hold {quotas.committed(ns)} GPU(s), cap "
                f"{cap} (hard {quotas.cap(ns)} × oversubscription "
                f"factor {quotas.factor.get(ns, 1.0):g}); delete or "
                "resume-and-stop a session, or raise the factor",
            )
        if not quota_ok:
            if suspends_pending:
                return self._awaiting_suspend(suspends_pending)
            cap = quotas.cap(ns)
            used = quotas.used.get(ns, 0)
            self.m_attempts.inc({"result": "quota_exhausted"})
            return (
                "QuotaExhausted",
                f"quota exhausted in {ns}: requests.{GPU_RESOURCE} "
                f"used {used}, hard {cap}, need {gpus}",
            )
        if fit is None:
            if suspends_pending:
                return self._awaiting_suspend(suspends_pending)
            self.m_attempts.inc({"result": "unschedulable"})
            if not inventory.capacity_exists(accel, count, exclude_zones=exclude):
                if exclude and inventory.capacity_exists(accel, count):
                    return (
                        "ZoneDrained",
                        f"the only {accel}/{count} capacity is in "
                        f"drained zone(s) {', '.join(sorted(exclude))}; "
                        "queued until a surviving zone has capacity",
                    )
                return (
                    "NoMatchingSlice",
                    f"no node pool with accelerator {accel} and "
                    f"{count} GPUs a node in the cluster",
                )
            return (
                "SliceBusy",
                f"no {accel}/{count} node pool with {nodes} free node(s) "
                f"({gpus_per_node} GPUs each)",
            )

        pool, chosen = fit
        self._admit(wl, pool, chosen, inventory, quotas)
        return None

    def _awaiting_suspend(self, count: int) -> tuple[str, str]:
        self.m_attempts.inc({"result": "awaiting_suspend"})
        return (
            "AwaitingSuspend",
            f"waiting for {count} session(s) to suspend to checkpoint "
            "and release their GPU reservation",
        )

    # -- zone drains (checkpoint-then-migrate) --------------------------------

    def drain_zone(self, zone: str, trigger: str = "operator") -> None:
        """Mark ``zone`` drained and run a cycle: placement excludes it
        from here on, and every gang already placed there migrates —
        suspendable sessions via checkpoint-then-migrate (suspend,
        re-enqueue excluding the zone, resume in a surviving zone),
        the rest via gang eviction + requeue."""
        if zone not in self._drained_zones:
            self._drained_zones[zone] = {
                "trigger": trigger,
                "since": self.now(),
            }
            self.m_zone_drains.inc({"trigger": trigger})
        self.run_cycle()

    def undrain_zone(self, zone: str) -> None:
        """Re-admit ``zone`` to placement (operator drains only clear
        here; storm drains also expire on their own once the zone has
        live capacity and losses stop)."""
        self._drained_zones.pop(zone, None)
        self.run_cycle()

    def drained_zones(self) -> dict[str, str]:
        return {z: d["trigger"] for z, d in self._drained_zones.items()}

    def _detect_zone_storms(self, lost_zones: dict[str, int]) -> None:
        """Escalate per-node eviction into a zone drain when one cycle
        sees ``zone_storm_threshold`` or more gangs lose nodes in the
        same failure domain — that is a zone dying, not a node blip."""
        for zone, n in lost_zones.items():
            if n < self.zone_storm_threshold:
                continue
            drain = self._drained_zones.get(zone)
            if drain is None:
                self._drained_zones[zone] = {
                    "trigger": "node-storm",
                    "since": self.now(),
                }
                self.m_zone_drains.inc({"trigger": "node-storm"})
            else:
                drain["since"] = self.now()  # storm still raging

    def _expire_storm_drains(
        self, inventory: SliceInventory, lost_zones: dict[str, int]
    ) -> None:
        """A storm-triggered drain heals itself: once the zone shows
        live GPU capacity again, no gang lost a node there this cycle,
        and the cooldown since the last loss has passed, the zone
        rejoins placement. Operator drains never auto-clear."""
        for zone in list(self._drained_zones):
            drain = self._drained_zones[zone]
            if drain["trigger"] != "node-storm":
                continue
            if zone in lost_zones:
                drain["since"] = self.now()
                continue
            if (
                zone in inventory.zones()
                and self.now() - drain["since"] >= self.zone_drain_cooldown
            ):
                del self._drained_zones[zone]

    def _drain_pass(self, admitted: list[Obj], pending: list[Obj]) -> None:
        """Migrate every gang still placed in a drained zone. The
        checkpoint-then-preempt machinery runs as checkpoint-then-
        migrate: suspendable sessions snapshot first (their pods stay
        up until the checkpoint is durable, then the Workload deletes
        and :meth:`_advance_zone_migrations` re-enqueues it with the
        zone excluded); non-suspendable gangs hard-evict and requeue
        directly."""
        for wl in list(admitted):
            zone = obj_util.get_path(
                wl, "status", "assignment", "zone", default=""
            )
            if zone not in self._drained_zones:
                continue
            if self.suspender is not None and self.suspender.suspend_in_flight(wl):
                continue  # snapshot already being taken; release coming
            if self.suspender is not None and self.suspender.is_suspendable(wl):
                if self.suspender.request_suspend(
                    wl,
                    f"zone {zone} draining; suspending session to "
                    "checkpoint for migration to a surviving zone",
                    reason="zone-drain",
                ):
                    self.m_preemptions.inc({"reason": "suspend"})
                    self._zone_migrations_pending = True
                continue  # stays admitted until its checkpoint lands
            self._evict(
                wl,
                reason="ZoneDrained",
                message=(
                    f"zone {zone} draining; gang requeued for placement "
                    "in a surviving zone"
                ),
                metric_reason="zone_drain",
            )
            admitted.remove(wl)
            pending.append(wl)

    def _advance_zone_migrations(self) -> int:
        """The resume half of checkpoint-then-migrate: a zone-drain
        suspend whose checkpoint is durable clears its stop/suspend
        contract and stamps resume-requested — the notebook controller
        re-enqueues the Workload, the scan places it with the drained
        zone excluded, and the SessionManager restores the state
        digest-checked. Returns how many migrations are still in
        flight (durable-but-unresumed plus still-snapshotting)."""
        if self.suspender is None:
            return 0
        # hot-path guard: the checkpoint scan only runs while a drain
        # is active or a zone-drain suspend may still be outstanding
        # (flag starts True so a restarted scheduler scans once)
        if not self._drained_zones and not self._zone_migrations_pending:
            return 0
        from odh_kubeflow_tpu_torch.apis import (
            RESUME_REQUESTED_ANNOTATION,
            STOP_ANNOTATION,
            SUSPEND_REASON_ANNOTATION,
            SUSPENDED_AT_ANNOTATION,
        )
        from odh_kubeflow_tpu_torch.sessions import checkpoint_durable

        in_flight = 0
        try:
            checkpoints = self.api.list("SessionCheckpoint")
        except NotFound:
            return 0
        for ckpt in checkpoints:
            ns = obj_util.namespace_of(ckpt)
            name = obj_util.get_path(ckpt, "spec", "notebook", default=obj_util.name_of(ckpt))
            try:
                nb = self.api.get("Notebook", name, ns)
            except NotFound:
                continue
            ann = obj_util.annotations_of(nb)
            if ann.get(SUSPEND_REASON_ANNOTATION) != "zone-drain":
                continue
            suspended_at = ann.get(SUSPENDED_AT_ANNOTATION)
            if not suspended_at:
                continue
            in_flight += 1
            if not checkpoint_durable(ckpt, suspended_at):
                continue  # snapshot still landing; resume would lose it
            try:
                wl = self.api.get("Workload", name, ns)
                if wlutil.is_admitted(wl):
                    # the notebook controller hasn't finished the
                    # scale-down yet — clearing the stop now would
                    # cancel it and pin the gang in the drained zone
                    continue
            except NotFound:
                pass  # workload deleted: the GPUs are released
            try:
                self.api.patch(
                    "Notebook",
                    name,
                    {
                        "metadata": {
                            "annotations": {
                                STOP_ANNOTATION: None,
                                SUSPENDED_AT_ANNOTATION: None,
                                SUSPEND_REASON_ANNOTATION: None,
                                RESUME_REQUESTED_ANNOTATION: obj_util.now_rfc3339(),
                            }
                        }
                    },
                    ns,
                )
            except (Conflict, NotFound):
                continue  # next cycle retries from fresh state
            self.m_migrations.inc()
            self.recorder.normal(
                nb,
                "ZoneMigration",
                "checkpoint durable; re-enqueuing the workload for a surviving zone",
            )
        self._zone_migrations_pending = in_flight > 0
        return in_flight

    def _admit(
        self,
        wl: Obj,
        pool: str,
        nodes: list[str],
        inventory: SliceInventory,
        quotas: QuotaSnapshot,
    ) -> bool:
        ns = obj_util.namespace_of(wl)
        gpus_per_node = wlutil.gpus_per_node_of(wl)
        for node in nodes:
            inventory.charge(node, gpus_per_node)
        quotas.charge(ns, wlutil.gpus_of(wl))
        queued_at = obj_util.get_path(
            wl, "status", "queuedAt", default=""
        ) or obj_util.meta(wl).get("creationTimestamp", "")
        now = self.now()
        wait = max(now - obj_util.parse_rfc3339(queued_at), 0.0) if queued_at else 0.0
        # the recorded assignment carries the failure domain + capacity
        # class: NodeLost-storm detection and the drain pass key off
        # the zone AS ADMITTED (the node objects may be gone by then)
        assignment: Obj = {"pool": pool, "nodes": list(nodes)}
        pool_obj = inventory.pools.get(pool)
        if pool_obj is not None:
            if pool_obj.zone:
                assignment["zone"] = pool_obj.zone
            if pool_obj.spot:
                assignment["spot"] = True
        wl.setdefault("status", {})
        wl["status"].update(
            {
                "state": STATE_ADMITTED,
                "reason": "Admitted",
                "message": f"admitted to node pool {pool}",
                "assignment": assignment,
                "admittedAt": obj_util.now_rfc3339(),
                "queuedAt": queued_at,
                "position": 0,
            }
        )
        written = self._write_status(wl)
        if written:
            self.m_wait.observe(wait)
            self.m_attempts.inc({"result": "admitted"})
            self._record(
                wl,
                "Normal",
                "Admitted",
                f"workload admitted to node pool {pool} "
                f"(nodes: {', '.join(nodes)})",
            )
        return written

    # -- preemption ---------------------------------------------------------

    def _plan_preemption(
        self,
        wl: Obj,
        inventory: SliceInventory,
        quotas: QuotaSnapshot,
        admitted: list[Obj],
    ) -> Optional[list[Obj]]:
        """The minimal victim prefix whose release admits ``wl``, or
        None (in which case all trial releases are rolled back).
        Victims: strictly lower priority, contending on quota (same
        namespace) or capacity (assigned pool matches the selector);
        cheapest first — lowest priority, then suspendable (their state
        survives as a checkpoint — a hard kill loses real work) before
        hard-kill victims, then youngest admission."""
        ns = obj_util.namespace_of(wl)
        accel, count = _flavor(wl)
        my_priority = wlutil.priority_of(wl)

        def contends(victim: Obj) -> bool:
            if obj_util.namespace_of(victim) == ns and quotas.cap(ns) is not None:
                return True
            pool_name = obj_util.get_path(
                victim, "status", "assignment", "pool", default=""
            )
            pool = inventory.pools.get(pool_name)
            return pool is not None and pool.matches(accel, count)

        # cheapest victims first: lowest priority, then — at equal
        # priority — suspendable (or already-suspending) sessions ahead
        # of hard-kill victims, then the most recently admitted (loses
        # the least running work)
        def yields_via_checkpoint(v: Obj) -> bool:
            return self.suspender is not None and (
                self.suspender.suspend_in_flight(v) or self.suspender.is_suspendable(v)
            )

        candidates = sorted(
            (
                v
                for v in admitted
                if wlutil.priority_of(v) < my_priority and contends(v)
            ),
            key=lambda v: (
                wlutil.priority_of(v),
                0 if yields_via_checkpoint(v) else 1,
                -obj_util.parse_rfc3339(
                    obj_util.get_path(v, "status", "admittedAt", default="")
                ),
            ),
        )
        if not candidates:
            return None
        nodes = wlutil.nodes_of(wl)
        gpus_per_node = wlutil.gpus_per_node_of(wl)
        gpus = wlutil.gpus_of(wl)

        def release(victim: Obj) -> None:
            inventory.release_workload(victim)
            quotas.release(obj_util.namespace_of(victim), wlutil.gpus_of(victim))

        def charge(victim: Obj) -> None:
            inventory.charge_workload(victim)
            quotas.charge(obj_util.namespace_of(victim), wlutil.gpus_of(victim))

        def admits() -> bool:
            return bool(
                quotas.fits(ns, gpus)
                and quotas.fits_sessions(ns, obj_util.name_of(wl), gpus)
                and inventory.fit(
                    accel,
                    count,
                    nodes,
                    gpus_per_node,
                    exclude_zones=set(self._drained_zones),
                )
            )

        chosen: list[Obj] = []
        for victim in candidates:
            release(victim)
            chosen.append(victim)
            if admits():
                break
        else:
            # no combination admits wl — roll every trial release back
            for victim in chosen:
                charge(victim)
            return None
        # prune: a greedy victim whose release turned out not to matter
        # (e.g. it freed pool capacity when quota was the real blocker)
        # must not lose its pods — keep only victims the fit depends on
        for victim in list(chosen):
            charge(victim)
            if admits():
                chosen.remove(victim)
            else:
                release(victim)
        return chosen

    def _plan_suspend_reclaim(
        self,
        wl: Obj,
        inventory: SliceInventory,
        quotas: QuotaSnapshot,
        admitted: list[Obj],
    ) -> int:
        """Checkpoint-then-preempt for an overcommitted pool: when
        ``wl`` is starved and strict-priority preemption found nothing,
        ask IDLE suspendable sessions (equal or lower priority — the
        NotebookOS density move) to yield their GPUs via a durable
        snapshot. Nothing is evicted here: suspends are requested, the
        releases land asynchronously, and the caller reports
        ``AwaitingSuspend``. Returns the number of pending releases
        (new requests + suspends already in flight); every trial
        release is rolled back before returning."""
        ns = obj_util.namespace_of(wl)
        accel, count = _flavor(wl)
        nodes = wlutil.nodes_of(wl)
        gpus_per_node = wlutil.gpus_per_node_of(wl)
        gpus = wlutil.gpus_of(wl)
        my_priority = wlutil.priority_of(wl)

        def contends(victim: Obj) -> bool:
            if obj_util.namespace_of(victim) == ns and quotas.cap(ns) is not None:
                return True
            pool_name = obj_util.get_path(victim, "status", "assignment", "pool", default="")
            pool = inventory.pools.get(pool_name)
            return pool is not None and pool.matches(accel, count)

        def release(victim: Obj) -> None:
            inventory.release_workload(victim)
            quotas.release(obj_util.namespace_of(victim), wlutil.gpus_of(victim))

        def charge(victim: Obj) -> None:
            inventory.charge_workload(victim)
            quotas.charge(obj_util.namespace_of(victim), wlutil.gpus_of(victim))

        def admits() -> bool:
            return bool(
                quotas.fits(ns, gpus)
                and quotas.fits_sessions(ns, obj_util.name_of(wl), gpus)
                and inventory.fit(
                    accel, count, nodes, gpus_per_node,
                    exclude_zones=set(self._drained_zones),
                )
            )

        # releases already on their way (snapshots being taken now)
        in_flight = [
            v for v in admitted if contends(v) and self.suspender.suspend_in_flight(v)
        ]
        for v in in_flight:
            release(v)
        try:
            if admits():
                return len(in_flight)
            candidates = sorted(
                (
                    v
                    for v in admitted
                    if v not in in_flight
                    and wlutil.priority_of(v) <= my_priority
                    and contends(v)
                    and self.suspender.is_suspendable(v, require_idle=True)
                ),
                key=lambda v: (
                    wlutil.priority_of(v),
                    -obj_util.parse_rfc3339(
                        obj_util.get_path(v, "status", "admittedAt", default="")
                    ),
                ),
            )
            chosen: list[Obj] = []
            for victim in candidates:
                release(victim)
                chosen.append(victim)
                if admits():
                    break
            else:
                for victim in chosen:
                    charge(victim)
                return len(in_flight)
            # prune greedy extras — every suspend is real user latency
            for victim in list(chosen):
                charge(victim)
                if admits():
                    chosen.remove(victim)
                else:
                    release(victim)
            requested = 0
            for victim in chosen:
                if self.suspender.request_suspend(
                    victim,
                    f"idle session yielding its GPUs to "
                    f"{ns}/{obj_util.name_of(wl)} (pool overcommitted); "
                    "suspending to checkpoint",
                ):
                    self.m_preemptions.inc({"reason": "suspend"})
                    requested += 1
            for victim in chosen:
                charge(victim)
            # only requests that landed are pending releases
            return requested + len(in_flight)
        finally:
            for v in in_flight:
                charge(v)

    # -- eviction -----------------------------------------------------------

    def _evict(
        self, wl: Obj, reason: str, message: str, metric_reason: str
    ) -> None:
        """Gang-atomic teardown: every pod of the gang goes, the
        workload requeues Pending. GPUs release implicitly — the next
        snapshot no longer charges this workload."""
        ns = obj_util.namespace_of(wl)
        name = obj_util.name_of(wl)
        for pod in list_by_index(
            self.api,
            "Pod",
            f"label:{WORKLOAD_LABEL}",
            name,
            namespace=ns,
            fallback_selector={"matchLabels": {WORKLOAD_LABEL: name}},
        ):
            try:
                self.api.delete("Pod", obj_util.name_of(pod), ns)
            except NotFound:
                pass
        wl.setdefault("status", {})
        wl["status"].update(
            {
                "state": STATE_PENDING,
                "reason": reason,
                "message": message,
                "assignment": None,
                "admittedAt": None,
                "queuedAt": obj_util.now_rfc3339(),
            }
        )
        if self._write_status(wl):
            self.m_preemptions.inc({"reason": metric_reason})
            self._record(wl, "Warning", reason, message)
        self._attempts[(ns, name)] = self._attempts.get((ns, name), 0) + 1

    def _overcommitted_victims(
        self, admitted: list[Obj], inventory: SliceInventory
    ) -> list[Obj]:
        """Workloads to evict because a node they reserved went
        negative after real (non-gang) pod usage was charged — the
        kubelet would refuse their gang bind forever. Newest admission
        yields first: it lost the race to pods already on the node;
        fully-bound gangs physically hold their GPUs, so a collision
        can only involve a reservation whose members aren't all bound."""
        deficit = {
            node: -free
            for pool in inventory.pools.values()
            for node, free in pool.free.items()
            if free < 0
        }
        if not deficit:
            return []
        victims: list[Obj] = []
        for wl in sorted(
            admitted,
            key=lambda w: obj_util.get_path(
                w, "status", "admittedAt", default=""
            ),
            reverse=True,
        ):
            if not deficit:
                break
            overlapping = set(wlutil.assigned_nodes(wl)) & set(deficit)
            if not overlapping:
                continue
            victims.append(wl)
            gpus = wlutil.gpus_per_node_of(wl)
            for node in overlapping:
                deficit[node] -= gpus
                if deficit[node] <= 0:
                    del deficit[node]
        return victims

    def _assignment_lost(self, wl: Obj, inventory: SliceInventory) -> bool:
        nodes = wlutil.assigned_nodes(wl)
        if len(nodes) != wlutil.nodes_of(wl):
            return True  # spec changed under an old assignment
        if any(not inventory.has_node(n) for n in nodes):
            return True
        # an accelerator or node-shape edit invalidates the old placement
        pool = inventory.pools.get(
            obj_util.get_path(wl, "status", "assignment", "pool", default="")
        )
        return pool is None or not pool.matches(*_flavor(wl))

    # -- bookkeeping --------------------------------------------------------

    def _charge_foreign_pods(
        self, inventory: SliceInventory, quotas: QuotaSnapshot
    ) -> None:
        """Non-gang GPU pods charge QUOTA for their whole active life
        (ResourceQuota charges at creation — the kubelet ledger counts
        them bound or not, and admission must agree or it overshoots
        the cap) but charge INVENTORY only once bound to a node. The
        JAX scheduler walks the informer cache's GPU-count index here;
        the port has no cache yet, so it lists the pods outside any gang
        (gang pods are charged via their Workload)."""
        outside_gangs = {
            "matchExpressions": [{"key": WORKLOAD_LABEL, "operator": "DoesNotExist"}]
        }
        for pod in self.api.list("Pod", label_selector=outside_gangs):
            gpus = int(pod_gpus(pod))
            if not gpus:
                continue
            if obj_util.get_path(pod, "status", "phase") in (
                "Succeeded",
                "Failed",
            ):
                continue
            quotas.charge(obj_util.namespace_of(pod), gpus)
            node = obj_util.get_path(pod, "spec", "nodeName")
            if node:
                inventory.charge(node, gpus)

    def _write_pending(
        self, wl: Obj, reason: str, message: str, position: int
    ) -> None:
        first_time = not wlutil.state_of(wl)
        # snapshot before update: wl["status"] is the same dict the
        # update mutates, so comparing through it afterwards would
        # always see "unchanged"
        prev = dict(wl.get("status") or {})
        wl.setdefault("status", {})
        wl["status"].update(
            {
                "state": STATE_PENDING,
                "reason": reason,
                "message": message,
                "position": position,
                "queuedAt": prev.get("queuedAt") or obj_util.now_rfc3339(),
                "assignment": None,
            }
        )
        changed = self._write_status(wl)
        if first_time:
            self._record(
                wl,
                "Normal",
                "Queued",
                f"workload queued at position {position}: {message}",
            )
        if (
            reason != "Blocked"
            and (
                first_time
                or (
                    changed
                    and (
                        prev.get("reason") != reason
                        or prev.get("message") != message
                    )
                )
            )
        ):
            # the human-readable unschedulable reason — quota exhausted
            # vs no node with the shape — not a generic failure
            self._record(wl, "Warning", "FailedScheduling", message)

    def _write_status(self, wl: Obj) -> bool:
        """update_status, reporting whether anything actually changed
        (the store suppresses no-op writes — reuse its verdict via
        resourceVersion). Conflicts are fine: the next cycle rewrites
        from fresh state."""
        try:
            before = obj_util.meta(wl).get("resourceVersion")
            updated = self.api.update_status(wl)
            after = updated["metadata"]["resourceVersion"]
            obj_util.meta(wl)["resourceVersion"] = after
            return before != after
        except (Conflict, NotFound):
            return False

    def _record(
        self, wl: Obj, event_type: str, reason: str, message: str
    ) -> None:
        """Events land on the Notebook (what users describe/watch) and
        the Workload both; the recorder dedupes repeats into count
        bumps."""
        emit = (
            self.recorder.warning
            if event_type == "Warning"
            else self.recorder.normal
        )
        emit(wl, reason, message)
        try:
            notebook = self.api.get(
                "Notebook", obj_util.name_of(wl), obj_util.namespace_of(wl)
            )
        except NotFound:
            return
        emit(notebook, reason, message)

    def _gc_attempts(self, workloads: list[Obj]) -> None:
        live = {
            (obj_util.namespace_of(w), obj_util.name_of(w)) for w in workloads
        }
        for key in list(self._attempts):
            if key not in live:
                del self._attempts[key]
