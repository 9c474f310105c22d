"""WarmPool: pre-admitted, pre-imaged, pre-built standby sessions (the
port's copy of the JAX package's ``warmup/pool.py``, on GPU node
pools).

A ``WarmPool`` keeps ``spec.size`` standby Notebooks per (profile
namespace, GKE accelerator, GPU count, image) template alive and ready.
The lifecycle:

    Backfilling ──(standby admitted + pod Running)──▶ Ready
        ▲                                              │ atomic claim
        │ standby died / zone kill / reclaimed         ▼
        └──────────── backfill ◀──────────────── Claimed ──▶ reaped

- **Backfill** rides the ordinary gang queue at the
  ``warm-pool-backfill`` PriorityClass (negative value): pending_order
  sorts standbys behind every real user, and the preemption planner's
  lowest-priority-first victim sort makes them the CHEAPEST victims
  under quota pressure — draining/reclaiming needs no scheduler
  special-casing.
- **Claim** (``claim_standby``) is a conditional update on the
  standby's resourceVersion: concurrent spawners racing for the last
  standby produce exactly one winner; losers fall through to the cold
  path. The controller reaps claimed leftovers after a grace window,
  and a claimed standby is never handed out again.
- **Warm restore**: the pool maintains a template kernel state in the
  session checkpoint store; a claimed notebook gets that state copied
  under its own UID plus a ``SessionCheckpoint`` in phase Suspended —
  the suspend machinery then runs in REVERSE, restoring the warmed
  state (the compile-cache manifest included) into the fresh pod.
- **Zone spread** falls out of the scheduler's zone-load-aware fit;
  the claimed user notebook carries ``PREFERRED_POOL_ANNOTATION`` so
  its gang lands on the node pool its standby just freed (pre-pulled
  image, warm node).

The template's ``topology`` (JAX's TPU topology) is its GPU count here,
``spec.count``; the compile-cache manifest lists the cache entries
built for the pool accelerator's architecture
(``utils/gpu.py`` ``arch``, the cache key's topology axis).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.apis import (
    GPU_ACCELERATOR_ANNOTATION,
    GPU_COUNT_ANNOTATION,
    GPU_RUNTIME_LABEL,
)
from odh_kubeflow_tpu_torch.controllers.runtime import Manager, Request, Result
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.events import EventRecorder
from odh_kubeflow_tpu_torch.machinery.objects import mutable
from odh_kubeflow_tpu_torch.machinery.store import (
    AlreadyExists,
    Conflict,
    NotFound,
)
from odh_kubeflow_tpu_torch.scheduling import PRIORITY_CLASS_ANNOTATION
from odh_kubeflow_tpu_torch.sessions import (
    PHASE_SUSPENDED,
    checkpoint_of,
    checkpoint_spec_of,
    new_checkpoint,
)
from odh_kubeflow_tpu_torch.utils.gpu import GPU_ACCELERATORS
from odh_kubeflow_tpu_torch.utils import prometheus
from odh_kubeflow_tpu_torch.warmup import (
    BACKFILL_PRIORITY_CLASS,
    CLAIMED_AT_ANNOTATION,
    CLAIMED_BY_ANNOTATION,
    POOL_LABEL,
    STANDBY_ANNOTATION,
    WARM_FROM_ANNOTATION,
    WARMUP_API_VERSION,
    is_claimed,
    pool_of,
)

Obj = dict[str, Any]

COMPONENT = "warm-pool-controller"


@dataclasses.dataclass
class WarmPoolConfig:
    enabled: bool = True
    backfill_priority: int = -100
    claim_grace_seconds: float = 60.0
    resync_seconds: float = 5.0

    @staticmethod
    def from_env() -> "WarmPoolConfig":
        env = os.environ
        return WarmPoolConfig(
            enabled=env.get("WARM_POOL_ENABLED", "true").lower() == "true",
            backfill_priority=int(
                env.get("WARM_POOL_BACKFILL_PRIORITY", "-100")
            ),
            claim_grace_seconds=float(
                env.get("WARM_POOL_CLAIM_GRACE_SECONDS", "60")
            ),
            resync_seconds=float(env.get("WARM_POOL_RESYNC_SECONDS", "5")),
        )


def new_warm_pool(
    name: str,
    namespace: str,
    *,
    size: int,
    accelerator: str,
    count: str,
    image: str,
    cpu: str = "1",
    memory: str = "2Gi",
) -> Obj:
    """A WarmPool CR shell: one standby template per (namespace,
    accelerator, GPU count, image)."""
    return {
        "apiVersion": WARMUP_API_VERSION,
        "kind": "WarmPool",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "size": int(size),
            "accelerator": accelerator,
            "count": str(count),
            "image": image,
            "cpu": cpu,
            "memory": memory,
        },
    }


def standbys(api: Any, namespace: str, pool: str) -> list[Obj]:
    """The pool's standby Notebooks, stable name order."""
    try:
        rows = api.list("Notebook", namespace=namespace)
    except NotFound:
        return []
    out = [nb for nb in rows if pool_of(nb) == pool]
    out.sort(key=obj_util.name_of)
    return out


def standby_ready(api: Any, notebook: Obj) -> bool:
    """A standby is handoutable once unclaimed AND its pod-0 is
    Running — admitted, imaged, and warm. (Pre-pod standbys are still
    backfilling; claiming one would hand out a cold start.)"""
    if is_claimed(notebook):
        return False
    try:
        pod = api.get(
            "Pod",
            f"{obj_util.name_of(notebook)}-0",
            obj_util.namespace_of(notebook),
        )
    except NotFound:
        return False
    return obj_util.get_path(pod, "status", "phase", default="") == "Running"


def _assignment_of(api: Any, notebook: Obj) -> tuple[str, str]:
    """(node pool, zone) the standby's gang is admitted to — the
    placement the claimed user notebook should prefer."""
    try:
        wl = api.get(
            "Workload",
            obj_util.name_of(notebook),
            obj_util.namespace_of(notebook),
        )
    except NotFound:
        return "", ""
    return (
        obj_util.get_path(wl, "status", "assignment", "pool", default="")
        or "",
        obj_util.get_path(wl, "status", "assignment", "zone", default="")
        or "",
    )


def claim_standby(
    api: Any,
    namespace: str,
    accelerator: str = "",
    count: str = "",
    image: str = "",
    claimant: str = "",
) -> Optional[Obj]:
    """Atomically claim one ready standby matching the requested
    template, or None (cold path). The claim is a conditional update on
    the standby's resourceVersion: under concurrent spawns exactly one
    caller wins each standby — a Conflict means another spawner got
    there first, and the loser moves to the next candidate. A claimed
    standby fails ``standby_ready``, so it is never handed out again.
    (JAX's store writes the claim to its write-ahead log before this
    returns; the port's store applies it in memory.)"""
    try:
        pools = api.list("WarmPool", namespace=namespace)
    except NotFound:
        return None
    for pool in sorted(pools, key=obj_util.name_of):
        spec = pool.get("spec") or {}
        if accelerator and spec.get("accelerator", "") != accelerator:
            continue
        if count and spec.get("count", "") != str(count):
            continue
        if image and spec.get("image", "") != image:
            continue
        for nb in standbys(api, namespace, obj_util.name_of(pool)):
            if not standby_ready(api, nb):
                continue
            cand = mutable(nb)
            ann = cand["metadata"].setdefault("annotations", {})
            ann[CLAIMED_BY_ANNOTATION] = claimant or "spawner"
            ann[CLAIMED_AT_ANNOTATION] = obj_util.now_rfc3339()
            try:
                api.update(cand)
            except (Conflict, NotFound):
                continue  # raced — this standby went to another spawner
            node_pool, zone = _assignment_of(api, nb)
            return {
                "pool": obj_util.name_of(pool),
                "standby": obj_util.name_of(nb),
                "nodePool": node_pool,
                "zone": zone,
                "claimedAt": ann[CLAIMED_AT_ANNOTATION],
            }
    return None


class WarmPoolController:
    """Keeps every WarmPool at ``spec.size`` ready standbys: creates
    standby Notebooks (backfill through the gang queue at backfill
    priority), reaps claimed/orphaned standbys, maintains the template
    kernel state, warm-restores claimed user notebooks, and drives the
    compile cache's GC + heal passes on its resync tick."""

    def __init__(
        self,
        api: Any,
        config: Optional[WarmPoolConfig] = None,
        registry: Optional[prometheus.Registry] = None,
        session_store: Optional[Any] = None,
        compile_cache: Optional[Any] = None,
        time_fn: Callable[[], float] = time.time,
    ):
        self.api = api
        self.config = config or WarmPoolConfig()
        self.now = time_fn
        self.session_store = session_store
        self.compile_cache = compile_cache
        self.recorder = EventRecorder(api, COMPONENT)
        reg = registry or prometheus.default_registry
        self.m_ready = reg.gauge(
            "warm_pool_ready_standbys",
            "Standbys currently claimable, per WarmPool",
            labelnames=("pool",),
        )
        self.m_claims = reg.counter(
            "warm_pool_claims_total",
            "Standbys handed out to spawning notebooks",
        )
        self.m_backfills = reg.counter(
            "warm_pool_backfills_total",
            "Standby Notebooks created to refill a pool",
        )
        self.m_reaps = reg.counter(
            "warm_pool_reaps_total",
            "Standbys deleted by the controller, by reason",
            labelnames=("reason",),
        )

    # -- wiring --------------------------------------------------------------

    def register(self, mgr: Manager) -> None:
        ctrl = mgr.new_controller("warm-pool", "WarmPool", self.reconcile)
        ctrl.watches("Notebook", self._map_notebook)

    @staticmethod
    def _map_notebook(_etype: str, nb: Obj) -> list[Request]:
        pool = pool_of(nb) or obj_util.annotations_of(nb).get(
            WARM_FROM_ANNOTATION, ""
        )
        if not pool:
            return []
        return [Request(obj_util.namespace_of(nb), pool)]

    # -- reconcile -----------------------------------------------------------

    def reconcile(self, req: Request) -> Result:
        try:
            pool = self.api.get("WarmPool", req.name, req.namespace)
        except NotFound:
            return self._gc_pool(req)

        self._ensure_priority_class()
        spec = pool.get("spec") or {}
        size = int(spec.get("size", 0) or 0)
        self._ensure_template_state(pool)
        self._restore_claimed(pool)

        rows = standbys(self.api, req.namespace, req.name)
        live: list[Obj] = []
        for nb in rows:
            if is_claimed(nb):
                self._maybe_reap(nb)
            else:
                live.append(nb)

        ready = [nb for nb in live if standby_ready(self.api, nb)]
        if len(live) < size:
            taken = {obj_util.name_of(nb) for nb in rows}
            idx = 0
            for _ in range(size - len(live)):
                while f"{req.name}-standby-{idx}" in taken:
                    idx += 1
                self._create_standby(pool, idx)
                taken.add(f"{req.name}-standby-{idx}")
        elif len(live) > size:
            for nb in live[size:]:
                self._delete_standby(nb, "scale-down")

        zones = sorted(
            {
                zone
                for nb in ready
                for _, zone in (_assignment_of(self.api, nb),)
                if zone
            }
        )
        self._update_status(
            pool,
            {
                "readyStandbys": len(ready),
                "pendingStandbys": len(live) - len(ready),
                "zones": zones,
                "lastSyncAt": obj_util.now_rfc3339(),
            },
        )
        self.m_ready.set(len(ready), {"pool": req.name})
        # the cache service's retention + replication-heal loops ride
        # this resync tick (blocking store IO — reconcile body, no
        # locks held)
        if self.compile_cache is not None:
            self.compile_cache.gc()
            self.compile_cache.heal_pass()
        return Result(requeue_after=self.config.resync_seconds)

    # -- standby lifecycle ---------------------------------------------------

    def _ensure_priority_class(self) -> None:
        self.api.create_or_get(
            {
                "apiVersion": "scheduling.k8s.io/v1",
                "kind": "PriorityClass",
                "metadata": {"name": BACKFILL_PRIORITY_CLASS},
                "value": self.config.backfill_priority,
                "description": (
                    "warm-pool standby backfill: behind every real "
                    "user in the queue, first out under pressure"
                ),
            }
        )

    def _create_standby(self, pool: Obj, idx: int) -> None:
        spec = pool.get("spec") or {}
        name = f"{obj_util.name_of(pool)}-standby-{idx}"
        ns = obj_util.namespace_of(pool)
        notebook: Obj = {
            "apiVersion": "kubeflow.org/v1beta1",
            "kind": "Notebook",
            "metadata": {
                "name": name,
                "namespace": ns,
                "labels": {
                    "app": name,
                    POOL_LABEL: obj_util.name_of(pool),
                    GPU_RUNTIME_LABEL: "enabled",
                },
                "annotations": {
                    STANDBY_ANNOTATION: "true",
                    PRIORITY_CLASS_ANNOTATION: BACKFILL_PRIORITY_CLASS,
                    GPU_ACCELERATOR_ANNOTATION: spec.get("accelerator", ""),
                    GPU_COUNT_ANNOTATION: spec.get("count", ""),
                },
            },
            "spec": {
                "template": {
                    "metadata": {"labels": {"app": name}},
                    "spec": {
                        "containers": [
                            {
                                "name": name,
                                "image": spec.get("image", ""),
                                "resources": {
                                    "requests": {
                                        "cpu": spec.get("cpu", "1"),
                                        "memory": spec.get(
                                            "memory", "2Gi"
                                        ),
                                    },
                                },
                                "volumeMounts": [],
                                "env": [],
                            }
                        ],
                        "volumes": [],
                    },
                }
            },
        }
        obj_util.set_controller_reference(notebook, pool)
        try:
            self.api.create(notebook)
        except AlreadyExists:
            return
        self.m_backfills.inc()
        self.recorder.normal(
            pool,
            "StandbyBackfill",
            f"created standby {name} (queued at "
            f"{BACKFILL_PRIORITY_CLASS})",
        )

    def _delete_standby(self, nb: Obj, reason: str) -> None:
        try:
            self.api.delete(
                "Notebook", obj_util.name_of(nb), obj_util.namespace_of(nb)
            )
        except NotFound:
            return
        self.m_reaps.inc({"reason": reason})

    def _maybe_reap(self, nb: Obj) -> None:
        """A claimed standby the claimant never deleted (spawner died
        between claim and delete): after the grace window the claim is
        abandoned — reap it so the pool backfills. It is NEVER handed
        out again either way (claimed standbys fail
        ``standby_ready``), so recovery cannot double-hand-out."""
        claimed_at = obj_util.annotations_of(nb).get(
            CLAIMED_AT_ANNOTATION, ""
        )
        age = (
            self.now() - obj_util.parse_rfc3339(claimed_at)
            if claimed_at
            else self.config.claim_grace_seconds + 1
        )
        if age >= self.config.claim_grace_seconds:
            self._delete_standby(nb, "claimed")

    def _gc_pool(self, req: Request) -> Result:
        """Pool deleted: its standbys go with it (they are pool
        furniture, not user sessions)."""
        for nb in standbys(self.api, req.namespace, req.name):
            self._delete_standby(nb, "pool-deleted")
        return Result()

    # -- template state + warm restore ---------------------------------------

    def _template_uid(self, pool: Obj) -> str:
        return (
            f"warmpool-{obj_util.namespace_of(pool)}-"
            f"{obj_util.name_of(pool)}-template"
        )

    def _ensure_template_state(self, pool: Obj) -> None:
        """The pool's template kernel state: what a claimed session
        wakes up holding — pool provenance plus the staged
        compile-cache manifest (which built kernels its accelerator's
        architecture can load instead of building)."""
        if self.session_store is None:
            return
        uid = self._template_uid(pool)
        if self.session_store.exists(uid):
            return
        spec = pool.get("spec") or {}
        known = GPU_ACCELERATORS.get(spec.get("accelerator", ""))
        arch = known.arch if known else ""
        staged: list[str] = []
        if self.compile_cache is not None:
            staged = [
                obj_util.get_path(e, "spec", "fingerprint", default="")
                for e in self.compile_cache.entries()
                if obj_util.get_path(e, "spec", "topology", default="") == arch
            ]
        state = {
            "warmpool": obj_util.name_of(pool),
            "preheated": True,
            "compileCache": {"topology": arch, "staged": sorted(f for f in staged if f)},
        }
        receipt = self.session_store.save(uid, state)
        self._update_status(
            pool, {"templateDigest": receipt.get("digest", "")}
        )

    def _restore_claimed(self, pool: Obj) -> None:
        """Run the suspend machinery in reverse for claimed notebooks:
        copy the template state under the new notebook's UID and leave
        a SessionCheckpoint in phase Suspended — the SessionManager's
        ordinary resume path then restores the warmed state into the
        fresh pod."""
        if self.session_store is None:
            return
        ns = obj_util.namespace_of(pool)
        pool_name = obj_util.name_of(pool)
        try:
            rows = self.api.list("Notebook", namespace=ns)
        except NotFound:
            return
        for nb in rows:
            ann = obj_util.annotations_of(nb)
            if ann.get(WARM_FROM_ANNOTATION, "") != pool_name:
                continue
            if checkpoint_of(self.api, nb) is not None:
                continue  # restore already staged (or session live)
            uid = obj_util.meta(nb).get("uid", "")
            if not uid:
                continue
            loaded = self.session_store.load(self._template_uid(pool))
            if loaded is None:
                continue
            state, _ = loaded
            receipt = self.session_store.save(uid, state)
            gpus, accel, per_node = checkpoint_spec_of(
                nb, accel=(pool.get("spec") or {}).get("accelerator", "")
            )
            ckpt = new_checkpoint(nb, gpus=gpus, accel=accel, accel_count=per_node)
            try:
                ckpt = self.api.create(ckpt)
            except AlreadyExists:
                continue
            ckpt = mutable(ckpt)
            ckpt["status"] = {
                "phase": PHASE_SUSPENDED,
                "suspendedAt": ann.get(CLAIMED_AT_ANNOTATION, "")
                or obj_util.now_rfc3339(),
                "checkpointStep": receipt.get("step", 0),
                "digest": receipt.get("digest", ""),
                "sizeBytes": receipt.get("sizeBytes", 0),
                "stateCaptured": True,
            }
            try:
                self.api.update_status(ckpt)
            except (Conflict, NotFound):
                continue
            self.m_claims.inc()
            self.recorder.normal(
                nb,
                "WarmHandout",
                f"warm template state staged from pool {pool_name}; "
                "resuming pre-warmed session into the fresh pod",
            )

    def _update_status(self, pool: Obj, patch: Obj) -> None:
        pool = mutable(pool)
        merged = dict(pool.get("status") or {})
        merged.update(patch)
        pool["status"] = merged
        try:
            self.api.update_status(pool)
        except (Conflict, NotFound):
            pass  # next resync rewrites from fresh state
