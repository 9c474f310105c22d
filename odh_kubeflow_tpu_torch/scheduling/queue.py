"""Quota pools and GPU node-pool inventory — the scheduler's world model
(the port's copy of the JAX package's ``scheduling/queue.py``).

Two resources bound a Workload's admission:

- **GPU quota** (``QuotaSnapshot``): per-profile-namespace hard caps
  read from the same ``kf-resource-quota`` ResourceQuota objects the
  profile controller writes (``requests.nvidia.com/gpu``). Admission is
  charged at the *workload* level — an admitted gang holds its GPUs
  whether or not its pods have materialised yet, which is what makes
  the quota a reservation rather than a race.
- **node-pool inventory** (``SliceInventory``): the cluster's GPU node
  pools snapshotted from Nodes. A pool is one GKE node pool (the
  ``gke-nodepool`` label): same accelerator type, same GPUs a node. A
  gang's nodes must land in ONE pool whose accelerator and GPU-count
  labels match the workload's selector, where the JAX package matches
  a TPU slice's accelerator and topology. The classes keep the JAX
  names (``SlicePool``, ``SliceInventory``) so a reader finds the
  counterpart; a pool's ``accelerator_count`` is its GPUs a node.

Both are snapshots: the scheduler rebuilds them at the top of every
admission cycle and charges them as it admits, so a cycle is a pure
function of cluster state (same inputs → same admissions).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from odh_kubeflow_tpu_torch.apis import (
    GPU_ACCEL_NODE_LABEL,
    GPU_COUNT_NODE_LABEL,
    GPU_RESOURCE,
)
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.kubelet import SPOT_LABEL, ZONE_LABEL
from odh_kubeflow_tpu_torch.scheduling import OVERSUBSCRIPTION_FACTOR_ANNOTATION
from odh_kubeflow_tpu_torch.scheduling import workload as wlutil
from odh_kubeflow_tpu_torch.sessions import checkpoint_gpus, committed_checkpoints

Obj = dict[str, Any]

NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"
# a pool's zone (topology.kubernetes.io/zone, via machinery.kubelet)
# is its failure domain; spot/preemptible pools are reclaimable at any
# time, so placement prefers on-demand capacity when both fit
PREEMPTIBLE_LABEL = "cloud.google.com/gke-preemptible"
GPU_QUOTA_KEYS = (f"requests.{GPU_RESOURCE}", GPU_RESOURCE)


# ---------------------------------------------------------------------------
# node-pool inventory


@dataclasses.dataclass
class SlicePool:
    """One GPU node pool of identically-labelled nodes."""

    name: str
    accelerator_type: str
    # the GPUs each node of the pool holds (the node-count label's value)
    accelerator_count: str
    # failure domain (topology.kubernetes.io/zone); "" = unzoned
    zone: str = ""
    # spot/preemptible capacity — reclaimable by the cloud at any time
    spot: bool = False
    # node name → free GPUs (allocatable minus charges)
    free: dict[str, int] = dataclasses.field(default_factory=dict)

    def matches(self, accelerator_type: str, accelerator_count: str) -> bool:
        return (
            self.accelerator_type == accelerator_type
            and self.accelerator_count == accelerator_count
        )

    def fit_nodes(self, nodes: int, gpus_per_node: int) -> Optional[list[str]]:
        """``nodes`` distinct nodes with ``gpus_per_node`` free each,
        or None. Tightest nodes first (least free GPUs) so partially
        used nodes fill up before fresh ones fragment."""
        candidates = sorted(
            (free, name)
            for name, free in self.free.items()
            if free >= gpus_per_node
        )
        if len(candidates) < nodes:
            return None
        return sorted(name for _, name in candidates[:nodes])


class SliceInventory:
    def __init__(self) -> None:
        self.pools: dict[str, SlicePool] = {}
        self._node_pool: dict[str, str] = {}  # node name → pool name

    @classmethod
    def snapshot(cls, api: Any) -> "SliceInventory":
        inv = cls()
        for node in api.list("Node"):
            labels = obj_util.labels_of(node)
            accel = labels.get(GPU_ACCEL_NODE_LABEL)
            if not accel:
                continue
            capacity = int(
                obj_util.parse_quantity(
                    obj_util.get_path(
                        node, "status", "allocatable", GPU_RESOURCE, default=0
                    )
                )
            )
            if capacity <= 0:
                continue
            name = obj_util.name_of(node)
            pool_name = labels.get(NODEPOOL_LABEL, name)
            pool = inv.pools.get(pool_name)
            if pool is None:
                pool = inv.pools[pool_name] = SlicePool(
                    pool_name,
                    accel,
                    labels.get(GPU_COUNT_NODE_LABEL, ""),
                    zone=labels.get(ZONE_LABEL, ""),
                    spot=labels.get(SPOT_LABEL, "").lower() == "true"
                    # protocol-ok: legacy GKE-written node label; sim models gke-spot only
                    or labels.get(PREEMPTIBLE_LABEL, "").lower() == "true",
                )
            pool.free[name] = capacity
            inv._node_pool[name] = pool_name
        return inv

    def zone_of_pool(self, pool_name: str) -> str:
        pool = self.pools.get(pool_name)
        return pool.zone if pool is not None else ""

    def zones(self) -> set[str]:
        """Every failure domain with GPU capacity in the cluster."""
        return {p.zone for p in self.pools.values() if p.zone}

    def has_node(self, node: str) -> bool:
        return node in self._node_pool

    def charge(self, node: str, gpus: int) -> None:
        pool_name = self._node_pool.get(node)
        if pool_name is not None:
            pool = self.pools[pool_name]
            pool.free[node] = pool.free.get(node, 0) - gpus

    def release(self, node: str, gpus: int) -> None:
        self.charge(node, -gpus)

    def charge_workload(self, wl: Obj) -> None:
        gpus = wlutil.gpus_per_node_of(wl)
        for node in wlutil.assigned_nodes(wl):
            self.charge(node, gpus)

    def release_workload(self, wl: Obj) -> None:
        gpus = wlutil.gpus_per_node_of(wl)
        for node in wlutil.assigned_nodes(wl):
            self.release(node, gpus)

    def fit(
        self,
        accelerator_type: str,
        accelerator_count: str,
        nodes: int,
        gpus_per_node: int,
        exclude_zones: Optional[set[str]] = None,
        zone_load: Optional[dict[str, int]] = None,
        prefer_pool: Optional[str] = None,
    ) -> Optional[tuple[str, list[str]]]:
        """All-or-nothing fit: ``nodes`` nodes in ONE matching pool, or
        None. Pool preference order:

        1. never a pool in ``exclude_zones`` (drained/dead domains);
        2. ``prefer_pool`` when it fits — a warm-pool claim just freed
           capacity there (pre-pulled image, warm node), so the
           claimed gang should land on it even against zone spread;
        3. the least-loaded zone by ``zone_load`` (GPUs already
           committed per zone) — the zone-spread preference that keeps
           one zone loss from taking every session;
        4. on-demand before spot/preemptible capacity;
        5. best-fit (fewest total free GPUs first) so big empty pools
           stay available for big gangs."""
        best: Optional[tuple[tuple, str, list[str]]] = None
        for pool in self.pools.values():
            if not pool.matches(accelerator_type, accelerator_count):
                continue
            if exclude_zones and pool.zone in exclude_zones:
                continue
            chosen = pool.fit_nodes(nodes, gpus_per_node)
            if chosen is None:
                continue
            slack = sum(pool.free.values())
            rank = (
                0 if prefer_pool and pool.name == prefer_pool else 1,
                (zone_load or {}).get(pool.zone, 0),
                1 if pool.spot else 0,
                slack,
                pool.name,
            )
            if best is None or rank < best[0]:
                best = (rank, pool.name, chosen)
        if best is None:
            return None
        return best[1], best[2]

    def capacity_exists(
        self,
        accelerator_type: str,
        accelerator_count: str,
        exclude_zones: Optional[set[str]] = None,
    ) -> bool:
        """Whether ANY matching pool exists at all — distinguishes
        "queue behind other workloads" from "this node shape is not in
        the cluster" for the unschedulable message."""
        return any(
            p.matches(accelerator_type, accelerator_count)
            and not (exclude_zones and p.zone in exclude_zones)
            for p in self.pools.values()
        )


# ---------------------------------------------------------------------------
# quota pools


class QuotaSnapshot:
    """Per-namespace GPU caps + charged usage. The cap is the tightest
    hard value across the namespace's quotas that name a GPU key (the
    same rule the admission controller applies); namespaces with no
    GPU-capped quota are unlimited.

    **Oversubscription** (sessions/ subsystem): the quota object may
    carry ``OVERSUBSCRIPTION_FACTOR_ANNOTATION``. ``hard`` still bounds
    the GPUs ACTIVE workloads hold; ``hard × factor`` bounds the GPUs
    COMMITTED to sessions overall — active workloads plus
    suspended-to-checkpoint sessions (which hold a checkpoint, not
    GPUs). That is what lets a pool admit more sessions than physical
    inventory while suspend/resume time-shares the real GPUs."""

    def __init__(self) -> None:
        self.hard: dict[str, int] = {}
        self.used: dict[str, int] = {}
        # oversubscription factor per namespace (absent → 1.0)
        self.factor: dict[str, float] = {}
        # GPUs held by suspended/resuming sessions (SessionCheckpoints)
        self.suspended: dict[str, int] = {}
        # (namespace, workload-name) keys whose session is already
        # committed (suspended or mid-resume) — their re-admission must
        # not re-charge the session cap
        self.session_keys: set[tuple[str, str]] = set()

    @classmethod
    def snapshot(cls, api: Any) -> "QuotaSnapshot":
        snap = cls()
        for quota in api.list("ResourceQuota"):
            ns = obj_util.namespace_of(quota)
            hard = obj_util.get_path(quota, "spec", "hard", default={}) or {}
            for key in GPU_QUOTA_KEYS:
                if key in hard:
                    cap = int(obj_util.parse_quantity(hard[key]))
                    if ns not in snap.hard or cap < snap.hard[ns]:
                        snap.hard[ns] = cap
                        try:
                            snap.factor[ns] = max(
                                float(
                                    obj_util.annotations_of(quota).get(
                                        # protocol-ok: operator-set on the quota
                                        OVERSUBSCRIPTION_FACTOR_ANNOTATION,
                                        "1",
                                    )
                                ),
                                1.0,
                            )
                        except ValueError:
                            snap.factor[ns] = 1.0
                    break
        # the one committed-session definition (shared with JWA and the
        # dashboard): Suspended/Resuming checkpoints whose Workload is
        # not currently Admitted — an admitted gang's GPUs live in the
        # active charge and must not be double-booked
        for ck in committed_checkpoints(api):
            ns = obj_util.namespace_of(ck)
            snap.suspended[ns] = snap.suspended.get(ns, 0) + checkpoint_gpus(
                ck
            )
            snap.session_keys.add((ns, obj_util.name_of(ck)))
        return snap

    def cap(self, namespace: str) -> Optional[int]:
        return self.hard.get(namespace)

    def headroom(self, namespace: str) -> Optional[int]:
        cap = self.hard.get(namespace)
        if cap is None:
            return None
        return cap - self.used.get(namespace, 0)

    def fits(self, namespace: str, gpus: int) -> bool:
        head = self.headroom(namespace)
        return head is None or gpus <= head

    def charge(self, namespace: str, gpus: int) -> None:
        self.used[namespace] = self.used.get(namespace, 0) + gpus

    def release(self, namespace: str, gpus: int) -> None:
        self.charge(namespace, -gpus)

    # -- oversubscription (session cap) --------------------------------------

    def session_cap(self, namespace: str) -> Optional[int]:
        """``hard × factor`` — the committed-session ceiling, or None
        when the namespace is unlimited."""
        cap = self.hard.get(namespace)
        if cap is None:
            return None
        return int(cap * self.factor.get(namespace, 1.0))

    def committed(self, namespace: str) -> int:
        """GPUs committed to sessions: active workload charges plus
        suspended/resuming checkpoints."""
        return self.used.get(namespace, 0) + self.suspended.get(namespace, 0)

    def fits_sessions(self, namespace: str, name: str, gpus: int) -> bool:
        """Whether admitting ``gpus`` more keeps the pool inside its
        committed-session ceiling. Only pools that opted into
        oversubscription (factor > 1) are session-capped — without the
        annotation the legacy quota semantics hold unchanged (suspended
        sessions are as invisible to admission as stopped ones). A
        workload whose session is already committed (a suspended
        notebook resuming) is exempt — it is re-claiming GPUs the pool
        already granted."""
        if self.factor.get(namespace, 1.0) <= 1.0:
            return True
        cap = self.session_cap(namespace)
        if cap is None:
            return True
        if (namespace, name) in self.session_keys:
            return True
        return self.committed(namespace) + gpus <= cap


# ---------------------------------------------------------------------------
# queue ordering


def pending_order(workloads: list[Obj]) -> list[Obj]:
    """Strict admission order: priority desc, then age (creation
    timestamp asc — FIFO within a priority band), then name for a
    total, deterministic order."""
    return sorted(
        workloads,
        key=lambda w: (
            -wlutil.priority_of(w),
            obj_util.meta(w).get("creationTimestamp", ""),
            obj_util.namespace_of(w),
            obj_util.name_of(w),
        ),
    )
