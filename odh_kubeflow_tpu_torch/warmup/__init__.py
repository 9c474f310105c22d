"""Warm-start subsystem: the compile cache + warm session pools (the
port's copy of the JAX package's ``warmup/__init__.py``).

A fresh notebook process pays for its cold start twice: the kernels it
launches are built by ``nvcc`` on first use, and its container starts
from nothing. This package removes both, in two cooperating halves:

- ``compilecache`` — a content-addressed store of built kernel
  libraries keyed by (the library's content fingerprint, the
  accelerator it was built for, the compiler version), exposed through
  the platform API as ``CompileCacheEntry`` objects whose bytes live on
  a zone-replicated backing store. The first process to build one
  populates it, everyone else loads; singleflight dedup collapses N
  concurrent builds of the same key into ONE.
- ``pool`` — ``WarmPool``: ``spec.size`` pre-admitted, pre-imaged,
  pre-built standby sessions per (profile, accelerator, image)
  template. The spawner hands one out on notebook create with an
  atomic claim (conditional update on the standby's resourceVersion —
  no double-handout under concurrent spawns); the controller backfills
  asynchronously through the ordinary gang queue at LOW priority
  (standbys never starve real users, and preemption treats them as the
  cheapest victims); a template ``SessionCheckpoint`` restores warmed
  kernel state into the claimed session by running the suspend
  machinery in reverse.
"""

from __future__ import annotations

from typing import Any, Optional

from odh_kubeflow_tpu_torch.machinery import objects as obj_util

Obj = dict[str, Any]

GROUP = "warmup.kubeflow.org"
WARMUP_API_VERSION = f"{GROUP}/v1alpha1"

# label on standby Notebooks: which WarmPool owns them
POOL_LABEL = f"{GROUP}/pool"
# marks a Notebook as a pool standby (not a real user session): JWA
# hides the cold-start milestones for these and the pool controller is
# their only owner
STANDBY_ANNOTATION = f"{GROUP}/standby"
# the atomic claim: stamped onto a standby via a conditional update
# (resourceVersion-checked) — exactly one spawner wins a given standby
CLAIMED_BY_ANNOTATION = f"{GROUP}/claimed-by"
CLAIMED_AT_ANNOTATION = f"{GROUP}/claimed-at"
# on the user's claimed notebook: which pool served it (the JWA "warm"
# badge) and which standby's GPUs it inherited
WARM_FROM_ANNOTATION = f"{GROUP}/warm-from"
STANDBY_SOURCE_ANNOTATION = f"{GROUP}/standby-source"
# placement hint carried Notebook → Workload → SliceInventory.fit: the
# claimed session prefers the node pool its standby just freed, so the
# pre-pulled image and warmed node are actually reused
PREFERRED_POOL_ANNOTATION = f"{GROUP}/preferred-pool"

# the PriorityClass pool backfill queues at (value from
# WARM_POOL_BACKFILL_PRIORITY, default negative): pending_order sorts
# standbys behind every real user, and _plan_preemption picks the
# lowest priority first — standbys are automatically the cheapest
# victims under quota pressure, with no scheduler special-casing
BACKFILL_PRIORITY_CLASS = "warm-pool-backfill"


def register_warmup(api: Any) -> None:
    """Register the warmup kinds on an APIServer-shaped api (embedded
    store or RemoteAPIServer)."""
    api.register_kind(
        WARMUP_API_VERSION, "CompileCacheEntry", "compilecacheentries", False
    )
    api.register_kind(WARMUP_API_VERSION, "WarmPool", "warmpools", True)


def pool_of(notebook: Obj) -> str:
    """The WarmPool a standby Notebook belongs to ("" for real
    sessions)."""
    return obj_util.labels_of(notebook).get(POOL_LABEL, "")


def is_standby(notebook: Obj) -> bool:
    return STANDBY_ANNOTATION in obj_util.annotations_of(notebook)


def is_claimed(notebook: Obj) -> bool:
    return CLAIMED_BY_ANNOTATION in obj_util.annotations_of(notebook)


def warm_source(notebook: Obj) -> Optional[dict[str, str]]:
    """The warm-handout provenance of a claimed user notebook (the JWA
    badge's data), or None for cold-spawned sessions."""
    ann = obj_util.annotations_of(notebook)
    pool = ann.get(WARM_FROM_ANNOTATION, "")
    if not pool:
        return None
    return {
        "pool": pool,
        "standby": ann.get(STANDBY_SOURCE_ANNOTATION, ""),
        "claimedAt": ann.get(CLAIMED_AT_ANNOTATION, ""),
    }
