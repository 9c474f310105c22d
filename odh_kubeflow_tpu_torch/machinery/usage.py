"""GPU-second metering: the fleet-wide GPU usage ledger (the port's copy
of the JAX package's ``machinery/usage.py``).

Every allocated GPU-second is attributed to a notebook/workload/
namespace/pool/zone and split into **active** vs **idle** by the same
duty-cycle signal the culler probes (the in-pod GPU activity agent,
``images/jupyter-pytorch-cuda/gpu-activity-agent``, which reads NVML's
utilization). The TPU package's names become GPU names only through
``apis.ACCELERATOR_MAPPING``: chip-seconds are GPU-seconds, a
Workload's chips its ``gpus``.

Accounting model (two independent integrals per allocation):

- **allocated GPU-seconds** — ``gpus × wall-seconds admitted``,
  integrated from the scheduler's admit→release lifecycle. The open
  side is :meth:`UsageMeter.workload_admitted` (called by the
  scheduler after the Admitted status write lands); the close side is
  :meth:`UsageMeter.workload_released` (called from the scheduler's
  evict paths — preemption, NodeLost, zone drain, assignment loss —
  and from the notebook controller when a scale-down/suspend deletes
  the Workload). Both are idempotent, so a status-write conflict that
  retries an evict cannot double-close, and :meth:`sweep` reconciles
  the open set against the store for any path that bypassed the hooks
  (split-process deployments, meter restart after failover).
- **active GPU-seconds** — ``gpus × ∫ duty_cycle/100 dt``,
  integrated from periodic duty-cycle samples
  (:meth:`observe_sample`). A sample at time *t* covers the window
  since the previous sample (**trailing attribution** — the activity
  agent reports duty over its own sampling interval), so the culler's
  probe and the meter's own sampler can share one path without double
  counting. A gap longer than ``max_sample_gap`` is a **gap in the
  record, not a zero**: the uncovered span stays unsampled (allocated
  but neither active nor idle) rather than poisoning the idle split —
  a wedged agent must not manufacture idleness.

``idle = sampled − active``; ``unsampled = allocated − sampled``.

Samples and allocation fold into **windowed aggregates** keyed by
(window start, namespace, notebook), split exactly across window
boundaries, and persist through the store as ``UsageRecord`` objects —
so the ledger rides the store's write-ahead log through a restart.
Each record carries ``status.flushedThrough``; after a restart
:meth:`recover` reloads the records and resumes integration of
still-admitted workloads from that point — nothing lost, nothing
double-counted.

Exposure: Prometheus (``gpu_allocated_seconds_total``,
``gpu_seconds_total{namespace,phase="active"|"idle"}``,
``gpu_duty_cycle_pct``, ``gpu_pool_utilization_ratio``,
``gpu_duty_samples_total``), the dashboard's ``GET /api/usage``
showback endpoint, the JWA's per-notebook usage block and the
``/debug/usage`` zpage (``machinery/zpages.py``), which
:meth:`UsageMeter.timelines` feeds. A meter whose store answers
``FencedOut`` or ``NotLeader`` (a deposed leader, ``machinery/leader.py``)
stands down: ``flush`` raises it instead of counting a failed write, and
the meter's loop stops, so the new leader's meter owns the ledger.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.apis import ACCELERATOR_MAPPING as _NAMES
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import (
    AlreadyExists,
    APIError,
    FencedOut,
    NotLeader,
)
from odh_kubeflow_tpu_torch.utils import prometheus

Obj = dict[str, Any]

# the ledger's names, each the JAX package's carried through the mapping
ALLOCATED_METRIC = _NAMES["tpu_allocated_chip_seconds_total"]
SECONDS_METRIC = _NAMES["tpu_chip_seconds_total"]
DUTY_METRIC = _NAMES["tpu_duty_cycle_pct"]
POOL_UTIL_METRIC = _NAMES["tpu_pool_utilization_ratio"]
SAMPLES_METRIC = _NAMES["tpu_duty_samples_total"]
ALLOCATED = _NAMES["allocatedChipSeconds"]
ACTIVE = _NAMES["activeChipSeconds"]
IDLE = _NAMES["idleChipSeconds"]
SAMPLED = _NAMES["sampledChipSeconds"]
UNSAMPLED = _NAMES["unsampledChipSeconds"]
HOURS = _NAMES["chipHours"]
ACTIVITY_PATH = _NAMES["/api/tpu/activity"]

USAGE_GROUP = "usage.kubeflow.org"
USAGE_API_VERSION = f"{USAGE_GROUP}/v1alpha1"

# UsageRecord label carrying the window start (integer epoch seconds)
# so retention pruning and window queries can select without parsing
# names
WINDOW_LABEL = f"{USAGE_GROUP}/window"

# per-(namespace, notebook) timeline ring: enough for ~an hour of
# 15-second samples plus lifecycle marks
TIMELINE_LIMIT = 256


def register_usage(api: Any) -> None:
    """Register the UsageRecord kind on an APIServer-shaped api
    (embedded store or RemoteAPIServer)."""
    api.register_kind(USAGE_API_VERSION, "UsageRecord", "usagerecords", True)


@dataclasses.dataclass
class UsageConfig:
    """Env-driven metering knobs (``USAGE_METERING``,
    ``USAGE_SAMPLE_SECONDS``, ``USAGE_WINDOW_SECONDS``,
    ``USAGE_RETENTION_SECONDS``)."""

    enabled: bool = True
    # duty-cycle sampling cadence of the meter's own poll loop
    sample_seconds: float = 15.0
    # aggregation window of the persisted ledger
    window_seconds: float = 300.0
    # UsageRecords older than this are pruned from the store
    retention_seconds: float = 7 * 86400.0

    @staticmethod
    def from_env() -> "UsageConfig":
        env = os.environ
        return UsageConfig(
            enabled=env.get("USAGE_METERING", "true").lower() == "true",
            sample_seconds=float(env.get("USAGE_SAMPLE_SECONDS", "15")),
            window_seconds=float(env.get("USAGE_WINDOW_SECONDS", "300")),
            retention_seconds=float(
                env.get("USAGE_RETENTION_SECONDS", str(7 * 86400))
            ),
        )

    @property
    def max_sample_gap(self) -> float:
        """A sample arriving later than this after its predecessor
        leaves the uncovered span unsampled instead of attributing it —
        the agent was wedged, not idle."""
        return 4.0 * self.sample_seconds


class _Interval:
    """One open allocation: a workload holding GPUs right now."""

    __slots__ = (
        "namespace",
        "notebook",
        "workload",
        "pool",
        "zone",
        "accelerator",
        "gpus",
        "opened_at",
        "acct_t",
        "sample_t",
        "last_duty",
    )

    def __init__(
        self,
        namespace: str,
        notebook: str,
        workload: str,
        pool: str,
        zone: str,
        accelerator: str,
        gpus: int,
        opened_at: float,
    ):
        self.namespace = namespace
        self.notebook = notebook
        self.workload = workload
        self.pool = pool
        self.zone = zone
        self.accelerator = accelerator
        self.gpus = gpus
        self.opened_at = opened_at
        # allocation integrated through here
        self.acct_t = opened_at
        # duty samples attributed through here (trailing attribution)
        self.sample_t = opened_at
        self.last_duty: Optional[float] = None


class _Bucket:
    """One windowed aggregate: (window start, namespace, notebook)."""

    __slots__ = (
        "window_start",
        "namespace",
        "notebook",
        "workload",
        "pool",
        "zone",
        "accelerator",
        "gpus",
        "allocated",
        "active",
        "sampled",
        "samples",
        "flushed_through",
        "dirty",
    )

    def __init__(self, window_start: float, iv: _Interval):
        self.window_start = window_start
        self.namespace = iv.namespace
        self.notebook = iv.notebook
        self.workload = iv.workload
        self.pool = iv.pool
        self.zone = iv.zone
        self.accelerator = iv.accelerator
        self.gpus = iv.gpus
        self.allocated = 0.0
        self.active = 0.0
        self.sampled = 0.0
        self.samples = 0
        self.flushed_through = 0.0
        self.dirty = True

    @property
    def idle(self) -> float:
        return max(self.sampled - self.active, 0.0)

    @property
    def unsampled(self) -> float:
        return max(self.allocated - self.sampled, 0.0)


class UsageMeter:
    """Integrates allocation events and duty-cycle samples into the
    windowed, store-persisted usage ledger.

    Thread-safe; every public method takes the meter lock. ``time_fn``
    and ``sample_fn`` are injectable — tests and the accounting drill
    drive a fake clock and deterministic waveforms, the platform wires
    the sim cluster's waveform (or the HTTP activity-agent probe) and
    the real clock."""

    def __init__(
        self,
        api: Any,
        config: Optional[UsageConfig] = None,
        registry: Optional[prometheus.Registry] = None,
        time_fn: Callable[[], float] = time.time,
        sample_fn: Optional[Callable[[str, str], Optional[float]]] = None,
    ):
        self.api = api
        self.config = config or UsageConfig.from_env()
        self.now = time_fn
        # sample_fn(namespace, notebook) -> duty_cycle_pct | None
        # (None == no signal: unreachable agent, pod not running)
        self.sample_fn = sample_fn or self._probe_agent
        self._lock = threading.Lock()
        # open allocations keyed by (namespace, workload name)
        self._open: dict[tuple[str, str], _Interval] = {}
        # windowed aggregates keyed by (window_start, ns, notebook)
        self._buckets: dict[tuple[float, str, str], _Bucket] = {}
        # recent samples + lifecycle marks per (ns, notebook):
        # (t, kind, value) where kind is "sample" or "mark"
        self._timelines: dict[tuple[str, str], deque] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        reg = registry or prometheus.default_registry
        self.m_allocated = reg.counter(
            ALLOCATED_METRIC,
            "GPU-seconds held by admitted workloads, by namespace",
            labelnames=("namespace",),
        )
        self.m_gpu_seconds = reg.counter(
            SECONDS_METRIC,
            "Duty-sampled GPU-seconds split into active (computing) "
            "and idle, by namespace; allocated time without a sample "
            "is in neither phase (gap, not zero)",
            labelnames=("namespace", "phase"),
        )
        self.m_duty = reg.gauge(
            DUTY_METRIC,
            "Last observed GPU duty cycle per notebook",
            labelnames=("namespace", "notebook"),
        )
        self.m_pool_util = reg.gauge(
            POOL_UTIL_METRIC,
            "active/allocated GPU-seconds per node pool over the "
            "trailing aggregation window (the admission-model signal)",
            labelnames=("pool",),
        )
        self.m_samples = reg.counter(
            SAMPLES_METRIC,
            "Duty-cycle samples folded into the usage ledger by source",
            labelnames=("source",),
        )
        self.m_flush_errors = reg.counter(
            "usage_ledger_flush_errors_total",
            "UsageRecord upserts that failed and were left dirty for "
            "the next flush",
        )

    # -- allocation lifecycle ------------------------------------------------

    def workload_admitted(self, wl: Obj, t: Optional[float] = None) -> None:
        """Open an allocation interval for an admitted Workload. Called
        by the scheduler after the Admitted status write lands; a
        second call for an already-open interval is a no-op (the sweep
        and the hook may race benignly)."""
        ns = obj_util.namespace_of(wl)
        name = obj_util.name_of(wl)
        with self._lock:
            key = (ns, name)
            if key in self._open:
                return
            t = self.now() if t is None else t
            self._open[key] = self._interval_from(wl, t)

    def workload_released(
        self,
        namespace: str,
        name: str,
        reason: str = "released",
        t: Optional[float] = None,
    ) -> None:
        """Close an allocation interval: integrate allocation through
        ``t`` and drop the open entry. Idempotent — every evict path
        (preempt, NodeLost, zone drain, scale-down delete) may fire it,
        and only the first close counts."""
        with self._lock:
            iv = self._open.pop((namespace, name), None)
            if iv is None:
                return
            t = self.now() if t is None else t
            self._fold_alloc(iv, t)
            self._mark_locked(namespace, iv.notebook, f"released:{reason}", t)

    def _interval_from(self, wl: Obj, t: float) -> _Interval:
        spec = wl.get("spec") or {}
        nodes = int(spec.get("nodes", 1) or 1)
        per_node = int(spec.get("gpusPerNode", spec.get("gpus", 0)) or 0)
        gpus = int(spec.get("gpus", nodes * per_node) or nodes * per_node)
        return _Interval(
            namespace=obj_util.namespace_of(wl),
            # one Workload per notebook, same name (workload.py derives
            # it from the notebook's StatefulSet)
            notebook=obj_util.name_of(wl),
            workload=obj_util.name_of(wl),
            pool=obj_util.get_path(
                wl, "status", "assignment", "pool", default=""
            )
            or "",
            zone=obj_util.get_path(
                wl, "status", "assignment", "zone", default=""
            )
            or "",
            accelerator=spec.get("acceleratorType", "") or "",
            gpus=max(gpus, 0),
            opened_at=t,
        )

    # -- duty-cycle sampling -------------------------------------------------

    def observe_sample(
        self,
        namespace: str,
        notebook: str,
        duty_pct: float,
        t: Optional[float] = None,
        source: str = "agent",
    ) -> None:
        """Fold one duty-cycle sample into the ledger. The sample
        covers the span since the previous sample of this interval
        (trailing attribution); spans longer than ``max_sample_gap``
        stay unsampled. Samples for notebooks with no open allocation
        only update the gauge/timeline — there are no gpus to
        attribute."""
        try:
            duty = min(max(float(duty_pct), 0.0), 100.0)
        except (TypeError, ValueError):
            return  # malformed sample: a gap, never a zero
        t = self.now() if t is None else t
        with self._lock:
            self.m_duty.set(duty, {"namespace": namespace, "notebook": notebook})
            self._timeline(namespace, notebook).append((t, "sample", duty))
            self.m_samples.inc({"source": source})
            iv = self._open_by_notebook(namespace, notebook)
            if iv is None:
                return
            if t <= iv.sample_t:
                return  # stale or duplicate: already attributed past t
            dt = t - iv.sample_t
            if dt <= self.config.max_sample_gap:
                self._fold_sample(iv, iv.sample_t, t, duty)
            iv.sample_t = t
            iv.last_duty = duty

    def mark_event(
        self,
        namespace: str,
        notebook: str,
        label: str,
        t: Optional[float] = None,
    ) -> None:
        """Annotate the notebook's timeline with a lifecycle mark
        (suspended/restored/…) so the duty-cycle timeline reads
        alongside the session state machine."""
        t = self.now() if t is None else t
        with self._lock:
            self._mark_locked(namespace, notebook, label, t)

    def _mark_locked(
        self, namespace: str, notebook: str, label: str, t: float
    ) -> None:
        self._timeline(namespace, notebook).append((t, "mark", label))

    def _timeline(self, namespace: str, notebook: str) -> deque:
        return self._timelines.setdefault(
            (namespace, notebook), deque(maxlen=TIMELINE_LIMIT)
        )

    def _open_by_notebook(
        self, namespace: str, notebook: str
    ) -> Optional[_Interval]:
        iv = self._open.get((namespace, notebook))
        if iv is not None:
            return iv
        for other in self._open.values():
            if other.namespace == namespace and other.notebook == notebook:
                return other
        return None

    def _probe_agent(self, namespace: str, notebook: str) -> Optional[float]:
        """Default sampler: the in-image GPU activity agent over HTTP
        (``apis.notebook_agent_url``) — the same endpoint the culler
        probes. Any transport/shape problem is a gap (None)."""
        import json
        import urllib.error
        import urllib.request

        from odh_kubeflow_tpu_torch.apis import notebook_agent_url

        nb = {"metadata": {"name": notebook, "namespace": namespace}}
        url = notebook_agent_url(nb) + ACTIVITY_PATH
        try:
            with urllib.request.urlopen(url, timeout=2.0) as r:
                payload = json.loads(r.read().decode())
        except (urllib.error.URLError, OSError, ValueError):
            return None
        if not isinstance(payload, dict):
            return None
        try:
            return float(payload.get("duty_cycle_pct"))
        except (TypeError, ValueError):
            return None

    # -- window folding ------------------------------------------------------

    def _bucket(self, iv: _Interval, window_start: float) -> _Bucket:
        key = (window_start, iv.namespace, iv.notebook)
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = _Bucket(window_start, iv)
        return b

    def _windows(self, a: float, b: float):
        """Yield (window_start, span_start, span_end) covering (a, b]
        split exactly at window boundaries."""
        w = self.config.window_seconds
        t = a
        while t < b:
            ws = (t // w) * w
            end = min(ws + w, b)
            yield ws, t, end
            t = end

    def _fold_alloc(self, iv: _Interval, t: float) -> None:
        """Advance the allocation integral of ``iv`` through ``t``."""
        if t <= iv.acct_t or iv.gpus <= 0:
            iv.acct_t = max(iv.acct_t, t)
            return
        for ws, s, e in self._windows(iv.acct_t, t):
            bucket = self._bucket(iv, ws)
            add = iv.gpus * (e - s)
            bucket.allocated += add
            bucket.flushed_through = max(bucket.flushed_through, e)
            bucket.dirty = True
            self.m_allocated.inc({"namespace": iv.namespace}, add)
        iv.acct_t = t

    def _fold_sample(
        self, iv: _Interval, a: float, b: float, duty: float
    ) -> None:
        """Attribute a duty sample over (a, b] into the windows."""
        if iv.gpus <= 0:
            return
        frac = duty / 100.0
        for ws, s, e in self._windows(a, b):
            bucket = self._bucket(iv, ws)
            span = iv.gpus * (e - s)
            active = span * frac
            bucket.sampled += span
            bucket.active += active
            bucket.samples += 1
            bucket.dirty = True
            self.m_gpu_seconds.inc(
                {"namespace": iv.namespace, "phase": "active"}, active
            )
            self.m_gpu_seconds.inc(
                {"namespace": iv.namespace, "phase": "idle"}, span - active
            )

    # -- store persistence ---------------------------------------------------

    def flush(self, t: Optional[float] = None) -> int:
        """Advance every open interval's allocation integral to ``t``,
        upsert dirty window buckets as UsageRecords, prune windows past
        retention, and refresh the pool-utilization gauges. Returns the
        number of records written. A failed upsert leaves its bucket
        dirty — the ledger catches up on the next flush instead of
        losing the delta."""
        t = self.now() if t is None else t
        with self._lock:
            for iv in self._open.values():
                self._fold_alloc(iv, t)
            self._prune_locked(t)
            self._set_pool_gauges_locked(t)
            dirty = [b for b in self._buckets.values() if b.dirty]
        written = 0
        for bucket in dirty:
            if self._upsert_record(bucket):
                bucket.dirty = False
                written += 1
            else:
                self.m_flush_errors.inc()
        return written

    def _record_name(self, bucket: _Bucket) -> str:
        return f"u{int(bucket.window_start)}-{bucket.notebook}"

    def _upsert_record(self, bucket: _Bucket) -> bool:
        status = {
            ALLOCATED: round(bucket.allocated, 6),
            ACTIVE: round(bucket.active, 6),
            IDLE: round(bucket.idle, 6),
            SAMPLED: round(bucket.sampled, 6),
            UNSAMPLED: round(bucket.unsampled, 6),
            "samples": bucket.samples,
            "flushedThrough": bucket.flushed_through,
        }
        obj = {
            "apiVersion": USAGE_API_VERSION,
            "kind": "UsageRecord",
            "metadata": {
                "name": self._record_name(bucket),
                "namespace": bucket.namespace,
                "labels": {WINDOW_LABEL: str(int(bucket.window_start))},
            },
            "spec": {
                "windowStart": bucket.window_start,
                "windowSeconds": self.config.window_seconds,
                "notebook": bucket.notebook,
                "workload": bucket.workload,
                "pool": bucket.pool,
                "zone": bucket.zone,
                "accelerator": bucket.accelerator,
                "gpus": bucket.gpus,
            },
            "status": status,
        }
        try:
            try:
                self.api.create(obj)
            except AlreadyExists:
                self.api.patch(
                    "UsageRecord",
                    self._record_name(bucket),
                    {"status": status},
                    bucket.namespace,
                )
            return True
        except (FencedOut, NotLeader):
            # deposed leader: the new incumbent's meter owns the ledger
            # now — stand down instead of fighting its writes
            raise
        except APIError:
            return False

    def _prune_locked(self, t: float) -> None:
        cutoff = t - self.config.retention_seconds
        stale = [
            key
            for key, b in self._buckets.items()
            if b.window_start + self.config.window_seconds < cutoff
        ]
        for key in stale:
            b = self._buckets.pop(key)
            try:
                self.api.delete(
                    "UsageRecord", self._record_name(b), b.namespace
                )
            except (FencedOut, NotLeader):
                raise  # deposed: stand down, the new leader prunes
            except APIError:
                pass  # already gone, or transient — re-pruned next flush

    def _set_pool_gauges_locked(self, t: float) -> None:
        """active/allocated per pool over the trailing two windows
        (current + previous — enough history that a fresh window
        boundary doesn't blank the signal)."""
        w = self.config.window_seconds
        floor = (t // w) * w - w
        alloc: dict[str, float] = {}
        active: dict[str, float] = {}
        for b in self._buckets.values():
            if b.window_start < floor or not b.pool:
                continue
            alloc[b.pool] = alloc.get(b.pool, 0.0) + b.allocated
            active[b.pool] = active.get(b.pool, 0.0) + b.active
        for pool, a in alloc.items():
            if a > 0:
                self.m_pool_util.set(active.get(pool, 0.0) / a, {"pool": pool})

    # -- reconciliation + recovery -------------------------------------------

    def sweep(self, t: Optional[float] = None) -> None:
        """Reconcile the open set against the store: close intervals
        whose Workload is gone or no longer Admitted (a release path
        that bypassed the hooks), open intervals for admitted Workloads
        the meter has not seen (split-process starts, post-failover
        recovery). Recovered intervals resume from the ledger's
        ``flushedThrough`` when one exists — the GPU-seconds between
        the last flush and the failover integrate on the next flush
        instead of vanishing."""
        t = self.now() if t is None else t
        try:
            workloads = self.api.list("Workload")
        except APIError:
            return
        admitted: dict[tuple[str, str], Obj] = {}
        for wl in workloads:
            if obj_util.get_path(wl, "status", "state") == "Admitted":
                admitted[
                    (obj_util.namespace_of(wl), obj_util.name_of(wl))
                ] = wl
        with self._lock:
            for key in [k for k in self._open if k not in admitted]:
                iv = self._open.pop(key)
                self._fold_alloc(iv, t)
                self._mark_locked(key[0], iv.notebook, "released:swept", t)
            for key, wl in admitted.items():
                if key in self._open:
                    continue
                opened = self._recovered_open_time(wl, t)
                iv = self._interval_from(wl, opened)
                self._open[key] = iv

    def _recovered_open_time(self, wl: Obj, t: float) -> float:
        """Where integration resumes for a workload the meter did not
        watch get admitted: the ledger's high-water flushedThrough if
        any, else the recorded admittedAt — clamped to now so a clock
        mismatch can never integrate the future."""
        ns = obj_util.namespace_of(wl)
        notebook = obj_util.name_of(wl)
        high = 0.0
        for (ws, bns, bnb), b in self._buckets.items():
            if bns == ns and bnb == notebook:
                high = max(high, b.flushed_through)
        if high <= 0.0:
            high = obj_util.parse_rfc3339(
                obj_util.get_path(wl, "status", "admittedAt", default="")
            )
        return min(max(high, 0.0), t)

    def recover(self) -> None:
        """Rebuild the in-memory ledger from persisted UsageRecords
        (post-failover or split-process start), then sweep the open set
        from the store's admitted Workloads."""
        try:
            records = self.api.list("UsageRecord")
        except APIError:
            records = []
        cutoff = self.now() - self.config.retention_seconds
        with self._lock:
            for rec in records:
                # retention fence on the window label: a long-dead
                # leader's stale windows (which the pruner never saw)
                # must not resurrect into the rebuilt ledger
                try:
                    window = float(obj_util.labels_of(rec).get(WINDOW_LABEL, ""))
                except (TypeError, ValueError):
                    window = None
                if (
                    window is not None
                    and window + self.config.window_seconds < cutoff
                ):
                    continue
                spec = rec.get("spec") or {}
                status = rec.get("status") or {}
                iv = _Interval(
                    namespace=obj_util.namespace_of(rec),
                    notebook=spec.get("notebook", "") or "",
                    workload=spec.get("workload", "") or "",
                    pool=spec.get("pool", "") or "",
                    zone=spec.get("zone", "") or "",
                    accelerator=spec.get("accelerator", "") or "",
                    gpus=int(spec.get("gpus", 0) or 0),
                    opened_at=float(spec.get("windowStart", 0.0) or 0.0),
                )
                b = _Bucket(float(spec.get("windowStart", 0.0) or 0.0), iv)
                b.allocated = float(status.get(ALLOCATED, 0.0))
                b.active = float(status.get(ACTIVE, 0.0))
                b.sampled = float(status.get(SAMPLED, 0.0))
                b.samples = int(status.get("samples", 0) or 0)
                b.flushed_through = float(status.get("flushedThrough", 0.0))
                b.dirty = False
                self._buckets[
                    (b.window_start, b.namespace, b.notebook)
                ] = b
        self.sweep()

    # -- periodic poll -------------------------------------------------------

    def poll(self, t: Optional[float] = None) -> None:
        """One metering tick: sweep the open set, sample every open
        interval's notebook through ``sample_fn``, and flush the
        ledger. The serving cadence (:meth:`start`) and the showback
        endpoint's ``?flush=1`` both land here."""
        t = self.now() if t is None else t
        self.sweep(t)
        with self._lock:
            targets = [
                (iv.namespace, iv.notebook) for iv in self._open.values()
            ]
        for ns, notebook in targets:
            duty = self.sample_fn(ns, notebook)
            if duty is not None:
                self.observe_sample(ns, notebook, duty, source="meter")
        self.flush(self.now() if t is None else None)

    def start(self, interval: Optional[float] = None) -> None:
        if self._thread is not None or not self.config.enabled:
            return
        self._stop.clear()
        period = interval or self.config.sample_seconds

        def loop():
            while not self._stop.wait(period):
                try:
                    self.poll()
                except (FencedOut, NotLeader):
                    # this process lost the leadership epoch: stop
                    # metering — the new leader's meter owns the ledger
                    self._stop.set()
                except Exception:  # noqa: BLE001 — telemetry must not die
                    self.m_flush_errors.inc()

        self._thread = threading.Thread(
            target=loop, name="usage-meter", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- read views ----------------------------------------------------------

    def _live_totals(self, t: float) -> dict[tuple[float, str, str], _Bucket]:
        """Buckets with every open interval advanced to ``t`` — a
        read-only view; the persisted ledger is untouched (the copies
        never mark dirty)."""
        view: dict[tuple[float, str, str], _Bucket] = {}
        for key, b in self._buckets.items():
            c = _Bucket(b.window_start, b)  # _Bucket reads iv-shaped attrs
            c.allocated, c.active = b.allocated, b.active
            c.sampled, c.samples = b.sampled, b.samples
            c.flushed_through = b.flushed_through
            view[key] = c
        for iv in self._open.values():
            if t <= iv.acct_t or iv.gpus <= 0:
                continue
            for ws, s, e in self._windows(iv.acct_t, t):
                key = (ws, iv.namespace, iv.notebook)
                c = view.get(key)
                if c is None:
                    c = view[key] = _Bucket(ws, iv)
                c.allocated += iv.gpus * (e - s)
        return view

    def summary(self, top_n: int = 10, t: Optional[float] = None) -> Obj:
        """The showback feed for ``GET /api/usage``: top-N namespaces
        by GPU-hours with active/idle split, plus per-zone, per-pool
        and per-accelerator utilization."""
        t = self.now() if t is None else t
        with self._lock:
            view = self._live_totals(t).values()
            by_ns: dict[str, dict[str, float]] = {}
            by_zone: dict[str, dict[str, float]] = {}
            by_pool: dict[str, dict[str, float]] = {}
            by_accel: dict[str, dict[str, float]] = {}
            for b in view:
                for keymap, key in (
                    (by_ns, b.namespace),
                    (by_zone, b.zone),
                    (by_pool, b.pool),
                    (by_accel, b.accelerator),
                ):
                    if not key:
                        continue
                    row = keymap.setdefault(
                        key, {"allocated": 0.0, "active": 0.0, "sampled": 0.0}
                    )
                    row["allocated"] += b.allocated
                    row["active"] += b.active
                    row["sampled"] += b.sampled
            open_count = len(self._open)

        def rows(keymap, label):
            out = []
            for key, r in keymap.items():
                idle = max(r["sampled"] - r["active"], 0.0)
                out.append(
                    {
                        label: key,
                        ALLOCATED: round(r["allocated"], 3),
                        ACTIVE: round(r["active"], 3),
                        IDLE: round(idle, 3),
                        UNSAMPLED: round(
                            max(r["allocated"] - r["sampled"], 0.0), 3
                        ),
                        HOURS: round(r["allocated"] / 3600.0, 4),
                        "utilization": round(
                            r["active"] / r["allocated"], 4
                        )
                        if r["allocated"] > 0
                        else None,
                    }
                )
            out.sort(key=lambda x: -x[ALLOCATED])
            return out

        return {
            "windowSeconds": self.config.window_seconds,
            "retentionSeconds": self.config.retention_seconds,
            "openAllocations": open_count,
            "namespaces": rows(by_ns, "namespace")[:top_n],
            "zones": rows(by_zone, "zone"),
            "pools": rows(by_pool, "pool"),
            "accelerators": rows(by_accel, "accelerator"),
        }

    def utilization(self, t: Optional[float] = None) -> Obj:
        """{"accelerators": {name: ratio}, "zones": {...}, "pools":
        {...}} — the dashboard occupancy panel's utilization column."""
        s = self.summary(top_n=0, t=t)
        return {
            "accelerators": {
                r["accelerator"]: r["utilization"]
                for r in s["accelerators"]
                if r["utilization"] is not None
            },
            "zones": {
                r["zone"]: r["utilization"]
                for r in s["zones"]
                if r["utilization"] is not None
            },
            "pools": {
                r["pool"]: r["utilization"]
                for r in s["pools"]
                if r["utilization"] is not None
            },
        }

    def notebook_usage(
        self, namespace: str, notebook: str, t: Optional[float] = None
    ) -> Obj:
        """The JWA detail-page usage block for one notebook."""
        t = self.now() if t is None else t
        with self._lock:
            allocated = active = sampled = 0.0
            gpus = 0
            for b in self._live_totals(t).values():
                if b.namespace != namespace or b.notebook != notebook:
                    continue
                allocated += b.allocated
                active += b.active
                sampled += b.sampled
                gpus = b.gpus or gpus
            iv = self._open_by_notebook(namespace, notebook)
            return {
                "allocated": iv is not None,
                "gpus": iv.gpus if iv is not None else gpus,
                ALLOCATED: round(allocated, 3),
                ACTIVE: round(active, 3),
                IDLE: round(max(sampled - active, 0.0), 3),
                UNSAMPLED: round(
                    max(allocated - sampled, 0.0), 3
                ),
                HOURS: round(allocated / 3600.0, 4),
                "dutyCyclePct": iv.last_duty if iv is not None else None,
                "utilization": round(active / allocated, 4)
                if allocated > 0
                else None,
            }

    def timelines(
        self, namespace: str = "", limit: int = 50
    ) -> list[Obj]:
        """Recent duty-cycle timelines (newest notebooks first): the
        feed of the JAX package's /debug/usage zpage."""
        with self._lock:
            out = []
            for (ns, nb), ring in self._timelines.items():
                if namespace and ns != namespace:
                    continue
                if not ring:
                    continue
                out.append(
                    {
                        "namespace": ns,
                        "notebook": nb,
                        "open": self._open_by_notebook(ns, nb) is not None,
                        "events": [
                            {"t": t, "kind": kind, "value": value}
                            for t, kind, value in list(ring)[-limit:]
                        ],
                    }
                )
            out.sort(
                key=lambda row: -(
                    row["events"][-1]["t"] if row["events"] else 0.0
                )
            )
            return out
