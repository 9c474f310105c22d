"""Declarative SLOs evaluated as multi-window burn rates (the port's copy
of the JAX package's ``utils/slo.py``).

Each :class:`SLO` names a good/total event pair (a latency histogram
bucket, or a bad/total counter pair), and the :class:`SLOEngine` samples
the cumulative counts on a cadence and computes **burn rates** over
several windows — the Google SRE-workbook multi-window multi-burn-rate
alerting model:

    burn_rate(W) = (bad_W / total_W) / (1 - objective)

A burn rate of 1.0 consumes exactly the error budget over the SLO
period; 14.4 over a 5-minute window is the classic fast-burn page,
~1–6 over an hour the slow-burn ticket. The engine exposes every
(slo, window) pair as the ``slo_burn_rate`` gauge and as structured
rows for the dashboard's ``/api/slo`` (``web/dashboard.py``).

Cumulative counters can't answer "in the last 5 minutes" by
themselves, so the engine keeps a bounded ring of (timestamp, good,
total) samples per SLO and differences against the sample closest to
the window's left edge. ``time_fn`` is injectable; tests drive the
clock and call :meth:`SLOEngine.tick` directly.

The specs read histograms and counters the port registers:
``notebook_spawn_ready_seconds`` (``controllers/notebook.py``),
``http_request_duration_seconds`` (``web/microweb.py``),
``controller_runtime_reconcile_total`` and its errors
(``controllers/runtime.py``), ``session_resume_seconds``
(``sessions/manager.py``). ``idle-waste`` reads the usage ledger's GPU
seconds (``GPU_SECONDS_METRIC``, which ``machinery/usage.UsageMeter``
registers on its registry); on a registry without a meter it has no
samples and evaluates to zero, as any spec whose metric is not
registered does.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Mapping, Optional

from odh_kubeflow_tpu_torch.apis import ACCELERATOR_MAPPING
from odh_kubeflow_tpu_torch.utils import prometheus

# the usage ledger's duty-sampled GPU seconds (phase="active"|"idle"), the
# counterpart of the JAX package's TPU chip-seconds counter
GPU_SECONDS_METRIC = ACCELERATOR_MAPPING["tpu_chip_seconds_total"]

# the SRE-workbook pair: a fast window that pages on budget-torching
# regressions and a slow window that catches steady leaks
DEFAULT_WINDOWS: dict[str, float] = {"5m": 300.0, "1h": 3600.0}

# conventional alerting thresholds, applied per window: short windows
# (≤ FAST_WINDOW_MAX_SECONDS) page at the fast-burn rate, long windows
# ticket at the slow-burn rate
FAST_BURN_THRESHOLD = 14.4  # 5m window: 2% of a 30d budget in 1h
SLOW_BURN_THRESHOLD = 3.0  # 1h window: 10% of a 30d budget in ~10h
FAST_WINDOW_MAX_SECONDS = 900.0


def burn_threshold(window_seconds: float) -> float:
    """The alerting threshold appropriate to a window's length."""
    return (
        FAST_BURN_THRESHOLD
        if window_seconds <= FAST_WINDOW_MAX_SECONDS
        else SLOW_BURN_THRESHOLD
    )


@dataclasses.dataclass(frozen=True)
class SLO:
    """One objective. Exactly one SLI style is set:

    - **latency**: ``histogram`` + ``threshold_s`` — good events are
      observations ≤ threshold (which must be an exact bucket
      boundary; the tier-1 lint enforces it), total is the
      observation count. ``labels`` filters series (subset match).
    - **ratio**: ``total_metric``/``bad_metric`` counters (each with
      an optional label subset) — good = total − bad.
    """

    name: str
    description: str
    objective: float  # e.g. 0.99 → error budget 0.01
    histogram: str = ""
    threshold_s: float = 0.0
    labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    total_metric: str = ""
    total_labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    bad_metric: str = ""
    bad_labels: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name}: objective must be in (0, 1), "
                f"got {self.objective}"
            )
        if bool(self.histogram) == bool(self.total_metric):
            raise ValueError(
                f"SLO {self.name}: set exactly one of histogram= "
                "(latency SLI) or total_metric=/bad_metric= (ratio SLI)"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def referenced_histograms(self) -> list[str]:
        return [self.histogram] if self.histogram else []


def default_slos() -> list[SLO]:
    """The platform's burn-rate surface. Every referenced histogram
    must exist in the platform registry with exemplars enabled and
    every ``threshold_s`` must be an exact bucket boundary
    (``tests/test_torch_slo.py`` holds the port's registries to it)."""
    return [
        SLO(
            name="spawn-ready-p99",
            description=(
                "99% of notebook spawns reach Ready within 30s "
                "(platform path on the sim kubelet; excludes image pull)"
            ),
            objective=0.99,
            histogram="notebook_spawn_ready_seconds",
            threshold_s=30.0,
        ),
        SLO(
            name="web-serial-p99",
            description="99% of web/BFF requests answer within 250ms",
            objective=0.99,
            histogram="http_request_duration_seconds",
            threshold_s=0.25,
        ),
        SLO(
            name="reconcile-errors",
            description=(
                "99.9% of reconciles across every controller succeed"
            ),
            objective=0.999,
            total_metric="controller_runtime_reconcile_total",
            bad_metric="controller_runtime_reconcile_errors_total",
        ),
        SLO(
            name="warm-resume-p95",
            description=(
                "95% of suspended-session resumes restore state "
                "within 5s of re-admission"
            ),
            objective=0.95,
            histogram="session_resume_seconds",
            threshold_s=5.0,
        ),
        SLO(
            name="idle-waste",
            description=(
                "at least 50% of duty-sampled GPU-seconds are active "
                "compute (fleet utilization — the GPU-hour economics "
                "signal from the usage ledger; unsampled allocation "
                "is excluded so a wedged agent cannot burn budget)"
            ),
            objective=0.5,
            # one counter family, subset-label semantics: total sums
            # both phases, bad selects phase="idle" (good = active)
            total_metric=GPU_SECONDS_METRIC,
            bad_metric=GPU_SECONDS_METRIC,
            bad_labels={"phase": "idle"},
        ),
    ]


class SLOEngine:
    """Samples SLI counters from a live registry and evaluates
    multi-window burn rates.

    ``tick()`` appends one (t, good, total) sample per SLO;
    ``evaluate()`` computes burn rates per window from the ring and
    sets the ``slo_burn_rate{slo,window}`` gauges. ``start()`` runs
    both on a daemon-thread cadence for serving deployments; tests
    call them directly with an injected clock."""

    def __init__(
        self,
        registry: prometheus.Registry,
        specs: Optional[list[SLO]] = None,
        windows: Optional[Mapping[str, float]] = None,
        time_fn: Callable[[], float] = time.time,
    ):
        self.registry = registry
        self.specs = list(specs) if specs is not None else default_slos()
        self.windows = dict(windows or DEFAULT_WINDOWS)
        self.now = time_fn
        self.m_burn = registry.gauge(
            "slo_burn_rate",
            "Error-budget burn rate per SLO and window "
            "(1.0 = budget consumed exactly over the SLO period)",
            labelnames=("slo", "window"),
        )
        max_window = max(self.windows.values(), default=3600.0)
        self._max_window = max_window
        self._samples: dict[str, deque] = {
            s.name: deque() for s in self.specs
        }
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- SLI counts ----------------------------------------------------------

    def _counts(self, spec: SLO) -> tuple[float, float]:
        """Current cumulative (good, total) for a spec — 0s when the
        metric isn't registered (a split-process deployment may not
        run every subsystem)."""
        if spec.histogram:
            m = self.registry.metric(spec.histogram)
            if not isinstance(m, prometheus.Histogram):
                return 0.0, 0.0
            labels = dict(spec.labels)
            return (
                m.count_le(spec.threshold_s, labels),
                m.count_matching(labels),
            )
        total_m = self.registry.metric(spec.total_metric)
        bad_m = self.registry.metric(spec.bad_metric)
        total = (
            total_m.sum_matching(dict(spec.total_labels))
            if total_m is not None
            else 0.0
        )
        bad = (
            bad_m.sum_matching(dict(spec.bad_labels))
            if bad_m is not None
            else 0.0
        )
        return max(total - bad, 0.0), total

    # -- sampling + evaluation ----------------------------------------------

    def tick(self) -> None:
        """Record one sample per SLO and trim the ring to the largest
        window (plus one sample of slack for the left-edge diff)."""
        t = self.now()
        with self._lock:
            for spec in self.specs:
                good, total = self._counts(spec)
                ring = self._samples[spec.name]
                ring.append((t, good, total))
                while len(ring) > 2 and ring[1][0] <= t - self._max_window:
                    ring.popleft()

    @staticmethod
    def _at_window_start(ring, cutoff: float):
        """The newest sample at or before ``cutoff`` (else the oldest
        — a short history evaluates over what it has)."""
        base = ring[0]
        for s in ring:
            if s[0] <= cutoff:
                base = s
            else:
                break
        return base

    def evaluate(self) -> list[dict[str, Any]]:
        """Burn-rate rows for every (slo, window), gauges updated.
        Each row: slo, window, burn_rate, bad/good/total deltas in the
        window, objective, and the window actually covered."""
        t = self.now()
        rows: list[dict[str, Any]] = []
        with self._lock:
            for spec in self.specs:
                ring = self._samples[spec.name]
                if not ring:
                    continue
                cur_t, cur_good, cur_total = ring[-1]
                for wname, wsecs in sorted(
                    self.windows.items(), key=lambda kv: kv[1]
                ):
                    base_t, base_good, base_total = self._at_window_start(
                        ring, t - wsecs
                    )
                    d_total = max(cur_total - base_total, 0.0)
                    d_good = max(cur_good - base_good, 0.0)
                    d_bad = max(d_total - d_good, 0.0)
                    bad_ratio = (d_bad / d_total) if d_total > 0 else 0.0
                    burn = bad_ratio / spec.budget
                    threshold = burn_threshold(wsecs)
                    self.m_burn.set(
                        burn, {"slo": spec.name, "window": wname}
                    )
                    rows.append(
                        {
                            "slo": spec.name,
                            "description": spec.description,
                            "objective": spec.objective,
                            "window": wname,
                            "windowSeconds": wsecs,
                            "coveredSeconds": round(
                                max(cur_t - base_t, 0.0), 3
                            ),
                            "total": d_total,
                            "bad": d_bad,
                            "badRatio": round(bad_ratio, 6),
                            "burnRate": round(burn, 4),
                            # per-window alert: short windows page at
                            # the fast-burn rate, long windows ticket
                            # at the slow-burn rate (the SRE-workbook
                            # multi-window recipe fires when BOTH do)
                            "burnThreshold": threshold,
                            # epsilon absorbs float noise in the
                            # budget (1 − objective): a true 3.0 burn
                            # must not read 2.999…96 and stay silent
                            "alerting": burn >= threshold - 1e-9,
                        }
                    )
        return rows

    # -- serving cadence -----------------------------------------------------

    def start(self, interval: float = 15.0) -> None:
        if self._thread is not None:
            return
        # a stopped engine must be restartable: stop() leaves the
        # event set, and an un-cleared flag would make this thread
        # exit on its first wait with no error anywhere
        self._stop.clear()
        self.tick()  # seed the ring so the first evaluate has a base

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.tick()
                    self.evaluate()
                except Exception:  # noqa: BLE001 — telemetry must not die
                    pass

        self._thread = threading.Thread(
            target=loop, name="slo-engine", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
