"""Fleet-wide overload defense: deadlines, retry budgets, breakers and
priority levels (the port's copy of the JAX package's
``machinery/overload.py``, which imports nothing of that package but
its metrics module).

Four cooperating mechanisms keep the control plane free of metastable
failure when offered load exceeds capacity:

- **End-to-end deadlines** — a request's remaining time budget rides a
  contextvar: web apps and controllers stamp it
  (``REQUEST_DEADLINE_DEFAULT``), ``client.py`` propagates the
  *remaining* seconds in ``X-Request-Deadline`` (delta form, so clock
  skew between hosts cannot corrupt it), and the serving side re-derives
  an absolute deadline against its own monotonic clock. Every stage
  sheds expired work with 504 *before* doing it — admission, worker-pool
  dequeue, the group-commit ack wait — because work a client has
  already abandoned is pure amplification.

- **Retry budgets** — a per-process token bucket (the gRPC/Envoy retry-
  throttling shape): successes refill ``RETRY_BUDGET_RATIO`` tokens,
  each retry spends one. When the bucket runs dry the caller surfaces
  the error instead of retrying, so attempts per logical request are
  bounded by construction (~``1 + ratio`` in steady state) however many
  layers stack their retry loops.

- **Circuit breakers** — a per-endpoint rolling error/latency window
  with the closed → open → half-open machine. An endpoint past
  ``BREAKER_FAILURE_THRESHOLD`` sheds calls locally for
  ``BREAKER_COOLDOWN_SECONDS`` and is then probed by exactly one trial
  request rather than hammered by every caller at once.

- **Priority levels** — APF-style classes (system > controller > user
  web > background) with cumulative concurrency ceilings
  (``APF_LEVEL_*``, percent of ``APF_INFLIGHT_LIMIT``): lower-priority
  traffic can only ever fill part of the inflight pool, so lease
  renewals and reconciles always have admission headroom — a user-load
  flood cannot starve the traffic that keeps the fleet consistent.

``store``, ``client``, ``httpapi``, ``eventloop`` and ``backoff`` all
import this module without cycles. The
:class:`~odh_kubeflow_tpu_torch.machinery.store.DeadlineExceeded` error
itself lives in ``store.py`` with the rest of the API error hierarchy.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque
from typing import Any, Optional

from odh_kubeflow_tpu_torch.utils import prometheus

# ---------------------------------------------------------------------------
# knobs


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


# default end-to-end deadline (seconds) web apps and controllers stamp
# on work that arrives without one; 0 disables stamping
DEADLINE_DEFAULT_ENV = "REQUEST_DEADLINE_DEFAULT"
# tokens refilled into the retry budget per SUCCESSFUL request; each
# retry spends 1, so steady-state amplification is bounded by 1 + ratio
BUDGET_RATIO_ENV = "RETRY_BUDGET_RATIO"

# wire header: REMAINING delta-seconds (gRPC ``grpc-timeout`` posture —
# absolute wall-clock deadlines would be corrupted by clock skew)
DEADLINE_HEADER = "X-Request-Deadline"
PRIORITY_HEADER = "X-Priority-Level"


def default_deadline_seconds() -> float:
    """``REQUEST_DEADLINE_DEFAULT`` (seconds; 0 disables stamping)."""
    return _env_float(DEADLINE_DEFAULT_ENV, 30.0)


# ---------------------------------------------------------------------------
# end-to-end deadlines (contextvar, the fencing-token propagation shape)

# the calling context's absolute deadline on THIS host's monotonic
# clock — None means the request has no time bound
_DEADLINE: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "odh_deadline", default=None
)


def current_deadline() -> Optional[float]:
    """The calling context's absolute ``time.monotonic()`` deadline,
    or None when the work is unbounded."""
    return _DEADLINE.get()


def set_deadline(deadline: Optional[float]):
    """Install an absolute monotonic deadline on the calling context;
    returns the reset token for ``ContextVar.reset``."""
    return _DEADLINE.set(deadline)


def reset_deadline(token) -> None:
    _DEADLINE.reset(token)


def remaining() -> Optional[float]:
    """Seconds left before the ambient deadline (may be <= 0), or None
    when the context carries no deadline."""
    d = _DEADLINE.get()
    return None if d is None else d - time.monotonic()


def expired() -> bool:
    """True when the ambient deadline has passed."""
    d = _DEADLINE.get()
    return d is not None and d <= time.monotonic()


def header_value() -> Optional[str]:
    """The ``X-Request-Deadline`` value for an outbound hop: remaining
    delta-seconds (clamped at 0 — the server sheds it immediately),
    or None when the context has no deadline to propagate."""
    rem = remaining()
    return None if rem is None else f"{max(rem, 0.0):.3f}"


def environ_deadline(environ: dict) -> Optional[float]:
    """Absolute monotonic deadline for an inbound WSGI request, parsed
    from its ``X-Request-Deadline`` delta-seconds header. Anchored to
    the connection's arrival stamp when the front end recorded one
    (``odh.request.arrival``, the event-loop server) so queue time
    spent before dispatch counts against the budget; arrival-less
    requests anchor at now. Raises ``ValueError`` on a malformed value
    (callers answer 400, the fencing-header posture)."""
    raw = environ.get("HTTP_" + DEADLINE_HEADER.upper().replace("-", "_"), "")
    if not raw:
        return None
    delta = float(raw)  # ValueError propagates to the caller's 400
    base = environ.get("odh.request.arrival")
    if not isinstance(base, (int, float)):
        base = time.monotonic()
    return base + delta


class deadline_scope:
    """Context manager installing a deadline ``seconds`` from entry —
    the stamp web apps put around request handling and controllers put
    around one reconcile. Never *loosens* an inherited deadline: when
    the ambient one is already tighter, it stays. ``seconds`` <= 0 (the
    knob's off position) installs nothing."""

    def __init__(self, seconds: Optional[float] = None):
        self.seconds = (
            default_deadline_seconds() if seconds is None else seconds
        )
        self._token = None

    def __enter__(self):
        if self.seconds and self.seconds > 0:
            mine = time.monotonic() + self.seconds
            ambient = _DEADLINE.get()
            if ambient is None or mine < ambient:
                self._token = _DEADLINE.set(mine)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _DEADLINE.reset(self._token)
            self._token = None


# ---------------------------------------------------------------------------
# retry budget (gRPC retry-throttling / Envoy retry-budget shape)


class RetryBudget:
    """Per-process retry token bucket: each retry spends one token,
    each success refills ``ratio`` (``RETRY_BUDGET_RATIO``). A dry
    bucket means the fleet is retrying more than ``ratio`` per
    successful request — amplification territory — so ``try_spend``
    answers False and the caller surfaces its error instead of piling
    on. The bucket starts full (``cap``) so a cold process can absorb
    a genuine transient blip before the ratio governs."""

    def __init__(
        self,
        ratio: Optional[float] = None,
        cap: float = 100.0,
        registry: Optional[prometheus.Registry] = None,
    ):
        self.ratio = (
            _env_float(BUDGET_RATIO_ENV, 0.1) if ratio is None else ratio
        )
        self.cap = cap
        self._tokens = cap
        self._lock = threading.Lock()
        reg = registry or prometheus.default_registry
        self._m_spent = reg.counter(
            "retry_budget_spent_total",
            "Retry tokens spent (each token is one retry attempt)",
        )
        self._m_exhausted = reg.counter(
            "retry_budget_exhausted_total",
            "Retries suppressed because the per-process retry budget "
            "was exhausted",
        )

    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def on_success(self) -> None:
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                spent = True
            else:
                spent = False
        if spent:
            self._m_spent.inc()
        else:
            self._m_exhausted.inc()
        return spent


_shared_budget: Optional[RetryBudget] = None
_shared_lock = threading.Lock()


def shared_budget() -> RetryBudget:
    """The process-wide budget every API-path retrier threads
    (``backoff.retry(..., budget=...)``) — ONE bucket per process so
    stacked retry layers share one amplification bound."""
    global _shared_budget
    with _shared_lock:
        if _shared_budget is None:
            _shared_budget = RetryBudget()
        return _shared_budget


def _reset_shared_budget_for_tests() -> RetryBudget:
    global _shared_budget
    with _shared_lock:
        _shared_budget = RetryBudget(registry=prometheus.Registry())
        return _shared_budget


# ---------------------------------------------------------------------------
# circuit breaker


class CircuitBreaker:
    """Per-endpoint breaker over a rolling error/latency window.

    closed → (failure ratio over the window >= ``threshold`` with at
    least ``min_requests`` samples) → open → (after ``cooldown``) →
    half-open: exactly ONE probe call is admitted; its success closes
    the breaker (window cleared), its failure re-opens the cooldown.
    A call slower than ``slow_seconds`` counts as a failure even when
    it succeeded — a drowning endpoint that still answers eventually
    ties up inflight slots just like a dead one.

    Knobs: ``BREAKER_WINDOW_SECONDS`` / ``BREAKER_FAILURE_THRESHOLD`` /
    ``BREAKER_MIN_REQUESTS`` / ``BREAKER_COOLDOWN_SECONDS`` /
    ``BREAKER_SLOW_SECONDS``. ``clock`` is injectable for tests."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(
        self,
        window: Optional[float] = None,
        threshold: Optional[float] = None,
        min_requests: Optional[int] = None,
        cooldown: Optional[float] = None,
        slow_seconds: Optional[float] = None,
        clock: Any = time.monotonic,
    ):
        self.window = (
            _env_float("BREAKER_WINDOW_SECONDS", 10.0)
            if window is None
            else window
        )
        self.threshold = (
            _env_float("BREAKER_FAILURE_THRESHOLD", 0.5)
            if threshold is None
            else threshold
        )
        self.min_requests = (
            int(_env_float("BREAKER_MIN_REQUESTS", 10))
            if min_requests is None
            else min_requests
        )
        self.cooldown = (
            _env_float("BREAKER_COOLDOWN_SECONDS", 1.0)
            if cooldown is None
            else cooldown
        )
        self.slow_seconds = (
            _env_float("BREAKER_SLOW_SECONDS", 5.0)
            if slow_seconds is None
            else slow_seconds
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._open_until = 0.0
        self._probing = False
        # rolling (timestamp, failed) samples, pruned to the window
        self._samples: deque[tuple[float, bool]] = deque()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def blocking(self) -> bool:
        """True while the breaker would reject a call RIGHT NOW —
        pure (no half-open transition), for health ranking."""
        with self._lock:
            return (
                self._state == self.OPEN
                and self._clock() < self._open_until
            ) or (self._state == self.HALF_OPEN and self._probing)

    def retry_after(self) -> float:
        """Seconds until the next probe slot — the Retry-After hint a
        shed caller gets."""
        with self._lock:
            if self._state == self.OPEN:
                return max(self._open_until - self._clock(), 0.0)
            return 0.0

    def allow(self) -> bool:
        """May a call proceed? Open sheds until the cooldown elapses,
        then admits a single half-open probe."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = self._clock()
            if self._state == self.OPEN:
                if now < self._open_until:
                    return False
                self._state = self.HALF_OPEN
                self._probing = True
                return True
            # half-open: one outstanding probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record(self, ok: bool, latency: float = 0.0) -> None:
        """Report a call outcome. ``ok=False`` or a slow success feeds
        the failure side of the window."""
        failed = (not ok) or latency >= self.slow_seconds
        with self._lock:
            now = self._clock()
            if self._state == self.HALF_OPEN:
                self._probing = False
                if failed:
                    self._state = self.OPEN
                    self._open_until = now + self.cooldown
                else:
                    self._state = self.CLOSED
                    self._samples.clear()
                return
            self._samples.append((now, failed))
            horizon = now - self.window
            while self._samples and self._samples[0][0] < horizon:
                self._samples.popleft()
            if self._state != self.CLOSED or len(self._samples) < max(
                self.min_requests, 1
            ):
                return
            failures = sum(1 for _, f in self._samples if f)
            if failures / len(self._samples) >= self.threshold:
                self._state = self.OPEN
                self._open_until = now + self.cooldown
                self._samples.clear()


# ---------------------------------------------------------------------------
# priority levels (APF-style)

LEVEL_SYSTEM = 0  # lease renew / fencing / replication / usage flush
LEVEL_CONTROLLER = 1  # reconcile traffic
LEVEL_USER = 2  # interactive web requests
LEVEL_BACKGROUND = 3  # warm-pool backfill and other deferrable work

LEVEL_NAMES = ("system", "controller", "user", "background")
_LEVEL_BY_NAME = {name: i for i, name in enumerate(LEVEL_NAMES)}

def level_ceilings(limit: int) -> tuple[int, ...]:
    """Absolute per-level inflight ceilings for a pool of ``limit``
    seats: cumulative PERCENT of the pool each level's traffic may
    fill (``APF_LEVEL_*``), so everything above a level keeps
    guaranteed admission headroom — system is 100 by definition
    (nothing outranks it). Each ceiling is at least 1 so no level can
    be configured fully off."""
    pcts = (
        _env_float("APF_LEVEL_SYSTEM", 100.0),
        _env_float("APF_LEVEL_CONTROLLER", 90.0),
        _env_float("APF_LEVEL_USER", 75.0),
        _env_float("APF_LEVEL_BACKGROUND", 50.0),
    )
    return tuple(max(1, int(limit * p / 100.0)) for p in pcts)


def classify(
    kind: Optional[str] = None,
    path: str = "",
    header: Optional[str] = None,
    controller: bool = False,
) -> int:
    """Priority level for one inbound request. An explicit
    ``X-Priority-Level`` header wins (internal callers self-declare:
    warm-pool backfill marks itself background); otherwise traffic the
    fleet's own consistency machinery generates — Lease renewals
    (fencing heartbeats) and the replication surface — is system,
    reconcile-originated calls (the tracestate marker) are controller,
    and everything else is interactive user traffic."""
    if header:
        lvl = _LEVEL_BY_NAME.get(header.strip().lower())
        if lvl is not None:
            return lvl
    if kind == "Lease" or path.startswith("/replication/"):
        return LEVEL_SYSTEM
    if controller:
        return LEVEL_CONTROLLER
    return LEVEL_USER
