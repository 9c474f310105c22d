"""Shared retry/backoff policy for every API-path client (the port's
copy of the JAX package's ``machinery/backoff.py``).

One implementation of "retry with exponential backoff + decorrelated
jitter, honour Retry-After, cap the attempts" so the remote client,
the cloud IAM clients, and the informer cache all pace their retries
the same way (client-go's ``wait.Backoff`` / ``retry.OnError``
posture).

Decorrelated jitter (the AWS architecture-blog recipe): each delay is
``uniform(base, prev * 3)`` clamped to ``cap``. Compared with plain
exponential-with-jitter it decorrelates competing retriers faster,
which is exactly what a thundering herd of controllers hitting one
recovering apiserver needs.

Both entry points take an injectable ``rng``/``sleep_fn`` so chaos
tests are deterministic and sleep-free.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Iterator, Optional, Sequence

from odh_kubeflow_tpu_torch.machinery import overload


def next_delay(
    prev: Optional[float],
    base: float = 0.05,
    cap: float = 2.0,
    rng: Any = random,
) -> float:
    """One decorrelated-jitter step: ``uniform(base, prev*3)`` capped.
    Pass the previous return value back in (None on the first retry)."""
    prev = base if prev is None else prev
    return min(cap, rng.uniform(base, max(prev * 3.0, base)))


def delays(
    attempts: int,
    base: float = 0.05,
    cap: float = 2.0,
    rng: Any = random,
) -> Iterator[float]:
    """The ``attempts - 1`` sleep intervals between ``attempts`` tries."""
    prev: Optional[float] = None
    for _ in range(max(attempts - 1, 0)):
        prev = next_delay(prev, base=base, cap=cap, rng=rng)
        yield prev


def retry(
    fn: Callable[[], Any],
    retryable: Any = (Exception,),
    attempts: int = 4,
    base: float = 0.05,
    cap: float = 2.0,
    rng: Any = random,
    # None = time.sleep, looked up at CALL time
    sleep_fn: Optional[Callable[[float], None]] = None,
    on_retry: Optional[Callable[[BaseException, int, float], None]] = None,
    budget: Optional[Any] = None,
    deadline: Optional[float] = None,
) -> Any:
    """Call ``fn`` until it succeeds, a non-retryable error escapes, or
    ``attempts`` are exhausted (the last error re-raises). Sleeps a
    decorrelated-jitter delay between tries; an exception carrying a
    ``retry_after`` attribute (the 429 contract) raises the floor of
    the next delay to it. ``on_retry(exc, attempt, delay)`` observes
    each retry (metrics/log hooks).

    ``retryable`` is an exception type, a sequence of types, or a
    predicate ``(exc) -> bool`` for policies that depend on more than
    the type (the remote client's verb × error table).

    Overload defense (machinery.overload): ``budget`` is a
    :class:`~odh_kubeflow_tpu_torch.machinery.overload.RetryBudget` — each
    retry must spend a token (a dry bucket surfaces the error instead
    of amplifying) and each success refills it. ``deadline`` is an
    absolute ``time.monotonic()`` bound; None consults the ambient
    request deadline. A sleep that would outlive the deadline is never
    taken — the last error surfaces immediately."""
    if isinstance(retryable, type):
        types: Any = (retryable,)
        should_retry: Callable[[BaseException], bool] = (
            lambda e: isinstance(e, types)
        )
    elif callable(retryable):
        should_retry = retryable
    else:
        types = tuple(retryable)
        should_retry = lambda e: isinstance(e, types)  # noqa: E731
    prev: Optional[float] = None
    for attempt in range(1, max(attempts, 1) + 1):
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001 — re-raised unless retryable
            if attempt >= attempts or not should_retry(e):
                raise
            prev = next_delay(prev, base=base, cap=cap, rng=rng)
            retry_after = getattr(e, "retry_after", None)
            if retry_after:
                prev = max(prev, float(retry_after))
            rem = (
                overload.remaining()
                if deadline is None
                else deadline - time.monotonic()
            )
            if rem is not None and prev >= rem:
                # the caller's deadline expires during (or before) the
                # sleep: the retry could never be observed — surface
                raise
            if budget is not None and not budget.try_spend():
                # fleet retry budget exhausted: retrying now is pure
                # amplification — surface the error instead
                raise
            if on_retry is not None:
                on_retry(e, attempt, prev)
            (sleep_fn or time.sleep)(prev)
        else:
            if budget is not None:
                budget.on_success()
            return result
    raise AssertionError("unreachable")  # pragma: no cover
