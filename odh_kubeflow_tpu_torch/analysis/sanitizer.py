"""Runtime concurrency sanitizer: lock wrapping + blocking-op probes.

The control plane's thread-safety rests on conventions no test
exercises directly: locks in ``store.py``/``cache.py``/``runtime.py``
are always taken in one global order, non-reentrant locks are never
re-entered, and nothing blocking (``time.sleep``, HTTP round-trips,
``Watch.get``) runs while a store/cache lock is held (the old
``_RateLimiter`` bug was exactly that shape). This module is the
``-race``-style probe for those conventions — the Go operators the
reference builds on get this from the runtime; Python needs a harness.

Opt-in via ``GRAFT_SANITIZE=1`` (or ``enable()`` in a test):

- ``new_lock(name)`` / ``new_rlock(name)`` are the factories the
  machinery uses everywhere it used to call ``threading.Lock()`` /
  ``RLock()``. Disabled (the default), they return the raw primitive —
  zero overhead. Enabled, they return a :class:`SanitizedLock` that
  records per-thread acquisition order.
- **Lock-order inversion**: acquiring B while holding A records the
  edge A→B; a later acquisition that closes a cycle (B held, A wanted,
  with A→…→B already witnessed) is reported with both witness sites.
  Single-threaded runs detect inversions too — the order graph is
  global, so the randomized property tests double as race probes
  without needing a lucky interleaving.
- **Same-thread re-entry** on a non-reentrant lock is a guaranteed
  deadlock; it is reported AND raised as :class:`SanitizerError`
  (blocking forever would just hang the test).
- **Blocking under lock**: ``enable()`` patches ``time.sleep``, and
  the machinery's known blocking entry points (``Watch.get`` with a
  timeout, the remote client's HTTP requests) call
  :func:`note_blocking`; either reports when the calling thread holds
  any sanitized lock.

Reports accumulate in-process (``reports()``); the property tests
assert the list is empty at the end of a randomized run, and
``reset()`` clears state between probes.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Optional

__all__ = [
    "SanitizedLock",
    "SanitizerError",
    "enable",
    "disable",
    "enabled",
    "new_lock",
    "new_rlock",
    "note_blocking",
    "reports",
    "reset",
    "set_factory_hook",
]


class SanitizerError(RuntimeError):
    """A concurrency violation that cannot safely proceed (re-entering
    a non-reentrant lock would deadlock the thread for real)."""


_enabled = os.environ.get("GRAFT_SANITIZE", "") == "1"
_real_sleep = None

# global sanitizer state, guarded by one raw lock (never a sanitized
# one — the sanitizer must not recurse into itself)
_state_lock = threading.Lock()
_edges: dict[str, set[str]] = {}  # held-name → {acquired-after names}
_witness: dict[tuple[str, str], str] = {}  # edge → "file:line" first seen
_reports: list[str] = []
_reported_pairs: set[tuple[str, str]] = set()
_tls = threading.local()


def _held() -> list["SanitizedLock"]:
    """This thread's held sanitized locks (the instances, pinned so
    ids stay unique), outermost first, each listed once regardless of
    re-entry depth. ``_tls.counts`` tracks per-INSTANCE depth — two
    distinct locks sharing a factory name are different locks (no
    false re-entry), while the order graph ranks by NAME (lockdep
    semantics: every instance of a lock role shares a rank)."""
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
        _tls.counts = {}
    return h


def _held_names() -> list[str]:
    return [lock.name for lock in _held()]


def _call_site() -> str:
    """First stack frame outside this module — the acquisition site."""
    for frame in reversed(traceback.extract_stack()):
        if not frame.filename.endswith("sanitizer.py"):
            return f"{os.path.basename(frame.filename)}:{frame.lineno}"
    return "?"


def _report(message: str) -> None:
    with _state_lock:
        _reports.append(message)


def _reachable(src: str, dst: str) -> bool:
    """Whether the order graph already witnesses src→…→dst (caller
    holds ``_state_lock``)."""
    seen = {src}
    stack = [src]
    while stack:
        for nxt in _edges.get(stack.pop(), ()):
            if nxt == dst:
                return True
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


class SanitizedLock:
    """Instrumented Lock/RLock with the ``threading`` lock protocol
    (``acquire``/``release``/context manager), safe to hand to
    ``threading.Condition``. ``allow_blocking`` marks a lock whose
    critical section is DESIGNED to block (a coarse try-acquire-only
    heal mutex): it still participates in order/re-entry tracking but
    is exempt from blocking-under-lock reports."""

    def __init__(self, name: str, reentrant: bool, allow_blocking: bool = False):
        self.name = name
        self.reentrant = reentrant
        self.allow_blocking = allow_blocking
        self._raw = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        counts: dict[int, int] = _tls.counts
        me = id(self)
        if blocking and not self.reentrant and counts.get(me, 0) > 0:
            msg = (
                f"same-thread re-entry on non-reentrant lock "
                f"{self.name!r} at {_call_site()} (guaranteed deadlock)"
            )
            _report(msg)
            raise SanitizerError(msg)
        ok = self._raw.acquire(blocking, timeout)
        if not ok:
            return False
        first = counts.get(me, 0) == 0
        counts[me] = counts.get(me, 0) + 1
        if first:
            if held:
                # _call_site walks the stack (expensive); only needed
                # when an ordering edge is actually being recorded
                site = _call_site()
                with _state_lock:
                    for h in _held_names():
                        if h == self.name:
                            continue
                        edge = (h, self.name)
                        _edges.setdefault(h, set()).add(self.name)
                        _witness.setdefault(edge, site)
                        pair = (self.name, h)
                        if pair not in _reported_pairs and _reachable(
                            self.name, h
                        ):
                            _reported_pairs.add(pair)
                            _reported_pairs.add((h, self.name))
                            prior = _witness.get(pair, "?")
                            _reports.append(
                                f"lock-order inversion: {self.name!r} "
                                f"acquired while holding {h!r} at {site}, "
                                f"but {h!r} was previously acquired while "
                                f"holding {self.name!r} at {prior}"
                            )
            held.append(self)
        return True

    def release(self) -> None:
        self._raw.release()
        held = _held()
        counts: dict[int, int] = _tls.counts
        me = id(self)
        n = counts.get(me, 1) - 1
        if n <= 0:
            counts.pop(me, None)
            if self in held:
                held.remove(self)
        else:
            counts[me] = n

    def __enter__(self) -> "SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        kind = "RLock" if self.reentrant else "Lock"
        return f"<SanitizedLock {kind} {self.name!r}>"


# ---------------------------------------------------------------------------
# factories (the machinery's only lock constructors)

# installed by analysis.schedule while a deterministic scheduler is
# active: (name, reentrant) -> lock, or None to fall through. Lets the
# explorer hand out cooperative locks without the machinery importing
# anything new.
_factory_hook: Optional[callable] = None


def set_factory_hook(fn) -> None:
    global _factory_hook
    _factory_hook = fn


def new_lock(name: str, allow_blocking: bool = False):
    """A non-reentrant lock; cooperative while a schedule explorer is
    active, sanitized when the sanitizer is enabled, a raw
    ``threading.Lock`` (zero overhead) otherwise. ``allow_blocking``
    exempts the lock from blocking-under-lock reports (see
    :class:`SanitizedLock`) — reserve it for coarse try-acquire-only
    mutexes whose body blocks by design."""
    if _factory_hook is not None:
        lock = _factory_hook(name, False, allow_blocking)
        if lock is not None:
            return lock
    if _enabled:
        return SanitizedLock(name, reentrant=False, allow_blocking=allow_blocking)
    return threading.Lock()


def new_rlock(name: str, allow_blocking: bool = False):
    """A reentrant lock; cooperative under an active explorer,
    sanitized when enabled, raw otherwise."""
    if _factory_hook is not None:
        lock = _factory_hook(name, True, allow_blocking)
        if lock is not None:
            return lock
    if _enabled:
        return SanitizedLock(name, reentrant=True, allow_blocking=allow_blocking)
    return threading.RLock()


# ---------------------------------------------------------------------------
# blocking-op probes


def note_blocking(op: str) -> None:
    """Called by known blocking entry points (``Watch.get`` with a
    timeout, remote HTTP requests). Reports when the calling thread
    holds any sanitized lock — the runtime half of the static
    ``blocking-under-lock`` rule."""
    if not _enabled:
        return
    held = [
        lock.name
        for lock in _held()
        if not getattr(lock, "allow_blocking", False)
    ]
    if held:
        _report(
            f"blocking-under-lock: {op} at {_call_site()} while holding "
            + ", ".join(repr(h) for h in held)
        )


def _sleep_probe(secs: float) -> None:
    note_blocking(f"time.sleep({secs!r})")
    _real_sleep(secs)


# ---------------------------------------------------------------------------
# lifecycle


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn the sanitizer on (idempotent): future ``new_lock`` /
    ``new_rlock`` calls return instrumented locks and ``time.sleep``
    gains the held-lock probe. Already-constructed raw locks stay
    raw — enable before building the objects under test."""
    global _enabled, _real_sleep
    if _enabled and _real_sleep is not None:
        return
    _enabled = True
    if _real_sleep is None:
        _real_sleep = time.sleep
        time.sleep = _sleep_probe


def disable() -> None:
    """Turn the sanitizer off and restore ``time.sleep``. Existing
    SanitizedLock instances keep working (they no-op their raw lock
    semantics); only new constructions and probes are affected."""
    global _enabled, _real_sleep
    _enabled = False
    if _real_sleep is not None:
        time.sleep = _real_sleep
        _real_sleep = None


def reset() -> None:
    """Clear accumulated reports and the global order graph (between
    independent probes). Per-thread held state is left alone — live
    locks may legitimately be held elsewhere."""
    with _state_lock:
        _edges.clear()
        _witness.clear()
        _reports.clear()
        _reported_pairs.clear()


def reports() -> list[str]:
    """Accumulated violation reports (empty == clean run)."""
    with _state_lock:
        return list(_reports)


def order_graph() -> dict[str, dict[str, str]]:
    """The live lock-order graph: held-name → {acquired-after-name:
    first witness site}. The ``/debug/locks`` zpage renders this so an
    operator can read the process's actual lock hierarchy (and any
    reported inversions) without reproducing a deadlock first."""
    with _state_lock:
        return {
            src: {
                dst: _witness.get((src, dst), "?")
                for dst in sorted(dsts)
            }
            for src, dsts in sorted(_edges.items())
        }


if _enabled:  # GRAFT_SANITIZE=1 in the environment: arm immediately
    _enabled = False  # force enable() through its patch path
    enable()
