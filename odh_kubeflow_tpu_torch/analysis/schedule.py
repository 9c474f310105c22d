"""Deterministic schedule explorer (loom/shuttle for the control plane).

The sanitizer (``analysis/sanitizer.py``) reports the bad interleaving
a test run HAPPENS to execute; the races PRs 8/10 fixed — group-commit
writers vs the committer vs a snapshot cut, lease-fencing handover,
informer heal-vs-read — were each found by hand-written drills because
no run happened to execute them. This module makes the interleaving a
controlled input:

- **Serialization**: a :class:`Scheduler` runs the scenario's threads
  one-runnable-at-a-time. Participating threads hand control back at
  *schedule points*: every acquire/release of a lock built through the
  sanitizer factories (``new_lock``/``new_rlock`` route to cooperative
  :class:`SchedLock`\\ s while a scheduler is active), the explicit
  :func:`sched_point` markers in the store commit pipeline and the
  informer heal path, patched ``time.sleep``, and the cooperative
  :func:`wait_event`/:func:`queue_get` shims the store's
  ack-after-durable wait and committer drain run through.
- **Exploration**: :func:`explore` runs the scenario under many
  schedules — seeded random walks (each seed fully determines the
  interleaving) and a bounded *systematic* mode that enumerates the
  first divergent choices depth-first. A schedule fails when a thread
  raises, an invariant check fails, the scheduler detects a deadlock
  (no runnable thread while some are blocked), or a blocking op runs
  while a lock is held.
- **Replay**: a failing schedule replays exactly from its seed (or its
  recorded choice trace in systematic mode) — print the seed, hand it
  to :func:`run_schedule`, and step the identical interleaving.

Scenario shape::

    def scenario(sched):
        wal = WriteAheadLog(tmpdir)
        api = APIServer(wal=wal)            # locks are SchedLocks now
        for i in range(3):
            sched.spawn(f"writer-{i}", lambda i=i: api.create(obj(i)))
        def check():
            assert ...                       # post-quiescence invariant
        return check, api.close              # (check, cleanup)

    outcome = schedule.explore(scenario, schedules=100, seed=7)
    assert outcome.found is None, outcome.found

Threads the scenario does not spawn (the store's committer) are
*adopted*: ``thread_started`` registers them as service threads that
participate in scheduling but do not block completion; when the
scenario's threads finish, service threads fall back to their real
blocking behavior so ordinary teardown (``api.close()``) works.

Exploration is activated programmatically (``explore`` /
``run_schedule`` install the factory hook for their duration), so
production processes never pay for it — the module-level shims are a
``None`` check when no exploration is running. ``GRAFT_SCHED=<n>``
(read by the explorer suite, ``tests/test_torch_schedule.py``) multiplies the schedule
budgets for deeper sweeps.
"""

from __future__ import annotations

import dataclasses
import queue as _queue_mod
import random
import threading
import time
from typing import Any, Callable, Iterable, Optional

from odh_kubeflow_tpu_torch.analysis import sanitizer as _sanitizer

__all__ = [
    "SchedLock",
    "Scheduler",
    "ScheduleResult",
    "ExploreOutcome",
    "active",
    "explore",
    "queue_get",
    "run_schedule",
    "sched_point",
    "thread_started",
    "wait_event",
]

_active: Optional["Scheduler"] = None
_real_sleep: Optional[Callable[[float], None]] = None

_MISS = object()  # sentinel: cooperative path declined, use the real op


def active() -> Optional["Scheduler"]:
    return _active


# ---------------------------------------------------------------------------
# module-level shims (the product code's entire integration surface)


def sched_point(label: str = "") -> None:
    """A yield marker: under an active scheduler the calling
    participant hands control back and waits to be rescheduled; a
    no-op (one global read) otherwise. Place these where interleaving
    MATTERS — between prepare and apply, between heal steps — not on
    every line; lock acquire/release already yield."""
    s = _active
    if s is not None:
        s._maybe_point(label)


def wait_event(event: threading.Event, timeout: Optional[float] = None) -> bool:
    """``event.wait`` that participates in scheduling: a participant
    blocks cooperatively (other threads keep being scheduled) until
    the event is set; everyone else gets the real wait. A TIMED wait
    stays real even for participants — logical time does not advance
    under serialization, so a cooperative timed wait could never time
    out; keeping it real preserves the production code path."""
    s = _active
    if s is not None and timeout is None:
        got = s._coop_wait_pred(event.is_set, "event.wait")
        if got is not _MISS:
            return event.is_set()
    return event.wait(timeout)


def queue_get(q: "_queue_mod.Queue", timeout: Optional[float] = None):
    """Blocking ``Queue.get`` that participates in scheduling (the
    committer's drain park). Falls back to the real ``get`` for
    non-participants and after the scheduler completes."""
    s = _active
    if s is not None:
        got = s._coop_queue_get(q)
        if got is not _MISS:
            return got
    return q.get(timeout=timeout)


def thread_started(t: Optional[threading.Thread]) -> None:
    """Adopt a thread the product code just started (the WAL
    committer): under an active scheduler, blocks until the thread has
    registered at its first cooperative operation, so the set of
    schedulable threads — and therefore every seeded choice — is
    deterministic. A thread started during the scenario BUILD phase
    (before ``go()``) is recorded and joins the schedule at start,
    before the first choice is made. No-op otherwise."""
    s = _active
    if s is not None and t is not None:
        s._adopt(t)


# ---------------------------------------------------------------------------
# cooperative lock


class SchedLock:
    """Lock handed out by the sanitizer factories while a scheduler is
    active. Participants acquire it cooperatively (yielding at the
    acquire point and blocking without holding the OS thread's turn);
    non-participants fall through to the raw primitive.

    ``threading.Condition`` interop is deliberately partial: the
    ownership probe (``_is_owned``) is answered correctly and a
    non-blocking acquire of a lock the caller already holds returns
    False instead of tripping the re-entry detector — but
    ``Condition.wait`` itself parks on a raw waiter lock the scheduler
    cannot see, so a participant waiting on a Condition freezes its
    schedule (reported as a hang violation with a replayable seed, not
    a silent wrong answer). Scenarios targeting Condition-based
    components (the controller WorkQueue) need a cooperative wait shim
    first; the drilled targets use Events and queues."""

    def __init__(
        self,
        name: str,
        reentrant: bool,
        sched: "Scheduler",
        allow_blocking: bool = False,
    ):
        self.name = name
        self.reentrant = reentrant
        self.allow_blocking = allow_blocking
        self._sched = sched
        self._raw = threading.RLock() if reentrant else threading.Lock()
        # participant ownership, guarded by the scheduler's mutex
        self._owner: Optional[int] = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        s = self._sched
        if s is not _active or not s._is_registered():
            return self._raw.acquire(blocking, timeout)
        return s._lock_acquire(self, blocking)

    def release(self) -> None:
        s = self._sched
        me = threading.get_ident()
        if s is _active and self._owner == me:
            s._lock_release(self)
            return
        self._raw.release()

    def _is_owned(self) -> bool:
        """threading.Condition's ownership probe."""
        if self._owner == threading.get_ident():
            return True
        if self._raw.acquire(False):
            self._raw.release()
            return False
        return True  # the stdlib heuristic: unacquirable ≈ owned

    def __enter__(self) -> "SchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        kind = "RLock" if self.reentrant else "Lock"
        return f"<SchedLock {kind} {self.name!r}>"


# ---------------------------------------------------------------------------
# scheduler


class _Aborted(BaseException):
    """Unwinds participant threads when a schedule is abandoned
    (deadlock, hang, step budget). BaseException so scenario code's
    ``except Exception`` cannot swallow the teardown."""


class _TState:
    __slots__ = (
        "name", "ident", "gate", "ready", "waiting", "finished",
        "service", "where", "thread",
    )

    def __init__(self, name: str, service: bool):
        self.name = name
        self.ident: Optional[int] = None
        self.gate = threading.Event()
        self.ready: Optional[Callable[[], bool]] = None
        self.waiting = False
        self.finished = False
        self.service = service
        self.where = ""
        self.thread: Optional[threading.Thread] = None


class Scheduler:
    """One schedule: a seeded (or trace-forced) serialization of the
    scenario's threads. Create via :func:`run_schedule`/:func:`explore`
    rather than directly — activation patches the sanitizer lock
    factories and ``time.sleep`` for the schedule's duration."""

    def __init__(
        self,
        seed: int = 0,
        force: Optional[Iterable[int]] = None,
        default_first: bool = False,
        step_timeout: float = 20.0,
        max_steps: int = 50_000,
    ):
        self.seed = seed
        self.rng = random.Random(seed)
        self.force = list(force) if force is not None else None
        self.default_first = default_first
        self.step_timeout = step_timeout
        self.max_steps = max_steps
        self._mx = threading.Lock()
        self._cv = threading.Condition(self._mx)
        self._states: dict[int, _TState] = {}
        self._pending: list[tuple[_TState, threading.Thread]] = []
        self._threads: list[threading.Thread] = []
        # machinery threads started during the scenario BUILD phase
        # (before go()); they poll instead of blocking so they can
        # register the moment the schedule starts — go() waits for
        # every one of them before making the first choice
        self._service_expected: list[threading.Thread] = []
        self._ever_started = False
        self._held: dict[int, list[str]] = {}
        self._started = False
        self._aborted = False
        self._done = threading.Event()
        self._steps = 0
        self._choice_i = 0
        # the thread currently holding the turn (None while all are
        # parked); the watchdog uses it to detect a scheduled thread
        # that DIED without yielding (a service thread's loop exiting
        # on a crash) and hand the turn onward
        self._running: Optional[_TState] = None
        # the schedule's identity: (n_runnable, chosen_index, name) per
        # decision — two runs with equal traces ARE the same
        # interleaving
        self.choices: list[tuple[int, int, str]] = []
        self.violations: list[str] = []

    # -- scenario surface ----------------------------------------------------

    def spawn(self, name: str, fn: Callable, *args) -> None:
        """Register a scenario thread. Threads start inside ``go()``
        and run only when scheduled."""
        st = _TState(name, service=False)

        def body():
            me = threading.get_ident()
            st.ident = me
            st.thread = threading.current_thread()
            with self._cv:
                self._states[me] = st
                st.waiting = True
                self._cv.notify_all()
            self._gate_wait(st)
            try:
                fn(*args)
            except _Aborted:
                pass
            except BaseException as e:  # noqa: BLE001 — the violation IS the result
                self._violation(f"thread {name!r} raised {type(e).__name__}: {e}")
            finally:
                self._thread_finished(st)

        t = threading.Thread(target=body, name=f"sched-{name}", daemon=True)
        self._pending.append((st, t))

    def go(self, timeout: float = 60.0) -> None:
        """Run the schedule to quiescence: start the spawned threads,
        then schedule one runnable thread at a time until every
        scenario thread finished (or the schedule fails)."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        self._threads = [t for _, t in pending]
        for _, t in pending:
            t.start()

        def registered() -> bool:
            return all(
                st.ident is not None and st.ident in self._states
                for st, _ in pending
            )

        with self._cv:
            deadline = time.monotonic() + self.step_timeout
            while not registered() and not self._aborted:
                if not self._cv.wait(timeout=0.5) and (
                    time.monotonic() > deadline
                ):
                    self._violation("spawned threads never registered")
                    self._abort_locked()
                    return
            self._started = True
            self._ever_started = True
            # build-phase machinery threads (a committer born before
            # go()) must be IN the schedule before the first choice,
            # or the first batch races the serialized threads
            expected = [
                t
                for t in self._service_expected
                if t.ident is not None and t.is_alive()
            ]
            while (
                not all(t.ident in self._states for t in expected)
                and not self._aborted
            ):
                if not self._cv.wait(timeout=0.5) and (
                    time.monotonic() > deadline + self.step_timeout
                ):
                    self._violation(
                        "build-phase service threads never joined the "
                        "schedule"
                    )
                    self._abort_locked()
                    return
            self._schedule_locked()
        threading.Thread(
            target=self._watchdog, name="sched-watchdog", daemon=True
        ).start()
        if not self._done.wait(timeout):
            self._violation("schedule hung (go() timeout)")
            with self._mx:
                self._abort_locked()
        # let aborted scenario threads finish unwinding (releasing any
        # cooperative locks) before the caller runs cleanup
        for t in self._threads:
            t.join(timeout=self.step_timeout)

    # -- participation -------------------------------------------------------

    def _is_registered(self) -> bool:
        return threading.get_ident() in self._states

    def _ensure_state(self) -> Optional[_TState]:
        """The calling thread's state. A thread the scheduler has
        never seen that reaches a cooperative operation while the
        schedule is driving is machinery-spawned (the WAL committer, a
        pump): it registers as a *service* thread and PARKS here until
        scheduled — ``thread_started`` in the creator waits for
        exactly this registration, so the schedulable set is
        deterministic before the creator takes another step."""
        me = threading.get_ident()
        st = self._states.get(me)
        if st is not None:
            return None if st.finished else st
        name = f"service-{threading.current_thread().name}"
        st = _TState(name, service=True)
        st.ident = me
        st.thread = threading.current_thread()
        with self._cv:
            if self._aborted or not self._started:
                return None
            self._states[me] = st
            st.waiting = True
            self._cv.notify_all()
        self._gate_wait(st)
        return st

    def _adopt(self, t: threading.Thread) -> None:
        ident = t.ident
        if ident is None:
            return
        with self._cv:
            if not self._started and not self._ever_started:
                # build phase: the thread polls (see _coop_queue_get)
                # and registers at go(), before the first choice
                self._service_expected.append(t)
                return
            deadline = time.monotonic() + self.step_timeout
            while (
                ident not in self._states
                and self._started
                and not self._aborted
            ):
                if not self._cv.wait(timeout=0.5) and time.monotonic() > deadline:
                    self._violation(
                        f"adopted thread {t.name!r} never reached a "
                        "cooperative operation"
                    )
                    self._abort_locked()
                    return

    # -- yield machinery -----------------------------------------------------

    def _gate_wait(self, st: _TState) -> None:
        ok = st.gate.wait(timeout=self.step_timeout)
        st.gate.clear()
        if not ok:
            self._violation(f"thread {st.name!r} starved (gate timeout)")
            with self._mx:
                self._abort_locked()
        if self._aborted and not st.service:
            raise _Aborted()

    def _yield(
        self,
        ready: Optional[Callable[[], bool]],
        label: str,
    ) -> bool:
        """Park the calling participant (runnable again when ``ready``
        passes, immediately if None) and schedule the next thread.
        Returns False when the scheduler is no longer driving (caller
        falls back to real blocking behavior)."""
        me = threading.get_ident()
        with self._mx:
            st = self._states.get(me)
            if (
                st is None
                or st.finished
                or not self._started
                or self._aborted
            ):
                return False
            if self._running is st:
                self._running = None
            st.ready = ready
            st.waiting = True
            st.where = label
            self._schedule_locked()
        self._gate_wait(st)
        return True

    def _maybe_point(self, label: str) -> None:
        st = self._ensure_state()
        if st is not None:
            self._yield(None, label or "sched_point")

    def _coop_wait_pred(self, pred: Callable[[], bool], label: str):
        st = self._ensure_state()
        if st is None:
            return _MISS
        self._note_blocking(label)
        while True:
            with self._mx:
                driving = self._started and not self._aborted
            if not driving or _active is not self:
                return _MISS
            if pred():
                return True
            if not self._yield(
                lambda: pred() or not self._started, label
            ):
                return _MISS

    def _coop_queue_get(self, q: "_queue_mod.Queue"):
        while True:
            with self._mx:
                aborted = self._aborted
                started = self._started
                ever = self._ever_started
            if aborted or (ever and not started) or _active is not self:
                # schedule over OR the scheduler was deactivated before
                # ever starting (build() raised): real blocking
                # behavior — never leave a poller spinning
                return _MISS
            if not started:
                # scheduler active but not yet driving (scenario build
                # phase): serve in short real polls so the thread can
                # join the schedule the moment go() starts
                try:
                    return q.get(timeout=0.005)
                except _queue_mod.Empty:
                    continue
            st = self._ensure_state()  # registers + parks adoptees
            if st is None:
                return _MISS
            try:
                return q.get_nowait()
            except _queue_mod.Empty:
                pass
            if not self._yield(
                lambda: not q.empty() or not self._started, "queue.get"
            ):
                return _MISS

    # -- locks ---------------------------------------------------------------

    def _lock_acquire(self, lock: SchedLock, blocking: bool) -> bool:
        me = threading.get_ident()
        st = self._states.get(me)
        if st is None or st.finished:
            return lock._raw.acquire(blocking)
        with self._mx:
            if lock._owner == me:
                if lock.reentrant:
                    lock._depth += 1
                    return True
                if not blocking:
                    # a try-acquire of one's own lock is a probe
                    # (Condition._is_owned), not an imminent deadlock
                    return False
                self._violation(
                    f"same-thread re-entry on non-reentrant lock "
                    f"{lock.name!r} in {st.name!r} (guaranteed deadlock)"
                )
                self._abort_locked()
                raise _Aborted()
        # the acquire attempt is itself a schedule point: whether a
        # contender gets in first is exactly what exploration varies
        self._yield(None, f"acquire:{lock.name}")
        while True:
            with self._mx:
                if lock._owner is None and lock._raw.acquire(blocking=False):
                    lock._owner = me
                    lock._depth = 1
                    if not lock.allow_blocking:
                        # allow_blocking locks are exempt from the
                        # blocking-under-lock check (_held feeds only it)
                        self._held.setdefault(me, []).append(lock.name)
                    return True
                if not blocking:
                    return False
            def _acquirable() -> bool:
                # probe the RAW lock too: a non-participant holder
                # (a free-running pump that never reached a shim)
                # leaves _owner None while _raw is held — waking on
                # _owner alone would busy-spin the scheduler and make
                # the choice trace OS-timing-dependent
                if lock._owner is not None:
                    return False
                if lock._raw.acquire(False):
                    lock._raw.release()
                    return True
                return False

            if not self._yield(
                lambda: _acquirable() or not self._started,
                f"blocked:{lock.name}",
            ):
                return lock._raw.acquire(blocking)

    def _lock_release(self, lock: SchedLock) -> None:
        me = threading.get_ident()
        with self._mx:
            lock._depth -= 1
            if lock._depth > 0:
                return
            lock._owner = None
            held = self._held.get(me)
            if held and lock.name in held:
                held.remove(lock.name)
        lock._raw.release()
        # release is a schedule point too: a waiter may run next
        self._yield(None, f"release:{lock.name}")

    def _note_blocking(self, op: str) -> None:
        """Blocking op about to run on a participant: a violation when
        any cooperative lock is held (the _RateLimiter bug shape)."""
        held = self._held.get(threading.get_ident())
        if held:
            self._violation(
                f"blocking-under-lock: {op} while holding "
                + ", ".join(repr(h) for h in held)
            )

    # -- scheduling core -----------------------------------------------------

    def _violation(self, msg: str) -> None:
        # lock-free on purpose: violations are recorded from inside
        # _mx-holding paths (deadlock detection, adoption timeouts) —
        # list.append is atomic under the GIL
        self.violations.append(msg)

    def _abort_locked(self) -> None:
        if self._aborted:
            return
        self._aborted = True
        self._started = False
        for st in self._states.values():
            st.gate.set()
        self._done.set()

    def _thread_finished(self, st: _TState) -> None:
        with self._mx:
            st.finished = True
            st.waiting = False
            if self._running is st:
                self._running = None
            if all(
                s.finished for s in self._states.values() if not s.service
            ) and not self._pending:
                self._complete_locked()
            else:
                self._schedule_locked()

    def _complete_locked(self) -> None:
        self._started = False
        for st in self._states.values():
            if st.service and st.waiting:
                st.gate.set()  # fall back to real blocking behavior
        self._done.set()

    def _schedule_locked(self) -> None:
        if self._aborted or not self._started:
            return
        self._steps += 1
        if self._steps > self.max_steps:
            self._violation(f"step budget exceeded ({self.max_steps})")
            self._abort_locked()
            return
        waiting = sorted(
            (
                s
                for s in self._states.values()
                if s.waiting and not s.finished
            ),
            key=lambda s: s.name,
        )
        runnable = [s for s in waiting if s.ready is None or s.ready()]
        if not runnable:
            blocked = [s for s in waiting if not s.service]
            if blocked:
                self._violation(
                    "deadlock: no runnable thread; blocked: "
                    + ", ".join(f"{s.name}@{s.where}" for s in blocked)
                )
                self._abort_locked()
            # only idle service threads left: nothing to do until a
            # scenario thread arrives (or completion/teardown wakes them)
            return
        if len(runnable) == 1:
            idx = 0
        elif self.force is not None and self._choice_i < len(self.force):
            idx = self.force[self._choice_i] % len(runnable)
        elif self.default_first:
            idx = 0
        else:
            idx = self.rng.randrange(len(runnable))
        self._choice_i += 1
        chosen = runnable[idx]
        self.choices.append((len(runnable), idx, chosen.name))
        chosen.waiting = False
        chosen.ready = None
        self._running = chosen
        self._held.setdefault(chosen.ident or 0, [])
        chosen.gate.set()

    def _watchdog(self) -> None:
        """Detect a scheduled thread that exited without yielding —
        spawned bodies report via ``_thread_finished``, but an adopted
        service thread whose loop returns (the committer after a
        CrashPoint) just dies. Hand the turn onward so the schedule
        keeps its determinism: at the hand-off every other thread is
        parked, so the runnable set is exactly what the dead thread
        left behind."""
        while not self._done.is_set():
            (_real_sleep or time.sleep)(0.005)
            with self._mx:
                r = self._running
                if (
                    self._started
                    and not self._aborted
                    and r is not None
                    and r.thread is not None
                    and not r.thread.is_alive()
                ):
                    r.finished = True
                    r.waiting = False
                    self._running = None
                    if all(
                        s.finished
                        for s in self._states.values()
                        if not s.service
                    ):
                        self._complete_locked()
                    else:
                        self._schedule_locked()


# ---------------------------------------------------------------------------
# activation (factory + sleep interposition)


def _activate(sched: Scheduler) -> None:
    global _active, _real_sleep
    if _active is not None:
        raise RuntimeError("a scheduler is already active in this process")
    _active = sched
    _sanitizer.set_factory_hook(
        lambda name, reentrant, allow_blocking=False: SchedLock(
            name, reentrant, sched, allow_blocking
        )
    )
    if _real_sleep is None:
        _real_sleep = time.sleep
        time.sleep = _sched_sleep


def _deactivate() -> None:
    global _active, _real_sleep
    _active = None
    _sanitizer.set_factory_hook(None)
    if _real_sleep is not None:
        time.sleep = _real_sleep
        _real_sleep = None


def _sched_sleep(secs: float) -> None:
    s = _active
    if s is not None and s._is_registered():
        # a participant's sleep is a schedule point, not wall time —
        # and sleeping with a lock held is the classic stall bug
        s._note_blocking(f"time.sleep({secs!r})")
        st = s._ensure_state()
        if st is not None:
            s._yield(None, "time.sleep")
        return
    rs = _real_sleep
    (rs or time.sleep)(secs)


# ---------------------------------------------------------------------------
# exploration harness


@dataclasses.dataclass
class ScheduleResult:
    """One executed schedule: its seed (or forced trace), the decision
    trace actually taken, and any violations."""

    seed: int
    violations: list[str]
    choices: list[tuple[int, int, str]]
    steps: int
    forced: Optional[list[int]] = None

    @property
    def failed(self) -> bool:
        return bool(self.violations)

    def render(self) -> str:
        head = (
            f"schedule seed={self.seed}"
            if self.forced is None
            else f"schedule trace={self.forced}"
        )
        if not self.failed:
            return f"{head}: ok ({self.steps} steps)"
        return (
            f"{head}: FAILED ({self.steps} steps)\n  "
            + "\n  ".join(self.violations)
        )


@dataclasses.dataclass
class ExploreOutcome:
    found: Optional[ScheduleResult]  # first failing schedule, or None
    schedules_run: int

    def __str__(self) -> str:
        if self.found is None:
            return f"explored {self.schedules_run} schedules: all green"
        return (
            f"explored {self.schedules_run} schedules, found failure:\n"
            + self.found.render()
        )


def run_schedule(
    build: Callable[[Scheduler], Any],
    seed: int = 0,
    force: Optional[list[int]] = None,
    default_first: bool = False,
    step_timeout: float = 20.0,
    max_steps: int = 50_000,
    go_timeout: float = 60.0,
) -> ScheduleResult:
    """Execute ONE schedule of the scenario. ``build(sched)`` creates
    the objects under test (their sanitizer-factory locks become
    cooperative), spawns threads via ``sched.spawn``, and returns an
    invariant check callable, a ``(check, cleanup)`` pair, or None.
    The check runs after quiescence; cleanup always runs (schedule the
    store's ``close`` there so adopted committer threads exit)."""
    sched = Scheduler(
        seed=seed,
        force=force,
        default_first=default_first,
        step_timeout=step_timeout,
        max_steps=max_steps,
    )
    _activate(sched)
    check = cleanup = None
    try:
        out = build(sched)
        if isinstance(out, tuple):
            check, cleanup = out
        else:
            check = out
        sched.go(timeout=go_timeout)
        if check is not None and not sched.violations:
            try:
                check()
            except AssertionError as e:
                sched.violations.append(f"invariant violated: {e}")
            except _Aborted:
                pass
            except BaseException as e:  # noqa: BLE001 — ANY check failure
                # (CrashPoint from a crash-drill recovery included) is
                # the schedule's result: letting it escape would lose
                # the seed/trace exactly when a real bug was found
                sched.violations.append(
                    f"invariant check raised {type(e).__name__}: {e}"
                )
    finally:
        _deactivate()
        if cleanup is not None:
            try:
                cleanup()
            except Exception:  # noqa: BLE001 — teardown must not mask the schedule result
                pass
    return ScheduleResult(
        seed=seed,
        violations=list(sched.violations),
        choices=list(sched.choices),
        steps=sched._steps,
        forced=list(force) if force is not None else None,
    )


def explore(
    build: Callable[[Scheduler], Any],
    schedules: int = 100,
    seed: int = 0,
    mode: str = "random",
    systematic_depth: int = 12,
    **run_kwargs,
) -> ExploreOutcome:
    """Run up to ``schedules`` interleavings of the scenario and stop
    at the first failure.

    - ``mode="random"``: seeded random walks with seeds ``seed,
      seed+1, …`` — every schedule independently replayable from its
      seed.
    - ``mode="systematic"``: bounded DFS over the first
      ``systematic_depth`` multi-way decisions: run the leftmost
      schedule, then branch each recorded decision point in turn
      (stateless model checking, shuttle's default posture). Failures
      replay from the recorded ``forced`` trace.
    """
    if mode == "random":
        for i in range(schedules):
            res = run_schedule(build, seed=seed + i, **run_kwargs)
            if res.failed:
                return ExploreOutcome(found=res, schedules_run=i + 1)
        return ExploreOutcome(found=None, schedules_run=schedules)
    if mode != "systematic":
        raise ValueError(f"unknown mode {mode!r}")
    stack: list[list[int]] = [[]]
    runs = 0
    seen: set[tuple[int, ...]] = set()
    while stack and runs < schedules:
        prefix = stack.pop()
        res = run_schedule(
            build, seed=seed, force=prefix, default_first=True, **run_kwargs
        )
        runs += 1
        if res.failed:
            return ExploreOutcome(found=res, schedules_run=runs)
        # branch every undecided MULTI-WAY point inside the depth
        # bound — 1-way (forced) steps consume a trace position but
        # not depth, so long single-runnable stretches (a committer
        # draining alone) don't eat the divergence budget
        taken = [idx for (_, idx, _) in res.choices]
        multiway = 0
        for p, (n, idx, _name) in enumerate(res.choices):
            if n <= 1:
                continue
            if multiway >= systematic_depth:
                break
            multiway += 1
            if p < len(prefix):
                continue  # already forced: don't re-branch
            for alt in range(n):
                if alt == idx:
                    continue
                branch = taken[:p] + [alt]
                key = tuple(branch)
                if key not in seen:
                    seen.add(key)
                    stack.append(branch)
    return ExploreOutcome(found=None, schedules_run=runs)
