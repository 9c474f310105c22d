"""The port's deterministic schedule explorer (``analysis/schedule.py``)
and the schedule hooks in its control plane, held to the JAX package's.

Four layers, after ``tests/test_schedule.py``:

- scheduler mechanics on the port: seeded determinism, deadlock and
  blocking-under-lock detection, systematic enumeration, raw locks
  after an exploration;
- explorer parity: the same toy scenario under the same seed replays
  the same decision trace in both packages' explorers, and the same
  deliberate deadlock is found at the same seed;
- the port's control plane GREEN under exploration: the group-commit
  pipeline (racing writers × committer × snapshot cut, recovery as the
  invariant), the lease-fencing handover, informer heal-vs-read, and a
  live ``PartitionMover`` move against a concurrent writer (zero acked
  writes lost);
- historical races reverted in fixtures over the port's own classes —
  the rate limiter's sleep under its lock and a committer that applies
  before its fsync — each FOUND within the bounded budget, on both
  packages, and replayed from the printed seed.

``GRAFT_SCHED=<n>`` multiplies the budgets for deeper sweeps.
"""

import importlib
import os
import threading
import time
import types

import pytest

ROOTS = {"jax": "odh_kubeflow_tpu", "torch": "odh_kubeflow_tpu_torch"}
_MODULES = {
    "sanitizer": "analysis.sanitizer",
    "schedule": "analysis.schedule",
    "cache": "machinery.cache",
    "leader": "machinery.leader",
    "store": "machinery.store",
    "wal": "machinery.wal",
    "partition": "machinery.partition",
}


def pkg(name: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        name=name,
        **{k: importlib.import_module(f"{ROOTS[name]}.{v}") for k, v in _MODULES.items()},
    )


P = pkg("torch")
schedule = P.schedule
sanitizer = P.sanitizer

_BUDGET_SCALE = max(1, int(os.environ.get("GRAFT_SCHED", "1") or 1))
GREEN_SCHEDULES = 20 * _BUDGET_SCALE
HUNT_SCHEDULES = 48 * _BUDGET_SCALE


def cm(name, data=None, ns="default"):
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {"name": name, "namespace": ns},
        "data": data or {},
    }


# ---------------------------------------------------------------------------
# scheduler mechanics (the port's explorer)


def _toy_scenario(m):
    """Three workers around one factory lock and a sched point: the
    parity scenario, built from ``m``'s own primitives."""

    def scenario(sched):
        lock = m.sanitizer.new_lock("t.shared")
        order = []

        def worker(i):
            with lock:
                order.append(i)
            m.schedule.sched_point("mid")
            with lock:
                order.append(10 + i)

        for i in range(3):
            sched.spawn(f"w{i}", worker, i)
        return None

    return scenario


def _deadlock_scenario(m):
    def scenario(sched):
        a = m.sanitizer.new_lock("t.A")
        b = m.sanitizer.new_lock("t.B")

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        sched.spawn("ab", ab)
        sched.spawn("ba", ba)
        return None

    return scenario


def test_same_seed_replays_identical_trace():
    scenario = _toy_scenario(P)
    a = schedule.run_schedule(scenario, seed=42)
    b = schedule.run_schedule(scenario, seed=42)
    assert not a.failed and not b.failed
    assert a.choices == b.choices
    traces = {tuple(schedule.run_schedule(scenario, seed=s).choices) for s in range(6)}
    assert len(traces) > 1


def test_deadlock_detected_and_replayable():
    scenario = _deadlock_scenario(P)
    out = schedule.explore(scenario, schedules=64, seed=0)
    assert out.found is not None, "deadlock never found"
    assert any("deadlock" in v for v in out.found.violations)
    replay = schedule.run_schedule(scenario, seed=out.found.seed)
    assert replay.failed and replay.choices == out.found.choices


def test_blocking_under_lock_violation_reported():
    def scenario(sched):
        lock = sanitizer.new_lock("t.lock")

        def sleeper():
            with lock:
                time.sleep(0.01)

        sched.spawn("sleeper", sleeper)
        return None

    res = schedule.run_schedule(scenario, seed=0)
    assert res.failed
    assert any("blocking-under-lock" in v for v in res.violations)


def test_systematic_mode_enumerates_orders():
    def scenario(sched):
        order = []

        def worker(i):
            schedule.sched_point("go")
            order.append(i)

        sched.spawn("w0", worker, 0)
        sched.spawn("w1", worker, 1)

        def check():
            assert order[0] == 0, f"w1 won: {order}"

        return check

    out = schedule.explore(scenario, schedules=32, mode="systematic")
    assert out.found is not None
    assert any("invariant violated" in v for v in out.found.violations)
    replay = schedule.run_schedule(scenario, force=out.found.forced, default_first=True)
    assert replay.failed and replay.choices == out.found.choices


def test_thread_exception_is_a_violation():
    def scenario(sched):
        def boom():
            raise RuntimeError("scenario bug")

        sched.spawn("boom", boom)
        return None

    res = schedule.run_schedule(scenario, seed=3)
    assert res.failed and any("scenario bug" in v for v in res.violations)


def test_locks_are_raw_again_after_exploration():
    def scenario(sched):
        sched.spawn("noop", lambda: None)
        return None

    schedule.run_schedule(scenario, seed=0)
    assert schedule.active() is None
    lock = sanitizer.new_lock("after")
    assert not isinstance(lock, schedule.SchedLock)


# ---------------------------------------------------------------------------
# explorer parity: same scenario, same seed, same trace in both packages


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_same_seed_same_trace_in_both_explorers(seed):
    runs = {
        name: m.schedule.run_schedule(_toy_scenario(m), seed=seed)
        for name, m in (("jax", pkg("jax")), ("torch", P))
    }
    assert not runs["jax"].failed and not runs["torch"].failed
    assert runs["torch"].choices == runs["jax"].choices
    assert runs["torch"].choices  # a real interleaving, not an empty trace


def test_same_deadlock_found_at_the_same_seed_in_both_explorers():
    found = {}
    for name, m in (("jax", pkg("jax")), ("torch", P)):
        out = m.schedule.explore(_deadlock_scenario(m), schedules=64, seed=0)
        assert out.found is not None, name
        found[name] = (out.found.seed, out.found.choices, out.found.violations)
    assert found["torch"] == found["jax"]


# ---------------------------------------------------------------------------
# green targets: the port's drilled subsystems under exploration


def _group_commit_scenario(m, tmp_path):
    counter = [0]

    def scenario(sched):
        counter[0] += 1
        wal_dir = str(tmp_path / f"wal-{m.name}-{counter[0]}")
        wal = m.wal.WriteAheadLog(wal_dir)
        api = m.store.APIServer(wal=wal, snapshot_interval=2)

        def writer(i):
            api.create(cm(f"w-{i}", {"v": str(i)}))

        for i in range(3):
            sched.spawn(f"writer-{i}", writer, i)
        # the snapshot cut racing the committer
        sched.spawn("snapshot", api.snapshot_now)

        def check():
            for i in range(3):
                api.get("ConfigMap", f"w-{i}", "default")
            api.close()
            wal.close()
            recovered = m.store.APIServer.recover(m.wal.WriteAheadLog(wal_dir))
            try:
                # every acked write survives crash + recovery however
                # writers, committer and snapshot interleaved
                for i in range(3):
                    recovered.get("ConfigMap", f"w-{i}", "default")
            finally:
                recovered.close()

        return check, api.close

    return scenario


def test_group_commit_pipeline_green_under_exploration(tmp_path):
    out = schedule.explore(_group_commit_scenario(P, tmp_path), schedules=GREEN_SCHEDULES, seed=0)
    assert out.found is None, out.found.render()


def test_group_commit_points_are_the_references(tmp_path):
    """The port's commit pipeline yields at the same named points as
    JAX's: one seeded schedule of the same scenario visits the same
    labels (the explorer records a point's label in its trace)."""
    labels = {}
    for name, m in (("jax", pkg("jax")), ("torch", P)):
        seen = []
        real = m.schedule.sched_point

        def spy(label="", _real=real, _seen=seen):
            _seen.append(label)
            return _real(label)

        m.schedule.sched_point = spy
        try:
            res = m.schedule.run_schedule(_group_commit_scenario(m, tmp_path), seed=5)
        finally:
            m.schedule.sched_point = real
        assert not res.failed, res.render()
        labels[name] = sorted(set(seen))
    assert labels["torch"] == labels["jax"]
    assert {"store.commit.enqueue", "store.commit.fsync", "store.commit.apply",
            "store.snapshot.cut", "store.snapshot.persist"} <= set(labels["torch"])


def test_build_phase_committer_joins_schedule_deterministically(tmp_path):
    counter = [0]

    def scenario(sched):
        counter[0] += 1
        wal = P.wal.WriteAheadLog(str(tmp_path / f"wal-pre-{counter[0]}"))
        api = P.store.APIServer(wal=wal)
        api.create(cm("seeded"))  # build-phase write: the committer is born here

        def writer(i):
            api.create(cm(f"w-{i}"))

        sched.spawn("writer-0", writer, 0)
        sched.spawn("writer-1", writer, 1)

        def check():
            for name in ("seeded", "w-0", "w-1"):
                api.get("ConfigMap", name, "default")

        return check, api.close

    a = schedule.run_schedule(scenario, seed=11)
    b = schedule.run_schedule(scenario, seed=11)
    assert not a.failed, a.render()
    assert not b.failed, b.render()
    assert a.choices == b.choices
    assert any("service-" in name for (_, _, name) in a.choices)


def test_fencing_handover_green_under_exploration():
    def scenario(sched):
        api = P.store.APIServer()
        clock = [100.0]
        api.fence_now_fn = lambda: clock[0]
        a = P.leader.LeaderElector(api, "ctrl", identity="A", lease_duration=10,
                                   now_fn=lambda: clock[0])
        assert a.try_acquire()
        token_a = a.token
        api.create(cm("state", {"owner": "boot"}))
        outcomes = []

        def old_holder():
            # the deposed holder's write still in flight from epoch A
            # after B's takeover must be fenced out
            try:
                with P.leader.fenced("kubeflow", "ctrl", token_a):
                    obj = api.get("ConfigMap", "state", "default")
                    obj["data"] = {"owner": "A"}
                    api.update(obj)
                outcomes.append("ok")
            except Exception as e:  # noqa: BLE001 — FencedOut/Conflict expected
                outcomes.append(type(e).__name__)

        def usurper():
            clock[0] += 30.0  # A's lease expires
            b = P.leader.LeaderElector(api, "ctrl", identity="B", lease_duration=10,
                                       now_fn=lambda: clock[0])
            assert b.try_acquire()
            with b.fence():
                obj = api.get("ConfigMap", "state", "default")
                obj["data"] = {"owner": "B"}
                api.update(obj)

        sched.spawn("old-holder", old_holder)
        sched.spawn("usurper", usurper)

        def check():
            final = api.get("ConfigMap", "state", "default")
            assert final["data"]["owner"] == "B", final["data"]
            assert outcomes and outcomes[0] in ("ok", "FencedOut", "Conflict"), outcomes

        return check

    out = schedule.explore(scenario, schedules=GREEN_SCHEDULES, seed=0)
    assert out.found is None, out.found.render()


def test_informer_heal_vs_read_green_under_exploration():
    def scenario(sched):
        api = P.store.APIServer()
        cache = P.cache.InformerCache(api, kinds=("ConfigMap",))
        cache.reestablish_backoff = 0.0
        cache.start(live=False)
        client = P.cache.CachedClient(api, cache)
        api.create(cm("a", {"v": "0"}))
        cache.drain_once()
        # stream loss: in drain mode the read path heals (fresh watch +
        # relist)
        cache._kinds["ConfigMap"].degraded = True
        cache._watches["ConfigMap"].ended = True

        def writer():
            api.create(cm("b", {"v": "1"}))
            obj = api.get("ConfigMap", "a", "default")
            obj["data"] = {"v": "2"}
            api.update(obj)

        def reader():
            for _ in range(3):
                try:
                    client.get("ConfigMap", "a", "default")
                except P.store.NotFound:
                    pass
                schedule.sched_point("reader")

        def healer():
            cache.poke("ConfigMap")

        sched.spawn("writer", writer)
        sched.spawn("reader", reader)
        sched.spawn("healer", healer)

        def check():
            cache.poke("ConfigMap")
            cache.drain_once()
            # the mirror converges to the store: no event lost to the
            # heal, no resurrected deletes
            mirror = {o["metadata"]["name"]: o["data"] for o in cache.list("ConfigMap")}
            truth = {o["metadata"]["name"]: o["data"] for o in api.list("ConfigMap")}
            assert mirror == truth, (mirror, truth)
            assert not cache.degraded("ConfigMap")

        return check

    out = schedule.explore(scenario, schedules=GREEN_SCHEDULES, seed=0)
    assert out.found is None, out.found.render()


def _nb(ns, name, v=0):
    return {"kind": "Notebook", "metadata": {"name": name, "namespace": ns}, "spec": {"v": v}}


def _move_scenario(m):
    """A live namespace move racing a writer into the moving namespace.
    The invariant is the move protocol's: no acked write is lost, and a
    move either completes (the namespace lives on the destination only)
    or aborts with a retryable 429 and changes nothing."""

    def scenario(sched):
        router = m.partition.build_partitions(2)
        router.register_kind("kubeflow.org/v1beta1", "Notebook", "notebooks")
        ns = "moving-team"
        src = router.owner_of(ns)
        dst = 1 - src
        for i in range(3):
            router.create(_nb(ns, f"pre-{i}", i))
        acked, outcome = [f"pre-{i}" for i in range(3)], []
        mover = m.partition.PartitionMover(router, ns, dst)
        # a writer parked in the scheduler holds its in-flight count;
        # the quiesce barrier waits on a plain condition, so keep its
        # real-time bound short and let such schedules abort the move
        mover.QUIESCE_TIMEOUT = 0.02

        def writer():
            for i in range(3):
                name = f"live-{i}"
                try:
                    router.create(_nb(ns, name, i))
                except m.store.TooManyRequests:
                    continue  # refused inside the freeze: never acked
                acked.append(name)

        def move():
            try:
                mover.run()
                outcome.append("moved")
            except m.store.TooManyRequests:
                outcome.append("aborted")

        sched.spawn("writer", writer)
        sched.spawn("mover", move)

        def check():
            assert outcome in (["moved"], ["aborted"]), outcome
            owner = router.owner_of(ns)
            assert owner == (dst if outcome == ["moved"] else src)
            names = {o["metadata"]["name"] for o in router.list("Notebook", namespace=ns)}
            lost = sorted(set(acked) - names)
            assert not lost, f"acked writes lost by the move: {lost}"
            if outcome == ["moved"]:
                assert not router.backends[src].list("Notebook", namespace=ns)
            assert router.create(_nb(ns, "after"))  # the namespace takes writes again

        return check

    return scenario


def test_partition_move_vs_concurrent_writer_green_under_exploration():
    seen = []
    real = schedule.sched_point

    def spy(label=""):
        seen.append(label)
        return real(label)

    schedule.sched_point = spy
    try:
        out = schedule.explore(_move_scenario(P), schedules=GREEN_SCHEDULES, seed=0)
    finally:
        schedule.sched_point = real
    assert out.found is None, out.found.render()
    # the mover's six protocol points took part in the exploration
    assert {f"partition.move.{p}" for p in ("cut", "ship", "freeze", "tail", "takeover",
                                            "unfreeze")} <= set(seen)


# ---------------------------------------------------------------------------
# historical races, reverted in fixtures, re-found by the explorer


def _buggy_rate_limiter(m):
    class _BuggyRateLimiter:
        """The rate limiter's old bug, reverted: the backoff sleep runs
        INSIDE the critical section, stalling every other worker."""

        def __init__(self):
            self.failures: dict[str, int] = {}
            self._lock = m.sanitizer.new_lock("controller.ratelimiter")

        def when(self, key: str) -> float:
            with self._lock:
                n = self.failures.get(key, 0)
                self.failures[key] = n + 1
                delay = min(0.005 * (2 ** n), 16.0)
                time.sleep(delay)  # the bug: blocking while holding the lock
            return delay

    def scenario(sched):
        limiter = _BuggyRateLimiter()
        sched.spawn("worker-0", limiter.when, "req")
        sched.spawn("worker-1", limiter.when, "req")
        return None

    return scenario


def test_explorer_refinds_rate_limiter_lock_bug_on_both():
    found = {}
    for name, m in (("jax", pkg("jax")), ("torch", P)):
        scenario = _buggy_rate_limiter(m)
        out = m.schedule.explore(scenario, schedules=HUNT_SCHEDULES, seed=0)
        assert out.found is not None, f"{name}: bounded budget failed to find the bug"
        assert any("blocking-under-lock" in v and "ratelimiter" in v
                   for v in out.found.violations), out.found.violations
        print(f"{name} rate-limiter bug found: {out.found.render()}")
        replay = m.schedule.run_schedule(scenario, seed=out.found.seed)
        assert replay.failed
        assert replay.choices == out.found.choices
        assert replay.violations == out.found.violations
        found[name] = (out.found.seed, out.found.choices)
    assert found["torch"] == found["jax"]


def test_the_ports_rate_limiter_sleeps_outside_its_lock():
    """The repaired shape on the port's own ``_RateLimiter``: workers
    computing delays under exploration never block under its lock."""
    from odh_kubeflow_tpu_torch.controllers import runtime

    def scenario(sched):
        limiter = runtime._RateLimiter()

        def worker():
            time.sleep(limiter.when("req"))

        sched.spawn("worker-0", worker)
        sched.spawn("worker-1", worker)
        return None

    out = schedule.explore(scenario, schedules=GREEN_SCHEDULES, seed=0)
    assert out.found is None, out.found.render()


def _apply_before_fsync_server(m):
    class _CrashingFsyncIO(m.wal.FileIO):
        """Process death at the first segment fsync, with the unfsynced
        write lost (pinned deterministic)."""

        def write(self, f, data: bytes) -> None:
            pass

        def fsync(self, f):
            raise m.wal.CrashPoint("injected: died at fsync")

    class _ApplyBeforeFsyncServer(m.store.APIServer):
        """The log→fsync→apply→ack ordering, reverted: the committer
        applies records (reader-visible) BEFORE the covering fsync."""

        def _committer_loop(self):  # noqa: C901 — deliberate bug fixture
            while True:
                entry = m.schedule.queue_get(self._commitq)
                if entry is None:
                    return
                batch = [entry]
                while True:
                    try:
                        nxt = self._commitq.get_nowait()
                    except Exception:  # noqa: BLE001 — queue.Empty
                        break
                    if nxt is None:
                        self._commitq.put(None)
                        break
                    batch.append(nxt)
                # THE REVERT: apply first (visible to every reader) …
                with self._lock:
                    for e in batch:
                        if e.etype != "register":
                            self._apply_record(e.etype, e.kind, e.key, e.obj, e.rv)
                        if self._pending.get((e.kind, e.key)) is e:
                            del self._pending[(e.kind, e.key)]
                m.schedule.sched_point("buggy.applied-before-fsync")
                # … then try to make it durable
                try:
                    with self._wal.io_lock:
                        for e in batch:
                            self._wal.write_record(e.record)
                        self._wal.sync()
                except BaseException as e:  # noqa: BLE001 — incl. CrashPoint
                    self._commit_failed(batch, e)
                    return
                for e in batch:
                    e.done.set()

    return _CrashingFsyncIO, _ApplyBeforeFsyncServer


def _apply_before_fsync_scenario(m, tmp_path, buggy: bool):
    crashing_io, buggy_cls = _apply_before_fsync_server(m)
    server_cls = buggy_cls if buggy else m.store.APIServer
    counter = [0]

    def scenario(sched):
        counter[0] += 1
        wal_dir = str(tmp_path / f"wal-{m.name}-{buggy}-{counter[0]}")
        wal = m.wal.WriteAheadLog(wal_dir, io=crashing_io())
        api = server_cls(wal=wal)
        observed = []

        def writer():
            try:
                api.create(cm("cm-x"))
            except BaseException:  # noqa: BLE001 — the injected crash
                pass

        def reader():
            for _ in range(4):
                try:
                    api.get("ConfigMap", "cm-x", "default")
                    observed.append(True)
                except m.store.NotFound:
                    pass
                m.schedule.sched_point("reader")

        sched.spawn("writer", writer)
        sched.spawn("reader", reader)

        def check():
            if not observed:
                return  # the reader missed the window
            wal.close()
            recovered = m.store.APIServer.recover(m.wal.WriteAheadLog(wal_dir))
            try:
                try:
                    recovered.get("ConfigMap", "cm-x", "default")
                except m.store.NotFound:
                    raise AssertionError(
                        "reader observed 'cm-x' but recovery has no record of "
                        "it — unacked state was visible before its covering fsync"
                    ) from None
            finally:
                recovered.close()

        return check, api.close

    return scenario


def test_explorer_refinds_apply_before_fsync_reorder_on_both(tmp_path):
    found = {}
    for name, m in (("jax", pkg("jax")), ("torch", P)):
        out = m.schedule.explore(_apply_before_fsync_scenario(m, tmp_path, True),
                                 schedules=HUNT_SCHEDULES, seed=0)
        assert out.found is not None, f"{name}: bounded budget failed to find the reorder"
        assert any("covering fsync" in v for v in out.found.violations)
        print(f"{name} apply-before-fsync found: {out.found.render()}")
        replay = m.schedule.run_schedule(_apply_before_fsync_scenario(m, tmp_path, True),
                                         seed=out.found.seed)
        assert replay.failed
        assert replay.violations == out.found.violations
        found[name] = out.found.seed
    assert found["torch"] == found["jax"]


def test_the_ports_committer_never_shows_undurable_state(tmp_path):
    out = schedule.explore(_apply_before_fsync_scenario(P, tmp_path, False),
                           schedules=GREEN_SCHEDULES, seed=0)
    assert out.found is None, out.found.render()


def test_explorer_runs_leave_no_scheduler_threads():
    before = {t.name for t in threading.enumerate()}
    schedule.run_schedule(_toy_scenario(P), seed=1)
    time.sleep(0.05)
    left = {t.name for t in threading.enumerate()} - before
    assert not {n for n in left if n.startswith("sched-")}, left
