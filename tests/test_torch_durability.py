"""The port's crash-safe store against the JAX package's, on the CPU.

``machinery/wal.py`` (segments, snapshots, torn-tail truncation, the loud
mid-log failure), the store's durability branch (the group-commit
pipeline, fail-stop after a failed fsync, the off-lock snapshot,
``APIServer.recover``: objects, the rv counter, dynamic kinds, the Event
dedupe index, the bounded watch cache and its 410) and
``machinery/faults.py`` (kill points, disk weather, the API-path chaos).
Each scenario of JAX's ``tests/test_durability.py`` that needs no
HTTP facade, fencing, replication or leader election runs through both
packages with the same seeds: what each recovers must be the acked
prefix (± the one in-flight record), and the package-independent
outcome (the op counts of the log, the acked models, which kill point
fires where) must equal JAX's. One cross-package case runs one op script
through both stores and compares the recovered objects and rvs, and the
port recovers a log the JAX package wrote.
"""

from __future__ import annotations

import importlib
import os
import random
import threading
import time
from types import SimpleNamespace

import pytest

SEED = 11
PACKAGES = ("odh_kubeflow_tpu", "odh_kubeflow_tpu_torch")


def pkg(port: bool) -> SimpleNamespace:
    """One package's durability surface."""
    name = PACKAGES[port]
    store = importlib.import_module(f"{name}.machinery.store")
    wal = importlib.import_module(f"{name}.machinery.wal")
    faults = importlib.import_module(f"{name}.machinery.faults")
    return SimpleNamespace(
        port=port, store=store, wal=wal, faults=faults,
        APIServer=store.APIServer, WriteAheadLog=wal.WriteAheadLog,
        CrashPoint=wal.CrashPoint, FileIO=wal.FileIO,
        backoff=importlib.import_module(f"{name}.machinery.backoff"),
        prometheus=importlib.import_module(f"{name}.utils.prometheus"),
        scheduling=importlib.import_module(f"{name}.scheduling"),
        workload=importlib.import_module(f"{name}.scheduling.workload"),
        sessions=importlib.import_module(f"{name}.sessions"),
        checkpoint=importlib.import_module(f"{name}.sessions.checkpoint"),
        manager=importlib.import_module(f"{name}.sessions.manager"))


BOTH = [pkg(False), pkg(True)]
J, T = BOTH


def both(scenario, tmp_path):
    """``scenario(p, dir)`` for JAX's package and the port; returns their
    results, which must be equal."""
    got = [scenario(p, str(tmp_path / ("port" if p.port else "jax"))) for p in BOTH]
    assert got[1] == got[0]
    return got[1]


def _widget_api(p, wal, snapshot_interval=9):
    api = p.APIServer(wal=wal, snapshot_interval=snapshot_interval)
    api.register_kind("kubeflow.org/v1", "Widget", "widgets")
    return api


def _widgets_of(p, api) -> dict:
    try:
        items = api.list("Widget")
    except p.store.NotFound:  # crashed before the registration record landed
        return {}
    return {(o["metadata"]["namespace"], o["metadata"]["name"]): o["spec"]["v"] for o in items}


def _widget(name, v, ns="a"):
    return {"kind": "Widget", "metadata": {"name": name, "namespace": ns}, "spec": {"v": v}}


def _recover(p, d, io=None, attempts=4):
    last = None
    for _ in range(attempts):
        try:
            return p.APIServer.recover(p.WriteAheadLog(d, io=io))
        except OSError as e:  # a transient short read: retry recovery
            last = e
    raise last


# ---------------------------------------------------------------------------
# WAL mechanics


def test_wal_roundtrip_snapshot_rotation_and_gc(tmp_path):
    def scenario(p, d):
        wal = p.WriteAheadLog(d)
        api = _widget_api(p, wal, snapshot_interval=5)
        for i in range(13):
            api.create(_widget(f"w{i}", i))
        api.delete("Widget", "w3", "a")
        w5 = api.get("Widget", "w5", "a")
        w5["spec"]["v"] = 500
        api.update(w5)
        names = sorted(os.listdir(d))
        snaps = sum(n.startswith("snap-") for n in names)
        api.close()
        wal.close()
        rec = p.APIServer.recover(p.WriteAheadLog(d))
        with pytest.raises(p.store.NotFound):
            rec.get("Widget", "w3", "a")
        orig, back = api.get("Widget", "w7", "a"), rec.get("Widget", "w7", "a")
        assert orig["metadata"]["uid"] == back["metadata"]["uid"]
        fresh = rec.create(_widget("post", 1))
        rec.close()
        return {"snapshots": snaps, "segments": sum(n.startswith("wal-") for n in names),
                "widgets": _widgets_of(p, rec),
                "rv": back["metadata"]["resourceVersion"],
                "rv_continues": int(fresh["metadata"]["resourceVersion"])
                > int(orig["metadata"]["resourceVersion"]),
                "fsyncs": wal.fsync_total, "appended": wal.appended_total}

    got = both(scenario, tmp_path)
    assert got["snapshots"] == 1 and got["rv_continues"]
    assert len(got["widgets"]) == 13 and got["widgets"][("a", "w5")] == 500


def test_event_dedupe_index_survives_recovery(tmp_path):
    def scenario(p, d):
        wal = p.WriteAheadLog(d)
        api = _widget_api(p, wal)
        obj = api.create(_widget("w", 0))
        ev = api.emit_event(obj, "Scheduled", "placed on node n1")
        api.close()
        wal.close()
        rec = p.APIServer.recover(p.WriteAheadLog(d))
        again = rec.emit_event(obj, "Scheduled", "placed on node n1")
        rec.close()
        return {"same": again["metadata"]["name"] == ev["metadata"]["name"],
                "events": len(rec.list("Event", namespace="a"))}

    assert both(scenario, tmp_path) == {"same": True, "events": 1}


def test_torn_tail_is_truncated_and_never_acked_lost(tmp_path):
    def scenario(p, d):
        wal = p.WriteAheadLog(d)
        api = _widget_api(p, wal, snapshot_interval=0)  # no snapshots: pure log
        for i in range(5):
            api.create(_widget(f"w{i}", i))
        api.close()
        wal.close()
        path = os.path.join(d, [n for n in os.listdir(d) if n.startswith("wal-")][0])
        whole = os.path.getsize(path)
        with open(path, "ab") as f:
            f.write(b"\xff\xff\x00\x00garbage-torn-tail")
        rec = p.APIServer.recover(p.WriteAheadLog(d))
        return {"widgets": _widgets_of(p, rec), "truncated": os.path.getsize(path) == whole}

    got = both(scenario, tmp_path)
    assert len(got["widgets"]) == 5 and got["truncated"]


@pytest.mark.parametrize("where", ["mid_log", "sealed_segment"])
def test_corruption_before_the_tail_fails_loudly(tmp_path, where):
    """A flipped byte mid-log, or garbage after a sealed segment's last
    record: rot, not a torn write — recovery refuses."""

    def scenario(p, d):
        wal = p.WriteAheadLog(d)
        api = _widget_api(p, wal, snapshot_interval=0)
        for i in range(6 if where == "mid_log" else 1):
            api.create(_widget(f"w{i}", i))
        api.close()
        wal.close()
        if where == "mid_log":
            path = os.path.join(d, [n for n in os.listdir(d) if n.startswith("wal-")][0])
            data = bytearray(open(path, "rb").read())
            data[len(data) // 2] ^= 0xFF
            open(path, "wb").write(bytes(data))
        else:
            # recovery rotates to a fresh segment: the old one is sealed
            wal2 = p.WriteAheadLog(d)
            rec = p.APIServer.recover(wal2)
            rec.create(_widget("w1", 1))
            rec.close()
            wal2.close()
            sealed = sorted(n for n in os.listdir(d) if n.startswith("wal-"))[0]
            with open(os.path.join(d, sealed), "ab") as f:
                f.write(b"tail-garbage")
        with pytest.raises(p.wal.WALCorruptError):
            p.APIServer.recover(p.WriteAheadLog(d))
        return "refused"

    assert both(scenario, tmp_path) == "refused"


# ---------------------------------------------------------------------------
# the watch cache across a restart (the 410 contract)


def test_watch_resume_across_restart_replays_or_410(tmp_path, monkeypatch):
    for p in BOTH:
        monkeypatch.setattr(p.APIServer, "WATCH_CACHE_SIZE", 16)

    def scenario(p, d):
        wal = p.WriteAheadLog(d)
        api = _widget_api(p, wal, snapshot_interval=10)
        for i in range(40):
            api.create(_widget(f"w{i}", i))
        live_floor = api._compacted_rv
        api.close()
        wal.close()
        rec = p.APIServer.recover(p.WriteAheadLog(d))
        with pytest.raises(p.store.Expired):
            rec.watch("Widget", resource_version="1")
        floor = rec._compacted_rv
        w = rec.watch("Widget", resource_version=str(floor))
        got, last = [], floor
        while (item := w.try_get()) is not None:
            etype, obj = item
            rv = int(obj["metadata"]["resourceVersion"])
            assert rv > last
            last = rv
            got.append((etype, obj["metadata"]["name"]))
        # a live event after the replay reaches the resumed stream
        rec.create(_widget("late", 1))
        live = w.try_get()
        rec.close()
        return {"live_floor": live_floor, "floor": floor, "replayed": got,
                "reaches_present": last == rec._rv - 1,
                "live": (live[0], live[1]["metadata"]["name"])}

    got = both(scenario, tmp_path)
    assert got["floor"] >= got["live_floor"] > 0
    assert got["replayed"] and got["reaches_present"] and got["live"] == ("ADDED", "late")


def test_watch_resume_without_a_log_is_the_live_window(tmp_path, monkeypatch):
    """The in-memory store keeps the same bounded window: a resume inside
    it replays, below it 410 — and a watch without a resourceVersion is
    the initial dump as before."""
    for p in BOTH:
        monkeypatch.setattr(p.APIServer, "WATCH_CACHE_SIZE", 8)

    def scenario(p, _d):
        api = _widget_api(p, None)
        for i in range(12):
            api.create(_widget(f"w{i}", i))
        api.delete("Widget", "w0", "a")
        with pytest.raises(p.store.Expired):
            api.watch("Widget", resource_version="2")
        w = api.watch("Widget", resource_version=str(api._compacted_rv))
        replay = []
        while (item := w.try_get()) is not None:
            replay.append((item[0], item[1]["metadata"]["name"]))
        dump = api.watch("Widget")
        names = []
        while (item := dump.try_get()) is not None:
            names.append(item[1]["metadata"]["name"])
        return {"floor": api._compacted_rv, "replay": replay, "dump": sorted(names)}

    got = both(scenario, tmp_path)
    assert got["replay"][-1] == ("DELETED", "w0") and len(got["dump"]) == 11


# ---------------------------------------------------------------------------
# seeded kill-point and disk-fault drills


def _ops_script(rng, n=26):
    names = [f"w{i}" for i in range(5)]
    return [(rng.choice(["create", "create", "update", "update", "delete"]),
             rng.choice(["a", "b"]), rng.choice(names), i) for i in range(n)]


def _run_to_crash(p, api, ops):
    """Apply until process death / fail-stop; returns (model of acked
    ops, model with the in-flight op, last acked rv, crashed?)."""
    model, last_rv = {}, 0
    for op, ns, name, i in ops:
        key = (ns, name)
        prev = dict(model)
        try:
            if op == "create":
                try:
                    out = api.create(_widget(name, i, ns))
                except p.store.AlreadyExists:
                    continue
                model[key] = i
            elif op == "update":
                try:
                    cur = api.get("Widget", name, ns)
                except p.store.NotFound:
                    continue
                cur["spec"]["v"] = i
                out = api.update(cur)
                model[key] = i
            else:
                try:
                    api.delete("Widget", name, ns)
                except p.store.NotFound:
                    continue
                out = None
                model.pop(key, None)
            if out is not None:
                last_rv = max(last_rv, int(out["metadata"]["resourceVersion"]))
        except (p.CrashPoint, p.store.APIError):
            in_flight = {
                "create": lambda m: {**m, key: i},
                "update": lambda m: {**m, key: i} if key in m else m,
                "delete": lambda m: {k: v for k, v in m.items() if k != key},
            }[op](prev)
            return prev, in_flight, last_rv, True
    return model, None, last_rv, False


def _assert_watch_cache_coherent(p, rec):
    """Folding the recovered resume window agrees with the recovered
    store; event rvs strictly increase."""
    store_now = _widgets_of(p, rec)
    try:
        w = rec.watch("Widget", resource_version=str(rec._compacted_rv))
    except (p.store.Expired, p.store.NotFound):
        return
    folded, deleted, last = {}, set(), rec._compacted_rv
    while (item := w.try_get()) is not None:
        etype, obj = item
        rv = int(obj["metadata"]["resourceVersion"])
        assert rv > last, "watch replay rvs must be strictly increasing"
        last = rv
        key = (obj["metadata"]["namespace"], obj["metadata"]["name"])
        if etype == "DELETED":
            deleted.add(key)
            folded.pop(key, None)
        else:
            deleted.discard(key)
            folded[key] = obj["spec"]["v"]
    for key, v in folded.items():
        assert store_now.get(key) == v
    for key in deleted:
        assert key not in store_now


@pytest.mark.parametrize("after_op", [False, True], ids=["before_op", "after_op"])
def test_kill_point_sweep_prefix_consistency(tmp_path, after_op):
    """Process death at every WAL IO op in turn (mid-append with a torn
    record, pre-fsync, post-fsync pre-ack): each package recovers exactly
    the acked prefix (± the one in-flight record), keeps rv monotonic and
    its watch cache coherent, and keeps working; the clean run's IO op
    count and each kill point's acked model equal JAX's."""
    ops = _ops_script(random.Random(SEED))

    def scenario(p, d):
        probe = p.faults.KillPointIO(10**9, seed=SEED)
        api = _widget_api(p, p.WriteAheadLog(os.path.join(d, "probe"), io=probe),
                          snapshot_interval=7)
        _run_to_crash(p, api, ops)
        api.close()
        total_io = probe.ops
        acked_models = []
        for kill_at in range(1, total_io + 1):
            kd = os.path.join(d, f"k{kill_at}")
            io = p.faults.KillPointIO(kill_at, seed=SEED * 1000 + kill_at, after_op=after_op)
            try:
                api = _widget_api(p, p.WriteAheadLog(kd, io=io), snapshot_interval=7)
            except p.CrashPoint:
                acked, in_flight, last_rv, crashed = {}, None, 0, True
            else:
                acked, in_flight, last_rv, crashed = _run_to_crash(p, api, ops)
            assert crashed
            rec = _recover(p, kd)
            recovered = _widgets_of(p, rec)
            assert recovered in (acked, in_flight), (kill_at, recovered, acked, in_flight)
            assert rec._rv >= last_rv, "rv counter went backwards"
            _assert_watch_cache_coherent(p, rec)
            if recovered:
                ns, name = next(iter(recovered))
                cur = rec.get("Widget", name, ns)
                cur["spec"]["v"] = -1
                assert int(rec.update(cur)["metadata"]["resourceVersion"]) > last_rv
            rec.close()
            acked_models.append(sorted(acked.items()))
        return {"total_io": total_io, "acked": acked_models}

    got = both(scenario, tmp_path)
    assert got["total_io"] > 20


def test_disk_fault_schedule_drill(tmp_path):
    """Seeded torn-write / failed-fsync / short-read / slow-disk weather:
    every recovery is the acked prefix (± the in-flight record), short
    reads during recovery are retried, never taken for a torn tail; the
    faults each run draws equal JAX's."""

    def scenario(p, d):
        fired = []
        for case in range(12):
            seed = SEED * 100 + case
            ops = _ops_script(random.Random(seed), n=22)
            cd = os.path.join(d, f"c{case}")
            io = p.faults.FaultyFileIO(
                seed=seed, schedule=p.faults.DiskFaultSchedule(
                    torn_write=0.06, fsync_fail=0.04, short_read=0.25, slow_disk=0.05,
                    slow_seconds=0.0), sleep_fn=lambda s: None)
            try:
                api = _widget_api(p, p.WriteAheadLog(cd, io=io), snapshot_interval=6)
            except (p.CrashPoint, p.store.APIError):
                acked, in_flight, last_rv, crashed = {}, None, 0, True
            else:
                acked, in_flight, last_rv, crashed = _run_to_crash(p, api, ops)
                api.close()
            rec_io = p.faults.FaultyFileIO(
                seed=seed + 1, schedule=p.faults.DiskFaultSchedule(short_read=0.25))
            rec = _recover(p, cd, io=rec_io)
            recovered = _widgets_of(p, rec)
            assert recovered in ((acked, in_flight) if crashed else (acked,))
            assert rec._rv >= last_rv
            _assert_watch_cache_coherent(p, rec)
            rec.close()
            fired.append((sorted(io.counts.items()), crashed, sorted(acked.items())))
        return fired

    fired = both(scenario, tmp_path)
    assert any(dict(c).get("torn_write") for c, _, _ in fired)
    assert any(dict(c).get("fsync_fail") for c, _, _ in fired)


def test_failed_fsync_is_failstop_and_never_half_applies(tmp_path):
    def scenario(p, d):
        io = p.faults.FaultyFileIO(seed=1, schedule=p.faults.DiskFaultSchedule.none())
        api = _widget_api(p, p.WriteAheadLog(d, io=io), snapshot_interval=0)
        api.create(_widget("ok", 1))
        io.schedule = p.faults.DiskFaultSchedule(fsync_fail=1.0)
        with pytest.raises(p.store.APIError):
            api.create(_widget("lost", 2))
        with pytest.raises(p.store.NotFound):  # log-then-apply: not visible
            api.get("Widget", "lost", "a")
        io.schedule = p.faults.DiskFaultSchedule.none()
        with pytest.raises(p.store.APIError):  # fail-stop for mutations
            api.create(_widget("late", 3))
        served = api.get("Widget", "ok", "a")["spec"]["v"]  # reads keep serving
        api.close()
        got = _widgets_of(p, _recover(p, d))
        assert got in ({("a", "ok"): 1}, {("a", "ok"): 1, ("a", "lost"): 2})
        return {"served": served, "ok_recovered": got[("a", "ok")]}

    assert both(scenario, tmp_path) == {"served": 1, "ok_recovered": 1}


def test_snapshot_write_failure_does_not_lose_acked_writes(tmp_path):
    def scenario(p, d):
        class NoSnapshotIO(p.FileIO):
            def open_trunc(self, path):  # every snapshot attempt fails
                raise OSError("injected snapshot failure")

        api = _widget_api(p, p.WriteAheadLog(d, io=NoSnapshotIO()), snapshot_interval=4)
        for i in range(14):
            api.create(_widget(f"w{i}", i))
        api.close()
        return len(_recover(p, d).list("Widget", namespace="a"))

    assert both(scenario, tmp_path) == 14


def test_recovery_under_chaos_api_faults(tmp_path):
    """Injected conflicts / 429 / 5xx in front of a durable store: every
    write the retrying client saw acked survives recovery; the faults
    the seeded injector drew equal JAX's."""

    def scenario(p, d):
        api = _widget_api(p, p.WriteAheadLog(d), snapshot_interval=8)
        registry = p.prometheus.Registry()
        inj = p.faults.FaultInjector(
            api, seed=SEED, schedule=p.faults.FaultSchedule(
                conflict=0.08, too_many_requests=0.08, server_error=0.08),
            registry=registry, sleep_fn=lambda s: None)
        acked = {}
        for i in range(40):
            name, ns = f"w{i % 7}", "a"

            def attempt(name=name, ns=ns, i=i):
                try:
                    return inj.create(_widget(name, i, ns))
                except p.store.AlreadyExists:
                    cur = inj.get("Widget", name, ns)
                    cur["spec"]["v"] = i
                    return inj.update(cur)

            try:
                p.backoff.retry(attempt,
                                retryable=(p.store.Conflict, p.store.TooManyRequests,
                                           p.store.APIError),
                                attempts=6, sleep_fn=lambda s: None)
                acked[(ns, name)] = i
            except (p.store.Conflict, p.store.TooManyRequests, p.store.APIError):
                pass
        api.close()
        got = _widgets_of(p, _recover(p, d))
        for key in acked:
            assert key in got, f"acked write {key} lost across recovery"
        assert set(got) <= {("a", f"w{k}") for k in range(7)}
        faults = sorted(line for line in registry.exposition().splitlines()
                        if line.startswith("faults_injected_total{"))
        return {"acked": sorted(acked.items()), "faults": faults}

    got = both(scenario, tmp_path)
    assert got["faults"] and got["acked"]


def test_fault_injector_drops_watches_and_expires_resumes(tmp_path):
    """The seeded API-path chaos on a watch: a drop ends the stream with
    the sentinel (``ended``), a resume draws 410, an outage fails every
    verb and drops every live stream."""

    def scenario(p, _d):
        api = _widget_api(p, None)
        inj = p.faults.FaultInjector(
            api, seed=SEED, schedule=p.faults.FaultSchedule(watch_drop=1.0, expire=1.0),
            registry=p.prometheus.Registry(), sleep_fn=lambda s: None)
        w = inj.watch("Widget")
        inj.create(_widget("x", 1))  # its fault point drops the live watch
        dropped = w.ended
        events = []
        while (item := w.try_get()) is not None:
            events.append(item[0])
        with pytest.raises(p.store.Expired):
            inj.watch("Widget", resource_version="1")
        inj.set_schedule(p.faults.FaultSchedule.none())
        w2 = inj.watch("Widget")
        inj.set_offline(True)
        with pytest.raises(p.store.APIError):
            inj.get("Widget", "x", "a")
        offline_dropped = w2.ended
        inj.set_offline(False)
        back = inj.get("Widget", "x", "a")["spec"]["v"]
        return {"dropped": dropped, "offline_dropped": offline_dropped, "back": back,
                "digest_equal": inj.state_digest() == api.state_digest(),
                "events": events}

    got = both(scenario, tmp_path)
    assert got["dropped"] and got["offline_dropped"] and got["back"] == 1
    assert got["digest_equal"]


def test_kill_zone_and_chaos_seed(monkeypatch):
    for p in BOTH:
        monkeypatch.setenv(p.faults.CHAOS_ENV, "7")
        assert p.faults.chaos_seed() == 7
        api = p.APIServer()
        wrapped = p.faults.maybe_wrap(api, registry=p.prometheus.Registry())
        assert isinstance(wrapped, p.faults.FaultInjector) and wrapped.seed == 7
        monkeypatch.setenv(p.faults.CHAOS_ENV, "")
        assert p.faults.maybe_wrap(api) is api

    class Cluster:
        def kill_zone(self, zone):
            return [f"{zone}-n0"]

    class Store:
        failed = []

        def fail_zone(self, zone):
            self.failed.append(zone)

    store = Store()
    assert T.faults.kill_zone(Cluster(), store, "z1") == {"zone": "z1", "nodes": ["z1-n0"]}
    assert store.failed == ["z1"]


# ---------------------------------------------------------------------------
# group commit: batched fsyncs, batch-boundary kill points, off-lock
# snapshots


def _slow_fsync_io(p, delay):
    class SlowFsyncIO(p.FileIO):
        def fsync(self, f) -> None:
            time.sleep(delay)
            super().fsync(f)

    return SlowFsyncIO()


def _hammer(p, api, threads: int, per_thread: int):
    """``threads`` concurrent writers on unique keys; returns the acked
    (name → value) and every issued name."""
    acked: dict = {}
    issued: set = set()
    lock = threading.Lock()
    barrier = threading.Barrier(threads)

    def writer(tid: int):
        barrier.wait()
        for i in range(per_thread):
            name = f"t{tid}-{i}"
            with lock:
                issued.add(name)
            try:
                api.create(_widget(name, i))
            except (p.CrashPoint, p.store.APIError):
                return
            with lock:
                acked[name] = i

    ts = [threading.Thread(target=writer, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive(), "writer wedged (lost ack?)"
    return acked, issued


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
def test_group_commit_batches_fsyncs_across_concurrent_writers(tmp_path, port):
    """8 writers through the group-commit log: every write acked after
    its fsync, far fewer fsyncs than records; ``group_commit=False`` pays
    one fsync a record. (Batch sizes follow thread timing, so each
    package is held to the invariants, not to the other's counts.)"""
    p = BOTH[port]
    wal = p.WriteAheadLog(str(tmp_path / "g"), io=_slow_fsync_io(p, 0.002))
    api = _widget_api(p, wal, snapshot_interval=0)
    acked, _ = _hammer(p, api, threads=8, per_thread=10)
    assert len(acked) == 80
    assert wal.appended_total == 81  # 80 creates + the kind registration
    assert wal.fsync_total < wal.appended_total, (wal.fsync_total, wal.appended_total)
    api.close()
    assert len(_recover(p, str(tmp_path / "g")).list("Widget", namespace="a")) == 80

    base_wal = p.WriteAheadLog(str(tmp_path / "b"), io=_slow_fsync_io(p, 0.0))
    base = p.APIServer(wal=base_wal, group_commit=False, snapshot_interval=0)
    base.register_kind("kubeflow.org/v1", "Widget", "widgets")
    _hammer(p, base, threads=4, per_thread=5)
    assert base_wal.fsync_total == base_wal.appended_total
    base.close()


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
@pytest.mark.parametrize("after_op", [False, True], ids=["before_op", "after_op"])
def test_group_commit_batch_boundary_kill_points(tmp_path, port, after_op):
    """Process death before / after the covering fsync while 4 writers
    race: every acked record is recovered, and nothing outside the issued
    set appears."""
    p = BOTH[port]
    for kill_at in range(2, 44, 5):
        d = str(tmp_path / f"k{kill_at}")
        io = p.faults.KillPointIO(kill_at, seed=SEED * 77 + kill_at, after_op=after_op)
        try:
            api = _widget_api(p, p.WriteAheadLog(d, io=io), snapshot_interval=9)
        except p.CrashPoint:
            acked, issued = {}, set()
        else:
            acked, issued = _hammer(p, api, threads=4, per_thread=6)
        rec = _recover(p, d)
        recovered = _widgets_of(p, rec)
        for name, v in acked.items():
            assert recovered.get(("a", name)) == v, (kill_at, name)
        for (_ns, name) in recovered:
            assert name in issued, f"kill@{kill_at}: phantom record {name} recovered"
        _assert_watch_cache_coherent(p, rec)


def test_offlock_snapshot_serves_mutations_during_dump(tmp_path):
    """While a gated snapshot dump is parked mid-write, reads are served
    and new mutations ack durable; the record appended during the
    snapshot survives rotation and GC."""

    def scenario(p, d):
        entered, release = threading.Event(), threading.Event()

        class GatedSnapshotIO(p.FileIO):
            def write(self, f, data: bytes) -> None:
                if getattr(f, "name", "").endswith(".tmp"):  # the snapshot file
                    entered.set()
                    assert release.wait(timeout=30)
                super().write(f, data)

        api = _widget_api(p, p.WriteAheadLog(d, io=GatedSnapshotIO()), snapshot_interval=0)
        for i in range(5):
            api.create(_widget(f"pre{i}", i))
        done = []
        snap = threading.Thread(target=lambda: done.append(api.snapshot_now()))
        snap.start()
        assert entered.wait(timeout=10), "snapshot never reached its write"
        t0 = time.monotonic()
        api.create(_widget("during", 99))
        blocked = time.monotonic() - t0
        read = api.get("Widget", "pre0", "a")["spec"]["v"]
        release.set()
        snap.join(timeout=30)
        api.close()
        assert blocked < 5.0, f"create stalled {blocked:.1f}s behind the snapshot"
        got = _widgets_of(p, _recover(p, d))
        return {"snapshot_done": done == [None], "read": read, "during": got[("a", "during")],
                "widgets": len(got)}

    assert both(scenario, tmp_path) == {"snapshot_done": True, "read": 0, "during": 99,
                                        "widgets": 6}


# ---------------------------------------------------------------------------
# the cross-package case: one op script, the same objects and rvs


def _script_state(p, api) -> dict:
    """Every object of the script's kinds, minus what each package draws
    (uids, timestamps): kind, key, rv, spec, status, generation."""
    out = {}
    for kind in ("Widget", "Event"):
        for o in api.list(kind):
            m = o["metadata"]
            out[(kind, m.get("namespace", ""), m["name"] if kind != "Event" else
                 o["reason"])] = (m["resourceVersion"], m.get("generation"),
                                  o.get("spec"), o.get("status"))
    return out


def _op_script(api):
    for i in range(30):
        api.create(_widget(f"w{i}", i, ns="a" if i % 3 else "b"))
    for i in range(0, 30, 4):
        ns = "a" if i % 3 else "b"
        cur = api.get("Widget", f"w{i}", ns)
        cur["spec"]["v"] = -i
        api.update(cur)
        cur = api.get("Widget", f"w{i}", ns)
        cur["status"] = {"seen": i}
        api.update_status(cur)
    for i in range(1, 30, 5):
        api.delete("Widget", f"w{i}", "a" if i % 3 else "b")
    api.emit_event(api.get("Widget", "w2", "a"), "Touched", "once")
    api.patch("Widget", "w5", {"spec": {"v": 55}}, "a")


def test_one_op_script_recovers_the_same_objects_and_rvs_in_both(tmp_path):
    def scenario(p, d):
        wal = p.WriteAheadLog(d)
        api = _widget_api(p, wal, snapshot_interval=11)
        _op_script(api)
        live = _script_state(p, api)
        api.close()
        wal.close()
        rec = p.APIServer.recover(p.WriteAheadLog(d))
        assert _script_state(p, rec) == live
        return {"state": sorted(live.items()), "rv": rec._rv,
                "compacted": rec._compacted_rv, "applied": rec.applied_rv()}

    got = both(scenario, tmp_path)
    assert got["rv"] == got["applied"] > 40


def test_the_port_recovers_a_log_the_jax_package_wrote(tmp_path):
    """The record framing, the record and snapshot shapes are JAX's: the
    port's recovery of a JAX-written directory serves JAX's objects, uids
    and rvs included, and resumes a watch from the same window."""
    d = str(tmp_path / "wal")
    wal = J.WriteAheadLog(d)
    api = _widget_api(J, wal, snapshot_interval=11)
    _op_script(api)
    api.close()
    wal.close()
    want = J.APIServer.recover(J.WriteAheadLog(d))
    got = T.APIServer.recover(T.WriteAheadLog(d))
    for kind in ("Widget", "Event"):
        assert sorted(map(repr, got.list(kind))) == sorted(map(repr, want.list(kind)))
    assert (got._rv, got._compacted_rv) == (want._rv, want._compacted_rv)
    assert got.state_digest() == want.state_digest()
    floor = str(want._compacted_rv)
    wj, wt = want.watch("Widget", resource_version=floor), got.watch("Widget",
                                                                    resource_version=floor)
    ej, et = [], []
    while (item := wj.try_get()) is not None:
        ej.append((item[0], item[1]["metadata"]["resourceVersion"]))
    while (item := wt.try_get()) is not None:
        et.append((item[0], item[1]["metadata"]["resourceVersion"]))
    assert et == ej and et


# ---------------------------------------------------------------------------
# subsystem recovery: scheduling reservations and session receipts


def test_scheduling_reservations_rebuilt_from_recovered_store(tmp_path):
    def scenario(p, d):
        wal = p.WriteAheadLog(d)
        api = p.APIServer(wal=wal, snapshot_interval=6)
        p.scheduling.register_scheduling(api)
        for i in range(6):
            spec = ({"nodes": 2, "gpusPerNode": 4, "gpus": 8} if p.port else
                    {"hosts": 2, "chipsPerHost": 4, "chips": 8})
            wl = api.create({"kind": "Workload",
                             "metadata": {"name": f"gang{i}", "namespace": f"team{i % 2}"},
                             "spec": {**spec, "queue": f"team{i % 2}", "priority": i}})
            if i < 4:  # 4 admitted, 2 pending
                wl["status"] = {"state": "Admitted",
                                "assignment": {"nodes": [f"n{i}a", f"n{i}b"]}}
                api.update_status(wl)
        before = p.workload.admitted_reservations(api)
        api.close()
        wal.close()
        after = p.workload.admitted_reservations(p.APIServer.recover(p.WriteAheadLog(d)))
        assert after == before
        return {q: (b["workloads"], b["gpus" if p.port else "chips"], b["nodes"])
                for q, b in after.items()}

    got = both(scenario, tmp_path)
    assert set(got) == {"team0", "team1"} and got["team0"][1] == 16


def test_session_checkpoint_receipts_survive_restart(tmp_path):
    def scenario(p, d):
        wal = p.WriteAheadLog(d)
        api = p.APIServer(wal=wal, snapshot_interval=4)
        p.sessions.register_sessions(api)
        store = p.checkpoint.SessionCheckpointStore(d + "-ckpt", backend="json")
        receipt = store.save("uid-1", {"cells": [1, 2, 3], "counter": 7})
        notebook = {"kind": "Notebook", "metadata": {"name": "nb1", "namespace": "u1",
                                                     "uid": "uid-1"}}
        shell = (p.sessions.new_checkpoint(notebook, 4, "nvidia-l4", "4") if p.port else
                 p.sessions.new_checkpoint(notebook, chips=4, accel="tpu-v5e", topo="2x2"))
        ckpt = api.create(shell)
        ckpt["status"] = {"phase": "Checkpointed", "digest": receipt["digest"],
                          "checkpointStep": receipt["step"], "sizeBytes": receipt["sizeBytes"]}
        api.update_status(ckpt)
        api.close()
        wal.close()
        rec = p.APIServer.recover(p.WriteAheadLog(d))
        mgr = p.manager.SessionManager(rec, store=store, registry=p.prometheus.Registry())
        rows = [(r["ok"], r["detail"]) for r in mgr.verify_receipts()]
        store.delete("uid-1")
        lost = [r["ok"] for r in mgr.verify_receipts()]
        return {"rows": rows, "lost": lost}

    assert both(scenario, tmp_path) == {"rows": [(True, "bit-identical")], "lost": [False]}
