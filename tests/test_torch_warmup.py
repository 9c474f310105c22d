"""The port's warm-start subsystem against the JAX package's, on the CPU.

The compile cache (``warmup/compilecache.py``) on the kernels' build
directory: content-addressed hits and misses, singleflight, digest-
verified loads, TTL and LRU retention, zone-replicated artifacts, the
build-directory bridge (``ingest_dir`` / ``materialize_dir``) that a
cold notebook process and a warm one share, and
``install_process_cache`` moving this process's build directory. The
warm pools (``warmup/pool.py``): backfill at the negative backfill
priority, the atomic claim, reaping, zone kills, the JWA's warm handout
with the template state restored through the resume machinery, the
kubelet's simulated image pulls and the compile-cache mount. Each runs
through both packages (JAX's tests ``tests/test_warmup.py`` but those
that need ``machinery/wal.py``); the port's cache entries, claims,
checkpoints, phases and events must equal JAX's carried across (a v5e
2x2 slice is one L4 node of 4 GPUs; the template's compile topology,
JAX's TPU topology, is the L4's ``sm_89``). These run on the wall
clock, as JAX's do: a warm pool stamps ``lastSyncAt`` on every resync, so
a clock that moves a second a stamp would never let its status settle.
"""

from __future__ import annotations

import os
import threading

import pytest

from test_torch_sessions import (
    _OBSERVE, L4, L4_GPUS, NS, V5E, Env, _canonical_digest, scrub,
    to_port as _sessions_to_port)

PACKAGES = ("odh_kubeflow_tpu", "odh_kubeflow_tpu_torch")


def to_port(obj):
    """``test_torch_sessions.to_port`` plus the warm pool's template state:
    its compile-cache topology is the accelerator's architecture."""
    if isinstance(obj, dict):
        if "compileCache" in obj:
            obj = dict(obj, compileCache=dict(obj["compileCache"], topology="sm_89"))
        if {"notebook", "chips", "topology"} <= obj.keys() or "chipsPerHost" in obj:
            return _sessions_to_port(obj)
        return {_sessions_to_port(k): to_port(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(v) for v in obj)
    return _sessions_to_port(obj)


def cc_mod(port: bool):
    import importlib

    return importlib.import_module(f"{PACKAGES[port]}.warmup.compilecache")


def cache_service(port, tmp_path, zones="", **cfg):
    import importlib

    store = importlib.import_module(f"{PACKAGES[port]}.machinery.store")
    warmup = importlib.import_module(f"{PACKAGES[port]}.warmup")
    prom = importlib.import_module(f"{PACKAGES[port]}.utils.prometheus")
    cc = cc_mod(port)
    api = store.APIServer()
    warmup.register_warmup(api)
    root = tmp_path / PACKAGES[port]
    if zones:
        zones = ",".join(f"{z}={root / z}" for z in zones.split(","))
    registry = prom.Registry()
    svc = cc.CompileCacheService(
        api, cc.CompileCacheConfig(cache_dir=str(root / "cc"), zones=zones, **cfg),
        registry=registry)
    svc.test_registry = registry
    return svc, api, cc


def entries(api) -> dict:
    return {e["metadata"]["name"]: scrub({"spec": e["spec"], "status": e.get("status", {})})
            for e in api.list("CompileCacheEntry")}


def for_both(fn, tmp_path, **kw):
    """``fn(svc, api, cc)`` on JAX's compile cache and the port's; their
    returns must be equal (a cache entry's content is the same in both).
    Returns the port's."""
    out = []
    for port in (False, True):
        svc, api, cc = cache_service(port, tmp_path, **kw)
        out.append(fn(svc, api, cc))
    assert out[1] == out[0]
    return out[1]


# ---------------------------------------------------------------------------
# compile cache — the service


def test_compile_cache_miss_then_hit(tmp_path):
    from odh_kubeflow_tpu.utils.prometheus import lint_metric_names

    def run(svc, api, cc):
        key = cc.CompileKey("libint4_dequant-0123abcd.so", topology="sm_90a",
                            compiler_version="nvcc-12.8.93+torch-2.11.0")
        calls = []

        def compile_fn():
            calls.append(1)
            return b"cubin-bytes"

        got = [svc.get_or_compile(key, compile_fn), svc.get_or_compile(key, compile_fn)]
        return [got, len(calls), svc.m_hits.value(), svc.m_misses.value({"reason": "cold"}),
                key.entry_name, entries(api), lint_metric_names(svc.test_registry)]

    got = for_both(run, tmp_path)
    assert got[:4] == [[b"cubin-bytes"] * 2, 1, 1, 1]
    status = got[5][got[4]]["status"]
    assert status["sizeBytes"] == len(b"cubin-bytes") and got[6] == []


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
def test_singleflight_dedups_concurrent_builds(tmp_path, port):
    svc, _, cc = cache_service(port, tmp_path)
    key = cc.CompileKey("libgmm-feed.so", topology="sm_90a")
    builds = []
    gate = threading.Event()

    def compile_fn():
        builds.append(1)
        gate.wait(2.0)  # hold the leader so followers pile up
        return b"one-artifact"

    results: list = []
    threads = [threading.Thread(target=lambda: results.append(
        svc.get_or_compile(key, compile_fn))) for _ in range(8)]
    for t in threads:
        t.start()
    deadline = threading.Event()
    for _ in range(400):
        if svc.m_waits.value() >= 1:
            break
        deadline.wait(0.005)
    gate.set()
    for t in threads:
        t.join(timeout=5)
    assert len(builds) == 1, "singleflight must build exactly once"
    assert results == [b"one-artifact"] * 8
    assert svc.m_waits.value() >= 1


def test_corrupt_artifact_detected_and_rebuilt(tmp_path):
    def run(svc, api, cc):
        key = cc.CompileKey("libtgmm-1.so", topology="sm_90a")
        svc.put(key, b"good-bytes")
        with open(os.path.join(svc.root, f"{key.key_id}.bin"), "wb") as f:
            f.write(b"bitrot!!")
        out = [svc.load(key), entries(api)]
        calls = []
        out.append(svc.get_or_compile(key, lambda: calls.append(1) or b"fresh"))
        out += [calls, svc.load(key), svc.m_misses.value({"reason": "cold"})]
        return out

    got = for_both(run, tmp_path)
    assert got[0] is None and got[1] == {}  # never loaded; the lying entry purged
    assert got[2:5] == [b"fresh", [1], b"fresh"]


def test_gc_ttl_and_lru(tmp_path):
    def stamp(api, key, ts, mutable):
        entry = mutable(api.get("CompileCacheEntry", key.entry_name))
        entry["status"]["lastAccessAt"] = ts
        entry["status"]["createdAt"] = ts
        api.update_status(entry)

    def run_ttl(svc, api, cc):
        mutable = __import__(type(api).__module__.rsplit(".", 1)[0] + ".objects",
                             fromlist=["mutable"]).mutable
        old, fresh = cc.CompileKey("lib-old.so"), cc.CompileKey("lib-fresh.so")
        svc.put(old, b"o" * 8)
        svc.put(fresh, b"f" * 8)
        stamp(api, old, "2020-01-01T00:00:00Z", mutable)
        return [svc.gc(), svc.load(old), svc.load(fresh), svc.m_evictions.value({"reason": "ttl"})]

    assert for_both(run_ttl, tmp_path / "ttl", ttl_seconds=10.0, max_bytes=0) == [
        1, None, b"f" * 8, 1]

    def run_lru(svc, api, cc):
        mutable = __import__(type(api).__module__.rsplit(".", 1)[0] + ".objects",
                             fromlist=["mutable"]).mutable
        keys = [cc.CompileKey(f"lib-{i}.so") for i in range(3)]
        for i, k in enumerate(keys):
            svc.put(k, bytes([65 + i]) * 10)  # 30 bytes, budget 20
            stamp(api, k, f"2026-01-01T00:00:0{i}Z", mutable)
        svc.gc()
        return [svc.load(keys[0]), svc.load(keys[1]) is not None,
                svc.load(keys[2]) is not None, svc.m_bytes.value()]

    assert for_both(run_lru, tmp_path / "lru", ttl_seconds=0.0, max_bytes=20) == [
        None, True, True, 20]


def test_replicated_store_zone_loss_and_heal(tmp_path):
    def run(svc, api, cc):
        assert isinstance(svc.store, cc.ReplicatedArtifactStore)
        key = cc.CompileKey("libflash_fwd-1.so", topology="sm_90a")
        svc.put(key, b"replicated-bytes")
        out = [entries(api)]
        svc.store.fail_zone("za")
        out.append(svc.load(key))
        key2 = cc.CompileKey("libflash_bwd-1.so", topology="sm_90a")
        svc.put(key2, b"degraded-write")
        out.append(entries(api)[key2.entry_name]["status"])
        svc.store.heal_zone("za")
        out += [svc.heal_pass(), entries(api)[key2.entry_name]["status"],
                svc.store.stores["za"].load(key2.key_id)[0]]
        with open(os.path.join(svc.store.stores["zb"].root, f"{key.key_id}.bin"), "wb") as f:
            f.write(b"garbage")
        out.append(svc.load(key))
        return out

    got = for_both(run, tmp_path, zones="za,zb")
    status = next(iter(got[0].values()))["status"]
    assert sorted(status["zones"]) == ["za", "zb"] and not status["replicationDegraded"]
    assert got[1] == b"replicated-bytes"
    assert got[2]["zones"] == ["zb"] and got[2]["replicationDegraded"]
    assert got[3] == 1 and sorted(got[4]["zones"]) == ["za", "zb"]
    assert got[5] == b"degraded-write" and got[6] == b"replicated-bytes"


# ---------------------------------------------------------------------------
# the build-directory bridge


def _stage(directory, files: dict):
    os.makedirs(directory, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)


LIBS = {"libint4_dequant-aaaa.so": b"dequant cubin", "libflash_fwd-bbbb.so": b"flash cubin"}


def test_ingest_and_materialize_bridge_the_build_directory(tmp_path):
    """A cold process's build directory (its ``lib<name>-<hash>.so`` files,
    the file name the fingerprint; a library still being written is a dot
    file) enters the cache once; ``materialize_dir`` stages the
    digest-verified libraries for the next process, only for the same
    architecture and compiler."""
    def run(svc, api, cc):
        staging = svc.staging_dir("cold")
        _stage(staging, {**LIBS, ".libgmm-cccc.so.123.tmp": b"half a build"})
        out = [svc.ingest_dir(staging, topology="sm_90a", compiler_ver="v1"),
               svc.ingest_dir(staging, topology="sm_90a", compiler_ver="v1")]
        warm = os.path.join(svc.root, "..", "warm")
        out.append(svc.materialize_dir(warm, topology="sm_90a", compiler_ver="v1"))
        out.append({f: open(os.path.join(warm, f), "rb").read() for f in sorted(os.listdir(warm))})
        out.append(svc.materialize_dir(os.path.join(svc.root, "..", "w2"), topology="sm_89",
                                       compiler_ver="v1"))
        out.append(svc.stats())
        return out

    got = for_both(run, tmp_path)
    assert got[:3] == [2, 0, 2]
    assert got[3] == LIBS
    assert got[4] == 0 and got[5] == {"entries": 2, "bytes": 24, "degraded": 0}


def test_materialize_never_stages_a_corrupted_artifact(tmp_path):
    """One flipped byte in the stored artifact: ``materialize_dir`` into a
    fresh directory stages nothing, the failed load is recorded (the
    entry purged, a later lookup a miss) and the bad bytes are never
    written — the only guard before ``ops/_build.py`` loads a library
    whose file exists."""
    def run(svc, api, cc):
        staging = svc.staging_dir("cold")
        _stage(staging, {"libint4_dequant-aaaa.so": LIBS["libint4_dequant-aaaa.so"]})
        svc.ingest_dir(staging, topology="sm_90a", compiler_ver="v1")
        key = cc.CompileKey("libint4_dequant-aaaa.so", "sm_90a", "v1")
        path = os.path.join(svc.root, f"{key.key_id}.bin")
        data = bytearray(open(path, "rb").read())
        data[3] ^= 0x01
        open(path, "wb").write(bytes(data))
        fresh = os.path.join(svc.root, "..", "fresh")
        return [svc.materialize_dir(fresh, topology="sm_90a", compiler_ver="v1"),
                os.listdir(fresh), entries(api), os.path.exists(path),
                svc.get_or_compile(key, lambda: b"rebuilt"),
                svc.m_misses.value({"reason": "cold"})]

    assert for_both(run, tmp_path) == [0, [], {}, False, b"rebuilt", 1]


def test_materialize_writes_each_library_whole(tmp_path, monkeypatch):
    """Two processes may stage into one directory at once: each file is
    written to a dot temp name and moved into place, so a reader (or
    ``ops/_build.py``) never sees a partial library."""
    svc, _, cc = cache_service(True, tmp_path)
    staging = svc.staging_dir("cold")
    _stage(staging, LIBS)
    svc.ingest_dir(staging, topology="sm_90a", compiler_ver="v1")
    target = str(tmp_path / "shared")
    seen: list = []
    real_replace = os.replace

    def watching_replace(src, dst):
        seen.append((os.path.basename(src), sorted(os.listdir(target))))
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", watching_replace)
    threads = [threading.Thread(target=svc.materialize_dir, args=(target,),
                                kwargs={"topology": "sm_90a", "compiler_ver": "v1"})
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert all(src.startswith(".tmp-") for src, _ in seen) and len(seen) == 4
    for _, names in seen:  # before each move: whole libraries and dot files only
        assert all(n in LIBS or n.startswith(".tmp-") for n in names)
    assert {f: open(os.path.join(target, f), "rb").read()
            for f in os.listdir(target)} == LIBS


def test_compile_key_axes_name_the_build():
    from odh_kubeflow_tpu_torch.ops import _build
    from odh_kubeflow_tpu_torch.warmup import compilecache as cc

    assert cc.build_target() == "sm_90a"
    version = cc.compiler_version()
    assert version.startswith("nvcc-") and "+torch-" in version
    # the key is JAX's: the same three axes digest to the same entry name
    jax_key = cc_mod(False).CompileKey("libx-1.so", "sm_90a", version)
    assert cc.CompileKey("libx-1.so", "sm_90a", version).entry_name == jax_key.entry_name
    # the fingerprint is the library's own file name
    assert _build._target("int4_dequant").name.startswith("libint4_dequant-")


# ---------------------------------------------------------------------------
# install_process_cache: this process's build directory


@pytest.fixture
def build_dir():
    """Restore ``ops/_build.py``'s directory and loaded libraries after a
    test moves them."""
    from odh_kubeflow_tpu_torch.ops import _build

    saved, libs = _build.BUILD_DIR, dict(_build._libs)
    yield _build
    _build.BUILD_DIR = saved
    _build._libs.clear()
    _build._libs.update(libs)


def test_install_process_cache_moves_the_build_directory(tmp_path, monkeypatch, build_dir):
    from odh_kubeflow_tpu_torch.warmup.compilecache import install_process_cache

    monkeypatch.delenv("ODH_TORCH_KERNEL_CACHE", raising=False)
    before = build_dir.BUILD_DIR
    assert install_process_cache() is None and build_dir.BUILD_DIR == before
    target = str(tmp_path / "kernels")
    assert install_process_cache(target) == target
    assert os.path.isdir(target) and str(build_dir.BUILD_DIR) == target
    assert build_dir._target("int4_dequant").parent == build_dir.BUILD_DIR
    env_dir = str(tmp_path / "from-env")
    monkeypatch.setenv("ODH_TORCH_KERNEL_CACHE", env_dir)
    assert install_process_cache() == env_dir and str(build_dir.BUILD_DIR) == env_dir


def test_install_process_cache_refuses_a_switch_after_a_load(tmp_path, build_dir):
    """A library loaded from one directory pins the process there: a
    later switch raises (the process would hold kernels from two
    places); the same directory is accepted."""
    from odh_kubeflow_tpu_torch.warmup.compilecache import install_process_cache

    first = str(tmp_path / "first")
    install_process_cache(first)
    build_dir._libs["int4_dequant"] = object()  # as ``library()`` leaves it
    assert install_process_cache(first) == first
    with pytest.raises(RuntimeError, match="already loaded"):
        install_process_cache(str(tmp_path / "second"))
    assert str(build_dir.BUILD_DIR) == first


def test_install_process_cache_raises_on_an_unusable_directory(tmp_path, build_dir):
    """JAX's swallows every exception and returns None, so a warm start
    turns cold without a word; the port's raises."""
    from odh_kubeflow_tpu_torch.warmup.compilecache import install_process_cache

    (tmp_path / "a-file").write_text("")
    before = build_dir.BUILD_DIR
    with pytest.raises(OSError):
        install_process_cache(str(tmp_path / "a-file" / "kernels"))
    assert build_dir.BUILD_DIR == before
    jax_install = cc_mod(False).install_process_cache
    assert jax_install(str(tmp_path / "a-file" / "kernels")) is None


def test_decode_engine_and_trainer_install_the_cache(tmp_path, monkeypatch, build_dir):
    """``DecodeEngine(compile_cache_dir=)`` is accepted on the CPU, moves
    the build directory and serves the tokens of an engine without one;
    ``Trainer`` installs ``$ODH_TORCH_KERNEL_CACHE`` before anything
    builds."""
    import torch

    from odh_kubeflow_tpu_torch.models.engine import DecodeEngine
    from odh_kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer
    from test_torch_llama import TCFG, trees

    _, params = trees("f32", seed=3)
    kw = dict(n_slots=1, max_len=64, prompt_buckets=(16,), cache_dtype=torch.float32,
              device="cpu")
    tokens = []
    target = str(tmp_path / "engine-kernels")
    for cache_dir in (None, target):
        eng = DecodeEngine(params, TCFG, compile_cache_dir=cache_dir, **kw)
        try:
            tokens.append(eng.submit([5, 9, 13], max_tokens=4).result(120))
        finally:
            eng.stop()
    assert tokens[0] == tokens[1] and len(tokens[0]) == 4
    assert str(build_dir.BUILD_DIR) == target
    env_dir = str(tmp_path / "trainer-kernels")
    monkeypatch.setenv("ODH_TORCH_KERNEL_CACHE", env_dir)
    Trainer(TCFG, TrainConfig(), device="cpu")
    assert str(build_dir.BUILD_DIR) == env_dir


# ---------------------------------------------------------------------------
# warm pools — the platform


def warm_pool(env, size=1, image="jax:latest"):
    if env.port:
        return env.pool_mod.new_warm_pool("wp", NS, size=size, accelerator=L4,
                                          count=str(L4_GPUS), image=image)
    return env.pool_mod.new_warm_pool("wp", NS, size=size, accelerator=V5E, topology="2x2",
                                      image=image)


def claim(env, **kw):
    accel = L4 if env.port else V5E
    return env.pool_mod.claim_standby(env.api, NS, accelerator=accel, **kw)


def pool_status(env):
    return env.api.get("WarmPool", "wp", NS).get("status") or {}


def spawn_body(env, name, image="jax:latest"):
    body = {"name": name, "image": image, "cpu": "1", "memory": "2Gi",
            "workspaceVolume": None, "dataVolumes": []}
    if env.port:
        body["gpus"] = {"accelerator": L4, "count": str(L4_GPUS)}
    else:
        body["tpus"] = {"accelerator": V5E, "topology": "2x2"}
    return body


def both_warm(scenario, tmp_path, **env_kw):
    logs = []
    for port in (False, True):
        env, log = Env(port, tmp_path, warm=True, **env_kw), {}

        def record(key, value=_OBSERVE, env=env, log=log):
            log[key] = scrub(env.observe() if value is _OBSERVE else value)

        try:
            scenario(env, record)
        finally:
            env.close()
        logs.append(log)
    want, got = to_port(logs[0]), logs[1]
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == want[key], key
    return got


def test_warm_pool_backfills_to_size_at_backfill_priority(tmp_path):
    from odh_kubeflow_tpu.utils.prometheus import lint_metric_names

    def scenario(env, log):
        env.api.create(warm_pool(env, size=2))
        log("ready", env.converge(lambda: pool_status(env).get("readyStandbys") == 2,
                                  warm=True))
        log("pool", [pool_status(env), env.api.get("PriorityClass", "warm-pool-backfill")[
            "value"], env.warm.m_ready.value({"pool": "wp"})])
        log("obs")
        pool = env.objects.mutable(env.api.get("WarmPool", "wp", NS))
        pool["spec"]["size"] = 1
        env.api.update(pool)
        log("scaled", env.converge(lambda: len(env.api.list("Notebook", namespace=NS)) == 1,
                                   warm=True))
        log("lint", lint_metric_names(env.registry))

    got = both_warm(scenario, tmp_path, pools=2)
    assert got["ready"] is True and got["scaled"] is True and got["lint"] == []
    assert got["pool"][1:] == [-100, 2]
    assert set(got["obs"]["notebooks"]) == {"wp-standby-0", "wp-standby-1"}
    for wl in got["obs"]["workloads"].values():
        assert wl["spec"]["priority"] == -100
        assert wl["spec"]["priorityClassName"] == "warm-pool-backfill"


def test_concurrent_claims_hand_out_exactly_one_standby(tmp_path):
    def scenario(env, log):
        env.api.create(warm_pool(env))
        env.converge(lambda: pool_status(env).get("readyStandbys") == 1, warm=True)
        results: list = []
        barrier = threading.Barrier(8)

        def racer(i):
            barrier.wait()
            results.append(claim(env, claimant=f"spawner-{i}"))

        threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=5)
        wins = [r for r in results if r is not None]
        log("claims", [len(results), len(wins), wins[0]["pool"], wins[0]["standby"],
                       wins[0].get("nodePool", wins[0].get("slicePool"))])
        log("claimed", env.warmup.is_claimed(env.api.get("Notebook", "wp-standby-0", NS)))
        log("late", claim(env))

    got = both_warm(scenario, tmp_path)
    assert got["claims"] == [8, 1, "wp", "wp-standby-0", "pool-0"]
    assert got["claimed"] is True and got["late"] is None


def test_claimed_standby_reaped_after_grace_and_backfilled(tmp_path):
    def scenario(env, log):
        env.api.create(warm_pool(env))
        env.converge(lambda: pool_status(env).get("readyStandbys") == 1, warm=True)
        log("claimed", claim(env, claimant="crashed") is not None)
        log("healed", env.converge(lambda: pool_status(env).get("readyStandbys") == 1 and not any(
            env.warmup.is_claimed(nb) for nb in env.api.list("Notebook", namespace=NS)),
            warm=True))
        log("reaps", env.warm.m_reaps.value({"reason": "claimed"}) >= 1)

    got = both_warm(scenario, tmp_path, pools=2, grace=0.0)
    assert got == {"claimed": True, "healed": True, "reaps": True}


def test_zone_kill_drains_standbys_and_backfills_surviving_zone(tmp_path):
    def scenario(env, log):
        env.api.create(warm_pool(env, size=2))
        log("ready", env.converge(lambda: pool_status(env).get("readyStandbys") == 2,
                                  rounds=80, warm=True))
        log("placed", sorted(w["status"]["assignment"]["zone"]
                             for w in env.api.list("Workload")))
        log("killed", env.cluster.kill_zone("zone-a"))
        got = claim(env, claimant="mid-kill")
        if got is not None:
            pod = env.api.get("Pod", f"{got['standby']}-0", NS)
            log("mid-kill", [got["standby"], pod["status"]["phase"]])
            env.api.delete("Notebook", got["standby"], NS)
        log("survivor", env.converge(
            lambda: pool_status(env).get("readyStandbys") == 2
            and pool_status(env).get("zones") == ["zone-b"], rounds=120, warm=True))
        log("obs")

    got = both_warm(scenario, tmp_path, zones={"zone-a": 2, "zone-b": 2})
    assert got["ready"] is True and got["killed"] and got["survivor"] is True
    assert got.get("mid-kill", ["", "Running"])[1] == "Running"


def test_jwa_spawn_claims_standby_and_restores_template_state(tmp_path):
    """The warm handout: a JWA POST claims the Ready standby, deletes it,
    lands on the node pool it freed and gets the pool's template state
    restored through the resume machinery before ready."""
    def scenario(env, log):
        jwa = env.JupyterWebApp(env.api, registry=env.registry)
        env.api.create(warm_pool(env))
        env.converge(lambda: pool_status(env).get("readyStandbys") == 1, warm=True)
        freed = env.api.get("Workload", "wp-standby-0", NS)["status"]["assignment"]["pool"]
        resp = jwa.create_notebook(NS, spawn_body(env, "warm-nb"), "u")
        log("spawned", [resp.status, env.api.get("Notebook", "warm-nb", NS)["metadata"][
            "annotations"].get(env.warmup.WARM_FROM_ANNOTATION)])
        log("standby_gone", [n["metadata"]["name"] for n in env.api.list("Notebook",
                                                                          namespace=NS)])

        def restored():
            ck = env.ckpt("warm-nb")
            return bool(ck) and ck.get("status", {}).get("phase") == "Restored"

        log("restored", env.converge(restored, rounds=80, warm=True))
        wl = env.api.get("Workload", "warm-nb", NS)
        log("placed", [wl["spec"]["preferredPool"] == freed,
                       wl["status"]["assignment"]["pool"] == freed])
        log("kernel", env.kernel("warm-nb"))
        row = jwa._warm_row(env.api.get("Notebook", "warm-nb", NS))
        log("row", [row["pool"], row["standby"], bool(row["claimedAt"]), row["restored"]])
        ck = env.ckpt("warm-nb")
        log("receipt", [ck["status"]["digest"] == _canonical_digest(env.kernel("warm-nb")),
                        ck["spec"]])

    got = both_warm(scenario, tmp_path)
    assert got["spawned"] == [201, "wp"] and got["standby_gone"] == ["warm-nb"]
    assert got["restored"] is True and got["placed"] == [True, True]
    assert got["kernel"] == {"warmpool": "wp", "preheated": True,
                             "compileCache": {"topology": "sm_89", "staged": []}}
    assert got["row"] == ["wp", "wp-standby-0", True, True]
    assert got["receipt"][0] is True


def test_jwa_spawn_cold_path_when_no_pool_matches(tmp_path):
    def scenario(env, log):
        jwa = env.JupyterWebApp(env.api, registry=env.registry)
        env.api.create(warm_pool(env))
        env.converge(lambda: pool_status(env).get("readyStandbys") == 1, warm=True)
        resp = jwa.create_notebook(NS, spawn_body(env, "cold-nb", image="other:latest"), "u")
        nb = env.api.get("Notebook", "cold-nb", NS)
        log("cold", [resp.status, env.warmup.WARM_FROM_ANNOTATION in nb["metadata"][
            "annotations"], env.warmup.is_claimed(env.api.get("Notebook", "wp-standby-0", NS)),
            jwa._warm_row(nb)])

    assert both_warm(scenario, tmp_path, pools=2)["cold"] == [201, False, False, None]


def test_template_state_lists_the_cache_entries_of_the_pools_architecture(tmp_path):
    """The template kernel state carries the compile-cache manifest: the
    entries built for the pool accelerator's architecture (``sm_89`` for
    an L4 pool; an ``sm_90a`` entry is not listed)."""
    env = Env(True, tmp_path, warm=True)
    try:
        for fp, topo in (("libint4_dequant-a.so", "sm_89"), ("libflash_fwd-b.so", "sm_90a")):
            env.cc.put(env.compilecache.CompileKey(fp, topo, "v1"), b"bytes")
        env.api.create(warm_pool(env))
        env.warm_tick()
        loaded, _ = env.store.load("warmpool-team-a-wp-template")
        assert loaded["compileCache"] == {"topology": "sm_89",
                                          "staged": ["libint4_dequant-a.so"]}
    finally:
        env.close()


# ---------------------------------------------------------------------------
# the kubelet's image pulls and the compile-cache mount


def test_sim_image_pull_gates_cold_start_and_warm_node_skips_it(tmp_path):
    import time as _time

    def scenario(env, log):
        env.cluster.image_pull_seconds = 0.15
        jwa = env.JupyterWebApp(env.api, registry=env.registry)
        seen = []
        for name in ("cold-nb", "warm2-nb"):
            assert jwa.create_notebook(NS, spawn_body(env, name), "u").status == 201
            pulling = False
            deadline = _time.monotonic() + 10
            while _time.monotonic() < deadline:
                env.quiesce(rounds=1)
                try:
                    pod = env.api.get("Pod", f"{name}-0", NS)
                except env.store_mod.NotFound:
                    continue
                msgs = [c.get("message", "") for c in pod["status"].get("conditions", [])]
                pulling |= any("pulling image" in m for m in msgs)
                if pod["status"].get("phase") == "Running":
                    break
                threading.Event().wait(0.02)
            node = env.api.get("Pod", f"{name}-0", NS)["spec"]["nodeName"]
            seen.append([pulling, "jax:latest" in env.cluster.node_images(node)])
            if name == "cold-nb":
                env.api.delete("Notebook", name, NS)
                env.quiesce(rounds=4)
        log("pulls", seen)

    assert both_warm(scenario, tmp_path)["pulls"] == [[True, True], [False, True]]


def test_compile_cache_mount_lands_in_statefulset_env(tmp_path):
    """The mount sets the kernels' build directory: ``ODH_TORCH_KERNEL_CACHE``
    where JAX's sets ``JAX_COMPILATION_CACHE_DIR``."""
    def scenario(env, log):
        env.create("nb")
        env.quiesce()
        sts = env.api.get("StatefulSet", "nb", NS)
        env_vars = {e["name"]: e.get("value", "")
                    for e in sts["spec"]["template"]["spec"]["containers"][0]["env"]}
        name = "ODH_TORCH_KERNEL_CACHE" if env.port else "JAX_COMPILATION_CACHE_DIR"
        log("mount", env_vars[name])

    assert both_warm(scenario, tmp_path, compile_cache_mount="/cache/kernels")["mount"] == (
        "/cache/kernels")


def test_compile_cache_mount_wins_over_the_gpu_runtime_poddefault(tmp_path):
    """Both set the kernels' build directory on a GPU notebook's pod: the
    compile-cache mount (the notebook controller's, on the container)
    wins, and the PodDefault's workspace directory stays the default of
    a pod without a mount. JAX's admission refuses such a pod (its
    TPU-runtime PodDefault and the mount both set
    ``JAX_COMPILATION_CACHE_DIR``, a merge conflict)."""
    results = {}
    for port in (False, True):
        for mount in ("", "/cache/kernels"):
            env = Env(port, tmp_path / f"{port}-{bool(mount)}", compile_cache_mount=mount)
            try:
                if port:
                    from odh_kubeflow_tpu_torch.webhooks import (
                        PodDefaultWebhook, gpu_runtime_poddefault)

                    env.api.create(gpu_runtime_poddefault(NS))
                    name, label = "ODH_TORCH_KERNEL_CACHE", "gpu-runtime"
                else:
                    from odh_kubeflow_tpu.webhooks import PodDefaultWebhook
                    from odh_kubeflow_tpu.webhooks.poddefault import tpu_runtime_poddefault

                    env.api.create(tpu_runtime_poddefault(NS))
                    name, label = "JAX_COMPILATION_CACHE_DIR", "tpu-runtime"
                PodDefaultWebhook(env.api).register()
                nb = env.notebook("nb")
                nb["spec"]["template"]["metadata"] = {"labels": {label: "enabled"}}
                env.api.create(nb)
                try:
                    env.quiesce()
                    pod = env.api.get("Pod", "nb-0", NS)
                    results[port, mount] = {e["name"]: e.get("value") for e in pod["spec"][
                        "containers"][0]["env"]}.get(name)
                except Exception as e:  # noqa: BLE001 — JAX's admission refusal is the finding
                    results[port, mount] = type(e).__name__
            finally:
                env.close()
    from odh_kubeflow_tpu_torch.webhooks.poddefault import KERNEL_CACHE_DIR

    assert results[True, ""] == KERNEL_CACHE_DIR
    assert results[True, "/cache/kernels"] == "/cache/kernels"
    assert results[False, ""] not in (None, "MergeConflict")
    assert results[False, "/cache/kernels"] == "MergeConflict"


def test_platform_sessions_phase_drives_the_fleet_on_a_stub_process(tmp_path):
    """``chip_smoke.platform_sessions_phase``'s control plane on the CPU
    (on the wall clock, as the phase runs on the card):
    the cold standby's build ingested, the warm handout, the suspend that
    frees a node to the 8-GPU gang, the resume restored before ready and
    the corrupted artifact never staged — each notebook process a stub
    that "builds" the dequant library into its kernel directory when it
    is missing (the card runs ``--notebook-serve`` there)."""
    import chip_smoke
    from odh_kubeflow_tpu_torch.ops import _build

    lib = _build._target("int4_dequant").name

    def stub(label, env, kernel_dir, scratch):
        before = chip_smoke.dir_state(kernel_dir)
        built = []
        if lib not in before:
            os.makedirs(kernel_dir, exist_ok=True)
            with open(os.path.join(kernel_dir, lib), "wb") as f:
                f.write(b"a built library")
            built = ["int4_dequant"]
        return {"kernel_dir": kernel_dir, "before": before,
                "after": chip_smoke.dir_state(kernel_dir), "imported_s": 0.0,
                "service_s": 0.0, "first_token_s": 0.0, "process_s": 0.0, "first": [1],
                "tokens": list(range(16)), "built": built, "build_dir": kernel_dir,
                "device": "stub", "launches": chip_smoke.LAUNCHES_PER_FORWARD * 19}

    record, launches = chip_smoke.platform_sessions_phase(run_notebook=stub)
    assert record["nvcc_runs"] == {"cold": 1, "warm": 0, "resumed": 0}
    assert record["cache"]["entries"] == [{"fingerprint": lib, "topology": "sm_90a",
                                           "compilerVersion": record["compiler"]}]
    assert record["cache"]["corrupt"] == {"staged": 0, "files": [], "entries": 0,
                                          "artifact_kept": False}
    assert record["suspend"]["quota"]["suspended"] == "1"
    assert record["suspend"]["gang_waited"]["reason"] == "SliceBusy"
    assert record["resume"]["digest_equal"] is True
    assert launches == 3 * chip_smoke.LAUNCHES_PER_FORWARD * 19
