"""The port's multi-zone failure domains against the JAX package's, on the
CPU: zone-replicated checkpoints, zone-aware placement and the
checkpoint-then-migrate zone drain.

JAX's ``tests/test_zones.py`` up to its promotion and replica-fanout
tests (which need the control plane's leader election and replication,
ROADMAP.md) runs through both packages: the replicated store's
write-all receipts, reads from any surviving zone and heals; the pools'
zone and spot labels flowing into the recorded assignment; zone spread
with the on-demand preference; ``drain_zone`` suspending the session to
its replicated checkpoint and resuming it in the surviving zone
bit-identical; NodeLost storms escalating into a drain; the zone-kill
drill without fault injection (``machinery/faults.py`` waits); degraded
checkpoints healing. JAX's receipts, placements, checkpoint phases and
zones, and scheduler decisions, carried across by
``test_torch_sessions.to_port``, must equal the port's.
"""

from __future__ import annotations

import random

import pytest

from test_torch_sessions import (  # noqa: F401 — the shared clock's fixtures
    NS, Env, _canonical_digest, _hold_clock, both, shared_clock)

SEED = 20260804
ZONES = ("zone-a", "zone-b")


def zone_env(**kw):
    kw.setdefault("zones", ZONES)
    return dict(replicated=True, zone_heal_retry_seconds=0.01, **kw)


def stores(tmp_path):
    """JAX's replicated store and the port's over the same zone spec."""
    from odh_kubeflow_tpu.sessions import checkpoint as jax_ck
    from odh_kubeflow_tpu_torch.sessions import checkpoint as port_ck

    return [mod.ReplicatedCheckpointStore(
        mod.parse_zone_spec("zone-a,zone-b", str(tmp_path / name)), backend="json")
        for name, mod in (("jax", jax_ck), ("port", port_ck))]


def on_both(fn, tmp_path):
    out = [fn(store) for store in stores(tmp_path)]
    assert out[1] == out[0]
    return out[1]


# ---------------------------------------------------------------------------
# the replicated checkpoint store


def test_replicated_store_write_all_receipts_and_heal(tmp_path):
    def run(store):
        out = [store.save("uid-1", {"cells": [1, 2, 3]})]
        out.append([store.stores[z].load("uid-1")[1] for z in ZONES])
        store.fail_zone("zone-b")
        r2 = store.save("uid-1", {"cells": [4]})
        out += [r2, store.replication_status("uid-1", r2["digest"])]
        store.heal_zone("zone-b")
        out += [store.heal("uid-1", r2["digest"]), store.stores["zone-b"].load("uid-1")[1]]
        return out

    got = on_both(run, tmp_path)
    receipt = got[0]
    assert receipt["zones"] == list(ZONES) and receipt["degraded"] is False
    assert got[1] == [receipt["digest"]] * 2
    assert got[2]["zones"] == ["zone-a"] and got[2]["degraded"] is True
    assert got[3]["missing"] == ["zone-b"] and got[3]["degraded"]
    assert got[4] == {"zones": list(ZONES), "missing": [], "degraded": False}
    assert got[5] == got[2]["digest"] == _canonical_digest({"cells": [4]})


def test_replicated_store_reads_newest_from_surviving_zone(tmp_path):
    def run(store):
        store.save("u", {"v": 1})
        store.fail_zone("zone-b")
        r2 = store.save("u", {"v": 2})
        store.heal_zone("zone-b")
        out = [store.load("u", expect_digest=r2["digest"])]
        store.fail_zone("zone-a")
        stale = store.load("u", expect_digest=r2["digest"])
        out.append([stale[0], stale[1] != r2["digest"]])
        store.fail_zone("zone-b")
        out.append(store.load("u"))
        return out

    got = on_both(run, tmp_path)
    assert got[0] == ({"v": 2}, _canonical_digest({"v": 2}))
    assert got[1] == [{"v": 1}, True] and got[2] is None


def test_replicated_store_delete_incomplete_while_zone_dark(tmp_path):
    def run(store):
        store.save("u", {"v": 1})
        store.fail_zone("zone-b")
        out = [store.delete("u")]
        store.heal_zone("zone-b")
        out += [store.stores["zone-b"].exists("u"), store.delete("u"), store.exists("u")]
        return out

    assert on_both(run, tmp_path) == [False, True, True, False]


def test_replicated_store_on_the_torch_backend(tmp_path):
    """The port's default backend under replication: the receipts JAX's
    JSON backend writes, read back from the surviving zone."""
    from odh_kubeflow_tpu_torch.sessions.checkpoint import (
        ReplicatedCheckpointStore, parse_zone_spec)

    port = ReplicatedCheckpointStore(parse_zone_spec("zone-a,zone-b", str(tmp_path / "p")),
                                     backend="torch")
    jax = stores(tmp_path)[0]
    for state in ({"cells": [1]}, {"cells": [1, 2]}):
        assert port.save("u", state) == jax.save("u", state)
    port.fail_zone("zone-a")
    assert port.load("u") == ({"cells": [1, 2]}, _canonical_digest({"cells": [1, 2]}))
    port.close()


def test_parse_zone_spec_paths_and_subdirs(tmp_path):
    from odh_kubeflow_tpu.sessions.checkpoint import parse_zone_spec as jax_parse
    from odh_kubeflow_tpu_torch.sessions.checkpoint import parse_zone_spec

    for spec, root in ((f"zone-a={tmp_path}/pvc-a, zone-b", str(tmp_path / "root")),
                       ("", "/x"), ("a,b=/v/b,,c", "/r")):
        assert parse_zone_spec(spec, root) == jax_parse(spec, root)
    spec = parse_zone_spec(f"zone-a={tmp_path}/pvc-a, zone-b", str(tmp_path / "root"))
    assert spec["zone-a"] == f"{tmp_path}/pvc-a" and spec["zone-b"].endswith("root/zone-b")


# ---------------------------------------------------------------------------
# zone-aware placement


def test_zone_labels_flow_inventory_to_assignment(tmp_path):
    def scenario(env, log):
        pools = env.queue.SliceInventory.snapshot(env.api).pools
        log("pools", sorted((p.name, p.zone, p.spot) for p in pools.values()))
        log("zones", sorted(env.queue.SliceInventory.snapshot(env.api).zones()))
        env.create("nb-assign")
        env.quiesce()
        log("obs")

    _, got = both(scenario, tmp_path, **zone_env(spot_pool_zone="zone-b"))
    assert got["pools"] == [("zone-a-pool-0", "zone-a", False),
                            ("zone-b-pool-0", "zone-b", False),
                            ("zone-b-spot", "zone-b", True)]
    assert got["zones"] == list(ZONES)
    assignment = got["obs"]["workloads"]["nb-assign"]["status"]["assignment"]
    assert assignment["pool"].startswith(assignment["zone"])


def test_zone_spread_and_on_demand_preference(tmp_path):
    def scenario(env, log):
        for i in range(3):
            env.create(f"nb-{i}")
            env.quiesce()
        log("obs")

    _, got = both(scenario, tmp_path, **zone_env(spot_pool_zone="zone-a"))
    assignments = [got["obs"]["workloads"][f"nb-{i}"]["status"]["assignment"]
                   for i in range(3)]
    assert {a["zone"] for a in assignments[:2]} == set(ZONES)
    assert not any(a["pool"].endswith("-spot") for a in assignments[:2])
    assert assignments[2]["pool"] == "zone-a-spot" and assignments[2]["spot"] is True


def test_drain_zone_checkpoint_then_migrate(tmp_path):
    state = {"cells": ["x = 42", "train()"], "counter": 7}

    def scenario(env, log):
        env.create("nb-live")
        env.quiesce()
        src = env.api.get("Workload", "nb-live", NS)["status"]["assignment"]["zone"]
        log("src", src)
        env.cluster.set_session_state(NS, "nb-live", state)
        env.scheduler.drain_zone(src)
        env.quiesce(rounds=10)
        log("obs")
        log("drained", env.scheduler.drained_zones())
        log("metrics", env.metrics("zone_", "workload_preemptions_total"))
        env.scheduler.undrain_zone(src)
        log("undrained", env.scheduler.drained_zones())

    _, got = both(scenario, tmp_path, **zone_env())
    src, obs = got["src"], got["obs"]
    dst = "zone-b" if src == "zone-a" else "zone-a"
    assert obs["workloads"]["nb-live"]["status"]["assignment"]["zone"] == dst
    assert obs["kernels"]["nb-live-0"] == state
    ck = obs["checkpoints"]["nb-live"]["status"]
    assert ck["digest"] == _canonical_digest(state) and ck["zones"] == list(ZONES)
    assert any(e[1] == "ZoneMigration" for e in obs["events"])
    assert got["drained"] == {src: "operator"} and got["undrained"] == {}
    assert got["metrics"]['workload_preemptions_total{reason="suspend"}'] == 1
    assert got["metrics"]["zone_migrations_total"] == 1


def test_drained_zone_excluded_from_new_admissions(tmp_path):
    def scenario(env, log):
        env.scheduler.drain_zone("zone-a")
        env.create("nb-new")
        env.quiesce()
        log("nb-new", env.api.get("Workload", "nb-new", NS)["status"])
        env.scheduler.drain_zone("zone-b")
        env.create("nb-blocked")
        env.quiesce()
        log("obs")

    _, got = both(scenario, tmp_path, **zone_env())
    assert got["nb-new"]["assignment"]["zone"] == "zone-b"
    wls = got["obs"]["workloads"]
    assert wls["nb-blocked"]["status"]["state"] == "Pending"
    assert wls["nb-blocked"]["status"]["reason"] == "ZoneDrained"


def test_node_lost_storm_escalates_to_zone_drain(tmp_path):
    def scenario(env, log):
        for i in range(3):
            env.create(f"nb-{i}")
            env.quiesce()
        zone_of = {f"nb-{i}": env.api.get("Workload", f"nb-{i}", NS)["status"]["assignment"]
                   for i in range(3)}
        storm = "zone-a" if sum(a["zone"] == "zone-a" for a in zone_of.values()) >= 2 \
            else "zone-b"
        hit = [n for n, a in sorted(zone_of.items()) if a["zone"] == storm][:2]
        for name in hit:
            for node in zone_of[name]["nodes"]:
                env.cluster.preempt_node(node)
        env.quiesce(rounds=8)
        log("storm", storm)
        log("drained", env.scheduler.drained_zones())
        log("obs")

    _, got = both(scenario, tmp_path, **zone_env(pools_per_zone=3))
    assert got["drained"].get(got["storm"]) == "node-storm"
    for wl in got["obs"]["workloads"].values():
        if wl["status"].get("state") == "Admitted":
            assert wl["status"]["assignment"]["zone"] != got["storm"]


# ---------------------------------------------------------------------------
# the zone-kill drill and degraded checkpoints


def test_zone_kill_drill_sessions_resume_in_surviving_zone(tmp_path):
    """Seeded sessions across two zones, two of them suspended to their
    replicated checkpoints; then one zone's nodes AND its checkpoint
    store arm die in the same instant (``machinery/faults.kill_zone``'s
    two steps). Every suspended session resumes in the surviving zone
    with digest-verified bit-identical state."""
    def scenario(env, log):
        rng = random.Random(SEED)
        names = [f"nb-{i}" for i in range(4)]
        for name in names:
            env.create(name)
        log("up", env.converge(lambda: all(env.running(n) for n in names), rounds=40))
        states = {}
        for name in names:
            states[name] = {"cells": [f"cell-{rng.randrange(1 << 30)}" for _ in range(3)],
                            "seed": rng.randrange(1 << 30)}
            env.cluster.set_session_state(NS, name, states[name])
        suspended = sorted(rng.sample(names, 2))
        for name in suspended:
            env.suspend(name)
        env.quiesce(rounds=8)
        log("checkpointed", [env.ckpt(n)["status"] for n in suspended])
        log("killed", env.cluster.kill_zone("zone-a"))
        env.store.fail_zone("zone-a")
        env.quiesce(rounds=10)
        for name in suspended:
            env.resume(name)
        env.quiesce(rounds=10)
        log("restored", env.converge(lambda: all(
            env.running(n) and env.kernel(n) == states[n] for n in suspended), rounds=60))
        log("obs")
        log("replication", [env.store.replication_status(
            env.ckpt(n)["spec"]["notebookUID"], env.ckpt(n)["status"]["digest"])
            for n in suspended])

    _, got = both(scenario, tmp_path, **zone_env(pools_per_zone=4))
    assert got["up"] is True and got["restored"] is True and got["killed"]
    assert all(s["zones"] == list(ZONES) for s in got["checkpointed"])
    for wl in got["obs"]["workloads"].values():
        if wl["status"].get("assignment"):
            assert wl["status"]["assignment"]["zone"] == "zone-b"
    assert all("zone-b" in r["zones"] for r in got["replication"])


@pytest.mark.parametrize("resume_first", [False, True])
def test_degraded_checkpoint_rereplicates_on_zone_heal(tmp_path, resume_first):
    """A checkpoint written while a zone is dark is degraded; when the
    zone heals it re-replicates — also when the session was resumed
    before the heal (resume must not freeze ``replicationDegraded``)."""
    def scenario(env, log):
        env.create("nb")
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", {"k": "v"})
        env.store.fail_zone("zone-b")
        env.suspend("nb")
        env.quiesce(rounds=8)
        log("degraded", env.ckpt("nb")["status"])
        if resume_first:
            env.resume("nb")
            env.quiesce(rounds=10)
            log("kernel", env.kernel("nb"))
        env.store.heal_zone("zone-b")
        log("healed", env.converge(
            lambda: env.ckpt("nb")["status"]["replicationDegraded"] is False, rounds=40))
        ck = env.ckpt("nb")
        log("zone-b", env.store.stores["zone-b"].load(ck["spec"]["notebookUID"])[1]
            == ck["status"]["digest"])
        log("obs")

    _, got = both(scenario, tmp_path, **zone_env())
    assert got["degraded"]["zones"] == ["zone-a"]
    assert got["degraded"]["replicationDegraded"] is True
    assert got["healed"] is True and got["zone-b"] is True
    assert got["obs"]["checkpoints"]["nb"]["status"]["zones"] == list(ZONES)
    if resume_first:
        assert got["kernel"] == {"k": "v"}
