"""The port's leader election (``machinery/leader.py``), the store's
fencing and the client's token throttle, held to the JAX package's.

Every case of ``tests/test_leader.py`` runs as one scenario on both
packages under one injected clock; the scenario keeps its JAX assertions
and returns what it observed (holders, ``leaseTransitions``, fencing
tokens, whole Lease specs, which writes were fenced), and the two records
must be equal. ``pkg`` is the shared lazy two-package module table of
the high-availability tests (``test_torch_{replica,informer,promotion,
runner,platform_failover}.py``).
"""

import hashlib
import importlib
import json
import time

import pytest

ROOTS = {"jax": "odh_kubeflow_tpu", "torch": "odh_kubeflow_tpu_torch"}
_MODULES = {
    "apis": "apis",
    "store": "machinery.store",
    "leader": "machinery.leader",
    "replica": "machinery.replica",
    "promoter": "machinery.promoter",
    "runner": "machinery.runner",
    "cache": "machinery.cache",
    "client": "machinery.client",
    "httpapi": "machinery.httpapi",
    "faults": "machinery.faults",
    "objects": "machinery.objects",
    "runtime": "controllers.runtime",
    "notebook": "controllers.notebook",
    "prometheus": "utils.prometheus",
    "overload": "machinery.overload",
    "scheduling": "scheduling",
}


class _Pkg:
    """One package's modules by short name, imported on first use."""

    def __init__(self, name: str):
        self.name = name

    def __getattr__(self, short: str):
        mod = importlib.import_module(f"{ROOTS[self.name]}.{_MODULES[short]}")
        setattr(self, short, mod)
        return mod


_PKGS = {}


def pkg(name: str) -> _Pkg:
    if name not in _PKGS:
        _PKGS[name] = _Pkg(name)
    return _PKGS[name]


def both(scenario, *args):
    """Run ``scenario(m, *args)`` on each package; returns (jax, torch)."""
    return scenario(pkg("jax"), *args), scenario(pkg("torch"), *args)


# per-object identity that each store draws for itself
_VOLATILE = {"uid", "creationTimestamp", "deletionTimestamp", "firstTimestamp",
             "lastTimestamp", "eventTime", "odh.kubeflow.org/trace-id"}


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def state_view(api) -> str:
    """sha256 over every applied object with the fields each store draws
    for itself (uids, wall-clock stamps, trace ids) removed: two
    packages' stores that saw the same writes have equal views. Within
    one package ``state_digest`` is compared as is."""
    out = []
    for kind in sorted(api._types):
        for o in api.list(kind):
            out.append(_scrub(json.loads(json.dumps(o))))
    return hashlib.sha256(json.dumps(out, sort_keys=True).encode()).hexdigest()


LEASE = "notebook-controller-leader"


def _mk(m, api, ident, now_fn=time.time, **kw):
    return m.leader.LeaderElector(
        api,
        LEASE,
        namespace="default",
        identity=ident,
        lease_duration=10.0,
        renew_period=0.1,
        retry_period=0.05,
        now_fn=now_fn,
        **kw,
    )


def _spec(api):
    return dict(api.get("Lease", LEASE, "default")["spec"])


def _fenced(m, fn) -> str:
    try:
        fn()
    except m.store.FencedOut:
        return "FencedOut"
    return "applied"


def first_caller_acquires_second_waits(m):
    clock = {"t": 1000.0}
    api = m.store.APIServer()
    a = _mk(m, api, "pod-a", now_fn=lambda: clock["t"])
    b = _mk(m, api, "pod-b", now_fn=lambda: clock["t"])
    got = [a.try_acquire(), b.try_acquire(), a.try_acquire()]
    assert got == [True, False, True]
    spec = _spec(api)
    assert spec["holderIdentity"] == "pod-a"
    return got, spec, a.token, b.token


def expired_lease_is_taken_over_with_transition_bump(m):
    clock = {"t": 1000.0}
    api = m.store.APIServer()
    a = _mk(m, api, "pod-a", now_fn=lambda: clock["t"])
    b = _mk(m, api, "pod-b", now_fn=lambda: clock["t"])
    assert a.try_acquire()
    clock["t"] += 600.0
    assert b.try_acquire() is True
    spec = _spec(api)
    assert spec["holderIdentity"] == "pod-b"
    assert spec["leaseTransitions"] == 1
    assert a.try_acquire() is False
    return spec, a.token, b.token


def release_allows_immediate_takeover(m):
    clock = {"t": 1000.0}
    api = m.store.APIServer()
    a = _mk(m, api, "pod-a", now_fn=lambda: clock["t"])
    b = _mk(m, api, "pod-b", now_fn=lambda: clock["t"])
    assert a.try_acquire()
    a.release()
    released = _spec(api)
    assert b.try_acquire() is True
    spec = _spec(api)
    assert spec["holderIdentity"] == "pod-b"
    return released, spec, b.token


def renew_loop_detects_loss(m):
    api = m.store.APIServer()
    a = _mk(m, api, "pod-a")
    assert a.try_acquire()
    lost = []
    a.run(on_lost=lambda: lost.append(True))
    lease = api.get("Lease", LEASE, "default")
    lease["spec"]["holderIdentity"] = "intruder"
    api.update(lease)
    deadline = time.time() + 5
    while not lost and time.time() < deadline:
        time.sleep(0.02)
    a._stop.set()
    assert lost
    return bool(lost), _spec(api)["holderIdentity"]


def leader_failover_under_injected_faults(m):
    api = m.store.APIServer()
    inj = m.faults.FaultInjector(
        api,
        seed=5,
        schedule=m.faults.FaultSchedule.none(),
        registry=m.prometheus.Registry(),
        sleep_fn=lambda s: None,
    )
    lease_duration = 1.0
    kw = dict(namespace="default", lease_duration=lease_duration,
              renew_period=0.05, retry_period=0.02)
    holder = m.leader.LeaderElector(inj, LEASE, identity="holder", **kw)
    standby = m.leader.LeaderElector(api, LEASE, identity="standby", **kw)
    assert holder.try_acquire()
    lost = []
    holder.run(on_lost=lambda: lost.append(time.monotonic()))
    t0 = time.monotonic()
    inj.set_offline(True)
    took_over = False
    while time.monotonic() < t0 + 10 * lease_duration:
        if standby.try_acquire():
            took_over = True
            break
        time.sleep(0.02)
    took = time.monotonic() - t0
    assert took_over and lease_duration * 0.5 <= took < 4 * lease_duration
    inj.set_offline(False)
    stop_at = time.monotonic() + 5
    while not lost and time.monotonic() < stop_at:
        time.sleep(0.02)
    assert lost
    assert standby.try_acquire() is True
    assert holder.try_acquire() is False
    holder._stop.set()
    spec = _spec(api)
    return spec["holderIdentity"], spec["leaseTransitions"], spec["fencingToken"]


def _notebook_api(m, clock):
    api = m.store.APIServer()
    api.fence_now_fn = lambda: clock["t"]
    api.register_kind("kubeflow.org/v1", "Notebook", "notebooks")
    return api


def deposed_holder_in_flight_write_is_fenced(m):
    clock = {"t": 1000.0}
    api = _notebook_api(m, clock)
    api.create({"kind": "Notebook", "metadata": {"name": "nb", "namespace": "u1"},
                "spec": {"owner": "nobody"}})
    a = _mk(m, api, "pod-a", now_fn=lambda: clock["t"])
    b = _mk(m, api, "pod-b", now_fn=lambda: clock["t"])
    assert a.try_acquire() and a.token == 1
    in_flight = api.get("Notebook", "nb", "u1")
    in_flight["spec"]["owner"] = "pod-a"
    clock["t"] += 600.0
    assert b.try_acquire() and b.token == 2

    def stale():
        with a.fence():
            api.update(in_flight)

    out = [_fenced(m, stale)]
    assert out == ["FencedOut"]
    assert api.get("Notebook", "nb", "u1")["spec"]["owner"] == "nobody"
    fresh = api.get("Notebook", "nb", "u1")
    fresh["spec"]["owner"] = "pod-b"

    def live():
        with b.fence():
            api.update(fresh)

    out.append(_fenced(m, live))
    assert api.get("Notebook", "nb", "u1")["spec"]["owner"] == "pod-b"
    return out, _spec(api), state_view(api)


def expired_lease_fences_even_without_takeover(m):
    clock = {"t": 1000.0}
    api = _notebook_api(m, clock)
    api.create({"kind": "Notebook", "metadata": {"name": "nb", "namespace": "u1"}})
    a = _mk(m, api, "pod-a", now_fn=lambda: clock["t"])
    assert a.try_acquire()
    obj = api.get("Notebook", "nb", "u1")
    obj["spec"] = {"x": 1}
    clock["t"] += 600.0

    def expired():
        with a.fence():
            api.update(obj)

    out = [_fenced(m, expired)]
    assert out == ["FencedOut"]
    assert a.try_acquire()

    def again():
        with a.fence():
            api.update(api.get("Notebook", "nb", "u1") | {"spec": {"x": 2}})

    out.append(_fenced(m, again))
    assert api.get("Notebook", "nb", "u1")["spec"] == {"x": 2}
    return out, a.token, _spec(api)


def fenced_write_propagates_lease_deletion(m):
    clock = {"t": 1000.0}
    api = _notebook_api(m, clock)
    api.create({"kind": "Notebook", "metadata": {"name": "nb", "namespace": "u1"}})
    a = _mk(m, api, "pod-a", now_fn=lambda: clock["t"])
    assert a.try_acquire()
    api.delete("Lease", LEASE, "default")

    def deleted():
        with m.leader.fenced("default", LEASE, a.token):
            api.delete("Notebook", "nb", "u1")

    out = _fenced(m, deleted)
    assert out == "FencedOut"
    api.delete("Notebook", "nb", "u1")
    return out, state_view(api)


def _member(m, api, ident, clock):
    return m.leader.ShardMembership(
        api, "mgr", identity=ident, namespace="default", lease_duration=10.0,
        renew_period=0.05, now_fn=lambda: clock["t"],
    )


def shard_members_partition_namespaces_disjointly_and_agree(m):
    clock = {"t": 1000.0}
    api = m.store.APIServer()
    members = [_member(m, api, f"r{i}", clock) for i in (1, 2, 3)]
    assert all(x.join() for x in members)
    assert members[0].members(fresh=True) == ["r1", "r2", "r3"]
    namespaces = [f"ns{i}" for i in range(60)]
    for ns in namespaces:
        assert len({x.owner_of(ns) for x in members}) == 1
    slices = [sorted(ns for ns in namespaces if x.owns(ns)) for x in members]
    assert set().union(*map(set, slices)) == set(namespaces)
    assert sum(map(len, slices)) == len(namespaces)
    assert all(len(s) >= 5 for s in slices)
    return slices, [x.token for x in members]


def shard_reshard_moves_only_the_dead_members_slice(m):
    clock = {"t": 1000.0}
    api = m.store.APIServer()
    m1, m2, m3 = (_member(m, api, f"r{i}", clock) for i in (1, 2, 3))
    assert m1.join() and m2.join() and m3.join()
    namespaces = [f"ns{i}" for i in range(60)]
    before = {ns: m1.owner_of(ns, m1.members(fresh=True)) for ns in namespaces}
    clock["t"] += 600.0
    assert m1.join() and m2.join()
    assert m1.members(fresh=True) == ["r1", "r2"]
    after = {ns: m1.owner_of(ns, m1.members(fresh=True)) for ns in namespaces}
    for ns in namespaces:
        if before[ns] != "r3":
            assert after[ns] == before[ns]
        else:
            assert after[ns] in ("r1", "r2")
    return before, after


def shard_rejoin_after_expiry_starts_a_new_epoch(m):
    clock = {"t": 1000.0}
    api = m.store.APIServer()
    api.fence_now_fn = lambda: clock["t"]
    m1 = _member(m, api, "r1", clock)
    assert m1.join()
    first = m1.token
    clock["t"] += 600.0
    assert m1.join()
    assert m1.token == first + 1
    return first, m1.token


def shard_membership_change_callback_fires_on_expiry(m):
    clock = {"t": 1000.0}
    api = m.store.APIServer()
    m1 = _member(m, api, "r1", clock)
    m2 = _member(m, api, "r2", clock)
    assert m1.join() and m2.join()
    changes = []
    m1.add_on_change(lambda old, new: changes.append((old, new)))
    m1._check_membership_change()
    clock["t"] += 600.0
    assert m1.join()
    m1._check_membership_change()
    assert changes and changes[-1] == (["r1", "r2"], ["r1"])
    return changes


def client_qps_throttle_paces_requests(m):
    client = m.client.RemoteAPIServer("http://127.0.0.1:1", qps=50.0, burst=5)
    t0 = time.monotonic()
    for _ in range(5):
        client._throttle()
    burst_ok = time.monotonic() - t0 < 0.05
    t0 = time.monotonic()
    for _ in range(10):
        client._throttle()
    paced = time.monotonic() - t0
    assert burst_ok and 0.1 < paced < 1.0
    return burst_ok, 0.1 < paced < 1.0


SCENARIOS = [
    first_caller_acquires_second_waits,
    expired_lease_is_taken_over_with_transition_bump,
    release_allows_immediate_takeover,
    renew_loop_detects_loss,
    leader_failover_under_injected_faults,
    deposed_holder_in_flight_write_is_fenced,
    expired_lease_fences_even_without_takeover,
    fenced_write_propagates_lease_deletion,
    shard_members_partition_namespaces_disjointly_and_agree,
    shard_reshard_moves_only_the_dead_members_slice,
    shard_rejoin_after_expiry_starts_a_new_epoch,
    shard_membership_change_callback_fires_on_expiry,
    client_qps_throttle_paces_requests,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_leader_scenario_equal_on_both(scenario):
    jax_rec, torch_rec = both(scenario)
    assert torch_rec == jax_rec


@pytest.mark.parametrize("members", [3, 4, 5])
def test_hrw_owners_equal_for_200_namespaces(members):
    """The rendezvous owner of every namespace is the same on both
    packages, so a mixed fleet never splits a namespace."""
    ids = [f"replica-{i}" for i in range(members)]
    namespaces = [f"team-{i}" for i in range(200)]
    owners = {}
    for name in ("jax", "torch"):
        m = pkg(name)
        clock = {"t": 1000.0}
        api = m.store.APIServer()
        ms = [_member(m, api, i, clock) for i in ids]
        assert all(x.join() for x in ms)
        owners[name] = [ms[0].owner_of(ns) for ns in namespaces]
        assert owners[name] == [ms[-1].owner_of(ns) for ns in namespaces]
        assert [m.leader._hrw_weight(i, ns) for i in ids for ns in namespaces[:20]] == [
            pkg("jax").leader._hrw_weight(i, ns) for i in ids for ns in namespaces[:20]
        ]
    assert owners["torch"] == owners["jax"]
    assert len(set(owners["torch"])) == members


def test_lease_expiry_rule_equal():
    """``lease_expired`` is the one freshness rule the elector, the shard
    heartbeat and the promotion watchdog share."""
    spec = lambda renew, dur: {"spec": {"renewTime": renew, "leaseDurationSeconds": dur}}
    fmt = pkg("torch").leader._fmt_micro
    cases = [None, {}, spec("garbage", 10), spec(fmt(1000.0), 10), spec(fmt(1000.0), 0)]
    for now in (1000.0, 1009.9, 1010.1, 5000.0):
        got = [pkg(n).leader.lease_expired(c, now) for n in ("jax", "torch") for c in cases]
        assert got[: len(cases)] == got[len(cases):]
    assert pkg("torch").leader._fmt_micro(1000.25) == pkg("jax").leader._fmt_micro(1000.25)
