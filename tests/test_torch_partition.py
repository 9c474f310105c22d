"""The port's partitioned write path (``machinery/partition.py``) held to
the JAX package's.

Every case of ``tests/test_partition.py`` runs as one scenario on both
packages (``m``, ``test_torch_overload.wire``'s module table) and returns what it
observed: owners, merged walks, watch deliveries, 410 restarts, frozen
windows, move statistics and the scrubbed ``state_view`` of the stores.
The two records must be equal wherever the scenario is deterministic; the
live move under concurrent writers races threads, so each package must
lose no acked write and the deterministic part of its record must agree.
Also here: ``partition_of`` against JAX's for 1,000 namespaces at N = 1…8,
the merged watch's per-partition floor and isolated 410
(``tests/test_fleet.py``), the router's overload defense
(``tests/test_overload.py``), and a partitioned store replicated across
the two packages in both directions, over ``?partition=`` pulls.
"""

import threading
import time

import pytest

from test_torch_leader import state_view
from test_torch_overload import wire

SEED = 18


def both(scenario, *args):
    return scenario(wire("jax"), *args), scenario(wire("torch"), *args)


def _router(m, n=3, **kwargs):
    router = m.partition.build_partitions(n, **kwargs)
    router.register_kind("kubeflow.org/v1beta1", "Notebook", "notebooks")
    return router


def _nb(ns, name, v=0):
    return {"kind": "Notebook", "metadata": {"name": name, "namespace": ns}, "spec": {"v": v}}


def _fill(router, namespaces, per_ns=4):
    keys = []
    for ns in namespaces:
        for i in range(per_ns):
            router.create(_nb(ns, f"nb-{i:03d}", i))
            keys.append((ns, f"nb-{i:03d}"))
    return sorted(keys)


def _key(o):
    return (o["metadata"]["namespace"], o["metadata"]["name"])


def _views(router):
    return [state_view(b) for _, b in sorted(router.backends.items())]


# ---------------------------------------------------------------------------
# assignment


@pytest.mark.parametrize("n", range(1, 9))
def test_partition_of_agrees_with_jax(n):
    namespaces = [f"ns-{i:04d}" for i in range(1000)]
    jax_owners, torch_owners = both(
        lambda m: [m.partition.partition_of(ns, n) for ns in namespaces])
    assert torch_owners == jax_owners
    assert set(torch_owners) == set(range(n))


def assignment_spreads_and_resize_moves_only_to_the_new_partition(m):
    namespaces = [f"user-{i}" for i in range(400)]
    at4 = {ns: m.partition.partition_of(ns, 4) for ns in namespaces}
    counts = [list(at4.values()).count(p) for p in range(4)]
    assert all(c > 0 for c in counts)
    assert max(counts) < 3 * min(counts)
    at5 = {ns: m.partition.partition_of(ns, 5) for ns in namespaces}
    moved = {ns for ns in namespaces if at4[ns] != at5[ns]}
    assert all(at5[ns] == 4 for ns in moved)
    assert 0.10 < len(moved) / len(namespaces) < 0.35
    assert all(m.partition.partition_of(ns, 1) == 0 for ns in namespaces[:10])
    return counts, sorted(moved)


def partition_map_overrides_are_the_exception_list(m):
    pmap = m.partition.PartitionMap(4)
    ns = "team-a"
    home = pmap.owner_of(ns)
    other = (home + 1) % 4
    pmap.override(ns, other)
    assert pmap.owner_of(ns) == other and pmap.overrides() == {ns: other}
    pmap.override(ns, home)
    assert pmap.owner_of(ns) == home and pmap.overrides() == {}
    with pytest.raises(m.store.Invalid):
        pmap.override(ns, 4)
    return home, other


# ---------------------------------------------------------------------------
# routing & redirects


def writes_route_to_owner_and_cluster_kinds_pin_to_partition_zero(m):
    router = _router(m, 3)
    router.register_kind("kubeflow.org/v1", "Profile", "profiles", namespaced=False)
    namespaces = [f"team-{i}" for i in range(6)]
    _fill(router, namespaces, per_ns=2)
    where = {}
    for ns in namespaces:
        p = router.owner_of(ns)
        assert len(router.backends[p].list("Notebook", namespace=ns)) == 2
        for q in router.backends:
            if q != p:
                assert not router.backends[q].list("Notebook", namespace=ns)
        where[ns] = p
    router.create({"kind": "Profile", "metadata": {"name": "prof-a"}, "spec": {}})
    assert router.backends[0].get("Profile", "prof-a")
    assert router.get("Profile", "prof-a")
    return where, router.applied_rvs(), _views(router)


def unowned_partition_answers_307_with_the_leader_url(m):
    backends = {i: m.store.APIServer() for i in range(3)}
    for b in backends.values():
        b.register_kind("kubeflow.org/v1beta1", "Notebook", "notebooks")
    urls = {i: f"http://leader-{i}:8443" for i in range(3)}
    router = m.partition.PartitionRouter(backends, owned={0}, urls=urls)
    foreign = next(ns for ns in (f"team-{i}" for i in range(64)) if router.owner_of(ns) != 0)
    with pytest.raises(m.store.NotLeader) as ei:
        router.create(_nb(foreign, "nb"))
    assert ei.value.leader_url == urls[router.owner_of(foreign)]
    owned_ns = next(ns for ns in (f"team-{i}" for i in range(64)) if router.owner_of(ns) == 0)
    created = router.create(_nb(owned_ns, "nb"))
    with pytest.raises(m.store.Invalid):
        m.partition.PartitionRouter({1: m.store.APIServer()})
    return foreign, ei.value.leader_url, owned_ns, created["metadata"]["resourceVersion"]


# ---------------------------------------------------------------------------
# merged lists


def _walk(router, limit, mid_page=None):
    seen, token, pages = [], "", 0
    while True:
        items, token = router.list_chunk("Notebook", limit=limit, continue_token=token)
        assert len(items) <= limit
        seen += [_key(o) for o in items]
        pages += 1
        if mid_page is not None:
            mid_page(pages, token)
        if not token:
            return seen, pages


def merged_list_walk_is_ordered_and_exact(m, limit):
    router = _router(m, 3)
    keys = _fill(router, [f"team-{i}" for i in range(9)], per_ns=3)
    seen, pages = _walk(router, limit)
    assert seen == keys
    # the unpaged cluster list and a namespaced page agree with the walk
    assert [_key(o) for o in router.list("Notebook")] == keys
    assert [_key(o) for o in router.list("Notebook", limit=limit)] == keys[:limit]
    ns_items, ns_token = router.list_chunk("Notebook", namespace="team-4", limit=2)
    assert [_key(o) for o in ns_items] == [k for k in keys if k[0] == "team-4"][:2]
    assert not m.partition.is_composite_token(ns_token)
    return seen, pages


def merged_list_under_mid_walk_writers_never_skips_or_dups_stable_rows(m):
    router = _router(m, 4)
    stable = _fill(router, [f"team-{i}" for i in range(8)], per_ns=3)
    counter = iter(range(10_000))

    def churn(pages, token):
        i = next(counter)
        router.create(_nb(f"team-{i % 8}", f"zz-new-{i:04d}"))

    seen, pages = _walk(router, 5, mid_page=churn)
    for ns in {k[0] for k in seen}:
        in_ns = [k for k in seen if k[0] == ns]
        assert in_ns == sorted(in_ns)
    assert len(seen) == len(set(seen))
    assert [k for k in seen if not k[1].startswith("zz-new-")] == stable
    return seen, pages


def merged_list_one_partitions_410_restarts_only_that_leg(m):
    router = _router(m, 3)
    stable = _fill(router, [f"team-{i}" for i in range(9)], per_ns=4)
    items, token = router.list_chunk("Notebook", limit=5)
    assert token
    victim = router.owner_of("team-0")
    router.backends[victim].WATCH_CACHE_SIZE = 4
    for i in range(30):
        nb = router.get("Notebook", "nb-000", "team-0")
        nb["spec"]["v"] = 1000 + i
        router.update(nb)
    assert router.backends[victim]._compacted_rv > 0
    seen = [_key(o) for o in items]
    while token:
        items, token = router.list_chunk("Notebook", limit=5, continue_token=token)
        seen += [_key(o) for o in items]
    assert sorted(set(seen)) == stable and len(seen) == len(set(seen))
    # a single-partition token is not a fleet token
    _, plain = router.backends[0].list_chunk("Notebook", limit=1)
    with pytest.raises(m.store.BadRequest):
        router.list_chunk("Notebook", limit=1, continue_token=plain)
    return seen, victim, router.backends[victim]._compacted_rv


# ---------------------------------------------------------------------------
# merged watches


def _drain(w):
    got, controls = [], []
    for etype, obj in iter(w.try_get, None):
        if etype == "CONTROL":
            controls.append(obj)
        else:
            got.append((etype, _key(obj), int(obj["metadata"]["resourceVersion"])))
    return got, controls


def merged_watch_delivers_each_partition_exactly_once_in_rv_order(m):
    router = _router(m, 3)
    namespaces = [f"team-{i}" for i in range(9)]
    owners = {ns: router.owner_of(ns) for ns in namespaces}
    w = router.watch("Notebook")
    acked = []
    for i in range(90):
        ns = namespaces[i % len(namespaces)]
        out = router.create(_nb(ns, f"nb-{i:04d}", i))
        acked.append((owners[ns], int(out["metadata"]["resourceVersion"])))
    got, _ = _drain(w)
    w.stop()
    pairs = [(owners[k[0]], rv) for _, k, rv in got]
    assert sorted(pairs) == sorted(acked)
    per = {}
    for p, rv in pairs:
        assert rv > per.get(p, 0)
        per[p] = rv
    return got


def merged_watch_scalar_resume_is_rejected_composite_accepted(m):
    router = _router(m, 2)
    router.create(_nb("team-0", "nb"))
    with pytest.raises(m.store.Invalid):
        router.watch("Notebook", resource_version="7")
    w = router.watch("Notebook")
    first, _ = _drain(w)
    token = w.resume_token()
    rvs = w.resume_rvs()
    w.stop()
    assert m.partition.decode_fleet_rvs(token, "Notebook") == rvs
    with pytest.raises(m.store.BadRequest):
        m.partition.decode_fleet_rvs(token, "Pod")
    w2 = router.watch("Notebook", resource_version=token)
    assert w2.try_get() is None
    router.create(_nb("team-1", "nb"))
    got, _ = _drain(w2)
    w2.stop()
    assert [(e, k[1]) for e, k, _ in got] == [("ADDED", "nb")]
    return first, rvs, got


def merged_watch_resume_at_each_partition_floor_and_isolated_410(m):
    router = m.partition.build_partitions(3)
    router.register_kind("kubeflow.org/v1beta1", "Notebook", "notebooks")
    for b in router.backends.values():
        b.WATCH_CACHE_SIZE = 16
    namespaces = [f"team-{i}" for i in range(9)]
    owners = {ns: router.owner_of(ns) for ns in namespaces}
    assert set(owners.values()) == {0, 1, 2}
    for i in range(120):
        router.create(_nb(namespaces[i % 9], f"nb-{i:04d}", i))
    for i in range(120):
        nb = router.get("Notebook", f"nb-{i:04d}", namespaces[i % 9])
        nb["spec"]["v"] = -i
        router.update(nb)
    floors = {p: b._compacted_rv for p, b in router.backends.items()}
    assert all(f > 0 for f in floors.values())
    retained = {p: [erv for erv, *_ in b._event_log] for p, b in router.backends.items()}

    def collect(w):
        got, controls = _drain(w)
        per = {p: [] for p in router.backends}
        for _, k, rv in got:
            per[owners[k[0]]].append(rv)
        return per, controls

    w = router.watch("Notebook",
                     resource_version=m.partition.encode_fleet_rvs("Notebook", floors))
    got, controls = collect(w)
    w.stop()
    assert not [c for c in controls if c.get("expired")]
    assert got == retained
    bad = dict(floors)
    bad[0] = floors[0] - 1
    w = router.watch("Notebook", resource_version=m.partition.encode_fleet_rvs("Notebook", bad))
    got, controls = collect(w)
    assert w.expired_partitions == {0}
    assert [c["partition"] for c in controls if c.get("expired")] == [0]
    assert got[0] == [] and got[1] == retained[1] and got[2] == retained[2]
    live_ns = next(ns for ns, p in owners.items() if p == 1)
    out = router.create(_nb(live_ns, "after-410"))
    late, _ = _drain(w)
    w.stop()
    assert [k for _, k, _ in late] == [(live_ns, "after-410")]
    return floors, got, out["metadata"]["resourceVersion"]


# ---------------------------------------------------------------------------
# fleet digest and frozen window


def fleet_digest_composes_per_partition_digests(m):
    a = _router(m, 3)
    _fill(a, [f"team-{i}" for i in range(6)], per_ns=2)
    digests = a.partition_digests()
    assert [p for p, *_ in digests] == [0, 1, 2]
    assert a.state_digest() == m.store.APIServer.compose_digests(digests)
    before = a.state_digest()
    nb = a.get("Notebook", "nb-000", "team-0")
    nb["spec"]["v"] = 999
    a.update(nb)
    assert a.state_digest() != before
    assert a.applied_rv() == sum(a.applied_rvs().values())
    control = a.replication_control()
    with pytest.raises(m.store.Invalid):
        a.replication_cut()
    return ([(p, rv) for p, _, rv in digests], a.applied_rvs(), _views(a),
            [(c["partition"], c["rv"], c["epoch"]) for c in control["partitions"]],
            a.kind_version("Notebook"))


def frozen_namespace_answers_retryable_429_until_unfrozen(m):
    router = _router(m, 2)
    router.create(_nb("team-0", "nb"))
    router.freeze("team-0")
    with pytest.raises(m.store.TooManyRequests) as ei:
        router.create(_nb("team-0", "nb2"))
    assert ei.value.retry_after == router.move_retry_after
    other = next(ns for ns in (f"x-{i}" for i in range(32))
                 if router.owner_of(ns) != router.owner_of("team-0"))
    router.create(_nb(other, "nb3"))
    assert router.quiesce_writes("team-0", timeout=0.1)
    router.unfreeze("team-0")
    assert router.create(_nb("team-0", "nb2"))
    return other, ei.value.retry_after, _views(router)


# ---------------------------------------------------------------------------
# live moves


def live_move_loses_zero_acked_writes_under_concurrent_writers(m):
    router = _router(m, 3)
    ns = "moving-team"
    src = router.owner_of(ns)
    dst = (src + 1) % 3
    for i in range(20):
        router.create(_nb(ns, f"pre-{i:04d}", i))
    acked, refused, stop = [], [], threading.Event()

    def writer(wid):
        i = 0
        while not stop.is_set():
            name = f"live-{wid}-{i:05d}"
            try:
                router.create(_nb(ns, name, i))
            except m.store.TooManyRequests as e:
                refused.append(name)
                time.sleep(min(e.retry_after, 0.01))
                continue
            acked.append(name)
            i += 1
            time.sleep(0.0005)  # paced: the mover's catch-up must be able to win

    threads = [threading.Thread(target=writer, args=(wid,)) for wid in range(3)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.05)
        stats = m.partition.PartitionMover(router, ns, dst).run()
        time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert router.owner_of(ns) == dst
    assert stats["shipped"] >= 20 and stats["to"] == dst
    lost = [n for n in [f"pre-{i:04d}" for i in range(20)] + acked
            if _missing(router, m, n, ns)]
    assert lost == [], lost
    in_dst = {o["metadata"]["name"] for o in router.backends[dst].list("Notebook", namespace=ns)}
    assert set(acked) <= in_dst
    assert not router.backends[src].list("Notebook", namespace=ns)
    assert router.create(_nb(ns, "post-move"))
    assert router.backends[dst].get("Notebook", "post-move", ns)
    return {"src": src, "dst": dst, "lost": lost, "scrubbed_source": True,
            "stats_keys": sorted(stats), "overrides": router._map.overrides(),
            "acked": len(acked) > 0}


def _missing(router, m, name, ns) -> bool:
    try:
        router.get("Notebook", name, ns)
        return False
    except m.store.NotFound:
        return True


def move_to_current_owner_is_a_noop(m):
    router = _router(m, 2)
    router.create(_nb("team-0", "nb"))
    return m.partition.PartitionMover(router, "team-0", router.owner_of("team-0")).run()


def concurrent_movers_for_one_namespace_fence_each_other(m):
    router = _router(m, 3)
    ns = "contested"
    src = router.owner_of(ns)
    dst = (src + 1) % 3
    for i in range(4):
        router.create(_nb(ns, f"nb-{i}", i))
    slow = m.partition.PartitionMover(router, ns, dst)
    stale_token = slow._acquire_move_token(router.backends[dst])
    fast = m.partition.PartitionMover(router, ns, dst)
    stats = fast.run()
    assert router.owner_of(ns) == dst
    with m.leader.fenced(m.partition.MOVE_LEASE_NS, slow.lease_name, stale_token):
        with pytest.raises(m.store.FencedOut):
            router.backends[dst].import_object(_nb(ns, "stale-apply"))
    with pytest.raises(m.store.NotFound):
        router.backends[dst].get("Notebook", "stale-apply", ns)
    stats = {k: v for k, v in stats.items() if not k.endswith("_ms")}
    return stale_token, stats, _views(router)


def move_kill_point_sweep_over_destination_wal(m, tmp_path):
    """Process death at every destination-WAL IO op in turn, mid-move:
    recovery and an idempotent re-run finish the move with every acked
    write present once. The record holds, per kill point, whether the
    move died and both partitions' scrubbed states."""
    ns = "drilled"
    root = tmp_path / m.name

    def scenario(dst_io, tag):
        probe = _router(m, 2)
        src = probe.owner_of(ns)
        dst = 1 - src

        def factory(i):
            d = str(root / f"run-{tag}-p{i}")
            return m.wal.WriteAheadLog(d, io=dst_io) if i == dst else m.wal.WriteAheadLog(d)

        router = _router(m, 2, wal_factory=factory)
        acked = []
        for i in range(6):
            router.create(_nb(ns, f"nb-{i:03d}", i))
            acked.append(f"nb-{i:03d}")
        return router, src, dst, acked

    probe_io = m.faults.KillPointIO(10**9, seed=SEED)
    router, src, dst, acked = scenario(probe_io, "probe")
    m.partition.PartitionMover(router, ns, dst).run()
    total_io = probe_io.ops
    assert total_io > 5
    router.close()
    outcomes = []
    for kill_at in range(1, total_io + 1):
        io = m.faults.KillPointIO(kill_at, seed=SEED * 1000 + kill_at)
        try:
            router, src, dst, acked = scenario(io, kill_at)
        except m.wal.CrashPoint:
            outcomes.append((kill_at, "before"))
            continue
        died = False
        try:
            m.partition.PartitionMover(router, ns, dst).run()
        except (m.wal.CrashPoint, Exception):  # noqa: BLE001 — or the fail-stopped WAL's refusal
            died = True
        if died:
            d = str(root / f"run-{kill_at}-p{dst}")
            backends = dict(router.backends)
            backends[dst] = m.store.APIServer.recover(m.wal.WriteAheadLog(d))
            router = m.partition.PartitionRouter(backends)
            m.partition.PartitionMover(router, ns, dst).run()
        assert router.owner_of(ns) == dst
        served = {o["metadata"]["name"]
                  for o in router.backends[dst].list("Notebook", namespace=ns)}
        assert served == set(acked), (kill_at, sorted(served))
        for name in acked:
            assert router.get("Notebook", name, ns)
        assert not router.backends[src].list("Notebook", namespace=ns)
        outcomes.append((kill_at, died, sorted(served),
                         state_view(router.backends[src]), state_view(router.backends[dst])))
        router.close()
    return total_io, outcomes


SCENARIOS = [
    assignment_spreads_and_resize_moves_only_to_the_new_partition,
    partition_map_overrides_are_the_exception_list,
    writes_route_to_owner_and_cluster_kinds_pin_to_partition_zero,
    unowned_partition_answers_307_with_the_leader_url,
    merged_list_under_mid_walk_writers_never_skips_or_dups_stable_rows,
    merged_list_one_partitions_410_restarts_only_that_leg,
    merged_watch_delivers_each_partition_exactly_once_in_rv_order,
    merged_watch_scalar_resume_is_rejected_composite_accepted,
    merged_watch_resume_at_each_partition_floor_and_isolated_410,
    fleet_digest_composes_per_partition_digests,
    frozen_namespace_answers_retryable_429_until_unfrozen,
    live_move_loses_zero_acked_writes_under_concurrent_writers,
    move_to_current_owner_is_a_noop,
    concurrent_movers_for_one_namespace_fence_each_other,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_partition_scenario_equal_on_both(scenario):
    jax_rec, torch_rec = both(scenario)
    assert torch_rec == jax_rec


@pytest.mark.parametrize("limit", [1, 3, 7, 50])
def test_merged_list_walk_is_ordered_and_exact_on_both(limit):
    jax_rec, torch_rec = both(merged_list_walk_is_ordered_and_exact, limit)
    assert torch_rec == jax_rec


def test_move_kill_point_sweep_over_destination_wal_on_both(tmp_path):
    jax_rec, torch_rec = both(move_kill_point_sweep_over_destination_wal, tmp_path)
    assert torch_rec == jax_rec


# ---------------------------------------------------------------------------
# overload defense on the router


def _overload_router(m):
    backends = {0: m.store.APIServer(), 1: m.store.APIServer()}
    for b in backends.values():
        m.apis.register_crds(b)
    return m.partition.PartitionRouter(backends)


def router_sheds_expired_deadline(m):
    router = _overload_router(m)
    tok = m.overload.set_deadline(time.monotonic() - 0.1)
    shed = []
    try:
        for call in (lambda: router.create(_nb("team-a", "x") | {"apiVersion": "kubeflow.org/v1beta1"}),
                     lambda: router.get("Notebook", "x", "team-a"),
                     lambda: router.list_chunk("Notebook", limit=10)):
            with pytest.raises(m.store.DeadlineExceeded) as ei:
                call()
            shed.append(str(ei.value))
    finally:
        m.overload.reset_deadline(tok)
    return shed


def router_breaker_sheds_sick_partition(m):
    router = _overload_router(m)
    breaker = router._breaker_for(0)
    breaker._state = breaker.OPEN
    breaker._open_until = time.monotonic() + 60.0
    with pytest.raises(m.store.TooManyRequests) as ei:
        router.get("PriorityClass", "x")  # cluster-scoped: partition 0
    assert "circuit breaker" in str(ei.value) and ei.value.retry_after > 0
    # the healthy partition still answers
    ns1 = next(ns for ns in (f"t-{i}" for i in range(32)) if router.owner_of(ns) == 1)
    with pytest.raises(m.store.NotFound):
        router.get("Notebook", "x", ns1)
    return str(ei.value).split(";")[0]


@pytest.mark.parametrize("scenario", [router_sheds_expired_deadline,
                                      router_breaker_sheds_sick_partition],
                         ids=lambda f: f.__name__)
def test_router_overload_equal_on_both(scenario):
    jax_rec, torch_rec = both(scenario)
    assert torch_rec == jax_rec


# ---------------------------------------------------------------------------
# a partitioned store replicated across the packages


@pytest.mark.parametrize("leader_pkg,follower_pkg", [("jax", "torch"), ("torch", "jax")])
def test_partitioned_replication_crosses_packages(leader_pkg, follower_pkg, monkeypatch):
    """A ``build_partitions(3)`` façade of one package; the other
    package's ``replica_router_from_env`` (one router URL,
    ``STORE_PARTITIONS=3``: one ``?partition=``-scoped follower a
    partition) follows it. Both reach the leader's ``partition_digests``,
    and the follower's merged list equals the leader's."""
    lm, fm = wire(leader_pkg), wire(follower_pkg)
    leader = lm.partition.build_partitions(3)
    lm.apis.register_crds(leader)
    namespaces = [f"team-{i}" for i in range(9)]
    for i, ns in enumerate(namespaces):
        leader.create({"apiVersion": "kubeflow.org/v1beta1", **_nb(ns, f"nb-{i}", i),
                       "spec": {"template": {"spec": {"containers": [{"name": "nb"}]}}}})
    _t, port, srv = lm.httpapi.serve(leader, host="127.0.0.1", port=0)
    monkeypatch.setenv("REPLICA_OF", f"http://127.0.0.1:{port}")
    monkeypatch.setenv("STORE_PARTITIONS", "3")
    router, clients = fm.partition.replica_router_from_env()
    fm.apis.register_crds(router)
    try:
        for i in range(3):
            assert clients[i].partition == i
        # live writes after the cold join, on every partition
        for i, ns in enumerate(namespaces):
            nb = leader.get("Notebook", f"nb-{i}", ns)
            nb["metadata"].setdefault("labels", {})["v"] = str(100 + i)
            leader.update(nb)
        leader.delete("Notebook", "nb-0", "team-0")
        want = leader.partition_digests()
        end = time.time() + 30
        while router.partition_digests() != want and time.time() < end:
            time.sleep(0.02)
        assert router.partition_digests() == want
        assert [_key(o) for o in router.list("Notebook")] == \
               [_key(o) for o in leader.list("Notebook")]
        with pytest.raises(fm.store.NotLeader):
            router.create(_nb("team-1", "nope"))
    finally:
        for c in clients:
            c.stop()
        srv.shutdown()
