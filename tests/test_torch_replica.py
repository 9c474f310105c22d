"""The port's read replicas (``machinery/replica.py``), the store's
replication feed and sharded watch dispatch, and the façade's
``/replication/`` routes, held to the JAX package's.

Every case of ``tests/test_replica.py`` runs as one scenario on both
packages: inside a package the follower must converge bit-identical to
its leader (rv and ``state_digest``), and across packages the scenario's
record (rvs, statuses, counts, the scrubbed ``state_view``) must be
equal. The wire is crossed both ways: the port's ``ReplicationClient``
follows a JAX leader's ``/replication/stream`` and JAX's follows the
port's, and each follower reaches its leader's digest.
"""

import json
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

from test_torch_leader import both, pkg, state_view

# the reconnect backoff of the HTTP cases: JAX's defaults (50 ms base,
# 2 s cap) spend most of a chaos-drop run asleep
FAST = dict(reconnect_base=0.005, reconnect_cap=0.02)


def _widget_api(m, **kwargs):
    api = m.store.APIServer(**kwargs)
    api.register_kind("kubeflow.org/v1", "Widget", "widgets")
    return api


def _widget(name, ns="a", v=0):
    return {"kind": "Widget", "metadata": {"name": name, "namespace": ns}, "spec": {"v": v}}


def _drain(w, timeout):
    """A watch's events until it ends or ``timeout`` passes with none
    (``get`` answers None for both, in either package)."""
    out = []
    while (item := w.get(timeout=timeout)) is not None:
        out.append(item)
    return out


def _names(api, ns="a"):
    return sorted(o["metadata"]["name"] for o in api.list("Widget", namespace=ns))


def follower_converges_and_rejects_writes(m):
    leader = _widget_api(m)
    rep = m.replica.ReplicaStore()
    ship = m.replica.InProcessReplication(leader, rep)
    for i in range(7):
        leader.create(_widget(f"w{i}", v=i))
    leader.delete("Widget", "w3", "a")
    w5 = leader.get("Widget", "w5", "a")
    w5["spec"]["v"] = 500
    leader.update(w5)
    ship.sync()
    assert rep.applied_rv() == leader.applied_rv()
    assert rep.state_digest() == leader.state_digest()
    assert rep.get("Widget", "w1", "a")["metadata"]["uid"] == leader.get(
        "Widget", "w1", "a")["metadata"]["uid"]
    page, token = rep.list_chunk("Widget", namespace="a", limit=4)
    rest, token2 = rep.list_chunk("Widget", namespace="a", limit=4, continue_token=token)
    assert len(page) == 4 and token and len(rest) == 2 and not token2
    refused = []
    for verb, call in [
        ("create", lambda: rep.create(_widget("x"))),
        ("update", lambda: rep.update(rep.get("Widget", "w5", "a"))),
        ("patch", lambda: rep.patch("Widget", "w5", {"spec": {"v": 9}}, "a")),
        ("delete", lambda: rep.delete("Widget", "w5", "a")),
        ("emit_event", lambda: rep.emit_event(_widget("w5"), "R", "m")),
    ]:
        with pytest.raises(m.store.NotLeader):
            call()
        refused.append(verb)
    return rep.applied_rv(), _names(rep), state_view(rep), refused


def follower_registers_dynamic_kinds_from_stream(m):
    leader = m.store.APIServer()
    rep = m.replica.ReplicaStore()
    ship = m.replica.InProcessReplication(leader, rep)
    ship.sync()
    leader.register_kind("kubeflow.org/v1", "Widget", "widgets")
    leader.create(_widget("w0"))
    ship.sync()
    assert rep.get("Widget", "w0", "a")["spec"]["v"] == 0
    assert rep.type_info("Widget").plural == "widgets"
    return rep.applied_rv(), state_view(rep)


def follower_watch_serves_same_resume_contract(m):
    leader = _widget_api(m)
    rep = m.replica.ReplicaStore()
    ship = m.replica.InProcessReplication(leader, rep)
    leader.create(_widget("w0"))
    ship.sync()
    seen_rv = rep.get("Widget", "w0", "a")["metadata"]["resourceVersion"]
    w = rep.watch("Widget", namespace="a", resource_version=seen_rv)
    leader.create(_widget("w1", v=1))
    ship.sync()
    etype, obj = w.get(timeout=1)
    w.stop()
    assert etype == "ADDED" and obj["metadata"]["name"] == "w1"
    return etype, obj["metadata"]["name"], obj["metadata"]["resourceVersion"]


def rv_pinned_read_waits_then_410(m):
    leader = _widget_api(m)
    rep = m.replica.ReplicaStore()
    rep.RV_WAIT_SECONDS = 0.1
    ship = m.replica.InProcessReplication(leader, rep)
    leader.create(_widget("w0"))
    ship.sync()
    future_rv = leader.applied_rv() + 1
    with pytest.raises(m.store.Expired):
        rep.wait_for_rv(future_rv)
    leader.create(_widget("w1"))
    done = threading.Event()
    t = threading.Thread(target=lambda: (done.wait(0.05), ship.sync()), daemon=True)
    t.start()
    rep.RV_WAIT_SECONDS = 5.0
    rep.wait_for_rv(future_rv)
    t.join()
    assert rep.applied_rv() >= future_rv
    return future_rv, rep.applied_rv()


def deposed_leader_stream_is_fenced_out(m):
    leader = _widget_api(m)
    rep = m.replica.ReplicaStore()
    ship = m.replica.InProcessReplication(leader, rep)
    leader.create(_widget("w0"))
    ship.sync()
    rep.observe_leader(rep.applied_rv(), epoch=7, ts=time.time())
    zombie = _widget("zombie") | {
        "metadata": {"name": "zombie", "namespace": "a", "resourceVersion": "999"}}
    with pytest.raises(m.store.FencedOut):
        rep.apply_replicated("ADDED", zombie, epoch=3)
    assert "zombie" not in _names(rep)
    return rep.leader_epoch, _names(rep)


def promoted_follower_serves_writes_and_fences_stale_epoch(m):
    leader = _widget_api(m)
    rep = m.replica.ReplicaStore()
    ship = m.replica.InProcessReplication(leader, rep)
    leader.create(_widget("w0"))
    ship.sync()
    rep.promote(epoch=11)
    created = rep.create(_widget("post-promo", v=1))
    stale = {"kind": "Widget", "spec": {"v": 0},
             "metadata": {"name": "stale", "namespace": "a", "resourceVersion": "999"}}
    with pytest.raises(m.store.FencedOut):
        rep.apply_replicated("ADDED", stale, epoch=2)
    return (created["metadata"]["resourceVersion"], rep.replication_epoch,
            rep.is_follower, _names(rep))


def http_replication_cold_join_live_stream_and_307(m):
    leader = _widget_api(m)
    for i in range(5):
        leader.create(_widget(f"w{i}", v=i))
    _t, port, srv = m.httpapi.serve(leader, port=0)
    url = f"http://127.0.0.1:{port}"
    rep = m.replica.ReplicaStore(url)
    registry = m.prometheus.Registry()
    rep.attach_replica_metrics(registry)
    client = m.replica.ReplicationClient(rep, **FAST).start()
    try:
        assert client.wait_caught_up(30, target_rv=leader.applied_rv())
        assert client.snapshots_loaded == 1
        leader.create(_widget("live", v=42))
        deadline = time.time() + 10
        while time.time() < deadline and rep.applied_rv() < leader.applied_rv():
            time.sleep(0.01)
        assert rep.get("Widget", "live", "a")["spec"]["v"] == 42
        assert rep.state_digest() == leader.state_digest()
        assert rep.lag_records() == 0
        _t2, port2, srv2 = m.httpapi.serve(rep, port=0)
        try:
            base = f"http://127.0.0.1:{port2}/apis/kubeflow.org/v1/namespaces/a/widgets"
            resp = urllib.request.urlopen(base)
            served = resp.headers["X-Served-RV"]
            items = len(json.loads(resp.read().decode())["items"])
            req = urllib.request.Request(
                base, data=b'{"metadata": {"name": "nope"}}', method="POST")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req)
            status = err.value.code
            assert err.value.headers["Location"].startswith(url)
            reason = json.loads(err.value.read().decode())["reason"]
        finally:
            srv2.shutdown()
        exposition = registry.exposition()
        assert "replica_lag_records 0" in exposition
        assert "replica_staleness_seconds" in exposition
        assert served == str(rep.applied_rv())
        return items, status, reason, rep.applied_rv(), state_view(rep)
    finally:
        client.stop()
        srv.shutdown()


def http_stream_reconnect_resumes_without_loss_or_duplicates(m):
    leader = _widget_api(m)
    _t, port, srv = m.httpapi.serve(leader, port=0)
    rep = m.replica.ReplicaStore(f"http://127.0.0.1:{port}")
    rng = random.Random(7)
    client = m.replica.ReplicationClient(
        rep, chaos_drop=lambda: rng.random() < 0.2, **FAST).start()
    try:
        assert client.wait_caught_up(30, target_rv=leader.applied_rv())
        for i in range(40):
            leader.create(_widget(f"w{i}", v=i))
        assert client.wait_caught_up(60, target_rv=leader.applied_rv())
        assert rep.state_digest() == leader.state_digest()
        assert client.reconnects > 0
        return rep.applied_rv(), _names(rep), state_view(rep)
    finally:
        client.stop()
        srv.shutdown()


def replication_coherence_property_randomized(m, seed=13):
    rng = random.Random(seed)
    leader = _widget_api(m)
    leader.WATCH_CACHE_SIZE = 32
    rep = m.replica.ReplicaStore()
    ship = m.replica.InProcessReplication(leader, rep)
    live = set()
    for step in range(400):
        op = rng.random()
        name = f"w{rng.randrange(60)}"
        try:
            if op < 0.5 or name not in live:
                leader.create(_widget(name, v=step))
                live.add(name)
            elif op < 0.8:
                obj = leader.get("Widget", name, "a")
                obj["spec"]["v"] = step
                leader.update(obj)
            else:
                leader.delete("Widget", name, "a")
                live.discard(name)
        except m.store.APIError:
            pass
        if rng.random() < 0.08:
            ship.drop_stream()
        if rng.random() < 0.3:
            ship.step(budget=rng.randrange(1, 8))
    ship.sync()
    assert rep.applied_rv() == leader.applied_rv()
    assert rep.state_digest() == leader.state_digest()
    assert set(_names(rep)) == live
    assert ship.reconnects > 1
    ship.drop_stream()
    for i in range(leader.WATCH_CACHE_SIZE + 5):
        obj = leader.get("Widget", sorted(live)[0], "a")
        obj["spec"]["v"] = 10_000 + i
        leader.update(obj)
    ship.sync()
    assert ship.snapshots_loaded >= 1
    assert rep.state_digest() == leader.state_digest()
    return rep.applied_rv(), ship.reconnects, ship.snapshots_loaded, state_view(rep)


def slow_watch_consumer_evicted_with_410(m):
    api = _widget_api(m)
    api.WATCH_CACHE_SIZE = 16
    registry = m.prometheus.Registry()
    api.attach_metrics(registry)
    w = api.watch("Widget", namespace="a", send_initial=False)
    assert w.maxsize == 16
    for i in range(40):
        api.create(_widget(f"w{i}"))
    assert w.evicted and w.ended and isinstance(w.error, m.store.Expired)
    assert api.watch_evictions == 1
    assert "watch_consumers_evicted_total 1" in registry.exposition()
    drained = len(_drain(w, 0.1))
    assert drained == 16 and w not in api._watches
    w2 = api.watch("Widget", namespace="a", send_initial=False)
    api.create(_widget("after"))
    _etype, obj = w2.get(timeout=1)
    w2.stop()
    return drained, api.watch_evictions, obj["metadata"]["name"]


def initial_dump_never_self_evicts(m):
    api = _widget_api(m)
    api.WATCH_CACHE_SIZE = 8
    for i in range(50):
        api.create(_widget(f"w{i}"))
    w = api.watch("Widget", namespace="a")
    assert not w.evicted
    n = len(_drain(w, 0.1))
    assert n == 50
    return n


def dispatcher_watches_preserve_rv_order_and_deliver_all(m):
    api = _widget_api(m)
    watches = [api.watch("Widget", namespace="a", send_initial=False, inline=False)
               for _ in range(24)]
    assert api._shards and all(w._shard is not None for w in watches)
    for i in range(30):
        api.create(_widget(f"w{i:02d}", v=i))
    orders = []
    for w in watches:
        got = []
        while len(got) < 30:
            item = w.get(timeout=5)
            assert item is not None, "dispatcher dropped an event"
            got.append(item)
        w.stop()
        rvs = [int(o["metadata"]["resourceVersion"]) for _e, o in got]
        assert rvs == sorted(rvs) and len(rvs) == 30
        orders.append(rvs)
    api.close()
    return orders, [w._shard for w in watches]


def read_split_api_routes_reads_to_replica_writes_to_leader(m):
    leader = _widget_api(m)
    rep = m.replica.ReplicaStore()
    ship = m.replica.InProcessReplication(leader, rep)
    split = m.replica.ReadSplitAPI(leader, rep)
    split.create(_widget("w0", v=5))
    ship.sync()
    listed = split.list("Widget", namespace="a")[0]["spec"]["v"]
    split.create(_widget("fresh", v=9))
    fresh = split.get("Widget", "fresh", "a")["spec"]["v"]
    assert split.applied_rv() == rep.applied_rv()
    ship.sync()
    w = split.watch("Widget", namespace="a", send_initial=False)
    split.update(split.get("Widget", "w0", "a") | {"spec": {"v": 6}})
    ship.sync()
    etype, obj = w.get(timeout=1)
    w.stop()
    assert (listed, fresh, etype, obj["spec"]["v"]) == (5, 9, "MODIFIED", 6)
    return listed, fresh, etype, obj["spec"]["v"], state_view(rep)


def follower_resnapshot_expires_its_own_watchers(m):
    leader = _widget_api(m)
    leader.WATCH_CACHE_SIZE = 8
    rep = m.replica.ReplicaStore()
    ship = m.replica.InProcessReplication(leader, rep)
    leader.create(_widget("w0"))
    ship.sync()
    consumer = rep.watch("Widget", namespace="a", send_initial=False)
    ship.drop_stream()
    for i in range(1, 30):
        leader.create(_widget(f"w{i}"))
    ship.sync()
    assert ship.snapshots_loaded >= 1
    assert consumer.ended and isinstance(consumer.error, m.store.Expired)
    assert rep.state_digest() == leader.state_digest()
    return ship.snapshots_loaded, rep.applied_rv(), state_view(rep)


def identity_preserving_writes_ship_to_followers(m):
    """``import_object`` keeps a moved object's uid and stamps a local
    rv, ``purge_object`` drops one with no cascade (and is idempotent);
    both ship to a follower; ``compose_digests`` folds per-partition
    digests in sorted order."""
    source = _widget_api(m)
    moved = source.create(_widget("moved", ns="b", v=3))
    leader = _widget_api(m)
    rep = m.replica.ReplicaStore()
    ship = m.replica.InProcessReplication(leader, rep)
    leader.create(_widget("w0"))
    imported = leader.import_object(moved)
    assert imported["metadata"]["uid"] == moved["metadata"]["uid"]
    again = leader.import_object(imported | {"spec": {"v": 4}})
    purged = [leader.purge_object("Widget", "w0", "a"),
              leader.purge_object("Widget", "w0", "a")]
    ship.sync()
    assert rep.state_digest() == leader.state_digest()
    assert purged == [True, False]
    fleet = m.store.APIServer.compose_digests(
        [(1, "d1", 5), (0, leader.state_digest(), leader.applied_rv())])
    return (imported["metadata"]["resourceVersion"], again["metadata"]["resourceVersion"],
            again["spec"], purged, _names(rep, "b"), _names(rep), len(fleet),
            m.store.APIServer.compose_digests([(0, "x", 1), (1, "y", 2)]))


SCENARIOS = [
    identity_preserving_writes_ship_to_followers,
    follower_converges_and_rejects_writes,
    follower_registers_dynamic_kinds_from_stream,
    follower_watch_serves_same_resume_contract,
    rv_pinned_read_waits_then_410,
    deposed_leader_stream_is_fenced_out,
    promoted_follower_serves_writes_and_fences_stale_epoch,
    http_replication_cold_join_live_stream_and_307,
    http_stream_reconnect_resumes_without_loss_or_duplicates,
    replication_coherence_property_randomized,
    slow_watch_consumer_evicted_with_410,
    initial_dump_never_self_evicts,
    dispatcher_watches_preserve_rv_order_and_deliver_all,
    read_split_api_routes_reads_to_replica_writes_to_leader,
    follower_resnapshot_expires_its_own_watchers,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_replica_scenario_equal_on_both(scenario):
    jax_rec, torch_rec = both(scenario)
    assert torch_rec == jax_rec


@pytest.mark.parametrize("leader_pkg,follower_pkg", [("jax", "torch"), ("torch", "jax")])
def test_replication_stream_crosses_packages(leader_pkg, follower_pkg):
    """A follower of one package cold-joins and follows a leader of the
    other over ``/replication/snapshot`` and ``/replication/stream``:
    registrations, creates, updates, deletes and the CONTROL frames'
    epoch all cross the wire, and the follower reaches the leader's
    digest."""
    lm, fm = pkg(leader_pkg), pkg(follower_pkg)
    leader = lm.store.APIServer()
    leader.replication_epoch = 3
    leader.register_kind("kubeflow.org/v1", "Widget", "widgets")
    for i in range(6):
        leader.create(_widget(f"w{i}", v=i))
    _t, port, srv = lm.httpapi.serve(leader, port=0)
    rep = fm.replica.ReplicaStore(f"http://127.0.0.1:{port}")
    client = fm.replica.ReplicationClient(rep, **FAST).start()
    try:
        assert client.wait_caught_up(30, target_rv=leader.applied_rv())
        leader.register_kind("kubeflow.org/v1", "Gadget", "gadgets")
        leader.create({"kind": "Gadget", "metadata": {"name": "g", "namespace": "b"}})
        leader.delete("Widget", "w2", "a")
        w4 = leader.get("Widget", "w4", "a")
        w4["spec"]["v"] = 44
        leader.update(w4)
        assert client.wait_caught_up(30, target_rv=leader.applied_rv())
        deadline = time.time() + 5
        while rep.leader_epoch != 3 and time.time() < deadline:
            time.sleep(0.02)
        assert rep.leader_epoch == 3
        assert rep.applied_rv() == leader.applied_rv()
        assert rep.state_digest() == leader.state_digest()
        assert rep.get("Gadget", "g", "b")["metadata"]["name"] == "g"
        # the follower's façade 307s a write back at the other package's leader
        with pytest.raises(fm.store.NotLeader):
            rep.create(_widget("nope"))
    finally:
        client.stop()
        srv.shutdown()


def test_replication_cut_and_feed_equal():
    """The snapshot cut and the feed's records (REGISTER first, then the
    watch cache above ``from_rv``) have the same shape on both."""

    def scenario(m):
        api = m.store.APIServer()
        api.register_kind("kubeflow.org/v1", "Widget", "widgets")
        for i in range(3):
            api.create(_widget(f"w{i}", v=i))
        api.delete("Widget", "w1", "a")
        cut = api.replication_cut()
        w = api.replication_watch(from_rv=2, inline=True)
        feed = [(etype, o.get("kind"), o.get("metadata", {}).get("resourceVersion"))
                for etype, o in _drain(w, 0.05)]
        with pytest.raises(m.store.Expired):
            api.WATCH_CACHE_SIZE = 1
            api.create(_widget("w9"))
            api.create(_widget("w10"))
            api.replication_watch(from_rv=1)
        return (sorted(cut), cut["rv"], cut["epoch"], cut["types"], cut["kind_rv"],
                len(cut["objects"]), feed, api.kind_version("Widget"))

    jax_rec, torch_rec = both(scenario)
    assert torch_rec == jax_rec
