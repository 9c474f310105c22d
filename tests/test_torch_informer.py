"""The port's informer cache (``machinery/cache.py``: ``InformerCache``,
``CachedClient``, ``register_platform_indexers``), its degraded serving
and healing under injected faults, and the runtime's informer-fed
controllers, held to the JAX package's.

Every case of ``tests/test_cache.py`` but the repo-wide lint (which
reads the JAX package's analysis tools) and the cache cases of
``tests/test_chaos.py`` run as one scenario on both packages; the
records (mirror states with their rvs, index contents, hit / miss /
coalesce / relist counts, fault counts) must be equal. Pods request
``google.com/tpu`` on the JAX side and ``nvidia.com/gpu`` on the port's,
the one resource table between them (``apis.ACCELERATOR_MAPPING``).
"""

import random

import pytest

from test_torch_leader import both, pkg

RESOURCE = {"jax": "google.com/tpu", "torch": "nvidia.com/gpu"}
SEED = 20260803


def _pod(m, name, ns="default", labels=None, chips=None, node=None, claims=()):
    spec = {"containers": [{"name": name}]}
    if chips:
        res = RESOURCE[m.name]
        spec["containers"][0]["resources"] = {
            "limits": {res: str(chips)}, "requests": {res: str(chips)}}
    if node:
        spec["nodeName"] = node
    if claims:
        spec["volumes"] = [{"name": c, "persistentVolumeClaim": {"claimName": c}}
                           for c in claims]
    return {"apiVersion": "v1", "kind": "Pod", "spec": spec,
            "metadata": {"name": name, "namespace": ns, "labels": labels or {}}}


def _cm(name, ns="default", v="0"):
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": name, "namespace": ns}, "data": {"v": v}}


def _cache(m, api, kinds=("Pod", "StatefulSet", "Event", "ConfigMap"), registry=None):
    return m.cache.InformerCache(api, kinds=kinds, registry=registry or m.prometheus.Registry())


def _injector(m, api, schedule=None, seed=SEED, registry=None):
    return m.faults.FaultInjector(
        api, seed=seed,
        schedule=schedule if schedule is not None else m.faults.FaultSchedule.none(),
        registry=registry or m.prometheus.Registry(), sleep_fn=lambda s: None,
    )


def _cache_state(cache, kind):
    with cache._lock:
        return sorted(
            (k, (o["metadata"]["name"], o["metadata"]["resourceVersion"]))
            for k, o in cache._kinds[kind].objects.items()
        )


def _store_state(m, api, kind):
    return sorted(
        ((m.objects.namespace_of(o), m.objects.name_of(o)),
         (o["metadata"]["name"], o["metadata"]["resourceVersion"]))
        for o in api.list(kind)
    )


def _names(m, objs):
    return [m.objects.name_of(o) for o in objs]


def freeze_mutable_roundtrip_and_isolation(m):
    c = m.cache
    tree = {"a": {"b": [1, {"c": "x"}]}, "n": 3}
    frozen = c.freeze(tree)
    assert c.is_frozen(frozen) and frozen == tree
    raised = 0
    for fn in (lambda: frozen.__setitem__("a", 1),
               lambda: frozen["a"]["b"].append(2),
               lambda: frozen["a"]["b"][1].__setitem__("c", "y"),
               lambda: frozen.setdefault("missing", 1)):
        with pytest.raises(c.FrozenObjectError):
            fn()
        raised += 1
    assert frozen.setdefault("n") == 3
    thawed = c.mutable(frozen)
    assert thawed == tree and type(thawed) is dict
    thawed["a"]["b"].append(2)
    plain = {"x": 1}
    assert c.mutable(plain) is plain
    return raised, len(frozen["a"]["b"]), thawed


def reader_mutation_raises_instead_of_corrupting_store(m):
    api = m.store.APIServer()
    api.create(_pod(m, "p1", labels={"app": "x"}))
    cache = _cache(m, api)
    cache.start(live=False)
    client = m.cache.CachedClient(api, cache)
    pod = client.get("Pod", "p1", "default")
    with pytest.raises(m.cache.FrozenObjectError):
        pod["metadata"]["labels"]["app"] = "evil"
    with pytest.raises(m.cache.FrozenObjectError):
        pod["spec"]["containers"].pop()
    stored = api.get("Pod", "p1", "default")
    return stored["metadata"]["labels"], len(stored["spec"]["containers"])


def zero_deepcopies_on_cached_read_hits(m):
    api = m.store.APIServer()
    for i in range(10):
        api.create(_pod(m, f"p{i}", labels={"statefulset": "web"}))
    cache = _cache(m, api)
    m.cache.register_platform_indexers(cache)
    cache.start(live=False)
    client = m.cache.CachedClient(api, cache)
    client.get("Pod", "p3", "default")
    before = m.objects.deepcopy_count()
    for _ in range(50):
        client.get("Pod", "p3", "default")
        client.list("Pod", namespace="default")
        client.list("Pod", namespace="default",
                    label_selector={"matchLabels": {"statefulset": "web"}})
        client.by_index("Pod", "label:statefulset", "web")
    hits_copied = m.objects.deepcopy_count() - before
    api.get("Pod", "p3", "default")
    assert hits_copied == 0 and m.objects.deepcopy_count() > before
    cache.flush_metrics()
    return hits_copied, cache.m_hits.value({"kind": "Pod"})


def cache_coherence_property_randomized_crud(m):
    rng = random.Random(7)
    api = m.store.APIServer()
    cache = _cache(m, api, kinds=("ConfigMap",))
    cache.start(live=False)
    live = set()
    for step in range(400):
        op = rng.random()
        name, ns = f"cm-{rng.randrange(40)}", f"ns-{rng.randrange(3)}"
        try:
            if op < 0.45 or not live:
                api.create(_cm(name, ns, str(step)))
                live.add(f"{ns}/{name}")
            elif op < 0.75:
                api.patch("ConfigMap", name, {"data": {"v": str(step)}}, ns)
            else:
                api.delete("ConfigMap", name, ns)
                live.discard(f"{ns}/{name}")
        except m.store.APIError:
            pass
        if rng.random() < 0.3:
            cache.drain_once()
    cache.drain_once()
    state = _cache_state(cache, "ConfigMap")
    assert state == _store_state(m, api, "ConfigMap")
    return state


def resync_heals_dropped_event(m):
    api = m.store.APIServer()
    cache = _cache(m, api, kinds=("ConfigMap",))
    cache.start(live=False)
    api.create(_cm("a", v="1"))
    assert cache._watches["ConfigMap"].try_get() is not None
    cache.drain_once()
    lost = _cache_state(cache, "ConfigMap")
    assert lost != _store_state(m, api, "ConfigMap")
    before = cache.m_resync.value()
    cache.resync("ConfigMap")
    healed = _cache_state(cache, "ConfigMap")
    assert healed == _store_state(m, api, "ConfigMap")
    assert cache.m_resync.value() == before + 1
    return lost, healed


def rv_guard_ignores_stale_out_of_order_events(m):
    api = m.store.APIServer()
    cache = _cache(m, api, kinds=("ConfigMap",))
    cache.start(live=False)
    api.create(_cm("a", v="1"))
    cache.drain_once()
    fresh = api.get("ConfigMap", "a", "default")
    stale = m.objects.deepcopy(fresh)
    stale["data"] = {"v": "stale"}
    stale["metadata"]["resourceVersion"] = "0"
    out = [cache._apply("ConfigMap", "MODIFIED", stale)]
    assert cache.get("ConfigMap", "a", "default")["data"]["v"] == "1"
    api.delete("ConfigMap", "a", "default")
    cache.drain_once()
    out.append(cache._apply("ConfigMap", "ADDED", m.objects.deepcopy(fresh)))
    with pytest.raises(m.store.NotFound):
        cache.get("ConfigMap", "a", "default")
    tomb = cache._kinds["ConfigMap"].tombstones[("default", "a")]
    assert int(fresh["metadata"]["resourceVersion"]) <= tomb
    return out, tomb


def platform_indexers_pods_sts_nodes_events(m):
    api = m.store.APIServer()
    m.apis.register_crds(api)
    m.scheduling.register_scheduling(api)
    cache = m.cache.InformerCache(api, registry=m.prometheus.Registry())
    m.cache.register_platform_indexers(cache)
    sts = api.create({"apiVersion": "apps/v1", "kind": "StatefulSet", "spec": {},
                      "metadata": {"name": "web", "namespace": "default",
                                   "labels": {"notebook-name": "web"}}})
    uid = sts["metadata"]["uid"]
    pod = _pod(m, "web-0", labels={"statefulset": "web"}, chips=4, node="n1",
               claims=("data",))
    pod["metadata"]["ownerReferences"] = [
        {"kind": "StatefulSet", "name": "web", "uid": uid, "controller": True}]
    api.create(pod)
    api.create(_pod(m, "other"))
    api.create({"apiVersion": "v1", "kind": "Node", "metadata": {
        "name": "n1", "labels": {"cloud.google.com/gke-nodepool": "pool-a"}}})
    api.emit_event(sts, "Bang", "boom", event_type="Warning")
    cache.start(live=False)
    client = m.cache.CachedClient(api, cache)
    rec = {
        "owner": _names(m, client.by_index("Pod", "owner-uid", uid)),
        "chips": {k: _names(m, v) for k, v in client.index_buckets("Pod", "tpu").items()},
        "pvc": _names(m, client.by_index("Pod", "pvc", "data")),
        "pool": _names(m, client.by_index("Node", "nodepool", "pool-a")),
        "sts": _names(m, client.by_index("StatefulSet", "label:notebook-name", "web")),
        "events": [e["reason"] for e in client.by_index("Event", "involved", "StatefulSet/web")],
    }
    before = m.objects.deepcopy_count()
    out = client.list("Pod", namespace="default",
                      label_selector={"matchLabels": {"statefulset": "web"}})
    rec["selector"] = _names(m, out)
    assert m.objects.deepcopy_count() == before
    api.delete("Pod", "web-0", "default")
    cache.drain_once()
    rec["after_delete"] = (client.by_index("Pod", "owner-uid", uid),
                           client.index_buckets("Pod", "tpu"))
    assert rec["owner"] == ["web-0"] and rec["chips"] == {"4": ["web-0"]}
    assert rec["after_delete"] == ([], {})
    return rec


def list_by_index_falls_back_without_cache(m):
    api = m.store.APIServer()
    api.create(_pod(m, "a", labels={"statefulset": "web"}))
    api.create(_pod(m, "b", labels={"statefulset": "other"}))
    out = m.cache.list_by_index(api, "Pod", "label:statefulset", "web", namespace="default",
                                fallback_selector={"matchLabels": {"statefulset": "web"}})
    assert _names(m, out) == ["a"]
    return _names(m, out)


def cached_client_hits_misses_and_fallthrough(m):
    api = m.store.APIServer()
    api.create(_pod(m, "p1"))
    cache = _cache(m, api, kinds=("Pod",))
    cache.start(live=False)
    client = m.cache.CachedClient(api, cache)
    client.get("Pod", "p1", "default")
    client.list("Pod", namespace="default")
    api.create({"apiVersion": "v1", "kind": "Service", "spec": {},
                "metadata": {"name": "s", "namespace": "default"}})
    client.get("Service", "s", "default")
    with pytest.raises(m.store.NotFound):
        client.get("Pod", "absent", "default")
    cache.flush_metrics()
    counts = (cache.m_hits.value({"kind": "Pod"}), cache.m_misses.value({"kind": "Service"}),
              cache.m_misses.value({"kind": "Pod"}))
    assert counts == (2, 1, 1)
    api.create(_pod(m, "p2"))
    ryw = client.get("Pod", "p2", "default")["metadata"]["name"]
    client.delete("Pod", "p2", "default")
    with pytest.raises(m.store.NotFound):
        client.get("Pod", "p2", "default")
    return counts, ryw


def event_coalescing_counts_superseded_events(m):
    api = m.store.APIServer()
    cache = _cache(m, api, kinds=("ConfigMap",))
    cache.start(live=False)
    cm = api.create(_cm("a"))
    for i in range(5):
        cm["data"] = {"v": str(i + 1)}
        cm = api.update(cm)
    before = cache.m_coalesced.value()
    cache.drain_once()
    coalesced = cache.m_coalesced.value() - before
    assert coalesced == 5
    return coalesced, cache.get("ConfigMap", "a", "default")["data"]["v"]


def event_prune_notifies_cache(m):
    api = m.store.APIServer()
    api.EVENT_RETENTION = 10
    cache = _cache(m, api, kinds=("Event",))
    cache.start(live=False)
    cm = api.create(_cm("a"))
    for i in range(25):
        api.emit_event(cm, f"R{i}", f"msg {i}")
    cache.drain_once()
    cached = sorted(e["reason"] for e in cache.list("Event", namespace="default"))
    assert cached == sorted(e["reason"] for e in api.list("Event", namespace="default"))
    return cached


def cache_metric_names_pass_naming_lint(m):
    registry = m.prometheus.Registry()
    m.cache.InformerCache(m.store.APIServer(), registry=registry)
    assert m.prometheus.lint_metric_names(registry) == []
    names = sorted(x.name for x in registry.metrics())
    assert {"cache_hits_total", "cache_misses_total", "cache_resync_total",
            "watch_events_coalesced_total", "cache_staleness_seconds"} <= set(names)
    return names


def shared_frozen_event_across_watchers(m):
    api = m.store.APIServer()
    w1, w2 = api.watch("ConfigMap"), api.watch("ConfigMap")
    api.create(_cm("a"))
    e1, e2 = w1.get(timeout=1), w2.get(timeout=1)
    assert e1[1] is e2[1] and m.cache.is_frozen(e1[1])
    with pytest.raises(m.cache.FrozenObjectError):
        e1[1]["metadata"]["name"] = "evil"
    w1.stop()
    w2.stop()
    return e1[0], e1[1]["metadata"]["resourceVersion"]


def manager_owns_cache_and_controllers_source_from_informer(m):
    api = m.store.APIServer()
    cache = _cache(m, api, kinds=("ConfigMap",))
    mgr = m.runtime.Manager(api, cache=cache)
    seen = []
    ctrl = mgr.new_controller(
        "cm-test", "ConfigMap", lambda req: seen.append((req.namespace, req.name)))
    api.create(_cm("a"))
    mgr.drain()
    assert ("default", "a") in seen and ctrl._watches == [None]
    assert cache.synced("ConfigMap")
    return seen, ctrl._watches


# -- tests/test_chaos.py: the informer under injected faults -----------------


def cache_serves_last_known_good_while_degraded_then_heals(m):
    api = m.store.APIServer()
    registry = m.prometheus.Registry()
    inj = _injector(m, api, registry=registry)
    cache = _cache(m, inj, kinds=("ConfigMap",), registry=registry)
    cache.reestablish_backoff = 0.0
    cache.start(live=False)
    api.create(_cm("a"))
    cache.drain_once()
    inj.set_offline(True)
    api.create(_cm("b"))
    cache.drain_once()
    degraded = cache.degraded("ConfigMap")
    assert degraded
    assert cache.get("ConfigMap", "a", "default")["data"]["v"] == "0"
    with pytest.raises(m.store.NotFound):
        cache.get("ConfigMap", "b", "default")
    inj.set_offline(False)
    cache.drain_once()
    assert not cache.degraded("ConfigMap")
    state = _cache_state(cache, "ConfigMap")
    assert state == _store_state(m, api, "ConfigMap")
    assert cache.m_relists.value() >= 1
    return degraded, state, cache.m_relists.value()


def _chaos_crud(m, schedule, steps, seed, registry):
    rng = random.Random(seed)
    api = m.store.APIServer()
    inj = _injector(m, api, m.faults.FaultSchedule(**schedule), seed=seed, registry=registry)
    cache = _cache(m, inj, kinds=("ConfigMap",), registry=registry)
    cache.reestablish_backoff = 0.0
    cache.start(live=False)
    live = set()
    for step in range(steps):
        op = rng.random()
        name, ns = f"cm-{rng.randrange(40)}", f"ns-{rng.randrange(3)}"
        try:
            if op < 0.45 or not live:
                inj.create(_cm(name, ns=ns, v=str(step)))
                live.add(f"{ns}/{name}")
            elif op < 0.75:
                inj.patch("ConfigMap", name, {"data": {"v": str(step)}}, ns)
            else:
                inj.delete("ConfigMap", name, ns)
                live.discard(f"{ns}/{name}")
        except (m.store.APIError, KeyError):
            pass
        if rng.random() < 0.3:
            cache.drain_once()
    inj.set_schedule(m.faults.FaultSchedule.none())
    for _ in range(6):
        cache.drain_once()
    state = _cache_state(cache, "ConfigMap")
    assert state == _store_state(m, api, "ConfigMap")
    assert not cache.degraded("ConfigMap")
    faults = {k: inj.m_faults.value({"kind": k}) for k in schedule}
    assert sum(faults.values()) > 0
    return state, faults, cache


def cache_coherence_property_under_chaos(m):
    schedule = dict(conflict=0.03, too_many_requests=0.05, server_error=0.05, watch_drop=0.05)
    state, faults, cache = _chaos_crud(m, schedule, 400, SEED, m.prometheus.Registry())
    assert cache.m_relists.value() >= 1
    return state, faults, cache.m_relists.value()


def cache_prime_retries_are_budget_bounded(m):
    overload = m.overload
    budget = overload._reset_shared_budget_for_tests()
    try:
        budget._tokens = 1.0
        api = m.store.APIServer()
        inj = _injector(m, api, m.faults.FaultSchedule(server_error=1.0))
        calls = {"n": 0}
        real_chunk, real_list = inj.list_chunk, inj.list

        def counting_chunk(*a, **kw):
            calls["n"] += 1
            return real_chunk(*a, **kw)

        def counting_list(*a, **kw):
            calls["n"] += 1
            return real_list(*a, **kw)

        inj.list_chunk, inj.list = counting_chunk, counting_list
        cache = _cache(m, inj, kinds=("ConfigMap",))
        with pytest.raises(m.store.APIError):
            cache.start(live=False)
        assert calls["n"] == 2
        return calls["n"]
    finally:
        overload._reset_shared_budget_for_tests()


def cache_coherence_property_with_overload_defense_armed(m):
    overload = m.overload
    budget = overload._reset_shared_budget_for_tests()
    try:
        schedule = dict(conflict=0.03, too_many_requests=0.05, server_error=0.12,
                        watch_drop=0.05)
        state, faults, _cache_ = _chaos_crud(m, schedule, 300, SEED + 20,
                                             m.prometheus.Registry())
        assert 0.0 <= budget.tokens() <= budget.cap
        return state, faults
    finally:
        overload._reset_shared_budget_for_tests()


SCENARIOS = [
    freeze_mutable_roundtrip_and_isolation,
    reader_mutation_raises_instead_of_corrupting_store,
    zero_deepcopies_on_cached_read_hits,
    cache_coherence_property_randomized_crud,
    resync_heals_dropped_event,
    rv_guard_ignores_stale_out_of_order_events,
    platform_indexers_pods_sts_nodes_events,
    list_by_index_falls_back_without_cache,
    cached_client_hits_misses_and_fallthrough,
    event_coalescing_counts_superseded_events,
    event_prune_notifies_cache,
    cache_metric_names_pass_naming_lint,
    shared_frozen_event_across_watchers,
    manager_owns_cache_and_controllers_source_from_informer,
    cache_serves_last_known_good_while_degraded_then_heals,
    cache_coherence_property_under_chaos,
    cache_prime_retries_are_budget_bounded,
    cache_coherence_property_with_overload_defense_armed,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_informer_scenario_equal_on_both(scenario):
    jax_rec, torch_rec = both(scenario)
    assert torch_rec == jax_rec


def test_relist_after_stream_loss_reaches_the_handlers():
    """Objects written, changed or deleted while a kind's watch was down
    reach its handlers when the relist heals it, as events (ADDED,
    MODIFIED, DELETED), or a controller fed by the cache never learns of
    a notebook created during an apiserver failover. The JAX package's
    cache rebuilds its mirror silently; the mirrors still agree."""
    seen = {}
    for name in ("jax", "torch"):
        m = pkg(name)
        api = m.store.APIServer()
        inj = _injector(m, api)
        cache = _cache(m, inj, kinds=("ConfigMap",))
        cache.reestablish_backoff = 0.0
        events = []
        cache.add_handler("ConfigMap", lambda etype, obj: events.append(
            (etype, obj["metadata"]["name"], obj["data"]["v"])))
        cache.start(live=False)
        api.create(_cm("kept"))
        api.create(_cm("changed"))
        api.create(_cm("gone"))
        cache.drain_once()
        before = len(events)
        inj.set_offline(True)
        api.create(_cm("new", v="1"))
        obj = api.get("ConfigMap", "changed", "default")
        api.update({**obj, "data": {"v": "2"}})
        api.delete("ConfigMap", "gone", "default")
        cache.drain_once()
        assert cache.degraded("ConfigMap")
        inj.set_offline(False)
        cache.drain_once()
        assert not cache.degraded("ConfigMap")
        assert _cache_state(cache, "ConfigMap") == _store_state(m, api, "ConfigMap")
        seen[name] = sorted(events[before:])
    assert seen["torch"] == [("ADDED", "new", "1"), ("DELETED", "gone", "0"),
                             ("MODIFIED", "changed", "2")]
    assert seen["jax"] == []


def test_collector_flush_lands_in_the_same_scrape():
    """A collector that flushes batched counts into a registered family
    (the store's slow-consumer evictions, the informer's hits and
    misses) runs before the families render, so one scrape shows the
    count (the port rendered the families first and lagged a scrape)."""
    for name in ("jax", "torch"):
        m = pkg(name)
        api = m.store.APIServer()
        reg = m.prometheus.Registry()
        cache = _cache(m, api, kinds=("Pod",), registry=reg)
        cache.start(live=False)
        api.create(_pod(m, "p1"))
        m.cache.CachedClient(api, cache).get("Pod", "p1", "default")
        assert 'cache_hits_total{kind="Pod"} 1' in reg.exposition(), name
