"""The port's hands-off failover (``machinery/promoter.py``
``PromotionWatchdog``) and read spreading (``machinery/client.py``
``ReplicaFanout``), held to the JAX package's.

The cases of ``tests/test_zones.py`` from the promotion watchdog on run
as one scenario on both packages under one injected clock; the records
(the watchdog's state sequence, the promoted epoch, the takeover Lease,
rvs, which endpoint served which call) must be equal.
"""

import socket
import time

import pytest

from test_torch_leader import both

NS = "kubeflow"


def _lease(m, name, holder, token, now, duration=1.0):
    return {
        "apiVersion": "coordination.k8s.io/v1",
        "kind": "Lease",
        "metadata": {"name": name, "namespace": NS},
        "spec": {"holderIdentity": holder, "leaseDurationSeconds": max(1, int(duration)),
                 "renewTime": m.leader._fmt_micro(now), "fencingToken": token},
    }


def watchdog_hands_off_failover(m):
    clock = {"now": 1000.0}
    now = lambda: clock["now"]  # noqa: E731
    duration = 1.0
    leader = m.store.APIServer()
    leader.register_kind("kubeflow.org/v1", "Widget", "widgets")
    leader.replication_epoch = 3
    leader.create(_lease(m, "control-plane-leader", "leader-0", 3, now()))
    follower = m.replica.ReplicaStore()
    ship = m.replica.InProcessReplication(leader, follower)
    ship.step()
    stream_live = {"alive": True}
    dog = m.promoter.PromotionWatchdog(
        follower, lease_name="control-plane-leader", namespace=NS, identity="watchdog-1",
        lease_duration=duration, grace_windows=1.0,
        stream_alive_fn=lambda: stream_live["alive"], now_fn=now,
        registry=m.prometheus.Registry(),
    )
    states = []
    for _ in range(3):
        clock["now"] += 0.4
        lease = leader.get("Lease", "control-plane-leader", NS)
        lease["spec"]["renewTime"] = m.leader._fmt_micro(now())
        leader.update(lease)
        ship.step()
        states.append(dog.step())
    for i in range(5):
        leader.create({"kind": "Widget", "metadata": {"name": f"w{i}", "namespace": "a"}})
    ship.step()
    shipped_rv = follower.applied_rv()
    clock["now"] += 2 * duration
    states.append(dog.step())
    stream_live["alive"] = False
    ship.drop_stream()
    states.append(dog.step())
    assert dog.promoted_epoch == 0
    clock["now"] += 1.5 * duration
    states.append(dog.step())
    assert states == ["leader-alive"] * 3 + ["stream-alive", "grace", "promoted"]
    assert dog.promoted_epoch == 4 and follower.is_follower is False
    lease = dict(follower.get("Lease", "control-plane-leader", NS)["spec"])
    assert lease["holderIdentity"] == "watchdog-1" and int(lease["fencingToken"]) == 4
    created = follower.create({"kind": "Widget", "metadata": {"name": "post", "namespace": "a"}})
    assert int(created["metadata"]["resourceVersion"]) == shipped_rv + 2
    with pytest.raises(m.store.FencedOut):
        follower.apply_replicated("ADDED", {"kind": "Widget", "metadata": {
            "name": "zombie", "namespace": "a", "resourceVersion": str(shipped_rv + 99)}},
            epoch=3)
    clock["now"] += 0.4
    states.append(dog.step())
    # the takeover elector stamps its Lease on the wall clock
    stamps = {k: lease.pop(k) for k in ("acquireTime", "renewTime")}
    assert all(stamps.values())
    return states, dog.promoted_epoch, lease, shipped_rv, follower.replication_epoch


def watchdog_standby_when_not_chosen(m):
    clock = {"now": 500.0}
    now = lambda: clock["now"]  # noqa: E731
    leader = m.store.APIServer()
    leader.replication_epoch = 1
    leader.create(_lease(m, "cp-leader", "leader-0", 1, now()))
    for ident in ("wd-a", "wd-b"):
        lease = _lease(m, f"shard-wd-{ident}", ident, 1, now())
        lease["metadata"]["labels"] = {m.leader.SHARD_LABEL: "wd"}
        leader.create(lease)
    follower = m.replica.ReplicaStore()
    m.replica.InProcessReplication(leader, follower).step()
    chosen = max(["wd-a", "wd-b"], key=lambda x: m.leader._hrw_weight(x, "kubeflow/cp-leader"))
    loser = "wd-a" if chosen == "wd-b" else "wd-b"
    dogs = {ident: m.promoter.PromotionWatchdog(
        follower, lease_name="cp-leader", namespace=NS, identity=ident, lease_duration=1.0,
        grace_windows=0.0, membership_group="wd", now_fn=now, registry=m.prometheus.Registry())
        for ident in ("wd-a", "wd-b")}
    clock["now"] += 5.0
    out = (dogs[loser].step(), dogs[chosen].step())
    assert out == ("standby", "promoted") and follower.is_follower is False
    return chosen, out, dogs[chosen].promoted_epoch


def watchdog_never_promotes_without_a_lease(m):
    follower = m.replica.ReplicaStore()
    dog = m.promoter.PromotionWatchdog(follower, lease_name="cp-leader", namespace=NS,
                                       lease_duration=1.0, registry=m.prometheus.Registry())
    out = dog.step()
    assert out == "no-lease" and follower.is_follower is True
    return out


class _FakeEndpoint:
    def __init__(self, name, fail=False, served_rv=None):
        self.base_url = f"http://{name}"
        self.fail = fail
        self.calls = []
        self._served_rv = served_rv

    def get(self, kind, name, namespace=None):
        self.calls.append(("get", kind, name))
        if self.fail:
            raise OSError("endpoint down")
        return {"kind": kind, "metadata": {"name": name}}

    def list(self, kind, **kwargs):
        self.calls.append(("list", kind))
        if self.fail:
            raise OSError("endpoint down")
        return []

    def list_chunk(self, kind, **kwargs):
        self.calls.append(("list_chunk", kind, kwargs.get("continue_token")))
        if self.fail:
            raise OSError("endpoint down")
        return [], f"{self.base_url}-token"

    def watch(self, kind, namespace=None, **kwargs):
        self.calls.append(("watch", kind, namespace))
        return f"watch:{self.base_url}:{kind}"

    def applied_rv(self):
        return self._served_rv


def fanout_spreads_and_fails_over(m):
    a, b = _FakeEndpoint("a", served_rv=10), _FakeEndpoint("b", served_rv=17)
    fan = m.client.ReplicaFanout([a, b], cooldown=30.0)
    for _ in range(6):
        fan.list("Notebook")
    assert a.calls and b.calls and fan.applied_rv() == 10
    a.fail = True
    before = len(b.calls)
    for _ in range(4):
        assert fan.get("Notebook", "nb") is not None
    assert len(b.calls) >= before + 4
    assert len([c for c in a.calls if c[0] == "get"]) <= 1
    a.fail = False
    w1 = fan.watch("Notebook", namespace="team-a")
    w2 = fan.watch("Notebook", namespace="team-a")
    assert w1 == w2
    return a.calls, b.calls, w1


def fanout_watch_fails_over_past_dead_home(m):
    a, b = _FakeEndpoint("a"), _FakeEndpoint("b")
    fan = m.client.ReplicaFanout([a, b], cooldown=30.0)
    home = fan.watch("Notebook", namespace="team-a")
    dead = a if home.startswith("watch:http://a") else b
    live = b if dead is a else a
    dead.fail = True
    w = fan.watch("Notebook", namespace="team-a")
    assert w.startswith(f"watch:{live.base_url}")
    return home, w


def fanout_pagination_sticks_to_one_endpoint(m):
    a, b = _FakeEndpoint("a"), _FakeEndpoint("b")
    fan = m.client.ReplicaFanout([a, b], cooldown=30.0)
    _, token = fan.list_chunk("Notebook", namespace="team-a", limit=10)
    home = a if a.calls else b
    for _ in range(3):
        fan.list_chunk("Notebook", namespace="team-a", limit=10, continue_token=token)
    other = b if home is a else a
    assert not other.calls
    home.fail = True
    with pytest.raises(m.store.Expired):
        fan.list_chunk("Notebook", namespace="team-a", limit=10, continue_token=token)
    items, _ = fan.list_chunk("Notebook", namespace="team-a", limit=10)
    assert items == []
    return token, home.base_url, a.calls, b.calls


def fanout_first_page_fails_over_from_healthy_listed_home(m):
    a, b = _FakeEndpoint("a"), _FakeEndpoint("b")
    fan = m.client.ReplicaFanout([a, b], cooldown=30.0)
    probe_home = fan._order(sticky_key="list\x00Notebook\x00team-a")[0]
    home, other = (a, b) if probe_home == 0 else (b, a)
    home.fail = True
    items, _ = fan.list_chunk("Notebook", namespace="team-a", limit=10)
    assert items == [] and any(c[0] == "list_chunk" for c in other.calls)
    return probe_home, other.calls


def fanout_walk_stays_pinned_when_better_endpoint_recovers(m):
    a, b = _FakeEndpoint("a"), _FakeEndpoint("b")
    fan = m.client.ReplicaFanout([a, b], cooldown=30.0)
    home_idx = fan._order(sticky_key="list\x00Notebook\x00team-a")[0]
    home, other = (a, b) if home_idx == 0 else (b, a)
    fan._mark_down(home_idx, OSError("down"))
    _, token = fan.list_chunk("Notebook", namespace="team-a", limit=10)
    assert other.calls and not home.calls
    fan._down_until.clear()
    fan.list_chunk("Notebook", namespace="team-a", limit=10, continue_token=token)
    assert not any(c[0] == "list_chunk" for c in home.calls)
    assert other.calls[-1][2] == f"{other.base_url}-token"
    return home_idx, token, other.calls


def remote_watch_reconnect_window_bounds_a_dead_endpoint(m):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    client = m.client.RemoteAPIServer(f"http://127.0.0.1:{port}", retry_base=0.01, retry_cap=0.05)
    m.apis.register_crds(client)
    w = client.watch("Notebook", reconnect_window=0.3)
    deadline = time.time() + 5
    while time.time() < deadline and not w.ended:
        time.sleep(0.02)
    w.stop()
    assert w.ended and w.error is not None
    return w.ended, w.error is not None


def fanout_rendezvous_stable_under_blip(m):
    eps = [_FakeEndpoint(n) for n in ("a", "b", "c")]
    fan = m.client.ReplicaFanout(eps, cooldown=30.0)
    keys = [f"Kind{i}\x00ns" for i in range(12)]
    before = {k: fan._order(sticky_key=k)[0] for k in keys}
    blipped = before[keys[0]]
    fan._mark_down(blipped, OSError("blip"))
    after = {k: fan._order(sticky_key=k)[0] for k in keys}
    for k in keys:
        assert after[k] == before[k] if before[k] != blipped else after[k] != blipped
    return before, after


def api_from_env_comma_list_builds_fanout(m):
    api = m.client.api_from_env("http://replica-a:8002, http://replica-b:8002")
    assert isinstance(api, m.client.ReplicaFanout)
    urls = [c.base_url for c in api.clients]
    api.register_kind("x.dev/v1", "Gizmo", "gizmos", True)
    plurals = [c.type_info("Gizmo").plural for c in api.clients]
    assert urls == ["http://replica-a:8002", "http://replica-b:8002"]
    return urls, plurals


def remote_client_mirrors_served_rv_header(m):
    api = m.store.APIServer()
    m.apis.register_crds(api)
    _, port, srv = m.httpapi.serve(api, host="127.0.0.1", port=0)
    try:
        client = m.client.RemoteAPIServer(f"http://127.0.0.1:{port}")
        m.apis.register_crds(client)
        assert client.applied_rv() is None
        client.create({"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
                       "metadata": {"name": "nb-rv", "namespace": "team-a"},
                       "spec": {"template": {"spec": {"containers": [{"name": "nb-rv"}]}}}})
        client.list("Notebook", namespace="team-a")
        assert client.applied_rv() == api.applied_rv()
        return client.applied_rv()
    finally:
        srv.shutdown()


SCENARIOS = [
    watchdog_hands_off_failover,
    watchdog_standby_when_not_chosen,
    watchdog_never_promotes_without_a_lease,
    fanout_spreads_and_fails_over,
    fanout_watch_fails_over_past_dead_home,
    fanout_pagination_sticks_to_one_endpoint,
    fanout_first_page_fails_over_from_healthy_listed_home,
    fanout_walk_stays_pinned_when_better_endpoint_recovers,
    remote_watch_reconnect_window_bounds_a_dead_endpoint,
    fanout_rendezvous_stable_under_blip,
    api_from_env_comma_list_builds_fanout,
    remote_client_mirrors_served_rv_header,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_promotion_scenario_equal_on_both(scenario):
    jax_rec, torch_rec = both(scenario)
    assert torch_rec == jax_rec


def test_fenced_write_over_the_wire_is_403_and_not_applied():
    """A write carried with a deposed holder's ``X-Fencing-Token`` (the
    remote client sends the header inside ``fenced``) is 403
    ``FencedOut`` on both packages' façades, and nothing is applied; a
    malformed header is 400."""
    import urllib.error
    import urllib.request

    def scenario(m):
        clock = {"t": 1000.0}
        api = m.store.APIServer()
        api.fence_now_fn = lambda: clock["t"]
        m.apis.register_crds(api)
        _, port, srv = m.httpapi.serve(api, host="127.0.0.1", port=0)
        base = f"http://127.0.0.1:{port}"
        try:
            remote = m.client.RemoteAPIServer(base)
            m.apis.register_crds(remote)
            kw = dict(namespace="default", lease_duration=10.0, now_fn=lambda: clock["t"])
            a = m.leader.LeaderElector(remote, "ctl", identity="a", **kw)
            b = m.leader.LeaderElector(remote, "ctl", identity="b", **kw)
            assert a.try_acquire()
            clock["t"] += 600.0
            assert b.try_acquire()
            nb = {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
                  "metadata": {"name": "nb", "namespace": "team-a"},
                  "spec": {"template": {"spec": {"containers": [{"name": "nb"}]}}}}
            with pytest.raises(m.store.FencedOut):
                with a.fence():
                    remote.create(nb)
            stale = len(api.list("Notebook", namespace="team-a"))
            with b.fence():
                remote.create(nb)
            req = urllib.request.Request(
                base + "/apis/kubeflow.org/v1beta1/namespaces/team-a/notebooks",
                data=b"{}", method="POST", headers={"X-Fencing-Token": "bad"})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req)
            return stale, len(api.list("Notebook", namespace="team-a")), err.value.code
        finally:
            srv.shutdown()

    jax_rec, torch_rec = both(scenario)
    assert torch_rec == jax_rec == (0, 1, 400)
