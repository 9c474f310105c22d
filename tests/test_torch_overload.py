"""The port's overload defense (``machinery/overload.py``, ``backoff.py``'s
budget and ambient deadline, the store's deadline-bounded ack wait, the
REST façade's admission and the remote client's breaker) held to the JAX
package's.

Every test of ``tests/test_overload.py`` but the two on the partition
router is carried over and runs on both packages (``m``); a seeded
script of budget spends and refills, breaker outcomes and priority
inputs must leave both packages in equal states. ``wire`` is the shared
two-package module table of the port's wire tests.
"""

import importlib
import json
import random
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

ROOTS = {"jax": "odh_kubeflow_tpu", "torch": "odh_kubeflow_tpu_torch"}
_MODULES = {
    "apis": "apis",
    "store": "machinery.store",
    "httpapi": "machinery.httpapi",
    "client": "machinery.client",
    "overload": "machinery.overload",
    "backoff": "machinery.backoff",
    "cache": "machinery.cache",
    "eventloop": "machinery.eventloop",
    "zpages": "machinery.zpages",
    "serialize": "machinery.serialize",
    "objects": "machinery.objects",
    "rbac": "machinery.rbac",
    "prometheus": "utils.prometheus",
    "tracing": "utils.tracing",
    "microweb": "web.microweb",
    "crud_backend": "web.crud_backend",
    "runtime": "controllers.runtime",
    "notebook": "controllers.notebook",
    "certs": "webhooks.certs",
    "nb_webhook": "webhooks.notebook",
    "partition": "machinery.partition",
    "leader": "machinery.leader",
    "faults": "machinery.faults",
    "wal": "machinery.wal",
    "replica": "machinery.replica",
    "scheduling": "scheduling",
    "jwa": "web.jwa",
    "vwa": "web.vwa",
    "twa": "web.twa",
    "cloudiam": "machinery.cloudiam",
    "profile": "controllers.profile",
}


def wire(name: str) -> types.SimpleNamespace:
    """One package's wire modules by short name (``name`` "jax" or
    "torch")."""
    return types.SimpleNamespace(
        name=name,
        **{k: importlib.import_module(f"{ROOTS[name]}.{v}") for k, v in _MODULES.items()},
    )


@pytest.fixture(params=["jax", "torch"])
def m(request):
    """Both packages' modules, each test starting with a clean deadline
    context and a fresh shared budget (the singleton survives across
    tests otherwise)."""
    mods = wire(request.param)
    assert mods.overload.current_deadline() is None
    mods.overload._reset_shared_budget_for_tests()
    yield mods
    mods.overload._reset_shared_budget_for_tests()


def _nb(name="nb1", ns="team-a"):
    return {
        "apiVersion": "kubeflow.org/v1beta1",
        "kind": "Notebook",
        "metadata": {"name": name, "namespace": ns},
        "spec": {"template": {"spec": {"containers": [{"name": name, "image": "j:x"}]}}},
    }


# ---------------------------------------------------------------------------
# deadlines: contextvar, scope, wire format


def test_deadline_contextvar_roundtrip(m):
    ov = m.overload
    assert ov.remaining() is None and not ov.expired()
    tok = ov.set_deadline(time.monotonic() + 5.0)
    try:
        assert 4.0 < ov.remaining() <= 5.0
        assert not ov.expired()
        assert 4.0 < float(ov.header_value()) <= 5.0
    finally:
        ov.reset_deadline(tok)
    assert ov.current_deadline() is None
    assert ov.header_value() is None


def test_expired_deadline_clamps_header_to_zero(m):
    ov = m.overload
    tok = ov.set_deadline(time.monotonic() - 1.0)
    try:
        assert ov.expired()
        assert ov.header_value() == "0.000"
    finally:
        ov.reset_deadline(tok)


def test_deadline_scope_never_loosens(m):
    ov = m.overload
    tight = time.monotonic() + 0.5
    tok = ov.set_deadline(tight)
    try:
        with ov.deadline_scope(30.0):
            assert ov.current_deadline() == tight
        with ov.deadline_scope(0.1):
            assert ov.current_deadline() < tight
        assert ov.current_deadline() == tight
    finally:
        ov.reset_deadline(tok)


def test_deadline_scope_knob_off_installs_nothing(m, monkeypatch):
    monkeypatch.setenv("REQUEST_DEADLINE_DEFAULT", "0")
    with m.overload.deadline_scope():
        assert m.overload.current_deadline() is None


def test_environ_deadline_anchors_on_arrival_stamp(m):
    ov = m.overload
    arrival = time.monotonic() - 3.0
    environ = {"HTTP_X_REQUEST_DEADLINE": "2.5", "odh.request.arrival": arrival}
    assert ov.environ_deadline(environ) == arrival + 2.5
    assert ov.environ_deadline({"HTTP_X_REQUEST_DEADLINE": ""}) is None
    assert ov.environ_deadline({}) is None
    with pytest.raises(ValueError):
        ov.environ_deadline({"HTTP_X_REQUEST_DEADLINE": "soon"})


# ---------------------------------------------------------------------------
# retry budget


def test_retry_budget_spend_and_refill(m):
    reg = m.prometheus.Registry()
    b = m.overload.RetryBudget(ratio=0.5, cap=2.0, registry=reg)
    assert b.try_spend() and b.try_spend()
    assert not b.try_spend()
    assert b.tokens() == 0.0
    b.on_success()
    assert b.tokens() == 0.5
    b.on_success()
    assert b.try_spend()
    for _ in range(100):
        b.on_success()
    assert b.tokens() == 2.0
    assert reg.counter("retry_budget_spent_total", "x").value() == 3
    assert reg.counter("retry_budget_exhausted_total", "x").value() >= 1


def test_backoff_retry_stops_on_dry_budget(m):
    budget = m.overload.RetryBudget(ratio=0.1, cap=1.0, registry=m.prometheus.Registry())
    calls = []

    def flaky():
        calls.append(1)
        raise m.store.Conflict("racing")

    with pytest.raises(m.store.Conflict):
        m.backoff.retry(flaky, retryable=m.store.Conflict, attempts=10,
                        sleep_fn=lambda s: None, budget=budget)
    assert len(calls) == 2  # 1 try + exactly cap=1 budgeted retry


def test_backoff_retry_success_refills_budget(m):
    budget = m.overload.RetryBudget(ratio=0.25, cap=4.0, registry=m.prometheus.Registry())
    budget._tokens = 0.0
    assert m.backoff.retry(lambda: "ok", budget=budget) == "ok"
    assert budget.tokens() == 0.25


def test_backoff_retry_never_sleeps_past_deadline(m):
    calls, slept = [], []

    def flaky():
        calls.append(1)
        raise m.store.Conflict("racing")

    with pytest.raises(m.store.Conflict):
        m.backoff.retry(flaky, retryable=m.store.Conflict, attempts=50, base=10.0,
                        cap=20.0, sleep_fn=slept.append,
                        deadline=time.monotonic() + 1.0)
    assert len(calls) == 1 and slept == []


def test_backoff_retry_consults_ambient_deadline(m):
    tok = m.overload.set_deadline(time.monotonic() + 0.5)
    try:
        calls = []

        def flaky():
            calls.append(1)
            raise m.store.Conflict("racing")

        with pytest.raises(m.store.Conflict):
            m.backoff.retry(flaky, retryable=m.store.Conflict, attempts=50,
                            base=5.0, cap=5.0, sleep_fn=lambda s: None)
        assert len(calls) == 1
    finally:
        m.overload.reset_deadline(tok)


def test_backoff_delays_match(m):
    """``delays`` yields ``attempts - 1`` decorrelated steps, equal to
    the reference's for one seed."""
    ref = wire("jax").backoff
    got = list(m.backoff.delays(6, base=0.05, cap=2.0, rng=random.Random(7)))
    want = list(ref.delays(6, base=0.05, cap=2.0, rng=random.Random(7)))
    assert got == want and len(got) == 5
    assert list(m.backoff.delays(1)) == []


# ---------------------------------------------------------------------------
# circuit breaker


def _clock():
    state = {"t": 1000.0}

    def now():
        return state["t"]

    now.advance = lambda dt: state.__setitem__("t", state["t"] + dt)
    return now


def test_breaker_trips_at_threshold_and_probes_half_open(m):
    now = _clock()
    b = m.overload.CircuitBreaker(window=10.0, threshold=0.5, min_requests=4,
                                  cooldown=2.0, slow_seconds=5.0, clock=now)
    assert b.state == b.CLOSED
    for ok in (True, True, False, False):
        assert b.allow()
        b.record(ok)
    assert b.state == b.OPEN and b.blocking
    assert b.retry_after() == pytest.approx(2.0)
    assert not b.allow()
    now.advance(2.1)
    assert b.allow()
    assert b.state == b.HALF_OPEN
    assert not b.allow()
    b.record(True)
    assert b.state == b.CLOSED
    assert b.allow()


def test_breaker_probe_failure_reopens(m):
    now = _clock()
    b = m.overload.CircuitBreaker(window=10.0, threshold=0.5, min_requests=2,
                                  cooldown=1.0, clock=now)
    b.record(False)
    b.record(False)
    assert b.state == b.OPEN
    now.advance(1.5)
    assert b.allow()
    b.record(False)
    assert b.state == b.OPEN
    assert not b.allow()


def test_breaker_slow_success_counts_as_failure(m):
    b = m.overload.CircuitBreaker(window=10.0, threshold=0.5, min_requests=2,
                                  cooldown=1.0, slow_seconds=0.2, clock=_clock())
    b.record(True, latency=5.0)
    b.record(True, latency=5.0)
    assert b.state == b.OPEN


def test_breaker_window_prunes_old_samples(m):
    now = _clock()
    b = m.overload.CircuitBreaker(window=1.0, threshold=0.5, min_requests=3,
                                  cooldown=1.0, clock=now)
    b.record(False)
    b.record(False)
    now.advance(5.0)
    b.record(False)
    assert b.state == b.CLOSED


# ---------------------------------------------------------------------------
# priority levels


def test_level_ceilings_are_cumulative_and_never_zero(m):
    assert m.overload.level_ceilings(100) == (100, 90, 75, 50)
    assert m.overload.level_ceilings(1) == (1, 1, 1, 1)


def test_classify_priority(m):
    ov = m.overload
    assert ov.classify(kind="Lease") == ov.LEVEL_SYSTEM
    assert ov.classify(path="/replication/stream") == ov.LEVEL_SYSTEM
    assert ov.classify(controller=True) == ov.LEVEL_CONTROLLER
    assert ov.classify(kind="Notebook") == ov.LEVEL_USER
    assert ov.classify(kind="Lease", header="background") == ov.LEVEL_BACKGROUND
    assert ov.classify(header="bogus") == ov.LEVEL_USER


def test_inflight_limiter_priority_ceilings(m):
    ov = m.overload
    reg = m.prometheus.Registry()
    lim = m.httpapi.InflightLimiter(4, registry=reg)  # ceilings 4/3/3/2
    assert lim.try_acquire("bg1", level=ov.LEVEL_BACKGROUND)
    assert lim.try_acquire("bg2", level=ov.LEVEL_BACKGROUND)
    assert not lim.try_acquire("bg3", level=ov.LEVEL_BACKGROUND)
    assert lim.try_acquire("u1", level=ov.LEVEL_USER)
    assert not lim.try_acquire("u2", level=ov.LEVEL_USER)
    assert lim.try_acquire("sys", level=ov.LEVEL_SYSTEM)
    assert not lim.try_acquire("sys2", level=ov.LEVEL_SYSTEM)
    lim.release("bg1")
    assert lim.try_acquire("sys2", level=ov.LEVEL_SYSTEM)
    shed = reg.counter("inflight_shed_total", "x", labelnames=("level", "reason"))
    assert shed.value({"level": "background", "reason": "level"}) == 1
    assert shed.value({"level": "user", "reason": "level"}) == 1


def test_inflight_limiter_per_client_cap_still_applies(m):
    lim = m.httpapi.InflightLimiter(2)
    assert lim.try_acquire("a", level=m.overload.LEVEL_SYSTEM)
    assert lim.try_acquire("a", level=m.overload.LEVEL_SYSTEM)
    assert not lim.try_acquire("a", level=m.overload.LEVEL_SYSTEM)


def test_inflight_limiter_sheds_expired_deadline_with_504(m):
    reg = m.prometheus.Registry()
    lim = m.httpapi.InflightLimiter(4, registry=reg)
    with pytest.raises(m.store.DeadlineExceeded):
        lim.try_acquire("a", deadline=time.monotonic() - 0.1)
    shed = reg.counter("inflight_shed_total", "x", labelnames=("level", "reason"))
    assert shed.value({"level": "user", "reason": "deadline"}) == 1


def _overload_script(pkg_name: str, seed: int) -> list:
    """A seeded run of budget spends and refills, breaker records and
    allows on an injected clock, ``classify`` and ``level_ceilings``
    inputs, and limiter acquires and releases; every outcome and the
    final states, in order."""
    mods = wire(pkg_name)
    ov, rng = mods.overload, random.Random(seed)
    reg = mods.prometheus.Registry()
    budget = ov.RetryBudget(ratio=0.3, cap=5.0, registry=reg)
    now = _clock()
    breaker = ov.CircuitBreaker(window=3.0, threshold=0.4, min_requests=3, cooldown=1.5,
                                slow_seconds=0.5, clock=now)
    limiter = mods.httpapi.InflightLimiter(8, registry=reg)
    held: list = []
    out = []
    for _ in range(400):
        op = rng.randrange(7)
        if op == 0:
            out.append(("spend", budget.try_spend(), round(budget.tokens(), 9)))
        elif op == 1:
            budget.on_success()
            out.append(("refill", round(budget.tokens(), 9)))
        elif op == 2:
            out.append(("allow", breaker.allow(), breaker.state))
        elif op == 3:
            breaker.record(rng.random() < 0.6, latency=rng.choice((0.0, 0.1, 0.9)))
            out.append(("record", breaker.state, round(breaker.retry_after(), 9)))
            now.advance(rng.choice((0.1, 0.5, 2.0)))
        elif op == 4:
            kind = rng.choice(("Lease", "Notebook", "Pod", None))
            path = rng.choice(("", "/replication/stream", "/api/v1/pods"))
            header = rng.choice((None, "system", "user", "background", "bogus", " Controller "))
            out.append(("classify", ov.classify(kind=kind, path=path, header=header,
                                                controller=rng.random() < 0.3)))
            out.append(("ceilings", ov.level_ceilings(rng.randrange(1, 300))))
        elif op == 5:
            client = rng.choice(("a", "b", "c"))
            level = rng.randrange(4)
            ok = limiter.try_acquire(client, level=level)
            if ok:
                held.append(client)
            out.append(("acquire", client, level, ok))
        elif held:
            client = held.pop(rng.randrange(len(held)))
            limiter.release(client)
            out.append(("release", client))
    shed = reg.counter("inflight_shed_total", "x", labelnames=("level", "reason"))
    out.append(("shed", sorted((tuple(sorted(k.items())), v) for k, v in shed.samples())))
    out.append(("budget", round(budget.tokens(), 9),
                reg.counter("retry_budget_spent_total", "x").value(),
                reg.counter("retry_budget_exhausted_total", "x").value()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_overload_script_equal_states(seed):
    assert _overload_script("torch", seed) == _overload_script("jax", seed)


# ---------------------------------------------------------------------------
# wiring: store ack wait, REST façade, event loop, client


def test_group_commit_ack_wait_is_deadline_bounded(m):
    ov = m.overload
    server = m.store.APIServer()
    stuck = types.SimpleNamespace(done=threading.Event(), error=None)
    tok = ov.set_deadline(time.monotonic() - 0.1)
    try:
        with pytest.raises(m.store.DeadlineExceeded) as ei:
            server._await(stuck)
        assert "durable" in str(ei.value)
    finally:
        ov.reset_deadline(tok)
    tok = ov.set_deadline(time.monotonic() + 0.05)
    try:
        t0 = time.monotonic()
        with pytest.raises(m.store.DeadlineExceeded):
            server._await(stuck)
        assert time.monotonic() - t0 < 2.0
    finally:
        ov.reset_deadline(tok)
    stuck.done.set()
    assert server._await(stuck) is None


def test_wal_write_under_an_expired_ack_deadline_still_commits(tmp_path):
    """The port's durable store: a create whose deadline runs out while
    its record waits for the committer answers 504, and the record still
    becomes durable (it is read back after the committer catches up)."""
    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.machinery import overload
    from odh_kubeflow_tpu_torch.machinery.store import APIServer, DeadlineExceeded
    from odh_kubeflow_tpu_torch.machinery.wal import WriteAheadLog

    wal = WriteAheadLog(str(tmp_path))
    api = APIServer(wal=wal)
    apis.register_crds(api)
    gate = threading.Event()
    sync = wal.sync

    def held_sync():  # a wedged disk: the covering fsync waits
        gate.wait(10)
        sync()

    wal.sync = held_sync
    try:
        tok = overload.set_deadline(time.monotonic() + 0.05)
        try:
            with pytest.raises(DeadlineExceeded):
                api.create(_nb("late"))
        finally:
            overload.reset_deadline(tok)
        gate.set()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            try:
                assert api.get("Notebook", "late", "team-a")["metadata"]["name"] == "late"
                break
            except Exception:  # noqa: BLE001 — not applied yet
                time.sleep(0.01)
        else:
            raise AssertionError("the record never committed")
    finally:
        gate.set()
        api.close()


@pytest.fixture(params=[False, True], ids=["threaded", "eventloop"])
def served(request, m):
    server = m.store.APIServer()
    m.apis.register_crds(server)
    _, port, httpd = m.httpapi.serve(server, port=0, event_loop=request.param)
    yield server, port
    httpd.shutdown()


def test_rest_facade_sheds_expired_deadline_with_504(m, served):
    _, port = served
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v1/namespaces/team-a/notebooks",
        headers={m.overload.DEADLINE_HEADER: "0.000"},
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 504
    assert json.loads(ei.value.read().decode())["reason"] == "DeadlineExceeded"


def test_rest_facade_rejects_malformed_deadline_with_400(m, served):
    _, port = served
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v1/namespaces/team-a/notebooks",
        headers={m.overload.DEADLINE_HEADER: "soon"},
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400


def test_rest_facade_serves_within_deadline(m, served):
    _, port = served
    client = m.client.RemoteAPIServer(f"http://127.0.0.1:{port}",
                                      registry=m.prometheus.Registry())
    m.apis.register_crds(client)
    with m.overload.deadline_scope(30.0):
        created = client.create(_nb("dl-ok"))
    assert created["metadata"]["uid"]


def test_client_maps_504_and_does_not_retry_it(m, served):
    _, port = served
    reg = m.prometheus.Registry()
    client = m.client.RemoteAPIServer(f"http://127.0.0.1:{port}", registry=reg)
    m.apis.register_crds(client)
    tok = m.overload.set_deadline(time.monotonic() - 0.1)
    try:
        with pytest.raises(m.store.DeadlineExceeded):
            client.get("Notebook", "x", "team-a")
    finally:
        m.overload.reset_deadline(tok)
    assert reg.counter("client_retries_total", "x",
                       labelnames=("verb", "reason")).value() == 0


def test_client_breaker_open_sheds_locally(m):
    breaker = m.overload.CircuitBreaker(min_requests=1, threshold=0.1, cooldown=60.0)
    breaker._state = breaker.OPEN
    breaker._open_until = time.monotonic() + 60.0
    client = m.client.RemoteAPIServer("http://127.0.0.1:1", breaker=breaker, retries=1,
                                      registry=m.prometheus.Registry())
    m.apis.register_crds(client)
    with pytest.raises(m.store.TooManyRequests) as ei:
        client.get("Notebook", "x", "team-a")
    assert ei.value.retry_after > 0


def test_watch_reconnects_shed_through_open_breaker(m):
    breaker = m.overload.CircuitBreaker(cooldown=60.0)
    breaker._state = breaker.OPEN
    breaker._open_until = time.monotonic() + 60.0
    reg = m.prometheus.Registry()
    client = m.client.RemoteAPIServer("http://127.0.0.1:1", breaker=breaker, registry=reg)
    m.apis.register_crds(client)
    client._sleep = lambda s: None
    w = client.watch("Notebook", reconnect_window=0.0)
    deadline = time.monotonic() + 5.0
    while not w.ended and time.monotonic() < deadline:
        time.sleep(0.01)
    assert w.ended and w.error is not None
    assert reg.counter("watch_reconnects_shed_total", "x").value() >= 1


def test_client_declares_its_priority_level():
    """The port's client option: ``priority_level`` rides every call as
    ``X-Priority-Level``, which the façade's classification honours (a
    declared controller is admitted past the user ceiling)."""
    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.machinery import httpapi, overload
    from odh_kubeflow_tpu_torch.machinery.client import RemoteAPIServer
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.utils.prometheus import Registry

    server = APIServer()
    apis.register_crds(server)
    reg = Registry()
    _, port, httpd = httpapi.serve(server, inflight_limit=10, metrics_registry=reg)
    try:
        # hold the user ceiling (7 of 10 seats; controllers may fill 9)
        # from other identities
        limiter = httpd._app.limiter  # the event-loop server's WSGI app
        for i in range(7):
            assert limiter.try_acquire(f"flood-{i}", level=overload.LEVEL_USER)
        user = RemoteAPIServer(f"http://127.0.0.1:{port}", retries=1, registry=Registry())
        ctl = RemoteAPIServer(f"http://127.0.0.1:{port}", retries=1, registry=Registry(),
                              priority_level="controller")
        apis.register_crds(user)
        apis.register_crds(ctl)
        with pytest.raises(Exception) as ei:
            user.list("Notebook", namespace="team-a")
        assert type(ei.value).__name__ == "TooManyRequests"
        assert ctl.list("Notebook", namespace="team-a") == []
        shed = reg.metric("inflight_shed_total")
        assert shed.value({"level": "user", "reason": "level"}) == 1
        assert shed.value({"level": "controller", "reason": "level"}) == 0
    finally:
        httpd.shutdown()


# ---------------------------------------------------------------------------
# metrics contract


def test_overload_metrics_pass_naming_lint(m):
    reg = m.prometheus.Registry()
    m.overload.RetryBudget(registry=reg)
    m.httpapi.InflightLimiter(4, registry=reg)
    m.client.RemoteAPIServer("http://127.0.0.1:1", registry=reg)
    names = {metric.name for metric in reg.metrics()}
    for expected in ("retry_budget_spent_total", "retry_budget_exhausted_total",
                     "inflight_shed_total", "watch_reconnects_shed_total"):
        assert expected in names
    assert m.prometheus.lint_metric_names(reg) == []
