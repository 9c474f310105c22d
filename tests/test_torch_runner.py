"""The port's split-process runner (``machinery/runner.py``), its
``/metrics`` server (``utils/prometheus.serve_metrics``) and the two
controller entry points that go through it (``python -m
odh_kubeflow_tpu_torch.controllers.notebook`` and ``...scheduling.
scheduler``), held to the JAX package's where both packages run.

The env wiring (``READ_FROM_REPLICA``, ``INFORMER_CACHE``, the config
``from_env``) builds the same shapes on both packages; the port's
deliberate differences are pinned here: ``PARTITION_LEADERS`` is refused
until the partition router is ported, a short ``LEASE_DURATION`` renews
inside its own window, and the informer cache's counters are on the
registry the runner serves.
"""

import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from test_torch_leader import pkg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def clean_env(monkeypatch):
    for k in ("READ_FROM_REPLICA", "INFORMER_CACHE", "PARTITION_LEADERS"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("value", ["", "http://127.0.0.1:1", "http://127.0.0.1:1,http://127.0.0.1:2"])
def test_split_reads_builds_the_same_read_arm(clean_env, value):
    shapes = []
    for name in ("jax", "torch"):
        m = pkg(name)
        clean_env.setenv("READ_FROM_REPLICA", value)
        api = m.store.APIServer()
        got = m.runner._split_reads(api)
        if not value:
            assert got is api
            shapes.append(None)
            continue
        read = got.read_api
        urls = ([c.base_url for c in read.clients] if hasattr(read, "clients")
                else [read.base_url])
        shapes.append((type(got).__name__, type(read).__name__, urls, got.write_api is api))
    assert shapes[0] == shapes[1]


@pytest.mark.parametrize("flag", ["true", "false"])
def test_wrap_cached_caches_the_registered_kinds(clean_env, flag):
    kinds = []
    for name in ("jax", "torch"):
        m = pkg(name)
        clean_env.setenv("INFORMER_CACHE", flag)
        api = m.store.APIServer()
        m.apis.register_crds(api)
        got, cache = m.runner._wrap_cached(api)
        if flag == "false":
            assert got is api and cache is None
            kinds.append(None)
            continue
        assert type(got).__name__ == "CachedClient" and got.cache is cache
        kinds.append(sorted(cache.kinds()))
    assert kinds[0] == kinds[1]


def test_wrap_cached_counters_land_on_the_served_registry(clean_env):
    m = pkg("torch")
    registry = m.prometheus.Registry()
    api = m.store.APIServer()
    api.create({"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "p", "namespace": "a"},
                "spec": {}})
    client, cache = m.runner._wrap_cached(api, registry)
    cache.start(live=False)
    client.get("Pod", "p", "a")
    assert 'cache_hits_total{kind="Pod"} 1' in registry.exposition()


def test_partition_leaders_route_through_one_client_a_leader(clean_env):
    """``PARTITION_LEADERS`` routes: one remote client per leader behind a
    ``PartitionRouter`` that owns every partition, as JAX's runner
    builds it; unset, the api passes through."""
    shapes = []
    for name in ("jax", "torch"):
        m = pkg(name)
        api = m.store.APIServer()
        clean_env.delenv("PARTITION_LEADERS", raising=False)
        assert m.runner._partition_leaders(api) is api
        clean_env.setenv("PARTITION_LEADERS", "http://127.0.0.1:1/, http://127.0.0.1:2")
        router = m.runner._partition_leaders(api)
        assert type(router).__name__ == "PartitionRouter"
        assert all(type(b).__name__ == "RemoteAPIServer" for b in router.backends.values())
        shapes.append((router.partition_count, sorted(router.owned), router.urls,
                       {p: b.base_url for p, b in router.backends.items()},
                       [router.owner_of(f"team-{i}") for i in range(32)]))
    assert shapes[0] == shapes[1]
    assert shapes[1][2] == {0: "http://127.0.0.1:1", 1: "http://127.0.0.1:2"}


def test_lease_periods_default_to_the_jax_runner_and_fit_short_leases():
    periods = pkg("torch").runner._lease_periods
    # the JAX runner's LeaderElector defaults at its 15 s lease
    jax_elector = pkg("jax").leader.LeaderElector(pkg("jax").store.APIServer(), "x")
    assert periods(15.0) == {"renew_period": jax_elector.renew_period,
                             "retry_period": jax_elector.retry_period}
    assert periods(6.0) == {"renew_period": 2.0, "retry_period": 1.5}


def test_serve_metrics_serves_the_registry_on_both():
    bodies = []
    for name in ("jax", "torch"):
        prom = pkg(name).prometheus
        reg = prom.Registry()
        reg.counter("widgets_made_total", "Widgets made", labelnames=("kind",)).inc({"kind": "a"})
        reg.gauge("widget_depth", "Depth").set(3)
        _t, port, httpd = prom.serve_metrics(reg, "127.0.0.1", 0)
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
                bodies.append((r.headers["Content-Type"], r.read().decode()))
            req = urllib.request.Request(f"http://127.0.0.1:{port}/",
                                         headers={"Accept": "application/openmetrics-text"})
            with urllib.request.urlopen(req) as r:
                assert r.read().decode().endswith("# EOF\n")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
            assert err.value.code == 404
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert bodies[0] == bodies[1]
    assert 'widgets_made_total{kind="a"} 1' in bodies[1][1]


def test_notebook_controller_config_from_env_matches(clean_env):
    """The port's ``from_env`` reads the JAX names but for the TPU ones,
    which become GPU names."""
    env = {"USE_ISTIO": "true", "ISTIO_HOST": "nb.example", "CLUSTER_DOMAIN": "c.local",
           "ADD_FSGROUP": "false", "ENABLE_CULLING": "true", "CULL_IDLE_TIME": "30",
           "IDLENESS_CHECK_PERIOD": "2", "ENABLE_SESSION_SUSPEND": "false",
           "SESSION_SUSPEND_GRACE_SECONDS": "90", "COMPILE_CACHE_MOUNT": "/cache"}
    for k, v in env.items():
        clean_env.setenv(k, v)
    clean_env.setenv("ENABLE_TPU_QUEUEING", "false")
    clean_env.setenv("ENABLE_GPU_QUEUEING", "false")
    clean_env.setenv("CULL_CHECK_TPU_DUTY_CYCLE", "false")
    clean_env.setenv("CULL_CHECK_GPU_DUTY_CYCLE", "false")
    j = pkg("jax").notebook.NotebookControllerConfig.from_env()
    t = pkg("torch").notebook.NotebookControllerConfig.from_env()
    jd, td = dict(vars(j)), dict(vars(t))
    assert jd.pop("cull_check_tpu_duty_cycle") is td.pop("cull_check_gpu_duty_cycle") is False
    assert jd == td


def _serve_store():
    m = pkg("torch")
    api = m.store.APIServer()
    m.apis.register_crds(api)
    m.scheduling.register_scheduling(api)
    _t, port, httpd = m.httpapi.serve(api, host="127.0.0.1", port=0)
    return api, f"http://127.0.0.1:{port}", httpd


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(module, env, tmp_path):
    return subprocess.Popen(
        [sys.executable, "-m", module], cwd=str(tmp_path), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": ROOT, "TRACE_EXPORT": "false", **env})


def _wait_for(proc, needle, limit=60.0):
    end = time.time() + limit
    lines = []
    while time.time() < end:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if needle in line:
            return lines
    raise AssertionError(f"no {needle!r}: {''.join(lines)}")


def test_notebook_controller_main_reconciles_through_the_runner(tmp_path):
    """``python -m odh_kubeflow_tpu_torch.controllers.notebook`` against a
    served store: it takes its lease, serves ``/metrics`` (the informer
    cache's counters and the reconciles), materialises a notebook's
    StatefulSet from the cache, and on SIGINT stops and releases the
    lease."""
    api, url, httpd = _serve_store()
    port = _free_port()
    proc = _start("odh_kubeflow_tpu_torch.controllers.notebook", {
        "KUBE_API_URL": url, "LEADER_ELECT": "true", "LEASE_DURATION": "3",
        "METRICS_PORT": str(port), "METRICS_HOST": "127.0.0.1",
        "ENABLE_SESSION_SUSPEND": "false"}, tmp_path)
    try:
        _wait_for(proc, "notebook-controller running")
        lease = api.get("Lease", "notebook-controller-leader", "kubeflow")["spec"]
        assert lease["holderIdentity"].endswith(f"_{proc.pid}")
        assert lease["leaseDurationSeconds"] == 3
        api.create({"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
                    "metadata": {"name": "nb", "namespace": "team-a"},
                    "spec": {"template": {"spec": {"containers": [
                        {"name": "nb", "image": "jupyter:latest"}]}}}})
        end = time.time() + 30
        while time.time() < end and not api.list("StatefulSet", namespace="team-a"):
            time.sleep(0.05)
        assert [s["metadata"]["name"] for s in api.list("StatefulSet", namespace="team-a")] == [
            "nb"]
        want = 'controller_runtime_reconcile_total{controller="notebook-controller"'
        end = time.time() + 10
        while True:  # the count lands as the reconcile returns
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
                text = r.read().decode()
            if want in text or time.time() > end:
                break
            time.sleep(0.05)
        assert 'cache_hits_total{kind="' in text
        assert want in text
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=30)
        assert proc.returncode == 0
        released = api.get("Lease", "notebook-controller-leader", "kubeflow")["spec"]
        assert released["holderIdentity"] == ""
        assert released["fencingToken"] == lease["fencingToken"] + 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        httpd.shutdown()


def test_scheduler_main_runs_and_a_replica_serves_its_reads(tmp_path):
    """``python -m odh_kubeflow_tpu_torch.machinery.replica`` follows the
    served store, and the scheduler's ``main()`` runs against it with its
    reads from the replica (``READ_FROM_REPLICA``), its writes 307'd to
    the leader."""
    api, url, httpd = _serve_store()
    rport = _free_port()
    replica = _start("odh_kubeflow_tpu_torch.machinery.replica", {
        "REPLICA_OF": url, "HOST": "127.0.0.1", "PORT": str(rport)}, tmp_path)
    sched = None
    try:
        _wait_for(replica, "serving reads on")
        rurl = f"http://127.0.0.1:{rport}"
        sched = _start("odh_kubeflow_tpu_torch.scheduling.scheduler", {
            "KUBE_API_URL": rurl, "READ_FROM_REPLICA": f"{rurl},{url}",
            "LEADER_ELECT": "true", "LEASE_DURATION": "3", "METRICS_PORT": "0",
            "ENABLE_SESSION_SUSPEND": "false"}, tmp_path)
        _wait_for(sched, "gpu-scheduler running")
        # the lease was written through the replica's 307 to the leader
        assert api.get("Lease", "gpu-scheduler-leader", "kubeflow")["spec"][
            "holderIdentity"].endswith(f"_{sched.pid}")
    finally:
        for p in (sched, replica):
            if p is not None:
                if p.poll() is None:
                    p.send_signal(signal.SIGINT)
                    try:
                        p.wait(timeout=20)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                p.stdout.close()
        httpd.shutdown()
