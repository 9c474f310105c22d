"""The port's all-in-one platform (``platform.py``) and every split-process
``main()``, held to the JAX package's.

- ``tests/test_platform.py``'s spawn over sockets runs on both
  ``Platform``s: tenant onboarding, a POST through the web port's prefix
  router to the JWA, the controller and the sim kubelet to a ready
  notebook, the REST façade's view and the other mounts. The record (every
  status, the row's phase, the accelerator count the StatefulSet asks
  for, the node selector's pool type) must be equal once the TPU names
  are mapped to the GPU ones.
- The restart: a durable ``--sim`` platform restarted on its own
  ``WAL_DIR`` comes up with the same objects (uids, rvs, digests). JAX's
  raises ``AlreadyExists`` there: its simulator creates the recovered
  Node again (``machinery/kubelet.py`` ``add_node``); the port's
  re-registers it.
- One subprocess start of each of the eleven ``main()``s and of ``python
  -m odh_kubeflow_tpu_torch.platform``: each prints its ready line, and
  none imports torch, jax or the JAX package (a directory on the path
  shadows all three and logs any import).
- The split JWA's client names the kinds its rows read (JAX's cannot
  name a Workload), and ``chip_smoke.py``'s ``platform_partitions`` phase
  on the CPU with a stub notebook.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALICE = "alice@example.com"
# JAX's v5e 2x2 slice (4 chips) against 4 GPUs of an H100 pool
ACCEL = {"jax": {"tpus": {"accelerator": "tpu-v5-lite-podslice", "topology": "2x2"}},
         "torch": {"gpus": {"accelerator": "nvidia-h100-80gb", "count": "4"}}}
LIMIT = {"jax": "google.com/tpu", "torch": "nvidia.com/gpu"}
SELECTOR = {"jax": "cloud.google.com/gke-tpu-accelerator",
            "torch": "cloud.google.com/gke-accelerator"}


def _platform_cls(name):
    if name == "jax":
        from odh_kubeflow_tpu.platform import Platform
    else:
        from odh_kubeflow_tpu_torch.platform import Platform
    return Platform


def _add_pool(name, p):
    p.cluster.add_node("cpu-0", cpu="32", memory="128Gi")
    if name == "jax":
        p.cluster.add_tpu_node_pool("tpu-v5e-0", accelerator_type="tpu-v5-lite-podslice",
                                    topology="2x2")
    else:
        p.cluster.add_gpu_node_pool("h100-pool", accelerator_type="nvidia-h100-80gb",
                                    num_nodes=1, gpus_per_node=8)


def _req(base, method, path, body=None, user=ALICE):
    req = urllib.request.Request(base + path, method=method,
                                 data=json.dumps(body).encode() if body is not None else None)
    if user:
        req.add_header("kubeflow-userid", user)
    if method not in ("GET", "HEAD"):
        req.add_header("Cookie", "XSRF-TOKEN=t")
        req.add_header("X-XSRF-TOKEN", "t")
    if body is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def _wait(fn, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.05)
    raise AssertionError("condition not met in time")


def full_spawn_over_sockets(name, monkeypatch):
    for var in ("WAL_DIR", "STORE_PARTITIONS"):
        monkeypatch.delenv(var, raising=False)
    p = _platform_cls(name)(sim=True)
    _add_pool(name, p)
    api_port, web_port = p.start(api_port=0, web_port=0)
    api_base, web_base = f"http://127.0.0.1:{api_port}", f"http://127.0.0.1:{web_port}"
    try:
        p.api.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                      "metadata": {"name": "team-a"},
                      "spec": {"owner": {"kind": "User", "name": ALICE}}})
        _wait(lambda: p.api.list("RoleBinding", namespace="team-a"))
        status, body = _req(web_base, "POST", "/jupyter/api/namespaces/team-a/notebooks",
                            body={"name": "nb1", "image": "jupyter:latest", "cpu": "2",
                                  "memory": "4Gi", **ACCEL[name]})
        assert status == 201, body

        def ready():
            rows = _req(web_base, "GET", "/jupyter/api/namespaces/team-a/notebooks")[1]
            nbs = rows.get("notebooks", [])
            return nbs if nbs and nbs[0]["status"]["phase"] == "ready" else None

        rows = _wait(ready)
        nb_status, _ = _req(api_base, "GET",
                            "/apis/kubeflow.org/v1beta1/namespaces/team-a/notebooks/nb1",
                            user=None)
        sts_status, sts = _req(api_base, "GET",
                               "/apis/apps/v1/namespaces/team-a/statefulsets/nb1", user=None)
        pod_spec = sts["spec"]["template"]["spec"]
        mounts = [_req(web_base, "GET", "/volumes/api/namespaces/team-a/pvcs")[0],
                  _req(web_base, "GET", "/tensorboards/api/namespaces/team-a/tensorboards")[0],
                  _req(web_base, "GET", "/api/workgroup/exists")[0]]
        env_status, env = _req(web_base, "GET", "/api/workgroup/env-info")
        return {"post": status, "phase": rows[0]["status"]["phase"], "rest": nb_status,
                "sts": sts_status,
                "limit": pod_spec["containers"][0]["resources"]["limits"][LIMIT[name]],
                "selector": bool(pod_spec["nodeSelector"].get(SELECTOR[name])),
                "mounts": mounts, "env_info": env_status,
                "namespaces": [n.get("namespace") for n in env.get("namespaces", [])]}
    finally:
        p.stop()


def test_full_spawn_over_sockets_on_both(monkeypatch):
    jax_rec = full_spawn_over_sockets("jax", monkeypatch)
    torch_rec = full_spawn_over_sockets("torch", monkeypatch)
    assert torch_rec == jax_rec
    assert torch_rec["phase"] == "ready" and torch_rec["limit"] == "4"


def _objects(api, kinds=("Profile", "Notebook", "StatefulSet", "Pod", "Node")):
    return {k: sorted((o["metadata"].get("namespace", ""), o["metadata"]["name"],
                       o["metadata"]["uid"], o["metadata"]["resourceVersion"])
                      for o in api.list(k)) for k in kinds}


@pytest.mark.parametrize("partitions", ["1", "3"])
def test_durable_sim_platform_restarts_on_its_wal(tmp_path, monkeypatch, partitions):
    """A ``--sim`` platform on ``WAL_DIR`` (one store, or three partitions)
    is stopped and built again on the same directory: the recovered store
    keeps every object's uid and rv and the digests, and the sim nodes
    re-register without a write. JAX's raises ``AlreadyExists`` at the
    second registration of its node."""
    monkeypatch.setenv("WAL_DIR", str(tmp_path / "wal"))
    monkeypatch.setenv("STORE_PARTITIONS", partitions)
    Platform = _platform_cls("torch")
    p = Platform(sim=True)
    _add_pool("torch", p)
    p.api.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                  "metadata": {"name": "team-a"},
                  "spec": {"owner": {"kind": "User", "name": ALICE}}})
    p.api.create({"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
                  "metadata": {"name": "nb1", "namespace": "team-a"},
                  "spec": {"template": {"spec": {"containers": [
                      {"name": "nb1", "image": "jupyter:latest"}]}}}})
    before, digest, rv = _objects(p.api), p.api.state_digest(), p.api.applied_rv()
    p.api.close()
    again = Platform(sim=True)
    _add_pool("torch", again)
    assert _objects(again.api) == before
    assert (again.api.state_digest(), again.api.applied_rv()) == (digest, rv)
    again.api.close()

    monkeypatch.setenv("WAL_DIR", str(tmp_path / "wal-jax"))
    from odh_kubeflow_tpu.machinery.store import AlreadyExists

    JaxPlatform = _platform_cls("jax")
    first = JaxPlatform(sim=True)
    _add_pool("jax", first)
    first.api.close()
    second = JaxPlatform(sim=True)
    with pytest.raises(AlreadyExists):
        _add_pool("jax", second)
    second.api.close()


# ---------------------------------------------------------------------------
# every main()


MAINS = [
    ("controllers.profile", "profile-controller running"),
    ("controllers.tensorboard", "tensorboard-controller running"),
    ("controllers.exposure", "exposure-controller running"),
    ("sessions.manager", "session-manager running"),
    ("webhooks.server", "admission-webhook on https://"),
    ("webhooks.certs", "webhook certs bootstrapped"),
    ("web.jwa", "jupyter-web-app on http://"),
    ("web.dashboard", "centraldashboard on http://"),
    ("web.vwa", "volumes-web-app on http://"),
    ("web.twa", "tensorboards-web-app on http://"),
    ("web.kfam_app", "kfam on http://"),
    ("platform", "platform up: api http://"),
]


def test_every_main_starts_and_loads_no_torch(tmp_path):
    from odh_kubeflow_tpu_torch.apis import register_crds
    from odh_kubeflow_tpu_torch.machinery import httpapi
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.scheduling import register_scheduling
    from odh_kubeflow_tpu_torch.sessions import register_sessions

    api = APIServer()
    register_crds(api)
    register_scheduling(api)
    register_sessions(api)
    _t, port, httpd = httpapi.serve(api, host="127.0.0.1", port=0)
    poison = tmp_path / "poison"
    log = tmp_path / "imports.log"
    for mod in ("torch", "jax", "odh_kubeflow_tpu"):
        (poison / mod).mkdir(parents=True)
        (poison / mod / "__init__.py").write_text(
            f"with open({str(log)!r}, 'a') as f:\n    f.write('{mod}\\n')\n"
            f"raise ImportError('{mod} is not to be loaded here')\n")
    env = {**os.environ, "PYTHONPATH": ROOT, "KUBE_API_URL": f"http://127.0.0.1:{port}",
           "HOST": "127.0.0.1", "PORT": "0", "METRICS_PORT": "0", "TRACE_EXPORT": "false",
           "CERT_DIR": str(tmp_path / "certs"), "NAMESPACE": "kubeflow",
           "INFORMER_CACHE": "false", "SLO_TICK_SECONDS": "60"}
    procs = {}
    try:
        for module, _ in MAINS:
            argv = [sys.executable, "-m", f"odh_kubeflow_tpu_torch.{module}"]
            if module == "platform":
                argv += ["--sim", "--api-port", "0", "--web-port", "0"]
            procs[module] = subprocess.Popen(
                argv, cwd=str(poison), env=env, stdin=subprocess.DEVNULL,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        seen = {}
        for module, line in MAINS:
            p = procs[module]
            end = time.time() + 60
            out = []
            while time.time() < end:
                got = p.stdout.readline()
                if not got:
                    break
                out.append(got)
                if line in got:
                    seen[module] = got.strip()
                    break
            assert module in seen, (module, "".join(out))
        assert not log.exists(), log.read_text()
        secret = api.get("Secret", "admission-webhook-certs", "kubeflow")
        assert secret["data"]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
            p.stdout.close()
        httpd.shutdown()


def test_split_jwa_client_names_the_kinds_its_rows_read():
    """A split JWA's client registers Workloads, SessionCheckpoints and
    WarmPools before the informer cache picks its kinds, so the listing
    memo and its pages key on the Workload mirror's version. JAX's split
    JWA (``api_from_env`` alone) cannot name a Workload: its rows lose the
    queue position and its pages fall back to a row-count tag."""
    from odh_kubeflow_tpu.machinery.client import api_from_env as jax_api_from_env
    from odh_kubeflow_tpu.machinery.store import NotFound as JaxNotFound
    from odh_kubeflow_tpu_torch.machinery.client import RemoteAPIServer
    from odh_kubeflow_tpu_torch.web.jwa import register_client_kinds

    jax_client = jax_api_from_env(url="http://127.0.0.1:1")
    with pytest.raises(JaxNotFound):
        jax_client.type_info("Workload")
    client = RemoteAPIServer("http://127.0.0.1:1")
    register_client_kinds(client)
    assert {client.type_info(k).plural for k in ("Workload", "SessionCheckpoint", "WarmPool")} \
        == {"workloads", "sessioncheckpoints", "warmpools"}


def test_platform_partitions_phase_on_cpu():
    """``chip_smoke.platform_partitions_phase`` with a stub in place of the
    notebook's 8B serve on the card: the platform (three WAL'd
    partitions), the partitioned follower and the split JWA as real
    processes through their entry points, every gate of the phase."""
    import chip_smoke
    from test_torch_platform_failover import stub_notebook

    record, launches = chip_smoke.platform_partitions_phase(run_notebook=stub_notebook,
                                                            limit_s=120.0)
    assert launches == 21 * chip_smoke.LAUNCHES_PER_FORWARD
    fw, jw, rc = record["follower_walk"], record["jwa_walk"], record["recovery"]
    assert fw["stable_in_order"] and not fw["duplicates"] and fw["composite_tokens"]
    assert len(jw["rows"]) == 4 and jw["stale_token"] == 410
    assert all(len(s) == 3 for s in jw["served_rv_partitions"])
    assert rc["states_equal"] and rc["identities_equal"] and rc["follower_pid_kept"]
    assert rc["states_after"] == rc["follower_after"]
    assert rc["objects"] == {"Profile": 6, "Notebook": 30, "StatefulSet": 30}
    assert not any(record["reference"].values()) and not record["exited"]
