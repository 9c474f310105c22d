"""The port's dashboard, VWA, TWA and kfam apps against the JAX package's,
over real HTTP sockets (port 0), on the CPU.

The same requests go to both packages' apps on one seeded scenario
(``test_torch_web.Side``: the store, the PodDefault webhook, the kubelet
simulator, the notebook, profile and tensorboard controllers, alice
owning ``team-a``; a v5e 2x2 slice is one L4 node of 4 GPUs). Each
answer from JAX, carried through ``apis.ACCELERATOR_MAPPING`` and
``test_torch_web.web_to_port`` (volatile fields scrubbed: ages, event
times, a local file's mtime), must equal the port's: PVC rows with the
pods that mount them, Tensorboard rows and their ``/logs`` listing
(containment under ``TWA_LOCAL_LOGS_ROOT`` included), kfam bindings and
profiles, the dashboard's workgroup routes, quota panel, activities,
GPU panel, ``/api/usage`` (503 without a meter) and ``/api/slo`` rows —
and the 403s for users without access.
"""

from __future__ import annotations

from odh_kubeflow_tpu_torch.apis import ACCELERATOR_MAPPING
from test_torch_platform import scrub
from test_torch_web import ALICE, NS, Client, Side, web_to_port

BOB = "bob@example.com"
STRANGER = "stranger@example.com"
ROOT = "root@example.com"
# the volatile fields of the apps' rows (the scenario's wall clock)
_TIMES = {"age", "time", "timestamp", "modified"}
# the dashboard's platform text (values, not keys) in each package's terms
_PLATFORM = {"tpu-native-0.1.0": "gpu-native-0.1.0", "gke-tpu": "gke-gpu"}


def events(response):
    """An events feed's rows in a fixed order: the apps sort them by
    their wall-clock second, which two runs need not share."""
    status, body = response
    return [status, sorted((e["involved"], e["reason"], e["type"], e["message"])
                           for e in body["events"])]


def norm(obj):
    if isinstance(obj, dict):
        return {k: norm(v) for k, v in obj.items() if k not in _TIMES}
    if isinstance(obj, (list, tuple)):
        return [norm(v) for v in obj]
    if isinstance(obj, str):  # a whole value that names a TPU thing (a quota key)
        return _PLATFORM.get(obj, ACCELERATOR_MAPPING.get(obj, obj))
    return obj


class AppsSide(Side):
    """``test_torch_web.Side`` plus the tensorboard controller, the VWA,
    TWA, kfam app and dashboard (``root`` a cluster admin of kfam)."""

    def __init__(self, port: bool):
        super().__init__(port)
        if port:
            from odh_kubeflow_tpu_torch.controllers.kfam import KfamService
            from odh_kubeflow_tpu_torch.controllers.tensorboard import TensorboardController
            from odh_kubeflow_tpu_torch.utils.prometheus import Registry
            from odh_kubeflow_tpu_torch.web.dashboard import DashboardApp
            from odh_kubeflow_tpu_torch.web.kfam_app import KfamApp
            from odh_kubeflow_tpu_torch.web.twa import TensorboardsWebApp
            from odh_kubeflow_tpu_torch.web.vwa import VolumesWebApp
        else:
            from odh_kubeflow_tpu.controllers.kfam import KfamService
            from odh_kubeflow_tpu.controllers.tensorboard import TensorboardController
            from odh_kubeflow_tpu.utils.prometheus import Registry
            from odh_kubeflow_tpu.web.dashboard import DashboardApp
            from odh_kubeflow_tpu.web.kfam_app import KfamApp
            from odh_kubeflow_tpu.web.twa import TensorboardsWebApp
            from odh_kubeflow_tpu.web.vwa import VolumesWebApp
        api = self.api
        TensorboardController(api).register(self.mgr)
        reg = Registry()
        apps = {"vwa": VolumesWebApp(api, registry=reg),
                "twa": TensorboardsWebApp(api, registry=reg),
                "kfam": KfamApp(api, cluster_admins={ROOT}, registry=reg),
                "dash": DashboardApp(api, KfamService(api, {ROOT}), registry=reg)}
        self.servers = {k: a.app.serve("127.0.0.1", 0) for k, a in apps.items()}
        self.c = {k: Client(f"http://127.0.0.1:{s.server_address[1]}")
                  for k, s in self.servers.items()}

    def close(self):
        for s in self.servers.values():
            s.shutdown()
            s.server_close()
        super().close()


def both(scenario) -> dict:
    """``scenario(side, log)`` on both packages; the port's log must equal
    JAX's carried across. Returns the port's."""
    logs = []
    for port in (False, True):
        side, log = AppsSide(port), {}
        try:
            scenario(side, lambda key, value: log.__setitem__(key, norm(scrub(value))))
        finally:
            side.close()
        logs.append(log)
    want, got = web_to_port(logs[0]), logs[1]
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == want[key], key
    return got


def _mounting_notebook(side, claim: str) -> None:
    """A CPU notebook mounting ``claim`` (its pod is what the VWA lists)."""
    side.api.create({
        "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
        "metadata": {"name": "nb1", "namespace": NS},
        "spec": {"template": {"spec": {
            "containers": [{"name": "nb1", "image": "img:v1",
                            "volumeMounts": [{"name": "data", "mountPath": "/data"}]}],
            "volumes": [{"name": "data", "persistentVolumeClaim": {"claimName": claim}}]}}}})
    side.settle()


def test_vwa_pvcs_with_their_mounting_pods_and_403s():
    def scenario(side, log):
        c = side.c["vwa"]
        log("post", c.request("POST", f"/api/namespaces/{NS}/pvcs", {"pvc": {
            "metadata": {"name": "data-1"},
            "spec": {"accessModes": ["ReadWriteOnce"],
                     "resources": {"requests": {"storage": "5Gi"}}}}}))
        log("post_nameless", c.request("POST", f"/api/namespaces/{NS}/pvcs", {"pvc": {}}))
        _mounting_notebook(side, "data-1")
        log("list", c.request("GET", f"/api/namespaces/{NS}/pvcs"))
        log("details", c.request("GET", f"/api/namespaces/{NS}/pvcs/data-1"))
        log("events", events(c.request("GET", f"/api/namespaces/{NS}/pvcs/data-1/events")))
        log("outsider_list", c.request("GET", f"/api/namespaces/{NS}/pvcs", user=STRANGER))
        log("outsider_delete", c.request("DELETE", f"/api/namespaces/{NS}/pvcs/data-1",
                                         user=STRANGER))
        log("anonymous", c.request("GET", f"/api/namespaces/{NS}/pvcs", user=""))
        log("delete", c.request("DELETE", f"/api/namespaces/{NS}/pvcs/data-1"))
        log("missing", c.request("GET", f"/api/namespaces/{NS}/pvcs/data-1"))

    got = both(scenario)
    assert got["post"][0] == 201 and got["post_nameless"][0] == 400
    row = got["details"][1]["details"]
    assert row["usedBy"] == ["nb1-0"] and row["pods"][0]["mountPaths"] == ["/data"]
    assert [got[k][0] for k in ("outsider_list", "outsider_delete", "anonymous")] == [
        403, 403, 401]
    assert got["missing"][0] == 404


def test_twa_tensorboards_logs_and_403s(tmp_path, monkeypatch):
    """Rows, readiness once the kubelet runs the Deployment, the ``/logs``
    browser (a ``pvc://`` path reported, not listed; a local path listed
    only under ``TWA_LOCAL_LOGS_ROOT``), events, delete and 403s."""
    root = tmp_path / "logs-root"
    session = root / "run" / "plugins" / "profile" / "2026_01_01_00_00_00_000001"
    session.mkdir(parents=True)
    (session / "host.pt.trace.json.gz").write_bytes(b"x" * 7)
    monkeypatch.setenv("TWA_LOCAL_LOGS_ROOT", str(root))

    def scenario(side, log):
        c = side.c["twa"]
        base = f"/api/namespaces/{NS}/tensorboards"
        log("post", c.request("POST", base, {"name": "tb1", "logspath": "pvc://data-1/logs"}))
        log("post_local", c.request("POST", base, {"name": "tb-local",
                                                   "logspath": str(root / "run")}))
        log("post_escape", c.request("POST", base, {"name": "tb-etc", "logspath": "/etc"}))
        log("post_gs", c.request("POST", base, {"name": "tb-gs", "logspath": "gs://b/t"}))
        log("post_bad", c.request("POST", base, {"name": "tb2"}))
        log("waiting", c.request("GET", base))
        side.settle()
        log("ready", c.request("GET", base))
        log("logs_pvc", c.request("GET", f"{base}/tb1/logs"))
        log("logs_local", c.request("GET", f"{base}/tb-local/logs"))
        log("logs_escape", c.request("GET", f"{base}/tb-etc/logs"))
        log("logs_gs", c.request("GET", f"{base}/tb-gs/logs"))
        log("events", events(c.request("GET", f"{base}/tb1/events")))
        log("outsider", c.request("GET", base, user=STRANGER))
        log("outsider_logs", c.request("GET", f"{base}/tb-local/logs", user=STRANGER))
        log("delete", c.request("DELETE", f"{base}/tb1"))
        log("after", [r["name"] for r in c.request("GET", base)[1]["tensorboards"]])

    got = both(scenario)
    assert {r["name"]: r["status"]["phase"] for r in got["ready"][1]["tensorboards"]} == {
        "tb1": "ready", "tb-local": "ready", "tb-etc": "ready", "tb-gs": "ready"}
    assert got["post_bad"][0] == 400
    assert got["logs_pvc"][1]["claim"] == "data-1" and not got["logs_pvc"][1]["listable"]
    assert got["logs_local"][1]["files"] == [{
        "path": "plugins/profile/2026_01_01_00_00_00_000001/host.pt.trace.json.gz", "size": 7}]
    assert not got["logs_escape"][1]["listable"] and got["logs_escape"][1]["files"] == []
    assert got["outsider"][0] == got["outsider_logs"][0] == 403
    assert sorted(got["after"]) == ["tb-etc", "tb-gs", "tb-local"]


def test_kfam_app_bindings_profiles_and_403s():
    def scenario(side, log):
        c = side.c["kfam"]
        log("admin", c.request("GET", "/kfam/v1/role/clusteradmin", user=ROOT))
        log("not_admin", c.request("GET", "/kfam/v1/role/clusteradmin"))
        binding = {"user": {"kind": "User", "name": BOB}, "referredNamespace": NS,
                   "roleRef": {"kind": "ClusterRole", "name": "kubeflow-edit"}}
        log("bind_by_stranger", c.request("POST", "/kfam/v1/bindings", binding, user=STRANGER))
        log("bind", c.request("POST", "/kfam/v1/bindings", binding))
        log("bindings", c.request("GET", f"/kfam/v1/bindings?namespace={NS}"))
        log("by_user", c.request("GET", f"/kfam/v1/bindings?user={BOB}"))
        log("unbind_by_stranger", c.request("DELETE", "/kfam/v1/bindings", binding,
                                            user=STRANGER))
        log("unbind", c.request("DELETE", "/kfam/v1/bindings", binding))
        log("after", c.request("GET", f"/kfam/v1/bindings?namespace={NS}"))
        log("profile", c.request("POST", "/kfam/v1/profiles", {
            "apiVersion": "kubeflow.org/v1", "kind": "Profile", "metadata": {"name": "team-k"}, "spec": {"owner": {"kind": "User", "name": BOB}}}))
        side.settle()
        log("namespace", side.api.get("Namespace", "team-k")["metadata"]["annotations"])
        log("drop_by_stranger", c.request("DELETE", "/kfam/v1/profiles/team-k", user=STRANGER))
        log("drop", c.request("DELETE", "/kfam/v1/profiles/team-k", user=BOB))
        log("csrf", c.request("POST", "/kfam/v1/bindings", binding, csrf=False))

    got = both(scenario)
    assert got["admin"][1]["clusteradmin"] is True and got["not_admin"][1]["clusteradmin"] is False
    assert [got[k][0] for k in ("bind_by_stranger", "unbind_by_stranger", "drop_by_stranger",
                                "csrf")] == [403, 403, 403, 403]
    assert [b["user"]["name"] for b in got["bindings"][1]["bindings"]] == [BOB]
    assert got["after"][1]["bindings"] == []


def test_dashboard_workgroups_panels_and_403s():
    def scenario(side, log):
        c = side.c["dash"]
        api = side.api
        quota_key = "requests.nvidia.com/gpu" if side.port else "requests.google.com/tpu"
        api.patch("Profile", NS, {"spec": {"resourceQuotaSpec": {"hard": {quota_key: "8"}}}})
        side.settle()
        status, body = c.request("GET", "/api/slo?tick=1")
        log("slo_first", [status, [(r["slo"], r["window"], r["total"], r["burnRate"])
                                   for r in body["slos"]]])
        log("exists", c.request("GET", "/api/workgroup/exists"))
        log("exists_stranger", c.request("GET", "/api/workgroup/exists", user=STRANGER))
        log("env_info", c.request("GET", "/api/workgroup/env-info"))
        log("create", c.request("POST", "/api/workgroup/create", {"namespace": "team-carol"},
                                user="carol@example.com"))
        log("create_again", c.request("POST", "/api/workgroup/create",
                                      {"namespace": "team-carol"}, user="carol@example.com"))
        log("create_nameless", c.request("POST", "/api/workgroup/create", {}))
        side.settle()
        log("add", c.request("POST", f"/api/workgroup/add-contributor/{NS}",
                             {"contributor": BOB}))
        log("contributors", c.request("GET", f"/api/workgroup/contributors/{NS}"))
        log("contributors_stranger", c.request("GET", f"/api/workgroup/contributors/{NS}",
                                               user=STRANGER))
        log("quota", c.request("GET", f"/api/workgroup/quota/{NS}"))
        log("quota_contributor", c.request("GET", f"/api/workgroup/quota/{NS}", user=BOB))
        log("quota_stranger", c.request("GET", f"/api/workgroup/quota/{NS}", user=STRANGER))
        log("all_namespaces", c.request("GET", "/api/workgroup/get-all-namespaces", user=ROOT))
        log("all_namespaces_user", c.request("GET", "/api/workgroup/get-all-namespaces"))
        for name, kind, reason, ts in (("ev-1", "Notebook", "FailedScheduling",
                                        "2026-07-30T10:00:00Z"),
                                       ("ev-2", "StatefulSet", "Created",
                                        "2026-07-30T11:00:00Z")):
            api.create({"kind": "Event", "apiVersion": "v1",
                        "metadata": {"name": name, "namespace": NS},
                        "type": "Normal", "reason": reason, "message": reason,
                        "involvedObject": {"kind": kind, "name": "nb1"},
                        "lastTimestamp": ts})
        status, body = c.request("GET", f"/api/activities/{NS}")
        # the two stamped ones, oldest last; the controllers' own events
        # carry the run's wall clock
        log("activities", [status, [a for a in body["activities"]
                                    if a["time"].startswith("2026-07-30")]])
        log("activities_stranger", c.request("GET", f"/api/activities/{NS}", user=STRANGER))
        log("remove", c.request("DELETE", f"/api/workgroup/remove-contributor/{NS}",
                                {"contributor": BOB}))
        log("after_remove", c.request("GET", f"/api/workgroup/contributors/{NS}"))
        log("metrics", c.request("GET", "/api/metrics", user=ROOT))
        log("usage", c.request("GET", "/api/usage"))
        status, body = c.request("GET", "/api/slo?tick=1")
        log("slo", [status, sorted((r["slo"], r["window"], r["objective"],
                                    r["burnThreshold"]) for r in body["slos"])])
        status, text = _get_text(side, "dash", "/prometheus/metrics")
        log("prometheus", [status, "http_request_duration_seconds_bucket" in text])

    got = both(scenario)
    assert got["exists"][1]["hasWorkgroup"] and not got["exists_stranger"][1]["hasWorkgroup"]
    assert got["create"][0] == 201 and got["create_again"][0] == 409
    assert got["contributors"][1]["contributors"] == [BOB]
    assert {r["resource"]: r["hard"] for r in got["quota"][1]["quota"]} == {
        "requests.nvidia.com/gpu": "8"}
    assert [got[k][0] for k in ("contributors_stranger", "quota_stranger",
                                "activities_stranger", "all_namespaces_user")] == [
        403, 403, 403, 403]
    panel = got["metrics"][1]["gpu"]
    assert panel[0]["accelerator"] == "nvidia-l4" and panel[0]["capacityGpus"] == 4.0
    assert got["usage"][0] == 503
    assert len(got["slo"][1]) == 10


def _get_text(side, app, path):
    import urllib.request

    req = urllib.request.Request(side.c[app].base + path)
    req.add_header("kubeflow-userid", ALICE)
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.read().decode()


def test_dashboard_gpu_panel_counts_running_gpus_per_zone_and_suspended():
    """The GPU panel (the port's own): capacity and Running pods' GPU
    limits per accelerator and zone, and a suspended session's GPUs as
    committed beside the used ones."""
    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.controllers.runtime import Manager
    from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.sessions import new_checkpoint, register_sessions
    from odh_kubeflow_tpu_torch.utils.prometheus import Registry
    from odh_kubeflow_tpu_torch.web.dashboard import DashboardApp

    api = APIServer()
    apis.register_crds(api)
    register_sessions(api)
    cluster = FakeCluster(api)
    cluster.add_gpu_node_pool("a", "nvidia-h100-80gb", 2, 8, zone="zone-a")
    cluster.add_gpu_node_pool("b", "nvidia-l4", 1, 4, zone="zone-b")
    for name, node, gpus, accel in (("p1", "a-0", 3, "nvidia-h100-80gb"),
                                    ("p2", "b-0", 2, "nvidia-l4")):
        api.create({"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": name, "namespace": NS},
                    "spec": {"nodeName": node,
                             "nodeSelector": {apis.GPU_ACCEL_NODE_LABEL: accel},
                             "containers": [{"name": "c", "resources": {
                                 "limits": {apis.GPU_RESOURCE: str(gpus)}}},
                                            {"name": "sidecar"}]},
                    "status": {"phase": "Running"}})
    nb = {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
          "metadata": {"name": "nb-s", "namespace": NS, "uid": "u1"},
          "spec": {"template": {"spec": {"containers": [{"name": "nb-s"}]}}}}
    ck = new_checkpoint(nb, 4, "nvidia-h100-80gb", "4")
    ck["status"] = {"phase": "Suspended"}
    api.create(ck)
    Manager(api)
    dash = DashboardApp(api, registry=Registry())
    server = dash.app.serve("127.0.0.1", 0)
    try:
        status, body = Client(f"http://127.0.0.1:{server.server_address[1]}").request(
            "GET", "/api/metrics")
    finally:
        server.shutdown()
        server.server_close()
    assert status == 200
    assert body["gpu"] == [
        {"accelerator": "nvidia-h100-80gb", "capacityGpus": 16.0, "usedGpus": 3.0,
         "suspendedGpus": 4.0, "committedGpus": 7.0, "utilizationRatio": None},
        {"accelerator": "nvidia-l4", "capacityGpus": 4.0, "usedGpus": 2.0,
         "suspendedGpus": 0, "committedGpus": 2.0, "utilizationRatio": None}]
    assert body["zones"] == [
        {"zone": "zone-a", "capacityGpus": 16.0, "usedGpus": 3.0, "utilizationRatio": None},
        {"zone": "zone-b", "capacityGpus": 4.0, "usedGpus": 2.0, "utilizationRatio": None}]
    assert body["suspendedSessions"] == 1
