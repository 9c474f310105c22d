"""The port's JWA spawner on GPU node pools against the JAX package's on TPU
slices, over real HTTP sockets (port 0), on the CPU.

The same spawner flow goes through both packages: the store with the
PodDefault webhook and the runtime PodDefault, the kubelet simulator,
the notebook and profile controllers and the JWA served by ``microweb``
(JAX's ``tests/test_web.py`` fixture). Each request's answer from JAX,
carried across (a TPU type and topology become a GPU type and count,
the ``tpus`` fields ``gpus`` fields, the runtime PodDefault's rows by
``test_torch_webhooks.RUNTIME_ROWS``; volatile fields scrubbed), must
equal the port's: the config, the inventory, list rows, create, stop,
start, delete, details, events, PVCs and PodDefaults.
"""

from __future__ import annotations

import json
import re
import urllib.error
import urllib.request

import pytest

from odh_kubeflow_tpu_torch.apis import ACCELERATOR_MAPPING
from test_torch_platform import scrub
from test_torch_webhooks import runtime_to_gpu

ALICE = "alice@example.com"
TRACE_ANNOTATION = "odh.kubeflow.org/trace-id"
NS = "team-a"
# the spawner's TPU request ↔ the port's GPU request of the same shape
TPU_POOL = ("tpu-v5-lite-podslice", "2x2")
GPU_POOL = ("nvidia-l4", 4)
FORMS = {
    "pool": ({"accelerator": "tpu-v5-lite-podslice", "topology": "2x2"},
             {"accelerator": "nvidia-l4", "count": "4"}),
    "too_large": ({"accelerator": "tpu-v5-lite-podslice", "topology": "4x4"},
                  {"accelerator": "nvidia-l4", "count": "16"}),
}


def web_to_port(obj):
    """JAX's answers carried to the port's: the request fields, the
    runtime PodDefault, the spot toleration group's key and text; the
    trace id JAX's web requests stamp on what they create, and the
    details page's empty usage block, go (the port has no tracing or
    usage meter yet)."""
    obj = runtime_to_gpu(obj)
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "annotations" and isinstance(v, dict) and TRACE_ANNOTATION in v:
                v = {a: b for a, b in v.items() if a != TRACE_ANNOTATION}
                if not v:
                    continue
            if k == "usage" and v is None:
                continue  # the details block that comes with machinery/usage.py
            if k == "notebooks.kubeflow.org/tpu-topology":
                v = str(GPU_POOL[1])
            if k == "tpus":
                k = "gpus"
                if isinstance(v, dict) and "topology" in v:  # a list row
                    v = {"accelerator": GPU_POOL[0], "count": str(GPU_POOL[1]),
                         "gpus": str(GPU_POOL[1])}
            k = {"hosts": "nodes", "chips": "gpus"}.get(k, k)
            out[ACCELERATOR_MAPPING.get(k, k)] = web_to_port(v)
        return out
    if isinstance(obj, list):
        return [web_to_port(v) for v in obj]
    if isinstance(obj, str):
        obj = obj.replace("spot-tpu", "spot-gpu").replace("spot/preemptible TPU",
                                                          "spot/preemptible GPU")
        if obj == "TPU runtime (libtpu + XLA env)":  # the runtime PodDefault's desc
            from odh_kubeflow_tpu_torch.webhooks import gpu_runtime_poddefault

            return gpu_runtime_poddefault(NS)["spec"]["desc"]
        return obj.replace(TPU_POOL[0], GPU_POOL[0]).replace("tpu-runtime", "gpu-runtime")
    return obj


class Client:
    """Tiny HTTP client with the user header and the CSRF pair."""

    def __init__(self, base: str, user: str = ALICE):
        self.base, self.user, self.csrf = base, user, "testtoken"

    def request(self, method, path, body=None, user=None, csrf=True):
        req = urllib.request.Request(
            self.base + path, method=method,
            data=json.dumps(body).encode() if body is not None else None)
        u = user if user is not None else self.user
        if u:
            req.add_header("kubeflow-userid", u)
        if method not in ("GET", "HEAD") and csrf:
            req.add_header("Cookie", f"XSRF-TOKEN={self.csrf}")
            req.add_header("X-XSRF-TOKEN", self.csrf)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.loads(r.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode() or "{}")


class Side:
    """One package's spawner stack (JAX's ``env`` + ``jwa_client``)."""

    def __init__(self, port: bool):
        if port:
            from odh_kubeflow_tpu_torch import apis
            from odh_kubeflow_tpu_torch.controllers.notebook import (
                NotebookController, NotebookControllerConfig)
            from odh_kubeflow_tpu_torch.controllers.profile import ProfileController
            from odh_kubeflow_tpu_torch.controllers.runtime import Manager
            from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
            from odh_kubeflow_tpu_torch.machinery.store import APIServer
            from odh_kubeflow_tpu_torch.utils.prometheus import Registry
            from odh_kubeflow_tpu_torch.web.jwa import JupyterWebApp
            from odh_kubeflow_tpu_torch.webhooks import (
                PodDefaultWebhook, gpu_runtime_poddefault as runtime)
        else:
            from odh_kubeflow_tpu import apis
            from odh_kubeflow_tpu.controllers.notebook import (
                NotebookController, NotebookControllerConfig)
            from odh_kubeflow_tpu.controllers.profile import ProfileController
            from odh_kubeflow_tpu.controllers.runtime import Manager
            from odh_kubeflow_tpu.machinery.kubelet import FakeCluster
            from odh_kubeflow_tpu.machinery.store import APIServer
            from odh_kubeflow_tpu.utils.prometheus import Registry
            from odh_kubeflow_tpu.web.jwa import JupyterWebApp
            from odh_kubeflow_tpu.webhooks.poddefault import (
                PodDefaultWebhook, tpu_runtime_poddefault as runtime)
        self.port = port
        self.field = "gpus" if port else "tpus"
        api = self.api = APIServer()
        apis.register_crds(api)
        PodDefaultWebhook(api).register()
        self.cluster = FakeCluster(api)
        self.cluster.add_node("cpu-0")
        if port:
            self.cluster.add_gpu_node_pool("pool", GPU_POOL[0], num_nodes=1,
                                           gpus_per_node=GPU_POOL[1])
        else:
            self.cluster.add_tpu_node_pool("pool", *TPU_POOL)
        self.mgr = Manager(api)
        NotebookController(api, NotebookControllerConfig(), registry=Registry()).register(
            self.mgr)
        ProfileController(api, registry=Registry()).register(self.mgr)
        api.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                    "metadata": {"name": NS},
                    "spec": {"owner": {"kind": "User", "name": ALICE}}})
        self.mgr.drain()
        api.create(runtime(NS))
        api.create({
            "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRole",
            "metadata": {"name": "kubeflow-edit"},
            "rules": [{"apiGroups": ["kubeflow.org", "tensorboard.kubeflow.org", ""],
                       "resources": ["notebooks", "poddefaults", "tensorboards",
                                     "persistentvolumeclaims", "nodes", "events"],
                       "verbs": ["*"]}]})
        api.create({
            "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRoleBinding",
            "metadata": {"name": "alice-edit"},
            "subjects": [{"kind": "User", "name": ALICE}],
            "roleRef": {"kind": "ClusterRole", "name": "kubeflow-edit"}})
        self.jwa = JupyterWebApp(api, registry=Registry())
        self.server = self.jwa.app.serve("127.0.0.1", 0)
        self.client = Client(f"http://127.0.0.1:{self.server.server_address[1]}")

    def form(self, which: str = "pool") -> dict:
        return FORMS[which][1 if self.port else 0]

    def settle(self):
        self.mgr.drain()
        self.cluster.step()
        self.mgr.drain()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.mgr.stop()


def both(scenario) -> dict:
    """Run ``scenario(side, log)`` on both packages; the port's log must
    equal JAX's carried across, but for keys ``own:…`` (the accelerator
    inventory, in each package's own terms). Returns the port's."""
    logs = []
    for port in (False, True):
        side, log = Side(port), {}
        try:
            scenario(side, lambda key, value: log.__setitem__(key, scrub(value)))
        finally:
            side.close()
        logs.append(log)
    want, got = web_to_port(logs[0]), logs[1]
    assert got.keys() == want.keys()
    for key in got:
        if not key.startswith("own:"):  # each package's own inventory terms
            assert got[key] == want[key], key
    return got


def _without_age(rows):
    return [{k: v for k, v in r.items() if k != "age"} for r in rows]


def test_jwa_spawn_gpu_notebook_end_to_end():
    def scenario(side, log):
        c = side.client
        status, body = c.request("GET", "/api/config")
        cfg = body["config"]
        log("config", [status, {k: v for k, v in cfg.items()
                                if k not in ("image", "tpus", "gpus")}])
        log("own:accelerators", [a["type"] for a in cfg[side.field]["accelerators"]])
        status, body = c.request("GET", f"/api/{side.field}")
        log("own:inventory", [status, body[side.field]])
        status, body = c.request("POST", f"/api/namespaces/{NS}/notebooks", {
            "name": "nb", "image": "img:v1", "cpu": "4", "memory": "8Gi",
            side.field: side.form()})
        log("create", [status, body])
        log("pvc", side.api.get("PersistentVolumeClaim", "nb-workspace", NS))
        side.settle()
        pod = side.api.get("Pod", "nb-0", NS)
        log("pod_phase", pod["status"]["phase"])
        log("pod_runtime", {
            "labels": pod["metadata"]["labels"],
            "env": [e for e in pod["spec"]["containers"][0]["env"]
                    if not e["name"].startswith(("TPU_WORKER", "NVIDIA_VISIBLE"))],
            "volumeMounts": pod["spec"]["containers"][0]["volumeMounts"]})
        status, body = c.request("GET", f"/api/namespaces/{NS}/notebooks")
        log("list", [status, _without_age(body["notebooks"])])
        status, body = c.request("PATCH", f"/api/namespaces/{NS}/notebooks/nb",
                                 {"stopped": True})
        side.mgr.drain()
        side.cluster.step()
        log("stop", [status, body, _without_age(
            c.request("GET", f"/api/namespaces/{NS}/notebooks")[1]["notebooks"])])
        status, body = c.request("PATCH", f"/api/namespaces/{NS}/notebooks/nb",
                                 {"stopped": False})
        side.settle()
        log("start", [status, body, _without_age(
            c.request("GET", f"/api/namespaces/{NS}/notebooks")[1]["notebooks"])])
        log("delete", list(c.request("DELETE", f"/api/namespaces/{NS}/notebooks/nb")))
        log("after_delete", side.api.list("Notebook", namespace=NS))

    got = both(scenario)
    assert got["own:accelerators"] == ["nvidia-h100-80gb", "nvidia-h100-mega-80gb",
                                          "nvidia-h200-141gb", "nvidia-l4"]
    assert got["own:inventory"] == [200, [
        {"type": "nvidia-l4", "displayName": "NVIDIA L4", "counts": ["1", "2", "4"]}]]
    assert got["create"] == [201, {"success": True, "status": 201, "notebook": "nb"}]
    assert got["pvc"]["spec"]["resources"]["requests"]["storage"] == "10Gi"
    assert got["pod_phase"] == "Running"
    env = {e["name"]: e["value"] for e in got["pod_runtime"]["env"]}
    assert env["ODH_TORCH_KERNEL_CACHE"] == "/home/jovyan/.cache/torch_kernels"
    row = got["list"][1][0]
    assert row["status"]["phase"] == "ready"
    assert row["gpus"] == {"accelerator": "nvidia-l4", "count": "4", "gpus": "4"}
    assert got["stop"][2][0]["status"]["phase"] == "stopped"
    assert got["start"][2][0]["status"]["phase"] == "ready"
    assert got["delete"][0] == 200 and got["after_delete"] == []


def test_gpu_inventory_and_quota_routes():
    """``/api/gpus`` offers the counts one node pool of a type can hold;
    the namespaced route adds the profile's GPU quota."""
    side = Side(True)
    try:
        c = side.client
        assert c.request("GET", "/api/gpus")[1]["gpus"] == [
            {"type": "nvidia-l4", "displayName": "NVIDIA L4", "counts": ["1", "2", "4"]}]
        side.cluster.add_gpu_node_pool("big", "nvidia-l4", num_nodes=4, gpus_per_node=4)
        side.cluster.add_gpu_node_pool("h100", "nvidia-h100-80gb", num_nodes=2)
        assert c.request("GET", "/api/gpus")[1]["gpus"] == [
            {"type": "nvidia-h100-80gb", "displayName": "NVIDIA H100 80GB",
             "counts": ["1", "2", "4", "8", "16"]},
            {"type": "nvidia-l4", "displayName": "NVIDIA L4",
             "counts": ["1", "2", "4", "8", "16"]}]
        assert side.jwa.gpu_quota(NS) is None  # an unlimited profile has no quota row
        status, body = c.request("GET", f"/api/namespaces/{NS}/gpus")
        assert status == 403  # alice's role does not list resourcequotas
        side.api.create({"apiVersion": "v1", "kind": "ResourceQuota",
                         "metadata": {"name": "kf-resource-quota", "namespace": NS,
                                      "annotations": {
                                          "scheduling.kubeflow.org/oversubscription-factor":
                                          "1.5"}},
                         "spec": {"hard": {"requests.nvidia.com/gpu": "8"}}})
        assert side.jwa.gpu_quota(NS) == {
            "resource": "requests.nvidia.com/gpu", "hard": "8", "used": "0",
            "oversubscriptionFactor": "1.5", "sessionCap": "12", "committed": "0",
            "suspended": "0"}
    finally:
        side.close()


def test_jwa_authn_authz_and_csrf():
    def scenario(side, log):
        c = side.client
        path = f"/api/namespaces/{NS}/notebooks"
        log("no_user", c.request("GET", path, user="")[0])
        log("stranger", c.request("GET", path, user="mallory@example.com")[0])
        log("no_csrf", list(c.request("POST", path, {}, csrf=False)))
        status, _ = c.request("POST", path, {"name": "toolarge",
                                              side.field: side.form("too_large")})
        side.mgr.drain()
        side.cluster.step()
        rows = {r["name"]: r for r in c.request("GET", path)[1]["notebooks"]}
        log("too_large", [status, rows["toolarge"]["status"]["phase"]])

    got = both(scenario)
    assert (got["no_user"], got["stranger"]) == (401, 403)
    assert got["no_csrf"][0] == 403
    assert got["too_large"] == [201, "warning"]


def test_jwa_toleration_and_affinity_groups():
    def scenario(side, log):
        c = side.client
        status, _ = c.request("POST", f"/api/namespaces/{NS}/notebooks", {
            "name": "spot-nb", "image": "img:v1", "cpu": "1", "memory": "1Gi",
            "tolerationGroup": "spot-gpu" if side.port else "spot-tpu",
            "affinityConfig": "same-zone"})
        spec = side.api.get("Notebook", "spot-nb", NS)["spec"]["template"]["spec"]
        log("groups", [status, spec["tolerations"], spec["affinity"]])
        log("unknown", list(c.request("POST", f"/api/namespaces/{NS}/notebooks", {
            "name": "bad-nb", "image": "x", "tolerationGroup": "no-such-group"})))

    got = both(scenario)
    status, tolerations, affinity = got["groups"]
    assert status == 201 and tolerations[0]["key"] == "cloud.google.com/gke-spot"
    assert "podAffinity" in affinity
    assert got["unknown"][0] == 400 and "tolerationGroup" in got["unknown"][1]["log"]


def test_spawner_accelerators_exist_in_the_gpu_table():
    """Every type and count the spawner offers is one the notebook
    controller can schedule (JAX's topology-table check)."""
    from odh_kubeflow_tpu_torch.controllers.notebook import gpu_request_of
    from odh_kubeflow_tpu_torch.web.jwa import DEFAULT_CONFIG

    for acc in DEFAULT_CONFIG["spawnerFormDefaults"]["gpus"]["accelerators"]:
        for count in acc["counts"]:
            req = gpu_request_of({"metadata": {"annotations": {
                "notebooks.kubeflow.org/gpu-accelerator": acc["type"],
                "notebooks.kubeflow.org/gpu-count": count}}})
            assert (req.accelerator_type, req.gpus) == (acc["type"], int(count))


def test_jwa_attach_existing_pvc_details_events_and_listings():
    """A data volume from an existing claim; then the details, events,
    PVC and PodDefault routes of the spawned notebook."""
    def scenario(side, log):
        c = side.client
        side.api.create({"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                         "metadata": {"name": "datasets", "namespace": NS},
                         "spec": {"accessModes": ["ReadWriteOnce"],
                                  "resources": {"requests": {"storage": "5Gi"}}}})
        status, _ = c.request("POST", f"/api/namespaces/{NS}/notebooks", {
            "name": "vol-nb", "image": "img:v1", "cpu": "1", "memory": "1Gi",
            side.field: side.form(),
            "dataVolumes": [{"mount": "/data/datasets", "existingSource": {
                "persistentVolumeClaim": {"claimName": "datasets"}}}]})
        side.settle()
        spec = side.api.get("Notebook", "vol-nb", NS)["spec"]["template"]["spec"]
        log("volumes", [status, spec["volumes"], spec["containers"][0]["volumeMounts"]])
        status, body = c.request("GET", f"/api/namespaces/{NS}/notebooks/vol-nb/details")
        details = body["details"]
        details.pop("age")
        details["annotations"] = {k: v for k, v in details["annotations"].items()
                                  if "last-activity" not in k}
        log("details", [status, details])
        status, body = c.request("GET", f"/api/namespaces/{NS}/notebooks/vol-nb/events")
        log("events", [status, sorted((e["reason"], e["involved"]) for e in body["events"])])
        status, body = c.request("GET", f"/api/namespaces/{NS}/pvcs")
        log("pvcs", [status, sorted(p["metadata"]["name"] for p in body["pvcs"])])
        log("poddefaults", list(c.request("GET", f"/api/namespaces/{NS}/poddefaults")))
        log("one", c.request("GET", f"/api/namespaces/{NS}/notebooks/vol-nb")[0])

    got = both(scenario)
    status, volumes, mounts = got["volumes"]
    assert status == 201
    assert "datasets" in [v.get("persistentVolumeClaim", {}).get("claimName") for v in volumes]
    assert "/data/datasets" in {m["mountPath"] for m in mounts}
    assert got["details"][1]["pods"] == [{"name": "vol-nb-0", "phase": "Running",
                                          "node": "pool-0"}]
    assert got["pvcs"][1] == ["datasets", "vol-nb-workspace"]
    assert got["poddefaults"][1]["poddefaults"][0]["label"] == "gpu-runtime"
    assert got["one"] == 200


@pytest.mark.parametrize("name, kind, expected", [
    ("nb", "Pod", "nb-0"), ("nb", "Notebook", "nb-2"), ("nb", "Pod", "nb-x"),
    ("nb", "PersistentVolumeClaim", "nb-workspace"),
])
def test_event_family_rules_match_jax(name, kind, expected):
    from odh_kubeflow_tpu.web.jwa import _event_belongs_to_notebook as jax_rule
    from odh_kubeflow_tpu_torch.web.jwa import _event_belongs_to_notebook

    involved = {"kind": kind, "name": expected}
    assert _event_belongs_to_notebook(involved, name) == jax_rule(involved, name)
    assert re.fullmatch(r"nb(-\d+|-workspace)?", expected) or not (
        _event_belongs_to_notebook(involved, name))
