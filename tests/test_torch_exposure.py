"""The port's exposure and tensorboard controllers against the JAX
package's, on the CPU.

The same Notebook and Tensorboard inputs go through both packages' store,
notebook admission webhook, kubelet simulator and controllers; every
object the two controllers make must be equal (the cookie secret's
random bytes scrubbed; the TensorBoard image pinned by
``TENSORBOARD_IMAGE`` on both sides — the port's default image is its
own, ``images/tensorboard-pytorch/``). A notebook that asks for the auth
sidecar is locked by the webhook at zero replicas and reaches one only
once the exposure controller has made its ServiceAccount and secrets and
released the lock.
"""

from __future__ import annotations

import pytest

from test_torch_platform import scrub

NS = "team-x"
INJECT = "notebooks.opendatahub.io/inject-oauth"
LOCK = "kubeflow-resource-stopped"
KINDS = ("ServiceAccount", "Secret", "Service", "HTTPRoute", "NetworkPolicy")


class Side:
    """One package's store with the notebook webhook, the kubelet
    simulator (one CPU node) and a manager running the notebook
    controller; ``expose()`` adds the exposure controller."""

    def __init__(self, port: bool):
        if port:
            from odh_kubeflow_tpu_torch import apis
            from odh_kubeflow_tpu_torch.controllers.exposure import ExposureController
            from odh_kubeflow_tpu_torch.controllers.notebook import NotebookController
            from odh_kubeflow_tpu_torch.controllers.runtime import Manager
            from odh_kubeflow_tpu_torch.controllers.tensorboard import TensorboardController
            from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
            from odh_kubeflow_tpu_torch.machinery.store import APIServer
            from odh_kubeflow_tpu_torch.utils.prometheus import Registry
            from odh_kubeflow_tpu_torch.webhooks import NotebookWebhook
        else:
            from odh_kubeflow_tpu import apis
            from odh_kubeflow_tpu.controllers.exposure import ExposureController
            from odh_kubeflow_tpu.controllers.notebook import NotebookController
            from odh_kubeflow_tpu.controllers.runtime import Manager
            from odh_kubeflow_tpu.controllers.tensorboard import TensorboardController
            from odh_kubeflow_tpu.machinery.kubelet import FakeCluster
            from odh_kubeflow_tpu.machinery.store import APIServer
            from odh_kubeflow_tpu.utils.prometheus import Registry
            from odh_kubeflow_tpu.webhooks.notebook import NotebookWebhook
        self.api = APIServer()
        apis.register_crds(self.api)
        NotebookWebhook(self.api).register()
        self.cluster = FakeCluster(self.api)
        self.cluster.add_node("cpu-0")
        self.mgr = Manager(self.api)
        NotebookController(self.api, registry=Registry()).register(self.mgr)
        self._exposure = ExposureController
        self._tensorboard = TensorboardController

    def expose(self):
        self._exposure(self.api).register(self.mgr)

    def tensorboards(self):
        self._tensorboard(self.api).register(self.mgr)

    def settle(self, rounds: int = 2):
        for _ in range(rounds):
            self.mgr.drain()
            self.cluster.step()
            self.mgr.drain()

    def replicas(self, name: str) -> int:
        return self.api.get("StatefulSet", name, NS)["spec"]["replicas"]

    def owned(self, name: str) -> dict:
        out = {}
        for kind in KINDS:
            for obj in self.api.list(kind, namespace=NS):
                if obj["metadata"]["name"].startswith(name):
                    obj = scrub(obj)
                    if obj["metadata"]["name"].endswith("-cookie-secret"):
                        obj["data"] = {"secret": len(obj["data"]["secret"])}
                    out[f"{kind}/{obj['metadata']['name']}"] = obj
        return out


def notebook(name: str, auth: bool) -> dict:
    meta = {"name": name, "namespace": NS}
    if auth:
        meta["annotations"] = {INJECT: "true"}
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook", "metadata": meta,
            "spec": {"template": {"spec": {"containers": [{"name": name, "image": "img:v1"}]}}}}


def test_an_auth_notebook_reaches_one_replica_only_once_exposed():
    """The webhook's lock holds the notebook at zero replicas while no
    exposure controller runs; with it, the ServiceAccount, cookie and TLS
    secrets, TLS Service, route to the sidecar's 8443 and both network
    policies appear, the lock goes and the notebook scales to one."""
    seen = []
    for port in (False, True):
        side = Side(port)
        try:
            side.api.create(notebook("nb-auth", auth=True))
            side.settle()
            locked = [side.api.get("Notebook", "nb-auth", NS)["metadata"]["annotations"].get(
                LOCK), side.replicas("nb-auth")]
            side.expose()
            side.settle()
            nb = side.api.get("Notebook", "nb-auth", NS)
            pods = [p["metadata"]["name"] for p in side.api.list("Pod", namespace=NS)]
            seen.append([locked, LOCK in nb["metadata"].get("annotations", {}),
                         side.replicas("nb-auth"), pods, side.owned("nb-auth")])
        finally:
            side.mgr.stop()
    assert seen[1] == seen[0]
    locked, still_locked, replicas, pods, owned = seen[1]
    assert locked == ["odh-notebook-controller-lock", 0]
    assert not still_locked and replicas == 1 and pods == ["nb-auth-0"]
    assert owned["HTTPRoute/nb-auth"]["spec"]["rules"][0]["backendRefs"] == [
        {"name": "nb-auth-tls", "port": 8443}]
    assert {"ServiceAccount/nb-auth", "Secret/nb-auth-cookie-secret", "Secret/nb-auth-tls",
            "Service/nb-auth-tls", "NetworkPolicy/nb-auth-ctrl-np",
            "NetworkPolicy/nb-auth-auth-np"} <= owned.keys()


def test_a_plain_notebook_is_routed_without_auth_materials():
    """Without the auth annotation: no lock, no ServiceAccount or secrets,
    one network policy, and the route goes to the notebook's port 80."""
    seen = []
    for port in (False, True):
        side = Side(port)
        try:
            side.expose()
            side.api.create(notebook("nb-open", auth=False))
            side.settle()
            seen.append([side.replicas("nb-open"), side.owned("nb-open")])
        finally:
            side.mgr.stop()
    assert seen[1] == seen[0]
    replicas, owned = seen[1]
    assert replicas == 1
    assert sorted(k.split("/")[0] for k in owned) == ["HTTPRoute", "NetworkPolicy", "Service"]
    assert owned["HTTPRoute/nb-open"]["spec"]["rules"][0]["backendRefs"] == [
        {"name": "nb-open", "port": 80}]


def test_a_user_stop_is_not_released():
    """Only the webhook's own lock is released: a user's stop annotation
    (another value) keeps the notebook stopped."""
    seen = []
    for port in (False, True):
        side = Side(port)
        try:
            side.expose()
            nb = notebook("nb-stop", auth=False)
            nb["metadata"]["annotations"] = {LOCK: "2026-01-01T00:00:00Z"}
            side.api.create(nb)
            side.settle()
            seen.append([side.api.get("Notebook", "nb-stop", NS)["metadata"]["annotations"],
                         side.replicas("nb-stop")])
        finally:
            side.mgr.stop()
    assert seen[1] == seen[0] == [{LOCK: "2026-01-01T00:00:00Z"}, 0]


TENSORBOARDS = {
    "tb-pvc": ("pvc://trace-pvc/logs", {}),
    "tb-rwx": ("pvc://shared-pvc/runs/a", {}),
    "tb-gcs": ("gs://bucket/traces", {}),
    "tb-gcs-key": ("gs://bucket/traces", {"tensorboards.kubeflow.org/gcp-sa-secret": "sa-key"}),
    "tb-s3": ("s3://bucket/prefix", {}),
    "tb-local": ("/mnt/logs", {}),
}


@pytest.mark.parametrize("rwo_scheduling", ["true", "false"])
def test_tensorboard_controller_objects_equal_jax(monkeypatch, rwo_scheduling):
    """Deployment (the PVC mounted and its subpath served; workload
    identity or the key secret for gs://), Service, HTTPRoute with the
    300 s timeout, the status mirror and events — with the RWO-PVC
    co-scheduling affinity to the node of the pod mounting the claim
    when ``RWO_PVC_SCHEDULING`` is on (none for a ReadWriteMany claim)."""
    monkeypatch.setenv("TENSORBOARD_IMAGE", "tensorboard:test")
    monkeypatch.setenv("RWO_PVC_SCHEDULING", rwo_scheduling)
    seen = []
    for port in (False, True):
        side = Side(port)
        try:
            side.tensorboards()
            for claim, mode in (("trace-pvc", "ReadWriteOnce"), ("shared-pvc", "ReadWriteMany")):
                side.api.create({"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                                 "metadata": {"name": claim, "namespace": NS},
                                 "spec": {"accessModes": [mode]}})
            side.api.create({"apiVersion": "v1", "kind": "Pod",
                             "metadata": {"name": "writer", "namespace": NS},
                             "spec": {"nodeName": "cpu-0", "containers": [{"name": "w"}],
                                      "volumes": [{"name": "t", "persistentVolumeClaim": {
                                          "claimName": "trace-pvc"}}]}})
            for name, (logspath, ann) in TENSORBOARDS.items():
                side.api.create({"apiVersion": "tensorboard.kubeflow.org/v1alpha1",
                                 "kind": "Tensorboard",
                                 "metadata": {"name": name, "namespace": NS, "annotations": ann},
                                 "spec": {"logspath": logspath}})
            side.settle()
            objects = {}
            for name in TENSORBOARDS:
                objects[name] = scrub({
                    "deployment": side.api.get("Deployment", name, NS)["spec"],
                    "service": side.api.get("Service", name, NS)["spec"],
                    "route": side.api.get("HTTPRoute", f"tensorboard-{name}", NS)["spec"],
                    "status": side.api.get("Tensorboard", name, NS)["status"]})
            objects["events"] = sorted((e["involvedObject"]["name"], e["reason"])
                                       for e in side.api.list("Event", namespace=NS)
                                       if e["involvedObject"]["kind"] == "Tensorboard")
            seen.append(objects)
        finally:
            side.mgr.stop()
    assert seen[1] == seen[0]
    pvc = seen[1]["tb-pvc"]["deployment"]["template"]["spec"]
    assert pvc["volumes"] == [{"name": "logs",
                               "persistentVolumeClaim": {"claimName": "trace-pvc"}}]
    assert pvc["containers"][0]["args"][0] == "--logdir=/logs/logs"
    assert ("affinity" in pvc) == (rwo_scheduling == "true")
    assert "affinity" not in seen[1]["tb-rwx"]["deployment"]["template"]["spec"]
    assert seen[1]["tb-pvc"]["route"]["rules"][0]["timeouts"] == {"request": "300s"}
    assert seen[1]["tb-pvc"]["status"]["readyReplicas"] == 1


def test_tensorboard_default_image_serves_the_ports_traces():
    """The port's default image is its own (TensorBoard with the profile
    plugins that index ``utils/profiling.py``'s file name), with the
    plugins' Python loader; the logspath schemes parse as JAX's."""
    from odh_kubeflow_tpu.controllers.tensorboard import TensorboardController as Jax
    from odh_kubeflow_tpu_torch.controllers import tensorboard
    from odh_kubeflow_tpu_torch.utils import profiling

    assert tensorboard.DEFAULT_IMAGE == "odh-kubeflow-tpu/tensorboard-pytorch:latest"
    assert profiling.TRACE_SUFFIX.endswith(".trace.json.gz")
    for path in ("pvc://c/sub/dir", "pvc://c", "gs://b/p", "s3://b/p", "/local", "relative"):
        assert tensorboard.TensorboardController.parse_logspath(path) == Jax.parse_logspath(path)
