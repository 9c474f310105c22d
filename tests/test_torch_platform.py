"""The port's control plane on GPU node pools against the JAX package's on
TPU slices, on the CPU.

The same Notebook, Profile and node-pool inputs go through both
packages' store, kubelet simulator and notebook / profile / culler /
kfam controllers. JAX's output, carried through the accelerator mapping
(``odh_kubeflow_tpu_torch.apis.ACCELERATOR_MAPPING`` plus each case's
values: a TPU type and topology become a GKE GPU type and a GPU count),
must equal the port's: the StatefulSet, the Services, the ResourceQuota,
the scheduling decision, the quota rejection, the culler's stop
annotation, the kfam RoleBinding, the preemption condition and events
and the gang restart. Volatile fields (uids, resource versions, wall
timestamps, generated Event names) are scrubbed on both sides.
"""

from __future__ import annotations

import functools
import re
import threading
from dataclasses import dataclass
from http.server import HTTPServer

import pytest

import odh_kubeflow_tpu_torch.apis as gpu_apis
from odh_kubeflow_tpu_torch.apis import ACCELERATOR_MAPPING

OWNER = "alice@example.com"
NS = "team-par"
T0 = 1_700_000_000.0


@dataclass(frozen=True)
class Case:
    tpu_accel: str
    topology: str
    gpu_accel: str
    gpus: int
    node_gpus: int  # the GPU type's GPUs per node, and the JAX pool's chips per host
    pool_nodes: int  # nodes of the first pool: the gang's node count

    @property
    def nodes(self) -> int:
        return -(-self.gpus // self.node_gpus)

    def __str__(self):
        return f"{self.topology}-as-{self.gpu_accel}-{self.gpus}"


# each case holds the same shape on both sides: chips ↔ GPUs, hosts ↔ nodes
CASES = [
    Case("tpu-v5-lite-podslice", "1x1", "nvidia-h100-80gb", 1, 8, 1),
    Case("tpu-v5-lite-podslice", "2x2", "nvidia-h100-80gb", 4, 8, 1),
    Case("tpu-v5p-slice", "2x2x1", "nvidia-h100-80gb", 4, 8, 2),
    Case("tpu-v5-lite-podslice", "2x4", "nvidia-l4", 8, 4, 2),
    Case("tpu-v5-lite-podslice", "4x4", "nvidia-l4", 16, 4, 4),
]
CASE_IDS = [str(c) for c in CASES]

# podIP: JAX's kubelet simulator gives a running pod a new IP on every
# pass, the port's keeps it (test_running_pods_keep_their_status)
_VOLATILE = {
    "uid", "creationTimestamp", "resourceVersion", "firstReadyAt", "startedAt",
    "firstTimestamp", "lastTimestamp", "deletionTimestamp", "podIP",
}
_STRING_MAP = sorted(ACCELERATOR_MAPPING.items(), key=lambda kv: -len(kv[0]))


def to_gpu(obj, case: Case):
    """JAX's output carried through the accelerator mapping for ``case``."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            nk = ACCELERATOR_MAPPING.get(k, k)
            if k in ("notebooks.kubeflow.org/tpu-accelerator",
                     "cloud.google.com/gke-tpu-accelerator", "acceleratorType"):
                out[nk] = case.gpu_accel
            elif k == "notebooks.kubeflow.org/tpu-topology":
                out[nk] = str(case.gpus)
            elif k == "cloud.google.com/gke-tpu-topology":
                out[nk] = str(case.node_gpus)
            elif k == "env" and isinstance(v, list):
                out[nk] = _env_to_gpu(v, case)
            else:
                out[nk] = to_gpu(v, case)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_gpu(v, case) for v in obj)
    if isinstance(obj, str):
        for tpu, gpu in _STRING_MAP:
            obj = obj.replace(tpu, gpu)
        obj = obj.replace(case.tpu_accel, case.gpu_accel).replace("chip(s)", "GPU(s)")
        # a node selector quoted in a scheduling message: topology → node GPUs
        obj = obj.replace(f"'{case.topology}'", f"'{case.node_gpus}'")
        # the worker-identity env keeps its names (utils/distributed.py reads them)
        return re.sub(r"TPU(?!_WORKER)", "GPU", obj)
    return obj


def _env_to_gpu(env: list, case: Case) -> list:
    """The port's GPU pods see every GPU of their limit: one entry ahead
    of the worker identity the JAX package injects."""
    out = [to_gpu(e, case) for e in env]
    names = [e.get("name") for e in out]
    if "TPU_WORKER_ID" in names:
        at = min(names.index(n) for n in ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES") if n in names)
        out.insert(at, {"name": "NVIDIA_VISIBLE_DEVICES", "value": "all"})
    return out


def scrub(obj):
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


def events(api, ns=NS):
    """(kind/name, reason, type, message, count) of every Event, sorted."""
    return sorted(
        (f"{e['involvedObject']['kind']}/{e['involvedObject']['name']}", e["reason"],
         e["type"], e["message"], e.get("count", 1))
        for e in api.list("Event", namespace=ns)
    )


@functools.lru_cache(maxsize=None)
def _jupyter_url() -> str:
    from odh_kubeflow_tpu_torch.conformance import _IdleJupyter

    _IdleJupyter.idle_since = T0
    server = HTTPServer(("127.0.0.1", 0), _IdleJupyter)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_port}"


class Side:
    """One package's platform on one case: store, kubelet simulator,
    manager with the notebook (culling on) and profile controllers, kfam,
    and a fake clock."""

    def __init__(self, port: bool, case: Case, queueing: bool = False):
        if port:
            from odh_kubeflow_tpu_torch import apis
            from odh_kubeflow_tpu_torch.controllers import culler, kfam, notebook, profile
            from odh_kubeflow_tpu_torch.controllers.runtime import Manager
            from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
            from odh_kubeflow_tpu_torch.machinery.store import APIServer
            from odh_kubeflow_tpu_torch.scheduling import register_scheduling
            from odh_kubeflow_tpu_torch.utils.prometheus import Registry

            self.quota_key = profile.GPU_QUOTA_KEY
            self.annotations = {apis.GPU_ACCELERATOR_ANNOTATION: case.gpu_accel,
                                apis.GPU_COUNT_ANNOTATION: str(case.gpus)}
        else:
            from odh_kubeflow_tpu import apis
            from odh_kubeflow_tpu.controllers import culler, kfam, notebook, profile
            from odh_kubeflow_tpu.controllers.runtime import Manager
            from odh_kubeflow_tpu.machinery.kubelet import FakeCluster
            from odh_kubeflow_tpu.machinery.store import APIServer
            from odh_kubeflow_tpu.scheduling import register_scheduling
            from odh_kubeflow_tpu.utils.prometheus import Registry

            self.quota_key = profile.TPU_QUOTA_KEY
            self.annotations = {apis.TPU_ACCELERATOR_ANNOTATION: case.tpu_accel,
                                apis.TPU_TOPOLOGY_ANNOTATION: case.topology}
        self.port, self.case, self.apis = port, case, apis
        self.notebook_mod = notebook
        self.clock = {"now": T0}
        self.api = APIServer()
        apis.register_crds(self.api)
        if queueing:
            register_scheduling(self.api)
        self.cluster = FakeCluster(self.api)
        self.mgr = Manager(self.api, time_fn=lambda: self.clock["now"])
        url = _jupyter_url()
        cul = culler.Culler(
            self.api,
            culler.CullerConfig(cull_idle_seconds=600, idleness_check_seconds=60),
            base_url_fn=lambda nb: url,
            now_fn=lambda: self.clock["now"],
        )
        self.registry = Registry()
        self.controller = notebook.NotebookController(
            self.api,
            notebook.NotebookControllerConfig(enable_culling=True, enable_queueing=queueing),
            registry=self.registry,
            culler=cul,
        )
        self.controller.register(self.mgr)
        profile.ProfileController(self.api, registry=Registry()).register(self.mgr)
        self.kfam = kfam.KfamService(self.api, cluster_admins={"root@example.com"})

    def add_pool(self, name: str, nodes: int):
        c = self.case
        if self.port:
            self.cluster.add_gpu_node_pool(name, c.gpu_accel, num_nodes=nodes,
                                           gpus_per_node=c.node_gpus)
        else:
            self.cluster.add_tpu_node_pool(name, c.tpu_accel, c.topology, num_hosts=nodes,
                                           chips_per_host=c.node_gpus)

    def notebook(self, name: str) -> dict:
        return {
            "apiVersion": "kubeflow.org/v1beta1",
            "kind": "Notebook",
            "metadata": {"name": name, "namespace": NS, "annotations": dict(self.annotations)},
            "spec": {"template": {"spec": {"containers": [{"name": name, "image": "nb"}]}}},
        }

    def settle(self):
        self.mgr.drain()
        self.cluster.step()
        self.mgr.drain()

    def pods(self, name: str) -> list:
        return sorted(
            (p for p in self.api.list("Pod", namespace=NS)
             if p["metadata"]["labels"].get("notebook-name") == name),
            key=lambda p: p["metadata"]["name"],
        )


def scenario(side: Side) -> dict:
    """The conformance sequence's control-plane steps at the case's
    shape; returns a snapshot of what each step left behind."""
    api, snap, n = side.api, {}, side.case.pool_nodes
    side.add_pool("pool-a", n)
    api.create({
        "apiVersion": "kubeflow.org/v1", "kind": "Profile", "metadata": {"name": NS},
        "spec": {"owner": {"kind": "User", "name": OWNER},
                 "resourceQuotaSpec": {"hard": {side.quota_key: str(side.case.gpus)}}},
    })
    side.mgr.drain()
    snap["quota"] = api.get("ResourceQuota", "kf-resource-quota", NS)
    snap["namespace"] = api.get("Namespace", NS)
    snap["rolebindings"] = sorted(api.list("RoleBinding", namespace=NS),
                                  key=lambda o: o["metadata"]["name"])

    api.create(side.notebook("nb1"))
    side.settle()
    snap["sts"] = api.get("StatefulSet", "nb1", NS)
    snap["services"] = sorted(api.list("Service", namespace=NS),
                              key=lambda o: o["metadata"]["name"])
    snap["pods"] = side.pods("nb1")
    snap["nodes"] = sorted(api.list("Node"), key=lambda o: o["metadata"]["name"])
    snap["status"] = api.get("Notebook", "nb1", NS)["status"]

    side.kfam.create_binding({
        "user": {"kind": "User", "name": "bob@example.com"}, "referredNamespace": NS,
        "roleRef": {"apiGroup": "rbac.authorization.k8s.io", "kind": "ClusterRole",
                    "name": "kubeflow-edit"},
    }, requester=OWNER)
    snap["kfam"] = [api.get(kind, "user-bob-example-com-clusterrole-kubeflow-edit", NS)
                    for kind in ("RoleBinding", "AuthorizationPolicy")]
    snap["kfam_namespaces"] = side.kfam.namespaces_for_user("bob@example.com")

    api.create(side.notebook("nb2"))
    side.settle()
    snap["rejected_pods"] = side.pods("nb2")
    snap["quota_after_reject"] = api.get("ResourceQuota", "kf-resource-quota", NS)
    snap["events_after_reject"] = events(api)
    api.delete("Notebook", "nb2", NS)
    side.mgr.drain()

    side.clock["now"] += 61
    side.mgr.drain()
    side.clock["now"] += 700
    side.settle()
    snap["culled"] = api.get("Notebook", "nb1", NS)["metadata"]["annotations"]
    snap["culled_sts"] = api.get("StatefulSet", "nb1", NS)["spec"]["replicas"]

    api.patch("Notebook", "nb1", {"metadata": {"annotations": {
        side.apis.STOP_ANNOTATION: None}}}, NS)
    side.settle()
    snap["restarted_pods"] = side.pods("nb1")

    node = side.pods("nb1")[0]["spec"]["nodeName"]
    side.cluster.preempt_node(node)
    side.mgr.drain()
    snap["preempted_status"] = api.get("Notebook", "nb1", NS)["status"]
    snap["preempted_pods"] = side.pods("nb1")
    snap["events_after_preempt"] = events(api)

    side.settle()  # one node short: the gang cannot all come back
    snap["partial_status"] = api.get("Notebook", "nb1", NS)["status"]
    snap["partial_pods"] = side.pods("nb1")

    side.add_pool("pool-b", n)
    side.settle()
    side.settle()
    snap["recovered_pods"] = side.pods("nb1")
    snap["recovered_status"] = api.get("Notebook", "nb1", NS)["status"]
    snap["events_after_recovery"] = events(api)
    side.mgr.stop()
    return snap


@functools.lru_cache(maxsize=None)
def snapshots(case: Case) -> tuple[dict, dict]:
    """(JAX's snapshot mapped to GPUs and scrubbed, the port's scrubbed)."""
    jax_snap = to_gpu(scenario(Side(port=False, case=case)), case)
    port_snap = scenario(Side(port=True, case=case))
    for snap in (jax_snap, port_snap):  # Events sort by their mapped text
        for k in [k for k in snap if k.startswith("events_")]:
            snap[k] = sorted(snap[k])
    return scrub(jax_snap), scrub(port_snap)


def assert_same(case: Case, *keys):
    want, got = snapshots(case)
    for k in keys:
        assert got[k] == want[k], k


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_statefulset_matches_jax(case):
    assert_same(case, "sts")
    want, got = snapshots(case)
    assert got["sts"]["spec"]["replicas"] == case.nodes
    c0 = got["sts"]["spec"]["template"]["spec"]["containers"][0]
    assert c0["resources"]["limits"] == {"nvidia.com/gpu": str(case.gpus // case.nodes)}


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_services_match_jax(case):
    assert_same(case, "services")
    names = [s["metadata"]["name"] for s in snapshots(case)[1]["services"]]
    assert names == (["nb1", "nb1-hosts"] if case.gpus > case.node_gpus else ["nb1"])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_profile_quota_namespace_and_rolebindings_match_jax(case):
    assert_same(case, "quota", "namespace", "rolebindings")
    assert snapshots(case)[1]["quota"]["spec"]["hard"] == {
        "requests.nvidia.com/gpu": str(case.gpus)}


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scheduling_decision_matches_jax(case):
    """The pods, their nodes and the nodes' labels and capacity."""
    assert_same(case, "pods", "nodes", "status")
    pods = snapshots(case)[1]["pods"]
    assert all(p["status"]["phase"] == "Running" for p in pods)
    assert len({p["spec"]["nodeName"] for p in pods}) == len(pods)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_quota_rejection_matches_jax(case):
    assert_same(case, "rejected_pods", "quota_after_reject", "events_after_reject")
    want, got = snapshots(case)
    assert got["rejected_pods"] == []
    assert any(r == "FailedCreate" and "exceeded quota" in m and "nvidia.com/gpu" in m
               for _, r, _, m, _ in got["events_after_reject"])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_culler_stop_annotation_matches_jax(case):
    assert_same(case, "culled", "culled_sts", "restarted_pods")
    got = snapshots(case)[1]
    assert gpu_apis.STOP_ANNOTATION in got["culled"] and got["culled_sts"] == 0


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_kfam_rolebinding_matches_jax(case):
    assert_same(case, "kfam", "kfam_namespaces")
    assert snapshots(case)[1]["kfam_namespaces"] == [NS]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_preempt_condition_and_events_match_jax(case):
    assert_same(case, "preempted_status", "preempted_pods", "events_after_preempt")
    conds = {c["type"]: c for c in snapshots(case)[1]["preempted_status"]["conditions"]}
    assert conds["SlicePreempted"]["status"] == "True"
    assert any(r == "GPUSlicePreempted" for _, r, _, _, _ in
               snapshots(case)[1]["events_after_preempt"])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_gang_restart_matches_jax(case):
    """One node short the condition holds; with capacity back every pod
    runs and it flips to SliceRecovered."""
    assert_same(case, "partial_status", "partial_pods", "recovered_pods", "recovered_status",
                "events_after_recovery")
    got = snapshots(case)[1]
    partial = {c["type"]: c for c in got["partial_status"]["conditions"]}
    running = sum(p["status"]["phase"] == "Running" for p in got["partial_pods"])
    assert running == min(case.pool_nodes - 1, case.nodes)
    assert partial["SlicePreempted"]["status"] == ("False" if running == case.nodes else "True")
    assert [p["status"]["phase"] for p in got["recovered_pods"]] == ["Running"] * len(
        got["recovered_pods"])
    conds = {c["type"]: c for c in got["recovered_status"]["conditions"]}
    assert (conds["SlicePreempted"]["status"], conds["SlicePreempted"]["reason"]) == (
        "False", "SliceRecovered")


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_queued_statefulset_workload_and_gated_pods_match_jax(case):
    """With queueing on: the gated template, the gang Workload (its spec
    keys renamed: hosts → nodes, chipsPerHost → gpusPerNode, chips →
    gpus, topology → acceleratorCount) and the pods the kubelet keeps
    Pending until the Workload is admitted."""
    renamed = {"hosts": "nodes", "chipsPerHost": "gpusPerNode", "chips": "gpus",
               "topology": "acceleratorCount"}
    out = {}
    for port in (False, True):
        side = Side(port=port, case=case, queueing=True)
        side.add_pool("pool-a", case.pool_nodes)
        side.api.create(side.notebook("nb1"))
        side.settle()
        got = {"sts": side.api.get("StatefulSet", "nb1", NS),
               "workload": side.api.get("Workload", "nb1", NS), "pods": side.pods("nb1")}
        side.mgr.stop()
        if not port:
            got = to_gpu(got, case)
            spec = {renamed.get(k, k): v for k, v in got["workload"]["spec"].items()}
            spec["acceleratorCount"] = str(case.node_gpus)
            got["workload"]["spec"] = spec
        out[port] = scrub(got)
    assert out[True] == out[False]
    assert out[True]["workload"]["spec"]["gpus"] == case.gpus
    assert {p["status"]["conditions"][0]["reason"] for p in out[True]["pods"]} == {
        "SchedulingGated"}


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_gpu_request_matches_tpu_request(case):
    from odh_kubeflow_tpu.controllers.notebook import tpu_request_of
    from odh_kubeflow_tpu_torch.controllers.notebook import gpu_request_of

    tpu = tpu_request_of(Side(False, case).notebook("x"))
    gpu = gpu_request_of(Side(True, case).notebook("x"))
    assert (gpu.gpus, gpu.nodes, gpu.gpus_per_node) == (tpu.chips, tpu.hosts, tpu.chips_per_host)


@pytest.mark.parametrize("annotations, message", [
    ({"notebooks.kubeflow.org/gpu-accelerator": "nvidia-b300"}, "unknown GPU accelerator"),
    ({"notebooks.kubeflow.org/gpu-accelerator": "nvidia-h100-80gb",
      "notebooks.kubeflow.org/gpu-count": "3"}, "unknown GPU count"),
    ({"notebooks.kubeflow.org/gpu-accelerator": "nvidia-h100-80gb",
      "notebooks.kubeflow.org/gpu-count": "0"}, "must be positive"),
])
def test_invalid_gpu_request_is_refused_as_jax_refuses_a_tpu_one(annotations, message):
    """A bad request raises in the request parser and surfaces as a
    warning event and a Degraded condition, as JAX's does."""
    from odh_kubeflow_tpu_torch.controllers.notebook import gpu_request_of

    side = Side(True, CASES[0])
    nb = side.notebook("bad")
    nb["metadata"]["annotations"] = annotations
    with pytest.raises(ValueError, match=message):
        gpu_request_of(nb)
    side.api.create(nb)
    side.mgr.drain()
    status = side.api.get("Notebook", "bad", NS)["status"]
    assert [(c["type"], c["reason"]) for c in status["conditions"]] == [
        ("Degraded", "GPURequestInvalid")]
    assert [e[1] for e in events(side.api)] == ["InvalidGPURequest"]
    from odh_kubeflow_tpu_torch.machinery.store import NotFound

    with pytest.raises(NotFound):
        side.api.get("StatefulSet", "bad", NS)


def test_node_pool_table_folds_in_the_peak_table():
    from odh_kubeflow_tpu_torch.utils import gpu
    from odh_kubeflow_tpu_torch.utils.device import peak_flops_per_device

    assert gpu.GPU_ACCELERATORS["nvidia-h100-80gb"].gpus_per_node == 8
    assert gpu.nodes_in_slice("nvidia-h100-80gb", 4) == 1
    assert gpu.nodes_in_slice("nvidia-h100-80gb", 16) == 2
    assert gpu.nodes_in_slice("nvidia-l4", 16) == 4
    for t in gpu.GPU_TYPES:
        assert peak_flops_per_device(f"NVIDIA {t.device_name}") == gpu.peak_bf16_flops(
            t.device_name)
        assert not t.accelerator or (t.gpus_per_node and t.counts)


def _store_ops(store_mod) -> list:
    """One sequence of store operations; what each returned or raised."""
    api = store_mod.APIServer()
    api.EVENT_RETENTION = 3
    out = []

    def do(fn, *a, **k):
        try:
            r = fn(*a, **k)
            out.append(scrub(r) if isinstance(r, (dict, list)) else r)
        except store_mod.APIError as e:
            out.append((type(e).__name__, e.code))

    cm = {"apiVersion": "v1", "kind": "ConfigMap",
          "metadata": {"name": "a", "namespace": "ns", "labels": {"x": "1"}}, "data": {"k": "v"}}
    do(api.create, cm)
    do(api.create, cm)  # AlreadyExists
    cur = api.get("ConfigMap", "a", "ns")
    stale = dict(cur, metadata=dict(cur["metadata"], resourceVersion="1"))
    do(api.update, dict(cur, data={"k": "w"}))
    do(api.update, dict(stale, data={"k": "z"}))  # Conflict
    do(api.update, api.get("ConfigMap", "a", "ns"))  # a no-op write keeps its rv
    do(api.patch, "ConfigMap", "a", {"data": {"k": None, "j": "1"}}, "ns")
    do(api.list, "ConfigMap", namespace="ns", label_selector={"matchLabels": {"x": "1"}})
    do(api.list, "ConfigMap", label_selector={"matchExpressions": [
        {"key": "x", "operator": "NotIn", "values": ["1"]}]})
    do(api.get, "ConfigMap", "nope", "ns")  # NotFound
    do(api.create, {"kind": "Pod", "metadata": {"name": "p"}})  # Invalid: namespace required
    owner = api.create({"apiVersion": "apps/v1", "kind": "StatefulSet",
                        "metadata": {"name": "s", "namespace": "ns",
                                     "finalizers": ["f"]}, "spec": {"replicas": 1}})
    pod = {"apiVersion": "v1", "kind": "Pod", "metadata": {
        "name": "s-0", "namespace": "ns", "ownerReferences": [
            {"kind": "StatefulSet", "name": "s", "uid": owner["metadata"]["uid"]}]}}
    do(api.create, pod)
    w = api.watch("Pod", namespace="ns")
    do(api.delete, "StatefulSet", "s", "ns")  # finalizer: marked, not removed
    do(lambda: "deletionTimestamp" in api.get("StatefulSet", "s", "ns")["metadata"])
    s = api.get("StatefulSet", "s", "ns")
    s["metadata"]["finalizers"] = []
    do(api.update, s)  # the finalizer's removal releases the delete and cascades
    do(api.list, "Pod", namespace="ns")
    do(lambda: [(t, o["metadata"]["name"]) for t, o in iter(w.try_get, None)])
    w.stop()
    for i in range(5):  # a repeat dedupes; past 3 Events the oldest go
        do(lambda i=i: {k: v for k, v in api.emit_event(cm, "R", f"m{i % 4}", "Warning", "c")
                        .items() if k in ("reason", "message", "type", "count", "source")})
    do(lambda: sorted(e["message"] for e in api.list("Event", namespace="ns")))
    api.WATCH_CACHE_SIZE = 2
    slow = api.watch("ConfigMap", namespace="ns", send_initial=False)
    for i in range(3):
        api.create(dict(cm, metadata={"name": f"b{i}", "namespace": "ns"}))
    do(lambda: (slow.evicted, slow.ended, type(slow.error).__name__, api.watch_evictions))
    return out


def test_store_semantics_match_jax():
    """CRUD, conflicts, no-op writes, merge patch, selectors, two-phase
    delete with cascade, watch events, Event dedupe and retention, and a
    slow watch consumer's eviction, step by step."""
    from odh_kubeflow_tpu.machinery import store as jax_store
    from odh_kubeflow_tpu_torch.machinery import store as port_store

    want, got = _store_ops(jax_store), _store_ops(port_store)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)


@pytest.mark.parametrize("user, verb, resource, namespace", [
    (OWNER, "delete", "notebooks", NS),
    (OWNER, "get", "secrets", NS),
    ("bob@example.com", "create", "notebooks", NS),
    ("bob@example.com", "get", "secrets", NS),
    ("bob@example.com", "delete", "profiles", None),
    ("eve@example.com", "get", "pods", NS),
    ("system:serviceaccount:team-par:default-editor", "patch", "pods", NS),
    ("system:serviceaccount:team-par:default-viewer", "patch", "pods", NS),
    ("system:serviceaccount:team-par:default-viewer", "list", "pods", NS),
])
def test_rbac_decisions_match_jax(user, verb, resource, namespace):
    """The RBAC evaluator over what the profile controller and kfam wrote."""
    from odh_kubeflow_tpu.machinery.rbac import RBACEvaluator as JaxRBAC
    from odh_kubeflow_tpu_torch.machinery.rbac import RBACEvaluator

    seen = []
    for port, evaluator in ((False, JaxRBAC), (True, RBACEvaluator)):
        side = Side(port=port, case=CASES[0])
        side.apis.install_default_cluster_roles(side.api)
        side.api.create({
            "apiVersion": "kubeflow.org/v1", "kind": "Profile", "metadata": {"name": NS},
            "spec": {"owner": {"kind": "User", "name": OWNER}}})
        side.mgr.drain()
        side.kfam.create_binding({
            "user": {"kind": "User", "name": "bob@example.com"}, "referredNamespace": NS,
            "roleRef": {"apiGroup": "rbac.authorization.k8s.io", "kind": "ClusterRole",
                        "name": "kubeflow-edit"}}, requester=OWNER)
        group = "kubeflow.org" if resource in ("notebooks", "profiles") else ""
        seen.append(evaluator(side.api).can(user, verb, resource, namespace, api_group=group))
        side.mgr.stop()
    assert seen[0] == seen[1]


def test_manager_runs_live_and_stops():
    """The controller runtime's live mode (watch pumps and workers on
    threads) reconciles a notebook without ``drain`` and stops."""
    import time

    side = Side(port=True, case=CASES[1])
    side.mgr.start()
    try:
        side.api.create(side.notebook("live"))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                sts = side.api.get("StatefulSet", "live", NS)
                break
            except Exception:  # noqa: BLE001 — not reconciled yet
                time.sleep(0.02)
        else:
            raise AssertionError("no StatefulSet within 10 s")
    finally:
        side.mgr.stop()
    assert sts["metadata"]["ownerReferences"][0]["name"] == "live"
    for c in side.mgr.controllers:
        for t in c._threads:
            t.join(timeout=5)
            assert not t.is_alive()


def test_notebook_metrics_match_jax():
    """The controller's counters and its scrape-time running-notebook
    gauge (a registry collector), after one spawn and one cull."""
    lines = {}
    for port in (False, True):
        side = Side(port=port, case=CASES[1])
        side.add_pool("pool-a", 1)
        side.api.create(side.notebook("nb1"))
        side.settle()
        running = [x for x in side.registry.exposition().splitlines()
                   if x.startswith("notebook_running ")]
        side.clock["now"] += 61
        side.mgr.drain()
        side.clock["now"] += 700
        side.settle()
        lines[port] = running + [
            x for x in side.registry.exposition().splitlines()
            if x.startswith(("notebook_running ", "notebook_create_total ",
                             "notebook_culling_total "))]
        side.mgr.stop()
    assert lines[True] == lines[False]
    assert lines[True][0] == "notebook_running 1"
    assert "notebook_culling_total 1" in lines[True]


def test_running_pods_keep_their_status():
    """A settled cluster writes nothing: a kubelet pass leaves a Running
    pod's IP and start times as they were (JAX's simulator reassigns
    them on every pass), so the notebook controller has nothing to
    mirror either. Each pod got an IP of its own when it first ran."""
    side = Side(port=True, case=CASES[1])
    side.add_pool("pool-a", 2)
    for name in ("nb1", "nb2"):
        side.api.create(side.notebook(name))
    side.settle()
    pods = side.pods("nb1") + side.pods("nb2")
    rv = side.api._rv
    for _ in range(3):
        side.settle()
    assert side.api._rv == rv
    again = side.pods("nb1") + side.pods("nb2")
    assert [p["status"] for p in again] == [p["status"] for p in pods]
    assert [p["status"]["phase"] for p in again] == ["Running", "Running"]
    ips = [p["status"]["podIP"] for p in again]
    assert all(ips) and len(set(ips)) == len(ips)
    side.mgr.stop()


def test_container_env_resolves_values_and_field_refs():
    """``kubelet.container_env``: the first container's env as a kubelet
    gives it, plain values and ``fieldRef`` values read off the pod."""
    from odh_kubeflow_tpu_torch.machinery.kubelet import container_env

    def ref(path):
        return {"valueFrom": {"fieldRef": {"fieldPath": path}}}

    pod = {
        "metadata": {"name": "nb1-0", "namespace": NS,
                     "labels": {"notebook-name": "nb1"}},
        "spec": {"containers": [
            {"name": "nb1", "env": [
                {"name": "PLAIN", "value": "8476"},
                {"name": "EMPTY"},
                {"name": "NOTEBOOK", **ref("metadata.labels['notebook-name']")},
                {"name": "MISSING_LABEL", **ref("metadata.labels['absent']")},
                {"name": "POD_NAME", **ref("metadata.name")},
                {"name": "POD_IP", **ref("status.podIP")},
            ]},
            {"name": "sidecar", "env": [{"name": "SIDECAR", "value": "1"}]},
        ]},
        "status": {"phase": "Running", "podIP": "10.0.0.7"},
    }
    assert container_env(pod) == {
        "PLAIN": "8476", "EMPTY": "", "NOTEBOOK": "nb1", "MISSING_LABEL": "",
        "POD_NAME": "nb1-0", "POD_IP": "10.0.0.7"}
    pod["spec"]["containers"][0]["env"] = [
        {"name": "TOKEN", "valueFrom": {"secretKeyRef": {"name": "s", "key": "k"}}}]
    with pytest.raises(ValueError, match="only fieldRef"):
        container_env(pod)
