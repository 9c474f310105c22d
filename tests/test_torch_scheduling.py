"""The port's gang scheduler on GPU node pools against the JAX package's on
TPU slices, on the CPU.

Every scenario of JAX's ``tests/test_scheduling.py`` runs through both
packages' store, kubelet simulator, notebook controller (queueing on)
and ``SliceScheduler``: Workload derivation, all-or-nothing admission,
strict priority order, preemption, gang atomicity under node loss,
foreign pods, the quota mirror, the JWA's queue surface, the culler's
queue-wait guard, backoff, metrics, and the randomized admit / preempt /
node-loss sequences. JAX's decisions, carried across by ``to_port`` (a
TPU flavor becomes a GPU flavor of the same shape: chips a host ↔ GPUs
a node, hosts ↔ nodes; its messages' nouns renamed), must equal the
port's: the admitted set, node assignments, eviction order, pending
reasons and positions, and the scheduler's events.
"""

from __future__ import annotations

import itertools
import random
import re
import time

import pytest

from odh_kubeflow_tpu_torch.apis import ACCELERATOR_MAPPING

V5E = "tpu-v5-lite-podslice"
V5P = "tpu-v5p-slice"
NS = "team-a"

# a TPU flavor → its GPU counterpart: (accelerator, GPUs of the request,
# GPUs a node) with chips a host == GPUs a node, so every count carries
FLAVORS = {
    (V5E, "2x2"): ("nvidia-l4", 4, 4),  # 1 host × 4 chips ↔ 1 node × 4 GPUs
    (V5P, "2x2x2"): ("nvidia-l4", 8, 4),  # 2 hosts × 4 ↔ 2 nodes × 4
    (V5P, "4x4x4"): ("nvidia-h100-80gb", 64, 8),  # absent from every cluster here
}
_RENAMED = {"hosts": "nodes", "chipsPerHost": "gpusPerNode", "chips": "gpus",
            "topology": "acceleratorCount"}
_VOLATILE = {"uid", "creationTimestamp", "resourceVersion", "queuedAt", "admittedAt",
             "firstTimestamp", "lastTimestamp"}


def _text_to_port(s: str) -> str:
    for (tpu, topo), (gpu, _, per_node) in FLAVORS.items():
        s = s.replace(f"{tpu}/{topo} slice with", f"{gpu}/{per_node} node pool with")
        s = s.replace(f"accelerator {tpu} topology {topo} in the cluster",
                      f"accelerator {gpu} and {per_node} GPUs a node in the cluster")
        s = s.replace(f"the only {tpu}/{topo} capacity", f"the only {gpu}/{per_node} capacity")
    for a, b in (
        ("free host(s)", "free node(s)"), ("chips each)", "GPUs each)"),
        ("assigned TPU host(s)", "assigned GPU node(s)"),
        ("slice assignment no longer matches the workload spec",
         "node-pool assignment no longer matches the workload spec"),
        ("assigned host capacity", "assigned node capacity"),
        ("admitted to slice ", "admitted to node pool "), ("(hosts: ", "(nodes: "),
        ("requests.google.com/tpu", "requests.nvidia.com/gpu"), ("chip(s)", "GPU(s)"),
    ):
        s = s.replace(a, b)
    return s


def to_port(obj):
    """JAX's observations carried to the port's names and values."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "spec" and isinstance(v, dict) and "chipsPerHost" in v:
                tpu = (v["acceleratorType"], v["topology"])
                gpu, _, per_node = FLAVORS[tpu]
                spec = {_RENAMED.get(sk, sk): to_port(sv) for sk, sv in v.items()}
                spec.update(acceleratorType=gpu, acceleratorCount=str(per_node))
                out[k] = spec
            else:
                k = _RENAMED.get(k, k) if k != "topology" else k
                out[ACCELERATOR_MAPPING.get(k, k)] = to_port(v)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(v) for v in obj)
    if isinstance(obj, str):
        return _text_to_port(obj)
    return obj


def scrub(obj):
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


@pytest.fixture(autouse=True)
def ordered_clock(monkeypatch):
    """Strictly increasing object timestamps in both packages, so that
    creation order (a tie-break of the admission order) never depends on
    where a second boundary falls during the run."""
    from odh_kubeflow_tpu.machinery import objects as jax_objects
    from odh_kubeflow_tpu_torch.machinery import objects as port_objects

    ticks = itertools.count()
    base = time.time() - 86_400

    def now_rfc3339():
        return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(base + next(ticks)))

    for mod in (jax_objects, port_objects):
        monkeypatch.setattr(mod, "now_rfc3339", now_rfc3339)


class Env:
    """One package's platform: store, kubelet simulator, notebook
    controller with queueing, ``SliceScheduler`` and the two priority
    classes (JAX's ``make_env``)."""

    def __init__(self, port: bool, quota=None, culling=False):
        if port:
            from odh_kubeflow_tpu_torch import apis
            from odh_kubeflow_tpu_torch.controllers import culler as culler_mod
            from odh_kubeflow_tpu_torch.controllers import notebook as nb_mod
            from odh_kubeflow_tpu_torch.controllers.runtime import Manager
            from odh_kubeflow_tpu_torch.machinery import objects, store
            from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
            from odh_kubeflow_tpu_torch.scheduling import register_scheduling, scheduler
            from odh_kubeflow_tpu_torch.scheduling import workload
            from odh_kubeflow_tpu_torch.utils.prometheus import Registry
            from odh_kubeflow_tpu_torch.web.jwa import JupyterWebApp

            self.resource = apis.GPU_RESOURCE
        else:
            from odh_kubeflow_tpu import apis
            from odh_kubeflow_tpu.controllers import culler as culler_mod
            from odh_kubeflow_tpu.controllers import notebook as nb_mod
            from odh_kubeflow_tpu.controllers.runtime import Manager
            from odh_kubeflow_tpu.machinery import objects, store
            from odh_kubeflow_tpu.machinery.kubelet import FakeCluster
            from odh_kubeflow_tpu.scheduling import register_scheduling, scheduler
            from odh_kubeflow_tpu.scheduling import workload
            from odh_kubeflow_tpu.utils.prometheus import Registry
            from odh_kubeflow_tpu.web.jwa import JupyterWebApp

            self.resource = "google.com/tpu"
        self.port, self.apis, self.objects, self.store = port, apis, objects, store
        self.nb_mod, self.workload, self.culler_mod = nb_mod, workload, culler_mod
        self.JupyterWebApp = JupyterWebApp
        self.component = scheduler.COMPONENT
        api = self.api = store.APIServer()
        apis.register_crds(api)
        register_scheduling(api)
        self.cluster = FakeCluster(api)
        self.mgr = Manager(api)
        self.registry = Registry()
        self.culler = (
            culler_mod.Culler(
                api,
                culler_mod.CullerConfig(cull_idle_seconds=3600.0, idleness_check_seconds=0.0),
                base_url_fn=lambda nb: "http://127.0.0.1:9/unreachable",
            )
            if culling else None
        )
        nb_mod.NotebookController(
            api,
            nb_mod.NotebookControllerConfig(enable_queueing=True, enable_culling=culling),
            registry=self.registry, culler=self.culler,
        ).register(self.mgr)
        self.scheduler = scheduler.SliceScheduler(api, registry=self.registry)
        self.scheduler.register(self.mgr)
        for name, value in (("tpu-interactive", 1000), ("tpu-batch", -100)):
            api.create({"apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
                        "metadata": {"name": name}, "value": value, "globalDefault": False})
        if quota is not None:
            api.create({"apiVersion": "v1", "kind": "ResourceQuota",
                        "metadata": {"name": "kf-resource-quota", "namespace": NS},
                        "spec": {"hard": {f"requests.{self.resource}": str(quota)}}})

    # -- the cluster, in either package's terms -------------------------------

    def node_labels(self, pool: str, flavor) -> dict:
        if self.port:
            gpu, _, per_node = FLAVORS[flavor]
            return {"cloud.google.com/gke-accelerator": gpu,
                    "cloud.google.com/gke-accelerator-count": str(per_node),
                    "cloud.google.com/gke-nodepool": pool}
        return {"cloud.google.com/gke-tpu-accelerator": flavor[0],
                "cloud.google.com/gke-tpu-topology": flavor[1],
                "cloud.google.com/gke-nodepool": pool}

    def add_pool(self, name: str, flavor, nodes: int):
        if self.port:
            gpu, _, per_node = FLAVORS[flavor]
            return self.cluster.add_gpu_node_pool(name, gpu, num_nodes=nodes,
                                                  gpus_per_node=per_node)
        return self.cluster.add_tpu_node_pool(name, flavor[0], flavor[1], num_hosts=nodes,
                                              chips_per_host=4)

    def add_node(self, name: str, pool: str, flavor):
        self.cluster.add_node(name, labels=self.node_labels(pool, flavor),
                              extra_capacity={self.resource: "4"})

    def notebook(self, name, flavor=(V5E, "2x2"), priority_class=None, ns=NS) -> dict:
        if self.port:
            gpu, count, _ = FLAVORS[flavor]
            ann = {self.apis.GPU_ACCELERATOR_ANNOTATION: gpu,
                   self.apis.GPU_COUNT_ANNOTATION: str(count)}
        else:
            ann = {self.apis.TPU_ACCELERATOR_ANNOTATION: flavor[0],
                   self.apis.TPU_TOPOLOGY_ANNOTATION: flavor[1]}
        if priority_class:
            ann["notebooks.kubeflow.org/priority-class"] = priority_class
        return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
                "metadata": {"name": name, "namespace": ns, "annotations": ann},
                "spec": {"template": {"spec": {"containers": [
                    {"name": name, "image": "jax:latest"}]}}}}

    def create(self, *args, **kw):
        return self.api.create(self.notebook(*args, **kw))

    def foreign_pod(self, name: str, node=None, selector=None) -> dict:
        spec = {"containers": [{"name": "c", "resources": {"limits": {self.resource: "4"}}}]}
        if node:
            spec["nodeName"] = node
        if selector:
            spec["nodeSelector"] = selector
        return self.api.create({"apiVersion": "v1", "kind": "Pod",
                                "metadata": {"name": name, "namespace": NS}, "spec": spec})

    def quiesce(self, rounds=3):
        for _ in range(rounds):
            self.cluster.step()
            self.mgr.drain()

    def state(self, name, ns=NS) -> str:
        return self.api.get("Workload", name, ns).get("status", {}).get("state", "")

    def bound(self, name, ns=NS) -> list:
        return [
            p for p in self.api.list("Pod", namespace=ns,
                                     label_selector={"matchLabels": {
                                         "scheduling.kubeflow.org/workload": name}})
            if p.get("spec", {}).get("nodeName")
            and p.get("status", {}).get("phase") not in ("Succeeded", "Failed")
        ]

    # -- what is compared ------------------------------------------------------

    def observe(self) -> dict:
        """Every Workload's spec and status, every gang pod's node and
        phase, and the scheduler's events."""
        workloads = {
            f"{w['metadata']['namespace']}/{w['metadata']['name']}":
                {"spec": w["spec"], "status": w.get("status", {})}
            for w in self.api.list("Workload")
        }
        pods = sorted(
            (p["metadata"]["namespace"], p["metadata"]["name"],
             p.get("spec", {}).get("nodeName", ""), p.get("status", {}).get("phase", ""))
            for p in self.api.list("Pod")
        )
        events = sorted(
            (e["metadata"]["namespace"],
             f"{e['involvedObject']['kind']}/{e['involvedObject']['name']}",
             e["reason"], e["type"], e["message"], e.get("count", 1))
            for e in self.api.list("Event")
            if e.get("source", {}).get("component") == self.component
        )
        return scrub({"workloads": workloads, "pods": pods, "events": events})

    def stop(self):
        self.mgr.stop()


_OBSERVE = object()


def both(scenario, **env_kw):
    """Run ``scenario(env, log)`` on JAX's platform and the port's;
    ``log(key, value)`` records a value, ``log(key)`` the platform's
    ``observe()``. Asserts the port's log
    equals JAX's carried across, and returns the port's."""
    logs = []
    for port in (False, True):
        env, log = Env(port, **env_kw), {}

        def record(key, value=_OBSERVE, env=env, log=log):
            log[key] = scrub(env.observe() if value is _OBSERVE else value)

        try:
            scenario(env, record)
        finally:
            env.stop()
        logs.append(log)
    want, got = to_port(logs[0]), logs[1]
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == want[key], key
    return got


def events_of(obs, name, reason=None):
    return [e for e in obs["events"] if e[1].endswith(f"/{name}")
            and (reason is None or e[2] == reason)]


# ---------------------------------------------------------------------------
# workload derivation


def test_workload_derived_from_statefulset_shape():
    def scenario(env, log):
        if env.port:
            make_req = env.nb_mod.gpu_request_of
        else:
            make_req = env.nb_mod.tpu_request_of
        ctrl = env.nb_mod.NotebookController(
            env.api, env.nb_mod.NotebookControllerConfig(enable_queueing=True),
            registry=type(env.registry)())
        nb = env.notebook("big", flavor=(V5P, "2x2x2"))
        sts = ctrl.generate_statefulset(nb, make_req(nb))
        log("spec", {"spec": env.workload.workload_from_statefulset(
            sts, priority=7, priority_class="x")["spec"]})
        nb["metadata"]["annotations"]["kubeflow-resource-stopped"] = "t"
        log("stopped", env.workload.workload_from_statefulset(
            ctrl.generate_statefulset(nb, make_req(nb))))
        plain = {"kind": "StatefulSet", "metadata": {"name": "p", "namespace": "n"},
                 "spec": {"replicas": 1, "template": {"spec": {"containers": []}}}}
        log("plain", env.workload.workload_from_statefulset(plain))

    got = both(scenario)
    assert got["spec"]["spec"] == {
        "nodes": 2, "gpusPerNode": 4, "gpus": 8, "acceleratorType": "nvidia-l4",
        "acceleratorCount": "4", "priority": 7, "priorityClassName": "x", "queue": NS}
    assert got["stopped"] is None and got["plain"] is None


# ---------------------------------------------------------------------------
# gang admission


def test_gang_admission_is_all_or_nothing():
    """A 2-node gang with one node of capacity binds NOTHING; adding the
    second node admits and binds the whole gang at once."""
    flavor = (V5P, "2x2x2")

    def scenario(env, log):
        env.add_pool("pool", flavor, 1)
        env.create("big", flavor=flavor)
        env.quiesce()
        log("one_node")
        env.add_node("pool-1", "pool", flavor)
        env.quiesce()
        log("two_nodes")

    got = both(scenario)
    wl = got["one_node"]["workloads"][f"{NS}/big"]
    assert wl["status"]["state"] == "Pending"
    assert [p[3] for p in got["one_node"]["pods"]] == ["Pending", "Pending"]
    assert all(p[2] == "" for p in got["one_node"]["pods"])
    wl = got["two_nodes"]["workloads"][f"{NS}/big"]
    assert wl["status"]["state"] == "Admitted"
    nodes = wl["status"]["assignment"]["nodes"]
    # ordinal i → assignment node i, all Running
    assert [(p[1], p[2], p[3]) for p in got["two_nodes"]["pods"]] == [
        ("big-0", nodes[0], "Running"), ("big-1", nodes[1], "Running")]


def test_fit_rejects_a_gang_split_across_pools():
    """One free node in each of two 2-node pools is not a fit for a
    2-node gang."""
    flavor = (V5P, "2x2x2")

    def scenario(env, log):
        env.add_pool("pa", flavor, 2)
        env.add_pool("pb", flavor, 2)
        env.foreign_pod("squat-0", node="pa-0")
        env.foreign_pod("squat-1", node="pb-0")
        env.create("big", flavor=flavor)
        env.quiesce()
        log("split")

    status = both(scenario)["split"]["workloads"][f"{NS}/big"]["status"]
    assert (status["state"], status["reason"]) == ("Pending", "SliceBusy")


# ---------------------------------------------------------------------------
# quota pools


def test_quota_queueing_and_release():
    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.add_pool("b", (V5E, "2x2"), 1)
        env.create("first")
        env.quiesce()
        env.create("second")
        env.quiesce()
        log("queued")
        env.api.delete("Notebook", "first", NS)
        env.quiesce()
        log("released")

    got = both(scenario, quota=4)
    status = got["queued"]["workloads"][f"{NS}/second"]["status"]
    assert (status["state"], status["reason"], status["position"]) == (
        "Pending", "QuotaExhausted", 1)
    assert "requests.nvidia.com/gpu used 4, hard 4" in status["message"]
    assert {e[2] for e in events_of(got["queued"], "second")} >= {"Queued", "FailedScheduling"}
    assert got["released"]["workloads"][f"{NS}/second"]["status"]["state"] == "Admitted"


def test_stop_annotation_releases_admission():
    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.create("first")
        env.create("second")
        env.quiesce()
        log("both")
        env.api.patch("Notebook", "first", {"metadata": {"annotations": {
            "kubeflow-resource-stopped": "2026-08-03T00:00:00Z"}}}, NS)
        env.quiesce()
        log("stopped")

    got = both(scenario, quota=4)
    states = {k: w["status"]["state"] for k, w in got["both"]["workloads"].items()}
    assert states == {f"{NS}/first": "Admitted", f"{NS}/second": "Pending"}
    assert list(got["stopped"]["workloads"]) == [f"{NS}/second"]
    assert got["stopped"]["workloads"][f"{NS}/second"]["status"]["state"] == "Admitted"


# ---------------------------------------------------------------------------
# priority & preemption


def test_priority_preemption_evicts_lowest_newest_first():
    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.create("batch", priority_class="tpu-batch")
        env.quiesce()
        env.create("urgent", priority_class="tpu-interactive")
        env.quiesce()
        log("preempted")
        env.api.delete("Notebook", "urgent", NS)
        env.quiesce()
        log("readmitted")

    got = both(scenario)
    wls = got["preempted"]["workloads"]
    assert wls[f"{NS}/urgent"]["status"]["state"] == "Admitted"
    assert wls[f"{NS}/batch"]["status"]["state"] == "Pending"
    assert events_of(got["preempted"], "batch", "Preempted")
    assert got["readmitted"]["workloads"][f"{NS}/batch"]["status"]["state"] == "Admitted"


def test_preemption_evicts_only_victims_that_unblock_admission():
    def scenario(env, log):
        for pool in ("a", "b", "c"):
            env.add_pool(pool, (V5E, "2x2"), 1)
        env.create("low")
        env.create("batch", priority_class="tpu-batch", ns="team-b")
        env.quiesce()
        env.create("urgent", priority_class="tpu-interactive")
        env.quiesce()
        log("after")

    wls = both(scenario, quota=4)["after"]["workloads"]
    assert wls[f"{NS}/urgent"]["status"]["state"] == "Admitted"
    assert wls[f"{NS}/low"]["status"]["state"] == "Pending"
    assert wls["team-b/batch"]["status"]["state"] == "Admitted"


def test_equal_priority_never_preempts():
    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.create("one")
        env.quiesce()
        env.create("two")
        env.quiesce()
        log("after")

    wls = both(scenario)["after"]["workloads"]
    assert (wls[f"{NS}/one"]["status"]["state"], wls[f"{NS}/two"]["status"]["state"]) == (
        "Admitted", "Pending")


def test_no_queue_jumping_within_contended_pool():
    flavor = (V5P, "2x2x2")

    def scenario(env, log):
        env.add_pool("a", flavor, 2)
        env.create("holder", flavor=flavor, priority_class="tpu-interactive")
        env.quiesce()
        env.create("starved", flavor=flavor, priority_class="tpu-interactive")
        env.quiesce()
        env.create("jumper", flavor=flavor, priority_class="tpu-batch")
        env.quiesce()
        log("queued")
        env.api.delete("Notebook", "holder", NS)
        env.quiesce()
        log("released")

    got = both(scenario)
    starved = got["queued"]["workloads"][f"{NS}/starved"]["status"]
    jumper = got["queued"]["workloads"][f"{NS}/jumper"]["status"]
    assert (starved["state"], jumper["state"], jumper["reason"]) == (
        "Pending", "Pending", "Blocked")
    assert starved["position"] < jumper["position"]
    wls = got["released"]["workloads"]
    assert (wls[f"{NS}/starved"]["status"]["state"],
            wls[f"{NS}/jumper"]["status"]["state"]) == ("Admitted", "Pending")


# ---------------------------------------------------------------------------
# gang atomicity under node loss, foreign pods


def test_node_loss_evicts_and_requeues_whole_gang():
    flavor = (V5P, "2x2x2")

    def scenario(env, log):
        env.add_pool("pool", flavor, 2)
        env.create("big", flavor=flavor)
        env.quiesce()
        log("admitted")
        env.cluster.preempt_node("pool-0")
        env.mgr.drain()
        log("lost")
        env.quiesce()
        log("lost_quiesced")
        env.add_node("pool-0", "pool", flavor)
        env.quiesce()
        log("restored")

    got = both(scenario)
    assert len([p for p in got["admitted"]["pods"] if p[3] == "Running"]) == 2
    assert got["lost"]["workloads"][f"{NS}/big"]["status"]["state"] == "Pending"
    for key in ("lost", "lost_quiesced"):  # the survivor evicted too
        assert not [p for p in got[key]["pods"] if p[2] and p[3] == "Running"]
    assert ("Notebook/big" in {e[1] for e in events_of(got["lost"], "big", "NodeLost")})
    assert got["restored"]["workloads"][f"{NS}/big"]["status"]["state"] == "Admitted"
    assert [p[3] for p in got["restored"]["pods"]] == ["Running", "Running"]


def test_foreign_pod_on_reserved_capacity_requeues_the_gang():
    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.create("nb")
        env.mgr.drain()  # admitted; gang pods not yet materialised
        log("admitted")
        env.foreign_pod("squatter", node="a-0")
        env.quiesce()
        log("squatted")
        env.api.delete("Pod", "squatter", NS)
        env.quiesce()
        log("readmitted")

    got = both(scenario)
    assert got["admitted"]["workloads"][f"{NS}/nb"]["status"]["state"] == "Admitted"
    assert got["squatted"]["workloads"][f"{NS}/nb"]["status"]["state"] == "Pending"
    assert got["readmitted"]["workloads"][f"{NS}/nb"]["status"]["state"] == "Admitted"
    assert [p[1:] for p in got["readmitted"]["pods"]] == [("nb-0", "a-0", "Running")]


def test_admitted_reservation_counts_against_pod_level_quota():
    """A legacy Deployment pod asking for the whole quota while the
    admitted gang's pods are still gated is refused by the ResourceQuota
    backstop."""
    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.add_pool("b", (V5E, "2x2"), 1)
        env.create("nb")
        env.mgr.drain()
        env.api.create({
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "legacy", "namespace": NS},
            "spec": {"replicas": 1, "template": {
                "metadata": {"labels": {"app": "legacy"}},
                "spec": {"containers": [{"name": "c", "resources": {
                    "limits": {env.resource: "4"}}}]}}}})
        env.quiesce()
        log("after")
        log("refused", sorted(e["reason"] for e in env.api.list("Event", namespace=NS)
                              if "exceeded quota" in e.get("message", "")))
        quota = env.api.get("ResourceQuota", "kf-resource-quota", NS)
        log("used", quota["status"]["used"][f"requests.{env.resource}"])

    got = both(scenario, quota=4)
    assert [p[1] for p in got["after"]["pods"]] == ["nb-0"]
    assert got["refused"] and set(got["refused"]) == {"FailedCreate"}
    assert got["used"] == "4"


def test_unbound_foreign_pod_still_counts_against_admission_quota():
    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.foreign_pod("stuck", selector={"no-such-label": "x"})
        env.create("nb")
        env.quiesce()
        log("blocked")
        env.api.delete("Pod", "stuck", NS)
        env.quiesce()
        log("freed")

    got = both(scenario, quota=4)
    status = got["blocked"]["workloads"][f"{NS}/nb"]["status"]
    assert (status["state"], status["reason"]) == ("Pending", "QuotaExhausted")
    assert got["freed"]["workloads"][f"{NS}/nb"]["status"]["state"] == "Admitted"


def test_unschedulable_reason_transition_emits_new_event():
    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.create("holder")
        env.quiesce()
        env.create("waiter")
        env.quiesce()
        log("busy")
        env.cluster.preempt_node("a-0")
        env.quiesce()
        log("gone")

    got = both(scenario)
    assert any("node pool with 1 free node(s)" in e[4]
               for e in events_of(got["busy"], "waiter", "FailedScheduling"))
    assert any("no node pool with accelerator" in e[4]
               for e in events_of(got["gone"], "holder", "FailedScheduling"))
    assert got["gone"]["workloads"][f"{NS}/holder"]["status"]["reason"] == "NoMatchingSlice"


# ---------------------------------------------------------------------------
# quota status mirror + the JWA's queue surface


def test_quota_status_used_mirrored_and_surfaced():
    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.create("nb")
        env.quiesce()
        quota = env.api.get("ResourceQuota", "kf-resource-quota", NS)
        log("status", {"used": quota["status"]["used"], "hard": quota["status"]["hard"]})
        jwa = env.JupyterWebApp(env.api)
        row = jwa.gpu_quota if env.port else jwa.tpu_quota
        log("jwa", [row(NS), row("elsewhere")])

    got = both(scenario, quota=8)
    assert got["jwa"] == [{"resource": "requests.nvidia.com/gpu", "hard": "8", "used": "4"},
                          None]


def test_jwa_surfaces_queue_position_and_reason():
    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.create("first")
        env.create("second")
        env.quiesce()
        jwa = env.JupyterWebApp(env.api)
        for name in ("first", "second"):
            nb = env.api.get("Notebook", name, NS)
            row = jwa.notebook_row(nb)
            log(name, {"status": row["status"], "workload": jwa._workload_row(nb)})

    got = both(scenario, quota=4)
    second = got["second"]
    assert second["status"]["phase"] == "waiting"
    assert second["status"]["queuePosition"] == 1
    assert "quota exhausted" in second["status"]["message"]
    assert (second["workload"]["state"], second["workload"]["reason"]) == (
        "Pending", "QuotaExhausted")
    assert got["first"]["status"]["phase"] == "ready"
    assert got["first"]["workload"]["assignment"]["nodes"] == ["a-0"]


def test_failedscheduling_reasons_are_specific():
    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.create("first")
        env.quiesce()
        env.create("overquota")
        env.create("notopo", flavor=(V5P, "4x4x4"), ns="team-b")
        env.quiesce()
        # a 64-chip v5p slice is 16 hosts, 64 H100s are 8 nodes: the
        # statuses and events carry across, the pod counts do not
        obs = env.observe()
        log("after", {"statuses": {k: w["status"] for k, w in obs["workloads"].items()},
                      "events": obs["events"]})

    got = both(scenario, quota=4)["after"]
    over = events_of(got, "overquota", "FailedScheduling")
    assert over and "quota exhausted" in over[0][4] and "hard 4" in over[0][4]
    missing = [e for e in got["events"] if e[0] == "team-b" and e[2] == "FailedScheduling"]
    assert missing and "no node pool with accelerator nvidia-h100-80gb" in missing[0][4]


# ---------------------------------------------------------------------------
# the culler's queue-wait guard


def test_queue_wait_does_not_accrue_idleness():
    def scenario(env, log):
        clock = {"now": 1_000_000.0}
        env.culler.now = lambda: clock["now"]
        env.add_pool("a", (V5E, "2x2"), 1)
        env.create("nb")
        env.quiesce()
        env.cluster.preempt_node("a-0")
        env.quiesce()
        log("queued")
        for _ in range(4):  # queue wait 2× the cull threshold
            clock["now"] += 1800.0
            env.mgr.drain()
            env.culler.reconcile_notebook(env.api.get("Notebook", "nb", NS))
        ann = env.api.get("Notebook", "nb", NS)["metadata"]["annotations"]
        last = env.culler_mod._parse_time(ann["notebooks.kubeflow.org/last-activity"])
        log("waited", {"stopped": "kubeflow-resource-stopped" in ann,
                       "idle_below_threshold": clock["now"] - last < 3600.0})
        env.add_node("a-0", "a", (V5E, "2x2"))
        env.quiesce()
        clock["now"] += 60.0
        env.culler.reconcile_notebook(env.api.get("Notebook", "nb", NS))
        ann = env.api.get("Notebook", "nb", NS)["metadata"]["annotations"]
        log("restarted", {"stopped": "kubeflow-resource-stopped" in ann})
        log("after")

    got = both(scenario, culling=True)
    assert got["queued"]["workloads"][f"{NS}/nb"]["status"]["state"] == "Pending"
    assert got["waited"] == {"stopped": False, "idle_below_threshold": True}
    assert got["restarted"] == {"stopped": False}
    assert got["after"]["workloads"][f"{NS}/nb"]["status"]["state"] == "Admitted"


# ---------------------------------------------------------------------------
# backoff + metrics


def test_unschedulable_requeues_with_growing_backoff():
    def scenario(env, log):
        env.create("starved")  # no GPU nodes at all
        env.mgr.drain()
        log("delays", [env.scheduler.run_cycle().requeue_after for _ in range(4)])
        env.add_pool("a", (V5E, "2x2"), 1)
        env.quiesce()
        log("admitted", [env.state("starved"), env.scheduler.run_cycle().requeue_after])

    got = both(scenario)
    delays = got["delays"]
    assert all(d is not None for d in delays)
    assert delays == sorted(delays) and delays[-1] > delays[0]
    assert got["admitted"] == ["Admitted", None]


def test_scheduler_metrics_match_jax():
    from odh_kubeflow_tpu.utils.prometheus import lint_metric_names

    def scenario(env, log):
        env.add_pool("a", (V5E, "2x2"), 1)
        env.create("first")
        env.create("second")
        env.quiesce()
        if env.port:
            assert lint_metric_names(env.registry) == []
        lines = [x for x in env.registry.exposition().splitlines()
                 if x.startswith(("pending_workloads", "admission_attempts_total",
                                  "admission_wait_seconds_count", "workload_preemptions"))]
        # a failed attempt counts once a cycle, and JAX's simulator wakes
        # the cycle more often (its running pods change on every pass):
        # the retries' count is each package's own
        retry = 'admission_attempts_total{result="quota_exhausted"}'
        log("metrics", sorted(x for x in lines if not x.startswith(retry)))
        log("retried", any(x.startswith(retry) for x in lines))

    got = both(scenario, quota=4)
    lines = got["metrics"]
    assert 'pending_workloads{queue="team-a"} 1' in lines
    assert 'admission_attempts_total{result="admitted"} 1' in lines
    assert got["retried"]
    assert "admission_wait_seconds_count 1" in lines


def test_zone_drain_and_storm_match_jax():
    """The zone bookkeeping: spread across zones, on-demand before spot,
    an operator drain evicting and re-placing outside the zone, and a
    node-loss storm escalating into a drain."""
    flavor = (V5E, "2x2")

    def scenario(env, log):
        def pool(name, zone, spot=False):
            if env.port:
                env.cluster.add_gpu_node_pool(name, "nvidia-l4", num_nodes=2, gpus_per_node=4,
                                              zone=zone, spot=spot)
            else:
                env.cluster.add_tpu_node_pool(name, V5E, "2x2", num_hosts=2, chips_per_host=4,
                                              zone=zone, spot=spot)
        pool("za", "zone-a")
        pool("zb", "zone-b")
        pool("zc", "zone-c", spot=True)
        for i in range(4):
            env.create(f"nb{i}", flavor=flavor)
        env.quiesce()
        log("spread")
        env.scheduler.drain_zone("zone-a")
        env.quiesce()
        log("drained", [env.scheduler.drained_zones(), env.observe()])
        env.scheduler.undrain_zone("zone-a")
        env.cluster.kill_zone("zone-b")
        env.mgr.drain()
        env.quiesce()
        log("storm", [env.scheduler.drained_zones(), env.observe()])

    got = both(scenario)
    zones = [w["status"]["assignment"].get("zone")
             for w in got["spread"]["workloads"].values()]
    # the least-loaded zone first, on-demand before spot at equal load
    assert sorted(zones) == ["zone-a", "zone-a", "zone-b", "zone-c"]
    drained, obs = got["drained"]
    assert drained == {"zone-a": "operator"}
    assert all(w["status"]["assignment"]["zone"] != "zone-a"
               for w in obs["workloads"].values() if w["status"]["state"] == "Admitted")
    assert got["storm"][0] == {"zone-b": "node-storm"}


# ---------------------------------------------------------------------------
# the randomized sequences (JAX's property test), decision by decision


def _restore_lost_nodes(env, want_nodes):
    existing = {n["metadata"]["name"] for n in env.api.list("Node")}
    for name, pool in want_nodes.items():
        if name not in existing:
            env.add_node(name, pool, (V5P, "2x2x2"))


def _random_sequence(seed: int, steps: int):
    def scenario(env, log):
        rng = random.Random(seed)
        flavor = (V5P, "2x2x2")
        nodes = {}
        for pool in ("pa", "pb", "pc"):
            for node in env.add_pool(pool, flavor, 2):
                nodes[node["metadata"]["name"]] = pool
        classes = [None, "tpu-batch", "tpu-interactive"]
        live, counter = set(), 0
        for step in range(steps):
            op = rng.choice(["create", "create", "delete", "preempt", "restore"])
            if op == "create" and len(live) < 6:
                counter += 1
                env.create(f"nb{counter}", flavor=flavor, priority_class=rng.choice(classes))
                live.add(f"nb{counter}")
            elif op == "delete" and live:
                name = rng.choice(sorted(live))
                live.discard(name)
                env.api.delete("Notebook", name, NS)
            elif op == "preempt":
                existing = sorted(n for n in nodes if n in {
                    x["metadata"]["name"] for x in env.api.list("Node")})
                if existing:
                    env.cluster.preempt_node(rng.choice(existing))
            elif op == "restore":
                _restore_lost_nodes(env, nodes)
            env.quiesce()
            log(f"{step}:{op}")
        _restore_lost_nodes(env, nodes)
        env.quiesce(rounds=4)
        log("final")
    return scenario


@pytest.mark.parametrize("seed", [20260803, 7, 11, 12, 13, 14])
def test_random_admit_preempt_node_loss_sequences_decide_as_jax(seed):
    """Random create / delete / preempt / restore sequences: the same
    decisions after every step, and JAX's two invariants on the port's
    side (no partially bound gang; no pending workload outranks an
    admitted one in the shared pool), with the quota never exceeded."""
    got = both(_random_sequence(seed, 30), quota=16)
    for key, obs in got.items():
        wls = obs["workloads"]
        bound = {}
        for ns, pod, node, phase in obs["pods"]:
            if node and phase not in ("Succeeded", "Failed"):
                bound[re.sub(r"-\d+$", "", pod)] = bound.get(re.sub(r"-\d+$", "", pod), 0) + 1
        admitted = [w for w in wls.values() if w["status"].get("state") == "Admitted"]
        pending = [w for w in wls.values() if w["status"].get("state") != "Admitted"]
        for name, w in wls.items():
            n = bound.get(name.split("/")[1], 0)
            assert n in (0, w["spec"]["nodes"]), (key, name, n)
            if w["status"].get("state") != "Admitted":
                assert n == 0, (key, name)
        for p in pending:
            for a in admitted:
                assert a["spec"]["priority"] >= p["spec"]["priority"], key
        assert sum(w["spec"]["gpus"] for w in admitted) <= 16
