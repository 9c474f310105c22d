"""Node / scheduler / kubelet simulation for tests and local dev (the
port's copy of the JAX package's ``machinery/kubelet.py``, on GPU node
pools).

The simulator materialises Pods from StatefulSets/Deployments, schedules
them onto fake nodes honoring GPU nodeSelectors and ``nvidia.com/gpu``
capacity, enforces the namespace's GPU ResourceQuota at pod creation,
and drives pod phases — which is what lets the culler, status
mirroring, and gang scheduling be tested end-to-end with no cluster.
The sessions subsystem's container memory (``SimSessionRuntime``) and
the warm-start subsystem's simulated image pulls are JAX's. Left out of
the copy (ROADMAP.md): simulated duty-cycle waveforms and the tracing
spans of gang binds and container starts.

Deterministic by design: ``step()`` runs one reconcile pass; call it
after mutations instead of racing a background thread.
"""

from __future__ import annotations

import itertools
import os
import re
import time
from typing import Any, Optional

from odh_kubeflow_tpu_torch.apis import (
    GPU_ACCEL_NODE_LABEL,
    GPU_COUNT_NODE_LABEL,
    GPU_RESOURCE,
    pod_gpus,
)
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import APIServer, AlreadyExists, NotFound
from odh_kubeflow_tpu_torch.scheduling import (
    ADMISSION_GATE_ANNOTATION,
    WORKLOAD_LABEL,
)

Obj = dict[str, Any]

ZONE_LABEL = "topology.kubernetes.io/zone"
SPOT_LABEL = "cloud.google.com/gke-spot"
ORDINAL_LABEL = "apps.kubernetes.io/pod-index"


_FIELD_REF = re.compile(r"metadata\.(labels|annotations)\['([^']+)'\]")


def container_env(pod: Obj) -> dict[str, str]:
    """The environment a kubelet gives the first container of ``pod``:
    each ``env`` entry's ``value``, or its ``valueFrom.fieldRef`` read
    off the pod (``metadata.name``/``namespace``/``uid``, a label or
    annotation by key, ``spec.nodeName``/``serviceAccountName``,
    ``status.podIP``/``hostIP``). Other sources (ConfigMap and Secret
    keys, resource fields) raise: nothing the platform injects uses
    them."""
    container = obj_util.get_path(pod, "spec", "containers")[0]
    env: dict[str, str] = {}
    for entry in container.get("env") or []:
        name = entry["name"]
        if "valueFrom" not in entry:
            env[name] = str(entry.get("value", ""))
            continue
        path = obj_util.get_path(entry, "valueFrom", "fieldRef", "fieldPath")
        if path is None:
            raise ValueError(f"env {name}: only fieldRef sources are resolved")
        m = _FIELD_REF.fullmatch(path)
        if m:
            value = (obj_util.meta(pod).get(m.group(1)) or {}).get(m.group(2), "")
        else:
            value = obj_util.get_path(pod, *path.split("."), default="")
        env[name] = str(value or "")
    return env


def _is_gated_unbound(pod: Obj) -> bool:
    """An admission-gated pod that has not been gang-bound yet holds no
    GPUs: quota charges at workload admission (the reservation), and
    the pod-level backstop only counts pods that actually occupy a
    node."""
    return (
        ADMISSION_GATE_ANNOTATION in obj_util.annotations_of(pod)
        and not obj_util.get_path(pod, "spec", "nodeName")
    )


class SimSessionRuntime:
    """The kubelet sim's checkpoint/restore container hooks (the
    sessions/ subsystem's runtime interface). "Container memory" —
    kernel state — is keyed by pod UID and lives exactly as long as the
    pod does: a deleted or Failed pod loses its unsnapshotted state,
    which is precisely why checkpoint-then-preempt beats a hard kill.

    Tests (and the sim's notebook "kernels") write state with
    ``write_state``; the SessionManager's suspend path calls
    ``snapshot`` while the pod is still Running, and its resume path
    calls ``restore`` into the fresh pod."""

    def __init__(self) -> None:
        self._memory: dict[str, Obj] = {}  # pod uid → kernel state

    @staticmethod
    def _uid(pod: Obj) -> str:
        return obj_util.meta(pod).get("uid", "")

    def write_state(self, pod: Obj, state: Obj) -> None:
        self._memory[self._uid(pod)] = obj_util.deepcopy(state)

    def read_state(self, pod: Obj) -> Optional[Obj]:
        state = self._memory.get(self._uid(pod))
        return obj_util.deepcopy(state) if state is not None else None

    # -- the hooks the SessionManager drives --------------------------------

    def snapshot(self, notebook: Obj, pod: Obj) -> Optional[Obj]:
        # a live container that never wrote memory has a valid, EMPTY
        # kernel state — None is reserved for "hook unreachable" (the
        # manager retries that inside the suspend grace window)
        return obj_util.deepcopy(self._memory.get(self._uid(pod), {}))

    def restore(self, notebook: Obj, pod: Obj, state: Obj) -> bool:
        self._memory[self._uid(pod)] = obj_util.deepcopy(state or {})
        return True

    # -- lifecycle ----------------------------------------------------------

    def drop(self, pod: Obj) -> None:
        self._memory.pop(self._uid(pod), None)

    def prune(self, live_uids: set[str]) -> None:
        for uid in list(self._memory):
            if uid not in live_uids:
                del self._memory[uid]


class FakeCluster:
    def __init__(self, api: APIServer):
        self.api = api
        self._ip_counter = itertools.count(2)
        # checkpoint/restore container hooks (sessions/ subsystem)
        self.session_runtime = SimSessionRuntime()
        # per-step() scheduler ledger: used GPUs by node, built once per
        # pass and updated as pods bind (None outside a step)
        self._sched_used: Optional[dict[str, float]] = None
        # simulated image pulls (warmup/ subsystem): a node that has
        # never run an image keeps the pod Pending for
        # SIM_IMAGE_PULL_SECONDS, then remembers it — warm-pool
        # standbys pre-pull, so claimed sessions skip the wait. 0
        # (default) preserves the instant-start behavior.
        self.image_pull_seconds = float(
            os.environ.get("SIM_IMAGE_PULL_SECONDS", "0") or 0
        )
        self._node_images: dict[str, set[str]] = {}
        self._pull_started: dict[str, float] = {}

    # -- session-state helpers (tests drive these as "the kernel") ----------

    def set_session_state(self, namespace: str, notebook: str, state: Obj) -> None:
        """Write kernel state into notebook's pod-0 container memory —
        what a user's running kernel does between our observations."""
        pod = self.api.get("Pod", f"{notebook}-0", namespace)
        self.session_runtime.write_state(pod, state)

    def get_session_state(self, namespace: str, notebook: str) -> Optional[Obj]:
        pod = self.api.get("Pod", f"{notebook}-0", namespace)
        return self.session_runtime.read_state(pod)

    # -- nodes --------------------------------------------------------------

    def add_node(
        self,
        name: str,
        cpu: str = "16",
        memory: str = "64Gi",
        labels: Optional[dict[str, str]] = None,
        extra_capacity: Optional[dict[str, str]] = None,
    ) -> Obj:
        capacity = {"cpu": cpu, "memory": memory, "pods": "110"}
        capacity.update(extra_capacity or {})
        node = {
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": {"name": name, "labels": labels or {}},
            "status": {
                "capacity": capacity,
                "allocatable": dict(capacity),
                "conditions": [{"type": "Ready", "status": "True"}],
            },
        }
        return self.api.create(node)

    def add_gpu_node_pool(
        self,
        name: str,
        accelerator_type: str,
        num_nodes: int = 1,
        gpus_per_node: int = 8,
        zone: str = "",
        spot: bool = False,
    ) -> list[Obj]:
        """One Node per machine of a GPU node pool, labelled the way GKE
        labels GPU node pools (the accelerator type and the pool name)
        plus the GPUs each node holds, which the notebook controller's
        node selector names (the counterpart of ``add_tpu_node_pool``).
        ``zone`` stamps the well-known ``topology.kubernetes.io/zone``
        failure-domain label and ``spot`` the GKE spot capacity
        class."""
        labels = {
            GPU_ACCEL_NODE_LABEL: accelerator_type,
            GPU_COUNT_NODE_LABEL: str(gpus_per_node),
            "cloud.google.com/gke-nodepool": name,
        }
        if zone:
            labels[ZONE_LABEL] = zone
        if spot:
            labels[SPOT_LABEL] = "true"
        nodes = []
        for i in range(num_nodes):
            nodes.append(
                self.add_node(
                    f"{name}-{i}",
                    labels=dict(labels),
                    extra_capacity={GPU_RESOURCE: str(gpus_per_node)},
                )
            )
        return nodes

    def kill_zone(self, zone: str) -> list[str]:
        """Take a whole failure domain down: every node labelled with
        ``zone`` is preempted (object deleted, bound pods Failed,
        container memory lost) in one storm — what a real zone outage
        looks like from the control plane. Returns the node names
        killed."""
        doomed = [
            obj_util.name_of(n)
            for n in self.api.list("Node")
            if obj_util.labels_of(n).get(ZONE_LABEL) == zone
        ]
        for name in doomed:
            self.preempt_node(name)
        return doomed

    def preempt_node(self, name: str) -> None:
        """Simulate GKE reclaiming a spot/preemptible GPU node: the Node
        object vanishes and every pod bound to it is marked Failed with
        reason Preempted (what the node controller reports for a lost
        node). The notebook controller's gang-health reconcile turns
        this into a SlicePreempted condition + atomic gang restart."""
        try:
            self.api.delete("Node", name, None)
        except NotFound:
            pass
        for pod in self.api.list("Pod"):
            if obj_util.get_path(pod, "spec", "nodeName") != name:
                continue
            if obj_util.get_path(pod, "status", "phase") in ("Succeeded", "Failed"):
                continue
            # container memory dies with the node — unsnapshotted
            # kernel state on a preempted node is gone
            self.session_runtime.drop(pod)
            pod.setdefault("status", {})
            pod["status"]["phase"] = "Failed"
            pod["status"]["reason"] = "Preempted"
            pod["status"]["message"] = f"Node {name} was preempted"
            pod["status"]["conditions"] = [
                {"type": "Ready", "status": "False", "reason": "Preempted"}
            ]
            self.api.update_status(pod)
            self.api.emit_event(
                pod,
                "Preempted",
                f"Node {name} was preempted; pod terminated",
                event_type="Warning",
                component="node-controller",
            )

    # -- scheduling ---------------------------------------------------------

    def _quota_denies(self, pod: Obj) -> Optional[str]:
        """ResourceQuota admission for the GPU resource: creating this
        pod must keep the namespace's summed ``nvidia.com/gpu`` limits
        within every quota's hard cap (the real admission controller's
        contract, scoped to the resource the platform quotas —
        ``controllers/profile.py`` writes ``requests.nvidia.com/gpu``)."""
        ns = obj_util.namespace_of(pod)
        req = self._pod_gpu_request(pod)
        if req <= 0:
            return None
        if _is_gated_unbound(pod):
            # gang-queued pods exist without holding GPUs; the gang
            # scheduler enforced the workload-level quota reservation
            # at admission time
            return None
        quotas = self.api.list("ResourceQuota", namespace=ns)
        if not quotas:
            return None
        # one namespace-wide sum per admission, shared by every quota —
        # not per quota (the O(N²) re-list pattern _sched_used exists
        # to avoid)
        used = self._gpus_used_in_namespace(ns)
        for quota in quotas:
            hard = obj_util.get_path(quota, "spec", "hard", default={}) or {}
            cap = hard.get(f"requests.{GPU_RESOURCE}", hard.get(GPU_RESOURCE))
            if cap is None:
                continue
            if used + req > obj_util.parse_quantity(cap):
                return (
                    f"exceeded quota: {obj_util.name_of(quota)}, "
                    f"requested: {GPU_RESOURCE}={int(req)}, "
                    f"used: {int(used)}, limited: {cap}"
                )
        return None

    def _pod_gpu_request(self, pod: Obj) -> float:
        return pod_gpus(pod)

    def _gpus_used_in_namespace(self, ns: str) -> float:
        """GPUs a namespace holds against its quota: non-gang active
        pods count per-pod; gang (workload-labelled) pods count through
        their Workload's ADMISSION instead — an admitted gang owns its
        whole reservation even while its pods are still gated, so a
        foreign pod can never slip into GPUs the scheduler promised
        away."""
        used = sum(
            self._pod_gpu_request(p)
            for p in self.api.list("Pod", namespace=ns)
            if obj_util.get_path(p, "status", "phase")
            not in ("Succeeded", "Failed")
            and WORKLOAD_LABEL not in obj_util.labels_of(p)
        )
        try:
            for wl in self.api.list("Workload", namespace=ns):
                if obj_util.get_path(wl, "status", "state") == "Admitted":
                    used += float(
                        obj_util.get_path(wl, "spec", "gpus", default=0) or 0
                    )
        except NotFound:
            pass  # scheduling subsystem not installed
        return used

    def _node_fits(
        self,
        node: Obj,
        pod: Obj,
        want_gpus: float,
        used_by_node: Optional[dict[str, float]],
    ) -> bool:
        selector = obj_util.get_path(pod, "spec", "nodeSelector", default={}) or {}
        node_labels = obj_util.labels_of(node)
        for k, v in selector.items():
            if node_labels.get(k) != v:
                return False
        if want_gpus:
            alloc = obj_util.parse_quantity(
                obj_util.get_path(
                    node, "status", "allocatable", GPU_RESOURCE, default=0
                )
            )
            used = (used_by_node or {}).get(obj_util.name_of(node), 0.0)
            if used + want_gpus > alloc:
                return False
        return True

    def _build_used_by_node(self) -> dict[str, float]:
        used: dict[str, float] = {}
        for other in self.api.list("Pod"):
            if obj_util.get_path(other, "status", "phase") == "Succeeded":
                continue
            name = obj_util.get_path(other, "spec", "nodeName")
            if name:
                used[name] = used.get(name, 0.0) + self._pod_gpu_request(other)
        return used

    def _schedule(self, pod: Obj) -> Optional[str]:
        # One pod list per step() (the real kube-scheduler keeps a
        # cache the same way), updated incrementally as this pass binds
        # pods — re-listing per pod was the loadtest's O(N²) hotspot
        # (every list deep-copies through the store). Outside a step
        # (direct calls in tests) the ledger is built on demand.
        want_gpus = self._pod_gpu_request(pod)
        used_by_node = self._sched_used
        if want_gpus and used_by_node is None:
            used_by_node = self._build_used_by_node()
        for node in self.api.list("Node"):
            if self._node_fits(node, pod, want_gpus, used_by_node):
                name = obj_util.name_of(node)
                if want_gpus and used_by_node is not None:
                    used_by_node[name] = used_by_node.get(name, 0.0) + want_gpus
                return name
        return None

    def _unschedulable_reason(self, pod: Obj) -> tuple[str, str]:
        """Human-readable why-not: selector mismatch (the accelerator or
        node shape is not in the cluster) is a different story from
        matching nodes that are simply full."""
        selector = obj_util.get_path(pod, "spec", "nodeSelector", default={}) or {}
        matching = [
            n
            for n in self.api.list("Node")
            if all(
                obj_util.labels_of(n).get(k) == v for k, v in selector.items()
            )
        ]
        if not matching:
            return (
                "Unschedulable",
                f"no node matches nodeSelector {selector or '{}'}",
            )
        want = self._pod_gpu_request(pod)
        return (
            "Unschedulable",
            f"insufficient {GPU_RESOURCE}: need {int(want)} GPU(s), no "
            f"matching node has enough free capacity",
        )

    # -- gang binding (slice scheduler integration) -------------------------

    def _mark_gated(self, pod: Obj, workload_name: str) -> None:
        """Real-cluster semantics for scheduling gates: the pod stays
        Pending with PodScheduled=False/SchedulingGated and no
        FailedScheduling event (it is not a scheduling failure — it is
        a queue)."""
        pod.setdefault("status", {})
        pod["status"]["phase"] = "Pending"
        pod["status"]["conditions"] = [
            {
                "type": "PodScheduled",
                "status": "False",
                "reason": "SchedulingGated",
                "message": (
                    f"waiting for gang admission of workload "
                    f"{workload_name}"
                ),
            }
        ]
        self.api.update_status(pod)

    def _bind_gang(self, pod: Obj, workload_name: str) -> bool:
        """True only when the whole gang is bound (this pod
        included): the full member set must exist, every assigned node
        must still exist with enough free GPUs, and only then do the
        nodeName writes happen — a half-alive gang is never
        observable."""
        ns = obj_util.namespace_of(pod)
        try:
            wl = self.api.get("Workload", workload_name, ns)
        except NotFound:
            return False
        if obj_util.get_path(wl, "status", "state") != "Admitted":
            return False
        hosts = int(obj_util.get_path(wl, "spec", "nodes", default=0) or 0)
        nodes = (
            obj_util.get_path(
                wl, "status", "assignment", "nodes", default=[]
            )
            or []
        )
        if not hosts or len(nodes) != hosts:
            return False
        members = [
            p
            for p in self.api.list(
                "Pod",
                namespace=ns,
                label_selector={"matchLabels": {WORKLOAD_LABEL: workload_name}},
            )
            if obj_util.get_path(p, "status", "phase")
            not in ("Succeeded", "Failed")
        ]
        by_ordinal: dict[int, Obj] = {}
        for p in members:
            try:
                by_ordinal[int(obj_util.labels_of(p).get(ORDINAL_LABEL, ""))] = p
            except ValueError:
                return False
        if set(by_ordinal) != set(range(hosts)):
            return False  # gang not fully materialised yet
        used = self._sched_used
        if used is None:
            used = self._build_used_by_node()
        plan: list[tuple[Obj, str, float]] = []
        for ordinal in range(hosts):
            member = by_ordinal[ordinal]
            node_name = nodes[ordinal]
            if obj_util.get_path(member, "spec", "nodeName"):
                continue  # already bound (re-sync after partial pass)
            try:
                node = self.api.get("Node", node_name)
            except NotFound:
                return False
            want = self._pod_gpu_request(member)
            alloc = obj_util.parse_quantity(
                obj_util.get_path(
                    node, "status", "allocatable", GPU_RESOURCE, default=0
                )
            )
            if want and used.get(node_name, 0.0) + want > alloc:
                return False
            plan.append((member, node_name, want))
        for member, node_name, want in plan:
            member["spec"]["nodeName"] = node_name
            self.api.update(member)
            used[node_name] = used.get(node_name, 0.0) + want
        return True

    # -- pod lifecycle ------------------------------------------------------

    def _make_pod(
        self,
        owner: Obj,
        name: str,
        template: Obj,
        ordinal: int,
        subdomain: Optional[str],
    ) -> Obj:
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "namespace": obj_util.namespace_of(owner),
                "labels": dict(
                    obj_util.get_path(template, "metadata", "labels", default={})
                    or {}
                ),
                "annotations": dict(
                    obj_util.get_path(template, "metadata", "annotations", default={})
                    or {}
                ),
            },
            "spec": obj_util.deepcopy(template.get("spec", {})),
        }
        if subdomain:
            pod["spec"]["hostname"] = name
            pod["spec"]["subdomain"] = subdomain
        obj_util.set_controller_reference(pod, owner)
        pod["metadata"]["labels"].setdefault(
            "statefulset.kubernetes.io/pod-name", name
        )
        pod["metadata"]["labels"].setdefault(
            "apps.kubernetes.io/pod-index", str(ordinal)
        )
        return pod

    def _sync_pod_status(self, pod: Obj) -> None:
        """Drive Pending→Running once scheduled; mark unschedulable.
        Admission-gated pods never reach the per-pod scheduler: they
        wait for their Workload's admission and then bind as a gang.

        A Running pod keeps its status — its IP and its containers'
        start times — as a kubelet keeps them. (The JAX package's
        simulator rewrites them on every pass, so its cluster never
        stops writing; here a settled cluster writes nothing.)"""
        phase = obj_util.get_path(pod, "status", "phase")
        if phase in ("Succeeded", "Failed", "Running"):
            return
        node = obj_util.get_path(pod, "spec", "nodeName")
        if not node:
            gate = obj_util.annotations_of(pod).get(ADMISSION_GATE_ANNOTATION)
            if gate:
                if not self._bind_gang(pod, gate):
                    self._mark_gated(pod, gate)
                    return
                pod = self.api.get(
                    "Pod", obj_util.name_of(pod), obj_util.namespace_of(pod)
                )
                node = obj_util.get_path(pod, "spec", "nodeName")
            else:
                target = self._schedule(pod)
                if target is None:
                    reason, message = self._unschedulable_reason(pod)
                    pod.setdefault("status", {})
                    pod["status"]["phase"] = "Pending"
                    pod["status"]["conditions"] = [
                        {
                            "type": "PodScheduled",
                            "status": "False",
                            "reason": reason,
                            "message": message,
                        }
                    ]
                    self.api.update_status(pod)
                    self.api.emit_event(
                        pod,
                        "FailedScheduling",
                        message,
                        event_type="Warning",
                        component="default-scheduler",
                    )
                    return
                pod["spec"]["nodeName"] = target
                pod = self.api.update(pod)
        if not self._images_ready(pod):
            return
        containers = obj_util.get_path(pod, "spec", "containers", default=[]) or []
        pod.setdefault("status", {})
        pod["status"].update(
            {
                "phase": "Running",
                "podIP": f"10.0.0.{next(self._ip_counter)}",
                "conditions": [
                    {"type": "PodScheduled", "status": "True"},
                    {"type": "Initialized", "status": "True"},
                    {"type": "ContainersReady", "status": "True"},
                    {"type": "Ready", "status": "True"},
                ],
                "containerStatuses": [
                    {
                        "name": c.get("name", ""),
                        "ready": True,
                        "restartCount": 0,
                        "state": {"running": {"startedAt": obj_util.now_rfc3339()}},
                    }
                    for c in containers
                ],
            }
        )
        self.api.update_status(pod)

    # -- simulated image pulls (warmup/ subsystem) ---------------------------

    def node_images(self, node: str) -> set[str]:
        """Images this node has already pulled — its 'warmth'."""
        return set(self._node_images.get(node, set()))

    def _images_ready(self, pod: Obj) -> bool:
        """Whether the pod's node holds every container image. A cold
        node pays SIM_IMAGE_PULL_SECONDS of Pending (reason
        ContainersNotReady / pulling), then remembers the images; a
        warm node — one a standby already ran the image on — starts
        instantly. With the knob at 0 the pull is instantaneous but
        warmth is still tracked, so tests can observe which nodes a
        warm pool pre-imaged."""
        node = obj_util.get_path(pod, "spec", "nodeName")
        if not node:
            return True
        images = {
            c.get("image", "")
            for c in obj_util.get_path(pod, "spec", "containers", default=[])
            or []
            if c.get("image")
        }
        have = self._node_images.setdefault(str(node), set())
        missing = images - have
        uid = obj_util.meta(pod).get("uid", "")
        if not missing:
            self._pull_started.pop(uid, None)
            return True
        if self.image_pull_seconds <= 0:
            have |= missing
            return True
        started = self._pull_started.setdefault(uid, time.time())
        if time.time() - started < self.image_pull_seconds:
            pod.setdefault("status", {})
            pod["status"]["phase"] = "Pending"
            pod["status"]["conditions"] = [
                {"type": "PodScheduled", "status": "True"},
                {
                    "type": "Ready",
                    "status": "False",
                    "reason": "ContainersNotReady",
                    "message": "pulling image(s) " + ", ".join(sorted(missing)),
                },
            ]
            self.api.update_status(pod)
            return False
        have |= missing
        self._pull_started.pop(uid, None)
        return True

    # -- workload reconciliation --------------------------------------------

    def _owned_pods(self, owner: Obj) -> list[Obj]:
        """The owner's pods. Its pods carry its selector's labels (they
        are made from its template), so the store filters by the
        selector before it copies anything: without that, a pass over N
        StatefulSets copied every pod of their namespaces N times."""
        uid = obj_util.meta(owner).get("uid")
        selector = obj_util.get_path(owner, "spec", "selector") or None
        return [
            p
            for p in self.api.list(
                "Pod", namespace=obj_util.namespace_of(owner), label_selector=selector
            )
            if any(
                r.get("uid") == uid
                for r in obj_util.meta(p).get("ownerReferences") or []
            )
        ]

    def _sync_statefulset(self, sts: Obj) -> None:
        replicas = obj_util.get_path(sts, "spec", "replicas", default=1)
        template = obj_util.get_path(sts, "spec", "template", default={}) or {}
        service_name = obj_util.get_path(sts, "spec", "serviceName")
        name = obj_util.name_of(sts)
        existing = {obj_util.name_of(p): p for p in self._owned_pods(sts)}
        want = {f"{name}-{i}": i for i in range(replicas)}
        for pod_name in list(existing):
            if pod_name not in want:
                try:
                    self.api.delete(
                        "Pod", pod_name, obj_util.namespace_of(sts)
                    )
                except NotFound:
                    pass
        for pod_name, ordinal in want.items():
            if pod_name not in existing:
                pod = self._make_pod(sts, pod_name, template, ordinal, service_name)
                denial = self._quota_denies(pod)
                if denial:
                    # the ResourceQuota admission contract: pod CREATE
                    # is refused, the workload controller records the
                    # failure and retries — replicas stay unsatisfied
                    self.api.emit_event(
                        sts,
                        "FailedCreate",
                        denial,
                        event_type="Warning",
                        component="statefulset-controller",
                    )
                    continue
                try:
                    created = self.api.create(pod)
                except AlreadyExists:
                    continue
                existing[pod_name] = created
        ready = 0
        for pod_name in want:
            pod = existing.get(pod_name)
            if pod is None:
                continue
            fresh = self.api.get("Pod", pod_name, obj_util.namespace_of(sts))
            self._sync_pod_status(fresh)
            fresh = self.api.get("Pod", pod_name, obj_util.namespace_of(sts))
            if obj_util.get_path(fresh, "status", "phase") == "Running":
                ready += 1
        sts = self.api.get("StatefulSet", name, obj_util.namespace_of(sts))
        sts.setdefault("status", {})
        sts["status"].update(
            {"replicas": replicas, "readyReplicas": ready, "currentReplicas": ready}
        )
        self.api.update_status(sts)

    def _sync_deployment(self, deploy: Obj) -> None:
        replicas = obj_util.get_path(deploy, "spec", "replicas", default=1)
        template = obj_util.get_path(deploy, "spec", "template", default={}) or {}
        name = obj_util.name_of(deploy)
        existing = self._owned_pods(deploy)
        for i, pod in enumerate(existing[replicas:]):
            self.api.delete("Pod", obj_util.name_of(pod), obj_util.namespace_of(deploy))
        for i in range(len(existing), replicas):
            pod = self._make_pod(
                deploy, f"{name}-{i}-{obj_util.meta(deploy)['uid'][:5]}", template, i, None
            )
            denial = self._quota_denies(pod)
            if denial:
                self.api.emit_event(
                    deploy,
                    "FailedCreate",
                    denial,
                    event_type="Warning",
                    component="deployment-controller",
                )
                continue
            self.api.create(pod)
        ready = 0
        for pod in self._owned_pods(deploy):
            fresh = self.api.get(
                "Pod", obj_util.name_of(pod), obj_util.namespace_of(deploy)
            )
            self._sync_pod_status(fresh)
            fresh = self.api.get(
                "Pod", obj_util.name_of(pod), obj_util.namespace_of(deploy)
            )
            if obj_util.get_path(fresh, "status", "phase") == "Running":
                ready += 1
        deploy = self.api.get("Deployment", name, obj_util.namespace_of(deploy))
        deploy.setdefault("status", {})
        deploy["status"].update(
            {"replicas": replicas, "readyReplicas": ready, "availableReplicas": ready}
        )
        self.api.update_status(deploy)

    # -- quota status mirroring ---------------------------------------------

    def _mirror_quota_status(self) -> None:
        """Write ``status.used`` onto every GPU-capped ResourceQuota
        from the scheduler ledger (the real resource-quota controller's
        job — without it ``kubectl describe quota`` and the spawner UI
        show hard caps with no usage). Only the GPU keys the ledger
        tracks are mirrored; gated-unbound pods hold no GPUs."""
        for quota in self.api.list("ResourceQuota"):
            hard = obj_util.get_path(quota, "spec", "hard", default={}) or {}
            gpu_keys = [
                k
                for k in (f"requests.{GPU_RESOURCE}", GPU_RESOURCE)
                if k in hard
            ]
            if not gpu_keys:
                continue
            used = int(
                self._gpus_used_in_namespace(obj_util.namespace_of(quota))
            )
            # merge — only the GPU keys are ledger-tracked here; any
            # other capped resource keeps whatever status it has
            status = quota.setdefault("status", {})
            hard_status = dict(status.get("hard") or {})
            used_status = dict(status.get("used") or {})
            for k in gpu_keys:
                hard_status[k] = str(hard[k])
                used_status[k] = str(used)
            status["hard"] = hard_status
            status["used"] = used_status
            self.api.update_status(quota)  # no-op writes are suppressed

    def step(self) -> None:
        """One full sync pass over all StatefulSets and Deployments."""
        self._sched_used = self._build_used_by_node()
        try:
            for sts in self.api.list("StatefulSet"):
                self._sync_statefulset(sts)
            for deploy in self.api.list("Deployment"):
                self._sync_deployment(deploy)
        finally:
            self._sched_used = None
        self._mirror_quota_status()
        # container memory lives and dies with its pod: GC kernel state
        # for pods that no longer exist (scale-down, eviction, delete);
        # a cluster whose kernels hold nothing skips the pod list
        if self.session_runtime._memory:
            self.session_runtime.prune(
                {obj_util.meta(p).get("uid", "") for p in self.api.list("Pod")}
            )
