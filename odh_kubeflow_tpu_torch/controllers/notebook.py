"""notebook-controller: Notebook CR → StatefulSet + Service(+ routes),
with GPU gang scheduling (the port's copy of the JAX package's
``controllers/notebook.py``).

Reference parity (components/notebook-controller/controllers/
notebook_controller.go): Reconcile :90-282, generateStatefulSet
:418-481, generateService :483-510, generateVirtualService :516-610,
event re-emission :94-118 + nbNameFromInvolvedObject :653-677, status
mirroring :300-359, culling branch :252-281.

On GPU node pools (the JAX package's TPU slices mapped as
``apis.ACCELERATOR_MAPPING`` says):
- The accelerator request is (GKE accelerator type, GPU count)
  annotations + an ``nvidia.com/gpu`` limit per pod.
- A request larger than one node spans ``ceil(gpus / gpus_per_node)``
  nodes: StatefulSet replicas == nodes, a headless service gives stable
  per-node DNS, and every pod gets the worker identity that
  ``utils/distributed.py`` reads to start NCCL (TPU_WORKER_ID = the pod
  ordinal, TPU_WORKER_HOSTNAMES = all nodes, JAX_COORDINATOR_ADDRESS on
  node 0: the platform's names, kept) beside NVIDIA_VISIBLE_DEVICES.
- Culling treats the node group atomically: replicas go nodes→0, never
  partial; a preempted node restarts the whole gang.

The sessions subsystem's suspend hold and checkpoint watch, the
warm-pool placement hint and the compile-cache mount are JAX's; the
mount sets ``ODH_TORCH_KERNEL_CACHE`` (the kernels' build directory,
``ops/_build.py``) where JAX's sets ``JAX_COMPILATION_CACHE_DIR``, and
it wins over the GPU-runtime PodDefault's workspace default
(``webhooks/poddefault.py``). Left out of the copy for now
(ROADMAP.md): the spawn-trace stamps, the usage meter tap and the
split-process ``main()``.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Optional

from odh_kubeflow_tpu_torch.apis import (
    GPU_ACCEL_NODE_LABEL,
    GPU_ACCELERATOR_ANNOTATION,
    GPU_COUNT_ANNOTATION,
    GPU_COUNT_NODE_LABEL,
    GPU_NODES_ENV,
    GPU_RESOURCE,
    GPU_VISIBLE_ENV,
    STOP_ANNOTATION,
)
from odh_kubeflow_tpu_torch.controllers import reconcilehelper
from odh_kubeflow_tpu_torch.controllers.runtime import Manager, Request, Result
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.cache import list_by_index
from odh_kubeflow_tpu_torch.machinery.events import EventRecorder
from odh_kubeflow_tpu_torch.machinery.objects import mutable
from odh_kubeflow_tpu_torch.machinery.store import APIServer, Conflict, NotFound
from odh_kubeflow_tpu_torch.scheduling import (
    ADMISSION_GATE_ANNOTATION,
    WORKLOAD_LABEL,
)
from odh_kubeflow_tpu_torch.scheduling.workload import (
    resolve_priority,
    workload_from_statefulset,
)
from odh_kubeflow_tpu_torch.utils import prometheus
from odh_kubeflow_tpu_torch.ops._build import KERNEL_CACHE_ENV
from odh_kubeflow_tpu_torch.utils.gpu import GPU_ACCELERATORS, gpus_in_request, nodes_in_slice
from odh_kubeflow_tpu_torch.warmup import PREFERRED_POOL_ANNOTATION

Obj = dict[str, Any]

DEFAULT_CONTAINER_PORT = 8888
DEFAULT_SERVICE_PORT = 80
DEFAULT_FSGROUP = 100
PREFIX_ENV = "NB_PREFIX"
GPU_AGENT_PORT = 8890


@dataclasses.dataclass
class NotebookControllerConfig:
    """Toggles, names matching the reference
    (notebook_controller.go:204,472,534,548; culler.go:26-30); reading
    them from the env (``from_env``) comes with the split-process
    entrypoint."""

    use_istio: bool = False
    istio_gateway: str = "kubeflow/kubeflow-gateway"
    istio_host: str = "*"
    cluster_domain: str = "cluster.local"
    add_fsgroup: bool = True
    enable_culling: bool = False
    cull_idle_seconds: float = 1440 * 60.0
    idleness_check_seconds: float = 60.0
    # gang admission (scheduling/): GPU notebooks get a Workload +
    # admission-gated pods instead of racing the quota
    enable_queueing: bool = False
    # suspend-to-checkpoint sessions (sessions/ subsystem): culls become
    # suspends, the scale-down waits for the kernel snapshot, and
    # suspended notebooks resume warm instead of starting cold
    enable_sessions: bool = False
    # wedge-breaker: a suspend whose snapshot never lands within this
    # window degrades to a plain stop (losing state beats leaking GPUs)
    suspend_grace_seconds: float = 600.0
    # compilation-cache service mount (warmup/ subsystem): when set,
    # GPU notebook kernels get ODH_TORCH_KERNEL_CACHE pointed at this
    # cache-service-backed path, so their first launch loads the
    # fleet's built kernels instead of running nvcc
    compile_cache_mount: str = ""

# ---------------------------------------------------------------------------
# GPU request derivation


@dataclasses.dataclass(frozen=True)
class GpuRequest:
    accelerator_type: str
    gpus: int

    @property
    def nodes(self) -> int:
        return nodes_in_slice(self.accelerator_type, self.gpus)

    @property
    def gpus_per_node(self) -> int:
        return self.gpus // self.nodes

    @property
    def node_gpus(self) -> int:
        """The GPUs one node of the pool holds (its node label)."""
        return GPU_ACCELERATORS[self.accelerator_type].gpus_per_node


def gpu_request_of(notebook: Obj) -> Optional[GpuRequest]:
    """The notebook's GPU request (the counterpart of ``tpu_request_of``):
    None without an accelerator annotation; a missing count takes the
    type's smallest. Raises ValueError for an unknown type or a count
    the type does not offer."""
    ann = obj_util.annotations_of(notebook)
    accel = ann.get(GPU_ACCELERATOR_ANNOTATION, "")
    count = ann.get(GPU_COUNT_ANNOTATION, "")
    if not accel:
        return None
    if accel not in GPU_ACCELERATORS:
        raise ValueError(f"unknown GPU accelerator type {accel!r}")
    counts = GPU_ACCELERATORS[accel].counts
    gpus = gpus_in_request(count) if count else counts[0]
    if gpus not in counts:
        raise ValueError(f"unknown GPU count {count!r} for {accel}")
    return GpuRequest(accel, gpus)


# ---------------------------------------------------------------------------
# controller


class NotebookController:
    def __init__(
        self,
        api: APIServer,
        config: Optional[NotebookControllerConfig] = None,
        registry: Optional[prometheus.Registry] = None,
        culler: Optional[Any] = None,
    ):
        self.api = api
        self.config = config or NotebookControllerConfig()
        self.culler = culler
        self.recorder = EventRecorder(api, "notebook-controller")
        reg = registry or prometheus.default_registry
        self.m_create = reg.counter(
            "notebook_create_total", "Total times of creating notebooks"
        )
        self.m_create_failed = reg.counter(
            "notebook_create_failed_total", "Failed creations"
        )
        self.m_cull = reg.counter("notebook_culling_total", "Culled notebooks")
        self.m_last_cull = reg.gauge(
            "last_notebook_culling_timestamp_seconds",
            "Timestamp of the last notebook culling in seconds",
        )
        # spawn→ready, observed once per notebook at its FIRST ready
        # transition (creation → readyReplicas>0; restarts are excluded
        # by the firstReadyAt marker)
        self.m_spawn_ready = reg.histogram(
            "notebook_spawn_ready_seconds",
            "Notebook creation to first Ready (platform spawn path)",
            buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0),
        )
        reg.register_collector(self._collect_running)
        # wire the metrics into the culler (reference metrics.go:13-20:
        # the culling counter/timestamp are the controller's metrics,
        # incremented when the cull decision fires)
        if culler is not None and getattr(culler, "m_cull", None) is None:
            culler.m_cull = self.m_cull
            culler.m_last_cull = self.m_last_cull

    def _collect_running(self):
        # notebook StatefulSets only: the Exists selector filters in the
        # store before any copy
        n = 0
        selector = {
            "matchExpressions": [
                {"key": "notebook-name", "operator": "Exists"}
            ]
        }
        for sts in self.api.list("StatefulSet", label_selector=selector):
            if obj_util.get_path(sts, "status", "readyReplicas", default=0):
                n += 1
        yield "# HELP notebook_running Number of currently running notebooks"
        yield "# TYPE notebook_running gauge"
        yield f"notebook_running {n}"

    # -- wiring -------------------------------------------------------------

    def register(self, mgr: Manager) -> None:
        ctrl = mgr.new_controller("notebook-controller", "Notebook", self.reconcile)
        ctrl.owns("StatefulSet").owns("Service")
        ctrl.watches("Pod", self._map_pod, predicate=self._pod_predicate)
        ctrl.watches("Event", self._map_event)
        if self.config.enable_sessions:
            # the checkpoint turning durable is what releases the held
            # scale-down — the suspend completes on this watch
            ctrl.watches("SessionCheckpoint", self._map_checkpoint)
        if self.config.use_istio:
            ctrl.owns("VirtualService")

    @staticmethod
    def _map_checkpoint(_etype: str, ckpt: Obj) -> list[Request]:
        name = obj_util.get_path(ckpt, "spec", "notebook", default=obj_util.name_of(ckpt))
        return [Request(obj_util.namespace_of(ckpt), name)] if name else []

    def _pod_predicate(self, _etype: str, pod: Obj) -> bool:
        return "notebook-name" in obj_util.labels_of(pod)

    def _map_pod(self, _etype: str, pod: Obj) -> list[Request]:
        name = obj_util.labels_of(pod).get("notebook-name", "")
        return [Request(obj_util.namespace_of(pod), name)] if name else []

    def _map_event(self, etype: str, event: Obj) -> list[Request]:
        """Re-queue the Notebook named by an Event on its StatefulSet or
        Pods (reference nbNameFromInvolvedObject :653-677: strip the
        ordinal suffix and verify a Notebook of that name exists), and
        re-emit the event onto the Notebook CR itself so
        ``kubectl describe notebook`` tells the whole story (reference
        notebook_controller.go:94-118,649-723)."""
        if etype == "DELETED":
            # an event EXPIRING (store retention prune now notifies
            # DELETED) is not a fresh observation — re-mirroring it
            # would resurrect long-resolved failures with current
            # timestamps, and at the retention limit each re-emission
            # triggers another prune (a cascade)
            return []
        involved = event.get("involvedObject") or {}
        ns = involved.get("namespace", "")
        name = involved.get("name", "")
        kind = involved.get("kind", "")
        if kind == "Pod" and "-" in name:
            name = name.rsplit("-", 1)[0]
        if not ns or not name:
            return []
        try:
            notebook = self.api.get("Notebook", name, ns)
        except NotFound:
            return []
        if kind in ("StatefulSet", "Pod"):
            self._mirror_event(notebook, event)
        return [Request(ns, name)]

    def _mirror_event(self, notebook: Obj, event: Obj) -> None:
        """Copy an owned-object Warning event onto the Notebook (Normal
        events are noise at the CR level — the reference's useful signal
        is failures). Dedupe is server-side with real kube count
        semantics: an identical (reason, message, type) event already on
        the CR absorbs the re-observation as a count bump + lastTimestamp
        advance instead of a duplicate object, so a restarted controller
        replaying the Event watch cannot flood the CR, while a recurring
        failure stays visibly fresh. Events older than the CR (a
        recreated notebook inheriting stale pod events, reference
        :700-712) are skipped."""
        if event.get("type") != "Warning":
            return
        created = obj_util.meta(notebook).get("creationTimestamp", "")
        stamp = event.get("lastTimestamp") or event.get("firstTimestamp") or ""
        if created and stamp and stamp < created:
            return
        reason = event.get("reason", "")
        message = event.get("message", "")
        if not reason and not message:
            return
        name = obj_util.name_of(notebook)
        for existing in list_by_index(
            self.api,
            "Event",
            "involved",
            f"Notebook/{name}",
            namespace=obj_util.namespace_of(notebook),
        ):
            involved = existing.get("involvedObject", {})
            if (
                involved.get("kind") == "Notebook"
                and involved.get("name") == name
                and existing.get("reason") == reason
                and existing.get("message") == message
                and existing.get("type") == "Warning"
            ):
                if stamp and stamp > existing.get("lastTimestamp", ""):
                    existing = mutable(existing)
                    existing["count"] = int(existing.get("count", 1)) + 1
                    existing["lastTimestamp"] = stamp
                    try:
                        self.api.update(existing)
                    except Conflict:
                        pass  # another worker bumped it; same truth
                return
        self.api.emit_event(
            notebook,
            reason,
            message,
            event_type="Warning",
            component="notebook-controller",
        )

    # -- reconcile ----------------------------------------------------------

    def reconcile(self, req: Request) -> Result:
        try:
            # mutable(): this reconcile writes status/conditions onto
            # the in-hand object, so a cache hit takes one private copy
            # here (instead of the store's mandatory copy per get)
            notebook = mutable(self.api.get("Notebook", req.name, req.namespace))
        except NotFound:
            return Result()

        try:
            gpu = gpu_request_of(notebook)
        except ValueError as e:
            self.api.emit_event(
                notebook,
                "InvalidGPURequest",
                str(e),
                event_type="Warning",
                component="notebook-controller",
            )
            self._set_condition(notebook, "GPURequestInvalid", str(e))
            return Result()

        # suspend hold: a requested suspend keeps the pods (and the
        # Workload reservation) alive until the kernel snapshot is
        # durable — only then does the scale-down release the GPUs
        suspend_hold = False
        if self.config.enable_sessions:
            from odh_kubeflow_tpu_torch import sessions

            suspend_hold = sessions.suspend_pending(
                self.api, notebook, grace_seconds=self.config.suspend_grace_seconds
            )

        sts = self.generate_statefulset(notebook, gpu, suspend_hold=suspend_hold)
        try:
            _, created = reconcilehelper.reconcile_object(
                self.api, sts, owner=notebook
            )
            if created:
                self.m_create.inc()
                self.recorder.normal(
                    notebook, "Created", f"Created StatefulSet {req.name}"
                )
        except Exception as e:
            # the failure path probes existence (it is rare; the steady
            # state pays no extra GET): only a failed CREATE counts
            try:
                self.api.get("StatefulSet", req.name, req.namespace)
            except NotFound:
                self.m_create_failed.inc()
                self.recorder.warning(
                    notebook,
                    "FailedCreate",
                    f"Failed to create StatefulSet {req.name}: {e}",
                )
            raise

        if self.config.enable_queueing:
            self._reconcile_workload(notebook, sts)

        svc = self.generate_service(notebook, gpu)
        reconcilehelper.reconcile_object(self.api, svc, owner=notebook)
        if gpu is not None and gpu.nodes > 1:
            headless = self.generate_headless_service(notebook)
            reconcilehelper.reconcile_object(self.api, headless, owner=notebook)
        if self.config.use_istio:
            vs = self.generate_virtualservice(notebook)
            reconcilehelper.reconcile_object(self.api, vs, owner=notebook)

        self.mirror_status(notebook)

        if gpu is not None:
            slice_result = self._reconcile_slice_health(notebook, gpu)
            if slice_result is not None:
                return slice_result

        if self.config.enable_culling and self.culler is not None:
            return self.culler.reconcile_notebook(notebook)
        return Result()

    # -- gang admission (scheduling/ subsystem) -----------------------------

    def _reconcile_workload(self, notebook: Obj, sts: Obj) -> None:
        """Keep the Workload in lockstep with the generated StatefulSet
        shape. A stopped/non-GPU notebook has no Workload (deleting it
        releases the admission reservation — culled notebooks free
        their GPUs for the queue)."""
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        priority, pclass, resolved = resolve_priority(self.api, notebook)
        if not resolved:
            self.recorder.warning(
                notebook,
                "UnknownPriorityClass",
                f"PriorityClass {pclass!r} not found; scheduling at "
                "default priority 0",
            )
        desired = workload_from_statefulset(
            sts,
            priority=priority,
            priority_class=pclass,
            # warm-pool handout: the claimed notebook prefers the node
            # pool its standby just freed (warmup/ subsystem)
            preferred_pool=obj_util.annotations_of(notebook).get(
                PREFERRED_POOL_ANNOTATION, ""
            ),
        )
        try:
            if desired is None:
                try:
                    self.api.delete("Workload", name, ns)
                except NotFound:
                    pass
                return
            reconcilehelper.reconcile_object(self.api, desired, owner=notebook)
        except NotFound:
            # Workload kind not registered — queueing enabled without
            # the scheduling subsystem installed; degrade to the legacy
            # per-pod path rather than wedging the reconcile
            return

    # -- gang health -----------------------------------------------------------

    def _reconcile_slice_health(
        self, notebook: Obj, gpu: GpuRequest
    ) -> Optional[Result]:
        """Preempted GPU nodes surface as CR conditions and restart
        cleanly. A multi-node notebook is a gang: one preempted node
        makes the whole NCCL group useless (every worker must be
        present), so recovery deletes ALL the group's pods — survivors
        included — and lets the StatefulSet re-materialise them
        together. The condition keeps the JAX package's type,
        ``SlicePreempted``."""
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        # filter in the store (before the per-object copy), not here:
        # at N notebooks this reconcile runs N times per drain, and an
        # unfiltered list would copy all N slices' pods every time
        pods = self.api.list(
            "Pod",
            namespace=ns,
            label_selector={"matchLabels": {"statefulset": name}},
        )
        failed = [
            p
            for p in pods
            if obj_util.get_path(p, "status", "phase") == "Failed"
        ]
        if failed:
            hosts = ", ".join(sorted(obj_util.name_of(p) for p in failed))
            msg = (
                f"GPU slice preempted: host pod(s) {hosts} failed; "
                "restarting the slice group atomically"
            )
            self.api.emit_event(
                notebook,
                "GPUSlicePreempted",
                msg,
                event_type="Warning",
                component="notebook-controller",
            )
            self._upsert_condition(
                notebook, "SlicePreempted", "True", "SlicePreempted", msg
            )
            for p in pods:
                try:
                    self.api.delete("Pod", obj_util.name_of(p), ns)
                except NotFound:
                    pass
            return Result(requeue_after=1.0)

        # recovery: the full gang is ready again → flip the condition
        for cond in obj_util.get_path(
            notebook, "status", "conditions", default=[]
        ) or []:
            if cond.get("type") == "SlicePreempted" and cond.get("status") == "True":
                # count live pods, not the (possibly stale) STS status:
                # right after the gang teardown the STS still reports
                # its pre-preemption readyReplicas
                running = sum(
                    1
                    for p in pods
                    if obj_util.get_path(p, "status", "phase") == "Running"
                )
                if running == gpu.nodes:
                    self._upsert_condition(
                        notebook,
                        "SlicePreempted",
                        "False",
                        "SliceRecovered",
                        f"all {gpu.nodes} slice host(s) ready",
                    )
                break
        return None

    # -- generators ---------------------------------------------------------

    def _notebook_prefix(self, notebook: Obj) -> str:
        return f"/notebook/{obj_util.namespace_of(notebook)}/{obj_util.name_of(notebook)}"

    def generate_statefulset(
        self, notebook: Obj, gpu: Optional[GpuRequest], suspend_hold: bool = False
    ) -> Obj:
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        template = obj_util.deepcopy(
            obj_util.get_path(notebook, "spec", "template", default={}) or {}
        )
        pod_spec = template.setdefault("spec", {})
        containers = pod_spec.setdefault("containers", [])
        if containers:
            c0 = containers[0]
            c0["name"] = name
            c0.setdefault("workingDir", "/home/jovyan")
            c0.setdefault(
                "ports",
                [
                    {
                        "containerPort": DEFAULT_CONTAINER_PORT,
                        "name": "notebook-port",
                        "protocol": "TCP",
                    }
                ],
            )
            env = c0.setdefault("env", [])
            if not any(e.get("name") == PREFIX_ENV for e in env):
                env.append(
                    {"name": PREFIX_ENV, "value": self._notebook_prefix(notebook)}
                )

        if self.config.add_fsgroup:
            pod_spec.setdefault("securityContext", {}).setdefault(
                "fsGroup", DEFAULT_FSGROUP
            )

        stopped = STOP_ANNOTATION in obj_util.annotations_of(notebook) and not suspend_hold
        replicas = 0 if stopped else 1

        if gpu is not None:
            replicas = 0 if stopped else gpu.nodes
            self._apply_gpu_scheduling(notebook, pod_spec, gpu)
            if self.config.enable_queueing:
                # admission gate: the kubelet sim keeps these pods
                # Pending (SchedulingGated) until the gang scheduler
                # admits the gang, then binds all hosts to the recorded
                # assignment atomically
                tmeta = template.setdefault("metadata", {})
                tmeta.setdefault("annotations", {})[
                    ADMISSION_GATE_ANNOTATION
                ] = name
                tmeta.setdefault("labels", {})[WORKLOAD_LABEL] = name

        labels = {"statefulset": name, "notebook-name": name}
        template.setdefault("metadata", {}).setdefault("labels", {}).update(labels)
        return {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {"name": name, "namespace": ns, "labels": dict(labels)},
            "spec": {
                "replicas": replicas,
                "serviceName": f"{name}-hosts" if gpu and gpu.nodes > 1 else name,
                "selector": {"matchLabels": {"statefulset": name}},
                "template": template,
            },
        }

    def _apply_gpu_scheduling(
        self, notebook: Obj, pod_spec: Obj, gpu: GpuRequest
    ) -> None:
        """The GPU scheduling contract (the counterpart of
        ``_apply_tpu_scheduling``): node selectors for the pool's
        accelerator type and node shape, ``nvidia.com/gpu`` limits per
        pod, and the env that starts one NCCL process per GPU."""
        name = obj_util.name_of(notebook)
        selector = pod_spec.setdefault("nodeSelector", {})
        selector[GPU_ACCEL_NODE_LABEL] = gpu.accelerator_type
        selector[GPU_COUNT_NODE_LABEL] = str(gpu.node_gpus)
        containers = pod_spec.get("containers") or []
        if not containers:
            return
        c0 = containers[0]
        resources = c0.setdefault("resources", {})
        limits = resources.setdefault("limits", {})
        requests = resources.setdefault("requests", {})
        limits[GPU_RESOURCE] = str(gpu.gpus_per_node)
        requests[GPU_RESOURCE] = str(gpu.gpus_per_node)

        env = c0.setdefault("env", [])

        def set_env(entry: Obj) -> None:
            for e in env:
                if e.get("name") == entry["name"]:
                    e.clear()
                    e.update(entry)
                    return
            env.append(entry)

        # every GPU of the pod's limit visible to the container
        set_env({"name": GPU_VISIBLE_ENV, "value": "all"})
        if gpu.nodes > 1:
            hosts_svc = f"{name}-hosts"
            hostnames = ",".join(
                f"{name}-{i}.{hosts_svc}" for i in range(gpu.nodes)
            )
            set_env({"name": "TPU_WORKER_HOSTNAMES", "value": hostnames})
            set_env(
                {
                    "name": "TPU_WORKER_ID",
                    "valueFrom": {
                        "fieldRef": {
                            "fieldPath": (
                                "metadata.labels['apps.kubernetes.io/pod-index']"
                            )
                        }
                    },
                }
            )
            set_env(
                {
                    "name": "JAX_COORDINATOR_ADDRESS",
                    "value": f"{name}-0.{hosts_svc}:8476",
                }
            )
            set_env({"name": GPU_NODES_ENV, "value": str(gpu.nodes)})
        else:
            set_env({"name": "TPU_WORKER_ID", "value": "0"})
            set_env({"name": "TPU_WORKER_HOSTNAMES", "value": "localhost"})
        if self.config.compile_cache_mount:
            # kernels build into (and load from) the cache-service-backed
            # mount: the fleet's built kernels load instead of rebuilding
            # (warmup/compilecache.py stages/ingests the directory)
            set_env({"name": KERNEL_CACHE_ENV, "value": self.config.compile_cache_mount})

    def generate_service(
        self, notebook: Obj, gpu: Optional[GpuRequest] = None
    ) -> Obj:
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        ports = [
            {
                # http- prefix: Istio protocol selection
                # (reference :500-501)
                "name": f"http-{name}",
                "port": DEFAULT_SERVICE_PORT,
                "targetPort": DEFAULT_CONTAINER_PORT,
                "protocol": "TCP",
            }
        ]
        if gpu is not None:
            # the in-image gpu-activity agent the culler probes
            ports.append(
                {
                    "name": "http-gpu-activity",
                    "port": GPU_AGENT_PORT,
                    "targetPort": GPU_AGENT_PORT,
                    "protocol": "TCP",
                }
            )
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": ns},
            "spec": {
                "type": "ClusterIP",
                "selector": {"statefulset": name},
                "ports": ports,
            },
        }

    def generate_headless_service(self, notebook: Obj) -> Obj:
        """Stable per-node DNS for multi-node notebooks — the names feeding
        TPU_WORKER_HOSTNAMES (the NCCL rendezvous of
        ``utils/distributed.py``)."""
        name = obj_util.name_of(notebook)
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": f"{name}-hosts",
                "namespace": obj_util.namespace_of(notebook),
            },
            "spec": {
                "clusterIP": "None",
                "selector": {"statefulset": name},
                "ports": [
                    {"name": "jax-coordinator", "port": 8476, "protocol": "TCP"}
                ],
            },
        }

    def generate_virtualservice(self, notebook: Obj) -> Obj:
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        prefix = self._notebook_prefix(notebook) + "/"
        service_host = f"{name}.{ns}.svc.{self.config.cluster_domain}"
        return {
            "apiVersion": "networking.istio.io/v1beta1",
            "kind": "VirtualService",
            "metadata": {"name": f"notebook-{ns}-{name}", "namespace": ns},
            "spec": {
                "hosts": [self.config.istio_host],
                "gateways": [self.config.istio_gateway],
                "http": [
                    {
                        "match": [{"uri": {"prefix": prefix}}],
                        "rewrite": {"uri": "/"},
                        "route": [
                            {
                                "destination": {
                                    "host": service_host,
                                    "port": {"number": DEFAULT_SERVICE_PORT},
                                }
                            }
                        ],
                        "timeout": "300s",
                    }
                ],
            },
        }

    # -- status -------------------------------------------------------------

    def mirror_status(self, notebook: Obj) -> None:
        """Status from the StatefulSet + pod (reference :300-359): ready
        replicas, pod conditions, container state of the notebook
        container, error-event surfacing."""
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        prev_ready = obj_util.get_path(
            notebook, "status", "readyReplicas", default=0
        )
        status: Obj = {
            "readyReplicas": 0,
            "conditions": [],
            "containerState": {},
        }
        # a suspend/resume phase (the sessions subsystem's field) is not
        # this mirror's — preserve it across the rebuild
        phase = obj_util.get_path(notebook, "status", "phase", default="")
        if phase:
            status["phase"] = phase
        # first-ever-ready marker (spawn-SLO dedupe): owned by this
        # mirror, preserved across rebuilds like phase — durable state,
        # unlike the Started event whose dedupe identity embeds the
        # ready-host count and whose retention window prunes
        first_ready = obj_util.get_path(
            notebook, "status", "firstReadyAt", default=""
        )
        if first_ready:
            status["firstReadyAt"] = first_ready
        # controller-owned conditions survive the pod-mirror rebuild
        for cond in (
            obj_util.get_path(notebook, "status", "conditions", default=[]) or []
        ):
            if cond.get("type") == "SlicePreempted":
                status["conditions"].append(cond)
        try:
            sts = self.api.get("StatefulSet", name, ns)
            status["readyReplicas"] = obj_util.get_path(
                sts, "status", "readyReplicas", default=0
            )
        except NotFound:
            pass
        try:
            pod = self.api.get("Pod", f"{name}-0", ns)
            for cond in obj_util.get_path(pod, "status", "conditions", default=[]) or []:
                status["conditions"].append(
                    {"type": cond.get("type"), "status": cond.get("status"),
                     **({"reason": cond["reason"]} if cond.get("reason") else {}),
                     **({"message": cond["message"]} if cond.get("message") else {})}
                )
            for cs in (
                obj_util.get_path(pod, "status", "containerStatuses", default=[])
                or []
            ):
                if cs.get("name") == name:
                    status["containerState"] = cs.get("state") or {}
        except NotFound:
            pass
        # ready-transition Event (0 → ready): level-triggered, so the
        # guard is the stored status — re-reconciles of a ready
        # notebook see prev_ready > 0 and stay quiet
        observe_spawn = False
        if status["readyReplicas"] and not prev_ready:
            self.recorder.normal(
                notebook,
                "Started",
                f"Notebook server started ({status['readyReplicas']} "
                "ready host(s))",
            )
            # first-EVER ready only: a stop/restart transition would
            # otherwise observe creation→now. The histogram is observed AFTER
            # the status write lands — a Conflict retry would
            # otherwise re-observe the same spawn (the marker exists
            # exactly so this fires once).
            if not first_ready:
                status["firstReadyAt"] = obj_util.now_rfc3339()
                observe_spawn = True
        if (notebook.get("status") or {}) == status:
            # steady state: the mirrored status is already what's
            # stored — skip the API round-trip entirely (the store
            # would suppress the write anyway, but only after three
            # deepcopies; at N notebooks per drain that tax dominates)
            return
        notebook["status"] = status
        if reconcilehelper.update_status_level_triggered(self.api, notebook) is None:
            return  # Conflict: the conflicting write re-enqueues this key
        if observe_spawn:
            created = obj_util.meta(notebook).get("creationTimestamp", "")
            if created:
                self.m_spawn_ready.observe(
                    max(_time.time() - obj_util.parse_rfc3339(created), 0.0)
                )

    def _set_condition(self, notebook: Obj, reason: str, message: str) -> None:
        self._upsert_condition(notebook, "Degraded", "True", reason, message)

    def _upsert_condition(
        self, notebook: Obj, ctype: str, status: str, reason: str, message: str
    ) -> None:
        conditions = notebook.setdefault("status", {}).setdefault("conditions", [])
        cond = {
            "type": ctype,
            "status": status,
            "reason": reason,
            "message": message,
        }
        for i, existing in enumerate(conditions):
            if existing.get("type") == ctype:
                conditions[i] = cond
                break
        else:
            conditions.append(cond)
        reconcilehelper.update_status_level_triggered(self.api, notebook)

