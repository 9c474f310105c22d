"""Central dashboard BFF (the port's copy of the JAX package's
``web/dashboard.py``, on GPU node pools).

Reference parity (components/centraldashboard/app/): workgroup API
api_workgroup.ts:254-340 (/exists, /env-info, registration flow,
contributor management), user-header middleware
attach_user_middleware.ts, pluggable metrics service
metrics_service.ts (here: the Prometheus registry and the GPU
occupancy panel). ``/api/slo`` serves the burn rates of an
``utils/slo.SLOEngine`` (built here when none is handed in; its owner
starts its cadence) and ``/prometheus/metrics`` the registry.

The JAX package's TPU panel of ``/api/metrics`` is a GPU panel here: it
reads capacity from each node's ``nvidia.com/gpu`` and accelerator
label, use from the Running pods' GPU limits, and suspended GPUs from
the sessions ledger; its JSON keys are the TPU panel's through
``apis.ACCELERATOR_MAPPING``. ``/api/usage`` serves the GPU-second
ledger's showback from the usage meter (``machinery/usage.py``; 503
without one, as JAX's does), and the panel's utilization column reads
the meter's ``utilization()``. Left out of the copy (ROADMAP.md): the
index-bucket fast path of the pod scan and the static frontend.
``main()`` serves it in a process of its own through
``machinery/runner.py``; in-process,
``DashboardApp(api).app.serve(host, port)``.
"""

from __future__ import annotations

from typing import Any, Optional

from odh_kubeflow_tpu_torch.apis import (
    ACCELERATOR_MAPPING,
    GPU_ACCEL_NODE_LABEL,
    GPU_RESOURCE,
)
from odh_kubeflow_tpu_torch.controllers.kfam import KfamService
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import AlreadyExists, APIServer
from odh_kubeflow_tpu_torch.utils import prometheus
from odh_kubeflow_tpu_torch.web.crud_backend import failure, success, user_of
from odh_kubeflow_tpu_torch.web.microweb import App, Response, install_csrf

Obj = dict[str, Any]

# the accelerator panel's JSON keys: the JAX package's TPU panel keys
# carried through the accelerator mapping
PANEL, CAPACITY, USED, SUSPENDED, COMMITTED = (
    ACCELERATOR_MAPPING[k]
    for k in ("tpu", "capacityChips", "usedChips", "suspendedChips", "committedChips")
)


class DashboardApp:
    def __init__(
        self,
        api: APIServer,
        kfam: Optional[KfamService] = None,
        registry: Optional[prometheus.Registry] = None,
        slo_engine: Optional[Any] = None,
        meter: Optional[Any] = None,
    ):
        self.api = api
        self.kfam = kfam or KfamService(api)
        self.registry = registry or prometheus.default_registry
        # GPU-second ledger (machinery.usage.UsageMeter): feeds the
        # /api/usage showback endpoint and the occupancy panel's
        # utilization column; None degrades both (/api/usage answers 503)
        self.meter = meter
        # burn-rate rows for /api/slo (utils.slo.SLOEngine); built here
        # when not handed in. NOT started from the constructor — the
        # owner starts the sampling cadence, so embedders and tests
        # don't leak a ticking thread.
        if slo_engine is None:
            from odh_kubeflow_tpu_torch.utils.slo import SLOEngine

            slo_engine = SLOEngine(self.registry)
        self.slo_engine = slo_engine
        self.app = App("centraldashboard", registry=self.registry)
        install_csrf(self.app)
        self._register_routes()

    def _register_routes(self) -> None:
        app = self.app

        @app.route("/api/workgroup/exists")
        def exists(request):
            user = user_of(request)
            namespaces = self.kfam.namespaces_for_user(user)
            return success(
                {
                    "hasAuth": True,
                    "user": user,
                    "hasWorkgroup": bool(namespaces),
                    "registrationFlowAllowed": True,
                }
            )

        @app.route("/api/workgroup/env-info")
        def env_info(request):
            user = user_of(request)
            namespaces = self.kfam.namespaces_for_user(user)
            return success(
                {
                    "user": user,
                    "isClusterAdmin": self.kfam.is_cluster_admin(user),
                    "namespaces": [
                        {"namespace": ns, "role": "owner"} for ns in namespaces
                    ],
                    "platform": {
                        "kubeflowVersion": "gpu-native-0.1.0",
                        "provider": "gke-gpu",
                    },
                }
            )

        @app.route("/api/workgroup/create", methods=["POST"])
        def register(request):
            """First-login registration: create the user's Profile
            (api_workgroup.ts registration flow)."""
            user = user_of(request)
            body = request.json or {}
            namespace = body.get("namespace", "")
            if not namespace:
                return failure("namespace required", 400)
            profile = {
                "apiVersion": "kubeflow.org/v1",
                "kind": "Profile",
                "metadata": {"name": namespace},
                "spec": {"owner": {"kind": "User", "name": user}},
            }
            try:
                self.api.create(profile)
            except AlreadyExists:
                return failure(f"profile {namespace} already exists", 409)
            return success(status=201)

        @app.route("/api/workgroup/add-contributor/<namespace>", methods=["POST"])
        def add_contributor(request, namespace):
            user = user_of(request)
            body = request.json or {}
            binding = {
                "user": {"kind": "User", "name": body.get("contributor", "")},
                "referredNamespace": namespace,
                "roleRef": {
                    "apiGroup": "rbac.authorization.k8s.io",
                    "kind": "ClusterRole",
                    "name": "kubeflow-edit",
                },
            }
            self.kfam.create_binding(binding, requester=user)
            return success(status=201)

        @app.route(
            "/api/workgroup/remove-contributor/<namespace>", methods=["DELETE"]
        )
        def remove_contributor(request, namespace):
            user = user_of(request)
            body = request.json or {}
            binding = {
                "user": {"kind": "User", "name": body.get("contributor", "")},
                "referredNamespace": namespace,
                "roleRef": {
                    "apiGroup": "rbac.authorization.k8s.io",
                    "kind": "ClusterRole",
                    "name": "kubeflow-edit",
                },
            }
            self.kfam.delete_binding(binding, requester=user)
            return success()

        @app.route("/api/workgroup/contributors/<namespace>")
        def list_contributors(request, namespace):
            """Contributor rows for the manage-users view (reference
            main-page's manage-users data comes from kfam bindings)."""
            user = user_of(request)
            if not (
                self.kfam.is_owner_or_admin(user, namespace)
                or self.kfam.is_cluster_admin(user)
            ):
                return failure(f"{user} is not an owner of {namespace}", 403)
            contributors = [
                b["user"]["name"]
                for b in self.kfam.list_bindings(namespace=namespace)
                if b.get("user", {}).get("name")
            ]
            return success({"contributors": sorted(set(contributors))})

        @app.route("/api/workgroup/quota/<namespace>")
        def namespace_quota(request, namespace):
            """Quota panel feed: the namespace's ResourceQuota
            hard/used pairs (the profile controller materialises
            ``kf-resource-quota`` from Profile.spec.resourceQuotaSpec,
            ``requests.nvidia.com/gpu`` included — reference: the resources panel the
            dashboard renders from cluster metrics, made first-class
            for quotas here)."""
            user = user_of(request)
            if not (
                self.kfam.is_owner_or_admin(user, namespace)
                or self.kfam.is_cluster_admin(user)
                or self.kfam.has_binding(user, namespace)
            ):
                return failure(f"{user} has no access to {namespace}", 403)
            rows = []
            for rq in self.api.list("ResourceQuota", namespace=namespace):  # unbounded-ok: cache-served zero-copy read
                hard = obj_util.get_path(rq, "spec", "hard", default={}) or {}
                used = (
                    obj_util.get_path(rq, "status", "used", default={}) or {}
                )
                for resource in sorted(hard):
                    rows.append({
                        "quota": obj_util.name_of(rq),
                        "resource": resource,
                        "hard": str(hard[resource]),
                        "used": str(used.get(resource, "0")),
                    })
            return success({"quota": rows})

        @app.route("/api/workgroup/get-all-namespaces")
        def all_namespaces(request):
            user = user_of(request)
            if not self.kfam.is_cluster_admin(user):
                return failure("cluster admin only", 403)
            out = []
            for profile in self.api.list("Profile"):  # unbounded-ok: cache-served zero-copy read
                out.append(
                    [
                        obj_util.name_of(profile),
                        obj_util.get_path(
                            profile, "spec", "owner", "name", default=""
                        ),
                    ]
                )
            return success({"namespaces": out})

        @app.route("/api/activities/<namespace>")
        def activities(request, namespace):
            """Namespace activity feed (reference: centraldashboard
            api.ts events route feeding main-page's activities view):
            recent k8s Events, newest first, access-gated like every
            other per-namespace view."""
            user = user_of(request)
            if not (
                namespace in self.kfam.namespaces_for_user(user)
                or self.kfam.is_cluster_admin(user)
            ):
                return failure(f"{user} has no access to {namespace}", 403)

            def stamp(e):
                return (
                    e.get("lastTimestamp")
                    or e.get("firstTimestamp")
                    or obj_util.get_path(
                        e, "metadata", "creationTimestamp", default=""
                    )
                )

            events = sorted(
                self.api.list("Event", namespace=namespace),  # unbounded-ok: cache-served zero-copy read
                key=stamp,
                reverse=True,
            )[:100]
            rows = [
                {
                    "time": stamp(e),
                    "type": e.get("type", "Normal"),
                    "reason": e.get("reason", ""),
                    "message": e.get("message", ""),
                    "involved": "{}/{}".format(
                        e.get("involvedObject", {}).get("kind", ""),
                        e.get("involvedObject", {}).get("name", ""),
                    ),
                    "count": e.get("count", 1),
                }
                for e in events
            ]
            return success({"activities": rows})

        @app.route("/api/metrics")
        def metrics_panel(request):
            """Cluster metrics panels (metrics_service.ts analog): GPU
            capacity/usage per accelerator type + notebook counts."""
            user_of(request)
            capacity: dict[str, float] = {}
            used: dict[str, float] = {}
            # per-failure-domain axes (topology.kubernetes.io/zone):
            # a zone running hot — or dark — shows up here first
            zone_capacity: dict[str, float] = {}
            zone_used: dict[str, float] = {}
            node_zone: dict[str, str] = {}
            for node in self.api.list("Node"):  # uncached-ok: cluster inventory  # unbounded-ok: cache-served zero-copy read
                labels = obj_util.labels_of(node)
                accel = labels.get(GPU_ACCEL_NODE_LABEL)
                if not accel:
                    continue
                cap = obj_util.parse_quantity(
                    obj_util.get_path(node, "status", "capacity", GPU_RESOURCE, default=0)
                )
                capacity[accel] = capacity.get(accel, 0) + cap
                zone = labels.get("topology.kubernetes.io/zone", "")
                if zone:
                    node_zone[obj_util.name_of(node)] = zone
                    zone_capacity[zone] = zone_capacity.get(zone, 0) + cap
            # only pods holding GPUs matter — the ``tpu`` field index
            # (the GPU count; all buckets) replaces the all-pods scan on
            # the cached path
            index_buckets = getattr(self.api, "index_buckets", None)
            buckets = index_buckets("Pod", "tpu") if index_buckets else None
            gpu_pods = (
                [p for pods in buckets.values() for p in pods]
                if buckets is not None
                else self.api.list("Pod")  # uncached-ok: no cache to index  # unbounded-ok: cache-served zero-copy read
            )
            for pod in gpu_pods:
                if obj_util.get_path(pod, "status", "phase") != "Running":
                    continue
                sel = obj_util.get_path(pod, "spec", "nodeSelector", default={}) or {}
                accel = sel.get(GPU_ACCEL_NODE_LABEL)
                if not accel:
                    continue
                zone = node_zone.get(
                    obj_util.get_path(pod, "spec", "nodeName", default="") or "", ""
                )
                for c in obj_util.get_path(pod, "spec", "containers", default=[]) or []:
                    gpus = obj_util.parse_quantity(
                        obj_util.get_path(c, "resources", "limits", GPU_RESOURCE, default=0)
                    )
                    used[accel] = used.get(accel, 0) + gpus
                    if zone:
                        zone_used[zone] = zone_used.get(zone, 0) + gpus
            # suspended sessions hold committed GPUs without occupying
            # inventory — the occupancy panel shows both axes so an
            # oversubscribed pool (committed > capacity) is visible;
            # the ledger definition is shared with JWA and admission
            from odh_kubeflow_tpu_torch.sessions import (
                checkpoint_gpus,
                committed_checkpoints,
            )

            suspended_gpus: dict[str, float] = {}
            suspended_count = 0
            for ck in committed_checkpoints(self.api):
                if obj_util.get_path(ck, "status", "phase") == "Suspended":
                    suspended_count += 1
                accel = obj_util.get_path(ck, "spec", "acceleratorType", default="")
                if accel:
                    suspended_gpus[accel] = suspended_gpus.get(accel, 0) + float(
                        checkpoint_gpus(ck)
                    )
            # utilization (active/allocated GPU-seconds, from the usage
            # ledger) rides next to the instantaneous occupancy: a pool
            # can be 100% occupied and 10% utilized
            util = (
                self.meter.utilization()
                if self.meter is not None
                else {"accelerators": {}, "zones": {}, "pools": {}}
            )
            return success(
                {
                    PANEL: [
                        {
                            "accelerator": accel,
                            CAPACITY: cap,
                            USED: used.get(accel, 0),
                            SUSPENDED: suspended_gpus.get(accel, 0),
                            COMMITTED: used.get(accel, 0) + suspended_gpus.get(accel, 0),
                            "utilizationRatio": util["accelerators"].get(accel),
                        }
                        for accel, cap in sorted(capacity.items())
                    ],
                    "zones": [
                        {
                            "zone": zone,
                            CAPACITY: cap,
                            USED: zone_used.get(zone, 0),
                            "utilizationRatio": util["zones"].get(zone),
                        }
                        for zone, cap in sorted(zone_capacity.items())
                    ],
                    "notebooks": len(self.api.list("Notebook")),  # uncached-ok: count only  # unbounded-ok: cache-served zero-copy read
                    "suspendedSessions": suspended_count,
                }
            )

        @app.route("/api/usage")
        def usage(request):
            """Showback: top-N namespaces by GPU-hours with the
            active/idle split, plus per-zone/pool/accelerator
            utilization — the economics view of the fleet (GPU-hours
            scale with compute demand, not logged-in sessions); 503
            without a meter.
            ``flush=1`` forces a metering tick first (tests and ad-hoc
            curls; the serving cadence otherwise samples in the
            background)."""
            user_of(request)
            if self.meter is None:
                return failure("usage metering not wired", 503)
            if request.query.get("flush"):
                self.meter.poll()
            try:
                top_n = int(request.query.get("top", "10"))
            except ValueError:
                top_n = 10
            return success({"usage": self.meter.summary(top_n=top_n)})

        @app.route("/api/slo")
        def slo(request):
            """Multi-window burn rates per SLO (utils/slo.py): the
            operator's budget view — which objective is burning, how
            fast, over which window. ``tick=1`` forces a fresh sample
            first (tests and ad-hoc curls; the serving cadence
            otherwise samples in the background)."""
            user_of(request)
            if request.query.get("tick"):
                self.slo_engine.tick()
            return success({"slos": self.slo_engine.evaluate()})

        @app.route("/prometheus/metrics")
        def prom(request):
            return Response(
                self.registry.exposition(), content_type="text/plain"
            )


def main() -> None:
    """Split-process entrypoint (manifests/web)."""
    import os

    from odh_kubeflow_tpu_torch.machinery.runner import run_web

    def build(api):
        dash = DashboardApp(api)
        # the entrypoint owns the engine lifecycle (mirrors
        # Platform.start): background sampling so /api/slo has
        # window history without a ?tick on every request
        dash.slo_engine.start(
            interval=float(os.environ.get("SLO_TICK_SECONDS", "15"))
        )
        return dash

    run_web("centraldashboard", 8082, build)


if __name__ == "__main__":
    main()
