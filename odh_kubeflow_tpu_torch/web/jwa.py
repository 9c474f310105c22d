"""Jupyter web app (JWA) backend: the notebook spawner (the port's copy of
the JAX package's ``web/jwa.py``, on GPU node pools).

Reference parity (crud-web-apps/jupyter/backend/apps/): POST flow
(dry-run → PVCs → Notebook) default/routes/post.py:14-73, form
resolution common/form.py:17-252 (readOnly defaults, cpu/mem
limitFactor, tolerationGroup, affinityConfig, configurations,
shm), GET routes common/routes/get.py:9-73, PATCH stop/start
patch.py:18-75, status derivation common/status.py:10-59 (+ error-event
mining), list-row shaping common/utils.py:56-140, live-reloaded admin
config (utils.py:22-53; spawner_ui_config.yaml).

GPU node pools: the JAX package's ``tpus:`` vendor block becomes a
``gpus:`` block — accelerator type + GPU count dropdowns from
``utils/gpu.py`` (the reference's own ``gpus:`` block,
spawner_ui_config.yaml:111-123); ``GET /api/gpus`` intersects the
config's types with live node capacity the way the reference's
/api/gpus does (get.py:52-73); a GPU selection sets the scheduling
annotations the notebook controller consumes plus the ``gpu-runtime``
opt-in label for the PodDefault webhook.

Suspend-on-stop and the resume route (the sessions subsystem), the
detail page's checkpoint and warm-handout blocks and the warm-pool claim
at spawn (warmup) are JAX's, and so is the detail page's usage block,
fed by the GPU-second ledger (``meter``, ``machinery/usage.py``). The
listings go through the CRUD backend's ``listing_response`` (memo,
degraded serving, ``?limit=&continue=`` pages). ``main()`` serves the
app in a process of its own through ``machinery/runner.py``; in-process,
``JupyterWebApp(api).app.serve(host, port)``.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Optional

from odh_kubeflow_tpu_torch.apis import (
    GPU_ACCEL_NODE_LABEL,
    GPU_ACCELERATOR_ANNOTATION,
    GPU_COUNT_ANNOTATION,
    GPU_RESOURCE,
    GPU_RUNTIME_LABEL,
    RESUME_REQUESTED_ANNOTATION,
    STOP_ANNOTATION,
    SUSPEND_REASON_ANNOTATION,
    SUSPENDED_AT_ANNOTATION,
)
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.cache import list_by_index
from odh_kubeflow_tpu_torch.machinery.store import APIServer, NotFound
from odh_kubeflow_tpu_torch.scheduling import OVERSUBSCRIPTION_FACTOR_ANNOTATION
from odh_kubeflow_tpu_torch.sessions import checkpoint_gpus, committed_checkpoints
from odh_kubeflow_tpu_torch.utils.gpu import GPU_ACCELERATORS
from odh_kubeflow_tpu_torch.warmup import (
    CLAIMED_AT_ANNOTATION,
    PREFERRED_POOL_ANNOTATION,
    STANDBY_SOURCE_ANNOTATION,
    WARM_FROM_ANNOTATION,
    warm_source,
)
from odh_kubeflow_tpu_torch.web.crud_backend import (
    CrudBackend,
    failure,
    success,
    user_of,
)

Obj = dict[str, Any]

NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"

DEFAULT_CONFIG: Obj = {
    "spawnerFormDefaults": {
        "image": {
            "value": "kubeflownotebookswg/jupyter-scipy:v1.7.0",
            "options": [
                "kubeflownotebookswg/jupyter-scipy:v1.7.0",
                "kubeflownotebookswg/jupyter-pytorch-cuda-full:v1.7.0",
            ],
        },
        "imageGroupOne": {
            "value": "odh-kubeflow-tpu/codeserver:v0.1.0",
            "options": ["odh-kubeflow-tpu/codeserver:v0.1.0"],
        },
        "imageGroupTwo": {
            "value": "odh-kubeflow-tpu/rstudio:v0.1.0",
            "options": ["odh-kubeflow-tpu/rstudio:v0.1.0"],
        },
        "cpu": {"value": "0.5", "limitFactor": "1.2", "readOnly": False},
        "memory": {"value": "1Gi", "limitFactor": "1.2", "readOnly": False},
        "workspaceVolume": {
            "value": {
                "mount": "/home/jovyan",
                "newPvc": {
                    "metadata": {"name": "{notebook-name}-workspace"},
                    "spec": {
                        "resources": {"requests": {"storage": "10Gi"}},
                        "accessModes": ["ReadWriteOnce"],
                    },
                },
            },
            "readOnly": False,
        },
        "dataVolumes": {"value": [], "readOnly": False},
        # the reference's `gpus:` vendor block: GKE accelerator type and
        # GPU count dropdowns, one row a node-pool type of utils/gpu.py
        "gpus": {
            "value": {"accelerator": "none", "count": ""},
            "accelerators": [
                {
                    "type": t.accelerator,
                    "displayName": t.display_name,
                    "counts": [str(c) for c in t.counts],
                }
                for t in GPU_ACCELERATORS.values()
            ],
            "readOnly": False,
        },
        "tolerationGroup": {
            "value": "",
            "options": [
                {
                    "groupKey": "spot-gpu",
                    "displayName": "Schedule on spot/preemptible GPU nodes",
                    "tolerations": [
                        {
                            "key": "cloud.google.com/gke-spot",
                            "operator": "Equal",
                            "value": "true",
                            "effect": "NoSchedule",
                        }
                    ],
                }
            ],
            "readOnly": False,
        },
        "affinityConfig": {
            "value": "",
            "options": [
                {
                    "configKey": "same-zone",
                    "displayName": "Pack into a single zone",
                    "affinity": {
                        "podAffinity": {
                            "preferredDuringSchedulingIgnoredDuringExecution": [
                                {
                                    "weight": 100,
                                    "podAffinityTerm": {
                                        "labelSelector": {
                                            "matchLabels": {GPU_RUNTIME_LABEL: "enabled"}
                                        },
                                        "topologyKey": (
                                            "topology.kubernetes.io/zone"
                                        ),
                                    },
                                }
                            ]
                        }
                    },
                }
            ],
            "readOnly": False,
        },
        "configurations": {"value": [], "readOnly": False},
        "shm": {"value": True, "readOnly": False},
    }
}


class JupyterWebApp(CrudBackend):
    def __init__(
        self,
        api: APIServer,
        config_path: Optional[str] = None,
        registry=None,
        meter=None,
    ):
        super().__init__(api, "jupyter-web-app", registry=registry)
        # GPU-second ledger (machinery.usage.UsageMeter): the detail
        # page's per-notebook usage block; None degrades to no block
        self.meter = meter
        # without the sessions subsystem a suspend request would stamp
        # annotations nobody serves — the UI must not promise warm
        # state that can never exist
        self.sessions_enabled = (
            os.environ.get("ENABLE_SESSION_SUSPEND", "true").lower() == "true"
        )
        # warm-pool handout (warmup/ subsystem): spawn tries to claim a
        # pre-admitted standby before the cold path. Harmless without
        # pools (the claim simply finds none); the flag exists for
        # operators who want cold spawns even with pools present.
        self.warm_enabled = os.environ.get("WARM_POOL_ENABLED", "true").lower() == "true"
        self.config_path = config_path
        self._config_mtime: Optional[float] = None
        self._config = copy.deepcopy(DEFAULT_CONFIG)
        self._register_routes()

    # -- config (live reload per request, utils.py:22-53) --------------------

    def config(self) -> Obj:
        if self.config_path:
            import yaml

            try:
                mtime = os.path.getmtime(self.config_path)
                if mtime != self._config_mtime:
                    with open(self.config_path) as f:
                        self._config = yaml.safe_load(f)
                    self._config_mtime = mtime
            except OSError:
                pass
        return self._config

    def form_defaults(self) -> Obj:
        return self.config().get("spawnerFormDefaults", {})

    # -- routes --------------------------------------------------------------

    def _register_routes(self) -> None:
        app = self.app

        # config + GPU inventory are authn-only: the spawner form needs
        # them before any namespace is chosen, and node capacity is read
        # with the backend's own privileges (reference /api/gpus,
        # get.py:52-73, likewise guards with authentication only)
        @app.route("/api/config")
        def get_config(request):
            user_of(request)
            return success({"config": self.form_defaults()})

        @app.route("/api/gpus")
        def get_gpus(request):
            user_of(request)
            return success({"gpus": self.available_gpus()})

        @app.route("/api/namespaces/<namespace>/gpus")
        def get_namespace_gpus(request, namespace):
            """The spawner's namespaced view: GPU inventory plus the
            profile's GPU quota (used/hard, mirrored onto the
            ResourceQuota status by the kubelet ledger) so the form can
            show 'GPUs: 8 of 16 used' before the user picks a count."""
            self.authorize(request, "list", "resourcequotas", namespace)
            return success(
                {
                    "gpus": self.available_gpus(),
                    "quota": self.gpu_quota(namespace),
                }
            )

        @app.route("/api/namespaces/<namespace>/notebooks")
        def list_notebooks(request, namespace):
            self.authorize(request, "list", "notebooks", namespace, "kubeflow.org")

            def build_rows():
                # one LAZY event pass shared by the whole listing: ready
                # rows mine nothing, so an all-ready listing pays none
                memo: list[dict] = []

                def events():
                    if not memo:
                        memo.append(self._warning_events_by_owner(namespace))
                    return memo[0]

                return [
                    self.notebook_row(nb, events=events)
                    for nb in self.api.list("Notebook", namespace=namespace)  # unbounded-ok: cache-served zero-copy read
                ]

            return self.listing_response(  # contract-ok: kube 410 pagination contract — a stale continue token answers 410 Expired and the client restarts its walk from a fresh first page
                "notebooks",
                ("notebooks", namespace),
                build_rows,
                request,
                # the full read set: rows derive queue position from
                # Workloads and warning messages from Events, so the
                # listing memo must key on their versions too
                kinds=("Notebook", "Workload", "Event"),
            )

        @app.route("/api/namespaces/<namespace>/notebooks", methods=["POST"])
        def post_notebook(request, namespace):
            user = self.authorize(
                request, "create", "notebooks", namespace, "kubeflow.org"
            )
            body = request.json or {}
            return self.create_notebook(namespace, body, user)

        @app.route(
            "/api/namespaces/<namespace>/notebooks/<name>", methods=["GET"]
        )
        def get_notebook(request, namespace, name):
            self.authorize(request, "get", "notebooks", namespace, "kubeflow.org")
            nb = self.api.get("Notebook", name, namespace)
            return success({"notebook": nb})

        @app.route(
            "/api/namespaces/<namespace>/notebooks/<name>/details",
            methods=["GET"],
        )
        def notebook_details(request, namespace, name):
            """The detail-page feed (reference: the notebook detail
            page's OVERVIEW tab): parsed spec + mirrored CONDITIONS +
            the live pod family, one request."""
            self.authorize(request, "get", "notebooks", namespace, "kubeflow.org")
            nb = self.api.get("Notebook", name, namespace)
            container = obj_util.get_path(
                nb, "spec", "template", "spec", "containers", 0, default={}
            ) or {}
            # the notebook's own pod family via the statefulset label
            pods = [
                {
                    "name": obj_util.name_of(p),
                    "phase": obj_util.get_path(
                        p, "status", "phase", default=""
                    ),
                    "node": obj_util.get_path(
                        p, "spec", "nodeName", default=""
                    ),
                }
                for p in list_by_index(
                    self.api,
                    "Pod",
                    "label:statefulset",
                    name,
                    namespace=namespace,
                    fallback_selector={"matchLabels": {"statefulset": name}},
                )
            ]
            return success({
                "details": {
                    **self.notebook_row(nb),
                    "conditions": obj_util.get_path(
                        nb, "status", "conditions", default=[]
                    )
                    or [],
                    "containerState": obj_util.get_path(
                        nb, "status", "containerState", default={}
                    )
                    or {},
                    "volumes": [
                        {
                            "name": v.get("name", ""),
                            "mountPath": next(
                                (
                                    m.get("mountPath", "")
                                    for m in container.get(
                                        "volumeMounts", []
                                    )
                                    if m.get("name") == v.get("name")
                                ),
                                "",
                            ),
                            "pvc": obj_util.get_path(
                                v, "persistentVolumeClaim", "claimName",
                                default="",
                            ),
                        }
                        for v in obj_util.get_path(
                            nb, "spec", "template", "spec", "volumes",
                            default=[],
                        )
                        or []
                    ],
                    "pods": pods,
                    "annotations": obj_util.annotations_of(nb),
                    "workload": self._workload_row(nb),
                    "checkpoint": self._checkpoint_row(nb),
                    "warm": self._warm_row(nb),
                    "usage": (
                        self.meter.notebook_usage(namespace, name)
                        if self.meter is not None
                        else None
                    ),
                }
            })

        @app.route(
            "/api/namespaces/<namespace>/notebooks/<name>/events",
            methods=["GET"],
        )
        def notebook_events(request, namespace, name):
            """The detail drawer's feed: events involving the Notebook
            CR itself (the controller re-emits owned STS/Pod events
            onto it) plus any raw events from its child resources,
            newest first."""
            self.authorize(request, "get", "notebooks", namespace, "kubeflow.org")
            return success({
                "events": self.event_rows(
                    namespace,
                    lambda inv: _event_belongs_to_notebook(inv, name),
                )
            })

        @app.route(
            "/api/namespaces/<namespace>/notebooks/<name>", methods=["PATCH"]
        )
        def patch_notebook(request, namespace, name):
            self.authorize(
                request, "update", "notebooks", namespace, "kubeflow.org"
            )
            body = request.json or {}
            stopped = body.get("stopped")
            if stopped is None:
                return failure("body must set 'stopped': true|false", 400)
            now = obj_util.now_rfc3339()
            if stopped:
                annotations: Obj = {STOP_ANNOTATION: now}
                if body.get("suspend") and self.sessions_enabled:
                    # user-requested suspend: keep the kernel as a
                    # checkpoint instead of a cold stop. Idempotent —
                    # a duplicate suspend must NOT open a new epoch
                    # (that would resurrect the pods and overwrite the
                    # durable checkpoint with a fresh kernel's nothing)
                    nb = self.api.get("Notebook", name, namespace)
                    if SUSPENDED_AT_ANNOTATION not in obj_util.annotations_of(nb):
                        annotations[SUSPENDED_AT_ANNOTATION] = now
                        annotations[SUSPEND_REASON_ANNOTATION] = "user"
            else:
                annotations, _ = self._resume_annotations(namespace, name, now)
            self.api.patch(
                "Notebook", name, {"metadata": {"annotations": annotations}},
                namespace,
            )
            return success()

        @app.route(
            "/api/namespaces/<namespace>/notebooks/<name>/resume",
            methods=["POST"],
        )
        def resume_notebook(request, namespace, name):
            """Explicit resume API (the spawner's CONNECT on a
            suspended row): clear the stop/suspend contract so the
            Workload re-enqueues, and stamp resume-requested-at — the
            session manager's warm-resume histogram measures from this
            instant to state-restored-in-pod."""
            self.authorize(request, "update", "notebooks", namespace, "kubeflow.org")
            annotations, warm = self._resume_annotations(
                namespace, name, obj_util.now_rfc3339()
            )
            self.api.patch(
                "Notebook", name, {"metadata": {"annotations": annotations}}, namespace
            )
            return success({"resume": "warm" if warm else "cold"})

        @app.route(
            "/api/namespaces/<namespace>/notebooks/<name>", methods=["DELETE"]
        )
        def delete_notebook(request, namespace, name):
            self.authorize(
                request, "delete", "notebooks", namespace, "kubeflow.org"
            )
            self.api.delete("Notebook", name, namespace)
            return success()

        @app.route("/api/namespaces/<namespace>/pvcs")
        def list_pvcs(request, namespace):
            self.authorize(request, "list", "persistentvolumeclaims", namespace)
            return self.listing_response(  # contract-ok: kube 410 pagination contract — a stale continue token answers 410 Expired and the client restarts its walk from a fresh first page
                "pvcs",
                ("pvcs", namespace),
                lambda: self.api.list("PersistentVolumeClaim", namespace=namespace),  # unbounded-ok: cache-served zero-copy read
                request,
                kinds=("PersistentVolumeClaim",),
            )

        @app.route("/api/namespaces/<namespace>/poddefaults")
        def list_poddefaults(request, namespace):
            self.authorize(
                request, "list", "poddefaults", namespace, "kubeflow.org"
            )
            pds = [
                {
                    "label": obj_util.name_of(pd),
                    "desc": (pd.get("spec") or {}).get(
                        "desc", obj_util.name_of(pd)
                    ),
                    "selector": (pd.get("spec") or {}).get("selector", {}),
                }
                for pd in self.api.list("PodDefault", namespace=namespace)  # unbounded-ok: cache-served zero-copy read
            ]
            return success({"poddefaults": pds})

    # -- GPU inventory -------------------------------------------------------

    def available_gpus(self) -> list[Obj]:
        """config accelerators ∩ cluster node capacity (get.py:52-73):
        a type the cluster has a node pool of, with the counts some one
        pool of that type can hold (a gang's nodes share one pool)."""
        pool_gpus: dict[tuple[str, str], int] = {}
        for node in self.api.list("Node"):  # uncached-ok: cluster inventory  # unbounded-ok: cache-served zero-copy read
            labels = obj_util.labels_of(node)
            accel = labels.get(GPU_ACCEL_NODE_LABEL)
            capacity = obj_util.get_path(
                node, "status", "capacity", GPU_RESOURCE, default=None
            )
            if accel and capacity:
                key = (accel, labels.get(NODEPOOL_LABEL, obj_util.name_of(node)))
                pool_gpus[key] = pool_gpus.get(key, 0) + int(
                    obj_util.parse_quantity(capacity)
                )
        largest: dict[str, int] = {}
        for (accel, _pool), gpus in pool_gpus.items():
            largest[accel] = max(largest.get(accel, 0), gpus)
        out = []
        for accel_cfg in self.form_defaults().get("gpus", {}).get(
            "accelerators", []
        ):
            atype = accel_cfg.get("type", "")
            if atype in largest:
                out.append(
                    {
                        "type": atype,
                        "displayName": accel_cfg.get("displayName", atype),
                        "counts": [
                            c
                            for c in accel_cfg.get("counts", [])
                            if int(c) <= largest[atype]
                        ],
                    }
                )
        return out

    def gpu_quota(self, namespace: str) -> Optional[Obj]:
        """used/hard GPUs for the namespace's quota, or None when the
        profile is unlimited. Prefers the mirrored status (live ledger);
        falls back to spec.hard with used=0 before the first kubelet
        sync."""
        for quota in self.api.list("ResourceQuota", namespace=namespace):  # unbounded-ok: cache-served zero-copy read
            for key in (f"requests.{GPU_RESOURCE}", GPU_RESOURCE):
                hard = obj_util.get_path(
                    quota, "status", "hard", key,
                    default=obj_util.get_path(quota, "spec", "hard", key),
                )
                if hard is None:
                    continue
                used = obj_util.get_path(
                    quota, "status", "used", key, default="0"
                )
                row = {
                    "resource": key,
                    "hard": str(hard),
                    "used": str(used),
                }
                factor = obj_util.annotations_of(quota).get(
                    OVERSUBSCRIPTION_FACTOR_ANNOTATION
                )
                try:
                    factor_f = float(factor) if factor else 1.0
                except ValueError:
                    factor_f = 1.0
                if factor_f > 1.0:
                    # oversubscribed pool: surface the committed-session
                    # view next to the physical one so the spawner can
                    # say "4 of 8 GPUs running, 12 of 16 committed"
                    suspended = sum(
                        checkpoint_gpus(ck)
                        for ck in committed_checkpoints(self.api, namespace=namespace)
                    )
                    cap = int(obj_util.parse_quantity(hard) * factor_f)
                    row.update(
                        {
                            "oversubscriptionFactor": f"{factor_f:g}",
                            "sessionCap": str(cap),
                            "committed": str(
                                int(obj_util.parse_quantity(used)) + suspended
                            ),
                            "suspended": str(suspended),
                        }
                    )
                return row
        return None

    def _workload_of(self, nb: Obj) -> Optional[Obj]:
        try:
            return self.api.get(
                "Workload", obj_util.name_of(nb), obj_util.namespace_of(nb)
            )
        except NotFound:  # no workload, or scheduling not installed
            return None

    def _resume_annotations(self, namespace: str, name: str, now: str) -> tuple[Obj, bool]:
        """The start/resume merge-patch plus whether the resume is
        warm (one read decides both): clears the stop/suspend contract;
        a notebook that was suspended (not plain-stopped) additionally
        gets resume-requested-at so the warm-resume latency is measured
        from the user's click."""
        warm = False
        try:
            nb = self.api.get("Notebook", name, namespace)
            warm = SUSPENDED_AT_ANNOTATION in obj_util.annotations_of(nb)
        except NotFound:
            pass
        annotations: Obj = {
            STOP_ANNOTATION: None,
            SUSPENDED_AT_ANNOTATION: None,
            SUSPEND_REASON_ANNOTATION: None,
        }
        if warm:
            annotations[RESUME_REQUESTED_ANNOTATION] = now
        return annotations, warm

    def _checkpoint_row(self, nb: Obj) -> Optional[Obj]:
        """The detail page's durability block: where the session's
        checkpoint bytes live (which zones) and whether replication is
        degraded — the user-visible half of the zone-replication
        contract."""
        try:
            ck = self.api.get(
                "SessionCheckpoint", obj_util.name_of(nb), obj_util.namespace_of(nb)
            )
        except NotFound:  # never suspended, or sessions not installed
            return None
        status = ck.get("status") or {}
        row: Obj = {
            "phase": status.get("phase", ""),
            "digest": status.get("digest", ""),
            "sizeBytes": status.get("sizeBytes", 0),
            "suspendedAt": status.get("suspendedAt", ""),
        }
        if "zones" in status:
            row["zones"] = status.get("zones") or []
            row["replicationDegraded"] = bool(status.get("replicationDegraded"))
        return row

    def _warm_row(self, nb: Obj) -> Optional[Obj]:
        """Warm-handout provenance: which pool served this notebook and
        whether the pre-warmed session state has been restored into it
        yet (checkpoint phase reaches Restored once the session manager
        replays the template state)."""
        src = warm_source(nb)
        if src is None:
            return None
        restored = False
        try:
            ck = self.api.get(
                "SessionCheckpoint", obj_util.name_of(nb), obj_util.namespace_of(nb)
            )
            restored = obj_util.get_path(ck, "status", "phase", default="") == "Restored"
        except NotFound:
            pass
        return {**src, "restored": restored}

    def _workload_row(self, nb: Obj) -> Optional[Obj]:
        """The detail page's admission block: lifecycle timestamps feed
        the spawn-latency breakdown (queue wait vs scheduling vs
        container start)."""
        wl = self._workload_of(nb)
        if wl is None:
            return None
        status = wl.get("status") or {}
        spec = wl.get("spec") or {}
        return {
            "state": status.get("state", "Pending"),
            "position": status.get("position", 0),
            "reason": status.get("reason", ""),
            "message": status.get("message", ""),
            "queuedAt": status.get("queuedAt", ""),
            "admittedAt": status.get("admittedAt", ""),
            "assignment": status.get("assignment"),
            "priority": spec.get("priority", 0),
            "priorityClassName": spec.get("priorityClassName", ""),
            "nodes": spec.get("nodes", 0),
            "gpus": spec.get("gpus", 0),
        }

    # -- form → Notebook (form.py:17-252) ------------------------------------

    def _resolve(self, body: Obj, field: str):
        """readOnly fields always take the admin default (form.py:17-60)."""
        defaults = self.form_defaults()
        cfg = defaults.get(field, {})
        if cfg.get("readOnly"):
            return cfg.get("value")
        if field in body:
            return body[field]
        return cfg.get("value")

    def create_notebook(self, namespace: str, body: Obj, user: str):
        name = body.get("name", "")
        if not name:
            return failure("notebook name is required", 400)

        image = self._resolve(body, "image")
        cpu = str(self._resolve(body, "cpu"))
        memory = str(self._resolve(body, "memory"))
        defaults = self.form_defaults()
        cpu_limit = _apply_limit_factor(cpu, defaults.get("cpu", {}))
        mem_limit = _apply_limit_factor(memory, defaults.get("memory", {}))

        container: Obj = {
            "name": name,
            "image": image,
            "resources": {
                "requests": {"cpu": cpu, "memory": memory},
                "limits": {"cpu": cpu_limit, "memory": mem_limit},
            },
            "volumeMounts": [],
            "env": [],
        }
        pod_spec: Obj = {"containers": [container], "volumes": []}
        labels: dict[str, str] = {"app": name}
        annotations: dict[str, str] = {}

        for config_name in self._resolve(body, "configurations") or []:
            labels[config_name] = "true"

        gpu = self._resolve(body, "gpus") or {}
        accelerator = gpu.get("accelerator", "none")
        if accelerator and accelerator != "none":
            annotations[GPU_ACCELERATOR_ANNOTATION] = accelerator
            if gpu.get("count"):
                annotations[GPU_COUNT_ANNOTATION] = str(gpu["count"])
            labels[GPU_RUNTIME_LABEL] = "enabled"  # PodDefault opt-in

        # tolerationGroup / affinityConfig: admin-defined groups applied
        # by key (reference form.py:179-223)
        group_key = self._resolve(body, "tolerationGroup")
        if group_key and group_key != "none":  # "none" = upstream sentinel
            for opt in defaults.get("tolerationGroup", {}).get("options", []):
                if opt.get("groupKey") == group_key:
                    pod_spec["tolerations"] = obj_util.deepcopy(
                        opt.get("tolerations", [])
                    )
                    break
            else:
                return failure(f"unknown tolerationGroup {group_key!r}", 400)
        affinity_key = self._resolve(body, "affinityConfig")
        if affinity_key and affinity_key != "none":
            for opt in defaults.get("affinityConfig", {}).get("options", []):
                if opt.get("configKey") == affinity_key:
                    pod_spec["affinity"] = obj_util.deepcopy(
                        opt.get("affinity", {})
                    )
                    break
            else:
                return failure(f"unknown affinityConfig {affinity_key!r}", 400)

        if self._resolve(body, "shm"):
            pod_spec["volumes"].append(
                {"name": "dshm", "emptyDir": {"medium": "Memory"}}
            )
            container["volumeMounts"].append(
                {"name": "dshm", "mountPath": "/dev/shm"}
            )

        notebook: Obj = {
            "apiVersion": "kubeflow.org/v1beta1",
            "kind": "Notebook",
            "metadata": {
                "name": name,
                "namespace": namespace,
                "labels": labels,
                "annotations": annotations,
            },
            "spec": {
                "template": {
                    "metadata": {"labels": dict(labels)},
                    "spec": pod_spec,
                }
            },
        }

        # dry-run first so form errors surface before PVCs exist
        self.api.create(notebook, dry_run=True)

        pvcs: list[Obj] = []
        workspace = self._resolve(body, "workspaceVolume")
        if workspace:
            pvcs.append(self._attach_volume(notebook, workspace, name))
        for vol in self._resolve(body, "dataVolumes") or []:
            pvcs.append(self._attach_volume(notebook, vol, name))
        for pvc in pvcs:
            if pvc is not None:
                try:
                    self.api.create(pvc)
                except Exception as e:  # AlreadyExists → reuse
                    if "exists" not in str(e):
                        raise

        # warm-pool handout (warmup/): claim a ready standby matching
        # (accelerator, GPU count, image). The claim is an atomic
        # conditional update — concurrent spawns racing for the last
        # standby get exactly one winner; a miss falls through to the
        # ordinary cold spawn. The standby is deleted so its freed GPUs
        # (pre-pulled image, warm node) are exactly where the new gang
        # lands via the preferred-pool hint.
        if self.warm_enabled and accelerator and accelerator != "none":
            from odh_kubeflow_tpu_torch.warmup.pool import claim_standby

            warm = claim_standby(
                self.api,
                namespace,
                accelerator=accelerator,
                count=str(gpu.get("count", "") or ""),
                image=image,
                claimant=f"{user or 'spawner'}/{name}",
            )
            if warm is not None:
                annotations[WARM_FROM_ANNOTATION] = warm["pool"]
                annotations[STANDBY_SOURCE_ANNOTATION] = warm["standby"]
                annotations[CLAIMED_AT_ANNOTATION] = warm["claimedAt"]
                if warm.get("nodePool"):
                    annotations[PREFERRED_POOL_ANNOTATION] = warm["nodePool"]
                try:
                    self.api.delete("Notebook", warm["standby"], namespace)
                except NotFound:
                    pass  # pool controller reaped it first

        created = self.api.create(notebook)
        return success({"notebook": obj_util.name_of(created)}, status=201)

    def _attach_volume(
        self, notebook: Obj, volume: Obj, nb_name: str
    ) -> Optional[Obj]:
        mount = volume.get("mount", "/home/jovyan")
        pod_spec = notebook["spec"]["template"]["spec"]
        container = pod_spec["containers"][0]
        if "existingSource" in volume:
            claim = obj_util.get_path(
                volume, "existingSource", "persistentVolumeClaim", "claimName"
            )
            vol_name = f"existing-{claim}"
            pod_spec["volumes"].append(
                {
                    "name": vol_name,
                    "persistentVolumeClaim": {"claimName": claim},
                }
            )
            container["volumeMounts"].append(
                {"name": vol_name, "mountPath": mount}
            )
            return None
        new_pvc = obj_util.deepcopy(volume.get("newPvc") or {})
        pvc_name = (
            obj_util.get_path(new_pvc, "metadata", "name", default="")
            or f"{nb_name}-volume"
        ).replace("{notebook-name}", nb_name)
        new_pvc.setdefault("apiVersion", "v1")
        new_pvc["kind"] = "PersistentVolumeClaim"
        new_pvc.setdefault("metadata", {})["name"] = pvc_name
        new_pvc["metadata"]["namespace"] = obj_util.namespace_of(notebook)
        pod_spec["volumes"].append(
            {
                "name": pvc_name,
                "persistentVolumeClaim": {"claimName": pvc_name},
            }
        )
        container["volumeMounts"].append(
            {"name": pvc_name, "mountPath": mount}
        )
        return new_pvc

    # -- list rows + status (utils.py:56-140, status.py:10-59) ---------------

    def notebook_row(self, nb: Obj, events: Optional[Any] = None) -> Obj:
        container = obj_util.get_path(
            nb, "spec", "template", "spec", "containers", 0, default={}
        ) or {}
        ann = obj_util.annotations_of(nb)
        gpus = None
        accel = ann.get(GPU_ACCELERATOR_ANNOTATION)
        if accel:
            count = ann.get(GPU_COUNT_ANNOTATION, "")
            known = GPU_ACCELERATORS.get(accel)
            # the GPU count of the request (a missing count takes the
            # type's smallest); the controller owns the per-node
            # nvidia.com/gpu limits on the StatefulSet
            total = count or (str(known.counts[0]) if known else "")
            gpus = {"accelerator": accel, "count": count, "gpus": total}
        return {
            "name": obj_util.name_of(nb),
            "namespace": obj_util.namespace_of(nb),
            "image": container.get("image", ""),
            "shortImage": (container.get("image", "").split("/")[-1]),
            "cpu": obj_util.get_path(
                container, "resources", "requests", "cpu", default=""
            ),
            "memory": obj_util.get_path(
                container, "resources", "requests", "memory", default=""
            ),
            "gpus": gpus,
            "status": self.notebook_status(nb, events=events),
            "age": obj_util.meta(nb).get("creationTimestamp", ""),
        }

    def notebook_status(self, nb: Obj, events: Optional[Any] = None) -> Obj:
        """stopped/suspended/resuming/terminating/waiting/running +
        error-event mining. Suspended is NOT stopped: the session
        survives as a checkpoint and resumes warm."""
        ann = obj_util.annotations_of(nb)
        if obj_util.meta(nb).get("deletionTimestamp"):
            return {"phase": "terminating", "message": "Deleting this notebook"}
        session_phase = obj_util.get_path(nb, "status", "phase", default="")
        if STOP_ANNOTATION in ann:
            if SUSPENDED_AT_ANNOTATION in ann:
                if session_phase == "Suspending":
                    return {
                        "phase": "suspending",
                        "message": (
                            "Checkpointing session state before "
                            "releasing the GPUs"
                        ),
                    }
                return {
                    "phase": "suspended",
                    "message": (
                        "Session suspended to checkpoint; resume to "
                        "restore it warm"
                    ),
                }
            return {"phase": "stopped", "message": "No Pods are currently running"}
        ready = obj_util.get_path(nb, "status", "readyReplicas", default=0)
        if session_phase == "Resuming":
            return {
                "phase": "resuming",
                "message": "Restoring session state from checkpoint",
            }
        if ready and ready > 0:
            return {"phase": "ready", "message": "Running"}
        wl = self._workload_of(nb)
        if wl is not None and obj_util.get_path(
            wl, "status", "state", default=""
        ) not in ("", "Admitted"):
            # queued, not broken: position + the human-readable reason
            # (quota exhausted vs no matching pool vs behind a
            # higher-priority workload)
            position = obj_util.get_path(wl, "status", "position", default=0)
            reason = obj_util.get_path(
                wl, "status", "message",
                default=obj_util.get_path(wl, "status", "reason", default=""),
            )
            return {
                "phase": "waiting",
                "message": f"Queued (position {position}): {reason}",
                "queuePosition": position,
            }
        error_event = self._find_error_event(nb, events=events)
        if error_event:
            return {"phase": "warning", "message": error_event}
        return {"phase": "waiting", "message": "Starting"}

    def _warning_events_by_owner(self, ns: str) -> dict:
        """One pass over a namespace's Warning events, pre-bucketed by
        the notebook name each would belong to under the
        ``_event_belongs_to_notebook`` rules — so a listing request
        mines error events in O(rows + events) instead of every
        non-ready row rescanning the namespace. Two buckets preserve
        the scan's exact precedence: ``notebook`` keeps the FIRST
        Notebook-kind exact-name Warning (the scan returns on it),
        ``family`` the LAST family-rule match (the scan's running
        fallback)."""
        notebook_first: dict[str, str] = {}
        family_last: dict[str, str] = {}
        for event in self.api.list("Event", namespace=ns):  # unbounded-ok: cache-served zero-copy read
            if event.get("type") != "Warning":
                continue
            involved = event.get("involvedObject", {})
            kind = involved.get("kind", "")
            iname = involved.get("name", "")
            if not iname:
                continue
            msg = event.get("message", event.get("reason", ""))
            if kind == "Notebook":
                notebook_first.setdefault(iname, msg)
                continue
            # reverse of the per-row suffix rules: which notebook name
            # would claim this event?
            family_last[iname] = msg  # exact-name rule, any kind
            if kind == "Pod":
                m = re.fullmatch(r"(.+)-\d+", iname)
                if m:
                    family_last[m.group(1)] = msg
            elif kind == "PersistentVolumeClaim" and iname.endswith(
                "-workspace"
            ):
                family_last[iname[: -len("-workspace")]] = msg
        return {"notebook": notebook_first, "family": family_last}

    def _find_error_event(
        self, nb: Obj, events: Optional[Any] = None
    ) -> Optional[str]:
        """CR events first (the controller re-emits owned STS/Pod events
        onto the Notebook), then raw namespace-event mining as fallback
        for anything the mirror missed."""
        name = obj_util.name_of(nb)
        ns = obj_util.namespace_of(nb)
        if events is not None:
            # listing path: one shared (lazily built) bucketing of this
            # namespace's Warnings replaces the per-row rescan, exact
            # precedence preserved
            buckets = events() if callable(events) else events
            if name in buckets["notebook"]:
                return buckets["notebook"][name]
            return buckets["family"].get(name)
        fallback: Optional[str] = None
        for event in self.api.list("Event", namespace=ns):  # unbounded-ok: cache-served zero-copy read
            if event.get("type") != "Warning":
                continue
            involved = event.get("involvedObject", {})
            iname = involved.get("name", "")
            if involved.get("kind") == "Notebook" and iname == name:
                return event.get("message", event.get("reason", ""))
            if _event_belongs_to_notebook(involved, name):
                fallback = event.get("message", event.get("reason", ""))
        return fallback


def _event_belongs_to_notebook(involved: Obj, name: str) -> bool:
    """Match an event's involvedObject to a notebook's owned-resource
    family: the CR/STS/Service share its exact name, *Pods* append an
    ordinal (``name-0``), the workspace *PVC* appends ``-workspace``.
    The suffix rules are kind-gated because names alone are ambiguous:
    a bare ``name-`` prefix match would swallow a SIBLING notebook
    called ``name-2`` (kind Notebook/StatefulSet — rejected) while the
    pod ``name-2`` of THIS notebook (kind Pod — accepted) keeps its
    events. The drawer must never show another server's crashes."""
    kind = involved.get("kind", "")
    iname = involved.get("name", "")
    if iname == name:
        return True
    suffix = iname[len(name):] if iname.startswith(name) else ""
    if kind == "Pod" and re.fullmatch(r"-\d+", suffix):
        return True
    return kind == "PersistentVolumeClaim" and suffix == "-workspace"


def _apply_limit_factor(value: str, cfg: Obj) -> str:
    factor = cfg.get("limitFactor", "none")
    if factor in (None, "none", ""):
        return value
    q = obj_util.parse_quantity(value)
    limit = q * float(factor)
    if value.endswith("Gi"):
        return f"{limit / 2**30:.1f}Gi"
    if value.endswith("Mi"):
        return f"{limit / 2**20:.0f}Mi"
    return f"{limit:g}"



def register_client_kinds(api) -> None:
    """The kinds a JWA reads beyond the CRDs, on a split process's client:
    Workloads (a row's queue position; the listing memo keys on their
    version), SessionCheckpoints (the detail page's checkpoint block) and
    WarmPools (the warm rows). Without them a remote client cannot name
    these kinds: the reads come back empty and the informer cache leaves
    them out, so the listing's pages fall back to a row-count tag."""
    from odh_kubeflow_tpu_torch.scheduling import register_scheduling
    from odh_kubeflow_tpu_torch.sessions import register_sessions
    from odh_kubeflow_tpu_torch.warmup import register_warmup

    register_scheduling(api)
    register_sessions(api)
    register_warmup(api)


def main() -> None:
    """Split-process entrypoint (manifests/web)."""
    import os

    from odh_kubeflow_tpu_torch.machinery.runner import run_web

    run_web(
        "jupyter-web-app",
        5000,
        lambda api: JupyterWebApp(api, config_path=os.environ.get("UI_CONFIG")),
        register=register_client_kinds,
    )


if __name__ == "__main__":
    main()
