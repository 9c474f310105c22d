"""tensorboard-controller: Tensorboard CR → Deployment + Service + route
(the port's copy of the JAX package's ``controllers/tensorboard.py``).

Reference parity (components/tensorboard-controller/controllers/
tensorboard_controller.go): Reconcile :67-149, generateDeployment
:159-284 (image from TENSORBOARD_IMAGE :164, gs:// secret mount
:224-239, RWO-PVC co-scheduling affinity :199-223 + :408-451 gated by
RWO_PVC_SCHEDULING :456-466), logspath parsing :360-390, VirtualService
with 300s timeout :306-358.

The path the port drives end to end is ``pvc://``: a notebook captures
its profile on the card (``utils/profiling.py`` on ``torch.profiler``)
into ``<logdir>/plugins/profile/<session>/<host>.pt.trace.json.gz`` on
a PVC, and the Deployment here mounts that PVC and serves the subpath.
The default image (``images/tensorboard-pytorch/``: TensorBoard with
its profile plugin and the PyTorch profiler's plugin, which index that
file name) and ``--load_fast=false`` (the plugins' Python loader) are
what let TensorBoard show those traces; ``TENSORBOARD_IMAGE`` overrides
the image. ``gs://`` logdirs use workload identity (the namespace
``default-editor`` KSA from the profile controller) instead of
mounting a ``user-gcp-sa`` key secret; the reference's secret mount
remains as a fallback when the annotation asks for it. ``main()``
runs the controller in a process of its own through
``machinery/runner.py``.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from odh_kubeflow_tpu_torch.controllers import reconcilehelper
from odh_kubeflow_tpu_torch.controllers.runtime import Manager, Request, Result
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.cache import list_by_index
from odh_kubeflow_tpu_torch.machinery.events import EventRecorder
from odh_kubeflow_tpu_torch.machinery.objects import mutable
from odh_kubeflow_tpu_torch.machinery.store import APIServer, NotFound

Obj = dict[str, Any]

DEFAULT_IMAGE = "odh-kubeflow-tpu/tensorboard-pytorch:latest"
GCP_SA_SECRET_ANNOTATION = "tensorboards.kubeflow.org/gcp-sa-secret"


class TensorboardController:
    def __init__(self, api: APIServer):
        self.api = api
        self.image = os.environ.get("TENSORBOARD_IMAGE", DEFAULT_IMAGE)
        self.rwo_scheduling = (
            os.environ.get("RWO_PVC_SCHEDULING", "true").lower() == "true"
        )
        self.recorder = EventRecorder(api, "tensorboard-controller")

    def register(self, mgr: Manager) -> None:
        ctrl = mgr.new_controller(
            "tensorboard-controller", "Tensorboard", self.reconcile
        )
        ctrl.owns("Deployment").owns("Service").owns("HTTPRoute")

    def reconcile(self, req: Request) -> Result:
        try:
            # mutable(): _mirror_status writes onto the in-hand object
            tb = mutable(self.api.get("Tensorboard", req.name, req.namespace))
        except NotFound:
            return Result()
        deployment = self.generate_deployment(tb)
        try:
            _, created = reconcilehelper.reconcile_object(
                self.api, deployment, owner=tb
            )
            if created:
                self.recorder.normal(
                    tb, "Created", f"Created Deployment {req.name}"
                )
        except Exception as e:
            try:
                self.api.get("Deployment", req.name, req.namespace)
            except NotFound:
                self.recorder.warning(
                    tb,
                    "FailedCreate",
                    f"Failed to create Deployment {req.name}: {e}",
                )
            raise
        service = self.generate_service(tb)
        reconcilehelper.reconcile_object(self.api, service, owner=tb)
        route = self.generate_route(tb)
        reconcilehelper.reconcile_object(self.api, route, owner=tb)
        self._mirror_status(tb)
        return Result()

    # -- logspath parsing (:360-390) ----------------------------------------

    @staticmethod
    def parse_logspath(path: str) -> dict[str, str]:
        if path.startswith("pvc://"):
            rest = path[len("pvc://") :]
            pvc, _, sub = rest.partition("/")
            return {"kind": "pvc", "pvc": pvc, "subpath": sub}
        if path.startswith("gs://"):
            return {"kind": "gcs", "path": path}
        if path.startswith("s3://"):
            return {"kind": "s3", "path": path}
        return {"kind": "local", "path": path}

    # -- generators ---------------------------------------------------------

    def generate_deployment(self, tb: Obj) -> Obj:
        name = obj_util.name_of(tb)
        ns = obj_util.namespace_of(tb)
        logspath = obj_util.get_path(tb, "spec", "logspath", default="")
        parsed = self.parse_logspath(logspath)

        container: Obj = {
            "name": "tensorboard",
            "image": self.image,
            "command": ["/usr/local/bin/tensorboard"],
            "args": [
                f"--logdir={logspath}",
                "--bind_all",
                "--port=6006",
                # the profile plugins' Python loader: the notebooks'
                # torch.profiler traces (utils/profiling.py)
                "--load_fast=false",
            ],
            "ports": [{"containerPort": 6006, "name": "http", "protocol": "TCP"}],
            "resources": {
                "requests": {"cpu": "250m", "memory": "1Gi"},
                "limits": {"cpu": "2", "memory": "4Gi"},
            },
        }
        pod_spec: Obj = {"containers": [container]}

        if parsed["kind"] == "pvc":
            container["args"][0] = "--logdir=/logs/" + parsed["subpath"]
            container["volumeMounts"] = [{"name": "logs", "mountPath": "/logs"}]
            pod_spec["volumes"] = [
                {
                    "name": "logs",
                    "persistentVolumeClaim": {"claimName": parsed["pvc"]},
                }
            ]
            if self.rwo_scheduling:
                affinity = self._rwo_affinity(ns, parsed["pvc"])
                if affinity:
                    pod_spec["affinity"] = affinity
        elif parsed["kind"] == "gcs":
            # workload identity first; key-secret fallback by annotation
            pod_spec["serviceAccountName"] = "default-editor"
            # protocol-ok: user-set on the Tensorboard; no package writer
            secret = obj_util.annotations_of(tb).get(GCP_SA_SECRET_ANNOTATION)
            if secret:
                container["volumeMounts"] = [
                    {"name": "gcp-creds", "mountPath": "/secret", "readOnly": True}
                ]
                container.setdefault("env", []).append(
                    {
                        "name": "GOOGLE_APPLICATION_CREDENTIALS",
                        "value": "/secret/key.json",
                    }
                )
                pod_spec["volumes"] = [
                    {"name": "gcp-creds", "secret": {"secretName": secret}}
                ]

        labels = {"app": name, "tensorboard": name}
        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": name, "namespace": ns, "labels": dict(labels)},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"tensorboard": name}},
                "template": {
                    "metadata": {"labels": dict(labels)},
                    "spec": pod_spec,
                },
            },
        }

    def _rwo_affinity(self, ns: str, pvc_name: str) -> Optional[Obj]:
        """Co-schedule with the pod already mounting the RWO PVC
        (:199-223,408-451): node affinity to that pod's node."""
        try:
            pvc = self.api.get("PersistentVolumeClaim", pvc_name, ns)
        except NotFound:
            return None
        modes = obj_util.get_path(pvc, "spec", "accessModes", default=[]) or []
        if "ReadWriteMany" in modes:
            return None
        # pods mounting this claim, via the ``pvc`` field index (the
        # uncached fallback still scans only the namespace)
        for pod in list_by_index(
            self.api, "Pod", "pvc", pvc_name, namespace=ns
        ):
            node = obj_util.get_path(pod, "spec", "nodeName")
            if not node:
                continue
            for vol in obj_util.get_path(pod, "spec", "volumes", default=[]) or []:
                claim = obj_util.get_path(vol, "persistentVolumeClaim", "claimName")
                if claim == pvc_name:
                    return {
                        "nodeAffinity": {
                            "requiredDuringSchedulingIgnoredDuringExecution": {
                                "nodeSelectorTerms": [
                                    {
                                        "matchExpressions": [
                                            {
                                                # protocol-ok: kubelet-owned node identity label
                                                "key": "kubernetes.io/hostname",
                                                "operator": "In",
                                                "values": [node],
                                            }
                                        ]
                                    }
                                ]
                            }
                        }
                    }
        return None

    def generate_service(self, tb: Obj) -> Obj:
        name = obj_util.name_of(tb)
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": name,
                "namespace": obj_util.namespace_of(tb),
            },
            "spec": {
                "type": "ClusterIP",
                "selector": {"tensorboard": name},
                "ports": [
                    {
                        "name": "http-tb",
                        "port": 80,
                        "targetPort": 6006,
                        "protocol": "TCP",
                    }
                ],
            },
        }

    def generate_route(self, tb: Obj) -> Obj:
        name = obj_util.name_of(tb)
        ns = obj_util.namespace_of(tb)
        return {
            "apiVersion": "gateway.networking.k8s.io/v1",
            "kind": "HTTPRoute",
            "metadata": {"name": f"tensorboard-{name}", "namespace": ns},
            "spec": {
                "parentRefs": [{"name": "kubeflow-gateway", "namespace": "kubeflow"}],
                "rules": [
                    {
                        "matches": [
                            {
                                "path": {
                                    "type": "PathPrefix",
                                    "value": f"/tensorboard/{ns}/{name}",
                                }
                            }
                        ],
                        "backendRefs": [{"name": name, "port": 80}],
                        # long profile loads (reference VS timeout :306-358)
                        "timeouts": {"request": "300s"},
                    }
                ],
            },
        }

    def _mirror_status(self, tb: Obj) -> None:
        try:
            deploy = self.api.get(
                "Deployment", obj_util.name_of(tb), obj_util.namespace_of(tb)
            )
        except NotFound:
            return
        ready = obj_util.get_path(deploy, "status", "readyReplicas", default=0)
        prev_ready = obj_util.get_path(tb, "status", "readyReplicas", default=0)
        if ready and not prev_ready:
            self.recorder.normal(tb, "Started", "Tensorboard server started")
        status = {
            "readyReplicas": ready,
            "conditions": [
                {
                    "type": "Available" if ready else "Progressing",
                    "status": "True",
                }
            ],
        }
        if (tb.get("status") or {}) == status:
            return  # steady state: skip the no-op status round-trip
        tb["status"] = status
        reconcilehelper.update_status_level_triggered(self.api, tb)


def main() -> None:
    """Split-process entrypoint (manifests/tensorboard-controller)."""
    from odh_kubeflow_tpu_torch.machinery.runner import run_controller

    run_controller(
        "tensorboard-controller",
        lambda api, mgr: TensorboardController(api).register(mgr),
    )


if __name__ == "__main__":
    main()
