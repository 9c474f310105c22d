"""Volumes web app (VWA) backend: PVC CRUD (the port's copy of the JAX
package's ``web/vwa.py``).

Reference parity: crud-web-apps/volumes/backend/apps/default/routes/
{get,post,delete}.py + common/utils.py parsing. A PVC's detail page
lists the pods mounting it (``machinery/cache.list_by_index``, a
namespace scan on the plain store). The listing goes through the CRUD
backend's ``listing_response`` (memo, degraded serving,
``?limit=&continue=`` pages). ``main()`` serves it in a process of its
own through ``machinery/runner.py``; in-process,
``VolumesWebApp(api).app.serve(host, port)``.
"""

from __future__ import annotations

from typing import Any, Optional

from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.cache import list_by_index
from odh_kubeflow_tpu_torch.machinery.store import APIServer
from odh_kubeflow_tpu_torch.web.crud_backend import CrudBackend, failure, success

Obj = dict[str, Any]


class VolumesWebApp(CrudBackend):
    def __init__(self, api: APIServer, registry=None):
        super().__init__(api, "volumes-web-app", registry=registry)
        self._register_routes()

    def _register_routes(self) -> None:
        app = self.app

        @app.route("/api/namespaces/<namespace>/pvcs")
        def list_pvcs(request, namespace):
            self.authorize(request, "list", "persistentvolumeclaims", namespace)
            return self.listing_response(  # contract-ok: kube 410 pagination contract — a stale continue token answers 410 Expired and the client restarts its walk from a fresh first page
                "pvcs",
                ("pvcs", namespace),
                lambda: [
                    self.pvc_row(pvc)
                    for pvc in self.api.list("PersistentVolumeClaim", namespace=namespace)  # unbounded-ok: cache-served zero-copy read
                ],
                request,
                kinds=("PersistentVolumeClaim", "Pod", "Event"),
            )

        @app.route("/api/namespaces/<namespace>/pvcs", methods=["POST"])
        def post_pvc(request, namespace):
            self.authorize(request, "create", "persistentvolumeclaims", namespace)
            body = request.json or {}
            pvc = body.get("pvc") or {}
            pvc.setdefault("apiVersion", "v1")
            pvc["kind"] = "PersistentVolumeClaim"
            pvc.setdefault("metadata", {})["namespace"] = namespace
            if not obj_util.name_of(pvc):
                return failure("pvc.metadata.name required", 400)
            created = self.api.create(pvc)
            return success({"pvc": obj_util.name_of(created)}, 201)

        @app.route(
            "/api/namespaces/<namespace>/pvcs/<name>", methods=["DELETE"]
        )
        def delete_pvc(request, namespace, name):
            self.authorize(request, "delete", "persistentvolumeclaims", namespace)
            self.api.delete("PersistentVolumeClaim", name, namespace)
            return success()

        @app.route("/api/namespaces/<namespace>/pvcs/<name>", methods=["GET"])
        def get_pvc(request, namespace, name):
            """Detail-page feed (reference: volumes/frontend's
            per-volume page with its pods tab): the list row plus the
            full spec and the MOUNTING PODS with phase + mount path —
            'used by' as live objects, not just names."""
            self.authorize(request, "get", "persistentvolumeclaims", namespace)
            pvc = self.api.get("PersistentVolumeClaim", name, namespace)
            pods = self._mounting_pods(namespace, name)
            return success({
                "details": {
                    **self.pvc_row(
                        pvc, mounted_by=[p["name"] for p in pods]
                    ),
                    "spec": pvc.get("spec", {}),
                    "pods": pods,
                }
            })

        @app.route("/api/namespaces/<namespace>/pvcs/<name>/events")
        def pvc_events(request, namespace, name):
            """Details-drawer feed: events on the PVC itself plus on
            the pods mounting it (a scheduling failure shows up on the
            pod, but the user is looking at the volume)."""
            self.authorize(request, "get", "persistentvolumeclaims", namespace)
            mounters = set(self._mounted_by(namespace, name))
            return success({
                "events": self.event_rows(
                    namespace,
                    lambda inv: (
                        inv.get("kind") == "PersistentVolumeClaim"
                        and inv.get("name") == name
                    )
                    or (
                        inv.get("kind") == "Pod"
                        and inv.get("name") in mounters
                    ),
                )
            })

    def _mounting_pods(self, namespace: str, name: str) -> list:
        """The pods mounting ``name``, as rich rows (name, phase, mount
        paths) — the ONE pod scan every used-by surface derives from."""
        out = []
        # ``pvc`` field index: only pods actually mounting the claim
        # (namespace scan only when no cache serves Pods)
        for pod in list_by_index(
            self.api, "Pod", "pvc", name, namespace=namespace
        ):
            vols = obj_util.get_path(pod, "spec", "volumes", default=[]) or []
            vol_names = {
                v.get("name")
                for v in vols
                if obj_util.get_path(v, "persistentVolumeClaim", "claimName")
                == name
            }
            if not vol_names:
                continue
            out.append({
                "name": obj_util.name_of(pod),
                "phase": obj_util.get_path(
                    pod, "status", "phase", default=""
                ),
                "mountPaths": [
                    m.get("mountPath", "")
                    for c in obj_util.get_path(
                        pod, "spec", "containers", default=[]
                    )
                    or []
                    for m in c.get("volumeMounts", []) or []
                    if m.get("name") in vol_names
                ],
            })
        return out

    def _mounted_by(self, namespace: str, name: str) -> list:
        return [p["name"] for p in self._mounting_pods(namespace, name)]

    def pvc_row(self, pvc: Obj, mounted_by: Optional[list] = None) -> Obj:
        name = obj_util.name_of(pvc)
        ns = obj_util.namespace_of(pvc)
        if mounted_by is None:
            mounted_by = self._mounted_by(ns, name)
        return {
            "name": name,
            "namespace": ns,
            "capacity": obj_util.get_path(
                pvc, "spec", "resources", "requests", "storage", default=""
            ),
            "modes": obj_util.get_path(pvc, "spec", "accessModes", default=[]),
            "class": obj_util.get_path(
                pvc, "spec", "storageClassName", default=""
            ),
            "status": self.pvc_status(pvc),
            "usedBy": mounted_by,
            "age": obj_util.meta(pvc).get("creationTimestamp", ""),
        }

    def pvc_status(self, pvc: Obj) -> Obj:
        """Same status treatment as JWA (the reference's shared
        common/status.py): terminal phases map directly, a Pending
        claim with a Warning event surfaces the event message."""
        if obj_util.meta(pvc).get("deletionTimestamp"):
            return {"phase": "terminating", "message": "Deleting this volume"}
        phase = obj_util.get_path(pvc, "status", "phase", default="Bound")
        if phase == "Bound":
            return {"phase": "ready", "message": "Bound"}
        if phase == "Lost":
            return {"phase": "error", "message": "Underlying volume lost"}
        name = obj_util.name_of(pvc)
        error = self.find_error_event(
            obj_util.namespace_of(pvc),
            lambda inv: inv.get("kind") == "PersistentVolumeClaim"
            and inv.get("name") == name,
        )
        if error:
            return {"phase": "warning", "message": error}
        return {"phase": "waiting", "message": "Provisioning"}


def main() -> None:
    """Split-process entrypoint (manifests/web)."""
    from odh_kubeflow_tpu_torch.machinery.runner import run_web

    run_web("volumes-web-app", 5000, VolumesWebApp)


if __name__ == "__main__":
    main()
