"""Tensorboards web app (TWA) backend (the port's copy of the JAX
package's ``web/twa.py``).

Reference parity: crud-web-apps/tensorboards/backend/app/routes/
post.py:15-38, app/utils.py:4-38 (the CR and its status parse). The
``/logs`` route lists a local logspath under ``TWA_LOCAL_LOGS_ROOT``
(the profiles ``utils/profiling.py`` writes, as a PVC's host directory
holds them). The listing goes through the CRUD backend's
``listing_response`` (memo, degraded serving, ``?limit=&continue=``
pages). ``main()`` serves it in a process of its own through
``machinery/runner.py``; in-process,
``TensorboardsWebApp(api).app.serve(host, port)``.
"""

from __future__ import annotations

import re

from typing import Any

from odh_kubeflow_tpu_torch.apis import TENSORBOARD_API_VERSION
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import APIServer
from odh_kubeflow_tpu_torch.web.crud_backend import CrudBackend, failure, success

Obj = dict[str, Any]


class TensorboardsWebApp(CrudBackend):
    def __init__(self, api: APIServer, registry=None):
        super().__init__(api, "tensorboards-web-app", registry=registry)
        self._register_routes()

    def _register_routes(self) -> None:
        app = self.app

        @app.route("/api/namespaces/<namespace>/tensorboards")
        def list_tbs(request, namespace):
            self.authorize(
                request, "list", "tensorboards", namespace, "tensorboard.kubeflow.org"
            )
            return self.listing_response(  # contract-ok: kube 410 pagination contract — a stale continue token answers 410 Expired and the client restarts its walk from a fresh first page
                "tensorboards",
                ("tensorboards", namespace),
                lambda: [
                    self.tensorboard_row(tb)
                    for tb in self.api.list("Tensorboard", namespace=namespace)  # unbounded-ok: cache-served zero-copy read
                ],
                request,
                kinds=("Tensorboard", "Event"),
            )

        @app.route("/api/namespaces/<namespace>/tensorboards", methods=["POST"])
        def post_tb(request, namespace):
            self.authorize(
                request,
                "create",
                "tensorboards",
                namespace,
                "tensorboard.kubeflow.org",
            )
            body = request.json or {}
            name = body.get("name", "")
            logspath = body.get("logspath", "")
            if not name or not logspath:
                return failure("name and logspath are required", 400)
            tb = {
                "apiVersion": TENSORBOARD_API_VERSION,
                "kind": "Tensorboard",
                "metadata": {"name": name, "namespace": namespace},
                "spec": {"logspath": logspath},
            }
            self.api.create(tb)
            return success({"tensorboard": name}, 201)

        @app.route(
            "/api/namespaces/<namespace>/tensorboards/<name>",
            methods=["DELETE"],
        )
        def delete_tb(request, namespace, name):
            self.authorize(
                request,
                "delete",
                "tensorboards",
                namespace,
                "tensorboard.kubeflow.org",
            )
            self.api.delete("Tensorboard", name, namespace)
            return success()

        @app.route("/api/namespaces/<namespace>/tensorboards/<name>/logs")
        def tb_logs(request, namespace, name):
            """Log-directory browser for the detail page: the parsed
            logspath plus, when the path resolves to a LOCAL directory
            (standalone/dev platforms and the profiling tier's
            torch.profiler layout — ``utils/profiling.py``), the run/file
            listing TensorBoard would index. Remote schemes (gs://,
            s3://) report listable=False with their parsed bucket and
            prefix — browsing those is the bucket console's job, not a
            BFF proxy's."""
            self.authorize(
                request, "get", "tensorboards", namespace,
                "tensorboard.kubeflow.org",
            )
            tb = self.api.get("Tensorboard", name, namespace)
            logspath = obj_util.get_path(tb, "spec", "logspath", default="")
            parsed = _parse_logspath(logspath)
            rows = []
            if parsed["scheme"] == "local":
                import os

                # CONTAINMENT: spec.logspath is user-controlled — only
                # list under the operator-declared root (standalone/dev
                # deployments set TWA_LOCAL_LOGS_ROOT; unset = local
                # listing disabled), resolved against symlink escapes.
                # Without this, a namespace user could browse arbitrary
                # server filesystem metadata via logspath="/etc".
                root = os.environ.get("TWA_LOCAL_LOGS_ROOT", "")
                base = os.path.realpath(parsed["path"])
                contained = bool(root) and (
                    base == os.path.realpath(root)
                    or base.startswith(
                        os.path.realpath(root).rstrip("/") + "/"
                    )
                )
                if contained and os.path.isdir(base):
                    parsed["listable"] = True
                    cap = 500  # browse, don't mirror
                    for dirpath, _dirs, files in os.walk(base):
                        rel = os.path.relpath(dirpath, base)
                        for f in sorted(files):
                            if len(rows) >= cap:
                                break
                            full = os.path.join(dirpath, f)
                            try:
                                st = os.stat(full)
                            except OSError:
                                continue
                            rows.append({
                                "path": (
                                    f if rel == "." else f"{rel}/{f}"
                                ),
                                "size": st.st_size,
                                "modified": int(st.st_mtime),
                            })
                        if len(rows) >= cap:
                            break
            return success({
                "logspath": logspath, **parsed, "files": rows
            })

        @app.route("/api/namespaces/<namespace>/tensorboards/<name>/events")
        def tb_events(request, namespace, name):
            """Details-drawer feed: events on the Tensorboard CR and
            its owned Deployment/Pods (kubelet pods append
            ``-<i>-<uid5>``, so the prefix match is kind-gated the way
            JWA's is — a sibling CR called ``name-2`` must not leak)."""
            self.authorize(
                request, "get", "tensorboards", namespace,
                "tensorboard.kubeflow.org",
            )
            return success({
                "events": self.event_rows(
                    namespace, lambda inv: _event_belongs_to_tb(inv, name)
                )
            })

    def tensorboard_row(self, tb: Obj) -> Obj:
        return {
            "name": obj_util.name_of(tb),
            "namespace": obj_util.namespace_of(tb),
            "logspath": obj_util.get_path(tb, "spec", "logspath", default=""),
            "status": self.tensorboard_status(tb),
            "age": obj_util.meta(tb).get("creationTimestamp", ""),
        }

    def tensorboard_status(self, tb: Obj) -> Obj:
        """JWA's status treatment (shared common/status.py parity):
        deleting → terminating, ready → running, otherwise mine the
        owned resources' Warning events before settling for waiting."""
        if obj_util.meta(tb).get("deletionTimestamp"):
            return {
                "phase": "terminating", "message": "Deleting this tensorboard"
            }
        ready = obj_util.get_path(tb, "status", "readyReplicas", default=0)
        if ready:
            return {"phase": "ready", "message": "Running"}
        name = obj_util.name_of(tb)
        error = self.find_error_event(
            obj_util.namespace_of(tb),
            lambda inv: _event_belongs_to_tb(inv, name),
        )
        if error:
            return {"phase": "warning", "message": error}
        return {"phase": "waiting", "message": "Starting"}


def _parse_logspath(logspath: str) -> Obj:
    """Scheme split matching the controller's path parsing
    (controllers/tensorboard.py): pvc://claim/sub, gs://bucket/prefix,
    s3://bucket/prefix, anything else = a local filesystem path."""
    m = re.fullmatch(r"(pvc|gs|s3)://([^/]+)/?(.*)", logspath)
    if not m:
        return {"scheme": "local", "path": logspath, "listable": False}
    scheme, root, sub = m.groups()
    key = "claim" if scheme == "pvc" else "bucket"
    return {
        "scheme": scheme, key: root, "prefix": sub, "listable": False
    }


def _event_belongs_to_tb(involved: Obj, name: str) -> bool:
    """Kind-gated suffix match (JWA's _event_belongs_to_notebook
    discipline): a sibling CR named ``<name>-2`` must not leak its
    events into this one's drawer — only this CR's exact name and its
    Deployment pods (``<name>-<i>-<uid5>``) belong."""
    kind = involved.get("kind", "")
    iname = involved.get("name", "")
    if iname == name:
        return True
    suffix = iname[len(name):] if iname.startswith(name) else ""
    return kind == "Pod" and bool(
        re.fullmatch(r"-\d+-[0-9a-f]{5}", suffix)
    )


def main() -> None:
    """Split-process entrypoint (manifests/web)."""
    from odh_kubeflow_tpu_torch.machinery.runner import run_web

    run_web("tensorboards-web-app", 5000, TensorboardsWebApp)


if __name__ == "__main__":
    main()
