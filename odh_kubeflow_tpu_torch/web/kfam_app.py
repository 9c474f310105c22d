"""kfam HTTP service (access-management, port 8081 in the reference; the
port's copy of the JAX package's ``web/kfam_app.py``, on
``controllers/kfam.py``).

Reference parity: components/access-management/kfam/api_default.go
:36-43 — /kfam/v1/bindings (GET/POST/DELETE), /kfam/v1/profiles
(POST/DELETE), /kfam/v1/role/clusteradmin (GET). ``main()`` serves it
in a process of its own through ``machinery/runner.py``; in-process,
``KfamApp(api).app.serve(host, port)``.
"""

from __future__ import annotations

from typing import Optional

from odh_kubeflow_tpu_torch.controllers.kfam import KfamService
from odh_kubeflow_tpu_torch.machinery.store import APIServer, Invalid
from odh_kubeflow_tpu_torch.utils import prometheus
from odh_kubeflow_tpu_torch.web.crud_backend import failure, success, user_of
from odh_kubeflow_tpu_torch.web.microweb import App, Response, install_csrf


class KfamApp:
    def __init__(
        self,
        api: APIServer,
        cluster_admins: Optional[set[str]] = None,
        registry: Optional[prometheus.Registry] = None,
    ):
        self.service = KfamService(api, cluster_admins)
        self.app = App("kfam", registry=registry)
        install_csrf(self.app)
        reg = registry or prometheus.default_registry
        self.m_requests = reg.counter(
            "kfam_http_requests_total", "kfam requests"
        )
        self._register_routes()

    def _register_routes(self) -> None:
        app = self.app
        svc = self.service

        @app.route("/kfam/v1/role/clusteradmin")
        def cluster_admin(request):
            self.m_requests.inc()
            user = request.query.get("user") or user_of(request)
            return success({"clusteradmin": svc.is_cluster_admin(user)})

        @app.route("/kfam/v1/bindings")
        def get_bindings(request):
            self.m_requests.inc()
            ns = request.query.get("namespace")
            user = request.query.get("user")
            return success({"bindings": svc.list_bindings(ns, user)})

        @app.route("/kfam/v1/bindings", methods=["POST"])
        def create_binding(request):
            self.m_requests.inc()
            try:
                svc.create_binding(request.json or {}, requester=user_of(request))
            except Invalid as e:
                return failure(str(e), 403)
            return success(status=201)

        @app.route("/kfam/v1/bindings", methods=["DELETE"])
        def delete_binding(request):
            self.m_requests.inc()
            try:
                svc.delete_binding(request.json or {}, requester=user_of(request))
            except Invalid as e:
                return failure(str(e), 403)
            return success()

        @app.route("/kfam/v1/profiles", methods=["POST"])
        def create_profile(request):
            self.m_requests.inc()
            body = request.json or {}
            svc.create_profile(body)
            return success(status=201)

        @app.route("/kfam/v1/profiles/<name>", methods=["DELETE"])
        def delete_profile(request, name):
            self.m_requests.inc()
            try:
                svc.delete_profile(name, requester=user_of(request))
            except Invalid as e:
                return failure(str(e), 403)
            return success()

        @app.route("/metrics")
        def metrics(request):
            reg = prometheus.default_registry
            return Response(reg.exposition(), content_type="text/plain")


def main() -> None:
    """Split-process entrypoint (manifests/profile-controller kfam)."""
    from odh_kubeflow_tpu_torch.machinery.runner import run_web

    run_web("kfam", 8081, KfamApp)


if __name__ == "__main__":
    main()
