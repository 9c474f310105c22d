"""Exposure controller: the odh-notebook-controller role, GKE-native (the
port's copy of the JAX package's ``controllers/exposure.py``).

Second operator watching the same Notebook CR (reference:
components/odh-notebook-controller/controllers/notebook_controller.go
:126-198): external exposure, auth materials, network policy, and the
create-time reconciliation-lock release.

Redesign:
- OpenShift ``Route`` → Gateway-API ``HTTPRoute`` (TLS terminates at
  the gateway; re-encrypt to the auth sidecar's 8443).
- OAuth SA annotations → plain ServiceAccount + cookie Secret + tls
  Secret; certificates are expected from the platform's cert issuer
  (cert-manager style), named ``<notebook>-tls``.
- NetworkPolicies: notebook port 8888 only from the platform namespace
  (controllers + gateway), auth port 8443 open (notebook_network.go
  :130-209).
- Lock release: once the per-notebook ServiceAccount and secrets exist,
  remove the notebook webhook's lock annotation
  (``webhooks/notebook.py`` sets it on every notebook that asks for
  auth injection) → the notebook controller's StatefulSet finally
  scales up (notebook_controller.go:94-122). Without this controller
  such a notebook stays at 0 replicas.

``main()`` runs the controller in a process of its own through
``machinery/runner.py``.
"""

from __future__ import annotations

import base64
import os
import secrets
from typing import Any

from odh_kubeflow_tpu_torch.controllers import reconcilehelper
from odh_kubeflow_tpu_torch.controllers.runtime import Manager, Request, Result
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import APIServer, NotFound
from odh_kubeflow_tpu_torch.webhooks.notebook import (
    AUTH_PROXY_PORT,
    INJECT_AUTH_ANNOTATION,
    LOCK_ANNOTATION,
    LOCK_VALUE,
)

Obj = dict[str, Any]

GATEWAY_NAME = os.environ.get("GATEWAY_NAME", "kubeflow-gateway")
GATEWAY_NAMESPACE = os.environ.get("GATEWAY_NAMESPACE", "kubeflow")


class ExposureController:
    def __init__(self, api: APIServer, platform_namespace: str = "kubeflow"):
        self.api = api
        self.platform_namespace = platform_namespace

    def register(self, mgr: Manager) -> None:
        ctrl = mgr.new_controller("exposure-controller", "Notebook", self.reconcile)
        ctrl.owns("Service").owns("Secret").owns("ServiceAccount")
        ctrl.owns("HTTPRoute").owns("NetworkPolicy")

    # -- reconcile ----------------------------------------------------------

    def reconcile(self, req: Request) -> Result:
        try:
            notebook = self.api.get("Notebook", req.name, req.namespace)
        except NotFound:
            return Result()
        if obj_util.meta(notebook).get("deletionTimestamp"):
            return Result()

        auth = (
            obj_util.annotations_of(notebook).get(INJECT_AUTH_ANNOTATION) == "true"
        )
        self._reconcile_network_policies(notebook, auth)
        if auth:
            self._reconcile_service_account(notebook)
            self._reconcile_tls_service(notebook)
            self._reconcile_secrets(notebook)
        self._reconcile_route(notebook, auth)
        self._maybe_release_lock(notebook, auth)
        return Result()

    # -- auth materials -----------------------------------------------------

    def _reconcile_service_account(self, notebook: Obj) -> None:
        name = obj_util.name_of(notebook)
        sa = {
            "apiVersion": "v1",
            "kind": "ServiceAccount",
            "metadata": {
                "name": name,
                "namespace": obj_util.namespace_of(notebook),
                "annotations": {
                    # protocol-ok: routed by the external auth proxy layer
                    "auth.kubeflow.org/redirect-path": (
                        f"/notebook/{obj_util.namespace_of(notebook)}/{name}/"
                    )
                },
            },
        }
        reconcilehelper.reconcile_object(self.api, sa, owner=notebook)

    def _reconcile_tls_service(self, notebook: Obj) -> None:
        name = obj_util.name_of(notebook)
        svc = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": f"{name}-tls",
                "namespace": obj_util.namespace_of(notebook),
                "annotations": {
                    # cert issuer contract: materialise <name>-tls secret
                    # protocol-ok: the external cert controller consumes it
                    "cert.kubeflow.org/serving-cert-secret-name": f"{name}-tls"
                },
            },
            "spec": {
                "type": "ClusterIP",
                "selector": {"statefulset": name},
                "ports": [
                    {
                        "name": "https-auth",
                        "port": AUTH_PROXY_PORT,
                        "targetPort": AUTH_PROXY_PORT,
                        "protocol": "TCP",
                    }
                ],
            },
        }
        reconcilehelper.reconcile_object(self.api, svc, owner=notebook)

    def _reconcile_secrets(self, notebook: Obj) -> None:
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        cookie = {
            "apiVersion": "v1",
            "kind": "Secret",
            "metadata": {"name": f"{name}-cookie-secret", "namespace": ns},
            "type": "Opaque",
            "data": {
                "secret": base64.b64encode(secrets.token_bytes(32)).decode()
            },
        }
        try:
            self.api.get("Secret", f"{name}-cookie-secret", ns)
        except NotFound:
            obj_util.set_controller_reference(cookie, notebook)
            self.api.create(cookie)
        # tls secret: in a real cluster the cert issuer fills this from
        # the service annotation; create a placeholder if absent so the
        # pod can mount (and the issuer can overwrite).
        try:
            self.api.get("Secret", f"{name}-tls", ns)
        except NotFound:
            tls = {
                "apiVersion": "v1",
                "kind": "Secret",
                "metadata": {"name": f"{name}-tls", "namespace": ns},
                "type": "kubernetes.io/tls",
                "data": {"tls.crt": "", "tls.key": ""},
            }
            obj_util.set_controller_reference(tls, notebook)
            self.api.create(tls)

    # -- network ------------------------------------------------------------

    def _reconcile_network_policies(self, notebook: Obj, auth: bool) -> None:
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        notebook_port_policy = {
            "apiVersion": "networking.k8s.io/v1",
            "kind": "NetworkPolicy",
            "metadata": {"name": f"{name}-ctrl-np", "namespace": ns},
            "spec": {
                "podSelector": {
                    "matchLabels": {"statefulset.kubernetes.io/pod-name": f"{name}-0"}
                },
                "policyTypes": ["Ingress"],
                "ingress": [
                    {
                        "from": [
                            {
                                "namespaceSelector": {
                                    "matchLabels": {
                                        "kubernetes.io/metadata.name": (
                                            self.platform_namespace
                                        )
                                    }
                                }
                            }
                        ],
                        "ports": [{"protocol": "TCP", "port": 8888}],
                    }
                ],
            },
        }
        reconcilehelper.reconcile_object(
            self.api, notebook_port_policy, owner=notebook
        )
        if auth:
            auth_port_policy = {
                "apiVersion": "networking.k8s.io/v1",
                "kind": "NetworkPolicy",
                "metadata": {"name": f"{name}-auth-np", "namespace": ns},
                "spec": {
                    "podSelector": {
                        "matchLabels": {
                            "statefulset.kubernetes.io/pod-name": f"{name}-0"
                        }
                    },
                    "policyTypes": ["Ingress"],
                    "ingress": [
                        {"ports": [{"protocol": "TCP", "port": AUTH_PROXY_PORT}]}
                    ],
                },
            }
            reconcilehelper.reconcile_object(
                self.api, auth_port_policy, owner=notebook
            )

    # -- route --------------------------------------------------------------

    def _reconcile_route(self, notebook: Obj, auth: bool) -> None:
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        backend = (
            {"name": f"{name}-tls", "port": AUTH_PROXY_PORT}
            if auth
            else {"name": name, "port": 80}
        )
        route = {
            "apiVersion": "gateway.networking.k8s.io/v1",
            "kind": "HTTPRoute",
            "metadata": {"name": name, "namespace": ns},
            "spec": {
                "parentRefs": [
                    {"name": GATEWAY_NAME, "namespace": GATEWAY_NAMESPACE}
                ],
                "rules": [
                    {
                        "matches": [
                            {
                                "path": {
                                    "type": "PathPrefix",
                                    "value": f"/notebook/{ns}/{name}",
                                }
                            }
                        ],
                        "backendRefs": [backend],
                    }
                ],
            },
        }
        reconcilehelper.reconcile_object(self.api, route, owner=notebook)

    # -- lock ---------------------------------------------------------------

    def _maybe_release_lock(self, notebook: Obj, auth: bool) -> None:
        ann = obj_util.annotations_of(notebook)
        # only release OUR lock — a user/culler stop annotation (any
        # other value) is not ours to remove
        if ann.get(LOCK_ANNOTATION) != LOCK_VALUE:
            return
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        if auth:
            try:
                # existence probes only — served zero-copy by the
                # informer cache when one fronts the api
                self.api.get("ServiceAccount", name, ns)
                self.api.get("Secret", f"{name}-cookie-secret", ns)
                self.api.get("Secret", f"{name}-tls", ns)
            except NotFound:
                return  # keep the lock; requeue happens via owns() events
        self.api.patch(
            "Notebook",
            name,
            {"metadata": {"annotations": {LOCK_ANNOTATION: None}}},
            ns,
        )


def main() -> None:
    """Split-process entrypoint: the second operator watching Notebook
    (manifests/odh-notebook-controller posture), reads fronted by the
    runner's informer cache."""
    import os

    from odh_kubeflow_tpu_torch.machinery.runner import run_controller

    run_controller(
        "exposure-controller",
        lambda api, mgr: ExposureController(
            api,
            platform_namespace=os.environ.get(
                "PLATFORM_NAMESPACE", "kubeflow"
            ),
        ).register(mgr),
    )


if __name__ == "__main__":
    main()
