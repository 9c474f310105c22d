"""Notebook mutating webhook (the odh-notebook-controller webhook's
role, GKE-native; the port's copy of the JAX package's
``webhooks/notebook.py``, unchanged in substance).

Reference parity (components/odh-notebook-controller/controllers/
notebook_webhook.go): Handle :226-265 (lock on create, sidecar, proxy
env), InjectOAuthProxy :68-223, ClusterWideProxyIsEnabled :267-291,
InjectProxyConfig :299-398.

Redesign notes:
- The OpenShift ``oauth-proxy`` sidecar becomes a generic
  ``auth-proxy`` (oauth2-proxy-style) container guarding 8443 with a
  per-notebook allow-list — same per-notebook RBAC intent as the
  reference's ``--openshift-sar`` flag, no OpenShift dependency.
- The create-time reconciliation lock annotation survives as-is: the
  exposure controller removes it once auth materials exist (the
  webhook-ordering race the reference solved).
- Cluster-wide egress proxy env is read from a ``ConfigMap``
  (``kube-system/cluster-proxy-config``) instead of the OpenShift
  ``Proxy`` CR.
"""

from __future__ import annotations

from typing import Any, Optional

from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import (
    AdmissionRequest,
    APIServer,
    NotFound,
)

Obj = dict[str, Any]

INJECT_AUTH_ANNOTATION = "notebooks.opendatahub.io/inject-oauth"
# The lock IS the stop annotation with a marker value: the notebook
# controller keeps replicas at 0 through its normal stopped path until
# the exposure controller removes it (webhook.go:49-64 + odh
# notebook_controller.go:94-122)
LOCK_ANNOTATION = "kubeflow-resource-stopped"
LOCK_VALUE = "odh-notebook-controller-lock"
LOGOUT_URL_ANNOTATION = "notebooks.opendatahub.io/oauth-logout-url"

AUTH_PROXY_PORT = 8443
AUTH_PROXY_CONTAINER = "auth-proxy"
PROXY_CONFIGMAP_NS = "kube-system"
PROXY_CONFIGMAP_NAME = "cluster-proxy-config"
TRUSTED_CA_BUNDLE_CONFIGMAP = "odh-trusted-ca-bundle"


class NotebookWebhook:
    def __init__(
        self,
        api: APIServer,
        auth_proxy_image: str = "odh-kubeflow-tpu/auth-proxy:latest",
    ):
        # the platform's auth-proxy image (a stdlib reverse proxy with
        # header/HMAC-cookie authn + SubjectAccessReview authz)
        self.api = api
        self.auth_proxy_image = auth_proxy_image

    def register(self) -> None:
        self.api.register_admission_hook(
            {"Notebook"}, self.mutate, mutating=True, name="notebook-webhook"
        )

    def mutate(self, req: AdmissionRequest) -> Optional[Obj]:
        notebook = req.obj
        if req.operation == "CREATE" and self._auth_injection_enabled(notebook):
            # reconciliation lock: replicas stay 0 until the exposure
            # controller confirms auth materials (webhook.go:49-64)
            obj_util.set_annotation(notebook, LOCK_ANNOTATION, LOCK_VALUE)
        if req.operation not in ("CREATE", "UPDATE"):
            return None
        if self._auth_injection_enabled(notebook):
            self._inject_auth_proxy(notebook)
        self._inject_cluster_proxy_env(notebook)
        return notebook

    # -- auth sidecar -------------------------------------------------------

    def _auth_injection_enabled(self, notebook: Obj) -> bool:
        return (
            # protocol-ok: user/spawner-set opt-in; no package writer
            obj_util.annotations_of(notebook).get(INJECT_AUTH_ANNOTATION) == "true"
        )

    def _inject_auth_proxy(self, notebook: Obj) -> None:
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        pod_spec = (
            notebook.setdefault("spec", {})
            .setdefault("template", {})
            .setdefault("spec", {})
        )
        pod_spec["serviceAccountName"] = name
        containers = pod_spec.setdefault("containers", [])
        sidecar = {
            "name": AUTH_PROXY_CONTAINER,
            "image": self.auth_proxy_image,
            "ports": [
                {
                    "containerPort": AUTH_PROXY_PORT,
                    "name": "https-auth",
                    "protocol": "TCP",
                }
            ],
            "args": [
                f"--upstream=http://localhost:8888",
                f"--https-address=:{AUTH_PROXY_PORT}",
                "--provider=oidc",
                f"--email-domain=*",
                # per-notebook authorization: only identities allowed to
                # `get` this Notebook may pass (the reference encodes the
                # same check as --openshift-sar, webhook.go:118-136)
                (
                    "--allowed-resource="
                    f'{{"verb":"get","resource":"notebooks","namespace":"{ns}",'
                    f'"name":"{name}"}}'
                ),
                "--tls-cert=/etc/tls/private/tls.crt",
                "--tls-key=/etc/tls/private/tls.key",
                "--cookie-secret-file=/etc/auth/cookie/secret",
            ],
            "volumeMounts": [
                {"name": "auth-tls", "mountPath": "/etc/tls/private"},
                {"name": "auth-cookie", "mountPath": "/etc/auth/cookie"},
            ],
            "livenessProbe": {
                "httpGet": {
                    "path": "/ping",
                    "port": AUTH_PROXY_PORT,
                    "scheme": "HTTPS",
                }
            },
            "resources": {
                "requests": {"cpu": "100m", "memory": "64Mi"},
                "limits": {"cpu": "100m", "memory": "64Mi"},
            },
        }
        # protocol-ok: user-set alongside the oauth opt-in annotation
        logout = obj_util.annotations_of(notebook).get(LOGOUT_URL_ANNOTATION)
        if logout:
            sidecar["args"].append(f"--logout-url={logout}")
        for i, c in enumerate(containers):
            if c.get("name") == AUTH_PROXY_CONTAINER:
                containers[i] = sidecar
                break
        else:
            containers.append(sidecar)

        volumes = pod_spec.setdefault("volumes", [])

        def ensure_volume(vol: Obj) -> None:
            for i, v in enumerate(volumes):
                if v.get("name") == vol["name"]:
                    volumes[i] = vol
                    return
            volumes.append(vol)

        ensure_volume(
            {"name": "auth-tls", "secret": {"secretName": f"{name}-tls"}}
        )
        ensure_volume(
            {
                "name": "auth-cookie",
                "secret": {"secretName": f"{name}-cookie-secret"},
            }
        )

    # -- cluster-wide proxy env --------------------------------------------

    def _proxy_config(self) -> Optional[Obj]:
        try:
            cm = self.api.get(
                "ConfigMap", PROXY_CONFIGMAP_NAME, PROXY_CONFIGMAP_NS
            )
        except NotFound:
            return None
        data = cm.get("data") or {}
        if not (data.get("httpProxy") or data.get("httpsProxy")):
            return None
        return data

    def _inject_cluster_proxy_env(self, notebook: Obj) -> None:
        data = self._proxy_config()
        if data is None:
            return
        env_pairs = []
        if data.get("httpProxy"):
            env_pairs += [
                ("HTTP_PROXY", data["httpProxy"]),
                ("http_proxy", data["httpProxy"]),
            ]
        if data.get("httpsProxy"):
            env_pairs += [
                ("HTTPS_PROXY", data["httpsProxy"]),
                ("https_proxy", data["httpsProxy"]),
            ]
        if data.get("noProxy"):
            env_pairs += [
                ("NO_PROXY", data["noProxy"]),
                ("no_proxy", data["noProxy"]),
            ]
        pod_spec = (
            notebook.setdefault("spec", {})
            .setdefault("template", {})
            .setdefault("spec", {})
        )
        for c in pod_spec.get("containers") or []:
            env = c.setdefault("env", [])
            names = {e.get("name") for e in env}
            for key, value in env_pairs:
                if key not in names:
                    env.append({"name": key, "value": value})
        if data.get("trustedCABundle"):
            volumes = pod_spec.setdefault("volumes", [])
            if not any(v.get("name") == "trusted-ca" for v in volumes):
                volumes.append(
                    {
                        "name": "trusted-ca",
                        "configMap": {
                            "name": TRUSTED_CA_BUNDLE_CONFIGMAP,
                            "items": [
                                {
                                    "key": "ca-bundle.crt",
                                    "path": "tls-ca-bundle.pem",
                                }
                            ],
                        },
                    }
                )
            for c in pod_spec.get("containers") or []:
                mounts = c.setdefault("volumeMounts", [])
                if not any(m.get("name") == "trusted-ca" for m in mounts):
                    mounts.append(
                        {
                            "name": "trusted-ca",
                            "mountPath": "/etc/pki/tls/certs",
                            "readOnly": True,
                        }
                    )
