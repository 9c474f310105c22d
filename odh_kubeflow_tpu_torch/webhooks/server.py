"""AdmissionReview HTTP server: the real k8s webhook wire protocol (the
port's copy of the JAX package's ``webhooks/server.py``).

In-process (all-in-one platform / tests) the webhook classes register
straight into the embedded APIServer's admission chain. Deployed
against a real kube-apiserver (manifests/admission-webhook), the same
mutate functions serve v1 AdmissionReview over HTTP: request object in,
JSONPatch out — the reference's exact contract
(admission-webhook/main.go:555-573 builds the same patch response;
odh notebook_webhook.go:226-265 the same Handle shape). The
split-process ``main()``, which reads PodDefaults through
``machinery/client.py``, comes with that module.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import AdmissionRequest, Denied
from odh_kubeflow_tpu_torch.web.microweb import App, Request, Response

Obj = dict[str, Any]


def json_patch_diff(old: Any, new: Any, path: str = "") -> list[Obj]:
    """RFC-6902 patch turning ``old`` into ``new``. Dicts recurse;
    lists replace wholesale (k8s merge semantics for webhook patches —
    upstream webhooks do the same rather than emit fragile indexed
    ops)."""
    if isinstance(old, dict) and isinstance(new, dict):
        ops: list[Obj] = []
        for k in old:
            if k not in new:
                ops.append({"op": "remove", "path": f"{path}/{_esc(k)}"})
        for k, v in new.items():
            if k not in old:
                ops.append({"op": "add", "path": f"{path}/{_esc(k)}", "value": v})
            elif old[k] != v:
                ops.extend(json_patch_diff(old[k], v, f"{path}/{_esc(k)}"))
        return ops
    # RFC 6901: the document root is "" ("/" addresses the ""-named key)
    return [{"op": "replace", "path": path, "value": new}]


def _esc(key: str) -> str:
    return key.replace("~", "~0").replace("/", "~1")


class AdmissionServer:
    """WSGI app mapping webhook paths to mutate callables."""

    def __init__(self):
        self.app = App("admission-webhook")
        self._handlers: dict[str, Callable[[AdmissionRequest], Optional[Obj]]] = {}

        @self.app.route("/healthz")
        @self.app.route("/readyz")
        def health(request):  # noqa: ANN001
            return Response(b"ok", content_type="text/plain")

    def handle(self, path: str, mutate: Callable[[AdmissionRequest], Optional[Obj]]):
        self._handlers[path] = mutate

        @self.app.route(path, methods=["POST"])
        def review(request: Request, _mutate=mutate):
            return self._review(request, _mutate)

        return self

    def _review(self, request: Request, mutate) -> Response:
        body = request.json
        ar = body.get("request") or {}
        uid = ar.get("uid", "")
        obj = ar.get("object") or {}
        old = ar.get("oldObject")
        operation = ar.get("operation", "CREATE")
        dry_run = bool(ar.get("dryRun"))

        response: Obj = {"uid": uid, "allowed": True}
        try:
            mutated = mutate(
                AdmissionRequest(operation, obj_util.deepcopy(obj), old, dry_run)
            )
        except Denied as e:
            response = {
                "uid": uid,
                "allowed": False,
                "status": {"message": str(e), "code": 403},
            }
            mutated = None
        if mutated is not None:
            ops = json_patch_diff(obj, mutated)
            if ops:
                response["patchType"] = "JSONPatch"
                response["patch"] = base64.b64encode(
                    json.dumps(ops).encode()
                ).decode()
        return Response(
            json.dumps(
                {
                    "apiVersion": "admission.k8s.io/v1",
                    "kind": "AdmissionReview",
                    "response": response,
                }
            ).encode(),
            content_type="application/json",
        )


def make_ssl_context(cert_file: str, key_file: str):
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cert_file, key_file)
    return ctx
