"""Shared CRUD-backend factory: authn + authz + probes + envelopes (the
port's copy of the JAX package's ``web/crud_backend.py``).

Reference parity (crud-web-apps/common/backend/kubeflow/kubeflow/
crud_backend/): app factory __init__.py:16-35, header authn
authn.py:13-66 (USERID_HEADER + prefix strip), SubjectAccessReview
authz @needs_authorization authz.py:25-132 (dev mode skips :53-60),
success/error envelopes, liveness probes (probes.py).

Left out of the copy (ROADMAP.md), to come with the informer cache,
the store's pagination and the frontends: degraded-mode serving from
last-known-good rows, the listing memo, ``?limit=&continue=`` pages,
the replica-read ``servedRv`` stamps and the bundled static frontends.
A listing here is the whole list, built on every request.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from odh_kubeflow_tpu_torch.machinery.rbac import RBACEvaluator
from odh_kubeflow_tpu_torch.machinery.store import APIError, APIServer
from odh_kubeflow_tpu_torch.web.microweb import (
    App,
    HTTPError,
    Request,
    Response,
    install_csrf,
)

USERID_HEADER = os.environ.get("USERID_HEADER", "kubeflow-userid")
USERID_PREFIX = os.environ.get("USERID_PREFIX", "")
DEV_MODE = os.environ.get("APP_DEV_MODE", "").lower() in ("1", "true")


def success(extra: Optional[dict] = None, status: int = 200) -> Response:
    body: dict[str, Any] = {"success": True, "status": status}
    body.update(extra or {})
    return Response(body, status)


def failure(log: str, status: int = 400) -> Response:
    return Response({"success": False, "status": status, "log": log}, status)


def user_of(request: Request) -> str:
    raw = request.headers.get(USERID_HEADER.lower(), "")
    if not raw:
        if DEV_MODE:
            return os.environ.get("APP_DEV_USER", "dev@example.com")
        raise HTTPError(401, f"missing {USERID_HEADER} header")
    if USERID_PREFIX and raw.startswith(USERID_PREFIX):
        raw = raw[len(USERID_PREFIX) :]
    return raw


class CrudBackend:
    """Holds the API handle + RBAC evaluator; builds per-app WSGI apps."""

    def __init__(self, api: APIServer, app_name: str, registry=None):
        self.api = api
        self.rbac = RBACEvaluator(api)
        self.app = App(app_name, registry=registry)
        install_csrf(self.app)
        self._install_probes()
        self._install_errors()

    def _install_probes(self) -> None:
        @self.app.route("/healthz")
        @self.app.route("/healthz/liveness")
        @self.app.route("/healthz/readiness")
        def probe(request):
            return success()

    def _install_errors(self) -> None:
        @self.app.error_handler(APIError)
        def api_error(request, e: APIError):
            return failure(str(e), e.code)

    def authorize(
        self,
        request: Request,
        verb: str,
        resource: str,
        namespace: Optional[str] = None,
        api_group: str = "",
    ) -> str:
        """SubjectAccessReview gate (authz.py:101-132); returns the
        authenticated user. Dev mode authenticates but skips authz."""
        user = user_of(request)
        if DEV_MODE:
            return user
        if not self.rbac.can(user, verb, resource, namespace, api_group):
            raise HTTPError(
                403,
                f"User {user} is not authorized to {verb} {resource}"
                + (f" in namespace {namespace}" if namespace else ""),
            )
        return user

    # -- shared status/event treatment (reference:
    # crud-web-apps/common/backend/.../status.py — every app derives
    # status and mines error events the same way) -------------------------

    def event_rows(self, namespace: str, match) -> list:
        """Event feed for a resource's details drawer: every event whose
        involvedObject satisfies ``match``, newest first, in the shape
        the common frontend's events table renders."""
        rows = []
        for event in self.api.list("Event", namespace=namespace):
            involved = event.get("involvedObject", {})
            if not match(involved):
                continue
            rows.append(
                {
                    "type": event.get("type", "Normal"),
                    "reason": event.get("reason", ""),
                    "message": event.get("message", ""),
                    "involved": (
                        f"{involved.get('kind', '')}/"
                        f"{involved.get('name', '')}"
                    ),
                    "timestamp": event.get("lastTimestamp")
                    or event.get("firstTimestamp", ""),
                    "count": event.get("count", 1),
                }
            )
        rows.sort(key=lambda e: e["timestamp"], reverse=True)
        return rows

    def find_error_event(self, namespace: str, match) -> Optional[str]:
        """Latest Warning-event message for a resource — what turns a
        bare 'waiting' status into an actionable 'warning' one."""
        message: Optional[str] = None
        latest = ""
        for event in self.api.list("Event", namespace=namespace):
            if event.get("type") != "Warning":
                continue
            if not match(event.get("involvedObject", {})):
                continue
            # trailing `or ""`: an Event may carry both timestamp fields
            # explicitly null
            ts = event.get("lastTimestamp") or event.get("firstTimestamp") or ""
            # latest by recurrence time, not list position: the store
            # dedupes repeats in place, so a recurring warning keeps an
            # early list slot while only its lastTimestamp advances
            if ts >= latest:
                latest = ts
                message = event.get("message", event.get("reason", ""))
        return message
