"""Shared CRUD-backend factory: authn + authz + probes + envelopes (the
port's copy of the JAX package's ``web/crud_backend.py``).

Reference parity (crud-web-apps/common/backend/kubeflow/kubeflow/
crud_backend/): app factory __init__.py:16-35, header authn
authn.py:13-66 (USERID_HEADER + prefix strip), SubjectAccessReview
authz @needs_authorization authz.py:25-132 (dev mode skips :53-60),
success/error envelopes, liveness probes (probes.py).

The listing half: degraded-mode serving from last-known-good rows, the
listing memo keyed on the informer cache's ``listing_versions``,
``?limit=&continue=`` pages and the replica-read ``servedRv`` /
``servedRvPartitions`` stamps. Left out of the copy (ROADMAP.md): the
bundled static frontends.
"""

from __future__ import annotations

import http.client
import logging
import os
import threading
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.machinery.rbac import RBACEvaluator
from odh_kubeflow_tpu_torch.machinery.store import (
    APIServer,
    APIError,
    Expired,
    decode_continue,
    encode_continue,
)
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

log = logging.getLogger("crud-backend")


def success(extra: Optional[dict] = None, status: int = 200) -> Response:
    body: dict[str, Any] = {"success": True, "status": status}
    body.update(extra or {})
    return Response(body, status)


# connection-level failures the remote client classifies as network
# outages and may re-raise after its retries (BadStatusLine,
# IncompleteRead are HTTPException, NOT OSError)
_OUTAGE_ERRORS = (APIError, OSError, http.client.HTTPException)


def _is_outage(e: Exception) -> bool:
    """A backend failure that degraded-mode serving should mask:
    server errors, load shedding, and network loss. Client errors
    (403/404/422…) are real answers and must surface."""
    if isinstance(e, APIError):
        return e.code >= 500 or e.code == 429
    return isinstance(e, (OSError, http.client.HTTPException))


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
        # last-known-good listings for degraded-mode serving: when the
        # backend is unreachable, list endpoints answer from here with
        # a `degraded: true` marker instead of 500ing (NotebookOS's
        # mask-transient-infrastructure-failures posture)
        self._lkg: dict[Any, list] = {}
        self._lkg_lock = threading.Lock()
        # listing memo: rows keyed by the mirror versions of every kind
        # they derive from — a repeat listing with an unchanged cache
        # skips row building entirely (the web-tier hot path becomes
        # memo lookup + serialization, which the bytes cache also skips
        # on a hit). Only populated when the api can version the whole
        # read set (CachedClient.listing_versions); store-served apps
        # rebuild every time, exactly as before.
        self._listing_memo: dict[Any, tuple[tuple, list]] = {}
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

    # -- degraded-mode serving ---------------------------------------------

    def backend_degraded(self, *kinds: str) -> bool:
        """Whether the informer cache behind ``self.api`` (when there
        is one) is serving any of ``kinds`` degraded — watch stream
        down, state last-known-good."""
        cache = getattr(self.api, "cache", None)
        return cache is not None and any(
            cache.has_kind(k) and cache.degraded(k) for k in kinds
        )

    _VERSIONS_UNREAD = object()  # sentinel: serve_listing reads them itself

    def serve_listing(
        self,
        key: Any,
        build: Callable[[], list],
        kinds: tuple[str, ...] = (),
        versions: Any = _VERSIONS_UNREAD,
    ) -> tuple[list, bool]:
        """Build a listing's rows, remembering them as last-known-good;
        when the backend is unreachable (5xx/429/network), serve the
        remembered rows — possibly empty — with ``degraded=True``
        instead of failing the request. ``kinds`` lets an informer
        cache's own degraded state mark even successful (stale) reads.

        ``kinds`` must name EVERY kind the rows derive from: it doubles
        as the listing-memo key (rows are reused while all those mirror
        versions hold still), so a kind missing from it would serve
        stale rows after that kind changed."""
        if versions is self._VERSIONS_UNREAD:
            versions_fn = getattr(self.api, "listing_versions", None)
            versions = versions_fn(kinds) if versions_fn is not None else None
        if versions is not None:
            # versions read BEFORE build: a write landing mid-build can
            # only make the memoized rows NEWER than their key — the
            # next request misses and rebuilds, never serves stale
            memo = self._listing_memo.get(key)
            if memo is not None and memo[0] == versions:
                return list(memo[1]), self.backend_degraded(*kinds)
        try:
            rows = build()
        except _OUTAGE_ERRORS as e:
            if not _is_outage(e):
                raise
            log.warning(
                "listing %s: backend unreachable (%s: %s); serving "
                "last-known-good", key, type(e).__name__, e,
            )
            with self._lkg_lock:
                return list(self._lkg.get(key, [])), True
        # checked AFTER build: the informer pokes (and discovers a dead
        # stream) during the reads build() performs
        degraded = self.backend_degraded(*kinds)
        with self._lkg_lock:
            self._lkg[key] = list(rows)
            if versions is not None:
                self._listing_memo[key] = (versions, list(rows))
        return rows, degraded

    def listing_body(
        self, field: str, rows: list, degraded: bool
    ) -> dict[str, Any]:
        body: dict[str, Any] = {field: rows}
        if degraded:
            body["degraded"] = True
        # replica-read deployments (READ_FROM_REPLICA): stamp the rv
        # horizon the backing replica served at, so API consumers see
        # the bounded-staleness contract instead of guessing. Scoped to
        # actual replica reads (a ReadSplitAPI, a follower store, or an
        # HTTP client mirroring the server's X-Served-RV header) —
        # in-process leader-served listings keep their exact
        # pre-replica shape.
        target = getattr(self.api, "read_api", None)
        if target is None and getattr(self.api, "is_follower", False):
            target = self.api
        if target is None and getattr(self.api, "base_url", ""):
            # HTTP split: the remote client surfaces the last-seen
            # X-Served-RV as applied_rv(), so split web apps carry the
            # same servedRv stamp in-process splits do
            target = self.api
        rv_fn = getattr(target, "applied_rv", None)
        if rv_fn is not None:
            try:
                served = rv_fn()
            except APIError:
                served = None  # backend blip: the rows still stand
            if served is not None:
                body["servedRv"] = int(served)
        # partitioned fleets (machinery.partition): the scalar horizon
        # is a SUM over independent per-partition rv spaces, so it is
        # not comparable to the partition-scalar rv a write returned.
        # Stamp the vector too, so consumers can check staleness
        # against the partition their write landed in. A remote client
        # carries the vector its server stamped (None from an
        # unpartitioned server: no stamp, as in-process).
        vec_fn = getattr(target, "applied_rvs", None)
        if vec_fn is not None:
            try:
                vec = vec_fn()
            except APIError:
                vec = None  # backend blip: the rows still stand
            if vec is not None:
                body["servedRvPartitions"] = {
                    str(p): int(rv) for p, rv in vec.items()
                }
        return body

    # -- listing pagination -------------------------------------------------

    def serve_listing_page(
        self,
        key: Any,
        build: Callable[[], list],
        request: Request,
        kinds: tuple[str, ...] = (),
    ) -> tuple[list, str, bool]:
        """:meth:`serve_listing` plus kube-style pagination from the
        request's ``?limit=&continue=``: returns (page of rows, next
        continue token — "" when exhausted, degraded). Without a
        ``limit`` param the full listing serves as before (token "").

        The continue token pins the mirror versions of the listing's
        whole read set; a token presented after ANY of those kinds
        changed raises :class:`Expired` (410 body via the APIError
        handler) — offsets into a changed listing would silently skip
        or repeat rows, so the client restarts from the first page
        (the same contract the apiserver's continue tokens carry)."""
        # versions read ONCE, BEFORE the rows are built (and handed to
        # serve_listing so it doesn't poke the whole read set again): a
        # write landing mid-build can only make the rows NEWER than the
        # token's tag, so the next page 410s (a conservative restart)
        # instead of applying an offset into a silently different row
        # list
        versions_fn = getattr(self.api, "listing_versions", None)
        versions = versions_fn(kinds) if versions_fn is not None else None
        rows, degraded = self.serve_listing(
            key, build, kinds=kinds, versions=versions
        )
        raw_limit = request.query.get("limit", "")
        cont = request.query.get("continue", "")
        if not raw_limit and not cont:
            return rows, "", degraded
        try:
            limit = int(raw_limit) if raw_limit else 50
        except ValueError:
            raise HTTPError(400, f"limit {raw_limit!r} is not numeric") from None
        limit = max(limit, 1)
        # store-served apps have no cheap version; fall back to the row
        # count as the staleness tag (weaker, still catches growth)
        tag = list(versions) if versions is not None else [len(rows)]
        offset = 0
        if cont:
            payload = decode_continue(cont)
            if payload.get("v") != tag:
                raise Expired(
                    "listing changed since this continue token was "
                    "issued; restart from the first page"
                )
            offset = max(int(payload.get("o", 0)), 0)
        page = rows[offset : offset + limit]
        token = ""
        if offset + limit < len(rows):
            token = encode_continue({"o": offset + limit, "v": tag})
        return page, token, degraded

    def listing_response(
        self,
        field: str,
        key: Any,
        build: Callable[[], list],
        request: Request,
        kinds: tuple[str, ...] = (),
    ):
        """The standard listing endpoint body: rows (paginated when the
        request asks, via ``?limit=&continue=``), the degraded marker,
        and the next continue token under ``"continue"``."""
        rows, cont, degraded = self.serve_listing_page(
            key, build, request, kinds=kinds
        )
        body = self.listing_body(field, rows, degraded)
        if cont:
            body["continue"] = cont
        return success(body)

    # -- shared status/event treatment (reference:
    # crud-web-apps/common/backend/.../status.py — every app derives
    # status and mines error events the same way) -------------------------

    def event_rows(self, namespace: str, match) -> list:
        """Event feed for a resource's details drawer: every event whose
        involvedObject satisfies ``match``, newest first, in the shape
        the common frontend's events table renders."""
        rows = []
        for event in self.api.list("Event", namespace=namespace):  # unbounded-ok: cache-served zero-copy read
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
        for event in self.api.list("Event", namespace=namespace):  # unbounded-ok: cache-served zero-copy read
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
