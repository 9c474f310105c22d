"""Kubernetes-convention REST façade over the embedded APIServer (the
port's copy of the JAX package's ``machinery/httpapi.py``).

The reference talks to a real kube-apiserver; this module gives the
embedded store the same wire surface so the platform's components run as
*separate processes* exactly as the manifests deploy them
(`manifests/*/manifests.yaml` command lines), with
``machinery.client.RemoteAPIServer`` as the in-process client on the
other end.

Paths follow upstream conventions:

    /api/v1/namespaces/{ns}/{plural}[/{name}[/status]]
    /api/v1/{plural}[/{name}]                        (cluster-scoped core)
    /apis/{group}/{version}/namespaces/{ns}/{plural}[/{name}[/status]]
    /apis/{group}/{version}/{plural}[/{name}[/status]]
    ?labelSelector=k=v,k2   on lists
    ?watch=true             streams {"type","object"} JSON lines
                            (k8s watch framing), HEARTBEAT lines as
                            keep-alive
    /healthz /readyz /version

Verb → store mapping: GET(list/get), POST(create), PUT(update or
update_status), PATCH(json-merge-patch), DELETE. Store errors map to the
same HTTP codes kube-apiserver uses (404/409/409/422/403).

Overload defense (``machinery/overload.py``): ``InflightLimiter`` admits
per client and per priority level, an expired ``X-Request-Deadline`` is
a 504 before a seat is taken, and ``/debug/...`` serves the zpages.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Optional
from urllib.parse import parse_qs
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server
from socketserver import ThreadingMixIn

from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery import serialize
from odh_kubeflow_tpu_torch.machinery.cache import SerializedBytesCache
from odh_kubeflow_tpu_torch.machinery.eventloop import (
    EventLoopServer,
    WatchBody,
    event_loop_enabled,
)
from odh_kubeflow_tpu_torch.machinery import overload, zpages
from odh_kubeflow_tpu_torch.utils import prometheus, tracing
from odh_kubeflow_tpu_torch.utils.prometheus import Registry
from odh_kubeflow_tpu_torch.machinery.store import (
    AlreadyExists,
    APIError,
    APIServer,
    BadRequest,
    Conflict,
    DeadlineExceeded,
    Denied,
    Expired,
    FencedOut,
    Invalid,
    NotFound,
    NotLeader,
    TooManyRequests,
    reset_fence,
    set_fence,
)

Obj = dict[str, Any]

_STATUS = {
    NotFound: 404,
    AlreadyExists: 409,
    Conflict: 409,
    Invalid: 422,
    # 403 like Denied, but with its own Status.reason so the client
    # re-raises FencedOut (a deposed controller must stand down, not
    # treat it as an RBAC denial)
    FencedOut: 403,
    Denied: 403,
    BadRequest: 400,
    Expired: 410,
    TooManyRequests: 429,
    # the request's end-to-end deadline expired before the work
    # completed; the caller already gave up (machinery.overload)
    DeadlineExceeded: 504,
    # kube-style leader redirect: a mutation hit a read replica; the
    # Status reason is NotLeader and Location points at the leader
    NotLeader: 307,
}

WATCH_HEARTBEAT_SECONDS = 15.0

# the replication stream's CONTROL frame cadence: each frame carries the
# leader's rv, epoch and wall clock (lag denominator, liveness signal)
REPLICATION_HEARTBEAT_SECONDS = 1.0

# APF-lite default: per-client concurrent (non-watch) request cap.
# kube-apiserver's Priority & Fairness rejects excess work with 429 +
# Retry-After instead of queueing it unboundedly; so do we. 0 disables.
DEFAULT_INFLIGHT_LIMIT = int(os.environ.get("APF_INFLIGHT_LIMIT", "256"))
INFLIGHT_RETRY_AFTER_SECONDS = 1.0


class InflightLimiter:
    """Per-client inflight counter (APF-lite) with priority levels.
    ``try_acquire`` admits up to ``limit`` concurrent requests per
    client identity and sheds the rest — the caller turns a False into
    a 429 with Retry-After. Watches are exempt (long-running, same as
    kube's APF).

    Priority-aware shedding (machinery.overload): the same ``limit``
    also bounds GLOBAL inflight, with cumulative per-level ceilings
    (``APF_LEVEL_*``, percent of the limit) — user traffic can only
    ever fill part of the pool, so system traffic (lease renewals,
    fencing, replication) always has admission headroom and is never
    starved by a user-load flood.

    Deadline-aware: a request whose propagated end-to-end deadline has
    already expired raises :class:`DeadlineExceeded` from
    ``try_acquire`` — it is shed with 504 *before* consuming a seat
    (the client gave up; serving it is amplification, and admitting it
    would let dead work crowd out live work)."""

    def __init__(
        self,
        limit: int,
        retry_after: float = INFLIGHT_RETRY_AFTER_SECONDS,
        registry: Optional[Registry] = None,
    ):
        self.limit = limit
        self.retry_after = retry_after
        self._lock = threading.Lock()
        self._inflight: dict[str, int] = {}
        self._total = 0
        self._ceilings = overload.level_ceilings(limit)
        self._m_shed = None
        if registry is not None:
            self._m_shed = registry.counter(
                "inflight_shed_total",
                "Requests shed at admission, by priority level and "
                "shed reason (per-client cap, level ceiling, or an "
                "already-expired deadline)",
                labelnames=("level", "reason"),
            )

    def _shed(self, level: int, reason: str) -> None:
        if self._m_shed is not None:
            self._m_shed.inc(
                {"level": overload.LEVEL_NAMES[level], "reason": reason}
            )

    def try_acquire(
        self,
        client: str,
        level: int = overload.LEVEL_USER,
        deadline: Optional[float] = None,
    ) -> bool:
        if deadline is None:
            deadline = overload.current_deadline()
        if deadline is not None and deadline <= time.monotonic():
            self._shed(level, "deadline")
            raise DeadlineExceeded(
                "request deadline expired before admission"
            )
        with self._lock:
            n = self._inflight.get(client, 0)
            if n >= self.limit:
                per_client_full = True
            elif self._total >= self._ceilings[level]:
                per_client_full = False
            else:
                self._inflight[client] = n + 1
                self._total += 1
                return True
        self._shed(level, "client" if per_client_full else "level")
        return False

    def release(self, client: str) -> None:
        with self._lock:
            n = self._inflight.get(client, 0) - 1
            if n <= 0:
                self._inflight.pop(client, None)
            else:
                self._inflight[client] = n
            if self._total > 0:
                self._total -= 1


def _retry_after_header(seconds: float) -> tuple[str, str]:
    """RFC 9110 delta-seconds is an INTEGER: a float ("1.0") reads as
    absent to conformant clients (client-go, urllib3), defeating the
    backpressure. Round up so the hint never undershoots."""
    return ("Retry-After", str(max(1, math.ceil(seconds))))


def _err_status(e: APIError) -> int:
    for klass, code in _STATUS.items():
        if isinstance(e, klass):
            return code
    return 500


class _Route:
    """Parsed resource path."""

    def __init__(self, plural: str, namespace: Optional[str], name: Optional[str],
                 subresource: Optional[str]):
        self.plural = plural
        self.namespace = namespace
        self.name = name
        self.subresource = subresource


def _parse_path(path: str) -> Optional[_Route]:
    parts = [p for p in path.split("/") if p]
    if not parts:
        return None
    if parts[0] == "api":
        parts = parts[2:] if len(parts) >= 2 and parts[1] == "v1" else None
    elif parts[0] == "apis":
        # /apis/{group}/{version}/...
        parts = parts[3:] if len(parts) >= 3 else None
    else:
        return None
    if parts is None:
        return None
    ns = None
    if len(parts) >= 2 and parts[0] == "namespaces" and len(parts) > 2:
        # /namespaces/{ns}/{plural}/... — but /namespaces and
        # /namespaces/{name} address the Namespace kind itself
        ns, parts = parts[1], parts[2:]
    if not parts:
        return None
    plural = parts[0]
    name = parts[1] if len(parts) > 1 else None
    sub = parts[2] if len(parts) > 2 else None
    return _Route(plural, ns, name, sub)


class TokenAuthenticator:
    """Static bearer-token authn, kube's ``--token-auth-file`` model.

    ``tokens`` maps token → username. ``from_file`` reads the upstream
    CSV format (``token,user,uid[,"group1,group2"]``; kube-apiserver
    docs "static token file") so a test or standalone deployment can
    mint credentials the same way. Returns the username for a valid
    ``Authorization: Bearer`` header, else None (→ 401 at the façade).
    """

    def __init__(self, tokens: dict[str, str]):
        self._tokens = dict(tokens)

    @classmethod
    def from_file(cls, path: str) -> "TokenAuthenticator":
        import csv

        tokens: dict[str, str] = {}
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if len(row) >= 2 and row[0].strip():
                    tokens[row[0].strip()] = row[1].strip()
        return cls(tokens)

    def __call__(self, environ) -> Optional[str]:
        auth = environ.get("HTTP_AUTHORIZATION", "")
        if not auth.startswith("Bearer "):
            return None
        return self._tokens.get(auth[len("Bearer "):].strip())


class RestAPI:
    """WSGI app. Thread-safe (the store locks internally)."""

    def __init__(
        self,
        server: APIServer,
        authenticator: Optional[Any] = None,  # environ -> username | None
        metrics_registry: Optional[Registry] = None,
        inflight_limit: Optional[int] = None,
        usage_meter: Optional[Any] = None,
    ):
        self.server = server
        self.authenticator = authenticator
        # served at /metrics when given (anonymous, like the health
        # probes — the controller-runtime metrics-listener posture)
        self.metrics_registry = metrics_registry
        # backs the /debug/usage zpage (chip-hour ledger timelines)
        self.usage_meter = usage_meter
        limit = DEFAULT_INFLIGHT_LIMIT if inflight_limit is None else inflight_limit
        self.limiter = (
            InflightLimiter(limit, registry=metrics_registry)
            if limit > 0
            else None
        )
        # per-(kind, rv) serialized-bytes cache: list responses compose
        # from per-object bytes and watch events serialize ONCE for all
        # subscribers
        self.bytes_cache = SerializedBytesCache()

    # -- helpers ------------------------------------------------------------

    def _resolve_kind(self, plural: str) -> str:
        return self.server.kind_for_plural(plural)

    def _json(
        self, status: int, body: Obj, start_response, headers=()
    ) -> list[bytes]:
        return self._raw(status, serialize.dumps(body), start_response, headers)

    def _object(
        self, status: int, obj: Obj, start_response, headers=()
    ) -> list[bytes]:
        """Single-object response through the bytes cache — a GET of an
        unchanged object (same rv) is a cache hit, and the bytes are
        shared with the list/watch views of the same rv."""
        return self._raw(status, self.bytes_cache.obj_bytes(obj), start_response, headers)

    @staticmethod
    def _raw(
        status: int, payload: bytes, start_response, headers=()
    ) -> list[bytes]:
        start_response(
            f"{status} {'OK' if status < 400 else 'Error'}",
            [
                ("Content-Type", "application/json"),
                ("Content-Length", str(len(payload))),
                *headers,
            ],
        )
        return [payload]

    def _error(
        self, status: int, message: str, start_response, reason: str = "", headers=()
    ) -> list[bytes]:
        return self._json(
            status,
            {
                "kind": "Status",
                "apiVersion": "v1",
                "status": "Failure",
                "message": message,
                # structured reason (k8s Status.reason) so clients never
                # have to sniff message substrings
                "reason": reason,
                "code": status,
            },
            start_response,
            headers=headers,
        )

    def _watch_stream(self, w) -> WatchBody:
        """Wrap a store Watch for streaming. The event-loop server
        pumps the returned body on the loop (no thread pinned); plain
        WSGI consumers iterate it (one blocking thread, the old
        behaviour). Framing goes through the serialized-bytes cache:
        the same event fans the SAME bytes to every subscriber, so one
        store write costs one serialization no matter how many watch
        streams are connected."""
        frame = lambda item: self.bytes_cache.event_bytes(*item)  # noqa: E731
        return WatchBody(w, frame, heartbeat=WATCH_HEARTBEAT_SECONDS)

    # -- WSGI ---------------------------------------------------------------

    def __call__(self, environ, start_response):
        if (
            environ.get("PATH_INFO", "/") == "/metrics"
            and self.metrics_registry is not None
        ):
            # anonymous, like the health probes: controller-runtime
            # serves its metrics listener without authn too.
            # Content-negotiated: Accept: application/openmetrics-text
            # gets the exemplar-bearing OpenMetrics dialect (the
            # metric→trace pivot), everything else the byte-stable
            # plain text.
            om = prometheus.negotiate_openmetrics(environ.get("HTTP_ACCEPT"))
            payload = self.metrics_registry.exposition(openmetrics=om).encode()
            start_response(
                "200 OK",
                [
                    (
                        "Content-Type",
                        prometheus.OPENMETRICS_CONTENT_TYPE
                        if om
                        else prometheus.PLAIN_CONTENT_TYPE,
                    ),
                    ("Content-Length", str(len(payload))),
                ],
            )
            return [payload]
        if environ.get("PATH_INFO", "/").startswith("/debug/"):
            # zpages (machinery/zpages.py): recent slow/error traces,
            # the span-ingest endpoint split-process components ship
            # spans to, queue depths, the lock page and usage timelines
            resp = zpages.handle_debug(
                environ,
                start_response,
                registry=self.metrics_registry,
                api=self.server,
                meter=self.usage_meter,
            )
            if resp is not None:
                return resp
        # an inbound traceparent joins this request to the caller's
        # trace: every store op (and admission hook) below runs inside
        # the span, so the CREATE path stamps the caller's trace id
        remote = tracing.parse_traceparent(environ.get("HTTP_TRACEPARENT"))
        if remote is None:
            return self._handle(environ, start_response)
        attrs = {}
        if "odh=controller" in environ.get("HTTP_TRACESTATE", ""):
            # reconcile-originated call (client.py's tracestate marker):
            # the store must treat its creates like embedded reconcile
            # writes and skip the trace-annotation stamp
            attrs["controller"] = "remote"
        with tracing.span(
            "apiserver", parent=tracing.nested_parent(remote), **attrs
        ):
            return self._handle(environ, start_response)

    def _handle(self, environ, start_response):
        path = environ.get("PATH_INFO", "/")
        method = environ.get("REQUEST_METHOD", "GET")
        qs = parse_qs(environ.get("QUERY_STRING", ""))

        if path in ("/healthz", "/readyz", "/livez"):
            # health probes stay anonymous (kube's
            # --anonymous-auth allows exactly these by default)
            start_response("200 OK", [("Content-Type", "text/plain")])
            return [b"ok"]
        if self.authenticator is not None:
            user = self.authenticator(environ)
            if user is None:
                start_response(
                    "401 Unauthorized",
                    [
                        ("Content-Type", "application/json"),
                        ("WWW-Authenticate", "Bearer"),
                    ],
                )
                return [
                    serialize.dumps(
                        {
                            "kind": "Status",
                            "status": "Failure",
                            "message": "Unauthorized",
                            "reason": "Unauthorized",
                            "code": 401,
                        }
                    )
                ]
            environ["odh.authenticated.user"] = user
        if path == "/version":
            return self._json(
                200, {"gitVersion": "odh-kubeflow-tpu-torch", "major": "1"}, start_response
            )
        if (
            method == "POST"
            and path == "/apis/authorization.k8s.io/v1/subjectaccessreviews"
        ):
            return self._subject_access_review(environ, start_response)
        if path.startswith("/replication/"):
            try:
                return self._replication(path, method, qs, start_response)
            except APIError as e:
                return self._error(
                    _err_status(e), str(e), start_response, reason=type(e).__name__
                )

        route = _parse_path(path)
        if route is None:
            return self._error(404, f"unrecognised path {path}", start_response)

        try:
            kind = self._resolve_kind(route.plural)
        except NotFound as e:
            return self._error(404, str(e), start_response)

        # the caller's fencing epoch (namespace/lease/token): a deposed
        # holder's write is rejected by the store atomically with the apply
        fence = None
        raw_fence = environ.get("HTTP_X_FENCING_TOKEN", "")
        if raw_fence:
            parts = raw_fence.split("/")
            if len(parts) != 3:
                return self._error(
                    400,
                    f"malformed X-Fencing-Token {raw_fence!r} "
                    "(want namespace/lease/token)",
                    start_response,
                    reason="BadRequest",
                )
            try:
                fence = (parts[0], parts[1], int(parts[2]))
            except ValueError:
                return self._error(
                    400,
                    f"non-numeric fencing token in {raw_fence!r}",
                    start_response,
                    reason="BadRequest",
                )

        # the propagated end-to-end deadline (X-Request-Deadline,
        # remaining delta-seconds) re-anchors on THIS host's monotonic
        # clock; parsed before admission — a malformed value is
        # a 400 that must not leak an inflight slot, and an already-
        # expired deadline sheds with 504 BEFORE any work
        try:
            deadline = overload.environ_deadline(environ)
        except ValueError:
            return self._error(
                400,
                "malformed X-Request-Deadline "
                f"{environ.get('HTTP_X_REQUEST_DEADLINE', '')!r} "
                "(want remaining seconds)",
                start_response,
                reason="BadRequest",
            )
        # APF priority level: explicit self-declaration header, else
        # system for the fleet's own consistency traffic (Lease
        # renewals), controller for reconcile-originated calls, user
        # otherwise
        level = overload.classify(
            kind=kind,
            path=path,
            header=environ.get("HTTP_X_PRIORITY_LEVEL"),
            controller="odh=controller" in environ.get("HTTP_TRACESTATE", ""),
        )

        # APF-lite admission: cap concurrent non-watch requests per
        # client identity AND per priority level (cumulative ceilings —
        # user traffic cannot fill the seats system traffic needs),
        # shedding excess with 429 + Retry-After instead of queueing
        # unboundedly in the thread pool. Watches are exempt
        # (long-running, kube's APF posture) — but ONLY what _dispatch
        # actually serves as a watch (collection GETs); ?watch=true on
        # a named resource is an ordinary read and must not buy its
        # way past the limiter.
        is_watch = (
            method == "GET"
            and route.name is None
            and qs.get("watch", ["false"])[0] in ("true", "1")
        )
        client = None
        if self.limiter is not None and not is_watch:
            client = environ.get("odh.authenticated.user") or environ.get(
                "REMOTE_ADDR", "anonymous"
            )
            try:
                admitted = self.limiter.try_acquire(
                    client, level=level, deadline=deadline
                )
            except DeadlineExceeded as e:
                return self._error(
                    504, str(e), start_response, reason="DeadlineExceeded"
                )
            if not admitted:
                return self._error(
                    429,
                    f"too many in-flight requests for client {client!r}",
                    start_response,
                    reason="TooManyRequests",
                    headers=[_retry_after_header(self.limiter.retry_after)],
                )
        elif deadline is not None and deadline <= time.monotonic():
            # no limiter (or watch): the pre-work deadline shed still
            # applies — dead work is amplification either way
            return self._error(
                504,
                "request deadline expired before dispatch",
                start_response,
                reason="DeadlineExceeded",
            )
        # re-install the parsed fence AND deadline on this handler's
        # context so the store validates the epoch atomically with the
        # apply and every downstream stage (the ack wait) sees the same
        # time budget, same as the embedded path
        fence_reset = set_fence(fence) if fence is not None else None
        deadline_reset = (
            overload.set_deadline(deadline) if deadline is not None else None
        )
        try:
            return self._dispatch(kind, route, method, qs, environ, start_response)
        except APIError as e:
            # fencing-ok: protocol boundary — FencedOut maps to a 403 +
            # Status(reason=FencedOut) response; the REMOTE caller is
            # the deposed holder and must stand down, the server keeps
            # serving
            headers = []
            if isinstance(e, TooManyRequests):
                headers.append(_retry_after_header(e.retry_after))
            if isinstance(e, NotLeader) and e.leader_url:
                # kube-style redirect: the Status body says NotLeader,
                # Location points the writer at the leader
                headers.append(
                    ("Location", e.leader_url + environ.get("PATH_INFO", "/"))
                )
            return self._error(
                _err_status(e),
                str(e),
                start_response,
                reason=type(e).__name__,
                headers=headers,
            )
        except Exception as e:  # noqa: BLE001 — surface as 500, keep serving
            return self._error(500, f"{type(e).__name__}: {e}", start_response)
        finally:
            if deadline_reset is not None:
                overload.reset_deadline(deadline_reset)
            if fence_reset is not None:
                reset_fence(fence_reset)
            if client is not None:
                self.limiter.release(client)

    def _subject_access_review(self, environ, start_response):
        """kube's SAR endpoint: the auth-proxy sidecar (and any other
        out-of-process client) asks "may <user> <verb> this resource"
        and the embedded RBAC evaluator answers — the same contract the
        reference's oauth-proxy --openshift-sar flag relies on."""
        from odh_kubeflow_tpu_torch.machinery.rbac import RBACEvaluator

        try:
            body = self._read_body(environ)
        except ValueError:
            return self._error(400, "invalid JSON body", start_response)
        spec = body.get("spec") or {}
        user = spec.get("user", "")
        attrs = spec.get("resourceAttributes") or {}
        allowed = bool(user) and RBACEvaluator(self.server).can(
            user,
            attrs.get("verb", ""),
            attrs.get("resource", ""),
            attrs.get("namespace") or None,
            attrs.get("group", ""),
            name=attrs.get("name") or None,
        )
        return self._json(
            201,
            {
                "kind": "SubjectAccessReview",
                "apiVersion": "authorization.k8s.io/v1",
                "spec": spec,
                "status": {"allowed": allowed},
            },
            start_response,
        )


    def _replication(self, path, method, qs, start_response):
        """The WAL-shipping surface follower replicas pull from:

        - ``GET /replication/snapshot`` — a consistent full-state cut
          (rv, types, objects, kind_rv, watch-cache events, epoch) for
          cold catch-up;
        - ``GET /replication/stream?from=<rv>`` — committed records of
          every kind above ``from``, in rv order, as watch-framed JSON
          lines, interleaved with CONTROL frames carrying the leader's
          current rv/epoch/wall-clock. A ``from`` below the compacted
          window answers 410 (catch up from a snapshot instead).

        When the serving store is a PartitionRouter, ``?partition=<i>``
        scopes both endpoints to that partition's own backend — rv
        spaces are per-partition, so a follower replicates exactly one
        partition's history."""
        if method != "GET":
            raise Invalid(f"unsupported {method} on {path}")
        server = self.server
        if "partition" in qs:
            backend_fn = getattr(server, "partition_backend", None)
            if backend_fn is None:
                raise Invalid(
                    "?partition= on an unpartitioned store; remove the "
                    "parameter or point at the PartitionRouter"
                )
            try:
                server = backend_fn(int(qs["partition"][0]))
            except ValueError:
                raise Invalid(
                    "replication 'partition' must be numeric"
                ) from None
        cut_fn = getattr(server, "replication_cut", None)
        feed_fn = getattr(server, "replication_watch", None)
        if path == "/replication/snapshot" and cut_fn is not None:
            return self._json(200, cut_fn(), start_response)
        if path == "/replication/stream" and feed_fn is not None:
            try:
                from_rv = int(qs.get("from", ["0"])[0])
            except ValueError:
                raise Invalid("replication 'from' rv must be numeric") from None
            w = feed_fn(from_rv)  # Expired → the caller's 410 mapping
            start_response(
                "200 OK",
                [("Content-Type", "application/json"), ("X-Stream", "replication")],
            )
            return WatchBody(
                w,
                self._replication_frame,
                heartbeat=REPLICATION_HEARTBEAT_SECONDS,
                heartbeat_fn=lambda: self._replication_control_line(server),
            )
        return self._error(404, f"unrecognised path {path}", start_response)

    def _replication_frame(self, item) -> bytes:
        etype, obj = item
        if etype == "REGISTER":
            return b'{"type": "REGISTER", "object": ' + serialize.dumps(obj) + b"}\n"
        return self.bytes_cache.event_bytes(etype, obj)

    def _replication_control_line(self, server=None) -> bytes:
        server = self.server if server is None else server
        control_fn = getattr(server, "replication_control", None)
        if control_fn is not None:
            # a PartitionRouter's heartbeat: the per-partition
            # (rv, epoch) vector — one scalar cannot describe N
            # independent rv spaces
            return serialize.dumps(control_fn()) + b"\n"
        return (
            serialize.dumps(
                {
                    "type": "CONTROL",
                    "rv": server.applied_rv(),
                    "epoch": getattr(server, "replication_epoch", 0),
                    "ts": time.time(),
                }
            )
            + b"\n"
        )
    def _read_body(self, environ) -> Obj:
        length = int(environ.get("CONTENT_LENGTH") or 0)
        raw = environ["wsgi.input"].read(length) if length else b"{}"
        return json.loads(raw.decode() or "{}")

    def _rv_headers(self) -> list[tuple[str, str]]:
        """``X-Served-RV``: the applied-rv horizon this read was served
        at — on a follower, the bounded-staleness contract made
        visible per response. A partitioned store (whose scalar horizon
        sums independent rv spaces) also stamps its per-partition vector
        in ``X-Served-RV-Partitions`` (``0=12,1=9,…``), which a remote
        client mirrors as ``applied_rvs()``."""
        fn = getattr(self.server, "applied_rv", None)
        out = [("X-Served-RV", str(fn()))] if fn is not None else []
        vec_fn = getattr(self.server, "applied_rvs", None)
        if vec_fn is not None:
            out.append(("X-Served-RV-Partitions",
                        ",".join(f"{p}={rv}" for p, rv in sorted(vec_fn().items()))))
        return out

    def _await_rv(self, rv) -> None:
        """rv-pinned read against a store that can lag (a follower
        replica): wait — bounded — for replication to reach the pinned
        horizon, else 410 (the wait-or-410 contract). The leader has
        no ``wait_for_rv``: every rv it ever issued is already
        applied when a read runs, so the pin is a no-op there."""
        if rv is None:
            return
        wait_fn = getattr(self.server, "wait_for_rv", None)
        if wait_fn is None:
            return
        try:
            wait_fn(int(rv))  # Expired on timeout → the 410 mapping
        except (TypeError, ValueError):
            raise Invalid(f"resourceVersion {rv!r} is not numeric") from None

    def _dispatch(self, kind, route, method, qs, environ, start_response):
        ns, name = route.namespace, route.name

        if method == "GET" and name is None:
            if qs.get("watch", ["false"])[0] in ("true", "1"):
                send_initial = qs.get("sendInitialEvents", ["true"])[0] != "false"
                rv = qs.get("resourceVersion", [None])[0]
                # a replica waits (bounded) for its replication stream
                # to reach a pinned resume rv before opening — the
                # wait-or-410 half of the bounded-staleness contract
                self._await_rv(rv)
                # the watch opens BEFORE streaming starts so a 410
                # Expired resume surfaces as a proper Status response
                # (raised here → the APIError handler), not a broken
                # stream
                # inline=False: HTTP streams are fanned out by the
                # store's dispatcher shards, never the mutator
                w = self.server.watch(
                    kind,
                    namespace=ns,
                    send_initial=send_initial,
                    resource_version=rv,
                    inline=False,
                )
                start_response(
                    "200 OK",
                    [("Content-Type", "application/json"), ("X-Stream", "watch")],
                )
                return self._watch_stream(w)
            # rv-pinned list against a replica: wait for the horizon
            # (or 410), then serve — reads never go back in time past
            # an rv the client already observed on the leader
            self._await_rv(qs.get("resourceVersion", [None])[0])
            # the horizon header is read BEFORE the list: a racing
            # writer can only make the served state NEWER than the
            # advertised rv, never staler
            rv_hdrs = self._rv_headers()
            selector = None
            if "labelSelector" in qs:
                selector = obj_util.parse_selector_string(qs["labelSelector"][0])
            limit_q = qs.get("limit", [None])[0]
            cont_q = qs.get("continue", [None])[0]
            if limit_q is not None:
                try:
                    lim_val = int(limit_q)
                except ValueError:
                    raise Invalid(
                        f"limit {limit_q!r} is not numeric"
                    ) from None
                if lim_val <= 0 and not cont_q:
                    # kube semantics: limit<=0 means no limit — serve
                    # the full collection via the legacy path below
                    limit_q = None
            if limit_q is not None or cont_q:
                # kube-style paginated list: limit + opaque continue
                # token in ListMeta. A token that predates the
                # compacted window raises Expired → the 410 Status
                # mapping below; the client restarts from a fresh
                # list. Pages compose from per-object cached bytes.
                lim = int(limit_q) if limit_q else 0
                items, token = self.server.list_chunk(
                    kind,
                    namespace=ns,
                    label_selector=selector,
                    limit=lim or None,
                    continue_token=cont_q or None,
                )
                return self._raw(
                    200,
                    self.bytes_cache.list_bytes(kind, items, continue_token=token),
                    start_response,
                    headers=rv_hdrs,
                )
            ver_fn = getattr(self.server, "kind_version", None)
            if ver_fn is not None:
                # whole-list payload cache: a kind's list output is
                # immutable between bumps of its per-kind version
                lkey = (kind, ns or "", qs.get("labelSelector", [""])[0], ver_fn(kind))
                payload = self.bytes_cache.list_payload(lkey)
                if payload is None:
                    items = self.server.list(kind, namespace=ns, label_selector=selector)
                    payload = self.bytes_cache.list_bytes(kind, items)
                    self.bytes_cache.store_list_payload(lkey, payload)
                return self._raw(200, payload, start_response, headers=rv_hdrs)
            items = self.server.list(kind, namespace=ns, label_selector=selector)
            # composed from per-object cached bytes: a repeat list of
            # unchanged objects (same rvs) serializes NOTHING — the hot
            # cached-namespace-list path is a memcpy join
            return self._raw(
                200,
                self.bytes_cache.list_bytes(kind, items),
                start_response,
                headers=rv_hdrs,
            )

        if method == "GET":
            self._await_rv(qs.get("resourceVersion", [None])[0])
            return self._object(
                200,
                self.server.get(kind, name, ns),
                start_response,
                headers=self._rv_headers(),
            )

        if method == "POST" and name is None:
            obj = self._read_body(environ)
            obj.setdefault("kind", kind)
            if ns and not obj.setdefault("metadata", {}).get("namespace"):
                obj["metadata"]["namespace"] = ns
            dry = qs.get("dryRun", [""])[0] == "All"
            created = self.server.create(obj, dry_run=dry)
            if dry:
                # NOT through the bytes cache: a dry-run echo carries
                # whatever resourceVersion the client sent, and caching
                # bytes under a forged (name, rv) would poison later
                # reads of the real object at that rv
                return self._json(201, created, start_response)
            return self._object(201, created, start_response)

        if method == "PUT" and name is not None:
            obj = self._read_body(environ)
            obj.setdefault("kind", kind)
            # kube-apiserver semantics: the body may omit namespace (the
            # URL supplies it) but must not contradict the URL — 400.
            meta = obj.setdefault("metadata", {})
            if ns and not meta.get("namespace"):
                meta["namespace"] = ns
            if meta.get("name") != name or (ns and meta.get("namespace") != ns):
                raise BadRequest(
                    f"body metadata ({meta.get('namespace')}/{meta.get('name')}) "
                    f"does not match URL ({ns}/{name})"
                )
            if route.subresource == "status":
                return self._object(
                    200, self.server.update_status(obj), start_response
                )
            return self._object(200, self.server.update(obj), start_response)

        if method == "PATCH" and name is not None:
            patch = self._read_body(environ)
            pmeta = patch.get("metadata", {}) if isinstance(patch, dict) else {}
            if pmeta.get("name", name) != name or (
                ns and pmeta.get("namespace", ns) != ns
            ):
                raise BadRequest(
                    "patch may not change metadata.name/namespace "
                    f"({pmeta.get('namespace')}/{pmeta.get('name')} vs URL {ns}/{name})"
                )
            return self._object(
                200, self.server.patch(kind, name, patch, ns), start_response
            )

        if method == "DELETE" and name is not None:
            self.server.delete(kind, name, ns)
            return self._json(200, {"status": "Success"}, start_response)

        raise Invalid(f"unsupported {method} on {route.plural}")


class _ThreadingServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True
    # long-lived watch streams must not serialize behind each other
    request_queue_size = 64


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, *args):  # noqa: D102 — stdlib signature
        pass


def serve(
    server: APIServer,
    host: str = "127.0.0.1",
    port: int = 0,
    ssl_context: Optional[Any] = None,
    authenticator: Optional[Any] = None,
    metrics_registry: Optional[Registry] = None,
    inflight_limit: Optional[int] = None,
    event_loop: Optional[bool] = None,
    workers: Optional[int] = None,
    usage_meter: Optional[Any] = None,
) -> tuple[threading.Thread, int, Any]:
    """Serve the REST façade; returns (thread, bound_port, httpd).
    ``httpd.shutdown()`` stops it.

    Serving defaults to the asyncio event loop
    (``machinery/eventloop.py``): all connections and watch streams
    multiplex on one loop thread (a watch no longer pins a thread for
    its lifetime) and handler bodies run in a small worker pool.
    ``event_loop=False`` / ``WEB_EVENT_LOOP=false`` keeps the legacy
    thread-per-request server.

    ``ssl_context`` (an ``ssl.SSLContext``) serves HTTPS — the posture
    a real kube-apiserver always has; ``authenticator`` (see
    ``TokenAuthenticator``) turns on bearer authn, rejecting anonymous
    requests with 401 except on health probes; ``metrics_registry``
    exposes Prometheus text exposition at ``/metrics``."""
    app = RestAPI(
        server,
        authenticator=authenticator,
        metrics_registry=metrics_registry,
        inflight_limit=inflight_limit,
        usage_meter=usage_meter,
    )
    if event_loop is None:
        event_loop = event_loop_enabled()
    if event_loop:
        srv = EventLoopServer(
            app, host=host, port=port, ssl_context=ssl_context, workers=workers
        )
        return srv._thread, srv.server_address[1], srv
    httpd = make_server(
        host, port, app, server_class=_ThreadingServer, handler_class=_QuietHandler
    )
    if ssl_context is not None:
        httpd.socket = ssl_context.wrap_socket(httpd.socket, server_side=True)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return t, httpd.server_address[1], httpd
