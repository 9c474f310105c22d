"""HTTP client for the platform API server, duck-typed to
``machinery.store.APIServer`` (the port's copy of the JAX package's
``machinery/client.py``: ``RemoteAPIServer``, the read-spreading
``ReplicaFanout`` and ``api_from_env``).

Controllers, webhooks, and web backends take an ``APIServer``-shaped
object; handing them a ``RemoteAPIServer`` instead runs the identical
code against a remote API over the REST façade (``machinery.httpapi``)
— the same split the reference deploys (every component is a separate
process talking to kube-apiserver; SURVEY.md §1 control flow). Admission
hooks are the one server-side concern: ``register_admission_hook`` here
is a no-op because mutation/validation happens inside the serving
process (or via the AdmissionReview webhook deployment).
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import socket
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import OrderedDict
from typing import Any, Optional

from odh_kubeflow_tpu_torch.analysis import sanitizer as _sanitizer
from odh_kubeflow_tpu_torch.machinery import backoff, objects as obj_util, overload
from odh_kubeflow_tpu_torch.utils import prometheus, tracing
from odh_kubeflow_tpu_torch.machinery.store import (
    AlreadyExists,
    APIError,
    BadRequest,
    Conflict,
    DeadlineExceeded,
    Denied,
    Expired,
    FencedOut,
    Invalid,
    NotFound,
    NotLeader,
    paged_list_all,
    TooManyRequests,
    TypeInfo,
    Unauthorized,
    current_fence as store_fence,
    Watch,
)

log = logging.getLogger("machinery.client")

Obj = dict[str, Any]

_ERR_BY_CODE = {
    400: BadRequest,
    401: Unauthorized,
    404: NotFound,
    409: Conflict,
    410: Expired,
    422: Invalid,
    403: Denied,
    429: TooManyRequests,
    504: DeadlineExceeded,
}
_REASON_TO_ERR = {
    "AlreadyExists": AlreadyExists,
    "BadRequest": BadRequest,
    "Conflict": Conflict,
    "NotFound": NotFound,
    "Invalid": Invalid,
    "Denied": Denied,
    "Unauthorized": Unauthorized,
    "Expired": Expired,
    "FencedOut": FencedOut,
    "TooManyRequests": TooManyRequests,
    # the end-to-end deadline expired server-side (504): the time
    # budget is spent — never retried, whatever the verb
    "DeadlineExceeded": DeadlineExceeded,
    # a mutation hit a read replica: the caller must write to the
    # leader (the 307's Location header / the split client's write arm)
    "NotLeader": NotLeader,
}
_EVENT_INDEX_MAX = 4096

# Retry policy (the verb × error table in docs/GUIDE.md): a 429 was
# never executed server-side, so every verb retries it after the
# Retry-After wait; 5xx and network errors retry only verbs that are
# safe to repeat when the first attempt MAY have been executed — reads.
# Mutations surface immediately (their callers already run level-
# triggered reconcile loops / optimistic-concurrency retries).
_IDEMPOTENT_VERBS = frozenset({"GET"})


_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class RemoteAPIServer:
    """Credential model mirrors client-go's rest.Config (the reference
    builds it with ``ctrl.GetConfigOrDie()`` +
    ``--kube-api-qps/--kube-api-burst``, notebook-controller
    ``main.go:61-81``):
    bearer token (inline or file — file is re-read on mtime change,
    because bound serviceaccount tokens rotate), a custom CA bundle for
    the apiserver's certificate, and optional mTLS client certs.
    """

    def __init__(
        self,
        base_url: str = "http://127.0.0.1:8001",
        timeout: float = 30.0,
        qps: Optional[float] = None,
        burst: int = 10,
        token: Optional[str] = None,
        token_file: Optional[str] = None,
        ca_file: Optional[str] = None,
        client_cert_file: Optional[str] = None,
        client_key_file: Optional[str] = None,
        insecure_skip_tls_verify: bool = False,
        retries: int = 4,
        retry_base: float = 0.05,
        retry_cap: float = 2.0,
        page_size: Optional[int] = None,
        registry: Optional[prometheus.Registry] = None,
        follow_not_leader: int = 1,
        retry_budget: Optional[overload.RetryBudget] = None,
        breaker: Optional[overload.CircuitBreaker] = None,
        priority_level: Optional[str] = None,
    ):
        self.base_url = base_url.rstrip("/")
        # 307 NotLeader hops to follow transparently before surfacing
        # the error: a write sent to a read replica is retried against
        # the leader its Location names. 0 = surface every redirect.
        self.follow_not_leader = max(int(follow_not_leader), 0)
        # sent as X-Priority-Level on every call when set (one of
        # overload.LEVEL_NAMES); None lets the server classify
        self.priority_level = priority_level
        self.timeout = timeout
        # kube client-go pager posture: with a page size, list() walks
        # the collection in limit-sized chunks via continue tokens —
        # no fleet-sized payload ever crosses the wire in one response.
        # None = single unpaginated request (legacy behaviour).
        self.page_size = page_size
        # shared backoff policy (machinery.backoff): `retries` total
        # attempts, exponential + decorrelated jitter between them
        self.retries = max(int(retries), 1)
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        # injectable for tests; None = time.sleep looked up at call time
        self._sleep: Optional[Any] = None
        # overload defense (machinery.overload): every retry spends a
        # token from the PROCESS-shared budget (stacked retry layers
        # share one amplification bound), and this endpoint's circuit
        # breaker sheds calls locally while it is sick instead of
        # tying up inflight slots on a drowning server
        self._budget = (
            overload.shared_budget() if retry_budget is None else retry_budget
        )
        self._breaker = overload.CircuitBreaker() if breaker is None else breaker
        reg = registry or prometheus.default_registry
        self._m_retries = reg.counter(
            "client_retries_total",
            "API requests retried by the client, by verb and reason",
            labelnames=("verb", "reason"),
        )
        self._m_watch_reestablished = reg.counter(
            "watch_reestablished_total",
            "Watch streams re-established after a dropped connection",
        )
        self._m_watch_shed = reg.counter(
            "watch_reconnects_shed_total",
            "Watch reconnect attempts shed because the endpoint's "
            "circuit breaker was open (probed on the breaker's "
            "cadence instead of hammered)",
        )
        self._m_list_restarts = reg.counter(
            "client_list_restarts_total",
            "Paginated lists restarted from a fresh full list after a "
            "continue token expired (410) mid-walk",
            labelnames=("kind",),
        )
        self._token = token
        self._token_file = token_file
        self._token_file_mtime: Optional[float] = None
        self._token_cached: Optional[str] = None
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if self.base_url.startswith("https"):
            if insecure_skip_tls_verify:
                # explicit opt-in, client-go's Insecure flag — built
                # from the public API (no ssl._create_unverified_context)
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            else:
                ctx = ssl.create_default_context(cafile=ca_file)
            if client_cert_file:
                ctx.load_cert_chain(client_cert_file, client_key_file)
            self._ssl_ctx = ctx
        # client-side rate limit (reference flag parity: --kube-api-qps /
        # --kube-api-burst, notebook-controller/main.go:56-70). Token
        # bucket: ``burst`` instant requests, refilled at ``qps``/s.
        self._qps = qps
        self._burst = max(burst, 1)
        self._tokens = float(self._burst)
        self._refill_t = time.monotonic()
        self._types: dict[str, TypeInfo] = {}
        self._watches: list[Watch] = []
        # the highest X-Served-RV the server has stamped on our
        # responses: the applied-rv horizon our reads were served at
        # (None until the first response carries the header)
        self._served_rv: Optional[int] = None
        # a partitioned server's per-partition horizon vector
        # (X-Served-RV-Partitions), as last stamped
        self._served_rvs: Optional[dict[int, int]] = None
        self._lock = _sanitizer.new_rlock("remote-client")
        # LRU-bounded: long-running controllers emit events with dynamic
        # detail; the dedupe cache must not grow with them
        self._event_index: "OrderedDict[tuple, str]" = OrderedDict()
        # mirror the embedded server's builtin registry so kind→path
        # resolution works without a discovery round-trip
        from odh_kubeflow_tpu_torch.machinery.store import BUILTIN_KINDS

        for api_version, kind, plural, namespaced in BUILTIN_KINDS:
            self.register_kind(api_version, kind, plural, namespaced)

    # -- registry (local only; the server owns admission) -------------------

    def register_kind(
        self, api_version: str, kind: str, plural: str, namespaced: bool = True
    ) -> None:
        with self._lock:
            self._types[kind] = TypeInfo(api_version, kind, plural, namespaced)

    def register_admission_hook(self, kinds, fn, mutating=True, name="") -> None:
        """Admission runs in the serving process; a remote registration
        is intentionally a no-op (parity: you cannot register Go code
        into kube-apiserver either — you deploy a webhook)."""

    def type_info(self, kind: str) -> TypeInfo:
        try:
            return self._types[kind]
        except KeyError:
            raise NotFound(f"kind {kind!r} not registered") from None

    def kind_for_plural(self, plural: str) -> str:
        for kind, info in self._types.items():
            if info.plural == plural:
                return kind
        raise NotFound(f"no kind with plural {plural!r}")

    # -- wire ---------------------------------------------------------------

    def _path(
        self, kind: str, namespace: Optional[str], name: Optional[str],
        subresource: Optional[str] = None, require_ns: bool = True,
    ) -> str:
        """``require_ns=False`` is the all-namespaces collection form
        used by list/watch."""
        info = self.type_info(kind)
        group_version = info.api_version
        prefix = (
            "/api/v1" if "/" not in group_version else f"/apis/{group_version}"
        )
        p = prefix
        if info.namespaced:
            if not namespace and require_ns:
                raise Invalid(f"{kind} is namespaced; namespace required")
            if namespace:
                p += f"/namespaces/{namespace}"
        p += f"/{info.plural}"
        if name:
            p += f"/{name}"
        if subresource:
            p += f"/{subresource}"
        return p

    def _throttle(self) -> None:
        if self._qps is None:
            return
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self._burst, self._tokens + (now - self._refill_t) * self._qps
            )
            self._refill_t = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return
            wait = (1.0 - self._tokens) / self._qps
            self._tokens = 0.0
        time.sleep(wait)

    def _bearer_token(self) -> Optional[str]:
        """Inline token, or the token file's contents cached by mtime
        (kube rotates bound tokens ~hourly; client-go re-reads the
        file, so we do too)."""
        if self._token is not None:
            return self._token
        if not self._token_file:
            return None
        with self._lock:
            try:
                mtime = os.stat(self._token_file).st_mtime
            except OSError:
                return None
            if mtime != self._token_file_mtime:
                with open(self._token_file) as f:
                    self._token_cached = f.read().strip()
                self._token_file_mtime = mtime
            return self._token_cached

    def _headers(self) -> dict[str, str]:
        headers = {"Content-Type": "application/json"}
        tok = self._bearer_token()
        if tok:
            headers["Authorization"] = f"Bearer {tok}"
        # propagate the caller's span so webhook → apiserver →
        # controller hops share one trace (httpapi parses it back)
        span = tracing.current()
        if span is not None:
            headers["traceparent"] = span.traceparent()
            if "controller" in span.attrs:
                # mark reconcile-originated requests (W3C tracestate)
                # so the remote store skips trace-stamping children,
                # same as the embedded path
                headers["tracestate"] = "odh=controller"
        # the caller's fencing epoch (machinery.leader.fenced): the
        # remote store validates it atomically with the apply
        fence = store_fence()
        if fence is not None:
            ns, lease, token = fence
            headers["X-Fencing-Token"] = f"{ns}/{lease}/{token}"
        # a self-declared priority level (the APF classification's
        # header): a process whose every call is platform traffic, such
        # as the kubelet, declares "controller"
        if self.priority_level:
            headers[overload.PRIORITY_HEADER] = self.priority_level
        # propagate the remaining end-to-end time budget (delta-seconds
        # — clock-skew safe; the server re-anchors on its own monotonic
        # clock and sheds expired work with 504 before doing it)
        deadline = overload.header_value()
        if deadline is not None:
            headers[overload.DEADLINE_HEADER] = deadline
        return headers

    def _retry_reason(self, method: str, e: Exception) -> Optional[str]:
        """Whether (and why) this failure is retryable for this verb —
        the policy table in docs/GUIDE.md. None = surface it now."""
        if isinstance(e, DeadlineExceeded):
            # the end-to-end time budget is spent: a retry inside it
            # cannot be observed by the caller — pure amplification
            return None
        if isinstance(e, TooManyRequests):
            return "429"  # not executed server-side: all verbs retry
        if isinstance(e, APIError):
            if e.code >= 500 and method in _IDEMPOTENT_VERBS:
                return "5xx"
            return None
        if isinstance(e, (OSError, http.client.HTTPException)):
            # connection refused/reset/timeout: the request MAY have
            # executed — only reads are safe to repeat
            if method in _IDEMPOTENT_VERBS:
                return "network"
        return None

    def _request(
        self, method: str, path: str, body: Optional[Obj] = None, query: str = ""
    ) -> Obj:
        """One API call through the shared retry helper
        (``machinery.backoff``): capped attempts, exponential +
        decorrelated jitter, Retry-After honoured, the verb × error
        policy of ``_retry_reason`` as the retryable predicate, every
        retry paid for from the shared :class:`overload.RetryBudget`,
        and no sleep ever taken past the ambient deadline."""

        def on_retry(e: BaseException, attempt: int, delay: float) -> None:
            reason = self._retry_reason(method, e) or "?"
            self._m_retries.inc({"verb": method, "reason": reason})
            log.warning(
                "%s %s failed (%s); retry %d/%d in %.3fs",
                method, path, reason, attempt + 1, self.retries, delay,
            )

        return backoff.retry(
            lambda: self._do_request(method, path, body, query),
            retryable=lambda e: self._retry_reason(method, e) is not None,
            attempts=self.retries,
            base=self.retry_base,
            cap=self.retry_cap,
            sleep_fn=self._sleep,
            on_retry=on_retry,
            budget=self._budget,
        )

    def _do_request(
        self,
        method: str,
        path: str,
        body: Optional[Obj] = None,
        query: str = "",
    ) -> Obj:
        for hop in range(self.follow_not_leader + 1):
            try:
                return self._do_request_once(method, path, body, query)
            except NotLeader as e:
                if hop >= self.follow_not_leader or not e.leader_url:
                    raise
                self._m_retries.inc({"verb": method, "reason": "307"})
                path = e.leader_url
        raise AssertionError("unreachable")  # the loop returns or raises

    def _do_request_once(
        self,
        method: str,
        path: str,
        body: Optional[Obj] = None,
        query: str = "",
    ) -> Obj:
        # overload defense, before any work: an expired end-to-end
        # deadline sheds here (the server would only 504 it anyway),
        # and an open circuit breaker sheds locally — a sick endpoint
        # is probed on the breaker's cadence, not hammered by every
        # caller. Breaker sheds surface as TooManyRequests so the
        # verb × error policy retries them after the cooldown hint.
        rem = overload.remaining()
        if rem is not None and rem <= 0:
            raise DeadlineExceeded(
                f"deadline expired before {method} {path}"
            )
        if not self._breaker.allow():
            raise TooManyRequests(
                f"circuit breaker open for {self.base_url}",
                retry_after=max(self._breaker.retry_after(), 0.05),
            )
        self._throttle()
        url = (
            path if path.startswith(("http://", "https://")) else self.base_url + path
        ) + (f"?{query}" if query else "")
        data = (
            json.dumps(body).encode()  # dumps-ok: outbound request body
            if body is not None
            else None
        )
        req = urllib.request.Request(
            url, data=data, method=method, headers=self._headers(),
        )
        # never wait longer than the caller's remaining time budget
        timeout = (
            self.timeout if rem is None else max(min(self.timeout, rem), 1e-3)
        )
        # an HTTP round-trip must never run while holding a store/cache
        # lock (sanitizer probe; no-op when GRAFT_SANITIZE is off)
        _sanitizer.note_blocking(f"http {method} {path}")
        # endpoint health for the breaker window: server-side failures
        # (5xx, 429 shed, network/timeout) and slow answers count
        # against the endpoint; 4xx are the CALLER's errors and do not
        healthy, t0 = True, time.monotonic()
        try:
            with urllib.request.urlopen(
                req, timeout=timeout, context=self._ssl_ctx
            ) as r:
                served = r.headers.get("X-Served-RV")
                if served is not None:
                    try:
                        self._note_served_rv(int(served))
                    except ValueError:
                        pass
                vector = r.headers.get("X-Served-RV-Partitions")
                if vector:
                    self._note_served_rvs(vector)
                return json.loads(r.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            # 504 is the CALLER's deadline expiring, not endpoint
            # sickness — it must not trip the breaker
            healthy = e.code == 504 or (e.code < 500 and e.code != 429)
            message, reason = str(e), ""
            try:
                status = json.loads(e.read().decode())
                message = status.get("message", message)
                reason = status.get("reason", "")
            except (
                OSError,
                ValueError,
                AttributeError,
                http.client.HTTPException,  # e.g. IncompleteRead mid-body
            ):
                pass  # non-Status error body; the HTTPError text stands
            # the structured Status.reason disambiguates the two 409s
            klass = _REASON_TO_ERR.get(reason) or _ERR_BY_CODE.get(
                e.code, APIError
            )
            if klass is TooManyRequests:
                raise TooManyRequests(
                    message, retry_after=_retry_after_of(e)
                ) from None
            if klass is NotLeader:
                # surface the redirect target: a caller catching
                # NotLeader retries its write against this URL
                raise NotLeader(
                    message,
                    leader_url=(e.headers or {}).get("Location", ""),
                ) from None
            raise klass(message) from None
        except (OSError, http.client.HTTPException):
            healthy = False
            raise
        finally:
            self._breaker.record(healthy, time.monotonic() - t0)

    def _note_served_rv(self, rv: int) -> None:
        with self._lock:
            if self._served_rv is None or rv > self._served_rv:
                self._served_rv = rv

    def _note_served_rvs(self, header: str) -> None:
        try:
            vec = {int(p): int(rv) for p, rv in
                   (part.split("=", 1) for part in header.split(","))}
        except ValueError:
            return
        with self._lock:
            self._served_rvs = vec

    def applied_rvs(self) -> Optional[dict[int, int]]:
        """A partitioned server's per-partition horizon vector as its
        last ``X-Served-RV-Partitions`` header stamped it; None from an
        unpartitioned server (or before the first response)."""
        with self._lock:
            return None if self._served_rvs is None else dict(self._served_rvs)

    def applied_rv(self) -> Optional[int]:
        """The server's ``X-Served-RV`` horizon as mirrored onto this
        client's responses — what lets HTTP-split web apps stamp
        ``servedRv`` on listings exactly like in-process read splits
        do. None until the first response carried the header (an old
        server, or no request yet)."""
        with self._lock:
            return self._served_rv

    # -- CRUD (APIServer duck type) -----------------------------------------

    def create(self, obj: Obj, dry_run: bool = False) -> Obj:
        kind = obj.get("kind", "")
        info = self.type_info(kind)
        ns = obj.get("metadata", {}).get("namespace") if info.namespaced else None
        if info.namespaced and not ns:
            raise Invalid(f"{kind} is namespaced; namespace required")
        return self._request(
            "POST",
            self._path(kind, ns, None),
            obj,
            query="dryRun=All" if dry_run else "",
        )

    def get(self, kind: str, name: str, namespace: Optional[str] = None) -> Obj:
        return self._request("GET", self._path(kind, namespace, name))

    def _selector_query(self, label_selector: Optional[Obj]) -> str:
        if not label_selector:
            return ""
        return "labelSelector=" + urllib.parse.quote(
            _selector_to_string(label_selector), safe=""
        )

    @staticmethod
    def _field_filter(
        items: list[Obj], field_matches: Optional[dict[str, Any]]
    ) -> list[Obj]:
        if not field_matches:
            return items
        return [
            it
            for it in items
            if all(
                obj_util.get_path(it, *path.split(".")) == want
                for path, want in field_matches.items()
            )
        ]

    def list_chunk(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
        continue_token: Optional[str] = None,
    ) -> tuple[list[Obj], str]:
        """One page of a paginated list (``?limit=&continue=``); the
        returned token is "" when the walk is done. An expired token
        surfaces as :class:`Expired` (410) — restart from a fresh
        list. ``field_matches`` filters client-side (it never crosses
        the wire), so a page may come back shorter than ``limit``."""
        p = self._path(kind, namespace, None, require_ns=False)
        parts = [f"limit={int(limit)}" if limit else "limit=500"]
        sel = self._selector_query(label_selector)
        if sel:
            parts.append(sel)
        if continue_token:
            parts.append(
                "continue=" + urllib.parse.quote(continue_token, safe="")
            )
        resp = self._request("GET", p, query="&".join(parts))
        items = self._field_filter(resp.get("items", []), field_matches)
        token = (resp.get("metadata") or {}).get("continue", "") or ""
        return items, token

    # paginated-list restart cap: after this many mid-walk 410s the
    # client falls back to ONE unpaginated list (always consistent)
    LIST_RESTARTS_MAX = 3

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
    ) -> list[Obj]:
        if limit:
            # bounded read: first page only (kube limit-without-continue)
            items, _ = self.list_chunk(
                kind,
                namespace=namespace,
                label_selector=label_selector,
                field_matches=field_matches,
                limit=limit,
            )
            return items
        p = self._path(kind, namespace, None, require_ns=False)

        def unpaginated() -> list[Obj]:
            items = self._request(
                "GET", p, query=self._selector_query(label_selector)
            ).get("items", [])
            return self._field_filter(items, field_matches)

        if not self.page_size:
            return unpaginated()

        # chunked walk (client-go pager) through the shared restart
        # policy: a continue token that 410s mid-list restarts the
        # whole walk (client_list_restarts_total), with one
        # unpaginated request as the last resort.
        def chunk(kind_: str, limit: int, continue_token: Optional[str]):
            return self.list_chunk(
                kind_,
                namespace=namespace,
                label_selector=label_selector,
                field_matches=field_matches,
                limit=limit,
                continue_token=continue_token,
            )

        def on_restart() -> None:
            self._m_list_restarts.inc({"kind": kind})
            log.warning(
                "list %s: continue token expired mid-walk; restarting "
                "from a fresh list", kind,
            )

        return paged_list_all(
            chunk,
            kind,
            self.page_size,
            unpaginated,
            restarts=self.LIST_RESTARTS_MAX,
            on_restart=on_restart,
        )

    def update(self, obj: Obj) -> Obj:
        meta = obj.get("metadata", {})
        return self._request(
            "PUT",
            self._path(obj.get("kind", ""), meta.get("namespace"), meta["name"]),
            obj,
        )

    def update_status(self, obj: Obj) -> Obj:
        meta = obj.get("metadata", {})
        return self._request(
            "PUT",
            self._path(
                obj.get("kind", ""), meta.get("namespace"), meta["name"], "status"
            ),
            obj,
        )

    def patch(
        self, kind: str, name: str, patch: Obj, namespace: Optional[str] = None
    ) -> Obj:
        return self._request("PATCH", self._path(kind, namespace, name), patch)

    def delete(self, kind: str, name: str, namespace: Optional[str] = None) -> None:
        self._request("DELETE", self._path(kind, namespace, name))

    # -- watch --------------------------------------------------------------

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        send_initial: bool = True,
        resource_version: Optional[str] = None,
        reconnect_window: Optional[float] = None,
    ) -> Watch:
        """Watch with automatic stream recovery: a dropped connection
        logs a warning and reconnects, resuming from the last-seen
        resourceVersion (no events lost, no duplicate replay).
        ``reconnect_window`` bounds the recovery loop: when set and no
        connection succeeds for that many seconds, the watch ends with
        an error so the consumer relists and re-establishes —
        replica-fanout consumers use this to re-home a stream whose
        endpoint died for good (default None keeps the
        reconnect-forever posture single-endpoint deployments want: a
        restarting leader comes back on the same URL). A 410
        Expired resume — the server compacted our resume point — ends
        the Watch with ``ended=True`` / ``error=Expired`` so the
        consumer relists (the informer cache does exactly that); other
        4xx responses surface the mapped error the same way, as does a
        stream that drops before ANY event arrived on a no-initial-dump
        watch (no resume point exists, so reconnecting would silently
        skip the gap — with send_initial the reconnect replays the full
        state instead, which rv-guarded consumers dedupe). Before this
        pump reconnected, a broken stream left consumers blocked on a
        dead Watch forever."""
        p = self._path(kind, namespace, None, require_ns=False)
        w = Watch(self, kind, namespace)
        # first-connect handshake: consumers rely on watch-then-list
        # ordering (open the stream, then list; anything written in
        # between arrives as an event). The embedded store registers
        # the watch synchronously; over HTTP we must not return before
        # the stream is actually open server-side, or a list issued
        # right after could race past events into a silent gap.
        connected = threading.Event()

        def _url(initial: bool, rv: Optional[str]) -> str:
            q = f"?watch=true&sendInitialEvents={'true' if initial else 'false'}"
            if rv is not None:
                q += f"&resourceVersion={urllib.parse.quote(str(rv), safe='')}"
            return self.base_url + p + q

        def pump():
            try:
                _pump_loop()
            except Exception as e:  # noqa: BLE001 — never die silently
                if not w._stopped:
                    w.error = e
                    log.warning(
                        "watch %s: pump crashed (%s: %s); consumer must "
                        "relist", kind, type(e).__name__, e,
                    )
            finally:
                # the sentinel AND the ended flag are guaranteed no
                # matter how the pump exits — a dead watch must never
                # look alive (the pre-PR bug this module fixes)
                if not w._stopped:
                    w.ended = True
                connected.set()  # release a waiting opener either way
                w._q.put(None)
                w._wake()  # event-loop consumers parked on set_notify

        def _pump_loop():
            rv = resource_version
            delay: Optional[float] = None
            floor: Optional[float] = None  # Retry-After from a 429
            connected_once = False
            last_alive = time.monotonic()
            while not w._stopped:
                if not self._breaker.allow():
                    # the endpoint's circuit is open (every caller's
                    # failures feed one breaker): probe on the
                    # breaker's cadence instead of hammering an
                    # unreachable endpoint in a reconnect hot loop
                    self._m_watch_shed.inc()
                    if (
                        reconnect_window is not None
                        and time.monotonic() - last_alive > reconnect_window
                    ):
                        w.error = APIError(
                            f"watch {kind}: no successful connection for "
                            f"{reconnect_window:.0f}s; relist and re-watch"
                        )
                        w.ended = True
                        log.warning(
                            "watch %s: endpoint breaker open beyond the "
                            "%.0fs reconnect window; stream ended for "
                            "re-homing", kind, reconnect_window,
                        )
                        break
                    (self._sleep or time.sleep)(
                        max(self._breaker.retry_after(), self.retry_base)
                    )
                    continue
                resp = None
                try:
                    # no read timeout: heartbeats arrive every 15s; a
                    # dead server surfaces as a connection error and we
                    # reconnect below
                    resp = urllib.request.urlopen(  # noqa: S310
                        urllib.request.Request(
                            # resuming: replay from rv, never a second
                            # full initial dump
                            _url(send_initial and rv is None, rv),
                            headers=self._headers(),
                        ),
                        context=self._ssl_ctx,
                    )
                    w._resp = resp
                    self._breaker.record(True)
                    connected.set()
                    if connected_once:
                        self._m_watch_reestablished.inc()
                        log.warning(
                            "watch %s: stream re-established (resume rv=%s)",
                            kind, rv,
                        )
                    connected_once = True
                    delay = None  # healthy stream resets the backoff
                    last_alive = time.monotonic()
                    for line in resp:
                        if w._stopped:
                            break
                        try:
                            evt = json.loads(line.decode())
                        except ValueError:
                            continue
                        if (
                            not isinstance(evt, dict)
                            or evt.get("type") in ("HEARTBEAT", None)
                        ):
                            continue
                        obj = evt.get("object")
                        if not isinstance(obj, dict):
                            # unknown framing (a Status doc, a future
                            # BOOKMARK): skip, don't kill the pump
                            continue
                        new_rv = obj.get("metadata", {}).get("resourceVersion")
                        if new_rv is not None:
                            rv = new_rv
                        w._enqueue((evt["type"], obj))
                    if w._stopped:
                        break
                    log.warning(
                        "watch %s: stream ended; reconnecting from rv=%s",
                        kind, rv,
                    )
                except urllib.error.HTTPError as e:
                    # endpoint health feeds the shared breaker: 5xx and
                    # 429 shed count against it, caller-side 4xx do not
                    self._breaker.record(e.code < 500 and e.code != 429)
                    retry_after = _retry_after_of(e) if e.code == 429 else None
                    try:
                        e.read()
                    except (OSError, ValueError):
                        pass
                    if 400 <= e.code < 500 and e.code != 429:
                        # includes 410: our resume point was compacted —
                        # the consumer must relist; other 4xx (authn/
                        # authz/bad request) won't heal by retrying
                        # either. 429 is NOT here: shed load was never
                        # executed, so the reconnect below retries it
                        # after the Retry-After wait (the verb × error
                        # policy table).
                        klass = _ERR_BY_CODE.get(e.code, APIError)
                        w.error = klass(
                            f"watch {kind}: HTTP {e.code} (resume rv={rv})"
                        )
                        w.ended = True
                        log.warning(
                            "watch %s: HTTP %d at rv=%s; stream dead "
                            "(%s) — consumer must relist/reauth",
                            kind, e.code, rv, klass.__name__,
                        )
                        return  # pump()'s finally delivers the sentinel
                    if retry_after:
                        floor = retry_after
                    log.warning(
                        "watch %s: HTTP %d; reconnecting from rv=%s",
                        kind, e.code, rv,
                    )
                except (OSError, ValueError, http.client.HTTPException):
                    self._breaker.record(False)
                    if not w._stopped:
                        log.warning(
                            "watch %s: stream broke; reconnecting from rv=%s",
                            kind, rv,
                        )
                finally:
                    # the pump owns the close: closing from another
                    # thread would block on the buffered-reader lock
                    # held by the in-flight readline until the next
                    # heartbeat
                    if resp is not None:
                        try:
                            resp.close()
                        except OSError:
                            pass
                if w._stopped:
                    break
                if (
                    reconnect_window is not None
                    and time.monotonic() - last_alive > reconnect_window
                ):
                    # the endpoint has been unreachable past the bound:
                    # surface instead of spinning — the consumer's
                    # relist + re-watch goes back through the fanout's
                    # probe and homes on a live replica
                    w.error = APIError(
                        f"watch {kind}: no successful connection for "
                        f"{reconnect_window:.0f}s; relist and re-watch"
                    )
                    w.ended = True
                    log.warning(
                        "watch %s: endpoint unreachable beyond the "
                        "%.0fs reconnect window; stream ended for "
                        "re-homing", kind, reconnect_window,
                    )
                    break
                if rv is None and not send_initial and connected_once:
                    # a stream that OPENED and then dropped before any
                    # event leaves a gap no resume point covers — a
                    # reconnect would silently skip everything written
                    # during it. Surface instead — the consumer (the
                    # informer cache) relists. A connect that was
                    # REJECTED outright (429 shed, refused) opened no
                    # stream, so nothing was missed: retry below.
                    w.error = APIError(
                        f"watch {kind}: stream lost before any event; "
                        "no resume point — relist required"
                    )
                    w.ended = True
                    log.warning(
                        "watch %s: stream lost before any event; "
                        "consumer must relist", kind,
                    )
                    break
                delay = backoff.next_delay(
                    delay, base=self.retry_base, cap=self.retry_cap
                )
                if floor:
                    delay, floor = max(delay, floor), None
                (self._sleep or time.sleep)(delay)

        threading.Thread(target=pump, daemon=True).start()
        # bounded wait (best effort): a down server keeps the pump in
        # its reconnect loop — proceed after the timeout, no worse than
        # the old return-immediately behaviour
        _sanitizer.note_blocking(f"watch connect {kind}")
        connected.wait(timeout=min(5.0, self.timeout))
        with self._lock:
            self._watches.append(w)
        return w

    def _remove_watch(self, w: Watch) -> None:
        with self._lock:
            if w in self._watches:
                self._watches.remove(w)
        resp = getattr(w, "_resp", None)
        if resp is not None:
            # interrupt the pump's blocking readline NOW (vs waiting out
            # the server heartbeat) by shutting the socket down; the
            # pump thread then closes the response itself
            try:
                sock = resp.fp.raw._sock  # noqa: SLF001 — stdlib internals
                sock.shutdown(socket.SHUT_RDWR)
            except (AttributeError, OSError):
                pass

    # -- convenience (same semantics as the embedded server) ----------------

    def create_or_get(self, obj: Obj) -> Obj:
        try:
            return self.create(obj)
        except AlreadyExists:
            meta = obj.get("metadata", {})
            return self.get(obj["kind"], meta["name"], meta.get("namespace"))

    def emit_event(
        self,
        involved: Obj,
        reason: str,
        message: str,
        event_type: str = "Normal",
        component: str = "",
    ) -> Obj:
        ns = involved.get("metadata", {}).get("namespace") or "default"
        # Same dedupe contract as the embedded server: identical repeat
        # emissions return the existing Event with no write, so
        # reconcilers that emit-and-watch Events quiesce remotely too.
        dedupe_key = (
            ns,
            involved.get("kind", ""),
            obj_util.name_of(involved),
            involved.get("metadata", {}).get("uid", ""),
            reason,
            message,
            event_type,
        )
        with self._lock:
            cached_name = self._event_index.get(dedupe_key)
            if cached_name is not None:
                self._event_index.move_to_end(dedupe_key)
        if cached_name is not None:
            try:
                return self.get("Event", cached_name, ns)
            except NotFound:
                with self._lock:
                    self._event_index.pop(dedupe_key, None)
        event = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {
                "generateName": f"{obj_util.name_of(involved)}.",
                "namespace": ns,
            },
            "involvedObject": {
                "apiVersion": involved.get("apiVersion", ""),
                "kind": involved.get("kind", ""),
                "name": obj_util.name_of(involved),
                "namespace": ns,
                "uid": involved.get("metadata", {}).get("uid", ""),
            },
            "reason": reason,
            "message": message,
            "type": event_type,
            "source": {"component": component},
            "firstTimestamp": obj_util.now_rfc3339(),
            "lastTimestamp": obj_util.now_rfc3339(),
            "count": 1,
        }
        created = self.create(event)
        with self._lock:
            self._event_index[dedupe_key] = created["metadata"]["name"]
            while len(self._event_index) > _EVENT_INDEX_MAX:
                self._event_index.popitem(last=False)
        return created


class ReplicaFanout:
    """Read-spreading façade over N replica endpoints (the
    comma-separated ``READ_FROM_REPLICA`` form): each read goes to one
    endpoint — round-robin for point reads and lists, rendezvous-sticky
    per (kind, namespace) for watches so a long-lived stream keeps one
    home — and an endpoint that errors (network, 5xx, 429 shed) is
    marked down for ``cooldown`` seconds while the call falls through
    to the next replica. All endpoints down → every endpoint is tried
    anyway (serving degraded beats failing fast on a blip).

    Pagination is sticky too: every page of one continue-token walk
    must come from the SAME replica (another replica's horizon may
    differ, and an offset into a different history silently skips or
    repeats rows), so ``list_chunk`` homes on the (kind, namespace)
    endpoint and a mid-walk endpoint failure surfaces as
    :class:`Expired` — the callers' existing restart-from-fresh-list
    logic handles it.

    Reads only: the runner hands this to :class:`ReadSplitAPI` as the
    read arm; writes keep going to the leader. ``applied_rv`` reports
    the LOWEST horizon any endpoint has served (the conservative
    bounded-staleness stamp: whichever replica served the rows, its
    horizon is at least this)."""

    def __init__(self, clients: list["RemoteAPIServer"], cooldown: float = 5.0):
        if not clients:
            raise ValueError("ReplicaFanout needs >=1 endpoint")
        self.clients = list(clients)
        self.cooldown = cooldown
        self._next = 0
        self._down_until: dict[int, float] = {}
        self._lock = _sanitizer.new_lock("replica-fanout")

    # -- endpoint choice ------------------------------------------------------

    def _breaker_blocking(self, idx: int) -> bool:
        """True while the endpoint's own circuit breaker would shed a
        call right now — fanout ranking treats it like a cooldown."""
        breaker = getattr(self.clients[idx], "_breaker", None)
        return breaker is not None and breaker.blocking

    def _order(self, sticky_key: Optional[str] = None) -> list[int]:
        now = time.monotonic()
        with self._lock:
            healthy = [
                i
                for i in range(len(self.clients))
                if self._down_until.get(i, 0.0) <= now
                and not self._breaker_blocking(i)
            ]
            if sticky_key is None:
                self._next += 1
                rr = self._next
        if not healthy:
            healthy = list(range(len(self.clients)))
        if sticky_key is None:
            first = healthy[rr % len(healthy)]
        else:
            # true rendezvous (highest-random-weight, the SAME
            # primitive shard/promoter ranking uses): one endpoint
            # blipping out of the healthy set remaps ONLY the keys it
            # owned — hash-mod over the dynamic list would tear every
            # sticky stream down on any membership wobble
            from odh_kubeflow_tpu_torch.machinery.leader import _hrw_weight

            first = max(
                healthy,
                key=lambda i: _hrw_weight(
                    self.clients[i].base_url, sticky_key
                ),
            )
        ordered = [first] + [i for i in healthy if i != first]
        ordered += [i for i in range(len(self.clients)) if i not in ordered]
        return ordered

    def _endpoint_failed(self, e: Exception) -> bool:
        if isinstance(e, TooManyRequests):
            return True  # shed load: another replica may have headroom
        if isinstance(e, APIError):
            return e.code >= 500
        return isinstance(e, (OSError, http.client.HTTPException))

    def _mark_down(self, idx: int, e: Exception) -> None:
        with self._lock:
            self._down_until[idx] = time.monotonic() + self.cooldown
        log.warning(
            "replica endpoint %s failed (%s: %s); trying the next replica",
            self.clients[idx].base_url, type(e).__name__, e,
        )

    def _call(self, method: str, *args, sticky_key=None, **kwargs):
        last: Optional[Exception] = None
        for idx in self._order(sticky_key):
            try:
                return getattr(self.clients[idx], method)(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — policy-checked below
                if not self._endpoint_failed(e):
                    raise
                last = e
                self._mark_down(idx, e)
        assert last is not None
        raise last

    # -- the read surface -----------------------------------------------------

    def get(self, kind: str, name: str, namespace: Optional[str] = None) -> Obj:
        return self._call("get", kind, name, namespace)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
    ) -> list[Obj]:
        return self._call(
            "list",
            kind,
            namespace=namespace,
            label_selector=label_selector,
            field_matches=field_matches,
            limit=limit,
        )

    # marker appended to continue tokens to pin the walk's endpoint:
    # stickiness via rendezvous alone breaks when a better-ranked
    # endpoint RECOVERS mid-walk (the winner changes between pages and
    # the token resumes against a different replica's history)
    _TOKEN_PIN = "@@replica:"

    def _page_endpoint(
        self, kind: str, namespace: Optional[str], token: Optional[str]
    ) -> tuple[int, Optional[str]]:
        """(endpoint index, unwrapped server token) for one page. A
        continued walk is pinned to the endpoint recorded in its own
        token; a fresh walk homes on the healthy rendezvous winner."""
        if token and self._TOKEN_PIN in token:
            server_token, _, idx = token.rpartition(self._TOKEN_PIN)
            try:
                return int(idx), server_token
            except ValueError:
                pass  # foreign token shape: treat as unpinned
        key = f"list\x00{kind}\x00{namespace or ''}"
        return self._order(sticky_key=key)[0], token

    def list_chunk(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Obj] = None,
        field_matches: Optional[dict[str, Any]] = None,
        limit: Optional[int] = None,
        continue_token: Optional[str] = None,
    ) -> tuple[list[Obj], str]:
        # EVERY page of one continue walk must come from the same
        # replica — another endpoint's horizon differs, and an offset
        # into a different history silently skips/repeats rows — so
        # the token itself carries the endpoint it belongs to
        idx, server_token = self._page_endpoint(
            kind, namespace, continue_token
        )
        pinned = bool(continue_token)

        def page(i: int):
            items, token = self.clients[i].list_chunk(
                kind,
                namespace=namespace,
                label_selector=label_selector,
                field_matches=field_matches,
                limit=limit,
                continue_token=server_token,
            )
            return items, (
                f"{token}{self._TOKEN_PIN}{i}" if token else ""
            )

        try:
            return page(idx)
        except Exception as e:  # noqa: BLE001 — policy-checked below
            if not self._endpoint_failed(e):
                raise
            self._mark_down(idx, e)
            if pinned:
                # mid-walk: the token belongs to the dead endpoint's
                # history — 410 so the caller's existing restart-from-
                # fresh-list logic takes over (never resume the walk
                # against a different replica's state)
                raise Expired(
                    "replica serving this paginated walk became "
                    "unavailable; restart from a fresh list"
                ) from e
            key = f"list\x00{kind}\x00{namespace or ''}"
            for other in self._order(sticky_key=key):
                if other == idx:
                    continue
                try:
                    return page(other)
                except Exception as e2:  # noqa: BLE001
                    if not self._endpoint_failed(e2):
                        raise
                    self._mark_down(other, e2)
                    e = e2
            raise e

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        send_initial: bool = True,
        resource_version: Optional[str] = None,
        reconnect_window: Optional[float] = None,
    ) -> Watch:
        # sticky: the stream (and its resume rv space) lives on ONE
        # replica; the client pump's own reconnect loop handles blips.
        # watch() itself never raises (the pump retries forever), so a
        # dead home would spin unmarked — probe it with a bounded read
        # first and fail over to the next endpoint like any read. A
        # home that dies AFTER establishment is bounded too: the
        # reconnect_window ends the stream so the consumer's relist +
        # re-watch comes back through this probe and re-homes.
        key = f"{kind}\x00{namespace or ''}"
        if reconnect_window is None:
            reconnect_window = max(3 * self.cooldown, 15.0)
        last: Optional[Exception] = None
        for idx in self._order(sticky_key=key):
            try:
                self.clients[idx].list(kind, namespace=namespace, limit=1)
            except Exception as e:  # noqa: BLE001 — policy-checked below
                if not self._endpoint_failed(e):
                    raise
                self._mark_down(idx, e)
                last = e
                continue
            return self.clients[idx].watch(
                kind,
                namespace=namespace,
                send_initial=send_initial,
                resource_version=resource_version,
                reconnect_window=reconnect_window,
            )
        assert last is not None
        raise last

    def applied_rv(self) -> Optional[int]:
        # the MIN observed horizon: conservative — whichever endpoint
        # actually served the rows has a horizon at least this high,
        # so the stamp never promises freshness a lagging replica
        # didn't deliver
        horizons = [
            rv
            for rv in (c.applied_rv() for c in self.clients)
            if rv is not None
        ]
        return min(horizons) if horizons else None

    def register_kind(
        self,
        api_version: str,
        kind: str,
        plural: str,
        namespaced: bool = True,
    ) -> None:
        for c in self.clients:
            c.register_kind(api_version, kind, plural, namespaced)

    def type_info(self, kind: str) -> TypeInfo:
        return self.clients[0].type_info(kind)

    def kind_for_plural(self, plural: str) -> str:
        return self.clients[0].kind_for_plural(plural)

    def register_admission_hook(self, kinds, fn, mutating=True, name="") -> None:
        """No-op, same as every remote client."""

    def __getattr__(self, name: str):
        # anything else (writes should never land here — the runner
        # pairs this with ReadSplitAPI's leader write arm) delegates
        # to the first endpoint
        return getattr(self.clients[0], name)


def _retry_after_of(e: urllib.error.HTTPError) -> float:
    """The Retry-After header as seconds (delay-seconds form only —
    the HTTP-date form is overkill for an apiserver hint), default 1s."""
    try:
        return float(e.headers.get("Retry-After", "1"))
    except (AttributeError, TypeError, ValueError):
        return 1.0


def _selector_to_string(selector: Obj) -> str:
    """Inverse of ``objects.parse_selector_string``.

    Covers matchLabels plus the matchExpressions the string form can
    express (NotIn-single-value → ``k!=v``, Exists → ``k``,
    DoesNotExist → ``!k``, which the port's parser reads); anything
    richer raises rather than silently dropping a filter the embedded
    store's in-process ``list()`` would have honoured.
    """
    if "matchLabels" in selector or "matchExpressions" in selector:
        labels = selector.get("matchLabels") or {}
        exprs = selector.get("matchExpressions") or []
    else:
        labels, exprs = selector or {}, []
    parts = [f"{k}={v}" for k, v in labels.items()]
    for e in exprs:
        op, key, values = e.get("operator"), e.get("key"), e.get("values", [])
        if op == "Exists":
            parts.append(key)
        elif op == "DoesNotExist":
            parts.append(f"!{key}")
        elif op == "NotIn" and len(values) == 1:
            parts.append(f"{key}!={values[0]}")
        else:
            raise ValueError(
                f"matchExpressions entry {e!r} has no labelSelector string "
                "form; use the in-process APIServer for rich selectors"
            )
    return ",".join(parts)


def in_cluster_config() -> Optional[dict[str, Any]]:
    """client-go's ``rest.InClusterConfig()``: when the pod has the
    kubernetes service env and a mounted serviceaccount, return the
    https URL + rotating token file + apiserver CA. ``KUBE_SA_DIR``
    overrides the mount path (tests; the well-known default otherwise).
    Returns None outside a cluster."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    sa_dir = os.environ.get("KUBE_SA_DIR", _SA_DIR)
    token_file = os.path.join(sa_dir, "token")
    ca_file = os.path.join(sa_dir, "ca.crt")
    if not host or not os.path.exists(token_file):
        return None
    if ":" in host:  # IPv6 literal (client-go: net.JoinHostPort)
        host = f"[{host}]"
    cfg: dict[str, Any] = {
        "base_url": f"https://{host}:{port}",
        "token_file": token_file,
    }
    if os.path.exists(ca_file):
        cfg["ca_file"] = ca_file
    return cfg


def api_from_env(url: Optional[str] = None) -> Any:
    """Client for split-process components, the ``ctrl.GetConfigOrDie()``
    ladder (the reference's notebook-controller ``main.go:61-81``):

    1. ``url`` when given (the runner's replica-read endpoint — same
       credential env, different host), else ``$KUBE_API_URL`` (+
       optional ``KUBE_API_TOKEN`` / ``KUBE_API_TOKEN_FILE`` /
       ``KUBE_API_CA_FILE`` / ``KUBE_API_INSECURE_SKIP_TLS_VERIFY``);
    2. in-cluster config (kubernetes service env + serviceaccount mount);
    3. localhost:8001 (`kubectl proxy` posture) for dev.

    A comma-separated ``url`` (the multi-replica ``READ_FROM_REPLICA``
    form) returns a :class:`ReplicaFanout` spreading reads across the
    endpoints with per-endpoint failure fallback
    (``REPLICA_FANOUT_COOLDOWN``); a single URL returns the plain
    :class:`RemoteAPIServer`.

    Registers the platform CRD kinds for path mapping either way."""
    if url and "," in url:
        return ReplicaFanout(
            [api_from_env(part.strip()) for part in url.split(",") if part.strip()],
            cooldown=float(os.environ.get("REPLICA_FANOUT_COOLDOWN", "5")),
        )
    qps_env = os.environ.get("KUBE_API_QPS", "")
    page_env = os.environ.get("KUBE_LIST_PAGE_SIZE", "500")
    common: dict[str, Any] = dict(
        qps=float(qps_env) if qps_env else None,
        burst=int(os.environ.get("KUBE_API_BURST", "10")),
        # chunked lists by default (client-go pager parity): no
        # split-process component ever pulls a fleet-sized list in one
        # payload. KUBE_LIST_PAGE_SIZE=0 reverts to unpaginated.
        page_size=int(page_env) if page_env and int(page_env) > 0 else None,
    )
    url = url or os.environ.get("KUBE_API_URL")
    if url:
        api = RemoteAPIServer(
            url,
            token=os.environ.get("KUBE_API_TOKEN") or None,
            token_file=os.environ.get("KUBE_API_TOKEN_FILE") or None,
            ca_file=os.environ.get("KUBE_API_CA_FILE") or None,
            insecure_skip_tls_verify=os.environ.get(
                "KUBE_API_INSECURE_SKIP_TLS_VERIFY", ""
            ).lower() in ("1", "true"),
            **common,
        )
    else:
        cluster = in_cluster_config()
        if cluster is not None:
            api = RemoteAPIServer(**cluster, **common)
        else:
            api = RemoteAPIServer("http://127.0.0.1:8001", **common)
    from odh_kubeflow_tpu_torch.apis import register_crds

    register_crds(api)  # admission registration is a client-side no-op
    return api
