"""Micro WSGI framework (Flask-shaped, stdlib-only; the port's copy of the
JAX package's ``web/microweb.py``).

The reference's BFFs are Flask apps built by a shared factory
(crud-web-apps/common/backend/.../__init__.py:16-35). This image ships
no Flask, so the framework itself is part of the platform: routing with
path params, JSON request/response, before-request hooks, error
handlers and CSRF double-submit protection — the surface the CRUD
backends need.

Left out of the copy (ROADMAP.md), to come with ``machinery/{overload,
eventloop,zpages}.py`` and ``utils/tracing.py``: the per-request
deadline scope, the request spans, the ``/debug`` routes and the asyncio
event-loop front end; and, with the frontends, blueprints and static
serving. Serving is thread-per-request, and JSON bodies are plain
``json.dumps``.
"""

from __future__ import annotations

import http
import json
import re
import secrets as _secrets
import threading
import time
import traceback
from http.cookies import SimpleCookie
from typing import Any, Callable, Optional
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server
from socketserver import ThreadingMixIn



class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class Request:
    def __init__(self, environ: dict):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "/")
        from urllib.parse import parse_qsl

        self.query = dict(
            parse_qsl(environ.get("QUERY_STRING") or "", keep_blank_values=True)
        )
        self.headers = {
            k[5:].replace("_", "-").lower(): v
            for k, v in environ.items()
            if k.startswith("HTTP_")
        }
        if environ.get("CONTENT_TYPE"):
            self.headers["content-type"] = environ["CONTENT_TYPE"]
        self._body: Optional[bytes] = None
        self.params: dict[str, str] = {}
        self.context: dict[str, Any] = {}

    @property
    def body(self) -> bytes:
        if self._body is None:
            try:
                length = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                length = 0
            self._body = (
                self.environ["wsgi.input"].read(length) if length else b""
            )
        return self._body

    @property
    def json(self) -> Any:
        if not self.body:
            return None
        try:
            return json.loads(self.body.decode())
        except ValueError:
            raise HTTPError(400, "invalid JSON body") from None

    @property
    def cookies(self) -> dict[str, str]:
        cookie = SimpleCookie(self.environ.get("HTTP_COOKIE", ""))
        return {k: v.value for k, v in cookie.items()}


class Response:
    def __init__(
        self,
        body: Any = "",
        status: int = 200,
        headers: Optional[dict[str, str]] = None,
        content_type: Optional[str] = None,
    ):
        self.status = status
        self.headers = dict(headers or {})
        if isinstance(body, (dict, list)):
            self.body = json.dumps(body).encode()
            self.headers.setdefault("Content-Type", "application/json")
        elif isinstance(body, str):
            self.body = body.encode()
            self.headers.setdefault("Content-Type", content_type or "text/html")
        else:
            self.body = body or b""
            if content_type:
                self.headers.setdefault("Content-Type", content_type)
        self.headers.setdefault("Content-Length", str(len(self.body)))

    def set_cookie(self, name: str, value: str, path: str = "/", http_only=False):
        cookie = f"{name}={value}; Path={path}; SameSite=Strict"
        if http_only:
            cookie += "; HttpOnly"
        self.headers["Set-Cookie"] = cookie


_STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content", 301: "Moved Permanently",
    302: "Found", 400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
    410: "Gone", 422: "Unprocessable Entity", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}


def _status_text(status: int) -> str:
    """Reason phrase for a status code. Codes outside the common table
    fall back to the stdlib registry — an unknown code must not emit a
    status line with an empty reason phrase (the 410/429/503 responses
    the chaos-hardened paths send did exactly that before)."""
    text = _STATUS_TEXT.get(status)
    if text is None:
        try:
            text = http.HTTPStatus(status).phrase
        except ValueError:
            text = "Unknown"
    return text


class App:
    """WSGI application with Flask-style routing."""

    def __init__(self, name: str = "app", registry=None):
        from odh_kubeflow_tpu_torch.utils import prometheus

        self.name = name
        self._routes: list[tuple[str, re.Pattern, list[str], Callable]] = []
        self._before: list[Callable[[Request], Optional[Response]]] = []
        self._errors: dict[type, Callable] = {}
        # per-app request latency: one series per app, observed around
        # the whole dispatch
        reg = registry if registry is not None else prometheus.default_registry
        self.registry = reg
        self._m_requests = reg.histogram(
            "http_request_duration_seconds",
            "Web request handler latency per app",
            labelnames=("app",),
        ).labels(app=name)

    # -- registration -------------------------------------------------------

    @staticmethod
    def _compile(rule: str) -> tuple[re.Pattern, list[str]]:
        names: list[str] = []

        def repl(m):
            names.append(m.group(1))
            return r"(?P<%s>[^/]+)" % m.group(1)

        pattern = re.sub(r"<([a-zA-Z_][a-zA-Z0-9_]*)>", repl, rule)
        return re.compile("^" + pattern + "$"), names

    def route(self, rule: str, methods: Optional[list[str]] = None):
        def deco(fn):
            regex, names = self._compile(rule)
            for m in methods or ["GET"]:
                self._routes.append((m.upper(), regex, names, fn))
            return fn

        return deco

    def before_request(self, fn: Callable[[Request], Optional[Response]]):
        self._before.append(fn)
        return fn

    def error_handler(self, exc_type: type):
        def deco(fn):
            self._errors[exc_type] = fn
            return fn

        return deco

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, request: Request) -> Response:
        for hook in self._before:
            resp = hook(request)
            if resp is not None:
                return resp
        allowed: set[str] = set()
        for method, regex, _names, fn in self._routes:
            m = regex.match(request.path)
            if not m:
                continue
            if method != request.method:
                allowed.add(method)
                continue
            request.params = m.groupdict()
            out = fn(request, **m.groupdict())
            return out if isinstance(out, Response) else Response(out)
        if allowed:
            return Response({"success": False, "log": "method not allowed"}, 405)
        return Response({"success": False, "log": "not found"}, 404)

    def __call__(self, environ, start_response):
        request = Request(environ)
        t0 = time.perf_counter()
        try:
            response = self._dispatch(request)
        except HTTPError as e:
            response = Response(
                {"success": False, "status": e.status, "log": e.message}, e.status
            )
        except Exception as e:  # noqa: BLE001
            handler = None
            for etype, fn in self._errors.items():
                if isinstance(e, etype):
                    handler = fn
                    break
            if handler is not None:
                response = handler(request, e)
            else:
                traceback.print_exc()
                response = Response(
                    {"success": False, "status": 500, "log": str(e)}, 500
                )
        finally:
            self._m_requests.observe(time.perf_counter() - t0)
        status_line = f"{response.status} {_status_text(response.status)}"
        start_response(status_line, list(response.headers.items()))
        return [response.body]

    # -- serving ------------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0, ssl_context=None):
        """Start a daemon-thread server, one thread a request.
        ``ssl_context`` (an ``ssl.SSLContext``) upgrades it to HTTPS —
        the admission webhook serves AdmissionReview this way, since a
        real kube-apiserver only calls webhooks over TLS. Returns the
        server (``server_address``, ``shutdown()``)."""

        class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
            daemon_threads = True

            # TLS handshake must happen in the per-connection handler
            # thread (finish_request), never in the accept loop — a
            # client that connects and sends no ClientHello would
            # otherwise park serve_forever and block every caller.
            def finish_request(self, request, client_address):
                if ssl_context is not None:
                    request.settimeout(10)
                    request.do_handshake()
                    request.settimeout(None)
                super().finish_request(request, client_address)

        server = make_server(
            host, port, self, server_class=ThreadingWSGIServer,
            handler_class=_QuietHandler,
        )
        if ssl_context is not None:
            server.socket = ssl_context.wrap_socket(
                server.socket, server_side=True, do_handshake_on_connect=False
            )
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server


class _QuietHandler(WSGIRequestHandler):
    """No access-log line on stderr for every request (the event-loop
    front end the JAX package serves with by default logs none)."""

    def log_message(self, format, *args):  # noqa: A002
        pass


# ---------------------------------------------------------------------------
# CSRF (double-submit cookie, crud_backend csrf.py equivalent)

CSRF_COOKIE = "XSRF-TOKEN"
CSRF_HEADER = "x-xsrf-token"
_SAFE_METHODS = {"GET", "HEAD", "OPTIONS"}


def install_csrf(app: App) -> None:
    @app.before_request
    def _csrf(request: Request) -> Optional[Response]:
        if request.method in _SAFE_METHODS:
            return None
        cookie = request.cookies.get(CSRF_COOKIE)
        header = request.headers.get(CSRF_HEADER)
        if not cookie or cookie != header:
            return Response(
                {"success": False, "log": "CSRF token missing or invalid"}, 403
            )
        return None


def issue_csrf_cookie(response: Response) -> str:
    token = _secrets.token_urlsafe(16)
    response.set_cookie(CSRF_COOKIE, token)
    return token
