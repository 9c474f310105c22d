"""The port's event-loop web tier held to the JAX package's: the
serialized-bytes cache, the shed reason phrases, microweb on the event
loop and its opt-out, the REST façade's watch fan-out (one serialization
for every subscriber), watches without a thread each, persistent
connections, and the body, chunked-encoding and Content-Length
refusals. The counterparts of ``tests/test_webtier.py:204-348`` and
``:397-733``, on both packages (``m``); the listing-memo tests wait for
the informer cache.
"""

import json
import socket
import threading

import pytest

from test_torch_overload import wire


@pytest.fixture(params=["jax", "torch"])
def m(request):
    return wire(request.param)


def _obj(name="nb", ns="team-a", rv="3", kind="Notebook"):
    return {"kind": kind, "apiVersion": "v1",
            "metadata": {"name": name, "namespace": ns, "resourceVersion": rv},
            "spec": {"x": 1}}


def test_bytes_cache_hit_skips_serialization(m):
    c = m.cache.SerializedBytesCache()
    o = _obj()
    first = c.obj_bytes(o)
    assert first == json.dumps(o).encode()
    before = m.serialize.dumps_count()
    assert c.obj_bytes(o) is first
    assert m.serialize.dumps_count() == before
    assert c.hits == 1 and c.misses == 1


def test_bytes_cache_rv_change_is_a_miss(m):
    c = m.cache.SerializedBytesCache()
    c.obj_bytes(_obj(rv="3"))
    newer = _obj(rv="4")
    newer["spec"]["x"] = 2
    assert c.obj_bytes(newer) == json.dumps(newer).encode()
    assert c.misses == 2


def test_bytes_cache_unidentified_objects_bypass(m):
    c = m.cache.SerializedBytesCache()
    status = {"kind": "Status", "status": "Failure", "code": 404}
    assert c.obj_bytes(status) == json.dumps(status).encode()
    assert c.hits == 0 and c.misses == 0


def test_bytes_cache_event_bytes_compose_from_object_bytes(m):
    c = m.cache.SerializedBytesCache()
    o = _obj()
    line = c.event_bytes("ADDED", o)
    assert line == json.dumps({"type": "ADDED", "object": o}).encode() + b"\n"
    assert c.event_bytes("ADDED", o) is line
    before = m.serialize.dumps_count()
    mod = c.event_bytes("MODIFIED", o)
    assert m.serialize.dumps_count() == before
    assert mod == json.dumps({"type": "MODIFIED", "object": o}).encode() + b"\n"


def test_bytes_cache_list_compose_parity(m):
    c = m.cache.SerializedBytesCache()
    items = [_obj(name=f"nb-{i}", rv=str(i)) for i in range(5)]
    want = json.dumps({"kind": "NotebookList", "apiVersion": "v1", "items": items}).encode()
    assert c.list_bytes("Notebook", items) == want
    before = m.serialize.dumps_count()
    assert c.list_bytes("Notebook", items) == want
    assert m.serialize.dumps_count() == before
    paged = json.dumps({"kind": "NotebookList", "apiVersion": "v1",
                        "metadata": {"continue": "tok"}, "items": items}).encode()
    assert c.list_bytes("Notebook", items, continue_token="tok") == paged


def test_bytes_cache_lru_bound(m):
    c = m.cache.SerializedBytesCache(capacity=2)
    for i in range(5):
        c.obj_bytes(_obj(name=f"nb-{i}", rv=str(i)))
    assert len(c._data) == 2


def test_bytes_cache_outputs_equal_jax():
    """One seeded run of lookups through both caches: identical bytes,
    hits and misses."""
    import random

    caches = {p: wire(p).cache.SerializedBytesCache(capacity=8) for p in ("jax", "torch")}
    rng = random.Random(0)
    ops = [(rng.choice(("obj", "ADDED", "MODIFIED", "list")), rng.randrange(12),
            str(rng.randrange(3))) for _ in range(200)]
    outs = {}
    for p, c in caches.items():
        out = []
        for op, i, rv in ops:
            o = _obj(name=f"n{i}", rv=rv)
            if op == "obj":
                out.append(c.obj_bytes(o))
            elif op != "list":
                out.append(c.event_bytes(op, o))
            else:
                out.append(c.list_bytes("Notebook", [o, _obj(name=f"n{i + 1}", rv=rv)]))
        outs[p] = (out, c.hits, c.misses)
    assert outs["torch"] == outs["jax"]


# ---------------------------------------------------------------------------
# microweb: status text + event-loop serving


def test_status_text_covers_shed_and_chaos_codes(m):
    st = m.microweb._status_text
    assert st(410) == "Gone" and st(429) == "Too Many Requests"
    assert st(503) == "Service Unavailable" and st(200) == "OK"
    assert st(504) == "Gateway Timeout"
    assert st(418) == "I'm a Teapot" and st(599) == "Unknown"


def test_app_emits_reason_phrase_for_shed_statuses(m):
    app = m.microweb.App("t", registry=m.prometheus.Registry())

    @app.route("/shed")
    def shed(req):
        raise m.microweb.HTTPError(429, "slow down")

    captured = {}

    def start_response(status, headers):
        captured["status"] = status

    body = app({"REQUEST_METHOD": "GET", "PATH_INFO": "/shed", "QUERY_STRING": ""},
               start_response)
    assert captured["status"] == "429 Too Many Requests"
    assert json.loads(b"".join(body))["status"] == 429


def _get(port, path):
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n".encode())
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return data
            data += chunk


def test_event_loop_serves_microweb_app(m):
    app = m.microweb.App("t", registry=m.prometheus.Registry())

    @app.route("/ping")
    def ping(req):
        return {"pong": True, "n": 3}

    server = app.serve(event_loop=True)
    try:
        assert type(server).__name__ == "EventLoopServer"
        head, _, body = _get(server.server_port, "/ping").partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200 OK")
        assert json.loads(body) == {"pong": True, "n": 3}
    finally:
        server.shutdown()


def test_thread_server_fallback_still_serves(m):
    app = m.microweb.App("t", registry=m.prometheus.Registry())

    @app.route("/ping")
    def ping(req):
        return {"pong": True}

    server = app.serve(event_loop=False)
    try:
        assert b'{"pong": true}' in _get(server.server_address[1], "/ping")
    finally:
        server.shutdown()


def test_event_loop_env_opt_out(m, monkeypatch):
    monkeypatch.setenv("WEB_EVENT_LOOP", "false")
    assert not m.eventloop.event_loop_enabled()
    app = m.microweb.App("t", registry=m.prometheus.Registry())
    server = app.serve()
    try:
        assert type(server).__name__ != "EventLoopServer"
    finally:
        server.shutdown()
    monkeypatch.delenv("WEB_EVENT_LOOP")
    assert m.eventloop.event_loop_enabled()


def test_microweb_runs_each_request_under_a_deadline(m):
    """A request runs under the caller's X-Request-Deadline, else the
    default stamp (``REQUEST_DEADLINE_DEFAULT``, 30 s)."""
    import time

    app = m.microweb.App("t", registry=m.prometheus.Registry())
    seen = []

    @app.route("/dl")
    def dl(req):
        seen.append(m.overload.remaining())
        return {}

    env = {"REQUEST_METHOD": "GET", "PATH_INFO": "/dl", "QUERY_STRING": ""}
    app(dict(env), lambda s, h: None)
    app({**env, "HTTP_X_REQUEST_DEADLINE": "2", "odh.request.arrival": time.monotonic()},
        lambda s, h: None)
    app({**env, "HTTP_X_REQUEST_DEADLINE": "soon"}, lambda s, h: None)
    assert 29 < seen[0] <= 30 and 1 < seen[1] <= 2 and 29 < seen[2] <= 30
    assert m.overload.current_deadline() is None


# ---------------------------------------------------------------------------
# httpapi over the event loop: watch fan-out + thread accounting


@pytest.fixture()
def api_served(m):
    server = m.store.APIServer()
    m.apis.register_crds(server)
    _, port, httpd = m.httpapi.serve(server, port=0, event_loop=True)
    yield server, port, httpd
    httpd.shutdown()


def _nb(name, ns="team-a"):
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"template": {"spec": {"containers": [{"name": name, "image": "j"}]}}}}


def _open_watch(port, path="/api/v1/namespaces/team-a/notebooks?watch=true"):
    s = socket.create_connection(("127.0.0.1", port), timeout=15)
    s.sendall(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    f = s.makefile("rb")
    assert b"200" in f.readline()
    while f.readline() not in (b"\r\n", b"\n"):
        pass
    assert b"HEARTBEAT" in f.readline()
    return s, f


def test_watch_fanout_serializes_each_event_exactly_once(m, api_served):
    server, port, _ = api_served
    streams = [_open_watch(port) for _ in range(5)]
    try:
        before = m.serialize.dumps_count()
        server.create(_nb("fanout-nb"))
        lines = [f.readline() for _, f in streams]
        assert all(line == lines[0] for line in lines)
        event = json.loads(lines[0])
        assert event["type"] == "ADDED"
        assert event["object"]["metadata"]["name"] == "fanout-nb"
        assert m.serialize.dumps_count() - before == 1
    finally:
        for s, f in streams:
            f.close()
            s.close()


def test_watches_do_not_consume_a_thread_each(m, api_served):
    server, port, _ = api_served
    baseline = threading.active_count()
    n = 25
    streams = [_open_watch(port) for _ in range(n)]
    try:
        assert threading.active_count() - baseline < n // 2
        server.create(_nb("alive-nb"))
        for _, f in streams:
            assert b"alive-nb" in f.readline()
    finally:
        for s, f in streams:
            f.close()
            s.close()


def test_event_loop_persistent_connections(m, api_served):
    server, port, _ = api_served
    server.create(_nb("ka-nb"))
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    f = s.makefile("rb")
    try:
        for _ in range(3):
            s.sendall(b"GET /api/v1/namespaces/team-a/notebooks/ka-nb HTTP/1.1\r\n"
                      b"Host: t\r\n\r\n")
            assert b"200" in f.readline()
            headers = {}
            while True:
                line = f.readline()
                if line in (b"\r\n", b"\n"):
                    break
                k, _, v = line.partition(b":")
                headers[k.strip().lower()] = v.strip()
            assert headers[b"connection"] == b"keep-alive"
            body = f.read(int(headers[b"content-length"]))
            assert json.loads(body)["metadata"]["name"] == "ka-nb"
    finally:
        f.close()
        s.close()


def test_serial_requests_event_loop_parity(m, api_served):
    server, port, _ = api_served
    server.create(_nb("p1"))
    head, _, body = _get(port, "/api/v1/namespaces/team-a/notebooks/p1").partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200")
    assert body == json.dumps(server.get("Notebook", "p1", "team-a")).encode()
    _, _, body = _get(port, "/api/v1/namespaces/team-a/notebooks").partition(b"\r\n\r\n")
    assert body == json.dumps({"kind": "NotebookList", "apiVersion": "v1",
                               "items": server.list("Notebook", namespace="team-a")}).encode()


def _read_all(s):
    data = b""
    while True:
        chunk = s.recv(4096)
        if not chunk:
            return data
        data += chunk


def test_event_loop_rejects_oversized_bodies(m, api_served):
    _, port, _ = api_served
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        s.sendall(b"POST /api/v1/namespaces/team-a/notebooks HTTP/1.1\r\n"
                  b"Host: t\r\nContent-Length: "
                  + str(m.eventloop.MAX_BODY_BYTES + 1).encode() + b"\r\n\r\n")
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
        assert data.startswith(b"HTTP/1.1 413"), data[:64]
    finally:
        s.close()


def test_event_loop_rejects_chunked_transfer_encoding(m, api_served):
    _, port, _ = api_served
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        s.sendall(b"POST /api/v1/namespaces/team-a/notebooks HTTP/1.1\r\n"
                  b"Host: t\r\nTransfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n")
        assert _read_all(s).startswith(b"HTTP/1.1 501")
    finally:
        s.close()


def test_event_loop_half_close_still_delivers_pooled_response(m, api_served):
    server, port, _ = api_served
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        body = json.dumps(_nb("halfclose-nb")).encode()
        s.sendall(b"POST /api/v1/namespaces/team-a/notebooks HTTP/1.1\r\n"
                  b"Host: t\r\nContent-Type: application/json\r\n"
                  b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
        s.shutdown(socket.SHUT_WR)
        assert _read_all(s).startswith(b"HTTP/1.1 201")
        assert server.get("Notebook", "halfclose-nb", "team-a")
    finally:
        s.close()


@pytest.mark.parametrize("cl_headers", [
    b"Content-Length: 10\r\nContent-Length: 0\r\n",
    b"Content-Length: 1e2\r\n",
    b"Content-Length: -5\r\n",
], ids=["duplicate", "non-numeric", "negative"])
def test_event_loop_rejects_bad_content_length(m, api_served, cl_headers):
    _, port, _ = api_served
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        s.sendall(b"POST /api/v1/namespaces/team-a/notebooks HTTP/1.1\r\n"
                  b"Host: t\r\n" + cl_headers + b"\r\nXXXXXXXXXX")
        assert _read_all(s).startswith(b"HTTP/1.1 400")
    finally:
        s.close()


def test_watch_body_close_stops_watch(m):
    server = m.store.APIServer()
    m.apis.register_crds(server)
    w = server.watch("Notebook", namespace="team-a")
    wb = m.eventloop.WatchBody(w, frame=lambda item: b"", heartbeat=0.01)
    assert w in server._watches
    wb.close()
    assert w not in server._watches


def test_watch_notify_fires_on_events_and_stop(m):
    """``Watch.set_notify``: fired on registration, on each event and on
    stop — the event-loop pump's wake hook."""
    server = m.store.APIServer()
    m.apis.register_crds(server)
    w = server.watch("Notebook", namespace="team-a", send_initial=False)
    fired = []
    w.set_notify(lambda: fired.append(1))
    assert len(fired) == 1
    server.create(_nb("wake"))
    assert len(fired) == 2 and w.try_get()[0] == "ADDED"
    w.stop()
    assert len(fired) == 3
