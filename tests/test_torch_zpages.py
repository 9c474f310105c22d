"""The port's ``/debug`` pages (``machinery/zpages.py``) held to the JAX
package's: the web apps' routes behind the authenticated user, the
span-ingest route's shape checks and size cap, a remote exporter
shipping spans into one tree on the apiserver's page, the queues and
locks pages over HTTP (the counterparts of
``tests/test_observability.py:575``, ``:608``, ``:758`` and ``:795``, on
both packages), and ``/debug/usage`` on the port's usage meter.
"""

import json
import urllib.error
import urllib.request

import pytest

from test_torch_overload import wire


@pytest.fixture(params=["jax", "torch"])
def m(request):
    return wire(request.param)


def _fresh_collector(m, **kw):
    c = m.tracing.SpanCollector(**kw)
    old = m.tracing.set_collector(c)
    return c, lambda: m.tracing.set_collector(old)


def _notebook(name="nb1", ns="team-a"):
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"template": {"spec": {"containers": [{"name": name, "image": "j"}]}}}}


def test_bff_debug_routes_require_an_authenticated_user(m, monkeypatch):
    app = m.microweb.App("probe", registry=m.prometheus.Registry())
    captured = {}

    def start_response(status, headers):
        captured["status"] = status

    def get(path, user=None):
        path, _, query = path.partition("?")
        env = {"REQUEST_METHOD": "GET", "PATH_INFO": path, "QUERY_STRING": query}
        if user:
            env["HTTP_KUBEFLOW_USERID"] = user
        body = app(env, start_response)
        return captured["status"], b"".join(body)

    monkeypatch.setattr(m.crud_backend, "DEV_MODE", False)
    for path in ("/debug/traces", "/debug/queues", "/debug/locks", "/debug/usage"):
        status, _ = get(path)
        assert status.startswith("401"), (path, status)
    status, body = get("/debug/traces", user="ops@example.com")
    assert status.startswith("200") and b"/debug/traces" in body
    status, body = get("/debug/locks?format=json", user="ops@example.com")
    assert json.loads(body)["enabled"] is False


def test_ingest_endpoint_rejects_wrong_shapes_and_oversize_bodies(m):
    api = m.store.APIServer()
    m.apis.register_crds(api)
    _c, restore = _fresh_collector(m)
    _, port, httpd = m.httpapi.serve(api)
    try:
        def post(payload: bytes):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/debug/traces/ingest",
                                         data=payload, method="POST",
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    return r.status, json.loads(r.read().decode())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read().decode())

        assert post(b"[1, 2]") == (200, {"ingested": 0})
        assert post(b'{"spans": [42, {"traceId": "t", "spanId": "s"}]}') == (
            200, {"ingested": 1})
        assert post(b"not json")[0] == 400
        captured = {}

        def start_response(s, headers):
            captured["status"] = s

        resp = m.zpages.handle_debug(
            {"REQUEST_METHOD": "POST", "PATH_INFO": "/debug/traces/ingest",
             "QUERY_STRING": "", "CONTENT_LENGTH": str(m.zpages.INGEST_MAX_BYTES + 1)},
            start_response)
        assert captured["status"].startswith("413") and resp is not None
    finally:
        restore()
        httpd.shutdown()


def test_remote_span_exporter_ships_to_ingest_endpoint(m):
    api = m.store.APIServer()
    m.apis.register_crds(api)
    server_collector, restore = _fresh_collector(m)
    _, port, httpd = m.httpapi.serve(api)
    try:
        exporter = m.tracing.RemoteSpanExporter(f"http://127.0.0.1:{port}", flush_interval=999)
        with m.tracing.span("reconcile-remote", controller="nbctl") as ctx:
            pass
        rec = server_collector.trace(ctx.trace_id)[0]
        server_collector.clear()
        exporter(rec)
        exporter.flush()
        assert exporter.shipped_total == 1
        shipped = server_collector.trace(ctx.trace_id)
        assert len(shipped) == 1 and shipped[0].name == "reconcile-remote"
        assert shipped[0].attrs.get("controller") == "nbctl"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/traces?trace="
                                    f"{ctx.trace_id}&format=json", timeout=10) as r:
            body = json.loads(r.read().decode())
        assert body["traces"][0]["spans"][0]["name"] == "reconcile-remote"
    finally:
        restore()
        httpd.shutdown()


def test_remote_span_exporter_over_tls(tmp_path):
    """The port's exporter takes an SSL context, so components ship spans
    to an apiserver that serves HTTPS only."""
    import ssl

    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.machinery import httpapi
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.utils import tracing
    from odh_kubeflow_tpu_torch.webhooks.certs import generate_webhook_certs

    cert, key, ca = generate_webhook_certs(dns_names=["localhost"],
                                           ip_sans=["127.0.0.1"]).write(str(tmp_path))
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    api = APIServer()
    apis.register_crds(api)
    collector = tracing.SpanCollector()
    old = tracing.set_collector(collector)
    _, port, httpd = httpapi.serve(api, ssl_context=ctx)
    try:
        exporter = tracing.RemoteSpanExporter(
            f"https://127.0.0.1:{port}", flush_interval=999,
            ssl_context=ssl.create_default_context(cafile=ca))
        with tracing.span("over-tls") as span:
            pass
        rec = collector.trace(span.trace_id)[0]
        collector.clear()
        exporter(rec)
        exporter.flush()
        assert exporter.shipped_total == 1 and exporter.dropped_total == 0
        assert [s.name for s in collector.trace(span.trace_id)] == ["over-tls"]
    finally:
        tracing.set_collector(old)
        httpd.shutdown()


def test_debug_zpages_queues_and_locks_over_http(m):
    api = m.store.APIServer()
    m.apis.register_crds(api)
    mgr = m.runtime.Manager(api)
    mgr.new_controller("notebook-controller", "Notebook", lambda req: m.runtime.Result())
    api.create(_notebook())
    mgr.drain()
    _, port, httpd = m.httpapi.serve(api, metrics_registry=mgr.metrics_registry)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/queues?format=json",
                                    timeout=10) as r:
            queues = json.loads(r.read().decode())
        assert "notebook-controller" in {q["name"] for q in queues["workqueues"]}
        assert queues["store"]["groupCommit"]["queueDepth"] == 0
        assert queues["store"]["wal"] is None
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/locks", timeout=10) as r:
            assert "sanitizer off" in r.read().decode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()


def test_debug_queues_carries_the_wal_counters(tmp_path):
    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.machinery import zpages
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.machinery.wal import WriteAheadLog

    api = APIServer(wal=WriteAheadLog(str(tmp_path)))
    try:
        apis.register_crds(api)
        api.create(_notebook())
        wal = zpages.queues_json(None, api)["store"]["wal"]
        assert wal["fsyncTotal"] >= 1 and wal["appendedTotal"] >= 1
        assert "fsyncTotal=" in zpages.queues_text(None, api)
    finally:
        api.close()


def test_debug_usage_serves_the_meters_timelines():
    from odh_kubeflow_tpu_torch.machinery import usage, zpages
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.scheduling import register_scheduling
    from odh_kubeflow_tpu_torch.utils.prometheus import Registry

    api = APIServer()
    register_scheduling(api)
    usage.register_usage(api)
    clock = {"t": 1000.0}
    meter = usage.UsageMeter(api, usage.UsageConfig(enabled=True, sample_seconds=15.0),
                             registry=Registry(), time_fn=lambda: clock["t"])
    for i, duty in enumerate((10.0, 80.0, 55.5)):
        meter.observe_sample("team-a", "nb1", duty, t=1000.0 + 15 * i)
    data = zpages.usage_json(meter, namespace="team-a")
    assert data["enabled"] is True
    [tl] = data["timelines"]
    assert (tl["namespace"], tl["notebook"]) == ("team-a", "nb1")
    assert [e["value"] for e in tl["events"] if e["kind"] == "sample"] == [10.0, 80.0, 55.5]
    text = zpages.usage_text(meter)
    assert "team-a/nb1" in text and "duty=55.5%" in text
    assert zpages.usage_json(None)["enabled"] is False
    assert "no usage meter" in zpages.usage_text(None)
