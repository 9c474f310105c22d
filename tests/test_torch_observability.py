"""The port's tracing (``utils/tracing.py``), its exemplars and
OpenMetrics (``utils/prometheus.py``) and the span taps against the JAX
package's, on the CPU.

Each check runs the same calls through both packages and compares what
they record: ``traceparent`` round trips and refusals, span records,
the collector's tail keep rules and bounds, tree assembly over cycles
and cross-process orphans, the JSON log formatter; the plain exposition
byte for byte and the OpenMetrics one with its exemplars parsed back
(trace ids and stamps, random in each package, scrubbed). Then the taps:
the store's CREATE stamp, the reconcile span on the creating trace, the
web request's span (a root, or the caller's ``traceparent``), and the
port's cold spawn on a GPU pool assembling one tree with JAX's milestone
set in causal order (JAX's ``tests/test_observability.py``). Last, the
card phase's control plane (``chip_smoke.platform_observe_phase``) with
a stub in place of the notebook's process on the card.
"""

from __future__ import annotations

import importlib
import io
import json
import logging
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

PACKAGES = ("odh_kubeflow_tpu", "odh_kubeflow_tpu_torch")


def mod(port: bool, name: str):
    return importlib.import_module(f"{PACKAGES[port]}.{name}")


def for_both(fn):
    """``fn(port)`` for JAX's package and the port's, each with a fresh
    span collector; the results must be equal. Returns the port's."""
    out = []
    for port in (False, True):
        tracing = mod(port, "utils.tracing")
        collector = tracing.SpanCollector()
        old = tracing.set_collector(collector)
        try:
            out.append(fn(port))
        finally:
            tracing.set_collector(old)
    assert out[1] == out[0]
    return out[1]


def shape(spans):
    """What a trace's spans record, ids and times left out."""
    return sorted((s.name, s.status, s.error, sorted(s.attrs.items()),
                   [(e[1], e[2]) for e in s.events], bool(s.parent_span_id)) for s in spans)


# ---------------------------------------------------------------------------
# tracing


def test_traceparent_round_trips_and_refusals_equal_jax():
    tid, sid = "a" * 32, "b" * 16
    headers = [f"00-{tid}-{sid}-01", f"cc-{tid}-{sid}-00", f"ff-{tid}-{sid}-01",
               f"00-{'0' * 32}-{sid}-01", f"00-{tid}-{'0' * 16}-01", "garbage", None,
               "00-short-bad-01", f" 00-{tid}-{sid}-01 ", f"00-{tid.upper()}-{sid}-01"]

    def run(port):
        tracing = mod(port, "utils.tracing")
        parsed = [(p.trace_id, p.span_id, p.trace_flags, p.name) if p else None
                  for p in map(tracing.parse_traceparent, headers)]
        with tracing.span("root") as ctx:
            header = tracing.traceparent()
            back = tracing.parse_traceparent(header)
            round_trip = (header == f"00-{ctx.trace_id}-{ctx.span_id}-01",
                          back.trace_id == ctx.trace_id, back.span_id == ctx.span_id)
        return [parsed, round_trip, tracing.traceparent(), tracing.TRACE_ANNOTATION]

    assert for_both(run)[1] == (True, True, True)


def test_spans_record_timing_status_exceptions_and_events_as_jax():
    def run(port):
        tracing = mod(port, "utils.tracing")
        with tracing.span("op", user="alice") as ctx:
            tracing.add_event("milestone", detail="x")
            with tracing.span("child", step="1"):
                tracing.set_status("error", "soft failure")
            with tracing.span("dropped"):
                tracing.discard()
        with pytest.raises(RuntimeError):
            with tracing.span("boom", parent=ctx):
                raise RuntimeError("kaput")

        @tracing.traced
        def inner():
            return tracing.current()

        with tracing.span("outer", user="bob") as outer:
            seen = inner()
        spans = tracing.collector().trace(ctx.trace_id)
        return [shape(spans), seen.parent_span_id == outer.span_id, dict(seen.attrs),
                tracing.current() is None,
                tracing.child_span("x").__enter__() is None]

    got = for_both(run)
    names = [s[0] for s in got[0]]
    assert names == ["boom", "child", "op"]


def test_collector_keep_rules_and_bounds_equal_jax():
    def run(port):
        tracing = mod(port, "utils.tracing")
        c = tracing.SpanCollector(capacity=64, max_kept=2, default_threshold_s=0.5,
                                  max_spans_per_trace=16)
        tracing.set_collector(c)
        out = []
        with tracing.span("root-err") as err:
            with tracing.span("child"):
                pass
            tracing.set_status("error", "late failure")
        c.set_threshold("slow-root", 0.0)
        with tracing.span("slow-root") as slow:
            with tracing.span("fast-child"):
                pass
        with tracing.span("plain") as plain:
            pass
        out.append([c.keep_reason(t.trace_id) for t in (err, slow, plain)])
        out.append([shape(c.trace(t.trace_id)) for t in (err, slow)])
        for _ in range(80):
            with tracing.span("filler"):
                pass
        out.append([len(c.trace(plain.trace_id)), len(c.trace(err.trace_id))])
        for _ in range(40):  # a crash loop keeps one trace: bounded
            with tracing.span("retry", trace_id=err.trace_id):
                pass
        out.append([len(c.trace(err.trace_id)), c.trace_spans_dropped_total])
        with tracing.span("third") as third:  # max_kept 2: the oldest goes
            tracing.set_status("error", "x")
        out.append([[r for _, r, _ in c.kept_traces()], c.keep_reason(err.trace_id),
                    c.keep_reason(third.trace_id), c.recorded_total])
        return out

    got = for_both(run)
    assert got[0] == ["error", "slow", None] and got[2] == [0, 2]
    assert got[3] == [16, 26] and got[4][:3] == [["error", "slow"], None, "error"]


def test_assembly_over_cycles_orphans_and_the_wire_form_equals_jax():
    def run(port):
        tracing = mod(port, "utils.tracing")

        def rec(sid, parent, start):
            return tracing.SpanRecord(trace_id="t" * 32, span_id=sid, parent_span_id=parent,
                                      name=f"s-{sid[0]}", start=start, duration=0.001)

        def flat(node):
            return [node["span"].span_id] + [x for c in node["children"] for x in flat(c)]

        cases = [[rec("a" * 16, "a" * 16, 5.0)],
                 [rec("r" * 16, "", 1.0), rec("b" * 16, "c" * 16, 2.0),
                  rec("c" * 16, "b" * 16, 3.0)],
                 [rec("b" * 16, "c" * 16, 2.0), rec("c" * 16, "b" * 16, 3.0)],
                 [rec("r" * 16, "", 1.0), rec("k" * 16, "d" * 16, 9e9),
                  rec("m" * 16, "r" * 16, 1.5), rec("n" * 16, "x" * 16, 0.5)]]
        out = [flat(tracing.assemble(spans)) for spans in cases]
        wire = [tracing.SpanRecord.from_dict(json.loads(json.dumps(s.to_dict())))
                for s in cases[3]]
        out.append(flat(tracing.assemble(wire)))
        out.append(tracing.assemble([]))
        text = tracing.render_trace(cases[3], reason="slow")
        out.append([line.split("  ")[1 if i else 0].strip() for i, line in
                    enumerate(text.splitlines())][1:])
        return out

    got = for_both(run)
    assert sorted(got[1]) == sorted(["r" * 16, "b" * 16, "c" * 16])
    assert got[3][0] == "n" * 16  # the earliest orphan is the primary root


def test_json_log_formatter_and_idempotent_setup_equal_jax():
    def run(port):
        tracing = mod(port, "utils.tracing")
        buf = io.StringIO()
        handler = logging.StreamHandler(buf)
        handler.setFormatter(tracing.JsonLogFormatter())
        log = logging.getLogger(f"obs-test-{port}")
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        try:
            with tracing.span("reconcile", controller="nb", reconcile_key="ns/a") as ctx:
                tracing.set_status("error", "x")
                log.info("inside")
            log.info("outside")
        finally:
            log.removeHandler(handler)
        inside, outside = (json.loads(line) for line in buf.getvalue().splitlines())
        assert inside["trace_id"] == ctx.trace_id and inside["span_id"] == ctx.span_id
        keys = [sorted(inside), sorted(outside)]
        values = {k: inside[k] for k in ("span", "span.status", "trace_flags", "controller",
                                         "reconcile_key", "message", "level")}
        root = logging.getLogger()
        before, level = list(root.handlers), root.level
        h1 = tracing.configure_json_logging()
        try:
            h2 = tracing.configure_json_logging(logging.DEBUG)
            stacked = [h for h in root.handlers if h not in before]
            same = [h1 is h2, stacked == [h1], root.level == logging.DEBUG]
        finally:
            root.removeHandler(h1)
            root.setLevel(level)
        return [keys, values, same]

    assert for_both(run)[2] == [True, True, True]


def test_remote_span_exporter_ships_batches_to_an_ingest_endpoint():
    """The exporter's contract against a small WSGI endpoint standing in
    for ``/debug/traces/ingest`` (which comes with the port's zpages):
    batches POSTed as ``{"spans": [...]}`` in the wire form, a down
    endpoint counted as dropped, never raised; a full buffer drops."""
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    from odh_kubeflow_tpu_torch.utils import tracing

    received = []

    def ingest(environ, start_response):
        body = environ["wsgi.input"].read(int(environ.get("CONTENT_LENGTH") or 0))
        received.append((environ["PATH_INFO"], environ.get("CONTENT_TYPE"), json.loads(body)))
        start_response("202 Accepted", [("Content-Type", "application/json")])
        return [b"{}"]

    class Quiet(WSGIRequestHandler):
        def log_message(self, *a):
            pass

    httpd = make_server("127.0.0.1", 0, ingest, handler_class=Quiet)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    collector = tracing.SpanCollector()
    old = tracing.set_collector(collector)
    exporter = tracing.RemoteSpanExporter(f"http://127.0.0.1:{httpd.server_address[1]}/",
                                          flush_interval=999, max_batch=2, max_buffer=5)
    exporter.install()
    try:
        with tracing.span("reconcile-remote", controller="nbctl") as ctx:
            with tracing.span("child"):
                pass
        with tracing.span("other"):
            pass
        exporter.flush()
        assert exporter.shipped_total == 3 and exporter.dropped_total == 0
        assert [(p, ct) for p, ct, _ in received] == [
            ("/debug/traces/ingest", "application/json")] * 2
        shipped = [tracing.SpanRecord.from_dict(d) for _, _, b in received for d in b["spans"]]
        assert {s.name for s in shipped if s.trace_id == ctx.trace_id} == {
            "reconcile-remote", "child"}
        assert tracing.assemble([s for s in shipped if s.trace_id == ctx.trace_id])[
            "span"].attrs == {"controller": "nbctl"}
    finally:
        exporter.close()
        httpd.shutdown()
        httpd.server_close()
        tracing.set_collector(old)
    # the endpoint is gone: a flush drops and counts, and never raises
    for _ in range(7):
        exporter(tracing.SpanRecord("t" * 32, "s" * 16, "", "late", 0.0, 0.0))
    exporter.flush()
    assert exporter.dropped_total == 2 + 5 and exporter.shipped_total == 3


# ---------------------------------------------------------------------------
# exemplars and OpenMetrics


def _fill(port, spans: list):
    prom, tracing = mod(port, "utils.prometheus"), mod(port, "utils.tracing")
    reg = prom.Registry()
    h = reg.histogram("req_seconds", "latency", buckets=(0.1, 1.0), labelnames=("app",))
    plain_h = reg.histogram("size_bytes", "sizes", buckets=(10, 100), exemplars=False)
    c = reg.counter("req_total", 'requests "quoted"\\back\nslash', labelnames=("code",))
    g = reg.gauge("depth", "queue depth")
    reg.register_collector(lambda: iter(["# HELP live x", "# TYPE live gauge", "live 3"]))
    h.observe(5.0, {"app": "a"})  # outside any span: no exemplar
    with tracing.span("traced-req") as ctx:
        h.observe(0.05, {"app": "a"})
        h.observe(0.5, {"app": 'b"\n'})
        plain_h.observe(42)
    spans.append(ctx.trace_id)
    c.inc({"code": "200"}, 3)
    g.set(1.5)
    return reg, h


def test_plain_exposition_is_jaxs_byte_for_byte_and_openmetrics_parses_back_the_same():
    def run(port):
        prom = mod(port, "utils.prometheus")
        spans = []
        reg, h = _fill(port, spans)
        plain = reg.exposition()
        om = reg.exposition(openmetrics=True)
        # trace ids and stamps are random in each package
        om_scrubbed = re.sub(r'( # \{trace_id="T+"\} [^ ]+) [0-9.]+', r"\1 TS",
                             om.replace(spans[0], "T" * 32))
        fams = prom.parse_openmetrics(om)
        exemplars = {(labels.get("app"), labels.get("le")): (ex[0], ex[1])
                     for name, labels, _, ex in fams["req_seconds"]["samples"] if ex}
        return [plain, om_scrubbed,
                {k: (v[0]["trace_id"] == spans[0], v[1]) for k, v in exemplars.items()},
                sorted(fams), fams["req"]["type"], fams["req"]["samples"],
                [h.count_le(0.1), h.count_le(1.0, {"app": "a"}), h.count_le(0.7),
                 h.count_matching(), h.count_matching({"app": "a"}), h.samples()],
                reg.metric("req_total").sum_matching({"code": "200"}),
                reg.metric("req_total").samples(),
                prom.negotiate_openmetrics("application/openmetrics-text; version=1.0.0"),
                prom.negotiate_openmetrics("text/plain"), prom.negotiate_openmetrics(None),
                prom.OPENMETRICS_CONTENT_TYPE, prom.PLAIN_CONTENT_TYPE]

    got = for_both(run)
    assert "trace_id" not in got[0] and "# EOF" not in got[0]
    assert got[1].rstrip().endswith("# EOF") and "# TYPE req counter" in got[1]
    assert got[2] == {("a", "0.1"): (True, 0.05), ('b"\n', "1"): (True, 0.5)}


def test_openmetrics_parser_refusals_and_metric_name_lint_equal_jax():
    bad = ["# TYPE foo\n# EOF\n", "foo 1\n", "# HELP a x\n# TYPE a counter\na 1\n# EOF\nb 2\n",
           "# HELP a x\na 1\n# EOF\n", "# TYPE a counter\na{x=} 1\n# EOF\n"]
    names = [("ok_total", "counter", ()), ("Bad", "gauge", ()), ("c", "counter", ()),
             ("g_total", "gauge", ()), ("lat", "histogram", ()), ("lat_seconds", "histogram",
                                                                  ("Code",)),
             ("w_bytes", "histogram", ("le_x",))]

    def run(port):
        prom = mod(port, "utils.prometheus")
        refused = []
        for text in bad:
            try:
                prom.parse_openmetrics(text)
                refused.append(None)
            except ValueError as e:
                refused.append(str(e))
        reg = prom.Registry()
        reg.counter("bad_name", "x")
        reg.histogram("fine_seconds", "x")
        return [refused, [prom.metric_name_violations(*n) for n in names],
                prom.lint_metric_names(reg), prom.HISTOGRAM_UNIT_SUFFIXES]

    got = for_both(run)
    assert got[0][:3] == [got[0][0], got[0][1], got[0][2]] and all(got[0][:3])


# ---------------------------------------------------------------------------
# the taps


def _store(port):
    apis, store = mod(port, "apis"), mod(port, "machinery.store")
    api = store.APIServer()
    apis.register_crds(api)
    return api


def _notebook(name):
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"template": {"spec": {"containers": [{"name": name, "image": "i"}]}}}}


def test_the_store_stamps_a_traced_create_only_as_jax():
    """A CREATE inside a request span carries its trace id; a create
    outside any span, inside a reconcile span (a controller's child) or
    of an Event does not, and an update never rewrites the stamp."""
    def run(port):
        tracing, api = mod(port, "utils.tracing"), _store(port)
        ann = tracing.TRACE_ANNOTATION
        with tracing.span("jwa:POST") as web:
            a = api.create(_notebook("a"))
            api.emit_event(a, "Created", "x")
        b = api.create(_notebook("b"))
        with tracing.span("reconcile", controller="nb"):
            c = api.create(_notebook("c"))
        with tracing.span("other"):
            a2 = api.patch("Notebook", "a", {"metadata": {"labels": {"x": "1"}}}, "default")
        events = [e["metadata"].get("annotations", {}) for e in api.list("Event")]
        return [a["metadata"]["annotations"][ann] == web.trace_id,
                ann in (b["metadata"].get("annotations") or {}),
                ann in (c["metadata"].get("annotations") or {}),
                a2["metadata"]["annotations"][ann] == web.trace_id, events]

    assert for_both(run) == [True, False, False, True, [{}]]


def test_reconciles_run_on_the_creating_trace_and_errors_mark_it_as_jax():
    def run(port):
        tracing, api = mod(port, "utils.tracing"), _store(port)
        runtime = mod(port, "controllers.runtime")
        mgr = runtime.Manager(api)
        seen = []

        def reconcile(req):
            ctx = tracing.current()
            seen.append((req.name, ctx.name, tuple(sorted(ctx.attrs.items()))))
            if req.name == "fails" and len(seen) < 4:
                raise RuntimeError("transient")
            return runtime.Result()

        mgr.new_controller("nb-ctl", "Notebook", reconcile)
        with tracing.span("jwa:POST") as web:
            api.create(_notebook("traced"))
            api.create(_notebook("fails"))
        api.create(_notebook("untraced"))
        mgr.drain()
        for _ in range(40):  # the error backoff's requeues come due
            mgr.drain()
            if sum(1 for n, _, _ in seen if n == "fails") >= 2:
                break
            import time

            time.sleep(0.01)
        spans = tracing.collector().trace(web.trace_id)
        kept = tracing.collector().keep_reason(web.trace_id)
        # JAX's store also records a child span per traced create
        return [sorted(set(seen)), sorted({(s.name, s.status, s.attrs.get("reconcile_key", ""))
                                           for s in spans if s.name != "store.create"}), kept]

    got = for_both(run)
    assert ("reconcile", "error", "default/fails") in got[1] and got[2] == "error"


def test_a_web_request_is_a_trace_root_or_joins_the_callers_traceparent():
    def run(port):
        tracing, microweb = mod(port, "utils.tracing"), mod(port, "web.microweb")
        prom = mod(port, "utils.prometheus")
        reg = prom.Registry()
        app = microweb.App("probe", registry=reg)
        seen = []

        @app.route("/ok")
        def ok(request):
            seen.append(tracing.current())
            return microweb.Response({"ok": True})

        @app.route("/boom")
        def boom(request):
            raise RuntimeError("kaput")

        server = app.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        tid, sid = "c" * 32, "d" * 16
        try:
            urllib.request.urlopen(base + "/ok", timeout=10).read()
            req = urllib.request.Request(base + "/ok",
                                         headers={"traceparent": f"00-{tid}-{sid}-01"})
            urllib.request.urlopen(req, timeout=10).read()
            # the latest observation's bucket carries its trace (the last
            # write wins, so read it before another request lands)
            om = prom.parse_openmetrics(reg.exposition(openmetrics=True))
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(base + "/boom", timeout=10)
            deadline = time.monotonic() + 5  # a front end may record after it answers
            while not (tracing.collector().kept_traces() and tracing.collector().trace(tid)) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            server.shutdown()
            server.server_close()
        root, joined = seen
        spans = {s.name: s for s in tracing.collector().trace(tid)}
        exemplar_traces = {ex[0]["trace_id"] for _, _, _, ex in
                           om["http_request_duration_seconds"]["samples"] if ex}
        kept = [(r, [s.name for s in sp if s.name != "web.dispatch"])
                for _, r, sp in tracing.collector().kept_traces()]
        return [root.name, root.parent_span_id, joined.trace_id == tid,
                sid in {s.parent_span_id for s in spans.values()},
                # JAX's event-loop front end adds its dispatch span
                sorted(set(spans) - {"web.dispatch"}), tid in exemplar_traces,
                [n for _, n in sorted(kept)]]

    got = for_both(run)
    assert got[:4] == ["probe:GET /ok", "", True, True]
    assert got[5] is True and got[6] == [["probe:GET /boom"]]


def _spawn(port):
    """One 4-accelerator notebook POSTed inside a request span onto a pool
    of one 4-chip TPU host (JAX) or one 4-GPU L4 node (the port), with
    gang admission: drained to ready. Returns the trace's spans."""
    tracing, api = mod(port, "utils.tracing"), _store(port)
    runtime = mod(port, "controllers.runtime")
    nbmod = mod(port, "controllers.notebook")
    scheduling = mod(port, "scheduling")
    scheduler = mod(port, "scheduling.scheduler")
    kubelet = mod(port, "machinery.kubelet")
    apis = mod(port, "apis")
    scheduling.register_scheduling(api)
    cluster = kubelet.FakeCluster(api)
    cluster.add_node("cpu-0")
    if port:
        cluster.add_gpu_node_pool("l4", "nvidia-l4", num_nodes=1, gpus_per_node=4)
        ann = {apis.GPU_ACCELERATOR_ANNOTATION: "nvidia-l4", apis.GPU_COUNT_ANNOTATION: "4"}
    else:
        cluster.add_tpu_node_pool("v5e", "tpu-v5-lite-podslice", "2x2", num_hosts=1,
                                  chips_per_host=4)
        ann = {apis.TPU_ACCELERATOR_ANNOTATION: "tpu-v5-lite-podslice",
               apis.TPU_TOPOLOGY_ANNOTATION: "2x2"}
    mgr = runtime.Manager(api)
    nbmod.NotebookController(api, nbmod.NotebookControllerConfig(enable_queueing=True),
                             registry=mod(port, "utils.prometheus").Registry()).register(mgr)
    scheduler.SliceScheduler(api, registry=mod(port, "utils.prometheus").Registry()).register(mgr)
    nb = _notebook("traced-nb")
    nb["metadata"]["annotations"] = ann
    with tracing.span("jwa:POST /notebooks") as root:
        api.create(nb)
    for _ in range(20):
        mgr.drain()
        cluster.step()
        mgr.drain()
        if (api.get("StatefulSet", "traced-nb", "default").get("status") or {}).get(
                "readyReplicas"):
            break
    else:
        raise AssertionError("the spawn never became ready")
    return tracing, tracing.collector().trace(root.trace_id)


def test_a_cold_spawn_on_a_gpu_pool_is_one_trace_with_jaxs_milestones():
    milestones = ("scheduler.admit", "kubelet.gang_bind", "kubelet.container_start")

    def run(port):
        tracing, spans = _spawn(port)
        tree = tracing.assemble(spans)

        def size(node):
            return 1 + sum(size(c) for c in node["children"])

        ends = {}
        for s in spans:
            ends[s.name] = max(ends.get(s.name, 0.0), s.end)
        order = [ends[m] for m in milestones]
        # JAX's store also records a child span per traced create
        names = sorted({s.name for s in spans} - {"store.create"})
        return [names, size(tree) == len(spans), tree["span"].name, order == sorted(order),
                sorted((s.name, s.attrs.get("workload", "")) for s in spans
                       if s.name in milestones[:2])]

    got = for_both(run)
    assert set(milestones) <= set(got[0]) and got[1:4] == [True, "jwa:POST /notebooks", True]


def test_a_restore_is_the_session_restore_span_of_the_resume_trace(tmp_path):
    """The session manager's restore runs in a ``session.restore`` span
    under the reconcile of the notebook's trace; a cold outcome marks it
    an error, so the collector keeps the trace."""
    from odh_kubeflow_tpu_torch.utils import tracing

    src = open(mod(True, "sessions.manager").__file__).read()
    assert 'tracing.span("session.restore"' in src and "tracing.discard()" in src
    assert 'tracing.set_status("error", f"cold resume: {result}")' in src
    assert tracing.TRACE_ANNOTATION == mod(False, "utils.tracing").TRACE_ANNOTATION


# ---------------------------------------------------------------------------
# the card phase's control plane


def test_platform_observe_phase_drives_the_fleet_on_a_stub_process(tmp_path):
    """``chip_smoke.platform_observe_phase`` on the CPU, a stub in place of
    the notebook's process on the card (it writes one session into the
    PVC's host directory and reports the counts the card's run must
    show): the workgroup's quota row, the locked notebook released and
    ready, its trace and exemplar, the Tensorboard over the trace PVC and
    its ``/logs``, the dashboard's 16 / 1 GPUs, SLO rows and 503."""
    import gzip
    import os

    import chip_smoke
    from odh_kubeflow_tpu_torch.utils import profiling

    seen = {}

    def stub(env, scratch):
        seen["env"] = env
        logdir = env[profiling.LOGDIR_ENV]
        session = os.path.join(logdir, "plugins", "profile", "2026_01_01_00_00_00_000001")
        os.makedirs(session)
        with gzip.open(os.path.join(session, "host.pt.trace.json.gz"), "wt") as f:
            json.dump({"traceEvents": []}, f)
        per_step = dict(chip_smoke.TRAIN_LAUNCHES_PER_STEP)
        return {"imported_s": 0.0, "trainer_s": 0.0, "first_step_s": 0.0, "profiled_s": 0.0,
                "process_s": 0.0, "first_step_wall_s": 0.0, "profiled_step_wall_s": 0.0,
                "capture_wall_s": 0.0, "first_loss": 1.0, "loss": 1.0, "launched": per_step,
                "traced": per_step, "device_ms": {}, "trace_kernels": 0,
                "trace_kernel_ms": 0.0, "trace_events": 0, "files": ["host.pt.trace.json.gz"],
                "server": {"port": 1, "healthz": 200}, "built": [], "device": "stub",
                "sessions": [session],
                "launches_total": {k: 2 * v for k, v in per_step.items()}}

    record, launches = chip_smoke.platform_observe_phase(run_profile=stub)
    assert launches == {k: 2 * v for k, v in chip_smoke.TRAIN_LAUNCHES_PER_STEP.items()}
    assert seen["env"][profiling.LOGDIR_ENV].endswith(os.path.join("trace-pvc", "logs"))
    assert record["workgroup"]["quota"][0]["resource"] == "requests.nvidia.com/gpu"
    assert record["exposure"]["lock_released"] and record["trace"]["causal_order"]
    assert record["trace"]["exemplar"] and record["trace"]["spans"] == record["trace"][
        "tree_nodes"]
    assert record["tensorboard"]["listed"] == [
        "plugins/profile/2026_01_01_00_00_00_000001/host.pt.trace.json.gz"]
    panel = record["dashboard"]["metrics"]["gpu"][0]
    assert (panel["capacityGpus"], panel["usedGpus"]) == (16.0, 1.0)
    assert record["dashboard"]["usage_status"] == 503
    assert {r["slo"] for r in record["dashboard"]["slo"]} == {
        "spawn-ready-p99", "web-serial-p99", "reconcile-errors", "warm-resume-p95",
        "idle-waste"}
    assert "TWA_LOCAL_LOGS_ROOT" not in os.environ
