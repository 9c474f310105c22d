"""zpages: in-process debug surfaces (``/debug/...``; the port's copy
of the JAX package's ``machinery/zpages.py``).

The reference platform leans on external observability (Grafana,
Jaeger); a from-scratch control plane needs the opencensus-style
answer — live debug pages served by the process itself, no pipeline
required:

- ``/debug/traces`` — recent kept (slow/error) traces from the span
  collector as indented trees with durations; ``?trace=<id>`` fetches
  one trace (kept or still in the recent ring), ``?format=json``
  returns machine-readable spans (the spawn bench derives its
  queue/schedule/start breakdown from this).
- ``/debug/traces/ingest`` — POST target split-process components ship
  finished spans to (``tracing.RemoteSpanExporter``), so a trace that
  crosses webhook→store→reconcile→scheduler→kubelet hops assembles
  into ONE tree on the apiserver.
- ``/debug/queues`` — workqueue depths/adds (from the metrics
  registry) plus the store's group-commit pipeline depths and WAL
  counters.
- ``/debug/locks`` — the concurrency sanitizer's live lock-order
  graph and any reports, when ``GRAFT_SANITIZE=1``.
- ``/debug/usage`` — the usage meter's per-notebook duty timelines.

``handle_debug`` serves these for a raw WSGI façade (httpapi);
``install_debug_routes`` mounts the same pages on a microweb App (the
web/BFF processes)."""

from __future__ import annotations

import json
from typing import Any, Optional

from odh_kubeflow_tpu_torch.machinery import usage
from odh_kubeflow_tpu_torch.utils import tracing
from odh_kubeflow_tpu_torch.utils.prometheus import Registry

Obj = dict[str, Any]

# /debug/traces/ingest body cap: a full exporter batch (512 spans ×
# ~1KB) fits comfortably; anything bigger gets 413 instead of an
# unbounded parse on an anonymous endpoint
INGEST_MAX_BYTES = 8 * 1024 * 1024


# ---------------------------------------------------------------------------
# traces


def traces_json(
    collector: Optional[tracing.SpanCollector] = None,
    trace_id: str = "",
    limit: int = 50,
) -> Obj:
    c = collector or tracing.collector()
    if trace_id:
        spans = c.trace(trace_id)
        traces = (
            [
                {
                    "traceId": trace_id,
                    "keep": c.keep_reason(trace_id) or "",
                    "spans": [s.to_dict() for s in spans],
                }
            ]
            if spans
            else []
        )
    else:
        traces = [
            {
                "traceId": tid,
                "keep": reason,
                "spans": [s.to_dict() for s in spans],
            }
            for tid, reason, spans in c.kept_traces(limit)
        ]
    return {"traces": traces, "recordedTotal": c.recorded_total}


def traces_text(
    collector: Optional[tracing.SpanCollector] = None,
    trace_id: str = "",
    limit: int = 20,
) -> str:
    c = collector or tracing.collector()
    if trace_id:
        spans = c.trace(trace_id)
        if not spans:
            return f"trace {trace_id}: no recorded spans\n"
        return tracing.render_trace(spans, c.keep_reason(trace_id) or "")
    kept = c.kept_traces(limit)
    header = (
        f"/debug/traces — {len(kept)} kept slow/error trace(s), "
        f"{c.recorded_total} spans recorded "
        f"(threshold default {c.default_threshold_s}s)\n\n"
    )
    if not kept:
        return header + "(no kept traces; ?trace=<id> reads the recent ring)\n"
    return header + "\n".join(
        tracing.render_trace(spans, reason) for _, reason, spans in kept
    )


def ingest_spans(body: Any, collector: Optional[tracing.SpanCollector] = None) -> int:
    """Record spans shipped by a remote exporter. Straight into the
    collector — NOT through ``record_span`` — so an apiserver that
    itself exports can never loop spans back out. Tolerant of
    wrong-shaped (but valid-JSON) input: bad entries are skipped, a
    non-object body ingests nothing."""
    c = collector or tracing.collector()
    spans = body.get("spans") if isinstance(body, dict) else None
    if not isinstance(spans, list):
        return 0
    n = 0
    for d in spans:
        if not isinstance(d, dict):
            continue
        try:
            c.record(tracing.SpanRecord.from_dict(d))
            n += 1
        except (TypeError, ValueError, AttributeError):
            continue
    return n


# ---------------------------------------------------------------------------
# queues


def queues_json(
    registry: Optional[Registry] = None, api: Optional[Any] = None
) -> Obj:
    out: Obj = {"workqueues": [], "store": None}
    if registry is not None:
        depth = registry.metric("workqueue_depth")
        adds = registry.metric("workqueue_adds_total")
        adds_by = (
            {tuple(sorted(k.items())): v for k, v in adds.samples()}
            if adds is not None
            else {}
        )
        if depth is not None:
            for labels, value in depth.samples():
                out["workqueues"].append(
                    {
                        "name": labels.get("name", ""),
                        "depth": value,
                        "adds": adds_by.get(
                            tuple(sorted(labels.items())), 0.0
                        ),
                    }
                )
    debug_fn = getattr(api, "debug_queues", None)
    if debug_fn is not None:
        out["store"] = debug_fn()
    return out


def queues_text(
    registry: Optional[Registry] = None, api: Optional[Any] = None
) -> str:
    data = queues_json(registry, api)
    lines = ["/debug/queues", "", "workqueues:"]
    if data["workqueues"]:
        for q in data["workqueues"]:
            lines.append(
                f"  {q['name']}: depth={q['depth']:.0f} adds={q['adds']:.0f}"
            )
    else:
        lines.append("  (none registered)")
    store = data["store"]
    if store is not None:
        gc = store.get("groupCommit") or {}
        lines += [
            "",
            "group-commit pipeline:",
            f"  queueDepth={gc.get('queueDepth')} pending={gc.get('pending')}"
            f" batchHighWater={gc.get('batchHighWater')}"
            f" groupCommit={gc.get('groupCommit')}",
        ]
        wal = store.get("wal")
        if wal:
            lines += [
                "wal:",
                f"  fsyncTotal={wal.get('fsyncTotal')} "
                f"appendedTotal={wal.get('appendedTotal')} "
                f"recordsSinceSnapshot={wal.get('recordsSinceSnapshot')} "
                f"bytesSinceSnapshot={wal.get('bytesSinceSnapshot')}",
            ]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# locks


def locks_json() -> Obj:
    from odh_kubeflow_tpu_torch.analysis import sanitizer

    return {
        "enabled": sanitizer.enabled(),
        "orderGraph": sanitizer.order_graph() if sanitizer.enabled() else {},
        "reports": sanitizer.reports() if sanitizer.enabled() else [],
    }


def locks_text() -> str:
    data = locks_json()
    if not data["enabled"]:
        return (
            "/debug/locks\n\nsanitizer off — start the process with "
            "GRAFT_SANITIZE=1 to record the live lock-order graph\n"
        )
    lines = ["/debug/locks", "", "lock-order graph (held -> acquired-after):"]
    graph = data["orderGraph"]
    if not graph:
        lines.append("  (no multi-lock acquisitions witnessed yet)")
    for src, dsts in graph.items():
        for dst, site in dsts.items():
            lines.append(f"  {src} -> {dst}  (first: {site})")
    lines.append("")
    if data["reports"]:
        lines.append("REPORTS:")
        lines.extend(f"  {r}" for r in data["reports"])
    else:
        lines.append("no violations reported")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# usage (GPU-hour ledger timelines; the summary rows carry the port's
# field names, ``machinery/usage.py`` ALLOCATED / ACTIVE / IDLE)


def usage_json(
    meter: Optional[Any] = None, namespace: str = "", limit: int = 50
) -> Obj:
    if meter is None:
        return {"enabled": False, "timelines": [], "summary": None}
    return {
        "enabled": bool(meter.config.enabled),
        "summary": meter.summary(),
        "timelines": meter.timelines(namespace=namespace, limit=limit),
    }


def usage_text(
    meter: Optional[Any] = None, namespace: str = "", limit: int = 50
) -> str:
    data = usage_json(meter, namespace=namespace, limit=limit)
    if meter is None:
        return "/debug/usage\n\nno usage meter wired into this process\n"
    lines = [
        "/debug/usage — GPU-hour ledger "
        + ("(sampling on)" if data["enabled"] else "(sampling OFF)"),
        "",
    ]
    summary = data["summary"] or {}
    lines.append(
        f"open allocations: {summary.get('openAllocations', 0)}  "
        f"window={summary.get('windowSeconds')}s  "
        f"retention={summary.get('retentionSeconds')}s"
    )
    lines.append("")
    lines.append("namespaces (by allocated GPU-seconds):")
    for row in summary.get("namespaces", []):
        util = row["utilization"]
        lines.append(
            f"  {row['namespace']}: alloc={row[usage.ALLOCATED]:.0f}s "
            f"active={row[usage.ACTIVE]:.0f}s "
            f"idle={row[usage.IDLE]:.0f}s "
            f"util={util if util is None else f'{util:.1%}'}"
        )
    if not summary.get("namespaces"):
        lines.append("  (no usage recorded)")
    lines.append("")
    lines.append("recent duty-cycle timelines (newest first):")
    for tl in data["timelines"]:
        state = "open" if tl["open"] else "closed"
        lines.append(f"  {tl['namespace']}/{tl['notebook']} [{state}]:")
        for ev in tl["events"]:
            if ev["kind"] == "sample":
                lines.append(f"    {ev['t']:.1f}  duty={ev['value']:.1f}%")
            else:
                lines.append(f"    {ev['t']:.1f}  -- {ev['value']} --")
    if not data["timelines"]:
        lines.append("  (no samples observed)")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# WSGI plumbing


def handle_debug(
    environ,
    start_response,
    registry: Optional[Registry] = None,
    api: Optional[Any] = None,
    collector: Optional[tracing.SpanCollector] = None,
    meter: Optional[Any] = None,
) -> Optional[list[bytes]]:
    """Serve a ``/debug/...`` request on a raw WSGI façade; None when
    the path isn't a debug page (the caller continues dispatch).
    Anonymous by design, like ``/metrics`` and the health probes."""
    path = environ.get("PATH_INFO", "/")
    if not path.startswith("/debug/"):
        return None
    method = environ.get("REQUEST_METHOD", "GET")
    from urllib.parse import parse_qs

    qs = parse_qs(environ.get("QUERY_STRING", ""))
    fmt = qs.get("format", ["text"])[0]

    def _respond(status: int, payload: bytes, ctype: str) -> list[bytes]:
        start_response(
            f"{status} {'OK' if status < 400 else 'Error'}",
            [
                ("Content-Type", ctype),
                ("Content-Length", str(len(payload))),
            ],
        )
        return [payload]

    def _json(status: int, body: Obj) -> list[bytes]:
        return _respond(
            status,
            json.dumps(body).encode(),  # dumps-ok: cold debug page, not a serving path
            "application/json",
        )

    def _text(body: str) -> list[bytes]:
        return _respond(200, body.encode(), "text/plain; charset=utf-8")

    if path == "/debug/traces/ingest" and method == "POST":
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            return _json(400, {"error": "invalid Content-Length"})
        if length > INGEST_MAX_BYTES:
            # anonymous endpoint (like /metrics): the body must never
            # be attacker-sized — parse is the unbounded cost, the
            # collector ring already bounds storage
            return _json(
                413,
                {
                    "error": f"span batch over {INGEST_MAX_BYTES} bytes; "
                    "split the export batch"
                },
            )
        try:
            raw = environ["wsgi.input"].read(length) if length else b"{}"
            body = json.loads(raw.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            return _json(400, {"error": "invalid JSON body"})
        n = ingest_spans(body, collector)
        return _json(200, {"ingested": n})
    if path == "/debug/traces" and method == "GET":
        tid = qs.get("trace", [""])[0]
        if fmt == "json":
            return _json(200, traces_json(collector, trace_id=tid))
        return _text(traces_text(collector, trace_id=tid))
    if path == "/debug/queues" and method == "GET":
        if fmt == "json":
            return _json(200, queues_json(registry, api))
        return _text(queues_text(registry, api))
    if path == "/debug/locks" and method == "GET":
        if fmt == "json":
            return _json(200, locks_json())
        return _text(locks_text())
    if path == "/debug/usage" and method == "GET":
        ns = qs.get("namespace", [""])[0]
        if fmt == "json":
            return _json(200, usage_json(meter, namespace=ns))
        return _text(usage_text(meter, namespace=ns))
    return _json(404, {"error": f"unknown debug page {path}"})


def install_debug_routes(
    app,
    registry: Optional[Registry] = None,
    api: Optional[Any] = None,
    require_user: bool = True,
    meter: Optional[Any] = None,
) -> None:
    """Mount the zpages on a microweb App (the web/BFF processes get
    the same debug surface the apiserver façade serves natively).

    Unlike the apiserver façade (anonymous like /metrics — the
    kube-apiserver debug posture), the BFFs are user-facing and
    uniformly authenticated, and trace attrs carry cross-tenant
    notebook names/namespaces/errors — so by default these routes
    demand the same authenticated identity every sibling route does."""
    from odh_kubeflow_tpu_torch.web.microweb import Response

    def _render(request, json_fn, text_fn):
        if require_user:
            # same identity contract as every other BFF route (401
            # without it, dev-mode fallback applies)
            from odh_kubeflow_tpu_torch.web.crud_backend import user_of

            user_of(request)
        if request.query.get("format") == "json":
            return Response(json_fn())
        return Response(text_fn(), content_type="text/plain; charset=utf-8")

    @app.route("/debug/traces")
    def debug_traces(request):
        tid = request.query.get("trace", "")
        return _render(
            request,
            lambda: traces_json(trace_id=tid),
            lambda: traces_text(trace_id=tid),
        )

    @app.route("/debug/queues")
    def debug_queues(request):
        return _render(
            request,
            lambda: queues_json(registry, api),
            lambda: queues_text(registry, api),
        )

    @app.route("/debug/locks")
    def debug_locks(request):
        return _render(request, locks_json, locks_text)

    @app.route("/debug/usage")
    def debug_usage(request):
        ns = request.query.get("namespace", "")
        return _render(
            request,
            lambda: usage_json(meter, namespace=ns),
            lambda: usage_text(meter, namespace=ns),
        )
