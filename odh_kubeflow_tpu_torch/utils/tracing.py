"""Trace propagation, span recording and structured logging (the port's
copy of the JAX package's ``utils/tracing.py``, which imports nothing of
that package).

The reference gets request correlation for free from controller-runtime
zap logs and kube-apiserver audit IDs; this from-scratch runtime needs
its own: W3C ``traceparent``-style context carried over HTTP
(``web/microweb.py`` opens each request's span or joins the caller's),
a contextvar-propagated span so any code (admission hook, store write,
reconcile) can ask "what request am I part of", and a JSON log
formatter that stamps every record with ``trace_id``/``span_id`` plus
span attributes (``controller``, ``reconcile_key``).

The trace crosses the async apiserver→controller hop via an object
annotation: the store stamps ``TRACE_ANNOTATION`` on CREATE when a span
is active, and the controller runtime picks it up from the watch event
so the reconcile's spans share the originating request's trace_id
(webhook admission → apiserver write → reconcile → scheduler admission
→ kubelet bind and container start is one trace).

Beyond propagation, spans are *recorded*: every ``span()`` exit emits a
:class:`SpanRecord` (wall start, duration, ok/error status with the
exception captured, span events) into the process
:class:`SpanCollector` — a bounded ring buffer with **tail-based keep
rules**: error traces and traces whose root span exceeds its latency
threshold are promoted out of the ring into a kept-trace store, pulling
their already-recorded child spans with them (the decision is made at
the *tail* of the trace, when the outcome is known). Split-process
components ship finished spans with :class:`RemoteSpanExporter` to an
apiserver's ``/debug/traces/ingest`` (the route comes with the port's
``machinery/zpages.py``; ROADMAP.md), so a trace assembled from
webhook→store→reconcile→scheduler→kubelet hops renders as one tree.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import re
import threading
import time
import uuid
from collections import OrderedDict, deque
from contextvars import ContextVar
from typing import Any, Callable, Iterator, Mapping, Optional

# stamped by the embedded store on CREATE (see machinery/store.py)
TRACE_ANNOTATION = "odh.kubeflow.org/trace-id"

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def new_trace_id() -> str:
    return uuid.uuid4().hex  # 32 hex chars


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass(frozen=True)
class SpanContext:
    trace_id: str
    span_id: str
    parent_span_id: str = ""
    name: str = ""
    # searchable log dimensions (controller, reconcile_key, ...)
    attrs: Mapping[str, str] = dataclasses.field(default_factory=dict)
    trace_flags: str = "01"
    # recording state: the dataclass binding is frozen, the CONTENTS
    # mutate while the span is open (events appended, status set) —
    # compare/hash never look at them
    events: list = dataclasses.field(
        default_factory=list, compare=False, repr=False
    )
    _mut: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    def traceparent(self) -> str:
        """W3C trace-context header value (version 00)."""
        return f"00-{self.trace_id}-{self.span_id}-{self.trace_flags}"


_current: ContextVar[Optional[SpanContext]] = ContextVar(
    "odh_current_span", default=None
)


def current() -> Optional[SpanContext]:
    return _current.get()


def traceparent() -> Optional[str]:
    span = _current.get()
    return span.traceparent() if span is not None else None


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Remote context from a ``traceparent`` header value (or None for
    absent/malformed — a bad header must never fail the request).
    Per W3C trace-context: version ``ff`` is forbidden, and all-zero
    trace/parent ids are invalid."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip())
    if not m:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff":
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(
        trace_id=trace_id, span_id=span_id, name="remote", trace_flags=flags
    )


# ---------------------------------------------------------------------------
# span recording


@dataclasses.dataclass
class SpanRecord:
    """One finished span — what the collector stores and the ingest
    endpoint ships. ``start`` is wall-clock epoch seconds (cross-process
    assembly orders by it), ``duration`` comes from a monotonic clock."""

    trace_id: str
    span_id: str
    parent_span_id: str
    name: str
    start: float
    duration: float
    status: str = "ok"  # "ok" | "error"
    error: str = ""
    attrs: dict = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)

    @property
    def end(self) -> float:
        return self.start + self.duration

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentSpanId": self.parent_span_id,
            "name": self.name,
            "start": self.start,
            "duration": self.duration,
            "status": self.status,
            "error": self.error,
            "attrs": dict(self.attrs),
            "events": [list(e) for e in self.events],
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SpanRecord":
        return cls(
            trace_id=str(d.get("traceId", "")),
            span_id=str(d.get("spanId", "")),
            parent_span_id=str(d.get("parentSpanId", "")),
            name=str(d.get("name", "")),
            start=float(d.get("start", 0.0)),
            duration=float(d.get("duration", 0.0)),
            status=str(d.get("status", "ok")),
            error=str(d.get("error", "")),
            attrs=dict(d.get("attrs") or {}),
            events=[list(e) for e in (d.get("events") or [])],
        )


class SpanCollector:
    """Bounded in-process span store with tail-based keep rules.

    Finished spans land in a ring buffer (``capacity`` newest spans).
    When a span finishes with an error, or a ROOT span (no parent)
    finishes over its latency threshold, its whole trace is promoted
    into the kept store — including child spans already sitting in the
    ring (that is what makes the sampling *tail-based*: the decision
    happens when the outcome is known, and the history is still
    around). The kept store holds the ``max_kept`` newest interesting
    traces; later spans of a kept trace append to it directly.

    Per-root-name latency thresholds (``set_threshold``) let the spawn
    path keep a tighter bar than, say, a bulk list endpoint."""

    def __init__(
        self,
        capacity: int = 4096,
        max_kept: int = 128,
        default_threshold_s: float = 1.0,
        max_spans_per_trace: int = 512,
    ):
        self.capacity = capacity
        self.max_kept = max_kept
        self.default_threshold_s = default_threshold_s
        # a kept trace is bounded too: a crash-looping reconcile keeps
        # retrying under ONE trace id (the retry is the same unit of
        # work) and would otherwise grow its kept entry forever
        self.max_spans_per_trace = max_spans_per_trace
        self.trace_spans_dropped_total = 0
        self._thresholds: dict[str, float] = {}
        self._ring: deque[SpanRecord] = deque(maxlen=capacity)
        self._kept: "OrderedDict[str, list[SpanRecord]]" = OrderedDict()
        self._kept_reason: dict[str, str] = {}
        self._lock = threading.Lock()
        self.recorded_total = 0

    def set_threshold(self, root_name: str, seconds: float) -> None:
        with self._lock:
            self._thresholds[root_name] = float(seconds)

    def threshold_for(self, name: str) -> float:
        return self._thresholds.get(name, self.default_threshold_s)

    def record(self, rec: SpanRecord) -> None:
        if not rec.trace_id:
            return
        with self._lock:
            self.recorded_total += 1
            kept = self._kept.get(rec.trace_id)
            if kept is not None:
                if len(kept) < self.max_spans_per_trace:
                    kept.append(rec)
                else:
                    self.trace_spans_dropped_total += 1
                return
            self._ring.append(rec)
            reason = None
            if rec.status == "error":
                reason = "error"
            elif (
                not rec.parent_span_id
                and rec.duration >= self.threshold_for(rec.name)
            ):
                reason = "slow"
            if reason is not None:
                self._promote(rec.trace_id, reason)

    def _promote(self, trace_id: str, reason: str) -> None:
        # pull every span of the trace still in the ring; they stay in
        # the ring too (it ages them out naturally) but reads prefer
        # the kept copy
        spans = [r for r in self._ring if r.trace_id == trace_id][
            : self.max_spans_per_trace
        ]
        while len(self._kept) >= self.max_kept:
            old, _ = self._kept.popitem(last=False)
            self._kept_reason.pop(old, None)
        self._kept[trace_id] = spans
        self._kept_reason[trace_id] = reason

    def trace(self, trace_id: str) -> list[SpanRecord]:
        """Every recorded span of a trace — kept store first, then the
        recent ring (a trace needn't be slow/error to be fetched by
        id; the spawn bench reads its own trace this way)."""
        with self._lock:
            kept = self._kept.get(trace_id)
            if kept is not None:
                return list(kept)
            return [r for r in self._ring if r.trace_id == trace_id]

    def keep_reason(self, trace_id: str) -> Optional[str]:
        with self._lock:
            return self._kept_reason.get(trace_id)

    def kept_traces(self, limit: int = 50) -> list[tuple[str, str, list[SpanRecord]]]:
        """Newest-first kept (slow/error) traces as
        ``(trace_id, reason, spans)``."""
        with self._lock:
            out = [
                (tid, self._kept_reason.get(tid, ""), list(spans))
                for tid, spans in reversed(self._kept.items())
            ]
        return out[:limit]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._kept.clear()
            self._kept_reason.clear()


_collector = SpanCollector()
_sinks: list[Callable[[SpanRecord], None]] = []


def collector() -> SpanCollector:
    return _collector


def set_collector(c: SpanCollector) -> SpanCollector:
    global _collector
    old, _collector = _collector, c
    return old


def add_sink(fn: Callable[[SpanRecord], None]) -> None:
    """Register an extra consumer of finished spans (the remote
    exporter). Sinks must never raise into the traced code path."""
    _sinks.append(fn)


def remove_sink(fn: Callable[[SpanRecord], None]) -> None:
    with contextlib.suppress(ValueError):
        _sinks.remove(fn)


def record_span(rec: SpanRecord) -> None:
    _collector.record(rec)
    for fn in list(_sinks):
        try:
            fn(rec)
        except Exception:  # noqa: BLE001 — telemetry must not break callers
            pass


def add_event(name: str, **attrs: str) -> None:
    """Attach a timestamped event to the current span (no-op outside
    any span)."""
    ctx = _current.get()
    if ctx is not None:
        ctx.events.append((time.time(), name, attrs))


def set_status(status: str, message: str = "") -> None:
    """Set the current span's status explicitly ('ok'/'error'). An
    exception escaping the span still wins (always 'error')."""
    ctx = _current.get()
    if ctx is not None:
        ctx._mut["status"] = status
        if message:
            ctx._mut["error"] = message


def discard() -> None:
    """Mark the current span as not worth recording (e.g. a retried
    gang-bind attempt that didn't land — only the landed one is the
    trace's bind)."""
    ctx = _current.get()
    if ctx is not None:
        ctx._mut["discard"] = True


@contextlib.contextmanager
def span(
    name: str,
    trace_id: Optional[str] = None,
    parent: Optional[SpanContext] = None,
    **attrs: str,
) -> Iterator[SpanContext]:
    """Enter a span: child of ``parent`` (explicit, or the contextvar's
    current span), or a fresh trace root. ``trace_id`` forces the trace
    (the annotation-carried cross-process hop); attrs merge over the
    parent's when staying in the same trace.

    On exit the span is *recorded*: wall start + monotonic duration,
    status (an escaping exception ⇒ 'error' with the exception
    captured), and any ``add_event`` events flow into the process
    collector and sinks."""
    if parent is None:
        parent = _current.get()
    if trace_id is not None and parent is not None and parent.trace_id != trace_id:
        parent = None  # forced onto a different trace: not a child
    tid = trace_id or (parent.trace_id if parent is not None else new_trace_id())
    merged: dict[str, str] = dict(parent.attrs) if parent is not None else {}
    merged.update(attrs)
    ctx = SpanContext(
        trace_id=tid,
        span_id=new_span_id(),
        parent_span_id=parent.span_id if parent is not None else "",
        name=name,
        attrs=merged,
    )
    token = _current.set(ctx)
    start_wall = time.time()
    t0 = time.perf_counter()
    status, error = "ok", ""
    try:
        yield ctx
    except BaseException as e:
        status, error = "error", f"{type(e).__name__}: {e}"
        raise
    finally:
        _current.reset(token)
        if not ctx._mut.get("discard"):
            if status != "error":
                status = ctx._mut.get("status", status)
                error = ctx._mut.get("error", error)
            record_span(
                SpanRecord(
                    trace_id=ctx.trace_id,
                    span_id=ctx.span_id,
                    parent_span_id=ctx.parent_span_id,
                    name=name,
                    start=start_wall,
                    duration=time.perf_counter() - t0,
                    status=status,
                    error=error,
                    attrs=dict(attrs),
                    events=[
                        (ts, ename, dict(eattrs))
                        for ts, ename, eattrs in ctx.events
                    ],
                )
            )


def child_span(name: str, **attrs: str):
    """A span only when a trace is already active — hot paths (store
    mutations) use this so untraced operations pay one contextvar read
    and nothing else."""
    if _current.get() is None:
        return contextlib.nullcontext(None)
    return span(name, **attrs)


def nested_parent(remote: Optional[SpanContext]) -> Optional[SpanContext]:
    """The parent a request span should use for an inbound remote
    context: when an in-process wrapper (the event-loop dispatch span)
    already continued the SAME trace, nest under it instead of forking
    a sibling off the remote parent. One home for the rule, shared by
    every server front end (microweb, httpapi)."""
    cur = _current.get()
    if (
        cur is not None
        and remote is not None
        and cur.trace_id == remote.trace_id
    ):
        return cur
    return remote


@contextlib.contextmanager
def use_span(ctx: Optional[SpanContext]) -> Iterator[Optional[SpanContext]]:
    """Install an existing (e.g. header-parsed) context as current; a
    None ctx is a no-op so callers needn't branch. Installation only —
    nothing is recorded on exit (the remote end records its own)."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def traced(fn=None, *, name: Optional[str] = None):
    """Decorator: run the function inside a span named after it."""

    def deco(f):
        import functools

        span_name = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args: Any, **kwargs: Any):
            with span(span_name):
                return f(*args, **kwargs)

        return wrapper

    return deco(fn) if fn is not None else deco


def trace_id_of(obj: Mapping[str, Any]) -> Optional[str]:
    """The trace annotation stamped on a stored object, if any."""
    meta = obj.get("metadata") or {}
    ann = meta.get("annotations") or {}
    tid = ann.get(TRACE_ANNOTATION)
    return tid if isinstance(tid, str) and tid else None


# ---------------------------------------------------------------------------
# trace assembly + rendering (the /debug/traces zpage and the spawn
# bench's breakdown both consume these)


def assemble(spans: list[SpanRecord]) -> Optional[dict]:
    """One tree from a trace's flat spans: ``{"span": SpanRecord,
    "children": [...]}``. Cross-process traces routinely contain spans
    whose parent was recorded in another process (or is the caller's
    unrecorded client span) — every such orphan attaches under the
    PRIMARY root (the earliest-starting orphan), so the trace renders
    as one tree, not a forest.

    Defensive against malformed input (the ingest endpoint accepts
    spans from anywhere): self-parented spans, parent cycles, and
    duplicate ids can never crash assembly or drop spans — cycle
    members break at their first revisit and re-attach under the
    root, and a trace with no orphan at all (pure cycle) roots at the
    earliest span."""
    if not spans:
        return None
    by_id = {s.span_id: s for s in spans}
    children: dict[str, list[SpanRecord]] = {}
    orphans: list[SpanRecord] = []
    for s in spans:
        if (
            s.parent_span_id
            and s.parent_span_id in by_id
            and s.parent_span_id != s.span_id
        ):
            children.setdefault(s.parent_span_id, []).append(s)
        else:
            orphans.append(s)
    orphans.sort(key=lambda s: s.start)
    root = orphans[0] if orphans else min(spans, key=lambda s: s.start)
    for s in orphans[1:]:
        children.setdefault(root.span_id, []).append(s)

    visited: set[int] = set()  # by object identity: ids may collide

    def node(s: SpanRecord) -> dict:
        visited.add(id(s))
        kids = []
        for c in sorted(children.get(s.span_id, []), key=lambda c: c.start):
            if id(c) in visited:
                continue  # cycle edge: already placed elsewhere
            kids.append(node(c))
        return {"span": s, "children": kids}

    tree = node(root)
    # cycle islands unreachable from the root attach under it, so the
    # tree always covers every span exactly once
    for s in sorted(spans, key=lambda s: s.start):
        if id(s) not in visited:
            tree["children"].append(node(s))
    return tree


def render_trace(spans: list[SpanRecord], reason: str = "") -> str:
    """Indented text tree with durations — the zpage's human view."""
    tree = assemble(spans)
    if tree is None:
        return "(no spans)\n"
    root: SpanRecord = tree["span"]
    total = max((s.end for s in spans), default=root.end) - root.start
    lines = [
        f"trace {root.trace_id}  spans={len(spans)}  "
        f"span_total={total * 1000:.1f}ms"
        + (f"  keep={reason}" if reason else "")
    ]

    def walk(node: dict, depth: int) -> None:
        s: SpanRecord = node["span"]
        mark = "  !ERROR" if s.status == "error" else ""
        attrs = "".join(
            f" {k}={v}" for k, v in sorted(s.attrs.items())
        )
        lines.append(
            f"{'  ' * (depth + 1)}{s.name}  {s.duration * 1000:.2f}ms"
            f"  +{(s.start - root.start) * 1000:.1f}ms{attrs}{mark}"
            + (f"  ({s.error})" if s.error else "")
        )
        for ev in s.events:
            ts, ename = ev[0], ev[1]
            lines.append(
                f"{'  ' * (depth + 2)}@ +{(ts - root.start) * 1000:.1f}ms "
                f"{ename}"
            )
        for child in node["children"]:
            walk(child, depth + 1)

    walk(tree, 0)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# cross-process span shipping


class RemoteSpanExporter:
    """Ships finished spans to an apiserver's ``/debug/traces/ingest``
    in background batches, so split-process components' spans assemble
    into one tree on the apiserver's zpage. Best-effort by design: a
    down endpoint drops batches (counted) — telemetry must never
    backpressure the traced work. ``ssl_context`` verifies an HTTPS
    apiserver (its CA bundle)."""

    def __init__(
        self,
        base_url: str,
        flush_interval: float = 1.0,
        max_batch: int = 512,
        max_buffer: int = 8192,
        ssl_context: Optional[Any] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.ssl_context = ssl_context
        self.flush_interval = flush_interval
        self.max_batch = max_batch
        self.max_buffer = max_buffer
        self.dropped_total = 0
        self.shipped_total = 0
        self._buf: list[SpanRecord] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __call__(self, rec: SpanRecord) -> None:  # the sink interface
        with self._lock:
            if len(self._buf) >= self.max_buffer:
                self.dropped_total += 1
                return
            self._buf.append(rec)

    def install(self) -> "RemoteSpanExporter":
        add_sink(self)
        self._thread = threading.Thread(
            target=self._loop, name="span-exporter", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.flush_interval):
            self.flush()

    def flush(self) -> None:
        while True:
            with self._lock:
                batch, self._buf = (
                    self._buf[: self.max_batch],
                    self._buf[self.max_batch :],
                )
            if not batch:
                return
            try:
                self._post(batch)
                self.shipped_total += len(batch)
            except Exception:  # noqa: BLE001 — drop, never raise
                self.dropped_total += len(batch)
            if len(batch) < self.max_batch:
                return

    def _post(self, batch: list[SpanRecord]) -> None:
        import urllib.request

        body = json.dumps(
            {"spans": [r.to_dict() for r in batch]}
        ).encode()
        req = urllib.request.Request(
            self.base_url + "/debug/traces/ingest",
            data=body,
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=5, context=self.ssl_context) as resp:
            resp.read()

    def close(self) -> None:
        remove_sink(self)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.flush()


# ---------------------------------------------------------------------------
# structured logging


class JsonLogFormatter(logging.Formatter):
    """One JSON object per record, trace-correlated: ``trace_id``/
    ``span_id``/``span``/``trace_flags`` plus span attrs
    (``controller``, ``reconcile_key``) come from the contextvar at
    emit time — handlers format synchronously on the emitting thread,
    so the context is the record's. A span status set via
    :func:`set_status` is stamped as ``span.status``."""

    def format(self, record: logging.LogRecord) -> str:
        out: dict[str, Any] = {
            "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            )
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        ctx = _current.get()
        if ctx is not None:
            out["trace_id"] = ctx.trace_id
            out["span_id"] = ctx.span_id
            out["trace_flags"] = ctx.trace_flags
            if ctx.name:
                out["span"] = ctx.name
            if ctx._mut.get("status"):
                out["span.status"] = ctx._mut["status"]
            out.update(ctx.attrs)
        if record.exc_info and record.exc_info[0] is not None:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def configure_json_logging(level: int = logging.INFO) -> logging.Handler:
    """Install a JSON-formatted stderr handler on the root logger (the
    split-process entrypoints' default posture). Idempotent: repeat
    calls return the already-installed handler instead of stacking
    duplicates (every log line would otherwise print once per call)."""
    root = logging.getLogger()
    for h in root.handlers:
        if getattr(h, "_odh_json_handler", False):
            root.setLevel(level)
            return h
    handler = logging.StreamHandler()
    handler.setFormatter(JsonLogFormatter())
    handler._odh_json_handler = True  # type: ignore[attr-defined]
    root.addHandler(handler)
    root.setLevel(level)
    return handler
