"""Prometheus metrics for the trainer, the serving engine and the
controllers (the port's own copy of the part of the JAX package's
``utils/prometheus.py`` that ``Trainer``, ``DecodeEngine`` and the
controller runtime need).

``Registry`` gets-or-creates metric families by name and renders the
Prometheus text exposition; ``Counter`` and ``Gauge`` keep one value per
label set (an unlabelled one exposes 0 from registration); ``Histogram``
keeps cumulative ``le`` buckets ending in ``+Inf`` plus
``_sum``/``_count``. ``metric.labels(name=...)`` binds one label set;
``Registry.register_collector`` adds lines rendered at scrape time.

Two exposition dialects from one registry: plain Prometheus text
(``version=0.0.4``, byte-stable with the output before exemplars) and
OpenMetrics (``exposition(openmetrics=True)``, negotiated from the
``Accept`` header by ``negotiate_openmetrics``): counter families drop
``_total`` from HELP/TYPE, the stream ends in ``# EOF``, and histogram
buckets carry **exemplars**, the trace id (``utils/tracing.py``) active
when a value landed in the bucket, so a bad latency bucket leads to the
request that caused it. ``count_le`` / ``count_matching`` /
``sum_matching`` are the reads of the SLO engine (``utils/slo.py``);
``lint_metric_names`` holds a live registry to the naming conventions
and ``parse_openmetrics`` reads an exposition back. ``serve_metrics``
serves a registry's ``/metrics`` on a daemon thread (each split-process
controller's, from ``machinery/runner.py``).
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Any, Callable, Iterable, Optional, Sequence, Union

OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"
PLAIN_CONTENT_TYPE = "text/plain; version=0.0.4"


def negotiate_openmetrics(accept: Optional[str]) -> bool:
    """Whether an ``Accept`` header asks for OpenMetrics (the
    content-negotiation Prometheus itself performs when scraping)."""
    return bool(accept) and "application/openmetrics-text" in accept

# client_golang's DefBuckets: latency-shaped, seconds
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape_label_value(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _key(labels: Optional[dict[str, str]]) -> tuple:
    return tuple(sorted((labels or {}).items()))


class _Child:
    """A metric bound to one label set — ``metric.labels(name="x")``
    returns one, so hot paths resolve their label dict once."""

    __slots__ = ("_metric", "_labels")

    def __init__(self, metric: "Metric", labels: dict[str, str]):
        self._metric = metric
        self._labels = labels

    def inc(self, by: float = 1.0) -> None:
        self._metric.inc(self._labels, by)

    def set(self, value: float) -> None:
        self._metric.set(value, self._labels)

    def observe(self, value: float) -> None:
        self._metric.observe(value, self._labels)

    def value(self) -> float:
        return self._metric.value(self._labels)


class _Value:
    """A counter or gauge family: one float per label set."""

    type = ""

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, labels: Optional[dict[str, str]] = None, by: float = 1.0) -> None:
        with self._lock:
            key = _key(labels)
            self._values[key] = self._values.get(key, 0.0) + by

    def value(self, labels: Optional[dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_key(labels), 0.0)

    def labels(self, **labels: str) -> _Child:
        return _Child(self, labels)

    def samples(self) -> list[tuple[dict[str, str], float]]:
        """Every (labels, value) series."""
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._values.items())]

    def sum_matching(self, match: Optional[dict[str, str]] = None) -> float:
        """Sum of the series whose labels are a superset of ``match``
        (an empty match: the whole family) — how the SLO engine adds up
        its total and bad counts."""
        want = (match or {}).items()
        with self._lock:
            return sum(v for k, v in self._values.items() if all(i in k for i in want))

    def collect(self, openmetrics: bool = False) -> Iterable[str]:
        # OpenMetrics names a counter FAMILY without its _total suffix;
        # the sample line keeps it
        fam = self.name
        if openmetrics and self.type == "counter" and fam.endswith("_total"):
            fam = fam[: -len("_total")]
        yield f"# HELP {fam} {_escape_help(self.help)}"
        yield f"# TYPE {fam} {self.type}"
        with self._lock:
            if not self._values and not self.labelnames:
                # unlabelled: the zero value shows from registration; a
                # labelled family starts empty (no phantom series)
                yield f"{self.name} 0"
            for key, value in sorted(self._values.items()):
                yield f"{self.name}{_fmt_labels(dict(key))} {_fmt_value(value)}"


class Counter(_Value):
    type = "counter"


class Gauge(_Value):
    type = "gauge"

    def set(self, value: float, labels: Optional[dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_key(labels)] = value


def _fmt_le(b: float) -> str:
    return str(int(b)) if float(b).is_integer() else repr(float(b))


def _current_trace_id() -> Optional[str]:
    """The active trace id: the exemplar of an observation made inside a
    traced request."""
    from odh_kubeflow_tpu_torch.utils import tracing

    ctx = tracing.current()
    return ctx.trace_id if ctx is not None else None


class Histogram:
    """Cumulative-bucket histogram, one series per label set.

    With ``exemplars`` on (the default), an observation made inside an
    active trace records ``(trace_id, value, timestamp)`` on the bucket
    it landed in (the last one wins, client_golang's policy); only the
    OpenMetrics exposition shows them."""

    type = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        labelnames: Sequence[str] = (),
        exemplars: bool = True,
    ):
        if not buckets:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.exemplars = exemplars
        # per label key: [per-bucket non-cumulative counts (+Inf last), sum,
        # count, per-bucket exemplar (trace_id, value, ts) or None]
        self._series: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Optional[dict[str, str]] = None) -> None:
        value = float(value)
        tid = _current_trace_id() if self.exemplars else None
        with self._lock:
            n = len(self.buckets) + 1
            st = self._series.setdefault(_key(labels), [[0] * n, 0.0, 0, [None] * n])
            idx = bisect.bisect_left(self.buckets, value)
            st[0][idx] += 1
            st[1] += value
            st[2] += 1
            if tid is not None:
                st[3][idx] = (tid, value, time.time())

    def labels(self, **labels: str) -> _Child:
        return _Child(self, labels)

    def value(self, labels: Optional[dict[str, str]] = None) -> float:
        """Observation count."""
        with self._lock:
            st = self._series.get(_key(labels))
            return float(st[2]) if st is not None else 0.0

    def sum(self, labels: Optional[dict[str, str]] = None) -> float:
        with self._lock:
            st = self._series.get(_key(labels))
            return float(st[1]) if st is not None else 0.0

    def samples(self) -> list[tuple[dict[str, str], float]]:
        """(labels, observation count) per series."""
        with self._lock:
            return [(dict(k), float(st[2])) for k, st in sorted(self._series.items())]

    def count_matching(self, match: Optional[dict[str, str]] = None) -> float:
        """Observations across the series whose labels ⊇ ``match``."""
        want = (match or {}).items()
        with self._lock:
            return float(sum(st[2] for k, st in self._series.items()
                             if all(i in k for i in want)))

    def count_le(self, le: float, match: Optional[dict[str, str]] = None) -> float:
        """Observations ≤ the largest bucket boundary not above ``le``,
        over the series whose labels ⊇ ``match``: a latency SLI's good
        events. ``le`` should be a bucket boundary; a value between two
        counts the bucket below."""
        nbuckets = bisect.bisect_right(self.buckets, float(le))
        want = (match or {}).items()
        with self._lock:
            return float(sum(sum(st[0][:nbuckets]) for k, st in self._series.items()
                             if all(i in k for i in want)))

    @staticmethod
    def _fmt_exemplar(ex) -> str:
        tid, value, ts = ex
        return f' # {{trace_id="{_escape_label_value(tid)}"}} {_fmt_value(value)} {ts:.3f}'

    def collect(self, openmetrics: bool = False) -> Iterable[str]:
        yield f"# HELP {self.name} {_escape_help(self.help)}"
        yield f"# TYPE {self.name} histogram"
        n = len(self.buckets) + 1
        with self._lock:
            series = sorted((k, [list(st[0]), st[1], st[2], list(st[3])])
                            for k, st in self._series.items())
        if not series and not self.labelnames:
            series = [((), [[0] * n, 0.0, 0, [None] * n])]
        for key, (counts, total, count, exs) in series:
            labels = dict(key)
            cum = 0
            for i, le in enumerate([*map(_fmt_le, self.buckets), "+Inf"]):
                cum += counts[i]
                line = f"{self.name}_bucket{_fmt_labels({**labels, 'le': le})} {cum}"
                if openmetrics and exs[i] is not None:
                    line += self._fmt_exemplar(exs[i])
                yield line
            yield f"{self.name}_sum{_fmt_labels(labels)} {_fmt_value(total)}"
            yield f"{self.name}_count{_fmt_labels(labels)} {count}"


Metric = Union[Counter, Gauge, Histogram]


class Registry:
    def __init__(self):
        self._by_name: dict[str, Metric] = {}
        self._collect_fns: list[Callable[[], Iterable[str]]] = []
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> Metric:
        """Get-or-create by name; a second registration of another kind,
        with other labels or other buckets raises instead of silently
        mis-recording."""
        with self._lock:
            existing = self._by_name.get(metric.name)
            if existing is None:
                self._by_name[metric.name] = metric
                return metric
            if (existing.type, existing.labelnames, getattr(existing, "buckets", None)) != (
                metric.type, metric.labelnames, getattr(metric, "buckets", None)
            ):
                raise ValueError(
                    f"metric {metric.name!r} already registered as {existing.type} with "
                    f"labels {existing.labelnames}"
                    + (f" and buckets {existing.buckets}" if existing.type == "histogram" else "")
                )
            return existing

    def register_collector(self, fn: Callable[[], Iterable[str]]) -> None:
        """A custom collector producing exposition lines at scrape time
        (the notebook controller's live running-notebook gauge)."""
        with self._lock:
            self._collect_fns.append(fn)

    def counter(self, name: str, help_: str, labelnames: Sequence[str] = ()) -> Counter:
        return self.register(Counter(name, help_, labelnames))

    def gauge(self, name: str, help_: str, labelnames: Sequence[str] = ()) -> Gauge:
        return self.register(Gauge(name, help_, labelnames))

    def histogram(
        self,
        name: str,
        help_: str,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        labelnames: Sequence[str] = (),
        exemplars: bool = True,
    ) -> Histogram:
        return self.register(Histogram(name, help_, buckets, labelnames, exemplars=exemplars))

    def metric(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._by_name.get(name)

    def metrics(self) -> list[Metric]:
        with self._lock:
            return list(self._by_name.values())

    def exposition(self, openmetrics: bool = False) -> str:
        with self._lock:
            fns = list(self._collect_fns)
        # collectors run FIRST (their lines still render last): some
        # flush batched hot-path counts into registered families (the
        # store's evictions, the informer cache's hits and misses), which
        # must land before those families render
        collector_lines: list[str] = []
        for fn in fns:
            collector_lines.extend(fn())
        lines: list[str] = []
        for m in self.metrics():
            lines.extend(m.collect(openmetrics=openmetrics))
        lines.extend(collector_lines)
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


default_registry = Registry()


# ---------------------------------------------------------------------------
# naming lint

# histogram names end in their unit: _seconds for latencies,
# _bytes/_records/_size for size-shaped distributions
HISTOGRAM_UNIT_SUFFIXES = ("_seconds", "_bytes", "_records", "_size")
_NAME_RE = re.compile(r"[a-z_][a-z0-9_]*")


def metric_name_violations(name: str, typ: str, labelnames: Sequence[str] = ()) -> list[str]:
    """Prometheus naming conventions for one metric family: names and
    labels ``[a-z_][a-z0-9_]*``; counters end in ``_total`` and nothing
    else does; histograms end in a unit suffix."""
    violations = []
    if not _NAME_RE.fullmatch(name):
        violations.append(f"{name}: must match [a-z_][a-z0-9_]* (lowercase only)")
    if typ == "counter" and not name.endswith("_total"):
        violations.append(f"{name}: counter names must end in _total")
    if typ != "counter" and name.endswith("_total"):
        violations.append(f"{name}: _total suffix is reserved for counters")
    if typ == "histogram" and not name.endswith(HISTOGRAM_UNIT_SUFFIXES):
        violations.append(f"{name}: histograms must end in a unit suffix "
                          f"{'/'.join(HISTOGRAM_UNIT_SUFFIXES)}")
    for ln in labelnames:
        if not _NAME_RE.fullmatch(ln):
            violations.append(f"{name}: label {ln!r} must be lowercase")
    return violations


def lint_metric_names(registry: Registry) -> list[str]:
    """The naming conventions over what a live registry holds (empty:
    clean)."""
    return [v for m in registry.metrics()
            for v in metric_name_violations(m.name, m.type, m.labelnames)]


# ---------------------------------------------------------------------------
# OpenMetrics parsing: an exposition read back, so the emitter cannot
# drift from the format

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^ #]+)"
    r"(?:\s+(?P<ts>[0-9.e+-]+))?"
    r"(?:\s*#\s*\{(?P<exlabels>[^}]*)\}\s+(?P<exvalue>\S+)(?:\s+(?P<exts>\S+))?)?"
    r"\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_labels(raw: Optional[str]) -> dict[str, str]:
    if not raw:
        return {}
    return {k: v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
            for k, v in _LABEL_RE.findall(raw)}


def parse_openmetrics(text: str) -> dict[str, dict[str, Any]]:
    """An OpenMetrics exposition as ``{family: {"type", "help",
    "samples": [(sample_name, labels, value, exemplar or None)]}}``, an
    exemplar ``(labels, value, timestamp or None)``. Raises
    ``ValueError`` on a broken contract: no ``# EOF`` at the end, a
    sample before its HELP/TYPE, content after ``# EOF``."""
    families: dict[str, dict[str, Any]] = {}
    saw_eof = False
    for line in text.splitlines():
        if not line.strip():
            continue
        if saw_eof:
            raise ValueError(f"content after # EOF: {line!r}")
        if line == "# EOF":
            saw_eof = True
            continue
        parts = line.split(" ", 3)
        if line.startswith("# HELP "):
            families.setdefault(parts[2], {"help": None, "type": None, "samples": []})[
                "help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            if len(parts) < 4:
                raise ValueError(f"malformed TYPE line: {line!r}")
            families.setdefault(parts[2], {"help": None, "type": None, "samples": []})[
                "type"] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable sample line: {line!r}")
        sample = base = m.group("name")
        # a counter's sample carries _total, a histogram's _bucket/_sum/_count
        for suffix in ("_bucket", "_sum", "_count", "_total"):
            if base.endswith(suffix) and base[: -len(suffix)] in families:
                base = base[: -len(suffix)]
                break
        if base not in families:
            raise ValueError(f"sample {sample!r} before its HELP/TYPE: {line!r}")
        if families[base]["type"] is None:
            raise ValueError(f"sample {sample!r} with no TYPE")
        exemplar = None
        if m.group("exlabels") is not None:
            exemplar = (_parse_labels(m.group("exlabels")), float(m.group("exvalue")),
                        float(m.group("exts")) if m.group("exts") else None)
        families[base]["samples"].append(
            (sample, _parse_labels(m.group("labels")), float(m.group("value")), exemplar))
    if not saw_eof:
        raise ValueError("OpenMetrics exposition must end with # EOF")
    return families


# ---------------------------------------------------------------------------
# serving


def metrics_app(registry: Registry):
    """WSGI app exposing ``registry`` at ``/metrics`` (and ``/``, the
    scrape-anything posture controller-runtime's metrics listener has).
    Content-negotiated: an ``Accept`` asking for
    ``application/openmetrics-text`` gets the exemplar-bearing
    OpenMetrics dialect; everything else gets byte-stable plain text."""

    def app(environ, start_response):
        if environ.get("PATH_INFO", "/") not in ("/", "/metrics"):
            start_response("404 Not Found", [("Content-Type", "text/plain")])
            return [b"not found"]
        om = negotiate_openmetrics(environ.get("HTTP_ACCEPT"))
        payload = registry.exposition(openmetrics=om).encode()
        start_response(
            "200 OK",
            [
                ("Content-Type", OPENMETRICS_CONTENT_TYPE if om else PLAIN_CONTENT_TYPE),
                ("Content-Length", str(len(payload))),
            ],
        )
        return [payload]

    return app


def serve_metrics(registry: Registry, host: str = "0.0.0.0", port: int = 8080):
    """Serve ``/metrics`` on a daemon thread (the controller-runtime
    metrics-bind-address equivalent for split-process components).
    Returns (thread, bound_port, httpd)."""
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    class _Quiet(WSGIRequestHandler):
        def log_message(self, *args):  # noqa: D102 — stdlib signature
            pass

    httpd = make_server(host, port, metrics_app(registry), handler_class=_Quiet)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return t, httpd.server_address[1], httpd
