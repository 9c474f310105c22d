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
Exemplars (trace ids), OpenMetrics and the
``/metrics`` server stay with the JAX package's platform side.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Iterable, Optional, Sequence, Union

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

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {_escape_help(self.help)}"
        yield f"# TYPE {self.name} {self.type}"
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


class Histogram:
    """Cumulative-bucket histogram, one series per label set."""

    type = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        labelnames: Sequence[str] = (),
    ):
        if not buckets:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per label key: [per-bucket non-cumulative counts (+Inf last), sum, count]
        self._series: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Optional[dict[str, str]] = None) -> None:
        value = float(value)
        with self._lock:
            st = self._series.setdefault(
                _key(labels), [[0] * (len(self.buckets) + 1), 0.0, 0]
            )
            st[0][bisect.bisect_left(self.buckets, value)] += 1
            st[1] += value
            st[2] += 1

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

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {_escape_help(self.help)}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            series = sorted((k, [list(st[0]), st[1], st[2]]) for k, st in self._series.items())
        if not series and not self.labelnames:
            series = [((), [[0] * (len(self.buckets) + 1), 0.0, 0])]
        for key, (counts, total, count) in series:
            labels = dict(key)
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                le = str(int(b)) if b.is_integer() else repr(b)
                yield f"{self.name}_bucket{_fmt_labels({**labels, 'le': le})} {cum}"
            yield f"{self.name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} {count}"
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
    ) -> Histogram:
        return self.register(Histogram(name, help_, buckets, labelnames))

    def metric(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._by_name.get(name)

    def metrics(self) -> list[Metric]:
        with self._lock:
            return list(self._by_name.values())

    def exposition(self) -> str:
        with self._lock:
            fns = list(self._collect_fns)
        lines: list[str] = []
        for m in self.metrics():
            lines.extend(m.collect())
        for fn in fns:
            lines.extend(fn())
        return "\n".join(lines) + "\n"


default_registry = Registry()
