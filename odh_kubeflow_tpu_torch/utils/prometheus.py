"""Prometheus histograms for the trainer (the port's own copy of the part
of the JAX package's ``utils/prometheus.py`` that ``Trainer`` needs).

``Registry`` gets-or-creates metric families by name and renders the
Prometheus text exposition; ``Histogram`` keeps cumulative ``le``
buckets ending in ``+Inf`` plus ``_sum``/``_count``. Exemplars (trace
ids) and the other metric kinds stay with the JAX package's platform
side.
"""

from __future__ import annotations

import bisect
import threading
from typing import Iterable, Optional, Sequence

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

    @staticmethod
    def _key(labels: Optional[dict[str, str]]) -> tuple:
        return tuple(sorted((labels or {}).items()))

    def observe(self, value: float, labels: Optional[dict[str, str]] = None) -> None:
        value = float(value)
        with self._lock:
            st = self._series.setdefault(
                self._key(labels), [[0] * (len(self.buckets) + 1), 0.0, 0]
            )
            st[0][bisect.bisect_left(self.buckets, value)] += 1
            st[1] += value
            st[2] += 1

    def value(self, labels: Optional[dict[str, str]] = None) -> float:
        """Observation count."""
        with self._lock:
            st = self._series.get(self._key(labels))
            return float(st[2]) if st is not None else 0.0

    def sum(self, labels: Optional[dict[str, str]] = None) -> float:
        with self._lock:
            st = self._series.get(self._key(labels))
            return float(st[1]) if st is not None else 0.0

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
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


class Registry:
    def __init__(self):
        self._by_name: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def register(self, metric: Histogram) -> Histogram:
        """Get-or-create by name; a second registration with other
        buckets or labels raises instead of silently mis-bucketing."""
        with self._lock:
            existing = self._by_name.get(metric.name)
            if existing is None:
                self._by_name[metric.name] = metric
                return metric
            if (existing.buckets, existing.labelnames) != (metric.buckets, metric.labelnames):
                raise ValueError(
                    f"histogram {metric.name!r} already registered with buckets "
                    f"{existing.buckets} and labels {existing.labelnames}"
                )
            return existing

    def histogram(
        self,
        name: str,
        help_: str,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        labelnames: Sequence[str] = (),
    ) -> Histogram:
        return self.register(Histogram(name, help_, buckets, labelnames))

    def metric(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._by_name.get(name)

    def metrics(self) -> list[Histogram]:
        with self._lock:
            return list(self._by_name.values())

    def exposition(self) -> str:
        lines: list[str] = []
        for m in self.metrics():
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


default_registry = Registry()
