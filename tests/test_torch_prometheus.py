"""The port's metrics (``utils/prometheus.py``) against the JAX
package's: the same calls render the same Prometheus text exposition."""

import pytest

from odh_kubeflow_tpu.utils import prometheus as jax_prometheus
from odh_kubeflow_tpu_torch.utils import prometheus


def _drive(mod):
    reg = mod.Registry()
    c = reg.counter("requests_total", "Requests served")
    c.inc()
    c.inc(by=2)
    lc = reg.counter("errors_total", 'Errors by "kind"\nsecond line', labelnames=("kind",))
    lc.inc({"kind": 'bad "quote"'})
    g = reg.gauge("serving_queue_depth", "Requests waiting for a decode slot")
    g.set(3)
    g.inc(by=-1.5)
    reg.gauge("serving_batch_occupancy", "Fraction of slots active")  # never set: 0
    h = reg.histogram("serving_ttft_seconds", "TTFT", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0):
        h.observe(v)
    # get-or-create: the same family again is the live one
    assert reg.counter("requests_total", "Requests served") is c
    return reg, c, g


def test_counter_and_gauge_render_like_jax():
    jreg, jc, jg = _drive(jax_prometheus)
    treg, tc, tg = _drive(prometheus)
    assert treg.exposition() == jreg.exposition()
    assert (tc.value(), tg.value()) == (jc.value(), jg.value()) == (3.0, 1.5)


def test_a_second_kind_under_one_name_raises():
    reg = prometheus.Registry()
    reg.counter("x_total", "x")
    with pytest.raises(ValueError):
        reg.gauge("x_total", "x")
    with pytest.raises(ValueError):
        reg.counter("x_total", "x", labelnames=("a",))
