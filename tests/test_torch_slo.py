"""The port's SLO engine (``utils/slo.py``) against the JAX package's, on
the CPU.

The same sample streams — latency histograms and counter pairs fed in
the same order under one injected clock — go through JAX's and the
port's ``SLOEngine``; every burn-rate row (windows, deltas, ratios,
thresholds, alerting) and every ``slo_burn_rate`` gauge must be equal.
The port's default specs must resolve against the port's registries
(each histogram registered with exemplars, each threshold a bucket
boundary); the usage ledger's GPU-seconds counter, which
``machinery/usage.py`` will register, evaluates to zero until then.
"""

from __future__ import annotations

import importlib

import pytest

PACKAGES = ("odh_kubeflow_tpu", "odh_kubeflow_tpu_torch")
WINDOWS = {"5m": 300.0, "1h": 3600.0}


def mods(port: bool):
    pkg = PACKAGES[port]
    return (importlib.import_module(f"{pkg}.utils.prometheus"),
            importlib.import_module(f"{pkg}.utils.slo"))


def latency_stream(prom, slo, clock):
    reg = prom.Registry()
    h = reg.histogram("web_seconds", "latency", buckets=(0.25, 1.0, 5.0),
                      labelnames=("app",))
    specs = [slo.SLO(name="web-p99", description="d", objective=0.99,
                     histogram="web_seconds", threshold_s=0.25),
             slo.SLO(name="jwa-p95", description="d", objective=0.95,
                     histogram="web_seconds", threshold_s=1.0, labels={"app": "jwa"})]
    eng = slo.SLOEngine(reg, specs, windows=WINDOWS, time_fn=lambda: clock["t"])
    return reg, eng, lambda v, app: h.observe(v, {"app": app})


def ratio_stream(prom, slo, clock):
    reg = prom.Registry()
    total = reg.counter("controller_runtime_reconcile_total", "r",
                        labelnames=("controller", "result"))
    errors = reg.counter("controller_runtime_reconcile_errors_total", "e",
                         labelnames=("controller",))
    specs = [slo.SLO(name="reconcile-errors", description="d", objective=0.999,
                     total_metric="controller_runtime_reconcile_total",
                     bad_metric="controller_runtime_reconcile_errors_total"),
             slo.SLO(name="nb-errors", description="d", objective=0.99,
                     total_metric="controller_runtime_reconcile_total",
                     total_labels={"controller": "notebook"},
                     bad_metric="controller_runtime_reconcile_errors_total",
                     bad_labels={"controller": "notebook"})]
    eng = slo.SLOEngine(reg, specs, windows=WINDOWS, time_fn=lambda: clock["t"])

    def feed(ok: bool, controller: str):
        total.inc({"controller": controller, "result": "success" if ok else "error"})
        if not ok:
            errors.inc({"controller": controller})

    return reg, eng, feed


def run(port: bool, stream, script) -> list:
    """Feed ``script`` — (seconds to advance, [(value, label), ...]) per
    sample — through one engine; the rows after every tick and the
    final gauges."""
    prom, slo = mods(port)
    clock = {"t": 100_000.0}
    reg, eng, feed = stream(prom, slo, clock)
    out = []
    eng.tick()
    for advance, events in script:
        clock["t"] += advance
        for value, label in events:
            feed(value, label)
        eng.tick()
        out.append(eng.evaluate())
    out.append(sorted(eng.m_burn.samples(), key=lambda s: sorted(s[0].items())))
    return out


def latency_script(seed: int):
    import random

    rng = random.Random(seed)
    script = [(300.0, [(rng.choice((0.01, 0.1)), rng.choice(("jwa", "vwa")))
                       for _ in range(100)]) for _ in range(12)]  # a clean hour
    bad = [(rng.choice((0.5, 2.0, 9.0)), rng.choice(("jwa", "vwa"))) for _ in range(40)]
    script.append((300.0, bad + [(0.01, "jwa")] * 60))  # a regression
    script += [(60.0 * (i + 1), [(rng.choice((0.01, 3.0)), "jwa") for _ in range(20)])
               for i in range(6)]  # uneven sampling
    return script


def ratio_script(seed: int):
    import random

    rng = random.Random(seed)
    return [(rng.choice((30.0, 300.0, 900.0)),
             [(rng.random() > p, rng.choice(("notebook", "profile"))) for _ in range(50)])
            for p in (0.0, 0.01, 0.2, 0.02, 0.5, 0.0, 0.001, 0.1)]


@pytest.mark.parametrize("seed", [0, 1])
def test_latency_burn_rates_equal_jax(seed):
    script = latency_script(seed)
    got = run(True, latency_stream, script)
    assert got == run(False, latency_stream, script)
    fast = [r for r in got[12] if r["slo"] == "web-p99" and r["window"] == "5m"][0]
    assert fast["alerting"] and fast["total"] == 100 and fast["bad"] >= 40


@pytest.mark.parametrize("seed", [0, 1])
def test_ratio_burn_rates_equal_jax(seed):
    script = ratio_script(seed)
    got = run(True, ratio_stream, script)
    assert got == run(False, ratio_stream, script)
    assert {r["slo"] for r in got[0]} == {"reconcile-errors", "nb-errors"}


def test_spec_validation_and_thresholds_equal_jax():
    for port in (False, True):
        _, slo = mods(port)
        with pytest.raises(ValueError):
            slo.SLO(name="x", description="", objective=1.5, histogram="h")
        with pytest.raises(ValueError):
            slo.SLO(name="x", description="", objective=0.99)
        with pytest.raises(ValueError):
            slo.SLO(name="x", description="", objective=0.99, histogram="h", total_metric="t")
    jax_slo, port_slo = mods(False)[1], mods(True)[1]
    for w in (60.0, 300.0, 900.0, 901.0, 3600.0):
        assert port_slo.burn_threshold(w) == jax_slo.burn_threshold(w)
    assert port_slo.DEFAULT_WINDOWS == jax_slo.DEFAULT_WINDOWS


def test_default_slos_are_jaxs_with_the_gpu_seconds_counter():
    from odh_kubeflow_tpu_torch.apis import ACCELERATOR_MAPPING

    jax_specs = {s.name: s for s in mods(False)[1].default_slos()}
    port_specs = {s.name: s for s in mods(True)[1].default_slos()}
    assert port_specs.keys() == jax_specs.keys()
    for name, spec in port_specs.items():
        want = jax_specs[name]
        for field in ("objective", "histogram", "threshold_s", "labels", "total_labels",
                      "bad_labels"):
            assert getattr(spec, field) == getattr(want, field), (name, field)
        for field in ("total_metric", "bad_metric"):
            assert getattr(spec, field) == ACCELERATOR_MAPPING.get(
                getattr(want, field), getattr(want, field)), (name, field)
    assert port_specs["idle-waste"].total_metric == "gpu_seconds_total"


def test_idle_waste_evaluates_to_zero_until_the_usage_ledger_registers():
    prom, slo = mods(True)
    clock = {"t": 0.0}
    reg = prom.Registry()
    eng = slo.SLOEngine(reg, windows=WINDOWS, time_fn=lambda: clock["t"])
    eng.tick()
    clock["t"] += 300
    eng.tick()
    rows = [r for r in eng.evaluate() if r["slo"] == "idle-waste"]
    assert [(r["total"], r["burnRate"]) for r in rows] == [(0.0, 0.0), (0.0, 0.0)]
    # once the ledger's counter exists, its idle phase burns the budget
    gpu = reg.counter(slo.GPU_SECONDS_METRIC, "GPU seconds", labelnames=("phase",))
    gpu.inc({"phase": "active"}, 30.0)
    gpu.inc({"phase": "idle"}, 70.0)
    clock["t"] += 300
    eng.tick()
    row = [r for r in eng.evaluate() if r["slo"] == "idle-waste" and r["window"] == "5m"][0]
    assert row["bad"] == 70.0 and row["burnRate"] == pytest.approx(1.4)


def test_engine_restarts_after_stop():
    import time

    prom, slo = mods(True)
    reg = prom.Registry()
    eng = slo.SLOEngine(reg, windows=WINDOWS)
    eng.start(interval=0.01)
    eng.stop()
    eng.start(interval=0.01)
    try:
        before = len(eng._samples["spawn-ready-p99"])
        deadline = time.monotonic() + 5
        while len(eng._samples["spawn-ready-p99"]) <= before and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(eng._samples["spawn-ready-p99"]) > before
    finally:
        eng.stop()


def test_slo_specs_resolve_against_the_ports_registries():
    """Every spec's histogram is registered by the port's platform (the
    sessions fleet: notebook controller, session manager, runtime, JWA)
    with exemplars on and the threshold a bucket boundary; every ratio
    counter but the usage ledger's is registered; the whole registry
    passes the naming lint, and its OpenMetrics exposition round-trips
    an exemplar while the plain one shows none."""
    import chip_smoke
    from odh_kubeflow_tpu_torch.utils import tracing
    from odh_kubeflow_tpu_torch.utils.prometheus import (
        Histogram, lint_metric_names, parse_openmetrics)
    from odh_kubeflow_tpu_torch.utils.slo import GPU_SECONDS_METRIC, default_slos

    fleet = chip_smoke.sessions_fleet()
    try:
        reg = fleet["registry"]
        for spec in default_slos():
            if spec.histogram:
                m = reg.metric(spec.histogram)
                assert isinstance(m, Histogram) and m.exemplars, spec.name
                assert spec.threshold_s in m.buckets, (spec.name, m.buckets)
            else:
                for name in (spec.total_metric, spec.bad_metric):
                    assert (reg.metric(name) is not None) == (name != GPU_SECONDS_METRIC), name
        assert lint_metric_names(reg) == []
        with tracing.span("roundtrip") as ctx:
            reg.metric("http_request_duration_seconds").observe(0.01, {"app": "jupyter-web-app"})
        plain = reg.exposition()
        assert "# EOF" not in plain and "trace_id=" not in plain
        samples = parse_openmetrics(reg.exposition(openmetrics=True))[
            "http_request_duration_seconds"]["samples"]
        assert any(ex is not None and ex[0].get("trace_id") == ctx.trace_id
                   for _, labels, _, ex in samples if labels.get("app") == "jupyter-web-app")
    finally:
        fleet["close"]()
        import shutil

        shutil.rmtree(fleet["root"], ignore_errors=True)


def test_dashboard_api_slo_serves_the_engines_rows():
    import json

    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.web.dashboard import DashboardApp

    prom, slo = mods(True)
    reg = prom.Registry()
    h = reg.histogram("web_seconds", "x", buckets=(0.25, 1.0))
    clock = {"t": 777.0}
    eng = slo.SLOEngine(reg, [slo.SLO(name="web-p99", description="d", objective=0.99,
                                      histogram="web_seconds", threshold_s=0.25)],
                        windows=WINDOWS, time_fn=lambda: clock["t"])
    eng.tick()
    clock["t"] += 300
    for _ in range(9):
        h.observe(0.1)
    h.observe(3.0)
    dash = DashboardApp(APIServer(), registry=reg, slo_engine=eng)
    seen = {}
    body = dash.app({"REQUEST_METHOD": "GET", "PATH_INFO": "/api/slo", "QUERY_STRING": "tick=1",
                     "HTTP_KUBEFLOW_USERID": "ops@example.com"},
                    lambda status, headers: seen.setdefault("status", status))
    assert seen["status"].startswith("200")
    row = [r for r in json.loads(b"".join(body))["slos"] if r["window"] == "5m"][0]
    assert row["slo"] == "web-p99" and row["burnRate"] == pytest.approx(10.0)
    assert "slo_burn_rate{" in reg.exposition()
