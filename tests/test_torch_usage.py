"""The port's GPU-second meter (``machinery/usage.py``) against the JAX
package's chip-second meter, on the CPU.

Every test of JAX's ``tests/test_usage.py`` runs through both packages on
one injected clock: the idempotent admit / release, trailing attribution
with gap-not-zero, malformed / stale / clamped samples, the gauge-only
sample, exact window splits, recovery across a restart through the
write-ahead log, the sweep's self-heal, the poll tick, the ledger under
seeded chaos. What each package persists and reports must be equal, its
names carried through ``apis.ACCELERATOR_MAPPING`` (a Workload's chips
are its GPUs). Then the same ledger from both meters over one seeded
sample stream, the culler → meter feed of JAX's ``tests/test_culler.py``
(the probe feeding the meter and the duty annotation, malformed payloads
and a hanging agent as gaps, a zero duty that still culls), the SLO
engine's ``idle-waste`` on the meter's counter, and the meter behind the
dashboard's ``/api/usage`` and the JWA's usage block.
"""

from __future__ import annotations

import importlib
import json
import random
import socket
import threading
import time as _time
from http.server import BaseHTTPRequestHandler, HTTPServer
from types import SimpleNamespace

import pytest

from odh_kubeflow_tpu_torch.apis import ACCELERATOR_MAPPING

T0 = 1_000_200.0  # aligned to the 300 s window grid
SEED = 20591
PACKAGES = ("odh_kubeflow_tpu", "odh_kubeflow_tpu_torch")
TPU_ACCEL, GPU_ACCEL = "tpu-v5-lite-podslice", "nvidia-l4"


def pkg(port: bool) -> SimpleNamespace:
    name = PACKAGES[port]
    mods = {m: importlib.import_module(f"{name}.{m}") for m in (
        "apis", "machinery.store", "machinery.usage", "machinery.wal", "machinery.faults",
        "machinery.kubelet", "scheduling", "utils.prometheus", "controllers.culler",
        "controllers.notebook", "controllers.runtime", "utils.slo")}
    usage = mods["machinery.usage"]
    return SimpleNamespace(
        port=port, apis=mods["apis"], store=mods["machinery.store"], usage=usage,
        wal=mods["machinery.wal"], faults=mods["machinery.faults"],
        kubelet=mods["machinery.kubelet"], scheduling=mods["scheduling"],
        prom=mods["utils.prometheus"], culler=mods["controllers.culler"],
        notebook=mods["controllers.notebook"], runtime=mods["controllers.runtime"],
        slo=mods["utils.slo"])


BOTH = [pkg(False), pkg(True)]


def f(p, jax_name: str) -> str:
    """A ledger field's or metric's name in ``p``: JAX's, through the
    accelerator mapping for the port."""
    return ACCELERATOR_MAPPING.get(jax_name, jax_name) if p.port else jax_name


def fmt(t):
    return _time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime(t))


def workload(p, name="nb1", namespace="team-a", chips=4, pool="pool-a", zone="zone-a",
             admitted_at=T0):
    spec = ({"nodes": 1, "gpusPerNode": chips, "acceleratorType": GPU_ACCEL} if p.port else
            {"hosts": 1, "chipsPerHost": chips, "acceleratorType": TPU_ACCEL,
             "topology": "2x2"})
    return {"apiVersion": "scheduling.kubeflow.org/v1alpha1", "kind": "Workload",
            "metadata": {"name": name, "namespace": namespace}, "spec": spec,
            "status": {"state": "Admitted", "admittedAt": fmt(admitted_at),
                       "assignment": {"pool": pool, "zone": zone}}}


def make_meter(p, clock, api=None, sample_seconds=15.0, sample_fn=None, registry=None):
    if api is None:
        api = p.store.APIServer()
        p.scheduling.register_scheduling(api)
        p.usage.register_usage(api)
    meter = p.usage.UsageMeter(
        api, p.usage.UsageConfig(enabled=True, sample_seconds=sample_seconds,
                                 window_seconds=300.0),
        registry=registry or p.prom.Registry(), time_fn=lambda: clock["t"],
        sample_fn=sample_fn)
    return api, meter


def status(p, api, window_start, name="nb1", namespace="team-a") -> dict:
    """A UsageRecord's status under JAX's field names."""
    st = api.get("UsageRecord", f"u{int(window_start)}-{name}", namespace)["status"]
    names = {f(p, k): k for k in ("allocatedChipSeconds", "activeChipSeconds",
                                  "idleChipSeconds", "sampledChipSeconds",
                                  "unsampledChipSeconds")}
    return {names.get(k, k): v for k, v in st.items()}


def jaxify(p, obj):
    """A read view of ``p`` under JAX's names (ledger fields, ``gpus``,
    the accelerator) so both packages' results compare."""
    if not p.port:
        return obj
    back = {v: k for k, v in ACCELERATOR_MAPPING.items()}
    back.update(gpus="chips", **{GPU_ACCEL: TPU_ACCEL})
    if isinstance(obj, dict):
        return {back.get(k, k) if isinstance(k, str) else k: jaxify(p, v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [jaxify(p, v) for v in obj]
    if obj == GPU_ACCEL:
        return TPU_ACCEL
    return obj


def both(scenario):
    """``scenario(p)`` in each package; the results must be equal."""
    got = [scenario(p) for p in BOTH]
    assert got[1] == got[0]
    return got[1]


# ---------------------------------------------------------------------------
# lifecycle


def test_admit_release_idempotent():
    def scenario(p):
        clock = {"t": T0}
        api, meter = make_meter(p, clock)
        wl = workload(p)
        api.create(wl)
        meter.workload_admitted(wl, t=T0)
        meter.workload_admitted(wl, t=T0 + 50)  # duplicate: no-op
        meter.workload_released("team-a", "nb1", reason="preempted", t=T0 + 100)
        meter.workload_released("team-a", "nb1", reason="node-lost", t=T0 + 200)
        written = meter.flush(T0 + 200)
        marks = [e["value"] for e in meter.timelines("team-a")[0]["events"]
                 if e["kind"] == "mark"]
        return {"written": written, "status": status(p, api, T0),
                "open": meter.summary(t=T0 + 200)["openAllocations"], "marks": marks}

    got = both(scenario)
    assert got["written"] == 1 and got["status"]["allocatedChipSeconds"] == 4 * 100
    assert got["open"] == 0 and got["marks"] == ["released:preempted"]


def test_trailing_attribution_and_max_sample_gap():
    def scenario(p):
        clock = {"t": T0}
        api, meter = make_meter(p, clock)  # sample_seconds=15 → max gap 60
        wl = workload(p)
        api.create(wl)
        meter.workload_admitted(wl, t=T0)
        meter.observe_sample("team-a", "nb1", 50.0, t=T0 + 15)
        meter.observe_sample("team-a", "nb1", 100.0, t=T0 + 130)  # 115 s gap > 60
        meter.observe_sample("team-a", "nb1", 100.0, t=T0 + 145)
        meter.flush(T0 + 145)
        return status(p, api, T0)

    st = both(scenario)
    assert st["allocatedChipSeconds"] == 4 * 145
    assert st["sampledChipSeconds"] == 4 * 30
    assert st["activeChipSeconds"] == 4 * 15 * 0.5 + 4 * 15
    assert st["idleChipSeconds"] == 4 * 15 * 0.5
    assert st["allocatedChipSeconds"] == pytest.approx(
        st["activeChipSeconds"] + st["idleChipSeconds"] + st["unsampledChipSeconds"])


def test_malformed_stale_and_clamped_samples():
    def scenario(p):
        clock = {"t": T0}
        api, meter = make_meter(p, clock)
        wl = workload(p)
        api.create(wl)
        meter.workload_admitted(wl, t=T0)
        meter.observe_sample("team-a", "nb1", "NaN-ish", t=T0 + 15)  # malformed
        meter.observe_sample("team-a", "nb1", None, t=T0 + 15)  # malformed
        meter.observe_sample("team-a", "nb1", 250.0, t=T0 + 15)  # clamps to 100
        meter.observe_sample("team-a", "nb1", 80.0, t=T0 + 10)  # stale
        meter.observe_sample("team-a", "nb1", -40.0, t=T0 + 30)  # clamps to 0
        meter.flush(T0 + 30)
        events = meter.timelines("team-a")[0]["events"]
        return {"status": status(p, api, T0),
                "samples": [e["value"] for e in events if e["kind"] == "sample"]}

    got = both(scenario)
    assert got["status"]["samples"] == 2 and got["status"]["activeChipSeconds"] == 4 * 15
    assert got["samples"] == [100.0, 80.0, 0.0]


def test_sample_without_allocation_is_gauge_only():
    def scenario(p):
        clock = {"t": T0}
        api, meter = make_meter(p, clock)
        meter.observe_sample("team-a", "ghost", 75.0, t=T0 + 5)
        rows = meter.timelines("team-a")
        return {"written": meter.flush(T0 + 10), "notebook": rows[0]["notebook"],
                "open": rows[0]["open"]}

    assert both(scenario) == {"written": 0, "notebook": "ghost", "open": False}


# ---------------------------------------------------------------------------
# windows and persistence


def test_window_split_is_exact_at_the_boundary():
    def scenario(p):
        clock = {"t": T0}
        api, meter = make_meter(p, clock, sample_seconds=150.0)
        wl = workload(p, admitted_at=T0 + 250)
        api.create(wl)
        meter.workload_admitted(wl, t=T0 + 250)
        meter.observe_sample("team-a", "nb1", 50.0, t=T0 + 350)
        written = meter.flush(T0 + 350)
        rec = api.get("UsageRecord", f"u{int(T0)}-nb1", "team-a")
        return {"written": written, "first": status(p, api, T0),
                "second": status(p, api, T0 + 300),
                "label": rec["metadata"]["labels"][p.usage.WINDOW_LABEL],
                "spec": jaxify(p, rec["spec"])}

    got = both(scenario)
    assert got["written"] == 2 and got["label"] == str(int(T0))
    for st in (got["first"], got["second"]):
        assert st["allocatedChipSeconds"] == st["sampledChipSeconds"] == 4 * 50
        assert st["activeChipSeconds"] == 4 * 50 * 0.5
    assert (got["first"]["flushedThrough"], got["second"]["flushedThrough"]) == (
        T0 + 300, T0 + 350)


def test_failover_recovers_ledger_without_loss(tmp_path):
    """A crash between flushes: the new meter rebuilds its buckets from
    the WAL-replayed UsageRecords and resumes from ``flushedThrough``."""

    def scenario(p):
        d = str(tmp_path / ("port" if p.port else "jax"))
        clock = {"t": T0}
        wal = p.wal.WriteAheadLog(d)
        api = p.store.APIServer(wal=wal)
        p.scheduling.register_scheduling(api)
        p.usage.register_usage(api)
        _, meter = make_meter(p, clock, api=api)
        wl = workload(p)
        api.create(wl)
        meter.workload_admitted(wl, t=T0)
        meter.observe_sample("team-a", "nb1", 50.0, t=T0 + 15)
        clock["t"] = T0 + 15
        written = meter.flush(T0 + 15)
        api.close()
        wal.close()
        wal2 = p.wal.WriteAheadLog(d)
        api2 = p.store.APIServer.recover(wal2)
        _, meter2 = make_meter(p, clock, api=api2)
        meter2.recover()
        nb = jaxify(p, meter2.notebook_usage("team-a", "nb1", t=T0 + 15))
        meter2.observe_sample("team-a", "nb1", 50.0, t=T0 + 30)
        clock["t"] = T0 + 30
        meter2.flush(T0 + 30)
        api2.close()
        wal2.close()
        return {"written": written, "reopened": nb, "status": status(p, api2, T0)}

    got = both(scenario)
    assert got["reopened"]["allocated"] is True
    assert got["reopened"]["allocatedChipSeconds"] == 4 * 15
    st = got["status"]
    assert st["allocatedChipSeconds"] == st["sampledChipSeconds"] == 4 * 30
    assert st["activeChipSeconds"] == 4 * 30 * 0.5


def test_sweep_self_heals_missed_lifecycle():
    def scenario(p):
        clock = {"t": T0 + 40}
        api, meter = make_meter(p, clock)
        api.create(workload(p, admitted_at=T0))  # no workload_admitted call
        meter.sweep(T0 + 40)
        opened = jaxify(p, meter.notebook_usage("team-a", "nb1", t=T0 + 40))
        api.delete("Workload", "nb1", "team-a")
        clock["t"] = T0 + 100
        meter.sweep(T0 + 100)
        closed = jaxify(p, meter.notebook_usage("team-a", "nb1", t=T0 + 500))
        marks = [e["value"] for e in meter.timelines("team-a")[0]["events"]
                 if e["kind"] == "mark"]
        return {"opened": opened, "closed": closed, "marks": marks}

    got = both(scenario)
    assert got["opened"]["allocated"] and got["opened"]["allocatedChipSeconds"] == 4 * 40
    assert not got["closed"]["allocated"] and got["closed"]["allocatedChipSeconds"] == 4 * 100
    assert got["marks"] == ["released:swept"]


def test_poll_samples_through_sample_fn_with_gap_on_none():
    def scenario(p):
        clock = {"t": T0}
        duties = {"nb1": 60.0}
        api, meter = make_meter(p, clock, sample_fn=lambda ns, nb: duties.get(nb))
        api.create(workload(p, admitted_at=T0))
        for t, duty in ((15, 60.0), (150, None), (165, 60.0), (180, 60.0)):
            if duty is None:
                duties.pop("nb1", None)
            else:
                duties["nb1"] = duty
            clock["t"] = T0 + t
            meter.poll()
        return status(p, api, T0)

    st = both(scenario)
    assert st["allocatedChipSeconds"] == 4 * 180 and st["sampledChipSeconds"] == 4 * 30
    assert st["activeChipSeconds"] == pytest.approx(4 * 30 * 0.6)


# ---------------------------------------------------------------------------
# chaos


def test_ledger_exact_under_seeded_chaos():
    """The persistence path under the CI chaos mix: failed upserts stay
    dirty and land on a later flush; once the weather clears the windows
    sum to the straight-line truth — and both packages' records equal."""

    def scenario(p):
        clock = {"t": T0}
        api = p.store.APIServer()
        p.scheduling.register_scheduling(api)
        p.usage.register_usage(api)
        registry = p.prom.Registry()
        injector = p.faults.FaultInjector(api, seed=SEED,
                                          schedule=p.faults.FaultSchedule.default(),
                                          registry=registry, sleep_fn=lambda _s: None)
        meter = p.usage.UsageMeter(
            injector, p.usage.UsageConfig(enabled=True, sample_seconds=15.0,
                                          window_seconds=300.0),
            registry=registry, time_fn=lambda: clock["t"])
        plan = {"nb-a": (4, 50.0, 0, None), "nb-b": (8, 25.0, 0, 20),
                "nb-c": (2, 100.0, 4, None)}
        open_at, gt = {}, {n: {"alloc": 0.0, "active": 0.0} for n in plan}
        for tick in range(41):
            t = T0 + tick * 15.0
            clock["t"] = t
            for name, (chips, duty, open_tick, close_tick) in plan.items():
                if tick == open_tick:
                    wl = workload(p, name=name, chips=chips, admitted_at=t)
                    api.create(wl)
                    meter.workload_admitted(wl, t=t)
                    open_at[name] = t
                elif tick == close_tick:
                    api.delete("Workload", name, "team-a")
                    meter.workload_released("team-a", name, "preempted", t=t)
                    gt[name]["alloc"] += chips * (t - open_at.pop(name))
                elif name in open_at:
                    meter.observe_sample("team-a", name, duty, t=t, source="test")
                    gt[name]["active"] += chips * 15.0 * duty / 100.0
            if tick and tick % 4 == 0:
                meter.flush(t)
        t_end = T0 + 40 * 15.0
        for name, opened in open_at.items():
            gt[name]["alloc"] += plan[name][0] * (t_end - opened)
        injector.set_schedule(p.faults.FaultSchedule())
        meter.flush(t_end)
        sums = {n: {"alloc": 0.0, "active": 0.0} for n in plan}
        for rec in api.list("UsageRecord"):
            st = rec["status"]
            sums[rec["spec"]["notebook"]]["alloc"] += st[f(p, "allocatedChipSeconds")]
            sums[rec["spec"]["notebook"]]["active"] += st[f(p, "activeChipSeconds")]
        for name in plan:
            assert sums[name]["alloc"] == pytest.approx(gt[name]["alloc"]), name
            assert sums[name]["active"] == pytest.approx(gt[name]["active"]), name
        records = {r["metadata"]["name"]: status(p, api, r["spec"]["windowStart"],
                                                 r["spec"]["notebook"])
                   for r in api.list("UsageRecord")}
        errors = [line for line in registry.exposition().splitlines()
                  if line.startswith(("faults_injected_total{", "usage_ledger_flush_errors"))]
        return {"records": records, "errors": sorted(errors)}

    got = both(scenario)
    assert len(got["records"]) >= 4 and any("usage_ledger_flush_errors" in e
                                            for e in got["errors"])


# ---------------------------------------------------------------------------
# one sample stream, two meters


def test_same_ledger_from_both_meters_over_one_sample_stream():
    """Three notebooks through admissions, releases, suspends (marks),
    seeded duty samples (late, stale, malformed, gaps) and flushes across
    window boundaries, on one injected clock: the records, the summary,
    the utilization view, each notebook's usage block, the timelines and
    the metric samples equal JAX's."""
    rng = random.Random(SEED)
    stream = []
    for tick in range(120):
        t = T0 + tick * 7.0 + rng.random()
        for name in ("nb-a", "nb-b", "nb-c"):
            r = rng.random()
            if r < 0.05:
                stream.append(("gap", name, t))
            elif r < 0.08:
                stream.append(("sample", name, t, "garbage"))
            else:
                stream.append(("sample", name, t, round(rng.uniform(0, 100), 3)))
        if tick == 10:
            stream.append(("admit", "nb-c", t))
        if tick == 40:
            stream.append(("release", "nb-b", t))
            stream.append(("mark", "nb-b", t, "suspended"))
        if tick == 70:
            stream.append(("admit", "nb-b", t))
            stream.append(("mark", "nb-b", t, "resumed:restored"))
        if tick % 9 == 0:
            stream.append(("flush", t))

    def scenario(p):
        clock = {"t": T0}
        registry = p.prom.Registry()
        api, meter = make_meter(p, clock, sample_seconds=5.0, registry=registry)
        for name, chips, zone in (("nb-a", 4, "zone-a"), ("nb-b", 8, "zone-b"),
                                  ("nb-c", 2, "zone-a")):
            wl = workload(p, name=name, chips=chips, zone=zone, pool=f"pool-{zone}")
            api.create(wl)
            if name != "nb-c":
                meter.workload_admitted(wl, t=T0)
        for ev in stream:
            kind, t = ev[0], ev[-1] if ev[0] in ("admit", "release", "flush", "gap") else ev[2]
            clock["t"] = t
            if kind == "sample":
                meter.observe_sample("team-a", ev[1], ev[3], t=t, source="agent")
            elif kind == "admit":
                meter.workload_admitted(api.get("Workload", ev[1], "team-a"), t=t)
            elif kind == "release":
                meter.workload_released("team-a", ev[1], reason="suspended", t=t)
            elif kind == "mark":
                meter.mark_event("team-a", ev[1], ev[3], t=t)
            elif kind == "flush":
                meter.flush(t)
        t_end = clock["t"] + 1.0
        meter.flush(t_end)
        records = {r["metadata"]["name"]: (jaxify(p, r["spec"]),
                                          status(p, api, r["spec"]["windowStart"],
                                                 r["spec"]["notebook"]))
                   for r in api.list("UsageRecord")}
        samples = sorted(
            line.replace(f(p, "tpu_chip_seconds_total"), "tpu_chip_seconds_total")
            .replace(f(p, "tpu_allocated_chip_seconds_total"), "tpu_allocated_chip_seconds_total")
            .replace(f(p, "tpu_duty_samples_total"), "tpu_duty_samples_total")
            .replace(f(p, "tpu_duty_cycle_pct"), "tpu_duty_cycle_pct")
            .replace(f(p, "tpu_pool_utilization_ratio"), "tpu_pool_utilization_ratio")
            for line in registry.exposition().splitlines()
            if not line.startswith("#")
            and any(w in line for w in ("chip", "gpu", "duty", "pool_utilization")))
        return {"records": records, "summary": jaxify(p, meter.summary(t=t_end)),
                "utilization": jaxify(p, meter.utilization(t=t_end)),
                "usage": {n: jaxify(p, meter.notebook_usage("team-a", n, t=t_end))
                          for n in ("nb-a", "nb-b", "nb-c")},
                "timelines": meter.timelines("team-a", limit=1000), "metrics": samples}

    got = both(scenario)
    assert len(got["records"]) > 6 and got["summary"]["openAllocations"] == 3
    for r in got["summary"]["namespaces"]:
        assert r["allocatedChipSeconds"] == pytest.approx(
            r["activeChipSeconds"] + r["idleChipSeconds"] + r["unsampledChipSeconds"],
            abs=0.01)


# ---------------------------------------------------------------------------
# the culler → meter feed (JAX's tests/test_culler.py)


class FakeJupyter(BaseHTTPRequestHandler):
    kernels: list = []
    terminals: list = []
    agent = None

    def do_GET(self):  # noqa: N802
        body = None
        if self.path.endswith("/api/kernels"):
            body = type(self).kernels
        elif self.path.endswith("/api/terminals"):
            body = type(self).terminals
        elif self.path.endswith(("/api/tpu/activity", "/api/gpu/activity")):
            body = type(self).agent
        if body is None:
            self.send_response(404)
            self.end_headers()
            return
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


@pytest.fixture
def jupyter_server():
    server = HTTPServer(("127.0.0.1", 0), FakeJupyter)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    FakeJupyter.kernels, FakeJupyter.terminals, FakeJupyter.agent = [], [], None
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


def metered_env(p, base_url, now_fn, probe_timeout=5.0):
    api = p.store.APIServer()
    p.apis.register_crds(api)
    p.scheduling.register_scheduling(api)
    p.usage.register_usage(api)
    cluster = p.kubelet.FakeCluster(api)
    cluster.add_node("cpu-0")
    if p.port:
        cluster.add_gpu_node_pool("l4", GPU_ACCEL, num_nodes=1, gpus_per_node=4)
    else:
        cluster.add_tpu_node_pool("v5e", TPU_ACCEL, "2x2")
    registry = p.prom.Registry()
    meter = p.usage.UsageMeter(api, p.usage.UsageConfig(enabled=True, sample_seconds=30.0),
                               registry=registry, time_fn=now_fn)
    # the agent's probe rides the fake base (base_url_fn alone)
    culler = p.culler.Culler(
        api, p.culler.CullerConfig(cull_idle_seconds=600, idleness_check_seconds=60,
                                   probe_timeout=probe_timeout),
        base_url_fn=lambda nb: base_url, now_fn=now_fn, meter=meter)
    mgr = p.runtime.Manager(api, time_fn=now_fn)
    p.notebook.NotebookController(
        api, p.notebook.NotebookControllerConfig(enable_culling=True), culler=culler
    ).register(mgr)
    return api, cluster, mgr, meter, registry


def accel_notebook(p, name="train"):
    ann = ({p.apis.GPU_ACCELERATOR_ANNOTATION: GPU_ACCEL, p.apis.GPU_COUNT_ANNOTATION: "4"}
           if p.port else {p.apis.TPU_ACCELERATOR_ANNOTATION: TPU_ACCEL,
                           p.apis.TPU_TOPOLOGY_ANNOTATION: "2x2"})
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": "team-a", "annotations": ann},
            "spec": {"template": {"spec": {"containers": [{"name": name, "image": "img"}]}}}}


def duty_annotation(p):
    return p.apis.GPU_DUTY_CYCLE_ANNOTATION if p.port else p.apis.TPU_DUTY_CYCLE_ANNOTATION


def test_probe_feeds_meter_and_stamps_duty_annotation(jupyter_server):
    """One healthy probe, three consumers: the duty blocks the cull, lands
    as the audit annotation, and attributes active GPU-seconds."""

    def scenario(p):
        clock = {"t": 6_000_000.0}
        api, cluster, mgr, meter, registry = metered_env(p, jupyter_server,
                                                         lambda: clock["t"])
        FakeJupyter.kernels = [{"execution_state": "idle",
                                "last_activity": fmt(clock["t"] - 10_000)}]
        FakeJupyter.agent = {"duty_cycle_pct": 42.5}
        api.create(accel_notebook(p))
        mgr.drain()
        cluster.step()
        wl = workload(p, name="train", pool="v5e")
        api.create(wl)
        meter.workload_admitted(wl, t=clock["t"])
        mgr.drain()
        clock["t"] += 61
        mgr.drain()
        ann = api.get("Notebook", "train", "team-a")["metadata"]["annotations"]
        usage = jaxify(p, meter.notebook_usage("team-a", "train", t=clock["t"]))
        samples = [e["value"] for e in meter.timelines("team-a")[0]["events"]
                   if e["kind"] == "sample"]
        return {"stopped": p.apis.STOP_ANNOTATION in ann,
                "duty_annotation": ann[duty_annotation(p)] == f"42.5@{fmt(clock['t'])}",
                "usage": usage, "samples": samples,
                "counted": f'{f(p, "tpu_duty_samples_total")}{{source="culler"}} 1'
                in registry.exposition()}

    got = both(scenario)
    assert not got["stopped"] and got["duty_annotation"] and got["counted"]
    assert got["usage"]["dutyCyclePct"] == 42.5 and got["samples"] == [42.5]
    assert got["usage"]["activeChipSeconds"] == pytest.approx(4 * 61 * 0.425)


@pytest.mark.parametrize("payload", ["garbage", 17, ["duty_cycle_pct", 99], {"status": "ok"},
                                     {"duty_cycle_pct": None}, {"duty_cycle_pct": "NaN-ish"}])
def test_malformed_agent_payload_is_gap_not_zero(jupyter_server, payload):
    def scenario(p):
        clock = {"t": 7_000_000.0}
        api, cluster, mgr, meter, registry = metered_env(p, jupyter_server,
                                                         lambda: clock["t"])
        FakeJupyter.kernels = [{"execution_state": "idle",
                                "last_activity": fmt(clock["t"] - 10_000)}]
        FakeJupyter.agent = payload
        api.create(accel_notebook(p))
        mgr.drain()
        cluster.step()
        clock["t"] += 61
        mgr.drain()
        clock["t"] += 700
        mgr.drain()
        ann = api.get("Notebook", "train", "team-a")["metadata"]["annotations"]
        return {"duty": duty_annotation(p) in ann, "stopped": p.apis.STOP_ANNOTATION in ann,
                "timelines": meter.timelines("team-a"),
                "culler_source": 'source="culler"' in registry.exposition()}

    assert both(scenario) == {"duty": False, "stopped": True, "timelines": [],
                              "culler_source": False}


def test_hanging_agent_times_out_as_gap():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(16)  # accepts connects; nothing ever answers
    try:
        def scenario(p):
            clock = {"t": 8_000_000.0}
            api, cluster, mgr, meter, _ = metered_env(
                p, f"http://127.0.0.1:{srv.getsockname()[1]}", lambda: clock["t"],
                probe_timeout=0.25)
            api.create(accel_notebook(p))
            mgr.drain()
            cluster.step()
            clock["t"] += 61
            mgr.drain()
            ann = api.get("Notebook", "train", "team-a")["metadata"]["annotations"]
            first = (p.apis.LAST_ACTIVITY_ANNOTATION in ann, duty_annotation(p) in ann)
            clock["t"] += 700
            mgr.drain()
            ann = api.get("Notebook", "train", "team-a")["metadata"]["annotations"]
            return {"first": first, "stopped": p.apis.STOP_ANNOTATION in ann,
                    "timelines": meter.timelines("team-a")}

        assert both(scenario) == {"first": (True, False), "stopped": True, "timelines": []}
    finally:
        srv.close()


def test_malformed_last_active_and_zero_duty_still_cull(jupyter_server):
    def scenario(p):
        clock = {"t": 9_000_000.0}
        api, cluster, mgr, meter, _ = metered_env(p, jupyter_server, lambda: clock["t"])
        FakeJupyter.kernels = []
        FakeJupyter.agent = {"duty_cycle_pct": 0.0, "last_active": "not-a-timestamp"}
        api.create(accel_notebook(p))
        mgr.drain()
        cluster.step()
        clock["t"] += 61
        mgr.drain()
        ann = api.get("Notebook", "train", "team-a")["metadata"]["annotations"]
        first = (ann[duty_annotation(p)].startswith("0@"), p.apis.STOP_ANNOTATION in ann)
        clock["t"] += 700
        mgr.drain()
        ann = api.get("Notebook", "train", "team-a")["metadata"]["annotations"]
        samples = [e["value"] for e in meter.timelines("team-a")[0]["events"]
                   if e["kind"] == "sample"]
        return {"first": first, "stopped": p.apis.STOP_ANNOTATION in ann, "samples": samples}

    assert both(scenario) == {"first": (True, False), "stopped": True, "samples": [0.0, 0.0]}


# ---------------------------------------------------------------------------
# the counter behind idle-waste, the dashboard and the JWA


def test_idle_waste_reads_the_meters_counter():
    from odh_kubeflow_tpu_torch.utils import slo

    p = BOTH[1]
    clock = {"t": T0}
    registry = p.prom.Registry()
    api, meter = make_meter(p, clock, registry=registry)
    eng = slo.SLOEngine(registry, windows={"5m": 300.0}, time_fn=lambda: clock["t"])
    eng.tick()
    wl = workload(p)
    api.create(wl)
    meter.workload_admitted(wl, t=T0)
    meter.observe_sample("team-a", "nb1", 25.0, t=T0 + 15)
    clock["t"] = T0 + 60
    eng.tick()
    row = [r for r in eng.evaluate() if r["slo"] == "idle-waste"][0]
    assert row["total"] == pytest.approx(4 * 15) and row["bad"] == pytest.approx(4 * 15 * 0.75)
    assert slo.GPU_SECONDS_METRIC == meter.m_gpu_seconds.name == "gpu_seconds_total"


def test_dashboard_usage_and_jwa_block_serve_the_meter():
    """``/api/usage`` answers the meter's summary (200, not 503), the
    occupancy panel carries its utilization, and the JWA's details page
    its per-notebook block."""
    import urllib.request

    from odh_kubeflow_tpu_torch.web.dashboard import DashboardApp
    from odh_kubeflow_tpu_torch.web.jwa import JupyterWebApp

    p = BOTH[1]
    clock = {"t": T0}
    api = p.store.APIServer()
    p.apis.register_crds(api)
    p.scheduling.register_scheduling(api)
    p.usage.register_usage(api)
    p.apis.install_default_cluster_roles(api)
    registry = p.prom.Registry()
    _, meter = make_meter(p, clock, api=api, registry=registry)
    wl = workload(p)
    api.create(wl)
    meter.workload_admitted(wl, t=T0)
    meter.observe_sample("team-a", "nb1", 50.0, t=T0 + 15)
    clock["t"] = T0 + 20
    from odh_kubeflow_tpu_torch.controllers.profile import ProfileController

    mgr = p.runtime.Manager(api)
    ProfileController(api, registry=registry).register(mgr)
    api.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                "metadata": {"name": "team-a"},
                "spec": {"owner": {"kind": "User", "name": "alice@example.com"}}})
    mgr.drain()
    api.create(accel_notebook(p, "nb1"))
    dash = DashboardApp(api, registry=registry, meter=meter)
    jwa = JupyterWebApp(api, registry=registry, meter=meter)
    servers = [dash.app.serve("127.0.0.1", 0), jwa.app.serve("127.0.0.1", 0)]
    try:
        def get(server, path):
            req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}{path}",
                                         headers={"kubeflow-userid": "alice@example.com"})
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.loads(r.read())

        code, body = get(servers[0], "/api/usage")
        row = body["usage"]["namespaces"][0]
        assert code == 200 and row["namespace"] == "team-a"
        assert row[f(p, "allocatedChipSeconds")] == 4 * 20
        assert row[f(p, "activeChipSeconds")] == 4 * 15 * 0.5
        code, body = get(servers[1], "/api/namespaces/team-a/notebooks/nb1/details")
        block = body["details"]["usage"]
        assert block == meter.notebook_usage("team-a", "nb1")
        assert block["gpus"] == 4 and block["allocated"] is True
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
