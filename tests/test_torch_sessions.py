"""The port's suspend-to-checkpoint sessions against the JAX package's, on
the CPU.

Every scenario of JAX's ``tests/test_sessions.py`` runs through both
packages' store,
kubelet simulator (its container-memory hooks), notebook controller
(queueing and sessions on), culler, ``SessionManager`` and the
suspender-wired ``SliceScheduler``: the checkpoint store's receipts,
suspend on cull, the scale-down held until the snapshot is durable, the
freed reservation, warm resume before ready, checkpoint-then-preempt,
oversubscribed pools, the JWA's suspend / resume surface, the seeded
suspend / resume property and the metric families. JAX's observations,
carried across by ``to_port`` (a v5e 2x2 slice is one L4 node of 4
GPUs), must equal the port's: receipts and digests, checkpoint phases,
events, suspend and preempt decisions, session state in the pods. The
property's chaos variant puts each package's seeded ``FaultInjector``
(``machinery/faults.py``) between its controllers and its store; the
faults land on each package's own call sequence, so there each package
is held to the invariants and both to every session ending admitted
with its state.

Both packages run on one clock: object timestamps one second apart in
the order they are stamped, and ``time.time`` half a second after the
newest stamp, so creation order and every grace or idle window read the
same in both runs.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import random
import time

import pytest

from test_torch_scheduling import FLAVORS, V5E, to_port as _sched_to_port

# imported before any test patches ``time.time``: a default argument
# ``time_fn=time.time`` keeps the function it saw at import
for _pkg in ("odh_kubeflow_tpu", "odh_kubeflow_tpu_torch"):
    for _mod in ("controllers.culler", "controllers.notebook", "scheduling.scheduler",
                 "sessions.manager", "warmup.compilecache", "warmup.pool", "web.jwa"):
        importlib.import_module(f"{_pkg}.{_mod}")

NS = "team-a"
_sleep = time.sleep
L4, L4_GPUS, L4_PER_NODE = FLAVORS[(V5E, "2x2")]
SEED = 20260803

_VOLATILE = {
    "uid", "creationTimestamp", "resourceVersion", "queuedAt", "admittedAt",
    "firstTimestamp", "lastTimestamp", "suspendedAt", "resumedAt", "resumeStartedAt",
    "notebookUID", "claimedAt", "lastAccessAt", "createdAt", "lastSyncAt",
    "templateDigest",
}
_TEXT = (
    ("releasing the slice reservation", "releasing the GPU reservation"),
    ("retrying before releasing the slice", "retrying before releasing the GPUs"),
    ("release their slice reservation", "release their GPU reservation"),
    ("idle session yielding its slice to", "idle session yielding its GPUs to"),
    ("to checkpoint and releasing the slice", "to checkpoint and releasing the GPUs"),
)


def scrub(obj):
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


def to_port(obj):
    """JAX's observations carried to the port's names: a checkpoint's spec
    (chips, the TPU type and topology → GPUs, the GPU type and GPUs a
    node), a Workload's spec and the scheduler's texts as
    ``test_torch_scheduling.to_port`` carries them, and the sessions'
    event texts."""
    if isinstance(obj, dict):
        if {"notebook", "chips", "topology", "acceleratorType"} <= obj.keys():
            out = {k: v for k, v in obj.items() if k not in ("chips", "topology")}
            out.update(gpus=L4_GPUS if obj["chips"] else 0,
                       acceleratorCount=str(L4_PER_NODE) if obj["topology"] else "",
                       acceleratorType=L4 if obj["acceleratorType"] == V5E
                       else obj["acceleratorType"])
            return out
        if "chipsPerHost" in obj:  # a Workload's spec
            return _sched_to_port({"spec": obj})["spec"]
        return {_sched_to_port(k): to_port(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(v) for v in obj)
    if isinstance(obj, str):
        for a, b in _TEXT:
            obj = obj.replace(a, b)
        return _sched_to_port(obj)
    return obj


@pytest.fixture(autouse=True)
def shared_clock(monkeypatch):
    """One timeline for both packages (see the module docstring)."""
    from odh_kubeflow_tpu.machinery import objects as jax_objects
    from odh_kubeflow_tpu_torch.machinery import objects as port_objects

    clock = Clock()
    for mod in (jax_objects, port_objects):
        monkeypatch.setattr(mod, "now_rfc3339", clock.stamp)
    monkeypatch.setattr(time, "time", clock.time)
    return clock


class Clock:
    def __init__(self):
        self.base = float(int(time.time()))
        self.reset()

    def reset(self):
        self.t = self.base

    def stamp(self) -> str:
        self.t += 1.0
        return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(self.t))

    def time(self) -> float:
        return self.t + 0.5


CLOCK_HOLDER: list = []


class Env:
    """One package's platform for the session, zone and warm-pool
    scenarios: store, kubelet simulator, notebook controller (queueing +
    sessions), ``SessionManager`` over a JSON (or the port's torch)
    checkpoint store, the suspender-wired ``SliceScheduler``; optionally
    the culler, a zone-replicated store and the warm-start subsystem."""

    def __init__(self, port: bool, tmp_path, *, quota=None, factor=None, pools=1,
                 culling=False, suspend_on_cull=True, reclaim_idle_seconds=0.0,
                 zones=None, pools_per_zone=1, spot_pool_zone=None, storm_threshold=2,
                 replicated=False, zone_heal_retry_seconds=30.0, warm=False, grace=60.0,
                 compile_cache_mount="", backend="json", suspender=True, sessions=True,
                 suspend_grace_seconds=600.0, chaos=None):
        if port:
            from odh_kubeflow_tpu_torch import apis, sessions as sess, warmup
            from odh_kubeflow_tpu_torch.controllers import culler as culler_mod
            from odh_kubeflow_tpu_torch.controllers import notebook as nb_mod
            from odh_kubeflow_tpu_torch.controllers.runtime import Manager, Request
            from odh_kubeflow_tpu_torch.machinery import objects, store
            from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
            from odh_kubeflow_tpu_torch import scheduling as sched_pkg
            from odh_kubeflow_tpu_torch.scheduling import queue, register_scheduling, scheduler
            from odh_kubeflow_tpu_torch.sessions import checkpoint, manager
            from odh_kubeflow_tpu_torch.utils.prometheus import Registry
            from odh_kubeflow_tpu_torch.warmup import compilecache, pool as pool_mod
            from odh_kubeflow_tpu_torch.web.jwa import JupyterWebApp
        else:
            from odh_kubeflow_tpu import apis, sessions as sess, warmup
            from odh_kubeflow_tpu.controllers import culler as culler_mod
            from odh_kubeflow_tpu.controllers import notebook as nb_mod
            from odh_kubeflow_tpu.controllers.runtime import Manager, Request
            from odh_kubeflow_tpu.machinery import objects, store
            from odh_kubeflow_tpu.machinery.kubelet import FakeCluster
            from odh_kubeflow_tpu import scheduling as sched_pkg
            from odh_kubeflow_tpu.scheduling import queue, register_scheduling, scheduler
            from odh_kubeflow_tpu.sessions import checkpoint, manager
            from odh_kubeflow_tpu.utils.prometheus import Registry
            from odh_kubeflow_tpu.warmup import compilecache, pool as pool_mod
            from odh_kubeflow_tpu.web.jwa import JupyterWebApp
        if CLOCK_HOLDER:
            CLOCK_HOLDER[0].reset()
        self.port, self.apis, self.objects, self.store_mod = port, apis, objects, store
        self.sess, self.warmup, self.queue, self.Request = sess, warmup, queue, Request
        self.checkpoint, self.compilecache, self.pool_mod = checkpoint, compilecache, pool_mod
        self.JupyterWebApp, self.culler_mod = JupyterWebApp, culler_mod
        self.component = scheduler.COMPONENT
        self.resource = apis.GPU_RESOURCE if port else "google.com/tpu"
        root = tmp_path / ("port" if port else "jax")

        def now():  # the shared clock (a default argument bound the real one)
            return time.time()

        raw = self.api = store.APIServer()
        apis.register_crds(raw)
        register_scheduling(raw)
        sess.register_sessions(raw)
        if warm:
            warmup.register_warmup(raw)
        self.cluster = FakeCluster(raw)
        self.registry = Registry()
        # ``chaos`` (a FaultSchedule factory): the controllers reach the
        # store through a seeded FaultInjector; the simulator and the
        # assertions read the store itself
        self.injector = None
        if chaos is not None:
            faults = importlib.import_module(
                f"{'odh_kubeflow_tpu_torch' if port else 'odh_kubeflow_tpu'}.machinery.faults")
            self.injector = faults.FaultInjector(raw, seed=SEED, schedule=chaos(faults),
                                                 registry=self.registry,
                                                 sleep_fn=lambda _s: None)
            self.calm_schedule = faults.FaultSchedule.none()
        api = self.injector or raw
        self.mgr = Manager(api)
        zone_names = list(zones or ())
        if replicated:
            self.store = checkpoint.ReplicatedCheckpointStore(
                checkpoint.parse_zone_spec(",".join(zone_names), str(root / "ckpts")),
                backend=backend)
        else:
            self.store = checkpoint.SessionCheckpointStore(str(root / "ckpts"), backend=backend)
        self.session_mgr = None
        if sessions:
            self.session_mgr = manager.SessionManager(
                api,
                manager.SessionConfig(checkpoint_dir=str(root / "ckpts"), backend=backend,
                                      reclaim_idle_seconds=reclaim_idle_seconds,
                                      zone_heal_retry_seconds=zone_heal_retry_seconds),
                registry=self.registry, runtime=self.cluster.session_runtime,
                store=self.store, time_fn=now)
        self.culler = None
        if culling:
            self.culler = culler_mod.Culler(
                api,
                culler_mod.CullerConfig(cull_idle_seconds=3600.0, idleness_check_seconds=0.0,
                                        suspend_on_cull=suspend_on_cull),
                base_url_fn=lambda nb: "http://127.0.0.1:9/unreachable", now_fn=now)
        nb_mod.NotebookController(
            api,
            nb_mod.NotebookControllerConfig(enable_queueing=True, enable_sessions=True,
                                            enable_culling=culling,
                                            suspend_grace_seconds=suspend_grace_seconds,
                                            compile_cache_mount=compile_cache_mount),
            registry=self.registry, culler=self.culler,
        ).register(self.mgr)
        if self.session_mgr is not None:
            self.session_mgr.register(self.mgr)
        self.scheduler = scheduler.SliceScheduler(
            api, registry=self.registry,
            suspender=self.session_mgr if suspender else None, time_fn=now,
            zone_storm_threshold=storm_threshold, zone_drain_cooldown=3600.0)
        self.scheduler.register(self.mgr)
        self.cc = self.warm = None
        if warm:
            self.cc = compilecache.CompileCacheService(
                api, compilecache.CompileCacheConfig(cache_dir=str(root / "cc")),
                registry=self.registry, time_fn=now)
            self.warm = pool_mod.WarmPoolController(
                api, pool_mod.WarmPoolConfig(claim_grace_seconds=grace, resync_seconds=0.05),
                registry=self.registry, session_store=self.store, compile_cache=self.cc,
                time_fn=now)
            self.warm.register(self.mgr)
        if zones:
            for zone in zone_names:
                count = zones[zone] if isinstance(zones, dict) else pools_per_zone
                for i in range(count):
                    self.add_pool(f"{zone}-pool-{i}", zone=zone)
            if spot_pool_zone:
                self.add_pool(f"{spot_pool_zone}-spot", zone=spot_pool_zone, spot=True)
        else:
            for i in range(pools):
                self.add_pool(f"pool-{i}")
        if quota is not None:
            q = {"apiVersion": "v1", "kind": "ResourceQuota",
                 "metadata": {"name": "kf-resource-quota", "namespace": NS, "annotations": {}},
                 "spec": {"hard": {f"requests.{self.resource}": str(quota)}}}
            if factor is not None:
                q["metadata"]["annotations"][
                    sched_pkg.OVERSUBSCRIPTION_FACTOR_ANNOTATION] = str(factor)
            raw.create(q)
        self.servers: list = []

    # -- the cluster, in either package's terms ------------------------------

    def add_pool(self, name, zone="", spot=False):
        if self.port:
            return self.cluster.add_gpu_node_pool(name, L4, num_nodes=1,
                                                  gpus_per_node=L4_PER_NODE, zone=zone,
                                                  spot=spot)
        return self.cluster.add_tpu_node_pool(name, V5E, "2x2", num_hosts=1, chips_per_host=4,
                                              zone=zone, spot=spot)

    def gpu_annotations(self) -> dict:
        if self.port:
            return {self.apis.GPU_ACCELERATOR_ANNOTATION: L4,
                    self.apis.GPU_COUNT_ANNOTATION: str(L4_GPUS)}
        return {self.apis.TPU_ACCELERATOR_ANNOTATION: V5E,
                self.apis.TPU_TOPOLOGY_ANNOTATION: "2x2"}

    def notebook(self, name, priority_class=None, image="jax:latest") -> dict:
        ann = self.gpu_annotations()
        if priority_class:
            ann["notebooks.kubeflow.org/priority-class"] = priority_class
        return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
                "metadata": {"name": name, "namespace": NS, "annotations": ann},
                "spec": {"template": {"spec": {"containers": [
                    {"name": name, "image": image}]}}}}

    def create(self, name, **kw):
        return self.api.create(self.notebook(name, **kw))

    def priority_classes(self):
        for name, value in (("tpu-interactive", 1000), ("tpu-batch", -100)):
            self.api.create({"apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
                             "metadata": {"name": name}, "value": value,
                             "globalDefault": False})

    def kick(self, name):
        """Re-enqueue a notebook in every controller of Notebooks (the
        resync a real manager runs): the port's kubelet keeps a Running
        pod's status, so nothing else wakes an idle notebook's culler."""
        for c in self.mgr.controllers:
            if c.for_kind == "Notebook":
                c.enqueue(self.Request(NS, name))

    def quiesce(self, rounds=4):
        for _ in range(rounds):
            self.cluster.step()
            try:
                self.mgr.drain()
            except (RuntimeError, self.store_mod.APIError):
                # under chaos a round may not quiesce, and an injected
                # fault in a watch map function surfaces here; the
                # level-triggered retriggers and the end state are what
                # the invariants gate (JAX's harness does the same)
                if self.injector is None:
                    raise
            # JAX's harness waits a moment a round, so that short
            # requeues (a zone heal's retry) come due
            _sleep(0.002)

    def warm_tick(self):
        """The warm-pool resync tick (normally requeue_after-driven) by
        hand, so the scenario never waits on wall-clock timers."""
        for pool in self.api.list("WarmPool"):
            self.warm.reconcile(self.Request(pool["metadata"]["namespace"],
                                             pool["metadata"]["name"]))

    def converge(self, pred, rounds=60, warm=False):
        for _ in range(rounds):
            if pred():
                return True
            self.cluster.step()
            self.mgr.drain()
            if warm:
                self.warm_tick()
            _sleep(0.002)
        return pred()

    # -- the session contract -------------------------------------------------

    def suspend(self, name, reason="user"):
        now = self.objects.now_rfc3339()
        self.api.patch("Notebook", name, {"metadata": {"annotations": {
            self.apis.STOP_ANNOTATION: now, self.apis.SUSPENDED_AT_ANNOTATION: now,
            self.apis.SUSPEND_REASON_ANNOTATION: reason}}}, NS)

    def resume(self, name):
        self.api.patch("Notebook", name, {"metadata": {"annotations": {
            self.apis.STOP_ANNOTATION: None, self.apis.SUSPENDED_AT_ANNOTATION: None,
            self.apis.SUSPEND_REASON_ANNOTATION: None,
            self.apis.RESUME_REQUESTED_ANNOTATION: self.objects.now_rfc3339()}}}, NS)

    def state(self, name):
        try:
            return self.api.get("Workload", name, NS).get("status", {}).get("state", "")
        except self.store_mod.NotFound:
            return None

    def ckpt(self, name):
        try:
            return self.api.get("SessionCheckpoint", name, NS)
        except self.store_mod.NotFound:
            return None

    def uid(self, name):
        return self.api.get("Notebook", name, NS)["metadata"]["uid"]

    def kernel(self, name):
        try:
            return self.cluster.get_session_state(NS, name)
        except self.store_mod.NotFound:
            return None

    def running(self, name):
        try:
            pod = self.api.get("Pod", f"{name}-0", NS)
        except self.store_mod.NotFound:
            return False
        return pod.get("status", {}).get("phase") == "Running"

    def bound(self, name):
        return [p for p in self.api.list("Pod", namespace=NS, label_selector={
            "matchLabels": {"scheduling.kubeflow.org/workload": name}})
            if p.get("spec", {}).get("nodeName")
            and p.get("status", {}).get("phase") not in ("Succeeded", "Failed")]

    # -- what is compared ------------------------------------------------------

    def observe(self) -> dict:
        """Workloads, pods, checkpoints (spec and status), the notebooks'
        session annotations and phase, the session state in each pod,
        and the events of the session manager, the scheduler, the warm
        pools and the culler's suspend / cull decisions."""
        ann_keys = (self.apis.STOP_ANNOTATION, self.apis.SUSPENDED_AT_ANNOTATION,
                    self.apis.SUSPEND_REASON_ANNOTATION,
                    self.apis.RESUME_REQUESTED_ANNOTATION,
                    self.warmup.WARM_FROM_ANNOTATION, self.warmup.STANDBY_SOURCE_ANNOTATION,
                    self.warmup.CLAIMED_BY_ANNOTATION, self.warmup.POOL_LABEL)
        stamped = (self.apis.STOP_ANNOTATION, self.apis.SUSPENDED_AT_ANNOTATION,
                   self.apis.RESUME_REQUESTED_ANNOTATION, self.warmup.CLAIMED_BY_ANNOTATION)
        notebooks = {}
        for nb in self.api.list("Notebook", namespace=NS):
            ann = dict(nb["metadata"].get("annotations") or {})
            ann.update(nb["metadata"].get("labels") or {})
            notebooks[nb["metadata"]["name"]] = {
                "annotations": {k: ("set" if k in stamped else ann[k])
                                for k in ann_keys if k in ann},
                "phase": (nb.get("status") or {}).get("phase", ""),
            }
        workloads = {w["metadata"]["name"]: {"spec": w["spec"], "status": w.get("status", {})}
                     for w in self.api.list("Workload")}
        pods = sorted((p["metadata"]["name"], p.get("spec", {}).get("nodeName", ""),
                       p.get("status", {}).get("phase", ""))
                      for p in self.api.list("Pod"))
        ckpts = {c["metadata"]["name"]: {"spec": c["spec"], "status": c.get("status", {})}
                 for c in self.api.list("SessionCheckpoint")}
        kernels = {}
        for p in self.api.list("Pod"):
            st = self.cluster.session_runtime.read_state(p)
            if st is not None:
                kernels[p["metadata"]["name"]] = st
        components = {"session-manager", self.component, "warm-pool-controller"}
        events = sorted({
            (f"{e['involvedObject']['kind']}/{e['involvedObject']['name']}", e["reason"],
             e["type"], e["message"])
            for e in self.api.list("Event")
            if e.get("source", {}).get("component") in components
            or e["reason"] in ("Suspended", "Culled")
        })
        return scrub({"notebooks": notebooks, "workloads": workloads, "pods": pods,
                      "checkpoints": ckpts, "kernels": kernels, "events": events})

    def metrics(self, *prefixes) -> dict:
        """Sample → value of the registry's families under ``prefixes``
        (histogram buckets and sums left out: they read the clock)."""
        out = {}
        for line in self.registry.exposition().splitlines():
            if line.startswith("#") or not line.startswith(prefixes):
                continue
            name, value = line.rsplit(" ", 1)
            if "_bucket" in name or name.split("{")[0].endswith("_sum"):
                continue
            out[name] = float(value)
        return out

    def close(self):
        for s in self.servers:
            s.shutdown()
            s.server_close()
        self.mgr.stop()
        self.store.close()


_OBSERVE = object()


def both(scenario, tmp_path, **env_kw):
    """Run ``scenario(env, log)`` on JAX's platform and the port's;
    ``log(key, value)`` records a value, ``log(key)`` the platform's
    ``observe()``. The port's log must equal JAX's carried across;
    returns ``(jax_log, port_log)``, the port's own and JAX's raw."""
    logs = []
    for port in (False, True):
        env, log = Env(port, tmp_path, **env_kw), {}

        def record(key, value=_OBSERVE, env=env, log=log):
            log[key] = scrub(env.observe() if value is _OBSERVE else value)

        try:
            scenario(env, record)
        finally:
            env.close()
        logs.append(log)
    want, got = to_port(logs[0]), logs[1]
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == want[key], key
    return logs[0], got


@pytest.fixture(autouse=True)
def _hold_clock(shared_clock):
    CLOCK_HOLDER[:] = [shared_clock]
    yield
    CLOCK_HOLDER.clear()


def _canonical_digest(state: dict) -> str:
    return hashlib.sha256(
        json.dumps(state, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


# ---------------------------------------------------------------------------
# checkpoint store


@pytest.mark.parametrize("backend", ["json", "torch"])
def test_checkpoint_store_roundtrip_bit_identical(tmp_path, backend):
    """The port's two backends write the receipts JAX's JSON backend
    writes (step, sha256 of the same canonical bytes, size); the torch
    backend (the payload as a uint8 tensor through the port's
    ``CheckpointManager``) runs here, where JAX's orbax parametrization
    needs orbax."""
    from odh_kubeflow_tpu.sessions.checkpoint import SessionCheckpointStore as JaxStore
    from odh_kubeflow_tpu_torch.sessions.checkpoint import SessionCheckpointStore

    store = SessionCheckpointStore(str(tmp_path / "port"), backend=backend)
    ref = JaxStore(str(tmp_path / "jax"), backend="json")
    state = {"cells": [1, "two", {"three": 3.0}], "execution_count": 7}
    receipt = store.save("uid-a", state)
    assert receipt == ref.save("uid-a", state)
    assert receipt["step"] == 0 and receipt["sizeBytes"] > 0
    assert receipt["digest"] == _canonical_digest(state)
    loaded, digest = store.load("uid-a")
    assert loaded == state
    assert digest == receipt["digest"]  # bit-identical receipt
    # re-suspend writes a new step; old steps are GC'd under max_to_keep
    receipt2 = store.save("uid-a", {"execution_count": 8})
    assert receipt2 == ref.save("uid-a", {"execution_count": 8})
    assert receipt2["step"] == 1
    loaded2, digest2 = store.load("uid-a")
    assert loaded2 == {"execution_count": 8} and digest2 == receipt2["digest"]
    store.save("uid-a", {"execution_count": 9})
    ref.save("uid-a", {"execution_count": 9})
    if backend == "torch":
        assert store._manager("uid-a").all_steps() == [1, 2]  # max_to_keep 2
    else:
        assert store._json_steps("uid-a") == ref._json_steps("uid-a") == [1, 2]
    assert store.exists("uid-a") and not store.exists("uid-b")
    assert store.delete("uid-a") is True
    assert not store.exists("uid-a")
    store.close()


def test_checkpoint_store_backends_and_auto():
    """``auto`` resolves to the torch backend (the port's manager always
    imports); an unknown backend is refused."""
    from odh_kubeflow_tpu_torch.sessions.checkpoint import SessionCheckpointStore

    assert SessionCheckpointStore("/unused", backend="auto").backend == "torch"
    assert SessionCheckpointStore("/unused", backend="json").backend == "json"
    with pytest.raises(ValueError, match="backend"):
        SessionCheckpointStore("/unused", backend="orbax")


def test_torch_backend_detects_flipped_payload_bytes(tmp_path):
    """A byte flipped inside the stored tensor reads back with another
    digest — the bit-identity check the resume path runs."""
    import torch

    from odh_kubeflow_tpu_torch.sessions.checkpoint import SessionCheckpointStore

    store = SessionCheckpointStore(str(tmp_path), backend="torch")
    receipt = store.save("u", {"k": "value"})
    path = tmp_path / "u" / "torch" / "0" / "state.pt"
    tree = torch.load(path, weights_only=True)
    tree["session"][6] ^= 1  # "value" -> "walue": still JSON, other bytes
    torch.save(tree, path)
    state, digest = store.load("u")
    assert state == {"k": "walue"} and digest != receipt["digest"]


# ---------------------------------------------------------------------------
# the culler: the Suspended event and the suspended-at annotation


@pytest.mark.parametrize("suspend_on_cull", [True, False])
def test_cull_suspends_or_stops(tmp_path, suspend_on_cull):
    def scenario(env, log):
        clock = {"now": 1_000_000.0}
        env.culler.now = lambda: clock["now"]
        env.create("nb")
        env.quiesce()
        log("admitted", env.state("nb"))
        clock["now"] += 7200.0  # > cull_idle_seconds
        env.kick("nb")
        env.quiesce()
        log("culled")

    _, got = both(scenario, tmp_path, culling=True, suspend_on_cull=suspend_on_cull)
    assert got["admitted"] == "Admitted"
    ann = got["culled"]["notebooks"]["nb"]["annotations"]
    reasons = {e[1] for e in got["culled"]["events"]}
    assert "kubeflow-resource-stopped" in ann
    if suspend_on_cull:
        assert ann["notebooks.kubeflow.org/suspend-reason"] == "cull"
        assert "Suspended" in reasons and "Culled" not in reasons
        assert got["culled"]["checkpoints"]["nb"]["status"]["phase"] == "Suspended"
    else:
        assert "notebooks.kubeflow.org/suspended-at" not in ann
        assert "Culled" in reasons and "Suspended" not in reasons


# ---------------------------------------------------------------------------
# suspend: snapshot before scale-down, reservation freed


def test_suspend_checkpoints_state_then_frees_gpus_and_quota(tmp_path):
    state = {"counter": 42, "cells": [1, 2]}

    def scenario(env, log):
        env.create("nb")
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", state)
        env.suspend("nb", reason="cull")
        env.quiesce()
        log("suspended")
        loaded, digest = env.store.load(env.uid("nb"))
        log("stored", [loaded, digest])
        env.create("nb2")
        env.quiesce()
        log("second")

    _, got = both(scenario, tmp_path, quota=4)
    ck = got["suspended"]["checkpoints"]["nb"]
    assert ck["status"]["phase"] == "Suspended" and ck["status"]["stateCaptured"] is True
    assert ck["spec"]["gpus"] == L4_GPUS
    assert "nb" not in got["suspended"]["workloads"] and got["suspended"]["pods"] == []
    assert got["stored"] == [state, ck["status"]["digest"]]
    assert ck["status"]["digest"] == _canonical_digest(state)
    assert got["second"]["workloads"]["nb2"]["status"]["state"] == "Admitted"


@pytest.mark.parametrize("grace", [600.0, 0.0])
def test_scaledown_holds_until_checkpoint_is_durable_or_grace_expires(tmp_path, grace):
    """Without a session manager completing the snapshot a suspend keeps
    the pods and the reservation; past the grace window it degrades to a
    plain stop (GPUs must not leak)."""
    def scenario(env, log):
        env.create("nb")
        env.quiesce()
        env.suspend("nb")
        env.quiesce()
        log("held", [len(env.bound("nb")), env.state("nb")])
        log("after")

    _, got = both(scenario, tmp_path, sessions=False, suspender=False,
                  suspend_grace_seconds=grace)
    assert got["held"] == ([1, "Admitted"] if grace else [0, None])


def test_suspend_while_queued_records_empty_checkpoint(tmp_path):
    def scenario(env, log):
        env.create("holder")
        env.quiesce()
        env.create("queued")
        env.mgr.drain()  # queued behind holder; no pods bound
        env.suspend("queued")
        env.quiesce()
        log("obs")

    _, got = both(scenario, tmp_path)
    status = got["obs"]["checkpoints"]["queued"]["status"]
    assert status["phase"] == "Suspended" and status["stateCaptured"] is False
    assert status["digest"] == _canonical_digest({})
    assert any(e[1] == "SessionStateUnavailable" for e in got["obs"]["events"])


def test_resuspend_before_pod_runs_carries_checkpoint_forward(tmp_path):
    state = {"precious": True, "step": 9}

    def scenario(env, log):
        env.create("nb")
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", state)
        env.suspend("nb")
        env.quiesce()
        log("first")
        env.resume("nb")
        env.mgr.drain()  # no cluster.step: Resuming, pod never Running
        env.suspend("nb")
        env.quiesce()
        log("second")
        env.resume("nb")
        env.quiesce(rounds=8)
        log("kernel", env.kernel("nb"))

    _, got = both(scenario, tmp_path)
    first = got["first"]["checkpoints"]["nb"]["status"]
    second = got["second"]["checkpoints"]["nb"]["status"]
    assert first["stateCaptured"] is True
    assert second["phase"] == "Suspended" and second["stateCaptured"] is True
    assert second["digest"] == first["digest"]  # carried, not emptied
    assert got["kernel"] == state


# ---------------------------------------------------------------------------
# resume: warm restore before ready


def test_resume_restores_bit_identical_state_before_ready(tmp_path):
    state = {"weights_hash": "abc123", "step": 1337, "history": list(range(16))}

    def scenario(env, log):
        env.create("nb")
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", state)
        env.suspend("nb")
        env.quiesce()
        log("suspended")
        env.resume("nb")
        env.quiesce(rounds=6)
        log("resumed")
        log("metrics", env.metrics("session_"))

    _, got = both(scenario, tmp_path)
    assert "nb" not in got["suspended"]["workloads"]
    r = got["resumed"]
    assert r["workloads"]["nb"]["status"]["state"] == "Admitted"
    assert r["checkpoints"]["nb"]["status"]["phase"] == "Restored"
    assert r["kernels"]["nb-0"] == state
    assert r["notebooks"]["nb"]["phase"] == ""
    assert got["metrics"]["session_resume_seconds_count"] == 1
    assert got["metrics"]['session_resumes_total{result="restored"}'] == 1
    assert any(e[1] == "Resumed" for e in r["events"])


def test_resume_of_notebook_deleted_while_suspended_gcs_checkpoint(tmp_path):
    def scenario(env, log):
        env.create("nb")
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", {"x": 1})
        env.suspend("nb")
        env.quiesce()
        uid = env.uid("nb")
        log("stored", env.store.exists(uid))
        env.api.delete("Notebook", "nb", NS)
        env.quiesce()
        log("gone", [env.ckpt("nb"), env.store.exists(uid)])

    _, got = both(scenario, tmp_path)
    assert got["stored"] is True and got["gone"] == [None, False]


def test_a_recreated_notebook_drops_the_old_generations_checkpoint(tmp_path):
    """A same-named notebook with a fresh uid (the delete coalesced with
    the recreate) never resumes the deleted one's checkpoint, and the
    port's manager drops the stale generation's object and bytes, then
    suspends the new notebook with a checkpoint of its own. JAX's
    manager reads the checkpoint through ``checkpoint_of``, which hides
    the stale one, so it never drops it: the stale object and bytes
    stay, and the new notebook's suspend cannot write
    its checkpoint (AlreadyExists), so its phase flips between
    Suspending and Suspended without end (a fault of the reference, not
    copied)."""
    def recreate(env):
        env.create("nb")
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", {"old": True})
        env.suspend("nb")
        env.quiesce()
        old = env.uid("nb")
        env.api.delete("Notebook", "nb", NS)
        env.create("nb")
        env.mgr.drain()
        ck = env.ckpt("nb")
        stale = [ck is not None and ck["spec"]["notebookUID"] == old, env.store.exists(old)]
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", {"new": True})
        env.suspend("nb")
        return stale

    jax_env, port_env = Env(False, tmp_path), Env(True, tmp_path)
    try:
        assert recreate(jax_env) == [True, True]
        with pytest.raises(RuntimeError, match="did not quiesce"):
            jax_env.quiesce()
        assert recreate(port_env) == [False, False]
        port_env.quiesce()
        ck = port_env.ckpt("nb")
        assert ck["spec"]["notebookUID"] == port_env.uid("nb")
        assert ck["status"]["phase"] == "Suspended"
        assert ck["status"]["digest"] == _canonical_digest({"new": True})
    finally:
        jax_env.close()
        port_env.close()


# ---------------------------------------------------------------------------
# the scheduler: suspendable victims first, suspend vs evict metrics


def test_preemption_suspends_suspendable_victim_instead_of_hard_kill(tmp_path):
    def scenario(env, log):
        env.priority_classes()
        env.create("batch", priority_class="tpu-batch")
        env.quiesce()
        env.cluster.set_session_state(NS, "batch", {"loss": 0.5})
        env.create("urgent", priority_class="tpu-interactive")
        env.quiesce(rounds=6)
        log("obs")
        log("metrics", env.metrics("workload_preemptions_total", "session_suspends_total"))

    _, got = both(scenario, tmp_path)
    obs = got["obs"]
    assert obs["workloads"]["urgent"]["status"]["state"] == "Admitted"
    ck = obs["checkpoints"]["batch"]["status"]
    assert ck["phase"] == "Suspended" and ck["stateCaptured"] is True
    assert ck["digest"] == _canonical_digest({"loss": 0.5})
    assert obs["notebooks"]["batch"]["annotations"][
        "notebooks.kubeflow.org/suspend-reason"] == "preempt"
    assert got["metrics"] == {'workload_preemptions_total{reason="suspend"}': 1.0,
                              'session_suspends_total{reason="preempt"}': 1.0}


def test_hard_preemption_without_suspender_counts_evict(tmp_path):
    def scenario(env, log):
        env.priority_classes()
        env.create("batch", priority_class="tpu-batch")
        env.quiesce()
        env.create("urgent", priority_class="tpu-interactive")
        env.quiesce()
        log("states", [env.state("urgent"), env.state("batch")])
        log("metrics", env.metrics("workload_preemptions_total"))

    _, got = both(scenario, tmp_path, suspender=False, sessions=False)
    assert got["states"] == ["Admitted", "Pending"]
    assert got["metrics"] == {'workload_preemptions_total{reason="evict"}': 1.0}


def test_busy_session_is_not_reclaimed_at_equal_priority(tmp_path):
    def scenario(env, log):
        env.create("busy")
        env.quiesce()
        env.api.patch("Notebook", "busy", {"metadata": {"annotations": {
            env.apis.LAST_ACTIVITY_ANNOTATION: time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time()))}}}, NS)
        env.create("newcomer")
        env.quiesce(rounds=6)
        log("obs")

    _, got = both(scenario, tmp_path, reclaim_idle_seconds=3600.0)
    assert got["obs"]["workloads"]["busy"]["status"]["state"] == "Admitted"
    assert got["obs"]["workloads"]["newcomer"]["status"]["state"] == "Pending"
    assert "notebooks.kubeflow.org/suspended-at" not in got["obs"]["notebooks"]["busy"][
        "annotations"]


def test_idle_session_yields_its_gpus_at_equal_priority(tmp_path):
    """The reclaim itself: an idle session suspends for an equal-priority
    newcomer (``_plan_suspend_reclaim``); the newcomer waits on
    ``AwaitingSuspend`` until the checkpoint lands, then admits."""
    def scenario(env, log):
        env.create("idle")
        env.quiesce()
        env.cluster.set_session_state(NS, "idle", {"idle": 1})
        env.create("newcomer")
        env.mgr.drain()
        log("waiting", env.state("newcomer"))
        env.quiesce(rounds=6)
        log("obs")

    _, got = both(scenario, tmp_path, quota=4, factor=2)
    obs = got["obs"]
    assert obs["workloads"]["newcomer"]["status"]["state"] == "Admitted"
    assert obs["checkpoints"]["idle"]["status"]["phase"] == "Suspended"
    assert any("yielding its GPUs" in e[3] for e in obs["events"])


def test_high_priority_preempts_through_full_session_cap(tmp_path):
    def scenario(env, log):
        env.priority_classes()
        env.create("parked")
        env.quiesce()
        env.cluster.set_session_state(NS, "parked", {"p": 1})
        env.suspend("parked")
        env.quiesce()
        env.create("batch", priority_class="tpu-batch")
        env.quiesce(rounds=6)
        log("batch", env.state("batch"))
        env.create("urgent", priority_class="tpu-interactive")
        env.quiesce(rounds=8)
        log("obs")
        log("metrics", env.metrics("workload_preemptions_total"))

    _, got = both(scenario, tmp_path, quota=4, factor=2)
    assert got["batch"] == "Admitted"
    obs = got["obs"]
    assert obs["workloads"]["urgent"]["status"]["state"] == "Admitted"
    assert obs["workloads"]["batch"]["status"]["state"] == "Pending"
    assert obs["checkpoints"]["parked"]["status"]["phase"] == "Suspended"
    assert got["metrics"] == {'workload_preemptions_total{reason="evict"}': 1.0}


# ---------------------------------------------------------------------------
# oversubscription


def test_oversubscribed_pool_admits_more_sessions_than_inventory(tmp_path):
    """ONE L4 node of 4 GPUs, hard=4, factor=3: three 4-GPU sessions are
    admitted over time (12 committed GPUs) with idle ones suspending to
    make room; the fourth hits the session cap; every suspended session
    resumes with its exact state."""
    def scenario(env, log):
        states = {}
        for i in (1, 2, 3):
            name = f"nb{i}"
            env.create(name)
            env.quiesce(rounds=8)
            log(f"admitted-{name}", env.state(name))
            states[name] = {"owner": name, "payload": list(range(i))}
            env.cluster.set_session_state(NS, name, states[name])
        log("three")
        env.create("nb4")
        env.quiesce(rounds=4)
        log("fourth", env.api.get("Workload", "nb4", NS)["status"])
        env.api.delete("Notebook", "nb4", NS)
        for name in sorted(states):
            env.resume(name)
            env.quiesce(rounds=10)
            log(f"resumed-{name}", [env.state(name), env.kernel(name),
                                    env.ckpt(name)["status"]["phase"]])
        log("gauge", env.metrics("suspended_sessions"))

    _, got = both(scenario, tmp_path, quota=4, factor=3)
    assert [got[f"admitted-nb{i}"] for i in (1, 2, 3)] == ["Admitted"] * 3
    suspended = [c for c in got["three"]["checkpoints"].values()
                 if c["status"]["phase"] == "Suspended"]
    assert len(suspended) == 2
    assert sum(c["spec"]["gpus"] for c in suspended) + L4_GPUS == 12
    fourth = got["fourth"]
    assert fourth["state"] == "Pending" and fourth["reason"] == "SessionCapExhausted"
    assert "oversubscription factor 3" in fourth["message"]
    for i in (1, 2, 3):
        assert got[f"resumed-nb{i}"] == ["Admitted", {"owner": f"nb{i}",
                                                       "payload": list(range(i))},
                                          "Restored"]


def test_suspended_sessions_do_not_hold_quota_without_factor(tmp_path):
    def scenario(env, log):
        env.create("first")
        env.quiesce()
        env.suspend("first")
        env.quiesce()
        env.create("second")
        env.quiesce()
        log("second", env.state("second"))

    _, got = both(scenario, tmp_path, quota=4, pools=2)
    assert got["second"] == "Admitted"


# ---------------------------------------------------------------------------
# the JWA surface


def _jwa_call(env, jwa, method, path, body=None):
    import urllib.error
    import urllib.request

    if not env.servers:
        env.servers.append(jwa.app.serve("127.0.0.1", 0))
    port = env.servers[0].server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"kubeflow-userid": "alice@example.com", "Content-Type": "application/json",
                 "Cookie": "XSRF-TOKEN=t", "X-XSRF-TOKEN": "t"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


@pytest.fixture
def dev_mode(monkeypatch):
    from odh_kubeflow_tpu.web import crud_backend as jax_crud
    from odh_kubeflow_tpu_torch.web import crud_backend as port_crud

    for mod in (jax_crud, port_crud):
        monkeypatch.setattr(mod, "DEV_MODE", True)


def test_jwa_distinguishes_suspended_from_stopped_and_resumes(tmp_path, dev_mode):
    def scenario(env, log):
        jwa = env.JupyterWebApp(env.api)
        env.create("nb")
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", {"k": "v"})
        path = f"/api/namespaces/{NS}/notebooks/nb"
        log("stop", _jwa_call(env, jwa, "PATCH", path, {"stopped": True})[0])
        env.quiesce()
        log("stopped_row", jwa.notebook_row(env.api.get("Notebook", "nb", NS))["status"])
        _jwa_call(env, jwa, "PATCH", path, {"stopped": False})
        env.quiesce(rounds=6)
        env.cluster.set_session_state(NS, "nb", {"k": "v2"})
        log("suspend", _jwa_call(env, jwa, "PATCH", path, {"stopped": True, "suspend": True})[0])
        env.quiesce()
        log("suspended_row", jwa.notebook_row(env.api.get("Notebook", "nb", NS))["status"])
        log("checkpoint_row", jwa._checkpoint_row(env.api.get("Notebook", "nb", NS)))
        log("resume", _jwa_call(env, jwa, "POST", f"{path}/resume"))
        env.quiesce(rounds=6)
        log("kernel", env.kernel("nb"))
        log("ready_row", jwa.notebook_row(env.api.get("Notebook", "nb", NS))["status"])
        log("obs")

    _, got = both(scenario, tmp_path, quota=4, factor=2)
    assert got["stop"] == 200 and got["stopped_row"]["phase"] == "stopped"
    assert got["suspend"] == 200
    assert got["suspended_row"]["phase"] == "suspended"
    assert "resume" in got["suspended_row"]["message"]
    assert got["checkpoint_row"]["phase"] == "Suspended"
    assert got["checkpoint_row"]["digest"] == _canonical_digest({"k": "v2"})
    assert got["resume"][0] == 200 and got["resume"][1]["resume"] == "warm"
    assert got["kernel"] == {"k": "v2"}
    assert got["ready_row"]["phase"] == "ready"
    assert "notebooks.kubeflow.org/resume-requested-at" in got["obs"]["notebooks"]["nb"][
        "annotations"]


def test_duplicate_suspend_patch_keeps_epoch_and_checkpoint(tmp_path, dev_mode):
    def scenario(env, log):
        jwa = env.JupyterWebApp(env.api)
        env.create("nb")
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", {"keep": "me"})
        path = f"/api/namespaces/{NS}/notebooks/nb"
        _jwa_call(env, jwa, "PATCH", path, {"stopped": True, "suspend": True})
        env.quiesce()
        first_at = env.api.get("Notebook", "nb", NS)["metadata"]["annotations"][
            env.apis.SUSPENDED_AT_ANNOTATION]
        first = env.ckpt("nb")["status"]
        log("second", _jwa_call(env, jwa, "PATCH", path, {"stopped": True, "suspend": True})[0])
        env.quiesce(rounds=6)
        second = env.ckpt("nb")["status"]
        log("same", [env.api.get("Notebook", "nb", NS)["metadata"]["annotations"][
            env.apis.SUSPENDED_AT_ANNOTATION] == first_at,
            second["digest"] == first["digest"],
            second["suspendedAt"] == first["suspendedAt"]])
        log("obs")

    _, got = both(scenario, tmp_path, quota=4, factor=2)
    assert got["second"] == 200 and got["same"] == [True, True, True]
    assert got["obs"]["pods"] == []  # no resurrection


def test_jwa_quota_block_surfaces_oversubscription(tmp_path, dev_mode):
    def scenario(env, log):
        jwa = env.JupyterWebApp(env.api)
        env.create("nb")
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", {"s": 1})
        env.suspend("nb")
        env.quiesce()
        env.create("nb2")
        env.quiesce()
        quota = jwa.gpu_quota(NS) if env.port else jwa.tpu_quota(NS)
        log("quota", quota)

    _, got = both(scenario, tmp_path, quota=4, factor=2)
    q = got["quota"]
    assert q["oversubscriptionFactor"] == "2" and q["sessionCap"] == "8"
    assert q["suspended"] == "4" and int(q["committed"]) == int(q["used"]) + 4


# ---------------------------------------------------------------------------
# the property: seeded suspend/resume under oversubscription, decision by
# decision against JAX's


def _suspend_resume_property(env, log):
    rng = random.Random(SEED)
    expected: dict = {}
    live: set = set()
    version = counter = 0

    def check_invariants():
        used: dict = {}
        for pod in env.api.list("Pod"):
            node = pod.get("spec", {}).get("nodeName")
            if not node or pod.get("status", {}).get("phase") in ("Succeeded", "Failed"):
                continue
            limits = pod["spec"]["containers"][0].get("resources", {}).get("limits", {})
            used[node] = used.get(node, 0) + float(limits.get(env.resource, 0))
        assert all(u <= 4 for u in used.values()), used
        active = 0
        for wl in env.api.list("Workload"):
            name = wl["metadata"]["name"]
            nodes = wl["spec"].get("nodes", wl["spec"].get("hosts"))
            assert len(env.bound(name)) in (0, nodes), f"partial gang {name}"
            if wl.get("status", {}).get("state") == "Admitted":
                active += wl["spec"].get("gpus", wl["spec"].get("chips"))
        assert active <= 8
        committed = active + sum(
            c["spec"].get("gpus", c["spec"].get("chips"))
            for c in env.api.list("SessionCheckpoint", namespace=NS)
            if c.get("status", {}).get("phase") in ("Suspended", "Resuming"))
        assert committed <= 24
        for name in live:
            nb = env.api.get("Notebook", name, NS)
            if env.apis.SUSPENDED_AT_ANNOTATION not in nb["metadata"].get("annotations", {}):
                continue
            ck = env.ckpt(name)
            if ck is None or ck["status"].get("phase") != "Suspended" or not ck["status"].get(
                    "stateCaptured"):
                continue
            loaded = env.store.load(nb["metadata"]["uid"])
            assert loaded is not None and loaded[1] == ck["status"]["digest"]
            if name in expected:
                assert loaded[0] == expected[name]

    for step in range(22):
        op = rng.choice(["create", "suspend", "resume", "touch"])
        if op == "create" and len(live) < 5:
            counter += 1
            name = f"nb{counter}"
            env.create(name)
            live.add(name)
        elif op == "suspend" and live:
            name = rng.choice(sorted(live))
            ann = env.api.get("Notebook", name, NS)["metadata"].get("annotations", {})
            if env.apis.SUSPENDED_AT_ANNOTATION not in ann:
                env.suspend(name)
        elif op == "resume" and live:
            name = rng.choice(sorted(live))
            ann = env.api.get("Notebook", name, NS)["metadata"].get("annotations", {})
            if env.apis.STOP_ANNOTATION in ann:
                env.resume(name)
        elif op == "touch" and live:
            name = rng.choice(sorted(live))
            ann = env.api.get("Notebook", name, NS)["metadata"].get("annotations", {})
            if env.running(name) and env.apis.SUSPENDED_AT_ANNOTATION not in ann:
                version += 1
                expected[name] = {"owner": name, "version": version}
                env.cluster.set_session_state(NS, name, expected[name])
        env.quiesce(rounds=3)
        check_invariants()
        log(f"step-{step}")
    if env.injector is not None:  # the weather clears: everything converges
        env.injector.set_schedule(env.calm_schedule)
        for _ in range(6):
            env.quiesce(rounds=2)
        check_invariants()
    order = sorted(live)
    rng.shuffle(order)
    for name in order:
        env.resume(name)
        for _ in range(12):
            env.quiesce(rounds=2)
            ck = env.ckpt(name)
            phase = ck["status"].get("phase", "") if ck else ""
            if env.state(name) == "Admitted" and phase in ("", "Restored"):
                break
        log(f"final-{name}", [env.state(name), env.kernel(name) if name in expected else None])
        if name in expected:
            assert env.kernel(name) == expected[name]
        env.suspend(name)
        env.quiesce(rounds=3)
        check_invariants()


def test_property_random_suspend_resume_oversubscribed(tmp_path):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, got = both(_suspend_resume_property, tmp_path, quota=8, factor=3, pools=2)
    finally:
        torch.set_num_threads(threads)
    finals = [v for k, v in got.items() if k.startswith("final-")]
    assert finals and all(v[0] == "Admitted" for v in finals)


def test_property_random_suspend_resume_under_chaos(tmp_path):
    """The property with seeded conflicts / 429 / 5xx on the controllers'
    API path: no session lost, no GPU double-booked, no checkpoint
    corrupted, in either package; every session resumes admitted with
    its state."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    finals = []
    try:
        for port in (False, True):
            env, log = Env(port, tmp_path / f"chaos-{port}", quota=8, factor=3, pools=2,
                           chaos=lambda f: f.FaultSchedule(conflict=0.04,
                                                           too_many_requests=0.03,
                                                           server_error=0.02)), {}
            try:
                _suspend_resume_property(env, lambda key, value=None, log=log:
                                         log.__setitem__(key, value))
            finally:
                env.close()
            finals.append(sorted((k, v[0]) for k, v in log.items() if k.startswith("final-")))
            fired = [line for line in env.registry.exposition().splitlines()
                     if line.startswith("faults_injected_total{")]
            assert fired, "the chaos schedule injected nothing"
    finally:
        torch.set_num_threads(threads)
    assert finals[0] and all(state == "Admitted" for f in finals for _, state in f)
    assert [k for k, _ in finals[1]] == [k for k, _ in finals[0]]


# ---------------------------------------------------------------------------
# the receipts audit and the metric families


def test_verify_receipts_flags_missing_and_corrupt_bytes(tmp_path):
    def scenario(env, log):
        for name in ("a", "b", "c"):
            env.create(name)
        env.quiesce()
        for name in ("a", "b", "c"):
            if env.running(name):
                env.cluster.set_session_state(NS, name, {"n": name})
            env.suspend(name)
            env.quiesce()
        log("clean", [(r["key"], r["ok"], r["detail"])
                      for r in env.session_mgr.verify_receipts()])
        uid_b, uid_c = env.uid("b"), env.uid("c")
        env.store.delete(uid_b)
        env.store.save(uid_c, {"tampered": True})
        log("broken", sorted((r["key"], r["ok"], r["detail"][:20])
                             for r in env.session_mgr.verify_receipts()))

    _, got = both(scenario, tmp_path, pools=3)
    assert got["clean"] == [(f"{NS}/{n}", True, "bit-identical") for n in ("a", "b", "c")]
    assert [r[:2] for r in got["broken"]] == [(f"{NS}/a", True), (f"{NS}/b", False),
                                               (f"{NS}/c", False)]


def test_session_metric_families_and_naming_lint(tmp_path):
    from odh_kubeflow_tpu.utils.prometheus import lint_metric_names

    def scenario(env, log):
        env.create("nb")
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", {"a": 1})
        env.suspend("nb", reason="cull")
        env.quiesce()
        env.resume("nb")
        env.quiesce(rounds=6)
        log("lint", lint_metric_names(env.registry))
        log("metrics", env.metrics("session_", "suspended_sessions"))

    _, got = both(scenario, tmp_path)
    assert got["lint"] == []
    m = got["metrics"]
    assert m['session_suspends_total{reason="cull"}'] == 1
    assert m['session_resumes_total{result="restored"}'] == 1
    assert m["session_suspend_seconds_count"] == 1 and m["session_resume_seconds_count"] == 1
    assert m["session_checkpoint_size_bytes"] == len(b'{"a":1}')


def test_torch_backend_drives_the_whole_suspend_resume(tmp_path):
    """The platform over the port's default backend (the torch
    ``CheckpointManager``): the same receipts, checkpoint and restored
    kernel as JAX's JSON backend."""
    state = {"cells": ["import torch"], "n": 3}

    def scenario(env, log):
        env.create("nb")
        env.quiesce()
        env.cluster.set_session_state(NS, "nb", state)
        env.suspend("nb")
        env.quiesce()
        log("suspended")
        env.resume("nb")
        env.quiesce(rounds=6)
        log("resumed")

    logs = []
    for port in (False, True):
        env, log = Env(port, tmp_path, backend="torch" if port else "json"), {}
        try:
            scenario(env, lambda k, v=_OBSERVE, env=env, log=log: log.__setitem__(
                k, scrub(env.observe() if v is _OBSERVE else v)))
        finally:
            env.close()
        logs.append(log)
    assert to_port(logs[0]) == logs[1]
    assert logs[1]["resumed"]["kernels"]["nb-0"] == state

