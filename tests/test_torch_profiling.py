"""The port's profiling (``utils/profiling.py`` on ``torch.profiler``)
against the JAX package's (the XLA profiler), on the CPU, and the
tensorboard controller's half of the path that serves it.

``capture_trace`` around a training step of a 2-layer Llama gives one
session in TensorBoard's profile-plugin layout with a non-empty Chrome
trace, as JAX's does around a jitted step (JAX's
``tests/test_profiling.py``); there is no ``.xplane.pb`` on a GPU, so the
port's session holds the trace file only. A CUDA capture that records no
kernel raises and leaves no session. The kernel-startup snippet is valid
Python, never raises into the kernel and starts the capture server,
which answers an on-demand capture. A Tensorboard on the trace PVC gets a
Deployment mounting it in both packages.
"""

from __future__ import annotations

import gzip
import json
import os
import socket

import pytest
import torch

from odh_kubeflow_tpu_torch.utils import profiling


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _session_files(logdir):
    sessions = [os.path.basename(s) for s in profiling.trace_sessions(logdir)]
    return sessions, sorted(os.listdir(profiling.trace_sessions(logdir)[0])) if sessions else []


def test_capture_trace_around_a_training_step_gives_one_servable_session(tmp_path, one_thread):
    import jax
    import jax.numpy as jnp

    from odh_kubeflow_tpu.utils import profiling as jax_profiling
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
    from odh_kubeflow_tpu_torch.utils.prometheus import Registry

    # JAX's: a jitted step under the XLA profiler
    jax_logs = str(tmp_path / "jax")
    f = jax.jit(lambda x: (x @ x.T).sum())
    x = jnp.ones((64, 64), jnp.float32)
    float(f(x))
    with jax_profiling.capture_trace(jax_logs):
        float(f(x))
    # the port's: a 2-layer Llama LoRA step under torch.profiler
    logs = str(tmp_path / "torch")
    trainer = Trainer(LlamaConfig.tiny(), TrainConfig(warmup_steps=1, total_steps=4),
                      LoraConfig(rank=2), device="cpu", metrics_registry=Registry())
    batch = trainer.make_fake_batch(2, 64)
    float(trainer.train_step(batch)["loss"])
    with profiling.capture_trace(logs) as prof:
        loss = float(trainer.train_step(batch)["loss"])
    assert torch.isfinite(torch.tensor(loss)) and prof is not None

    jax_sessions, jax_files = _session_files(jax_logs)
    sessions, files = _session_files(logs)
    assert len(sessions) == len(jax_sessions) == 1
    host = socket.gethostname()
    assert files == [f"{host}.pt.trace.json.gz"]
    assert f"{host}.trace.json.gz" in jax_files  # the same plugin glob finds both
    assert any(fn.endswith(".xplane.pb") for fn in jax_files)  # XLA's own file
    events = profiling.latest_trace_events(logs)
    assert events and jax_profiling.latest_trace_events(jax_logs)
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names), sorted(names)[:20]
    # the plugin layout: logdir/plugins/profile/<session>/<file>, nothing else
    assert sorted(os.listdir(os.path.join(logs, "plugins", "profile"))) == sessions
    with gzip.open(os.path.join(profiling.trace_sessions(logs)[0], files[0]), "rt") as fh:
        assert json.load(fh)["traceEvents"] == events


def test_a_cuda_capture_without_a_kernel_raises_and_writes_no_session(tmp_path, monkeypatch):
    """A capture on the card in which no CUDA kernel ran (here: the CPU
    taken for a card, whose profile has no kernel events) raises; its temp
    directory goes, so no empty session can pass for a profile."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    logs = str(tmp_path / "logs")
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        with profiling.capture_trace(logs):
            torch.ones(8).sum()
    assert profiling.trace_sessions(logs) == []
    assert os.listdir(os.path.join(logs, "plugins", "profile")) == []
    assert profiling.kernel_events([{"cat": "kernel", "ph": "X", "name": "flash_fwd_kernel"},
                                    {"cat": "cuda_runtime", "ph": "X", "name": "cudaLaunch"},
                                    {"cat": "kernel", "ph": "M"}]) == [
        {"cat": "kernel", "ph": "X", "name": "flash_fwd_kernel"}]


def test_kernel_startup_snippet_is_guarded_and_starts_the_capture_server(tmp_path, monkeypatch):
    import urllib.request

    from odh_kubeflow_tpu.utils import profiling as jax_profiling

    snippet = profiling.kernel_startup_snippet()
    compile(snippet, "<startup>", "exec")
    assert profiling.AUTOSTART_ENV in snippet and "except Exception" in snippet
    # the JAX snippet's guard, under the port's own names
    assert snippet.count("try:") == jax_profiling.kernel_startup_snippet().count("try:") == 1
    assert "odh_kubeflow_tpu_torch.utils" in snippet and "TPU_" not in snippet

    monkeypatch.setattr(profiling, "DEFAULT_PORT", 0)
    monkeypatch.setenv(profiling.AUTOSTART_ENV, "false")
    exec(compile(snippet, "<startup>", "exec"), {})
    assert not profiling.server_started()
    monkeypatch.setenv(profiling.AUTOSTART_ENV, "true")
    monkeypatch.setenv(profiling.LOGDIR_ENV, str(tmp_path / "logs"))
    exec(compile(snippet, "<startup>", "exec"), {})
    try:
        assert profiling.server_started()
        server = profiling.start_server()  # a second start: the same server
        assert server is profiling._STATE["server"]
        port = profiling._STATE["port"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/capture", method="POST",
            data=json.dumps({"duration_ms": 20}).encode(),
            headers={"Cookie": "XSRF-TOKEN=t", "X-XSRF-TOKEN": "t",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 201
            session = json.loads(r.read())["session"]
        assert profiling.trace_sessions(str(tmp_path / "logs")) == [session]
        # a broken startup (the port taken) never raises into the kernel
        monkeypatch.setattr(profiling, "_STATE", {})
        monkeypatch.setattr(profiling, "DEFAULT_PORT", port)
        exec(compile(snippet, "<startup>", "exec"), {})
        assert not profiling.server_started()
    finally:
        monkeypatch.undo()
        profiling.stop_server()


def test_tensorboard_controller_serves_the_trace_volume():
    """A Tensorboard on ``pvc://trace-pvc/logs`` materialises a Deployment
    that mounts the claim and serves the subdirectory the traces land
    in, in both packages (JAX's ``tests/test_profiling.py``)."""
    seen = []
    for port in (False, True):
        pkg = "odh_kubeflow_tpu_torch" if port else "odh_kubeflow_tpu"
        import importlib

        apis = importlib.import_module(f"{pkg}.apis")
        Manager = importlib.import_module(f"{pkg}.controllers.runtime").Manager
        Controller = importlib.import_module(f"{pkg}.controllers.tensorboard").TensorboardController
        api = importlib.import_module(f"{pkg}.machinery.store").APIServer()
        apis.register_crds(api)
        mgr = Manager(api)
        Controller(api).register(mgr)
        api.create({"apiVersion": "tensorboard.kubeflow.org/v1alpha1", "kind": "Tensorboard",
                    "metadata": {"name": "gpu-traces", "namespace": "team-a"},
                    "spec": {"logspath": "pvc://trace-pvc/logs"}})
        mgr.drain()
        spec = api.get("Deployment", "gpu-traces", "team-a")["spec"]["template"]["spec"]
        seen.append(([v.get("persistentVolumeClaim", {}).get("claimName")
                      for v in spec.get("volumes", [])],
                     spec["containers"][0]["volumeMounts"], spec["containers"][0]["args"]))
    assert seen[1] == seen[0]
    claims, mounts, args = seen[1]
    assert claims == ["trace-pvc"] and mounts == [{"name": "logs", "mountPath": "/logs"}]
    assert args[0] == "--logdir=/logs/logs"
