"""The GPU activity agent (``images/jupyter-pytorch-cuda/gpu-activity-agent``)
as a real process, against the JAX package's TPU agent on the same
scenarios, on the CPU.

The agent serves ``/api/gpu/activity`` (JAX's ``/api/tpu/activity``
through ``apis.ACCELERATOR_MAPPING``) with JAX's keys. Its device tier
reads NVML's utilization through ``ctypes``; here a stand-in
``libnvidia-ml.so`` built from C in the test's directory plays the
library, and a script named ``nvidia-smi`` on ``PATH`` plays the tool
when the library cannot load. The proc tier: a temp file is the device
(``GPU_DEVICE_GLOBS``), a spawned process holding it open and burning
CPU the running program, as in JAX's ``tests/test_tpu_activity_agent.py``.

- the device tier wins over the proc tier (NVML first, then
  ``nvidia-smi``; a mean over the GPUs, several reads an interval), and
  falls back to the proc tier when the device stops answering;
- a busy holder counts as active for both agents, an idle one for
  neither;
- the culler (each package's, on its own agent) spares the busy holder.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from odh_kubeflow_tpu_torch.apis import ACCELERATOR_MAPPING

REPO = pathlib.Path(__file__).resolve().parent.parent
AGENTS = {
    "jax": (REPO / "images" / "jupyter-jax-tpu" / "tpu-activity-agent", "TPU", "/api/tpu/activity"),
    "port": (REPO / "images" / "jupyter-pytorch-cuda" / "gpu-activity-agent", "GPU",
             ACCELERATOR_MAPPING["/api/tpu/activity"]),
}
KEYS = {"duty_cycle_pct", "source", "last_active", "holders", "devices", "interval_s"}

FAKE_NVML = r"""
#include <stdio.h>
typedef struct { unsigned int gpu; unsigned int memory; } util_t;
static const char *path(void) { return "@DUTY@"; }
static int read_duties(unsigned int *out, int max) {
  FILE *f = fopen(path(), "r"); int n = 0; unsigned int v;
  if (!f) return -1;
  while (n < max && fscanf(f, "%u", &v) == 1) out[n++] = v;
  fclose(f); return n;
}
int nvmlInit_v2(void) { return 0; }
int nvmlDeviceGetCount_v2(unsigned int *count) {
  unsigned int d[16]; int n = read_duties(d, 16);
  if (n <= 0) return 999; *count = (unsigned int)n; return 0;
}
int nvmlDeviceGetHandleByIndex_v2(unsigned int i, void **handle) {
  *handle = (void *)(unsigned long)(i + 1); return 0;
}
int nvmlDeviceGetUtilizationRates(void *handle, util_t *u) {
  unsigned int d[16]; int n = read_duties(d, 16); unsigned long i = (unsigned long)handle - 1;
  if (n <= (int)i) return 999; u->gpu = d[i]; u->memory = 0; return 0;
}
"""


def _start(which: str, tmp_path, **env):
    """Run one package's agent on an ephemeral port with a fake device
    glob and fast sampling; returns (process, URL)."""
    path, tag, route = AGENTS[which]
    dev_glob = str(tmp_path / "dev" / ("accel*" if which == "jax" else "nvidia[0-9]*"))
    base = {f"{tag}_AGENT_PORT": "0", f"{tag}_AGENT_INTERVAL": "0.3",
            f"{tag}_DEVICE_GLOBS": dev_glob}
    if which == "jax":
        base["TPU_METRICS_URL"] = ""  # hermetic: no host metrics endpoint
    else:
        base.update(GPU_AGENT_NVML_LIB="", GPU_AGENT_SMI="")  # device tier off by default
    proc = subprocess.Popen([sys.executable, str(path)], env={**os.environ, **base, **env},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()
    m = re.search(r":(\d+)$", line.strip())
    assert m, f"agent did not report its port: {line!r}"
    return proc, f"http://127.0.0.1:{m.group(1)}{route}"


def _stop(proc):
    proc.terminate()
    proc.wait(timeout=10)


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.loads(r.read().decode())


def _wait(url, pred, seconds=30.0):
    deadline = time.time() + seconds
    state = _get(url)
    while time.time() < deadline and not pred(state):
        time.sleep(0.2)
        state = _get(url)
    return state


def _devices(tmp_path):
    d = tmp_path / "dev"
    d.mkdir(exist_ok=True)
    for name in ("accel0", "nvidia0"):
        (d / name).write_bytes(b"")
    return d


def _holder(device, busy=True):
    body = "while True:\n    pass" if busy else "import time\nwhile True:\n    time.sleep(0.1)"
    return subprocess.Popen([sys.executable, "-c", f"f = open({str(device)!r})\n{body}\n"])


def _fake_smi(tmp_path, duty_file):
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    smi = bindir / "nvidia-smi"
    smi.write_text(f"#!/bin/sh\n[ -s {duty_file} ] || exit 9\ncat {duty_file}\n")
    smi.chmod(0o755)
    return bindir


def _fake_nvml(tmp_path, duty_file):
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.fail("no C compiler to build the stand-in NVML")
    src = tmp_path / "nvml.c"
    src.write_text(FAKE_NVML.replace("@DUTY@", str(duty_file)))
    lib = tmp_path / "libnvidia-ml.so.1"
    subprocess.run([cc, "-shared", "-fPIC", "-O1", "-o", str(lib), str(src)], check=True)
    return lib


def test_both_agents_answer_the_same_keys_idle(tmp_path):
    """No holder: both agents report duty 0 from the proc tier, no
    holders, their device files, JAX's keys."""
    _devices(tmp_path)
    states = {}
    for which in AGENTS:
        proc, url = _start(which, tmp_path)
        try:
            time.sleep(0.7)
            states[which] = _get(url)
        finally:
            _stop(proc)
    for which, state in states.items():
        assert set(state) == KEYS, which
        assert state["duty_cycle_pct"] == 0.0 and state["holders"] == 0
        assert state["source"] == "proc-heuristic" and state["last_active"] is None
    assert states["port"]["devices"] == [str(tmp_path / "dev" / "nvidia0")]


def test_device_tier_wins_over_the_proc_tier_and_falls_back(tmp_path):
    """NVML answering: the agent reports the GPUs' mean utilization
    (``device-metrics``) with no holder at all; NVML gone, ``nvidia-smi``
    answers; both gone, the next sample falls back to the proc tier
    without a restart. JAX's agent does the same from its metrics
    endpoint (its own test); here both report the device's number."""
    _devices(tmp_path)
    duty = tmp_path / "duty"
    duty.write_text("83\n77\n")
    lib = _fake_nvml(tmp_path, duty)
    proc, url = _start("port", tmp_path, GPU_AGENT_NVML_LIB=str(lib))
    try:
        state = _wait(url, lambda s: s["source"] == "device-metrics" and
                      s["duty_cycle_pct"] == 80.0)
        assert state["source"] == "device-metrics" and state["duty_cycle_pct"] == 80.0
        assert state["holders"] == 0 and state["last_active"] is not None
        duty.write_text("")  # the library stops answering
        state = _wait(url, lambda s: s["source"] == "proc-heuristic")
        assert state["source"] == "proc-heuristic" and state["duty_cycle_pct"] == 0.0
    finally:
        _stop(proc)
    duty.write_text("40\n60\n20\n")
    bindir = _fake_smi(tmp_path, duty)
    proc, url = _start("port", tmp_path, GPU_AGENT_SMI="nvidia-smi",
                       PATH=f"{bindir}:{os.environ['PATH']}")
    try:
        state = _wait(url, lambda s: s["source"] == "device-metrics")
        assert state["source"] == "device-metrics" and state["duty_cycle_pct"] == 40.0
        duty.write_text("")  # nvidia-smi fails (exit 9)
        state = _wait(url, lambda s: s["source"] == "proc-heuristic")
        assert state["source"] == "proc-heuristic"
    finally:
        _stop(proc)


def test_a_sample_is_the_mean_of_its_intervals_reads(tmp_path):
    """Trailing attribution: a sample covers its own interval, the mean of
    the reads within it (a device busy half the interval reads ~50)."""
    _devices(tmp_path)
    duty = tmp_path / "duty"
    duty.write_text("0\n")
    bindir = _fake_smi(tmp_path, duty)
    proc, url = _start("port", tmp_path, GPU_AGENT_SMI="nvidia-smi", GPU_AGENT_INTERVAL="2",
                       PATH=f"{bindir}:{os.environ['PATH']}")
    try:
        state = _wait(url, lambda s: s["source"] == "device-metrics")
        seen = set()
        deadline = time.time() + 20
        while time.time() < deadline:
            duty.write_text("100\n")
            time.sleep(1.0)
            duty.write_text("0\n")
            time.sleep(1.0)
            seen.add(_get(url)["duty_cycle_pct"])
            if any(20.0 <= d <= 80.0 for d in seen):
                break
        assert any(20.0 <= d <= 80.0 for d in seen), seen
        assert state["interval_s"] == 2.0
    finally:
        _stop(proc)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_busy_holder_is_active_and_the_culler_spares_it(tmp_path, which):
    """A process holding the device file and burning CPU: the agent (proc
    tier) reports it busy and stamps ``last_active``; that package's
    culler, probing its agent with the Jupyter server dead, reads
    activity == now and does not cull."""
    devdir = _devices(tmp_path)
    device = devdir / ("accel0" if which == "jax" else "nvidia0")
    proc, url = _start(which, tmp_path)
    holder = _holder(device, busy=True)
    try:
        state = _wait(url, lambda s: s["duty_cycle_pct"] >= 5.0)
        assert state["holders"] >= 1 and state["duty_cycle_pct"] >= 5.0, state
        assert state["last_active"]
        if which == "jax":
            from odh_kubeflow_tpu import apis
            from odh_kubeflow_tpu.controllers.culler import Culler, CullerConfig
            from odh_kubeflow_tpu.machinery.store import APIServer

            culler = Culler(APIServer(), CullerConfig(tpu_duty_cycle_threshold=5.0),
                            base_url_fn=lambda nb: "http://127.0.0.1:1",
                            tpu_url_fn=lambda nb: url, now_fn=lambda: 12345.0)
            ann = {apis.TPU_ACCELERATOR_ANNOTATION: "tpu-v5-lite-podslice"}
        else:
            from odh_kubeflow_tpu_torch import apis
            from odh_kubeflow_tpu_torch.controllers.culler import Culler, CullerConfig
            from odh_kubeflow_tpu_torch.machinery.store import APIServer

            culler = Culler(APIServer(), CullerConfig(gpu_duty_cycle_threshold=5.0),
                            base_url_fn=lambda nb: "http://127.0.0.1:1",
                            gpu_url_fn=lambda nb: url, now_fn=lambda: 12345.0)
            ann = {apis.GPU_ACCELERATOR_ANNOTATION: "nvidia-h100-80gb"}
        nb = {"metadata": {"name": "n", "namespace": "ns", "annotations": ann}}
        assert culler.probe_activity(nb) == 12345.0
        old = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(12345.0 - 10_000))
        nb["metadata"]["annotations"][apis.LAST_ACTIVITY_ANNOTATION] = old
        culler.config.cull_idle_seconds = 600
        # the probe's activity refreshes the stamp: not idle, not culled
        activity = culler.probe_activity(nb)
        nb["metadata"]["annotations"][apis.LAST_ACTIVITY_ANNOTATION] = time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime(activity))
        assert not culler.needs_culling(nb)
    finally:
        holder.send_signal(signal.SIGKILL)
        holder.wait(timeout=10)
        _stop(proc)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_idle_holder_is_not_active(tmp_path, which):
    devdir = _devices(tmp_path)
    device = devdir / ("accel0" if which == "jax" else "nvidia0")
    proc, url = _start(which, tmp_path)
    holder = _holder(device, busy=False)
    try:
        deadline, calm = time.time() + 20, 0
        state = None
        while time.time() < deadline and calm < 2:
            time.sleep(0.4)
            state = _get(url)
            calm = calm + 1 if state["holders"] >= 1 and state["duty_cycle_pct"] < 5.0 else 0
        assert state["holders"] >= 1 and state["duty_cycle_pct"] < 5.0, state
    finally:
        holder.send_signal(signal.SIGKILL)
        holder.wait(timeout=10)
        _stop(proc)
