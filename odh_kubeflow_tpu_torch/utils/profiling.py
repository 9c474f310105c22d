"""Profiles of a notebook's work on ``torch.profiler``, in the layout
TensorBoard serves (the port's counterpart of the JAX package's
``utils/profiling.py``, which drives the XLA profiler).

A user captures a profile in a notebook with :func:`capture_trace` (or
starts :func:`start_server`, which answers an on-demand capture
request) and writes it to a PVC; the tensorboard controller
(``controllers/tensorboard.py``) serves that volume and the TWA's
``/logs`` route lists it. The layout is the JAX package's:
``<logdir>/plugins/profile/<session>/<host>.pt.trace.json.gz``, one
Chrome trace-event file a capture. Its name ends in ``.trace.json.gz``,
which :func:`trace_sessions` / :func:`latest_trace_events` (and
TensorBoard's profile plugin) read, and in ``.pt.trace.json.gz``, which
the PyTorch profiler's TensorBoard plugin reads. There is no
``.xplane.pb`` on a GPU: XLA writes that file, and nothing here runs
XLA.

On a CUDA run a capture records the CPU side and the card's kernels
(CUPTI); a capture in which no CUDA kernel ran raises and writes no
session, so an empty profile can never pass for one.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import socket
import threading
import time
from contextlib import contextmanager
from typing import Any, Optional

PORT_ENV = "ODH_TORCH_PROFILER_PORT"
AUTOSTART_ENV = "ODH_TORCH_PROFILER_AUTOSTART"
LOGDIR_ENV = "ODH_TORCH_PROFILER_LOGDIR"
DEFAULT_PORT = int(os.environ.get(PORT_ENV, "9999"))
TRACE_SUFFIX = ".pt.trace.json.gz"

_STATE: dict[str, Any] = {}
_capture_lock = threading.Lock()


def kernel_events(events: list[dict]) -> list[dict]:
    """The card's kernel launches of a Chrome trace (``cat: kernel``)."""
    return [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]


def _session_name() -> str:
    now = time.time()
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S", time.gmtime(now))
    return f"{stamp}_{int(now * 1e6) % 1_000_000:06d}"


@contextmanager
def capture_trace(logdir: str):
    """Capture one profiling session into TensorBoard's layout under
    ``logdir``; yields the ``torch.profiler.profile``. With a card it
    records CPU and CUDA activities, and a capture that recorded no
    kernel raises ``RuntimeError`` and leaves no session behind; without
    one, the CPU's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with _capture_lock:  # one profiler a process
        with profile(activities=activities) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize()
        root = os.path.join(logdir, "plugins", "profile")
        os.makedirs(root, exist_ok=True)
        session = _session_name()
        # built under a dot name and moved into place whole: a reader
        # (TensorBoard, the TWA's /logs) never sees a partial session
        tmp = os.path.join(root, f".{session}.{os.getpid()}.tmp")
        os.makedirs(tmp)
        try:
            raw = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(raw)
            with open(raw) as f:
                doc = json.load(f)
            if cuda and not kernel_events(doc.get("traceEvents", [])):
                raise RuntimeError(
                    "the capture recorded no CUDA kernel: the profiled code did "
                    "not run on the card (no session written)"
                )
            with open(raw, "rb") as src, gzip.open(
                os.path.join(tmp, socket.gethostname() + TRACE_SUFFIX), "wb", compresslevel=3
            ) as dst:
                shutil.copyfileobj(src, dst)
            os.unlink(raw)
            os.rename(tmp, os.path.join(root, session))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def trace_sessions(logdir: str) -> list[str]:
    """Session directories in TensorBoard profile-plugin layout,
    newest last."""
    return sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*")))


def latest_trace_events(logdir: str) -> list[dict]:
    """The newest session's trace events (the Chrome trace-event format
    TensorBoard's trace viewer renders): the cheap check that what was
    captured is servable."""
    sessions = trace_sessions(logdir)
    if not sessions:
        return []
    files = glob.glob(os.path.join(sessions[-1], "*.trace.json.gz"))
    if not files:
        return []
    with gzip.open(files[0], "rt") as f:
        doc = json.load(f)
    return doc.get("traceEvents", [])


def profiler_app(logdir: Optional[str] = None):
    """The on-demand capture endpoint (torch has no profiler server, so
    this is the counterpart of the XLA profiler's): ``POST /capture``
    with ``{"duration_ms": n, "logdir": path}`` profiles whatever the
    process runs for that long into one session and answers its
    directory; 409 when no CUDA kernel ran in that window."""
    from odh_kubeflow_tpu_torch.web.microweb import App, Response

    app = App("torch-profiler")

    @app.route("/healthz")
    def health(request):
        return Response({"ok": True})

    @app.route("/capture", methods=["POST"])
    def capture(request):
        body = request.json or {}
        target = body.get("logdir") or logdir or os.environ.get(LOGDIR_ENV, "")
        if not target:
            return Response({"error": "no logdir: pass one or set " + LOGDIR_ENV}, 400)
        duration = float(body.get("duration_ms", 1000)) / 1e3
        try:
            with capture_trace(target):
                time.sleep(duration)
        except RuntimeError as e:
            return Response({"error": str(e)}, 409)
        return Response({"session": trace_sessions(target)[-1]}, 201)

    return app


def start_server(port: Optional[int] = None, logdir: Optional[str] = None):
    """Serve :func:`profiler_app` on ``port`` (``DEFAULT_PORT``;
    ``ODH_TORCH_PROFILER_PORT``) in a daemon thread on localhost. A
    second call in one process returns the running server; the
    kernel-startup hook guards with :func:`server_started`."""
    if server_started():
        return _STATE["server"]
    server = profiler_app(logdir).serve("127.0.0.1", DEFAULT_PORT if port is None else port)
    _STATE["server"] = server
    _STATE["port"] = server.server_address[1]
    return server


def server_started() -> bool:
    return _STATE.get("server") is not None


def stop_server() -> None:
    server = _STATE.pop("server", None)
    _STATE.pop("port", None)
    if server is not None:
        server.shutdown()
        server.server_close()


def kernel_startup_snippet() -> str:
    """The IPython-startup hook a GPU notebook image seeds into
    ``~/.ipython/profile_default/startup/``: the capture server starts
    in every kernel, and nothing it does can raise into the kernel."""
    return (
        "# auto-start the torch profiler's capture server so a capture\n"
        "# request works against this kernel (set\n"
        f"# {AUTOSTART_ENV}=false to disable)\n"
        "import os as _os\n"
        f"if _os.environ.get('{AUTOSTART_ENV}', 'true') == 'true':\n"
        "    try:\n"
        "        from odh_kubeflow_tpu_torch.utils import profiling as _prof\n"
        "        if not _prof.server_started():\n"
        "            _prof.start_server()\n"
        "    except Exception:\n"
        "        pass\n"
    )
