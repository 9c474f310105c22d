"""Idleness culling, GPU-duty-cycle aware (the port's copy of the JAX
package's ``controllers/culler.py``).

Reference parity (notebook-controller/pkg/culler/culler.go): probes the
running server's Jupyter REST API (``/api/kernels``, ``/api/terminals``,
:155-221), maintains the ``notebooks.kubeflow.org/last-activity``
annotation with a monotonic guard (:266-355), and sets
``kubeflow-resource-stopped`` once idle beyond the threshold (:405-420).
Design doc: components/proposals/20220121-jupyter-notebook-idleness.md.

Kernel-state probing alone would cull a notebook mid-fine-tune — a
long training step looks "busy-but-quiet" (no new kernel activity,
websocket silent). The culler therefore also probes
``/api/gpu/activity`` (served by an in-image activity agent, the
counterpart of the JAX package's ``/api/tpu/activity``) and treats
recent GPU duty cycle above a threshold as activity. A multi-node
notebook is culled atomically — the stop annotation acts on the
Notebook, never a subset of nodes. With ``suspend_on_cull`` a cull is a
suspend to checkpoint (the sessions subsystem), as JAX's. The probed
duty feeds the shared usage meter (``machinery.usage.UsageMeter``), so
one probe serves both the cull decision and the GPU-second ledger.
"""

from __future__ import annotations

import calendar
import dataclasses
import json
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.apis import (
    GPU_ACCELERATOR_ANNOTATION,
    GPU_DUTY_CYCLE_ANNOTATION,
    LAST_ACTIVITY_ANNOTATION,
    LAST_ACTIVITY_CHECK_ANNOTATION,
    STOP_ANNOTATION,
    SUSPEND_REASON_ANNOTATION,
    SUSPENDED_AT_ANNOTATION,
    notebook_agent_url,
)
from odh_kubeflow_tpu_torch.controllers.runtime import Result
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.events import EventRecorder
from odh_kubeflow_tpu_torch.machinery.store import APIServer, Conflict, NotFound

Obj = dict[str, Any]

TIME_FORMAT = "%Y-%m-%dT%H:%M:%SZ"


def _parse_time(s: str) -> float:
    s = s.split(".")[0].rstrip("Z") + "Z"
    return calendar.timegm(time.strptime(s, TIME_FORMAT))


def _fmt_time(t: float) -> str:
    return time.strftime(TIME_FORMAT, time.gmtime(t))


@dataclasses.dataclass
class CullerConfig:
    cull_idle_seconds: float = 1440 * 60.0
    idleness_check_seconds: float = 60.0
    cluster_domain: str = "cluster.local"
    probe_timeout: float = 5.0
    # GPU activity: duty cycle above this percentage counts as active.
    # check_gpu_duty_cycle=False skips the agent probe entirely
    # (CULL_CHECK_GPU_DUTY_CYCLE env — clusters without the in-image
    # activity agent fall back to Jupyter-kernel idleness only)
    check_gpu_duty_cycle: bool = True
    gpu_duty_cycle_threshold: float = 5.0
    # port the in-image gpu-activity agent listens on (exposed by the
    # notebook Service for GPU notebooks)
    gpu_agent_port: int = 8890
    # suspend-to-checkpoint instead of a plain stop: the cull stamps
    # ``suspended-at`` alongside ``kubeflow-resource-stopped`` so the
    # session manager snapshots kernel state before the GPUs are
    # released, and the JWA shows "suspended, resumable" — not "stopped"
    suspend_on_cull: bool = False


class Culler:
    def __init__(
        self,
        api: APIServer,
        config: Optional[CullerConfig] = None,
        base_url_fn: Optional[Callable[[Obj], str]] = None,
        now_fn: Callable[[], float] = time.time,
        cull_counter=None,
        gpu_url_fn: Optional[Callable[[Obj], str]] = None,
        meter: Optional[Any] = None,
    ):
        self.api = api
        self.config = config or CullerConfig()
        # shared GPU-second ledger (machinery.usage.UsageMeter duck):
        # the probed duty sample feeds the meter instead of being
        # discarded after the threshold comparison
        self.meter = meter
        self._base_url_fn = base_url_fn or self._default_base_url
        # GPU probe URL: the agent serves on its own port (the Jupyter
        # port can't proxy it). When a test injects base_url_fn only,
        # the GPU probe rides the same fake base.
        if gpu_url_fn is None:
            if base_url_fn is None:
                gpu_url_fn = self._default_gpu_url
            else:
                gpu_url_fn = lambda nb: base_url_fn(nb) + "/api/gpu/activity"  # noqa: E731
        self._gpu_url_fn = gpu_url_fn
        self.now = now_fn
        self.m_cull = cull_counter
        self.m_last_cull = None  # gauge, wired by the notebook controller
        self.recorder = EventRecorder(api, "notebook-controller")

    def _default_base_url(self, notebook: Obj) -> str:
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        # service port 80 → jupyter 8888 (culler.go:155-180 URL shape)
        return (
            f"http://{name}.{ns}.svc.{self.config.cluster_domain}"
            f"/notebook/{ns}/{name}"
        )

    def _default_gpu_url(self, notebook: Obj) -> str:
        return (
            notebook_agent_url(
                notebook,
                self.config.cluster_domain,
                self.config.gpu_agent_port,
            )
            + "/api/gpu/activity"
        )

    # -- probes -------------------------------------------------------------

    def _get_json(self, url: str):
        try:
            with urllib.request.urlopen(url, timeout=self.config.probe_timeout) as r:
                return json.loads(r.read().decode())
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def probe_activity(self, notebook: Obj) -> Optional[float]:
        """Returns the server's latest activity timestamp (epoch), or
        None when the server is unreachable (treated as no-information:
        the annotation is left alone, matching the reference's behavior
        of skipping updates when probing fails)."""
        base = self._base_url_fn(notebook)
        latest: Optional[float] = None

        kernels = self._get_json(f"{base}/api/kernels")
        if isinstance(kernels, list):
            for k in kernels:
                if not isinstance(k, dict):
                    continue
                if k.get("execution_state") == "busy":
                    return self.now()
                la = k.get("last_activity")
                if la:
                    t = _parse_time(la)
                    latest = t if latest is None else max(latest, t)

        terminals = self._get_json(f"{base}/api/terminals")
        if isinstance(terminals, list):
            for term in terminals:
                if not isinstance(term, dict):
                    continue
                la = term.get("last_activity")
                if la:
                    t = _parse_time(la)
                    latest = t if latest is None else max(latest, t)

        # GPU probe only for GPU notebooks — non-GPU Services don't
        # expose the agent port, and an undeclared ClusterIP port can
        # stall the probe for its full timeout
        gpu = (
            self._get_json(self._gpu_url_fn(notebook))
            if self.config.check_gpu_duty_cycle
            and GPU_ACCELERATOR_ANNOTATION in obj_util.annotations_of(notebook)
            else None
        )
        if isinstance(gpu, dict):
            # a valid-JSON-but-wrong-shape payload (or a non-numeric
            # duty field) is no-information — a gap, exactly like an
            # unreachable agent; it must neither crash the loop nor
            # read as duty 0
            try:
                duty = float(gpu.get("duty_cycle_pct"))
            except (TypeError, ValueError):
                duty = None
            if duty is not None:
                self._observe_duty(notebook, duty)
                if duty >= self.config.gpu_duty_cycle_threshold:
                    return self.now()
            la = gpu.get("last_active")
            if la:
                try:
                    t = _parse_time(la)
                except (TypeError, ValueError):
                    t = None
                if t is not None:
                    latest = t if latest is None else max(latest, t)

        return latest

    def _observe_duty(self, notebook: Obj, duty: float) -> None:
        """A probed duty sample is evidence, not just a threshold
        input: feed it to the shared usage meter and stamp the
        last-observed annotation (rides the reconcile's annotation
        patch) so the cull decision is auditable."""
        now = self.now()
        if self.meter is not None:
            self.meter.observe_sample(
                obj_util.namespace_of(notebook),
                obj_util.name_of(notebook),
                duty,
                t=now,
                source="culler",
            )
        obj_util.set_annotation(
            notebook,
            # protocol-ok: audit trail for operators (kubectl describe)
            GPU_DUTY_CYCLE_ANNOTATION,
            f"{duty:g}@{_fmt_time(now)}",
        )

    # -- annotation state machine -------------------------------------------

    def reconcile_notebook(self, notebook: Obj) -> Result:
        """Called from the notebook controller's reconcile tail
        (reference :252-281). Returns the requeue period."""
        ann = obj_util.annotations_of(notebook)
        if STOP_ANNOTATION in ann:
            return Result()  # already stopped; nothing to track

        now = self.now()
        period = self.config.idleness_check_seconds

        last_check = ann.get(LAST_ACTIVITY_CHECK_ANNOTATION)
        if last_check is not None and now - _parse_time(last_check) < period:
            remaining = period - (now - _parse_time(last_check))
            return Result(requeue_after=max(remaining, 1.0))

        running = self._notebook_running(notebook)
        if not running and self._notebook_queued(notebook):
            # queue wait is not idleness: a gang waiting for admission
            # (or for GPU capacity) has no server to be idle. Pin
            # last-activity to now so a long queue wait can never tip
            # the notebook over the cull threshold the moment it
            # finally starts.
            obj_util.set_annotation(
                notebook, LAST_ACTIVITY_ANNOTATION, _fmt_time(now)
            )
        if running:
            # initialize on first sight (culler.go:118-141): without
            # this, a server that never reports activity (no kernels,
            # probe unreachable) would hold its GPUs forever.
            if LAST_ACTIVITY_ANNOTATION not in ann:
                obj_util.set_annotation(
                    notebook, LAST_ACTIVITY_ANNOTATION, _fmt_time(now)
                )
                ann = obj_util.annotations_of(notebook)
            activity = self.probe_activity(notebook)
            if activity is not None:
                prev = ann.get(LAST_ACTIVITY_ANNOTATION)
                # monotonic guard (culler.go:302-355)
                if prev is None or activity > _parse_time(prev):
                    obj_util.set_annotation(
                        notebook, LAST_ACTIVITY_ANNOTATION, _fmt_time(activity)
                    )
        obj_util.set_annotation(
            notebook, LAST_ACTIVITY_CHECK_ANNOTATION, _fmt_time(now)
        )

        if running and self.needs_culling(notebook):
            obj_util.set_annotation(notebook, STOP_ANNOTATION, _fmt_time(now))
            if self.m_cull is not None:
                self.m_cull.inc()
            if self.m_last_cull is not None:
                self.m_last_cull.set(now)
            # a re-cull of the same notebook (restarted, idled again)
            # bumps the Event count instead of stacking duplicates
            if self.config.suspend_on_cull:
                # suspended, not stopped: a DISTINCT event + the
                # suspended-at stamp let the JWA (and users) tell
                # "resumable with warm state" apart from a plain stop
                obj_util.set_annotation(notebook, SUSPENDED_AT_ANNOTATION, _fmt_time(now))
                obj_util.set_annotation(notebook, SUSPEND_REASON_ANNOTATION, "cull")
                self.recorder.normal(
                    notebook,
                    "Suspended",
                    "Notebook idle beyond threshold; suspending session "
                    "to checkpoint and releasing the GPUs",
                )
            else:
                self.recorder.normal(
                    notebook,
                    "Culled",
                    "Notebook idle beyond threshold; scaling to zero",
                )
        self._patch_annotations(notebook)
        return Result(requeue_after=period)

    def needs_culling(self, notebook: Obj) -> bool:
        ann = obj_util.annotations_of(notebook)
        last = ann.get(LAST_ACTIVITY_ANNOTATION)
        if last is None:
            return False
        return self.now() - _parse_time(last) > self.config.cull_idle_seconds

    def _notebook_queued(self, notebook: Obj) -> bool:
        """Whether the notebook is waiting on admission/scheduling
        rather than running: its Workload is not admitted, or its pods
        exist but sit Pending (gated or unschedulable)."""
        name = obj_util.name_of(notebook)
        ns = obj_util.namespace_of(notebook)
        try:
            wl = self.api.get("Workload", name, ns)
            if obj_util.get_path(wl, "status", "state") != "Admitted":
                return True
        except NotFound:
            pass  # no workload (queueing off) or kind not registered
        return any(
            obj_util.get_path(p, "status", "phase") == "Pending"
            for p in self.api.list(
                "Pod",
                namespace=ns,
                label_selector={"matchLabels": {"statefulset": name}},
            )
        )

    def _notebook_running(self, notebook: Obj) -> bool:
        try:
            pod = self.api.get(
                "Pod",
                f"{obj_util.name_of(notebook)}-0",
                obj_util.namespace_of(notebook),
            )
        except NotFound:
            return False
        return obj_util.get_path(pod, "status", "phase") == "Running"

    def _patch_annotations(self, notebook: Obj) -> None:
        patch = {
            "metadata": {"annotations": dict(obj_util.annotations_of(notebook))}
        }
        try:
            self.api.patch(
                "Notebook",
                obj_util.name_of(notebook),
                patch,
                obj_util.namespace_of(notebook),
            )
        except (Conflict, NotFound):
            pass  # next requeue retries
