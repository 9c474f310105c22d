"""SessionManager: the suspend/resume controller (the port's copy of the
JAX package's ``sessions/manager.py``).

Runs on the runtime Manager next to the notebook controller and drives
the SessionCheckpoint state machine:

- **suspend** (``SUSPENDED_AT_ANNOTATION`` stamped by the culler, the
  gang scheduler's checkpoint-then-preempt, or the JWA): while the
  notebook controller holds the scale-down (``sessions.suspend_pending``),
  snapshot the kernel state out of the live pod through the runtime
  hook, write it durably through the checkpoint store keyed by notebook
  UID, then mark the SessionCheckpoint ``Suspended`` — at which point
  the StatefulSet scales to zero, the gang Workload is deleted, and the
  GPUs are freed;
- **resume** (stop/suspend annotations cleared by the JWA's resume
  route): the Workload re-enqueues through normal reconcile; once the
  fresh pod is Running the manager restores the stored state into it
  (digest-checked — bit-identical or it warns), records the warm-resume
  latency histogram, and only then clears the notebook's ``Resuming``
  phase so the JWA reports ready;
- **suspender hooks** for the SliceScheduler: ``is_suspendable`` /
  ``suspend_in_flight`` / ``request_suspend`` implement
  checkpoint-then-preempt — idle sessions yield their GPUs via a
  durable snapshot instead of a hard kill.

Snapshot/restore IO is blocking (checkpoint writes, HTTP hooks) and
runs only from reconcile bodies — never under store locks. The JAX
manager's restore span and its usage-meter marks wait for
``utils/tracing.py`` and ``machinery/usage.py``, and its split-process
``main()`` for ``machinery/runner.py`` (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.apis import (
    LAST_ACTIVITY_ANNOTATION,
    RESUME_REQUESTED_ANNOTATION,
    STOP_ANNOTATION,
    SUSPEND_REASON_ANNOTATION,
    SUSPENDED_AT_ANNOTATION,
    notebook_agent_url,
)
from odh_kubeflow_tpu_torch.controllers.runtime import Manager, Request, Result
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.events import EventRecorder
from odh_kubeflow_tpu_torch.machinery.objects import mutable
from odh_kubeflow_tpu_torch.machinery.store import AlreadyExists, Conflict, NotFound
from odh_kubeflow_tpu_torch.sessions import (
    PHASE_RESTORED,
    PHASE_RESUMING,
    PHASE_SUSPENDED,
    PHASE_SUSPENDING,
    checkpoint_durable,
    checkpoint_of,
    checkpoint_spec_of,
    new_checkpoint,
)
from odh_kubeflow_tpu_torch.sessions.checkpoint import (
    ReplicatedCheckpointStore,
    SessionCheckpointStore,
    parse_zone_spec,
)
from odh_kubeflow_tpu_torch.utils import prometheus

Obj = dict[str, Any]

COMPONENT = "session-manager"

# suspend spans ms (sim snapshot) to minutes (a big kernel to a bucket);
# warm resumes must land in seconds — the buckets resolve the SLO
_LATENCY_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 300.0)


@dataclasses.dataclass
class SessionConfig:
    # where checkpoints live (PVC path or bucket prefix); empty → a
    # process-local temp dir (sim / tests)
    checkpoint_dir: str = ""
    backend: str = "auto"  # torch | json | auto (= torch)
    # zone-replicated checkpoints: comma-separated ``zone=path`` (one
    # independent volume per failure domain) or bare zone names
    # (subdirs of checkpoint_dir — sim/dev). ≥2 zones turns every
    # suspend into a write-all across them; empty keeps the single
    # store exactly as before.
    zones: str = ""
    # how often a degraded checkpoint (fewer zones than configured
    # hold its bytes) retries re-replication
    zone_heal_retry_seconds: float = 30.0
    # how long a session must be idle before the scheduler may reclaim
    # its GPUs via suspend (checkpoint-then-preempt at equal priority)
    reclaim_idle_seconds: float = 300.0
    # where the default HTTP snapshot/restore hooks reach the in-pod
    # session agent (must track the cluster's real domain or every
    # suspend silently degrades to a cold stop)
    cluster_domain: str = "cluster.local"
    agent_port: int = 8890
    # how long a transiently-unreachable snapshot hook is retried
    # against a still-Running pod before the suspend degrades to an
    # empty checkpoint (same window the notebook controller holds the
    # scale-down for)
    suspend_grace_seconds: float = 600.0
    # how long a failed restore hook is retried against a Running pod
    # (agent not listening yet) before the resume degrades to cold
    restore_retry_seconds: float = 120.0

    @staticmethod
    def from_env() -> "SessionConfig":
        env = os.environ
        return SessionConfig(
            checkpoint_dir=env.get("SESSION_CHECKPOINT_DIR", ""),
            backend=env.get("SESSION_CHECKPOINT_BACKEND", "auto"),
            zones=env.get("SESSION_CHECKPOINT_ZONES", ""),
            zone_heal_retry_seconds=float(env.get("SESSION_ZONE_HEAL_RETRY_SECONDS", "30")),
            reclaim_idle_seconds=float(env.get("SESSION_RECLAIM_IDLE_SECONDS", "300")),
            cluster_domain=env.get("CLUSTER_DOMAIN", "cluster.local"),
            agent_port=int(env.get("SESSION_AGENT_PORT", "8890")),
            suspend_grace_seconds=float(env.get("SESSION_SUSPEND_GRACE_SECONDS", "600")),
            restore_retry_seconds=float(env.get("SESSION_RESTORE_RETRY_SECONDS", "120")),
        )


class HttpSessionRuntime:
    """Real-cluster checkpoint/restore hooks: the in-image session
    agent (same sidecar family as the gpu-activity agent) serves the
    kernel snapshot on the agent port. The kubelet sim provides the
    in-process equivalent (``machinery.kubelet.SimSessionRuntime``)."""

    def __init__(self, cluster_domain: str = "cluster.local", port: int = 8890,
                 timeout: float = 10.0):
        self.cluster_domain = cluster_domain
        self.port = port
        self.timeout = timeout

    def _base(self, notebook: Obj) -> str:
        return notebook_agent_url(notebook, self.cluster_domain, self.port) + "/api/session"

    def snapshot(self, notebook: Obj, pod: Obj) -> Optional[Obj]:
        try:
            with urllib.request.urlopen(self._base(notebook) + "/state",
                                        timeout=self.timeout) as r:
                return json.loads(r.read().decode())
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def restore(self, notebook: Obj, pod: Obj, state: Obj) -> bool:
        req = urllib.request.Request(
            self._base(notebook) + "/restore",
            data=json.dumps(state).encode(),
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                return True
        except (urllib.error.URLError, OSError):
            return False


class SessionManager:
    def __init__(
        self,
        api: Any,
        config: Optional[SessionConfig] = None,
        registry: Optional[prometheus.Registry] = None,
        runtime: Optional[Any] = None,
        store: Optional[SessionCheckpointStore] = None,
        time_fn: Callable[[], float] = time.time,
    ):
        self.api = api
        self.config = config or SessionConfig()
        self.now = time_fn
        self.runtime = runtime or HttpSessionRuntime(
            cluster_domain=self.config.cluster_domain, port=self.config.agent_port
        )
        root = self.config.checkpoint_dir or tempfile.mkdtemp(prefix="session-ckpt-")
        if store is not None:
            self.store = store
        else:
            zones = parse_zone_spec(self.config.zones, root)
            self.store = (
                ReplicatedCheckpointStore(zones, backend=self.config.backend)
                if zones
                else SessionCheckpointStore(root, backend=self.config.backend)
            )
        self.recorder = EventRecorder(api, COMPONENT)
        reg = registry or prometheus.default_registry
        self.m_suspend = reg.histogram(
            "session_suspend_seconds",
            "Suspend request to durable checkpoint",
            buckets=_LATENCY_BUCKETS,
        )
        self.m_resume = reg.histogram(
            "session_resume_seconds",
            "Warm resume: reopen request to state restored in the fresh pod",
            buckets=_LATENCY_BUCKETS,
        )
        self.m_suspends = reg.counter(
            "session_suspends_total",
            "Completed suspend-to-checkpoint operations by trigger",
            labelnames=("reason",),
        )
        self.m_resumes = reg.counter(
            "session_resumes_total",
            "Completed session resumes by outcome",
            labelnames=("result",),
        )
        self.m_bytes = reg.gauge(
            "session_checkpoint_size_bytes",
            "Serialized size of the most recent kernel snapshot",
        )
        self.m_heals = reg.counter(
            "session_checkpoint_heals_total",
            "Degraded checkpoints re-replicated to their full zone set",
        )
        self.m_degraded = reg.gauge(
            "session_checkpoints_degraded",
            "Checkpoints (any phase) currently held by fewer zones than configured",
        )
        reg.register_collector(self._collect_suspended)

    def _collect_suspended(self):
        counts: dict[str, int] = {}
        degraded = 0
        try:
            rows = self.api.list("SessionCheckpoint")
        except NotFound:
            rows = []
        for ck in rows:
            if obj_util.get_path(ck, "status", "phase") == PHASE_SUSPENDED:
                ns = obj_util.namespace_of(ck)
                counts[ns] = counts.get(ns, 0) + 1
            if obj_util.get_path(ck, "status", "replicationDegraded"):
                degraded += 1
        self.m_degraded.set(degraded)
        yield (
            "# HELP suspended_sessions Sessions suspended to checkpoint, "
            "holding no GPUs, per quota pool"
        )
        yield "# TYPE suspended_sessions gauge"
        for ns in sorted(counts):
            yield f'suspended_sessions{{queue="{ns}"}} {counts[ns]}'

    # -- wiring -------------------------------------------------------------

    def register(self, mgr: Manager) -> None:
        ctrl = mgr.new_controller("session-manager", "Notebook", self.reconcile)
        ctrl.watches("SessionCheckpoint", self._map_checkpoint)
        ctrl.watches("Pod", self._map_pod, predicate=self._pod_predicate)

    @staticmethod
    def _map_checkpoint(_etype: str, ckpt: Obj) -> list[Request]:
        name = obj_util.get_path(ckpt, "spec", "notebook", default=obj_util.name_of(ckpt))
        return [Request(obj_util.namespace_of(ckpt), name)]

    @staticmethod
    def _pod_predicate(_etype: str, pod: Obj) -> bool:
        return "notebook-name" in obj_util.labels_of(pod)

    @staticmethod
    def _map_pod(_etype: str, pod: Obj) -> list[Request]:
        name = obj_util.labels_of(pod).get("notebook-name", "")
        return [Request(obj_util.namespace_of(pod), name)] if name else []

    # -- reconcile ----------------------------------------------------------

    def reconcile(self, req: Request) -> Result:
        try:
            notebook = mutable(self.api.get("Notebook", req.name, req.namespace))
        except NotFound:
            return self._gc(req)

        # one read serves the whole reconcile (suspend path, resume
        # path, upserts); a checkpoint left by a DELETED same-named
        # notebook (delete coalesced with the recreate) is dropped here
        # or it would pin phantom GPUs in the committed ledger forever.
        # It is read by name, unfenced: ``checkpoint_of`` hides another
        # generation's checkpoint, so JAX's manager (which reads through
        # it) never drops one, and the new notebook's own suspend then
        # cannot create its checkpoint (AlreadyExists) and waits out the
        # grace window as a plain stop.
        try:
            named = self.api.get("SessionCheckpoint", req.name, req.namespace)
        except NotFound:
            named = None
        ckpt = self._gc_stale_generation(notebook, named)

        ann = obj_util.annotations_of(notebook)
        suspended_at = ann.get(SUSPENDED_AT_ANNOTATION)
        if suspended_at:
            return self._reconcile_suspend(notebook, suspended_at, ckpt)
        if ckpt is not None:
            phase = obj_util.get_path(ckpt, "status", "phase", default="")
            if phase in (PHASE_SUSPENDED, PHASE_RESUMING):
                return self._reconcile_resume(notebook, ckpt)
        # terminal sweep: no suspend in progress and no resume owed —
        # a session phase left behind by a Conflict-swallowed clear
        # (the notebook controller mirrors status concurrently) would
        # otherwise pin the JWA at "resuming" forever
        if obj_util.get_path(notebook, "status", "phase", default="") in (
            PHASE_SUSPENDING,
            PHASE_SUSPENDED,
            PHASE_RESUMING,
        ):
            self._set_phase(notebook, "")
        if ckpt is not None:
            # a checkpoint degraded at suspend time keeps healing even
            # after the session resumed (the retained bytes are still
            # single-zone until every configured zone holds them)
            return self._reconcile_replication(notebook, ckpt)
        return Result()

    # -- suspend ------------------------------------------------------------

    def _reconcile_suspend(self, notebook: Obj, suspended_at: str, ckpt: Optional[Obj]) -> Result:
        if checkpoint_durable(ckpt, suspended_at):
            # snapshot durable — the notebook controller scales down /
            # deletes the Workload; keep the phase honest and, when
            # the checkpoint landed in fewer zones than configured,
            # keep re-replicating until every zone holds the bytes
            self._set_phase(notebook, PHASE_SUSPENDED)
            return self._reconcile_replication(notebook, ckpt)

        self._set_phase(notebook, PHASE_SUSPENDING)
        uid = obj_util.meta(notebook).get("uid", "")
        prev_status = (ckpt.get("status") or {}) if ckpt is not None else {}
        if (
            prev_status.get("stateCaptured")
            and prev_status.get("phase") in (PHASE_SUSPENDED, PHASE_RESUMING)
            and self.store.exists(uid)
        ):
            # re-suspended before the last restore completed: the
            # durable checkpoint from the previous epoch is STILL the
            # kernel's truth — a fresh pod that came up meanwhile holds
            # an empty kernel (state was never restored into it), so
            # snapshotting it would destroy real state. Carry forward.
            receipt = {
                "step": prev_status.get("checkpointStep", 0),
                "digest": prev_status.get("digest", ""),
                "sizeBytes": prev_status.get("sizeBytes", 0),
            }
            if "zones" in prev_status:
                receipt["zones"] = prev_status["zones"]
                receipt["degraded"] = bool(prev_status.get("replicationDegraded"))
            captured = True
        else:
            pod = self._running_pod0(notebook)
            state: Optional[Obj] = None
            if pod is not None:
                # blocking snapshot IO (HTTP hook / checkpoint write):
                # runs here in the reconcile body, never under store
                # locks
                state = self.runtime.snapshot(notebook, pod)
            captured = state is not None
            if not captured:
                if (
                    pod is not None
                    and self.now() - obj_util.parse_rfc3339(suspended_at)
                    < self.config.suspend_grace_seconds
                ):
                    # the kernel is alive but its snapshot hook didn't
                    # answer (agent restarting, transient network):
                    # retry inside the grace window — one flaky probe
                    # must not discard a living kernel by finalizing an
                    # empty checkpoint and releasing the GPUs
                    self.recorder.warning(
                        notebook,
                        "SessionSnapshotRetry",
                        "kernel snapshot hook unreachable; retrying before "
                        "releasing the GPUs",
                    )
                    return Result(requeue_after=2.0)
                self.recorder.warning(
                    notebook,
                    "SessionStateUnavailable",
                    "no live kernel state to snapshot (pod gone or snapshot "
                    "hook unreachable); suspending without state",
                )
            receipt = self.store.save(uid, state if captured else {})
        status_patch = {
            "phase": PHASE_SUSPENDED,
            "suspendedAt": suspended_at,
            "checkpointStep": receipt["step"],
            "digest": receipt["digest"],
            "sizeBytes": receipt["sizeBytes"],
            "stateCaptured": captured,
            "resumedAt": None,
        }
        if "zones" in receipt:
            # zone-replicated store: the CR status is the operator's
            # replication surface — which zones hold the bytes, and
            # whether the write degraded to fewer than configured
            status_patch["zones"] = list(receipt["zones"])
            status_patch["replicationDegraded"] = bool(receipt.get("degraded"))
        self._upsert_checkpoint(notebook, status_patch, ckpt=ckpt)
        reason = obj_util.annotations_of(notebook).get(SUSPEND_REASON_ANNOTATION) or "user"
        wait = self.now() - obj_util.parse_rfc3339(suspended_at)
        self.m_suspend.observe(max(wait, 0.0))
        self.m_suspends.inc({"reason": reason})
        self.m_bytes.set(receipt["sizeBytes"])
        self.recorder.normal(
            notebook,
            "SuspendCheckpointed",
            f"session state checkpointed (step {receipt['step']}, "
            f"{receipt['sizeBytes']} bytes); releasing the GPU reservation",
        )
        self._set_phase(notebook, PHASE_SUSPENDED)
        if receipt.get("degraded"):
            self.recorder.warning(
                notebook,
                "CheckpointReplicationDegraded",
                f"checkpoint durable in zone(s) "
                f"{', '.join(receipt.get('zones', []))} only; "
                "re-replicating when the missing zone(s) heal",
            )
            return Result(requeue_after=self.config.zone_heal_retry_seconds)
        return Result()

    def _reconcile_replication(self, notebook: Obj, ckpt: Obj) -> Result:
        """Re-replicate a degraded checkpoint (its bytes live in fewer
        zones than configured — a zone was down at suspend time) once
        the missing zones heal. Level-triggered: retried every
        ``zone_heal_retry_seconds`` while degraded, a no-op for
        fully-replicated checkpoints and non-replicated stores."""
        status = ckpt.get("status") or {}
        if not status.get("replicationDegraded"):
            return Result()
        heal = getattr(self.store, "heal", None)
        digest = status.get("digest", "")
        uid = obj_util.get_path(ckpt, "spec", "notebookUID", default="")
        if heal is None or not digest or not uid:
            return Result()
        # blocking checkpoint IO — reconcile body, no locks held
        replication = heal(uid, digest)
        if replication["degraded"]:
            return Result(requeue_after=self.config.zone_heal_retry_seconds)
        self._upsert_checkpoint(
            notebook,
            {"zones": list(replication["zones"]), "replicationDegraded": False},
            ckpt=ckpt,
        )
        self.m_heals.inc()
        self.recorder.normal(
            notebook,
            "CheckpointReplicated",
            "checkpoint re-replicated; every configured zone holds "
            f"bit-identical bytes ({', '.join(replication['zones'])})",
        )
        return Result()

    # -- resume -------------------------------------------------------------

    def _reconcile_resume(self, notebook: Obj, ckpt: Obj) -> Result:
        if STOP_ANNOTATION in obj_util.annotations_of(notebook):
            # still stopped (suspend annotation cleared by hand): the
            # checkpoint keeps waiting — resume starts when the stop
            # lifts and the Workload re-enqueues
            return Result()
        phase = obj_util.get_path(ckpt, "status", "phase", default="")
        if phase == PHASE_SUSPENDED:
            self._upsert_checkpoint(
                notebook,
                {"phase": PHASE_RESUMING, "resumeStartedAt": obj_util.now_rfc3339()},
                ckpt=ckpt,
            )
            self._set_phase(notebook, PHASE_RESUMING)
        pod = self._running_pod0(notebook)
        if pod is None:
            # the Workload is still queueing/binding; stay Resuming
            self._set_phase(notebook, PHASE_RESUMING)
            return Result()

        uid = obj_util.meta(notebook).get("uid", "")
        saved_digest = obj_util.get_path(ckpt, "status", "digest", default="")
        # the receipt digest steers a replicated store to a zone whose
        # bytes verify (read-from-any-SURVIVING-zone)
        loaded = self.store.load(uid, expect_digest=saved_digest or None)
        result = "restored"
        if loaded is None:
            result = "empty"
            self.recorder.warning(
                notebook,
                "SessionStateMissing",
                "no stored session state for this notebook; resuming cold",
            )
        else:
            state, read_digest = loaded
            if saved_digest and read_digest != saved_digest:
                result = "corrupt"
                self.recorder.warning(
                    notebook,
                    "SessionChecksumMismatch",
                    f"restored bytes digest {read_digest[:12]} != "
                    f"checkpointed {saved_digest[:12]}; resuming cold",
                )
            elif not self.runtime.restore(notebook, pod, state):
                started = obj_util.get_path(
                    ckpt, "status", "resumeStartedAt", default=""
                ) or obj_util.annotations_of(notebook).get(RESUME_REQUESTED_ANNOTATION, "")
                if (
                    started
                    and self.now() - obj_util.parse_rfc3339(started)
                    < self.config.restore_retry_seconds
                ):
                    # pod is Running but the agent inside isn't serving
                    # yet (normal startup ordering): retry — finalizing
                    # now would strand an intact, digest-valid
                    # checkpoint and turn every real resume cold
                    self.recorder.warning(
                        notebook,
                        "SessionRestoreRetry",
                        "restore hook not answering yet; retrying with the "
                        "checkpoint intact",
                    )
                    return Result(requeue_after=2.0)
                result = "error"
                self.recorder.warning(
                    notebook,
                    "SessionRestoreFailed",
                    "restore hook rejected the session state; resuming cold",
                )
        requested = obj_util.annotations_of(notebook).get(RESUME_REQUESTED_ANNOTATION, "")
        if requested:
            self.m_resume.observe(max(self.now() - obj_util.parse_rfc3339(requested), 0.0))
        self.m_resumes.inc({"result": result})
        self._upsert_checkpoint(
            notebook,
            {"phase": PHASE_RESTORED, "resumedAt": obj_util.now_rfc3339()},
            ckpt=ckpt,
        )
        self.recorder.normal(
            notebook,
            "Resumed",
            "warm resume complete: session state restored into the fresh pod"
            if result == "restored"
            else f"session resumed without state ({result})",
        )
        self._set_phase(notebook, "")
        return Result()

    # -- scheduler suspender hooks (checkpoint-then-preempt) ----------------

    def _notebook_for(self, wl: Obj) -> Optional[Obj]:
        try:
            return self.api.get("Notebook", obj_util.name_of(wl), obj_util.namespace_of(wl))
        except NotFound:
            return None

    def suspend_in_flight(self, wl: Obj) -> bool:
        """A suspend was requested for this workload's notebook and its
        GPU release is coming — the scheduler counts it as pending
        capacity instead of requesting more suspends."""
        nb = self._notebook_for(wl)
        return nb is not None and SUSPENDED_AT_ANNOTATION in obj_util.annotations_of(nb)

    def is_suspendable(self, wl: Obj, require_idle: bool = False) -> bool:
        """Whether the workload's session can yield its GPUs via a
        checkpoint. ``require_idle`` (equal-priority oversubscription
        reclaim) additionally demands the kernel has been quiet for
        ``reclaim_idle_seconds`` — preempting a running computation to
        densify is worse than queueing."""
        nb = self._notebook_for(wl)
        if nb is None:
            return False
        ann = obj_util.annotations_of(nb)
        if SUSPENDED_AT_ANNOTATION in ann or STOP_ANNOTATION in ann:
            return False
        if require_idle:
            idle_since = ann.get(LAST_ACTIVITY_ANNOTATION) or obj_util.meta(nb).get(
                "creationTimestamp", ""
            )
            if not idle_since:
                return False
            if (
                self.now() - obj_util.parse_rfc3339(idle_since)
                < self.config.reclaim_idle_seconds
            ):
                return False
        return True

    def request_suspend(self, wl: Obj, message: str, reason: str = "preempt") -> bool:
        """Stamp the suspend contract onto the workload's notebook.
        Returns True only when this call initiated the suspend (the
        caller counts the preemption metric off it). ``reason`` lands
        in ``SUSPEND_REASON_ANNOTATION`` — the scheduler's zone drain
        passes ``zone-drain`` so its migrate step can tell its own
        suspends from user/preempt ones."""
        nb = self._notebook_for(wl)
        if nb is None:
            return False
        if SUSPENDED_AT_ANNOTATION in obj_util.annotations_of(nb):
            return False
        now = obj_util.now_rfc3339()
        try:
            self.api.patch(
                "Notebook",
                obj_util.name_of(nb),
                {
                    "metadata": {
                        "annotations": {
                            STOP_ANNOTATION: now,
                            SUSPENDED_AT_ANNOTATION: now,
                            SUSPEND_REASON_ANNOTATION: reason,
                        }
                    }
                },
                obj_util.namespace_of(nb),
            )
        except (Conflict, NotFound):
            return False
        self.recorder.normal(nb, "Suspending", message)
        return True

    # -- plumbing -----------------------------------------------------------

    def _running_pod0(self, notebook: Obj) -> Optional[Obj]:
        try:
            pod = self.api.get(
                "Pod", f"{obj_util.name_of(notebook)}-0", obj_util.namespace_of(notebook)
            )
        except NotFound:
            return None
        if obj_util.get_path(pod, "status", "phase") != "Running":
            return None
        return pod

    def _set_phase(self, notebook: Obj, phase: str) -> None:
        """The notebook's session phase lives in ``status.phase``
        (preserved by the notebook controller's status mirror); the JWA
        reads it to gate "ready" behind the state restore. The write
        goes against a FRESH read — the in-hand object's rv is usually
        stale by now (this reconcile did store IO in between, and the
        notebook controller mirrors status concurrently), and a
        swallowed Conflict on the terminal clear would pin the phase."""
        try:
            fresh = mutable(
                self.api.get(
                    "Notebook", obj_util.name_of(notebook), obj_util.namespace_of(notebook)
                )
            )
        except NotFound:
            return
        if obj_util.get_path(fresh, "status", "phase", default="") == phase:
            return
        fresh.setdefault("status", {})["phase"] = phase
        try:
            updated = self.api.update_status(fresh)
            notebook["metadata"]["resourceVersion"] = updated["metadata"]["resourceVersion"]
            notebook.setdefault("status", {})["phase"] = phase
        except (Conflict, NotFound):
            pass  # the reconcile retriggers and re-drives the phase

    def _upsert_checkpoint(self, notebook: Obj, status: Obj, ckpt: Optional[Obj] = None) -> None:
        if ckpt is None:
            ckpt = checkpoint_of(self.api, notebook)
        if ckpt is None:
            gpus, accel, per_node = checkpoint_spec_of(notebook)
            ckpt = new_checkpoint(notebook, gpus=gpus, accel=accel, accel_count=per_node)
            try:
                ckpt = self.api.create(ckpt)
            except AlreadyExists:
                ckpt = checkpoint_of(self.api, notebook)
                if ckpt is None:
                    return
        ckpt = mutable(ckpt)
        merged = dict(ckpt.get("status") or {})
        merged.update(status)
        ckpt["status"] = merged
        try:
            self.api.update_status(ckpt)
        except (Conflict, NotFound):
            pass  # next reconcile rewrites from fresh state

    def verify_receipts(self) -> list[dict[str, Any]]:
        """Post-recovery audit: cross-check every SessionCheckpoint
        CR's digest receipt against the bytes actually in the durable
        store. The CRs live in the control plane and the bytes on the
        checkpoint volume — a crash must never split them. Returns one
        row per checkpoint: ``{key, uid, ok, detail}``."""
        rows: list[dict[str, Any]] = []
        for ckpt in self.api.list("SessionCheckpoint"):
            key = f"{obj_util.namespace_of(ckpt)}/{obj_util.name_of(ckpt)}"
            uid = obj_util.get_path(ckpt, "spec", "notebookUID", default="")
            saved = obj_util.get_path(ckpt, "status", "digest", default="")
            if not uid or not saved:
                continue  # never checkpointed (or receipt not yet cut)
            loaded = self.store.load(uid)
            if loaded is None:
                rows.append({"key": key, "uid": uid, "ok": False,
                             "detail": "receipt present but bytes missing"})
                continue
            _, digest = loaded
            ok = digest == saved
            rows.append({
                "key": key, "uid": uid, "ok": ok,
                "detail": "bit-identical" if ok
                else f"digest {digest[:12]} != receipt {saved[:12]}",
            })
        return rows

    def _gc_stale_generation(self, notebook: Obj, ckpt: Optional[Obj]) -> Optional[Obj]:
        """Drop a checkpoint whose recorded UID belongs to a previous
        notebook of the same name, along with its stored bytes.
        Returns the checkpoint if it belongs to THIS notebook, else
        None (dropped or absent)."""
        if ckpt is None:
            return None
        old_uid = obj_util.get_path(ckpt, "spec", "notebookUID", default="")
        if old_uid == obj_util.meta(notebook).get("uid", ""):
            return ckpt
        if old_uid:
            self.store.delete(old_uid)
        try:
            self.api.delete("SessionCheckpoint", obj_util.name_of(ckpt),
                            obj_util.namespace_of(ckpt))
        except NotFound:
            pass
        return None

    def _gc(self, req: Request) -> Result:
        """Notebook gone: drop its checkpoint object AND the stored
        bytes (the object is deliberately not owner-referenced so the
        UID survives long enough to clean the store). A zone that is
        dark at delete time may still hold the bytes — the CR is the
        ONLY uid→bytes record, so it stays (and this reconcile
        requeues) until the delete lands in every zone."""
        try:
            ckpt = self.api.get("SessionCheckpoint", req.name, req.namespace)
        except NotFound:
            return Result()
        uid = obj_util.get_path(ckpt, "spec", "notebookUID", default="")
        if uid and self.store.delete(uid) is False:
            return Result(requeue_after=self.config.zone_heal_retry_seconds)
        try:
            self.api.delete("SessionCheckpoint", req.name, req.namespace)
        except NotFound:
            pass
        return Result()
