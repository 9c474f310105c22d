"""Elastic training loop: preemption-aware run, checkpoint and resume
(counterpart of ``train/elastic.py``).

When a preemptible node is reclaimed the pod gets SIGTERM and a grace
period, so the loop

- installs a SIGTERM/SIGINT handler that asks for a graceful stop;
- saves a final checkpoint before it returns, so the caller can exit with
  ``PREEMPTED_EXIT_CODE`` and a supervisor knows the run can resume;
- on start, restores the latest checkpoint if there is one, also onto
  another mesh: ``Trainer.restore_checkpoint`` reshards the whole saved
  state onto the current one (the run may come back on other cards).
"""

from __future__ import annotations

import signal
import threading
from typing import Any, Callable, Iterable, Optional

import torch
import torch.distributed as dist

PREEMPTED_EXIT_CODE = 42


class PreemptionGuard:
    """Latches SIGTERM/SIGINT into a flag the step loop polls."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = threading.Event()
        self._previous = {}
        self._signals = signals

    def install(self) -> "PreemptionGuard":
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def _handle(self, _signum, _frame) -> None:
        self._stop.set()

    @property
    def preempted(self) -> bool:
        return self._stop.is_set()


def gang_preempted(guard: PreemptionGuard, device) -> bool:
    """The gang's verdict on the preemption flag: one int32 all-gather over
    the world group, so every process stops at the same step when any of
    them was signalled (a process that stops while its peers enter the
    next step's collectives would hang them). Without a process group the
    flag is this process's."""
    if not dist.is_initialized():
        return guard.preempted
    flag = torch.tensor([int(guard.preempted)], dtype=torch.int32, device=device)
    flags = [torch.empty_like(flag) for _ in range(dist.get_world_size())]
    dist.all_gather(flags, flag)
    return bool(torch.cat(flags).sum().item() > 0)


def run_elastic(
    trainer,
    manager,
    batches: Iterable[Any],
    *,
    total_steps: int,
    on_step: Optional[Callable[[int, dict], None]] = None,
    guard: Optional[PreemptionGuard] = None,
    eval_batches: Optional[Callable[[], Iterable[Any]]] = None,
    eval_interval: int = 0,
) -> dict:
    """Train until ``total_steps`` or preemption; returns ``{"step",
    "preempted", "resumed_from"}``. On preemption a final checkpoint is
    forced before returning. ``manager`` is a
    ``train.checkpoint.CheckpointManager``: its ``save_interval_steps``
    drives the periodic saves. ``eval_batches`` (a callable returning a
    fresh iterable) with ``eval_interval`` > 0 runs a no-grad sweep every
    N steps; its mean loss lands in the metrics passed to ``on_step`` as
    ``eval_loss``. Sweeps stop once preemption is signalled."""
    own_guard = guard is None
    guard = (guard or PreemptionGuard()).install()

    resumed_from = None
    if manager.latest_step() is not None:
        resumed_from = trainer.restore_checkpoint(manager)

    metrics: dict = {}
    preempted = False
    try:
        it = iter(batches)
        # one gang decision an iteration, reused by the loop condition and
        # the exit path: every collective below sees the same control flow
        # on every process
        while trainer.step < total_steps and not (
            preempted := gang_preempted(guard, trainer.device)
        ):
            try:
                batch = next(it)
            except StopIteration:
                break
            metrics = trainer.train_step(batch)
            trainer.save_checkpoint(manager)
            if eval_batches is not None and eval_interval > 0 and trainer.step % eval_interval == 0:
                losses = [float(trainer.eval_step(b)["loss"]) for b in eval_batches()]
                if losses:
                    metrics["eval_loss"] = sum(losses) / len(losses)
            if on_step is not None:
                on_step(trainer.step, metrics)
        if not preempted:
            # a step-limit or end-of-data exit still needs the gang's verdict
            preempted = gang_preempted(guard, trainer.device)
        if preempted:
            trainer.save_checkpoint(manager, force=True)
            manager.wait_until_finished()
    finally:
        if own_guard:
            guard.uninstall()
    return {"step": trainer.step, "preempted": preempted, "resumed_from": resumed_from}
