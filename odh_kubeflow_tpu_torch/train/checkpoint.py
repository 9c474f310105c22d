"""Checkpoint and resume of training state (counterpart of
``train/checkpoint.py``, which wraps orbax).

The surface is the JAX one: ``save(step, state, force=)``, ``restore``,
``latest_step``, ``all_steps``, ``max_to_keep``, ``save_interval_steps``,
``wait_until_finished``, ``close`` and use as a context manager. Each
step is ``<directory>/<step>/state.pt``, a ``torch.save`` of the state
tree (the trainer saves its trainable tree and optimizer state; frozen
base weights are not saved). ``save`` copies the tensors to host memory
at once and, with ``async_save``, writes the file on a background thread
while training goes on; a step directory appears only when its file is
complete (write to a temporary name, then rename). At most
``max_to_keep`` steps are kept, the oldest removed first. A trainer
under a mesh saves its state gathered whole from rank 0 and restores it
onto any mesh (``Trainer.save_checkpoint``, ``restore_checkpoint``).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Optional

import torch

Params = dict[str, Any]
_FILE = "state.pt"


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _like(loaded, like):
    """``loaded`` placed as ``like`` is: each tensor on ``like``'s device
    with its dtype."""
    if isinstance(like, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(like):
            raise ValueError("checkpoint tree does not match the target tree")
        return {k: _like(loaded[k], like[k]) for k in like}
    if isinstance(like, torch.Tensor):
        if tuple(loaded.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint shape {tuple(loaded.shape)} != {tuple(like.shape)}")
        return loaded.to(device=like.device, dtype=like.dtype)
    return loaded


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        *,
        max_to_keep: int = 3,
        save_interval_steps: int = 1,
        async_save: bool = True,
    ):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Params, *, force: bool = False) -> bool:
        """Returns whether a save started: not when ``step`` is off the
        interval (unless ``force``) or already saved."""
        if not force and step % self.save_interval_steps:
            return False
        self.wait_until_finished()
        if step in self.all_steps():
            return False
        host = _to_host(state)
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)
        return True

    def _write(self, step: int, host: Params) -> None:
        try:
            tmp = os.path.join(self.directory, f".{step}.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(host, os.path.join(tmp, _FILE))
            os.replace(tmp, self._path(step))
            if self.max_to_keep:  # None or 0 keeps every step
                for old in self.all_steps()[: -self.max_to_keep]:
                    shutil.rmtree(self._path(old), ignore_errors=True)
        except Exception as e:  # noqa: BLE001 — surfaced by wait_until_finished
            self._error = e

    def restore(self, state_like: Optional[Params], step: Optional[int] = None) -> Params:
        """The saved tree at ``step`` (the latest by default), each tensor
        on the device and in the dtype of its ``state_like`` leaf, or as
        saved (on the CPU) when ``state_like`` is None: a trainer under a
        mesh reshards the whole tree onto its own mesh."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        loaded = torch.load(
            os.path.join(self._path(step), _FILE), map_location="cpu", weights_only=True
        )
        return loaded if state_like is None else _like(loaded, state_like)

    def all_steps(self) -> list[int]:
        return sorted(
            int(d)
            for d in os.listdir(self.directory)
            if d.isdigit() and os.path.exists(os.path.join(self.directory, d, _FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
