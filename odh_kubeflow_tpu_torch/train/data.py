"""Input pipeline: document packing and device prefetch (counterpart of
``train/data.py``).

- :func:`pack_documents` packs variable-length documents into fixed
  ``[B, S]`` windows with ``segment_ids`` walls (the flash kernels' masked
  path keeps tokens from attending across documents) and a ``loss_mask``
  that zeroes padding and each piece's last token. The same greedy
  packing, bit for bit, as the JAX package's Python path; the JAX
  package's native packer is not part of the port.
- :func:`shard_batch` cuts a global batch to one rank's block of a mesh:
  batch rows over (data, fsdp, expert), the sequence over context.
- :func:`prefetch_to_device` keeps ``buffer_size`` batches in flight:
  each is copied to pinned host memory and sent with a non-blocking copy,
  so the transfer overlaps the current step on the card.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from odh_kubeflow_tpu_torch.utils.device import resolve_device

Batch = dict[str, Any]


def pack_documents(
    documents: Iterable[Sequence[int]],
    batch_size: int,
    seq_len: int,
    *,
    pad_id: int = 0,
    drop_remainder: bool = True,
    engine: str = "auto",
) -> Iterator[Batch]:
    """Greedy sequence packing into numpy ``[B, S]`` batches: ``tokens``,
    ``targets`` (next token within a piece), ``segment_ids`` (1-based per
    row, 0 for padding) and ``loss_mask``.

    A document longer than the space left is split across rows, each
    piece its own segment. ``engine`` is accepted for signature parity:
    "auto" and "python" pack in Python; "native" raises, the port has no
    native packer. Not itself a generator: argument errors raise at the
    call site."""
    if engine not in ("auto", "python", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "native":
        raise RuntimeError("engine='native': the port packs documents in Python only")
    return _pack(documents, batch_size, seq_len, pad_id, drop_remainder)


def _pack(documents, batch_size, seq_len, pad_id, drop_remainder) -> Iterator[Batch]:
    rows: list[list[tuple[int, list[int]]]] = []  # [(segment, tokens)]
    current: list[tuple[int, list[int]]] = []
    used = 0
    seg = 0

    def flush_row():
        nonlocal current, used, seg
        rows.append(current)
        current, used, seg = [], 0, 0

    for doc in documents:
        doc = list(doc)
        while doc:
            space = seq_len - used
            if space == 0:
                flush_row()
                space = seq_len
            seg += 1
            piece, doc = doc[:space], doc[space:]
            current.append((seg, piece))
            used += len(piece)
        while len(rows) >= batch_size:
            yield _emit(rows[:batch_size], seq_len, pad_id)
            rows = rows[batch_size:]
    if current:
        flush_row()
    while len(rows) >= batch_size:
        yield _emit(rows[:batch_size], seq_len, pad_id)
        rows = rows[batch_size:]
    if rows and not drop_remainder:
        while len(rows) < batch_size:
            rows.append([])
        yield _emit(rows, seq_len, pad_id)


def _emit(rows, seq_len: int, pad_id: int) -> Batch:
    B = len(rows)
    tokens = np.full((B, seq_len), pad_id, np.int32)
    targets = np.full((B, seq_len), pad_id, np.int32)
    segment_ids = np.zeros((B, seq_len), np.int32)
    loss_mask = np.zeros((B, seq_len), np.float32)
    for b, row in enumerate(rows):
        pos = 0
        for seg, piece in row:
            n = len(piece)
            tokens[b, pos : pos + n] = piece
            segment_ids[b, pos : pos + n] = seg
            # next-token targets within the segment; its last token has
            # no target and is masked
            if n > 1:
                targets[b, pos : pos + n - 1] = piece[1:]
                loss_mask[b, pos : pos + n - 1] = 1.0
            pos += n
    return {
        "tokens": tokens,
        "targets": targets,
        "segment_ids": segment_ids,
        "loss_mask": loss_mask,
    }


def shard_batch(batch: Batch, mesh, microbatches: Optional[int] = None) -> Batch:
    """This rank's block of a global ``[B, S]`` batch (numpy or tensors)
    by ``parallel.mesh.batch_spec``, as tensors. Without ``targets`` the
    next-token targets are made first, by shifting the whole sequence:
    shifted after the split, each context block's last token would lose
    its target.

    With ``microbatches`` M (a pipelined step) the block is taken
    microbatch-major: its rows ``[m·mb', (m+1)·mb')`` are this rank's share
    of the global microbatch ``m``, rows ``[m·B/M, (m+1)·B/M)``, as JAX's
    pipeline splits the global batch before the batch axes split it."""
    from odh_kubeflow_tpu_torch.parallel.mesh import BATCH_AXES, batch_spec, local_shard

    batch = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
             for k, v in batch.items()}
    if "targets" not in batch:
        batch["targets"] = torch.roll(batch["tokens"], -1, dims=1)
    if microbatches is None:
        return {k: local_shard(v, mesh, batch_spec()) for k, v in batch.items()}
    M = microbatches
    B = batch["tokens"].shape[0]
    n = mesh.size(BATCH_AXES)
    if B % M or (B // M) % n:
        raise ValueError(
            f"a microbatch of batch {B} / {M} microbatches does not split over the batch "
            f"axes (data x fsdp x expert = {n}): each microbatch needs a multiple of {n} rows")
    spec = (None,) + tuple(batch_spec())
    return {k: local_shard(v.reshape(M, B // M, *v.shape[1:]), mesh, spec).flatten(0, 1)
            for k, v in batch.items()}


def prefetch_to_device(
    batches: Iterable[Batch], device="cuda", buffer_size: int = 2
) -> Iterator[Batch]:
    """Yield the batches as tensors on ``device``, in order, with
    ``buffer_size`` of them already sent (at least one)."""
    dev = resolve_device(device)

    def put(batch: Batch) -> Batch:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            out[k] = t
        return out

    queue: collections.deque = collections.deque()
    it = iter(batches)
    for batch in it:
        queue.append(put(batch))
        if len(queue) >= max(buffer_size, 1):
            break
    while queue:
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        yield queue.popleft()
