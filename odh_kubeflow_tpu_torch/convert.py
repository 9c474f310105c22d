"""Carry parameter trees between the JAX package and this one.

A tree is nested dicts of arrays: the Llama or MoE param tree (expert
banks ``[L, E, ...]`` included), a LoRA tree, or a quantized tree whose
leaves are int8 ``{"q","scale"}`` or int4 ``{"q4","scale4"}`` dicts. Names, layout and dtypes are unchanged in
both directions. Arrays cross as numpy, which has no bf16 of its own:
``to_numpy_tree`` widens bf16 to float32 (exact), and
``from_numpy_tree`` turns an array of the ``bfloat16`` extension dtype
(what ``np.asarray`` gives for a JAX bf16 array) back into bf16; a
caller that sent bf16 as float32 casts on the torch side. Trees land on
the card unless the caller asks for the CPU (``device="cpu"``, as the
tests do); without a GPU the default raises.
"""

from __future__ import annotations

import numpy as np
import torch

from odh_kubeflow_tpu_torch.utils.device import resolve_device


def from_numpy_tree(tree, device="cuda"):
    """numpy tree → torch tree on ``device`` (the card by default; raises
    without a GPU), dtypes kept (int8 codes, packed uint8 nibbles, f32
    scales, bf16 leaves)."""
    return _from_numpy(tree, resolve_device(device))


def _from_numpy(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    bf16 = arr.dtype.name == "bfloat16"
    if bf16:
        arr = arr.astype(np.float32)  # exact widening
    t = torch.tensor(arr, device=device)  # a copy: JAX's arrays are read-only
    return t.to(torch.bfloat16) if bf16 else t


def to_numpy_tree(tree):
    """torch tree → numpy tree; bf16 tensors become float32 arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
