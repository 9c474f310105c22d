"""Normalisation ops (counterpart of ``ops/norms.py``).

Computed in float32 whatever the activation dtype: RMS statistics in
bfloat16 lose enough precision to hurt long sequences.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32)).to(dtype)
