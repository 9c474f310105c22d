"""Rotary position embeddings (counterpart of ``ops/rope.py``).

Angles are computed once per forward, outside the layer loop, and
shared by every layer.
"""

from __future__ import annotations

import torch


def rope_angles(
    positions: torch.Tensor,  # [B, S] integer absolute positions
    head_dim: int,
    theta: float = 500_000.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sin, cos), each [B, S, head_dim//2], float32."""
    half = head_dim // 2
    freq_exponents = (
        torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    )
    inv_freq = torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=positions.device),
        -freq_exponents,
    )  # [hd/2]
    angles = positions.to(torch.float32)[..., None] * inv_freq  # [B, S, hd/2]
    return torch.sin(angles), torch.cos(angles)


def apply_rope(
    x: torch.Tensor,  # [B, S, H, hd]
    sin: torch.Tensor,  # [B, S, hd/2]
    cos: torch.Tensor,  # [B, S, hd/2]
) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)
