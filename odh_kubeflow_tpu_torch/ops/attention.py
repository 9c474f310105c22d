"""Dense attention (counterpart of ``ops/attention.py``).

One einsum → softmax → einsum chain. GQA reshapes the queries to
``[B, S, Hkv, group, hd]`` instead of repeating the KV heads, so the
cache is read once per KV head. This is the attention of the serving
path: the KV-cache forward always attends densely, in the JAX package
too. The flash kernels are the training slice's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def dense_attention(
    q: torch.Tensor,  # [B, Sq, Hq, hd]
    k: torch.Tensor,  # [B, Sk, Hkv, hd]
    v: torch.Tensor,  # [B, Sk, Hkv, hd]
    *,
    causal: bool = True,
    q_offset: Union[int, torch.Tensor] = 0,
    segment_ids: Optional[torch.Tensor] = None,  # [B, S] same id attends
    kv_mask: Optional[torch.Tensor] = None,  # [B, Sk] bool, True = attend
) -> torch.Tensor:
    """Returns [B, Sq, Hq, hd]. Scores accumulate in float32.

    ``q_offset`` is the absolute position of q[0] relative to k[0]: an
    int (or 0-d tensor) shared by all rows, or a ``[B]`` tensor of
    per-row offsets. ``kv_mask`` marks the cache slots that hold real
    tokens (ragged right-padded prompts leave invalid slots between each
    prompt's end and the shared write index).
    """
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of KV heads {Hkv}")
    group = Hq // Hkv
    dev = q.device

    scale = hd**-0.5
    qg = q.reshape(B, Sq, Hkv, group, hd)
    # bf16 → f32 is exact, so an f32 product of the upcast operands is
    # JAX's bf16 dot with preferred_element_type=f32
    scores = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.to(torch.float32), k.to(torch.float32)
    )  # [B, Hkv, group, Sq, Sk]
    scores = scores * scale

    mask = None
    if causal:
        k_pos = torch.arange(Sk, device=dev)
        if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
            q_pos = q_offset.to(dev)[:, None] + torch.arange(Sq, device=dev)[None, :]
            mask = (q_pos[:, :, None] >= k_pos[None, None, :])[
                :, None, None, :, :
            ]  # [B, 1, 1, Sq, Sk]
        else:
            q_pos = torch.arange(Sq, device=dev)[:, None] + q_offset
            mask = (q_pos >= k_pos[None, :])[None, None, None, :, :]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[
            :, None, None, :, :
        ]  # [B, 1, 1, Sq, Sk]
        mask = seg if mask is None else mask & seg
    if kv_mask is not None:
        kvm = kv_mask[:, None, None, None, :]  # [B, 1, 1, 1, Sk]
        mask = kvm if mask is None else mask & kvm
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)

    # JAX's promotion: a bf16 cache read by f32 queries computes in f32
    out_dtype = torch.promote_types(q.dtype, v.dtype)
    weights = torch.softmax(scores, dim=-1).to(q.dtype).to(out_dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", weights, v.to(out_dtype))
    return out.reshape(B, Sq, Hq, hd)
