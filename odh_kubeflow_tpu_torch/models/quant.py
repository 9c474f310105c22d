"""Weight-only int8 and int4 quantization (counterpart of
``models/quant.py``).

int8: symmetric per-output-channel, ``scale = max|W| / 127`` over the
contraction axis (next-to-last). int4: the contraction axis splits into
groups of 128 rows (one group when K is not a multiple of 128), each
with its own per-column scale ``max|W| / 7``; codes in [-7, 7] are
stored +8, two nibbles per byte in split-halves order (low nibble rows
``[0, K/2)``, high nibble rows ``[K/2, K)``). Codes, packed bytes and
scales are bit-identical to the JAX package's.

Every int4 leaf dequantizes through ``ops.int4.int4_dequant``: the
hand-written kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

import zlib
from typing import Any

import torch

from odh_kubeflow_tpu_torch.ops import int4 as int4_ops
from odh_kubeflow_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]

# leaves quantized by name (matmul weights); everything else passes
# through in its original dtype. Copied from the JAX package's table.
_QUANT_LEAVES = {
    "wq", "wk", "wv", "wo",
    "w_gate", "w_up", "w_down",
    "lm_head",
    "moe_gate", "moe_up", "moe_down", "router",
}

INT4_GROUP = 128


def quantize_tensor(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: scale over the next-to-last
    axis (D_in), one scale per output channel."""
    amax = w.abs().amax(dim=-2, keepdim=True)
    # the division runs in the weight's dtype, as in JAX, then widens
    scale = (amax / 127.0).to(torch.float32)
    q = torch.clamp(
        torch.round(w / torch.clamp(scale, min=1e-12)), -127, 127
    ).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_tensor4(w: torch.Tensor, group: int = INT4_GROUP) -> dict:
    """Symmetric group-wise int4 in split-halves packing (see the module
    docstring); returns ``{"q4": uint8 [..., K/2, N], "scale4": f32
    [..., K/group, N]}``."""
    *lead, K, N = w.shape
    if K % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, K={K}")
    if K % group:
        group = K  # tiny test shapes: one group
    g = K // group
    wg = w.reshape(*lead, g, group, N)
    amax = wg.abs().amax(dim=-2, keepdim=True)
    scale = (amax / 7.0).to(torch.float32)  # [..., g, 1, N]
    q = torch.clamp(torch.round(wg / torch.clamp(scale, min=1e-12)), -7, 7).to(
        torch.int8
    ) + 8  # [1, 15]
    q = q.reshape(*lead, K, N).to(torch.uint8)
    lo = q[..., : K // 2, :]
    hi = q[..., K // 2 :, :]
    packed = lo | (hi << 4)  # [..., K/2, N]
    return {"q4": packed.contiguous(), "scale4": scale[..., 0, :].reshape(*lead, g, N)}


def dequantize_tensor4(t: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """One ``int4_dequant`` per 2-D matrix; leading axes (the ``[L]``
    stack) loop, as JAX vmaps them."""
    packed, scale = t["q4"], t["scale4"]
    if packed.ndim == 2:
        return int4_ops.int4_dequant(packed, scale, dtype)
    return torch.stack(
        [dequantize_tensor4({"q4": p, "scale4": s}, dtype) for p, s in zip(packed, scale)]
    )


def dequantize_tensor(t: dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    if "q4" in t:
        return dequantize_tensor4(t, dtype)
    return (t["q"].to(dtype) * t["scale"].to(dtype)).to(dtype)


def _is_quantized(tree) -> bool:
    return isinstance(tree, dict) and (
        set(tree) == {"q", "scale"} or set(tree) == {"q4", "scale4"}
    )


def quantize_params(params: Params, bits: int = 8) -> Params:
    """Quantize the matmul weights of a param tree in place of their
    float leaves; other leaves pass through unchanged."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qt = quantize_tensor if bits == 8 else quantize_tensor4

    def walk(tree):
        if isinstance(tree, dict):
            return {
                k: (
                    qt(v)
                    if k in _QUANT_LEAVES and isinstance(v, torch.Tensor)
                    else walk(v)
                )
                for k, v in tree.items()
            }
        return tree

    return walk(params)


def dequantize_params(qparams: Params, dtype=torch.bfloat16) -> Params:
    """The same tree with float matmul weights."""

    def walk(tree):
        if _is_quantized(tree):
            return dequantize_tensor(tree, dtype)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree

    return walk(qparams)


def _leaf_seed(seed: int, path: tuple, name: str) -> int:
    # crc32, not hash(): python's hash is salted per process, so two
    # processes would draw different "random" weights for one seed
    tag = zlib.crc32("/".join(path + (name,)).encode())
    return (seed * 2**31 + tag % (2**31)) % (2**63)


def streaming_quantized_init(
    cfg,
    seed: int = 0,
    scale: float = 0.02,
    *,
    bits: int = 8,
    device="cuda",
) -> Params:
    """Build an int8 (``bits=8``) or int4 (``bits=4``) param tree leaf by
    leaf on the device, with random weights (serving smoke and demo use).

    Initialising the whole model in bf16 and then quantizing would hold
    both trees at once. Here each leaf is drawn from its own
    ``torch.Generator`` (seeded from ``seed`` and the leaf's path), then
    quantized one ``[L]`` slice at a time, so the transient is one bf16
    leaf plus one layer's f32 working set. Quantizing per layer gives
    the same codes as quantizing the stack: the scales reduce within a
    layer. Non-matmul leaves (embedding, norms) are ``normal * scale``
    in bf16, as in the JAX package. ``cfg`` may be a ``LlamaConfig`` or a
    ``MoeConfig``: expert banks ``[L, E, K, N]`` quantize like any other
    matmul weight, a per-channel scale ``[L, E, 1, N]`` per expert.
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    from odh_kubeflow_tpu_torch.models import llama, moe

    param_shapes = moe.param_shapes if isinstance(cfg, moe.MoeConfig) else llama.param_shapes

    dev = resolve_device(device)
    qt = quantize_tensor if bits == 8 else quantize_tensor4

    def leaf(path, name, shape):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_leaf_seed(seed, path, name))
        if name not in _QUANT_LEAVES:
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
            return (w * scale).to(torch.bfloat16)
        w = torch.randn(shape, generator=gen, dtype=torch.bfloat16, device=dev) * scale
        if w.ndim == 2:
            return qt(w)
        parts = [qt(w[i]) for i in range(w.shape[0])]
        del w
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    def build(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = build(v, path + (k,))
            else:
                out[k] = leaf(path, k, v[0])
        return out

    return build(param_shapes(cfg))


def quantization_error(params: Params, qparams: Params) -> dict[str, float]:
    """Max relative error per quantized leaf (diagnostics)."""
    out = {}

    def walk(p, q, path):
        if _is_quantized(q):
            deq = dequantize_tensor(q, torch.float32)
            p32 = p.to(torch.float32)
            denom = torch.clamp(p32.abs().max(), min=1e-9)
            out[path] = float((p32 - deq).abs().max() / denom)
        elif isinstance(q, dict):
            for k in q:
                walk(p[k], q[k], f"{path}/{k}" if path else k)

    walk(params, qparams, "")
    return out
