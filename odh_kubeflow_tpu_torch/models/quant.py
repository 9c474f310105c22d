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
from odh_kubeflow_tpu_torch.parallel.mesh import P
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


def quantized_param_specs(specs: Params, bits: int = 8) -> Params:
    """A spec tree mapped to the tree ``quantize_params`` gives: each
    quantized leaf's spec becomes ``{"q": spec, "scale": spec'}`` (int4:
    ``q4``/``scale4``), where ``spec'`` replicates the contracted
    (next-to-last) axis, whose scales are ``[..., 1 or groups, N]``."""

    def scale_spec(spec):
        parts = list(spec)
        if len(parts) >= 2:
            parts[-2] = None
        return P(*parts)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in _QUANT_LEAVES:
                codes, scale = ("q", "scale") if bits == 8 else ("q4", "scale4")
                out[k] = {codes: v, scale: scale_spec(v)}
            else:
                out[k] = v
        return out

    return walk(specs)


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
    keep=None,
    layers=None,
) -> Params:
    """Build an int8 (``bits=8``) or int4 (``bits=4``) param tree leaf by
    leaf on the device, with random weights (serving smoke and demo use).

    Initialising the whole model in bf16 and then quantizing would hold
    both trees at once. Here each leaf is drawn from its own
    ``torch.Generator`` (seeded from ``seed`` and the leaf's path), a
    stacked ``[L, ...]`` leaf one layer at a time, and each matmul layer
    quantized as it is drawn, so the transient is one layer's working
    set. Quantizing per layer gives the same codes as quantizing the
    stack: the scales reduce within a layer. Non-matmul leaves (embedding,
    norms) are ``normal * scale`` in bf16, as in the JAX package. ``cfg``
    may be a ``LlamaConfig`` or a ``MoeConfig``: expert banks ``[L, E, K,
    N]`` quantize like any other matmul weight, a per-channel scale ``[L,
    E, 1, N]`` per expert.

    ``keep(path, tensor, per_layer)``, when given, returns the part of
    each drawn leaf, or of each quantized layer of a stacked one
    (``per_layer``), to keep: a rank of a mesh keeps its shard of exactly
    the single-device values. ``layers`` (a range, all by default) are the
    layers a pipeline stage builds: the other layers are skipped in each
    leaf's stream (``llama.normal_layers``), never drawn on the card, so a
    stage of an 8B base draws only its own.
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    from odh_kubeflow_tpu_torch.models import llama, moe

    param_shapes = moe.param_shapes if isinstance(cfg, moe.MoeConfig) else llama.param_shapes

    dev = resolve_device(device)
    qt = quantize_tensor if bits == 8 else quantize_tensor4

    keep = keep or (lambda path, t, per_layer: t)

    def leaf(path, name, shape):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_leaf_seed(seed, path, name))
        where = path + (name,)
        quant = name in _QUANT_LEAVES
        draw = torch.bfloat16 if quant else torch.float32
        if path[:1] != ("layers",):
            w = torch.randn(shape, generator=gen, dtype=draw, device=dev)
            if not quant:
                return keep(where, (w * scale).to(torch.bfloat16), False)
            return {k: keep(where + (k,), t, False) for k, t in qt(w * scale).items()}
        kept = range(shape[0]) if layers is None else layers
        parts = []
        for _, w in llama.normal_layers(gen, shape[1:], shape[0], kept, draw, dev):
            if quant:
                parts.append({k: keep(where + (k,), t, True) for k, t in qt(w * scale).items()})
            else:
                parts.append(keep(where, (w * scale).to(torch.bfloat16), True))
        if quant:
            return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        return torch.stack(parts)

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
