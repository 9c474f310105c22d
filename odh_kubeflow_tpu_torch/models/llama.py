"""Llama-family transformer (counterpart of ``models/llama.py``).

Plain functions on tensors. Params are the JAX package's nested dict:
every per-layer weight carries a leading ``[L, ...]`` axis, weights are
``[in, out]`` (``x @ w``, not ``nn.Linear``'s ``[out, in]``), and leaf
names match. Where JAX scans over the layer axis, this runs a Python
loop over it, slicing one layer per step.

Two paths: ``forward_with_cache`` serves (prefill and decode, dense
attention over the KV cache) and ``forward`` trains, with flash
attention on the card (``ops/flash_attention.py``) and the remat
policies of the JAX package mapped onto ``torch.utils.checkpoint``.
Quantized leaves (int8 ``{"q","scale"}``, int4 ``{"q4","scale4"}``)
dequantize inside each layer, inside its rematerialised region, so only
one layer's float weights exist at a time and the backward recomputes
them from the quantized tree; the int4 dequant is the hand-written
kernel on the card. With ``w8a8_decode`` the cached forward keeps int8
matmul weights packed and runs them as s8×s8→s32 products on
per-token-quantized activations (W8A8).

Under a mesh (``forward(mesh=)``, ``parallel/mesh.py``) each rank holds
its shards of the tree (``param_specs``): every layer's weights are
all-gathered over ``fsdp`` inside its rematerialised region, the
projections are Megatron tensor-parallel over ``tensor`` (wq/wk/wv and
the gate/up columns, wo and w_down rows summed), the embedding and head
are vocab-parallel, and with ``context > 1`` attention is the ring. With
``pipe > 1`` the decoder stack runs through the GPipe driver
(``parallel/pipeline.py``, ``_apply_layers_pipelined``): each rank holds
its stage's layers, and the embedding, the final norm and the head stay
outside the pipeline. ``forward_with_cache(mesh=)`` serves under a mesh:
the same gathers and tensor-parallel products on a rank's block of the
batch and of the cache (``generate.cache_specs``), the logits gathered.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from odh_kubeflow_tpu_torch.ops.attention import dense_attention
from odh_kubeflow_tpu_torch.ops.flash_attention import flash_attention
from odh_kubeflow_tpu_torch.ops.norms import rms_norm
from odh_kubeflow_tpu_torch.ops.rope import apply_rope, rope_angles
from odh_kubeflow_tpu_torch.parallel import collectives as col
from odh_kubeflow_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_TENSOR,
    BATCH_AXES,
    P,
)
from odh_kubeflow_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden_size: int = 4096
    intermediate_size: int = 14_336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500_000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # "auto" resolves to "ring" under a mesh with context > 1, else to
    # "flash" on the card and "dense" on the CPU
    attention_impl: str = "auto"
    # training-side rematerialisation (``forward``; the serving path has
    # no backward pass): "none", "dots", "attn", "attn_mlp"
    remat: bool = True
    remat_policy: str = "dots"
    remat_pin_layers: Optional[int] = None
    remat_prefix_policy: str = "none"
    # the cached forward (prefill and decode) runs int8 matmul weights as
    # s8×s8 products on int8-quantized activations; training ignores it
    w8a8_decode: bool = False

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama3_1b(**kw) -> "LlamaConfig":
        """Llama-3.2-1B shape."""
        d = dict(
            hidden_size=2048,
            intermediate_size=8192,
            num_layers=16,
            num_heads=32,
            num_kv_heads=8,
            head_dim=64,
            tie_embeddings=True,
        )
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Unit-test shape: runs in milliseconds on CPU."""
        d = dict(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            remat=False,
        )
        d.update(kw)
        return LlamaConfig(**d)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def num_params(self) -> int:
        D, F, V, L = (
            self.hidden_size,
            self.intermediate_size,
            self.vocab_size,
            self.num_layers,
        )
        per_layer = (
            D * self.q_dim  # wq
            + 2 * D * self.kv_dim  # wk, wv
            + self.q_dim * D  # wo
            + 3 * D * F  # gate, up, down
            + 2 * D  # norms
        )
        head = 0 if self.tie_embeddings else D * V
        return V * D + L * per_layer + D + head

    def flops_per_token(self, seq_len: int) -> float:
        """Forward-pass matmul FLOPs per token (2*params-style estimate
        plus the quadratic attention term), for MFU accounting.

        The attention term counts only the *causally required* pairs
        (seq_len/2 keys per query on average): a causal-block-skipping
        kernel (``ops/pallas_attention.py``) computes exactly these, so
        crediting the full S^2 would inflate MFU for the flash path and
        understate how much work the dense path wastes on masked pairs.
        """
        D, F, L = self.hidden_size, self.intermediate_size, self.num_layers
        proj = 2 * (D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D + 3 * D * F)
        attn = 2 * 2 * self.num_heads * self.head_dim * (seq_len / 2)  # qk^T + av
        head = 2 * D * self.vocab_size
        embed = 0  # lookup, not a matmul
        return L * (proj + attn) + head + embed

    def attn_flops_per_token(self, seq_len: int) -> float:
        """The quadratic (qk^T + av) share of ``flops_per_token`` —
        split out so training-FLOPs accounting can treat weight matmuls
        (whose dW is skipped when the base is frozen) differently from
        attention (whose backward is required work regardless)."""
        return (
            self.num_layers
            * 2 * 2 * self.num_heads * self.head_dim * (seq_len / 2)
        )


# ---------------------------------------------------------------------------
# init


def param_shapes(cfg: LlamaConfig) -> Params:
    """``init_params``'s tree with ``(shape, fan_in)`` leaves; ``fan_in``
    is None for the norms, which start at one."""
    D, F, V, L = (
        cfg.hidden_size,
        cfg.intermediate_size,
        cfg.vocab_size,
        cfg.num_layers,
    )
    shapes: Params = {
        "embed": ((V, D), D),
        "layers": {
            "attn_norm": ((L, D), None),
            "wq": ((L, D, cfg.q_dim), D),
            "wk": ((L, D, cfg.kv_dim), D),
            "wv": ((L, D, cfg.kv_dim), D),
            "wo": ((L, cfg.q_dim, D), cfg.q_dim),
            "mlp_norm": ((L, D), None),
            "w_gate": ((L, D, F), D),
            "w_up": ((L, D, F), D),
            "w_down": ((L, F, D), F),
        },
        "final_norm": ((D,), None),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((D, V), D)
    return shapes


def init_params(
    seed: int, cfg: LlamaConfig, dtype=torch.float32, *, device="cuda", keep=None, layers=None
) -> Params:
    """Random weights in the JAX package's layout, drawn from one
    ``torch.Generator`` seeded with ``seed`` (not JAX's random bits).
    ``keep`` selects each rank's shard and ``layers`` a pipeline stage's
    layers (``init_from_shapes``)."""
    return init_from_shapes(param_shapes(cfg), seed, dtype, device=device, keep=keep,
                            layers=layers)


def _draw_step(shape, dtype, device) -> int:
    """How far one ``torch.randn(shape, dtype)`` draw moves a CUDA
    generator's Philox offset (a function of the size, read off a probe)."""
    probe = torch.Generator(device=device)
    probe.manual_seed(0)
    start = probe.get_offset()
    torch.randn(shape, generator=probe, dtype=dtype, device=device)
    return probe.get_offset() - start


def normal_layers(gen: torch.Generator, shape, num_layers: int, layers, dtype, device):
    """``(i, torch.randn(shape, dtype))`` for each layer ``i`` in ``layers``
    of ``num_layers`` drawn one after another from ``gen``. The stream is
    advanced past the other layers, not re-seeded, so a kept layer is
    bit-equal to the same layer of the whole draw: on the card by moving
    the Philox offset (nothing is drawn), on the CPU by drawing and
    dropping."""
    step = None
    for i in range(num_layers):
        if i in layers:
            yield i, torch.randn(shape, generator=gen, dtype=dtype, device=device)
        elif device.type == "cuda":
            if step is None:
                step = _draw_step(shape, dtype, device)
            gen.set_offset(gen.get_offset() + step)
        else:
            torch.randn(shape, generator=gen, dtype=dtype, device=device)


def init_from_shapes(
    shapes: Params, seed: int, dtype, *, device="cuda", keep=None, layers=None
) -> Params:
    """A ``param_shapes``-style tree of ``(shape, fan_in)`` leaves made
    real: ``normal · fan_in^-0.5``, ones where ``fan_in`` is None, each
    leaf in order from one generator; a leaf under ``layers`` (``[L,
    ...]``) one layer at a time.

    ``keep(path, tensor, per_layer)``, when given, returns the part of
    each drawn leaf (``per_layer`` False) or layer (True) to keep: every
    rank of a mesh draws the same values and keeps its shard, so the
    shards are exactly the single-device init's. ``layers`` (a range, all
    by default) are the layers a pipeline stage builds; the stream skips
    the others (``normal_layers``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    keep = keep or (lambda path, t, per_layer: t)

    def build(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = build(v, path + (k,))
                continue
            shape, fan_in = v
            where = path + (k,)
            if path[:1] != ("layers",):
                t = torch.ones(shape, dtype=dtype, device=dev) if fan_in is None else (
                    torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
                    * fan_in**-0.5).to(dtype)
                out[k] = keep(where, t, False)
                continue
            kept = range(shape[0]) if layers is None else layers
            if fan_in is None:
                parts = [torch.ones(shape[1:], dtype=dtype, device=dev) for _ in kept]
            else:
                parts = [(w * fan_in**-0.5).to(dtype) for _, w in normal_layers(
                    gen, shape[1:], shape[0], kept, torch.float32, dev)]
            out[k] = torch.stack([keep(where, t, True) for t in parts])
        return out

    return build(shapes, ())


def param_specs(cfg: LlamaConfig) -> Params:
    """The sharding of ``init_params``'s tree, spec for spec the JAX
    package's: model dims split over (fsdp, tensor), the layer axis
    replicated; the embedding vocab-sharded over (tensor, fsdp), tensor
    major."""
    specs: Params = {
        "embed": P((AXIS_TENSOR, AXIS_FSDP), None),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, AXIS_FSDP, AXIS_TENSOR),
            "wk": P(None, AXIS_FSDP, AXIS_TENSOR),
            "wv": P(None, AXIS_FSDP, AXIS_TENSOR),
            "wo": P(None, AXIS_TENSOR, AXIS_FSDP),
            "mlp_norm": P(None, None),
            "w_gate": P(None, AXIS_FSDP, AXIS_TENSOR),
            "w_up": P(None, AXIS_FSDP, AXIS_TENSOR),
            "w_down": P(None, AXIS_TENSOR, AXIS_FSDP),
        },
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(AXIS_FSDP, AXIS_TENSOR)
    return specs


# ---------------------------------------------------------------------------
# forward


# torch._int_mm on the card needs more than 16 rows, so a decode step's
# rows (one a slot, at most 16) pad to 32; above that, to a multiple of 8
INT_MM_MIN_ROWS = 32


def _quant_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 activation quant → (xq, scale). Split out
    of ``_int8_matmul`` so projections that share an input (wq/wk/wv,
    gate/up) quantize it once."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(amax.to(torch.float32), min=1e-8) / 127.0
    xq = torch.clamp(torch.round(x.to(torch.float32) / sx), -127, 127).to(torch.int8)
    return xq, sx


def _int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` of int8 operands, summed exactly in int32:
    ``torch._int_mm`` (cuBLASLt) on the card, an int32 product on the CPU.
    The reference computes it as an XLA dot, outside any Pallas kernel."""
    if not a.is_cuda:
        return a.to(torch.int32) @ b.to(torch.int32)
    M = a.shape[0]
    rows = max(INT_MM_MIN_ROWS, -(-M // 8) * 8)
    if rows != M:
        a = torch.cat([a, a.new_zeros((rows - M, a.shape[1]))])
    return torch._int_mm(a, b)[:M]


def _int8_matmul_pre(
    xq: torch.Tensor, sx: torch.Tensor, w: dict, out_dtype
) -> torch.Tensor:
    """s8×s8 product on a pre-quantized activation, rescaled by the
    activation scale times the per-channel weight scale."""
    acc = _int8_product(xq.reshape(-1, xq.shape[-1]), w["q"])
    acc = acc.reshape(*xq.shape[:-1], acc.shape[-1])
    return (acc.to(torch.float32) * sx * w["scale"][0][None, :]).to(out_dtype)


def _int8_matmul(x: torch.Tensor, w: dict, out_dtype=None) -> torch.Tensor:
    """W8A8: per-token activation quant → s8×s8 product → rescale."""
    xq, sx = _quant_act(x)
    return _int8_matmul_pre(xq, sx, w, out_dtype or x.dtype)


# tensor-parallel roles of the projections: a column-parallel product
# splits its output columns over ``tensor``, a row-parallel one its input
# rows, and sums its partial products over ``tensor``
COLUMN_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up")
ROW_PARALLEL = ("wo", "w_down")


def _maybe_lora(
    name: str, x: torch.Tensor, w, lora_layer, xq_sx=None, tp=None
) -> torch.Tensor:
    """x @ w, plus the low-rank LoRA delta when an adapter is attached.
    ``w`` may be an int8 leaf kept packed (the W8A8 path); ``xq_sx`` then
    optionally carries x already quantized (shared across projections).

    ``tp`` is the tensor-parallel group (None: one rank). A
    column-parallel product takes its replicated input through
    ``copy_to_group`` (the backward sums the input's gradient over the
    group), and so does its adapter's ``x @ a``; a row-parallel one sums
    its partial product, and its adapter's, with ``all_reduce``."""
    row = tp is not None and name in ROW_PARALLEL
    if isinstance(w, dict):
        y = _int8_matmul_pre(*xq_sx, w, x.dtype) if xq_sx is not None else _int8_matmul(x, w)
    elif row:
        y = col.all_reduce(x @ w.to(x.dtype), tp)
    else:
        y = col.copy_to_group(x, tp) @ w.to(x.dtype)
    if lora_layer is not None and name in lora_layer:
        a = lora_layer[name]["a"].to(x.dtype)  # [D, r]
        b = lora_layer[name]["b"].to(x.dtype)  # [r, out]
        scale = lora_layer[name]["scale"].to(x.dtype)
        if row:
            y = y + (col.all_reduce(x @ a, tp) @ b) * scale
        elif tp is not None:
            y = y + (col.copy_to_group(x @ a, tp) @ b) * col.copy_to_group(scale, tp)
        else:
            y = y + ((x @ a) @ b) * scale
    return y


def _maybe_dequant(tree: Params, dtype, keep_int8_matmuls: bool = False) -> Params:
    """Dequantize any {"q","scale"} (int8) or {"q4","scale4"} (int4)
    leaves one level down (the shape a per-layer slice of a quantized
    param tree has). ``keep_int8_matmuls`` leaves int8 leaves packed for
    the W8A8 path (int4 always dequantizes)."""
    from odh_kubeflow_tpu_torch.models.quant import dequantize_tensor

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"q", "scale"}:
            out[k] = v if keep_int8_matmuls else dequantize_tensor(v, dtype)
        elif isinstance(v, dict) and set(v) == {"q4", "scale4"}:
            out[k] = dequantize_tensor(v, dtype)
        else:
            out[k] = v
    return out


def _layer_slice(tree, i: int):
    """Layer ``i`` of an ``[L, ...]``-stacked tree (views, no copies)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


class Sharding:
    """What ``forward`` needs of a mesh: the fsdp, tensor and context
    groups (None where the axis has size 1) and this rank's place."""

    def __init__(self, mesh, cfg: LlamaConfig):
        t = mesh.sizes[AXIS_TENSOR]
        if cfg.num_kv_heads % t or cfg.intermediate_size % t or cfg.vocab_size % t:
            raise ValueError(
                f"tensor={t} must divide the KV heads ({cfg.num_kv_heads}), the MLP "
                f"width ({cfg.intermediate_size}) and the vocabulary ({cfg.vocab_size})"
            )
        self.dtype = cfg.dtype
        self.fsdp = mesh.group(AXIS_FSDP)
        self.tp = mesh.group(AXIS_TENSOR)
        self.context_index = mesh.coords[AXIS_CONTEXT]

    def weight(self, name: str, w):
        """One layer's projection weight as this rank computes with it:
        gathered over fsdp (its shard of the tensor split stays)."""
        return self.gather(w, name in ROW_PARALLEL)

    def gather(self, w, row: bool, lead: int = 0):
        """A ``[..., in, out]`` weight (``lead`` leading dims: an expert
        bank's E) gathered over fsdp on its fsdp-split dim: ``out`` for a
        row-parallel weight, else ``in``. An int4 row-parallel weight under
        tensor > 1 is gathered whole, packed, then dequantized and sliced:
        its split-halves packing puts two K ranges in each packed row
        shard."""
        dim = lead + (1 if row else 0)
        if not isinstance(w, dict):
            return col.all_gather(w, self.fsdp, dim)
        codes = "q4" if "q4" in w else "q"
        scale = "scale4" if codes == "q4" else "scale"
        out = {
            codes: col.gather_dim(w[codes], self.fsdp, dim),
            # the scale's contracted axis is replicated
            scale: col.gather_dim(w[scale], self.fsdp, dim) if row else w[scale],
        }
        if codes == "q4" and row and self.tp is not None:
            from odh_kubeflow_tpu_torch.models.quant import dequantize_tensor

            out["q4"] = col.gather_dim(out["q4"], self.tp, lead)
            full = dequantize_tensor(out, self.dtype)
            return full.chunk(col.group_size(self.tp), lead)[col.group_rank(self.tp)]
        return out

    def layer(self, layer: Params, lora_layer):
        """A layer's local shards made ready for its computation."""
        layer = {
            k: self.weight(k, v) if k in COLUMN_PARALLEL + ROW_PARALLEL else v
            for k, v in layer.items()
        }
        if lora_layer is not None:
            lora_layer = {k: self._adapter(k, ab) for k, ab in lora_layer.items()}
        return layer, lora_layer

    def _adapter(self, name: str, ab: dict) -> dict:
        a = col.all_gather(ab["a"], self.fsdp, 0)  # [in, r]
        b = ab["b"]  # [r, out / tensor]
        if name in ROW_PARALLEL:
            # the input is split over tensor: its rows of a; the output is
            # replicated: all of b
            a = col.scatter_to_group(a, self.tp, 0)
            b = col.gather_to_replicated(b, self.tp, 1)
        return {"a": a, "b": b, "scale": ab["scale"]}

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Vocab-parallel lookup: the table's rows are split over (tensor,
        fsdp); the fsdp gather leaves this rank's tensor range, whose
        masked lookups sum over tensor."""
        table = col.all_gather(table, self.fsdp, 0)
        if self.tp is None:
            return table[tokens]
        v0 = col.group_rank(self.tp) * table.shape[0]
        local = tokens - v0
        hit = (local >= 0) & (local < table.shape[0])
        x = table[local.clamp(0, table.shape[0] - 1)] * hit[..., None].to(table.dtype)
        return col.all_reduce(x, self.tp)

    def head(self, params: Params, cfg: LlamaConfig) -> torch.Tensor:
        """``[D, V / tensor]``: this rank's vocab columns of the head."""
        if cfg.tie_embeddings:
            return col.all_gather(params["embed"], self.fsdp, 0).T
        head = params["lm_head"]
        if isinstance(head, dict):
            head = _maybe_dequant({"lm_head": self.weight("lm_head", head)}, cfg.dtype)
            return head["lm_head"]
        return col.all_gather(head, self.fsdp, 0)

    def vocab_start(self, cfg: LlamaConfig) -> int:
        """The first vocab id of this rank's head columns."""
        return col.group_rank(self.tp) * (cfg.vocab_size // col.group_size(self.tp))


def _decoder_layer(
    cfg: LlamaConfig,
    attention_fn: Optional[Callable],
    x: torch.Tensor,  # [B, S, D]
    layer: Params,  # leaves sliced to this layer (no leading L)
    lora_layer,  # matching slice of lora params, or None
    sin: torch.Tensor,
    cos: torch.Tensor,
    segment_ids,
    cache_layer=None,  # {"k","v"}: [B, S_max, Hkv, hd] views, or None
    cache_index=None,  # int or [B] tensor: write offset into the cache
    kv_mask=None,  # [B, S_max] bool: which cache slots are valid
    save_names=(),  # activations a remat policy pins (see _tag)
    par: Optional[Sharding] = None,  # under a mesh: the layer's slices are shards
):
    """Returns ``(x, cache_layer)``. On the KV-cache path this step's
    keys and values are written into ``cache_layer`` in place and it
    attends densely over the whole cache; ``attention_fn`` serves the
    no-cache forward only."""
    if par is not None:  # the gathers run inside the remat region
        layer, lora_layer = par.layer(layer, lora_layer)
    tp = None if par is None else par.tp
    # quantized frozen weights dequantize here, inside the layer: only
    # this layer's float copy ever exists. W8A8 (cache path only) keeps
    # the int8 matmul weights packed
    keep = cache_layer is not None and cfg.w8a8_decode
    layer = _maybe_dequant(layer, cfg.dtype, keep_int8_matmuls=keep)
    x, cache_layer = attention_block(
        cfg, attention_fn, x, layer, lora_layer, sin, cos, segment_ids,
        cache_layer, cache_index, kv_mask, save_names, tp,
    )
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    # W8A8: gate and up share the MLP input, quantized once
    hq = _quant_act(h) if isinstance(layer["w_gate"], dict) else None
    gate = _maybe_lora("w_gate", h, layer["w_gate"], lora_layer, hq, tp)
    gate = _tag(gate, "mlp_g", save_names)
    up = _maybe_lora("w_up", h, layer["w_up"], lora_layer, hq, tp)
    x = x + _maybe_lora(
        "w_down", torch.nn.functional.silu(gate) * up, layer["w_down"], lora_layer, tp=tp
    )
    return x, cache_layer


def attention_block(
    cfg: LlamaConfig,
    attention_fn: Optional[Callable],
    x: torch.Tensor,
    layer: Params,  # float leaves of this layer
    lora_layer,
    sin: torch.Tensor,
    cos: torch.Tensor,
    segment_ids,
    cache_layer=None,
    cache_index=None,
    kv_mask=None,
    save_names=(),
    tp=None,  # the tensor-parallel group: this rank's heads only
):
    """The attention half of a decoder layer, shared with the MoE family:
    ``x + wo(attention(rope(q), rope(k), v))``; returns ``(x, cache_layer)``.
    Packed int8 projections (W8A8) share one quantization of their input."""
    B, S, D = x.shape
    h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    hq = _quant_act(h) if isinstance(layer["wq"], dict) else None
    q = _maybe_lora("wq", h, layer["wq"], lora_layer, hq, tp)
    kk = _maybe_lora("wk", h, layer["wk"], lora_layer, hq, tp)
    vv = _maybe_lora("wv", h, layer["wv"], lora_layer, hq, tp)
    q = q.reshape(B, S, -1, cfg.head_dim)
    kk = kk.reshape(B, S, -1, cfg.head_dim)
    vv = vv.reshape(B, S, -1, cfg.head_dim)
    q = _tag(apply_rope(q, sin, cos), "q_rope", save_names)
    kk = _tag(apply_rope(kk, sin, cos), "k_rope", save_names)
    vv = _tag(vv, "v_proj", save_names)
    if cache_layer is not None:
        attn, cache_layer = cache_write_and_attend(
            q, kk, vv, cache_layer, cache_index, kv_mask
        )
    else:
        attn = attention_fn(q, kk, vv, segment_ids=segment_ids)
    attn = _tag(attn, "attn_out", save_names).reshape(B, S, -1)
    return x + _maybe_lora("wo", attn, layer["wo"], lora_layer, tp=tp), cache_layer


def cache_write_and_attend(
    q,  # [B, S, Hq, hd]
    kk,  # [B, S, Hkv, hd] this step's keys
    vv,
    cache_layer,  # {"k","v"}: [B, S_max, Hkv, hd]
    cache_index,  # int, or [B] tensor (per-row offsets)
    kv_mask,  # [B, S_max] bool or None
):
    """Write this step's K/V at ``cache_index`` and attend over the
    whole cache with absolute positions (``kv_mask``/``q_offset`` mask
    the unwritten tail).

    The writes are in place (``cache[...] = ...``): JAX returns a new
    cache that XLA updates in place inside its scan, but eager PyTorch
    would copy the whole ``[B, S_max, Hkv, hd]`` buffer on every step.
    ``cache_layer`` holds views into the stacked cache, so the write
    lands there.

    A scalar ``cache_index`` is generate()'s layout: every row writes at
    the same physical offset (ragged prompts pad to a shared index). A
    ``[B]`` tensor gives each row its own depth.
    """
    ck, cv = cache_layer["k"], cache_layer["v"]
    S_max = ck.shape[1]
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        B, S = q.shape[0], q.shape[1]
        rows = torch.arange(B, device=q.device)
        if S == 1:
            ck[rows, cache_index] = kk[:, 0].to(ck.dtype)
            cv[rows, cache_index] = vv[:, 0].to(cv.dtype)
        else:
            # per-row offsets with a multi-token window; the clamp keeps
            # ragged rows in bounds and kv_mask excludes what lies past
            # each row's real window
            cols = torch.clamp(
                cache_index[:, None] + torch.arange(S, device=q.device)[None, :],
                0,
                S_max - 1,
            )
            ck[rows[:, None], cols] = kk.to(ck.dtype)
            cv[rows[:, None], cols] = vv.to(cv.dtype)
    else:
        S = kk.shape[1]
        # dynamic_update_slice's clamp: the window always fits the cache
        start = min(max(int(cache_index), 0), S_max - S)
        ck[:, start : start + S] = kk.to(ck.dtype)
        cv[:, start : start + S] = vv.to(cv.dtype)
    attn = dense_attention(
        q, ck, cv, causal=True, q_offset=cache_index, kv_mask=kv_mask
    )
    return attn, {"k": ck, "v": cv}


def resolved_attention_impl(cfg: LlamaConfig, device=None, mesh=None) -> str:
    """"auto" is "ring" under a mesh whose context axis is > 1 (any other
    attention would compute block-diagonal attention over the shards),
    else "flash" for a forward on the card and "dense" on the CPU (the JAX
    package's backend rule: flash on the accelerator, dense where the
    kernel would only be emulated). An explicit "flash" on CPU tensors
    runs the kernels' plain versions through the same custom ops and
    autograd; an explicit "ring" without a context axis is the
    single-device attention."""
    if cfg.attention_impl == "auto":
        if mesh is not None and mesh.sizes[AXIS_CONTEXT] > 1:
            return "ring"
        on_card = device is not None and torch.device(device).type == "cuda"
        return "flash" if on_card else "dense"
    if cfg.attention_impl in ("dense", "flash", "ring"):
        return cfg.attention_impl
    raise ValueError(
        f"unknown attention_impl {cfg.attention_impl!r}; "
        "expected 'dense', 'flash', or 'ring'"
    )


def causal_attention_fn(impl: str, mesh=None) -> Callable:
    """``fn(q, k, v, segment_ids=None)``: causal attention of the resolved
    implementation, "flash", "dense" or "ring" (over ``mesh``)."""
    if impl == "flash":
        return functools.partial(flash_attention, causal=True)
    if impl == "ring":
        from odh_kubeflow_tpu_torch.parallel.ring_attention import ring_attention

        return functools.partial(ring_attention, mesh=mesh, causal=True)

    def attention_fn(q, k, v, segment_ids=None):
        return dense_attention(q, k, v, causal=True, segment_ids=segment_ids)

    return attention_fn


def _check_supported(cfg: LlamaConfig) -> None:
    resolved_attention_impl(cfg)


class _BF16ProductF32Out(torch.autograd.Function):
    """``a @ b`` of 2-D bf16 operands on the tensor cores with an f32
    output (``torch.mm(out_dtype=)``, which has no derivative of its
    own). The backward rounds the f32 gradient to bf16 and runs bf16
    products, so it stays on the tensor cores too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        ga = g @ b.t() if ctx.needs_input_grad[0] else None
        gb = a.t() @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with float32 output: JAX's ``preferred_element_type=f32``.
    On the card bf16 operands stay bf16 (tensor cores, f32 accumulate and
    output); elsewhere the operands are upcast, which is exact, so the f32
    product is the same."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        out = _BF16ProductF32Out.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def _logits(x: torch.Tensor, head: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ head`` in ``dtype`` with float32 products and output."""
    return f32_product(x.to(dtype), head.to(dtype))


# ---------------------------------------------------------------------------
# rematerialisation


@torch.library.custom_op("odh_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """A copy of ``x`` that a remat policy can recognise by ``name``
    (JAX's ``checkpoint_name``). Used only for names the active policy
    saves, so other policies pay no copy."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, g: (g, None))


def _tag(x: torch.Tensor, name: str, save_names) -> torch.Tensor:
    return checkpoint_name(x, name) if name in save_names else x


def _remat_plan(policy: str, impl: str):
    """(ops saved by op identity, activation names saved) of a policy;
    None for "none" (a plain checkpoint: everything recomputed).

    - "dots": every matmul without batch dims (``aten.mm``: the
      projections, LoRA and MLP products), plus the flash forward's
      residuals, which JAX's dot policy adds on the flash path;
    - "attn": the flash forward's ``(out, lse2)``, so the backward never
      re-runs the O(S²) kernel; on the dense path, the attention output;
    - "attn_mlp": "attn" plus the roped q/k, v and the MLP gate.
    """
    flash = (torch.ops.odh_torch.flash_fwd.default,) if impl == "flash" else ()
    if policy == "none":
        return None
    if policy == "dots":
        return (torch.ops.aten.mm.default, *flash), ()
    if policy in ("attn", "attn_mlp"):
        names = () if flash else ("attn_out",)
        if policy == "attn_mlp":
            names += ("q_rope", "k_rope", "v_proj", "mlp_g")
        return flash, names
    if policy == "attn_offload":
        raise NotImplementedError(
            "remat_policy='attn_offload' (residuals parked in pinned host "
            "memory) is not ported yet; it is queued in ROADMAP.md"
        )
    raise ValueError(
        f"unknown remat_policy {policy!r}; expected 'dots', 'attn', "
        "'attn_mlp', 'attn_offload', or 'none'"
    )


def _make_layer_fn(
    cfg: LlamaConfig, impl: str, attention_fn: Callable, policy: str, par=None
):
    """``fn(x, layer, lora_layer, sin, cos, segment_ids) -> x``, wrapped in
    ``torch.utils.checkpoint`` per the policy when ``cfg.remat``. The
    layer's slices are views of the stacked trees and the dequant runs
    inside the region, so the recompute re-dequantizes from the
    quantized leaves instead of saving a float copy of the model."""
    if not cfg.remat:
        return lambda x, *rest: _decoder_layer(cfg, attention_fn, x, *rest, par=par)[0]
    plan = _remat_plan(policy, impl)
    names = () if plan is None else plan[1]

    def body(x, layer, lora_layer, sin, cos, segment_ids):
        return _decoder_layer(
            cfg, attention_fn, x, layer, lora_layer, sin, cos, segment_ids,
            save_names=names, par=par,
        )[0]

    return remat_wrap(body, plan)


def remat_wrap(body: Callable, plan) -> Callable:
    """``body`` as a ``torch.utils.checkpoint`` region (with grad on):
    ``plan`` is ``(ops, names)``: ops saved by identity and ``_tag`` names
    saved, everything else recomputed in the backward; None recomputes
    everything."""
    if plan is None:
        context_fn = None
    else:
        ops, names = plan
        tagged = torch.ops.odh_torch.checkpoint_name.default

        def keep(ctx, op, *args, **kwargs):
            if op in ops or (op is tagged and args[1] in names):
                return CheckpointPolicy.MUST_SAVE
            return CheckpointPolicy.PREFER_RECOMPUTE

        context_fn = functools.partial(create_selective_checkpoint_contexts, keep)

    def layer_fn(x, *rest):
        if not torch.is_grad_enabled():
            return body(x, *rest)
        kw = {} if context_fn is None else {"context_fn": context_fn}
        return checkpoint(body, x, *rest, use_reentrant=False, **kw)

    return layer_fn


def forward(
    params: Params,
    tokens: torch.Tensor,  # [B, S] integer
    cfg: LlamaConfig,
    lora: Optional[Params] = None,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    mesh=None,
    pipeline_microbatches: int = 8,
    loopback_stages: Optional[int] = None,
) -> torch.Tensor:
    """Returns logits [B, S, V] in float32, or with ``return_hidden`` the
    final-norm hidden states [B, S, D] (the chunked loss runs the head).

    Under ``mesh`` the params are this rank's shards (``param_specs``) and
    ``tokens`` its block of the batch (``batch_spec``); the logits are
    this rank's vocab columns (``Sharding.vocab_start``), and the hidden
    states enter the vocab-parallel head through ``copy_to_group``.
    Positions default to those of this rank's context block.

    Attention is ``resolved_attention_impl`` of the tokens' device. With
    ``cfg.remat`` each layer is a checkpointed region under
    ``cfg.remat_policy``; ``remat_pin_layers = n`` gives the first
    ``L - n`` layers ``remat_prefix_policy`` and the last ``n`` the named
    policy, as JAX's two scans do.

    Pipelined, when ``mesh`` has ``pipe > 1`` (or, in one process,
    ``loopback_stages`` stages), the decoder stack runs through GPipe with
    ``pipeline_microbatches`` microbatches and every layer takes
    ``cfg.remat_policy``, as JAX's pipelined stack does; under the mesh the
    params' layers are this rank's stage's and ``tokens`` its block taken
    microbatch-major (``train.data.shard_batch``)."""
    _check_supported(cfg)
    par = None if mesh is None else Sharding(mesh, cfg)
    B, S = tokens.shape
    if positions is None:
        start = 0 if par is None else par.context_index * S
        positions = (start + torch.arange(S, device=tokens.device)).expand(B, S)
    sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    table = params["embed"]
    x = (table[tokens] if par is None else par.embed(table, tokens)).to(cfg.dtype)

    impl = resolved_attention_impl(cfg, tokens.device, mesh)
    attention_fn = causal_attention_fn(impl, mesh)

    lora_layers = lora["layers"] if lora is not None else None
    if pipelined(mesh, loopback_stages):
        layer_fn = _make_layer_fn(cfg, impl, attention_fn, cfg.remat_policy, par)
        x = _apply_layers_pipelined(layer_fn, params["layers"], lora_layers, x, sin, cos,
                                    segment_ids, pipeline_microbatches, mesh, loopback_stages)
    else:
        L = cfg.num_layers
        policies = [cfg.remat_policy] * L
        pin = cfg.remat_pin_layers
        if cfg.remat and cfg.remat_policy != "none" and pin is not None and 0 < pin < L:
            policies[: L - pin] = [cfg.remat_prefix_policy] * (L - pin)
        fns = {p: _make_layer_fn(cfg, impl, attention_fn, p, par) for p in set(policies)}
        for i in range(L):
            x = fns[policies[i]](
                x,
                _layer_slice(params["layers"], i),
                _layer_slice(lora_layers, i),
                sin,
                cos,
                segment_ids,
            )

    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if par is not None:
        x = col.copy_to_group(x, par.tp)  # into the vocab-parallel head
    if return_hidden:
        return x
    head = lm_head_weight(params, cfg) if par is None else par.head(params, cfg)
    return _logits(x, head, cfg.dtype)


def pipelined(mesh, loopback_stages: Optional[int]) -> bool:
    """Whether ``forward`` runs its decoder stack through the pipeline."""
    return bool(loopback_stages) or (mesh is not None and mesh.sizes[AXIS_PIPE] > 1)


def pipeline_args(layer_fn: Callable, layers: Params, lora_layers, sin, cos, segment_ids,
                  num_microbatches: int, accumulate_aux: bool = False):
    """``(stage_fn, stage_params, aux)`` for a pipeline driver
    (``parallel/pipeline.py``) over the decoder stack: ``stage_fn`` runs a
    stage's layers in order with ``layer_fn`` (and sums the layers' scalar
    extra, the MoE aux, from a float32 zero with ``accumulate_aux``); the
    rope angles and segment ids ride ``aux``, split into the microbatches
    they belong to. Shared by the dense and MoE families."""
    M = num_microbatches
    B = sin.shape[0]

    def split(a):
        return a.reshape(M, B // M, *a.shape[1:])

    aux = {"sin": split(sin), "cos": split(cos)}
    if segment_ids is not None:
        aux["segment_ids"] = split(segment_ids)
    stage_params = {"layers": layers}
    if lora_layers is not None:
        stage_params["lora"] = lora_layers

    def stage_fn(stage, x, aux_m):
        n = stage["layers"]["attn_norm"].shape[0]  # the stage's layers
        acc = torch.zeros((), dtype=torch.float32, device=x.device) if accumulate_aux else None
        for i in range(n):
            out = layer_fn(x, _layer_slice(stage["layers"], i),
                           _layer_slice(stage.get("lora"), i), aux_m["sin"], aux_m["cos"],
                           aux_m.get("segment_ids"))
            if accumulate_aux:
                x, extra = out
                acc = acc + extra
            else:
                x = out
        return (x, acc) if accumulate_aux else x

    return stage_fn, stage_params, aux


def _apply_layers_pipelined(layer_fn: Callable, layers: Params, lora_layers, x: torch.Tensor,
                            sin, cos, segment_ids, num_microbatches: int, mesh=None,
                            loopback_stages: Optional[int] = None, accumulate_aux: bool = False):
    """The decoder stack through GPipe (counterpart of JAX's
    ``_apply_layers_pipelined``): on ``mesh``'s pipe group, or
    ``loopback_stages`` stages in one process. With ``accumulate_aux`` the
    layers' scalar (the MoE aux) is summed over every (stage, microbatch)
    pair and returned as ``(y, aux_sum / M)``, the mean of the microbatches'
    auxes."""
    from odh_kubeflow_tpu_torch.parallel import pipeline

    M = num_microbatches
    B = x.shape[0]
    if B % M:
        shards = 1 if mesh is None else mesh.size(BATCH_AXES)
        raise ValueError(f"batch {B * shards} not divisible by pipeline_microbatches={M}")
    B, S = x.shape[:2]
    stage_fn, stage_params, aux = pipeline_args(
        layer_fn, layers, lora_layers, sin.expand(B, S, -1), cos.expand(B, S, -1), segment_ids,
        M, accumulate_aux)
    kw = dict(num_microbatches=M, aux=aux, with_aux_out=accumulate_aux)
    if loopback_stages:
        out = pipeline.loopback_pipeline_apply(stage_fn, stage_params, x,
                                               num_stages=loopback_stages, **kw)
    else:
        out = pipeline.pipeline_apply(stage_fn, stage_params, x, mesh=mesh, **kw)
    if accumulate_aux:
        y, aux_sum = out
        return y, aux_sum / M
    return out


def lm_head_weight(params: Params, cfg: LlamaConfig) -> torch.Tensor:
    """[D, V] head matrix (shared with the embedding when tied),
    dequantized if the tree carries a quantized lm_head."""
    if cfg.tie_embeddings:
        return params["embed"].T
    head = params["lm_head"]
    if isinstance(head, dict):
        head = _maybe_dequant({"lm_head": head}, cfg.dtype)["lm_head"]
    return head


def forward_with_cache(
    params: Params,
    tokens: torch.Tensor,  # [B, S] (S = prompt len for prefill, 1 for decode)
    cfg: LlamaConfig,
    cache: Params,  # {"k","v"}: [L, B, S_max, Hkv, hd]
    cache_index,  # int, or [B] tensor: write offset into the cache
    *,
    positions: torch.Tensor,  # [B, S] absolute positions (rope)
    kv_mask: Optional[torch.Tensor] = None,  # [B, S_max] valid cache slots
    lora: Optional[Params] = None,
    token_mask: Optional[torch.Tensor] = None,  # accepted for family-generic
    # callers (the MoE twin routes on it; the dense stack has no router)
    mesh=None,
    batch_axes=None,  # the MoE twin's: how the rows split over the mesh
) -> tuple[torch.Tensor, Params]:
    """KV-cached forward: returns (logits [B, S, V] float32, cache).

    ``generate`` drives both prefill (S = prompt length, cache_index =
    0) and decode steps (S = 1) through here. ``cache`` is updated in
    place and returned.

    Under ``mesh`` the params are this rank's shards (``param_specs``),
    ``tokens`` and ``cache`` its block (``generate.cache_specs``: its rows,
    its KV heads): each layer's weights are gathered over fsdp, the
    projections run tensor-parallel as in ``forward`` and the cache holds
    the rank's heads; the vocab-parallel logits are gathered over tensor,
    so every rank returns whole ``[B, S, V]`` logits. W8A8 runs under a mesh
    whose tensor axis is 1 (the int8 weights gathered over fsdp, the
    products the one-device ones); under tensor > 1 it is refused: a
    row-parallel product would quantize its activation by the amax of the
    rank's columns only, where JAX's GSPMD reads the whole row's.
    """
    _check_supported(cfg)
    par = None
    if mesh is not None:
        from odh_kubeflow_tpu_torch.models.generate import check_serving_mesh

        check_serving_mesh(mesh, cfg)
        par = Sharding(mesh, cfg)
        if cfg.w8a8_decode and par.tp is not None:
            raise NotImplementedError(
                "w8a8_decode under a mesh with tensor > 1: the row-parallel products' "
                "activation quantization would read one rank's columns; serve W8A8 "
                "with tensor=1"
            )
    sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    table = params["embed"]
    x = (table[tokens] if par is None else par.embed(table, tokens)).to(cfg.dtype)
    lora_layers = lora["layers"] if lora is not None else None

    for i in range(cfg.num_layers):
        x, _ = _decoder_layer(
            cfg,
            None,  # attention_fn unused: the cache path is always dense
            x,
            _layer_slice(params["layers"], i),
            _layer_slice(lora_layers, i),
            sin,
            cos,
            None,
            cache_layer={"k": cache["k"][i], "v": cache["v"][i]},
            cache_index=cache_index,
            kv_mask=kv_mask,
            par=par,
        )

    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if cfg.w8a8_decode and isinstance(head, dict) and set(head) == {"q", "scale"}:
        # the largest decode product (D × V) as W8A8, float32 logits
        if par is not None:
            head = par.weight("lm_head", head)
        return _int8_matmul(x, head, out_dtype=torch.float32), cache
    head = lm_head_weight(params, cfg) if par is None else par.head(params, cfg)
    logits = _logits(x, head, cfg.dtype)
    if par is not None:
        logits = col.gather_dim(logits, par.tp, logits.ndim - 1)
    return logits, cache
