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
kernel on the card.
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
    # "auto" resolves to "flash" on the card and "dense" on the CPU;
    # "ring" arrives with the multi-device slice
    attention_impl: str = "auto"
    # training-side rematerialisation (``forward``; the serving path has
    # no backward pass): "none", "dots", "attn", "attn_mlp"
    remat: bool = True
    remat_policy: str = "dots"
    remat_pin_layers: Optional[int] = None
    remat_prefix_policy: str = "none"
    # decode-path W8A8 arrives with the serving-engine slice
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
    seed: int, cfg: LlamaConfig, dtype=torch.float32, *, device="cuda"
) -> Params:
    """Random weights in the JAX package's layout, drawn from one
    ``torch.Generator`` seeded with ``seed`` (not JAX's random bits)."""
    return init_from_shapes(param_shapes(cfg), seed, dtype, device=device)


def init_from_shapes(shapes: Params, seed: int, dtype, *, device="cuda") -> Params:
    """A ``param_shapes``-style tree of ``(shape, fan_in)`` leaves made
    real: ``normal · fan_in^-0.5``, ones where ``fan_in`` is None."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def build(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = build(v)
                continue
            shape, fan_in = v
            if fan_in is None:
                out[k] = torch.ones(shape, dtype=dtype, device=dev)
            else:
                w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
                out[k] = (w * fan_in**-0.5).to(dtype)
        return out

    return build(shapes)


# ---------------------------------------------------------------------------
# forward


def _maybe_lora(name: str, x: torch.Tensor, w: torch.Tensor, lora_layer) -> torch.Tensor:
    """x @ w, plus the low-rank LoRA delta when an adapter is attached."""
    y = x @ w.to(x.dtype)
    if lora_layer is not None and name in lora_layer:
        a = lora_layer[name]["a"].to(x.dtype)  # [D, r]
        b = lora_layer[name]["b"].to(x.dtype)  # [r, out]
        scale = lora_layer[name]["scale"].to(x.dtype)
        y = y + ((x @ a) @ b) * scale
    return y


def _maybe_dequant(tree: Params, dtype) -> Params:
    """Dequantize any {"q","scale"} (int8) or {"q4","scale4"} (int4)
    leaves one level down (the shape a per-layer slice of a quantized
    param tree has)."""
    from odh_kubeflow_tpu_torch.models.quant import dequantize_tensor

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and (
            set(v) == {"q", "scale"} or set(v) == {"q4", "scale4"}
        ):
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
):
    """Returns ``(x, cache_layer)``. On the KV-cache path this step's
    keys and values are written into ``cache_layer`` in place and it
    attends densely over the whole cache; ``attention_fn`` serves the
    no-cache forward only."""
    # quantized frozen weights dequantize here, inside the layer: only
    # this layer's float copy ever exists
    layer = _maybe_dequant(layer, cfg.dtype)
    x, cache_layer = attention_block(
        cfg, attention_fn, x, layer, lora_layer, sin, cos, segment_ids,
        cache_layer, cache_index, kv_mask, save_names,
    )
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    gate = _tag(_maybe_lora("w_gate", h, layer["w_gate"], lora_layer), "mlp_g", save_names)
    up = _maybe_lora("w_up", h, layer["w_up"], lora_layer)
    x = x + _maybe_lora(
        "w_down", torch.nn.functional.silu(gate) * up, layer["w_down"], lora_layer
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
):
    """The attention half of a decoder layer, shared with the MoE family:
    ``x + wo(attention(rope(q), rope(k), v))``; returns ``(x, cache_layer)``."""
    B, S, D = x.shape
    h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    q = _maybe_lora("wq", h, layer["wq"], lora_layer)
    kk = _maybe_lora("wk", h, layer["wk"], lora_layer)
    vv = _maybe_lora("wv", h, layer["wv"], lora_layer)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    kk = kk.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    vv = vv.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q = _tag(apply_rope(q, sin, cos), "q_rope", save_names)
    kk = _tag(apply_rope(kk, sin, cos), "k_rope", save_names)
    vv = _tag(vv, "v_proj", save_names)
    if cache_layer is not None:
        attn, cache_layer = cache_write_and_attend(
            q, kk, vv, cache_layer, cache_index, kv_mask
        )
    else:
        attn = attention_fn(q, kk, vv, segment_ids=segment_ids)
    attn = _tag(attn, "attn_out", save_names).reshape(B, S, cfg.q_dim)
    return x + _maybe_lora("wo", attn, layer["wo"], lora_layer), cache_layer


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


def resolved_attention_impl(cfg: LlamaConfig, device=None) -> str:
    """"auto" is "flash" for a forward on the card and "dense" on the CPU
    (the JAX package's backend rule: flash on the accelerator, dense
    where the kernel would only be emulated). An explicit "flash" on CPU
    tensors runs the kernels' plain versions through the same custom ops
    and autograd."""
    if cfg.attention_impl == "auto":
        on_card = device is not None and torch.device(device).type == "cuda"
        return "flash" if on_card else "dense"
    if cfg.attention_impl in ("dense", "flash"):
        return cfg.attention_impl
    if cfg.attention_impl == "ring":
        raise NotImplementedError(
            "attention_impl='ring' arrives with the multi-device slice of "
            "the port (context-parallel ring attention over NCCL)"
        )
    raise ValueError(
        f"unknown attention_impl {cfg.attention_impl!r}; "
        "expected 'dense', 'flash', or 'ring'"
    )


def causal_attention_fn(impl: str) -> Callable:
    """``fn(q, k, v, segment_ids=None)``: causal attention of the resolved
    implementation, "flash" or "dense"."""
    if impl == "flash":
        return functools.partial(flash_attention, causal=True)

    def attention_fn(q, k, v, segment_ids=None):
        return dense_attention(q, k, v, causal=True, segment_ids=segment_ids)

    return attention_fn


def _check_supported(cfg: LlamaConfig) -> None:
    resolved_attention_impl(cfg)
    if cfg.w8a8_decode:
        raise NotImplementedError(
            "w8a8_decode arrives with the serving-engine slice of the port "
            "(continuous batching, speculative decoding and W8A8)"
        )


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


def _make_layer_fn(cfg: LlamaConfig, impl: str, attention_fn: Callable, policy: str):
    """``fn(x, layer, lora_layer, sin, cos, segment_ids) -> x``, wrapped in
    ``torch.utils.checkpoint`` per the policy when ``cfg.remat``. The
    layer's slices are views of the stacked trees and the dequant runs
    inside the region, so the recompute re-dequantizes from the
    quantized leaves instead of saving a float copy of the model."""
    if not cfg.remat:
        return lambda x, *rest: _decoder_layer(cfg, attention_fn, x, *rest)[0]
    plan = _remat_plan(policy, impl)
    names = () if plan is None else plan[1]

    def body(x, layer, lora_layer, sin, cos, segment_ids):
        return _decoder_layer(
            cfg, attention_fn, x, layer, lora_layer, sin, cos, segment_ids,
            save_names=names,
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
) -> torch.Tensor:
    """Returns logits [B, S, V] in float32, or with ``return_hidden`` the
    final-norm hidden states [B, S, D] (the chunked loss runs the head).

    Attention is ``resolved_attention_impl`` of the tokens' device. With
    ``cfg.remat`` each layer is a checkpointed region under
    ``cfg.remat_policy``; ``remat_pin_layers = n`` gives the first
    ``L - n`` layers ``remat_prefix_policy`` and the last ``n`` the named
    policy, as JAX's two scans do."""
    _check_supported(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    x = params["embed"][tokens].to(cfg.dtype)

    impl = resolved_attention_impl(cfg, tokens.device)
    attention_fn = causal_attention_fn(impl)

    L = cfg.num_layers
    policies = [cfg.remat_policy] * L
    pin = cfg.remat_pin_layers
    if cfg.remat and cfg.remat_policy != "none" and pin is not None and 0 < pin < L:
        policies[: L - pin] = [cfg.remat_prefix_policy] * (L - pin)
    fns = {p: _make_layer_fn(cfg, impl, attention_fn, p) for p in set(policies)}

    lora_layers = lora["layers"] if lora is not None else None
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
    if return_hidden:
        return x
    return _logits(x, lm_head_weight(params, cfg), cfg.dtype)


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
) -> tuple[torch.Tensor, Params]:
    """KV-cached forward: returns (logits [B, S, V] float32, cache).

    ``generate`` drives both prefill (S = prompt length, cache_index =
    0) and decode steps (S = 1) through here. ``cache`` is updated in
    place and returned.
    """
    _check_supported(cfg)
    sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    x = params["embed"][tokens].to(cfg.dtype)
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
        )

    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(x, lm_head_weight(params, cfg), cfg.dtype), cache
