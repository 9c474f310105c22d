"""Sparse Mixture-of-Experts Llama, Mixtral-shaped (counterpart of
``models/moe.py``).

Every decoder layer keeps the dense family's attention
(``llama.attention_block``) and replaces its MLP with a top-k router over
E expert SwiGLU FFNs. Params are the JAX package's tree: the dense
leaves without ``w_gate/w_up/w_down``, plus ``router [L, D, E]``,
``moe_gate/moe_up [L, E, D, F]`` and ``moe_down [L, E, F, D]``.

Three dispatches, as in JAX (``MoeConfig.dispatch``):

- "einsum": the GShard one-hot ``[B, S, E, C]`` dispatch and combine, with
  a per-row capacity; the reference semantics;
- "ragged": the same routing as index tables, gather and scatter-add;
- "grouped": dropless. ``route_sorted`` counting-sorts the B·S·k
  assignments by expert into 128-aligned groups and the grouped-matmul
  ops (``ops/grouped_matmul.py``) run every assignment once
  (``expert_ffn``): on int8 banks the fused SwiGLU kernel, then the down
  projection; on float banks three grouped products, whose weight
  gradients (a full fine-tune) are ``tgmm`` launches; all hand-written
  kernels on the card. Batches of fewer than 2048 assignments (decode
  steps) take the ragged path.

``forward`` trains; ``forward_with_cache`` serves (``models/generate.py``,
``models/serve.py``), dequantizing each layer whole, banks included, as
JAX's does. The expert-parallel grouped path, the pipelined stack and
``param_specs`` wait for the port's multi-device parallelism and raise
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from odh_kubeflow_tpu_torch.models import llama
from odh_kubeflow_tpu_torch.models.llama import LlamaConfig, _maybe_dequant, _tag
from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm
from odh_kubeflow_tpu_torch.ops.norms import rms_norm
from odh_kubeflow_tpu_torch.ops.rope import rope_angles

Params = dict[str, Any]

BANKS = ("moe_gate", "moe_up", "moe_down")
# activations every MoE remat policy but "none" saves (JAX's names); the
# fused expert op's outputs are saved by op identity as "moe_y"/"moe_g"
ROUTE_NAMES = ("moe_route_src", "moe_route_w", "moe_route_offs", "moe_route_inv")


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    """MoE extension of a Llama backbone config."""

    base: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    num_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.02
    # "ragged" (index tables), "einsum" (GShard one-hot, the reference
    # form) or "grouped" (dropless sorted grouped matmul, the kernels)
    dispatch: str = "ragged"
    # with remat on, also keep the grouped path's gate activation g
    # ("moe_g", [B·S·k, F] per layer): with frozen banks the backward then
    # recomputes nothing of the expert forward
    pin_expert_acts: bool = False

    @staticmethod
    def mixtral_tiny(**kw) -> "MoeConfig":
        """Unit-test shape (Mixtral topology, milliseconds on the CPU)."""
        d = dict(base=LlamaConfig.tiny(), num_experts=4, num_experts_per_tok=2)
        d.update(kw)
        return MoeConfig(**d)

    @staticmethod
    def mixtral_8x1b(**kw) -> "MoeConfig":
        """8 experts, top-2, on the Llama-3.2-1B backbone, remat "attn"."""
        d = dict(
            base=LlamaConfig.llama3_1b(remat_policy="attn"),
            num_experts=8,
            num_experts_per_tok=2,
        )
        d.update(kw)
        return MoeConfig(**d)

    @property
    def vocab_size(self) -> int:
        return self.base.vocab_size

    def capacity(self, tokens_per_group: int) -> int:
        """Per-expert slot count for a routing group (static)."""
        c = (
            tokens_per_group
            * self.num_experts_per_tok
            * self.capacity_factor
            / self.num_experts
        )
        return max(int(-(-c // 1)), 1)

    def num_params(self) -> int:
        b = self.base
        per_layer_mlp = 3 * b.hidden_size * b.intermediate_size
        return b.num_params() + b.num_layers * (
            (self.num_experts - 1) * per_layer_mlp + b.hidden_size * self.num_experts
        )

    def flops_per_token(self, seq_len: int) -> float:
        """Forward matmul FLOPs per token: the dense model minus its MLP,
        plus k active experts and the router (strict-sparse accounting)."""
        b = self.base
        mlp = 2 * 3 * b.hidden_size * b.intermediate_size
        router = 2 * b.hidden_size * self.num_experts
        return b.flops_per_token(seq_len) + b.num_layers * (
            (self.num_experts_per_tok - 1) * mlp + router
        )

    def attn_flops_per_token(self, seq_len: int) -> float:
        """The backbone's quadratic attention share (experts replace only
        the MLP)."""
        return self.base.attn_flops_per_token(seq_len)


# ---------------------------------------------------------------------------
# params


def param_shapes(cfg: MoeConfig) -> Params:
    """``init_params``'s tree with ``(shape, fan_in)`` leaves."""
    b = cfg.base
    D, Fi, E, L = b.hidden_size, b.intermediate_size, cfg.num_experts, b.num_layers
    shapes = llama.param_shapes(b)
    layers = shapes["layers"]
    for name in ("w_gate", "w_up", "w_down"):
        del layers[name]
    layers["router"] = ((L, D, E), D)
    layers["moe_gate"] = ((L, E, D, Fi), D)
    layers["moe_up"] = ((L, E, D, Fi), D)
    layers["moe_down"] = ((L, E, Fi, D), Fi)
    return shapes


def init_params(seed: int, cfg: MoeConfig, dtype=torch.float32, *, device="cuda") -> Params:
    """Random weights in the JAX package's layout (not its random bits)."""
    return llama.init_from_shapes(param_shapes(cfg), seed, dtype, device=device)


def param_specs(cfg: MoeConfig):
    raise NotImplementedError(
        "MoE param_specs (expert-sharded banks) need multi-device parallelism, "
        "which the port does not have yet"
    )


def _is_int8(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale"}


def _unpack(bank):
    return (bank["q"], bank["scale"]) if _is_int8(bank) else (bank, None)


# ---------------------------------------------------------------------------
# routing


def _routing_stats(logits: torch.Tensor, cfg: MoeConfig, token_mask=None):
    """Renormalised top-k probs and ids, and the per-expert balance
    statistics ``(f, p)``: fraction first-routed and mean router prob,
    over the unmasked tokens."""
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    E = logits.shape[-1]
    first = F.one_hot(top_idx[..., 0], E).to(torch.float32)
    if token_mask is None:
        return top_p, top_idx, first.mean((0, 1)), probs.mean((0, 1))
    m = token_mask.to(torch.float32)[..., None]
    denom = m.sum().clamp_min(1.0)
    return top_p, top_idx, (first * m).sum((0, 1)) / denom, (probs * m).sum((0, 1)) / denom


def _routing_topk(logits, cfg: MoeConfig, token_mask=None):
    """``(top_p, top_idx, aux)``; aux is the Switch loss
    ``E · Σ f·p · coef``."""
    top_p, top_idx, f, p = _routing_stats(logits, cfg, token_mask)
    aux = logits.shape[-1] * (f * p).sum() * cfg.router_aux_loss_coef
    return top_p, top_idx, aux


def _expert_onehot(e_sel, E, token_mask):
    onehot = F.one_hot(e_sel, E)
    if token_mask is not None:
        onehot = onehot * token_mask.to(onehot.dtype)[..., None]
    return onehot


def route_tokens(logits: torch.Tensor, cfg: MoeConfig, token_mask=None):
    """``(dispatch [B,S,E,C] bool, combine [B,S,E,C] f32, aux)``: top-k
    routing with a per-row capacity; overflow and masked tokens are
    dropped (combine weight 0)."""
    B, S, E = logits.shape
    C = cfg.capacity(S)
    top_p, top_idx, aux = _routing_topk(logits, cfg, token_mask)
    dispatch = torch.zeros((B, S, E, C), dtype=torch.bool, device=logits.device)
    combine = torch.zeros((B, S, E, C), dtype=torch.float32, device=logits.device)
    fill = torch.zeros((B, E), dtype=torch.long, device=logits.device)
    for slot in range(cfg.num_experts_per_tok):
        onehot = _expert_onehot(top_idx[..., slot], E, token_mask)  # [B,S,E]
        pos = onehot.cumsum(1) - onehot + fill[:, None, :]
        keep = (pos < C) & (onehot > 0)
        pos_oh = F.one_hot(pos.clamp(max=C - 1), C).to(torch.float32) * keep[..., None]
        dispatch = dispatch | (pos_oh > 0)
        combine = combine + pos_oh * top_p[..., slot, None, None] * onehot[..., None]
        fill = fill + onehot.sum(1)
    return dispatch, combine, aux


def route_tables(logits: torch.Tensor, cfg: MoeConfig, token_mask=None):
    """``(idx [B,E,C] long, w [B,E,C] f32, aux)``: the index-table form of
    ``route_tokens`` (same decisions): ``idx[b,e,c]`` is the token of
    expert e's slot c in row b (-1 when empty), ``w`` its weight."""
    B, S, E = logits.shape
    C = cfg.capacity(S)
    top_p, top_idx, aux = _routing_topk(logits, cfg, token_mask)
    dev = logits.device
    b_grid = torch.arange(B, device=dev)[:, None].expand(B, S)
    s_grid = torch.arange(S, device=dev).expand(B, S)
    idx = torch.full((B, E, C), -1, dtype=torch.long, device=dev)
    w = torch.zeros((B, E, C), dtype=torch.float32, device=dev)
    fill = torch.zeros((B, E), dtype=torch.long, device=dev)
    for slot in range(cfg.num_experts_per_tok):
        e_sel = top_idx[..., slot]
        onehot = _expert_onehot(e_sel, E, token_mask)
        pos = onehot.cumsum(1) - onehot + fill[:, None, :]
        p_sel = pos.gather(2, e_sel[..., None])[..., 0]
        keep = p_sel < C
        if token_mask is not None:
            keep = keep & token_mask
        where = (b_grid, e_sel, p_sel.clamp(0, C - 1))
        # each kept cell receives one assignment, so an add on -1 gives s
        idx = idx.index_put(where, torch.where(keep, s_grid + 1, 0), accumulate=True)
        w = w.index_put(where, torch.where(keep, top_p[..., slot], 0.0), accumulate=True)
        fill = fill + onehot.sum(1)
    return idx, w, aux


def route_sorted(logits: torch.Tensor, cfg: MoeConfig, token_mask=None):
    """Dropless sorted-by-expert routing for the grouped path.

    Returns ``(src [M] long, w [M] f32, offsets [E+1] int32, inv [B·S, k]
    long, aux)``: row r of the sorted layout reads flat token ``src[r]``
    with combine weight ``w[r]`` (0 on padding rows); rows ``[offsets[e],
    offsets[e+1])`` are expert e's; every group start is a multiple of
    ``ALIGN`` and ``offsets[E] = M = round_up(B·S·k + E·ALIGN, 512)``, so
    the tail past the last group is computed with expert E-1's weights
    and dropped by w = 0. Masked tokens are sorted past every group with
    weight 0. ``inv[t]`` lists token t's k rows. ``w`` is built
    out of place, so it stays differentiable in the router's probs."""
    B, S, E = logits.shape
    k = cfg.num_experts_per_tok
    M = -(-(B * S * k + E * gm.ALIGN) // gm.DEFAULT_BM_B) * gm.DEFAULT_BM_B
    top_p, top_idx, aux = _routing_topk(logits, cfg, token_mask)
    dev = logits.device
    mask = None if token_mask is None else token_mask.reshape(B * S)
    tok_ids = torch.arange(B * S, device=dev)

    # counting sort: one-hot cumsums with a global running fill, expert-
    # major so each scan runs along contiguous memory (a scan over the
    # outer axis of [B·S, E] is a slow kernel on the card)
    counts = torch.zeros((E,), dtype=torch.long, device=dev)
    ranks, experts = [], []
    for slot in range(k):
        e_sel = top_idx[..., slot].reshape(B * S)
        onehot = _expert_onehot(e_sel, E, mask).t().contiguous()  # [E, B·S]
        pos = onehot.cumsum(1) - onehot + counts[:, None]
        ranks.append(pos.gather(0, e_sel[None, :])[0])
        experts.append(e_sel)
        counts = counts + onehot.sum(1)

    aligned = -(-counts // gm.ALIGN) * gm.ALIGN
    astarts = torch.cat([counts.new_zeros(1), aligned.cumsum(0)])
    offsets = torch.cat([astarts[:E], astarts.new_full((1,), M)]).to(torch.int32)

    src = torch.zeros((M,), dtype=torch.long, device=dev)
    w = torch.zeros((M,), dtype=torch.float32, device=dev)
    sent_fill = astarts[E]  # masked tokens go past every aligned group
    dsts = []
    for slot in range(k):
        e_sel, rank = experts[slot], ranks[slot]
        w_sel = top_p[..., slot].reshape(B * S)
        if mask is None:
            dst = astarts[e_sel] + rank
        else:
            n_masked = (~mask).long().cumsum(0) - (~mask).long()
            dst = torch.where(mask, astarts[e_sel] + rank, sent_fill + n_masked)
            sent_fill = sent_fill + (~mask).sum()
            w_sel = torch.where(mask, w_sel, 0.0)
        src[dst] = tok_ids
        w = w.index_put((dst,), w_sel)
        dsts.append(dst)
    return src, w, offsets, torch.stack(dsts, dim=1), aux


class _GatherSorted(torch.autograd.Function):
    """``x2d[src]`` whose transpose is a gather too: dropless routing puts
    every token exactly once per slot in the sorted layout, so
    ``dx[t] = Σ_j dxs[inv[t, j]]``; padding and masked rows carry zero
    cotangents (their combine weight is 0), so skipping them is exact."""

    @staticmethod
    def forward(ctx, x2d, src, inv):
        ctx.save_for_backward(inv)
        return x2d.index_select(0, src)

    @staticmethod
    def backward(ctx, dxs):
        (inv,) = ctx.saved_tensors
        dx = dxs.index_select(0, inv[:, 0])
        for j in range(1, inv.shape[1]):
            dx = dx + dxs.index_select(0, inv[:, j])
        return dx, None, None


class _CombineSorted(torch.autograd.Function):
    """Each token's k contributions gathered by ``inv`` and summed (no
    scatter-add); the backward gathers by ``src``. Padding rows get
    ``dout[src]`` there, which w = 0 zeroes before it reaches y, and w's
    own gradient is read back only at real rows."""

    @staticmethod
    def forward(ctx, contrib, src, inv):
        ctx.save_for_backward(src)
        out = contrib.index_select(0, inv[:, 0])
        for j in range(1, inv.shape[1]):
            out = out + contrib.index_select(0, inv[:, j])
        return out

    @staticmethod
    def backward(ctx, dout):
        (src,) = ctx.saved_tensors
        return dout.index_select(0, src), None, None


# ---------------------------------------------------------------------------
# the MoE MLP


def _router_logits(x, layer):
    return llama.f32_product(x, layer["router"].to(x.dtype))


def _expert_mlp(xin, layer, dtype):
    """The expert SwiGLU on ``[E, B, C, D]`` (einsum and ragged paths)."""
    gate = torch.einsum("ebcd,edf->ebcf", xin, layer["moe_gate"].to(dtype))
    up = torch.einsum("ebcd,edf->ebcf", xin, layer["moe_up"].to(dtype))
    h = F.silu(gate) * up
    return torch.einsum("ebcf,efd->ebcd", h, layer["moe_down"].to(dtype))


def _moe_mlp_ragged(x, layer, cfg: MoeConfig, token_mask=None, save_names=()):
    dtype = x.dtype
    B, S, D = x.shape
    E, C = cfg.num_experts, cfg.capacity(S)
    idx, w, aux = route_tables(_router_logits(x, layer), cfg, token_mask)
    idx = _tag(idx, "moe_route_src", save_names)
    w = _tag(w, "moe_route_w", save_names)
    flat = idx.reshape(B, E * C)
    clip = flat.clamp(0, S - 1)
    gath = x.gather(1, clip[..., None].expand(B, E * C, D)) * (flat >= 0)[..., None].to(dtype)
    xin = gath.reshape(B, E, C, D).permute(1, 0, 2, 3)
    out_e = _expert_mlp(xin, layer, dtype)
    contrib = out_e.permute(1, 0, 2, 3).reshape(B, E * C, D) * w.reshape(B, E * C, 1).to(dtype)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, E * C)
    out = torch.zeros((B, S, D), dtype=dtype, device=x.device).index_put(
        (rows, clip), contrib, accumulate=True
    )
    return out, aux


def _grouped_usable(x: torch.Tensor, cfg: MoeConfig) -> bool:
    """Enough assignments that the alignment padding is noise; smaller
    batches (decode steps) take the ragged path at a drop-free capacity.
    The port runs on one device, so no mesh rule applies."""
    B, S, _ = x.shape
    return B * S * cfg.num_experts_per_tok >= 2048


def _grouped_expert_ffn(xs, layer, offsets, dtype, save_names=(), keep_g=True):
    """The three expert projections on the sorted rows. One composite op,
    ``expert_ffn``, takes int8 banks whose K fits the fused kernel (fused
    gate/up/silu·mul, then the down projection) and float banks (cast to
    ``dtype``, as JAX's ``q.astype(dtype)``: three ``gmm``); u and h never
    reach a saved tensor. Other int8 banks (K past the fused kernel) take
    separate ``gmm`` products, as in JAX."""
    (gq, gs), (uq, us), (dq, ds) = (_unpack(layer[n]) for n in BANKS)
    scales = (gs, us, ds)
    if all(s is None for s in scales):
        y, _ = gm.expert_ffn_op(xs, gq.to(dtype), None, uq.to(dtype), None, dq.to(dtype), None,
                                offsets, keep_g)
        return y
    if all(s is not None for s in scales) and gm.fused_swiglu_usable(xs.shape[1]):
        y, _ = gm.expert_ffn_op(xs, gq, gs, uq, us, dq, ds, offsets, keep_g)
        return y

    def bank_gmm(lhs, q, sc):
        return gm.gmm_op(lhs, q if sc is not None else q.to(dtype), offsets, False, sc)

    g = _tag(bank_gmm(xs, gq, gs), "moe_g", save_names)
    u = _tag(bank_gmm(xs, uq, us), "moe_u", save_names)
    h = (F.silu(g.float()) * u.float()).to(dtype)
    return _tag(bank_gmm(h, dq, ds), "moe_y", save_names)


def _moe_mlp_grouped(x, layer, cfg: MoeConfig, token_mask=None, save_names=(), keep_g=True):
    dtype = x.dtype
    B, S, D = x.shape
    src, w, offsets, inv, aux = route_sorted(_router_logits(x, layer), cfg, token_mask)
    src, w, offsets, inv = (
        _tag(t, n, save_names) for t, n in zip((src, w, offsets, inv), ROUTE_NAMES)
    )
    xs = _GatherSorted.apply(x.reshape(B * S, D), src, inv)
    y = _grouped_expert_ffn(xs, layer, offsets, dtype, save_names, keep_g)
    contrib = y * w[:, None].to(dtype)
    return _CombineSorted.apply(contrib, src, inv).reshape(B, S, D), aux


def moe_mlp(x, layer, cfg: MoeConfig, token_mask=None, *, save_names=(), keep_g=True):
    """``(out [B,S,D], aux)`` through ``cfg.dispatch``. ``layer`` holds
    this layer's ``router [D,E]`` and banks ``[E,...]`` (int8
    ``{"q","scale"}`` banks stay quantized on the grouped path).
    ``keep_g``: the fused expert op keeps g for its backward (see
    ``ops.grouped_matmul.expert_ffn_op``)."""
    if cfg.dispatch == "grouped":
        if _grouped_usable(x, cfg):
            return _moe_mlp_grouped(x, layer, cfg, token_mask, save_names, keep_g)
        # tiny batches: the ragged path at the provably drop-free capacity
        # (per-row capacity = S), exact for any S
        exact = dataclasses.replace(
            cfg,
            capacity_factor=max(cfg.capacity_factor, cfg.num_experts / cfg.num_experts_per_tok),
        )
        return _moe_mlp_ragged(x, _maybe_dequant(layer, x.dtype), exact, token_mask, save_names)
    if cfg.dispatch == "ragged":
        return _moe_mlp_ragged(x, layer, cfg, token_mask, save_names)
    if cfg.dispatch != "einsum":
        raise ValueError(
            f"unknown dispatch {cfg.dispatch!r}; expected 'grouped', 'ragged' or 'einsum'"
        )
    dtype = x.dtype
    dispatch, combine, aux = route_tokens(_router_logits(x, layer), cfg, token_mask)
    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(dtype), x)
    out_e = _expert_mlp(xin, layer, dtype)
    return torch.einsum("bsec,ebcd->bsd", combine.to(dtype), out_e), aux


# ---------------------------------------------------------------------------
# decoder layer and forward


def _decoder_layer(cfg: MoeConfig, attention_fn, x, layer, lora_layer, sin, cos, segment_ids,
                   save_names=(), keep_g=True):
    """``(x, aux)``. LoRA attaches to the attention projections only;
    int8 expert banks stay quantized on the grouped path (the kernels read
    them), every other quantized leaf dequantizes here, inside the remat
    region."""
    b = cfg.base
    if cfg.dispatch == "grouped":
        banks = {k: layer[k] for k in BANKS if _is_int8(layer[k])}
        rest = {k: v for k, v in layer.items() if k not in banks}
        layer = {**_maybe_dequant(rest, b.dtype), **banks}
    else:
        layer = _maybe_dequant(layer, b.dtype)
    x, _ = llama.attention_block(
        b, attention_fn, x, layer, lora_layer, sin, cos, segment_ids, save_names=save_names
    )
    h = rms_norm(x, layer["mlp_norm"], b.rms_norm_eps)
    # packed batches mark padding with segment id 0: those tokens take no
    # expert row and no aux mass
    moe_out, aux = moe_mlp(
        h, layer, cfg, token_mask=None if segment_ids is None else segment_ids > 0,
        save_names=save_names, keep_g=keep_g,
    )
    return x + _tag(moe_out, "moe_out", save_names), aux


def _remat_plan(policy: str, impl: str, pin_acts: bool):
    """(ops saved by identity, names saved) of a policy, None for "none":
    the dense family's vocabulary with the MoE extras of JAX's
    ``forward``: every policy keeps the combined output, the expert
    output (the ``expert_ffn`` op, or "moe_y") and the routing, and with
    ``pin_acts`` the gate activation "moe_g"."""
    if policy == "none":
        return None
    if policy not in ("dots", "attn", "attn_mlp"):
        llama._remat_plan(policy, impl)  # raises, with the dense family's message
    flash = (torch.ops.odh_torch.flash_fwd.default,) if impl == "flash" else ()
    names = ("moe_out", "moe_y") + ROUTE_NAMES + (("moe_g",) if pin_acts else ())
    names += () if flash else ("attn_out",)
    if policy == "attn_mlp":
        names += ("q_rope", "k_rope", "v_proj")
    ops = flash + (torch.ops.odh_torch.expert_ffn.default,)
    if policy == "dots":
        ops += (torch.ops.aten.mm.default,)
    return ops, names


def _make_layer_fn(cfg: MoeConfig, impl: str, attention_fn, policy: str, pin_acts: bool):
    b = cfg.base
    if not b.remat:
        return lambda x, *rest: _decoder_layer(cfg, attention_fn, x, *rest)
    plan = _remat_plan(policy, impl, pin_acts)
    names = () if plan is None else plan[1]
    # the fused expert op keeps g when the backward would otherwise re-run
    # it: always, except under a saving policy without the "moe_g" pin
    keep_g = plan is None or pin_acts

    def body(x, layer, lora_layer, sin, cos, segment_ids):
        return _decoder_layer(cfg, attention_fn, x, layer, lora_layer, sin, cos, segment_ids,
                              save_names=names, keep_g=keep_g)

    return llama.remat_wrap(body, plan)


def forward(
    params: Params,
    tokens: torch.Tensor,  # [B, S] integer
    cfg: MoeConfig,
    lora: Optional[Params] = None,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
):
    """``(logits [B,S,V] f32 — or the final-norm hidden [B,S,D] with
    return_hidden — , total aux loss)``. With ``base.remat`` each layer is
    a checkpointed region; ``remat_pin_layers = n`` keeps the policy
    (and the "moe_g" pin) on the last n layers and gives the others the
    cheap tier, as JAX's two scans do: the policy without "moe_g" when
    ``pin_expert_acts``, else "none"."""
    b = cfg.base
    llama._check_supported(b)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    sin, cos = rope_angles(positions, b.head_dim, b.rope_theta)
    x = params["embed"][tokens].to(b.dtype)

    impl = llama.resolved_attention_impl(b, tokens.device)
    attention_fn = llama.causal_attention_fn(impl)

    L = b.num_layers
    plans = [(b.remat_policy, cfg.pin_expert_acts)] * L
    pin = b.remat_pin_layers
    if b.remat and b.remat_policy != "none" and pin is not None and 0 < pin < L:
        prefix = (b.remat_policy, False) if cfg.pin_expert_acts else ("none", False)
        plans[: L - pin] = [prefix] * (L - pin)
    fns = {p: _make_layer_fn(cfg, impl, attention_fn, *p) for p in set(plans)}

    lora_layers = lora["layers"] if lora is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(L):
        x, aux = fns[plans[i]](
            x,
            llama._layer_slice(params["layers"], i),
            llama._layer_slice(lora_layers, i),
            sin,
            cos,
            segment_ids,
        )
        aux_total = aux_total + aux

    x = rms_norm(x, params["final_norm"], b.rms_norm_eps)
    if return_hidden:
        return x, aux_total
    return llama._logits(x, llama.lm_head_weight(params, b), b.dtype), aux_total


def forward_with_cache(
    params: Params,
    tokens: torch.Tensor,  # [B, S] (S = prompt len for prefill, 1 for decode)
    cfg: MoeConfig,
    cache: Params,  # {"k","v"}: [L, B, S_max, Hkv, hd]
    cache_index,  # int, or [B] tensor: write offset into the cache
    *,
    positions: torch.Tensor,  # [B, S] absolute positions (rope)
    kv_mask: Optional[torch.Tensor] = None,  # [B, S_max] valid cache slots
    lora: Optional[Params] = None,
    token_mask: Optional[torch.Tensor] = None,  # [B, S] bool; False = pad
) -> tuple[torch.Tensor, Params]:
    """KV-cached MoE forward: returns (logits [B, S, V] float32, cache),
    the cache updated in place (``llama.forward_with_cache``'s contract).

    Attention is the dense family's cache path; the MLP is the router and
    the experts through ``cfg.dispatch``. Each layer dequantizes whole,
    expert banks included, so a grouped prefill runs its products on
    float banks. Without ``token_mask``, a prefill (S > 1) routes only
    the slots ``kv_mask`` marks valid: pads must not take expert rows. A
    decode step always carries a real token. ``lora`` carries
    attention-projection adapters (the MoE-LoRA targets)."""
    b = cfg.base
    llama._check_supported(b)
    sin, cos = rope_angles(positions, b.head_dim, b.rope_theta)
    x = params["embed"][tokens].to(b.dtype)
    S = tokens.shape[1]
    if token_mask is None and kv_mask is not None and S > 1:
        token_mask = kv_mask[:, :S]
    lora_layers = lora["layers"] if lora is not None else None

    for i in range(b.num_layers):
        layer = _maybe_dequant(llama._layer_slice(params["layers"], i), b.dtype)
        x, _ = llama.attention_block(
            b, None, x, layer, llama._layer_slice(lora_layers, i), sin, cos, None,
            cache_layer={"k": cache["k"][i], "v": cache["v"][i]},
            cache_index=cache_index, kv_mask=kv_mask,
        )
        h = rms_norm(x, layer["mlp_norm"], b.rms_norm_eps)
        moe_out, _ = moe_mlp(h, layer, cfg, token_mask=token_mask)
        x = x + moe_out

    x = rms_norm(x, params["final_norm"], b.rms_norm_eps)
    return llama._logits(x, llama.lm_head_weight(params, b), b.dtype), cache
