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
JAX's does.

Under a mesh (``forward(mesh=)``, ``parallel/mesh.py``) the dense leaves
shard as the Llama family's (``llama.Sharding``) and the grouped dispatch
runs expert-parallel over (data, fsdp, expert) (``_moe_mlp_grouped_ep``):
each rank holds ``E / expert`` whole experts of every bank
(``param_specs``), all-gathers its (data, fsdp) group's tokens and router
logits over ``expert``, sorts the assignments of its own experts into a
local buffer (``route_sorted_ep``), runs the same grouped kernels on its
local banks, and reduce-scatters the weighted outputs back over
``expert``. ``loopback_moe_mlp_grouped_ep`` runs the same shards one
after another on one device. The ragged and einsum dispatches, and a
grouped config's small batches, run under a mesh in JAX's GSPMD layout
(``_moe_mlp_sharded``): the banks' E over expert, D over fsdp (gathered
in the layer) and F over tensor; each row's sequence gathered over
context and the rows over expert, every row routed over all E experts,
the rank's experts' slots run tensor-parallel, and the expert shards'
outputs reduce-scattered back to the rows. ``forward_with_cache(mesh=)``
serves under a mesh (``generate.cache_specs``) with the rows replicated
over expert: the expert shards' outputs are all-reduced instead.

With ``pipe > 1`` (or ``loopback_stages``) the layer stack runs through
GPipe as the dense family's does (``llama._apply_layers_pipelined``), the
expert-parallel path inside each stage on the stage's (data, fsdp,
expert) groups; the router aux rides the pipeline's scalar channel and is
the mean of the microbatches' auxes, JAX's pipelined value (the
load-balancing loss is not linear in the batch, so it is not the
unpipelined aux).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from odh_kubeflow_tpu_torch.models import llama
from odh_kubeflow_tpu_torch.models.llama import LlamaConfig, _maybe_dequant, _tag
from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm
from odh_kubeflow_tpu_torch.ops.norms import rms_norm
from odh_kubeflow_tpu_torch.ops.rope import rope_angles
from odh_kubeflow_tpu_torch.parallel import collectives as col
from odh_kubeflow_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT,
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_TENSOR,
    BATCH_AXES,
    P,
)

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
    # the expert-parallel grouped path's row budget: each expert shard's
    # sorted buffer holds ceil(group assignments · factor / expert) rows.
    # None sizes it for the worst case (every assignment on one shard):
    # exactly dropless; a factor drops the assignments past the budget
    # (weight 0), bounded by it
    ep_capacity_factor: Optional[float] = None
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


def init_params(
    seed: int, cfg: MoeConfig, dtype=torch.float32, *, device="cuda", keep=None, layers=None
) -> Params:
    """Random weights in the JAX package's layout (not its random bits).
    ``keep`` selects each rank's shard and ``layers`` a pipeline stage's
    layers (``llama.init_from_shapes``)."""
    return llama.init_from_shapes(param_shapes(cfg), seed, dtype, device=device, keep=keep,
                                  layers=layers)


def param_specs(cfg: MoeConfig) -> Params:
    """The sharding of ``init_params``'s tree, the JAX package's: the dense
    leaves as ``llama.param_specs``, the router's D over fsdp. On the
    grouped dispatch the banks shard over ``expert`` only (the kernels
    take whole ``[K, N]`` expert blocks); on the others E, D and F split
    over expert, fsdp and tensor."""
    specs = llama.param_specs(cfg.base)
    layers = specs["layers"]
    for name in ("w_gate", "w_up", "w_down"):
        del layers[name]
    layers["router"] = P(None, AXIS_FSDP, None)
    if cfg.dispatch == "grouped":
        for name in BANKS:
            layers[name] = P(None, AXIS_EXPERT, None, None)
    else:
        layers["moe_gate"] = P(None, AXIS_EXPERT, AXIS_FSDP, AXIS_TENSOR)
        layers["moe_up"] = P(None, AXIS_EXPERT, AXIS_FSDP, AXIS_TENSOR)
        layers["moe_down"] = P(None, AXIS_EXPERT, AXIS_TENSOR, AXIS_FSDP)
    return specs


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


def _balance_sums(logits: torch.Tensor, cfg: MoeConfig, token_mask: torch.Tensor):
    """``(top_p, top_idx, (f_sum [E], p_sum [E], mask_sum))``: the top-k
    choices and the balance statistics summed over the unmasked tokens, the
    form a sharded caller sums over its peers before ``_ep_aux`` divides
    once (so the aux is the global batch's)."""
    top_p, top_idx, f, p = _routing_stats(logits, cfg, token_mask)
    ms = token_mask.to(torch.float32).sum()
    denom = ms.clamp_min(1.0)
    return top_p, top_idx, (f * denom, p * denom, ms)


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


def _onehot_routing(top_p, top_idx, C: int, E: int, token_mask=None):
    """``route_tokens``' dispatch and combine from the top-k choices of
    ``[B, S]`` tokens, with a per-row capacity ``C``."""
    B, S = top_idx.shape[:2]
    dev = top_p.device
    dispatch = torch.zeros((B, S, E, C), dtype=torch.bool, device=dev)
    combine = torch.zeros((B, S, E, C), dtype=torch.float32, device=dev)
    fill = torch.zeros((B, E), dtype=torch.long, device=dev)
    for slot in range(top_idx.shape[-1]):
        onehot = _expert_onehot(top_idx[..., slot], E, token_mask)  # [B,S,E]
        pos = onehot.cumsum(1) - onehot + fill[:, None, :]
        keep = (pos < C) & (onehot > 0)
        pos_oh = F.one_hot(pos.clamp(max=C - 1), C).to(torch.float32) * keep[..., None]
        dispatch = dispatch | (pos_oh > 0)
        combine = combine + pos_oh * top_p[..., slot, None, None] * onehot[..., None]
        fill = fill + onehot.sum(1)
    return dispatch, combine


def route_tokens(logits: torch.Tensor, cfg: MoeConfig, token_mask=None):
    """``(dispatch [B,S,E,C] bool, combine [B,S,E,C] f32, aux)``: top-k
    routing with a per-row capacity; overflow and masked tokens are
    dropped (combine weight 0)."""
    B, S, E = logits.shape
    top_p, top_idx, aux = _routing_topk(logits, cfg, token_mask)
    return (*_onehot_routing(top_p, top_idx, cfg.capacity(S), E, token_mask), aux)


def _index_tables(top_p, top_idx, C: int, E: int, token_mask=None):
    """``route_tables``' index tables from the top-k choices of ``[B, S]``
    tokens, with a per-row capacity ``C``."""
    B, S = top_idx.shape[:2]
    dev = top_p.device
    b_grid = torch.arange(B, device=dev)[:, None].expand(B, S)
    s_grid = torch.arange(S, device=dev).expand(B, S)
    idx = torch.full((B, E, C), -1, dtype=torch.long, device=dev)
    w = torch.zeros((B, E, C), dtype=torch.float32, device=dev)
    fill = torch.zeros((B, E), dtype=torch.long, device=dev)
    for slot in range(top_idx.shape[-1]):
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
    return idx, w


def route_tables(logits: torch.Tensor, cfg: MoeConfig, token_mask=None):
    """``(idx [B,E,C] long, w [B,E,C] f32, aux)``: the index-table form of
    ``route_tokens`` (same decisions): ``idx[b,e,c]`` is the token of
    expert e's slot c in row b (-1 when empty), ``w`` its weight."""
    B, S, E = logits.shape
    top_p, top_idx, aux = _routing_topk(logits, cfg, token_mask)
    return (*_index_tables(top_p, top_idx, cfg.capacity(S), E, token_mask), aux)


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


def _expert_mlp(xin, layer, dtype, tp=None):
    """The expert SwiGLU on ``[E, B, C, D]`` (einsum and ragged paths).
    ``tp``: the tensor group the banks' MLP width is split over (None: one
    rank): gate and up are column-parallel (their input enters through
    ``copy_to_group``), down row-parallel, its partial sums all-reduced."""
    xin = col.copy_to_group(xin, tp)
    gate = torch.einsum("ebcd,edf->ebcf", xin, layer["moe_gate"].to(dtype))
    up = torch.einsum("ebcd,edf->ebcf", xin, layer["moe_up"].to(dtype))
    h = F.silu(gate) * up
    return col.all_reduce(torch.einsum("ebcf,efd->ebcd", h, layer["moe_down"].to(dtype)), tp)


def _ragged_experts(x, idx, w, layer, dtype, tp=None):
    """The ragged dispatch's data movement around ``_expert_mlp``: the slots
    ``idx [B, n, C]`` of ``n`` experts (``layer``'s banks) gathered from
    ``x [B, S, D]``, run, weighted by ``w`` and scatter-added back."""
    B, S, D = x.shape
    n, C = idx.shape[1:]
    flat = idx.reshape(B, n * C)
    clip = flat.clamp(0, S - 1)
    gath = x.gather(1, clip[..., None].expand(B, n * C, D)) * (flat >= 0)[..., None].to(dtype)
    xin = gath.reshape(B, n, C, D).permute(1, 0, 2, 3)
    out_e = _expert_mlp(xin, layer, dtype, tp)
    contrib = out_e.permute(1, 0, 2, 3).reshape(B, n * C, D) * w.reshape(B, n * C, 1).to(dtype)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, n * C)
    return torch.zeros((B, S, D), dtype=dtype, device=x.device).index_put(
        (rows, clip), contrib, accumulate=True
    )


def _moe_mlp_ragged(x, layer, cfg: MoeConfig, token_mask=None, save_names=()):
    idx, w, aux = route_tables(_router_logits(x, layer), cfg, token_mask)
    idx = _tag(idx, "moe_route_src", save_names)
    w = _tag(w, "moe_route_w", save_names)
    return _ragged_experts(x, idx, w, layer, x.dtype), aux


def _exact(cfg: MoeConfig) -> MoeConfig:
    """The config at the provably drop-free capacity (per-row capacity =
    S): a grouped config's small batches take the ragged path with it."""
    return dataclasses.replace(
        cfg, capacity_factor=max(cfg.capacity_factor, cfg.num_experts / cfg.num_experts_per_tok)
    )


def _mesh_trivial(mesh) -> bool:
    """No mesh, or one whose token and model axes all have size 1."""
    return mesh is None or all(
        mesh.sizes[a] == 1
        for a in (AXIS_EXPERT, AXIS_TENSOR, AXIS_FSDP, AXIS_DATA, AXIS_CONTEXT)
    )


def _grouped_usable(x: torch.Tensor, cfg: MoeConfig, mesh=None) -> bool:
    """The one-device grouped path: enough assignments that the alignment
    padding is noise, and no mesh that shards anything. Smaller batches
    (decode steps) take the ragged path at a drop-free capacity; a
    sharded mesh takes the expert-parallel path or raises."""
    B, S, _ = x.shape
    return B * S * cfg.num_experts_per_tok >= 2048 and _mesh_trivial(mesh)


def _batch_sizes(mesh) -> dict:
    return {a: mesh.sizes[a] for a in (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT)}


def _grouped_ep_usable(x: torch.Tensor, cfg: MoeConfig, mesh) -> bool:
    """The expert-parallel grouped path: a mesh over (data, fsdp, expert)
    that shards something, with tensor = context = 1 (the kernels need the
    whole hidden and expert widths and the whole sequence), the experts
    dividing over ``expert``, the global batch ``x [B, S, D]`` over the
    three batch axes, and at least 2048 assignments a (data, fsdp) group."""
    if mesh is None or mesh.sizes[AXIS_TENSOR] > 1 or mesh.sizes[AXIS_CONTEXT] > 1:
        return False
    sizes = _batch_sizes(mesh)
    if all(v == 1 for v in sizes.values()):
        return False
    ep = sizes[AXIS_EXPERT]
    nbatch = sizes[AXIS_DATA] * sizes[AXIS_FSDP] * ep
    B, S, _ = x.shape
    if cfg.num_experts % ep or B % nbatch:
        return False
    return (B * S // (nbatch // ep)) * cfg.num_experts_per_tok >= 2048


def _grouped_mesh_blocker(x: torch.Tensor, cfg: MoeConfig, mesh) -> Optional[str]:
    """Why a large-batch grouped dispatch cannot run on ``mesh`` (``x`` the
    global activation); None when there is no mesh or a (data, fsdp)
    group's batch is small (the by-design exact ragged path). JAX's texts,
    for ``moe_mlp``'s explicit error."""
    if mesh is None:
        return None
    sizes = _batch_sizes(mesh)
    dp = sizes[AXIS_DATA] * sizes[AXIS_FSDP] * sizes[AXIS_EXPERT]
    group = sizes[AXIS_DATA] * sizes[AXIS_FSDP]
    B, S, _ = x.shape
    # the divisor _grouped_ep_usable applies: every batch the EP path would
    # take but for a real blocker reaches the error below
    if (B * S // group) * cfg.num_experts_per_tok < 2048:
        return None
    if mesh.sizes[AXIS_TENSOR] > 1 or mesh.sizes[AXIS_CONTEXT] > 1:
        return (
            "tensor/context-sharded meshes are unsupported (the grouped kernels run "
            "on full hidden/expert extents per device); keep tensor=context=1 and "
            "shard over data/fsdp/expert"
        )
    ep = sizes[AXIS_EXPERT]
    if cfg.num_experts % ep:
        return (
            f"num_experts={cfg.num_experts} is not divisible by the expert axis "
            f"extent {ep}"
        )
    if B % dp:
        return f"batch {B} is not divisible by the data×fsdp×expert extent {dp}"
    return "unsupported mesh for the grouped kernels"


def _global_activation(x: torch.Tensor, mesh, batch_axes=BATCH_AXES) -> torch.Tensor:
    """A storage-free stand-in of shape ``[B, S, D]`` for the global
    activation whose block this rank holds (``x``: its rows split over
    ``batch_axes``, its sequence over ``context``)."""
    if mesh is None:
        return x
    B, S, D = x.shape
    return torch.empty((B * mesh.size(batch_axes), S * mesh.sizes[AXIS_CONTEXT], D),
                       device="meta")


def dispatch_path(x: torch.Tensor, cfg: MoeConfig, mesh=None) -> str:
    """The path ``moe_mlp`` takes for the global activation ``x`` (any
    tensor of its shape, a meta one included) on ``mesh``: "grouped",
    "grouped_ep", "ragged_exact" (a grouped config's small batch),
    "ragged" or "einsum". Raises JAX's ``ValueError`` where the grouped
    dispatch cannot run on the mesh (never a silent fallback)."""
    if cfg.dispatch == "grouped":
        if _grouped_usable(x, cfg, mesh):
            return "grouped"
        if _grouped_ep_usable(x, cfg, mesh):
            return "grouped_ep"
        reason = _grouped_mesh_blocker(x, cfg, mesh)
        if reason is not None:
            raise ValueError(
                f"dispatch='grouped': {reason}; use dispatch='ragged' for this configuration"
            )
        return "ragged_exact"
    if cfg.dispatch in ("ragged", "einsum"):
        return cfg.dispatch
    raise ValueError(
        f"unknown dispatch {cfg.dispatch!r}; expected 'grouped', 'ragged' or 'einsum'"
    )


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


# ---------------------------------------------------------------------------
# the expert-parallel grouped path


def route_sorted_ep(logits, cfg: MoeConfig, first_expert: int, n_local: int, m_loc: int,
                    token_mask):
    """``route_sorted``'s counting sort for one expert shard: only the
    assignments to experts ``[first_expert, first_expert + n_local)`` of
    one (data, fsdp) group's tokens (``logits [N, E]``, ``token_mask
    [N]``), packed into an ``m_loc``-row buffer.

    Returns ``(src [m_loc], w_row [m_loc], w_tok [N, k], keep [N, k],
    offsets [n_local + 1] int32, inv [N, k], (f_sum [E], p_sum [E],
    mask_sum))``. Masked, non-local and over-budget assignments take no
    row: ``keep`` is False, ``w_tok`` 0 and ``inv`` 0 for them (the
    combine weighs at its gather, so they add exactly nothing). Group
    starts are ``ALIGN``-aligned and ``offsets[n_local]`` is pinned to
    ``m_loc``: the tail rows compute with the last local expert and carry
    ``w_row`` 0 and ``src`` 0. ``w_row`` (no gradient) repeats ``w_tok``
    per row for the combine's backward. The statistics are the group's
    balance sums, which the caller sums over (data, fsdp) and divides
    once, so the aux is the global batch's."""
    N, E = logits.shape
    dev = logits.device
    top_p, top_idx, stats = _balance_sums(logits[None], cfg, token_mask[None])
    top_p, top_idx = top_p[0], top_idx[0]

    counts = torch.zeros((n_local,), dtype=torch.long, device=dev)
    ranks, lsels, locals_ = [], [], []
    for slot in range(cfg.num_experts_per_tok):
        e_sel = top_idx[:, slot]
        local = (e_sel >= first_expert) & (e_sel < first_expert + n_local) & token_mask
        l_sel = (e_sel - first_expert).clamp(0, n_local - 1)
        # expert-major, as route_sorted: each scan runs along contiguous memory
        onehot = (F.one_hot(l_sel, n_local) * local[:, None]).t().contiguous()
        pos = onehot.cumsum(1) - onehot + counts[:, None]
        ranks.append(pos.gather(0, l_sel[None, :])[0])
        lsels.append(l_sel)
        locals_.append(local)
        counts = counts + onehot.sum(1)

    aligned = -(-counts // gm.ALIGN) * gm.ALIGN
    astarts = torch.cat([counts.new_zeros(1), aligned.cumsum(0)])
    offsets = astarts.clamp(max=m_loc)
    offsets[-1] = m_loc
    # one spare row past the buffer takes every dropped assignment's write
    # (JAX's mode="drop"), then goes
    src = torch.zeros((m_loc + 1,), dtype=torch.long, device=dev)
    w_row = torch.zeros((m_loc + 1,), dtype=torch.float32, device=dev)
    tok_ids = torch.arange(N, device=dev)
    invs, wtoks, keeps = [], [], []
    for slot in range(cfg.num_experts_per_tok):
        dst_raw = astarts[lsels[slot]] + ranks[slot]
        kept = locals_[slot] & (dst_raw < m_loc)
        dst = torch.where(kept, dst_raw, m_loc)
        src[dst] = tok_ids
        w_row[dst] = top_p[:, slot].detach()
        invs.append(torch.where(kept, dst_raw, 0))
        wtoks.append(torch.where(kept, top_p[:, slot], 0.0))
        keeps.append(kept)
    return (src[:m_loc], w_row[:m_loc], torch.stack(wtoks, 1), torch.stack(keeps, 1),
            offsets.to(torch.int32), torch.stack(invs, 1), stats)


class _GatherSortedEP(torch.autograd.Function):
    """``x2d[src]`` with the inverse-table transpose of ``_GatherSorted``;
    ``keep`` masks the inverse entries of dropped assignments (they point
    at row 0 and must not pull its cotangent)."""

    @staticmethod
    def forward(ctx, x2d, src, inv, keep):
        ctx.save_for_backward(inv, keep)
        return x2d.index_select(0, src)

    @staticmethod
    def backward(ctx, dxs):
        inv, keep = ctx.saved_tensors
        dx = None
        for j in range(inv.shape[1]):
            part = torch.where(keep[:, j, None], dxs.index_select(0, inv[:, j]), 0)
            dx = part if dx is None else dx + part
        return dx, None, None, None


class _CombineWeighted(torch.autograd.Function):
    """``out[t] = Σ_j w_tok[t, j] · y[inv[t, j]]``: the weight multiplies
    at the gather, so a dropped assignment (``w_tok`` 0, ``inv`` 0) adds
    exactly zero. Backward, gathers only: ``dy[r] = dout[src[r]] ·
    w_row[r]`` (a buffer row holds at most one kept assignment; padding
    and tail rows have ``w_row`` 0) and ``dw_tok[t, j] = dout[t] ·
    y[inv[t, j]]`` in float32."""

    @staticmethod
    def forward(ctx, y, w_tok, src, w_row, inv):
        ctx.save_for_backward(y, src, w_row, inv)
        out = None
        for j in range(inv.shape[1]):
            part = w_tok[:, j, None].to(y.dtype) * y.index_select(0, inv[:, j])
            out = part if out is None else out + part
        return out

    @staticmethod
    def backward(ctx, dout):
        y, src, w_row, inv = ctx.saved_tensors
        dy = dout.index_select(0, src) * w_row[:, None].to(dout.dtype)
        dw = None
        if ctx.needs_input_grad[1]:
            d32 = dout.to(torch.float32)
            dw = torch.stack([(d32 * y.index_select(0, inv[:, j]).to(torch.float32)).sum(-1)
                              for j in range(inv.shape[1])], 1)
        return dy.to(y.dtype), dw, None, None, None


def _ep_rows(n_tokens: int, cfg: MoeConfig, ep: int, n_local: int) -> int:
    """An expert shard's buffer rows for a group of ``n_tokens``: room for
    the budget and each local group's alignment padding, rounded up to
    ``DEFAULT_BM_B``. The budget is every assignment (worst case, exact)
    without ``ep_capacity_factor``, else ``ceil(N·k·factor / ep)``."""
    na = n_tokens * cfg.num_experts_per_tok
    budget = na
    if cfg.ep_capacity_factor is not None:
        budget = min(na, int(-(-na * cfg.ep_capacity_factor // ep)))
    return -(-(budget + n_local * gm.ALIGN) // gm.DEFAULT_BM_B) * gm.DEFAULT_BM_B


def _ep_shard(xg, lg, mg, banks, first: int, n_local: int, m_loc: int, cfg: MoeConfig,
              save_names=(), keep_g=True):
    """One expert shard's work on its (data, fsdp) group: the group's
    gathered tokens ``xg [N, D]``, router logits ``lg [N, E]`` and mask
    ``mg [N]``, and this shard's banks (``[n_local, ...]`` from global
    expert ``first``) in; ``(out_g [N, D], stats)`` out, where ``out_g``
    holds the weighted outputs of this shard's experts (the shards' sum is
    the layer's output) and ``stats`` the group's balance sums."""
    src, w_row, w_tok, keep, offsets, inv, stats = route_sorted_ep(
        lg, cfg, first, n_local, m_loc, mg
    )
    src, w_row, offsets, inv = (
        _tag(t, n, save_names) for t, n in zip((src, w_row, offsets, inv), ROUTE_NAMES)
    )
    xs = _GatherSortedEP.apply(xg, src, inv, keep)
    y = _grouped_expert_ffn(xs, banks, offsets, xg.dtype, save_names, keep_g)
    return _CombineWeighted.apply(y, w_tok, src, w_row, inv), stats


def _ep_aux(stats, cfg: MoeConfig, dp_group=None) -> torch.Tensor:
    """The Switch aux from a group's balance sums, summed over the (data,
    fsdp) ``dp_group`` first (never over expert: every expert shard of a
    group holds the same sums). The sum is ``col.psum``: every rank's loss
    share adds this aux, and the backward sums their gradients."""
    fs, ps, ms = stats
    E = fs.shape[0]
    if dp_group is not None:
        total = col.psum(torch.cat([fs, ps, ms[None]]), dp_group)
        fs, ps, ms = total[:E], total[E : 2 * E], total[2 * E]
    denom = ms.clamp_min(1.0)
    return E * ((fs / denom) * (ps / denom)).sum() * cfg.router_aux_loss_coef


def _expert_slice(bank, first: int, n: int):
    """Experts ``[first, first + n)`` of a ``[E, ...]`` bank (views)."""
    if _is_int8(bank):
        return {k: v[first : first + n] for k, v in bank.items()}
    return bank[first : first + n]


def _moe_mlp_grouped_ep(x, layer, cfg: MoeConfig, token_mask, mesh, save_names=(),
                        keep_g=True, batch_axes=BATCH_AXES):
    """The grouped MoE expert-parallel over (data, fsdp, expert), on one
    rank: ``x [B, S, D]`` is its batch block and ``layer``'s banks its
    ``[E / expert, ...]`` experts. The group's tokens, logits and mask are
    all-gathered over ``expert`` (backward: a reduce-scatter, so each
    token's gradient sums over the shards that took its assignments), the
    shard runs ``_ep_shard``, and its weighted outputs are
    reduce-scattered over ``expert`` back to this rank's block (backward:
    an all-gather). The router's gradient comes back through the gathered
    logits. Rows replicated over ``expert`` (``batch_axes`` without it:
    serving) are not gathered, and the shards' outputs are all-reduced.
    JAX stacks the banks of every layer for its scan (its ``bank_base``);
    the port's loop slices each layer's banks, so a rank's ``[L, E /
    expert, ...]`` shard already gives them per layer."""
    B, S, D = x.shape
    E = cfg.num_experts
    ep = mesh.sizes[AXIS_EXPERT]
    n_local = E // ep
    eg = mesh.group(AXIS_EXPERT)
    split = AXIS_EXPERT in batch_axes
    logits = _router_logits(x, layer)
    mask = torch.ones((B, S), dtype=torch.bool, device=x.device) if token_mask is None \
        else token_mask
    xg, lg, mg = x.reshape(B * S, D), logits.reshape(B * S, E), mask.reshape(B * S)
    if split:
        xg, lg = col.all_gather(xg, eg, 0), col.all_gather(lg, eg, 0)
        mg = col.gather_dim(mg.to(torch.uint8), eg, 0).bool()
    banks = {n: layer[n] for n in BANKS}
    out_g, stats = _ep_shard(
        xg, lg, mg, banks, mesh.coords[AXIS_EXPERT] * n_local, n_local,
        _ep_rows(xg.shape[0], cfg, ep, n_local), cfg, save_names, keep_g,
    )
    aux = _ep_aux(stats, cfg, _row_group(mesh, batch_axes))
    out = col.reduce_scatter(out_g, eg, 0) if split else col.all_reduce(out_g, eg)
    return out.reshape(B, S, D), aux


def _row_group(mesh, batch_axes):
    """The group of the (data, fsdp) axes the rows are split over: the
    balance sums' psum (never over expert, whose shards of a group hold
    the same sums)."""
    return mesh.group(tuple(a for a in (AXIS_DATA, AXIS_FSDP) if a in batch_axes))


def loopback_moe_mlp_grouped_ep(x, layer, cfg: MoeConfig, num_shards: int, token_mask=None,
                                save_names=(), keep_g=True):
    """``_moe_mlp_grouped_ep`` for one (data, fsdp) group on one device:
    ``x [B, S, D]`` is the group's batch and ``layer`` holds every expert;
    ``num_shards`` virtual expert shards run ``_ep_shard`` one after the
    other on their slices of the banks, and their outputs are summed
    (what the reduce-scatter sums before it splits the rows). The same
    sorting, buffers and kernel calls as the ranks'; the aux from the
    first shard's sums (every shard's are the same)."""
    B, S, D = x.shape
    E = cfg.num_experts
    if E % num_shards:
        raise ValueError(f"num_experts={E} is not divisible by {num_shards} shards")
    n_local = E // num_shards
    logits = _router_logits(x, layer)
    mask = torch.ones((B, S), dtype=torch.bool, device=x.device) if token_mask is None \
        else token_mask
    xg, lg, mg = x.reshape(B * S, D), logits.reshape(B * S, E), mask.reshape(B * S)
    m_loc = _ep_rows(B * S, cfg, num_shards, n_local)
    out = stats = None
    for s in range(num_shards):
        banks = {n: _expert_slice(layer[n], s * n_local, n_local) for n in BANKS}
        out_g, st = _ep_shard(xg, lg, mg, banks, s * n_local, n_local, m_loc, cfg,
                              save_names, keep_g)
        out = out_g if out is None else out + out_g
        stats = st if stats is None else stats
    return out.reshape(B, S, D), _ep_aux(stats, cfg)


def _moe_mlp_sharded(x, layer, cfg: MoeConfig, path: str, token_mask, mesh, batch_axes,
                     save_names=()):
    """"ragged", "einsum" and "ragged_exact" on one rank of ``mesh``, in
    JAX's layout: ``x [B, S, D]`` is this rank's block of the rows (split
    over ``batch_axes``) and of the sequence (over ``context``);
    ``layer``'s banks are its ``E / expert`` experts, gathered over fsdp
    (``shard_layer``), their MLP width split over ``tensor`` (a grouped
    config's banks split over ``expert`` only).

    Each row's whole sequence is gathered over ``context`` first: the
    per-row capacity and the position-in-expert cumsum read all of it.
    Rows split over ``expert`` (training) are gathered over it too; the
    backward of both gathers is a reduce-scatter, so each token's gradient
    sums over the ranks that read it. Routing is per row, so routing the
    gathered rows over all E experts gives the one-device decisions. The
    rank runs its own experts' slots (gate and up column-parallel over
    ``tensor``, down row-parallel and all-reduced) and scatter-adds their
    weighted outputs; the expert shards' partial outputs are
    reduce-scattered back to the rows over ``expert``, or all-reduced when
    the rows are replicated over it (serving), and the rank keeps its
    context block. The aux is the global batch's: the balance sums are
    psum'd over the (data, fsdp) axes the rows are split over."""
    E = cfg.num_experts
    n_local = E // mesh.sizes[AXIS_EXPERT]
    e0 = mesh.coords[AXIS_EXPERT] * n_local
    eg, cg = mesh.group(AXIS_EXPERT), mesh.group(AXIS_CONTEXT)
    split = AXIS_EXPERT in batch_axes
    dtype = x.dtype
    B, S_loc, D = x.shape
    mask = torch.ones((B, S_loc), dtype=torch.bool, device=x.device) if token_mask is None \
        else token_mask
    xg, mg = col.all_gather(x, cg, 1), col.gather_dim(mask.to(torch.uint8), cg, 1)
    if split:
        xg, mg = col.all_gather(xg, eg, 0), col.gather_dim(mg, eg, 0)
    mg = mg.bool()
    tm = None if token_mask is None else mg
    if path == "ragged_exact":
        cfg = _exact(cfg)
        layer = _maybe_dequant(layer, dtype)
    tp = None if cfg.dispatch == "grouped" else mesh.group(AXIS_TENSOR)
    C = cfg.capacity(xg.shape[1])
    top_p, top_idx, stats = _balance_sums(_router_logits(xg, layer), cfg, mg)
    if path == "einsum":
        dispatch, combine = _onehot_routing(top_p, top_idx, C, E, tm)
        dispatch, combine = dispatch[:, :, e0 : e0 + n_local], combine[:, :, e0 : e0 + n_local]
        out_e = _expert_mlp(torch.einsum("bsec,bsd->ebcd", dispatch.to(dtype), xg), layer,
                            dtype, tp)
        out = torch.einsum("bsec,ebcd->bsd", combine.to(dtype), out_e)
    else:
        idx, w = _index_tables(top_p, top_idx, C, E, tm)
        idx = _tag(idx[:, e0 : e0 + n_local], "moe_route_src", save_names)
        w = _tag(w[:, e0 : e0 + n_local], "moe_route_w", save_names)
        out = _ragged_experts(xg, idx, w, layer, dtype, tp)
    out = col.reduce_scatter(out, eg, 0) if split else col.all_reduce(out, eg)
    if cg is not None:
        out = out.narrow(1, col.group_rank(cg) * S_loc, S_loc)
    return out, _ep_aux(stats, cfg, _row_group(mesh, batch_axes))


def moe_mlp(x, layer, cfg: MoeConfig, token_mask=None, *, save_names=(), keep_g=True,
            mesh=None, batch_axes=BATCH_AXES):
    """``(out [B,S,D], aux)`` through ``cfg.dispatch``. ``layer`` holds
    this layer's ``router [D,E]`` and banks ``[E,...]`` (int8
    ``{"q","scale"}`` banks stay quantized on the grouped path).
    ``keep_g``: the fused expert op keeps g for its backward (see
    ``ops.grouped_matmul.expert_ffn_op``). Under ``mesh`` (``x`` this
    rank's block, its rows split over ``batch_axes``: all three batch axes
    in training, (data, fsdp) or none in serving; the router gathered
    whole, the banks this rank's experts) the path is ``dispatch_path`` of
    the global activation, and a mesh that shards anything takes the
    expert-parallel grouped path or ``_moe_mlp_sharded``."""
    path = dispatch_path(_global_activation(x, mesh, batch_axes), cfg, mesh)
    if path == "grouped":
        return _moe_mlp_grouped(x, layer, cfg, token_mask, save_names, keep_g)
    if path == "grouped_ep":
        return _moe_mlp_grouped_ep(x, layer, cfg, token_mask, mesh, save_names, keep_g,
                                   batch_axes)
    if not _mesh_trivial(mesh):
        return _moe_mlp_sharded(x, layer, cfg, path, token_mask, mesh, batch_axes, save_names)
    if path == "ragged_exact":
        # tiny batches: the ragged path at the provably drop-free capacity
        # (per-row capacity = S), exact for any S
        return _moe_mlp_ragged(x, _maybe_dequant(layer, x.dtype), _exact(cfg), token_mask,
                               save_names)
    if path == "ragged":
        return _moe_mlp_ragged(x, layer, cfg, token_mask, save_names)
    dtype = x.dtype
    dispatch, combine, aux = route_tokens(_router_logits(x, layer), cfg, token_mask)
    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(dtype), x)
    out_e = _expert_mlp(xin, layer, dtype)
    return torch.einsum("bsec,ebcd->bsd", combine.to(dtype), out_e), aux


# ---------------------------------------------------------------------------
# decoder layer and forward


def shard_layer(par, cfg: MoeConfig, layer, lora_layer):
    """A layer's local shards made ready for its computation under a mesh
    (``par``, a ``llama.Sharding``): the attention weights and the router
    gathered over fsdp, and, off the grouped dispatch, the banks too (their
    D dim; E stays split over expert and F over tensor)."""
    layer, lora_layer = par.layer(layer, lora_layer)
    layer["router"] = par.weight("router", layer["router"])
    if cfg.dispatch != "grouped":
        for n in BANKS:
            layer[n] = par.gather(layer[n], row=n == "moe_down", lead=1)
    return layer, lora_layer


def _decoder_layer(cfg: MoeConfig, attention_fn, x, layer, lora_layer, sin, cos, segment_ids,
                   save_names=(), keep_g=True, par=None, mesh=None):
    """``(x, aux)``. LoRA attaches to the attention projections only;
    int8 expert banks stay quantized on the grouped path (the kernels read
    them), every other quantized leaf dequantizes here, inside the remat
    region. Under a mesh (``par``, ``mesh``) the attention weights and the
    router are gathered over fsdp here, inside the region, and the banks
    are this rank's experts."""
    b = cfg.base
    if par is not None:
        layer, lora_layer = shard_layer(par, cfg, layer, lora_layer)
    if cfg.dispatch == "grouped":
        banks = {k: layer[k] for k in BANKS if _is_int8(layer[k])}
        rest = {k: v for k, v in layer.items() if k not in banks}
        layer = {**_maybe_dequant(rest, b.dtype), **banks}
    else:
        layer = _maybe_dequant(layer, b.dtype)
    x, _ = llama.attention_block(
        b, attention_fn, x, layer, lora_layer, sin, cos, segment_ids, save_names=save_names,
        tp=None if par is None else par.tp,
    )
    h = rms_norm(x, layer["mlp_norm"], b.rms_norm_eps)
    # packed batches mark padding with segment id 0: those tokens take no
    # expert row and no aux mass
    moe_out, aux = moe_mlp(
        h, layer, cfg, token_mask=None if segment_ids is None else segment_ids > 0,
        save_names=save_names, keep_g=keep_g, mesh=mesh,
    )
    return x + _tag(moe_out, "moe_out", save_names), aux


def _remat_plan(policy: str, impl: str, pin_acts: bool) -> Optional[llama.RematPlan]:
    """The plan of a policy, None for "none": the dense family's
    vocabulary with the MoE extras of JAX's ``forward``: every policy keeps
    the combined output, the expert output (the ``expert_ffn`` op, or
    "moe_y") and the routing, and with ``pin_acts`` the gate activation
    "moe_g"; "attn_offload" parks all that "attn" keeps in host memory."""
    if policy == "none":
        return None
    if policy not in ("dots", "attn", "attn_mlp", "attn_offload"):
        llama._remat_plan(policy, impl)  # raises, with the dense family's message
    flash = (torch.ops.odh_torch.flash_fwd.default,) if impl == "flash" else ()
    names = ("moe_out", "moe_y") + ROUTE_NAMES + (("moe_g",) if pin_acts else ())
    names += () if flash else ("attn_out",)
    if policy == "attn_mlp":
        names += ("q_rope", "k_rope", "v_proj")
    ops = flash + (torch.ops.odh_torch.expert_ffn.default,)
    if policy == "dots":
        ops += (torch.ops.aten.mm.default,)
    return llama.RematPlan(ops, names, offload=policy == "attn_offload")


def _make_layer_fn(cfg: MoeConfig, impl: str, attention_fn, policy: str, pin_acts: bool,
                   par=None, mesh=None):
    b = cfg.base
    if not b.remat:
        return lambda x, *rest: _decoder_layer(cfg, attention_fn, x, *rest, par=par, mesh=mesh)
    plan = _remat_plan(policy, impl, pin_acts)
    names = () if plan is None else plan.names
    # the fused expert op keeps g when the backward would otherwise re-run
    # it: always, except under a saving policy without the "moe_g" pin
    keep_g = plan is None or pin_acts

    def body(x, layer, lora_layer, sin, cos, segment_ids):
        return _decoder_layer(cfg, attention_fn, x, layer, lora_layer, sin, cos, segment_ids,
                              save_names=names, keep_g=keep_g, par=par, mesh=mesh)

    return llama.remat_wrap(body, plan)


def forward(
    params: Params,
    tokens: torch.Tensor,  # [B, S] integer
    cfg: MoeConfig,
    lora: Optional[Params] = None,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    mesh=None,
    pipeline_microbatches: int = 8,
    loopback_stages: Optional[int] = None,
):
    """``(logits [B,S,V] f32 — or the final-norm hidden [B,S,D] with
    return_hidden — , total aux loss)``. With ``base.remat`` each layer is
    a checkpointed region; ``remat_pin_layers = n`` keeps the policy
    (and the "moe_g" pin) on the last n layers and gives the others the
    cheap tier, as JAX's two scans do: the policy without "moe_g" when
    ``pin_expert_acts``, else "none".

    Under ``mesh`` the params are this rank's shards (``param_specs``),
    ``tokens`` its block of the batch, the logits its vocab columns, as in
    ``llama.forward(mesh=)``; the aux is the global batch's, the same on
    every rank. Pipelined as ``llama.forward``'s stack (every layer on
    ``remat_policy`` with the "moe_g" pin), the aux is the mean over the
    microbatches of each one's aux."""
    b = cfg.base
    llama._check_supported(b)
    par = None if mesh is None else llama.Sharding(mesh, b)
    B, S = tokens.shape
    if positions is None:
        start = 0 if par is None else par.context_index * S
        positions = (start + torch.arange(S, device=tokens.device)).expand(B, S)
    sin, cos = rope_angles(positions, b.head_dim, b.rope_theta)
    table = params["embed"]
    x = (table[tokens] if par is None else par.embed(table, tokens)).to(b.dtype)

    impl = llama.resolved_attention_impl(b, tokens.device, mesh)
    attention_fn = llama.causal_attention_fn(impl, mesh)

    lora_layers = lora["layers"] if lora is not None else None
    if llama.pipelined(mesh, loopback_stages):
        layer_fn = _make_layer_fn(cfg, impl, attention_fn, b.remat_policy, cfg.pin_expert_acts,
                                  par=par, mesh=mesh)
        x, aux_total = llama._apply_layers_pipelined(
            layer_fn, params["layers"], lora_layers, x, sin, cos, segment_ids,
            pipeline_microbatches, mesh, loopback_stages, accumulate_aux=True)
    else:
        L = b.num_layers
        plans = [(b.remat_policy, cfg.pin_expert_acts)] * L
        pin = b.remat_pin_layers
        if b.remat and b.remat_policy != "none" and pin is not None and 0 < pin < L:
            prefix = (b.remat_policy, False) if cfg.pin_expert_acts else ("none", False)
            plans[: L - pin] = [prefix] * (L - pin)
        fns = {p: _make_layer_fn(cfg, impl, attention_fn, *p, par=par, mesh=mesh)
               for p in set(plans)}
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
    if par is not None:
        x = col.copy_to_group(x, par.tp)  # into the vocab-parallel head
    if return_hidden:
        return x, aux_total
    head = llama.lm_head_weight(params, b) if par is None else par.head(params, b)
    return llama._logits(x, head, b.dtype), aux_total


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
    mesh=None,
    batch_axes=None,
) -> tuple[torch.Tensor, Params]:
    """KV-cached MoE forward: returns (logits [B, S, V] float32, cache),
    the cache updated in place (``llama.forward_with_cache``'s contract).

    Attention is the dense family's cache path; the MLP is the router and
    the experts through ``cfg.dispatch``. Each layer dequantizes whole,
    expert banks included, so a grouped prefill runs its products on
    float banks. Without ``token_mask``, a prefill (S > 1) routes only
    the slots ``kv_mask`` marks valid: pads must not take expert rows. A
    decode step always carries a real token. ``lora`` carries
    attention-projection adapters (the MoE-LoRA targets).

    Under ``mesh`` the attention half is the dense family's sharded cache
    path and the MLP is ``moe_mlp`` under the mesh with the rows replicated
    over expert: ``batch_axes`` are the axes the rows are split over,
    ``generate.SERVE_BATCH_AXES`` by default, none for a batch that every
    rank holds whole (an engine admission). The dispatch is JAX's
    decision on the global batch: a grouped config's decode steps and
    small prefills take the exact ragged path, and its large prefills
    raise JAX's text where the grouped kernels cannot run on the mesh."""
    b = cfg.base
    llama._check_supported(b)
    par = None
    if mesh is not None:
        from odh_kubeflow_tpu_torch.models.generate import SERVE_BATCH_AXES, check_serving_mesh

        check_serving_mesh(mesh, b)
        par = llama.Sharding(mesh, b)
        batch_axes = SERVE_BATCH_AXES if batch_axes is None else tuple(batch_axes)
    sin, cos = rope_angles(positions, b.head_dim, b.rope_theta)
    table = params["embed"]
    x = (table[tokens] if par is None else par.embed(table, tokens)).to(b.dtype)
    S = tokens.shape[1]
    if token_mask is None and kv_mask is not None and S > 1:
        token_mask = kv_mask[:, :S]
    lora_layers = lora["layers"] if lora is not None else None

    for i in range(b.num_layers):
        layer = llama._layer_slice(params["layers"], i)
        lora_layer = llama._layer_slice(lora_layers, i)
        if par is not None:
            layer, lora_layer = shard_layer(par, cfg, layer, lora_layer)
        layer = _maybe_dequant(layer, b.dtype)
        x, _ = llama.attention_block(
            b, None, x, layer, lora_layer, sin, cos, None,
            cache_layer={"k": cache["k"][i], "v": cache["v"][i]},
            cache_index=cache_index, kv_mask=kv_mask, tp=None if par is None else par.tp,
        )
        h = rms_norm(x, layer["mlp_norm"], b.rms_norm_eps)
        moe_out, _ = moe_mlp(h, layer, cfg, token_mask=token_mask, mesh=mesh,
                             batch_axes=BATCH_AXES if par is None else batch_axes)
        x = x + moe_out

    x = rms_norm(x, params["final_norm"], b.rms_norm_eps)
    if par is None:
        return llama._logits(x, llama.lm_head_weight(params, b), b.dtype), cache
    logits = llama._logits(x, par.head(params, b), b.dtype)
    return col.gather_dim(logits, par.tp, logits.ndim - 1), cache
