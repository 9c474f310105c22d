"""Ring attention: context-parallel attention over the ``context`` mesh
axis (counterpart of ``parallel/ring_attention.py``).

Each rank holds its query block for good; the key/value blocks (and their
segment ids) travel around the ring one neighbour a step, and the
partial outputs merge by their log-sum-exp. A rank never holds more than
one block pair's work.

The block work is the flash kernels' (``ops/flash_attention.py``):
``flash_fwd`` returns each block pair's output and base-2 lse, which
merge exactly; the backward recomputes each pair from the global lse and
``delta = rowsum(dO·O)``, as flash's own backward does, with ``flash_dq``
(dQ stays on its rank) and ``flash_dkv`` (dK/dV accumulate in float32 and
travel with their block, home after the last step). A pair is the
diagonal (causal), wholly visible (non-causal) or skipped:

- ``plain`` layout, causal: block ``s`` of rank ``r`` is the diagonal when
  ``s == r``, visible when ``s < r``, skipped when ``s > r``;
- ``zigzag`` layout (block ``i`` holds chunk ``i`` from the front of the
  sequence and chunk ``2C-1-i`` from the back, which balances causal
  work): the diagonal is causal on the whole block; below it the query
  block sees the key block's front half, above it the query block's back
  half sees the whole key block. Every half-block sub-pair is so either
  wholly visible, causal on the diagonal, or skipped.

The ring is a per-step function (``_fwd_step``, ``_bwd_step``) that a
driver feeds with the incoming block: ``_RingAttention`` over a process
group (``batch_isend_irecv``, the next block's exchange in flight during
this block's work), and ``loopback_ring_attention``, which runs C virtual
ranks in lockstep in one process, handing rank ``r`` the block of rank
``(r - t) mod C`` at step ``t`` (the card check and the tests). The dense
float32 attend of the JAX reference is the plain version: the kernels'
plain versions, which the wrappers run on CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from odh_kubeflow_tpu_torch.ops import flash_attention as fa
from odh_kubeflow_tpu_torch.parallel import collectives as col
from odh_kubeflow_tpu_torch.parallel.mesh import AXIS_CONTEXT

LAYOUTS = ("plain", "zigzag")


def _block_positions(block_idx: int, block_len: int, layout: str, num_blocks: int,
                     device=None) -> torch.Tensor:
    """Global token positions of ring block ``block_idx``: ``plain``
    blocks are contiguous, a ``zigzag`` block is chunk ``i``'s half from
    the front and the mirrored half ``2C-1-i`` from the back."""
    if layout == "plain":
        return block_idx * block_len + torch.arange(block_len, device=device)
    half = block_len // 2
    front = block_idx * half + torch.arange(half, device=device)
    back = (2 * num_blocks - 1 - block_idx) * half + torch.arange(half, device=device)
    return torch.cat([front, back])


def _zigzag_index(S: int, num_blocks: int, device=None) -> torch.Tensor:
    if S % (2 * num_blocks):
        raise ValueError(f"seq len {S} not tileable over {num_blocks} zigzag blocks")
    block_len = S // num_blocks
    return torch.cat([
        _block_positions(i, block_len, "zigzag", num_blocks, device)
        for i in range(num_blocks)
    ])


def zigzag_permute(x: torch.Tensor, num_blocks: int, axis: int = 1) -> torch.Tensor:
    """Reorder a sequence axis so contiguous shards hold the zigzag layout
    (apply to tokens, targets, masks and segment ids before a zigzag ring;
    ``zigzag_unpermute`` inverts it)."""
    return x.index_select(axis, _zigzag_index(x.shape[axis], num_blocks, x.device))


def zigzag_unpermute(x: torch.Tensor, num_blocks: int, axis: int = 1) -> torch.Tensor:
    idx = _zigzag_index(x.shape[axis], num_blocks, x.device)
    return x.index_select(axis, torch.argsort(idx))


def block_pairs(r: int, s: int, block_len: int, layout: str, causal: bool) -> list:
    """The flash calls of query block ``r`` against key block ``s``:
    ``(query slice, key slice, causal)`` each; empty when skipped."""
    every = slice(0, block_len)
    if not causal:
        return [(every, every, False)]
    if s == r:
        return [(every, every, True)]
    if layout == "plain":
        return [(every, every, False)] if s < r else []
    half = block_len // 2
    if s < r:  # the key block's front chunk precedes both query chunks
        return [(every, slice(0, half), False)]
    return [(slice(half, block_len), every, False)]  # the query's back chunk


def live_pairs(num_blocks: int, layout: str, causal: bool) -> int:
    """Flash calls a ring makes in one direction (forward, dQ or dK/dV)."""
    return sum(len(block_pairs(r, s, 2, layout, causal))
               for r in range(num_blocks) for s in range(num_blocks))


def _ops(plain: bool):
    if plain:
        return fa.flash_fwd_reference, fa.flash_dq_reference, fa.flash_dkv_reference
    return fa.flash_fwd, fa.flash_dq, fa.flash_dkv


def _seg(seg, sl):
    return None if seg is None else seg[:, sl].contiguous()


def _merge(acc, rows, o, lse):
    """Fold a block's ``(o, lse2)`` into the float32 accumulator's rows
    (the first block, a rank's own, covers every row)."""
    if acc is None:
        return [o.float(), lse]
    acc_lse = acc[1][:, :, rows]
    m = torch.maximum(acc_lse, lse)
    wa, wb = torch.exp2(acc_lse - m), torch.exp2(lse - m)
    den = wa + wb
    t = lambda w: (w / den).transpose(1, 2)[..., None]  # noqa: E731 — [B,H,S] → [B,S,H,1]
    # two passes over the output rows, in place: acc·wa/den + o·wb/den
    acc[0][:, rows].mul_(t(wa)).addcmul_(o, t(wb))
    acc[1][:, :, rows] = m + torch.log2(den)
    return acc


def _fwd_step(q, qseg, k, v, kseg, r, s, layout, causal, acc, plain=False):
    fwd = _ops(plain)[0]
    for qs, ks, c in block_pairs(r, s, q.shape[1], layout, causal):
        o, lse = fwd(q[:, qs], k[:, ks], v[:, ks], _seg(qseg, qs), _seg(kseg, ks), causal=c)
        acc = _merge(acc, qs, o, lse)
    return acc


def _bwd_step(q, qseg, do, lse, delta, k, v, kseg, r, s, layout, causal, dq, dk, dv,
              plain=False):
    _, dq_fn, dkv_fn = _ops(plain)
    for qs, ks, c in block_pairs(r, s, q.shape[1], layout, causal):
        args = (q[:, qs], k[:, ks], v[:, ks], lse[:, :, qs].contiguous(),
                delta[:, :, qs].contiguous(), do[:, qs], _seg(qseg, qs), _seg(kseg, ks))
        dq[:, qs].add_(dq_fn(*args, causal=c))  # widened to float32 in the add
        dk_b, dv_b = dkv_fn(*args, causal=c)
        dk[:, ks].add_(dk_b)
        dv[:, ks].add_(dv_b)


def _check(block_len: int, layout: str):
    if layout not in LAYOUTS:
        raise ValueError(f"unknown ring layout {layout!r}")
    if layout == "zigzag" and block_len % 2:
        raise ValueError(f"zigzag blocks split in halves; block length {block_len} is odd")


class _RingAttention(torch.autograd.Function):
    """This rank's query block against every rank's key/value block over
    the context group's ring."""

    @staticmethod
    def forward(ctx, q, k, v, seg, group, layout, causal):
        C, r = col.group_size(group), col.group_rank(group)
        blk = [k, v] + ([] if seg is None else [seg])
        acc = None
        for t in range(C):
            ex = col.ring_exchange(blk, group) if t < C - 1 else None
            kseg = blk[2] if seg is not None else None
            acc = _fwd_step(q, seg, blk[0], blk[1], kseg, r, (r - t) % C, layout, causal, acc)
            if ex is not None:
                blk = ex.wait()
        out = acc[0].to(q.dtype)
        ctx.save_for_backward(q, k, v, seg, out, acc[1])
        ctx.group, ctx.layout, ctx.causal = group, layout, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, out, lse = ctx.saved_tensors
        group, layout, causal = ctx.group, ctx.layout, ctx.causal
        C, r = col.group_size(group), col.group_rank(group)
        do = do.contiguous()
        delta = fa.flash_delta(out, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        grads = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                 torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        blk = [k, v] + ([] if seg is None else [seg])
        for t in range(C):
            ex = col.ring_exchange(blk, group) if t < C - 1 else None
            kseg = blk[2] if seg is not None else None
            _bwd_step(q, seg, do, lse, delta, blk[0], blk[1], kseg, r, (r - t) % C, layout,
                      causal, dq, grads[0], grads[1])
            if ex is not None:
                blk = ex.wait()
            # dK/dV ride with their block; after C hops they are home
            grads = col.ring_exchange(grads, group).wait()
        return dq.to(q.dtype), grads[0].to(k.dtype), grads[1].to(v.dtype), None, None, None, None


def single_device_attention(q, k, v, *, causal=True, segment_ids=None):
    """The attention of one device: the flash kernels on the card, dense
    attention on the CPU."""
    if q.is_cuda:
        return fa.flash_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    from odh_kubeflow_tpu_torch.ops.attention import dense_attention

    return dense_attention(q, k, v, causal=causal, segment_ids=segment_ids)


def ring_attention(
    q: torch.Tensor,  # [B, S/C, Hq, hd]: this rank's block of the sequence
    k: torch.Tensor,  # [B, S/C, Hkv, hd]
    v: torch.Tensor,
    *,
    mesh=None,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,  # [B, S/C]
    layout: str = "plain",  # or "zigzag" (the caller permutes the tokens)
) -> torch.Tensor:
    """Attention of this rank's query block over the whole sequence, whose
    blocks the ranks of ``mesh``'s context axis hold in order. Without a
    mesh, or at context 1, it is the single-device attention."""
    group = None if mesh is None else mesh.group(AXIS_CONTEXT)
    if group is None:
        return single_device_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    _check(q.shape[1], layout)
    seg = None if segment_ids is None else segment_ids.to(q.device, torch.int32).contiguous()
    return _RingAttention.apply(q, k, v, seg, group, layout, causal)


class _LoopbackRing(torch.autograd.Function):
    """C virtual ranks of the ring in one process, in lockstep."""

    @staticmethod
    def forward(ctx, q, k, v, seg, C, layout, causal, plain):
        qs, ks, vs = q.chunk(C, 1), k.chunk(C, 1), v.chunk(C, 1)
        segs = [None] * C if seg is None else seg.chunk(C, 1)
        acc = [None] * C
        for t in range(C):
            for r in range(C):
                s = (r - t) % C
                acc[r] = _fwd_step(qs[r], segs[r], ks[s], vs[s], segs[s], r, s, layout,
                                   causal, acc[r], plain)
        out = torch.cat([a[0] for a in acc], 1).to(q.dtype)
        lse = torch.cat([a[1] for a in acc], 2)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.C, ctx.layout, ctx.causal, ctx.plain = C, layout, causal, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, out, lse = ctx.saved_tensors
        C, layout, causal, plain = ctx.C, ctx.layout, ctx.causal, ctx.plain
        do = do.contiguous()
        delta = fa.flash_delta(out, do)
        f32 = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device)  # noqa: E731
        dq, dk, dv = f32(q), f32(k), f32(v)
        chunks = lambda t, dim=1: t.chunk(C, dim)  # noqa: E731
        qs, ks, vs, dos = chunks(q), chunks(k), chunks(v), chunks(do)
        lses, deltas = chunks(lse, 2), chunks(delta, 2)
        dqs, dks, dvs = chunks(dq), chunks(dk), chunks(dv)
        segs = [None] * C if seg is None else chunks(seg)
        for t in range(C):
            for r in range(C):
                s = (r - t) % C
                _bwd_step(qs[r], segs[r], dos[r], lses[r], deltas[r], ks[s], vs[s], segs[s],
                          r, s, layout, causal, dqs[r], dks[s], dvs[s], plain)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def loopback_ring_attention(
    q: torch.Tensor,  # [B, S, Hq, hd], the sequence in the layout's order
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_ranks: int,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    layout: str = "plain",
    plain: bool = False,
) -> torch.Tensor:
    """The ring of ``num_ranks`` ranks run in one process on the whole
    sequence (zigzag: already permuted), differentiable in q, k and v; the
    same block math as ``ring_attention``. ``plain`` runs the kernels'
    plain versions on any device (the card check's oracle)."""
    if q.shape[1] % num_ranks:
        raise ValueError(f"seq len {q.shape[1]} not tileable over {num_ranks} ranks")
    _check(q.shape[1] // num_ranks, layout)
    seg = None if segment_ids is None else segment_ids.to(q.device, torch.int32).contiguous()
    return _LoopbackRing.apply(q, k, v, seg, num_ranks, layout, causal, plain)
