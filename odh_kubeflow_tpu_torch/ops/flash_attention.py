"""Flash attention, forward and backward (counterpart of
``ops/pallas_attention.py``).

``flash_attention(q, k, v)`` takes the JAX layout, ``[B, S, H, hd]``, with
GQA (``Hq % Hkv == 0``), a static ``q_offset`` and optional
``segment_ids``. Three kernels back it, each with a plain PyTorch version
in this module and a launch counter:

- ``flash_fwd`` → ``csrc/flash_fwd.cu`` (``_fwd_kernel``): ``out`` and the
  base-2 log-sum-exp ``lse2 = log2(e)·lse`` ``[B, Hq, Sq]`` f32;
- ``flash_dq`` → ``csrc/flash_bwd.cu`` (``_dq_kernel``);
- ``flash_dkv`` → ``csrc/flash_bwd.cu`` (``_dkv_kernel``), each KV head
  summing its whole GQA group.

On CUDA tensors a wrapper launches its kernel (bf16, hd 64 or 128) or
raises; on CPU tensors it runs the plain version, whatever the dtype. The
forward and backward are registered as ``torch.library`` custom ops
(``odh_torch::flash_fwd``, ``odh_torch::flash_bwd``) with the autograd
glue between them, so torch dispatch sees them: selective activation
checkpointing (``models/llama.py``, remat policy "attn") saves the
forward's ``(out, lse2)`` and never re-runs the forward in the backward.

Semantics kept from the TPU kernels: ``scale = hd**-0.5``; a base-2
softmax with f32 statistics; keys past ``Sk``, above the causal diagonal
(``q + q_offset < k``) or in another document never contribute; a row
with no live key gives zeros (and ``lse2 = -1e30``), not NaN;
``delta = rowsum(dO·O)`` is a plain f32 torch op, as JAX leaves it to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from odh_kubeflow_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
NEG_INF = -1e30  # the masked score, as in the TPU kernel
HEAD_DIMS = (64, 128)  # the kernels' template instances
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024

# kernel launches since the last reset (plain counters: the caller zeroes them)
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

_argtypes_set: set[str] = set()


def _library(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    if name in _argtypes_set:
        return lib
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    S = ctypes.POINTER(ctypes.c_longlong)
    if name == "flash_fwd":
        # q k v qseg kseg out lse | strides | B Sq Sk Hq Hkv hd causal q_offset | c | stream
        lib.flash_fwd_launch.argtypes = [P] * 7 + [S] + [I] * 8 + [F, P]
        lib.flash_fwd_launch.restype = I
    else:
        # q k v dO lse delta qseg kseg dq | strides | ... | c scale | stream
        lib.flash_dq_launch.argtypes = [P] * 9 + [S] + [I] * 8 + [F, F, P]
        lib.flash_dq_launch.restype = I
        # q k v dO lse delta qseg kseg dk dv | strides | ... | c scale | stream
        lib.flash_dkv_launch.argtypes = [P] * 10 + [S] + [I] * 8 + [F, F, P]
        lib.flash_dkv_launch.restype = I
    _argtypes_set.add(name)
    return lib


# ---------------------------------------------------------------------------
# shared checks


def _dims(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash attention takes q [B,Sq,Hq,hd] and k, v [B,Sk,Hkv,hd]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree (GQA needs Hq % Hkv == 0)"
        )
    return B, Sq, Sk, Hq, Hkv, hd


def _on_cpu(*ts) -> bool:
    return all(t is None or t.device.type == "cpu" for t in ts)


def _cuda_checks(name, tensors: dict, hd: int):
    """The kernels' contract: one CUDA device, bf16, hd 64/128, unit
    stride on hd, 16-byte aligned rows."""
    dev = None
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda" or (dev is not None and t.device != dev):
            raise ValueError(
                f"{name}: {key} is on {t.device}; every operand must be on one CUDA "
                "device (or all on the CPU)"
            )
        dev = t.device
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernels take head dim {HEAD_DIMS}, not {hd}")
    for key, t in tensors.items():
        if t is None:
            continue
        if key in ("lse", "delta"):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name}: {key} must be contiguous float32")
        elif key in ("qseg", "kseg"):
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError(f"{name}: {key} must be contiguous int32")
        else:
            if t.dtype != torch.bfloat16:
                raise TypeError(f"{name}: the kernels take bfloat16, {key} is {t.dtype}")
            st = t.stride()
            if st[3] != 1 or any(s % 8 for s in st[:3]) or t.data_ptr() % 16:
                raise ValueError(
                    f"{name}: {key} needs unit stride on hd and 16-byte aligned rows "
                    f"(strides {st})"
                )
    return dev


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _mask(B, Sq, Sk, causal, q_offset, qseg, kseg, device):
    """[B or 1, 1, 1, Sq, Sk] live-pair mask, or None when every pair is
    live (the layout of the ``[B, Hkv, group, Sq, Sk]`` scores)."""
    mask = None
    if causal:
        qpos = torch.arange(Sq, device=device)[:, None] + q_offset
        mask = (qpos >= torch.arange(Sk, device=device)[None, :])[None, None, None]
    if qseg is not None:
        seg = (qseg[:, :, None] == kseg[:, None, :])[:, None, None]
        mask = seg if mask is None else mask & seg
    return mask


def _scores(q, k, causal, q_offset, qseg, kseg):
    """Base-2 scores ``(q·k)·hd^-0.5·log2(e)`` in f32, masked to -1e30,
    as ``[B, Hkv, group, Sq, Sk]``, and the mask."""
    B, Sq, Sk, Hq, Hkv, hd = _dims(q, k, k)
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (hd**-0.5 * LOG2E)
    mask = _mask(B, Sq, Sk, causal, q_offset, qseg, kseg, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    return s, mask


# ---------------------------------------------------------------------------
# plain versions: the CPU path and the kernels' oracle on the card


def flash_fwd_reference(q, k, v, qseg=None, kseg=None, *, causal=True, q_offset=0):
    """``(out [B,Sq,Hq,hd] in q's dtype, lse2 [B,Hq,Sq] f32)``. The
    softmax runs in one pass with the row max over all keys; P is rounded
    to v's dtype before P·V, as in the kernel."""
    B, Sq, Sk, Hq, Hkv, hd = _dims(q, k, v)
    s, mask = _scores(q, k, causal, q_offset, qseg, kseg)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    out = (pv / l_safe).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)
    lse = (m + torch.log2(l_safe))[..., 0].reshape(B, Hq, Sq)
    return out, lse


def _probs(q, k, lse, causal, q_offset, qseg, kseg):
    B, Sq, Sk, Hq, Hkv, hd = _dims(q, k, k)
    s, mask = _scores(q, k, causal, q_offset, qseg, kseg)
    p = torch.exp2(s - lse.reshape(B, Hkv, Hq // Hkv, Sq)[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    return p


def _dscores(p, v, delta, do):
    B, Sq, Hq, hd = do.shape
    Hkv = v.shape[2]
    dog = do.float().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    return p * (dp - delta.reshape(B, Hkv, Hq // Hkv, Sq)[..., None]), dog


def flash_delta(out, do):
    """``delta = rowsum(dO·O)`` in f32, ``[B, Hq, Sq]`` contiguous: the
    backward kernels' row operand (a plain torch op on every device)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_dq_reference(q, k, v, lse, delta, do, qseg=None, kseg=None, *, causal=True,
                       q_offset=0):
    """dQ in q's dtype; dS is rounded to k's dtype before dS·K."""
    B, Sq, Sk, Hq, Hkv, hd = _dims(q, k, v)
    p = _probs(q, k, lse, causal, q_offset, qseg, kseg)
    ds, _ = _dscores(p, v, delta, do)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), k.float())
    return (dq * hd**-0.5).reshape(B, Sq, Hq, hd).to(q.dtype)


def flash_dkv_reference(q, k, v, lse, delta, do, qseg=None, kseg=None, *, causal=True,
                        q_offset=0):
    """(dK, dV) per KV head, each summed over its GQA group, in k's and
    v's dtypes; P and dS are rounded to the operand dtype first."""
    B, Sq, Sk, Hq, Hkv, hd = _dims(q, k, v)
    p = _probs(q, k, lse, causal, q_offset, qseg, kseg)
    ds, dog = _dscores(p, v, delta, do)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), dog)
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(), qg) * hd**-0.5
    return dk.to(k.dtype), dv.to(v.dtype)


# what each kernel is held to against its plain version, in bf16, as
# tile_rel_err: about 4x the worst readings on an H100 at the training
# shapes (2.7e-3 for the forward's out, 9.0e-4 for dQ, 6.4e-4 for dK/dV;
# chip_smoke.py, PERF.md)
TILE_RTOL = {"flash_fwd": 1e-2, "flash_dq": 4e-3, "flash_dkv": 4e-3}


def tile_rel_err(got: torch.Tensor, want: torch.Tensor, tile: int = 64) -> float:
    """How far a kernel's ``[B, S, H, hd]`` result is from its plain
    version's: the largest ``||got - want|| / ||want||`` over tiles of
    ``tile`` consecutive positions of one batch row and head (a tile whose
    ``want`` is all zero counts its absolute error). Per tile, a small
    late-row or late-key tile is held to its own scale, not to the
    largest value in the tensor."""
    d = (got.float() - want.float()).square().sum(-1)  # [B, S, H]
    w = want.float().square().sum(-1)
    B, S, H = d.shape
    pad = -S % tile
    d = torch.nn.functional.pad(d, (0, 0, 0, pad)).reshape(B, -1, tile, H).sum(2)
    w = torch.nn.functional.pad(w, (0, 0, 0, pad)).reshape(B, -1, tile, H).sum(2)
    return (d.sqrt() / torch.where(w > 0, w.sqrt(), 1.0)).max().item()


# ---------------------------------------------------------------------------
# wrappers: the kernel on the card, the plain version on the CPU


def flash_fwd(q, k, v, qseg=None, kseg=None, *, causal=True, q_offset=0):
    """``(out, lse2)``; segment ids are int32 ``[B, Sq]`` / ``[B, Sk]``."""
    global fwd_launches
    if _on_cpu(q, k, v, qseg, kseg):
        return flash_fwd_reference(q, k, v, qseg, kseg, causal=causal, q_offset=q_offset)
    B, Sq, Sk, Hq, Hkv, hd = _dims(q, k, v)
    dev = _cuda_checks("flash_fwd", dict(q=q, k=k, v=v, qseg=qseg, kseg=kseg), hd)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    lib = _library("flash_fwd")
    strides = _strides(q, k, v, out)
    with torch.cuda.device(dev):
        rc = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(qseg), _ptr(kseg),
            out.data_ptr(), lse.data_ptr(), strides,
            B, Sq, Sk, Hq, Hkv, hd, int(causal), int(q_offset), hd**-0.5 * LOG2E,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    fwd_launches += 1
    return out, lse


def flash_dq(q, k, v, lse, delta, do, qseg=None, kseg=None, *, causal=True, q_offset=0):
    global dq_launches
    if _on_cpu(q, k, v, lse, delta, do, qseg, kseg):
        return flash_dq_reference(q, k, v, lse, delta, do, qseg, kseg, causal=causal,
                                  q_offset=q_offset)
    B, Sq, Sk, Hq, Hkv, hd = _dims(q, k, v)
    dev = _cuda_checks("flash_dq", dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta,
                                        qseg=qseg, kseg=kseg), hd)
    dq = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=dev)
    lib = _library("flash_bwd")
    strides = _strides(q, k, v, do, dq)
    with torch.cuda.device(dev):
        rc = lib.flash_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(qseg), _ptr(kseg), dq.data_ptr(), strides,
            B, Sq, Sk, Hq, Hkv, hd, int(causal), int(q_offset), hd**-0.5 * LOG2E,
            hd**-0.5, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_dq kernel launch failed: CUDA error {rc}")
    dq_launches += 1
    return dq


def flash_dkv(q, k, v, lse, delta, do, qseg=None, kseg=None, *, causal=True, q_offset=0):
    global dkv_launches
    if _on_cpu(q, k, v, lse, delta, do, qseg, kseg):
        return flash_dkv_reference(q, k, v, lse, delta, do, qseg, kseg, causal=causal,
                                   q_offset=q_offset)
    B, Sq, Sk, Hq, Hkv, hd = _dims(q, k, v)
    dev = _cuda_checks("flash_dkv", dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta,
                                         qseg=qseg, kseg=kseg), hd)
    dk = torch.empty((B, Sk, Hkv, hd), dtype=k.dtype, device=dev)
    dv = torch.empty((B, Sk, Hkv, hd), dtype=v.dtype, device=dev)
    lib = _library("flash_bwd")
    strides = _strides(q, k, v, do, dk, dv)
    with torch.cuda.device(dev):
        rc = lib.flash_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(qseg), _ptr(kseg), dk.data_ptr(), dv.data_ptr(),
            strides, B, Sq, Sk, Hq, Hkv, hd, int(causal), int(q_offset),
            hd**-0.5 * LOG2E, hd**-0.5, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_dkv kernel launch failed: CUDA error {rc}")
    dkv_launches += 1
    return dk, dv


# ---------------------------------------------------------------------------
# custom ops and autograd


@torch.library.custom_op("odh_torch::flash_fwd", mutates_args=())
def flash_fwd_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    qseg: Optional[torch.Tensor],
    kseg: Optional[torch.Tensor],
    causal: bool,
    q_offset: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, qseg, kseg, causal=causal, q_offset=q_offset)


@flash_fwd_op.register_fake
def _(q, k, v, qseg, kseg, causal, q_offset):
    B, Sq, Hq, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, Hq, Sq), dtype=torch.float32)


@torch.library.custom_op("odh_torch::flash_bwd", mutates_args=())
def flash_bwd_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    qseg: Optional[torch.Tensor],
    kseg: Optional[torch.Tensor],
    causal: bool,
    q_offset: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    delta = flash_delta(out, do)
    dq = flash_dq(q, k, v, lse, delta, do, qseg, kseg, causal=causal, q_offset=q_offset)
    dk, dv = flash_dkv(q, k, v, lse, delta, do, qseg, kseg, causal=causal,
                       q_offset=q_offset)
    return dq, dk, dv


@flash_bwd_op.register_fake
def _(q, k, v, out, lse, do, qseg, kseg, causal, q_offset):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, qseg, kseg, causal, q_offset = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse, qseg, kseg)
    ctx.causal, ctx.q_offset = causal, q_offset


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse, qseg, kseg = ctx.saved_tensors
    dq, dk, dv = flash_bwd_op(
        q, k, v, out, lse, dout.contiguous(), qseg, kseg, ctx.causal, ctx.q_offset
    )
    return dq, dk, dv, None, None, None, None


flash_fwd_op.register_autograd(_backward, setup_context=_setup_context)


# ---------------------------------------------------------------------------
# public entry


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, hd]
    k: torch.Tensor,  # [B, Sk, Hkv, hd]
    v: torch.Tensor,  # [B, Sk, Hkv, hd]
    *,
    causal: bool = True,
    q_offset: int = 0,
    segment_ids: Optional[torch.Tensor] = None,  # [B, Sq]; keys use [:, :Sk]
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    bwd_block_q: Optional[int] = None,
    bwd_block_k: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention with the contract of ``dense_attention``; returns
    ``[B, Sq, Hq, hd]`` in q's dtype, differentiable in q, k and v.

    ``q_offset`` must be a static python int, as in JAX. The block
    arguments are the TPU kernels' VMEM tiling; they are accepted so that
    calls carry over unchanged and change no result here (the CUDA
    forward kernel walks 128-key tiles for 128 queries a block; dQ walks
    64-key tiles for 128 queries, dK/dV 64-query tiles for 128 keys)."""
    del block_q, block_k, bwd_block_q, bwd_block_k
    if isinstance(q_offset, bool) or not isinstance(q_offset, int):
        raise TypeError(
            "flash_attention requires a static int q_offset; use dense_attention "
            "for traced offsets (KV-cache decode)."
        )
    _, Sq, Sk, _, _, _ = _dims(q, k, v)
    qseg = kseg = None
    if segment_ids is not None:
        if segment_ids.shape[1] < max(Sq, Sk):
            raise ValueError(
                f"segment_ids {tuple(segment_ids.shape)} shorter than the sequence"
            )
        seg = segment_ids.to(device=q.device, dtype=torch.int32)
        qseg, kseg = seg[:, :Sq].contiguous(), seg[:, :Sk].contiguous()
    out, _ = flash_fwd_op(q, k, v, qseg, kseg, causal, q_offset)
    return out
