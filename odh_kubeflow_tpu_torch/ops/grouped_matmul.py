"""Grouped matmul for dropless MoE (counterpart of
``ops/pallas_grouped_matmul.py``).

``gmm(lhs, rhs, offsets)`` multiplies row groups of ``lhs [M, K]`` by
per-expert matrices: rows ``[offsets[e], offsets[e+1])`` go through
``rhs[e]`` (``[E, K, N]``, or ``[E, N, K]`` with ``trans_rhs``). The
caller's counting sort (``models/moe.py`` ``route_sorted``) pads every
group start to a multiple of ``ALIGN`` and pins ``offsets[E] = M``, so
each 128-row tile belongs to exactly one expert.

Four kernels back this module, each with a plain PyTorch version here
and a launch counter:

- ``gmm`` → ``csrc/gmm.cu`` (``_gmm_a_kernel``, ``_gmm_a_kernel_q`` and
  ``_gmm_b_kernel``): a bf16 bank, or an int8 bank with its per-channel
  scale ``[E, 1, bank-last-axis]``; a persistent grid whose tile width and
  order ``gmm_tile_width`` and ``tile_order`` mirror;
- ``tgmm`` → ``csrc/tgmm.cu`` (``_tgmm_kernel``): the per-expert weight
  gradient ``lhs[rows_e]ᵀ · dout[rows_e]`` of a float bank, on the same
  persistent product with ``lhs`` read transposed; its tile width and
  expert-major order ``tgmm_tile_width`` and ``tgmm_tile_order`` mirror;
- ``swiglu_fwd`` → ``csrc/swiglu_gmm.cu`` (``_swiglu_fwd_kernel``):
  ``h = silu(x·Wg·sg) · (x·Wu·su)`` and ``g`` on int8 banks;
- ``swiglu_bwd`` → ``csrc/swiglu_gmm.cu`` (``_swiglu_bwd_kernel``):
  recompute ``u``, then ``dg`` and ``du``.

On CUDA tensors a wrapper launches its kernel (bf16 rows; an int8 or a
bf16 bank) or raises: a float32 bank on the card is a ``TypeError``, as
the model casts its banks to the compute dtype first (JAX's
``q.astype(dtype)``). On CPU tensors it runs the plain version, whatever
the dtype.

``gmm``, ``swiglu_gmm`` and ``expert_ffn`` (the three expert products of
one layer: the fused gate/up then the down projection on int8 banks,
three ``gmm`` launches on float banks) are ``torch.library`` custom ops
with fake and autograd registrations, so selective activation
checkpointing sees them and can save their outputs by op identity. With
an int8 (frozen) bank a product's backward is one more grouped product
of the cotangent through the same bank read the other way round; a float
bank's adds its weight gradient, a ``tgmm``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from odh_kubeflow_tpu_torch.ops import _build

# group starts are padded to this: the kernels' row tile
ALIGN = 128
# route_sorted rounds M up to this (the TPU kernel B's row tile; kept so
# the sorted layout has the JAX package's size)
DEFAULT_BM_B = 512
# the TPU kernel A's VMEM limit, kept for the same kernel choice: the fused
# SwiGLU takes K <= 2 * MAX_K_A (else two separate products, as in JAX)
MAX_K_A = 4096

# kernel launches since the last reset (plain counters: the caller zeroes them)
gmm_launches = 0
# the same launches by (bank kind "int8" or "bf16", contraction size K)
gmm_launches_by_k: dict[tuple[str, int], int] = {}
tgmm_launches = 0
swiglu_fwd_launches = 0
swiglu_bwd_launches = 0

_argtypes_set: set[str] = set()


def _library(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    if name in _argtypes_set:
        return lib
    P, I = ctypes.c_void_p, ctypes.c_int
    if name == "gmm":
        # lhs q scale offsets out scaled | M K N E trans | stream
        lib.gmm_launch.argtypes = [P] * 6 + [I] * 5 + [P]
        lib.gmm_launch.restype = I
        # lhs w offsets out | M K N E trans | stream
        lib.gmm_bf16_launch.argtypes = [P] * 4 + [I] * 5 + [P]
        lib.gmm_bf16_launch.restype = I
        # the schedule, for the mirrors' test on the card
        lib.gmm_tile_width.argtypes = [I] * 3
        lib.gmm_tile_width.restype = I
        lib.gmm_tile_order.argtypes = [I, I, P]
        lib.gmm_tile_order.restype = None
        # lhs scale offsets scaled | M K E | stream: an int8 trans launch's first pass
        lib.gmm_prescale_launch.argtypes = [P] * 4 + [I] * 3 + [P]
        lib.gmm_prescale_launch.restype = I
    elif name == "tgmm":
        # lhs dout offsets out | M K N E | stream
        lib.tgmm_launch.argtypes = [P] * 4 + [I] * 4 + [P]
        lib.tgmm_launch.restype = I
        # the schedule, for the mirrors' test on the card
        lib.tgmm_tile_width.argtypes = [I] * 4
        lib.tgmm_tile_width.restype = I
        lib.tgmm_tile_order.argtypes = [I, I, I, P]
        lib.tgmm_tile_order.restype = None
    else:
        # x wg wu sg su offsets h g | M K N E | stream
        lib.swiglu_fwd_launch.argtypes = [P] * 8 + [I] * 4 + [P]
        lib.swiglu_fwd_launch.restype = I
        # x wu su offsets g dh dg du | M K N E | stream
        lib.swiglu_bwd_launch.argtypes = [P] * 8 + [I] * 4 + [P]
        lib.swiglu_bwd_launch.restype = I
    _argtypes_set.add(name)
    return lib


# The persistent kernels' schedule (csrc/grouped_sm90.cuh), mirrored so the
# CPU tests hold it; a card test compares these with the library's own.
# Row tiles walked together before the next column block (kGroupM).
TILE_GROUP_M = 8


def gmm_tile_width(m: int, n: int, sms: int) -> int:
    """``gmm``'s output tile width for an ``[m, n]`` result on ``sms`` SMs
    (``tile_width``): 256 columns, unless those tiles would fill fewer
    than three waves of the card; then 128."""
    return 128 if (m // ALIGN) * -(-n // 256) < 3 * sms else 256


def tile_order(m_tiles: int, n_tiles: int) -> list[tuple[int, int]]:
    """(row tile, column tile) of each linear tile index in the order the
    persistent blocks take them (``Sched::coords``): groups of
    ``TILE_GROUP_M`` row tiles, row tile fastest, one column block after
    the other. Block b of a grid of G takes tiles b, b + G, ..."""
    order = []
    for t in range(m_tiles * n_tiles):
        group, within = divmod(t, TILE_GROUP_M * n_tiles)
        first = group * TILE_GROUP_M
        rows = min(m_tiles - first, TILE_GROUP_M)
        order.append((first + within % rows, within // rows))
    return order


def tgmm_tile_width(k: int, n: int, num_groups: int, sms: int) -> int:
    """``tgmm``'s output tile width (``csrc/tgmm.cu`` ``tile_width``):
    ``gmm_tile_width`` over the ``num_groups`` stacked ``[k, n]`` results,
    each ``k`` rounded up to whole 128-row tiles."""
    return gmm_tile_width(num_groups * -(-k // ALIGN) * ALIGN, n, sms)


def tgmm_tile_order(num_groups: int, k_tiles: int, n_tiles: int) -> list[tuple[int, int, int]]:
    """(expert, K-tile, N-tile) of each linear tile index in the order the
    persistent ``tgmm`` blocks take them: expert by expert, each expert's
    ``[K, N]`` tiles in ``tile_order``. An empty expert's tiles are in the
    walk too (they write zeros)."""
    per = tile_order(k_tiles, n_tiles)
    return [(e, kt, nt) for e in range(num_groups) for kt, nt in per]


def tgmm_tile_rows(offsets: list[int], e: int) -> range:
    """The rows a ``tgmm`` tile of expert ``e`` sums over, 64 a chunk
    (``TgmmOps::tile``): ``[offsets[e], offsets[e+1])``, the tail past the
    last real group included in expert E-1's (``offsets[E] = M``)."""
    return range(offsets[e], offsets[e + 1], 64)


def group_of_tile(m: int, offsets: torch.Tensor) -> torch.Tensor:
    """Expert id of each ``ALIGN``-row tile (``_group_of_tile``): the
    aligned group boundaries give each tile exactly one."""
    tiles = torch.arange(m // ALIGN, device=offsets.device, dtype=offsets.dtype) * ALIGN
    return torch.searchsorted(offsets[1:-1].contiguous(), tiles, right=True)


# ---------------------------------------------------------------------------
# plain versions: the CPU path and the kernels' oracle on the card


def _groups(offsets: torch.Tensor):
    """(expert, first row, end row) of every non-empty group."""
    offs = offsets.tolist()
    return [(e, offs[e], offs[e + 1]) for e in range(len(offs) - 1) if offs[e + 1] > offs[e]]


def gmm_reference(lhs, rhs, offsets, trans_rhs: bool = False, scale=None) -> torch.Tensor:
    """Per group, ``lhs[rows] @ rhs[e]`` with f32 products, the scale where
    the TPU kernels put it, one cast to ``lhs.dtype``. Rows of no group
    (none when ``offsets[E] = M``) are zero."""
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    out = torch.zeros((lhs.shape[0], n), dtype=lhs.dtype, device=lhs.device)
    for e, s, t in _groups(offsets):
        a = lhs[s:t]
        if scale is not None and trans_rhs:
            # the scaled axis is the contraction: JAX's lhs *
            # scale.astype(lhs.dtype), rounded to the lhs dtype
            a = a * scale[e, 0].to(lhs.dtype)
        w = rhs[e].to(lhs.dtype)
        acc = a.float() @ (w.T if trans_rhs else w).float()
        if scale is not None and not trans_rhs:
            acc = acc * scale[e, 0].float()
        out[s:t] = acc.to(lhs.dtype)
    return out


def tgmm_reference(lhs, dout, offsets, num_groups: int) -> torch.Tensor:
    """Per-group weight gradient ``lhs[rows]ᵀ · dout[rows]`` ``[E, K, N]``
    in f32 sums, cast to ``dout.dtype``; zeros for empty groups."""
    out = torch.zeros((num_groups, lhs.shape[1], dout.shape[1]), dtype=dout.dtype,
                      device=lhs.device)
    for e, s, t in _groups(offsets):
        out[e] = (lhs[s:t].float().T @ dout[s:t].float()).to(dout.dtype)
    return out


def swiglu_fwd_reference(lhs, wg, wu, sg, su, offsets):
    """``(h, g)`` in ``lhs.dtype``: ``g = (x·Wg)·sg``, ``u = (x·Wu)·su`` in
    f32, ``h = silu(g)·u``."""
    m, n = lhs.shape[0], wg.shape[2]
    h = torch.zeros((m, n), dtype=lhs.dtype, device=lhs.device)
    g = torch.zeros_like(h)
    for e, s, t in _groups(offsets):
        a = lhs[s:t].float()
        ge = (a @ wg[e].to(lhs.dtype).float()) * sg[e, 0].float()
        ue = (a @ wu[e].to(lhs.dtype).float()) * su[e, 0].float()
        h[s:t] = (torch.nn.functional.silu(ge) * ue).to(lhs.dtype)
        g[s:t] = ge.to(lhs.dtype)
    return h, g


def swiglu_bwd_reference(lhs, wu, su, g, dh, offsets):
    """``(dg, du)`` in ``lhs.dtype``: ``u`` recomputed in f32, then
    ``dg = dh·u·σ(g)(1 + g(1 − σ(g)))`` and ``du = dh·g·σ(g)``."""
    dg = torch.zeros_like(g, dtype=lhs.dtype)
    du = torch.zeros_like(dg)
    for e, s, t in _groups(offsets):
        u = (lhs[s:t].float() @ wu[e].to(lhs.dtype).float()) * su[e, 0].float()
        ge, dhe = g[s:t].float(), dh[s:t].float()
        sig = torch.sigmoid(ge)
        dg[s:t] = (dhe * u * (sig * (1.0 + ge * (1.0 - sig)))).to(lhs.dtype)
        du[s:t] = (dhe * (ge * sig)).to(lhs.dtype)
    return dg, du


# what each kernel is held to against its plain version in bf16, as
# tile_rel_err over 128-row tiles. Both sides round the same f32 sums once
# to bf16 (the lhs prescale is bit-identical), so a sound kernel differs
# only where the f32 sums, taken in another order, land on either side of
# a rounding boundary: the worst tile on an H100 at the Mixtral-8x1B
# shapes read 2.1e-4 (chip_smoke.py, PERF.md). The limit is ~10x that and
# above one whole bf16 rounding (~1.1e-3 RMS relative), and 45x below the
# smallest planted fault (a skipped last 64-wide chunk of K = 8192 reads
# 0.090, ~sqrt(64/8192)).
TILE_RTOL = 2e-3


def tile_rel_err(got: torch.Tensor, want: torch.Tensor, tile: int = ALIGN) -> float:
    """How far a kernel's ``[M, N]`` result is from its plain version's:
    the largest ``||got - want|| / ||want||`` over tiles of ``tile``
    consecutive rows (a tile whose ``want`` is all zero counts its
    absolute error), so one expert's tile is held to its own scale."""
    d = (got.float() - want.float()).square().sum(-1)
    w = want.float().square().sum(-1)
    pad = -d.shape[0] % tile
    d = torch.nn.functional.pad(d, (0, pad)).reshape(-1, tile).sum(1)
    w = torch.nn.functional.pad(w, (0, pad)).reshape(-1, tile).sum(1)
    return (d.sqrt() / torch.where(w > 0, w.sqrt(), 1.0)).max().item()


# ---------------------------------------------------------------------------
# wrappers: the kernel on the card, the plain version on the CPU


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _cuda_operands(name: str, lhs, banks, scales, offsets, num_groups: int):
    """The kernels' contract: bf16 rows, int8 banks with f32 scales or
    bf16 banks without; returns int32 offsets on the device."""
    dev = lhs.device
    for t in (*banks, *scales, offsets):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(
                f"{name}: every operand must be on one CUDA device (or all on the "
                f"CPU); got {lhs.device} and {t.device}"
            )
    want = torch.int8 if scales else torch.bfloat16
    if any(b.dtype != want for b in banks):
        raise TypeError(
            f"{name}: the kernels take an int8 bank with its scale or a bfloat16 bank "
            f"without; got {[b.dtype for b in banks]} with {len(scales)} scale(s) "
            "(cast a float bank to the rows' dtype first)"
        )
    if lhs.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernels take bfloat16 rows, got {lhs.dtype}")
    m, k = lhs.shape
    if m % ALIGN or k % 16:
        raise ValueError(f"{name}: needs M % {ALIGN} == 0 and K % 16 == 0, got {m}x{k}")
    for t in (lhs, *banks, *scales):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous with 16-byte aligned bases")
    for s in scales:
        if s.dtype != torch.float32:
            raise TypeError(f"{name}: scales must be float32, got {s.dtype}")
    if offsets.shape != (num_groups + 1,):
        raise ValueError(f"{name}: offsets {tuple(offsets.shape)} for {num_groups} experts")
    return offsets.to(torch.int32).contiguous()


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def gmm(lhs, rhs, offsets, trans_rhs: bool = False, scale=None) -> torch.Tensor:
    """``[M, N]`` in ``lhs.dtype``. On the card: a bf16 ``rhs``, or an int8
    one with its f32 ``scale`` ``[E, 1, N]`` (``[E, 1, K]`` with
    ``trans_rhs``)."""
    global gmm_launches
    scales = () if scale is None else (scale,)
    if _on_cpu(lhs, rhs, offsets, *scales):
        return gmm_reference(lhs, rhs, offsets, trans_rhs, scale)
    E = rhs.shape[0]
    m, k = lhs.shape
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    offs = _cuda_operands("gmm", lhs, (rhs,), scales, offsets, E)
    want_rhs = (E, n, k) if trans_rhs else (E, k, n)
    if rhs.shape != want_rhs or n % 16 or any(s.shape != (E, 1, rhs.shape[2]) for s in scales):
        raise ValueError(
            f"gmm: rhs {tuple(rhs.shape)} / scale {[tuple(s.shape) for s in scales]} do not "
            f"fit lhs {tuple(lhs.shape)} (trans_rhs={trans_rhs}; N % 16 == 0)"
        )
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    lib = _library("gmm")
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if scale is None:
            rc = lib.gmm_bf16_launch(lhs.data_ptr(), rhs.data_ptr(), offs.data_ptr(),
                                     out.data_ptr(), m, k, n, E, int(trans_rhs), stream)
        else:
            # trans: the kernel's first pass writes the prescaled lhs here
            scaled = torch.empty_like(lhs) if trans_rhs else None
            rc = lib.gmm_launch(
                lhs.data_ptr(), rhs.data_ptr(), scale.data_ptr(), offs.data_ptr(),
                out.data_ptr(), None if scaled is None else scaled.data_ptr(), m, k, n, E,
                int(trans_rhs), stream,
            )
    _raise_on(rc, "gmm")
    gmm_launches += 1
    key = ("bf16" if scale is None else "int8", k)
    gmm_launches_by_k[key] = gmm_launches_by_k.get(key, 0) + 1
    return out


def tgmm(lhs, dout, offsets, num_groups: int) -> torch.Tensor:
    """The per-expert weight gradient ``[E, K, N]`` in ``dout.dtype``:
    ``lhs[rows_e]ᵀ · dout[rows_e]`` with f32 sums, zeros for an expert
    with no row. On the card: bf16 ``lhs [M, K]`` and ``dout [M, N]``."""
    global tgmm_launches
    if _on_cpu(lhs, dout, offsets):
        return tgmm_reference(lhs, dout, offsets, num_groups)
    offs = _cuda_operands("tgmm", lhs, (), (), offsets, num_groups)
    m, k = lhs.shape
    n = dout.shape[1]
    if dout.dtype != lhs.dtype or dout.shape != (m, n) or n % 16:
        raise ValueError(
            f"tgmm: dout {tuple(dout.shape)} {dout.dtype} does not fit lhs "
            f"{tuple(lhs.shape)} {lhs.dtype} (N % 16 == 0)"
        )
    if not dout.is_contiguous() or dout.data_ptr() % 16 or dout.device != lhs.device:
        raise ValueError("tgmm: dout must be contiguous with a 16-byte aligned base")
    out = torch.empty((num_groups, k, n), dtype=dout.dtype, device=lhs.device)
    lib = _library("tgmm")
    with torch.cuda.device(lhs.device):
        rc = lib.tgmm_launch(lhs.data_ptr(), dout.data_ptr(), offs.data_ptr(), out.data_ptr(),
                             m, k, n, num_groups, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "tgmm")
    tgmm_launches += 1
    return out


def _swiglu_checks(lhs, banks, scales, offsets):
    E, k, n = banks[0].shape
    if any(b.dtype != torch.int8 for b in banks):
        raise TypeError(f"swiglu_gmm: the fused kernels take int8 banks, got "
                        f"{[b.dtype for b in banks]}")
    offs = _cuda_operands("swiglu_gmm", lhs, banks, scales, offsets, E)
    if lhs.shape[1] != k or n % 16 or any(b.shape != (E, k, n) for b in banks) or any(
        s.shape != (E, 1, n) for s in scales
    ):
        raise ValueError(
            f"swiglu_gmm: banks {[tuple(b.shape) for b in banks]} / scales "
            f"{[tuple(s.shape) for s in scales]} do not fit lhs {tuple(lhs.shape)}"
        )
    return offs, E, k, n


def swiglu_fwd(lhs, wg, wu, sg, su, offsets):
    """``(h, g)`` ``[M, N]`` in ``lhs.dtype``; int8 banks ``[E, K, N]``."""
    global swiglu_fwd_launches
    if _on_cpu(lhs, wg, wu, sg, su, offsets):
        return swiglu_fwd_reference(lhs, wg, wu, sg, su, offsets)
    offs, E, k, n = _swiglu_checks(lhs, (wg, wu), (sg, su), offsets)
    m = lhs.shape[0]
    h = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    g = torch.empty_like(h)
    lib = _library("swiglu_gmm")
    with torch.cuda.device(lhs.device):
        rc = lib.swiglu_fwd_launch(
            lhs.data_ptr(), wg.data_ptr(), wu.data_ptr(), sg.data_ptr(), su.data_ptr(),
            offs.data_ptr(), h.data_ptr(), g.data_ptr(), m, k, n, E,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "swiglu_fwd")
    swiglu_fwd_launches += 1
    return h, g


def swiglu_bwd(lhs, wu, su, g, dh, offsets):
    """``(dg, du)`` ``[M, N]`` in ``lhs.dtype``."""
    global swiglu_bwd_launches
    if _on_cpu(lhs, wu, su, g, dh, offsets):
        return swiglu_bwd_reference(lhs, wu, su, g, dh, offsets)
    offs, E, k, n = _swiglu_checks(lhs, (wu,), (su,), offsets)
    m = lhs.shape[0]
    for name, t in (("g", g), ("dh", dh)):
        if (t.shape != (m, n) or t.dtype != lhs.dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"swiglu_bwd: {name} must be contiguous {lhs.dtype} [{m}, {n}] "
                             "with a 16-byte aligned base (the kernel reads it by TMA)")
    dg = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    du = torch.empty_like(dg)
    lib = _library("swiglu_gmm")
    with torch.cuda.device(lhs.device):
        rc = lib.swiglu_bwd_launch(
            lhs.data_ptr(), wu.data_ptr(), su.data_ptr(), offs.data_ptr(), g.data_ptr(),
            dh.data_ptr(), dg.data_ptr(), du.data_ptr(), m, k, n, E,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "swiglu_bwd")
    swiglu_bwd_launches += 1
    return dg, du


# ---------------------------------------------------------------------------
# custom ops and autograd


@torch.library.custom_op("odh_torch::gmm", mutates_args=())
def gmm_op(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    offsets: torch.Tensor,
    trans_rhs: bool,
    scale: Optional[torch.Tensor],
) -> torch.Tensor:
    return gmm(lhs, rhs, offsets, trans_rhs, scale)


@gmm_op.register_fake
def _(lhs, rhs, offsets, trans_rhs, scale):
    return lhs.new_empty((lhs.shape[0], rhs.shape[1] if trans_rhs else rhs.shape[2]))


def _gmm_setup(ctx, inputs, output):
    lhs, rhs, offsets, trans_rhs, scale = inputs
    ctx.trans_rhs, ctx.dtype = trans_rhs, lhs.dtype
    # an int8 bank is frozen: its backward needs the bank and the offsets,
    # not this product's input, so lhs is kept only for a float bank's dW
    ctx.save_for_backward(rhs, offsets, scale, lhs if scale is None else None)


def _gmm_backward(ctx, dout):
    rhs, offsets, scale, lhs = ctx.saved_tensors
    # dlhs = dout · rhsᵀ: the same grouped product with rhs read the other
    # way round, so no transposed bank is ever made
    d = dout.to(ctx.dtype).contiguous()
    dlhs = gmm_op(d, rhs, offsets, not ctx.trans_rhs, scale)
    drhs = None
    if scale is None and ctx.needs_input_grad[1]:
        # a float bank's weight gradient, in its layout ([E, N, K] with
        # trans_rhs), as in _gmm_bwd
        E = rhs.shape[0]
        drhs = (tgmm(d, lhs, offsets, E) if ctx.trans_rhs else tgmm(lhs, d, offsets, E))
        drhs = drhs.to(rhs.dtype)
    return dlhs, drhs, None, None, None


gmm_op.register_autograd(_gmm_backward, setup_context=_gmm_setup)


@torch.library.custom_op("odh_torch::swiglu_gmm", mutates_args=())
def swiglu_gmm_op(
    lhs: torch.Tensor,
    wg: torch.Tensor,
    wu: torch.Tensor,
    sg: torch.Tensor,
    su: torch.Tensor,
    offsets: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    return swiglu_fwd(lhs, wg, wu, sg, su, offsets)


@swiglu_gmm_op.register_fake
def _(lhs, wg, wu, sg, su, offsets):
    h = lhs.new_empty((lhs.shape[0], wg.shape[2]))
    return h, torch.empty_like(h)


def _swiglu_dlhs(lhs, wg, wu, sg, su, offsets, g, dh, dg_out=None):
    """The SwiGLU backward from the pinned ``g``: one fused kernel (u
    recomputed, the dsilu epilogue), then the lhs gradient through both
    frozen banks read transposed, as in ``_swiglu_vjp_bwd``."""
    dg, du = swiglu_bwd(lhs, wu, su, g, dh.to(lhs.dtype).contiguous(), offsets)
    if dg_out is not None:
        dg = dg + dg_out.to(dg.dtype)
    return gmm_op(dg, wg, offsets, True, sg) + gmm_op(du, wu, offsets, True, su)


def _swiglu_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output[1])


def _swiglu_backward(ctx, dh, dg_out):
    lhs, wg, wu, sg, su, offsets, g = ctx.saved_tensors
    dlhs = _swiglu_dlhs(lhs, wg, wu, sg, su, offsets, g, dh, dg_out)
    return dlhs, None, None, None, None, None


swiglu_gmm_op.register_autograd(_swiglu_backward, setup_context=_swiglu_setup)


@torch.library.custom_op("odh_torch::expert_ffn", mutates_args=())
def expert_ffn_op(
    lhs: torch.Tensor,
    wg: torch.Tensor,
    sg: Optional[torch.Tensor],
    wu: torch.Tensor,
    su: Optional[torch.Tensor],
    wd: torch.Tensor,
    sd: Optional[torch.Tensor],
    offsets: torch.Tensor,
    keep_g: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, g)``: the three expert products of one layer. int8 banks
    (scales given): the fused SwiGLU, then the down projection. Float
    banks (no scales, in ``lhs.dtype``): ``g`` and ``u`` by two ``gmm``,
    ``h = silu(g)·u`` in f32, then the down ``gmm``. ``g`` is the gate
    pre-activation when ``keep_g`` (the backward then reads it: JAX's
    "moe_g" pin), else an empty tensor and the backward recomputes it;
    ``u`` is always recomputed (inside the fused backward kernel on int8
    banks). ``h`` never outlives the op, so a remat policy that saves
    this op's outputs keeps ``y`` (JAX's "moe_y") and at most ``g``, and
    the layer's recompute re-runs no expert product: the backward runs
    only the ones JAX's remat recomputes (gate and up, or up alone)."""
    if sg is None:
        g = gmm(lhs, wg, offsets)
        y = gmm(_silu_mul(g, gmm(lhs, wu, offsets)), wd, offsets)
    else:
        h, g = swiglu_fwd(lhs, wg, wu, sg, su, offsets)
        y = gmm(h, wd, offsets, False, sd)
    return y, g if keep_g else g.new_empty(0)


@expert_ffn_op.register_fake
def _(lhs, wg, sg, wu, su, wd, sd, offsets, keep_g):
    y = lhs.new_empty((lhs.shape[0], wd.shape[2]))
    return y, lhs.new_empty((lhs.shape[0], wg.shape[2]) if keep_g else (0,))


def _silu_mul(g, u):
    """``silu(g)·u`` in f32, rounded to ``g.dtype`` (JAX's float path)."""
    return (torch.nn.functional.silu(g.float()) * u.float()).to(g.dtype)


def _ffn_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:8], output[1])


def _ffn_backward(ctx, dy, _dg):
    lhs, wg, sg, wu, su, wd, sd, offsets, g = ctx.saved_tensors
    dy = dy.to(lhs.dtype).contiguous()
    if sg is not None:
        # down projection first: dh = dy · Wdᵀ needs only the bank, not h
        dh = gmm_op(dy, wd, offsets, True, sd)
        if g.numel() == 0:  # not kept: the fused forward runs again for it
            _, g = swiglu_gmm_op(lhs, wg, wu, sg, su, offsets)
        dlhs = _swiglu_dlhs(lhs, wg, wu, sg, su, offsets, g, dh)
        return (dlhs,) + (None,) * 8
    # float banks: recompute what was not kept, then the three dlhs
    # products and, for the banks that train, the three weight gradients
    E = wg.shape[0]
    if g.numel() == 0:
        g = gmm(lhs, wg, offsets)
    u = gmm(lhs, wu, offsets)
    dh = gmm(dy, wd, offsets, True).float()
    gf, uf = g.float(), u.float()
    sig = torch.sigmoid(gf)
    dg = (dh * uf * (sig * (1.0 + gf * (1.0 - sig)))).to(lhs.dtype)
    du = (dh * (gf * sig)).to(lhs.dtype)
    dlhs = gmm(dg, wg, offsets, True) + gmm(du, wu, offsets, True)
    need = ctx.needs_input_grad
    dwg = tgmm(lhs, dg, offsets, E).to(wg.dtype) if need[1] else None
    dwu = tgmm(lhs, du, offsets, E).to(wu.dtype) if need[3] else None
    dwd = tgmm(_silu_mul(g, u), dy, offsets, E).to(wd.dtype) if need[5] else None
    return dlhs, dwg, None, dwu, None, dwd, None, None, None


expert_ffn_op.register_autograd(_ffn_backward, setup_context=_ffn_setup)


def fused_swiglu_usable(k: int) -> bool:
    """The TPU's fused kernel takes the whole K of its two resident
    int8 blocks in VMEM (``_swiglu_specs``); past that the JAX package
    falls back to separate products, and so does the port."""
    return k <= 2 * MAX_K_A and 4 * 1024 * 1024 // k // 2 >= ALIGN
