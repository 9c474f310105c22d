"""The port's fused-dequant int4 matmul (``ops/int4.py`` ``int4_matmul``)
against the JAX package's (``ops/pallas_int4.py``), on the CPU.

JAX's op runs as its own test runs it (tests/test_quant.py): on the CPU
``int4_matmul`` defaults to Pallas interpret mode. Weights are quantized
by the JAX package and carried across with ``convert.from_numpy_tree``;
activations and cotangents are numpy draws from a seed.

Tolerances: float32, forward and dX within 1e-5 of the largest value
(test_quant.py's bar: both sides multiply the same f32 weights, summed in
another order). bfloat16: within ``BF16_TOL`` of the largest value. Both
sides round the same bf16 weights and take f32 sums, the TPU kernel in
1024-wide chunks and the port in one, so an output may round to the
neighbouring bf16 value: one bf16 ulp is 2^-8 of the value, and two ulps
at the largest value bound it.

The CUDA kernels are held against the plain versions on the card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models.quant import quantize_tensor4 as jax_quantize_tensor4
from odh_kubeflow_tpu.ops import pallas_int4
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.ops import int4

F32_TOL = 1e-5
BF16_TOL = 2 * 2.0**-8

# (M, K, N, group): JAX's own case, decode rows, and the group sizes
CASES = [
    (1024, 2048, 1024, 128),
    (4, 2048, 512, 128),
    (1, 4096, 256, 128),
    (512, 2048, 1536, 64),
    (512, 2048, 1536, 128),
    (512, 2048, 1536, 256),
]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _weights(K, N, group):
    w = np.random.default_rng(K + N + group).standard_normal((K, N)).astype(np.float32) * 0.3
    t = jax.tree.map(np.asarray, jax_quantize_tensor4(jnp.asarray(w), group=group))
    return t, convert.from_numpy_tree(t, device="cpu")


def _rows(M, K, seed, dtype):
    a = np.random.default_rng(seed).standard_normal((M, K)).astype(np.float32) * 0.5
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,K,N,group", CASES)
def test_int4_matmul_forward_matches_jax(M, K, N, group, dtype):
    jt, tt = _weights(K, N, group)
    jx, tx = _rows(M, K, 1, dtype)
    want = pallas_int4.int4_matmul(jx, jnp.asarray(jt["q4"]), jnp.asarray(jt["scale4"]), group)
    got = int4.int4_matmul(tx, tt["q4"], tt["scale4"], group)
    assert got.dtype == tx.dtype and got.shape == (M, N)
    assert _rel(got, want.astype(jnp.float32)) < (F32_TOL if dtype == "f32" else BF16_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,K,N,group", CASES)
def test_int4_matmul_gradient_matches_jax(M, K, N, group, dtype):
    """dX through the dlhs kernel against ``jax.vjp`` of JAX's op (its
    ``_int4_dlhs_kernel`` in interpret mode); q4 gets no gradient and
    scale4 zeros, as ``_int4_matmul_bwd`` returns."""
    jt, tt = _weights(K, N, group)
    jx, tx = _rows(M, K, 2, dtype)
    jd, td = _rows(M, N, 3, dtype)
    jq, js = jnp.asarray(jt["q4"]), jnp.asarray(jt["scale4"])
    _, vjp = jax.vjp(lambda x, s: pallas_int4.int4_matmul(x, jq, s, group), jx, js)
    want_dx, want_ds = vjp(jd)

    tx.requires_grad_(True)
    scale = tt["scale4"].clone().requires_grad_(True)
    q4 = tt["q4"].clone()
    int4.int4_matmul(tx, q4, scale, group).backward(td)
    assert tx.grad.dtype == tx.dtype and tx.grad.shape == (M, K)
    assert _rel(tx.grad, want_dx.astype(jnp.float32)) < (F32_TOL if dtype == "f32" else BF16_TOL)
    assert q4.grad is None
    assert torch.equal(scale.grad, torch.zeros_like(scale))
    np.testing.assert_array_equal(np.asarray(want_ds), 0.0)


# Shapes drawn from each reason the TPU kernels' blocking refuses, and their
# accepted neighbours: (id, x or dout rows M, x's K, q4 [K2, N], scale4
# shape, group, dout's N where it differs from q4's). None for scale4 means
# the matching (K // group, N).
CONTRACT = [
    ("jax_own_case", 256, 512, (256, 640), None, 128, None),  # test_quant.py:353-368
    ("accepted", 8, 2048, (1024, 64), None, 128, None),
    ("K_1024", 8, 1024, (512, 64), None, 128, None),
    ("K_3072", 8, 3072, (1536, 64), None, 128, None),
    ("K_4096", 8, 4096, (2048, 64), None, 128, None),
    ("K_ne_2K2", 8, 2048, (2048, 64), (32, 64), 128, None),
    ("group_32", 8, 2048, (1024, 64), None, 32, None),
    ("group_1024", 8, 2048, (1024, 64), None, 1024, None),
    ("group_2048", 8, 2048, (1024, 64), None, 2048, None),
    ("group_96", 8, 2048, (1024, 64), None, 96, None),
    ("scale_rows", 8, 2048, (1024, 64), (17, 64), 128, None),
    ("scale_cols", 8, 2048, (1024, 64), (16, 65), 128, None),
    ("scale_of_group_64", 8, 2048, (1024, 64), (32, 64), 128, None),
    ("M_1", 1, 2048, (1024, 64), None, 128, None),
    ("M_300", 300, 2048, (1024, 16), None, 128, None),
    ("M_512", 512, 2048, (1024, 16), None, 128, None),
    ("M_513", 513, 2048, (1024, 16), None, 128, None),
    ("M_1000", 1000, 2048, (1024, 16), None, 128, None),
    ("M_1536", 1536, 2048, (1024, 16), None, 128, None),
    ("N_100", 8, 2048, (1024, 100), None, 128, None),
    ("N_512", 8, 2048, (1024, 512), None, 128, None),
    ("N_600", 8, 2048, (1024, 600), None, 128, None),
    ("N_1000", 8, 2048, (1024, 1000), None, 128, None),
    ("N_1024", 8, 2048, (1024, 1024), None, 128, None),
    ("lm_head_width", 1, 2048, (1024, 128256), None, 128, None),
    ("dout_N_ne_q4_N", 8, 2048, (1024, 64), None, 128, 128),
]


def _jax_raises(fn, *shapes) -> bool:
    specs = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
    try:
        jax.eval_shape(fn, *specs)
    except NotImplementedError:
        return True
    return False


def _port_raises(fn, *tensors) -> bool:
    try:
        fn(*tensors)
    except NotImplementedError:
        return True
    return False


@pytest.mark.parametrize("case", CONTRACT, ids=[c[0] for c in CONTRACT])
def test_int4_matmul_refuses_exactly_where_jax_does(case):
    """Forward and dX raise ``NotImplementedError`` on the same shapes in
    both packages (JAX traced with ``eval_shape``: its checks run before
    the kernel)."""
    _, M, K, (K2, N), scale_shape, group, dout_n = case
    if scale_shape is None:
        scale_shape = (2 * K2 // group, N)
    q4 = torch.zeros((K2, N), dtype=torch.uint8)
    s = torch.ones(scale_shape, dtype=torch.float32)
    x = torch.zeros((M, K), dtype=torch.float32)
    dout = torch.zeros((M, dout_n or N), dtype=torch.float32)
    u8, f32 = jnp.uint8, jnp.float32

    jax_fwd = _jax_raises(lambda x, q, s: pallas_int4.int4_matmul(x, q, s, group),
                          ((M, K), f32), ((K2, N), u8), (scale_shape, f32))
    port_fwd = _port_raises(lambda *a: int4.int4_matmul(*a, group), x, q4, s)
    assert jax_fwd == port_fwd, (jax_fwd, port_fwd)

    jax_dlhs = _jax_raises(
        functools.partial(pallas_int4._int4_dlhs_impl, group=group, interpret=True),
        (tuple(dout.shape), f32), ((K2, N), u8), (scale_shape, f32))
    port_dlhs = _port_raises(lambda *a: int4.int4_dlhs(*a, group), dout, q4, s)
    assert jax_dlhs == port_dlhs, (jax_dlhs, port_dlhs)
    if case[0] == "jax_own_case":
        assert jax_fwd and port_fwd
    if case[0] == "lm_head_width":  # callers take the dequant path for the lm_head
        assert port_fwd and port_dlhs


def _small():
    t = jax.tree.map(np.asarray, jax_quantize_tensor4(
        jnp.asarray(np.random.default_rng(5).standard_normal((2048, 64)).astype(np.float32))))
    tt = convert.from_numpy_tree(t, device="cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 2048)).astype(np.float32))
    return x, tt["q4"], tt["scale4"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int4_matmul_cpu_runs_the_plain_version_and_counts_nothing(dtype):
    x, q4, s = _small()
    x = x.to(dtype).requires_grad_(True)
    before = (int4.launches, int4.mm_launches, int4.dlhs_launches)
    out = int4.int4_matmul(x, q4, s)
    assert torch.equal(out, int4.int4_matmul_reference(x.detach(), q4, s))
    d = torch.ones_like(out)
    out.backward(d)
    assert torch.equal(x.grad, int4.int4_dlhs_reference(d, q4, s))
    assert (int4.launches, int4.mm_launches, int4.dlhs_launches) == before


def test_int4_matmul_refuses_bad_operands():
    x, q4, s = _small()
    with pytest.raises(TypeError):
        int4.int4_matmul(x.half(), q4, s)  # neither f32 nor bf16
    with pytest.raises(TypeError):
        int4.int4_matmul(x, q4.to(torch.int8), s)
    with pytest.raises(TypeError):
        int4.int4_dlhs(torch.zeros(4, 64), q4, s.bfloat16())
    with pytest.raises(ValueError):
        int4.int4_mm(x.to("meta"), q4, s)  # two devices
    with pytest.raises(ValueError):
        int4.int4_dlhs(torch.zeros(4, 64), q4.to("meta"), s)
    with pytest.raises(ValueError):
        int4.int4_matmul(x.t().contiguous().t(), q4, s)  # not contiguous
    with pytest.raises(ValueError):
        int4.int4_dlhs(torch.zeros(64, 4).t(), q4, s)
    with pytest.raises(ValueError):
        int4.int4_matmul(x[None], q4, s)  # 3-D
    # on the card a float32 x or dout is refused, never cast (the check
    # the wrappers run on CUDA operands, run here on dtypes)
    with pytest.raises(TypeError):
        int4._check_dtype("int4_matmul", torch.float32, on_card=True)
    int4._check_dtype("int4_matmul", torch.bfloat16, on_card=True)
    int4._check_dtype("int4_matmul", torch.float32, on_card=False)


def test_int4_tile_rel_err_holds_each_128_by_128_tile_to_its_own_scale():
    want = torch.ones(300, 200)
    want[128:256, 128:] = 1e-3  # a small tile
    got = want.clone()
    got[130, 150] += 1e-2  # ~0.1 of the small tile's norm
    assert int4.tile_rel_err(got, want) > 5e-2
    assert int4.tile_rel_err(want, want) == 0.0
    got = want.clone()
    got[0, 0] += 1e-2  # the same error in a large tile
    assert int4.tile_rel_err(got, want) < 1e-4


def test_int4_mm_tile_rows_mirror_the_kernels_rule():
    """The Hopper forward's tile (``csrc/int4_matmul.cu`` ``tile_rows``):
    256 weight columns x 128 tokens at the QLoRA step's M 8,192 and any M
    past 16 (ragged M included); x 16 tokens (an m64n16 product) at decode."""
    for m in (17, 129, 300, 512, 8192):
        assert int4.int4_mm_tile_rows(m) == 128
    for m in (1, 4, 16):
        assert int4.int4_mm_tile_rows(m) == 16


@pytest.mark.parametrize("m,n,aligned,want", [
    (8192, 4096, True, "tma_128"),
    (8192, 1024, True, "tma_128"),
    (1, 4096, True, "tma_16"),
    (4, 14336, True, "tma_16"),
    (300, 208, True, "tma_128"),
    (300, 200, True, "generic"),  # N % 16 != 0: TMA cannot map q4's rows
    (1, 100, True, "generic"),
    (128, 2048, False, "generic"),  # a base not 16-byte aligned
])
def test_int4_mm_instance_follows_the_shape(m, n, aligned, want):
    """The wrapper's choice of forward kernel, made before the launch from
    the shape alone: the Hopper TMA kernel wherever TMA can map the
    operands, the first design's generic kernel elsewhere."""
    assert int4.int4_mm_instance(m, n, aligned) == want


def test_int4_widening_arithmetic_gives_the_dequant_bits():
    """The forward's widening in f32 as the Hopper kernel does it: a nibble
    in the low mantissa bits of 2^23, minus 2^23 + 8 (exact), one f32
    multiply by its group's scale, one rounding to bf16: the bits of
    ``int4_dequant_reference``, on every nibble and both halves."""
    rng = np.random.default_rng(11)
    K, N, group = 256, 64, 32
    q4 = torch.from_numpy(rng.integers(0, 256, (K // 2, N), dtype=np.uint8))
    scale = torch.from_numpy((rng.random((K // group, N)) * 0.02 + 1e-4).astype(np.float32))
    p = q4.to(torch.int32)
    nib = torch.cat([p & 0xF, (p >> 4) & 0xF])  # rows k < K/2 low, then high
    magic = (nib | 0x4B000000).to(torch.int32).view(torch.float32)
    w = (magic - 8388616.0) * scale.repeat_interleave(group, 0)
    assert torch.equal((magic - 8388616.0), (nib - 8).float())
    assert torch.equal(w.to(torch.bfloat16), int4.int4_dequant_reference(q4, scale))


@pytest.mark.parametrize("m,n,aligned,want", [
    (8192, 4096, True, "tma_128"),
    (8192, 14336, True, "tma_128"),
    (8192, 1024, True, "tma_128"),
    (1, 4096, True, "tma_16"),
    (4, 14336, True, "tma_16"),
    (16, 192, True, "tma_16"),
    (17, 192, True, "tma_128"),
    (300, 200, True, "generic"),  # N % 16 != 0: TMA cannot map q4's rows
    (1, 100, True, "generic"),
    (128, 2048, False, "generic"),  # a base not 16-byte aligned
])
def test_int4_dlhs_instance_follows_the_shape(m, n, aligned, want):
    """The wrapper's choice of dX kernel, made before the launch from the
    shape alone (``n`` is dout's width, the contraction): the Hopper
    kernel wherever TMA can map the operands, the generic one elsewhere."""
    assert int4.int4_dlhs_instance(m, n, aligned) == want


@pytest.mark.parametrize("n", [16, 64, 80, 100, 128, 192, 208, 400, 512, 1024, 4096, 14336])
def test_int4_dlhs_chunks_mirror_the_kernels_rule(n):
    """The Hopper dX's 64-deep chunks of its contraction
    (``csrc/int4_matmul.cu`` ``dlhs_chunks``): an even count (the
    consumers take two at a time) that covers ``n``, with at most one
    chunk wholly past it; the 8B shapes need no padding."""
    c = int4.int4_dlhs_chunks(n)
    assert c % 2 == 0 and 64 * c >= n and 64 * (c - 2) < n
    assert c - -(-n // 64) in (0, 1)
    if n % 128 == 0:
        assert c == n // 64


def test_int4_dlhs_on_the_cpu_counts_no_instance():
    x, q4, s = _small()
    before = dict(int4.dlhs_launches_by_instance)
    int4.int4_dlhs(torch.ones(4, 64), q4, s)
    assert int4.dlhs_launches_by_instance == before


def _swizzle(addr, bits):
    """TMA's swizzle of a shared-memory byte address (an involution):
    address bits 4.. (``bits`` of them) XOR the same number of bits from
    bit 7 (CU_TENSOR_MAP_SWIZZLE_64B: 2, _128B: 3)."""
    return addr ^ (((addr >> 7) & ((1 << bits) - 1)) << 4)


def _swz64(row, chunk):  # csrc/int4_matmul.cu swz64
    return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4)


def _swz128(row, chunk):  # csrc/sm90_common.cuh swz128
    return row * 128 + ((chunk ^ (row & 7)) << 4)


@pytest.mark.parametrize("group", [64, 256, 8])
def test_int4_dlhs_fragment_arithmetic_rebuilds_the_dequant_weights(group):
    """The Hopper dX's index arithmetic (``csrc/int4_matmul.cu``
    ``int4_dlhs_kernel``, ``widen_dlhs``) replayed on the CPU: each chunk
    of 128 packed rows x 64 columns laid out as TMA's 64-byte swizzle
    writes it; every consumer thread's A fragments read through ``swz64``
    (A row r of warpgroup cw is packed row 64 cw + r, block 0 its low
    nibble and block 1 its high), widened with the scales it picks (the
    four TMA-staged rows at group >= 64, ``__ldg`` of its own row below);
    each accumulator row then placed by the epilogue's ``stmatrix``
    transpose into a 128-byte-swizzled panel and un-swizzled as TMA's
    store reads it, into the low or the high run of dx columns. The
    weights so placed are ``int4_dequant_reference``'s, bit for bit (the
    product's A is W, rows k), and every accumulator lands on its own
    token and weight row. N 80 leaves the second chunk mostly past N: TMA
    reads zeros there."""
    rng = np.random.default_rng(group)
    K, N = 512, 80
    half, gshift = K // 2, group.bit_length() - 1
    q4 = rng.integers(0, 256, (half, N), dtype=np.uint8)
    scale = (rng.random((K // group, N)) * 0.02 + 1e-4).astype(np.float32)
    want = int4.int4_dequant_reference(torch.from_numpy(q4), torch.from_numpy(scale))
    got = torch.full((K, N), float("nan"), dtype=torch.bfloat16)
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    staged = gshift >= 6
    for kt in range(K // 256):
        p0 = 128 * kt
        for kc in range(int4.int4_dlhs_chunks(N)):
            n0 = 64 * kc
            # the stage as TMA fills it: packed box {64, 128}, four scale rows
            box = np.zeros((128, 64), np.uint8)
            cols = max(0, min(64, N - n0))
            box[:, :cols] = q4[p0:p0 + 128, n0:n0 + cols]
            smem = np.zeros(128 * 64, np.uint8)
            smem[_swizzle(np.arange(128 * 64), 2)] = box.reshape(-1)
            ss = np.zeros((4, 64), np.float32)
            for r in range(4):
                ss[r, :cols] = scale[(p0 + 64 * (r >> 1) + (r & 1) * half) >> gshift, n0:n0 + cols]
            for cw in range(2):
                for w in range(4):
                    row = 64 * cw + 16 * w + g
                    for j in range(4):
                        for i in range(4):
                            rh, c = i & 1, 16 * j + 2 * q + 8 * (i >> 1)
                            addr = _swz64(row + 8 * rh, j) + (c & 15)
                            pair = smem[addr].astype(np.uint32) | smem[addr + 1].astype(
                                np.uint32) << 8
                            nib = (pair | (pair << 12)) & 0x0F0F0F0F
                            if staged:
                                s4 = [ss[2 * cw, c], ss[2 * cw, c + 1], ss[2 * cw + 1, c],
                                      ss[2 * cw + 1, c + 1]]
                            else:
                                k = p0 + row + 8 * rh
                                n = np.minimum(n0 + c, N - 2)
                                live = n0 + c < N
                                s4 = [np.where(live, scale[kk >> gshift, n + e], 0)
                                      for kk in (k, k + half) for e in (0, 1)]
                            magic = np.stack([(nib >> (8 * b)) & 0xFF for b in range(4)])
                            f = torch.from_numpy(
                                ((magic | 0x4B000000).astype(np.int32).view(np.float32)
                                 - np.float32(8388616.0)) * np.stack(s4).astype(np.float32))
                            col = 16 * w + 8 * rh + g  # the epilogue's (checked below)
                            for h in range(2):  # block h: the low run, then the high
                                k_out = h * half + p0 + 64 * cw + col
                                for e in range(2):
                                    n = n0 + c + e
                                    live = n < N
                                    got[k_out[live], n[live]] = f[2 * h + e][live].to(
                                        torch.bfloat16)
    assert torch.equal(got, want)

    # The epilogue: the stmatrix of step jj stores matrix mi = lane >> 3 of
    # every lane's registers, register mi = 2 (jj' - jj) + rh holding the
    # thread's accumulator pair (e & 1 = 0, 1) of row 16w + g + 8rh at tokens
    # 8jj' + 2q, + 1; fragment element (g, cc) of matrix mi goes to byte 2g of
    # the 16 bytes lane 8 mi + cc addresses. Un-swizzled as TMA's store reads
    # the panel, each lands on its token's row and its weight row's column.
    for w in range(4):
        for jj1 in range(128 // 8):  # jj' (BT 128)
            jj = jj1 & ~1
            for rh in range(2):
                mi = 2 * (jj1 - jj) + rh
                for e1 in range(2):
                    cc = 2 * q + e1  # fragment column of lane (g, q)'s element
                    lane_addr = 8 * mi + cc
                    off = _swz128(8 * (jj + (lane_addr >> 3 >> 1)) + (lane_addr & 7),
                                  2 * w + ((lane_addr >> 3) & 1))
                    logical = _swizzle(off + 2 * g, 3)
                    assert (logical // 128 == 8 * jj1 + 2 * q + e1).all()
                    assert ((logical % 128) // 2 == 16 * w + 8 * rh + g).all()
