"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so without a GPU these skip.

This file imports no JAX, so it also runs where JAX is absent (the
GPU machine); there, skip the repo's conftest, which imports JAX:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tolerance: int4 dequant bit-exact (``torch.equal``): the kernel and its
plain version do the same f32 multiply and one rounding to the output
type. Flash attention in bf16: the kernels sum in another order than
their plain versions (an online softmax over 64-key tiles against one
pass with the global row max, so P rounds to bf16 against another max),
so results agree to a few bf16 ulps: ``||got - want|| / ||want||``
within ``flash_attention.TILE_RTOL`` in every tile of 64 positions of
one row and head (``flash_attention.tile_rel_err``) for outputs and
gradients, 1e-3 absolute for the f32 lse. Grouped matmul in bf16: the
same norm-relative check per 128-row tile against ``grouped_matmul.
TILE_RTOL`` (both sides round the same f32 sums once to bf16), on
routings with empty experts, all rows on one expert and a large tail,
into output buffers left full of NaN so an unwritten row shows; the
weight gradient ``tgmm`` the same way over 128-row tiles of its
``[E·K, N]`` view. The int4 fused-dequant matmul and its dX in bf16: per
128 x 128 output tile within ``int4.TILE_RTOL`` (``int4.tile_rel_err``),
into NaN-filled buffers.
"""

import numpy as np
import pytest
import torch

from odh_kubeflow_tpu_torch.ops import flash_attention as fa
from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm
from odh_kubeflow_tpu_torch.ops import int4


def _operands(K, N, g, seed=0):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, size=(K // 2, N), dtype=np.uint8)  # every nibble
    scale = (rng.random((g, N)) * 0.02 + 1e-4).astype(np.float32)
    return torch.from_numpy(packed).cuda(), torch.from_numpy(scale).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "K,N,g",
    [
        (4096, 1024, 32),  # an 8B wk: group 128, vector path
        (14336, 512, 112),  # w_down's K
        (4096, 8016, 32),  # N not a power of two
        (154, 1003, 1),  # N % 16 != 0: one byte per thread
        (74, 208, 1),  # K/2 not a multiple of the rows per thread
        (256, 48, 4),  # group 64
    ],
)
def test_int4_kernel_bit_exact_on_card(dtype, K, N, g):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p, s = _operands(K, N, g)
    before = int4.launches
    got = int4.int4_dequant(p, s, dtype)
    torch.cuda.synchronize()
    assert int4.launches == before + 1
    assert got.shape == (K, N) and got.dtype == dtype
    assert torch.equal(got, int4.int4_dequant_reference(p, s, dtype))


@pytest.mark.gpu
def test_int4_kernel_on_a_layer_slice_and_misaligned_view():
    """A slice of a stacked ``[L, K/2, N]`` leaf (what the decoder loop
    passes) and a view whose start is not 16-byte aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p, s = _operands(3 * 512, 256, 3 * 8)
    stacked_p, stacked_s = p.reshape(3, 256, 256), s.reshape(3, 8, 256)
    for i in range(3):
        got = int4.int4_dequant(stacked_p[i], stacked_s[i])
        assert torch.equal(got, int4.int4_dequant_reference(stacked_p[i], stacked_s[i]))
    flat = torch.from_numpy(np.arange(1 + 64 * 32, dtype=np.uint8)).cuda()
    view = flat[1:].reshape(64, 32)  # contiguous, data_ptr % 16 == 1
    sc = torch.full((1, 32), 0.5, device="cuda")
    got = int4.int4_dequant(view, sc, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, int4.int4_dequant_reference(view, sc, torch.float32))


@pytest.mark.gpu
def test_int4_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p, s = _operands(256, 64, 2)
    with pytest.raises(ValueError):
        int4.int4_dequant(p.t(), s)  # not contiguous
    with pytest.raises(ValueError):
        int4.int4_dequant(p, s.cpu())  # two devices


def _close(got, want, tol):
    assert got.shape == want.shape
    rel = fa.tile_rel_err(got, want)
    assert rel <= tol, rel


def _attn_inputs(B, Sq, Sk, Hq, Hkv, hd, seg, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().bfloat16()

    q, k, v, do = t(B, Sq, Hq, hd), t(B, Sk, Hkv, hd), t(B, Sk, Hkv, hd), t(B, Sq, Hq, hd)
    qseg = kseg = None
    if seg:
        ids = np.sort(rng.integers(0, 3, size=(B, max(Sq, Sk))), axis=1).astype(np.int32)
        ids = torch.from_numpy(ids).cuda()
        qseg, kseg = ids[:, :Sq].contiguous(), ids[:, :Sk].contiguous()
    return q, k, v, do, qseg, kseg


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,Sq,Sk,Hq,Hkv,hd,causal,q_offset,seg",
    [
        (2, 256, 256, 4, 4, 64, True, 0, False),  # MHA, hd 64
        (2, 128, 128, 8, 2, 128, True, 0, False),  # GQA group 4, hd 128
        (1, 384, 384, 4, 1, 128, True, 0, False),  # MQA
        (1, 200, 200, 8, 2, 128, True, 0, False),  # ragged
        (1, 1000, 1000, 4, 2, 64, True, 0, False),  # ragged, many tiles
        (2, 256, 256, 4, 2, 64, True, 0, True),  # packed documents
        (2, 192, 192, 4, 4, 64, False, 0, False),  # non-causal
        (1, 130, 130, 4, 4, 128, False, 0, True),  # non-causal, segments, ragged
        (1, 128, 320, 4, 2, 128, True, 192, False),  # Sq != Sk, q_offset
        (1, 64, 128, 2, 1, 64, True, -80, False),  # rows with no live key
        (1, 129, 129, 4, 2, 128, True, 0, False),  # one row past a 128-query tile
        (1, 255, 255, 4, 2, 64, True, 0, False),  # one row short of two tiles
        (1, 200, 392, 4, 2, 128, True, 192, False),  # Sq != Sk, q_offset, ragged tile
        (1, 127, 127, 4, 2, 128, True, 0, False),  # one key short of a 128-key block
        (1, 100, 129, 4, 2, 64, True, 29, False),  # one key past a block, Sq != Sk
        (1, 257, 257, 4, 1, 128, False, 0, True),  # one key past two blocks, segments
        (1, 203, 203, 4, 2, 64, True, 0, True),  # Sq % 4 != 0 (lse/delta rows), segments
        (1, 256, 256, 8, 1, 128, True, 0, False),  # GQA group 8
        (1, 384, 384, 4, 2, 64, True, -150, False),  # key tiles with no live query
        (2, 300, 300, 4, 2, 64, True, 0, True),  # documents across 128-key blocks
    ],
)
def test_flash_kernels_match_plain_on_card(B, Sq, Sk, Hq, Hkv, hd, causal, q_offset, seg):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v, do, qseg, kseg = _attn_inputs(B, Sq, Sk, Hq, Hkv, hd, seg)
    kw = dict(causal=causal, q_offset=q_offset)
    before = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    out, lse = fa.flash_fwd(q, k, v, qseg, kseg, **kw)
    want_out, want_lse = fa.flash_fwd_reference(q, k, v, qseg, kseg, **kw)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    _close(out, want_out, fa.TILE_RTOL["flash_fwd"])
    live = want_lse > -1e29
    assert torch.equal(live, lse > -1e29)
    assert ((lse - want_lse) * live).abs().max().item() <= 1e-3
    assert not bool(out.transpose(1, 2)[~live].any())  # no live key: zeros
    delta = fa.flash_delta(out, do)
    dq = fa.flash_dq(q, k, v, lse, delta, do, qseg, kseg, **kw)
    dk, dv = fa.flash_dkv(q, k, v, lse, delta, do, qseg, kseg, **kw)
    torch.cuda.synchronize()
    want_dq = fa.flash_dq_reference(q, k, v, lse, delta, do, qseg, kseg, **kw)
    _close(dq, want_dq, fa.TILE_RTOL["flash_dq"])
    want_dk, want_dv = fa.flash_dkv_reference(q, k, v, lse, delta, do, qseg, kseg, **kw)
    _close(dk, want_dk, fa.TILE_RTOL["flash_dkv"])
    _close(dv, want_dv, fa.TILE_RTOL["flash_dkv"])
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(n + 1 for n in before)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,seg", [(128, False), (64, True)])
def test_flash_backward_kernels_are_deterministic_on_card(hd, seg):
    """Each output is written once by one block, with no atomics: two
    launches on the same inputs give bitwise-equal dQ, dK and dV."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v, do, qseg, kseg = _attn_inputs(2, 320, 320, 8, 2, hd, seg, seed=5)
    out, lse = fa.flash_fwd(q, k, v, qseg, kseg)
    delta = fa.flash_delta(out, do)
    args = (q, k, v, lse, delta, do, qseg, kseg)
    first = (fa.flash_dq(*args), *fa.flash_dkv(*args))
    second = (fa.flash_dq(*args), *fa.flash_dkv(*args))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_attention_autograd_and_strided_inputs_on_card():
    """q, k, v as strided views of one fused projection (no copy), through
    the autograd glue: one launch of each kernel, gradients equal to the
    plain versions'."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    B, S, Hq, Hkv, hd = 2, 192, 8, 2, 128
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(
        rng.standard_normal((B, S, Hq + 2 * Hkv, hd)).astype(np.float32)
    ).cuda().bfloat16().requires_grad_()
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq : Hq + Hkv], qkv[:, :, Hq + Hkv :]
    assert not q.is_contiguous()
    g = torch.from_numpy(rng.standard_normal((B, S, Hq, hd)).astype(np.float32)).cuda().bfloat16()
    before = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    out = fa.flash_attention(q, k, v)
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(n + 1 for n in before)
    got = qkv.grad.clone()
    qkv.grad = None
    want_out, lse = fa.flash_fwd_reference(q, k, v)
    delta = fa.flash_delta(want_out, g)
    dq = fa.flash_dq_reference(q.detach(), k.detach(), v.detach(), lse, delta, g)
    dk, dv = fa.flash_dkv_reference(q.detach(), k.detach(), v.detach(), lse, delta, g)
    _close(out, want_out, fa.TILE_RTOL["flash_fwd"])
    _close(got[:, :, :Hq], dq, fa.TILE_RTOL["flash_dq"])
    _close(got[:, :, Hq : Hq + Hkv], dk, fa.TILE_RTOL["flash_dkv"])
    _close(got[:, :, Hq + Hkv :], dv, fa.TILE_RTOL["flash_dkv"])


@pytest.mark.gpu
def test_flash_kernels_refuse_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v, _, _, _ = _attn_inputs(1, 64, 64, 2, 1, 64, False)
    with pytest.raises(TypeError):
        fa.flash_fwd(q.float(), k.float(), v.float())  # f32 on the card
    with pytest.raises(ValueError):
        fa.flash_fwd(q[..., :32], k[..., :32], v[..., :32])  # hd 32
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k.cpu(), v)  # two devices


# ---------------------------------------------------------------------------
# grouped matmul (csrc/gmm.cu, csrc/swiglu_gmm.cu). Tolerance: bf16, each
# 128-row tile within gm.TILE_RTOL of the plain version, ||got - want|| /
# ||want|| (gm.tile_rel_err): both round the same f32 sums once to bf16.

GROUPED_OFFSETS = {
    "balanced": [0, 256, 512, 768, 1024],
    "empty": [0, 384, 384, 384, 1024],  # experts 1 and 2 own no row
    "one_expert": [0, 0, 0, 1024, 1024],  # every row on expert 2
    "large_tail": [0, 128, 256, 256, 1024],  # expert 3's rows are mostly tail
}


def _grouped_inputs(K, N, trans=False, seed=0, E=4, M=1024):
    rng = np.random.default_rng(seed)
    lhs = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).cuda().bfloat16()
    q = torch.from_numpy(rng.integers(-127, 128, (E, N, K) if trans else (E, K, N),
                                      dtype=np.int8)).cuda()
    scale = torch.from_numpy((rng.random((E, 1, K if trans else N)) * 0.02 + 1e-3)
                             .astype(np.float32)).cuda()
    return lhs, q, scale


def _grouped_offsets(routing, M):
    """A routing of ``GROUPED_OFFSETS`` (written for 1,024 rows) scaled to
    M rows, each group start rounded down to 128."""
    offs = [o * M // 1024 // 128 * 128 for o in GROUPED_OFFSETS[routing][:-1]] + [M]
    return torch.tensor(offs, dtype=torch.int32, device="cuda")


# gmm's edges in the persistent design (K, N, trans, M): N 272 ends 16
# columns into a last 128- or 256-wide tile; K 48 is less than one 64-wide
# chunk; M 256 gives fewer tiles than SMs; N 13,072 at M 1024 is enough
# tiles for the 256-wide width (gm.gmm_tile_width), with a last tile of 16
# columns.
GMM_EDGES = [(1024, 272, False, 1024), (1024, 272, True, 1024), (48, 512, False, 1024),
             (48, 512, True, 1024), (2048, 512, False, 256), (1024, 384, True, 256),
             (256, 13_072, False, 1024), (256, 13_072, True, 1024)]


def _poison(*shape):
    """Leave NaN in the caching allocator's next block of this size: an
    output row a kernel does not write then shows as NaN."""
    t = torch.full(shape, float("nan"), dtype=torch.bfloat16, device="cuda")
    del t


def _tiles_close(got, want):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    rel = gm.tile_rel_err(got, want)
    assert rel <= gm.TILE_RTOL, rel


@pytest.mark.gpu
@pytest.mark.parametrize("routing", list(GROUPED_OFFSETS))
@pytest.mark.parametrize("K,N,trans,M", [(2048, 512, False, 1024), (1024, 384, True, 1024),
                                         (4096, 256, True, 1024), (208, 96, False, 1024),
                                         *GMM_EDGES])
def test_gmm_kernel_matches_plain_on_card(routing, K, N, trans, M):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    lhs, q, scale = _grouped_inputs(K, N, trans, M=M)
    offs = _grouped_offsets(routing, M)
    before = gm.gmm_launches
    _poison(lhs.shape[0], N)
    got = gm.gmm(lhs, q, offs, trans, scale)
    torch.cuda.synchronize()
    assert gm.gmm_launches == before + 1
    _tiles_close(got, gm.gmm_reference(lhs, q, offs, trans, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("routing", list(GROUPED_OFFSETS))
# (208, 96): K not a multiple of the 64-wide chunk, N ending inside the
# second 64-column panel of the backward's 256-column tile; (1024, 400):
# a last tile of 144 columns, whose last panel lies wholly past N; (48,
# 272): K below one chunk, N 16 columns into the forward's third 128-wide
# tile; M 256: fewer tiles than SMs
@pytest.mark.parametrize("K,N,M", [(512, 640, 1024), (208, 96, 1024), (1024, 400, 1024),
                                   (48, 272, 1024), (512, 640, 256)])
def test_swiglu_kernels_match_plain_on_card(routing, K, N, M):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    lhs, wg, sg = _grouped_inputs(K, N, seed=1, M=M)
    _, wu, su = _grouped_inputs(K, N, seed=2, M=M)
    offs = _grouped_offsets(routing, M)
    before = (gm.swiglu_fwd_launches, gm.swiglu_bwd_launches)
    _poison(lhs.shape[0], N)
    h, g = gm.swiglu_fwd(lhs, wg, wu, sg, su, offs)
    want_h, want_g = gm.swiglu_fwd_reference(lhs, wg, wu, sg, su, offs)
    torch.cuda.synchronize()
    _tiles_close(h, want_h)
    _tiles_close(g, want_g)
    dh = torch.randn(h.shape, generator=torch.Generator("cuda").manual_seed(3),
                     device="cuda").bfloat16()
    dg, du = gm.swiglu_bwd(lhs, wu, su, g, dh, offs)
    want_dg, want_du = gm.swiglu_bwd_reference(lhs, wu, su, g, dh, offs)
    torch.cuda.synchronize()
    _tiles_close(dg, want_dg)
    _tiles_close(du, want_du)
    assert (gm.swiglu_fwd_launches, gm.swiglu_bwd_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("keep_g", [True, False])
def test_expert_ffn_autograd_on_card(keep_g):
    """The fused expert op through autograd: forward one SwiGLU and one
    gmm launch; backward one down dlhs, one SwiGLU backward, two gate/up
    dlhs (and without ``keep_g`` the SwiGLU forward again); the lhs
    gradient equals the plain versions' composition."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    D, F = 256, 512
    lhs, wg, sg = _grouped_inputs(D, F, seed=4)
    _, wu, su = _grouped_inputs(D, F, seed=5)
    _, wd, sd = _grouped_inputs(F, D, seed=6)
    offs = torch.tensor(GROUPED_OFFSETS["large_tail"], dtype=torch.int32, device="cuda")
    x = lhs.clone().requires_grad_()
    counts = lambda: (gm.swiglu_fwd_launches, gm.swiglu_bwd_launches, gm.gmm_launches)  # noqa: E731
    c0 = counts()
    y, _ = gm.expert_ffn_op(x, wg, sg, wu, su, wd, sd, offs, keep_g)
    dy = torch.randn(y.shape, generator=torch.Generator("cuda").manual_seed(7),
                     device="cuda").bfloat16()
    (dx,) = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    c1 = counts()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (1 if keep_g else 2, 1, 4)
    h, g = gm.swiglu_fwd_reference(lhs, wg, wu, sg, su, offs)
    _tiles_close(y, gm.gmm_reference(h, wd, offs, False, sd))
    dh = gm.gmm_reference(dy, wd, offs, True, sd)
    dg, du = gm.swiglu_bwd_reference(lhs, wu, su, g, dh, offs)
    want = gm.gmm_reference(dg, wg, offs, True, sg) + gm.gmm_reference(du, wu, offs, True, su)
    _tiles_close(dx, want)


@pytest.mark.gpu
@pytest.mark.parametrize("routing", list(GROUPED_OFFSETS))
@pytest.mark.parametrize("K,N,trans,M", [(2048, 512, False, 1024), (1024, 384, True, 1024),
                                         (8192, 256, True, 1024), (208, 96, False, 1024),
                                         *GMM_EDGES,
                                         # the serving prefill's two shapes (M 3,072): 128-
                                         # and 256-wide tiles
                                         (8192, 2048, False, 3072), (2048, 8192, False, 3072)])
def test_gmm_bf16_bank_kernel_matches_plain_on_card(routing, K, N, trans, M):
    """The bf16-bank form (``_gmm_a_kernel`` and the unscaled
    ``_gmm_b_kernel``): no scale, either orientation, every row written."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    lhs, q, _ = _grouped_inputs(K, N, trans, M=M)
    w = (q.float() * 0.01).bfloat16()
    offs = _grouped_offsets(routing, M)
    before, by_k = gm.gmm_launches, gm.gmm_launches_by_k.get(("bf16", K), 0)
    _poison(lhs.shape[0], N)
    got = gm.gmm(lhs, w, offs, trans)
    torch.cuda.synchronize()
    assert gm.gmm_launches == before + 1 and gm.gmm_launches_by_k[("bf16", K)] == by_k + 1
    _tiles_close(got, gm.gmm_reference(lhs, w, offs, trans))


@pytest.mark.gpu
def test_gmm_schedule_matches_its_python_mirror_on_card():
    """The tile width and persistent tile order ``csrc/gmm.cu`` takes are
    the ones ``gmm_tile_width`` and ``tile_order`` mirror (and the CPU
    tests hold), on this card's SM count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import ctypes

    lib = gm._library("gmm")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, n in ((17_408, 2048), (17_408, 8192), (3072, 2048), (3072, 8192), (1024, 272)):
        assert lib.gmm_tile_width(m, n, sms) == gm.gmm_tile_width(m, n, sms)
        width = gm.gmm_tile_width(m, n, sms)
        m_tiles, n_tiles = m // 128, -(-n // width)
        out = (ctypes.c_int * (2 * m_tiles * n_tiles))()
        lib.gmm_tile_order(m_tiles, n_tiles, out)
        got = [(out[2 * t], out[2 * t + 1]) for t in range(m_tiles * n_tiles)]
        assert got == gm.tile_order(m_tiles, n_tiles)


def _tgmm_close(got, want):
    """Per 128-row tile of the ``[E·K, N]`` view (where K % 128 == 0 a
    tile lies in one expert's block; an empty expert's want is zero)."""
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    rel = gm.tile_rel_err(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))
    assert rel <= gm.TILE_RTOL, rel


@pytest.mark.gpu
def test_tgmm_schedule_matches_its_python_mirror_on_card():
    """The tile width and expert-major tile order ``csrc/tgmm.cu`` takes
    are the ones ``tgmm_tile_width`` and ``tgmm_tile_order`` mirror (and
    the CPU tests hold), on this card's SM count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import ctypes

    lib = gm._library("tgmm")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, n, e in ((2048, 8192, 8), (8192, 2048, 8), (256, 512, 4), (48, 272, 4), (384, 208, 4)):
        assert lib.tgmm_tile_width(k, n, e, sms) == gm.tgmm_tile_width(k, n, e, sms)
        width = gm.tgmm_tile_width(k, n, e, sms)
        k_tiles, n_tiles = -(-k // 128), -(-n // width)
        out = (ctypes.c_int * (3 * e * k_tiles * n_tiles))()
        lib.tgmm_tile_order(e, k_tiles, n_tiles, out)
        got = [tuple(out[3 * t : 3 * t + 3]) for t in range(e * k_tiles * n_tiles)]
        assert got == gm.tgmm_tile_order(e, k_tiles, n_tiles)


@pytest.mark.gpu
@pytest.mark.parametrize("routing", ["balanced", "one_expert"])
def test_tgmm_kernel_is_deterministic_on_card(routing):
    """No rows split across blocks and no atomics: two launches agree bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(5)
    lhs = torch.from_numpy(rng.standard_normal((2048, 512)).astype(np.float32)).cuda().bfloat16()
    dout = torch.from_numpy(rng.standard_normal((2048, 768)).astype(np.float32)).cuda().bfloat16()
    offs = _grouped_offsets(routing, 2048)
    first = gm.tgmm(lhs, dout, offs, 4)
    second = gm.tgmm(lhs, dout, offs, 4)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _tgmm_close(first, gm.tgmm_reference(lhs, dout, offs, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("routing", list(GROUPED_OFFSETS))
@pytest.mark.parametrize("K,N", [(256, 512), (512, 128), (384, 208), (48, 272), (208, 96),
                                 (1024, 1024)])
def test_tgmm_kernel_matches_plain_on_card(routing, K, N):
    """``_tgmm_kernel``'s port: ``[E, K, N]`` per-expert sums over each
    group's rows, the tail with the last expert, zeros for an empty
    expert (into a NaN-filled buffer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(K + N)
    lhs = torch.from_numpy(rng.standard_normal((1024, K)).astype(np.float32)).cuda().bfloat16()
    dout = torch.from_numpy(rng.standard_normal((1024, N)).astype(np.float32)).cuda().bfloat16()
    offs = torch.tensor(GROUPED_OFFSETS[routing], dtype=torch.int32, device="cuda")
    before = gm.tgmm_launches
    _poison(4, K, N)
    got = gm.tgmm(lhs, dout, offs, 4)
    torch.cuda.synchronize()
    assert gm.tgmm_launches == before + 1 and got.dtype == torch.bfloat16
    want = gm.tgmm_reference(lhs, dout, offs, 4)
    _tgmm_close(got, want)
    for e in range(4):
        if GROUPED_OFFSETS[routing][e + 1] == GROUPED_OFFSETS[routing][e]:
            assert not bool(got[e].any())


@pytest.mark.gpu
@pytest.mark.parametrize("trans", [False, True], ids=["nt", "trans"])
def test_float_bank_gmm_op_backward_launches_one_gmm_and_one_tgmm_on_card(trans):
    """A trainable bf16 bank through ``gmm_op``: the forward one ``gmm``,
    the backward one ``gmm`` (dlhs, the bank read the other way round) and
    one ``tgmm`` (dW, in the bank's layout); both against the plain
    versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    K, N = 512, 256
    lhs, q, _ = _grouped_inputs(K, N, trans, seed=8)
    w = (q.float() * 0.01).bfloat16().requires_grad_()
    x = lhs.clone().requires_grad_()
    offs = torch.tensor(GROUPED_OFFSETS["large_tail"], dtype=torch.int32, device="cuda")
    dout = torch.randn((1024, N), generator=torch.Generator("cuda").manual_seed(9),
                       device="cuda").bfloat16()
    c0 = (gm.gmm_launches, gm.tgmm_launches)
    y = gm.gmm_op(x, w, offs, trans, None)
    assert (gm.gmm_launches, gm.tgmm_launches) == (c0[0] + 1, c0[1])
    dx, dw = torch.autograd.grad(y, (x, w), dout)
    torch.cuda.synchronize()
    assert (gm.gmm_launches, gm.tgmm_launches) == (c0[0] + 2, c0[1] + 1)
    assert dw.shape == w.shape and dw.dtype == torch.bfloat16
    _tiles_close(dx, gm.gmm_reference(dout, w.detach(), offs, not trans))
    want_dw = (gm.tgmm_reference(dout, lhs, offs, 4) if trans
               else gm.tgmm_reference(lhs, dout, offs, 4))
    _tgmm_close(dw, want_dw)


@pytest.mark.gpu
def test_expert_ffn_float_banks_autograd_on_card():
    """The expert op on trainable bf16 banks, g not kept (remat "attn"):
    forward three ``gmm``; backward two recomputed (gate, up), three dlhs
    and three ``tgmm``; every gradient against the plain versions'."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    D, F = 256, 512
    lhs, wg, _ = _grouped_inputs(D, F, seed=4)
    _, wu, _ = _grouped_inputs(D, F, seed=5)
    _, wd, _ = _grouped_inputs(F, D, seed=6)
    banks = [(w.float() * 0.002).bfloat16().requires_grad_() for w in (wg, wu, wd)]
    offs = torch.tensor(GROUPED_OFFSETS["empty"], dtype=torch.int32, device="cuda")
    x = lhs.clone().requires_grad_()
    c0 = (gm.gmm_launches, gm.tgmm_launches)
    y, _ = gm.expert_ffn_op(x, banks[0], None, banks[1], None, banks[2], None, offs, False)
    assert (gm.gmm_launches - c0[0], gm.tgmm_launches - c0[1]) == (3, 0)
    dy = torch.randn(y.shape, generator=torch.Generator("cuda").manual_seed(7),
                     device="cuda").bfloat16()
    grads = torch.autograd.grad(y, (x, *banks), dy)
    torch.cuda.synchronize()
    assert (gm.gmm_launches - c0[0], gm.tgmm_launches - c0[1]) == (8, 3)
    bg, bu, bd = (b.detach() for b in banks)
    g, u = gm.gmm_reference(lhs, bg, offs), gm.gmm_reference(lhs, bu, offs)
    h = (torch.nn.functional.silu(g.float()) * u.float()).bfloat16()
    _tiles_close(y, gm.gmm_reference(h, bd, offs))
    dh = gm.gmm_reference(dy, bd, offs, True).float()
    sig = torch.sigmoid(g.float())
    dg = (dh * u.float() * sig * (1 + g.float() * (1 - sig))).bfloat16()
    du = (dh * g.float() * sig).bfloat16()
    _tiles_close(grads[0], gm.gmm_reference(dg, bg, offs, True) + gm.gmm_reference(du, bu, offs, True))
    for got, want in zip(grads[1:], (gm.tgmm_reference(lhs, dg, offs, 4),
                                      gm.tgmm_reference(lhs, du, offs, 4),
                                      gm.tgmm_reference(h, dy, offs, 4))):
        _tgmm_close(got, want)


@pytest.mark.gpu
def test_grouped_kernels_refuse_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    lhs, q, scale = _grouped_inputs(256, 128)
    offs = torch.tensor(GROUPED_OFFSETS["balanced"], dtype=torch.int32, device="cuda")
    before = gm.gmm_launches
    got = gm.gmm(lhs, q.bfloat16(), offs)  # a bf16 bank: _gmm_a_kernel's port launches
    assert gm.gmm_launches == before + 1
    _tiles_close(got, gm.gmm_reference(lhs, q.bfloat16(), offs))
    with pytest.raises(TypeError):
        gm.gmm(lhs, q.float(), offs)  # a float32 bank: the model casts it first
    with pytest.raises(TypeError):
        gm.gmm(lhs, q.bfloat16(), offs, False, scale)  # a scale goes with an int8 bank
    with pytest.raises(TypeError):
        gm.tgmm(lhs.float(), lhs.float(), offs, 4)
    with pytest.raises(ValueError):
        gm.tgmm(lhs, lhs[:, :100], offs, 4)  # N % 16 != 0
    with pytest.raises(TypeError):
        gm.gmm(lhs.float(), q, offs, False, scale)
    with pytest.raises(ValueError):
        gm.gmm(lhs[:1000], q, offs, False, scale)  # M not a multiple of 128
    with pytest.raises(ValueError):
        gm.gmm(lhs, q, offs.cpu(), False, scale)  # two devices
    with pytest.raises(ValueError):
        gm.gmm(lhs, q, offs, False, scale[:, :, :64])  # scale does not fit


# ---------------------------------------------------------------------------
# int4 fused-dequant matmul (csrc/int4_matmul.cu). Tolerance: bf16, each
# 128 x 128 output tile within int4.TILE_RTOL of the plain version
# (int4.tile_rel_err): the kernel multiplies int4_dequant's bf16 weights and
# both sides round f32 sums once to bf16.


def _int4_mm_inputs(M, K, N, group, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).cuda().bfloat16()
    d = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)).cuda().bfloat16()
    q4 = torch.from_numpy(rng.integers(0, 256, (K // 2, N), dtype=np.uint8)).cuda()
    s = torch.from_numpy((rng.random((K // group, N)) * 0.02 + 1e-4).astype(np.float32)).cuda()
    return x, d, q4, s


def _int4_tiles_close(got, want):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    rel = int4.tile_rel_err(got, want)
    assert rel <= int4.TILE_RTOL, rel


@pytest.mark.gpu
@pytest.mark.parametrize(
    "M,K,N,group",
    [
        (256, 2048, 512, 128),
        (1024, 4096, 1024, 64),
        (1, 4096, 1024, 128),  # decode
        (4, 2048, 512, 32),
        (300, 2048, 200, 128),  # ragged M; N % 16 != 0: the generic load path
        (1, 2048, 100, 1024),
        (512, 6144, 1536, 256),  # three 1024-chunks a nibble half
        (300, 4096, 1024, 128),  # ragged M on the persistent forward
        (129, 2048, 512, 8),  # one row past a 128-row tile; a small group
        (4, 2048, 512, 1),  # a scale row a weight row
        (512, 2048, 208, 64),  # a tile's second 128-column panel wholly past N
        (17, 2048, 400, 128),  # 17 tokens: the 128-token tile; N not a multiple of 256
        (16, 4096, 1024, 32),  # the 16-token decode tile, unstaged scales
    ],
)
def test_int4_matmul_kernels_match_plain_on_card(M, K, N, group):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, d, q4, s = _int4_mm_inputs(M, K, N, group)
    before = (int4.mm_launches, int4.dlhs_launches)
    _poison(M, N)
    got = int4.int4_mm(x, q4, s, group)
    _poison(M, K)
    dx = int4.int4_dlhs(d, q4, s, group)
    torch.cuda.synchronize()
    assert (int4.mm_launches, int4.dlhs_launches) == (before[0] + 1, before[1] + 1)
    _int4_tiles_close(got, int4.int4_matmul_reference(x, q4, s))
    _int4_tiles_close(dx, int4.int4_dlhs_reference(d, q4, s))


@pytest.mark.gpu
def test_int4_mm_instance_choice_matches_its_cuda_mirror_on_card():
    """The forward's tile is the one ``int4_mm_tile_rows`` mirrors; the
    wrapper takes the Hopper TMA kernel where it can map the operands and
    counts it, the generic one elsewhere, and the TMA entry point itself
    refuses the shapes the wrapper sends to the generic one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    lib = int4._mm_library()
    for m in (1, 4, 16, 17, 128, 129, 300, 512, 8192):
        assert lib.int4_mm_tile_rows(m) == int4.int4_mm_tile_rows(m)
    for (M, N), want in (((8192, 1024), "tma_128"), ((4, 1024), "tma_16"), ((300, 200), "generic")):
        x, _, q4, s = _int4_mm_inputs(M, 2048, N, 128)
        before = dict(int4.mm_launches_by_instance)
        out = int4.int4_mm(x, q4, s)
        torch.cuda.synchronize()
        assert int4.mm_launches_by_instance[want] == before.get(want, 0) + 1
        _int4_tiles_close(out, int4.int4_matmul_reference(x, q4, s))
        if want == "generic":
            rc = lib.int4_mm_launch(x.data_ptr(), q4.data_ptr(), s.data_ptr(), out.data_ptr(),
                                    M, 2048, N, 128, torch.cuda.current_stream().cuda_stream)
            assert rc != 0


@pytest.mark.gpu
def test_int4_dlhs_instance_choice_chunks_and_determinism_on_card():
    """The dX's chunk count is the one ``int4_dlhs_chunks`` mirrors; the
    wrapper takes the Hopper kernel where TMA can map the operands and the
    generic one elsewhere, and counts each; the TMA entry point refuses
    the generic's shapes; two launches of either give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    lib = int4._mm_library()
    for n in (16, 64, 100, 128, 192, 208, 400, 1024, 14336):
        assert lib.int4_dlhs_chunks(n) == int4.int4_dlhs_chunks(n)
    for (M, N), want in (((8192, 1024), "tma_128"), ((4, 1024), "tma_16"), ((1, 192), "tma_16"),
                         ((300, 200), "generic")):
        _, d, q4, s = _int4_mm_inputs(M, 2048, N, 128)
        before = dict(int4.dlhs_launches_by_instance)
        _poison(M, 2048)
        dx = int4.int4_dlhs(d, q4, s)
        torch.cuda.synchronize()
        assert int4.dlhs_launches_by_instance[want] == before.get(want, 0) + 1
        _int4_tiles_close(dx, int4.int4_dlhs_reference(d, q4, s))
        _poison(M, 2048)
        assert torch.equal(int4.int4_dlhs(d, q4, s), dx)
        if want == "generic":
            rc = lib.int4_dlhs_launch(d.data_ptr(), q4.data_ptr(), s.data_ptr(), dx.data_ptr(),
                                      M, 2048, N, 128, torch.cuda.current_stream().cuda_stream)
            assert rc != 0


@pytest.mark.gpu
def test_int4_matmul_autograd_and_misaligned_view_on_card():
    """``int4_matmul``'s backward launches the dlhs kernel once; a view
    whose start is not 16-byte aligned takes the generic kernel, in both
    directions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, d, q4, s = _int4_mm_inputs(128, 2048, 256, 128)
    x.requires_grad_(True)
    scale = s.clone().requires_grad_(True)
    before = (int4.mm_launches, int4.dlhs_launches, int4.launches)
    out = int4.int4_matmul(x, q4, scale)
    out.backward(d)
    torch.cuda.synchronize()
    assert (int4.mm_launches, int4.dlhs_launches, int4.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    _int4_tiles_close(out, int4.int4_matmul_reference(x.detach(), q4, s))
    _int4_tiles_close(x.grad, int4.int4_dlhs_reference(d, q4, s))
    assert torch.equal(scale.grad, torch.zeros_like(s))
    flat = torch.zeros(1 + 128 * 2048, dtype=torch.bfloat16, device="cuda")
    view = flat[1:].view(128, 2048)  # contiguous, data_ptr % 16 == 2
    view.copy_(x.detach())
    generic = int4.mm_launches_by_instance.get("generic", 0)
    _int4_tiles_close(int4.int4_mm(view, q4, s), int4.int4_matmul_reference(view, q4, s))
    assert int4.mm_launches_by_instance["generic"] == generic + 1
    dview = flat[1:1 + 128 * 256].view(128, 256)
    dview.copy_(d)
    generic = int4.dlhs_launches_by_instance.get("generic", 0)
    _int4_tiles_close(int4.int4_dlhs(dview, q4, s), int4.int4_dlhs_reference(dview, q4, s))
    assert int4.dlhs_launches_by_instance["generic"] == generic + 1


@pytest.mark.gpu
def test_int4_matmul_kernels_launch_from_a_fresh_thread_on_card():
    """The Hopper kernels encode their TMA maps on the calling thread,
    which needs a current context: a thread that has made no CUDA call
    yet (autograd runs a backward on one of its own) launches them too,
    after the main thread already has."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import threading

    x, d, q4, s = _int4_mm_inputs(128, 2048, 256, 128)
    want = int4.int4_matmul_reference(x, q4, s), int4.int4_dlhs_reference(d, q4, s)
    int4.int4_mm(x, q4, s), int4.int4_dlhs(d, q4, s)  # the main thread first
    got = []
    worker = threading.Thread(target=lambda: got.extend(
        (int4.int4_mm(x, q4, s), int4.int4_dlhs(d, q4, s))))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    torch.cuda.synchronize()
    assert len(got) == 2
    _int4_tiles_close(got[0], want[0])
    _int4_tiles_close(got[1], want[1])


@pytest.mark.gpu
def test_int4_matmul_kernels_refuse_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, d, q4, s = _int4_mm_inputs(8, 2048, 64, 128)
    with pytest.raises(TypeError):
        int4.int4_matmul(x.float(), q4, s)  # f32 on the card: never cast
    with pytest.raises(TypeError):
        int4.int4_dlhs(d.float(), q4, s)
    with pytest.raises(ValueError):
        int4.int4_matmul(x, q4.cpu(), s)  # two devices
    with pytest.raises(NotImplementedError):
        int4.int4_matmul(x[:, :1024].contiguous(), q4[:512], s[:8])  # K % 2048
