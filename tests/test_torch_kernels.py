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
gradients, 1e-3 absolute for the f32 lse.
"""

import numpy as np
import pytest
import torch

from odh_kubeflow_tpu_torch.ops import flash_attention as fa
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
