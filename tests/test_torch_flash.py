"""The port's flash attention against the JAX package's Pallas kernels,
run in interpret mode on the CPU as the JAX package's own tests run them.

On CPU tensors the port's wrappers run the kernels' plain PyTorch
versions, through the same custom ops and autograd glue the card uses.
Inputs are float32 from a numpy seed, at ``tests/test_pallas_attention.py``'s
shapes. Tolerances are the JAX tests' own: forward and base-2 LSE 2e-5,
gradients rtol 1e-3 / atol 5e-4 (the sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.ops import pallas_attention as jpa
from odh_kubeflow_tpu_torch.ops import flash_attention as fa

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=5e-4)

CASES = {
    "mha": dict(B=1, Sq=256, Sk=256, Hq=4, Hkv=4, hd=64),
    "gqa4": dict(B=2, Sq=128, Sk=128, Hq=8, Hkv=2, hd=64),
    "mqa_hd128": dict(B=1, Sq=384, Sk=384, Hq=4, Hkv=1, hd=128),
    "ragged200": dict(B=1, Sq=200, Sk=200, Hq=4, Hkv=2, hd=64),
    "segments": dict(B=2, Sq=256, Sk=256, Hq=4, Hkv=4, hd=64, seg=True),
    "multiblock128": dict(B=1, Sq=512, Sk=512, Hq=4, Hkv=2, hd=64, block=128),
    "non_causal": dict(B=2, Sq=256, Sk=256, Hq=4, Hkv=4, hd=64, causal=False),
    "q_offset": dict(B=1, Sq=128, Sk=320, Hq=4, Hkv=2, hd=64, q_offset=192, block=128),
}


def _inputs(B, Sq, Sk, Hq, Hkv, hd, seg=False, seed=0, **_):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    g = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    ids = None
    if seg:  # two or three packed documents per row
        ids = np.sort(rng.integers(0, 3, size=(B, Sq)), axis=1).astype(np.int32)
    return q, k, v, g, ids


@pytest.mark.parametrize("name", list(CASES))
def test_forward_lse_and_grads_match_jax_pallas(name):
    case = CASES[name]
    q, k, v, g, ids = _inputs(**case)
    causal, q_offset = case.get("causal", True), case.get("q_offset", 0)
    blocks = {} if "block" not in case else dict(block_q=case["block"], block_k=case["block"])
    jseg = None if ids is None else jnp.asarray(ids)

    def jloss(q, k, v):
        out = jpa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  segment_ids=jseg, interpret=True, **blocks)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tseg = None if ids is None else torch.from_numpy(ids)
    tout = fa.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                              segment_ids=tseg, **blocks)
    (tout * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **FWD)
    for t, j in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **GRAD)

    # the base-2 residual against pallas_attention._fwd's, unpadded
    B, Sq, Sk = case["B"], case["Sq"], case["Sk"]
    bq = min(case.get("block", jpa.DEFAULT_BLOCK_Q), -(-Sq // 128) * 128)
    bk = min(case.get("block", jpa.DEFAULT_BLOCK_K), -(-Sk // 128) * 128)
    qt, kt, vt, qseg, kseg = jpa._prep(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jseg, Sq, Sk, bq, bk)
    _, jlse = jpa._fwd(qt, kt, vt, qseg, kseg, scale=case["hd"] ** -0.5, causal=causal,
                       q_offset=q_offset, sk=Sk, block_q=bq, block_k=bk, interpret=True)
    _, tlse = fa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           None if tseg is None else tseg.int(),
                           None if tseg is None else tseg[:, :Sk].int(),
                           causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :, :Sq, 0], **FWD)


def test_rows_with_no_live_key_give_zeros_not_nan():
    """A negative offset leaves the first rows with no key to attend to:
    zeros out, lse2 = -1e30, finite gradients (what ring shards rely on)."""
    q, k, v, g, _ = _inputs(B=1, Sq=64, Sk=64, Hq=2, Hkv=1, hd=16, seed=1)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, q_offset=-10)
    (out * torch.from_numpy(g)).sum().backward()
    assert not out[:, :10].any() and out[:, 10:].abs().sum() > 0
    _, lse = fa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          q_offset=-10)
    assert (lse[:, :, :10] == fa.NEG_INF).all()
    assert all(bool(torch.isfinite(t.grad).all()) for t in (tq, tk, tv))


def test_the_three_plain_versions_are_the_backward():
    """flash_dq/flash_dkv on the forward's residuals give the gradients
    autograd gives the dense softmax attention (independent check of the
    plain versions, GQA group 2)."""
    q, k, v, g, _ = _inputs(B=2, Sq=48, Sk=48, Hq=4, Hkv=2, hd=32, seed=2)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = fa.flash_fwd(tq, tk, tv)
    delta = fa.flash_delta(out, tg)
    dq = fa.flash_dq(tq, tk, tv, lse, delta, tg)
    dk, dv = fa.flash_dkv(tq, tk, tv, lse, delta, tg)
    rq, rk, rv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    kr, vr = rk.repeat_interleave(2, dim=2), rv.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", rq, kr) * 32**-0.5
    s = s.masked_fill(~torch.ones(48, 48, dtype=torch.bool).tril(), float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vr)
    (ref * tg).sum().backward()
    for got, want in ((out, ref.detach()), (dq, rq.grad), (dk, rk.grad), (dv, rv.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_tile_check_passes_bf16_rounding_and_rejects_a_skipped_tile():
    """``tile_rel_err`` and ``TILE_RTOL``, what the card's kernels are held
    to: the plain versions in bf16 against f32 on the same inputs pass; a
    forward or dQ that skips one key tile, or a dK/dV that skips one query
    tile, fails, though each tile is 1/8 of the sequence's work."""
    q, k, v, g, _ = _inputs(B=1, Sq=512, Sk=512, Hq=4, Hkv=2, hd=64, seed=4)
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v, g)]
    f32 = [t.float() for t in bf]

    def run(tq, tk, tv, tg, fwd_seg=(None, None), bwd_seg=(None, None)):
        out, _ = fa.flash_fwd(tq, tk, tv, *fwd_seg)
        ref_out, ref_lse = fa.flash_fwd(tq, tk, tv)
        delta = fa.flash_delta(ref_out, tg)
        dq = fa.flash_dq(tq, tk, tv, ref_lse, delta, tg, *fwd_seg)
        return (out, dq, *fa.flash_dkv(tq, tk, tv, ref_lse, delta, tg, *bwd_seg))

    want = run(*f32)
    names = ("flash_fwd", "flash_dq", "flash_dkv", "flash_dkv")
    for name, got, w in zip(names, run(*bf), want):
        assert fa.tile_rel_err(got, w) <= fa.TILE_RTOL[name], name
    zeros = torch.zeros((1, 512), dtype=torch.int32)
    tile = zeros.clone()
    tile[:, 256:320] = 1  # in a document of its own
    faulty = run(*f32, fwd_seg=(zeros, tile), bwd_seg=(tile, zeros))
    for name, got, w in zip(names, faulty, want):
        assert fa.tile_rel_err(got, w) > 5 * fa.TILE_RTOL[name], name


def test_signature_and_errors():
    q, k, v, _, _ = _inputs(B=1, Sq=8, Sk=8, Hq=4, Hkv=2, hd=16)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    base = fa.flash_attention(tq, tk, tv)
    # TPU tiling arguments change no result
    tiled = fa.flash_attention(tq, tk, tv, block_q=128, block_k=256, bwd_block_q=64,
                               bwd_block_k=64)
    assert torch.equal(base, tiled)
    with pytest.raises(TypeError):
        fa.flash_attention(tq, tk, tv, q_offset=torch.tensor(1))
    with pytest.raises(ValueError):
        fa.flash_attention(tq, tk[:, :, :1].repeat(1, 1, 3, 1), tv[:, :, :1].repeat(1, 1, 3, 1))
    with pytest.raises(ValueError):
        fa.flash_attention(tq, tk, tv, segment_ids=torch.zeros((1, 4), dtype=torch.int32))
