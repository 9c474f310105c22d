"""The PyTorch port's plain ops against the JAX package's, on the CPU.

The same numpy inputs go through both. Tolerance: rtol = atol = 1e-5 in
float32 — the conftest runs JAX matmuls at "highest" precision and
torch's CPU float32 is full float32, so only the order of summation
differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.ops import attention as jax_attention
from odh_kubeflow_tpu.ops import norms as jax_norms
from odh_kubeflow_tpu.ops import rope as jax_rope
from odh_kubeflow_tpu_torch.ops import attention, norms, rope

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3.0
    w = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    want = np.asarray(jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = norms.rms_norm(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("head_dim,theta", [(16, 500_000.0), (64, 10_000.0)])
def test_rope_matches_jax(head_dim, theta):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    jsin, jcos = jax_rope.rope_angles(jnp.asarray(pos), head_dim, theta)
    sin, cos = rope.rope_angles(_t(pos), head_dim, theta)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **TOL)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    want = np.asarray(jax_rope.apply_rope(jnp.asarray(x), jsin, jcos))
    got = rope.apply_rope(_t(x), sin, cos).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _qkv(rng, B=2, Sq=5, Sk=9, Hq=4, Hkv=2, hd=8):
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "case",
    [
        "causal",
        "non_causal",
        "scalar_offset",
        "vector_offset",
        "segment_ids",
        "kv_mask",
        "mha",
    ],
)
def test_dense_attention_matches_jax(case):
    rng = np.random.default_rng(2)
    Hkv = 4 if case == "mha" else 2  # GQA group 2, or plain MHA
    same_len = case == "segment_ids"
    q, k, v = _qkv(rng, Sq=9 if same_len else 5, Hkv=Hkv)
    B, Sk = k.shape[0], k.shape[1]
    kw_j, kw_t = {}, {}
    if case == "non_causal":
        kw_j["causal"] = kw_t["causal"] = False
    if case == "scalar_offset":
        kw_j["q_offset"] = kw_t["q_offset"] = 4
    if case == "vector_offset":
        off = np.array([1, 4], np.int32)
        kw_j["q_offset"], kw_t["q_offset"] = jnp.asarray(off), _t(off).long()
    if case == "segment_ids":
        seg = np.array([[0] * 4 + [1] * 5, [0] * 2 + [1] * 7], np.int32)
        kw_j["segment_ids"], kw_t["segment_ids"] = jnp.asarray(seg), _t(seg)
    if case == "kv_mask":
        m = rng.random((B, Sk)) < 0.7
        m[:, 0] = True  # every row attends somewhere
        kw_j["kv_mask"], kw_t["kv_mask"] = jnp.asarray(m), _t(m)
        kw_j["q_offset"] = kw_t["q_offset"] = 4
    want = np.asarray(
        jax_attention.dense_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw_j
        )
    )
    got = attention.dense_attention(_t(q), _t(k), _t(v), **kw_t).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
