"""The port's generation against the JAX package's, tiny config, f32.

Greedy tokens and lengths must be exactly equal for ragged prompts,
with and without ``eos_id``, on float32, int8 and int4 trees. Top-k and
top-p must keep exactly JAX's token set. Random draws differ between
the frameworks, so temperature sampling is checked for reproducibility
under one ``torch.Generator`` seed and for its distribution against
JAX's (absolute frequency difference < 0.02 over 20000 draws each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models.generate import GenerateConfig as JaxGenerateConfig
from odh_kubeflow_tpu.models.generate import generate as jax_generate
from odh_kubeflow_tpu.models.generate import sample_logits as jax_sample_logits
from odh_kubeflow_tpu_torch.models.generate import (
    GenerateConfig,
    filter_logits,
    generate,
    sample_logits,
)
from test_torch_llama import JCFG, TCFG, trees

PROMPTS = np.array(
    [[11, 12, 13, 0, 0, 0, 0, 0],
     [21, 22, 23, 24, 25, 26, 27, 28],
     [31, 32, 33, 34, 35, 0, 0, 0]], np.int32)
LENGTHS = np.array([3, 8, 5], np.int32)


def _jax_generate(jp, gen_cfg):
    out = jax_generate(
        jp, jnp.asarray(PROMPTS), JCFG, gen_cfg, prompt_lengths=jnp.asarray(LENGTHS)
    )
    return np.asarray(out["tokens"]), np.asarray(out["lengths"])


def _torch_generate(tp, gen_cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    out = generate(
        tp, torch.from_numpy(PROMPTS).long(), TCFG, gen_cfg,
        prompt_lengths=torch.from_numpy(LENGTHS), generator=gen,
    )
    return out["tokens"].numpy(), out["lengths"].numpy()


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
def test_greedy_generate_token_exact_against_jax(kind):
    jp, tp = trees(kind, seed=11)
    N = 8
    jt, jl = _jax_generate(jp, JaxGenerateConfig(max_new_tokens=N))
    tt, tl = _torch_generate(tp, GenerateConfig(max_new_tokens=N))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    # with eos: the token row 0 emits third ends that row (and any row
    # that emits it) early; the rest of such a row pads with pad_id
    eos = int(jt[0, 2])
    jt, jl = _jax_generate(jp, JaxGenerateConfig(max_new_tokens=N, eos_id=eos, pad_id=0))
    tt, tl = _torch_generate(tp, GenerateConfig(max_new_tokens=N, eos_id=eos, pad_id=0))
    assert jl[0] <= 3
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)


def _jax_kept(logits, **kw):
    """JAX's kept token set: sample_logits with a categorical that
    returns the finite mask of the logits it was given."""
    orig = jax.random.categorical
    jax.random.categorical = lambda key, lg: jnp.isfinite(lg)
    try:
        out = jax_sample_logits(jnp.asarray(logits), jax.random.key(0), **kw)
    finally:
        jax.random.categorical = orig
    return np.asarray(out).astype(bool)


@pytest.mark.parametrize(
    "kw",
    [dict(temperature=0.7, top_k=5), dict(temperature=1.3, top_p=0.8),
     dict(temperature=1.0, top_k=20, top_p=0.5), dict(temperature=0.5, top_p=0.999)],
    ids=["top_k", "top_p", "both", "wide_p"],
)
def test_top_k_top_p_keep_the_same_tokens_as_jax(kw):
    logits = (np.random.default_rng(12).standard_normal((4, 64)) * 2.0).astype(np.float32)
    want = _jax_kept(logits, **kw)
    got = torch.isfinite(filter_logits(torch.from_numpy(logits), **kw)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_temperature_sampling_reproducible_and_distributed_like_jax():
    base = np.array([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0], np.float32)
    n = 20000
    logits = np.broadcast_to(base, (n, base.size)).copy()
    kw = dict(temperature=0.9, top_k=6, top_p=0.95)
    draw = lambda s: sample_logits(  # noqa: E731
        torch.from_numpy(logits), torch.Generator().manual_seed(s), **kw
    )
    a, b, c = draw(3), draw(3), draw(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    jdraw = np.asarray(
        jax_sample_logits(jnp.asarray(logits), jax.random.key(3), **kw)
    )
    tf = np.bincount(a.numpy(), minlength=base.size) / n
    jf = np.bincount(jdraw, minlength=base.size) / n
    assert np.abs(tf - jf).max() < 0.02, (tf, jf)
    assert set(np.flatnonzero(tf)) == set(np.flatnonzero(jf))


def test_sampled_generate_is_reproducible_per_seed():
    _, tp = trees("int4", seed=13)
    cfg = GenerateConfig(max_new_tokens=6, temperature=0.8, top_k=40, top_p=0.9)
    t1, l1 = _torch_generate(tp, cfg, seed=5)
    t2, l2 = _torch_generate(tp, cfg, seed=5)
    t3, _ = _torch_generate(tp, cfg, seed=6)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(l1, l2)
    assert not np.array_equal(t1, t3)
    assert t1.min() >= 0 and t1.max() < TCFG.vocab_size
    with pytest.raises(ValueError):
        sample_logits(torch.zeros((1, 4)), None, temperature=1.0)
