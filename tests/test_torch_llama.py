"""The port's Llama forward against the JAX package's, tiny config, f32.

One numpy param tree (JAX layout) goes to both packages, as float32,
as an int8 tree and as an int4 tree (quantized by JAX, carried over by
``convert.py``), with and without a LoRA adapter whose ``b`` is
nonzero. Tolerance on logits and caches: rtol = atol = 1e-4, because
the sums run in another order over the layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import llama as jax_llama
from odh_kubeflow_tpu.models import lora as jax_lora
from odh_kubeflow_tpu.models import quant as jax_quant
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama, lora
from odh_kubeflow_tpu_torch.models.generate import init_cache

TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = llama.LlamaConfig.tiny(dtype=torch.float32)


def np_params(cfg, seed=0):
    """A param tree in the JAX layout, from a numpy seed."""
    rng = np.random.default_rng(seed)
    D, F, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in**-0.5).astype(np.float32)

    def norm(shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "embed": dense((V, D), D),
        "layers": {
            "attn_norm": norm((L, D)),
            "wq": dense((L, D, cfg.q_dim), D),
            "wk": dense((L, D, cfg.kv_dim), D),
            "wv": dense((L, D, cfg.kv_dim), D),
            "wo": dense((L, cfg.q_dim, D), cfg.q_dim),
            "mlp_norm": norm((L, D)),
            "w_gate": dense((L, D, F), D),
            "w_up": dense((L, D, F), D),
            "w_down": dense((L, F, D), F),
        },
        "final_norm": norm((D,)),
        "lm_head": dense((D, V), D),
    }


def np_lora(cfg, seed=1, rank=4, targets=("wq", "wk", "wv", "wo", "w_down")):
    """An adapter with b != 0, so the delta is live."""
    rng = np.random.default_rng(seed)
    dims = {"wq": (cfg.hidden_size, cfg.q_dim), "wk": (cfg.hidden_size, cfg.kv_dim),
            "wv": (cfg.hidden_size, cfg.kv_dim), "wo": (cfg.q_dim, cfg.hidden_size),
            "w_down": (cfg.intermediate_size, cfg.hidden_size)}
    L = cfg.num_layers
    return {"layers": {
        n: {"a": (rng.standard_normal((L, dims[n][0], rank)) * 0.1).astype(np.float32),
            "b": (rng.standard_normal((L, rank, dims[n][1])) * 0.1).astype(np.float32),
            "scale": np.full((L,), 2.0, np.float32)}
        for n in targets}}


def trees(kind, seed=0):
    """(jax tree, torch tree) of one base: float32, int8 or int4."""
    base = jax.tree.map(jnp.asarray, np_params(JCFG, seed))
    if kind != "f32":
        base = jax_quant.quantize_params(base, bits=8 if kind == "int8" else 4)
    return base, convert.from_numpy_tree(jax.tree.map(np.asarray, base), device="cpu")


def _tokens(B=2, S=6, seed=5):
    return np.random.default_rng(seed).integers(1, JCFG.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
@pytest.mark.parametrize("with_lora", [False, True], ids=["base", "lora"])
def test_forward_logits_match_jax(kind, with_lora):
    jp, tp = trees(kind)
    jl = tl = None
    if with_lora:
        nl = np_lora(JCFG)
        jl, tl = jax.tree.map(jnp.asarray, nl), convert.from_numpy_tree(nl, device="cpu")
    toks = _tokens()
    want = np.asarray(jax_llama.forward(jp, jnp.asarray(toks), JCFG, lora=jl))
    got = llama.forward(tp, torch.from_numpy(toks).long(), TCFG, lora=tl)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
@pytest.mark.parametrize("with_lora", [False, True], ids=["base", "lora"])
def test_forward_with_cache_prefill_and_decode_match_jax(kind, with_lora):
    """Ragged prefill (kv_mask), then 3 decode steps at the physical
    slot S + i with rope at the logical position len + i."""
    jp, tp = trees(kind, seed=1)
    jl = tl = None
    if with_lora:
        nl = np_lora(JCFG, seed=2)
        jl, tl = jax.tree.map(jnp.asarray, nl), convert.from_numpy_tree(nl, device="cpu")
    B, S, steps = 2, 6, 3
    S_max = S + steps
    toks = _tokens(B, S, seed=6)
    lens = np.array([4, 6], np.int64)
    shape = (JCFG.num_layers, B, S_max, JCFG.num_kv_heads, JCFG.head_dim)
    jcache = {"k": jnp.zeros(shape, jnp.float32), "v": jnp.zeros(shape, jnp.float32)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    slots = np.arange(S_max)[None, :]
    kv_mask = slots < lens[:, None]
    pos = np.broadcast_to(np.arange(S), (B, S))

    jlog, jcache = jax_llama.forward_with_cache(
        jp, jnp.asarray(toks), JCFG, jcache, jnp.int32(0),
        positions=jnp.asarray(pos), kv_mask=jnp.asarray(kv_mask), lora=jl,
    )
    tlog, tcache = llama.forward_with_cache(
        tp, torch.from_numpy(toks).long(), TCFG, tcache, 0,
        positions=torch.from_numpy(pos.copy()), kv_mask=torch.from_numpy(kv_mask), lora=tl,
    )
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)

    rng = np.random.default_rng(7)
    for i in range(steps):
        tok = rng.integers(1, JCFG.vocab_size, (B, 1)).astype(np.int32)
        kv_mask = kv_mask | (slots == S + i)
        pos = (lens + i)[:, None]
        jlog, jcache = jax_llama.forward_with_cache(
            jp, jnp.asarray(tok), JCFG, jcache, jnp.int32(S + i),
            positions=jnp.asarray(pos), kv_mask=jnp.asarray(kv_mask), lora=jl,
        )
        tlog, tcache = llama.forward_with_cache(
            tp, torch.from_numpy(tok).long(), TCFG, tcache, S + i,
            positions=torch.from_numpy(pos), kv_mask=torch.from_numpy(kv_mask), lora=tl,
        )
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **TOL)


@pytest.mark.parametrize("S", [1, 2])
def test_cache_write_and_attend_per_row_index_matches_jax(S):
    """The ``[B]`` cache-index layout (each row at its own depth)."""
    rng = np.random.default_rng(8)
    B, S_max, Hq, Hkv, hd = 3, 8, 4, 2, 8
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    kk = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    vv = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    ck = rng.standard_normal((B, S_max, Hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((B, S_max, Hkv, hd)).astype(np.float32)
    idx = np.array([2, 5, 7], np.int32)
    mask = np.arange(S_max)[None, :] <= idx[:, None] + S - 1
    jattn, jc = jax_llama.cache_write_and_attend(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.asarray(idx), jnp.asarray(mask),
    )
    tattn, tc = llama.cache_write_and_attend(
        torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(vv),
        {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())},
        torch.from_numpy(idx).long(), torch.from_numpy(mask),
    )
    np.testing.assert_allclose(tattn.numpy(), np.asarray(jattn), **TOL)
    for k in ("k", "v"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
def test_merge_lora_matches_jax_and_the_adapter_path(kind):
    """``merge_lora`` folds the adapter the way JAX does, and the merged
    forward equals the adapter forward (float bases; a quantized base is
    merged after dequantizing)."""
    jp, tp = trees(kind, seed=3)
    if kind != "f32":
        jp = jax_quant.dequantize_params(jp, jnp.float32)
        tp = convert.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    nl = np_lora(JCFG, seed=4)
    jl, tl = jax.tree.map(jnp.asarray, nl), convert.from_numpy_tree(nl, device="cpu")
    jm = jax_lora.merge_lora(jp, jl)
    tm = lora.merge_lora(tp, tl)
    for g, w in zip(jax.tree.leaves(convert.to_numpy_tree(tm)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jm))):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    toks = torch.from_numpy(_tokens(seed=9)).long()
    merged = llama.forward(tm, toks, TCFG)
    adapter = llama.forward(tp, toks, TCFG, lora=tl)
    np.testing.assert_allclose(merged.numpy(), adapter.numpy(), **TOL)
    assert set(tp["layers"]) == set(tm["layers"])  # the input tree is not mutated
    assert tp["layers"]["wq"] is not tm["layers"]["wq"]


def test_config_presets_and_flop_accounting_match_jax():
    for name in ("tiny", "llama3_1b", "llama3_8b"):
        jc = getattr(jax_llama.LlamaConfig, name)()
        tc = getattr(llama.LlamaConfig, name)()
        jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc) if f.name != "dtype"}
        tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc) if f.name != "dtype"}
        assert jf == tf
        assert tc.num_params() == jc.num_params()
        assert tc.flops_per_token(4096) == jc.flops_per_token(4096)
        assert tc.attn_flops_per_token(1024) == jc.attn_flops_per_token(1024)
    assert llama.LlamaConfig().dtype == torch.bfloat16


def test_later_slices_raise_not_implemented():
    _, tp = trees("f32")
    toks = torch.ones((1, 2), dtype=torch.long)
    assert llama.resolved_attention_impl(TCFG) == "dense"
    assert llama.resolved_attention_impl(TCFG, "cpu") == "dense"
    assert llama.resolved_attention_impl(TCFG, "cuda") == "flash"
    # flash is ported (slice 2): on CPU tensors it runs the plain versions
    flash = dataclasses.replace(TCFG, attention_impl="flash")
    np.testing.assert_allclose(
        llama.forward(tp, toks, flash).numpy(), llama.forward(tp, toks, TCFG).numpy(), **TOL
    )
    # ring is ported (slice 8): without a mesh it is the single-device
    # attention, as JAX's ring_attention is without a context axis
    ring = dataclasses.replace(TCFG, attention_impl="ring")
    np.testing.assert_allclose(
        llama.forward(tp, toks, ring).numpy(), llama.forward(tp, toks, TCFG).numpy(), **TOL
    )
    # remat "attn_offload" is ported (tests/test_torch_remat_offload.py):
    # the forward's values are those of every other policy
    np.testing.assert_array_equal(
        llama.forward(tp, toks, dataclasses.replace(
            TCFG, remat=True, remat_policy="attn_offload")).detach().numpy(),
        llama.forward(tp, toks, dataclasses.replace(TCFG, remat=True, remat_policy="attn"))
        .detach().numpy(),
    )
    # W8A8 decode is ported (tests/test_torch_w8a8.py): the training
    # forward ignores it, as JAX's does
    np.testing.assert_array_equal(
        llama.forward(tp, toks, dataclasses.replace(TCFG, w8a8_decode=True)).numpy(),
        llama.forward(tp, toks, TCFG).numpy(),
    )
    with pytest.raises(ValueError):
        llama.resolved_attention_impl(dataclasses.replace(TCFG, attention_impl="nope"))


def test_init_params_layout_and_device_default():
    tp = llama.init_params(0, TCFG, device="cpu")
    jshapes = jax.eval_shape(lambda k: jax_llama.init_params(k, JCFG), jax.random.key(0))
    got = jax.tree.map(lambda t: tuple(t.shape), tp)
    want = jax.tree.map(lambda s: tuple(s.shape), jshapes)
    assert got == want
    again = llama.init_params(0, TCFG, device="cpu")
    assert torch.equal(tp["layers"]["wq"], again["layers"]["wq"])
    cache = init_cache(TCFG, 2, 8, device="cpu")
    assert cache["k"].shape == (TCFG.num_layers, 2, 8, TCFG.num_kv_heads, TCFG.head_dim)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            llama.init_params(0, TCFG)  # default device is the card
        with pytest.raises(RuntimeError):
            init_cache(TCFG, 2, 8)  # so is the cache's
