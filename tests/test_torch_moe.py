"""The port's MoE model (``models/moe.py``) against the JAX package's, on
the CPU, ``mixtral_tiny`` in float32.

Routing is discontinuous: top-k of two frameworks' f32 softmax agrees
only where the top-k margin exceeds their rounding. So the routing
functions are held against JAX on identical logits (integers bit-exact,
weights to 1e-6), and every test that routes its own activations asserts
that the smallest top-2 margin among its tokens (the gap between the 1st
and 2nd and between the 2nd and 3rd router logits, i.e. the log-ratio of
their probabilities; f32 rounding moves it by ~1e-7) exceeds 1e-4, so a
flipped expert choice cannot pass for a kernel or layout error.

Tolerances, float32: outputs and logits rtol 1e-5 of max |JAX| (sums in
another order); the aux loss 1e-6; gradients under the remat policies
1e-5 relative to the no-remat ones (the same arithmetic, recomputed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import moe as jmoe
from odh_kubeflow_tpu.models.llama import LlamaConfig as JLlamaConfig
from odh_kubeflow_tpu.models.quant import quantize_params as jquantize_params
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama, lora, moe
from odh_kubeflow_tpu_torch.models.quant import streaming_quantized_init
from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm
from odh_kubeflow_tpu_torch.train import trainer as ttrainer

JCFG = jmoe.MoeConfig.mixtral_tiny(base=JLlamaConfig.tiny(dtype=jnp.float32))
TCFG = moe.MoeConfig.mixtral_tiny(base=llama.LlamaConfig.tiny(dtype=torch.float32))
B, S = 2, 512  # B·S·k = 2048: the grouped path engages
MARGIN = 1e-4
# router weights scaled so the logits spread (std ~8 on unit activations):
# the top-2 margins of 1024 tokens then clear MARGIN
ROUTER_GAIN = 8.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(int8=False, seed=0):
    jp = jmoe.init_params(jax.random.key(seed), JCFG)
    jp["layers"]["router"] = jp["layers"]["router"] * ROUTER_GAIN
    if int8:
        jp = jquantize_params(jp)
    return jp, convert.from_numpy_tree(_np(jp), device="cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _margin(logits: torch.Tensor, k: int = 2) -> float:
    z = logits.detach().float().sort(-1, descending=True).values
    return float((z[..., :k] - z[..., 1 : k + 1]).min())


@pytest.fixture
def margins(monkeypatch):
    """Records the top-k margin of every routing the port runs."""
    seen = []
    stats = moe._routing_stats

    def spy(logits, cfg, token_mask=None):
        live = logits if token_mask is None else logits[token_mask]
        seen.append(_margin(live, cfg.num_experts_per_tok))
        return stats(logits, cfg, token_mask)

    monkeypatch.setattr(moe, "_routing_stats", spy)
    return seen


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# routing on identical logits


def _mask(masked):
    if not masked:
        return None
    return np.arange(S)[None, :] < np.array([[S], [S // 3]])


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_route_sorted_matches_jax_bit_exact(masked):
    logits = np.random.default_rng(1).standard_normal((B, S, JCFG.num_experts)).astype(np.float32)
    m = _mask(masked)
    jsrc, jw, joffs, jinv, jaux = jmoe.route_sorted(jnp.asarray(logits), JCFG,
                                                    None if m is None else jnp.asarray(m))
    src, w, offs, inv, aux = moe.route_sorted(torch.from_numpy(logits), TCFG,
                                              None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(offs.numpy(), np.asarray(joffs))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    M = src.shape[0]
    assert M == 17 * 512 // 4 * 0 + (-(-(B * S * 2 + 4 * 128) // 512) * 512)
    assert offs[-1] == M and (offs[:-1] % gm.ALIGN == 0).all()
    # dropless: every live assignment keeps its weight
    live = B * S if m is None else int(m.sum())
    np.testing.assert_allclose(float(w.sum()), live, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_route_tables_and_tokens_match_jax_bit_exact(masked):
    logits = np.random.default_rng(2).standard_normal((B, 64, JCFG.num_experts)).astype(np.float32)
    m = None if not masked else np.arange(64)[None, :] < np.array([[64], [20]])
    jm, tm = (None, None) if m is None else (jnp.asarray(m), torch.from_numpy(m))
    jidx, jw, jaux = jmoe.route_tables(jnp.asarray(logits), JCFG, jm)
    idx, w, aux = moe.route_tables(torch.from_numpy(logits), TCFG, tm)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    jd, jc, jaux2 = jmoe.route_tokens(jnp.asarray(logits), JCFG, jm)
    d, c, aux2 = moe.route_tokens(torch.from_numpy(logits), TCFG, tm)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    for a, ja in ((aux, jaux), (aux2, jaux2)):
        np.testing.assert_allclose(float(a), float(ja), atol=1e-6)


def test_route_sorted_weights_stay_differentiable():
    logits = torch.randn((B, S, 4), generator=torch.Generator().manual_seed(3), requires_grad=True)
    _, w, _, _, aux = moe.route_sorted(logits, TCFG)
    (g,) = torch.autograd.grad((w * torch.arange(w.shape[0])).sum() + aux, logits)
    assert g.abs().sum() > 0


# ---------------------------------------------------------------------------
# the MoE MLP, each dispatch


@pytest.mark.parametrize(
    "dispatch,int8,masked",
    [
        ("einsum", False, False),
        ("ragged", False, False),
        ("ragged", False, True),
        ("grouped", False, False),
        ("grouped", True, False),
        ("grouped", True, True),
    ],
)
def test_moe_mlp_matches_jax(margins, dispatch, int8, masked):
    jp, tp = _params(int8)
    jl, tl = _layer0(jp["layers"]), llama._layer_slice(tp["layers"], 0)
    # as the decoder layer hands them over: int8 banks stay quantized on
    # the grouped path, every other leaf is float
    keep = moe.BANKS if dispatch == "grouped" else ()
    jl = {k: (jnp.asarray(v["q"], jnp.float32) * v["scale"]
              if isinstance(v, dict) and k not in keep else v) for k, v in jl.items()}
    tl = {**llama._maybe_dequant({k: v for k, v in tl.items() if k not in keep}, torch.float32),
          **{k: tl[k] for k in keep}}
    x = np.random.default_rng(4).standard_normal((B, S, 64)).astype(np.float32)
    m = _mask(masked)
    jcfg = dataclasses.replace(JCFG, dispatch=dispatch)
    tcfg = dataclasses.replace(TCFG, dispatch=dispatch)
    jm = None if m is None else jnp.asarray(m)
    ct = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(a, layer):
        out, aux = jmoe.moe_mlp(a, layer, jcfg, jm)
        return jnp.sum(out * ct), (out, aux)

    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x), jl)
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_mlp(tx, tl, tcfg, None if m is None else torch.from_numpy(m))
    assert min(margins) > MARGIN
    if m is not None:  # masked tokens' outputs are the path's own business
        jout = jnp.asarray(jout) * m[..., None]
        out = out * torch.from_numpy(m)[..., None]
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    # dx through the routing weights and the experts
    (tg,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), tx)
    _close(tg, jg, 1e-4)


def test_grouped_takes_the_ragged_path_for_tiny_batches(margins):
    jp, tp = _params(int8=True)
    jl, tl = _layer0(jp["layers"]), llama._layer_slice(tp["layers"], 0)
    x = np.random.default_rng(6).standard_normal((1, 4, 64)).astype(np.float32)
    cfg_j = dataclasses.replace(JCFG, dispatch="grouped")
    before = gm.swiglu_fwd_launches
    jout, _ = jmoe.moe_mlp(jnp.asarray(x), jl, cfg_j)
    out, _ = moe.moe_mlp(torch.from_numpy(x), tl, dataclasses.replace(TCFG, dispatch="grouped"))
    _close(out, jout)
    assert gm.swiglu_fwd_launches == before


# ---------------------------------------------------------------------------
# the whole forward


@pytest.mark.parametrize("dispatch,int8", [("grouped", True), ("grouped", False),
                                           ("einsum", False)])
def test_forward_logits_and_aux_match_jax(margins, dispatch, int8):
    jp, tp = _params(int8, seed=3)
    jcfg = dataclasses.replace(JCFG, dispatch=dispatch)
    tcfg = dataclasses.replace(TCFG, dispatch=dispatch)
    toks = np.random.default_rng(7).integers(0, 256, (B, S)).astype(np.int32)
    seg = np.repeat((np.arange(S) >= 200).astype(np.int32)[None] + 1, B, 0)
    seg[1, -60:] = 0  # padding
    jlog, jaux = jmoe.forward(jp, jnp.asarray(toks), jcfg, segment_ids=jnp.asarray(seg))
    tlog, taux = moe.forward(tp, torch.from_numpy(toks).long(), tcfg,
                             segment_ids=torch.from_numpy(seg))
    assert min(margins) > MARGIN
    assert tlog.shape == (B, S, 256) and tlog.dtype == torch.float32
    _close(tlog, jlog)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
    hid, haux = moe.forward(tp, torch.from_numpy(toks).long(), tcfg,
                            segment_ids=torch.from_numpy(seg), return_hidden=True)
    assert hid.shape == (B, S, 64) and float(haux) == float(taux)


def _adapter_grads(cfg, params, lp, toks, seg):
    tree = {"layers": {n: {k: t.detach().clone().requires_grad_() for k, t in ab.items()}
                       for n, ab in lp["layers"].items()}}
    leaves = [t for _, t in ttrainer._leaves(tree)]
    logits, aux = moe.forward(params, toks, cfg, lora=tree, segment_ids=seg)
    loss = ttrainer.cross_entropy_loss(logits, torch.roll(toks, -1, 1)) + aux
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize(
    "impl,policy,pin_acts,pin_layers,fused_calls",
    [
        ("dense", "none", False, None, 4),
        ("dense", "dots", False, None, 4),
        ("dense", "attn", False, None, 4),
        ("dense", "attn", True, None, 2),
        ("flash", "attn", True, None, 2),
        ("flash", "attn_mlp", True, None, 2),
        ("dense", "attn", True, 1, 3),
        ("dense", "attn", False, 1, 4),
    ],
)
def test_remat_policies_match_no_remat_and_pin_skips_the_expert_recompute(
    monkeypatch, impl, policy, pin_acts, pin_layers, fused_calls
):
    """Adapter gradients under every policy equal the no-remat ones; the
    fused SwiGLU forward runs L times under a pinned policy (the backward
    reads g and recomputes nothing of the experts), 2L otherwise, and
    L + (L - n) with ``remat_pin_layers = n`` and the pin. Port against
    port on one device: the routing is the same arithmetic both times."""
    base = llama.LlamaConfig.tiny(dtype=torch.float32, attention_impl=impl)
    cfg0 = moe.MoeConfig.mixtral_tiny(base=base, dispatch="grouped", pin_expert_acts=pin_acts)
    params = streaming_quantized_init(cfg0, 5, scale=0.1, device="cpu")
    params["layers"]["router"]["scale"] *= ROUTER_GAIN
    params = {k: (v.float() if isinstance(v, torch.Tensor) else v) for k, v in params.items()}
    params["layers"] = {k: (v.float() if isinstance(v, torch.Tensor) else v)
                        for k, v in params["layers"].items()}
    lp = lora.init_lora_params(0, base, lora.LoraConfig(rank=4), device="cpu")
    rng = np.random.default_rng(8)
    for ab in lp["layers"].values():
        ab["b"] = torch.from_numpy(rng.standard_normal(ab["b"].shape).astype(np.float32)) * 0.1
    toks = torch.from_numpy(rng.integers(0, 256, (B, S))).long()
    seg = torch.from_numpy(np.repeat((np.arange(S) >= 300).astype(np.int32)[None] + 1, B, 0))

    calls = []
    fwd = gm.swiglu_fwd_reference
    monkeypatch.setattr(gm, "swiglu_fwd_reference", lambda *a: calls.append(1) or fwd(*a))
    want = _adapter_grads(cfg0, params, lp, toks, seg)
    assert len(calls) == base.num_layers
    cfg = dataclasses.replace(cfg0, base=dataclasses.replace(
        base, remat=True, remat_policy=policy, remat_pin_layers=pin_layers))
    calls.clear()
    got = _adapter_grads(cfg, params, lp, toks, seg)
    assert len(calls) == fused_calls
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-7)


def test_config_accounting_matches_jax():
    for jc, tc in ((JCFG, TCFG), (jmoe.MoeConfig.mixtral_8x1b(), moe.MoeConfig.mixtral_8x1b())):
        assert tc.num_params() == jc.num_params()
        for s in (512, 4096):
            assert tc.flops_per_token(s) == jc.flops_per_token(s)
            assert tc.attn_flops_per_token(s) == jc.attn_flops_per_token(s)
        assert tc.capacity(512) == jc.capacity(512)
    c = moe.MoeConfig.mixtral_8x1b()
    assert (c.base.hidden_size, c.base.intermediate_size, c.base.num_layers) == (2048, 8192, 16)
    assert c.base.remat_policy == "attn" and c.base.vocab_size == 128_256


def test_param_tree_layout_matches_jax():
    jp = jmoe.init_params(jax.random.key(0), JCFG)
    tp = moe.init_params(0, TCFG, device="cpu")
    flat = lambda t: {"/".join(map(str, p)): v.shape  # noqa: E731
                      for p, v in ttrainer._leaves(t)}
    want = {"/".join(str(k.key) for k in p): v.shape
            for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {k: tuple(v) for k, v in flat(tp).items()} == {k: tuple(v) for k, v in want.items()}
    # int8 trees carry across whole: the banks' codes and [L, E, 1, N] scales
    jq = jquantize_params(jp)
    tq = convert.from_numpy_tree(_np(jq), device="cpu")
    assert tq["layers"]["moe_down"]["q"].dtype == torch.int8
    assert tuple(tq["layers"]["moe_down"]["scale"].shape) == (2, 4, 1, 64)
    sq = streaming_quantized_init(TCFG, 0, device="cpu")
    assert {k: tuple(v) for k, v in flat(sq).items()} == {
        k: tuple(v) for k, v in flat(tq).items()}


def test_later_slices_are_refused():
    """Slice 6's ``param_specs`` and an unknown dispatch raise. The
    KV-cached forward runs: a prefill and a decode step give the logits of
    the no-cache forward over the same tokens (a decode step and this
    short prefill take the drop-free ragged path, so routing is per
    token)."""
    _, tp = _params(seed=2)
    cfg = dataclasses.replace(TCFG, dispatch="grouped")
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 9))).long()
    with torch.no_grad():
        full, _ = moe.forward(tp, toks, cfg)
        cache = {k: torch.zeros((2, 2, 9, 2, 16)) for k in ("k", "v")}
        pre, cache = moe.forward_with_cache(tp, toks[:, :8], cfg, cache, 0,
                                            positions=torch.arange(8).expand(2, 8))
        step, _ = moe.forward_with_cache(tp, toks[:, 8:], cfg, cache, 8,
                                         positions=torch.full((2, 1), 8))
    _close(pre, full[:, :8])
    _close(step, full[:, 8:])
    with pytest.raises(NotImplementedError, match="multi-device parallelism"):
        moe.param_specs(TCFG)
    with pytest.raises(ValueError):
        moe.moe_mlp(torch.zeros(1, 4, 64), {}, dataclasses.replace(TCFG, dispatch="nope"))
