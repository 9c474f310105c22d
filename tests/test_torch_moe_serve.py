"""The port's MoE serving path (``models/moe.py`` ``forward_with_cache``,
``models/generate.py``, ``models/serve.py``) against the JAX package's,
``mixtral_tiny`` in float32 on the CPU, with the same numpy trees carried
into both packages by ``convert.py``.

Tolerance: logits to 1e-4 of max |JAX| over a prefill of B 2 × S 512
(B·S·k = 2048: the grouped path, JAX's Pallas kernels in interpret mode)
and three decode steps (the ragged path): sums run in another order,
through two layers and an f32 KV cache. Routing is discontinuous, so the
smallest top-2 router margin of the live tokens of every routing is
asserted above 1e-4 (``tests/test_torch_moe.py``). Greedy tokens and
completions must be identical.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import moe as jmoe
from odh_kubeflow_tpu.models.generate import GenerateConfig as JGenerateConfig
from odh_kubeflow_tpu.models.generate import generate as jgenerate
from odh_kubeflow_tpu.models.generate import init_cache as jinit_cache
from odh_kubeflow_tpu.models.lora import LoraConfig as JLoraConfig
from odh_kubeflow_tpu.models.lora import init_lora_params as jinit_lora
from odh_kubeflow_tpu.models.serve import CompletionService as JCompletionService
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama, lora, moe, quant, serve
from odh_kubeflow_tpu_torch.models.generate import GenerateConfig, generate, init_cache
from odh_kubeflow_tpu_torch.models.serve import CompletionService
from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm
from odh_kubeflow_tpu_torch.train import CheckpointManager, TrainConfig, Trainer
from odh_kubeflow_tpu_torch.train import trainer as ttrainer
from odh_kubeflow_tpu_torch.utils import prometheus
from test_torch_moe import JCFG, MARGIN, TCFG, _close, _np, _params, margins  # noqa: F401

B, S, STEPS = 2, 512, 3


def _lora_trees(seed=4):
    jl = jinit_lora(jax.random.key(seed), JCFG.base, JLoraConfig(rank=4))
    rng = np.random.default_rng(seed)
    for ab in jl["layers"].values():
        ab["b"] = jnp.asarray(rng.standard_normal(ab["b"].shape).astype(np.float32) * 0.1)
    return jl, convert.from_numpy_tree(_np(jl), device="cpu")


def _torch(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if t.dtype == torch.bool else t.long()


def _run(fwd, params, cfg, cache, toks, lengths, lora_tree, arr):
    """A prefill of ``toks[:, :S]`` (rows right-padded to ``lengths``),
    then ``STEPS`` decode steps of the next tokens; the logits of each."""
    slots = np.arange(S + STEPS)[None, :]
    kv = slots < lengths[:, None]
    outs = []
    logits, cache = fwd(params, arr(toks[:, :S]), cfg, cache, 0,
                        positions=arr(np.broadcast_to(np.arange(S), (B, S))),
                        kv_mask=arr(kv), lora=lora_tree)
    outs.append(logits)
    for i in range(STEPS):
        kv = kv | (slots == S + i)
        logits, cache = fwd(params, arr(toks[:, S + i : S + i + 1]), cfg, cache, S + i,
                            positions=arr((lengths + i)[:, None]), kv_mask=arr(kv),
                            lora=lora_tree)
        outs.append(logits)
    return outs


@pytest.mark.parametrize("dispatch,case", [("grouped", "plain"), ("ragged", "plain"),
                                           ("grouped", "padded"), ("grouped", "lora"),
                                           ("grouped", "int8")])
def test_forward_with_cache_matches_jax(margins, dispatch, case):  # noqa: F811
    jp, tp = _params(int8=case == "int8", seed=3)
    jcfg = dataclasses.replace(JCFG, dispatch=dispatch)
    tcfg = dataclasses.replace(TCFG, dispatch=dispatch)
    # tokens whose smallest router margin over every case is ~1.8e-3: run
    # to run, CPU f32 sums move a layer-2 margin by up to ~8e-4
    toks = np.random.default_rng(38).integers(0, 256, (B, S + STEPS)).astype(np.int32)
    lengths = np.array([S, 300] if case == "padded" else [S, S])
    jl, tl = _lora_trees() if case == "lora" else (None, None)
    fused = gm.gmm_launches, gm.swiglu_fwd_launches

    want = _run(jmoe.forward_with_cache, jp, jcfg, jinit_cache(jcfg.base, B, S + STEPS, jnp.float32),
                toks, lengths, jl, jnp.asarray)
    cache = init_cache(tcfg.base, B, S + STEPS, torch.float32, device="cpu")
    got = _run(moe.forward_with_cache, tp, tcfg, cache, toks, lengths, tl, _torch)
    assert min(margins) > MARGIN
    assert got[0].shape == (B, S, 256) and got[1].shape == (B, 1, 256)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-4)
    # CPU tensors take the plain versions: no kernel launched
    assert (gm.gmm_launches, gm.swiglu_fwd_launches) == fused


def test_prefill_routes_only_the_valid_slots(monkeypatch):
    """Without ``token_mask`` a prefill masks the router with
    ``kv_mask[:, :S]``; a decode step routes its one token unmasked."""
    _, tp = _params(seed=3)
    cfg = dataclasses.replace(TCFG, dispatch="grouped")
    seen = []
    stats = moe._routing_stats
    monkeypatch.setattr(moe, "_routing_stats",
                        lambda lg, c, token_mask=None: seen.append(token_mask) or stats(lg, c,
                                                                                        token_mask))
    toks = np.random.default_rng(2).integers(0, 256, (B, S + 1)).astype(np.int32)
    lengths = np.array([S, 200])
    cache = init_cache(cfg.base, B, S + 1, torch.float32, device="cpu")
    kv = torch.from_numpy(np.arange(S + 1)[None, :] < lengths[:, None])
    moe.forward_with_cache(tp, torch.from_numpy(toks[:, :S]).long(), cfg, cache, 0,
                           positions=torch.arange(S).expand(B, S), kv_mask=kv)
    assert len(seen) == cfg.base.num_layers
    for m in seen:
        assert torch.equal(m, kv[:, :S])
    seen.clear()
    moe.forward_with_cache(tp, torch.from_numpy(toks[:, S:]).long(), cfg, cache, S,
                           positions=torch.from_numpy(lengths[:, None]), kv_mask=kv)
    assert seen == [None] * cfg.base.num_layers


PROMPTS = np.array([[11, 12, 13, 0, 0, 0, 0, 0],
                    [21, 22, 23, 24, 25, 26, 27, 28],
                    [31, 32, 33, 34, 35, 0, 0, 0]], np.int32)
LENGTHS = np.array([3, 8, 5], np.int32)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_greedy_generate_matches_jax(margins, int8):  # noqa: F811
    jp, tp = _params(int8=int8, seed=5)
    jcfg = dataclasses.replace(JCFG, dispatch="grouped")
    tcfg = dataclasses.replace(TCFG, dispatch="grouped")
    want = jgenerate(jp, jnp.asarray(PROMPTS), jcfg, JGenerateConfig(max_new_tokens=6),
                     prompt_lengths=jnp.asarray(LENGTHS))
    got = generate(tp, torch.from_numpy(PROMPTS).long(), tcfg, GenerateConfig(max_new_tokens=6),
                   prompt_lengths=torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    assert min(margins) > MARGIN


def test_completion_service_over_http_matches_jax(margins):  # noqa: F811
    jp, tp = _params(seed=6)
    buckets = dict(prompt_buckets=(8, 16), batch_buckets=(1, 2, 4))
    jsvc = JCompletionService(jp, JCFG, **buckets)
    tsvc = CompletionService(tp, TCFG, device="cpu", **buckets)
    httpd = serve.serve(tsvc, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for prompts, n in (([[5, 6, 7, 8]], 5), ([[1, 2, 3], list(range(1, 13))], 4)):
            req = urllib.request.Request(
                base + "/v1/completions",
                data=json.dumps({"prompt": prompts, "max_tokens": n}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
                assert json.loads(r.read()) == jsvc.complete(prompts, max_tokens=n)
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert min(margins) > MARGIN


def test_build_service_serves_a_moe_config_on_cpu():
    svc, args = serve.build_service(["--config", "mixtral_tiny", "--device", "cpu"])
    assert isinstance(svc.cfg, moe.MoeConfig) and svc.cfg.dispatch == "ragged"
    assert svc.params["layers"]["moe_gate"].dtype == torch.bfloat16
    out = svc.complete([[1, 2, 3]], max_tokens=3)
    assert len(out["completions"][0]) == 3 and out["usage"]["padded_shape"] == [1, 64]
    svc8, _ = serve.build_service(["--config", "mixtral_tiny", "--int8", "--device", "cpu"])
    assert svc8.params["layers"]["moe_down"]["q"].dtype == torch.int8
    assert len(svc8.complete([[4, 5]], max_tokens=2)["completions"][0]) == 2
    with pytest.raises(ValueError):
        serve.build_service(["--config", "mixtral_tiny", "--int4", "--device", "cpu"])


@pytest.mark.parametrize("config", ["tiny", "mixtral_tiny"])
def test_build_service_restores_and_merges_a_checkpoint(tmp_path, config):
    """Train two steps, save, then ``--checkpoint``: the served weights are
    ``merge_lora(trainer.params, trainer.lora_params)`` exactly."""
    cfg = (moe.MoeConfig.mixtral_tiny() if config.startswith("mixtral")
           else llama.LlamaConfig.tiny(dtype=torch.bfloat16))
    tt = Trainer(cfg, TrainConfig(warmup_steps=1, total_steps=4, learning_rate=1e-2),
                 lora.LoraConfig(rank=2), seed=7, device="cpu",
                 metrics_registry=prometheus.Registry())
    for _ in range(2):  # the warm-up's first step has learning rate 0
        tt.train_step(tt.make_fake_batch(2, 16))
    with CheckpointManager(str(tmp_path / "ck")) as mgr:
        assert tt.save_checkpoint(mgr, force=True)
    assert float(tt.lora_params["layers"]["wq"]["b"].detach().abs().max()) > 0
    svc, _ = serve.build_service(["--config", config, "--checkpoint", str(tmp_path / "ck"),
                                  "--lora-rank", "2", "--seed", "7", "--device", "cpu"])
    want = lora.merge_lora(tt.params, tt.lora_params)
    flat = lambda t: {"/".join(p): v for p, v in ttrainer._leaves(t)}  # noqa: E731
    got, exp = flat(svc.params), flat(want)
    assert got.keys() == exp.keys()
    for k in exp:
        assert torch.equal(got[k], exp[k]), k
    assert not torch.equal(got["layers/wq"], flat(tt.params)["layers/wq"])
    assert len(svc.complete([[1, 2, 3]], max_tokens=2)["completions"][0]) == 2
    with pytest.raises(FileNotFoundError):
        serve.build_service(["--config", config, "--checkpoint", str(tmp_path / "none"),
                             "--lora-rank", "2", "--device", "cpu"])


def test_quantized_moe_tree_carries_across():
    """An int8 MoE tree from JAX and the port's own quantizer agree leaf
    for leaf (codes and scales), so either serves the other's weights."""
    jp, tp = _params(int8=False, seed=9)
    tq = quant.quantize_params(tp)
    _, jq_t = _params(int8=True, seed=9)
    for (p, a), (q, b) in zip(ttrainer._leaves(tq), ttrainer._leaves(jq_t)):
        assert p == q
        assert torch.equal(a, b), p
