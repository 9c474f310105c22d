"""The port's trainer against the JAX package's, tiny config, float32.

Each parity test builds the JAX ``Trainer`` on a one-device CPU mesh,
carries its parameters and adapters into the port's ``Trainer`` with
``convert.from_numpy_tree`` and runs the same numpy batch through both
for three steps. Tolerance rtol 1e-4 (atol 1e-5 on parameters) on the
loss, the gradient norm and every trainable leaf after each step: the
sums run in another order, and Adam divides by the root of the second
moment, which amplifies that where a gradient is tiny.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from odh_kubeflow_tpu.models import LlamaConfig as JLlamaConfig
from odh_kubeflow_tpu.models import LoraConfig as JLoraConfig
from odh_kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from odh_kubeflow_tpu.train import TrainConfig as JTrainConfig
from odh_kubeflow_tpu.train import Trainer as JTrainer
from odh_kubeflow_tpu.train import trainer as jtrainer
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama, lora
from odh_kubeflow_tpu_torch.ops import flash_attention as fa
from odh_kubeflow_tpu_torch.train import CheckpointManager, TrainConfig, Trainer
from odh_kubeflow_tpu_torch.train import trainer as ttrainer
from odh_kubeflow_tpu_torch.utils import prometheus
from odh_kubeflow_tpu_torch.utils.device import peak_flops_per_device

TC = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
JCFG = JLlamaConfig.tiny(dtype=jnp.float32)
TCFG = llama.LlamaConfig.tiny(dtype=torch.float32)


def _batch(B=2, S=16, seed=3, vocab=256):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(quantize_base=False, with_lora=True, jcfg=JCFG, tcfg=TCFG):
    jt = JTrainer(
        jcfg, JTrainConfig(**TC), JLoraConfig(rank=4) if with_lora else None,
        mesh=build_mesh(MeshConfig(), jax.devices()[:1]), quantize_base=quantize_base,
    )
    tt = Trainer(
        tcfg, TrainConfig(**TC), lora.LoraConfig(rank=4) if with_lora else None,
        quantize_base=quantize_base, device="cpu", metrics_registry=prometheus.Registry(),
    )
    tt.params = convert.from_numpy_tree(_np(jt.params), device="cpu")
    if with_lora:
        tt.lora_params = convert.from_numpy_tree(_np(jt.lora_params), device="cpu")
    return jt, tt


def _assert_steps_match(jt, tt, steps=3, batch=None, atol=1e-5):
    batch = batch or _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(steps):
        jm = jt.train_step(jbatch)
        tm = tt.train_step(batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        jtree = jt.lora_params if jt.lora_cfg is not None else jt.params
        ttree = tt.lora_params if tt.lora_cfg is not None else tt.params
        for g, w in zip(jax.tree.leaves(convert.to_numpy_tree(ttree)), jax.tree.leaves(_np(jtree))):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol)
    assert tt.step == jt.step == steps


@pytest.mark.parametrize("quantize_base", [False, "int8", "int4"], ids=["f32", "int8", "int4"])
def test_lora_train_steps_match_jax(quantize_base):
    jt, tt = _pair(quantize_base)
    _assert_steps_match(jt, tt)
    # the adapters moved, the frozen base did not
    assert float(tt.lora_params["layers"]["wq"]["b"].detach().abs().max()) > 0
    for g, w in zip(jax.tree.leaves(convert.to_numpy_tree(tt.params)), jax.tree.leaves(_np(jt.params))):
        np.testing.assert_array_equal(g, w)


def test_full_finetune_train_steps_match_jax():
    """atol 1e-3 on the weights, a tenth of one step at lr 1e-2: among the
    ~100k weights a handful have gradients at Adam's eps scale (1e-8),
    where the normalised update depends on the last bits of the sums."""
    jt, tt = _pair(with_lora=False)
    _assert_steps_match(jt, tt, atol=1e-3)


def test_flash_train_step_matches_jax_interpret():
    """JAX's Pallas kernels in interpret mode against the port's plain
    versions, through the custom ops, on a packed batch (segment ids)."""
    jt, tt = _pair(
        jcfg=dataclasses.replace(JCFG, attention_impl="flash"),
        tcfg=dataclasses.replace(TCFG, attention_impl="flash"),
    )
    batch = _batch(S=32)
    batch["segment_ids"] = np.repeat((np.arange(32) >= 13).astype(np.int32)[None] + 1, 2, 0)
    batch["loss_mask"] = (np.arange(32) != 12).astype(np.float32)[None].repeat(2, 0)
    _assert_steps_match(jt, tt, steps=1, batch=batch)


def _adapter_grads(cfg, params, lora_params, toks, seg=None):
    tree = {"layers": {
        name: {k: t.detach().clone().requires_grad_() for k, t in ab.items()}
        for name, ab in lora_params["layers"].items()
    }}
    leaves = [t for _, t in ttrainer._leaves(tree)]
    logits = llama.forward(params, toks, cfg, lora=tree, segment_ids=seg)
    loss = ttrainer.cross_entropy_loss(logits, torch.roll(toks, -1, 1))
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize(
    "impl,policy,pin",
    [
        ("flash", "none", None),
        ("flash", "dots", None),
        ("flash", "attn", None),
        ("flash", "attn_mlp", None),
        ("flash", "attn", 1),
        ("dense", "attn", None),
        ("dense", "attn_mlp", None),
        ("dense", "dots", 1),
    ],
)
def test_remat_policies_match_no_remat_and_attn_skips_forward_recompute(
    monkeypatch, impl, policy, pin
):
    base = llama.LlamaConfig.tiny(dtype=torch.float32, attention_impl=impl)
    rng = np.random.default_rng(11)

    def init(tree):
        return {
            k: init(v) if isinstance(v, dict) else torch.from_numpy(
                (rng.standard_normal(v[0]) * (0.1 if v[1] is None else v[1] ** -0.5)
                 + (v[1] is None)).astype(np.float32))
            for k, v in tree.items()
        }

    params = init(llama.param_shapes(base))
    lp = lora.init_lora_params(0, base, lora.LoraConfig(rank=4), device="cpu")
    for ab in lp["layers"].values():
        ab["b"] = torch.from_numpy(rng.standard_normal(ab["b"].shape).astype(np.float32)) * 0.1
    toks = torch.from_numpy(rng.integers(0, base.vocab_size, (2, 24))).long()
    seg = torch.from_numpy(np.repeat((np.arange(24) >= 9).astype(np.int32)[None], 2, 0))

    calls = []
    plain = fa.flash_fwd_reference
    monkeypatch.setattr(fa, "flash_fwd_reference", lambda *a, **k: calls.append(1) or plain(*a, **k))
    want = _adapter_grads(base, params, lp, toks, seg)
    assert len(calls) == (base.num_layers if impl == "flash" else 0)
    cfg = dataclasses.replace(base, remat=True, remat_policy=policy, remat_pin_layers=pin)
    calls.clear()
    got = _adapter_grads(cfg, params, lp, toks, seg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    if impl == "flash":
        # a layer under "none" (or the unpinned prefix) re-runs the forward
        # kernel in its backward; every other policy saves its residuals
        L = base.num_layers
        recomputed = L if policy == "none" else (L - pin if pin else 0)
        assert len(calls) == L + recomputed


def test_remat_policy_errors():
    _, tt = _pair()
    toks = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError):
        llama.forward(tt.params, toks, dataclasses.replace(TCFG, remat=True, remat_policy="nope"))
    with pytest.raises(NotImplementedError):
        llama.forward(tt.params, toks, dataclasses.replace(TCFG, remat=True, remat_policy="attn_offload"))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_chunked_match_jax(masked):
    rng = np.random.default_rng(7)
    B, S, D, V = 2, 8, 16, 32
    hidden = rng.standard_normal((B, S, D)).astype(np.float32)
    head = rng.standard_normal((D, V)).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < np.array([[6], [3]])).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)

    def jdense(h):
        return jtrainer.cross_entropy_loss(jnp.einsum("bsd,dv->bsv", h, head), targets, jm, z_loss=1e-4)

    def jchunk(h):
        return jtrainer.chunked_cross_entropy(h, jnp.asarray(head), jnp.asarray(targets), jm,
                                              z_loss=1e-4, chunk=4)

    th = torch.from_numpy(hidden).requires_grad_()
    tt = torch.from_numpy(targets)
    dense = ttrainer.cross_entropy_loss(th @ torch.from_numpy(head), tt, tm, z_loss=1e-4)
    chunk = ttrainer.chunked_cross_entropy(th, torch.from_numpy(head), tt, tm, z_loss=1e-4, chunk=4)
    (gd,) = torch.autograd.grad(dense, th)
    (gc,) = torch.autograd.grad(chunk, th)
    for got, grad, jfn in ((dense, gd, jdense), (chunk, gc, jchunk)):
        want, jg = jax.value_and_grad(jfn)(jnp.asarray(hidden))
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError):
        ttrainer.chunked_cross_entropy(th, torch.from_numpy(head), tt, chunk=3)


def test_learning_rate_matches_optax_schedule():
    for cfg in (TrainConfig(), TrainConfig(**TC), TrainConfig(warmup_steps=0, total_steps=5)):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, cfg.warmup_steps,
            max(cfg.total_steps, cfg.warmup_steps + 1), cfg.learning_rate * 0.1,
        )
        for count in (0, 1, 2, 5, 9, 10, 11, 500, 2000):
            np.testing.assert_allclose(
                ttrainer.learning_rate(cfg, count), float(sched(count)), rtol=1e-6, atol=1e-12
            )


def test_long_sequence_takes_the_chunked_loss(monkeypatch):
    """S > 2048 and a multiple of 1024: the hidden states go through the
    chunked loss, the loss equals the dense one and the step trains."""
    tt = Trainer(TCFG, TrainConfig(warmup_steps=1, total_steps=4), lora.LoraConfig(rank=2),
                 device="cpu", metrics_registry=prometheus.Registry())
    batch = tt.make_fake_batch(1, 3072)
    seen = []
    chunked = ttrainer.chunked_cross_entropy
    monkeypatch.setattr(ttrainer, "chunked_cross_entropy",
                        lambda *a, **k: seen.append(1) or chunked(*a, **k))
    with torch.no_grad():
        logits = llama.forward(tt.params, batch["tokens"], TCFG, lora=tt.lora_params)
        dense = ttrainer.cross_entropy_loss(logits, batch["targets"])
    loss = tt.eval_step(batch)["loss"]
    np.testing.assert_allclose(float(loss), float(dense), rtol=1e-5)
    m = tt.train_step(batch)
    assert seen == [1, 1] and np.isfinite(float(m["loss"]))


def test_trainer_surface_eval_fake_batch_benchmark_and_metrics():
    reg = prometheus.Registry()
    tt = Trainer(TCFG, TrainConfig(warmup_steps=1, total_steps=10), lora.LoraConfig(rank=2),
                 device="cpu", metrics_registry=reg, precompile_batch=(2, 16))
    batch = tt.make_fake_batch(2, 16)
    assert batch["tokens"].shape == (2, 16)
    assert torch.equal(batch["tokens"], tt.make_fake_batch(2, 16)["tokens"])
    assert torch.equal(batch["targets"], torch.roll(batch["tokens"], -1, 1))
    before = convert.to_numpy_tree(tt.lora_params)
    eval_loss = float(tt.eval_step(batch)["loss"])
    for g, w in zip(jax.tree.leaves(convert.to_numpy_tree(tt.lora_params)), jax.tree.leaves(before)):
        np.testing.assert_array_equal(g, w)
    assert tt.step == 0
    np.testing.assert_allclose(float(tt.train_step(batch)["loss"]), eval_loss, rtol=1e-6)
    out = tt.benchmark(2, 16, steps=1, warmup=1)
    fpt = TCFG.flops_per_token(16)
    assert out["model_flops_per_step"] == (2 * fpt + TCFG.attn_flops_per_token(16)) * 32
    assert set(out) == {"step_time_s", "tokens_per_s", "model_flops_per_step", "flops_per_s",
                        "train_equiv_flops_per_s", "loss"}
    hist = reg.metric("train_step_time_seconds")
    assert hist.value() == tt.step == 3
    assert 'train_step_time_seconds_bucket{le="+Inf"} 3' in reg.exposition()
    assert peak_flops_per_device("NVIDIA H100 80GB HBM3") == 989e12
    assert peak_flops_per_device("NVIDIA A100-SXM4-80GB") == 0.0


def test_trainer_refuses_what_jax_refuses_and_later_slices():
    with pytest.raises(ValueError):
        Trainer(TCFG, quantize_base="int8", device="cpu")  # no adapters to train
    with pytest.raises(ValueError):
        Trainer(TCFG, lora_cfg=lora.LoraConfig(), quantize_base="int2", device="cpu")
    with pytest.raises(NotImplementedError, match="multi-device parallelism"):
        Trainer(TCFG, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="LlamaConfig or a MoeConfig"):
        Trainer(object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Trainer(TCFG)  # the default device is the card


def test_checkpoint_round_trips_trainable_optimizer_state_and_step(tmp_path):
    tc = TrainConfig(warmup_steps=1, total_steps=10, learning_rate=1e-2)
    tt = Trainer(TCFG, tc, lora.LoraConfig(rank=2), device="cpu",
                 metrics_registry=prometheus.Registry())
    batch = tt.make_fake_batch(2, 8)

    def snapshot():  # copies: numpy views of CPU tensors follow in-place updates
        return jax.tree.map(np.copy, convert.to_numpy_tree(
            {"t": tt.lora_params, "mu": tt.opt_state["mu"], "nu": tt.opt_state["nu"]}))

    with CheckpointManager(str(tmp_path / "ck"), max_to_keep=2) as mgr:
        for _ in range(2):
            tt.train_step(batch)
        assert tt.save_checkpoint(mgr)
        assert not tt.save_checkpoint(mgr)  # step 2 is saved already
        for _ in range(2):
            tt.train_step(batch)
            assert tt.save_checkpoint(mgr)
        at_four = snapshot()
        tt.train_step(batch)
        mgr.wait_until_finished()
        assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4  # step 2 collected
        assert tt.restore_checkpoint(mgr) == 4 == tt.step
        assert tt.opt_state["count"] == 4
        for g, w in zip(jax.tree.leaves(snapshot()), jax.tree.leaves(at_four)):
            np.testing.assert_array_equal(g, w)
        assert tt.restore_checkpoint(mgr, step=3) == 3 and tt.opt_state["count"] == 3
    mgr2 = CheckpointManager(str(tmp_path / "ck2"), save_interval_steps=2, async_save=False)
    tt.step = 2
    assert tt.save_checkpoint(mgr2)
    after_two = jax.tree.map(np.copy, convert.to_numpy_tree(tt.lora_params))
    tt.step = 3
    assert not tt.save_checkpoint(mgr2)  # off the interval
    assert tt.save_checkpoint(mgr2, force=True)
    tt.train_step(batch)
    tt.restore_checkpoint(mgr2, step=2)
    for g, w in zip(jax.tree.leaves(convert.to_numpy_tree(tt.lora_params)), jax.tree.leaves(after_two)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tt._checkpoint_state())
