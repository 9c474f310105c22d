"""The port's continuous-batching engine against the JAX package, tiny
config, f32 caches, on the CPU.

Counterparts of the reference's ``tests/test_engine.py``. Every greedy
stream must equal, token for token, both JAX's ``generate`` and the
port's ``generate`` on the same trees (exact: greedy argmax over float32
logits that agree to 1e-4). JAX's references come from one batched,
right-padded ``generate`` call (a greedy decode's first n tokens are its
n-token decode), to spare XLA compiles. Sampled streams draw from the
engine's ``torch.Generator``, so they are checked for shape and range
only; the sampler's kept set is held to JAX's ``sample_logits_rowwise``.
No assertion reads a duration: batching is counted in decode steps.
Every engine stops in ``finally`` and every wait has its own timeout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import engine as jax_engine
from odh_kubeflow_tpu.models.generate import GenerateConfig as JaxGenerateConfig
from odh_kubeflow_tpu.models.generate import generate as jax_generate
from odh_kubeflow_tpu_torch.models import moe
from odh_kubeflow_tpu_torch.models.engine import DecodeEngine, sample_logits_rowwise
from odh_kubeflow_tpu_torch.models.generate import GenerateConfig, generate
from odh_kubeflow_tpu_torch.utils import prometheus
from test_torch_llama import JCFG, TCFG, trees

WAIT = 120  # seconds, every result()
N_REF = 12  # the longest greedy completion any test compares
SYSTEM = [3 + (i % 11) for i in range(16)]  # a 16-token shared prefix
PROMPTS = [
    [5, 9, 13], list(range(3, 40)), [7] * 10, [5, 6, 7], [5, 9, 13, 2],
    SYSTEM + [7, 9, 2], SYSTEM + [5, 1], list(range(3, 53)), list(range(2, 102)), [7] * 8,
] + [[2 + i, 11, 3 * i + 1] for i in range(6)]


@pytest.fixture(scope="module")
def model():
    """(torch tree, {prompt: JAX greedy tokens}) of one f32 base."""
    jp, tp = trees("f32", seed=3)
    S = max(len(p) for p in PROMPTS)
    rows = np.zeros((len(PROMPTS), S), np.int32)
    for i, p in enumerate(PROMPTS):
        rows[i, : len(p)] = p
    out = jax_generate(
        jp, jnp.asarray(rows), JCFG,
        JaxGenerateConfig(max_new_tokens=N_REF, cache_dtype=jnp.float32),
        prompt_lengths=jnp.asarray([len(p) for p in PROMPTS], jnp.int32),
    )
    toks = np.asarray(out["tokens"])
    return tp, {tuple(p): toks[i].tolist() for i, p in enumerate(PROMPTS)}


def want(model, prompt, n, eos_id=None):
    """The greedy tokens of ``prompt``: JAX's, after checking that the
    port's ``generate`` gives the same."""
    tp, jax_ref = model
    ref = jax_ref[tuple(prompt)][:n]
    if eos_id is not None and eos_id in ref:
        ref = ref[: ref.index(eos_id) + 1]
    out = generate(
        tp, torch.tensor([prompt]), TCFG,
        GenerateConfig(max_new_tokens=n, eos_id=eos_id, cache_dtype=torch.float32),
    )
    # the whole row: a token equal to pad_id counts as padding in lengths
    port = out["tokens"][0].tolist()
    if eos_id is not None and eos_id in port:
        port = port[: port.index(eos_id) + 1]
    assert port == ref, (port, ref)
    return ref


def engine(model, **kw):
    kw = {"n_slots": 2, "max_len": 256, "chunk": 4, "prompt_buckets": (16, 64),
          "cache_dtype": torch.float32, "device": "cpu",
          "metrics_registry": prometheus.Registry(), **kw}
    return DecodeEngine(model[0], TCFG, **kw)


def test_greedy_matches_generate(model):
    eng = engine(model)
    try:
        for prompt in PROMPTS[:3]:
            assert eng.submit(prompt, max_tokens=12).result(WAIT) == want(model, prompt, 12)
    finally:
        eng.stop()


def test_concurrent_streams_greedy_exact(model):
    """Six streams through four slots: each equals its solo decode (slot
    isolation: kv_mask and per-row offsets)."""
    eng = engine(model, n_slots=4, max_len=128, prompt_buckets=(16,))
    try:
        prompts = PROMPTS[-6:]
        handles = [eng.submit(p, max_tokens=10) for p in prompts]
        assert [h.result(WAIT) for h in handles] == [want(model, p, 10) for p in prompts]
    finally:
        eng.stop()


def test_mixed_sampling_params_and_eos(model):
    eng = engine(model, n_slots=4, max_len=128, prompt_buckets=(16,))
    try:
        greedy = eng.submit([5, 6, 7], max_tokens=8)
        sampled = eng.submit([5, 6, 7], max_tokens=8, temperature=1.3, top_k=20)
        nucleus = eng.submit([9, 2], max_tokens=8, temperature=0.9, top_p=0.8)
        g, s, n = greedy.result(WAIT), sampled.result(WAIT), nucleus.result(WAIT)
        assert len(g) == 8 and len(s) == 8 and len(n) == 8
        assert g == want(model, [5, 6, 7], 8)
        assert all(0 <= t < TCFG.vocab_size for t in s + n)
        # eos exact: the first greedy token as eos ends the stream there
        assert eng.submit([5, 6, 7], max_tokens=8, eos_id=g[0]).result(WAIT) == [g[0]]
        # eos inside a chunk: the stream stops at its first occurrence
        assert eng.submit([5, 6, 7], max_tokens=8, eos_id=g[5]).result(WAIT) == want(
            model, [5, 6, 7], 8, eos_id=g[5])
    finally:
        eng.stop()


def test_per_request_max_tokens(model):
    eng = engine(model, max_len=128, prompt_buckets=(16,))
    try:
        for n in (1, 3, 9):
            assert len(eng.submit([4, 5], max_tokens=n).result(WAIT)) == n
    finally:
        eng.stop()


def test_staggered_arrivals_share_decode_steps(model):
    """With overlapping arrivals the engine spends fewer decode steps than
    serial handling (max_tokens steps a request): > 1 token a step."""
    n_req, max_tok = 6, 32
    prompts = [[3 + i, 8, 2] for i in range(n_req)]
    eng = engine(model, n_slots=4, max_len=128, chunk=8, prompt_buckets=(16,))
    try:
        eng.submit(prompts[0], max_tokens=2).result(WAIT)
        eng.decode_steps = eng.tokens_emitted = 0
        handles = []
        for p in prompts:
            handles.append(eng.submit(p, max_tokens=max_tok))
        tokens = sum(len(h.result(WAIT)) for h in handles)
        steps = eng.decode_steps
    finally:
        eng.stop()
    assert tokens == n_req * max_tok
    assert steps < n_req * max_tok
    assert eng.tokens_emitted / steps > 1.0, (eng.tokens_emitted, steps)


def test_engine_serves_moe_family():
    """A MoE config decodes through the same slots: structure and
    determinism (greedy over routed experts), as the reference checks."""
    cfg = moe.MoeConfig.mixtral_tiny()
    cfg = dataclasses.replace(cfg, base=dataclasses.replace(cfg.base, dtype=torch.float32))
    params = moe.init_params(2, cfg, dtype=torch.float32, device="cpu")
    eng = DecodeEngine(params, cfg, n_slots=2, max_len=64, chunk=4, prompt_buckets=(16,),
                       cache_dtype=torch.float32, device="cpu",
                       metrics_registry=prometheus.Registry())
    try:
        a = eng.submit([5, 6, 7], max_tokens=8).result(WAIT)
        b = eng.submit([5, 6, 7], max_tokens=8).result(WAIT)
    finally:
        eng.stop()
    assert len(a) == 8 and all(0 <= t < cfg.vocab_size for t in a)
    assert a == b


def test_prefix_cache_exact_and_hits(model):
    eng = engine(model, prefix_cache_entries=2, prefix_buckets=(16,))
    try:
        p1, p2 = PROMPTS[5], PROMPTS[6]
        got1 = eng.submit(p1, max_tokens=10).result(WAIT)
        assert (eng.prefix_misses, eng.prefix_hits) == (1, 0)
        got2 = eng.submit(p2, max_tokens=10).result(WAIT)
        assert eng.prefix_hits == 1, (eng.prefix_hits, eng.prefix_misses)
        assert got1 == want(model, p1, 10)
        assert got2 == want(model, p2, 10)
    finally:
        eng.stop()


def test_greedy_fast_path_matches_sampling_program(model):
    """The greedy chunk (argmax only) and the general sampler give the same
    tokens to temperature-0 requests, chunk by chunk as the mix changes."""
    prompt = PROMPTS[4]
    results = {}
    for force_general in (True, False):
        eng = engine(model)
        if force_general:
            eng._chunk_fn = lambda variant, f=eng._chunk_fn: f(
                "sample" if variant == "greedy" else variant)
        try:
            results[force_general] = eng.submit(prompt, max_tokens=12).result(WAIT)
            sampled = eng.submit([4, 4, 4], max_tokens=8, temperature=0.9, top_k=5)
            assert len(sampled.result(WAIT)) == 8
        finally:
            eng.stop()
    assert results[True] == results[False] == want(model, prompt, 12)


def test_spec_decode_engine_greedy_exact(model):
    """Draft attached (the target itself: acceptance ~1, so the capped
    all-accepted path runs): streams stay exact, sampling is refused."""
    tp = model[0]
    spec = engine(model, draft_params=tp, draft_cfg=TCFG, spec_k=3)
    try:
        handles = [spec.submit(p, max_tokens=11) for p in PROMPTS[:3]]
        for p, h in zip(PROMPTS[:3], handles):
            assert h.result(WAIT) == want(model, p, 11)
        assert spec.spec_rounds > 0
        assert spec.tokens_emitted / spec.spec_rounds > 1.5, (
            spec.tokens_emitted, spec.spec_rounds)
        with pytest.raises(ValueError):
            spec.submit([1, 2, 3], max_tokens=4, temperature=0.8)
    finally:
        spec.stop()


def test_spec_engine_composes_with_prefix_cache(model):
    tp = model[0]
    spec = engine(model, draft_params=tp, draft_cfg=TCFG, spec_k=3,
                  prefix_cache_entries=2, prefix_buckets=(16,))
    try:
        for p in PROMPTS[5:7]:
            assert spec.submit(p, max_tokens=10).result(WAIT) == want(model, p, 10)
        assert spec.prefix_hits == 1, (spec.prefix_hits, spec.prefix_misses)
    finally:
        spec.stop()


def test_chunked_prefill_greedy_exact(model):
    eng = engine(model, prefill_chunk=16)
    try:
        prompt = PROMPTS[7]
        assert eng.submit(prompt, max_tokens=10).result(WAIT) == want(model, prompt, 10)
        # short prompts skip the part-by-part admission
        assert eng.submit(PROMPTS[0], max_tokens=8).result(WAIT) == want(model, PROMPTS[0], 8)
    finally:
        eng.stop()


def test_chunked_prefill_allows_prompts_past_buckets(model):
    eng = engine(model, prefill_chunk=32)
    try:
        prompt = PROMPTS[8]  # 100 tokens: past the largest bucket (64)
        assert eng.submit(prompt, max_tokens=8).result(WAIT) == want(model, prompt, 8)
    finally:
        eng.stop()


def test_chunked_prefill_interleaves_decode(model):
    """While a long admission runs part by part, an active stream keeps
    emitting between the parts: the order of emissions on the engine
    thread shows it."""
    eng = engine(model, max_len=512, chunk=2, prefill_chunk=16)
    try:
        a = eng.submit([7] * 8, max_tokens=40, stream=True)
        first = next(a.iter_tokens(timeout=WAIT))
        b = eng.submit(list(range(3, 63)), max_tokens=4)
        b.result(WAIT)
        rest = list(a.iter_tokens(timeout=WAIT))
        emitted_during = sum(1 for t in a.times if a.times[0] < t < b.times[0])
        # four parts (60 / 16): a chunk of two tokens after each of the three
        # interior parts at least
        assert emitted_during >= 2, (emitted_during, len(a.times))
        assert ([first] + rest)[:12] == want(model, [7] * 8, 12)
        assert len([first] + rest) == 40
    finally:
        eng.stop()


def test_ttft_itl_metrics_recorded(model):
    reg = prometheus.Registry()
    eng = engine(model, max_len=128, prompt_buckets=(16,), metrics_registry=reg)
    try:
        req = eng.submit([3, 5, 8], max_tokens=10)
        assert len(req.result(WAIT)) == 10
        assert req.ttft() > 0
        itls = req.itls()
        assert len(itls) == 9 and all(g >= 0 for g in itls)
    finally:
        eng.stop()
    assert reg.metric("serving_ttft_seconds").value() == 1
    assert reg.metric("serving_inter_token_seconds").value() == 9
    assert reg.metric("serving_batch_occupancy").value() == 0
    assert "serving_queue_depth 0" in reg.exposition()


def test_engine_refuses_a_mesh_and_a_compile_cache(model, tmp_path):
    """A mesh that is not the port's (a JAX mesh) is a ``TypeError``, as in
    ``Trainer(mesh=)`` (the engine under a port mesh:
    ``tests/test_torch_engine_mesh.py``); a compile cache directory that
    cannot be used raises (JAX's engine would go on with no cache; the
    accepted case: ``tests/test_torch_warmup.py``)."""
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        engine(model, mesh=object())
    (tmp_path / "a-file").write_text("")
    with pytest.raises(OSError):
        engine(model, compile_cache_dir=str(tmp_path / "a-file" / "cache"))
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecodeEngine(model[0], TCFG)


def test_stream_cancel_and_stop(model):
    """A cancelled stream frees its slot; after stop() a submit raises and
    a request queued behind the stop fails instead of hanging."""
    eng = engine(model, n_slots=1)
    try:
        a = eng.submit([5, 9, 13], max_tokens=200, stream=True)
        next(a.iter_tokens(timeout=WAIT))
        a.cancel()
        assert a.done.wait(WAIT)
        assert len(a.tokens) < 200
        assert eng.submit([5, 9, 13], max_tokens=4).result(WAIT) == want(model, [5, 9, 13], 4)
    finally:
        eng.stop()
    assert not eng._thread.is_alive()
    with pytest.raises(RuntimeError, match="down"):
        eng.submit([1, 2], max_tokens=2)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.7),
    dict(temperature=1.0, top_k=5),
    dict(temperature=1.0, top_p=0.6),
    dict(temperature=0.5, top_k=9, top_p=0.8),
    dict(temperature=0.0, top_k=3),
])
def test_sample_rowwise_keeps_jax_token_set(kw, monkeypatch):
    """Rows with mixed knobs: the port's kept set (finite logits before
    the draw) equals the one JAX's ``sample_logits_rowwise`` draws from,
    and temperature-0 rows take the argmax."""
    rng = np.random.default_rng(5)
    B, V = 4, 64
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    t = np.array([kw["temperature"], 0.0, 1.3, kw["temperature"]], np.float32)
    k = np.array([kw.get("top_k", 0), 0, 7, 0], np.int32)
    p = np.array([kw.get("top_p", 0.0), 0.0, 0.0, 0.9], np.float32)

    seen = {}

    def capture(key, scaled):
        seen["scaled"] = np.asarray(scaled)
        return jnp.zeros(scaled.shape[0], jnp.int32)

    monkeypatch.setattr(jax_engine.jax.random, "categorical", capture)
    jax_out = jax_engine.sample_logits_rowwise(
        jnp.asarray(logits), jax.random.key(0), jnp.asarray(t), jnp.asarray(k), jnp.asarray(p))
    from odh_kubeflow_tpu_torch.models.generate import filter_logits

    tt, tk, tq = torch.from_numpy(t), torch.from_numpy(k).long(), torch.from_numpy(p)
    kept = filter_logits(torch.from_numpy(logits), temperature=tt, top_k=tk, top_p=tq)
    np.testing.assert_array_equal(torch.isfinite(kept).numpy(), np.isfinite(seen["scaled"]))
    gen = torch.Generator().manual_seed(0)
    got = sample_logits_rowwise(torch.from_numpy(logits), gen, tt, tk, tq)
    greedy = t <= 0
    np.testing.assert_array_equal(got.numpy()[greedy], np.asarray(jax_out)[greedy])
    assert bool(torch.isfinite(kept.gather(1, got[:, None])).all())
