"""The port's speculative decoding against the JAX package's, tiny
configs, f32, on the CPU.

Counterparts of the reference's ``tests/test_spec_decode.py``. The same
numpy trees (a 2-layer target, a 1-layer draft) go through JAX's
``speculative_generate`` and the port's; tokens, lengths, accepted
drafts and rounds must be exactly equal (greedy argmax over float32
logits that agree to 1e-4), and the tokens must equal the target
decoding alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import llama as jax_llama
from odh_kubeflow_tpu.models.serve import CompletionService as JaxCompletionService
from odh_kubeflow_tpu.models.spec_decode import SpecDecodeConfig as JaxSpecDecodeConfig
from odh_kubeflow_tpu.models.spec_decode import speculative_generate as jax_speculative
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama
from odh_kubeflow_tpu_torch.models.generate import GenerateConfig, generate
from odh_kubeflow_tpu_torch.models.serve import CompletionService
from odh_kubeflow_tpu_torch.models.spec_decode import SpecDecodeConfig, speculative_generate
from test_torch_llama import JCFG, TCFG, np_params

JDRAFT = jax_llama.LlamaConfig.tiny(dtype=jnp.float32, num_layers=1)
TDRAFT = llama.LlamaConfig.tiny(dtype=torch.float32, num_layers=1)
PROMPT = [3, 1, 4, 1, 5]


@pytest.fixture(scope="module")
def models():
    """{"jax": (target, draft), "torch": (target, draft)} from numpy seeds."""
    trees = np_params(JCFG, seed=0), np_params(JDRAFT, seed=1)
    return {
        "jax": tuple(jax.tree.map(jnp.asarray, t) for t in trees),
        "torch": tuple(convert.from_numpy_tree(t, device="cpu") for t in trees),
    }


def both(models, prompt, k, n, *, draft="draft", eos_id=None, lengths=None):
    """(JAX's result, the port's) with numpy leaves, f32 caches."""
    jt, jd = models["jax"]
    tt, td = models["torch"]
    jdraft, jdcfg = (jt, JCFG) if draft == "target" else (jd, JDRAFT)
    tdraft, tdcfg = (tt, TCFG) if draft == "target" else (td, TDRAFT)
    j = jax_speculative(
        jt, JCFG, jdraft, jdcfg, jnp.asarray([prompt], jnp.int32),
        JaxSpecDecodeConfig(max_new_tokens=n, num_draft_tokens=k, eos_id=eos_id,
                            cache_dtype=jnp.float32),
        prompt_lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32),
    )
    t = speculative_generate(
        tt, TCFG, tdraft, tdcfg, torch.tensor([prompt]),
        SpecDecodeConfig(max_new_tokens=n, num_draft_tokens=k, eos_id=eos_id,
                         cache_dtype=torch.float32),
        prompt_lengths=None if lengths is None else torch.tensor(lengths),
    )
    jr = {key: np.asarray(j[key]) for key in ("tokens", "lengths", "accepted_drafts", "rounds")}
    tr = {"tokens": t["tokens"].numpy(), "lengths": t["lengths"].numpy(),
          "accepted_drafts": np.asarray(t["accepted_drafts"]), "rounds": np.asarray(t["rounds"])}
    for key in jr:
        np.testing.assert_array_equal(tr[key], jr[key], err_msg=key)
    return tr


def target_alone(models, prompt, n):
    out = generate(models["torch"][0], torch.tensor([prompt]), TCFG,
                   GenerateConfig(max_new_tokens=n, cache_dtype=torch.float32))
    return out["tokens"].numpy()


def test_greedy_exactness_vs_target_alone(models):
    N = 24
    want = target_alone(models, PROMPT, N)
    for k in (1, 3, 4):
        got = both(models, PROMPT, k, N)
        np.testing.assert_array_equal(got["tokens"], want, err_msg=f"k={k}")
        assert int(got["lengths"][0]) == N
        assert int(got["rounds"]) <= N


def test_perfect_draft_accepts_everything(models):
    N, k = 25, 4
    got = both(models, [7, 2, 9], k, N, draft="target")
    rounds, accepted = int(got["rounds"]), int(got["accepted_drafts"])
    assert accepted == rounds * k
    assert rounds == -(-(N - 1) // (k + 1))
    np.testing.assert_array_equal(got["tokens"], target_alone(models, [7, 2, 9], N))


def test_eos_truncates(models):
    N = 24
    plain = target_alone(models, PROMPT, N)
    eos = int(plain[0, 4])  # the 5th token as eos: truncation must fire
    got = both(models, PROMPT, 3, N, eos_id=eos)
    toks, length = got["tokens"][0], int(got["lengths"][0])
    assert toks[length - 1] == eos
    assert (toks[length:] == 0).all()
    np.testing.assert_array_equal(toks[:length], plain[0, :length])


def test_guard_rails(models):
    tt, td = models["torch"]
    with pytest.raises(ValueError, match="B=2"):
        speculative_generate(tt, TCFG, td, TDRAFT, torch.ones((2, 4), dtype=torch.long))
    small = llama.LlamaConfig.tiny(vocab_size=128, dtype=torch.float32)
    with pytest.raises(ValueError, match="vocab"):
        speculative_generate(tt, TCFG, llama.init_params(2, small, device="cpu"), small,
                             torch.ones((1, 4), dtype=torch.long))


def test_bucketed_padded_prompt_matches_exact(models):
    exact = both(models, PROMPT, 3, 12)
    padded = both(models, PROMPT + [0, 0, 0], 3, 12, lengths=[5])
    np.testing.assert_array_equal(padded["tokens"], exact["tokens"])


def test_completion_service_speculative_path(models):
    """A draft-equipped service answers greedy single prompts through
    speculation, equal to JAX's draft-equipped service and to the plain
    one; batched requests take the one-shot path."""
    jt, jd = models["jax"]
    tt, td = models["torch"]
    buckets = dict(prompt_buckets=(8,), batch_buckets=(1, 2))
    jspec = JaxCompletionService(jt, JCFG, draft_params=jd, draft_cfg=JDRAFT, spec_k=3,
                                 **buckets)
    plain = CompletionService(tt, TCFG, device="cpu", **buckets)
    spec = CompletionService(tt, TCFG, draft_params=td, draft_cfg=TDRAFT, spec_k=3,
                             device="cpu", **buckets)
    got = spec.complete([PROMPT], max_tokens=10)
    assert got == jspec.complete([PROMPT], max_tokens=10)
    assert got["completions"] == plain.complete([PROMPT], max_tokens=10)["completions"]
    two = spec.complete([PROMPT, [2, 7]], max_tokens=6)["completions"]
    assert len(two) == 2 and all(len(c) == 6 for c in two)
