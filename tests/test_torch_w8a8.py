"""The port's W8A8 decode (``LlamaConfig.w8a8_decode``) against the JAX
package's, tiny config, on the CPU.

``_int8_matmul`` quantizes the activation per token, multiplies s8×s8
with exact int32 sums and rescales in float32, in both packages: the
two agree to a relative 1e-6 (the float32 rescale of equal integer
sums). Greedy decode with W8A8 is token-exact against JAX's on one int8
tree.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from odh_kubeflow_tpu.models import llama as jax_llama
from odh_kubeflow_tpu.models import quant as jax_quant
from odh_kubeflow_tpu.models.generate import GenerateConfig as JaxGenerateConfig
from odh_kubeflow_tpu.models.generate import generate as jax_generate
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama, quant
from odh_kubeflow_tpu_torch.models.generate import GenerateConfig, generate
from test_torch_llama import JCFG, TCFG, trees

W8A8_RTOL = 1e-6
PROMPTS = np.array([[5, 9, 13, 2, 0, 0], [7, 1, 8, 2, 8, 1]], np.int32)
LENGTHS = np.array([4, 6], np.int32)


def test_int8_matmul_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) * 0.1).astype(np.float32)
    jw = jax_quant.quantize_tensor(jnp.asarray(w))
    tw = convert.from_numpy_tree({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    want = np.asarray(jax_llama._int8_matmul(jnp.asarray(x), jw))
    got = llama._int8_matmul(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, want, rtol=W8A8_RTOL, atol=W8A8_RTOL * np.abs(want).max())
    # one quantization shared by two products gives each product's own result
    xq, sx = llama._quant_act(torch.from_numpy(x))
    jxq, jsx = jax_llama._quant_act(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(
        llama._int8_matmul_pre(xq, sx, tw, torch.float32).numpy(), got)


def test_w8a8_greedy_decode_token_exact_against_jax():
    jp, tp = trees("int8", seed=9)
    jcfg = dataclasses.replace(JCFG, w8a8_decode=True)
    tcfg = dataclasses.replace(TCFG, w8a8_decode=True)
    out = jax_generate(jp, jnp.asarray(PROMPTS), jcfg,
                       JaxGenerateConfig(max_new_tokens=10, cache_dtype=jnp.float32),
                       prompt_lengths=jnp.asarray(LENGTHS))
    got = generate(tp, torch.from_numpy(PROMPTS).long(), tcfg,
                   GenerateConfig(max_new_tokens=10, cache_dtype=torch.float32),
                   prompt_lengths=torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(out["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(out["lengths"]))


def test_w8a8_decode_matches_dequant_path():
    """Counterpart of the reference's W8A8 check: the int8 product tracks
    the float one, and greedy decode agrees with the dequant path."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 96)) * 0.1).astype(np.float32))
    ref = x @ w
    err = float((llama._int8_matmul(x, quant.quantize_tensor(w)) - ref).abs().max()
                / ref.abs().max())
    assert err < 0.05, err

    params = quant.quantize_params(llama.init_params(0, TCFG, device="cpu"))
    prompt = torch.tensor([[5, 9, 13, 2]])
    g = GenerateConfig(max_new_tokens=10)
    t1 = generate(params, prompt, TCFG, g)["tokens"][0]
    t2 = generate(params, prompt, dataclasses.replace(TCFG, w8a8_decode=True), g)["tokens"][0]
    assert float((t1 == t2).float().mean()) >= 0.8, (t1.tolist(), t2.tolist())
    # the training forward ignores the flag (no cache: nothing stays int8)
    torch.testing.assert_close(
        llama.forward(params, prompt, dataclasses.replace(TCFG, w8a8_decode=True)),
        llama.forward(params, prompt, TCFG), rtol=0, atol=0)
