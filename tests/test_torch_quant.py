"""The port's quantization and int4 dequant against the JAX package's.

Tolerances: quantized codes, packed bytes and scales are bit-identical
(atol 0), from float32 and bfloat16 weights alike; the plain int4
dequant equals the JAX Pallas kernel (run in interpret mode, as
tests/test_quant.py runs it) with atol 0 in float32 and bfloat16. The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import quant as jax_quant
from odh_kubeflow_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from odh_kubeflow_tpu.ops import pallas_int4
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama, quant
from odh_kubeflow_tpu_torch.ops import int4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(shape, dtype, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return jw, tw


def _assert_tree_equal(got_torch, want_np):
    got = convert.to_numpy_tree(got_torch)
    assert set(got) == set(want_np)
    for k in want_np:
        assert got[k].shape == want_np[k].shape, k
        assert got[k].dtype == want_np[k].dtype, (k, got[k].dtype, want_np[k].dtype)
        np.testing.assert_array_equal(got[k], want_np[k], err_msg=k)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40)])
def test_quantize_tensor_int8_bit_identical(dtype, shape):
    jw, tw = _weights(shape, dtype)
    _assert_tree_equal(quant.quantize_tensor(tw), _np(jax_quant.quantize_tensor(jw)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 48), (2, 256, 40), (384, 24)])
def test_quantize_tensor4_bit_identical(dtype, shape):
    # (64, 48): one group (K not a multiple of 128); the others group 128
    jw, tw = _weights(shape, dtype, seed=1)
    _assert_tree_equal(quant.quantize_tensor4(tw), _np(jax_quant.quantize_tensor4(jw)))


def _random_packed(K, N, g, seed=2):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, size=(K // 2, N), dtype=np.uint8)  # every nibble
    scale = (rng.random((g, N)) * 0.02 + 1e-4).astype(np.float32)
    return packed, scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_reference_equals_pallas_kernel(dtype):
    K, N = 2048, 1024
    packed, scale = _random_packed(K, N, K // 128)
    orig = pallas_int4.pl.pallas_call
    with_interp = functools.partial(orig, interpret=True)
    pallas_int4.pl.pallas_call = with_interp
    try:
        want = pallas_int4.int4_dequant(
            jnp.asarray(packed), jnp.asarray(scale), dtype=getattr(jnp, dtype)
        )
    finally:
        pallas_int4.pl.pallas_call = orig
    got = int4.int4_dequant_reference(
        torch.from_numpy(packed), torch.from_numpy(scale), getattr(torch, dtype)
    )
    np.testing.assert_array_equal(
        convert.to_numpy_tree({"w": got})["w"], np.asarray(want).astype(np.float32)
    )


@pytest.mark.parametrize("shape", [(64, 32), (128, 256), (2, 64, 128)])
def test_int4_dequant_equals_jax_jnp_path(shape):
    """The tiny configs' shapes (one group: group = K) through
    ``dequantize_tensor4``, stacked leaves included."""
    jw, tw = _weights(shape, jnp.float32, seed=3)
    jt = jax_quant.quantize_tensor4(jw)
    want = np.asarray(jax_quant.dequantize_tensor4(jt, jnp.float32))
    got = quant.dequantize_tensor4(convert.from_numpy_tree(_np(jt), device="cpu"), torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int4_wrapper_on_cpu_runs_plain_version_without_launching():
    packed, scale = _random_packed(256, 48, 2)
    int4.launches = 0
    out = int4.int4_dequant(torch.from_numpy(packed), torch.from_numpy(scale))
    assert out.dtype == torch.bfloat16 and out.shape == (256, 48)
    assert int4.launches == 0
    ref = int4.int4_dequant_reference(torch.from_numpy(packed), torch.from_numpy(scale))
    assert torch.equal(out, ref)


def test_int4_wrapper_rejects_bad_operands():
    packed, scale = _random_packed(256, 48, 2)
    p, s = torch.from_numpy(packed), torch.from_numpy(scale)
    with pytest.raises(TypeError):
        int4.int4_dequant(p.to(torch.int8), s)
    with pytest.raises(TypeError):
        int4.int4_dequant(p, s.to(torch.float64))
    with pytest.raises(TypeError):
        int4.int4_dequant(p, s, torch.float16)
    with pytest.raises(ValueError):
        int4.int4_dequant(p, s[:, :40])
    with pytest.raises(ValueError):
        int4.int4_dequant(p, torch.ones((3, 48)))  # 256 rows in 3 groups
    with pytest.raises(ValueError):
        int4.int4_dequant(p[None], s)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_and_dequantize_params_match_jax(bits):
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    params = llama.init_params(0, cfg, device="cpu")
    np_params = convert.to_numpy_tree(params)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jq = jax_quant.quantize_params(jparams, bits=bits)
    tq = quant.quantize_params(params, bits=bits)
    want = _np(jq)
    got = convert.to_numpy_tree(tq)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    jd = _np(jax_quant.dequantize_params(jq, jnp.float32))
    td = convert.to_numpy_tree(quant.dequantize_params(tq, torch.float32))
    for g, w in zip(jax.tree.leaves(td), jax.tree.leaves(jd)):
        np.testing.assert_array_equal(g, w)
    jerr = jax_quant.quantization_error(jparams, jq)
    terr = quant.quantization_error(params, tq)
    assert set(jerr) == set(terr)
    for k in jerr:
        assert terr[k] == pytest.approx(jerr[k], rel=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_streaming_quantized_init_layout_and_determinism(bits):
    """Same tree, shapes and dtypes as the JAX streaming init (its
    random bits differ); one seed gives one tree; per-layer
    quantization equals quantizing the stack."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16, hidden_size=256)
    jtree = jax_quant.streaming_quantized_init(
        JaxLlamaConfig.tiny(dtype=jnp.bfloat16, hidden_size=256),
        jax.random.key(0),
        bits=bits,
    )
    a = quant.streaming_quantized_init(cfg, 5, bits=bits, device="cpu")
    b = quant.streaming_quantized_init(cfg, 5, bits=bits, device="cpu")
    c = quant.streaming_quantized_init(cfg, 6, bits=bits, device="cpu")
    got = convert.to_numpy_tree(a)
    want = _np(jtree)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        wdt = np.float32 if w.dtype.name == "bfloat16" else w.dtype
        assert g.dtype == wdt
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(convert.to_numpy_tree(b))):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(
        got["layers"]["wq"]["q4" if bits == 4 else "q"],
        convert.to_numpy_tree(c)["layers"]["wq"]["q4" if bits == 4 else "q"],
    )
    # the stacked leaf's codes equal a whole-stack quantization of the
    # same draw (wq at hidden 256 has two int4 groups per layer)
    gen = torch.Generator().manual_seed(quant._leaf_seed(5, ("layers",), "wq"))
    w = torch.randn((cfg.num_layers, 256, cfg.q_dim), generator=gen, dtype=torch.bfloat16) * 0.02
    whole = (quant.quantize_tensor if bits == 8 else quant.quantize_tensor4)(w)
    for k, v in whole.items():
        assert torch.equal(a["layers"]["wq"][k], v)


def test_convert_round_trip_keeps_names_dtypes_and_bf16():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    tree = {
        "f32": w,
        "bf16": np.asarray(jnp.asarray(w, jnp.bfloat16)),  # extension dtype
        "q": {"q4": rng.integers(0, 256, (2, 6), dtype=np.uint8),
              "scale4": rng.random((1, 6)).astype(np.float32)},
        "i8": {"q": rng.integers(-127, 128, (4, 6), dtype=np.int8),
               "scale": rng.random((1, 6)).astype(np.float32)},
    }
    t = convert.from_numpy_tree(tree, device="cpu")
    assert t["f32"].dtype == torch.float32 and t["bf16"].dtype == torch.bfloat16
    assert t["q"]["q4"].dtype == torch.uint8 and t["i8"]["q"].dtype == torch.int8
    back = convert.to_numpy_tree(t)
    np.testing.assert_array_equal(back["f32"], w)
    np.testing.assert_array_equal(back["bf16"], np.asarray(tree["bf16"]).astype(np.float32))
    np.testing.assert_array_equal(back["q"]["q4"], tree["q"]["q4"])
    np.testing.assert_array_equal(back["i8"]["q"], tree["i8"]["q"])


def test_convert_from_numpy_tree_defaults_to_the_card():
    """Like every entry point, ``from_numpy_tree`` lands on the card unless
    told otherwise, so without a GPU its default raises."""
    tree = {"w": np.ones((2, 3), np.float32), "q": {"q4": np.zeros((1, 3), np.uint8)}}
    t = convert.from_numpy_tree(tree, device="cpu")
    assert t["w"].device.type == "cpu" and t["q"]["q4"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            convert.from_numpy_tree(tree)  # default device is the card
    else:
        assert convert.from_numpy_tree(tree)["q"]["q4"].device.type == "cuda"
