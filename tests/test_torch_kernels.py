"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so without a GPU these skip.

This file imports no JAX, so it also runs where JAX is absent (the
GPU machine); there, skip the repo's conftest, which imports JAX:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tolerance: bit-exact (``torch.equal``). The kernel and its plain
version do the same f32 multiply and one rounding to the output type.
"""

import numpy as np
import pytest
import torch

from odh_kubeflow_tpu_torch.ops import int4


def _operands(K, N, g, seed=0):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, size=(K // 2, N), dtype=np.uint8)  # every nibble
    scale = (rng.random((g, N)) * 0.02 + 1e-4).astype(np.float32)
    return torch.from_numpy(packed).cuda(), torch.from_numpy(scale).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "K,N,g",
    [
        (4096, 1024, 32),  # an 8B wk: group 128, vector path
        (14336, 512, 112),  # w_down's K
        (4096, 8016, 32),  # N not a power of two
        (154, 1003, 1),  # N % 16 != 0: one byte per thread
        (74, 208, 1),  # K/2 not a multiple of the rows per thread
        (256, 48, 4),  # group 64
    ],
)
def test_int4_kernel_bit_exact_on_card(dtype, K, N, g):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p, s = _operands(K, N, g)
    before = int4.launches
    got = int4.int4_dequant(p, s, dtype)
    torch.cuda.synchronize()
    assert int4.launches == before + 1
    assert got.shape == (K, N) and got.dtype == dtype
    assert torch.equal(got, int4.int4_dequant_reference(p, s, dtype))


@pytest.mark.gpu
def test_int4_kernel_on_a_layer_slice_and_misaligned_view():
    """A slice of a stacked ``[L, K/2, N]`` leaf (what the decoder loop
    passes) and a view whose start is not 16-byte aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p, s = _operands(3 * 512, 256, 3 * 8)
    stacked_p, stacked_s = p.reshape(3, 256, 256), s.reshape(3, 8, 256)
    for i in range(3):
        got = int4.int4_dequant(stacked_p[i], stacked_s[i])
        assert torch.equal(got, int4.int4_dequant_reference(stacked_p[i], stacked_s[i]))
    flat = torch.from_numpy(np.arange(1 + 64 * 32, dtype=np.uint8)).cuda()
    view = flat[1:].reshape(64, 32)  # contiguous, data_ptr % 16 == 1
    sc = torch.full((1, 32), 0.5, device="cuda")
    got = int4.int4_dequant(view, sc, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, int4.int4_dequant_reference(view, sc, torch.float32))


@pytest.mark.gpu
def test_int4_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p, s = _operands(256, 64, 2)
    with pytest.raises(ValueError):
        int4.int4_dequant(p.t(), s)  # not contiguous
    with pytest.raises(ValueError):
        int4.int4_dequant(p, s.cpu())  # two devices
