"""int4 → bf16/f32 weight dequantization (counterpart of
``ops/pallas_int4.py`` ``int4_dequant``).

``int4_dequant`` launches the CUDA kernel ``csrc/int4_dequant.cu`` on a
CUDA tensor and runs ``int4_dequant_reference``, its plain PyTorch
version, on a CPU tensor. There is no fallback from one to the other:
on the card the kernel runs or the call raises. ``launches`` counts the
kernel's launches, so a run can show that its path went through it.

Packing (``models/quant.py``): ``packed`` is uint8 ``[K/2, N]`` whose low
nibbles hold rows ``[0, K/2)`` and high nibbles rows ``[K/2, K)``, stored
+8; ``scale`` is f32 ``[g, N]`` with ``K/g`` rows per group.
"""

from __future__ import annotations

import ctypes

import torch

from odh_kubeflow_tpu_torch.ops import _build

# kernel launches since the last reset (a plain counter: the caller zeroes it)
launches = 0

_argtypes_set = False


def _library() -> ctypes.CDLL:
    global _argtypes_set
    lib = _build.library("int4_dequant")
    if not _argtypes_set:
        fn = lib.int4_dequant_launch
        fn.argtypes = [
            ctypes.c_void_p,  # packed
            ctypes.c_void_p,  # scale
            ctypes.c_void_p,  # out
            ctypes.c_longlong,  # K/2
            ctypes.c_longlong,  # N
            ctypes.c_longlong,  # group
            ctypes.c_int,  # output is bf16 (else f32)
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def _check(packed: torch.Tensor, scale: torch.Tensor, dtype) -> tuple[int, int, int]:
    if packed.ndim != 2 or scale.ndim != 2:
        raise ValueError(
            f"int4_dequant takes 2-D operands, got {tuple(packed.shape)} "
            f"and {tuple(scale.shape)}"
        )
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(
            f"int4_dequant takes uint8 packed and float32 scale, got "
            f"{packed.dtype} and {scale.dtype}"
        )
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int4_dequant writes bfloat16 or float32, not {dtype}")
    K2, N = packed.shape
    g = scale.shape[0]
    if scale.shape[1] != N or g == 0 or (2 * K2) % g:
        raise ValueError(
            f"scale {tuple(scale.shape)} does not match packed {tuple(packed.shape)}"
        )
    return K2, N, (2 * K2) // g


def int4_dequant_reference(
    packed: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    """Plain PyTorch: ``out[r, n] = (nibble(r, n) - 8) * scale[r // group, n]``
    in f32, rounded once to ``dtype``. Runs on any device."""
    K2, N, group = _check(packed, scale, dtype)
    p = packed.to(torch.int32)
    nib = torch.cat([p & 0xF, (p >> 4) & 0xF], dim=0)  # [K, N]
    v = (nib - 8).to(torch.float32).reshape(-1, group, N)
    return (v * scale[:, None, :]).reshape(2 * K2, N).to(dtype)


def int4_dequant(
    packed: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    """``packed`` uint8 [K/2, N], ``scale`` f32 [g, N] → [K, N] ``dtype``.
    The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    global launches
    if packed.device.type == "cpu" and scale.device.type == "cpu":
        return int4_dequant_reference(packed, scale, dtype)
    if packed.device.type != "cuda" or scale.device != packed.device:
        raise ValueError(
            f"int4_dequant: operands on {packed.device} and {scale.device}; "
            "both must be on one CUDA device (or both on the CPU)"
        )
    K2, N, group = _check(packed, scale, dtype)
    if not (packed.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int4_dequant needs contiguous operands")
    out = torch.empty((2 * K2, N), dtype=dtype, device=packed.device)
    lib = _library()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.int4_dequant_launch(
            packed.data_ptr(),
            scale.data_ptr(),
            out.data_ptr(),
            K2,
            N,
            group,
            1 if dtype == torch.bfloat16 else 0,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"int4_dequant kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
