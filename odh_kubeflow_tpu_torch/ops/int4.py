"""int4 weights (counterpart of ``ops/pallas_int4.py``): the dequant and
the fused-dequant matmul with its input gradient.

- ``int4_dequant`` (``_dequant_kernel``) → ``csrc/int4_dequant.cu``:
  packed weights to a bf16 or f32 ``[K, N]`` copy.
- ``int4_matmul`` (``_int4_mm_kernel`` and ``_int4_dlhs_kernel``) →
  ``csrc/int4_matmul.cu``: ``x @ dequant(q4, scale4)`` with the weights
  left packed in device memory, differentiable in ``x`` only (a frozen
  QLoRA base). A ``torch.library`` custom op pair, ``odh_torch::int4_mm``
  and ``odh_torch::int4_dlhs``, with an autograd registration.

Each wrapper launches its CUDA kernel on a CUDA tensor and runs its plain
PyTorch version (``*_reference``) on a CPU tensor. There is no fallback
from one to the other: on the card the kernel runs or the call raises.
``launches`` counts the dequant kernel's launches, ``mm_launches`` and
``dlhs_launches`` the matmul's, so a run can show that its path went
through them. Each direction has two kernels, chosen by shape before the
launch (``int4_mm_instance``, ``int4_dlhs_instance``), never by trying
one: the Hopper kernel (``int4_mm_launch``, ``int4_dlhs_launch``, at every
shape TMA can map; ``int4_mm_tile_rows`` and ``int4_dlhs_chunks`` mirror
its tiles) and the first design's element-by-element kernel
(``int4_mm_generic_launch``, ``int4_dlhs_generic_launch``);
``mm_launches_by_instance`` and ``dlhs_launches_by_instance`` count each.

Packing (``models/quant.py``): ``packed`` / ``q4`` is uint8 ``[K/2, N]``
whose low nibbles hold rows ``[0, K/2)`` and high nibbles rows ``[K/2, K)``,
stored +8; ``scale`` / ``scale4`` is f32 ``[g, N]`` with ``K/g`` rows per
group.
"""

from __future__ import annotations

import ctypes

import torch

from odh_kubeflow_tpu_torch.ops import _build
from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm

# kernel launches since the last reset (plain counters: the caller zeroes
# them): the dequant, and the fused matmul's forward and input gradient
launches = 0
mm_launches = 0
dlhs_launches = 0
# launches by instance ("tma_<tokens>" or "generic"): the forward's, the dX's
mm_launches_by_instance: dict[str, int] = {}
dlhs_launches_by_instance: dict[str, int] = {}

_argtypes_set = False
_mm_argtypes_set = False


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


# ---------------------------------------------------------------------------
# the fused-dequant matmul: x @ dequant(q4, scale4), weights left packed

# the TPU kernels' blocking (pallas_int4.py MM_BM, MM_BN, MM_BK). The shape
# contract below raises where _int4_mm_impl and _int4_dlhs_impl do, on both
# devices, so a caller takes the dequant path on the same shapes in both
# packages (the lm_head, N = 128256, is one). The CUDA kernels mask their
# ragged edges: every shape the contract accepts runs, M and N <= 512 of
# any size included.
MM_BM = 512
MM_BN = 512
MM_BK = 1024

# what the matmul kernels are held to against their plain versions in bf16,
# per 128 x 128 output tile (``tile_rel_err``): the tensor cores read the
# bit-identical bf16 weights of int4_dequant and both sides round an f32 sum
# once to bf16, so they differ only where sums taken in another order land
# on either side of a rounding boundary; the grouped kernels' bar
TILE_RTOL = gm.TILE_RTOL
TILE = 128


def _mm_library() -> ctypes.CDLL:
    global _mm_argtypes_set
    lib = _build.library("int4_matmul")
    if not _mm_argtypes_set:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.int4_mm_launch, lib.int4_mm_generic_launch, lib.int4_dlhs_launch,
                   lib.int4_dlhs_generic_launch):
            # x or dout, q4, scale4, out | M K N group | stream
            fn.argtypes = [P] * 4 + [L] * 4 + [P]
            fn.restype = I
        # the tiles' rules, for the mirrors' test on the card
        for fn in (lib.int4_mm_tile_rows, lib.int4_dlhs_chunks):
            fn.argtypes = [L]
            fn.restype = I
        _mm_argtypes_set = True
    return lib


def int4_mm_tile_rows(m: int) -> int:
    """Tokens of a Hopper kernel's output tile for ``m`` rows of ``x`` or
    ``dout`` (``csrc/int4_matmul.cu`` ``tile_rows``, both directions): 16 at
    decode (``m <= 16``), else 128. A forward tile is 256 weight columns
    wide, a dX tile 256 weight rows (128 packed rows, both nibble halves)."""
    return 16 if m <= 16 else 128


def int4_dlhs_chunks(n: int) -> int:
    """64-deep chunks of a Hopper dX tile's contraction ``n``
    (``csrc/int4_matmul.cu`` ``dlhs_chunks``): rounded up to an even
    count, as the consumers take them two at a time; a chunk wholly past
    ``n`` reads zeros."""
    return 2 * -(-n // 128)


def int4_mm_instance(m: int, n: int, aligned: bool) -> str:
    """Which forward kernel a card launch of an ``[m, n]`` result takes:
    ``"tma_<tokens>"``, the Hopper kernel (TMA, weights widened into
    ``wgmma``'s registers), where TMA can map the operands (``n % 16 ==
    0`` and ``aligned``: 16-byte aligned bases of ``x``, ``q4`` and
    ``scale4``; the output is a fresh allocation), else ``"generic"``."""
    if n % 16 or not aligned:
        return "generic"
    return f"tma_{int4_mm_tile_rows(m)}"


def int4_dlhs_instance(m: int, n: int, aligned: bool) -> str:
    """Which dX kernel a card launch for ``dout [m, n]`` takes: the
    forward's rule (``int4_mm_instance``) on the contraction ``n``, which
    is the packed weights' row length: ``"tma_<tokens>"``, the Hopper kernel
    (``dxᵀ = W·doutᵀ``, weights widened into ``wgmma``'s registers), where
    ``n % 16 == 0`` and ``aligned`` (16-byte aligned bases of ``dout``,
    ``q4`` and ``scale4``), else ``"generic"``."""
    return int4_mm_instance(m, n, aligned)


def _check_dtype(name: str, dtype: torch.dtype, on_card: bool) -> None:
    """bf16 on the card, never cast here; f32 or bf16 on the CPU."""
    if on_card and dtype != torch.bfloat16:
        raise TypeError(
            f"{name}: the kernel takes bfloat16 on the card, got {dtype}; cast first"
        )
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: takes bfloat16 or float32, got {dtype}")


def _check_operands(name: str, a: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor) -> bool:
    """2-D operands, uint8 q4 and f32 scale4, one device, contiguous;
    True when they are on the card."""
    if a.ndim != 2 or q4.ndim != 2 or scale4.ndim != 2:
        raise ValueError(
            f"{name} takes 2-D operands, got {tuple(a.shape)}, {tuple(q4.shape)} "
            f"and {tuple(scale4.shape)}"
        )
    if q4.dtype != torch.uint8 or scale4.dtype != torch.float32:
        raise TypeError(
            f"{name} takes uint8 q4 and float32 scale4, got {q4.dtype} and {scale4.dtype}"
        )
    if not (a.device == q4.device == scale4.device) or a.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{name}: operands on {a.device}, {q4.device} and {scale4.device}; all must be "
            "on one CUDA device (or all on the CPU)"
        )
    on_card = a.device.type == "cuda"
    _check_dtype(name, a.dtype, on_card)
    if not (a.is_contiguous() and q4.is_contiguous() and scale4.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands")
    return on_card


def _mm_blocking(M: int, K: int, K2: int, N: int, group: int, scale_shape) -> None:
    """Raise ``NotImplementedError`` exactly where ``_int4_mm_impl`` does
    (pallas_int4.py:155-165)."""
    ng = K // group
    bm, bn = min(MM_BM, M), min(MM_BN, N)
    if (
        K != 2 * K2
        or K % (2 * MM_BK)
        or MM_BK % group
        or group > MM_BK
        or tuple(scale_shape) != (ng, N)
        or M % bm
        or N % bn
    ):
        raise NotImplementedError(f"int4_matmul blocking mismatch: x({M}, {K}) q4({K2}, {N})")


def _dlhs_blocking(M: int, N: int, K2: int, N2: int, group: int, scale_shape) -> None:
    """Raise ``NotImplementedError`` exactly where ``_int4_dlhs_impl``
    does (pallas_int4.py:226-237)."""
    K = 2 * K2
    ng = K // group
    bm, bn = min(MM_BM, M), min(MM_BN, N)
    if (
        N != N2
        or K % (2 * MM_BK)
        or MM_BK % group
        or group > MM_BK
        or M % bm
        or N % bn
        or tuple(scale_shape) != (ng, N)
    ):
        raise NotImplementedError(f"int4_matmul dlhs blocking mismatch: dout({M}, {N})")


def int4_matmul_reference(x: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: ``int4_dequant_reference(q4, scale4, x.dtype)`` (the
    weight rounded once to ``x.dtype``, as the TPU kernel's
    ``_unpack_scaled``), widened to f32, one f32 product, rounded once to
    ``x.dtype``. Runs on any device."""
    w = int4_dequant_reference(q4, scale4, x.dtype).float()
    return (x.float() @ w).to(x.dtype)


def int4_dlhs_reference(dout: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``dout @ dequant(q4, scale4)ᵀ``, rounded as
    ``int4_matmul_reference``, in ``dout.dtype``."""
    w = int4_dequant_reference(q4, scale4, dout.dtype).float()
    return (dout.float() @ w.T).to(dout.dtype)


def _launch(fn, a, q4, scale4, out, M, K, N, group) -> None:
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), q4.data_ptr(), scale4.data_ptr(), out.data_ptr(), M, K, N, group,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4_matmul kernel launch failed: CUDA error {rc}")


def int4_mm(x: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor, group: int = 128) -> torch.Tensor:
    """``x [M, K] @ dequant(q4 [K/2, N], scale4 [K/group, N])`` → ``[M, N]``
    in ``x.dtype``: the kernel on CUDA tensors (bf16 ``x``), the plain
    version on CPU tensors. Raises ``NotImplementedError`` where the TPU
    kernel's blocking does."""
    global mm_launches
    on_card = _check_operands("int4_matmul", x, q4, scale4)
    (M, K), (K2, N) = x.shape, q4.shape
    _mm_blocking(M, K, K2, N, group, scale4.shape)
    if not on_card:
        return int4_matmul_reference(x, q4, scale4)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    instance = int4_mm_instance(M, N, all(t.data_ptr() % 16 == 0 for t in (x, q4, scale4)))
    lib = _mm_library()
    fn = lib.int4_mm_generic_launch if instance == "generic" else lib.int4_mm_launch
    _launch(fn, x, q4, scale4, out, M, K, N, group)
    mm_launches += 1
    mm_launches_by_instance[instance] = mm_launches_by_instance.get(instance, 0) + 1
    return out


def int4_dlhs(dout: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor,
              group: int = 128) -> torch.Tensor:
    """``dout [M, N] @ dequant(q4, scale4)ᵀ`` → ``[M, K]`` in ``dout.dtype``:
    the kernel on CUDA tensors (bf16 ``dout``), the plain version on CPU
    tensors. Raises ``NotImplementedError`` where the TPU kernel's
    blocking does."""
    global dlhs_launches
    on_card = _check_operands("int4_matmul dlhs", dout, q4, scale4)
    (M, N), (K2, N2) = dout.shape, q4.shape
    _dlhs_blocking(M, N, K2, N2, group, scale4.shape)
    if not on_card:
        return int4_dlhs_reference(dout, q4, scale4)
    dx = torch.empty((M, 2 * K2), dtype=dout.dtype, device=dout.device)
    instance = int4_dlhs_instance(M, N, all(t.data_ptr() % 16 == 0 for t in (dout, q4, scale4)))
    lib = _mm_library()
    fn = lib.int4_dlhs_generic_launch if instance == "generic" else lib.int4_dlhs_launch
    _launch(fn, dout, q4, scale4, dx, M, 2 * K2, N, group)
    dlhs_launches += 1
    dlhs_launches_by_instance[instance] = dlhs_launches_by_instance.get(instance, 0) + 1
    return dx


@torch.library.custom_op("odh_torch::int4_mm", mutates_args=())
def int4_matmul(x: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor,
                group: int = 128) -> torch.Tensor:
    """``x [M, K] @ dequant(q4, scale4) [K, N]`` → ``[M, N]`` in ``x.dtype``
    with the weights left packed (the counterpart of ``pallas_int4.py``
    ``int4_matmul``). Differentiable in ``x`` only: the backward is
    ``dout @ dequant(W)ᵀ`` through the dlhs kernel, in ``dout.dtype``; no
    gradient for ``q4``, zeros for ``scale4``.

    ``q4`` is uint8 ``[K/2, N]`` in split halves (low nibble = weight row
    ``k < K/2``, high nibble = row ``k + K/2``), ``scale4`` f32
    ``[K/group, N]``. Each weight is ``(nibble - 8) * scale`` computed in
    f32 and rounded once to ``x.dtype`` before the product, as the TPU
    kernel's ``_unpack_scaled`` (pallas_int4.py:104-116), so the product
    sees ``int4_dequant``'s bits. On the card ``x`` is bf16 (a float32
    ``x`` or ``dout`` is a ``TypeError``); on the CPU f32 or bf16.

    Raises ``NotImplementedError`` where the TPU kernels do: ``K % 2048``,
    ``1024 % group`` or ``group > 1024``, ``scale4.shape != (K // group,
    N)``, ``M % min(512, M)`` or ``N % min(512, N)``, ``K != 2 * K/2``
    (pallas_int4.py:155-165, :226-237). Callers take the dequant path
    there."""
    return int4_mm(x, q4, scale4, group)


@int4_matmul.register_fake
def _(x, q4, scale4, group=128):
    return x.new_empty((x.shape[0], q4.shape[1]))


@torch.library.custom_op("odh_torch::int4_dlhs", mutates_args=())
def int4_dlhs_op(dout: torch.Tensor, q4: torch.Tensor, scale4: torch.Tensor,
                 group: int) -> torch.Tensor:
    return int4_dlhs(dout, q4, scale4, group)


@int4_dlhs_op.register_fake
def _(dout, q4, scale4, group):
    return dout.new_empty((dout.shape[0], 2 * q4.shape[0]))


def _mm_setup(ctx, inputs, output):
    _, q4, scale4, group = inputs
    ctx.group = group
    ctx.save_for_backward(q4, scale4)


def _mm_backward(ctx, dout):
    # the weights are frozen: dx through the dlhs kernel, none for q4, and
    # zeros for scale4, as _int4_matmul_bwd (pallas_int4.py:287-294)
    q4, scale4 = ctx.saved_tensors
    need = ctx.needs_input_grad
    dx = int4_dlhs_op(dout.contiguous(), q4, scale4, ctx.group) if need[0] else None
    return dx, None, torch.zeros_like(scale4) if need[2] else None, None


int4_matmul.register_autograd(_mm_backward, setup_context=_mm_setup)


def tile_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``||got - want|| / ||want||`` over 128 x 128 tiles of an
    ``[M, N]`` result (``grouped_matmul.tile_rel_err`` on a view that stacks
    the 128-column blocks; ragged edges padded with zeros on both sides)."""

    def blocks(t):
        m, n = t.shape
        t = torch.nn.functional.pad(t.float(), (0, -n % TILE, 0, -m % TILE))
        return t.reshape(t.shape[0], -1, TILE).transpose(0, 1).reshape(-1, TILE)

    return gm.tile_rel_err(blocks(got), blocks(want), TILE)
