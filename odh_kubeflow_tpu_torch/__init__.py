"""PyTorch/CUDA port of ``odh_kubeflow_tpu``'s model runtime, for one
NVIDIA H100.

The JAX package beside this one is the reference: module names match
(``models/llama.py`` here is the counterpart of ``models/llama.py``
there), parameter trees keep the same nested-dict layout and leaf
names, and every Pallas kernel on a ported path becomes a kernel
written by hand for Hopper under ``csrc/``. This package imports
``torch``, never ``jax``, and nothing of ``odh_kubeflow_tpu``.

Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; without a GPU they raise rather than fall
back. On a CPU tensor each kernel wrapper runs its plain PyTorch
version, which is also the kernel's oracle on the card.

The platform half (``apis/``, ``machinery/``, ``controllers/``,
``scheduling/``, ``sessions/``, ``warmup/``, ``webhooks/``, ``web/``)
schedules notebooks onto GPU node pools; ``python -m
odh_kubeflow_tpu_torch.platform`` (``platform.py``) boots all of it in one
process, the JAX package's all-in-one server.

``card_label`` and ``resolve_device`` load ``utils/device.py`` (and so
``torch``) on first use: the control plane's processes (apiserver,
replica, controllers) import only host-only modules and never pay
torch's import.
"""

__all__ = ["card_label", "resolve_device"]


def __getattr__(name: str):
    if name in __all__:
        from odh_kubeflow_tpu_torch.utils import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
