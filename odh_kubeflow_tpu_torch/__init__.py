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
"""

from odh_kubeflow_tpu_torch.utils.device import card_label, resolve_device

__all__ = ["card_label", "resolve_device"]
