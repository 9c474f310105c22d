#!/usr/bin/env python3
"""``chip_smoke.py``'s ``train_parity_on_card`` reading, leaf by leaf, over
several init seeds.

    python3 tools/train_parity_seeds.py [--seeds 1 3]

For each seed: the 2-layer model at Llama-3-8B width, int4 base, LoRA r16
with live adapters (b drawn from seed 9 times 0.01), remat "attn", as the
phase builds it; the adapters' gradients with the kernels and with their
plain versions on the phase's unpacked and packed batches, and for each
leaf both readings of ``chip_smoke.adapter_grad_readings``:
``||kernel - plain|| / ||plain||`` and, for a ``scale`` leaf, the same
difference over the sum of its terms' magnitudes (the gated reading).
Prints one JSON line per seed, then the card.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 3])
    args = parser.parse_args()

    import torch

    from odh_kubeflow_tpu_torch import card_label
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.ops import _build, int4
    from odh_kubeflow_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("train_parity_seeds: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["int4_dequant", "flash_fwd", "flash_bwd"])

    B, S = cs.TRAIN_SHAPE
    cfg = LlamaConfig.llama3_8b(num_layers=2, remat=True, remat_policy="attn")
    packed = cs.parity_packed(cfg)
    for seed in args.seeds:
        trainer = cs.parity_trainer(torch, cfg, seed)
        line = {"seed": seed, "grad_tol": cs.TRAIN_GRAD_TOL}
        for name, batch in (("unpacked", trainer.make_fake_batch(B, S, seed=2)),
                            ("packed", packed)):
            r = cs.adapter_grad_readings(torch, fa, int4, trainer, batch)
            del r["grads"]
            line[name] = r
        cs.emit(line)
        del trainer
        torch.cuda.empty_cache()
    print(card_label(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
