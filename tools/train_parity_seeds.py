#!/usr/bin/env python3
"""``chip_smoke.py``'s ``train_parity_on_card`` reading, leaf by leaf, over
several init seeds.

    python3 tools/train_parity_seeds.py [--seeds 1 2 3]

For each seed: the 2-layer model at Llama-3-8B width, int4 base, LoRA r16
with live adapters (b drawn from seed 9 times 0.01), remat "attn", as the
phase builds it; the adapters' gradients with the kernels and with their
plain versions on the phase's unpacked and packed batches, and for each
leaf ``||kernel - plain|| / ||plain||`` and ``||plain||``. Prints one JSON
line per seed, then the card.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    args = parser.parse_args()

    import torch

    from odh_kubeflow_tpu_torch import card_label
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.ops import _build, int4
    from odh_kubeflow_tpu_torch.ops import flash_attention as fa
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
    from odh_kubeflow_tpu_torch.train.data import pack_documents, prefetch_to_device

    if not torch.cuda.is_available():
        print("train_parity_seeds: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["int4_dequant", "flash_fwd", "flash_bwd"])

    def with_plain(fn):
        kept = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv, int4.int4_dequant)
        fa.flash_fwd, fa.flash_dq, fa.flash_dkv = (
            fa.flash_fwd_reference, fa.flash_dq_reference, fa.flash_dkv_reference)
        int4.int4_dequant = int4.int4_dequant_reference
        try:
            return fn()
        finally:
            fa.flash_fwd, fa.flash_dq, fa.flash_dkv, int4.int4_dequant = kept

    B, S = cs.TRAIN_SHAPE
    cfg = LlamaConfig.llama3_8b(num_layers=2, remat=True, remat_policy="attn")
    rng = torch.Generator().manual_seed(10)
    docs = [torch.randint(1, cfg.vocab_size, (int(n),), generator=rng).tolist()
            for n in torch.randint(100, 1500, (24,), generator=rng)]
    packed = next(prefetch_to_device(pack_documents(docs, B, S)))
    for seed in args.seeds:
        trainer = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base="int4",
                          seed=seed)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(9)
        with torch.no_grad():
            for ab in trainer.lora_params["layers"].values():
                ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device="cuda") * 0.01)
        line = {"seed": seed}
        for name, batch in (("unpacked", trainer.make_fake_batch(B, S, seed=2)),
                            ("packed", packed)):
            _, kernel = trainer.gradients(batch)
            _, plain = with_plain(lambda: trainer.gradients(batch))
            leaves = {}
            for path, p in plain.items():
                norm = p.float().norm()
                rel = ((kernel[path].float() - p.float()).norm() / norm.clamp_min(1e-30)).item()
                leaves["/".join(path)] = {"rel": rel, "plain_norm": norm.item()}
            worst = max(leaves, key=lambda k: leaves[k]["rel"])
            line[name] = {"worst_leaf": worst, **leaves[worst], "leaves": leaves}
        cs.emit(line)
        del trainer
        torch.cuda.empty_cache()
    print(card_label(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
