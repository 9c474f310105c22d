#!/usr/bin/env python3
"""The port's training steps and its grouped prefill, timed for this
checkout and for another one on the same card, in turns.

    python3 tools/step_compare.py --parent DIR

Runs, in one process per turn (the two checkouts' packages share a
name), ``Trainer.benchmark(2, 4096, steps=3, warmup=1)`` for the
Llama-3-8B QLoRA step (int4 base, LoRA r16, remat "attn"), the
Mixtral-8x1B QLoRA step (int8 banks, grouped dispatch, remat "attn" +
``pin_expert_acts``) and the 8-layer Mixtral-8x1B full fine-tune (bf16
banks and Adam state, remat "attn"), as ``chip_smoke.py``'s ``train``,
``moe_train`` and ``moe_full_train`` phases configure them; then the
time to the first token of Mixtral-8x1B served in bf16 with grouped
dispatch (16 layers, seed 0) for ``chip_smoke.py``'s four ragged prompts
(bucket [4, 256], one grouped prefill of 48 ``gmm``), by
``CompletionService.complete(max_tokens=1)`` without HTTP: the median of
5 after one warm-up. The turns go parent, this, this, parent, so a drift
of the card over the run shows as a difference between a checkout's two
turns. Each checkout builds its kernels under its own
``build/torch_kernels/`` first. Prints one JSON line per turn, then the
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TURN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
from odh_kubeflow_tpu_torch.models.lora import LoraConfig
from odh_kubeflow_tpu_torch.models.moe import MoeConfig
from odh_kubeflow_tpu_torch.ops import _build
from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

_build.build(["int4_dequant", "flash_fwd", "flash_bwd", "gmm", "swiglu_gmm", "tgmm"])
out = {"checkout": sys.argv[1]}
cfg = LlamaConfig.llama3_8b(remat=True, remat_policy="attn")
tr = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base="int4")
out["llama3_8b_qlora_step_s"] = tr.benchmark(2, 4096, steps=3, warmup=1)["step_time_s"]
del tr
torch.cuda.empty_cache()
cfg = MoeConfig.mixtral_8x1b(base=LlamaConfig.llama3_1b(remat_policy="attn"),
                             dispatch="grouped", pin_expert_acts=True)
tr = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base=True)
out["mixtral_8x1b_qlora_step_s"] = tr.benchmark(2, 4096, steps=3, warmup=1)["step_time_s"]
del tr
torch.cuda.empty_cache()
cfg = MoeConfig.mixtral_8x1b(base=LlamaConfig.llama3_1b(remat_policy="attn", num_layers=8),
                             dispatch="grouped")
tr = Trainer(cfg, TrainConfig(), None)
out["mixtral_8x1b_full_ft_8_layers_step_s"] = tr.benchmark(2, 4096, steps=3,
                                                           warmup=1)["step_time_s"]
del tr
torch.cuda.empty_cache()
import statistics, time
from odh_kubeflow_tpu_torch.models import moe
from odh_kubeflow_tpu_torch.models.serve import CompletionService
cfg = MoeConfig.mixtral_8x1b(dispatch="grouped")
service = CompletionService(moe.init_params(0, cfg, dtype=torch.bfloat16, device="cuda"), cfg)
gen = torch.Generator().manual_seed(17)
prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist() for n in (17, 64, 200, 256)]
service.complete(prompts, max_tokens=1)
ttft = []
for _ in range(5):
    t0 = time.perf_counter()
    service.complete(prompts, max_tokens=1)
    ttft.append(time.perf_counter() - t0)
out["mixtral_8x1b_grouped_prefill_ttft_s"] = statistics.median(ttft)
print(json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True,
                    help="another checkout of the repository (e.g. the parent commit)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("step_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from odh_kubeflow_tpu_torch import card_label

    trees = {"parent": args.parent.resolve(), "this": ROOT}
    for name in ("parent", "this", "this", "parent"):
        run = subprocess.run([sys.executable, "-c", TURN, str(trees[name])],
                             capture_output=True, text=True, cwd=trees[name])
        if run.returncode != 0:
            raise RuntimeError(f"{name}: exit {run.returncode}\n{run.stderr[-3000:]}")
        row = json.loads(run.stdout.strip().splitlines()[-1])
        row["turn"] = name
        print(json.dumps(row), flush=True)
    print(card_label(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
