"""The port's input pipeline against the JAX package's: ``pack_documents``
gives the same arrays, bit for bit, on ``tests/test_data.py``'s cases and
on random documents (the JAX package's Python path, the one the port
copies); ``prefetch_to_device`` keeps order and types, and a packed
batch trains through the port's trainer with segment-masked attention."""

import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.train import data as jdata
from odh_kubeflow_tpu_torch.models import llama, lora
from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
from odh_kubeflow_tpu_torch.train.data import pack_documents, prefetch_to_device
from odh_kubeflow_tpu_torch.utils import prometheus


def _random_docs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=rng.integers(lo, hi)).tolist() for _ in range(n)]


@pytest.mark.parametrize(
    "docs,kw",
    [
        ([[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11, 12]], dict(batch_size=2, seq_len=6)),
        ([[1, 2, 3, 4]], dict(batch_size=2, seq_len=8, drop_remainder=False)),
        (_random_docs(0, 64, 3, 20), dict(batch_size=8, seq_len=16)),
        (_random_docs(1, 48, 3, 14), dict(batch_size=4, seq_len=16, drop_remainder=False)),
        (_random_docs(2, 10, 30, 70), dict(batch_size=2, seq_len=16, pad_id=7)),
    ],
    ids=["segments_targets_mask", "pads_remainder", "random64", "random48_remainder",
         "long_docs_split"],
)
def test_pack_documents_matches_jax(docs, kw):
    want = list(jdata.pack_documents(docs, engine="python", **kw))
    got = list(pack_documents(iter(docs), **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_pack_documents_engine_argument():
    with pytest.raises(ValueError):
        pack_documents([[1, 2]], 1, 4, engine="fast")
    with pytest.raises(RuntimeError):
        pack_documents([[1, 2]], 1, 4, engine="native")


def test_prefetch_keeps_order_and_a_packed_batch_trains():
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    batches = list(pack_documents(_random_docs(3, 64, 3, 20), batch_size=4, seq_len=16))
    out = list(prefetch_to_device(iter(batches), device="cpu", buffer_size=2))
    assert len(out) == len(batches)
    for g, w in zip(out, batches):
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    assert len(list(prefetch_to_device(iter(batches[:1]), device="cpu", buffer_size=0))) == 1
    trainer = Trainer(cfg, TrainConfig(warmup_steps=1, total_steps=4), lora.LoraConfig(rank=2),
                      device="cpu", metrics_registry=prometheus.Registry())
    losses = [float(trainer.train_step(b)["loss"]) for b in out[:3]]
    assert all(np.isfinite(losses))
