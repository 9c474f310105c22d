"""The port's native packer (``odh_kubeflow_tpu_torch/native``): built by
the system C++ compiler from the port's own ``packer.cpp`` into the
git-ignored ``build/native/``, and bit for bit equal to the port's Python
path and to the JAX package's native packer on the cases of
``tests/test_native.py`` (drop_remainder, a long document split across
rows, 8 x 1,024 at scale, the fuzz edges), with its engine rules ("auto"
takes it for a list or tuple; generators stream through Python, "native"
refuses them) and ``pack_rows``' checks (lengths, the row bound)."""

import ctypes
import pathlib

import numpy as np
import pytest

from odh_kubeflow_tpu import native as jnative
from odh_kubeflow_tpu.train import data as jdata
from odh_kubeflow_tpu_torch import native
from odh_kubeflow_tpu_torch.train import data

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ compiler in this environment")

REPO = pathlib.Path(__file__).resolve().parent.parent
KEYS = ("tokens", "targets", "segment_ids", "loss_mask")


def _random_docs(n, rng, max_len=300):
    return [list(rng.integers(1, 1000, size=rng.integers(1, max_len))) for _ in range(n)]


def _fuzz(trial):
    """``tests/test_native.py``'s fuzz draws: many tiny docs, docs of
    seq_len multiples, one giant doc, numpy-backed mixed docs."""
    rng = np.random.default_rng(7 + 100 * trial)
    kind = trial % 4
    if kind == 0:
        return [list(rng.integers(1, 99, size=rng.integers(1, 4)))
                for _ in range(rng.integers(1, 40))]
    if kind == 1:
        return [list(rng.integers(1, 99, size=s)) for s in (32, 64, 96, 32)]
    if kind == 2:
        return [list(rng.integers(1, 99, size=500))]
    return [rng.integers(1, 99, size=rng.integers(1, 120), dtype=np.int32) for _ in range(20)]


CASES = {
    "random40_drop": (_random_docs(40, np.random.default_rng(0)), 3, 128, True),
    "random40_keep": (_random_docs(40, np.random.default_rng(0)), 3, 128, False),
    "long_doc_split": ([list(range(1, 1001))], 2, 64, True),
    "scale_8x1024": (_random_docs(500, np.random.default_rng(2), max_len=200), 8, 1024, True),
    **{f"fuzz{t}_{'drop' if d else 'keep'}": (_fuzz(t), 2, 32, d)
       for t in range(8) for d in (True, False)},
}


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(KEYS)
        for k in KEYS:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_native_pack_equals_python_and_the_reference_bitwise(case):
    docs, B, S, drop = CASES[case]
    kw = dict(batch_size=B, seq_len=S, drop_remainder=drop)
    nat = list(data.pack_documents(list(docs), engine="native", **kw))
    _same(nat, list(data.pack_documents(list(docs), engine="python", **kw)))
    _same(list(data.pack_documents(tuple(docs), **kw)), nat)  # "auto" on a tuple
    if jnative.available():
        _same(nat, list(jdata.pack_documents(list(docs), engine="native", **kw)))


def test_auto_takes_the_native_path_for_lists_only(monkeypatch):
    docs = _random_docs(20, np.random.default_rng(1))
    taken = []
    real = native.pack_rows
    monkeypatch.setattr(native, "pack_rows", lambda *a, **k: taken.append(1) or real(*a, **k))
    from_list = list(data.pack_documents(docs, 2, 128))
    assert taken == [1]
    from_gen = list(data.pack_documents(iter(docs), 2, 128))  # streams through Python
    assert taken == [1]
    _same(from_gen, from_list)
    with pytest.raises(RuntimeError, match="materialised"):
        data.pack_documents(iter([[1, 2]]), 1, 8, engine="native")


def test_pack_rows_validates_lengths_and_the_row_bound():
    with pytest.raises(ValueError, match="doc_lens"):
        native.pack_rows(np.arange(5, dtype=np.int32), np.array([3], np.int64), 8)
    # the C pass refuses to write past max_rows: 10 tokens need 3 rows of 4
    lib = native._load()
    flat = np.arange(1, 11, dtype=np.int32)
    lens = np.array([10], np.int64)
    out = [np.zeros((2, 4), np.int32) for _ in range(3)] + [np.zeros((2, 4), np.float32)]
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = lib.pack_documents_c(
        flat.ctypes.data_as(i32p), lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 1, 4,
        *(a.ctypes.data_as(i32p) for a in out[:3]),
        out[3].ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 2)
    assert n == -1


def test_the_library_builds_from_the_ports_source_into_build():
    so = native.build()
    assert so.parent == REPO / "build" / "native"
    assert so.name.startswith("libpacker-") and so.exists()
    assert native.SRC == REPO / "odh_kubeflow_tpu_torch" / "native" / "packer.cpp"
    assert "build/" in (REPO / ".gitignore").read_text().splitlines()
    assert native._target() == so  # named by the source's hash: built once
