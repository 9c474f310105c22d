"""The port's native host pieces (``odh_kubeflow_tpu_torch/native``), built
by the system C++ compiler from the port's own sources into the git-ignored
``build/native/``.

The packer (``packer.cpp``) is bit for bit equal to the port's Python
path and to the JAX package's native packer on the cases of
``tests/test_native.py`` (drop_remainder, a long document split across
rows, 8 x 1,024 at scale, the fuzz edges), with its engine rules ("auto"
takes it for a list or tuple; generators stream through Python, "native"
refuses them) and ``pack_rows``' checks (lengths, the row bound).

The JSON-tree extension (``jsontree.cpp``): ``dumps`` is byte-identical
to JAX's native ``dumps`` and to ``json.dumps`` on seeded random trees
(frozen subclasses, non-BMP strings, ``inf``/``nan``, non-str keys that
take the stdlib fallback), ``deepcopy`` is equal and isolated, the
control plane's ``serialize``/``objects`` switches take it, and without
a compiler the engine is visibly ``"python"``."""

import ctypes
import json
import pathlib
import random

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


# ---------------------------------------------------------------------------
# the JSON-tree extension (``jsontree.cpp``): deepcopy and dumps


def _tree(rng):
    """A seeded JSON-shaped tree with the serializer's edges (non-BMP and
    control characters, ``inf``/``nan``/``-0.0``, big ints, tuples, frozen
    subclasses, rare non-str keys): the generator ``chip_smoke.py``'s
    ``native_jsontree`` phase holds the extension to on the card machine."""
    import chip_smoke
    from odh_kubeflow_tpu_torch.machinery import objects

    return chip_smoke.jsontree_tree(rng, objects)


def test_jsontree_builds_from_the_ports_source_into_build():
    so = native.build_jsontree()
    assert so.parent == REPO / "build" / "native"
    assert so.name.startswith(native.JSONTREE_MODULE + "-") and so.exists()
    assert native.JSONTREE_SRC == REPO / "odh_kubeflow_tpu_torch" / "native" / "jsontree.cpp"
    assert native._jsontree_target() == so
    assert native.jsontree_dumps() is not None and native.jsontree_deepcopy() is not None


@pytest.mark.parametrize("seed", range(4))
def test_jsontree_dumps_is_byte_identical_to_jax_native_and_stdlib(seed):
    port_dumps, jax_dumps = native.jsontree_dumps(), jnative.jsontree_dumps()
    assert jax_dumps is not None
    rng = random.Random(seed)
    for trial in range(300):
        tree = _tree(rng)
        want = json.dumps(tree).encode()
        assert port_dumps(tree) == want, (seed, trial)
        assert jax_dumps(tree) == want, (seed, trial)


def test_jsontree_dumps_errors_match_the_stdlib():
    dumps = native.jsontree_dumps()
    for bad in ({"k": {1, 2}}, [object()], {(1, 2): "tuple key"}):
        with pytest.raises(TypeError) as native_err:
            dumps(bad)
        with pytest.raises(TypeError) as json_err:
            json.dumps(bad)
        assert str(native_err.value) == str(json_err.value)


@pytest.mark.parametrize("seed", range(2))
def test_jsontree_deepcopy_is_equal_and_isolated(seed):
    from odh_kubeflow_tpu_torch.machinery import objects

    port_copy, jax_copy = native.jsontree_deepcopy(), jnative.jsontree_deepcopy()
    rng = random.Random(100 + seed)
    for trial in range(300):
        tree = _tree(rng)
        got = port_copy(tree)
        assert json.dumps(got) == json.dumps(tree) == json.dumps(jax_copy(tree)), trial
        assert json.dumps(got) == json.dumps(objects._py_deepcopy(objects.mutable(tree))), trial
        # no container is shared with the source, and frozen trees thaw
        stack, seen = [got], 0
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                assert type(node) is dict
                stack.extend(node.values())
                seen += 1
            elif isinstance(node, list):
                assert type(node) is list
                stack.extend(node)
                seen += 1
        if isinstance(got, (dict, list)):
            assert got is not tree
    src = {"metadata": {"labels": {"a": "1"}}, "exotic": {1, 2}}
    out = port_copy(src)
    out["metadata"]["labels"]["b"] = "2"
    assert "b" not in src["metadata"]["labels"]
    assert out["exotic"] == {1, 2} and out["exotic"] is not src["exotic"]


def test_serialize_and_objects_take_the_native_path():
    from odh_kubeflow_tpu_torch.machinery import objects, serialize

    assert serialize.engine() == "native" and objects.engine() == "native"
    frozen = objects.freeze({"a": [1, {"b": "😀"}], "c": float("nan")})
    assert serialize.dumps(frozen) == json.dumps(frozen).encode()
    thawed = objects.mutable(frozen)
    assert type(thawed) is dict and type(thawed["a"]) is list and type(thawed["a"][1]) is dict
    before = serialize.dumps_count()
    serialize.set_engine("python")
    try:
        assert serialize.engine() == "python"
        assert serialize.dumps(frozen) == json.dumps(frozen).encode()
    finally:
        serialize.set_engine(None)
    assert serialize.dumps_count() == before + 1
    with pytest.raises(ValueError):
        serialize.set_engine("rust")


def test_without_a_compiler_the_engine_is_visibly_python(monkeypatch, tmp_path):
    """No compiler: the extension is not built, both switches answer
    ``"python"``, and ``set_engine("native")`` refuses."""
    from odh_kubeflow_tpu_torch.machinery import objects, serialize

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "_jt_mod", None)
    monkeypatch.setattr(native, "_jt_tried", False)
    monkeypatch.setattr(serialize, "_native_tried", False)
    monkeypatch.setattr(serialize, "_native_dumps", None)
    monkeypatch.setattr(objects, "_native_tried", False)
    monkeypatch.setattr(objects, "_native_copy", None)
    assert native.jsontree_dumps() is None and native.jsontree_deepcopy() is None
    assert serialize.engine() == "python" and objects.engine() == "python"
    with pytest.raises(RuntimeError, match="unavailable"):
        serialize.set_engine("native")
    tree = {"a": [1, 2.5, None]}
    assert serialize.dumps(tree) == json.dumps(tree).encode()
    assert objects.deepcopy(tree) == tree


def test_chip_smoke_native_jsontree_phase_on_cpu():
    """``chip_smoke.native_jsontree_phase`` end to end on this CPU: the
    engines are native, the 3,000 seeded trees pass (some through the
    stdlib fallback), and the record has both engines' timings (a CPU's,
    kept nowhere: the card machine's run is the one PERF.md reads)."""
    import chip_smoke

    record = chip_smoke.native_jsontree_phase("cpu")
    assert record["engine"] == record["deepcopy_engine"] == "native"
    assert record["trees"] == 3000 and record["fallback_trees"] > 0
    assert record["notebooks"] == 300 and record["list_bytes"] > 100_000
    for key in ("dumps_python_us", "dumps_native_us", "deepcopy_python_us", "deepcopy_native_us"):
        assert record[key] > 0
