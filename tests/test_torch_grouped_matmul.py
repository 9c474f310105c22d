"""The port's grouped matmul (``ops/grouped_matmul.py``) against the JAX
package's Pallas kernels, run in interpret mode on the CPU, on the same
numpy inputs.

Tolerances. float32: max |port − JAX| ≤ 1e-5 · max |JAX| (the f32 sums
run in another order: JAX's kernel B splits K into 1024-wide blocks).
bfloat16: both sides round the same f32 sums once to bf16 and apply an
int8 bank's transposed scale to the lhs with the same bf16 rounding, so
they differ only where a sum in another order lands across a rounding
boundary: at most one bf16 ulp, which is ≤ 2^-7 of the value, so
max |port − JAX| ≤ 1e-2 · max |JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models.quant import quantize_tensor as jquantize
from odh_kubeflow_tpu.ops import pallas_grouped_matmul as jgm
from odh_kubeflow_tpu_torch.models.quant import quantize_tensor
from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm

M, E = 1024, 4
# 128-aligned group starts, offsets[E] = M
OFFSETS = {
    "balanced": [0, 256, 512, 768, 1024],
    "empty_and_tail": [0, 256, 256, 640, 1024],  # expert 1 empty, 3 takes the tail
    "one_expert": [0, 0, 896, 896, 1024],  # every token on expert 1
}
# group boundaries on kernel B's 512-row tiles; experts 1 and 2 empty
OFFSETS_512 = [0, 512, 512, 512, 1024]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _t(a, dtype=None):
    """numpy (or JAX) array → torch, with a torch dtype cast."""
    t = torch.from_numpy(np.array(np.asarray(a, dtype=np.float32) if dtype else a))
    return t.to(dtype) if dtype else t


def _close(got: torch.Tensor, want, rel):
    want = np.asarray(want, dtype=np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _bank(rng, shape, int8):
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if not int8:
        return w, None
    q = jquantize(jnp.asarray(w))  # [E, K, N] int8, scale [E, 1, N]
    return np.asarray(q["q"]), np.asarray(q["scale"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("trans", [False, True], ids=["nt", "trans"])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "float"])
@pytest.mark.parametrize(
    "k,n", [(256, 384), (6144, 256)], ids=["kernelA", "kernelB"]
)
def test_gmm_matches_jax_and_its_lhs_gradient(dtype, trans, int8, k, n):
    jdt, tdt, rel = DTYPES[dtype]
    if k > 4096 and dtype == "f32" and not int8:
        k = 3072  # kernel B in f32 from K > 2048; keeps interpret mode quick
    rng = np.random.default_rng(k + n + int(trans) + 2 * int(int8))
    offs = np.asarray(OFFSETS["empty_and_tail"], np.int32)
    if k > 4096 and int8 and not trans:
        # one group per 512-row tile: where a tile spans groups, JAX's
        # kernel B scales it with its last group's scale (the test below)
        offs = np.asarray(OFFSETS_512, np.int32)
    lhs = rng.standard_normal((M, k)).astype(np.float32)
    q, scale = _bank(rng, (E, n, k) if trans else (E, k, n), int8)
    dout = rng.standard_normal((M, n)).astype(np.float32)

    jl = jnp.asarray(lhs, jdt)
    jq = jnp.asarray(q) if int8 else jnp.asarray(q, jdt)
    js = None if scale is None else jnp.asarray(scale)

    def jfn(a):
        return jgm.gmm(a, jq, jnp.asarray(offs), trans, None, js)

    want, vjp = jax.vjp(jfn, jl)
    (want_dl,) = vjp(jnp.asarray(dout, jdt))

    tl = _t(lhs, tdt).requires_grad_()
    tq = _t(q) if int8 else _t(q, tdt)
    ts = None if scale is None else _t(scale)
    got = gm.gmm_op(tl, tq, torch.from_numpy(offs), trans, ts)
    assert got.dtype == tdt and got.shape == (M, n)
    _close(got, want, rel)
    (got_dl,) = torch.autograd.grad(got, tl, _t(dout, tdt))
    _close(got_dl, want_dl, rel)


@pytest.mark.parametrize("routing", ["balanced", "empty_and_tail"])
def test_jax_kernel_b_scales_tiles_that_span_groups_with_the_last_group(routing):
    """A fault of the reference, pinned so the port does not copy it: on
    an int8 bank read forwards with K past kernel A's limit, JAX's
    ``_gmm_b_kernel`` applies the output scale once per 512-row tile, at
    the write, with the tile's last group's scale, so every earlier
    group's rows in that tile carry another expert's scale. The port
    scales each row with its own expert's (``gmm``'s contract, and what
    JAX's kernel A and a dequantized bank give); JAX's rows are
    reproduced exactly by the port's unscaled product times the last
    group's scale."""
    rng = np.random.default_rng(29)
    k, n = 3072, 128
    offs = np.asarray(OFFSETS[routing], np.int32)
    lhs = rng.standard_normal((M, k)).astype(np.float32)
    q, scale = _bank(rng, (E, k, n), True)
    jout = np.asarray(jgm.gmm(jnp.asarray(lhs), jnp.asarray(q), jnp.asarray(offs), False, None,
                              jnp.asarray(scale)))
    tq, ts, to = _t(q), _t(scale), torch.from_numpy(offs)
    port = gm.gmm_reference(_t(lhs), tq, to, False, ts).numpy()
    dequant = (q.astype(np.float32) * scale)
    for e in range(E):
        s, t = offs[e], offs[e + 1]
        np.testing.assert_allclose(port[s:t], lhs[s:t] @ dequant[e], rtol=1e-4, atol=1e-3)
    acc = gm.gmm_reference(_t(lhs), tq.float(), to).numpy()
    last = np.searchsorted(offs[1:-1], np.arange(M) // 512 * 512 + 511, side="right")
    np.testing.assert_allclose(jout, acc * scale[last, 0], rtol=1e-5, atol=1e-4)
    assert np.abs(jout - port).max() > 0.1 * np.abs(port).max()


@pytest.mark.parametrize("trans", [False, True], ids=["nt", "trans"])
@pytest.mark.parametrize("routing", list(OFFSETS))
def test_gmm_float_bank_weight_gradient_matches_jax_tgmm(routing, trans):
    """A float bank's lhs and bank gradients through ``gmm_op`` against
    ``jax.vjp`` of JAX's ``gmm`` (its ``_tgmm_kernel`` in interpret mode):
    the bank's gradient in its own layout (``[E, N, K]`` with
    ``trans_rhs``), zeros for empty experts."""
    rng = np.random.default_rng(5)
    k, n = 128, 256
    offs = np.asarray(OFFSETS[routing], np.int32)
    lhs = rng.standard_normal((M, k)).astype(np.float32)
    rhs = (rng.standard_normal((E, n, k) if trans else (E, k, n)) * 0.1).astype(np.float32)
    dout = rng.standard_normal((M, n)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, w: jgm.gmm(a, w, jnp.asarray(offs), trans), jnp.asarray(lhs),
                        jnp.asarray(rhs))
    want_dl, want_dw = vjp(jnp.asarray(dout))
    tl, tw = _t(lhs).requires_grad_(), _t(rhs).requires_grad_()
    got = gm.gmm_op(tl, tw, torch.from_numpy(offs), trans, None)
    got_dl, got_dw = torch.autograd.grad(got, (tl, tw), _t(dout))
    assert got_dw.shape == tw.shape
    for g, w in ((got, want), (got_dl, want_dl), (got_dw, want_dw)):
        _close(g, w, 1e-5)
    for e in range(E):
        if offs[e + 1] == offs[e]:
            assert not got_dw[e].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("orient", ["lhs_dout", "dout_lhs"])
@pytest.mark.parametrize("routing", [*OFFSETS, "512"])
def test_tgmm_matches_jax_tgmm_kernel(dtype, orient, routing):
    """``tgmm`` against JAX's ``_tgmm`` (interpret mode) called on
    ``span_pairs(include_empty=True)``, in both orientations its backward
    uses: ``(lhs, dout)`` for an ``[E, K, N]`` bank and ``(dout, lhs)``
    for a transposed one. The routings hold empty experts, a tail past the
    last group, groups on 512-row tile edges and groups that span them."""
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(13)
    offs = np.asarray(OFFSETS_512 if routing == "512" else OFFSETS[routing], np.int32)
    a = rng.standard_normal((M, 128)).astype(np.float32)
    d = rng.standard_normal((M, 256)).astype(np.float32)
    lhs, dout = (a, d) if orient == "lhs_dout" else (d, a)
    jo = jnp.asarray(offs)
    pairs = jgm.span_pairs(jo, M, jgm.DEFAULT_BM_B, include_empty=True)
    want = jgm._tgmm(jnp.asarray(lhs, jdt), jnp.asarray(dout, jdt), pairs, jo,
                     bm=jgm.DEFAULT_BM_B, bk=jgm.DEFAULT_BK_T, bn=jgm.DEFAULT_BN_T,
                     interpret=True)
    got = gm.tgmm(_t(lhs, tdt), _t(dout, tdt), torch.from_numpy(offs), E)
    assert got.dtype == tdt and got.shape == (E, lhs.shape[1], dout.shape[1])
    _close(got, want, rel)
    for e in range(E):
        if offs[e + 1] == offs[e]:
            assert not got[e].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("routing", list(OFFSETS))
def test_swiglu_gmm_matches_jax_with_its_vjp(dtype, routing):
    """``(h, g)`` of the fused SwiGLU and the lhs gradient of a cotangent
    on both outputs (JAX folds g's into dg)."""
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(11)
    k, n = 256, 384
    offs = np.asarray(OFFSETS[routing], np.int32)
    lhs = (rng.standard_normal((M, k)) * 0.5).astype(np.float32)
    gq, gs = _bank(rng, (E, k, n), True)
    uq, us = _bank(rng, (E, k, n), True)
    dh = rng.standard_normal((M, n)).astype(np.float32)
    dg = rng.standard_normal((M, n)).astype(np.float32) * 0.1

    def jfn(a):
        return jgm.swiglu_gmm(a, jnp.asarray(gq), jnp.asarray(uq), jnp.asarray(gs),
                              jnp.asarray(us), jnp.asarray(offs), None)

    (jh, jg), vjp = jax.vjp(jfn, jnp.asarray(lhs, jdt))
    (jdl,) = vjp((jnp.asarray(dh, jdt), jnp.asarray(dg, jdt)))

    tl = _t(lhs, tdt).requires_grad_()
    h, g = gm.swiglu_gmm_op(tl, _t(gq), _t(uq), _t(gs), _t(us), torch.from_numpy(offs))
    _close(h, jh, rel)
    _close(g, jg, rel)
    (dl,) = torch.autograd.grad((h, g), tl, (_t(dh, tdt), _t(dg, tdt)))
    _close(dl, jdl, rel)


@pytest.mark.parametrize("keep_g", [True, False])
def test_expert_ffn_matches_jax_swiglu_then_gmm(keep_g):
    """The fused expert op (SwiGLU, then the down projection) against JAX's
    ``swiglu_gmm`` → ``gmm``, forward and lhs gradient; without ``keep_g``
    its backward re-runs the fused forward for g."""
    rng = np.random.default_rng(17)
    k, f = 128, 256
    offs = np.asarray(OFFSETS["empty_and_tail"], np.int32)
    lhs = (rng.standard_normal((M, k)) * 0.5).astype(np.float32)
    (gq, gs), (uq, us), (dq, ds) = (_bank(rng, s, True) for s in ((E, k, f), (E, k, f), (E, f, k)))
    dy = rng.standard_normal((M, k)).astype(np.float32)
    jo = jnp.asarray(offs)

    def jfn(a):
        h, _ = jgm.swiglu_gmm(a, jnp.asarray(gq), jnp.asarray(uq), jnp.asarray(gs),
                              jnp.asarray(us), jo, None)
        return jgm.gmm(h, jnp.asarray(dq), jo, False, None, jnp.asarray(ds))

    want, vjp = jax.vjp(jfn, jnp.asarray(lhs))
    (want_dl,) = vjp(jnp.asarray(dy))
    tl = _t(lhs).requires_grad_()
    calls = []
    fwd = gm.swiglu_fwd_reference
    try:
        gm.swiglu_fwd_reference = lambda *a: calls.append(1) or fwd(*a)
        y, g = gm.expert_ffn_op(tl, _t(gq), _t(gs), _t(uq), _t(us), _t(dq), _t(ds),
                                torch.from_numpy(offs), keep_g)
        (dl,) = torch.autograd.grad(y, tl, _t(dy))
    finally:
        gm.swiglu_fwd_reference = fwd
    assert g.shape == ((M, f) if keep_g else (0,))
    assert len(calls) == (1 if keep_g else 2)
    _close(y, want, 1e-5)
    _close(dl, want_dl, 1e-5)


@pytest.mark.parametrize("routing", list(OFFSETS))
def test_group_of_tile_matches_jax(routing):
    offs = np.asarray(OFFSETS[routing], np.int32)
    want = np.asarray(jgm._group_of_tile(M, jnp.asarray(offs)))
    np.testing.assert_array_equal(gm.group_of_tile(M, torch.from_numpy(offs)).numpy(), want)


def test_port_copies_the_kernel_constants():
    assert (gm.ALIGN, gm.DEFAULT_BM_B, gm.MAX_K_A) == (jgm.ALIGN, jgm.DEFAULT_BM_B, jgm.MAX_K_A)
    assert gm.fused_swiglu_usable(2048) and gm.fused_swiglu_usable(8192)
    assert not gm.fused_swiglu_usable(8192 + 128)


def test_quantized_bank_codes_match_jax():
    """The int8 bank layout the kernels read: codes and ``[E, 1, N]``
    scales bit-identical to the JAX package's."""
    w = np.random.default_rng(3).standard_normal((E, 64, 48)).astype(np.float32)
    j, t = jquantize(jnp.asarray(w)), quantize_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_array_equal(t["scale"].numpy(), np.asarray(j["scale"]))
    assert t["scale"].shape == (E, 1, 48)


def test_tile_check_passes_bf16_rounding_and_rejects_planted_faults():
    """``tile_rel_err`` over 128-row tiles: bf16 rounding of a result
    passes ``TILE_RTOL``; a tile given the wrong expert and a product
    that skips the last 64-wide chunk of K do not."""
    rng = np.random.default_rng(23)
    k, n = 2048, 256
    offs = torch.tensor(OFFSETS["balanced"], dtype=torch.int32)
    lhs = torch.from_numpy(rng.standard_normal((M, k)).astype(np.float32)).bfloat16()
    q = quantize_tensor(torch.from_numpy(rng.standard_normal((E, k, n)).astype(np.float32)))
    want = gm.gmm_reference(lhs.float(), q["q"], offs, False, q["scale"])
    ok = gm.gmm_reference(lhs, q["q"], offs, False, q["scale"])  # one bf16 rounding
    assert gm.tile_rel_err(ok, want) <= gm.TILE_RTOL
    wrong = gm.gmm_reference(lhs, q["q"], torch.tensor([0, 384, 512, 768, 1024]), False,
                             q["scale"])  # rows 256..383 through expert 0
    skipped = lhs.clone()
    skipped[:, -64:] = 0
    short = gm.gmm_reference(skipped, q["q"], offs, False, q["scale"])
    for bad in (wrong, short):
        assert gm.tile_rel_err(bad, want) > 4 * gm.TILE_RTOL


# The persistent kernels' schedule (csrc/grouped_sm90.cuh) through its
# mirrors: the main path's shapes (the Mixtral-8x1B training step, M
# 17,408, and the serving prefill, M 3,072; D 2048, F 8192, E 8) on an
# H100's 132 SMs, and the routings chip_smoke.py holds the kernels on.
H100_SMS = 132
SCHEDULE_SHAPES = {  # (M, N, output tile width or None for gmm's own choice)
    "train_n2048": (17_408, 2048, None),
    "train_n8192": (17_408, 8192, None),
    "prefill_n2048": (3072, 2048, None),
    "prefill_n8192": (3072, 8192, None),
    "swiglu_fwd_train": (17_408, 8192, 128),
    "swiglu_fwd_small": (1024, 272, 128),
}


def _routing_counts(m, name):
    """Rows an expert (8 experts) for one of chip_smoke.py's routings."""
    per = m // 8 - 128
    return {
        "balanced": [per] * 8,
        "one_expert": [0, 0, 0, m, 0, 0, 0, 0],
        "two_empty": [per + 90, 0, per + 40, per, per - 110, 0, per + 60, per],
        "large_tail": [c * m // 17_408 for c in (1000, 900, 1100, 800, 1000, 1050, 950, 700)],
    }[name]


def _offsets(m, counts):
    starts, s = [], 0
    for c in counts:
        starts.append(s)
        s += -(-c // gm.ALIGN) * gm.ALIGN
    assert s <= m
    return torch.tensor(starts + [m], dtype=torch.int32)


@pytest.mark.parametrize("routing", ["balanced", "one_expert", "two_empty", "large_tail"])
@pytest.mark.parametrize("shape", list(SCHEDULE_SHAPES))
def test_persistent_schedule_writes_every_tile_once(shape, routing):
    """Every (row tile, column tile) pair is taken exactly once, by one
    block of a grid of min(tiles, SMs), the blocks' shares within one tile
    of each other; so every 128-row tile of every column block is written,
    each by its own expert (the tail past the last group by expert E-1)."""
    m, n, width = SCHEDULE_SHAPES[shape]
    width = width or gm.gmm_tile_width(m, n, H100_SMS)
    m_tiles, n_tiles = m // gm.ALIGN, -(-n // width)
    order = gm.tile_order(m_tiles, n_tiles)
    assert sorted(order) == [(i, j) for i in range(m_tiles) for j in range(n_tiles)]
    grid = min(len(order), H100_SMS)
    shares = [len(order[b::grid]) for b in range(grid)]
    assert max(shares) - min(shares) <= 1 and sum(shares) == len(order)
    offs = _offsets(m, _routing_counts(m, routing))
    experts = gm.group_of_tile(m, offs).tolist()
    seen = {}
    for mt, nt in order:
        seen.setdefault(nt, []).append(experts[mt])
    for nt, es in seen.items():  # each column block: every row tile, its expert
        assert sorted(es) == sorted(experts)
    last = next(e for e in range(8) if offs[e + 1] == m)
    assert experts[-1] == last and all(
        offs[e] <= mt * gm.ALIGN < (offs[e + 1] if e < last else m)
        for mt, e in enumerate(experts))


def test_gmm_tile_width_follows_the_waves_of_the_card():
    """256-wide tiles at the training shapes; 128 where 256-wide tiles
    would fill fewer than three waves of 132 SMs (the prefill's down
    projection: 192 tiles; the card tests' small shapes)."""
    assert gm.gmm_tile_width(17_408, 2048, H100_SMS) == 256
    assert gm.gmm_tile_width(17_408, 8192, H100_SMS) == 256
    assert gm.gmm_tile_width(3072, 8192, H100_SMS) == 256  # 768 tiles
    assert gm.gmm_tile_width(3072, 2048, H100_SMS) == 128  # 192 tiles
    assert gm.gmm_tile_width(1024, 512, H100_SMS) == 128
    for m in range(128, 20_000, 1280):
        for n in (16, 272, 2048, 8192, 13_072):
            tiles256 = (m // 128) * -(-n // 256)
            assert gm.gmm_tile_width(m, n, H100_SMS) == (256 if tiles256 >= 3 * H100_SMS else 128)


def test_tile_order_walks_row_groups_column_by_column():
    """Within a group of ``TILE_GROUP_M`` row tiles the row tile moves
    fastest, so concurrent blocks share a column block of the bank and a
    group's rows of x; the last group may be short."""
    order = gm.tile_order(10, 3)
    g = gm.TILE_GROUP_M
    assert order[:g] == [(i, 0) for i in range(g)]
    assert order[g : 2 * g] == [(i, 1) for i in range(g)]
    assert order[3 * g : 3 * g + 2] == [(g, 0), (g + 1, 0)]
    assert order[-1] == (9, 2)


# tgmm's persistent walk: (K, N, tile width or None for tgmm_tile_width's,
# M) of each weight gradient's result [8, K, N]
TGMM_SCHEDULE_SHAPES = {
    "gate_up_train": (2048, 8192, None, 17_408),
    "down_train": (8192, 2048, None, 17_408),
    "small_ragged_k": (208, 272, 128, 1024),
    "k_under_one_chunk": (48, 512, 128, 1024),
}


@pytest.mark.parametrize("routing", ["balanced", "one_expert", "two_empty", "large_tail"])
@pytest.mark.parametrize("shape", list(TGMM_SCHEDULE_SHAPES))
def test_tgmm_schedule_writes_every_tile_once(shape, routing):
    """Every (expert, K-tile, N-tile) is taken exactly once, by one block
    of a grid of min(tiles, SMs), the blocks' shares within one tile of
    each other; an empty expert's tiles too (they sum no row and write
    zeros). Each tile sums exactly its expert's rows, 64 a chunk, so every
    row, the tail past the last real group included, reaches every
    (K-tile, N-tile) of one expert: the one whose group holds it."""
    k, n, width, m = TGMM_SCHEDULE_SHAPES[shape]
    E = 8
    width = width or gm.tgmm_tile_width(k, n, E, H100_SMS)
    k_tiles, n_tiles = -(-k // gm.ALIGN), -(-n // width)
    order = gm.tgmm_tile_order(E, k_tiles, n_tiles)
    assert sorted(order) == [(e, i, j) for e in range(E) for i in range(k_tiles)
                             for j in range(n_tiles)]
    assert order[: k_tiles * n_tiles] == [(0, kt, nt) for kt, nt in gm.tile_order(k_tiles, n_tiles)]
    grid = min(len(order), H100_SMS)
    shares = [len(order[b::grid]) for b in range(grid)]
    assert max(shares) - min(shares) <= 1 and sum(shares) == len(order)
    offs = _offsets(m, _routing_counts(m, routing)).tolist()
    experts = gm.group_of_tile(m, torch.tensor(offs)).tolist()
    summed = {}  # (K-tile, N-tile) -> {64-row chunk start: expert}
    for e, kt, nt in order:
        rows = gm.tgmm_tile_rows(offs, e)
        assert len(rows) == (offs[e + 1] - offs[e]) // 64  # 0 for an empty expert
        for r in rows:
            assert (r, kt, nt) not in summed
            summed[(r, kt, nt)] = e
    for kt in range(k_tiles):
        for nt in range(n_tiles):
            assert [summed[(r, kt, nt)] for r in range(0, m, 64)] == [
                experts[r // gm.ALIGN] for r in range(0, m, 64)]


def test_tgmm_tile_width_follows_the_waves_of_the_card():
    """256-wide tiles at the training shapes (4,096 tiles of 8 experts);
    128 where 256-wide tiles of every expert's [K, N] would fill fewer
    than three waves of 132 SMs."""
    assert gm.tgmm_tile_width(2048, 8192, 8, H100_SMS) == 256
    assert gm.tgmm_tile_width(8192, 2048, 8, H100_SMS) == 256
    assert gm.tgmm_tile_width(256, 512, 4, H100_SMS) == 128  # 8 tiles
    assert gm.tgmm_tile_width(48, 272, 4, H100_SMS) == 128
    for k in (16, 48, 128, 208, 2048):
        for n in (16, 272, 2048, 8192):
            for e in (1, 4, 8):
                tiles256 = e * -(-k // 128) * -(-n // 256)
                assert gm.tgmm_tile_width(k, n, e, H100_SMS) == (
                    256 if tiles256 >= 3 * H100_SMS else 128)
