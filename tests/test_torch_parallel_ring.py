"""The port's ring attention against the JAX package's at context 4.

JAX's ``ring_attention`` runs on four virtual CPU devices under a mesh
with ``context=4``; the port's runs on four gloo ranks, each holding its
block of the sequence, and in one process as the loopback ring. Cases:
plain and zigzag layouts, causal and not, with and without segment ids;
the output and the gradients of q, k and v (of ``sum(out · g)`` for a
fixed random ``g``). float32; held to rtol 1e-5 and atol 2e-6 (the block
sums run in another order).
"""

import functools
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig
from odh_kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh
from odh_kubeflow_tpu_torch.ops import flash_attention as fa
from odh_kubeflow_tpu_torch.parallel import mesh as tmesh
from odh_kubeflow_tpu_torch.parallel import ring_attention as tring
from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks

# the module: the package re-exports the function under the same name
jring = importlib.import_module("odh_kubeflow_tpu.parallel.ring_attention")
C = 4
B, S, HQ, HKV, HD = 2, 32, 4, 2, 16
TOL = dict(rtol=1e-5, atol=2e-6)
CASES = list(itertools.product(("plain", "zigzag"), (True, False), (False, True)))


def _case_id(case):
    layout, causal, seg = case
    return f"{layout}-{'causal' if causal else 'full'}-{'seg' if seg else 'noseg'}"


def _inputs(layout, seg, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, HQ, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, HD)).astype(np.float32)
    g = rng.standard_normal((B, S, HQ, HD)).astype(np.float32)
    ids = None
    if seg:  # documents that cross block boundaries, one row ragged
        ids = np.stack([(np.arange(S) >= 11) + (np.arange(S) >= 23),
                        (np.arange(S) >= 5).astype(np.int64)]).astype(np.int32) + 1
    arrays = [q, k, v, g] + ([ids] if seg else [])
    if layout == "zigzag":  # the caller's permutation, JAX's own
        arrays = [np.array(jring.zigzag_permute(jnp.asarray(a), C)) for a in arrays]
    return arrays[:4], (arrays[4] if seg else None)


@functools.cache  # the loopback test asks for the cases the ranks' test did
def _jax_ring(layout, causal, seg):
    (q, k, v, g), ids = _inputs(layout, seg)
    mesh = jbuild_mesh(JMeshConfig(context=C), jax.devices()[:C])

    def loss(q, k, v):
        out = jring.ring_attention(q, k, v, causal=causal, layout=layout,
                                   segment_ids=None if ids is None else jnp.asarray(ids))
        return jnp.sum(out * g), out

    with jax.set_mesh(mesh):
        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


def _port_ranks(rank, world, inputs, out_path):
    """Every case on this rank's block; rank 0 saves the gathered output
    and gradients."""
    mesh = tmesh.build_mesh(tmesh.MeshConfig(context=world), device="cpu")
    spec = tmesh.P(None, tmesh.AXIS_CONTEXT)
    results = {}
    for (layout, causal, seg), ((q, k, v, g), ids) in zip(CASES, inputs):
        local = lambda a: tmesh.local_shard(torch.from_numpy(a), mesh, spec).contiguous()  # noqa: E731
        q, k, v = (local(a).requires_grad_() for a in (q, k, v))
        out = tring.ring_attention(q, k, v, mesh=mesh, causal=causal, layout=layout,
                                   segment_ids=None if ids is None else local(ids))
        grads = torch.autograd.grad((out * local(g)).sum(), (q, k, v))
        results[(layout, causal, seg)] = [
            tmesh.gather_full(t.detach(), mesh, spec).numpy() for t in (out, *grads)
        ]
    if rank == 0:
        torch.save(results, out_path)


def _collective_ranks(rank, world, out_path):
    """Each collective's forward and backward on this rank, for a loss
    ``sum(w · f(x))`` with rank-dependent x and w; rank 0 saves them."""
    from odh_kubeflow_tpu_torch.parallel import collectives as col

    group = torch.distributed.group.WORLD
    got = {}
    for name in ("all_gather", "gather_to_replicated", "reduce_scatter", "all_reduce",
                 "copy_to_group", "scatter_to_group"):
        x = (torch.arange(8.0) + 10 * rank).reshape(4, 2).requires_grad_()
        y = getattr(col, name)(x, group, 0) if name not in ("all_reduce", "copy_to_group") \
            else getattr(col, name)(x, group)
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) + rank
        (gx,) = torch.autograd.grad((y * w).sum(), x)
        got[name] = (y.detach(), gx)
    ex = col.ring_exchange([torch.full((2,), float(rank))], group)
    got["ring_exchange"] = ex.wait()[0]
    gathered = [None] * world
    torch.distributed.all_gather_object(gathered, got)
    if rank == 0:
        torch.save(gathered, out_path)


def test_collectives_forward_and_backward_on_gloo_ranks(tmp_path):
    """What each wrapper computes, and its backward, on 4 ranks: rank r's
    x is ``arange(8).reshape(4, 2) + 10 r`` and its loss weights ``w``
    are ``arange + r`` over the output."""
    out = tmp_path / "col.pt"
    spawn_cpu_ranks(_collective_ranks, C, str(out), rendezvous_dir=str(tmp_path))
    got = torch.load(out, weights_only=False)
    xs = [(torch.arange(8.0) + 10 * r).reshape(4, 2) for r in range(C)]
    full = torch.cat(xs)  # [16, 2]
    for r in range(C):
        g = got[r]
        w = lambda shape: torch.arange(float(np.prod(shape))).reshape(shape) + r  # noqa: E731
        w_of = lambda s, rank: torch.arange(float(np.prod(s))).reshape(s) + rank  # noqa: E731
        # all_gather: everyone's x; backward reduce-scatters every rank's w
        assert torch.equal(g["all_gather"][0], full)
        assert torch.equal(g["all_gather"][1],
                           sum(w_of((16, 2), q) for q in range(C))[4 * r:4 * r + 4])
        # gather_to_replicated: the same gather; backward keeps this rank's slice
        assert torch.equal(g["gather_to_replicated"][0], full)
        assert torch.equal(g["gather_to_replicated"][1], w((16, 2))[4 * r:4 * r + 4])
        # reduce_scatter: row r of the sum; backward gathers every rank's w
        assert torch.equal(g["reduce_scatter"][0], sum(xs)[r:r + 1])
        assert torch.equal(g["reduce_scatter"][1], torch.cat([w_of((1, 2), q) for q in range(C)]))
        # all_reduce (g): the sum, identity backward; copy_to_group (f): the reverse
        assert torch.equal(g["all_reduce"][0], sum(xs))
        assert torch.equal(g["all_reduce"][1], w((4, 2)))
        assert torch.equal(g["copy_to_group"][0], xs[r])
        assert torch.equal(g["copy_to_group"][1], sum(w_of((4, 2), q) for q in range(C)))
        # scatter_to_group: this rank's row; backward gathers the rows' gradients
        assert torch.equal(g["scatter_to_group"][0], xs[r][r:r + 1])
        assert torch.equal(g["scatter_to_group"][1], torch.cat([w_of((1, 2), q) for q in range(C)]))
        assert torch.equal(g["ring_exchange"], torch.full((2,), float((r - 1) % C)))


def test_ring_over_gloo_ranks_matches_jax_ring(tmp_path):
    out = tmp_path / "port.pt"
    inputs = [_inputs(layout, seg) for layout, _, seg in CASES]
    spawn_cpu_ranks(_port_ranks, C, inputs, str(out), rendezvous_dir=str(tmp_path))
    got = torch.load(out, weights_only=False)
    for case in CASES:
        want = _jax_ring(*case)
        for name, g, w in zip(("out", "dq", "dk", "dv"), got[case], want):
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"{_case_id(case)} {name}")


@pytest.mark.parametrize("case", [c for c in CASES if c[2]], ids=_case_id)
def test_loopback_ring_matches_jax_ring_and_counts_live_pairs(case, monkeypatch):
    """The single-process loopback (the card check's driver) runs the same
    block math: it equals JAX's ring, and calls each plain block kernel
    exactly ``live_pairs`` times in each direction."""
    layout, causal, seg = case
    (q, k, v, g), ids = _inputs(layout, seg)
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for name, attr in (("fwd", "flash_fwd_reference"), ("dq", "flash_dq_reference"),
                       ("dkv", "flash_dkv_reference")):
        fn = getattr(fa, attr)
        monkeypatch.setattr(fa, attr, lambda *a, _fn=fn, _n=name, **kw: (
            calls.__setitem__(_n, calls[_n] + 1), _fn(*a, **kw))[1])
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tring.loopback_ring_attention(q, k, v, num_ranks=C, causal=causal, layout=layout,
                                        segment_ids=torch.from_numpy(ids))
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (q, k, v))
    want = _jax_ring(layout, causal, seg)
    for name, t, w in zip(("out", "dq", "dk", "dv"), (out, *grads), want):
        np.testing.assert_allclose(t.detach().numpy(), w, **TOL, err_msg=name)
    n = tring.live_pairs(C, layout, causal)
    assert calls == {"fwd": n, "dq": n, "dkv": n}
    assert n == {("plain", True): C * (C + 1) // 2}.get((layout, causal), C * C)


def test_zigzag_permute_round_trip_matches_jax():
    x = np.arange(2 * 48 * 3).reshape(2, 48, 3)
    got = tring.zigzag_permute(torch.from_numpy(x), C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jring.zigzag_permute(jnp.asarray(x), C)))
    np.testing.assert_array_equal(tring.zigzag_unpermute(got, C).numpy(), x)
    for i in range(C):
        np.testing.assert_array_equal(
            tring._block_positions(i, 48 // C, "zigzag", C).numpy(),
            np.asarray(jring._block_positions(i, 48 // C, "zigzag", C)),
        )
    with pytest.raises(ValueError):
        tring.zigzag_permute(torch.zeros(1, 12), 4)  # 12 is not a multiple of 2C


def test_ring_without_context_axis_is_single_device_attention():
    (q, k, v, _), ids = _inputs("plain", True)
    q, k, v, ids = (torch.from_numpy(a) for a in (q, k, v, ids))
    from odh_kubeflow_tpu_torch.ops.attention import dense_attention

    np.testing.assert_array_equal(
        tring.ring_attention(q, k, v, segment_ids=ids).numpy(),
        dense_attention(q, k, v, causal=True, segment_ids=ids).numpy(),
    )
    with pytest.raises(ValueError):
        tring.loopback_ring_attention(q, k, v, num_ranks=C, layout="diagonal")
