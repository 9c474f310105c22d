"""Autograd-aware collectives over a mesh axis's process group.

JAX's GSPMD inserts these by itself from the sharding specs; the port's
model code calls them where they belong. Each is a
``torch.autograd.Function`` over ``torch.distributed`` with the backward
its use needs, and each is the identity on a group of None (an axis of
size 1 issues no collective, as GSPMD issues none):

- ``all_gather``: gather along a dim; backward reduce-scatters (FSDP:
  every rank's batch shard contributes to the whole weight's gradient);
- ``gather_to_replicated``: gather along a dim for a consumer that every
  rank of the group computes alike; backward keeps this rank's slice;
- ``reduce_scatter``: sum, keep this rank's slice; backward gathers;
- ``all_reduce`` (Megatron's g): sum; backward the identity, since the
  consumers of the sum are replicated;
- ``copy_to_group`` (Megatron's f): the identity; backward sums the
  gradients of the group's partitioned consumers;
- ``psum``: sum; backward sums too, for a total that every rank's loss
  share reads alike (the MoE aux's balance statistics);
- ``scatter_to_group``: keep this rank's slice of a replicated tensor;
  backward gathers the slices' gradients;
- ``ring_exchange``: send to the next rank of the group, receive from the
  previous (``batch_isend_irecv``), for the context ring.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` in group-rank order (no autograd)."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    if dist.get_backend(group) == "gloo":  # gloo has no reduce-scatter
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x.chunk(n, dim)[dist.get_rank(group)].contiguous()
    parts = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _slice_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    return x.chunk(n, dim)[dist.get_rank(group)].contiguous()


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


class _GatherToReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice_dim(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    # the loss is the sum of the ranks' shares and each share reads the
    # total, so the gradient by one rank's addend is the sum over the
    # ranks of each share's gradient by the total: an all-reduce again
    # (``all_reduce``'s identity backward is right only where one share
    # reads the total, the rest reading copies that carry no gradient)
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.group, ctx.dim), None, None


def all_gather(x, group, dim: int = 0):
    return x if group is None else _AllGather.apply(x, group, dim)


def gather_to_replicated(x, group, dim: int = 0):
    return x if group is None else _GatherToReplicated.apply(x, group, dim)


def reduce_scatter(x, group, dim: int = 0):
    return x if group is None else _ReduceScatter.apply(x, group, dim)


def all_reduce(x, group):
    return x if group is None else _AllReduce.apply(x, group)


def psum(x, group):
    return x if group is None else _Psum.apply(x, group)


def copy_to_group(x, group):
    return x if group is None else _CopyToGroup.apply(x, group)


def scatter_to_group(x, group, dim: int = 0):
    return x if group is None else _ScatterToGroup.apply(x, group, dim)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group (no gradient)."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group (no gradient)."""
    return _all_reduce(x.detach(), group)


class _Exchange:
    """An exchange in flight: ``wait()`` returns the received tensors."""

    def __init__(self, requests, sent, received):
        self._requests, self._sent, self._received = requests, sent, received

    def wait(self) -> list:
        for req in self._requests:
            req.wait()
        self._sent = None  # the sends are done: their buffers may go
        return self._received


def ring_exchange(tensors, group) -> _Exchange:
    """Start sending ``tensors`` to the next rank of ``group`` and
    receiving the previous rank's into fresh buffers."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    sent = [t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in sent]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in sent]
    ops += [dist.P2POp(dist.irecv, b, prv, group) for b in received]
    return _Exchange(dist.batch_isend_irecv(ops), sent, received)
