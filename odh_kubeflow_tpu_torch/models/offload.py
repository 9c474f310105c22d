"""Remat residuals parked in host memory: remat policy "attn_offload"
(JAX's ``save_and_offload_only_these_names`` with
``offload_dst="pinned_host"``).

A layer under "attn_offload" is a ``torch.utils.checkpoint`` region whose
``context_fn`` is :func:`contexts`. The ops "attn" would save (the flash
forward's ``(out, lse2)``, the MoE expert op's ``(y, g)``, the tagged
activations) run once in the forward, and their outputs are copied to
the host while the forward goes on with the device tensors; the
recompute in the backward gets those copies back in place of running
the op again. Selective checkpointing's own cache keeps what it saves
on the device, so the parking is a dispatch mode of its own, with the
same keep rule.

On the card the copies go to pinned memory on a side stream, ordered by
events: device → host after the op's kernel, host → device when a
region's recompute begins, for that region (if not yet fetched) and for
the region recorded just before it, the next one the backward reaches.
Nothing in the forward waits on the host. On the CPU, "host" is the CPU
and the copy is a plain clone. Either way the backward reads the same
bits as under "attn".

Under :func:`held_on_device` a region keeps on the device what it would
park, as "attn" does: for a forward whose backward follows at once (1F1B's
recompute at B), where a round trip through the host frees nothing.

``parked_bytes`` counts the bytes parked since the caller last zeroed it.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only

# bytes copied to the host since the last reset (plain counter: the caller zeroes it)
parked_bytes = 0

_last = None  # weakref to the region that parked last
_held = False  # under held_on_device()
_side_streams: dict = {}


def _side_stream(device: torch.device):
    stream = _side_streams.get(device)
    if stream is None:
        stream = _side_streams[device] = torch.cuda.Stream(device)
    return stream


def _to_host(t: torch.Tensor) -> torch.Tensor:
    global parked_bytes
    parked_bytes += t.numel() * t.element_size()
    if t.device.type != "cuda":
        return t.detach().clone()
    main = torch.cuda.current_stream(t.device)
    side = _side_stream(t.device)
    side.wait_stream(main)  # after the kernel that wrote t
    with torch.cuda.stream(side):
        host = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device="cpu",
                                   pin_memory=True)
        host.copy_(t, non_blocking=True)
    t.record_stream(side)  # t's memory is not reused before the copy is done
    return host


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    main = torch.cuda.current_stream(device)
    side = _side_stream(device)
    out = torch.empty_strided(host.size(), host.stride(), dtype=host.dtype, device=device)
    side.wait_stream(main)  # out's block is free on main's timeline up to here
    with torch.cuda.stream(side):
        out.copy_(host, non_blocking=True)
    out.record_stream(side)
    return out


class _Region:
    """One checkpointed call's parked outputs, in call order."""

    def __init__(self):
        self.host: list = []
        self.device = None  # the copies brought back, once fetched
        self.card = None  # the CUDA device the outputs came from, if any
        self.ready = None  # the event after which they are back there
        self.taken = 0
        self.prev = None  # weakref to the region that parked before this one

    def park(self, out):
        global _last
        if not self.host:
            self.prev, _last = _last, weakref.ref(self)
        self.host.append(tree_map_only(torch.Tensor, self._to_host, out))

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            self.card = t.device
        return _to_host(t)

    def fetch(self) -> None:
        """Start bringing the parked outputs back (once)."""
        if self.device is not None:
            return
        trees, self.host = self.host, []
        if self.card is None:
            self.device = trees
            return
        self.device = [tree_map_only(torch.Tensor, lambda t: _to_device(t, self.card), tree)
                       for tree in trees]
        self.ready = _side_stream(self.card).record_event()

    def begin_replay(self) -> None:
        before = self.prev() if self.prev is not None else None
        self.fetch()
        if self.ready is not None:
            torch.cuda.current_stream(self.card).wait_event(self.ready)
        self.taken = 0
        if before is not None:
            before.fetch()  # the next region the backward reaches

    def take(self):
        if self.device is None or self.taken >= len(self.device):
            raise RuntimeError("attn_offload: the recompute asked for more parked outputs "
                               "than the forward parked (a second backward?)")
        out = self.device[self.taken]
        self.device[self.taken] = None
        self.taken += 1
        return out


class _ParkingMode(TorchDispatchMode):
    def __init__(self, region: _Region, keep: Callable, replay: bool):
        super().__init__()
        self.region, self.keep, self.replay = region, keep, replay

    def __enter__(self):
        if self.replay:
            self.region.begin_replay()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.keep(func, args):
            return func(*args, **kwargs)
        if self.replay:
            return self.region.take()
        out = func(*args, **kwargs)
        self.region.park(out)
        return out


@contextlib.contextmanager
def held_on_device():
    """Checkpoint calls made inside keep on the device what they would park."""
    global _held
    before, _held = _held, True
    try:
        yield
    finally:
        _held = before


def contexts(keep: Callable, on_device: Callable):
    """``(forward context, recompute context)`` for one checkpoint call
    (``torch.utils.checkpoint``'s ``context_fn``): ops for which
    ``keep(func, args)`` holds are parked in the forward and replayed in
    the recompute; under :func:`held_on_device`, ``on_device()``'s pair
    (the same ops saved on the device)."""
    if _held:
        return on_device()
    region = _Region()
    return _ParkingMode(region, keep, replay=False), _ParkingMode(region, keep, replay=True)
