"""Device mesh over the process group's ranks (counterpart of
``parallel/mesh.py``).

Axis convention (the "How to Scale Your Model" recipe), as in the JAX
package:

- ``data``    — pure data parallelism (gradients all-reduced);
- ``fsdp``    — data parallelism with parameters and optimizer state
  sharded (ZeRO-3): each layer's weights are all-gathered at use, inside
  its rematerialised region, and the gather's backward reduce-scatters
  the gradient;
- ``tensor``  — Megatron tensor parallelism inside a layer (heads and the
  MLP's intermediate dim split, the row-parallel products summed);
- ``context`` — sequence parallelism (``parallel/ring_attention.py``);
- ``expert`` — expert parallelism: a grouped MoE's banks split by expert
  (``models/moe.py``), the axis a data axis for the dense layers;
- ``pipe`` — pipeline parallelism (``parallel/pipeline.py``): the layer
  stack split into stages, activations passed point to point between a
  rank and its ``neighbours`` along the axis.

One process drives one device. ``build_mesh`` lays a ``MeshConfig`` over
the ranks of the default process group row-major in ``AXIS_ORDER`` with
``torch.distributed.device_mesh.init_device_mesh``, and keeps the
process group of every axis set a collective of the trainer spans. A
``P`` spec names, per tensor dim, the mesh axes it is split over, as a
JAX ``PartitionSpec`` does: a tuple of names splits the dim over their
product, the first name major. Where JAX's GSPMD derives each collective
from the specs, the port's model code issues them itself
(``parallel/collectives.py``); an axis of size 1 issues none.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from odh_kubeflow_tpu_torch.utils.device import resolve_device

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_CONTEXT = "context"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipe"

# earlier axes change slowest across the ranks: the bandwidth-hungry axes
# (tensor, context) last, so they land on neighbouring ranks (one host's
# NVLink), and data, which tolerates the slowest links, first
AXIS_ORDER = (
    AXIS_DATA,
    AXIS_PIPE,
    AXIS_FSDP,
    AXIS_EXPERT,
    AXIS_CONTEXT,
    AXIS_TENSOR,
)

# a [batch, seq] token batch: batch over (data, fsdp, expert), sequence
# over context; the loss and the gradients of replicated leaves sum over
# all four
BATCH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT)
TOKEN_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_CONTEXT)


class P(tuple):
    """A sharding spec: one entry per tensor dim, each None (replicated),
    an axis name, or a tuple of axis names; dims past the spec's length
    are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry, in order (major first)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(spec) -> set:
    """Every axis a spec splits some dim over."""
    return {a for e in spec for a in entry_axes(e)}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. Its product must equal the number of ranks."""

    data: int = 1
    pipe: int = 1
    fsdp: int = 1
    expert: int = 1
    context: int = 1
    tensor: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (
            self.data,
            self.pipe,
            self.fsdp,
            self.expert,
            self.context,
            self.tensor,
        )

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    def validate(self, n_devices: int) -> None:
        if self.num_devices != n_devices:
            raise ValueError(
                f"mesh shape {self.shape} = {self.num_devices} devices, "
                f"but {n_devices} devices are available"
            )


def local_mesh_config(n_devices: Optional[int] = None) -> MeshConfig:
    """Default mesh for the ranks there are: everything on fsdp."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return MeshConfig(fsdp=n_devices)


class Mesh:
    """A ``MeshConfig`` laid over the process group: this rank's
    coordinates, the ``DeviceMesh``, and the process group of each axis
    set the trainer reduces over (None where the set has size 1)."""

    def __init__(self, config: MeshConfig, device: torch.device, device_mesh, rank: int):
        self.config = config
        self.device = device
        self.device_mesh = device_mesh
        self.rank = rank
        self.sizes = dict(zip(AXIS_ORDER, config.shape))
        coords, r = {}, self.rank
        for axis, n in reversed(list(self.sizes.items())):
            coords[axis], r = r % n, r // n
        self.coords = {a: coords[a] for a in AXIS_ORDER}
        self._groups: dict[tuple, object] = {}

    def size(self, axes) -> int:
        return math.prod(self.sizes[a] for a in entry_axes(axes))

    def index(self, axes) -> int:
        """This rank's chunk of a dim split over ``axes`` (first major)."""
        i = 0
        for a in entry_axes(axes):
            i = i * self.sizes[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of this rank's peers along ``axes``, ranked
        in the order of their coordinates; None when they are only this
        rank (no collective needed). Created on first use: every rank
        asks for the same sets in the same order."""
        axes = tuple(a for a in AXIS_ORDER if a in entry_axes(axes) and self.sizes[a] > 1)
        if not axes:
            return None
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = self.device_mesh.get_group(axes[0])
            else:
                self._groups[axes] = _subgroup(self.config, axes)
        return self._groups[axes]

    def peer(self, axis: str, index: int) -> int:
        """The global rank at coordinate ``index`` of ``axis`` whose other
        coordinates are this rank's."""
        coords = dict(self.coords, **{axis: index})
        r = 0
        for a in AXIS_ORDER:
            r = r * self.sizes[a] + coords[a]
        return r

    def neighbours(self, axis: str) -> tuple[Optional[int], Optional[int]]:
        """The global ranks before and after this one along ``axis`` (None
        past either end): a pipeline stage's previous and next stages."""
        i, n = self.coords[axis], self.sizes[axis]
        return (self.peer(axis, i - 1) if i > 0 else None,
                self.peer(axis, i + 1) if i < n - 1 else None)

    def __repr__(self) -> str:
        return f"Mesh({self.config}, rank={self.rank}, device={self.device})"


def _subgroup(config: MeshConfig, axes: tuple):
    """This rank's group of the partition of all ranks by their
    coordinates off ``axes``: each group holds the ranks that differ only
    along ``axes``."""
    shape = config.shape
    grid = torch.arange(config.num_devices).reshape(shape)
    keep = [AXIS_ORDER.index(a) for a in axes]
    rest = [d for d in range(len(shape)) if d not in keep]
    rows = grid.permute(*rest, *keep).reshape(-1, math.prod(shape[d] for d in keep))
    mine, _ = dist.new_subgroups_by_enumeration([r.tolist() for r in rows])
    return mine


def build_mesh(config: Optional[MeshConfig] = None, device="cuda") -> Mesh:
    """The mesh over the default process group (which the caller
    initialised: ``utils.distributed.launch_local`` (one process a card
    of each pod), ``initialize_from_env``, or ``init_process_group``
    with its address, world size and rank). On the
    card each rank drives its current CUDA device."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialised process group: start the "
            "pod's processes with utils.distributed.launch_local(fn), or "
            "call utils.distributed.initialize_from_env(device, local_rank, "
            "local_processes) or torch.distributed.init_process_group first"
        )
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if config is None:
        config = local_mesh_config()
    config.validate(dist.get_world_size())
    dm = init_device_mesh(dev.type, config.shape, mesh_dim_names=AXIS_ORDER)
    return Mesh(config, dev, dm, dist.get_rank())


def batch_spec() -> P:
    """The spec of a ``[batch, seq]`` token batch. The expert axis doubles
    as a data axis for the dense layers."""
    return P(BATCH_AXES, AXIS_CONTEXT)


def local_shard(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's block of a full tensor under ``spec`` (a view)."""
    for d, e in enumerate(spec):
        n = mesh.size(e)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split over {e} ({n})")
        c = x.shape[d] // n
        x = x.narrow(d, mesh.index(e) * c, c)
    return x


def gather_full(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """The full tensor from every rank's shard (no autograd)."""
    from odh_kubeflow_tpu_torch.parallel.collectives import gather_dim

    for d, e in enumerate(spec):
        for a in reversed(entry_axes(e)):  # minor axis first
            x = gather_dim(x, mesh.group(a), d)
    return x


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    return tree


def shard_tree(tree, mesh: Mesh, specs):
    """This rank's shard of every tensor leaf of ``tree`` (a matching
    tree of ``P`` specs), as a new contiguous tensor on the mesh's device
    (never the leaf itself: the shards are updated in place); other
    leaves pass through."""
    return _map_specs(
        lambda t, s: local_shard(t, mesh, s).to(mesh.device).clone(
            memory_format=torch.contiguous_format
        ),
        tree,
        specs,
    )


def gather_tree(tree, mesh: Mesh, specs):
    """Every sharded tensor leaf gathered whole (a collective: every rank
    calls it)."""
    return _map_specs(lambda t, s: gather_full(t.detach(), mesh, s), tree, specs)
