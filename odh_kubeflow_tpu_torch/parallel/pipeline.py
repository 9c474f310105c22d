"""Pipeline parallelism over the ``pipe`` mesh axis: GPipe and 1F1B
(counterpart of ``parallel/pipeline.py``).

Stage ``s`` of ``S`` holds layers ``[s·L/S, (s+1)·L/S)`` of every
``[L, ...]``-stacked leaf (the trainer's specs shard them over ``pipe``),
the batch splits into ``M`` contiguous microbatches, and each stage runs
the same ``stage_fn`` over its own layers, shape-preserving on the
microbatch. Every other axis (data, fsdp, tensor, context, expert) runs
inside the stage as it does unpipelined: its collectives span ranks of one
pipe coordinate, which all run the same schedule.

A schedule is built once, as data: ``schedule(S, M, kind)`` is the list of
ticks, each the ``Action``s (stage, "F" or "B", microbatch) run at that
tick. A message sent at one tick is read at the next.

- ``"gpipe"``: stage s runs F(m) at tick ``s + m``, then, after all
  forwards, B(m) at tick ``(M+S-1) + (S-1-s) + m``; every stage holds its
  M microbatches' residuals until their B.
- ``"1f1b"``: stage s runs F(m) at tick ``s + 2m`` and B(m) at tick
  ``2S-1-s+2m``, over ``2(M+S-1)`` ticks, at most one action a tick; an
  input is stored at F(m) and freed at B(m), so a stage holds at most
  ``min(S, M)`` of them (``max_in_flight``), and B recomputes the stage
  forward from the stored input. The loss must be computable per
  microbatch on the last stage (``head_fn``), which is what lets B(m)
  start one tick after F(m).

Two transports run a schedule's actions with the same arithmetic:

- the process-group driver (``pipeline_apply``, ``pipeline_train_1f1b``):
  each rank runs its own stage's actions and, after each tick, exchanges
  that tick's activations (down) and cotangents (up) with its pipe
  neighbours (the ranks with the same coordinates on every other axis) in
  one ``batch_isend_irecv``;
- the loopback (``loopback_pipeline_apply``,
  ``loopback_pipeline_train_1f1b``): one process runs every stage's
  actions in tick order on the whole ``[L, ...]`` stack, a dict keyed by
  (kind, stage, microbatch) standing in for the wire (the card, which has
  one GPU, and the tests).

A backward action is ``torch.autograd.grad`` of one (stage, microbatch)
forward, its layer gradients summed over the microbatches in float32 in
schedule order. GPipe's autograd runs through ``_GPipe``, whose backward
runs the B ticks. Activations travel in the model's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from odh_kubeflow_tpu_torch.parallel.mesh import AXIS_PIPE

Params = Any
KINDS = ("gpipe", "1f1b")


@dataclasses.dataclass(frozen=True)
class Action:
    stage: int
    op: str  # "F" (forward) or "B" (backward)
    microbatch: int


def schedule(num_stages: int, num_microbatches: int, kind: str) -> list[list[Action]]:
    """The ticks of a schedule, each the list of actions run at it, over
    ``2(M+S-1)`` ticks for both kinds."""
    S, M = num_stages, num_microbatches
    if kind not in KINDS:
        raise ValueError(f"unknown schedule {kind!r}; expected one of {KINDS}")
    ticks: list[list[Action]] = [[] for _ in range(2 * (M + S - 1))]
    for s in range(S):
        for m in range(M):
            if kind == "gpipe":
                f, b = s + m, (M + S - 1) + (S - 1 - s) + m
            else:
                f, b = s + 2 * m, 2 * S - 1 - s + 2 * m
            ticks[f].append(Action(s, "F", m))
            ticks[b].append(Action(s, "B", m))
    return ticks


def max_in_flight(ticks: list[list[Action]], stage: int) -> int:
    """The most microbatches ``stage`` holds between their F and their B."""
    held = most = 0
    for tick in ticks:
        for a in tick:
            if a.stage == stage:
                held += 1 if a.op == "F" else -1
                most = max(most, held)
    return most


# ---------------------------------------------------------------------------
# trees


def _flatten(tree, path=()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs of a dict tree in sorted key order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (k,))]
    return [(path, tree)]


def _rebuild(tree, leaves: dict):
    """``tree`` with each tensor leaf replaced by ``leaves[path]``."""

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        return leaves.get(path, t)

    return walk(tree, ())


def _slice_layers(tree, start: int, n: int):
    """Layers ``[start, start + n)`` of every tensor leaf (views)."""

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t.narrow(0, start, n) if isinstance(t, torch.Tensor) else t

    return walk(tree)


def _layer_dim(tree, num_stages: int) -> int:
    dims = {t.shape[0] for _, t in _flatten(tree) if isinstance(t, torch.Tensor)}
    for L in sorted(dims):
        if L % num_stages:
            raise ValueError(f"layer dim {L} does not divide into {num_stages} stages")
    if len(dims) != 1:
        raise ValueError(f"layer leaves disagree on the layer dim: {sorted(dims)}")
    return dims.pop()


def _split(x: torch.Tensor, M: int) -> list[torch.Tensor]:
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    return list(x.chunk(M, 0))


def _aux_at(aux, m: int):
    if aux is None:
        return None
    return {k: _aux_at(v, m) for k, v in aux.items()} if isinstance(aux, dict) else aux[m]


def _call(fn, params, x, aux_m):
    return fn(params, x) if aux_m is None else fn(params, x, aux_m)


def _sum_in_order(xs: list[torch.Tensor]) -> torch.Tensor:
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


# ---------------------------------------------------------------------------
# transports


class _Loopback:
    """The wire of the one-process driver: a message waits in a dict."""

    def __init__(self):
        self._box: dict = {}

    def send(self, kind: str, stage: int, m: int, t: torch.Tensor) -> None:
        self._box[(kind, stage, m)] = t

    def recv(self, kind: str, stage: int, m: int) -> torch.Tensor:
        return self._box.pop((kind, stage, m))

    def end_tick(self, tick: list[Action]) -> None:
        pass

    def sum_over_stages(self, per_stage: list[torch.Tensor]) -> torch.Tensor:
        return _sum_in_order(per_stage)

    def from_stage(self, t, stage: int):
        return t

    def reduce_cotangent(self, g):
        return g


class _GroupWire:
    """The wire of one rank over the mesh's ``pipe`` group: what the rank's
    actions of a tick send is queued, and at the tick's end the queue goes
    out to its neighbours (``Mesh.neighbours``) and what their actions of
    that tick send comes in, in one ``batch_isend_irecv``."""

    _TAGS = {"act": 0, "grad": 1}

    def __init__(self, mesh, like: torch.Tensor):
        self.mesh = mesh
        self.group = mesh.group(AXIS_PIPE)
        self.stage, self.S = mesh.coords[AXIS_PIPE], mesh.sizes[AXIS_PIPE]
        self.prev, self.next = mesh.neighbours(AXIS_PIPE)
        self.shape, self.dtype, self.device = like.shape, like.dtype, like.device
        self._out: list = []
        self._in: dict = {}

    def send(self, kind: str, stage: int, m: int, t: torch.Tensor) -> None:
        self._out.append((kind, stage, t.contiguous()))

    def recv(self, kind: str, stage: int, m: int) -> torch.Tensor:
        return self._in.pop((kind, m))

    def end_tick(self, tick: list[Action]) -> None:
        ops = [dist.P2POp(dist.isend, t, self.next if to > self.stage else self.prev,
                          self.group, self._TAGS[kind])
               for kind, to, t in self._out]
        got = {}
        for a in tick:
            if a.op == "F" and a.stage == self.stage - 1:  # its activation comes down
                kind = "act"
            elif a.op == "B" and a.stage == self.stage + 1:  # its cotangent comes up
                kind = "grad"
            else:
                continue
            buf = torch.empty(self.shape, dtype=self.dtype, device=self.device)
            got[(kind, a.microbatch)] = buf
            peer = self.prev if kind == "act" else self.next
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.group, self._TAGS[kind]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self._out = []
        self._in.update(got)

    def sum_over_stages(self, per_stage: list[torch.Tensor]) -> torch.Tensor:
        """The stages' scalars summed in stage order (every rank gets the
        loopback's sum, bit for bit)."""
        (mine,) = per_stage
        parts = [torch.empty_like(mine) for _ in range(self.S)]
        dist.all_gather(parts, mine.contiguous(), group=self.group)
        return _sum_in_order(parts)

    def from_stage(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        """``stage``'s ``t`` on every rank (the others pass a buffer of its
        shape)."""
        dist.broadcast(t, self.mesh.peer(AXIS_PIPE, stage), group=self.group)
        return t

    def reduce_cotangent(self, g: torch.Tensor) -> torch.Tensor:
        """The sum over the group of a replicated output's cotangents: every
        rank's share of the loss reads the output."""
        g = g.contiguous().clone()
        dist.all_reduce(g, group=self.group)
        return g


# ---------------------------------------------------------------------------
# the runner: a schedule's actions on some of its stages


class _Runner:
    """The actions of ``stages`` (all S on the loopback, the rank's own on
    a process group), fed by ``wire``. ``layers[s]`` is stage s's layer
    tree; the leaves that require grad are differentiated and their
    gradients summed in float32 per stage."""

    def __init__(self, stage_fn, layers: dict, xm: list, aux, with_aux_out: bool, S: int,
                 wire, x_grad: bool):
        self.stage_fn, self.xm, self.aux, self.with_aux = stage_fn, xm, aux, with_aux_out
        self.S, self.M, self.wire = S, len(xm), wire
        self.x_grad = x_grad
        self.layers, self.trained = {}, {}
        for s, tree in layers.items():
            alias = {p: t.detach().requires_grad_(True) for p, t in _flatten(tree)
                     if isinstance(t, torch.Tensor) and t.requires_grad}
            self.layers[s] = _rebuild(tree, alias)
            self.trained[s] = alias
        self.grads = {s: {p: None for p in a} for s, a in self.trained.items()}
        self.aux_acc = {s: None for s in layers}
        self.ys: dict = {}
        self.dxm: dict = {}
        self.dys: dict = {}
        self.saved: dict = {}
        self.head = None

    # -- the per-action work ----------------------------------------------------

    def _stage(self, s: int, x_in: torch.Tensor, m: int, grad: bool):
        x_d = x_in.detach()
        if grad:
            x_d.requires_grad_(s > 0 or self.x_grad)
        with torch.set_grad_enabled(grad):
            out = _call(self.stage_fn, self.layers[s], x_d, _aux_at(self.aux, m))
        out, a = out if self.with_aux else (out, None)
        return x_d, out, a

    def forward(self, a: Action, mode: str) -> None:
        """F(m) on stage s. ``mode``: "keep" (GPipe under autograd: keep
        the graph for B), "store" (1F1B: keep the input, run without
        grad) or "none"."""
        s, m = a.stage, a.microbatch
        x_in = self.xm[m] if s == 0 else self.wire.recv("act", s, m)
        x_d, out, aux_s = self._stage(s, x_in, m, grad=mode == "keep")
        if mode == "keep":
            self.saved[(s, m)] = (x_d, out, aux_s)
        elif mode == "store":
            self.saved[(s, m)] = x_in
        if aux_s is not None:
            v = aux_s.detach().to(torch.float32)
            self.aux_acc[s] = v if self.aux_acc[s] is None else self.aux_acc[s] + v
        out = out.detach()
        if s < self.S - 1:
            self.wire.send("act", s + 1, m, out)
            return
        self.ys[m] = out
        if self.head is not None:
            self.head.step(m, out, _aux_at(self.aux, m), self)

    def backward(self, a: Action, daux: Optional[torch.Tensor]) -> None:
        """B(m) on stage s: the vjp of its forward (kept, or recomputed from
        the stored input) at the cotangent from stage s+1 (the loss's on the
        last stage), layer gradients summed, dx sent to stage s-1."""
        s, m = a.stage, a.microbatch
        g = self.dys.pop(m) if s == self.S - 1 else self.wire.recv("grad", s, m)
        saved = self.saved.pop((s, m))
        if isinstance(saved, tuple):
            x_d, out, aux_s = saved
        else:
            x_d, out, aux_s = self._stage(s, saved, m, grad=True)
        outs, cots = [out], [g]
        if aux_s is not None and daux is not None:
            outs.append(aux_s)
            cots.append(daux.to(aux_s.dtype))
        wanted = list(self.trained[s].values())
        if x_d.requires_grad:
            wanted = [x_d] + wanted
        got = torch.autograd.grad(outs, wanted, cots, allow_unused=True) if wanted else ()
        dx = None
        if x_d.requires_grad:
            dx, got = got[0], got[1:]
        acc = self.grads[s]
        for p, d in zip(acc, got):
            if d is not None:
                d = d.to(torch.float32)
                acc[p] = d if acc[p] is None else acc[p] + d
        if s > 0:
            self.wire.send("grad", s - 1, m, dx)
        elif dx is not None:
            self.dxm[m] = dx

    def run(self, ticks, ops: str, mode: str = "none", daux=None) -> None:
        for tick in ticks:
            for a in tick:
                if a.stage in self.layers and a.op in ops:
                    if a.op == "F":
                        self.forward(a, mode)
                    else:
                        self.backward(a, daux)
            self.wire.end_tick([a for a in tick if a.op in ops])

    # -- results ------------------------------------------------------------------

    def layer_grads(self, s: int) -> dict:
        """Stage s's float32 gradient sums by leaf path (zeros where a
        trained leaf took none)."""
        return {p: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                if self.grads[s][p] is None else self.grads[s][p]
                for p, t in self.trained[s].items()}

    def aux_total(self) -> torch.Tensor:
        """The stage scalars' sum over every (stage, microbatch) pair, on
        every rank (zero without the aux channel: no collective)."""
        zero = torch.zeros((), dtype=torch.float32, device=self.xm[0].device)
        if not self.with_aux:
            return zero
        per = [zero if v is None else v for _, v in sorted(self.aux_acc.items())]
        return self.wire.sum_over_stages(per)

    def output(self, x: torch.Tensor) -> torch.Tensor:
        """The stack's output on every rank: the last stage's microbatches
        (broadcast over the group; the loopback holds them already)."""
        last_here = self.S - 1 in self.layers
        y = torch.cat([self.ys[m] for m in range(self.M)]) if last_here else torch.empty_like(x)
        return self.wire.from_stage(y, self.S - 1)


class _Head:
    """1F1B's loss on the last stage: after F(m), the head's loss, its
    gradients by the head's params (summed in float32) and by the stage's
    output (B(m)'s cotangent), in one vjp."""

    def __init__(self, head_fn, head_params):
        self.fn = head_fn
        alias = {p: t.detach().requires_grad_(True) for p, t in _flatten(head_params)
                 if isinstance(t, torch.Tensor) and t.requires_grad}
        self.params, self.trained = _rebuild(head_params, alias), alias
        self.grads = {p: None for p in alias}
        self.loss = None

    def step(self, m: int, y: torch.Tensor, aux_m, runner: _Runner) -> None:
        y_d = y.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = _call(self.fn, self.params, y_d, aux_m)
        got = torch.autograd.grad(loss, [y_d, *self.trained.values()], allow_unused=True)
        runner.dys[m] = got[0]
        for p, d in zip(self.grads, got[1:]):
            if d is not None:
                d = d.to(torch.float32)
                self.grads[p] = d if self.grads[p] is None else self.grads[p] + d
        v = loss.detach().to(torch.float32)
        self.loss = v if self.loss is None else self.loss + v


def _tensor_leaves(tree) -> list[tuple[tuple, torch.Tensor]]:
    return [(p, t) for p, t in _flatten(tree) if isinstance(t, torch.Tensor)]


def _grad_tree(tree, grads: dict):
    """``tree`` with each tensor leaf's gradient from ``grads`` by path, None
    for a leaf that does not require grad."""
    return _rebuild(tree, {p: grads.get(p) for p, _ in _tensor_leaves(tree)})


def _rank_setup(mesh, x: torch.Tensor, M: int):
    """(stages, this rank's stage, its wire) on ``mesh``'s pipe axis."""
    if mesh is None:
        raise ValueError(f"mesh has no {AXIS_PIPE!r} axis: ()")
    S = mesh.sizes[AXIS_PIPE]
    xm0 = _split(x, M)[0]
    wire = _GroupWire(mesh, xm0) if S > 1 else _Loopback()
    return S, mesh.coords[AXIS_PIPE], wire


def _loopback_stages(layer_params, S: int) -> dict:
    n = _layer_dim(layer_params, S) // S
    return {s: _slice_layers(layer_params, s * n, n) for s in range(S)}


# ---------------------------------------------------------------------------
# GPipe under autograd


class _GPipe(torch.autograd.Function):
    """The GPipe schedule as one differentiable op: the forward runs the F
    ticks keeping each (stage, microbatch) graph, the backward the B ticks.
    Outputs: the stack's output and the summed stage scalars, both the
    whole pipeline's on every rank."""

    @staticmethod
    def forward(ctx, run: dict, x, *leaves):
        runner = run["runner"]
        runner.run(run["ticks"], "F", mode="keep")
        ctx.run = run
        return runner.output(x), runner.aux_total()

    @staticmethod
    def backward(ctx, dy, daux):
        run = ctx.run
        runner = run["runner"]
        dy = runner.wire.reduce_cotangent(dy)
        daux = runner.wire.reduce_cotangent(daux) if runner.with_aux else None
        if runner.S - 1 in runner.layers:
            for m, g in enumerate(dy.chunk(runner.M, 0)):
                runner.dys[m] = g
        runner.run(run["ticks"], "B", daux=daux)
        dx = None
        if runner.dxm:
            dx = torch.cat([runner.dxm[m] for m in range(runner.M)]).to(run["x_dtype"])
        return (None, dx, *run["leaf_grads"](runner))


def _gpipe(stage_fn, stages: dict, layer_params, x, M: int, S: int, aux, with_aux_out: bool,
           wire, stack_grads: bool):
    """GPipe over ``stages`` (stage -> layer tree), differentiable when grad
    mode is on and ``x`` or a leaf of ``layer_params`` requires grad; a
    trained leaf's gradient is its stage's (or, with ``stack_grads``, every
    stage's concatenated: the loopback's whole stack)."""
    trained = [(p, t) for p, t in _tensor_leaves(layer_params) if t.requires_grad]
    runner = _Runner(stage_fn, stages, _split(x, M), aux, with_aux_out, S, wire,
                     x_grad=x.requires_grad)
    ticks = schedule(S, M, "gpipe")
    if not (torch.is_grad_enabled() and (x.requires_grad or trained)):
        runner.run(ticks, "F")
        out = runner.output(x), runner.aux_total()
    else:
        def leaf_grads(r: _Runner) -> list:
            per = [r.layer_grads(s) for s in sorted(stages)]
            return [(torch.cat([g[p] for g in per]) if stack_grads else per[0][p]).to(t.dtype)
                    for p, t in trained]

        run = {"runner": runner, "ticks": ticks, "x_dtype": x.dtype, "leaf_grads": leaf_grads}
        out = _GPipe.apply(run, x, *(t for _, t in trained))
    return out if with_aux_out else out[0]


def pipeline_apply(
    stage_fn: Callable,
    layer_params: Params,  # this rank's stage: leaves [L/S, ...]
    x: torch.Tensor,  # [B, ...], the same on every rank of the pipe group
    *,
    num_microbatches: int,
    aux: Optional[Params] = None,  # leaves [M, ...]: per-microbatch constants
    with_aux_out: bool = False,
    mesh=None,
):
    """Run ``x`` through the pipelined layer stack on this rank's stage;
    returns ``[B, ...]`` on every rank of the pipe group (or ``(y,
    aux_sum)`` with ``with_aux_out``). Differentiable.

    ``stage_fn(stage_layers, x_mb)``, or ``stage_fn(stage_layers, x_mb,
    aux_mb)`` with ``aux``, gets this rank's layers and one microbatch and
    returns its output of the same shape and dtype (and, with
    ``with_aux_out``, a scalar, e.g. the router's load-balancing loss:
    ``aux_sum`` totals it over every (stage, microbatch) pair). Under
    autograd each rank's share of the loss may read ``y`` and ``aux_sum``:
    their cotangents are summed over the group. The gradient of ``x`` lands
    on stage 0 (None on the others), whose input it is: a caller holding
    ``x`` on every stage sums its gradients over the group."""
    S, stage, wire = _rank_setup(mesh, x, num_microbatches)
    _layer_dim(layer_params, 1)
    return _gpipe(stage_fn, {stage: layer_params}, layer_params, x, num_microbatches, S, aux,
                  with_aux_out, wire, stack_grads=False)


def loopback_pipeline_apply(
    stage_fn: Callable,
    layer_params: Params,  # leaves [L, ...], the whole stack
    x: torch.Tensor,
    *,
    num_microbatches: int,
    num_stages: int,
    aux: Optional[Params] = None,
    with_aux_out: bool = False,
):
    """``pipeline_apply`` of ``num_stages`` stages in one process on the
    whole stack: every stage's actions in tick order, with the ranks'
    arithmetic (the same per-(stage, microbatch) calls, gradients summed in
    the same order). Differentiable; a layer leaf's gradient stacks the
    stages'."""
    _split(x, num_microbatches)
    return _gpipe(stage_fn, _loopback_stages(layer_params, num_stages), layer_params, x,
                  num_microbatches, num_stages, aux, with_aux_out, _Loopback(), stack_grads=True)


# ---------------------------------------------------------------------------
# 1F1B


def _train_1f1b(stage_fn, head_fn, stages: dict, head_params, x, M: int, S: int, aux, wire):
    """Run the 1F1B ticks of ``stages``; returns ``(loss_mean, dhead, dx,
    runner)``, the first three the same on every rank, scaled by 1/M."""
    ticks = schedule(S, M, "1f1b")
    for s in stages:
        if max_in_flight(ticks, s) > min(S, M):
            raise AssertionError(f"stage {s} holds more than min(S, M) = {min(S, M)} inputs")
    runner = _Runner(stage_fn, stages, _split(x, M), aux, False, S, wire,
                     x_grad=x.requires_grad)
    head = _Head(head_fn, head_params)
    last_here, first_here = S - 1 in stages, 0 in stages
    if last_here:
        runner.head = head
    for tick in ticks:
        for a in tick:
            if a.stage in stages:
                if a.op == "F":
                    runner.forward(a, "store")
                else:
                    runner.backward(a, None)
        wire.end_tick(tick)

    inv_m = 1.0 / M
    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device)  # noqa: E731
    loss = head.loss if last_here else zeros(x.new_empty(()))
    dhead = {p: wire.from_stage(head.grads[p] if last_here and head.grads[p] is not None
                                else zeros(t), S - 1) * inv_m
             for p, t in head.trained.items()}
    dx = None
    if x.requires_grad:
        dx = torch.cat([runner.dxm[m] for m in range(M)]) if first_here else torch.empty_like(x)
        dx = (wire.from_stage(dx, 0) * inv_m).to(x.dtype)
    return wire.from_stage(loss, S - 1) * inv_m, _grad_tree(head_params, dhead), dx, runner


def pipeline_train_1f1b(
    stage_fn: Callable,
    head_fn: Callable,
    layer_params: Params,  # this rank's stage: leaves [L/S, ...]
    head_params: Params,
    x: torch.Tensor,  # [B, ...]
    *,
    num_microbatches: int,
    aux: Optional[Params] = None,
    mesh=None,
):
    """One fused forward and backward under the 1F1B schedule; returns
    ``(loss_mean, dlayers, dhead, dx)``: the mean over microbatches of
    ``head_fn(head_params, y_mb)`` (``head_fn(head_params, y_mb, aux_mb)``
    with ``aux``), and its gradients, summed in float32 and scaled by 1/M:
    ``dlayers`` this rank's stage's (a tree like ``layer_params``),
    ``dhead`` and ``dx`` the same on every rank. A leaf that does not
    require grad gets None, and so does ``x``. Not an autograd op: the
    gradients are its result, as in the JAX package."""
    S, stage, wire = _rank_setup(mesh, x, num_microbatches)
    loss, dhead, dx, runner = _train_1f1b(stage_fn, head_fn, {stage: layer_params}, head_params,
                                          x, num_microbatches, S, aux, wire)
    dlayers = {p: g * (1.0 / num_microbatches) for p, g in runner.layer_grads(stage).items()}
    return loss, _grad_tree(layer_params, dlayers), dhead, dx


def loopback_pipeline_train_1f1b(
    stage_fn: Callable,
    head_fn: Callable,
    layer_params: Params,  # leaves [L, ...], the whole stack
    head_params: Params,
    x: torch.Tensor,
    *,
    num_microbatches: int,
    num_stages: int,
    aux: Optional[Params] = None,
):
    """``pipeline_train_1f1b`` of ``num_stages`` stages in one process on
    the whole stack, with the ranks' arithmetic; ``dlayers`` stacks every
    stage's."""
    S, M = num_stages, num_microbatches
    stages = _loopback_stages(layer_params, S)
    loss, dhead, dx, runner = _train_1f1b(stage_fn, head_fn, stages, head_params, x, M, S, aux,
                                          _Loopback())
    per = [runner.layer_grads(s) for s in range(S)]
    dlayers = {p: torch.cat([g[p] for g in per]) * (1.0 / M) for p in per[0]}
    return loss, _grad_tree(layer_params, dlayers), dhead, dx
