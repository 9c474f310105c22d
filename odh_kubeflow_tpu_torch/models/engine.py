"""Continuous-batching decode engine (counterpart of ``models/engine.py``).

``generate()`` decodes one request batch start to finish, so concurrent
requests queue behind each other although a decode step for several
cache slots costs barely more than for one (the step streams the layer
weights, shared by the batch). This engine keeps a slot-batched KV cache
on the device and admits new streams into the running decode loop:

- ``n_slots`` cache slots, each an independent stream with its own write
  offset, rope position, token budget, eos id and sampling knobs
  (temperature / top-k / top-p are ``[slot]`` tensors, so mixed requests
  share one decode chunk);
- the engine thread alternates *admission* (one prompt prefilled
  straight into a free slot's rows of the persistent cache) and *decode
  chunks* (``chunk`` steps of every active slot);
- per-request ``max_tokens`` and ``eos`` are exact: a slot that finishes
  inside a chunk goes inactive there and frees at the chunk's end;
- chunked prefill (``prefill_chunk``), an LRU prefix cache and, with a
  draft model, speculative decoding (greedy only).

The slot state is a set of tensors updated in place, never rebound
(the reference donates its state to XLA instead). On the card the decode
chunk is captured once per variant (greedy, sampling, speculative) as a
CUDA graph and replayed: the counterpart of the reference's one jitted
program per chunk. The first chunk of a variant runs eagerly and loads
the libraries and kernels; the second captures. A capture that fails
raises, it never falls back to eager. Kernel wrappers count their
launches on the host, so a capture's launches are counted once per
replay (``_LAUNCH_COUNTERS``). Prefill stays eager.

Under a mesh (``mesh=``, one process a rank, every rank building the
engine with its shards of the params) the persistent cache shards as
JAX's ``generate.cache_specs``: each rank holds its (data, fsdp) block of
the slots, replicated over tensor and expert, and its KV heads. JAX's
engine is one controller driving the whole mesh; the port's ranks run
the same loop in lockstep. Rank 0 owns the queue and ``submit``. At the
top of every loop turn it broadcasts the turn's plan over the world
group (the requests that arrived, with their prompts and sampling knobs;
the cancellations; stop), and every rank then takes the same decisions:
the admissions, the chunked-prefill parts, the decode chunks, so their
collectives match. A slot's prefill runs on every rank, replicated over
the batch axes and sharded over tensor; only the rank that owns the slot
writes its KV into its cache block (the others write a scratch row, and
keep the same prefix-cache entries). Every rank draws the noise of all
slots from the same generator state and keeps its rows, so sampled tokens
are the one-device engine's. After each chunk the emitted tokens and the
was-active mask are gathered over the batch axes, and every rank keeps
the same slot bookkeeping. At world size 1 the decode chunk is still
captured as one graph per variant; under a mesh with any axis > 1 the
chunks run eagerly (capture with collectives inside is untested), and
``cuda_graphs=True`` there is refused.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from odh_kubeflow_tpu_torch.models.generate import (
    SERVE_BATCH_AXES,
    batch_block,
    check_serving_mesh,
    family_forward,
    filter_logits,
    gumbel_noise,
    init_cache,
)
from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm
from odh_kubeflow_tpu_torch.ops import int4 as int4_ops
from odh_kubeflow_tpu_torch.parallel import collectives as col
from odh_kubeflow_tpu_torch.parallel import mesh as mesh_lib
from odh_kubeflow_tpu_torch.utils import prometheus
from odh_kubeflow_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]

# TTFT spans fast warm admissions to a first call that builds kernels
_TTFT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
# inter-token gaps are near zero within a fetched chunk and a chunk step
# at its boundaries (bimodal: the p95 is the SLO number)
_ITL_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)

# the host-side launch counters of the kernels a decode chunk can reach:
# (module, counter); a dict counter is keyed by kernel instance
_LAUNCH_COUNTERS = (
    (int4_ops, "launches"),
    (gm, "gmm_launches"),
    (gm, "gmm_launches_by_k"),
)

def sample_logits_rowwise(
    logits: torch.Tensor,  # [B, V] float32
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B] f32; <= 0 → greedy for that row
    top_k: torch.Tensor,  # [B] integer; <= 0 → off
    top_p: torch.Tensor,  # [B] f32; <= 0 or >= 1 → off
    rows=None,
) -> torch.Tensor:
    """Per-row sampling: each slot applies its own request's knobs, with
    ``generate.sample_logits``'s semantics row by row (the filtering is
    ``generate.filter_logits``). Draws come from ``generator`` (``rows``:
    a block of a larger batch, see ``generate.gumbel_noise``)."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    noise = gumbel_noise(scaled.shape, generator, logits.device, rows)
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)


@dataclasses.dataclass
class _Request:
    prompt: list[int]
    max_tokens: int
    temperature: float
    top_k: int
    top_p: float
    eos_id: int  # -1 = none
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    tokens: list[int] = dataclasses.field(default_factory=list)
    error: Optional[Exception] = None
    # set by submit(stream=True): tokens are also pushed here as they
    # decode; a None sentinel marks the end of the stream (check .error)
    token_q: Optional["queue.Queue"] = None
    cancelled: bool = False
    # wall-clock submit time and per-token emit times (monotonic seconds,
    # on the host: what a client streaming from this process sees)
    submit_t: float = 0.0
    times: list[float] = dataclasses.field(default_factory=list)
    # under a mesh: the id rank 0 gave the request, and the cancellation
    # every rank acts on (broadcast at a turn's start, so all act alike)
    rid: int = -1
    cancel_seen: bool = False

    def cancel(self) -> None:
        """Abandon the stream (the client went away): the engine frees the
        slot at the next chunk boundary instead of decoding for nobody."""
        self.cancelled = True

    def ttft(self) -> float:
        """Time to first token (s): submit → first emitted token."""
        if not self.times:
            raise ValueError("no tokens emitted")
        return self.times[0] - self.submit_t

    def itls(self) -> list[float]:
        """Gaps between consecutive token emissions (s), as a streaming
        client sees them: near zero inside a fetched chunk, a chunk step
        at its boundaries."""
        return [b - a for a, b in zip(self.times, self.times[1:])]

    def _emit(self, tok: int) -> None:
        self.tokens.append(tok)
        self.times.append(time.monotonic())
        if self.token_q is not None:
            self.token_q.put(tok)

    def _finish(self) -> None:
        self.done.set()
        if self.token_q is not None:
            self.token_q.put(None)

    def result(self, timeout: Optional[float] = None) -> list[int]:
        if not self.done.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self.error is not None:
            raise self.error
        return self.tokens

    def iter_tokens(self, timeout: float = 600.0):
        """Tokens as they decode (``stream=True`` submits only). Raises
        the stream's error, if any, at the end."""
        if self.token_q is None:
            raise ValueError("iter_tokens needs a request submitted with stream=True")
        while True:
            tok = self.token_q.get(timeout=timeout)
            if tok is None:
                break
            yield tok
        if self.error is not None:
            raise self.error


class DecodeEngine:
    """Slot-batched continuous decoding over a persistent KV cache, on
    the card unless ``device`` says otherwise. ``cuda_graphs`` (the card
    only; on by default where it can run) replays each decode-chunk
    variant as one CUDA graph; off, the chunks run eagerly (the comparison
    ``chip_smoke.py`` times). ``mesh``: a ``parallel.mesh.Mesh``; every
    rank builds the engine with its shards of the params
    (``param_specs``), rank 0 submits (see the module docstring)."""

    def __init__(
        self,
        params: Params,
        cfg,  # LlamaConfig or MoeConfig
        *,
        lora: Optional[Params] = None,
        n_slots: int = 4,
        max_len: int = 2048,
        chunk: int = 8,
        prompt_buckets: Sequence[int] = (64, 256, 1024),
        pad_id: int = 0,
        cache_dtype=torch.bfloat16,
        seed: int = 0,
        prefill_chunk: Optional[int] = None,
        mesh=None,
        prefix_cache_entries: int = 0,
        prefix_buckets: Sequence[int] = (256, 512),
        draft_params: Optional[Params] = None,
        draft_cfg=None,
        spec_k: int = 4,
        spec_rounds_per_call: int = 4,
        metrics_registry: Optional[prometheus.Registry] = None,
        compile_cache_dir: Optional[str] = None,
        device="cuda",
        cuda_graphs: Optional[bool] = None,
    ):
        if mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
            raise TypeError(
                f"mesh must be a parallel.mesh.Mesh (build_mesh), got {type(mesh).__name__}"
            )
        # the kernels' build directory (warmup/ subsystem): a staged or
        # materialized directory turns the first launches' nvcc builds
        # into loads. Explicit kwarg wins; falls back to
        # ODH_TORCH_KERNEL_CACHE; no-op when neither is set.
        from odh_kubeflow_tpu_torch.warmup.compilecache import install_process_cache

        install_process_cache(compile_cache_dir)
        if draft_params is not None and draft_cfg is None:
            raise ValueError("draft_params needs draft_cfg")
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
            check_serving_mesh(mesh, family_forward(cfg)[0], n_slots)
            if draft_params is not None:
                check_serving_mesh(mesh, family_forward(draft_cfg)[0])
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.lora = lora
        self.n_slots = n_slots
        self.max_len = max_len
        self.chunk = chunk
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.pad_id = pad_id
        # chunked prefill: prompts longer than this admit in parts, one
        # part per loop turn, so active slots keep decoding between parts
        self.prefill_chunk = prefill_chunk
        # the in-flight chunked admission (one at a time): dict of req /
        # slot / consumed / had_prefix
        self._admitting: Optional[dict] = None
        # prompt-prefix KV reuse, keyed on a bucketed prefix's tokens; LRU
        self.prefix_cache_entries = prefix_cache_entries
        self.prefix_buckets = tuple(sorted(prefix_buckets))
        self._prefix_cache: "dict[tuple, dict]" = {}
        self.prefix_hits = 0
        self.prefix_misses = 0
        # speculative decoding per slot (greedy only: the verify is exact
        # only under argmax)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_k = spec_k
        self.spec_rounds_per_call = max(1, spec_rounds_per_call)
        if draft_params is not None:
            dcache_cfg, self._dfwd = family_forward(draft_cfg)

        cache_cfg, self._fwd = family_forward(cfg)
        dev = self.device
        # this rank's block of the slots: rows [row0, row0 + S) of n_slots
        self._row0, S = 0, n_slots
        self._rows = None  # the noise rows a sampled step keeps (all of them)
        self._batch_group = None
        self._lockstep = False  # the ranks' loops run in lockstep
        self._decode_kw: dict = {}  # the cached forward's mesh arguments
        self._admit_kw: dict = {}
        multi = False
        if mesh is not None:
            index, blocks = batch_block(mesh)
            S = n_slots // blocks
            self._row0, self._rows = index * S, (index * S, n_slots)
            # every group the forwards use, made now, on every rank in one
            # order (a group over several axes is made collectively)
            for axes in (mesh_lib.AXIS_FSDP, mesh_lib.AXIS_TENSOR, mesh_lib.AXIS_EXPERT,
                         SERVE_BATCH_AXES):
                mesh.group(axes)
            self._batch_group = mesh.group(SERVE_BATCH_AXES)
            self._lockstep = dist.get_world_size() > 1
            self._decode_kw = {"mesh": mesh}
            # an admission's prompt is replicated over the batch axes
            self._admit_kw = {"mesh": mesh, "batch_axes": ()}
            multi = mesh.config.num_devices > 1
        self._rank0 = not self._lockstep or dist.get_rank() == 0
        self._n_local = S
        self._state = {
            "cache": init_cache(cache_cfg, n_slots, max_len, cache_dtype, device=dev, mesh=mesh),
            "kv_mask": torch.zeros((S, max_len), dtype=torch.bool, device=dev),
            "cur_token": torch.zeros((S,), dtype=torch.long, device=dev),
            "write_idx": torch.zeros((S,), dtype=torch.long, device=dev),
            "pos": torch.zeros((S,), dtype=torch.long, device=dev),
            "active": torch.zeros((S,), dtype=torch.bool, device=dev),
            "remaining": torch.zeros((S,), dtype=torch.long, device=dev),
            "temp": torch.zeros((S,), dtype=torch.float32, device=dev),
            "top_k": torch.zeros((S,), dtype=torch.long, device=dev),
            "top_p": torch.zeros((S,), dtype=torch.float32, device=dev),
            "eos": torch.full((S,), -1, dtype=torch.long, device=dev),
        }
        if draft_params is not None:
            self._state["dcache"] = init_cache(dcache_cfg, n_slots, max_len, cache_dtype,
                                               device=dev, mesh=mesh)
        # where a prefill of a slot another rank owns writes: one slot's rows
        self._scratch = None
        if mesh is not None and S < n_slots:
            self._scratch = {key: {kv: torch.zeros_like(c[:, :1]) for kv, c in
                                   self._state[key].items()}
                             for key in ("cache", "dcache") if key in self._state}
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)
        self._slots_row = torch.arange(max_len, device=dev)[None, :]
        # a chunk's outputs, rewritten in place by every chunk: emitted
        # tokens and the was-active mask, [n_slots, steps]
        width = self.spec_rounds_per_call * spec_k if draft_params is not None else chunk
        self._out_toks = torch.zeros((S, width), dtype=torch.long, device=dev)
        self._out_mask = torch.zeros((S, width), dtype=torch.bool, device=dev)

        # CUDA graphs, one a variant, sharing one memory pool (the
        # variants never run at once); not under a mesh with an axis > 1
        if cuda_graphs and multi:
            raise NotImplementedError(
                "cuda_graphs=True under a mesh with an axis > 1: capturing the decode "
                "chunk with collectives inside is not supported; its chunks run eagerly"
            )
        self.cuda_graphs = cuda_graphs is not False and dev.type == "cuda" and not multi
        self._graphs: dict[str, Any] = {}
        self._graph_launches: dict[str, list] = {}
        # device memory each capture reserved for its pool: what the
        # graphs hold beyond an eager chunk's transient use
        self.graph_pool_bytes: dict[str, int] = {}
        self._warm: set[str] = set()
        self._pool = None
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        # serving SLO metrics (TTFT / inter-token / queue / occupancy)
        reg = metrics_registry or prometheus.default_registry
        self.m_ttft = reg.histogram(
            "serving_ttft_seconds",
            "Time from request submit to first emitted token",
            buckets=_TTFT_BUCKETS,
        )
        self.m_itl = reg.histogram(
            "serving_inter_token_seconds",
            "Gap between consecutive token emissions (streaming-client view)",
            buckets=_ITL_BUCKETS,
        )
        self.m_queue_depth = reg.gauge(
            "serving_queue_depth", "Requests waiting for a decode slot"
        )
        self.m_occupancy = reg.gauge(
            "serving_batch_occupancy",
            "Fraction of decode slots active after the last chunk",
        )
        # decode_steps × n_slots is the work a serial server would have
        # spent; tokens_emitted / decode_steps is the batching efficiency
        self.decode_steps = 0
        self.tokens_emitted = 0
        self.spec_rounds = 0
        # per chunk (variant, active slots, host seconds from its launch to
        # its tokens on the host): what a decode step costs at each batch
        self.chunk_times: "collections.deque" = collections.deque(maxlen=4096)
        # set on an unrecoverable device failure; submit() then raises
        self.failure: Optional[Exception] = None
        self._slot_req: list[Optional[_Request]] = [None] * n_slots
        # (req, device first token, slot): fetched with the next chunk's
        # outputs, so the prefill's first token costs no sync of its own
        self._pending_first: list = []
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._wake = threading.Event()
        self._stopped = False
        # lockstep: the requests every rank knows, in arrival order, not yet
        # admitted; the live ones by id; rank 0's next id
        self._backlog: "collections.deque[_Request]" = collections.deque()
        self._live: dict[int, _Request] = {}
        self._next_rid = 0
        if dev.type == "cuda":
            # the state was written on this thread's stream; the engine
            # thread works on its own
            torch.cuda.synchronize(dev)
        self._thread = threading.Thread(target=self._loop, daemon=True, name="decode-engine")
        self._thread.start()

    # -- admission ----------------------------------------------------------

    def _local(self, slot: int) -> Optional[int]:
        """The slot's row in this rank's block, None where another rank
        owns it."""
        r = slot - self._row0
        return r if 0 <= r < self._n_local else None

    def _slot_view(self, slot: int, key: str = "cache") -> Params:
        """The slot's rows of a persistent cache, ``[L, 1, max_len, …]``
        views: a prefill writes there in place (a slot another rank owns:
        this rank's scratch row)."""
        r = self._local(slot)
        c = self._state[key] if r is not None else self._scratch[key]
        r = r or 0
        return {kv: c[kv][:, r : r + 1] for kv in ("k", "v")}

    def _deactivate(self, slot: int) -> None:
        r = self._local(slot)
        if r is not None:
            self._state["active"][r] = False

    def _write_slot_state(self, slot: int, first: torch.Tensor, total: int,
                          req: _Request) -> None:
        """Arm ``slot``'s decode fields after its prefill (shared by every
        admission path, so their semantics cannot drift); only its owner
        holds them."""
        slot = self._local(slot)
        if slot is None:
            return
        st = self._state
        st["kv_mask"][slot] = self._slots_row[0] < total
        st["cur_token"][slot : slot + 1] = first
        st["write_idx"][slot] = total
        st["pos"][slot] = total
        # the prefill itself emits the first token
        st["remaining"][slot] = req.max_tokens - 1
        st["active"][slot : slot + 1] = (first != req.eos_id) & (req.max_tokens > 1)
        st["temp"][slot] = req.temperature
        st["top_k"][slot] = req.top_k
        st["top_p"][slot] = req.top_p
        st["eos"][slot] = req.eos_id

    def _prefill_tail(self, slot: int, rem: list[int], start: int, bucket: int,
                      req: _Request) -> torch.Tensor:
        """Run the final (possibly only) prompt segment ``rem`` at cache
        offset ``start`` into the slot's rows, sample the first token and
        arm the slot; returns the first token (a ``[1]`` device tensor).
        Shared by the cold, prefix-hit and chunked admissions."""
        dev = self.device
        toks = torch.tensor(
            [rem + [self.pad_id] * (bucket - len(rem))], dtype=torch.long, device=dev
        )
        total = start + len(rem)
        positions = start + torch.arange(bucket, device=dev)[None, :]
        logits, _ = self._fwd(
            self.params, toks, self.cfg, self._slot_view(slot), start,
            positions=positions, kv_mask=self._slots_row < total, lora=self.lora,
            # bucket padding is not content: a MoE router must not route it
            token_mask=torch.arange(bucket, device=dev)[None, :] < len(rem), **self._admit_kw,
        )
        knobs = (
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.top_k], dtype=torch.long, device=dev),
            torch.tensor([req.top_p], dtype=torch.float32, device=dev),
        )
        first = sample_logits_rowwise(logits[:, len(rem) - 1], self._gen, *knobs)
        self._write_slot_state(slot, first, total, req)
        return first

    def _prefill_part(self, slot: int, toks: list[int], start: int) -> None:
        """One full interior segment of a chunked admission, written into
        the slot's rows at ``start``: no sampling, the slot stays
        inactive."""
        width = len(toks)
        dev = self.device
        self._fwd(
            self.params, torch.tensor([toks], dtype=torch.long, device=dev), self.cfg,
            self._slot_view(slot), start,
            positions=start + torch.arange(width, device=dev)[None, :],
            kv_mask=self._slots_row < start + width, lora=self.lora,
            token_mask=torch.ones((1, width), dtype=torch.bool, device=dev), **self._admit_kw,
        )

    def _seed_prefix(self, slot: int, entry: dict, plen: int) -> None:
        view = self._slot_view(slot)
        for kv in ("k", "v"):
            view[kv][:, 0, :plen] = entry[kv]

    def _draft_prefill(self, slot: int, prompt: list[int], bucket: int) -> None:
        """Fill the draft's cache rows of a freshly admitted slot over the
        full prompt (on a prefix hit too: prefix entries stay target-only)."""
        dev = self.device
        toks = torch.tensor(
            [prompt + [self.pad_id] * (bucket - len(prompt))], dtype=torch.long, device=dev
        )
        kv_mask = self._slots_row < len(prompt)
        self._dfwd(
            self.draft_params, toks, self.draft_cfg, self._slot_view(slot, "dcache"), 0,
            positions=torch.arange(bucket, device=dev)[None, :], kv_mask=kv_mask,
            token_mask=kv_mask[:, :bucket], **self._admit_kw,
        )

    def _match_prefix(self, prompt: list[int]):
        """Longest cached bucketed prefix strictly shorter than the prompt
        (the remainder must be non-empty: the model still has to produce
        the first next-token logits)."""
        if not self.prefix_cache_entries:
            return None, None
        for pb in reversed(self.prefix_buckets):
            if len(prompt) <= pb:
                continue
            key = (pb, tuple(prompt[:pb]))
            entry = self._prefix_cache.get(key)
            if entry is not None:
                self._prefix_cache[key] = self._prefix_cache.pop(key)  # LRU touch
                return pb, entry
        return None, None

    def _maybe_insert_prefix(self, prompt: list[int], slot: int) -> None:
        """After a cold prefill, keep the prompt's bucketed prefix KV (a
        copy of the slot's fresh rows) for the next request sharing it."""
        if not self.prefix_cache_entries:
            return
        for pb in reversed(self.prefix_buckets):
            if len(prompt) <= pb:
                continue
            key = (pb, tuple(prompt[:pb]))
            if key in self._prefix_cache:
                return
            view = self._slot_view(slot)
            entry = {kv: view[kv][:, 0, :pb].clone() for kv in ("k", "v")}
            while len(self._prefix_cache) >= self.prefix_cache_entries:
                self._prefix_cache.pop(next(iter(self._prefix_cache)))
            self._prefix_cache[key] = entry
            return

    def _bucket(self, n: int) -> int:
        return next(b for b in self.prompt_buckets if n <= b)

    def _admit(self, req: _Request) -> None:
        slot = self._slot_req.index(None)
        plen, entry = self._match_prefix(req.prompt)
        if plen is not None:
            self.prefix_hits += 1
            self._seed_prefix(slot, entry, plen)
            rem = req.prompt[plen:]
            first = self._prefill_tail(slot, rem, plen, self._bucket(len(rem)), req)
        else:
            self.prefix_misses += 1
            first = self._prefill_tail(slot, req.prompt, 0, self._bucket(len(req.prompt)), req)
            self._maybe_insert_prefix(req.prompt, slot)
        # a max_tokens <= 1 request never decodes: no draft prefill, and
        # its token is fetched now
        if req.max_tokens <= 1:
            req._emit(int(first))
            self._observe_emit(req)
            req._finish()
            return
        if self.draft_params is not None:
            self._draft_prefill(slot, req.prompt, self._bucket(len(req.prompt)))
        self._slot_req[slot] = req  # claim before the next admission
        self._pending_first.append((req, first, slot))

    def _begin_chunked_admit(self, req: _Request) -> None:
        """Reserve a slot for a part-by-part admission. The slot stays
        inactive (no emissions) until the final part arms it, and decode
        chunks run between parts; an inactive row still writes its cache
        at its write index, so that index parks at the last column, which
        a request's tokens never reach (prompt + max_tokens <= max_len)."""
        slot = self._slot_req.index(None)
        if self._local(slot) is not None:
            self._state["write_idx"][self._local(slot)] = self.max_len - 1
        start = 0
        plen, entry = self._match_prefix(req.prompt)
        if plen is not None:
            self.prefix_hits += 1
            self._seed_prefix(slot, entry, plen)
            start = plen
        else:
            self.prefix_misses += 1
        self._slot_req[slot] = req  # reserved; inactive until the final part
        self._admitting = dict(req=req, slot=slot, consumed=start, had_prefix=plen is not None)

    def _admit_step(self) -> None:
        """Advance the in-flight chunked admission by one part (once a loop
        turn, between decode chunks)."""
        adm = self._admitting
        req, slot = adm["req"], adm["slot"]
        if self._cancelled(req):
            self._admitting = None
            self._slot_req[slot] = None
            req._finish()
            return
        C = self.prefill_chunk
        consumed = adm["consumed"]
        if len(req.prompt) - consumed > C:
            self._prefill_part(slot, req.prompt[consumed : consumed + C], consumed)
            adm["consumed"] = consumed + C
            return
        # final part: the remainder (<= C) is sampled and arms the slot
        first = self._prefill_tail(slot, req.prompt[consumed:], consumed, C, req)
        self._admitting = None
        if not adm["had_prefix"]:
            self._maybe_insert_prefix(req.prompt, slot)
        if req.max_tokens <= 1:
            self._slot_req[slot] = None
            req._emit(int(first))
            self._observe_emit(req)
            req._finish()
            return
        self._pending_first.append((req, first, slot))

    # -- decode chunks --------------------------------------------------------

    def _decode_chunk(self, greedy: bool) -> None:
        """``chunk`` decode steps of every slot, the state rewritten in
        place: a finished slot goes inactive (its writes stop extending
        its valid region). Emitted tokens and the was-active mask land in
        ``_out_toks`` / ``_out_mask`` (a slot's final token is emitted
        while still active; pad_id may be a real token)."""
        st = self._state
        for i in range(self.chunk):
            active, widx, pos = st["active"], st["write_idx"], st["pos"]
            # only active rows extend their valid region
            st["kv_mask"] |= active[:, None] & (self._slots_row == widx[:, None])
            logits, _ = self._fwd(
                self.params, st["cur_token"][:, None], self.cfg, st["cache"], widx,
                positions=pos[:, None], kv_mask=st["kv_mask"], lora=self.lora, **self._decode_kw,
            )
            if greedy:
                # every active slot is greedy: no full-vocab sorts
                nxt = torch.argmax(logits[:, 0, :], dim=-1)
            else:
                nxt = sample_logits_rowwise(
                    logits[:, 0, :], self._gen, st["temp"], st["top_k"], st["top_p"], self._rows
                )
            remaining = st["remaining"] - active.long()
            finished = (nxt == st["eos"]) | (remaining <= 0)
            self._out_toks[:, i] = nxt
            self._out_mask[:, i] = active
            new = {
                "cur_token": torch.where(active, nxt, st["cur_token"]),
                "write_idx": torch.where(active, torch.clamp(widx + 1, max=self.max_len - 1),
                                         widx),
                "pos": torch.where(active, pos + 1, pos),
                "remaining": remaining,
                "active": active & ~finished,
            }
            for k, v in new.items():
                st[k].copy_(v)

    def _spec_chunk(self) -> None:
        """``spec_rounds_per_call`` speculative rounds. A round: the draft
        proposes ``spec_k`` tokens (greedy draft steps), the target scores
        them in one ``spec_k + 1``-token forward at per-slot offsets, and
        each slot advances by its accepted prefix, capped at ``spec_k``
        (the all-accepted bonus token is forfeited, so the draft cache
        never falls behind the stream). Proposal i stands iff it equals
        the target's own argmax there: the tokens equal plain greedy
        decode. Rejected positions stay in the caches behind ``kv_mask``."""
        st = self._state
        k, S = self.spec_k, self._n_local
        dev = self.device
        rows = torch.arange(S, device=dev)
        steps = torch.arange(k + 1, device=dev)[None, :]
        for r in range(self.spec_rounds_per_call):
            active, widx, pos, cur = st["active"], st["write_idx"], st["pos"], st["cur_token"]
            tok, props = cur, []
            for i in range(k):
                logits, _ = self._dfwd(
                    self.draft_params, tok[:, None], self.draft_cfg, st["dcache"], widx + i,
                    positions=(pos + i)[:, None],
                    kv_mask=self._slots_row < (widx + i + 1)[:, None], **self._decode_kw,
                )
                tok = torch.argmax(logits[:, 0, :], dim=-1)
                props.append(tok)
            props = torch.stack(props, dim=1)  # [S, k]
            logits_v, _ = self._fwd(
                self.params, torch.cat([cur[:, None], props], dim=1), self.cfg, st["cache"],
                widx, positions=pos[:, None] + steps,
                kv_mask=self._slots_row < (widx + k + 1)[:, None], lora=self.lora,
                **self._decode_kw,
            )
            targets = torch.argmax(logits_v, dim=-1)  # [S, k+1]
            emit_window = targets[:, :k]
            n_acc = torch.cumprod((props == emit_window).long(), dim=1).sum(dim=1)
            n_eff = torch.clamp(n_acc + 1, max=k)
            eos = st["eos"][:, None]
            eos_hit = (emit_window == eos) & (eos >= 0)
            any_eos = eos_hit.any(dim=1)
            first_eos = torch.argmax(eos_hit.int(), dim=1)
            n_eff = torch.where(any_eos, torch.minimum(n_eff, first_eos + 1), n_eff)
            n_eff = torch.minimum(n_eff, torch.clamp(st["remaining"], min=0))
            n_eff = torch.where(active, n_eff, 0)
            new_widx = widx + n_eff
            remaining = st["remaining"] - n_eff
            ended = (any_eos & (first_eos < n_eff)) | (remaining <= 0)
            self._out_toks[:, r * k : (r + 1) * k] = emit_window
            self._out_mask[:, r * k : (r + 1) * k] = active[:, None] & (steps[:, :k]
                                                                         < n_eff[:, None])
            new = {
                # contiguous validity [0, new_widx): the verify wrote k+1
                # positions, only the accepted prefix is the stream
                "kv_mask": self._slots_row < new_widx[:, None],
                "cur_token": torch.where(
                    active & (n_eff > 0),
                    emit_window[rows, torch.clamp(n_eff - 1, 0, k - 1)], cur,
                ),
                "write_idx": torch.clamp(new_widx, max=self.max_len - 1),
                "pos": pos + n_eff,
                "remaining": remaining,
                "active": active & ~ended,
            }
            for key, v in new.items():
                st[key].copy_(v)

    def _chunk_fn(self, variant: str):
        if variant == "spec":
            return self._spec_chunk
        return lambda: self._decode_chunk(greedy=variant == "greedy")

    def _run_chunk(self, variant: str) -> None:
        """One decode chunk of ``variant`` ("greedy", "sample" or "spec"):
        eager on the CPU, with ``cuda_graphs`` off, and on a variant's
        first call; else the variant's graph, captured at its second call
        and replayed from then on."""
        fn = self._chunk_fn(variant)
        if not self.cuda_graphs or variant not in self._warm:
            fn()
            self._warm.add(variant)
            return
        graph = self._graphs.get(variant)
        if graph is None:
            graph = self._capture(variant, fn)
        graph.replay()
        for (mod, name), launched in zip(_LAUNCH_COUNTERS, self._graph_launches[variant]):
            if isinstance(launched, dict):
                counter = getattr(mod, name)
                for key, n in launched.items():
                    counter[key] = counter.get(key, 0) + n
            else:
                setattr(mod, name, getattr(mod, name) + launched)

    def _capture(self, variant: str, fn):
        """Capture ``fn`` as a CUDA graph on the engine's stream. The
        kernel wrappers count at capture, where nothing runs: the counts
        go back to what they were, and each replay adds the captured
        launches. A capture error propagates (the loop fails the engine)."""
        before = [_snapshot(getattr(mod, name)) for mod, name in _LAUNCH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        if variant == "sample":
            # replays advance the engine's generator, as eager draws do
            graph.register_generator_state(self._gen)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # thread-local capture mode: the HTTP threads' one-shot path may
        # use the card meanwhile
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            reserved = torch.cuda.memory_reserved(self.device)  # a host-side read
            fn()
        self.graph_pool_bytes[variant] = torch.cuda.memory_reserved(self.device) - reserved
        launched = []
        for (mod, name), old in zip(_LAUNCH_COUNTERS, before):
            now = getattr(mod, name)
            if isinstance(now, dict):
                launched.append({k: n - old.get(k, 0) for k, n in now.items()
                                 if n != old.get(k, 0)})
                now.clear()
                now.update(old)
            else:
                launched.append(now - old)
                setattr(mod, name, old)
        self._graphs[variant] = graph
        self._graph_launches[variant] = launched
        return graph

    # -- engine loop ------------------------------------------------------------

    def _observe_emit(self, req: _Request) -> None:
        """The first token is the request's TTFT, every later one an
        inter-token gap (what a streaming client measures)."""
        if len(req.times) == 1:
            self.m_ttft.observe(req.times[0] - req.submit_t)
        else:
            self.m_itl.observe(req.times[-1] - req.times[-2])

    def _fail_engine(self, exc: Exception) -> None:
        """A device failure (out of memory, a failed launch or capture)
        anywhere in the loop is fatal: the slot state may be half
        written. Fail every in-flight and queued request now (their
        ``result()`` raises instead of waiting out a timeout) and make
        later ``submit()`` calls raise, so callers take the one-shot path.
        The first failure wins; finishing a request twice is harmless."""
        if self.failure is None:
            self.failure = exc
        self._admitting = None  # its request is failed through _slot_req
        for slot, req in enumerate(self._slot_req):
            if req is not None:
                req.error = exc
                req._finish()
                self._slot_req[slot] = None
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = exc
                req._finish()
        while self._backlog:  # lockstep: broadcast, not yet admitted
            req = self._backlog.popleft()
            req.error = exc
            req._finish()

    def _loop(self) -> None:
        try:
            with torch.no_grad():
                if self._stream is not None:
                    with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                        self._run_loop()
                else:
                    self._run_loop()
        finally:
            # drain on any exit (stop, device failure, bug), on this
            # thread: it owns _slot_req, so the drain cannot race a chunk
            self._fail_engine(RuntimeError("decode engine stopped"))

    def _cancelled(self, req: _Request) -> bool:
        """Whether the loop acts on a cancellation: in lockstep, only the
        one broadcast at the turn's start."""
        return req.cancel_seen if self._lockstep else req.cancelled

    def _next_request(self) -> Optional[_Request]:
        """The next queued request (None: the stop sentinel); raises
        ``queue.Empty``. In lockstep, from the broadcast backlog."""
        if not self._lockstep:
            return self._queue.get_nowait()
        if not self._backlog:
            raise queue.Empty
        return self._backlog.popleft()

    def _sync_turn(self) -> bool:
        """A lockstep turn's start: rank 0 broadcasts the requests that
        arrived since the last turn (each with an id), the ids of the live
        requests cancelled since, and whether to stop; every rank appends
        the new requests to its backlog (mirrors, on the other ranks) and
        marks the cancellations. Returns the stop flag."""
        new: list = []
        msg = None
        if self._rank0:
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is not None:  # stop() also sets _stopped
                    req.rid, self._next_rid = self._next_rid, self._next_rid + 1
                    new.append(req)
            msg = {
                "new": [(r.rid, r.prompt, r.max_tokens, r.temperature, r.top_k, r.top_p,
                         r.eos_id) for r in new],
                "cancel": [rid for rid, r in self._live.items()
                           if r.cancelled and not r.cancel_seen],
                "stop": self._stopped,
            }
        box = [msg]
        dist.broadcast_object_list(box, src=0)
        msg = box[0]
        if not self._rank0:
            new = [_Request(prompt=p, max_tokens=m, temperature=t, top_k=k, top_p=tp, eos_id=e,
                            rid=rid) for rid, p, m, t, k, tp, e in msg["new"]]
        for req in new:
            self._live[req.rid] = req
            self._backlog.append(req)
        for rid in msg["cancel"]:
            if rid in self._live:
                self._live[rid].cancel_seen = True
        self._live = {rid: r for rid, r in self._live.items() if not r.done.is_set()}
        return msg["stop"]

    def _admit_next(self) -> Optional[int]:
        """Admit queued requests while a slot is free and no chunked
        admission is in flight; returns how many, or None when the stop
        sentinel came."""
        admitted = 0
        while self._admitting is None and None in self._slot_req:
            try:
                req = self._next_request()
            except queue.Empty:
                break
            if req is None:
                return None
            if self._cancelled(req):
                # the client left while queued: spend no prefill on it
                req._finish()
                continue
            try:
                if self.prefill_chunk is not None and len(req.prompt) > self.prefill_chunk:
                    self._begin_chunked_admit(req)
                else:
                    self._admit(req)
            except Exception as e:  # noqa: BLE001 — failed with the engine
                req.error = e
                req._finish()
                raise
            admitted += 1
        return admitted

    def _run_loop(self) -> None:
        while True:
            if self._lockstep:
                if self._sync_turn():
                    return
            elif self._stopped:
                return
            try:
                admitted = 0
                if self._admitting is not None:
                    # one prefill part per turn: active slots get a chunk
                    # below before the next part runs
                    req = self._admitting["req"]
                    try:
                        self._admit_step()
                    except Exception as e:  # noqa: BLE001 — failed with the engine
                        req.error = e
                        req._finish()
                        raise
                    admitted = 1
                more = self._admit_next()
                if more is None:
                    return
                admitted += more
            except Exception as e:  # noqa: BLE001 — state integrity unknown
                self._fail_engine(e)
                return
            self.m_queue_depth.set(self._queue.qsize())
            adm_slot = self._admitting["slot"] if self._admitting is not None else -1
            n_active = sum(r is not None and s != adm_slot for s, r in enumerate(self._slot_req))
            if not n_active:
                if self._admitting is not None:
                    continue  # nothing decoding: run parts back to back
                if not admitted and self._rank0:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                continue
            if self.draft_params is not None:
                variant = "spec"
            elif all(r is None or r.temperature <= 0 for r in self._slot_req):
                variant = "greedy"  # argmax only: no vocab sorts
            else:
                variant = "sample"
            t0 = time.perf_counter()
            try:
                self._run_chunk(variant)
                pending, self._pending_first = self._pending_first, []
                toks, mask = self._out_toks, self._out_mask.long()
                if self._batch_group is not None:  # every rank's slots
                    both = col.gather_dim(torch.cat([toks, mask], 1), self._batch_group, 0)
                    toks, mask = both.split(toks.shape[1], 1)
                # one transfer for the chunk's tokens, its mask and the
                # first tokens of this turn's admissions
                flat = torch.cat([
                    toks.reshape(-1), mask.reshape(-1),
                    *(f.reshape(1) for _r, f, _s in pending),
                ]).tolist()
            except Exception as e:  # noqa: BLE001 — state integrity unknown
                self._fail_engine(e)
                return
            self.chunk_times.append((variant, n_active, time.perf_counter() - t0))
            width = self._out_toks.shape[1]
            n = self.n_slots * width
            toks = [flat[s * width : (s + 1) * width] for s in range(self.n_slots)]
            mask = [flat[n + s * width : n + (s + 1) * width] for s in range(self.n_slots)]
            for (preq, _f, pslot), tok in zip(pending, flat[2 * n :]):
                preq._emit(tok)
                self._observe_emit(preq)
                self.tokens_emitted += 1
                if tok == preq.eos_id:
                    preq._finish()
                    self._deactivate(pslot)
                    self._slot_req[pslot] = None
            if variant == "spec":
                self.spec_rounds += self.spec_rounds_per_call
                self.decode_steps += self.spec_rounds_per_call
            else:
                self.decode_steps += self.chunk
            for slot, req in enumerate(self._slot_req):
                if req is None or slot == adm_slot:
                    # a mid-admission slot: inactive, no emissions; its
                    # cancellation is _admit_step's job
                    continue
                if self._cancelled(req):
                    # the client abandoned the stream: stop its slot now
                    self._deactivate(slot)
                    req._finish()
                    self._slot_req[slot] = None
                    continue
                for t, live in zip(toks[slot], mask[slot]):
                    if live:
                        req._emit(t)
                        self._observe_emit(req)
                        self.tokens_emitted += 1
                if len(req.tokens) >= req.max_tokens or (
                    req.tokens and req.tokens[-1] == req.eos_id
                ):
                    req._finish()
                    self._slot_req[slot] = None
            self.m_occupancy.set(
                sum(1 for r in self._slot_req if r is not None) / float(self.n_slots)
            )

    # -- public API ---------------------------------------------------------------

    def submit(
        self,
        prompt: list[int],
        *,
        max_tokens: int = 64,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        eos_id: Optional[int] = None,
        stream: bool = False,
    ) -> _Request:
        if not self._rank0:
            raise RuntimeError(
                "a DecodeEngine under a mesh takes requests on rank 0 only; the other "
                "ranks follow its plan"
            )
        if self.failure is not None:
            raise RuntimeError(f"decode engine is down: {self.failure!r}")
        if not prompt:
            raise ValueError("empty prompt")
        if self.draft_params is not None and temperature > 0:
            raise ValueError(
                "draft-enabled engine decodes greedily (speculative verify is "
                "exact only under argmax); use the one-shot sampling path for "
                "temperature > 0"
            )
        chunkable = (
            self.prefill_chunk is not None
            and len(prompt) > self.prefill_chunk
            # the draft prefill still needs a full-prompt bucket
            and self.draft_params is None
        )
        if not chunkable and len(prompt) > self.prompt_buckets[-1]:
            raise ValueError(f"prompt longer than max bucket {self.prompt_buckets[-1]}")
        headroom = self.spec_k if self.draft_params is not None else 0
        if len(prompt) + max_tokens + headroom > self.max_len:
            # the speculative verify may write up to spec_k positions past
            # the final kept token: the cache needs that scratch tail
            raise ValueError(
                f"prompt+max_tokens (+{headroom} speculative headroom) exceeds "
                f"engine max_len {self.max_len}"
            )
        req = _Request(
            prompt=list(prompt),
            max_tokens=max_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            eos_id=-1 if eos_id is None else int(eos_id),
            token_q=queue.Queue() if stream else None,
            submit_t=time.monotonic(),
        )
        self._queue.put(req)
        self.m_queue_depth.set(self._queue.qsize())
        self._wake.set()
        # the loop may have exited (stop() or a failure) between the check
        # above and the put: its final drain would then miss this request.
        # Fail what we drain ourselves; finishing twice is harmless
        if self.failure is not None or self._stopped:
            err = self.failure or RuntimeError("decode engine stopped")
            saw_sentinel = False
            try:
                while True:
                    q = self._queue.get_nowait()
                    if q is None:
                        # stop()'s sentinel: keep draining, our request may
                        # sit behind it
                        saw_sentinel = True
                        continue
                    if q.error is None:
                        q.error = err
                    q._finish()
            except queue.Empty:
                pass
            if saw_sentinel:
                # restore it so a still-live loop's exit fires
                self._queue.put(None)
        return req

    def stop(self) -> None:
        """Signal the loop to exit and wait for it. The loop drains the
        in-flight requests itself on exit, after any running chunk. Under a
        mesh, rank 0's stop ends every rank's loop at the next turn; on
        another rank this waits for that."""
        if not self._rank0:
            self._thread.join()
            return
        self._stopped = True
        self._queue.put(None)
        self._wake.set()
        self._thread.join(timeout=60)


def _snapshot(counter):
    return dict(counter) if isinstance(counter, dict) else counter
