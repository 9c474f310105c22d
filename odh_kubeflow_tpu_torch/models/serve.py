"""Minimal completion server (counterpart of ``models/serve.py``).

    POST /v1/completions   {"prompt": [[ids...], ...] | [ids...],
                            "max_tokens": N, "temperature": t,
                            "top_k": k, "top_p": p, "seed": s,
                            "stream": false}
      → {"completions": [[ids...], ...], "usage": {...}}
        (with "stream": true, Server-Sent Events: one {"token": id}
        frame per token, then {"done": true, "tokens": [...]})
    GET  /healthz

Three paths, chosen per request as in the JAX server:

- the continuous-batching engine (``engine_slots > 0``,
  ``models/engine.py``): every request without a seed, each prompt its
  own stream in a shared decode loop; streaming needs it;
- speculative decoding (``draft_params``, ``models/spec_decode.py``):
  greedy single-prompt requests, output equal to the target's own;
- the one-shot bucketed path through ``models/generate.py``: prompts pad
  to the same prompt and batch buckets as the JAX server, so both
  packages answer a request with the same padded shape. PyTorch runs
  eagerly, so there is no compiled program to cache per shape.

The model is a dense ``LlamaConfig`` or a MoE ``MoeConfig`` (whose
grouped prefill runs the grouped-matmul kernels). Params may be a float
tree, a LoRA-merged tree (``main --checkpoint`` restores a trainer's
adapters and merges them), or an int8/int4 tree from ``models/quant.py``
(dequantized per layer inside the forward). Tokenization is out of
scope: ids in, ids out.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Sequence

import torch

from odh_kubeflow_tpu_torch.models.generate import GenerateConfig, generate
from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
from odh_kubeflow_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]

DEFAULT_PROMPT_BUCKETS = (64, 256, 1024)
DEFAULT_BATCH_BUCKETS = (1, 4)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class CompletionService:
    """Pads to shape buckets and drives generation on one device."""

    def __init__(
        self,
        params: Params,
        cfg,  # LlamaConfig or MoeConfig
        *,
        lora: Optional[Params] = None,
        draft_params: Optional[Params] = None,
        draft_cfg=None,
        spec_k: int = 4,
        prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        pad_id: int = 0,
        engine_slots: int = 0,
        engine_max_len: int = 2048,
        device="cuda",
        **engine_kw,
    ):
        """``engine_kw`` passes further ``DecodeEngine`` arguments (chunk,
        prefill_chunk, prefix cache, cuda_graphs) to the engine."""
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.lora = lora
        # a draft model: greedy single-prompt requests run speculative
        # decoding, with the same output
        if draft_params is not None and draft_cfg is None:
            raise ValueError("draft_params needs draft_cfg")
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_k = spec_k
        self.prompt_buckets = tuple(prompt_buckets)
        self.batch_buckets = tuple(batch_buckets)
        self.pad_id = pad_id
        self._lock = threading.Lock()  # one one-shot generation at a time
        # continuous batching: concurrent requests join one slot-batched
        # decode loop instead of queueing behind the lock; 0 = the
        # one-shot path for every request
        self.engine = None
        if engine_slots > 0:
            from odh_kubeflow_tpu_torch.models.engine import DecodeEngine

            self.engine = DecodeEngine(
                params,
                cfg,
                lora=lora,
                n_slots=engine_slots,
                max_len=engine_max_len,
                prompt_buckets=self.prompt_buckets,
                pad_id=pad_id,
                device=self.device,
                **engine_kw,
            )

    def _spec_runner(self, prompt: torch.Tensor, length: torch.Tensor, max_tokens: int,
                     eos_id: Optional[int]) -> dict:
        from odh_kubeflow_tpu_torch.models.spec_decode import (
            SpecDecodeConfig,
            speculative_generate,
        )

        spec_cfg = SpecDecodeConfig(
            max_new_tokens=max_tokens,
            num_draft_tokens=self.spec_k,
            eos_id=eos_id,
            pad_id=self.pad_id,
        )
        return speculative_generate(
            self.params, self.cfg, self.draft_params, self.draft_cfg, prompt, spec_cfg,
            prompt_lengths=length, target_lora=self.lora,
        )

    def stop(self) -> None:
        """Stop the engine's thread, if there is one."""
        if self.engine is not None:
            self.engine.stop()

    def complete(
        self,
        prompts: list[list[int]],
        *,
        max_tokens: int = 64,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        eos_id: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> dict:
        """``seed``: its presence (0 included) asks for reproducible
        sampling and takes the one-shot path, whose generator it seeds
        (the engine's generator is shared by all slots). Omit it for the
        engine."""
        if not prompts or any(not p for p in prompts):
            raise ValueError("prompts must be non-empty token-id lists")
        if max_tokens < 0:
            raise ValueError(f"max_tokens must be >= 0, got {max_tokens}")
        V = self.cfg.vocab_size
        if any(not (0 <= t < V) for p in prompts for t in p):
            raise ValueError(f"token ids must lie in [0, {V})")

        # greedy single-prompt requests go speculative when a draft is on
        speculate = (
            self.draft_params is not None and len(prompts) == 1 and temperature == 0.0
        )
        # the engine first: each prompt its own stream. Every prompt is
        # checked against the engine's bounds before any is submitted, so
        # a too-long one cannot strand its batchmates in running slots
        eng = self.engine
        if (
            eng is not None
            and not speculate
            and seed is None
            and eng.failure is None
            and all(
                len(p) <= eng.prompt_buckets[-1] and len(p) + max_tokens <= eng.max_len
                for p in prompts
            )
        ):
            handles = [
                eng.submit(p, max_tokens=max_tokens, temperature=temperature, top_k=top_k,
                           top_p=top_p, eos_id=eos_id)
                for p in prompts
            ]
            completions = [h.result(timeout=600) for h in handles]
            return {
                "completions": completions,
                "usage": {
                    "prompt_tokens": sum(len(p) for p in prompts),
                    "completion_tokens": sum(len(c) for c in completions),
                    "engine": True,
                },
            }

        B = _bucket(len(prompts), self.batch_buckets)
        S = _bucket(max(len(p) for p in prompts), self.prompt_buckets)
        if max(len(p) for p in prompts) > S:
            raise ValueError(f"prompt longer than max bucket {S}")
        if len(prompts) > B:
            raise ValueError(f"more prompts than the largest batch bucket {B}")

        rows = [list(p) + [self.pad_id] * (S - len(p)) for p in prompts]
        rows += [[self.pad_id] * S] * (B - len(prompts))
        lengths = [len(p) for p in prompts] + [0] * (B - len(prompts))
        gen_cfg = GenerateConfig(
            max_new_tokens=max_tokens,
            temperature=temperature,
            top_k=top_k or None,
            top_p=top_p or None,
            eos_id=eos_id,
            pad_id=self.pad_id,
        )
        with self._lock:
            tokens = torch.tensor(rows, dtype=torch.long, device=self.device)
            lens_in = torch.tensor(lengths, dtype=torch.long, device=self.device)
            if speculate:
                out = self._spec_runner(tokens[:1], lens_in[:1], max_tokens, eos_id)
            else:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(0 if seed is None else seed)
                out = generate(
                    self.params,
                    tokens,
                    self.cfg,
                    gen_cfg,
                    prompt_lengths=lens_in,
                    lora=self.lora,
                    generator=gen,
                )
            toks = out["tokens"].cpu().tolist()
            lens = out["lengths"].cpu().tolist()
        completions = [toks[i][: lens[i]] for i in range(len(prompts))]
        return {
            "completions": completions,
            "usage": {
                "prompt_tokens": sum(len(p) for p in prompts),
                "completion_tokens": int(sum(lens[: len(prompts)])),
                "padded_shape": [B, S],
            },
        }


def _gen_params(req: dict) -> dict:
    """The sampling knobs of a request, with the JAX server's defaults."""
    return {
        "max_tokens": int(req.get("max_tokens", 64)),
        "temperature": float(req.get("temperature", 0.0)),
        "top_k": int(req.get("top_k", 0)),
        "top_p": float(req.get("top_p", 0.0)),
        "eos_id": req.get("eos_id"),
    }


def serve(
    service: CompletionService, host: str = "0.0.0.0", port: int = 8000
) -> ThreadingHTTPServer:
    """Start the HTTP surface on a daemon thread; returns the server
    (``shutdown()`` then ``server_close()`` stop it)."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, body: dict):
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path.rstrip("/").endswith("/healthz"):
                self._reply(200, {"status": "ok"})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if not self.path.rstrip("/").endswith("/v1/completions"):
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length).decode() or "{}")
                prompts = req.get("prompt") or []
                if prompts and isinstance(prompts[0], int):
                    prompts = [prompts]
                if req.get("stream"):
                    return self._stream(prompts, req)
                result = service.complete(
                    prompts,
                    seed=None if req.get("seed") is None else int(req["seed"]),
                    **_gen_params(req),
                )
                self._reply(200, result)
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — surface, keep serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _stream(self, prompts, req):
            """``"stream": true`` → Server-Sent Events: one
            ``data: {"token": id}`` frame per token as the engine decodes
            it, then ``data: {"done": true, "tokens": [...]}``. It needs the
            continuous-batching engine: a one-shot decode has its tokens
            only when the whole batch ends."""
            if len(prompts) != 1:
                return self._reply(
                    400, {"error": "stream requires exactly one prompt"}
                )
            if req.get("seed") is not None:
                # the engine's generator is shared by every slot: a
                # per-request seed cannot be honoured
                return self._reply(
                    400, {"error": "stream does not support seed; omit it"}
                )
            eng = service.engine
            if eng is None:
                return self._reply(
                    400, {"error": "streaming requires engine_slots > 0"}
                )
            if eng.failure is not None:
                return self._reply(
                    500, {"error": f"decode engine is down: {eng.failure!r}"}
                )
            try:
                handle = eng.submit(prompts[0], stream=True, **_gen_params(req))
            except ValueError as e:  # the request is malformed
                return self._reply(400, {"error": str(e)})
            except RuntimeError as e:  # the engine died under us
                return self._reply(500, {"error": str(e)})
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                for tok in handle.iter_tokens():
                    self.wfile.write(f"data: {json.dumps({'token': tok})}\n\n".encode())
                    self.wfile.flush()
                final = {"done": True, "tokens": handle.tokens}
            except OSError:
                # the client went away: free its slot
                handle.cancel()
                return
            except Exception as e:  # noqa: BLE001 — end the stream honestly
                final = {"done": True, "error": f"{type(e).__name__}: {e}"}
            try:
                self.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
                self.wfile.flush()
            except OSError:
                pass  # the client went away on the final frame

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


CONFIGS = ("tiny", "llama3_1b", "llama3_8b", "mixtral_tiny", "mixtral_8x1b")


def _restore_merged(cfg, args, device) -> Params:
    """A trainer's LoRA adapters restored from ``args.checkpoint`` and
    merged into its base. Adapter checkpoints exclude the frozen base, so
    the trainer rebuilds it from ``args.seed``: the training run's seed."""
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig, merge_lora
    from odh_kubeflow_tpu_torch.train import CheckpointManager, TrainConfig, Trainer

    trainer = Trainer(cfg, TrainConfig(), lora_cfg=LoraConfig(rank=args.lora_rank),
                      seed=args.seed, device=device)
    with CheckpointManager(args.checkpoint) as mgr:
        step = trainer.restore_checkpoint(mgr)
    print(f"restored LoRA adapters at step {step}; merged", flush=True)
    return merge_lora(trainer.params, trainer.lora_params)


def build_service(argv: Optional[list] = None) -> tuple[CompletionService, Any]:
    """Parse ``main``'s arguments and build the service they describe;
    returns ``(service, args)``."""
    import argparse

    from odh_kubeflow_tpu_torch.models import llama, moe
    from odh_kubeflow_tpu_torch.models.quant import quantize_params, streaming_quantized_init

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="llama3_1b", choices=CONFIGS)
    parser.add_argument(
        "--checkpoint", default="", help="LoRA checkpoint dir (train/checkpoint.py)"
    )
    parser.add_argument("--lora-rank", type=int, default=16)
    parser.add_argument(
        "--seed", type=int, default=0,
        help="base-param init seed; with --checkpoint it must be the training "
        "run's Trainer seed (adapter checkpoints exclude the frozen base)",
    )
    parser.add_argument("--int8", action="store_true", help="int8 weights")
    parser.add_argument("--int4", action="store_true", help="int4 weights (dense configs)")
    parser.add_argument(
        "--draft-config", default="", choices=["", "tiny", "llama3_1b"],
        help="attach a draft model (random weights from --seed, quantized like the "
        "target): greedy single-prompt requests decode speculatively, same output",
    )
    parser.add_argument("--spec-k", type=int, default=4)
    parser.add_argument(
        "--engine-slots", type=int, default=0,
        help="continuous-batching decode slots (0 = the one-shot path only)",
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.int8 and args.int4:
        raise ValueError("--int8 and --int4 are exclusive")
    device = resolve_device(args.device)
    bits = 4 if args.int4 else 8 if args.int8 else 0
    is_moe = args.config.startswith("mixtral")
    if is_moe:
        if args.int4:
            raise ValueError("--int4 serves dense configs; a MoE model takes --int8")
        # the factory's dispatch ("ragged"), as the JAX server
        cfg = getattr(moe.MoeConfig, args.config)()
    else:
        cfg = getattr(LlamaConfig, args.config)(dtype=torch.bfloat16)
    if args.checkpoint:
        params = _restore_merged(cfg, args, device)
    elif bits and not is_moe:
        # stream init+quantize per leaf: the bf16 tree never exists whole
        params = streaming_quantized_init(cfg, args.seed, bits=bits, device=device)
    else:
        init = moe.init_params if is_moe else llama.init_params
        params = init(args.seed, cfg, dtype=torch.bfloat16, device=device)
    if bits:  # leaves quantized already pass through unchanged
        params = quantize_params(params, bits=bits)
    draft_params = draft_cfg = None
    if args.draft_config:
        draft_cfg = getattr(LlamaConfig, args.draft_config)(dtype=torch.bfloat16)
        if bits:
            draft_params = streaming_quantized_init(draft_cfg, args.seed, bits=bits,
                                                    device=device)
        else:
            draft_params = llama.init_params(args.seed, draft_cfg, dtype=torch.bfloat16,
                                             device=device)
    service = CompletionService(
        params, cfg, draft_params=draft_params, draft_cfg=draft_cfg, spec_k=args.spec_k,
        engine_slots=args.engine_slots, device=device,
    )
    return service, args


def main(argv: Optional[list] = None) -> None:
    """``python -m odh_kubeflow_tpu_torch.models.serve`` — serve a model
    with random weights on the card (``--device cpu`` for the CPU)."""
    import time

    service, args = build_service(argv)
    httpd = serve(service, host=args.host, port=args.port)
    bits = "int4" if args.int4 else "int8" if args.int8 else "bf16"
    print(
        f"completion server on http://{args.host}:{httpd.server_address[1]}"
        f" (config={args.config}, weights={bits}, device={service.device}, "
        f"engine_slots={args.engine_slots}, draft={args.draft_config or 'none'})",
        flush=True,
    )
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
