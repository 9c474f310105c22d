"""The port's completion service and HTTP surface against the JAX
package's, tiny config, f32, on the CPU.

Greedy completions and ``usage`` must be exactly equal to JAX's
``CompletionService`` for the same trees and buckets. The entry points
must refuse to run without a GPU unless asked for the CPU.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

from odh_kubeflow_tpu.models.serve import CompletionService as JaxCompletionService
from odh_kubeflow_tpu.models.serve import serve as JaxServe
from odh_kubeflow_tpu_torch.models import llama, quant, serve
from odh_kubeflow_tpu_torch.models.serve import CompletionService
from test_torch_llama import JCFG, TCFG, trees

BUCKETS = dict(prompt_buckets=(8, 16), batch_buckets=(1, 2, 4))
REQUESTS = [
    ([[5, 6, 7, 8]], dict(max_tokens=6)),
    ([[1, 2, 3], list(range(1, 13))], dict(max_tokens=5)),
    ([[9, 10], [40, 41, 42, 43, 44], [7] * 8], dict(max_tokens=4)),
]


@pytest.fixture(scope="module")
def int4_services():
    jp, tp = trees("int4", seed=21)
    return (
        JaxCompletionService(jp, JCFG, **BUCKETS),
        CompletionService(tp, TCFG, device="cpu", **BUCKETS),
    )


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
def test_complete_equals_jax_completion_service(kind, int4_services):
    if kind == "int4":
        jsvc, tsvc = int4_services
    else:
        jp, tp = trees(kind, seed=21)
        jsvc = JaxCompletionService(jp, JCFG, **BUCKETS)
        tsvc = CompletionService(tp, TCFG, device="cpu", **BUCKETS)
    for prompts, kw in REQUESTS:
        want = jsvc.complete(prompts, **kw)
        got = tsvc.complete(prompts, **kw)
        assert got == want
    # eos: the first greedy token of the first request ends its row
    prompts, kw = REQUESTS[1]
    eos = jsvc.complete(prompts, **kw)["completions"][1][1]
    assert tsvc.complete(prompts, eos_id=eos, **kw) == jsvc.complete(
        prompts, eos_id=eos, **kw
    )


def test_complete_rejects_bad_requests(int4_services):
    _, tsvc = int4_services
    for bad in ([], [[]], [list(range(99))], [[1, 2, TCFG.vocab_size]], [[1]] * 5):
        with pytest.raises(ValueError):
            tsvc.complete(bad, max_tokens=2)
    a = tsvc.complete([[3, 4]], max_tokens=4, temperature=0.9, top_k=30, seed=7)
    b = tsvc.complete([[3, 4]], max_tokens=4, temperature=0.9, top_k=30, seed=7)
    assert a == b


def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_surface(int4_services):
    jsvc, tsvc = int4_services
    httpd = serve.serve(tsvc, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}
        code, body = _post(base, "/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 3})
        assert code == 200
        assert body == jsvc.complete([[5, 6, 7]], max_tokens=3)
        assert _post(base, "/v1/completions", {"prompt": []})[0] == 400
        assert _post(base, "/v1/completions", {"prompt": [[]]})[0] == 400
        assert _post(base, "/nope", {"prompt": [1]})[0] == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert e.value.code == 404
        code, body = _post(base, "/v1/completions", {"prompt": [1, 2], "stream": True})
        assert code == 400 and "engine_slots" in body["error"]
        code, _ = _post(base, "/v1/completions", {"prompt": [[1], [2]], "stream": True})
        assert code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    _, tp = trees("f32")
    with pytest.raises(RuntimeError):
        CompletionService(tp, TCFG)
    with pytest.raises(RuntimeError):
        quant.streaming_quantized_init(TCFG, 0, bits=4)
    with pytest.raises(RuntimeError):
        llama.init_params(0, TCFG)
    with pytest.raises(RuntimeError):
        serve.main(["--config", "tiny", "--int4", "--port", "0"])


def svc_plain_f32(tp):
    return CompletionService(tp, TCFG, device="cpu").complete([[1, 2, 3]], max_tokens=3)[
        "completions"]


def test_build_service_on_cpu_and_later_slices_refused(tmp_path):
    svc, args = serve.build_service(["--config", "tiny", "--int4", "--device", "cpu"])
    assert set(svc.params["layers"]["wq"]) == {"q4", "scale4"}
    out = svc.complete([[1, 2, 3]], max_tokens=3)
    assert out["usage"]["padded_shape"] == [1, 64]
    assert svc.params["embed"].dtype == torch.bfloat16 and args.int4
    # the engine and speculative decoding are ported: both build and answer
    _, tp = trees("f32")
    eng_svc = CompletionService(tp, TCFG, device="cpu", engine_slots=2)
    try:
        got = eng_svc.complete([[1, 2, 3]], max_tokens=3)
    finally:
        eng_svc.stop()
    assert got["usage"]["engine"] and len(got["completions"][0]) == 3
    with pytest.raises(ValueError, match="draft_cfg"):
        CompletionService(tp, TCFG, device="cpu", draft_params=tp)
    spec_svc = CompletionService(tp, TCFG, device="cpu", draft_params=tp, draft_cfg=TCFG)
    assert spec_svc.complete([[1, 2, 3]], max_tokens=3)["completions"] == svc_plain_f32(tp)
    # MoE configs and --checkpoint now build (tests/test_torch_moe_serve.py);
    # a checkpoint directory that holds no checkpoint is an error
    moe_svc, _ = serve.build_service(["--config", "mixtral_tiny", "--device", "cpu"])
    assert len(moe_svc.complete([[1, 2]], max_tokens=2)["completions"][0]) == 2
    with pytest.raises(FileNotFoundError):
        serve.build_service(["--config", "tiny", "--checkpoint", str(tmp_path / "x"),
                             "--device", "cpu"])


def _sse(base, body):
    """The data frames of a streamed completion, parsed."""
    req = urllib.request.Request(
        base + "/v1/completions", data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        text = r.read().decode()
    return [json.loads(line[len("data: "):]) for line in text.split("\n\n") if line]


def test_engine_route_and_stream_equal_jax_engine_service():
    """``engine_slots=2`` on both sides, one f32 tree: greedy completions
    (one and several prompts, eos), usage and the SSE frames are equal;
    a seeded request takes the one-shot path; a prompt past the engine's
    max_len takes it too, for every prompt of the request."""
    jp, tp = trees("f32", seed=4)
    kw = dict(prompt_buckets=(8, 16), batch_buckets=(1, 2, 4), engine_slots=2,
              engine_max_len=64)
    jsvc = JaxCompletionService(jp, JCFG, **kw)
    tsvc = CompletionService(tp, TCFG, device="cpu", cache_dtype=torch.float32, **kw)
    httpd = serve.serve(tsvc, host="127.0.0.1", port=0)
    jhttpd = None
    try:
        for prompts, n in (([[5, 6, 7, 8]], 6), ([[1, 2, 3], list(range(1, 13)), [9]], 5)):
            want = jsvc.complete(prompts, max_tokens=n)
            assert want["usage"]["engine"]
            assert tsvc.complete(prompts, max_tokens=n) == want
        eos = jsvc.complete([[1, 2, 3]], max_tokens=5)["completions"][0][2]
        assert tsvc.complete([[1, 2, 3]], max_tokens=5, eos_id=eos) == jsvc.complete(
            [[1, 2, 3]], max_tokens=5, eos_id=eos)
        seeded = tsvc.complete([[1, 2, 3]], max_tokens=3, seed=0)
        assert seeded["usage"]["padded_shape"] == [1, 8]
        assert seeded == jsvc.complete([[1, 2, 3]], max_tokens=3, seed=0)
        # 13 + 55 tokens pass the engine's max_len (64): both prompts go one-shot
        mixed = tsvc.complete([[1, 2], list(range(1, 14))], max_tokens=55)
        assert mixed["usage"]["padded_shape"] == [2, 16]

        jhttpd = JaxServe(jsvc, host="127.0.0.1", port=0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        jbase = f"http://127.0.0.1:{jhttpd.server_address[1]}"
        body = {"prompt": [5, 6, 7], "max_tokens": 6}
        frames = _sse(base, body)
        assert frames == _sse(jbase, body)
        assert frames[-1] == {"done": True, "tokens": [f["token"] for f in frames[:-1]]}
        assert len(frames) == 7
        code, err = _post(base, "/v1/completions", {"prompt": [1, 2], "stream": True,
                                                    "seed": 1})
        assert code == 400 and "seed" in err["error"]
        code, err = _post(base, "/v1/completions", {"prompt": list(range(1, 30)),
                                                    "stream": True})
        assert code == 400 and "bucket" in err["error"]
    finally:
        for h in (httpd, jhttpd):
            if h is not None:
                h.shutdown()
                h.server_close()
        tsvc.stop()
        jsvc.engine.stop()


def test_build_service_engine_and_draft_flags_on_cpu():
    svc, args = serve.build_service(["--config", "tiny", "--int4", "--device", "cpu",
                                     "--engine-slots", "2", "--draft-config", "tiny",
                                     "--spec-k", "3"])
    try:
        assert (args.engine_slots, args.spec_k) == (2, 3)
        assert svc.engine is not None and svc.spec_k == 3
        assert set(svc.draft_params["layers"]["wq"]) == {"q4", "scale4"}
        # greedy single prompt: speculative; sampled: the engine
        spec = svc.complete([[1, 2, 3]], max_tokens=4)
        assert spec["usage"]["padded_shape"] == [1, 64]
        sampled = svc.complete([[1, 2, 3]], max_tokens=4, temperature=0.8)
        assert sampled["usage"]["engine"] and len(sampled["completions"][0]) == 4
    finally:
        svc.stop()
