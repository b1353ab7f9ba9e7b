"""The port's serving engine and server against the JAX InferenceEngine.

gpt-test in fp32 on bridged params, with the ServeConfig of the JAX
package's tensor-parallel serving dryrun (4 slots, max_seq_len 128, prefill
buckets of 32, pages of 8 tokens): greedy output must be token-identical,
with more prompts than slots (requests queue), a queued prompt that shares
full pages with an earlier one (the prefix-cache extend path), and
single-token requests (the prompt-is-whole-request edge).
"""

import dataclasses
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.models import (
    init as jax_init)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, SamplingParams as JaxSampling,
    kv_cache as jax_kv, scheduler as jax_sched, tokenizer as jax_tok)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.models import (
    gpt as tgpt)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, InferenceServer, SamplingParams, kv_cache as torch_kv,
    scheduler as torch_sched, tokenizer as torch_tok)
from distributed_llm_training_and_inference_system_tpu_torch.serve.server \
    import BadRequest, parse_completion_body
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

SERVE = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
             prefill_chunk=32, kv_block_size=8, dtype="float32")

_rs = np.random.RandomState(0)
_SHARED = [int(t) for t in _rs.randint(0, 256, 20)]     # 2 full pages + 4
PROMPTS = [
    _SHARED + [1, 2, 3],
    [int(t) for t in _rs.randint(0, 256, 7)],
    [5],
    [int(t) for t in _rs.randint(0, 256, 40)],
    [int(t) for t in _rs.randint(0, 256, 3)],
    _SHARED + [9, 9, 9, 9, 9],          # queued: hits the 2 cached pages
    [int(t) for t in _rs.randint(0, 256, 11)],
]


@pytest.fixture(scope="module")
def params():
    return jax_init(jax_cfg("gpt-test"), jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def torch_params(params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                           torch_cfg("gpt-test"), device="cpu")


def _jax_engine(params, **over):
    return JaxEngine(jax_cfg("gpt-test"),
                     jax_schema.ServeConfig(**{**SERVE, **over}),
                     params=params, seed=0)


def _torch_engine(torch_params, **over):
    return InferenceEngine(torch_cfg("gpt-test"),
                           ServeConfig(**{**SERVE, **over}),
                           params=torch_params, seed=0, device="cpu")


@pytest.fixture(scope="module")
def jax_run(params):
    eng = _jax_engine(params)
    reqs = eng.generate(PROMPTS, JaxSampling(temperature=0.0, max_tokens=12))
    return [r.generated_tokens for r in reqs], eng.stats()


def test_greedy_generation_token_identical_to_jax(jax_run, torch_params):
    ref_tokens, ref_stats = jax_run
    eng = _torch_engine(torch_params)
    reqs = eng.generate(PROMPTS, SamplingParams(temperature=0.0,
                                                max_tokens=12))
    assert [r.generated_tokens for r in reqs] == ref_tokens
    st = eng.stats()
    for key in ("prefill_tokens", "prefix_cached_tokens", "decode_steps",
                "admitted", "finished", "preemptions"):
        assert st[key] == ref_stats[key], key
    assert st["prefix_cached_tokens"] == 16      # the extend path ran
    assert st["kv"]["prefix_hits"] == ref_stats["kv"]["prefix_hits"]


def test_single_token_requests_identical(params, torch_params):
    greedy = dict(temperature=0.0, max_tokens=1)
    ref = _jax_engine(params).generate(PROMPTS[:5], JaxSampling(**greedy))
    out = _torch_engine(torch_params).generate(PROMPTS[:5],
                                               SamplingParams(**greedy))
    assert [r.generated_tokens for r in out] == \
        [r.generated_tokens for r in ref]
    assert all(r.finish_reason == "length" for r in out)


def test_preemption_under_page_pressure_identical(params, torch_params):
    """A 12-page pool for 4 slots: on-demand growth preempts the newest
    stream, which re-prefills and still produces the same tokens."""
    over = dict(kv_num_blocks=12)
    prompts = [PROMPTS[0], PROMPTS[3], PROMPTS[6], PROMPTS[1]]
    ref_eng = _jax_engine(params, **over)
    ref = ref_eng.generate(prompts, JaxSampling(temperature=0.0,
                                                max_tokens=20))
    eng = _torch_engine(torch_params, **over)
    out = eng.generate(prompts, SamplingParams(temperature=0.0,
                                               max_tokens=20))
    assert [r.generated_tokens for r in out] == \
        [r.generated_tokens for r in ref]
    assert eng.stats()["preemptions"] == ref_eng.stats()["preemptions"] > 0


def test_seeded_sampling_is_reproducible_and_batch_independent(torch_params):
    s = SamplingParams(temperature=0.9, top_k=20, top_p=0.9, max_tokens=10,
                       seed=1234)
    alone = _torch_engine(torch_params).generate([PROMPTS[3]], s)
    crowd = _torch_engine(torch_params).generate(
        [PROMPTS[1], PROMPTS[3], PROMPTS[0]], s)
    assert alone[0].generated_tokens == crowd[1].generated_tokens
    assert len(alone[0].generated_tokens) == 10


def test_stats_keys_cover_the_jax_counters(jax_run, torch_params):
    st = _torch_engine(torch_params).stats()
    for key in ("prefill_tokens", "prefix_cached_tokens", "decode_steps",
                "queue_depth", "active", "kv", "admission", "preemptions"):
        assert key in st and key in jax_run[1]


@pytest.mark.socket
def test_server_completions_and_health(jax_run, torch_params):
    srv = InferenceServer(torch_cfg("gpt-test"),
                          ServeConfig(**SERVE, host="127.0.0.1", port=0),
                          params=torch_params, device="cpu")
    port = srv.start()
    base = f"http://127.0.0.1:{port}"

    def post(body):
        req = urllib.request.Request(
            base + "/v1/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=60)

    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            assert r.status == 200
            assert json.loads(r.read())["status"] == "healthy"
        body = {"prompt": PROMPTS[1], "max_tokens": 12, "temperature": 0}
        with post(body) as r:
            out = json.loads(r.read())
        assert out["choices"][0]["token_ids"] == jax_run[0][1]
        assert out["usage"]["completion_tokens"] == 12
        with post({**body, "stream": True}) as r:
            events = [ln[6:] for ln in r.read().decode().splitlines()
                      if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        streamed = [t for e in events[:-1]
                    for t in json.loads(e)["choices"][0]["token_ids"]]
        assert streamed == jax_run[0][1]
        with pytest.raises(urllib.error.HTTPError) as err:
            post({"prompt": [], "max_tokens": 3})
        assert err.value.code == 400
    finally:
        srv.stop()


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_cfg("gpt-test")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, ServeConfig(**SERVE))
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceServer(cfg, ServeConfig(**SERVE))
    with pytest.raises(RuntimeError, match="CUDA"):
        tgpt.init(cfg)


@pytest.mark.parametrize("over", [
    {"quantization": "int4-awq"},
    {"quantization": "int4-awq", "kv_quantization": "int8"},
    {"tensor_parallel": 2},
    {"artifact": "/nonexistent/artifact"},
])
def test_unported_features_refuse_at_construction(over, torch_params):
    """Tensor parallelism constructs only on the ranks of a process group
    of that size (tests/test_torch_tp_serve.py serves it): outside one it
    refuses, saying so; int4-awq and artifacts are ported and construct."""
    if "tensor_parallel" in over:
        with pytest.raises(RuntimeError, match="process group of 2"):
            _torch_engine(torch_params, **over)
        return
    eng = _torch_engine(torch_params, **over)
    assert eng.stats()["quantization"] == over.get("quantization", "none")


@pytest.mark.socket
def test_server_refuses_an_origin_list(torch_params):
    """An explicit cors_origins list: an origin outside it gets no grant
    (only Vary), one inside it is reflected with credentials, a preflight
    answers 204; every header set equals the JAX server's _cors_headers for
    the same request. /v1/stats and /v1/models answer as JAX's do."""
    from types import SimpleNamespace

    from distributed_llm_training_and_inference_system_tpu.serve.server \
        import InferenceServer as JaxServer
    origins = "https://a.example, https://b.example"
    cfg = ServeConfig(**SERVE, host="127.0.0.1", port=0, cors_origins=origins)
    srv = InferenceServer(torch_cfg("gpt-test"), cfg, params=torch_params,
                          device="cpu")
    port = srv.start()
    names = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
             "Access-Control-Allow-Headers",
             "Access-Control-Allow-Credentials", "Vary")

    def call(path, origin, method="GET", req_headers=None):
        headers = {"Origin": origin} if origin else {}
        if req_headers:
            headers["Access-Control-Request-Headers"] = req_headers
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     headers=headers, method=method)
        with urllib.request.urlopen(req, timeout=30) as r:
            got = {k: r.headers[k] for k in names if r.headers[k]}
            return r.status, got, r.read()

    def jax_headers(o, serve_origins, req_headers=None):
        h = {"Origin": o} if o else {}
        if req_headers:
            h["Access-Control-Request-Headers"] = req_headers
        return JaxServer._cors_headers(
            SimpleNamespace(serve_cfg=SimpleNamespace(
                cors_origins=serve_origins)), SimpleNamespace(headers=h))

    try:
        for origin in ("https://b.example", "https://evil.example", ""):
            status, got, body = call("/v1/models", origin)
            assert status == 200 and got == jax_headers(origin, origins)
            assert json.loads(body)["data"][0]["id"] == "gpt-test"
        assert "Access-Control-Allow-Origin" not in \
            call("/v1/models", "https://evil.example")[1]
        status, got, _ = call("/v1/completions", "https://a.example",
                              method="OPTIONS", req_headers="content-type")
        assert status == 204
        assert got == jax_headers("https://a.example", origins,
                                  "content-type")
        assert got["Access-Control-Allow-Origin"] == "https://a.example"
        status, _, body = call("/v1/stats", "")
        stats = json.loads(body)
        for key in ("swap_ins", "swapped_host_bytes", "spec_dispatches",
                    "spec_acceptance", "decode_steps", "kv"):
            assert key in stats, key
    finally:
        srv.stop()
    from distributed_llm_training_and_inference_system_tpu_torch.serve \
        .server import cors_headers
    for serve_origins in ("*", ""):
        for origin in ("https://a.example", ""):
            assert cors_headers(serve_origins, origin, "") == \
                jax_headers(origin, serve_origins)


def test_params_must_be_a_module(params):
    with pytest.raises(TypeError):
        InferenceEngine(torch_cfg("gpt-test"), ServeConfig(**SERVE),
                        params=params, device="cpu")


def test_prefix_hashes_and_cache_bookkeeping_match_jax():
    toks = list(range(50))
    assert torch_kv.prefix_page_hashes(toks, 8) == \
        jax_kv.prefix_page_hashes(toks, 8)
    kw = dict(num_slots=64, max_seq_len=2048, page_size=8,
              hbm_budget_gb=0.001)
    j = jax_kv.PagedKVCache(jax_cfg("gpt-test"), **kw,
                            dtype=jax.numpy.bfloat16)
    t = torch_kv.PagedKVCache(torch_cfg("gpt-test"), **kw,
                              dtype=torch.bfloat16, device="cpu")
    assert t.num_pages == j.num_pages
    assert t.hbm_bytes() == j.hbm_bytes()
    hashes = torch_kv.prefix_page_hashes(toks, 8)
    for c in (j, t):
        c.allocate(0, 30)
        c.register_pages([(hashes[i], int(c.block_tables[0, i]))
                          for i in range(3)])
        c.release(0)                        # cached pages become evictable
        pins = c.lookup_prefix(hashes)
        c.pin_pages(pins)
        c.allocate(1, 40, prefix_pages=pins)
        assert c.extend_slot(1, 60)
        c.allocate(2, 8)
    np.testing.assert_array_equal(t.block_tables, j.block_tables)
    assert t.free_pages == j.free_pages
    assert t.stats()["prefix_cached_pages"] == \
        j.stats()["prefix_cached_pages"] == 3


def test_scheduler_and_tokenizer_copies_match_jax():
    for name in ("Request", "SamplingParams"):
        assert [f.name for f in dataclasses.fields(
            getattr(torch_sched, name))] == [f.name for f in dataclasses.fields(
                getattr(jax_sched, name))]
    jt, tt = jax_tok.ByteTokenizer(128256), torch_tok.ByteTokenizer(128256)
    text = "héllo wörld"
    assert tt.encode(text) == jt.encode(text)
    assert (tt.bos_token_id, tt.eos_token_id) == (jt.bos_token_id,
                                                  jt.eos_token_id)
    ids = tt.encode(text)
    dec = torch_tok.IncrementalDecoder(tt)
    assert "".join(dec.feed([i]) for i in ids) + dec.finish() == text


@pytest.mark.parametrize("body", [
    {"prompt": "hi", "max_tokens": 4, "temperature": 0.5, "top_k": 3},
    {"prompt": [1, 2, 3], "seed": 7, "stream": True},
    {"prompt": ""}, {"prompt": [1, True]}, {"prompt": [999]},
    {"prompt": "x", "seed": "7"}, {"prompt": "x", "max_tokens": 0},
    {"prompt": "x", "temperature": "hot"},
])
def test_parse_completion_body_matches_jax(body):
    from distributed_llm_training_and_inference_system_tpu.serve.server \
        import BadRequest as JaxBadRequest, parse_completion_body as jparse
    tok = torch_tok.ByteTokenizer(256)
    try:
        ref = jparse(body, jax_tok.ByteTokenizer(256), 256)
    except JaxBadRequest as e:
        with pytest.raises(BadRequest) as err:
            parse_completion_body(body, tok, 256)
        assert str(err.value) == str(e)
        return
    toks, sampling, stream = parse_completion_body(body, tok, 256)
    assert (toks, dataclasses.asdict(sampling), stream) == \
        (ref[0], dataclasses.asdict(ref[1]), ref[2])
