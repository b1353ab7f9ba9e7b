"""The engine's and the KV cache's fleet hooks against the JAX package's
(gpt-test, fp32, CPU; both engines on the same params).

- The KV cache's fleet helpers (``insert_prefix_pages``, the prefix
  inventory and pairs, ``slot_capacity_tokens``, ``can_allocate``,
  ``slice_page_payload``/``concat_page_payloads``) give the JAX cache's
  page ids, pool bytes and lists after the same calls.
- A payload that the JAX engine extracted mid-decode, framed by JAX's
  courier encoder, restores into the port's engine and the stream goes on
  token for token as the JAX engine's undisturbed run; the reverse holds
  (port extract, port frames, JAX engine). fp32 and int8 pages.
- A partial payload (full pages of a pre-copy) is served: its pages are
  written back and only the tail is prefilled, with JAX's tokens and
  counts.
- A ``pipeline_stage`` request is served: its pages are published chunk by
  chunk, ``pipeline_chunk_hook`` sees JAX's (done, finished) sequence, and
  the slot leaves without decoding; a later request hits those pages.
- ``prefix_fetch_hook`` imports another engine's cached pages before a
  prefill; ``on_prefill_complete`` and ``expect_pure_decode`` fire as in
  JAX.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.models import (
    init as jax_init)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, Request as JaxRequest,
    SamplingParams as JaxSampling, kv_cache as jax_kv)
from distributed_llm_training_and_inference_system_tpu.serve.fleet import (
    transport as jt)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, Request, SamplingParams, kv_cache as torch_kv)
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
    transport as tt)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

SERVE = dict(model="gpt-test", max_batch_size=2, max_seq_len=128,
             prefill_chunk=16, kv_block_size=8, dtype="float32",
             decode_steps_per_dispatch=2, pipelined_decode=False)
PROMPT = [7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
          71, 73, 79, 83]
GEN = 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return jax_init(jax_cfg("gpt-test"), jax.random.PRNGKey(0))


def _engines(params, **over):
    kw = dict(SERVE, **over)
    je = JaxEngine(jax_cfg("gpt-test"), jax_schema.ServeConfig(**kw),
                   params=params, seed=0)
    te = InferenceEngine(torch_cfg("gpt-test"), ServeConfig(**kw),
                         params=params_from_jax(
                             jax.tree_util.tree_map(np.asarray, params),
                             torch_cfg("gpt-test"), device="cpu"),
                         seed=0, device="cpu")
    return je, te


def _greedy(pkg="torch", n=GEN):
    return (SamplingParams if pkg == "torch" else JaxSampling)(
        temperature=0.0, max_tokens=n)


# -- the KV cache's helpers ----------------------------------------------------

def _raw(node):
    if isinstance(node, dict):
        return {k: _raw(v) for k, v in node.items()}
    if isinstance(node, np.ndarray):
        return (str(node.dtype), node.shape, node.tobytes())
    return node


@pytest.mark.parametrize("kind", ["none", "int8", "int4"])
def test_kv_cache_fleet_helpers_equal_jax(kind):
    geom = dict(num_slots=3, max_seq_len=64, page_size=8, num_pages=9)
    jc = jax_kv.PagedKVCache(jax_cfg("gpt-test"), **geom, quantized=kind,
                             dtype=jax.numpy.float32)
    tc = torch_kv.PagedKVCache(torch_cfg("gpt-test"), **geom,
                               quantized=kind, dtype=torch.float32,
                               device="cpu")
    rs = np.random.RandomState(5)
    src = jax_kv.PagedKVCache(jax_cfg("gpt-test"), **geom, quantized=kind,
                              dtype=jax.numpy.float32)
    src.allocate(0, 24)
    payload = src.extract_slot(0)                 # zeros of the right kind

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if not isinstance(node, np.ndarray):
            return node
        if node.dtype == np.float32:
            return rs.randn(*node.shape).astype(np.float32)
        info = np.iinfo(node.dtype)
        return rs.randint(info.min, info.max + 1, node.shape).astype(
            node.dtype)
    payload = fill(payload)
    hashes = [bytes([i]) * 16 for i in range(3)]
    out = {}
    for name, c in (("jax", jc), ("torch", tc)):
        c.allocate(0, 17)                          # 3 pages held
        got = [c.can_allocate(40), c.can_allocate(48),
               c.slot_capacity_tokens(0), c.slot_capacity_tokens(1)]
        got.append(c.insert_prefix_pages(hashes, payload))
        # a hash already cached keeps its page; a dry pool stops early
        got.append(c.insert_prefix_pages(
            [hashes[1], bytes([9]) * 16, bytes([8]) * 16, bytes([7]) * 16],
            torch_kv.concat_page_payloads(
                payload, torch_kv.slice_page_payload(payload, 1))))
        got += [c.prefix_inventory(), c.prefix_inventory(2),
                c.prefix_cache_pairs(), c.free_pages]
        pages = [int(p) for _h, p in c.prefix_cache_pairs()]
        got.append(_raw(torch_kv.payload_numpy(c.extract_pages(pages))
                        if name == "torch" else c.extract_pages(pages)))
        out[name] = got
    assert out["torch"] == out["jax"]
    for cut in (1, 3):
        assert _raw(torch_kv.slice_page_payload(payload, cut)) == _raw(
            jax_kv.slice_page_payload(payload, cut))
    assert _raw(torch_kv.concat_page_payloads(payload, payload)) == _raw(
        jax_kv.concat_page_payloads(payload, payload))
    with pytest.raises(ValueError):
        torch_kv.slice_page_payload(payload, 4)


def test_bf16_host_dtype_survives_concat_and_slice():
    c = torch_kv.PagedKVCache(torch_cfg("gpt-test"), num_slots=1,
                              max_seq_len=32, page_size=8, num_pages=5,
                              dtype=torch.bfloat16, device="cpu")
    c.allocate(0, 24)
    p = torch_kv.payload_numpy(c.extract_slot(0))
    assert torch_kv.host_dtype_name(p["k"].dtype) == "bfloat16"
    for q in (torch_kv.slice_page_payload(p, 2),
              torch_kv.concat_page_payloads(p, p)):
        assert torch_kv.host_dtype_name(q["k"].dtype) == "bfloat16"
        assert torch_kv.host_dtype_name(q["v"].dtype) == "bfloat16"


# -- payloads across the packages ----------------------------------------------

def _mid_decode(eng, req, steps: int):
    """Step ``eng`` until ``req`` holds ``steps`` tokens or more; then its
    slot's payload in the swapped_kv schema and the request's progress."""
    assert eng.scheduler.add_request(req)
    while len(req.generated_tokens) < steps:
        eng.step()
    slot = eng._req_slot[req.request_id]
    pages = eng.kv.extract_slot(slot)
    return {"pages": pages, "positions": int(eng.positions[slot]),
            "last_token": int(eng.last_tokens[slot])}


def _through_frames(src, dst, payload, codec):
    manifest, blob = src.encode_payload(payload, codec=codec)
    rx = dst.CourierReceiver()
    for c in src.make_chunks("mid", manifest, blob, 4096):
        rx.add_chunk(dst.CourierChunk.from_wire(c.to_wire()))
    return rx.take_payload("mid")


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_jax_payload_restores_into_the_port_and_back(params, kv):
    je, te = _engines(params, kv_quantization=kv)
    want = je.generate([PROMPT], _greedy("jax"))[0].generated_tokens
    assert te.generate([PROMPT], _greedy())[0].generated_tokens == want
    # JAX -> port
    je, te = _engines(params, kv_quantization=kv)
    jr = JaxRequest("m", list(PROMPT), _greedy("jax"))
    payload = _through_frames(jt, tt, _mid_decode(je, jr, 5), "delta-zlib")
    tr = Request("m", list(PROMPT), _greedy())
    tr.generated_tokens = list(jr.generated_tokens)
    tr.assigned_seed, tr.fleet_requeued = jr.assigned_seed, True
    tr.swapped_kv = payload
    assert te.scheduler.add_request(tr)
    te.run_until_idle()
    assert tr.generated_tokens == want
    assert te.total_prefill_tokens == 0 and te.total_swap_ins == 1
    # port -> JAX
    je, te = _engines(params, kv_quantization=kv)
    tr = Request("n", list(PROMPT), _greedy())
    mid = _mid_decode(te, tr, 7)
    payload = _through_frames(tt, jt, dict(
        mid, pages=torch_kv.payload_numpy(mid["pages"])), "zlib")
    jr = JaxRequest("n", list(PROMPT), _greedy("jax"))
    jr.generated_tokens = list(tr.generated_tokens)
    jr.assigned_seed, jr.fleet_requeued = tr.assigned_seed, True
    jr.swapped_kv = payload
    assert je.scheduler.add_request(jr)
    je.run_until_idle()
    assert jr.generated_tokens == want
    assert je.total_prefill_tokens == 0


def test_partial_payload_writes_its_pages_and_prefills_the_tail(params):
    out = {}
    for pkg in ("jax", "torch"):
        je, te = _engines(params)
        eng = je if pkg == "jax" else te
        R = JaxRequest if pkg == "jax" else Request
        req = R("p", list(PROMPT), _greedy(pkg))
        mid = _mid_decode(eng, req, 6)
        full = mid["positions"] // 8
        pages = (eng.kv.extract_slot_pages(eng._req_slot["p"], 0, full))
        if pkg == "torch":
            pages = torch_kv.payload_numpy(pages)
        again = R("p2", list(PROMPT), _greedy(pkg))
        again.generated_tokens = list(req.generated_tokens)
        again.assigned_seed, again.fleet_requeued = req.assigned_seed, True
        again.swapped_kv = {"pages": pages, "positions": full * 8,
                            "partial": True}
        fresh = (JaxEngine(jax_cfg("gpt-test"),
                           jax_schema.ServeConfig(**SERVE), params=params,
                           seed=0) if pkg == "jax" else _engines(params)[1])
        context = len(again.context_tokens)
        assert fresh.scheduler.add_request(again)
        fresh.run_until_idle()
        st = fresh.stats()
        out[pkg] = (again.generated_tokens, st["partial_restores"],
                    st["prefill_tokens"], st["requeue_cached_tokens"],
                    full * 8, context)
    assert out["torch"] == out["jax"]
    want = _engines(params)[1].generate([PROMPT], _greedy())[0]
    tokens, restores, prefilled, avoided, covered, context = out["torch"]
    assert tokens == want.generated_tokens
    assert restores == 1 and avoided == covered > 0
    assert prefilled == context - covered


def test_pipeline_stage_request_publishes_pages_chunk_by_chunk(params):
    out = {}
    for pkg in ("jax", "torch"):
        je, te = _engines(params, chunked_prefill_tokens=8)
        eng = je if pkg == "jax" else te
        R = JaxRequest if pkg == "jax" else Request
        calls = []
        eng.pipeline_chunk_hook = lambda r, done, fin: calls.append(
            (r.request_id, done, fin, len(eng.kv.prefix_inventory())))
        stage = R("s", list(PROMPT) * 2, _greedy(pkg, 4))
        stage.pipeline_stage = {"stage": 0}
        assert eng.scheduler.add_request(stage)
        eng.run_until_idle()
        follow = R("f", list(PROMPT) * 2 + [5], _greedy(pkg, 4))
        assert eng.scheduler.add_request(follow)
        eng.run_until_idle()
        st = eng.stats()
        out[pkg] = (calls, stage.generated_tokens, stage.finish_reason,
                    follow.generated_tokens, st["prefix_cached_tokens"],
                    st["prefill_tokens"])
    assert out["torch"] == out["jax"]
    calls = out["torch"][0]
    assert [c[1] for c in calls] == list(range(8, 41, 8))
    assert calls[-1][2] and out["torch"][2] == "pipeline_stage"
    assert out["torch"][4] == 40


def test_prefix_fetch_and_prefill_hooks_match_jax(params):
    out = {}
    for pkg in ("jax", "torch"):
        owner_j, owner_t = _engines(params)
        dest_j, dest_t = _engines(params)
        owner, dest = (owner_j, dest_j) if pkg == "jax" else (owner_t,
                                                              dest_t)
        R = JaxRequest if pkg == "jax" else Request
        owner.generate([PROMPT], _greedy(pkg, 2))
        asked, done = [], []

        def fetch(req, hashes, owner=owner, pkg=pkg):
            asked.append(len(hashes))
            pages = owner.kv.lookup_prefix(hashes)
            content = owner.kv.extract_pages(pages)
            if pkg == "torch":
                content = torch_kv.payload_numpy(content)
            return {"hashes": hashes[:len(pages)], "pages": content}
        dest.prefix_fetch_hook = fetch
        dest.on_prefill_complete = lambda r: done.append(r.request_id)
        dest.expect_pure_decode = True
        req = R("x", list(PROMPT) + [3, 5], _greedy(pkg, 6))
        req.prefix_owner = 0
        assert dest.scheduler.add_request(req)
        dest.run_until_idle()
        st = dest.stats()
        out[pkg] = (asked, done, req.generated_tokens,
                    st["prefix_fetched_tokens"], st["prefill_tokens"],
                    st["unexpected_prefills"], st["requeue_cached_tokens"])
    assert out["torch"] == out["jax"]
    assert out["torch"][3] == 16 and out["torch"][5] == 1
