"""Chunked prefill and n-gram speculative decoding in the port's engine,
against the JAX engine.

gpt-test in fp32 on bridged params (the JAX package's
tests/test_chunked_prefill.py and tests/test_speculative.py setting: 4
slots, max_seq_len 128, pages of 8 tokens). Tolerance: none. Greedy and
seeded output must be token-identical to the JAX engine's, and chunked
prefill and speculation must give the same tokens as the same engine with
the feature off; the engines' counters (prefill tokens, decode steps,
speculative dispatches, drafts and accepted drafts) must agree too.

On int4 KV pages a chunk longer than a page meets the JAX scatter that
loses a nibble (ROADMAP queue 3 item 5): there, chunks of one page are held
against JAX, and longer chunks against the port's own dense prefill.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hs

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.models import (
    init as jax_init)
from distributed_llm_training_and_inference_system_tpu.ops import (
    quantization as jq)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, Request as JaxRequest,
    SamplingParams as JaxSampling)
from distributed_llm_training_and_inference_system_tpu.serve import (
    speculative as jspec)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, Request, SamplingParams, decode as tdecode)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    speculative as tspec)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

SERVE = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
             prefill_chunk=32, kv_block_size=8, dtype="float32")
LONG = [int(t) for t in np.random.default_rng(3).integers(1, 250, 64)]
REPETITIVE = [7, 8, 9, 10, 7, 8, 9, 10, 7, 8, 9, 10, 7, 8]
RANDOM = [5, 17, 99, 3, 42, 250, 23]
COMBOS = [("none", "none"), ("int8", "none"), ("int4", "none"),
          ("none", "int8"), ("none", "int4"), ("int8", "int8"),
          ("int4", "int4"), ("int8", "int4"), ("int4", "int8")]
GREEDY = dict(temperature=0.0)
SEEDED = dict(temperature=0.8, top_k=20, seed=123)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """gpt-test's matrices are tiny: one intra-op thread runs them as fast
    as many, and keeps parallel test workers from oversubscribing the
    cores (which slowed this module 10-30x in a full parallel run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return jax_init(jax_cfg("gpt-test"), jax.random.PRNGKey(0))


def _quantized(params, kind):
    if kind == "int8":
        return dict(params, blocks=jq.to_runtime_quant(
            jq.quantize_tree_int8(params["blocks"], min_ndim=3)))
    if kind == "int4":
        return jq.to_runtime_quant(jq.quantize_tree_int4(dict(params)))
    return params


_TORCH_PARAMS = {}


def _torch_params(params, quantization):
    if quantization not in _TORCH_PARAMS:
        tree = _quantized(params, quantization)
        _TORCH_PARAMS[quantization] = params_from_jax(
            jax.tree_util.tree_map(np.asarray, tree), torch_cfg("gpt-test"),
            device="cpu")
    return _TORCH_PARAMS[quantization]


def _jax(params, quantization="none", **over):
    kw = dict(SERVE, quantization=quantization, **over)
    return JaxEngine(jax_cfg("gpt-test"), jax_schema.ServeConfig(**kw),
                     params=_quantized(params, quantization), seed=0)


def _port(params, quantization="none", **over):
    kw = dict(SERVE, quantization=quantization, **over)
    return InferenceEngine(torch_cfg("gpt-test"), ServeConfig(**kw),
                           params=_torch_params(params, quantization),
                           seed=0, device="cpu")


def _run(engine, prompts, **sampling):
    sp = (JaxSampling if isinstance(engine, JaxEngine)
          else SamplingParams)(**sampling)
    return [r.generated_tokens for r in engine.generate(prompts, sp)]


def _same_stats(te, je, keys=("prefill_tokens", "decode_steps",
                              "prefix_cached_tokens", "spec_dispatches",
                              "spec_drafts", "spec_accepted",
                              "spec_resumes", "preemptions")):
    st, rst = te.stats(), je.stats()
    for key in keys:
        assert st[key] == rst[key], (key, st[key], rst[key])
    return st


# -- chunked prefill ---------------------------------------------------------

CHUNKED = dict(decode_steps_per_dispatch=2)


@pytest.mark.parametrize("sampling", ["greedy", "seeded"])
@pytest.mark.parametrize("C", [8, 24])
@pytest.mark.parametrize("quantization,kv", COMBOS)
def test_chunked_prefill_matches_dense_and_jax(params, quantization, kv, C,
                                               sampling):
    sp = dict(GREEDY if sampling == "greedy" else SEEDED, max_tokens=8)
    prompts = [LONG, LONG[:10], LONG[5:50]]
    over = dict(CHUNKED, kv_quantization=kv)
    dense = _run(_port(params, quantization, **over), prompts, **sp)
    te = _port(params, quantization, chunked_prefill_tokens=C, **over)
    assert _run(te, prompts, **sp) == dense
    st = te.stats()
    chunked = [len(p) for p in prompts if len(p) > C]
    assert st["chunked_prefills"] == len(chunked)
    assert st["prefill_chunks"] == sum(-(-n // C) for n in chunked)
    if kv == "int4" and C > 8:
        return       # JAX's int4 scatter drops a nibble past one page
    je = _jax(params, quantization, chunked_prefill_tokens=C, **over)
    assert _run(je, prompts, **sp) == dense
    _same_stats(te, je)


def test_short_prompts_stay_on_single_dispatch(params):
    eng = _port(params, chunked_prefill_tokens=32, **CHUNKED)
    out = _run(eng, [LONG[:16]], temperature=0.0, max_tokens=4)
    assert out == _run(_jax(params, **CHUNKED), [LONG[:16]],
                       temperature=0.0, max_tokens=4)
    assert not eng._partial_prefills
    assert eng.stats()["prefill_chunks"] == 0


def _both(params, **over):
    return _jax(params, **over), _port(params, **over)


def _add(engines, rid, prompt, **sampling):
    je, te = engines
    assert je.scheduler.add_request(JaxRequest(rid, list(prompt),
                                               JaxSampling(**sampling)))
    req = Request(rid, list(prompt), SamplingParams(**sampling))
    assert te.scheduler.add_request(req)
    return req


def test_resident_stream_advances_during_long_prefill(params):
    """Stream A keeps producing tokens while B's long prompt prefills chunk
    by chunk; both engines step in lockstep and agree after every step."""
    engines = _both(params, chunked_prefill_tokens=8, **CHUNKED)
    je, te = engines
    a = _add(engines, "a", LONG[:8], temperature=0.0, max_tokens=40)
    je.step()
    te.step()                                  # A prefilled + decoding
    before = len(a.generated_tokens)
    b = _add(engines, "b", LONG, temperature=0.0, max_tokens=4)
    je.step()
    te.step()                                  # B's first chunk + A decode
    assert b.state.value == "prefilling"
    assert len(a.generated_tokens) > before, \
        "resident stream stalled behind a chunked prefill"
    for _ in range(100):
        je.step()
        te.step()
        assert {r: s["done"] for r, s in te._partial_prefills.items()} == \
            {r: s["done"] for r, s in je._partial_prefills.items()}
        if te.scheduler.active_count == 0:
            break
    done = {r.request_id: r.generated_tokens for r in je.scheduler.completed}
    assert b.generated_tokens == done["b"] and len(done["b"]) == 4
    assert a.generated_tokens == done["a"] and len(done["a"]) == 40


def test_per_step_chunk_budget_round_robins(params):
    """N concurrent chunked prefills share one budget a step, charged in
    suffix buckets, resumed round-robin by request id: the port's progress
    equals JAX's after every step."""
    engines = _both(params, chunked_prefill_tokens=8,
                    prefill_budget_tokens=8, **CHUNKED)
    je, te = engines
    for rid in ("b1", "b2", "b3"):
        _add(engines, rid, LONG, temperature=0.0, max_tokens=2)
    for _ in range(40):
        before = {r: s["done"] for r, s in te._partial_prefills.items()}
        je.step()
        te.step()
        after = {r: s["done"] for r, s in te._partial_prefills.items()}
        assert after == {r: s["done"]
                         for r, s in je._partial_prefills.items()}
        assert te._chunk_rr == je._chunk_rr
        advanced = sum(after.get(r, 64) - d for r, d in before.items())
        assert advanced <= 8, f"budget exceeded: {before} -> {after}"
        if te.scheduler.active_count == 0 and not te.scheduler.waiting:
            break
    want = {r.request_id: r.generated_tokens for r in je.scheduler.completed}
    got = {r.request_id: r.generated_tokens for r in te.scheduler.completed}
    assert got == want and len(got) == 3


def test_cancel_mid_prefill_frees_slot_and_pages(params):
    eng = _port(params, chunked_prefill_tokens=8, **CHUNKED)
    free_before = eng.kv.free_pages
    b = Request("b", LONG, SamplingParams(temperature=0.0, max_tokens=4))
    assert eng.scheduler.add_request(b)
    eng.step()                                  # chunk 1 dispatched
    assert "b" in eng._partial_prefills
    assert eng.scheduler.cancel("b")            # marks cancel-pending
    eng.step()                                  # aborted at the boundary
    assert "b" not in eng._partial_prefills
    assert eng.scheduler.active_count == 0
    assert eng.kv.free_pages == free_before
    assert b.state.value == "cancelled"


def test_chunked_with_prefix_cache_and_speculation(params):
    """The JAX package's test_chunked_prefill.py:133 on both engines: the
    second run of the same long prompt chunks only past its cached pages."""
    over = dict(chunked_prefill_tokens=16, prefix_caching=True,
                speculative="ngram", speculative_tokens=4, **CHUNKED)
    je, te = _both(params, **over)
    for _ in range(2):
        want = _run(je, [LONG], temperature=0.0, max_tokens=6)
        assert _run(te, [LONG], temperature=0.0, max_tokens=6) == want
    assert want == _run(_port(params, **CHUNKED), [LONG], temperature=0.0,
                        max_tokens=6)
    st = _same_stats(te, je)
    assert st["kv"]["prefix_hits"] == je.stats()["kv"]["prefix_hits"] > 0
    assert st["prefix_cached_tokens"] > 0 and st["spec_dispatches"] > 0


def test_preempted_resume_chunks_its_whole_context(params):
    """A recompute-preempted request resumes with prompt + generated,
    which passes the chunk threshold; tokens equal JAX's and those of a
    pool that never preempts."""
    prompts = [LONG[:14], LONG[20:34], LONG[40:54]]
    over = dict(chunked_prefill_tokens=16, kv_num_blocks=12,
                decode_steps_per_dispatch=4)
    je, te = _both(params, **over)
    want = _run(je, prompts, temperature=0.0, max_tokens=30)
    got = _run(te, prompts, temperature=0.0, max_tokens=30)
    # request 1's generated token 5 has this test's smallest top-2 logit
    # gap, 1.57e-3, against 2.1e-7 between the two packages' logits: a
    # mismatch is a difference of schedule or state, not of rounding, so
    # it reports both engines' counters
    assert got == want, (got, want, te.stats(), je.stats())
    assert want == _run(_port(params, decode_steps_per_dispatch=4), prompts,
                        temperature=0.0, max_tokens=30)
    st = _same_stats(te, je)
    assert st["preemptions"] > 0 and st["chunked_prefills"] > 0


def test_swap_chunked_and_speculation_together(params):
    prompts = [REPETITIVE + LONG[:10], LONG[:16], REPETITIVE * 2]
    over = dict(chunked_prefill_tokens=16, speculative="ngram",
                speculative_tokens=4, admission="ondemand",
                preemption="swap", kv_num_blocks=14,
                decode_steps_per_dispatch=4)
    je, te = _both(params, **over)
    want = _run(je, prompts, temperature=0.0, max_tokens=36)
    assert _run(te, prompts, temperature=0.0, max_tokens=36) == want
    assert want == _run(_port(params, decode_steps_per_dispatch=4), prompts,
                        temperature=0.0, max_tokens=36)
    st = _same_stats(te, je, keys=("prefill_tokens", "decode_steps",
                                   "spec_dispatches", "spec_drafts",
                                   "spec_accepted", "spec_resumes",
                                   "preemptions", "swap_ins"))
    assert st["swap_ins"] > 0 and st["spec_dispatches"] > 0
    assert st["chunked_prefills"] > 0


# -- speculative decoding ----------------------------------------------------

@pytest.mark.parametrize("ctx,n,max_ngram", [
    ([1, 2, 3, 9, 9, 1, 2, 3], 2, 3),
    ([5, 1, 2, 7, 0, 1, 2, 8, 3, 1, 2], 1, 3),
    ([1, 2, 3, 4], 3, 3), ([7], 3, 3), ([4, 5, 4, 5], 4, 2),
    ([4, 5, 4, 5], 0, 2),
])
def test_ngram_proposer_cases_match_jax(ctx, n, max_ngram):
    ctx = np.asarray(ctx, np.int32)
    want = jspec.propose_ngram_draft(ctx, n, max_ngram)
    got = tspec.propose_ngram_draft(ctx, n, max_ngram)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and list(got) == list(want)


@settings(max_examples=300, deadline=None)
@given(ctx=hs.lists(hs.integers(0, 5), min_size=0, max_size=40),
       n=hs.integers(0, 9), max_ngram=hs.integers(1, 4))
def test_ngram_proposer_matches_jax_on_drawn_contexts(ctx, n, max_ngram):
    arr = np.asarray(ctx, np.int64)
    want = jspec.propose_ngram_draft(arr, n, max_ngram)
    got = tspec.propose_ngram_draft(arr, n, max_ngram)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_spec_state_matches_jax():
    T = 8
    j, t = jspec.SpecState(window=T), tspec.SpecState(window=T)
    rs = np.random.RandomState(5)
    for _ in range(40):
        acc, drafted = int(rs.randint(0, 8)), int(rs.randint(0, 8))
        j.observe(acc, drafted, max_window=T)
        t.observe(acc, drafted, max_window=T)
        assert t.to_dict() == j.to_dict()
    for d in ({"window": "x", "ewma": 3, "warmup": -2}, {"window": 99},
              {"ewma": "nan?", "drafts": "7"}, {}):
        assert tspec.SpecState.from_dict(d, T).to_dict() == \
            jspec.SpecState.from_dict(d, T).to_dict()


@pytest.mark.parametrize("T", [2, 4, 8])
@pytest.mark.parametrize("prompt", [REPETITIVE, RANDOM, LONG[:30]])
def test_greedy_bit_identical_with_speculation_and_to_jax(params, prompt, T):
    over = dict(speculative="ngram", speculative_tokens=T)
    off = _run(_port(params), [prompt], temperature=0.0, max_tokens=12)
    je, te = _jax(params, **over), _port(params, **over)
    assert _run(te, [prompt], temperature=0.0, max_tokens=12) == off
    assert _run(je, [prompt], temperature=0.0, max_tokens=12) == off
    st = _same_stats(te, je)
    assert st["spec_dispatches"] > 0


def test_perfect_drafts_fully_accepted(params):
    """The true argmax chain as the draft: every draft is accepted and the
    token after it emitted, n_emit == T (the JAX package's test on the
    port's speculative_verify)."""
    cfg = torch_cfg("gpt-test")
    model = _torch_params(params, "none")
    prompt = REPETITIVE
    chain = _run(_port(params), [prompt], temperature=0.0, max_tokens=5)[0]
    n, T = len(prompt), 4
    shape = (cfg.num_layers, 8, cfg.num_kv_heads, 8, cfg.head_dim)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    tables = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    tdecode.extend_step_forward(model, torch.tensor([prompt]),
                                torch.zeros(1, dtype=torch.int64), kp, vp,
                                tables, cfg)
    emitted, n_emit, nonfinite = tspec.speculative_verify(
        model, torch.tensor([chain[:T]]), torch.tensor([n]), kp, vp, tables,
        torch.tensor([n + 64]), torch.tensor([0]), np.zeros(1, np.float32),
        np.zeros(1, np.int64), np.ones(1, np.float32), cfg)
    assert int(n_emit[0]) == T and int(nonfinite) == 0
    assert emitted[0].tolist() == chain[1:1 + T]


def test_oracle_drafts_are_accepted_as_in_jax(params):
    """An injected draft_fn that proposes the true continuation: both
    engines accept the same drafts, and nearly every one."""
    truth = _run(_port(params), [RANDOM], temperature=0.0, max_tokens=24)[0]
    full = RANDOM + truth

    def oracle(ctx, n, _ngram):
        i = len(ctx)
        return np.asarray((full[i:i + n] + [0] * n)[:n], np.int32)
    over = dict(speculative="ngram", speculative_tokens=4)
    je, te = _jax(params, **over), _port(params, **over)
    je.draft_fn = te.draft_fn = oracle
    assert _run(te, [RANDOM], temperature=0.0, max_tokens=24) == [truth]
    assert _run(je, [RANDOM], temperature=0.0, max_tokens=24) == [truth]
    st = _same_stats(te, je)
    assert st["spec_accepted"] >= st["spec_drafts"] - 3


def test_sampled_requests_match_nonspec_engine_and_jax(params):
    sp = dict(temperature=0.8, top_k=20, max_tokens=8, seed=123)
    over = dict(speculative="ngram", speculative_tokens=4)
    off = _run(_port(params), [RANDOM], **sp)
    assert _run(_port(params, **over), [RANDOM], **sp) == off
    assert _run(_jax(params, **over), [RANDOM], **sp) == off


def test_mixed_greedy_and_sampled_batch_matches_jax(params):
    over = dict(speculative="ngram", speculative_tokens=4)
    engines = _both(params, **over)
    off = _port(params)
    greedy = dict(temperature=0.0, max_tokens=8)
    sampled = dict(temperature=0.9, max_tokens=8, seed=7)
    g = _add(engines, "g", REPETITIVE, **greedy)
    s = _add(engines, "s", RANDOM, **sampled)
    assert off.scheduler.add_request(Request("g", list(REPETITIVE),
                                             SamplingParams(**greedy)))
    assert off.scheduler.add_request(Request("s", list(RANDOM),
                                             SamplingParams(**sampled)))
    for eng in (*engines, off):
        eng.run_until_idle()
    want = {r.request_id: r.generated_tokens
            for r in engines[0].scheduler.completed}
    assert g.generated_tokens == want["g"] and s.generated_tokens == want["s"]
    assert {r.request_id: r.generated_tokens
            for r in off.scheduler.completed} == want
    _same_stats(engines[1], engines[0])


@pytest.mark.parametrize("T", [4, 6])
def test_max_tokens_respected(params, T):
    eng = _port(params, speculative="ngram", speculative_tokens=T)
    [req] = eng.generate([REPETITIVE], SamplingParams(temperature=0.0,
                                                      max_tokens=5))
    assert len(req.generated_tokens) == 5 and req.finish_reason == "length"


def test_engine_spec_stats_consistent(params):
    over = dict(speculative="ngram", speculative_tokens=4)
    je, te = _jax(params, **over), _port(params, **over)
    _run(je, [REPETITIVE], temperature=0.0, max_tokens=12)
    [out] = _run(te, [REPETITIVE], temperature=0.0, max_tokens=12)
    st = _same_stats(te, je)
    assert len(out) == 12
    assert 0 < st["spec_dispatches"] <= 11     # 1 from prefill, >= 1 each
    assert 0 <= st["spec_accepted"] <= st["spec_drafts"]
    assert st["spec_acceptance"] == je.stats()["spec_acceptance"]


@pytest.mark.parametrize("T,K,L", [(8, 8, 0), (4, 2, 0), (2, 8, 3),
                                   (16, 4, 0)])
def test_lookahead_spans_window_plus_decode(params, T, K, L):
    over = dict(speculative="ngram", speculative_tokens=T,
                decode_steps_per_dispatch=K, latency_dispatch_steps=L)
    te = _port(params, **over)
    assert te._decode_lookahead == _jax(params, **over)._decode_lookahead
    assert te._decode_lookahead >= T + K - 1
    off = _port(params, decode_steps_per_dispatch=K,
                latency_dispatch_steps=L)
    assert off._decode_lookahead == te._decode_lookahead or \
        te._decode_lookahead == T + K - 1


def test_speculation_under_page_pressure_matches_jax(params):
    """A tight on-demand pool: every speculative dispatch must find pages
    for its window and its decode steps (the lookahead), or the overflow
    rows would land in scratch and rot the stream."""
    prompts = [REPETITIVE, REPETITIVE[3:] + RANDOM, RANDOM * 2]
    over = dict(speculative="ngram", speculative_tokens=8, kv_num_blocks=16,
                decode_steps_per_dispatch=4)
    je, te = _both(params, **over)
    want = _run(je, prompts, temperature=0.0, max_tokens=40)
    assert _run(te, prompts, temperature=0.0, max_tokens=40) == want
    assert want == _run(_port(params, decode_steps_per_dispatch=4), prompts,
                        temperature=0.0, max_tokens=40)
    st = _same_stats(te, je)
    assert st["preemptions"] > 0 and st["spec_dispatches"] > 0


def test_adaptive_kill_switch_matches_jax(params):
    """Drafts that are always wrong: after 64 dispatches under
    speculative_min_acceptance, speculation switches off in both engines
    at the same dispatch, and the tokens still equal plain decode's."""
    over = dict(speculative="ngram", speculative_tokens=4,
                decode_steps_per_dispatch=1)
    je, te = _jax(params, **over), _port(params, **over)

    def wrong(ctx, n, _ngram):
        return np.full(n, (int(ctx[-1]) + 1) % 5 + 250, np.int32)
    je.draft_fn = te.draft_fn = wrong
    off = _run(_port(params, decode_steps_per_dispatch=1), [RANDOM],
               temperature=0.0, max_tokens=90)
    assert _run(te, [RANDOM], temperature=0.0, max_tokens=90) == off
    assert _run(je, [RANDOM], temperature=0.0, max_tokens=90) == off
    st = _same_stats(te, je)
    assert st["spec_dispatches"] == 64 and not te._spec_on


@pytest.mark.parametrize("quantization,kv", COMBOS)
def test_speculation_in_every_quantized_mode_matches_jax(params,
                                                         quantization, kv):
    """T = 4 windows fit a page, so int4 pages take the window write in
    both packages."""
    over = dict(speculative="ngram", speculative_tokens=4,
                kv_quantization=kv)
    prompts = [REPETITIVE, RANDOM, LONG[:20]]
    for sp in (dict(GREEDY, max_tokens=10), dict(SEEDED, max_tokens=10)):
        je = _jax(params, quantization, **over)
        te = _port(params, quantization, **over)
        want = _run(je, prompts, **sp)
        assert _run(te, prompts, **sp) == want
        assert want == _run(_port(params, quantization, kv_quantization=kv),
                            prompts, **sp)
        _same_stats(te, je)


def test_verify_window_rows_and_the_kernel_route():
    """A verify window of B * T rows reaches the W8/W4 kernels only up to
    64 rows (on a card); the engine's default window is exactly 64."""
    cfg = ServeConfig()
    assert cfg.max_batch_size * cfg.speculative_tokens == \
        tdecode.KERNEL_MAX_ROWS == 64


def test_a_budget_stop_keeps_no_reservation(params):
    """admit() stops at the prefill budget before it reserves pages: after
    the run nothing stays reserved or pinned and every page is free. (The
    JAX scheduler reserves first, and its engine ends this run with 5 pages
    reserved and one page pinned for good; ROADMAP queue 3 item 9.) The
    tokens equal the JAX engine's."""
    prompts = [list(range(1, 17))] * 3
    je, te = _both(params, prefill_budget_tokens=20)
    want = _run(je, prompts, temperature=0.0, max_tokens=4)
    assert _run(te, prompts, temperature=0.0, max_tokens=4) == want
    assert te._reserved_pages == 0 and not te._reserved_by
    assert not te._prefix_pins and int(te.kv._ref.sum()) == 0
    assert te.kv.free_pages == te.kv.num_pages - 1
    # the reference's fault, which the port does not copy
    assert je._reserved_pages == 5 and not je._reserved_by
    assert je.kv.free_pages == je.kv.num_pages - 2
