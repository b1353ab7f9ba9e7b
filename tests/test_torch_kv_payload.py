"""KV payloads of the port's PagedKVCache against the JAX cache's.

Both caches (gpt-test geometry, pages of 8 tokens, 20 pages) get the same
page content, made from a numpy seed: bf16 and fp32 values, int8 values
with fp32 scales, packed int4 bytes with fp32 scales; and the same
allocations, so their block tables agree. Then, with no tolerance:

- every payload that the port extracts equals the JAX payload of the same
  request byte for byte (a bf16 array compared as its uint16 view), with
  the same shapes;
- a restore writes the pages back bit for bit, and leaves the port's pool
  equal to the JAX pool after the same restore (past scratch page 0); a
  JAX payload restores into the port's cache;
- every out-of-range request and malformed payload raises ValueError in
  both caches, and the port allocates nothing for it.

Then swap preemption in the engine (the JAX package's
tests/test_admission.py TestSwapPreemption): two 16-token prompts, 40 new
tokens each, 10 usable pages of 8 tokens, so on-demand growth must preempt.
A stream preempted by swap equals the same stream never preempted (the port
with 64 pages) and the JAX engine's, token for token, greedy and seeded,
in every quantization x kv_quantization pair, and no prefill token is spent
on the resume. The pool here only sees dense prefill and T = 1 decode
writes, so int4 pages stay within what the JAX engine writes right
(ROADMAP queue 3 item 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.models import (
    init as jax_init)
from distributed_llm_training_and_inference_system_tpu.ops import (
    paged_attention as jpa, quantization as jq)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, Request as JaxRequest,
    SamplingParams as JaxSampling, kv_cache as jax_kv)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    paged_attention as tpa)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, Request, SamplingParams, kv_cache as torch_kv)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

KINDS = ["bfloat16", "float32", "int8", "int4"]
GEOM = dict(num_slots=6, max_seq_len=64, page_size=8, num_pages=20)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """gpt-test's matrices are tiny: one intra-op thread runs them as fast
    as many, and keeps parallel test workers from oversubscribing the
    cores (which slowed this module 10-30x in a full parallel run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _content(cfg, kind, seed):
    """numpy content of one page buffer of the given kind: (values, scale
    or None)."""
    rs = np.random.RandomState(seed)
    shape = (cfg.num_layers, GEOM["num_pages"], cfg.num_kv_heads,
             GEOM["page_size"], cfg.head_dim)
    if kind == "int8":
        return (rs.randint(-127, 128, shape).astype(np.int8),
                rs.rand(*shape[:-1]).astype(np.float32))
    if kind == "int4":
        packed = (*shape[:-2], shape[-2] // 2, shape[-1])
        return (rs.randint(0, 256, packed).astype(np.uint8),
                rs.rand(*shape[:-1]).astype(np.float32))
    return rs.randn(*shape).astype(np.float32), None


def _caches(kind):
    """(JAX cache, port cache) holding the same pages."""
    quant = kind if kind in ("int8", "int4") else "none"
    jdt = jnp.bfloat16 if kind == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if kind == "bfloat16" else torch.float32
    jc = jax_kv.PagedKVCache(jax_cfg("gpt-test"), **GEOM, dtype=jdt,
                             quantized=quant)
    tc = torch_kv.PagedKVCache(torch_cfg("gpt-test"), **GEOM, dtype=tdt,
                               device="cpu", quantized=quant)
    for name, seed in (("k_pages", 1), ("v_pages", 2)):
        values, scale = _content(jax_cfg("gpt-test"), kind, seed)
        if scale is None:
            setattr(jc, name, jnp.asarray(values, jdt))
            setattr(tc, name, torch.from_numpy(values).to(tdt))
        else:
            jt = jpa.Int4Pages if kind == "int4" else jpa.QuantPages
            tt = tpa.Int4Pages if kind == "int4" else tpa.QuantPages
            setattr(jc, name, jt(jnp.asarray(values), jnp.asarray(scale)))
            setattr(tc, name, tt(torch.from_numpy(values),
                                 torch.from_numpy(scale)))
    for c in (jc, tc):
        c.allocate(0, 20)        # 3 pages
        c.allocate(1, 9)         # 2 pages
    np.testing.assert_array_equal(jc.block_tables, tc.block_tables)
    return jc, tc


def _bytes(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _assert_same_payload(jax_payload, torch_payload):
    got = torch_kv.payload_numpy(torch_payload)
    assert got["num_pages"] == jax_payload["num_pages"]
    for name in ("k", "v"):
        want, have = jax_payload[name], got[name]
        if isinstance(want, dict):
            assert set(have) == set(want) == {"values", "scale"}
            pairs = [(want[p], have[p]) for p in ("values", "scale")]
        else:
            pairs = [(want, have)]
        for w, h in pairs:
            w = _bytes(w)
            assert h.dtype == w.dtype and h.shape == w.shape
            assert h.tobytes() == w.tobytes()


def _pool_numpy(cache, jax_side):
    """Every pool tensor past scratch page 0 (JAX's bucketed restore pads
    with page 0 and writes zeros there; the port leaves it alone)."""
    out = []
    for buf in (cache.k_pages, cache.v_pages):
        parts = (buf.values, buf.scale) if isinstance(
            buf, (jpa.QuantPages, tpa.QuantPages)) else (buf,)
        for p in parts:
            if jax_side:
                out.append(_bytes(p)[:, 1:])
            else:
                out.append((p.view(torch.uint16) if p.dtype == torch.bfloat16
                            else p).numpy()[:, 1:])
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_extracted_payloads_equal_jax_bytes(kind):
    jc, tc = _caches(kind)
    chain0 = [int(p) for p in tc.block_tables[0, :3]]
    for call in (lambda c: c.extract_slot(0),
                 lambda c: c.extract_slot(1),
                 lambda c: c.extract_slot_pages(0, 1, 3),
                 lambda c: c.extract_slot_pages(1, 2, 2),
                 lambda c: c.extract_pages(chain0[::-1])):
        _assert_same_payload(call(jc), call(tc))


@pytest.mark.parametrize("kind", KINDS)
def test_restore_round_trips_bit_for_bit(kind):
    jc, tc = _caches(kind)
    jp, tp = jc.extract_slot(0), tc.extract_slot(0)
    original = torch_kv.payload_numpy(tp)
    for c, p in ((jc, jp), (tc, tp)):
        c.release(0)
        c.allocate(3, 30)        # takes the released pages first
        assert c.restore_slot(2, p)
    np.testing.assert_array_equal(jc.block_tables, tc.block_tables)
    # the restored chain holds the extracted bytes ...
    _assert_same_payload(
        {"k": original["k"], "v": original["v"], "num_pages": 3},
        tc.extract_slot(2))
    # ... and the whole pool equals the JAX pool after the same steps
    for a, b in zip(_pool_numpy(jc, True), _pool_numpy(tc, False)):
        assert a.tobytes() == b.tobytes()
    # a partial write into an allocated chain
    tc.write_slot_pages(1, tc.extract_slot_pages(2, 0, 1), lo=1)
    written = torch_kv.payload_numpy(tc.extract_slot_pages(2, 0, 1))
    _assert_same_payload(written, tc.extract_slot_pages(1, 1, 2))


@pytest.mark.parametrize("kind", KINDS)
def test_jax_payload_restores_into_the_port(kind):
    jc, tc = _caches(kind)
    jp = jc.extract_slot(0)

    def as_port_input(node):      # bf16 crosses as its uint16 view
        if isinstance(node, dict):
            return {k: as_port_input(v) for k, v in node.items()}
        return _bytes(node)
    payload = {"k": as_port_input(jp["k"]), "v": as_port_input(jp["v"]),
               "num_pages": jp["num_pages"]}
    assert tc.restore_slot(2, payload)
    _assert_same_payload(jp, tc.extract_slot(2))


@pytest.mark.parametrize("kind", ["bfloat16", "int4"])
def test_restore_into_a_full_pool_allocates_nothing(kind):
    jc, tc = _caches(kind)
    for c in (jc, tc):
        payload = c.extract_slot(0)
        c.allocate(2, 64)
        c.allocate(3, (c.free_pages - 2) * 8)     # 2 pages left, 3 needed
        free = c.free_pages
        assert c.restore_slot(4, payload) is False
        assert c.free_pages == free and 4 not in c._owned


def _malformed(kind, cache, payload_of):
    """(label, callable, message fragment) cases over one cache; each
    payload is built from that cache's own extract."""
    def swap(part, value):
        p = dict(payload_of(cache))
        p[part] = value
        return p

    def shape_cut():
        p = payload_of(cache)
        k = p["k"]
        if isinstance(k, dict):
            return dict(p, k=dict(k, values=k["values"][:, :1]))
        return dict(p, k=k[:, :1])

    def quant_swap():
        p = payload_of(cache)
        if isinstance(p["k"], dict):          # plain data for a quant pool
            return dict(p, k=p["k"]["values"])
        return dict(p, k={"values": p["k"], "scale": p["k"][..., 0]})

    return [
        ("range past the chain", lambda: cache.extract_slot_pages(0, 0, 4),
         "outside slot 0's chain"),
        ("range reversed", lambda: cache.extract_slot_pages(0, 2, 1),
         "outside slot 0's chain"),
        ("range negative", lambda: cache.extract_slot_pages(1, -1, 1),
         "outside slot 1's chain"),
        ("scratch page", lambda: cache.extract_pages([1, 0]),
         r"page id\(s\) \[0\] outside"),
        ("page past the pool", lambda: cache.extract_pages([20]),
         r"page id\(s\) \[20\] outside"),
        ("not a dict", lambda: cache.restore_slot(2, [1, 2]),
         "must be a dict"),
        ("no k", lambda: cache.restore_slot(2, {"v": 0, "num_pages": 1}),
         "must be a dict with 'k', 'v' and 'num_pages'"),
        ("num_pages not an int",
         lambda: cache.restore_slot(2, swap("num_pages", "three")),
         # JAX's restore_slot calls int() before its own check
         "num_pages must be an int|invalid literal for int"),
        ("num_pages negative",
         lambda: cache.restore_slot(2, swap("num_pages", -1)), "< 0"),
        ("wrong shape", lambda: cache.restore_slot(2, shape_cut()),
         "shape"),
        ("wrong kind", lambda: cache.restore_slot(2, quant_swap()),
         "quantized"),
        ("past the chain on write",
         lambda: cache.write_slot_pages(1, payload_of(cache), lo=0),
         "owns only 2 page"),
    ]


@pytest.mark.parametrize("case", range(12))
@pytest.mark.parametrize("kind", KINDS)
def test_bad_ranges_ids_and_payloads_raise_in_both(kind, case):
    jc, tc = _caches(kind)
    for c in (jc, tc):
        label, call, fragment = _malformed(
            kind, c, lambda cc: cc.extract_slot(0))[case]
        free, owned = c.free_pages, dict(c._owned)
        with pytest.raises(ValueError, match=fragment):
            call()
        if c is tc:      # the port validates before it allocates
            assert c.free_pages == free and c._owned == owned, label


def test_int8_payload_into_an_int4_pool_is_refused():
    _, t8 = _caches("int8")
    j4, t4 = _caches("int4")
    payload = t8.extract_slot(0)
    payload["k"] = dict(payload["k"], values=payload["k"]["values"][
        ..., :4, :])     # the packed shape, the wrong dtype
    payload["v"] = payload["k"]
    with pytest.raises(ValueError, match="dtype"):
        t4.restore_slot(2, payload)
    jp = j4.extract_slot(0)
    jp["k"] = dict(jp["k"], values=np.asarray(jp["k"]["values"]).view(
        np.int8))
    with pytest.raises(ValueError, match="dtype"):
        j4.restore_slot(2, jp)


# -- swap preemption in the engine ------------------------------------------

SERVE = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
             prefill_chunk=32, kv_block_size=8, dtype="float32",
             decode_steps_per_dispatch=4)
SWAP = dict(admission="ondemand", preemption="swap", kv_num_blocks=11)
PROMPTS = [[7 + i, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
            67] for i in range(2)]
GEN = 40
COMBOS = [("none", "none"), ("int8", "none"), ("int4", "none"),
          ("none", "int8"), ("none", "int4"), ("int8", "int8"),
          ("int4", "int4"), ("int8", "int4"), ("int4", "int8")]
SAMPLINGS = {"greedy": dict(temperature=0.0, max_tokens=GEN),
             "seeded": dict(temperature=0.9, top_k=20, max_tokens=GEN,
                            seed=77)}


@pytest.fixture(scope="module")
def params():
    return jax_init(jax_cfg("gpt-test"), jax.random.PRNGKey(0))


def _quantized(params, kind):
    """The JAX engine's own quantization of the tree (both engines are fed
    the same quantized bytes)."""
    if kind == "int8":
        return dict(params, blocks=jq.to_runtime_quant(
            jq.quantize_tree_int8(params["blocks"], min_ndim=3)))
    if kind == "int4":
        return jq.to_runtime_quant(jq.quantize_tree_int4(dict(params)))
    return params


def _engines(params, quantization="none", kv="none", **over):
    tree = _quantized(params, quantization)
    kw = dict(SERVE, quantization=quantization, kv_quantization=kv, **over)
    je = JaxEngine(jax_cfg("gpt-test"), jax_schema.ServeConfig(**kw),
                   params=tree, seed=0)
    te = InferenceEngine(
        torch_cfg("gpt-test"), ServeConfig(**kw),
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                               torch_cfg("gpt-test"), device="cpu"),
        seed=0, device="cpu")
    return je, te


def _tokens(reqs):
    return [r.generated_tokens for r in reqs]


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("quantization,kv", COMBOS)
def test_swap_resume_matches_unconstrained_and_jax(params, quantization, kv,
                                                   sampling):
    sp = SAMPLINGS[sampling]
    _, big = _engines(params, quantization, kv, kv_num_blocks=64)
    want = _tokens(big.generate(PROMPTS, SamplingParams(**sp)))
    je, te = _engines(params, quantization, kv, **SWAP)
    ref = _tokens(je.generate(PROMPTS, JaxSampling(**sp)))
    got = _tokens(te.generate(PROMPTS, SamplingParams(**sp)))
    assert got == want == ref
    st, rst = te.stats(), je.stats()
    assert st["preemptions"] == rst["preemptions"] > 0
    assert st["swap_ins"] == rst["swap_ins"] > 0, "no swap-in happened"
    assert st["swap_outs"] == st["swap_ins"] and st["swap_fallbacks"] == 0
    # the resume spent no prefill: the two 16-token prompts only
    assert st["prefill_tokens"] == rst["prefill_tokens"] == 2 * 16
    assert st["decode_steps"] == rst["decode_steps"]
    assert st["kv"]["free_pages"] == te.kv.num_pages - 1


def test_swap_bookkeeping_matches_jax_step_by_step(params):
    """Both engines stepped in lockstep: queue, residency, swapped host
    bytes and the pool agree after every step."""
    je, te = _engines(params, **SWAP)
    for i, p in enumerate(PROMPTS):
        assert je.scheduler.add_request(JaxRequest(
            f"r{i}", list(p), JaxSampling(**SAMPLINGS["greedy"])))
        assert te.scheduler.add_request(Request(
            f"r{i}", list(p), SamplingParams(**SAMPLINGS["greedy"])))
    seen_swapped = 0
    for _ in range(200):
        je.step()
        te.step()
        st, rst = te.stats(), je.stats()
        for key in ("queue_depth", "active", "preemptions", "swap_ins",
                    "swapped_host_bytes", "decode_steps", "prefill_tokens"):
            assert st[key] == rst[key], key
        assert st["kv"]["free_pages"] == rst["kv"]["free_pages"]
        seen_swapped = max(seen_swapped, st["swapped_host_bytes"])
        if st["active"] == 0 and st["queue_depth"] == 0:
            break
    # the victim's chain held 5 pages when it was swapped out; K and V, 2
    # layers x 2 kv heads x 8 page slots x 16 fp32 each
    assert seen_swapped == te.total_swap_out_bytes == \
        2 * 5 * 2 * 2 * 8 * 16 * 4


def test_swap_space_budget_falls_back_to_recompute(params):
    je, te = _engines(params, swap_space_gb=0.0, **SWAP)
    sp = SAMPLINGS["greedy"]
    ref = _tokens(je.generate(PROMPTS, JaxSampling(**sp)))
    got = _tokens(te.generate(PROMPTS, SamplingParams(**sp)))
    assert got == ref
    st = te.stats()
    assert st["preemptions"] > 0 and st["swap_ins"] == st["swap_outs"] == 0
    assert st["prefill_tokens"] == je.stats()["prefill_tokens"] > 2 * 16


@pytest.mark.parametrize("fault", ["malformed", "pool full"])
def test_failed_swap_in_falls_back_to_reprefill(params, fault, monkeypatch):
    """A payload that the restore refuses, or a pool that cannot take it,
    re-prefills from the tokens: counted, same tokens, no page leaked."""
    _, big = _engines(params, kv_num_blocks=64)
    sp = SamplingParams(**SAMPLINGS["greedy"])
    want = _tokens(big.generate(PROMPTS, sp))
    _, te = _engines(params, **SWAP)
    if fault == "malformed":
        extract = te.kv.extract_slot
        monkeypatch.setattr(te.kv, "extract_slot", lambda slot: dict(
            extract(slot), num_pages="six"))
    else:
        monkeypatch.setattr(te.kv, "restore_slot", lambda slot, c: False)
    assert _tokens(te.generate(PROMPTS, sp)) == want
    st = te.stats()
    assert st["swap_fallbacks"] == st["swap_outs"] > 0 and st["swap_ins"] == 0
    assert st["prefill_tokens"] > 2 * 16
    assert te.kv.free_pages == te.kv.num_pages - 1


@pytest.mark.parametrize("what", ["pipeline_stage", "partial"])
def test_fleet_requests_are_refused_naming_the_item(params, what):
    _, te = _engines(params)
    req = Request("fleet", list(PROMPTS[0]), SamplingParams(max_tokens=4))
    if what == "pipeline_stage":
        req.pipeline_stage = {"stage": 0}
    else:
        req.swapped_kv = {"partial": True, "positions": 8, "pages": {}}
    ok = Request("ok", list(PROMPTS[1]), SamplingParams(temperature=0.0,
                                                        max_tokens=4))
    assert te.scheduler.add_request(req) and te.scheduler.add_request(ok)
    te.run_until_idle()
    assert req.state.value == "failed" and "item 9" in req.error
    assert len(ok.generated_tokens) == 4
    assert te.kv.free_pages == te.kv.num_pages - 1
