"""The port's ServeFleet against the JAX package's, engine-backed: the
courier under chaos, disaggregation, streams and pipelined prefill (the
arms of the JAX package's tests/test_fleet.py, test_fleet_streams.py and
test_pipeline_prefill.py). Both fleets on the same params (gpt-test,
fp32, CPU), requests and FaultPlan give the same tokens, which are also
one undisturbed engine's.

- drain migration under seeded chunk drop, corruption, delay and
  duplication, with codec none and delta-zlib: 0 re-prefill tokens,
  resends counted, no abort; a link that drops everything aborts and the
  streams re-prefill;
- disaggregated prefill and decode roles: every sequence handed off with
  its KV, the decode replica prefills nothing;
- exactly-once streams across a drain migration: the stream hub's tokens
  equal the completion, no gap, no duplicate;
- a long prompt's prefill pipelined over both replicas;
- under int8 weight quantization the replicas share replica 0's
  quantized model.

Chunk faults come from the FaultPlan's seed; every wait is bounded; every
fleet is shut down by the ``fleets`` fixture.
"""

import threading

import pytest

from torch_fleet_harness import (  # noqa: F401  (fixtures)
    PKGS, PROMPTS, _one_thread, await_all, fleets, ledger_balanced,
    make_fleet, params, prefill_tokens, reference, submit, wait_until)

GREEDY = dict(temperature=0.0, max_tokens=48)
CHAOS_KW = dict(courier_chunk_bytes=1024, courier_max_retries=12,
                courier_retry_backoff_ms=0.2,
                courier_retry_backoff_max_ms=2.0,
                courier_chunk_deadline_ms=20.0)
CHAOS_PLAN = dict(seed=5, chunk_drop_rate=0.2, chunk_corrupt_rate=0.15,
                  chunk_delay_rate=0.1, chunk_delay_ms=30.0,
                  chunk_duplicate_rate=0.1)


def _drain_mid_decode(fleet, pkg, prompts, sampling, stream=False):
    reqs, events = submit(fleet, pkg, prompts, sampling, stream=stream)
    wait_until(lambda: all(len(r.generated_tokens) >= 2 or e.is_set()
                           for r, e in zip(reqs, events)), "decode")
    src = next(r.replica_id for r in fleet.replicas
               if r.resident_requests())
    pre = prefill_tokens(fleet)
    assert fleet.drain(src)
    await_all(fleet, events)
    return reqs, prefill_tokens(fleet) - pre


@pytest.mark.parametrize("codec", ["none", "delta-zlib"])
def test_drain_migration_under_chunk_chaos(params, fleets, codec):
    want = reference("jax", params, PROMPTS[:4], GREEDY)
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params, warm=True, plan=CHAOS_PLAN,
                           courier_codec=codec, **CHAOS_KW)
        reqs, reprefilled = _drain_mid_decode(fleet, pkg, PROMPTS[:4],
                                              GREEDY)
        cour = fleet.status()["courier"]
        out[pkg] = ([r.generated_tokens for r in reqs], reprefilled,
                    cour["transfers"] >= 1, cour["retries"] >= 1,
                    cour["aborts"], cour["bytes_wire"] > 0,
                    ledger_balanced(fleet.router.stats()))
    assert out["torch"] == out["jax"] == (want, 0, True, True, 0, True,
                                          True)


def test_a_lost_link_aborts_and_the_streams_reprefill(params, fleets):
    sp = dict(GREEDY, max_tokens=64)
    want = reference("jax", params, PROMPTS[:4], sp)
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params, warm=True,
                           plan=dict(seed=2, chunk_drop_rate=1.0),
                           courier_chunk_bytes=1024, courier_max_retries=1,
                           courier_retry_backoff_ms=0.2,
                           courier_retry_backoff_max_ms=1.0,
                           courier_chunk_deadline_ms=20.0)
        reqs, reprefilled = _drain_mid_decode(fleet, pkg, PROMPTS[:4], sp)
        cour = fleet.status()["courier"]
        st = fleet.router.stats()
        out[pkg] = ([r.generated_tokens for r in reqs], reprefilled > 0,
                    cour["aborts"] >= 1, cour["transfers"], st["failed"],
                    ledger_balanced(st))
    assert out["torch"] == out["jax"] == (want, True, True, 0, 0, True)


@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "chaos"])
def test_disaggregated_handoff(params, fleets, chaos):
    sp = dict(GREEDY, max_tokens=20)
    want = reference("jax", params, PROMPTS[:4], sp)
    out = {}
    for pkg in ("jax", "torch"):
        kw = dict(CHAOS_KW, courier_codec="delta-zlib") if chaos else {}
        fleet = make_fleet(fleets, pkg, params, warm=True,
                           plan=CHAOS_PLAN if chaos else None,
                           roles="prefill,decode", **kw)
        reqs, events = submit(fleet, pkg, PROMPTS[:4], sp)
        await_all(fleet, events)
        snap = fleet.status()
        out[pkg] = ([r.generated_tokens for r in reqs],
                    snap["handoff"]["handoffs"],
                    snap["courier"]["transfers"] >= 4,
                    snap["courier"]["aborts"],
                    fleet.replicas[1].engine.total_prefill_tokens,
                    prefill_tokens(fleet))
    assert out["torch"] == out["jax"] == (
        want, 4, True, 0, 0, sum(len(p) for p in PROMPTS[:4]))


class Recorder:
    """A stream subscriber that counts gaps and duplicates."""

    def __init__(self):
        self.tokens, self.next_seq, self.gaps, self.dups = [], 0, 0, 0
        self.finished = threading.Event()

    def __call__(self, ev):
        if ev[0] != "tokens":
            self.finished.set()
            return
        _k, start, toks = ev
        self.gaps += start > self.next_seq
        self.dups += start < self.next_seq
        self.tokens.extend(toks)
        self.next_seq = start + len(toks)


def test_streams_are_exactly_once_across_a_drain(params, fleets):
    seeded = dict(temperature=0.8, seed=123, max_tokens=48)
    want = reference("jax", params, PROMPTS[:4], seeded)
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params, warm=True)
        reqs, events = submit(fleet, pkg, PROMPTS[:4], seeded, stream=True)
        recs = []
        for r in reqs:
            rec = Recorder()
            sub = fleet.streams.subscribe(r.request_id, 0, rec)
            if sub["tokens"]:
                rec(("tokens", sub["start"], sub["tokens"]))
            if sub["finished"]:
                rec.finished.set()
            recs.append(rec)
        wait_until(lambda: all(len(r.generated_tokens) >= 2 or e.is_set()
                               for r, e in zip(reqs, events)), "decode")
        assert fleet.drain(0)
        wait_until(lambda: all(e.is_set() for e in events)
                   and all(r.finished.is_set() for r in recs),
                   "streams", fleet)
        snap = fleet.status()
        out[pkg] = ([r.tokens for r in recs],
                    [r.generated_tokens for r in reqs],
                    sum(r.gaps + r.dups for r in recs),
                    snap["migration"]["migrations"] >= 1,
                    snap["streams"]["identity_mismatches"])
    assert out["torch"] == out["jax"] == (want, want, 0, True, 0)


def test_a_long_prompt_prefills_over_both_replicas(params, fleets):
    long = [(i * 7 + 3) % 50 + 1 for i in range(100)]
    sp = dict(temperature=0.0, max_tokens=12)
    want = reference("jax", params, [long], sp, max_seq_len=128,
                     chunked_prefill_tokens=16)
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params, warm=True,
                           serve_kw=dict(max_seq_len=128,
                                         chunked_prefill_tokens=16),
                           courier_chunk_bytes=1024,
                           pipeline_prefill_min_tokens=48,
                           pipeline_prefill_max_stages=2)
        for r in fleet.replicas:
            r.engine.total_prefix_cached_tokens = 0
        reqs = fleet.generate([long], PKGS[pkg].Sampling(**sp),
                              timeout_s=120)
        pl = fleet.pipeline.snapshot()
        out[pkg] = ([r.generated_tokens for r in reqs], pl["pipelines"],
                    pl["completed"], pl["collapses"], pl["stages"],
                    pl["preshipped_pages"] >= 1,
                    sorted(r.engine.total_prefill_tokens
                           for r in fleet.replicas),
                    sorted(r.engine.total_prefix_cached_tokens
                           for r in fleet.replicas))
    assert out["torch"] == out["jax"] == (want, 1, 1, 0, 2, True, [48, 52],
                                          [0, 48])


def test_quantized_replicas_share_replica_zeros_model(params, fleets):
    """Replica 0 quantizes; replica 1 serves replica 0's quantized model
    (one copy), and the tokens are the JAX fleet's."""
    sp = dict(temperature=0.0, max_tokens=12)
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params,
                           serve_kw={"quantization": "int8"})
        out[pkg] = [r.generated_tokens for r in fleet.generate(
            PROMPTS[:2], PKGS[pkg].Sampling(**sp), timeout_s=120)]
        if pkg == "torch":
            a, b = (r.engine.params for r in fleet.replicas)
            assert a is b and a is not params["torch"]
            assert {r.engine.quantization for r in fleet.replicas} == {
                "int8"}
    assert out["torch"] == out["jax"]
