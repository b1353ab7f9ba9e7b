"""The fleet's tiered KV store on the port (serve/fleet/kv_store.py), held
to the JAX package's.

- The JAX package's ``tests/test_kv_store.py`` on the port's modules (its
  source with the package's name swapped). Left out, by name,
  ``test_eviction_fires_demote_hook``, which reads a bf16 page as
  ml_dtypes' bfloat16; its port counterpart below reads the
  ``BF16_HOST`` bits.
- The same bf16, int8 and int4 page payloads demoted into both packages'
  ``FleetKVStore`` give identical frames, ``.kvf`` spill files,
  inventories and snapshots, under the default codec and delta-zlib; each
  package's ``scan_disk`` indexes the other's spill directory and serves
  its pages byte for byte.
- Pages demoted and then overwritten at once on the device come back as
  they were demoted: the drain flush (``EngineReplica.
  _flush_inventory_to_store``, torch tensors filled by ``extract_pages``)
  and the eviction seam (``demote_hook``) both go through
  ``payload_numpy`` before a byte is encoded.
- The JAX regime ``serve.fleet2+kv-store``: both packages' fleets retire
  replica 0 into the store, restore a returning conversation tail-only,
  and fall back to a counted miss and a full prefill after a wipe, with
  equal tokens and counters.
"""

from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config.schema import (
    FleetConfig as JaxFleetConfig)
from distributed_llm_training_and_inference_system_tpu.serve.fleet import (
    kv_store as jkv_store, transport as jtransport)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.config.schema import (  # noqa: E501
    FleetConfig as TorchFleetConfig)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    kv_cache as tkv_cache)
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
    kv_store as tkv_store, transport as ttransport)
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.replica import (  # noqa: E501
    EngineReplica)
from torch_fleet_harness import (  # noqa: F401  (fixtures)
    PKGS, _one_thread, fleets, ledger_balanced, make_fleet, on_the_port,
    params, reference)

_ref = on_the_port("test_kv_store.py",
                   leave_out=("test_eviction_fires_demote_hook",))
for _name, _obj in list(_ref.items()):
    if _name.startswith("Test") and isinstance(_obj, type):
        globals()[_name] = _obj
model_cfg = _ref["model_cfg"]

PS = 8
HOT = [7, 3, 9, 1, 4, 8, 2, 6] * 4            # 32 tokens = 4 full pages


# -- byte identity across the packages ----------------------------------------

def _page_payloads(kind: str, n_pages: int = 4, seed: int = 0) -> tuple:
    """(JAX payload, port payload) holding the same bytes: bf16 as
    ml_dtypes' bfloat16 and as ``BF16_HOST``; int8 and int4 as values and
    fp32 scales."""
    cfg = torch_cfg("gpt-test")
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, n_pages, cfg.num_kv_heads, PS, cfg.head_dim)
    if kind == "bf16":
        bits = [(rng.standard_normal(shape, np.float32).view(np.uint32)
                 >> 16).astype(np.uint16) for _ in range(2)]
        return ({"k": bits[0].view(ml_dtypes.bfloat16),
                 "v": bits[1].view(ml_dtypes.bfloat16),
                 "num_pages": n_pages},
                {"k": bits[0].view(tkv_cache.BF16_HOST),
                 "v": bits[1].view(tkv_cache.BF16_HOST),
                 "num_pages": n_pages})
    vshape = shape if kind == "int8" else shape[:3] + (PS // 2, shape[4])
    parts = []
    for _ in range(2):
        values = (rng.integers(-127, 127, vshape, np.int8) if kind == "int8"
                  else rng.integers(0, 256, vshape, np.uint8))
        parts.append({"values": values,
                      "scale": rng.random(shape[:-1], np.float32)})
    payload = {"k": parts[0], "v": parts[1], "num_pages": n_pages}
    return payload, payload


def _bits(node):
    if isinstance(node, dict):
        return {k: _bits(v) for k, v in node.items() if k != "num_pages"}
    arr = np.asarray(node)
    return arr.view(np.uint16) if arr.dtype.itemsize == 2 else arr


def _assert_same_bits(a, b):
    a, b = _bits(a), _bits(b)
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_bits(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


def _store_cfg(cls, spill: Path, codec: str):
    # a ring that holds one page: the others spill to disk
    return cls(kv_store=True, kv_store_dram_mb=1e-6, kv_store_dir=str(spill),
               kv_store_disk_mb=64.0, courier_codec=codec,
               courier_chunk_bytes=1024)


@pytest.mark.parametrize("codec", ["none", "delta-zlib"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_both_stores_write_the_same_frames_and_spill_files(tmp_path, kind,
                                                           codec):
    jpay, tpay = _page_payloads(kind)
    hashes = tkv_cache.prefix_page_hashes(HOT, PS)
    jst = jkv_store.FleetKVStore(_store_cfg(JaxFleetConfig,
                                            tmp_path / "jax", codec))
    tst = tkv_store.FleetKVStore(_store_cfg(TorchFleetConfig,
                                            tmp_path / "torch", codec))
    assert jst.demote(hashes, jpay) == tst.demote(hashes, tpay) == 4
    assert jst.snapshot() == tst.snapshot()
    assert tst.snapshot()["disk_entries"] == 3
    assert jst.inventory() == tst.inventory()
    assert sorted(tst.inventory()) == sorted(hashes)
    for h in jst._dram:
        assert jst._dram[h].frames == tst._dram[h].frames
        assert jst._dram[h].manifest == tst._dram[h].manifest
    jfiles = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert jfiles == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert len(jfiles) == 3
    for name in jfiles:
        assert (tmp_path / "jax" / name).read_bytes()             == (tmp_path / "torch" / name).read_bytes()
    # each package re-indexes the other's spill directory and serves it
    jback = jkv_store.FleetKVStore(_store_cfg(JaxFleetConfig,
                                              tmp_path / "torch", codec))
    tback = tkv_store.FleetKVStore(_store_cfg(TorchFleetConfig,
                                              tmp_path / "jax", codec))
    assert jback.scan_disk() == tback.scan_disk() == 3
    spilled = hashes[:3]
    jout = jback.fetch(spilled, jtransport.CourierReceiver())
    tout = tback.fetch(spilled, ttransport.CourierReceiver())
    assert jout["hashes"] == tout["hashes"] == [h.hex() for h in spilled]
    want = {"k": _bits(tpay["k"]), "v": _bits(tpay["v"])}
    for got in (jout["pages"], tout["pages"]):
        for part in ("k", "v"):
            node = want[part]
            cut = ({k: v[:, :3] for k, v in node.items()}
                   if isinstance(node, dict) else node[:, :3])
            _assert_same_bits({"x": got[part]}, {"x": cut})
    if kind == "bf16":
        assert tout["pages"]["k"].dtype == tkv_cache.BF16_HOST
    assert jback.snapshot() == tback.snapshot()


def test_eviction_fires_demote_hook(model_cfg):
    """The reference test with the port's bf16 host form: one batched hook
    call, the evicted hashes oldest first, their exact content as
    ``BF16_HOST`` bits."""
    kv = _ref["make_kv"](model_cfg, num_pages=6)
    hashes = tkv_cache.prefix_page_hashes(HOT, PS)
    kv.allocate(0, len(HOT))
    payload = _ref["stamped_payload"](model_cfg, 4)
    kv.write_slot_pages(0, payload)
    table = kv.block_tables[0]
    kv.register_pages([(hashes[i], int(table[i])) for i in range(4)])
    kv.release(0)
    demoted = []
    kv.demote_hook = lambda hs, content: demoted.append((hs, content))
    kv.allocate(1, 3 * PS)                 # needs 3: 1 free + 2 evicted
    assert len(demoted) == 1
    hs, content = demoted[0]
    assert hs == hashes[:2]
    assert content["num_pages"] == 2
    assert content["k"].dtype == tkv_cache.BF16_HOST
    got = torch.from_numpy(content["k"].view(np.uint16).copy()).view(
        torch.bfloat16).float().numpy()
    want = torch.from_numpy(payload["k"][:, :2]).bfloat16().float().numpy()
    np.testing.assert_array_equal(got, want)


# -- pages overwritten right after their demotion -----------------------------

@pytest.fixture()
def numpy_spy(monkeypatch):
    """Counts the store's calls of ``payload_numpy``."""
    calls = []
    real = tkv_store.payload_numpy

    def spy(content):
        calls.append(content["num_pages"])
        return real(content)
    monkeypatch.setattr(tkv_store, "payload_numpy", spy)
    return calls


def _pages_bits(kv, pages) -> dict:
    return _bits(tkv_cache.payload_numpy(kv.extract_pages(pages)))


def test_a_drain_flush_encodes_the_pages_before_they_are_overwritten(
        params, numpy_spy):
    """The drain flush hands ``extract_pages``' torch tensors to the store;
    overwriting every page at once afterwards changes nothing that the
    store restores."""
    cfg = torch_cfg("gpt-test")
    rep = EngineReplica(0, cfg, PKGS["torch"].schema.ServeConfig(
        model="gpt-test", max_batch_size=2, max_seq_len=128,
        kv_block_size=PS, dtype="float32"), params=params["torch"],
        device="cpu")
    try:
        rep.engine.generate([HOT + [50, 51]], PKGS["torch"].Sampling(
            temperature=0.0, max_tokens=2))
        kv = rep.engine.kv
        pairs = kv.prefix_cache_pairs()
        assert len(pairs) == 4
        before = _pages_bits(kv, [p for _h, p in pairs])
        store = tkv_store.FleetKVStore(TorchFleetConfig(kv_store=True))
        rep.set_kv_store(store)
        rep._flush_inventory_to_store()
        kv.k_pages.fill_(7.0)
        kv.v_pages.fill_(-7.0)
        assert rep.store_flush_pages == 4 and numpy_spy == [4]
        out = store.fetch([h for h, _p in pairs],
                          ttransport.CourierReceiver())
        assert out["hashes"] == [h.hex() for h, _p in pairs]
        _assert_same_bits(out["pages"], before)
    finally:
        rep.engine.release()


def test_an_evicted_page_is_encoded_before_it_is_overwritten(model_cfg,
                                                             numpy_spy):
    """The eviction seam: the pool hands numpy pages (``payload_numpy`` in
    ``_flush_demotions``) to the store's encoder; pages overwritten at once
    still come back as they were evicted."""
    kv = _ref["make_kv"](model_cfg, num_pages=6)
    hashes = tkv_cache.prefix_page_hashes(HOT, PS)
    kv.allocate(0, len(HOT))
    kv.write_slot_pages(0, _ref["stamped_payload"](model_cfg, 4))
    table = kv.block_tables[0]
    before = _pages_bits(kv, [int(table[i]) for i in range(2)])
    kv.register_pages([(hashes[i], int(table[i])) for i in range(4)])
    kv.release(0)
    store = tkv_store.FleetKVStore(TorchFleetConfig(kv_store=True))
    kv.demote_hook = store.demote_async
    kv.allocate(1, 3 * PS)                 # evicts the two oldest pages
    kv.k_pages.fill_(7.0)
    kv.v_pages.fill_(-7.0)
    store.flush_pending()
    assert numpy_spy == []                 # already numpy: not converted
    out = store.fetch(hashes[:2], ttransport.CourierReceiver())
    assert out["hashes"] == [h.hex() for h in hashes[:2]]
    _assert_same_bits(out["pages"], before)


# -- the JAX regime serve.fleet2+kv-store ---------------------------------------

KS_A = [7, 3, 9, 1, 4, 8, 2, 6] * 4
KS_B = [5, 2, 8, 3, 1, 9, 6, 4] * 4
KS_PROMPTS = [KS_A + [70, 71, 72], KS_B + [80, 81, 82]]
GREEDY = dict(temperature=0.0, max_tokens=16)
REGIME_SERVE = dict(max_seq_len=128)


def drain_to(fleet, rid):
    from torch_fleet_harness import wait_until
    assert fleet.drain(rid)
    wait_until(lambda: fleet.replicas[rid].state == "drained",
               f"drain of replica {rid}", fleet)


def kv_store_regime(fleet, pkg) -> dict:
    S = PKGS[pkg].Sampling
    for rep in fleet.replicas:
        rep.engine.kv.flush_prefix_cache()
    drain_to(fleet, 1)                                 # warm on replica 0
    warm = fleet.generate([KS_A + [50, 51, 52], KS_B + [60, 61, 62]],
                          S(**GREEDY), timeout_s=120)
    fleet.undrain(1)
    drain_to(fleet, 0)                                 # retire: flush
    snap0 = fleet.kv_store.snapshot()
    fleet.replicas[0].engine.kv.flush_prefix_cache()
    fleet.router.invalidate_inventories()
    eng1 = fleet.replicas[1].engine
    pre = eng1.total_prefill_tokens
    ret_a = fleet.generate([KS_PROMPTS[0]], S(**GREEDY), timeout_s=120)
    snap1 = fleet.kv_store.snapshot()
    spent_a = eng1.total_prefill_tokens - pre
    fetched = eng1.total_prefix_fetched_tokens
    fleet.kv_store.clear()
    pre = eng1.total_prefill_tokens
    miss0 = fleet.replicas[1].prefix_fetch_misses
    ret_b = fleet.generate([KS_PROMPTS[1]], S(**GREEDY), timeout_s=120)
    snap2 = fleet.kv_store.snapshot()
    st = fleet.router.stats()
    # the compressed byte counts are left out: the two packages' K/V agree
    # within fp32 rounding, not bit for bit, so their deflated sizes differ
    keep = ("hits", "misses", "demotions", "duplicates", "evictions",
            "dram_entries")
    assert snap0["bytes_stored"] > 0 and snap1["bytes_served"] > 0
    return {"warm": [r.generated_tokens for r in warm],
            "tokens": [ret_a[0].generated_tokens, ret_b[0].generated_tokens],
            "retire": {k: snap0[k] for k in keep},
            "restore": {k: snap1[k] for k in keep},
            "wiped": {k: snap2[k] for k in keep},
            "tail_prefill": spent_a, "fetched_tokens": fetched,
            "miss_counted": fleet.replicas[1].prefix_fetch_misses - miss0,
            "full_prefill": eng1.total_prefill_tokens - pre,
            "failed": st["failed"], "balanced": ledger_balanced(st)}


def test_the_kv_store_regime_matches_the_jax_fleet(params, fleets):
    want = reference("jax", params, KS_PROMPTS, GREEDY, **REGIME_SERVE)
    out = {}
    for pkg in ("jax", "torch"):
        fleet = make_fleet(fleets, pkg, params, warm=True,
                           serve_kw=REGIME_SERVE, kv_store=True,
                           kv_store_dram_mb=16.0,
                           prefix_inventory_ttl_ms=60_000.0)
        out[pkg] = kv_store_regime(fleet, pkg)
    got = out["torch"]
    assert got == out["jax"]
    assert got["tokens"] == want
    assert got["retire"]["demotions"] >= 8
    assert got["restore"]["hits"] >= 4 and got["restore"]["misses"] == 0
    assert got["fetched_tokens"] == len(KS_A)
    assert got["tail_prefill"] == len(KS_PROMPTS[0]) - len(KS_A)
    assert got["wiped"]["misses"] >= 1 and got["miss_counted"] >= 1
    assert got["full_prefill"] == len(KS_PROMPTS[1])
    assert got["failed"] == 0 and got["balanced"]
