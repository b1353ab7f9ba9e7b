"""The port's KV courier (serve/fleet/transport.py) against the JAX
package's.

- Frames: a payload extracted from the port's cache and the same payload
  extracted from the JAX cache (the same page content, the same
  allocations) encode to the same manifest and blob, and frame to the
  same ``CourierChunk.to_wire()`` JSON, byte for byte, for every codec
  (none, zlib, delta-zlib) and page kind (bf16, fp32, int8, int4). Each
  package decodes the other's frames to its own payload.
- A bf16 frame decodes in a process that imports only the port, with
  ``ml_dtypes`` blocked: the manifest's ``"bfloat16"`` maps to the port's
  uint16 host dtype, and the pages restore into a bf16 cache.
- The JAX package's framing, receiver, in-process chaos and KVCourier arms
  (tests/test_courier_transport.py), run on both packages' classes with
  the same payloads and seeds, give the same acks, resends, aborts and
  counters; and that file's transport classes run as they are on the
  port's modules (its source with the package's name swapped for the
  port's), all but the two that read JAX arrays (the jnp nibble layout,
  the JAX cache's validation).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg)
from distributed_llm_training_and_inference_system_tpu.ops import (
    paged_attention as jpa)
from distributed_llm_training_and_inference_system_tpu.serve import (
    kv_cache as jax_kv)
from distributed_llm_training_and_inference_system_tpu.serve.fleet import (
    faults as jfaults, transport as jt)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    paged_attention as tpa)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    kv_cache as torch_kv)
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
    faults as tfaults, transport as tt)

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = "distributed_llm_training_and_inference_system_tpu"
KINDS = ["bfloat16", "float32", "int8", "int4"]
CODECS = ["none", "zlib", "delta-zlib"]
GEOM = dict(num_slots=4, max_seq_len=64, page_size=8, num_pages=12)
SPEC = {"window": 5, "ewma": 0.625, "warmup": 6, "drafts": 24,
        "accepted": 15}
PACKAGES = {"jax": (jt, jfaults), "torch": (tt, tfaults)}


def _caches(kind):
    """(JAX cache, port cache) holding the same pages (numpy seed 3) and
    the same two allocations."""
    quant = kind if kind in ("int8", "int4") else "none"
    jdt = jnp.bfloat16 if kind == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if kind == "bfloat16" else torch.float32
    cfg = jax_cfg("gpt-test")
    jc = jax_kv.PagedKVCache(cfg, **GEOM, dtype=jdt, quantized=quant)
    tc = torch_kv.PagedKVCache(torch_cfg("gpt-test"), **GEOM, dtype=tdt,
                               device="cpu", quantized=quant)
    rs = np.random.RandomState(3)
    shape = (cfg.num_layers, GEOM["num_pages"], cfg.num_kv_heads,
             GEOM["page_size"], cfg.head_dim)
    for name in ("k_pages", "v_pages"):
        if quant == "none":
            values = rs.randn(*shape).astype(np.float32)
            setattr(jc, name, jnp.asarray(values, jdt))
            setattr(tc, name, torch.from_numpy(values).to(tdt))
            continue
        if quant == "int8":
            values = rs.randint(-127, 128, shape).astype(np.int8)
        else:
            values = rs.randint(0, 256, (*shape[:-2], shape[-2] // 2,
                                         shape[-1])).astype(np.uint8)
        scale = rs.rand(*shape[:-1]).astype(np.float32)
        jtype = jpa.Int4Pages if quant == "int4" else jpa.QuantPages
        ttype = tpa.Int4Pages if quant == "int4" else tpa.QuantPages
        setattr(jc, name, jtype(jnp.asarray(values), jnp.asarray(scale)))
        setattr(tc, name, ttype(torch.from_numpy(values),
                                torch.from_numpy(scale)))
    for c in (jc, tc):
        c.allocate(0, 20)
        c.allocate(1, 9)
    return jc, tc


def _payloads(kind):
    """(JAX payload, port payload): slot 0's pages from each cache in the
    swapped_kv schema, with the SpecState scalars."""
    jc, tc = _caches(kind)
    scalars = {"positions": 20, "last_token": 7, "spec": dict(SPEC)}
    return ({"pages": jc.extract_slot(0), **scalars},
            {"pages": torch_kv.payload_numpy(tc.extract_slot(0)),
             **scalars})


def _raw(node):
    """A payload's arrays as (dtype name, shape, bytes), scalars as they
    are: what two packages' payloads must agree on."""
    if isinstance(node, dict):
        return {k: _raw(v) for k, v in node.items()}
    if isinstance(node, np.ndarray):
        name = torch_kv.host_dtype_name(node.dtype)
        bits = node.view(np.uint16) if name == "bfloat16" else node
        return (name, node.shape, bits.tobytes())
    return node


def _wire(chunks) -> list:
    return [json.dumps(c.to_wire()) for c in chunks]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("kind", KINDS)
def test_frames_are_byte_identical_to_jax(kind, codec):
    jp, tp = _payloads(kind)
    assert _raw(jp) == _raw(tp)
    jm, jb = jt.encode_payload(jp, codec=codec)
    tm, tb = tt.encode_payload(tp, codec=codec)
    assert json.dumps(jm) == json.dumps(tm) and jb == tb
    if kind == "bfloat16":
        assert {a["dtype"] for a in tm["arrays"]} == {"bfloat16"}
    assert _wire(jt.make_chunks("t0", jm, jb, 1000)) == \
        _wire(tt.make_chunks("t0", tm, tb, 1000))
    # the pipelined framer sends the same frames
    frames = tt.FramePipeline("t0", tm, tb, 1000, codec)
    assert _wire(frames.frame(i) for i in range(frames.total)) == \
        _wire(jt.make_chunks("t0", jm, jb, 1000))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("kind", KINDS)
def test_each_package_decodes_the_others_frames(kind, codec):
    jp, tp = _payloads(kind)
    for (src, dst), want in (((jt, tt), tp), ((tt, jt), jp)):
        manifest, blob = src.encode_payload(
            jp if src is jt else tp, codec=codec)
        chunks = [dst.CourierChunk.from_wire(json.loads(w))
                  for w in _wire(src.make_chunks("x", manifest, blob, 700))]
        rx = dst.CourierReceiver()
        for c in reversed(chunks):               # any order
            ack = rx.add_chunk(c)
        assert ack["ok"] and ack["complete"]
        got = rx.take_payload("x")
        assert _raw(got) == _raw(want)


def test_a_bf16_frame_decodes_without_ml_dtypes(tmp_path):
    """The card machine has no ml_dtypes; here JAX has loaded it and
    registered "bfloat16" with numpy, so the decode runs in a process that
    imports only the port, with ml_dtypes blocked."""
    jp, tp = _payloads("bfloat16")
    manifest, blob = jt.encode_payload(jp, codec="zlib")
    (tmp_path / "frames.json").write_text(json.dumps(
        [c.to_wire() for c in jt.make_chunks("t", manifest, blob, 4096)]))
    script = textwrap.dedent(f"""
        import hashlib, json, sys
        sys.modules["ml_dtypes"] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        import torch
        from distributed_llm_training_and_inference_system_tpu_torch.config import get_model_config
        from distributed_llm_training_and_inference_system_tpu_torch.serve import kv_cache
        from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import transport
        try:
            np.dtype("bfloat16")
            raise SystemExit("numpy knows bfloat16: ml_dtypes was loaded")
        except TypeError:
            pass
        rx = transport.CourierReceiver()
        for w in json.load(open({str(tmp_path / "frames.json")!r})):
            ack = rx.add_chunk(transport.CourierChunk.from_wire(w))
        p = rx.take_payload("t")
        pages = p["pages"]
        cache = kv_cache.PagedKVCache(get_model_config("gpt-test"),
                                      num_slots=2, max_seq_len=64,
                                      page_size=8, num_pages=8,
                                      dtype=torch.bfloat16, device="cpu")
        assert cache.restore_slot(1, pages)
        back = kv_cache.payload_numpy(cache.extract_slot(1))
        print(json.dumps({{
            "complete": ack["complete"],
            "dtype": kv_cache.host_dtype_name(pages["k"].dtype),
            "k": hashlib.sha256(pages["k"].tobytes()).hexdigest(),
            "v": hashlib.sha256(pages["v"].tobytes()).hexdigest(),
            "restored": hashlib.sha256(back["k"].tobytes()
                                       + back["v"].tobytes()).hexdigest(),
            "jax": sorted(m for m in sys.modules if m.split(".")[0] in
                          ("jax", "jaxlib", "ml_dtypes")
                          and sys.modules[m] is not None)}}))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    import hashlib
    k = np.asarray(jp["pages"]["k"]).view(np.uint16).tobytes()
    v = np.asarray(jp["pages"]["v"]).view(np.uint16).tobytes()
    assert res == {"complete": True, "dtype": "bfloat16",
                   "k": hashlib.sha256(k).hexdigest(),
                   "v": hashlib.sha256(v).hexdigest(),
                   "restored": hashlib.sha256(k + v).hexdigest(),
                   "jax": []}


# -- the reference's transport tests, on the port ------------------------------

_reference = (ROOT / "tests" / "test_courier_transport.py").read_text()
_ns: dict = {"__name__": "test_courier_transport_on_the_port"}
exec(compile(_reference.replace(f"{JAX_PKG}.", f"{JAX_PKG}_torch."),
             str(ROOT / "tests" / "test_courier_transport.py"), "exec"), _ns)
TestFraming = _ns["TestFraming"]
TestReceiver = _ns["TestReceiver"]
TestInProcTransport = _ns["TestInProcTransport"]
TestKVCourier = _ns["TestKVCourier"]
TestRouterCourierIntegration = _ns["TestRouterCourierIntegration"]


class TestWireCodecs(_ns["TestWireCodecs"]):
    # the jnp nibble layout is the JAX package's own (its write path);
    # the port's torch write path is held in tests/test_torch_quant_ops.py
    test_np_jnp_nibble_layout_agreement = None


# -- the reference's transport arms, on both packages ------------------------

def _fp(rng, pages=5):
    return {"pages": {
        "k": rng.standard_normal((2, pages, 2, 8, 16)).astype(np.float32),
        "v": rng.standard_normal((2, pages, 2, 8, 16)).astype(np.float32),
        "num_pages": pages}, "positions": pages * 8 - 3, "last_token": 42}


def _int8(rng, pages=3):
    def q():
        return {"values": rng.integers(-128, 127, (2, pages, 2, 8, 16))
                .astype(np.int8),
                "scale": rng.random((2, pages, 2, 8)).astype(np.float32)}
    return {"pages": {"k": q(), "v": q(), "num_pages": pages},
            "positions": pages * 8, "last_token": 7}


def _int4(rng, pages=3):
    def q():
        return {"values": rng.integers(0, 256, (2, pages, 2, 4, 16))
                .astype(np.uint8),
                "scale": rng.random((2, pages, 2, 8)).astype(np.float32)}
    return {"pages": {"k": q(), "v": q(), "num_pages": pages},
            "positions": pages * 8, "last_token": 9, "spec": dict(SPEC)}


def _cfg(**kw):
    base = dict(courier_chunk_bytes=1024, courier_max_retries=10,
                courier_retry_backoff_ms=0.2,
                courier_retry_backoff_max_ms=2.0,
                courier_chunk_deadline_ms=20.0)
    base.update(kw)
    return SimpleNamespace(**base)


COUNTERS = ("chunks", "retries", "corruptions", "duplicates", "resumes",
            "aborts", "transfers", "bytes_moved", "bytes_raw", "bytes_wire",
            "in_flight")


def _counters(stats) -> tuple:
    s = stats.snapshot()
    return tuple(s[k] for k in COUNTERS)


def _framing(tr, fl, rng):
    """Out-of-order and duplicated delivery, a corrupt copy, the wire
    round trip, an empty blob."""
    p = _fp(rng)
    m, b = tr.encode_payload(p)
    chunks = tr.make_chunks("t", m, b, 256)
    r = tr.ChunkReassembler(len(chunks))
    adds = [r.add(c) for c in reversed(chunks)]
    adds += [r.add(chunks[1]), r.add(chunks[0])]
    bad = chunks[2]
    r2 = tr.ChunkReassembler(len(chunks))
    with pytest.raises(tr.ChunkCorrupt):
        r2.add(tr.CourierChunk(bad.ticket, bad.seq, bad.total, bad.crc32,
                               bytes([bad.data[0] ^ 1]) + bad.data[1:]))
    with pytest.raises(tr.TransferAborted):
        tr.decode_payload(m, b[:-1] + bytes([b[-1] ^ 0xFF]))
    empty = tr.make_chunks("e", *tr.encode_payload({"positions": 5,
                                                    "partial": True}), 1024)
    return (adds, r.duplicates, r.missing(), _raw(r.payload()),
            r2.missing(), len(empty),
            [_raw(tr.CourierChunk.from_wire(c.to_wire()).manifest)
             for c in chunks[:1]])


def _receiver(tr, fl, rng):
    m, b = tr.encode_payload(_fp(rng))
    chunks = tr.make_chunks("tkt", m, b, 512)
    rx = tr.CourierReceiver()
    acks = [rx.add_chunk(c) for c in chunks]
    first = _raw(rx.take_payload("tkt"))
    again = rx.take_payload("tkt")
    one = tr.make_chunks("one", *tr.encode_payload(_fp(rng, 1)), 1 << 20)
    acks += [rx.add_chunk(one[0]), rx.add_chunk(one[0])]
    rx.put_payload("p", _int8(rng))
    return acks, first, again, _raw(rx.take_payload("p")), rx.stats()


def _chaos(tr, fl, rng):
    """Seeded drop + corrupt + delay + duplicate over five transfers."""
    inj = fl.FaultInjector(fl.FaultPlan(
        seed=3, chunk_drop_rate=0.2, chunk_corrupt_rate=0.15,
        chunk_delay_rate=0.1, chunk_delay_ms=30.0,
        chunk_duplicate_rate=0.1))
    t = tr.InProcTransport(_cfg(), injector=inj)
    p = _fp(rng)
    got = [_raw(t.receiver.take_payload(t.transfer(p, src=0, dest=1,
                                                   ticket=f"c{i}")))
           for i in range(5)]
    assert all(g == _raw(p) for g in got)
    return _counters(t.stats)


def _chaos_codecs(tr, fl, rng):
    out = []
    for codec in CODECS:
        inj = fl.FaultInjector(fl.FaultPlan(
            seed=11, chunk_drop_rate=0.3, chunk_corrupt_rate=0.2))
        t = tr.InProcTransport(_cfg(courier_codec=codec), injector=inj)
        p = _int8(rng)
        assert _raw(t.receiver.take_payload(
            t.transfer(p, src=0, dest=1, ticket="k"))) == _raw(p)
        out.append(_counters(t.stats))
    return out


def _resume_abort_unreachable(tr, fl, rng):
    out = []
    t = tr.InProcTransport(_cfg(), injector=fl.FaultInjector(fl.FaultPlan(
        seed=0, chunk_drop_rate=1.0, chunk_fault_budget=3)))
    t.transfer(_fp(rng), src=0, dest=1)
    out.append(_counters(t.stats))
    t = tr.InProcTransport(_cfg(courier_max_retries=2),
                           injector=fl.FaultInjector(fl.FaultPlan(
                               seed=1, chunk_drop_rate=1.0)))
    with pytest.raises(tr.TransferAborted):
        t.transfer(_fp(rng), src=0, dest=1)
    out.append(_counters(t.stats))
    for count, retries in ((2, 10), (10 ** 6, 2)):
        t = tr.InProcTransport(
            _cfg(courier_max_retries=retries),
            injector=fl.FaultInjector(fl.FaultPlan(
                dest_unreachable_replica=1, dest_unreachable_count=count)))
        try:
            t.transfer(_fp(rng), src=0, dest=1)
        except tr.TransferAborted:
            out.append("aborted")
        out.append(_counters(t.stats))
    return out


def _kv_courier(tr, fl, rng):
    out = []
    c = tr.KVCourier(_cfg())
    p = _fp(rng)
    r = SimpleNamespace(request_id="r0", swapped_kv=p)
    out.append(c.ship(r, src=0, dest=1))
    stub = dict(r.swapped_kv)
    out.append((tr.is_ticket_stub(stub), stub["at"], stub["partial"]))
    out.append(c.ship(r, src=1, dest=0))           # same host: a no-op
    out.append(_raw(c.receiver.take_payload(stub["courier_ticket"]))
               == _raw(p))
    part = SimpleNamespace(request_id="r1", swapped_kv={
        "pages": _fp(rng, 2)["pages"], "positions": 16, "partial": True})
    out.append((c.ship(part, src=0, dest=1), part.swapped_kv["partial"]))
    home = SimpleNamespace(request_id="r2", swapped_kv=p)
    out.append((c.ship(home, src=1, dest=1), home.swapped_kv is p,
                c.ship(SimpleNamespace(request_id="r3", swapped_kv=None),
                       src=0, dest=1)))
    lossy = tr.KVCourier(_cfg(courier_max_retries=1),
                         injector=fl.FaultInjector(fl.FaultPlan(
                             seed=1, chunk_drop_rate=1.0)))
    gone = SimpleNamespace(request_id="r4", swapped_kv=_fp(rng))
    out.append((lossy.ship(gone, src=0, dest=1), gone.swapped_kv))
    for snap in (c.snapshot(), lossy.snapshot()):
        snap.pop("transfer_ms")
        out.append(snap)
    return out


ARMS = {"framing": _framing, "receiver": _receiver, "chaos": _chaos,
        "chaos_codecs": _chaos_codecs,
        "resume_abort_unreachable": _resume_abort_unreachable,
        "kv_courier": _kv_courier}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_reference_transport_arms_agree_with_jax(arm):
    """Each arm on both packages, from the same numpy seed: equal acks,
    payloads, resends, aborts and counters."""
    got = {name: ARMS[arm](tr, fl, np.random.default_rng(7))
           for name, (tr, fl) in PACKAGES.items()}
    assert got["torch"] == got["jax"]


def test_encoding_a_torch_tensor_is_refused():
    """The courier encodes host numpy arrays (``payload_numpy``); a raw
    page tensor, which an extract may still be filling on the card, is
    not an array it walks."""
    with pytest.raises(TypeError, match="payload_numpy"):
        tt.encode_payload({"pages": {"k": torch.zeros(2, 3),
                                     "v": torch.zeros(2, 3),
                                     "num_pages": 1}})
