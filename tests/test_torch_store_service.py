"""The store service and the weight courier on the port
(serve/fleet/store_service.py, serve/fleet/weights.py), held to the JAX
package's.

- The JAX package's ``tests/test_store_service.py`` on the port's modules,
  its ``Harness`` serving the port's ``StoreService`` on ``http.server``
  instead of aiohttp. Left out, by name, the two tests that drive the JAX
  CLI through click (``test_worker_weights_from_store_needs_endpoint``,
  ``test_worker_boot_against_dead_store_names_endpoint``); their port
  counterparts below drive ``llmctl-torch``.
- Across the packages, over real sockets: the reference's networked-store
  and weight-courier classes with the JAX package's ``StoreClient`` and
  ``WeightCourier`` against the port's service (``...JaxClients``), and
  with the port's clients against the JAX package's aiohttp service
  (``...JaxService``): uploads and downloads resumed after a kill, a torn
  spool, the per-seq serve ledger balanced.
- The same requests to both packages' services draw the same acks, frame
  rows, inventories, weight ledgers and FATAL acks, key for key.
- The JAX regime ``serve.fleet2+net-store``: a spawned ``fleet store``
  (``--device cpu``) takes a checkpoint shipped by the JAX package's
  ``WeightCourier``, a spawned port worker boots from it
  (``--weights-from-store``: the JAX params' checksum, each chunk served
  once) and, behind the port's fleet, restores a retired replica's pages
  from the store tail-only, then counts a remote miss and prefills in full
  once the store is SIGKILLed. Tokens and counters equal the JAX fleet's
  over the JAX service, and the JAX engine's tokens.
"""

import json
import urllib.error
import urllib.request

import pytest

from torch_fleet_harness import (  # noqa: F401  (fixtures)
    _one_thread, fleets, on_the_port, params, procs)

from distributed_llm_training_and_inference_system_tpu_torch.cli import (
    main as tmain)
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.store_service import (  # noqa: E501
    StoreService)

_ref = on_the_port("test_store_service.py", leave_out=(
    "test_worker_weights_from_store_needs_endpoint",
    "test_worker_boot_against_dead_store_names_endpoint"))


class PortHarness:
    """The port's StoreService on a stdlib HTTP thread, killable mid-test
    (the socket closes and the client must degrade)."""

    def __init__(self, cfg=None):
        self.svc = StoreService(cfg or _ref["store_cfg"]())
        port = self.svc.serve_http("127.0.0.1", 0)
        self.endpoint = f"http://127.0.0.1:{port}"
        self._dead = False

    def kill(self):
        if not self._dead:
            self._dead = True
            self.svc.stop()


_ref["Harness"] = PortHarness
for _name, _obj in list(_ref.items()):
    if _name.startswith("Test") and isinstance(_obj, type):
        globals()[_name] = _obj
model_cfg = _ref["model_cfg"]
harness = _ref["harness"]
DEAD = _ref["DEAD"]

# the JAX package's clients (its test file as it is) against the port's
# service: the module's ``harness`` fixture serves the port's StoreService
_jax = on_the_port("test_store_service.py", swap=False)
TestNetworkedKVStoreJaxClients = _jax["TestNetworkedKVStore"]
TestWeightCourierJaxClients = _jax["TestWeightCourier"]


def _on_the_jax_service(cls):
    """``cls`` (the port's clients) with its harness serving the JAX
    package's aiohttp StoreService."""
    class OnTheJaxService(cls):
        @pytest.fixture()
        def harness(self):
            h = _jax["Harness"]()
            yield h
            h.kill()
    return OnTheJaxService


TestNetworkedKVStoreJaxService = _on_the_jax_service(
    _ref["TestNetworkedKVStore"])
TestWeightCourierJaxService = _on_the_jax_service(_ref["TestWeightCourier"])


def test_worker_weights_from_store_needs_endpoint(capsys):
    assert tmain.main(["--device", "cpu", "fleet", "worker", "--model",
                       "gpt-test", "--weights-from-store"]) == 1
    assert "--weights-from-store needs --store-endpoint" \
        in capsys.readouterr().err


@pytest.mark.socket
def test_worker_boot_against_dead_store_names_endpoint(capsys):
    assert tmain.main(["--device", "cpu", "fleet", "worker", "--model",
                       "gpt-test", "--store-endpoint", DEAD,
                       "--weights-from-store"]) == 1
    err = capsys.readouterr().err
    assert DEAD in err and "unreachable" in err


# -- the same requests to both services ----------------------------------------

def _call(ep: str, path: str, body=None):
    """(status, JSON answer) of a GET (body None) or POST."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"{ep}{path}", data=data, headers={
        "Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _requests(model_cfg) -> list:
    """One client's conversation with a store service: demotes (one a
    duplicate, one malformed), fetches (counted, uncounted, a miss),
    inventory, a weight upload with a corrupt and a duplicate chunk, the
    ledger, chunk fetches and peeks, bad bodies."""
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet import (  # noqa: E501
        store_service as tsvc)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.transport import (  # noqa: E501
        CODEC_ZLIB, encode_payload, make_chunks)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.kv_cache import (  # noqa: E501
        prefix_page_hashes)
    hashes = prefix_page_hashes(_ref["HOT"], _ref["PS"])
    payload = _ref["stamped_payload"](model_cfg, len(hashes))
    demotes = []
    for i, h in enumerate(hashes):
        page = {"prefix": True, "hashes": [h.hex()],
                "pages": {"k": payload["k"][:, i:i + 1],
                          "v": payload["v"][:, i:i + 1], "num_pages": 1}}
        manifest, blob = encode_payload(page, codec=CODEC_ZLIB)
        chunks = make_chunks("store", manifest, blob, 1024)
        demotes.append({"hash": h.hex(), "manifest": manifest,
                        "frames": tsvc._frames_to_wire(
                            [(c.seq, c.total, c.crc32, c.data)
                             for c in chunks]),
                        "raw_bytes": int(manifest["nbytes"])})
    params = _ref["tiny_params"](seed=9, n=2048)
    manifest, blob = encode_payload({"params": params}, codec=CODEC_ZLIB)
    chunks = make_chunks("weights-w", manifest, blob, 1024)
    bad = chunks[1].to_wire()
    bad["crc32"] = (bad["crc32"] + 1) % (1 << 32)
    out = [("POST", "/store/demote", d) for d in demotes]
    out += [("POST", "/store/demote", demotes[0]),
            ("POST", "/store/demote", {"hash": "zz"}),
            ("POST", "/store/fetch", {"hashes": [h.hex() for h in hashes]}),
            ("POST", "/store/fetch", {"hashes": [hashes[0].hex()],
                                      "count": False}),
            ("POST", "/store/fetch", {"hashes": ["00" * 16]}),
            ("POST", "/store/fetch", {}),
            ("POST", "/store/inventory", {"max_entries": 2}),
            ("POST", "/store/weights/chunk", {"name": "w",
                                              "chunk": chunks[0].to_wire()}),
            ("POST", "/store/weights/begin", {"name": "w"}),
            ("POST", "/store/weights/begin", {
                "name": "w", "manifest": manifest, "total": len(chunks),
                "nbytes": int(manifest["nbytes"])}),
            ("POST", "/store/weights/chunk", {"name": "w", "chunk": bad}),
            ("POST", "/store/weights/chunk", {"name": "w", "chunk": {}})]
    out += [("POST", "/store/weights/chunk", {"name": "w",
                                              "chunk": c.to_wire()})
            for c in chunks]
    out += [("POST", "/store/weights/chunk", {"name": "w",
                                              "chunk": chunks[0].to_wire()}),
            ("POST", "/store/weights/fetch", {"name": "w", "seqs": [0, 2]}),
            ("POST", "/store/weights/fetch", {"name": "w", "seqs": [999]}),
            ("POST", "/store/weights/sync", {"name": "w", "seqs": [1, 999]}),
            ("GET", "/store/weights/status?name=w", None),
            ("GET", "/store/weights/status?name=ghost", None),
            ("GET", "/store/weights/names", None),
            ("POST", "/store/clear", {}),
            ("POST", "/store/inventory", {}),
            ("GET", "/health", None)]
    return out


def _conversation(ep, reqs) -> list:
    return [_call(ep, path, body) for _m, path, body in reqs]


def _status_without_walls(ep) -> dict:
    _code, st = _call(ep, "/store/status")
    return st


@pytest.mark.socket
def test_both_services_answer_alike(model_cfg):
    """The same requests, in the same order, to the port's service and the
    JAX package's: every status code and answer equal (frames, manifests,
    acks, the weight ledger), and the same status counters after."""
    reqs = _requests(model_cfg)
    port = PortHarness(_ref["store_cfg"]())
    jaxh = _jax["Harness"]()
    try:
        got = _conversation(port.endpoint, reqs)
        want = _conversation(jaxh.endpoint, reqs)
        for (method, path, _b), g, w in zip(reqs, got, want):
            assert g == w, (method, path)
        assert _status_without_walls(port.endpoint) \
            == _status_without_walls(jaxh.endpoint)
    finally:
        port.kill()
        jaxh.kill()


@pytest.mark.socket
def test_a_fenced_member_of_either_package_acks_fatal(tmp_path, model_cfg):
    """Members of both packages in one registry: once fenced, each answers
    a write with the same FATAL ack, counts it, and its /health goes 503
    "fenced"; reads still answer."""
    from distributed_llm_training_and_inference_system_tpu.serve.fleet.store_service import (  # noqa: E501
        StoreService as JaxService)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.store_tier import (  # noqa: E501
        StoreMembership)
    mdir = str(tmp_path / "members")
    port_svc = StoreService(_ref["store_cfg"](), member_id="p",
                            membership_dir=mdir)
    port_svc.serve_http("127.0.0.1", 0)
    jaxh = _jax["Harness"]()
    # the JAX member joins the same registry under its own id
    jsvc = JaxService(_jax["store_cfg"](), member_id="j",
                      membership_dir=mdir)
    jaxh.svc.membership, jaxh.svc.member_id = jsvc.membership, "j"
    jaxh.svc.membership.attach({"endpoint": jaxh.endpoint})
    try:
        reqs = _requests(model_cfg)[:1]
        eps = {"p": port_svc.endpoint, "j": jaxh.endpoint}
        for mid in eps:
            assert _call(eps[mid], "/store/demote", reqs[0][2])[1] == {
                "ok": True, "stored": True}
        ctl = StoreMembership(mdir, "ctl")
        view = ctl.members_view()
        assert sorted(view) == ["j", "p"] and view["p"]["epoch"] == 1 \
            and view["j"]["epoch"] == 2
        assert ctl.fence("p") and ctl.fence("j")
        acks = {mid: _call(ep, "/store/demote", reqs[0][2])
                for mid, ep in eps.items()}
        for mid, (code, ack) in acks.items():
            assert code == 200 and ack == {
                "ok": False, "fatal": True,
                "error": f"store member {mid} is fenced; write refused"}
        for mid, ep in eps.items():
            assert _call(ep, "/health") == (503, {"status": "fenced"})
            st = _call(ep, "/store/status")[1]
            assert st["kv_store"]["fenced_rejects"] == 1
            assert st["member"]["fenced"] is True
            assert _call(ep, "/store/inventory", {})[1]["ok"]
    finally:
        port_svc.stop()
        jaxh.kill()


# -- the JAX regime serve.fleet2+net-store ------------------------------------

NS_A = [7, 3, 9, 1, 4, 8, 2, 6] * 4          # 4 full pages
NS_B = [5, 2, 8, 3, 1, 9, 6, 4] * 4
NS_PROMPTS = [NS_A + [70, 71, 72], NS_B + [80, 81, 82]]
NS_GREEDY = dict(temperature=0.0, max_tokens=16)
NS_SERVE = dict(max_seq_len=128)
NS_FLEET = dict(affinity_prefix_tokens=0, probe_interval_s=0.05,
                restart_backoff_s=0.05, probe_failures=2,
                remote_timeout_s=5.0, courier_chunk_bytes=1024,
                prefix_inventory_ttl_ms=60_000.0)


def net_store_regime(fleet, pkg, restorer, kill_store) -> dict:
    """The regime's flow on one fleet; ``restorer()`` reads the restoring
    replica's (remote hits, remote misses, prefill tokens)."""
    from torch_fleet_harness import PKGS, ledger_balanced, wait_until
    S = PKGS[pkg].Sampling

    def drain_to(rid):
        assert fleet.drain(rid)
        wait_until(lambda: fleet.replicas[rid].state == "drained",
                   f"drain of replica {rid}", fleet)

    fleet.replicas[0].engine.kv.flush_prefix_cache()
    drain_to(1)                                       # warm on replica 0
    fleet.generate([NS_A + [50, 51, 52], NS_B + [60, 61, 62]],
                   S(**NS_GREEDY), timeout_s=120)
    fleet.undrain(1)
    drain_to(0)                                       # retire: flush
    snap0 = fleet.kv_store.snapshot()
    fleet.replicas[0].engine.kv.flush_prefix_cache()
    fleet.router.invalidate_inventories()
    r0 = restorer()
    [ret_a] = fleet.generate([NS_PROMPTS[0]], S(**NS_GREEDY), timeout_s=120)
    r1 = restorer()
    kill_store()
    [ret_b] = fleet.generate([NS_PROMPTS[1]], S(**NS_GREEDY), timeout_s=120)
    r2 = restorer()
    dead = fleet.kv_store.snapshot()
    st = fleet.router.stats()
    return {"tokens": [ret_a.generated_tokens, ret_b.generated_tokens],
            "reachable": snap0["reachable"],
            "flushed_8": snap0["demotions"] >= 8,
            "restored": r1[0] - r0[0], "tail_prefill": r1[2] - r0[2],
            "misses_while_up": r1[1] - r0[1],
            "dead_misses": r2[1] - r1[1], "full_prefill": r2[2] - r1[2],
            "dead_reachable": dead["reachable"],
            "failed": st["failed"], "balanced": ledger_balanced(st)}


@pytest.mark.socket
def test_the_net_store_regime_matches_the_jax_fleet(params, fleets, procs,
                                                    tmp_path):
    import sys
    import time

    import jax
    import numpy as np

    from distributed_llm_training_and_inference_system_tpu.serve.fleet.weights import (  # noqa: E501
        WeightCourier as JaxCourier)
    from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.worker import (  # noqa: E501
        PARAMS_PREFIX, params_checksum)
    from torch_fleet_harness import (PKGS, PORT_CLI, Proc, SERVE, get_json,
                                     make_fleet, reference,
                                     remote_fleet_cfg)
    want = reference("jax", params, NS_PROMPTS, NS_GREEDY, **NS_SERVE)
    out = {}
    # the JAX package's fleet over its own aiohttp service
    jsvc = _jax["Harness"]()
    try:
        jf = make_fleet(fleets, "jax", params, warm=True, serve_kw=NS_SERVE,
                        kv_store_endpoint=jsvc.endpoint, **NS_FLEET)

        def jax_restorer():
            c = jf.kv_store
            return (c.total_remote_hits, c.total_remote_misses,
                    jf.replicas[1].engine.total_prefill_tokens)
        out["jax"] = net_store_regime(jf, "jax", jax_restorer, jsvc.kill)
    finally:
        jsvc.kill()
    # the port: a spawned store, a checkpoint shipped by the JAX package,
    # a spawned worker booting from it
    deadline = time.monotonic() + 60
    store = Proc([sys.executable, "-m", PORT_CLI, "--device", "cpu",
                  "fleet", "store", "--port", "0",
                  "--courier-chunk-bytes", "1024"],
                 tmp_path / "store.log", "LLMCTL_STORE_READY")
    procs.append(store)
    store.wait_ready(deadline)
    shipped = JaxCourier(endpoint=store.endpoint).ship(
        "gpt-test", jax.tree_util.tree_map(np.asarray, params["jax"]))
    assert shipped["sent"] == shipped["total"] > 1
    worker = Proc([sys.executable, "-m", PORT_CLI, "--device", "cpu",
                   "fleet", "worker", "--model", "gpt-test",
                   "--replica-id", "1", "--port", "0", "--seed", "1000",
                   "--max-batch-size", "2", "--max-seq-len", "128",
                   "--prefill-chunk", "32", "--kv-block-size", "8",
                   "--dtype", "float32", "--courier-chunk-bytes", "1024",
                   "--restart-backoff", "0.05", "--store-endpoint",
                   store.endpoint, "--weights-from-store",
                   "--weights-name", "gpt-test", "--weights-spool",
                   str(tmp_path / "spool")],
                  tmp_path / "worker.log", "LLMCTL_WORKER_READY")
    procs.append(worker)
    worker.wait_ready(deadline)
    assert float(worker.stderr_line(PARAMS_PREFIX).split("checksum=")[1]) \
        == params_checksum(params["torch"])
    ledger = get_json(f"{store.endpoint}/store/weights/status?name=gpt-test")
    assert sorted(int(q) for q in ledger["served"]) \
        == list(range(shipped["total"]))
    assert set(ledger["served"].values()) == {1}
    tf = PKGS["torch"].fleet.ServeFleet(
        PKGS["torch"].cfg, PKGS["torch"].schema.ServeConfig(
            **dict(SERVE, **NS_SERVE)),
        remote_fleet_cfg({1: worker.endpoint}, replicas=2,
                         remote_replicas="1",
                         kv_store_endpoint=store.endpoint, **NS_FLEET),
        params=params["torch"], supervise=False, seed=0, device="cpu")
    fleets.append(tf)
    rep0 = tf.replicas[0].engine
    rep0.generate([[1, 2, 3]], PKGS["torch"].Sampling(temperature=0.0,
                                                      max_tokens=4))
    rep0.total_prefill_tokens = 0
    tf.start()

    def port_restorer():
        st = get_json(f"{worker.endpoint}/worker/status")
        return (st["kv_store"]["remote_hits"], st["kv_store"]["remote_misses"],
                st["total_prefill_tokens"])
    out["torch"] = net_store_regime(tf, "torch", port_restorer, store.kill)
    got = out["torch"]
    assert got == out["jax"]
    assert got["tokens"] == want
    assert got["reachable"] and got["flushed_8"]
    assert got["restored"] >= 4 and got["misses_while_up"] == 0
    assert got["tail_prefill"] == len(NS_PROMPTS[0]) - len(NS_A)
    assert got["dead_misses"] >= 1
    assert got["full_prefill"] == len(NS_PROMPTS[1])
    assert got["dead_reachable"] is False
    assert got["failed"] == 0 and got["balanced"]
