"""Multi-rank runs of the port on the CPU, for the tests of collectives,
sharded training and context-parallel attention.

``spawn(fn, world, *args)`` starts ``world`` gloo ranks (a TCP rendezvous
on a free local port), runs ``fn(mesh_env, *args)`` on each and returns
each rank's result (numpy/plain Python: pickled back through a file), in
rank order. The ranks import torch and the port only, never JAX: every
check of one configuration runs in one spawn and the test process holds
the results to the JAX package's.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import traceback
from pathlib import Path

import numpy as np


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args, out_dir, device="cpu"):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    path = Path(out_dir) / f"{rank}.pkl"
    try:
        from distributed_llm_training_and_inference_system_tpu_torch.\
            parallel.mesh import init_distributed
        init_distributed(torch.device(device), timeout_s=120)
        result = ("ok", fn(*args))
    except BaseException:           # noqa: BLE001  (reported to the test)
        result = ("error", traceback.format_exc())
    path.write_bytes(pickle.dumps(result))
    if dist.is_initialized():
        dist.destroy_process_group()


# the ranks fork from one server process that has imported these once
# (multiprocessing's forkserver), not from the test process, which holds
# JAX's threads; the last two are what a rank's first autograd backward
# and first p2p receive import (~3.5 s a rank otherwise)
_PRELOAD = ["torch", "torch.distributed",
            "distributed_llm_training_and_inference_system_tpu_torch.parallel"
            ".api", "torch_dist_ranks", "torch.fx.experimental.symbolic_shapes",
            "torch.distributed.tensor"]


class Spawned:
    """``world`` gloo ranks running ``fn(*args)`` (``spawn``), started and
    not yet joined: the test process may work meanwhile. With ``device``
    "cuda" each rank joins as the port's launcher makes it (NCCL, card
    ``RANK``, where every rank has a card)."""

    def __init__(self, fn, world: int, *args, device: str = "cpu"):
        import multiprocessing

        import torch.multiprocessing as mp
        multiprocessing.set_forkserver_preload(_PRELOAD)
        self._dir = tempfile.TemporaryDirectory()
        self.world = world
        self._ctx = mp.start_processes(
            _rank_main, args=(world, free_port(), fn, args, self._dir.name,
                              device),
            nprocs=world, join=False, start_method="forkserver")

    def results(self) -> list:
        """Each rank's result, in rank order (waits for the ranks)."""
        try:
            while not self._ctx.join():
                pass
            results = [pickle.loads((Path(self._dir.name) / f"{r}.pkl")
                                    .read_bytes()) for r in range(self.world)]
        finally:
            self._dir.cleanup()
        errors = [(r, res[1]) for r, res in enumerate(results)
                  if res[0] != "ok"]
        if errors:
            raise AssertionError("\n".join(f"rank {r}:\n{tb}"
                                           for r, tb in errors))
        return [res[1] for res in results]


def spawn(fn, world: int, *args) -> list:
    return Spawned(fn, world, *args).results()


def _np(t):
    """A numpy copy (never a view of a tensor a step updates in place)."""
    return t.detach().float().numpy().copy() if hasattr(t, "detach") else t


# -- collectives -----------------------------------------------------------------

def collectives_rank(shapes: list):
    """Every collective of comms/collectives.py on each mesh of ``shapes``
    ({axis: size} each, over the whole world), over each axis of it and
    over the data axes together; rank r's input is arange + 100 r (a bf16
    one arange + r)."""
    import torch
    import torch.distributed as dist

    from distributed_llm_training_and_inference_system_tpu_torch.comms \
        import collectives as c
    from distributed_llm_training_and_inference_system_tpu_torch.parallel\
        .mesh import AXES, Mesh
    r = dist.get_rank()
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 100 * r
    xb = (torch.arange(8, dtype=torch.float32).reshape(4, 2) + r).bfloat16()
    results = []
    for shape in shapes:
        full = {a: shape.get(a, 1) for a in AXES}
        mesh = Mesh(full, r, dist.get_world_size(), "gloo",
                    torch.device("cpu"))
        out = {"coords": mesh.coords}
        axes = [a for a in AXES if full[a] > 1]
        if full["dp"] > 1 and full["fsdp"] > 1:
            axes.append(("dp", "fsdp"))
        for axis in axes:
            n = c.axis_size(axis, mesh)
            y = torch.arange(4 * n, dtype=torch.float32).reshape(
                n, 4) + 100 * r
            res = {
                "size": n, "index": c.axis_index(axis, mesh),
                "members": mesh.members(axis),
                "sum": _np(c.allreduce_sum(x, axis, mesh)),
                "mean": _np(c.allreduce_mean(x, axis, mesh)),
                "gather0": _np(c.all_gather(x, axis, gather_dim=0, mesh=mesh)),
                "gather1": _np(c.all_gather(x, axis, gather_dim=1, mesh=mesh)),
                "rs0": _np(c.reduce_scatter(x.repeat(n, 1), axis,
                                            scatter_dim=0, mesh=mesh)),
                "shift": _np(c.ring_shift(x, axis, mesh=mesh)),
                # small integers: exact in bf16
                "bf16_sum": _np(c.allreduce_sum(xb, axis, mesh)),
                "bf16_gather": _np(c.all_gather(xb, axis, mesh=mesh)),
                "a2a": _np(c.all_to_all(y, axis, split_dim=0,
                                        concat_dim=1, mesh=mesh)),
            }
            # the autograd pairs: forward and the gradient they pass
            z = x.clone().requires_grad_(True)
            (c.copy_to(z, axis, mesh) * (r + 1)).sum().backward()
            res["copy_to_grad"] = _np(z.grad)
            z = x.clone().requires_grad_(True)
            red = c.reduce_from(z, axis, mesh)
            (red * (r + 1)).sum().backward()
            res["reduce_from"] = _np(red)
            res["reduce_from_grad"] = _np(z.grad)
            for grad in ("reduce_scatter", "slice"):
                z = x.clone().requires_grad_(True)
                (c.gather(z, axis, 0, grad, mesh) * (r + 1)).sum().backward()
                res[f"gather_{grad}_grad"] = _np(z.grad)
            z = y.clone().requires_grad_(True)
            (c.all_to_all(z, axis, split_dim=0, concat_dim=1, mesh=mesh)
             * (r + 1)).sum().backward()
            res["a2a_grad"] = _np(z.grad)
            out["+".join(axis) if isinstance(axis, tuple)
                else axis] = res
        c.barrier(AXES, mesh)
        results.append(out)
    return results


# -- ring and Ulysses attention ------------------------------------------------------

def attention_rank(jobs: list, inputs: dict):
    """Each job (scheme "ring"|"ulysses", mesh shape) on this rank's
    sequence chunk of ``inputs`` (q/k/v/dout [B, S, N, D], positions and
    segments [B, S]; every data index computes the whole batch): its out,
    dq, dk, dv chunks."""
    import torch
    import torch.distributed as dist

    from distributed_llm_training_and_inference_system_tpu_torch.ops \
        import ring_attention, ulysses
    from distributed_llm_training_and_inference_system_tpu_torch.parallel\
        .mesh import AXES, Mesh
    results = []
    for scheme, shape in jobs:
        full = {a: shape.get(a, 1) for a in AXES}
        mesh = Mesh(full, dist.get_rank(), dist.get_world_size(), "gloo",
                    torch.device("cpu"))
        sp, i = mesh.axis_size("sp"), mesh.axis_index("sp")

        def chunk(a):
            t = torch.from_numpy(np.asarray(a))
            n = t.shape[1] // sp
            return t[:, i * n:(i + 1) * n].contiguous()
        q, k, v = (chunk(inputs[n]).requires_grad_(True)
                   for n in ("q", "k", "v"))
        pos, seg = chunk(inputs["positions"]), chunk(inputs["segment_ids"])
        fn = (ulysses.ulysses_attention if scheme == "ulysses"
              else ring_attention.ring_attention)
        if scheme == "ring-remat-thread":
            # the forward checkpointed, the backward (and with it the
            # recomputation) on another thread, as autograd runs a CUDA
            # backward on a device thread of its own
            import threading

            from torch.utils.checkpoint import checkpoint
            out = checkpoint(lambda a, b, c_: fn(
                a, b, c_, positions=pos, segment_ids=seg, mesh=mesh),
                q, k, v, use_reentrant=False)
            th = threading.Thread(target=out.backward,
                                  args=(chunk(inputs["dout"]),))
            th.start()
            th.join()
        else:
            out = fn(q, k, v, positions=pos, segment_ids=seg, mesh=mesh)
            out.backward(chunk(inputs["dout"]))
        results.append({"sp_index": i, "out": _np(out), "dq": _np(q.grad),
                        "dk": _np(k.grad), "dv": _np(v.grad)})
    return results


# -- sharded training --------------------------------------------------------------

def model_config(model):
    """The port's config of ``model``: a preset's name, or a dict of its
    name and fields to replace (``{"name": "gpt-test", "num_layers": 4}``)."""
    import dataclasses

    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import get_model_config
    if isinstance(model, str):
        return get_model_config(model)
    over = dict(model)
    cfg = get_model_config(over.pop("name"))
    moe = over.pop("moe", None)
    if moe:
        over["moe"] = dataclasses.replace(cfg.moe, **moe)
    return dataclasses.replace(cfg, **over)


def train_rank(model, par: dict, params: dict, batches: list,
               attn_impl: str = "xla", opt: dict = None,
               ckpt_dir: str = None, grads: bool = False):
    """``ShardedTrainer`` of ``model`` (``model_config``) on the mesh of
    ``par`` (ParallelConfig fields) from ``params`` (a JAX-layout tree by
    dotted path, numpy): a step on this rank's rows of each global batch.
    Returns the first batch's eval loss, the losses and grad norms, this
    rank's shard shapes and specs, its param shards at init and moment
    shards at the end, and on rank 0 the whole final params (JAX layout).
    With ``ckpt_dir`` rank 0 saves the final state there in the
    single-device format; with ``grads`` the first batch's loss, aux and
    gradient shards (``ShardedTrainer.gradients``) before its step."""
    import torch

    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import OptimizerConfig, ParallelConfig
    from distributed_llm_training_and_inference_system_tpu_torch.parallel\
        .api import ShardedTrainer, flatten_tree
    from distributed_llm_training_and_inference_system_tpu_torch.weights \
        import tree_from_named
    cfg = model_config(model)
    trainer = ShardedTrainer(cfg, OptimizerConfig(**(opt or {"lr": 1e-2})),
                             ParallelConfig(**par), torch.device("cpu"),
                             attn_impl=attn_impl)
    trainer.init_state(params=params)
    out = {"losses": [], "grad_norms": [], "rank": trainer.mesh.rank,
           "coords": trainer.mesh.coords, "shapes": trainer.local_shapes(),
           "p_specs": trainer.layout.p_specs,
           "o_specs": trainer.layout.o_specs,
           "init_shards": {p: _np(t) for p, t in
                           trainer.state.params.items()}}
    for i, b in enumerate(batches):
        local = trainer.shard_batch({k: torch.from_numpy(np.asarray(v))
                                     for k, v in b.items()})
        local["tokens"] = local["tokens"].long()
        if i == 0:      # the forward alone, before the first update
            out["eval_loss"] = float(trainer.evaluate(local)["loss"])
            if grads:
                g = trainer.gradients(local)
                out["grads"] = {p: _np(t) for p, t in g["grads"].items()}
                out["grad_loss"] = float(g["loss"])
                out["aux"] = float(g["aux"])
        m = trainer.step(local)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["mu_shards"] = {p: _np(t) for p, t in trainer.state.mu.items()}
    full = trainer.full_state_dict()
    if trainer.mesh.rank == 0:
        out["params"] = {p: t.numpy() for p, t in flatten_tree(
            tree_from_named(full["params"])).items()}
        if ckpt_dir:
            from distributed_llm_training_and_inference_system_tpu_torch.\
                io.checkpoint import CheckpointManager
            CheckpointManager(ckpt_dir, async_save=False).save(
                full["step"], full, extra={"step": full["step"]})
    return out


def saved_bytes_rank(model, par: dict, seq: int):
    """The most bytes that autograd holds saved for backward at once on
    this rank (``saved_tensors_hooks``) over one step's gradient of a
    pipelined ``ShardedTrainer``, fed ``num_microbatches`` rows of
    ``seq`` ones a data rank."""
    import torch

    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import OptimizerConfig, ParallelConfig
    from distributed_llm_training_and_inference_system_tpu_torch.parallel\
        .api import ShardedTrainer
    par = ParallelConfig(**par)
    trainer = ShardedTrainer(model_config(model), OptimizerConfig(), par,
                             torch.device("cpu"))
    trainer.init_state(seed=0)
    live = [0, 0]               # bytes held now, the most held

    class Held:
        def __init__(self, t):
            self.t, self.n = t, t.numel() * t.element_size()
            live[0] += self.n
            live[1] = max(live[1], live[0])

        def __del__(self):
            live[0] -= self.n

    rows = par.num_microbatches * trainer.data_size
    batch = trainer.shard_batch(
        {"tokens": torch.ones((rows, seq), dtype=torch.long)})
    with torch.autograd.graph.saved_tensors_hooks(Held, lambda h: h.t):
        trainer.gradients(batch)
    return live[1]


def schedules_rank(model, par: dict, seq: int):
    """The backend and, under each pipeline schedule (GPipe, then 1F1B),
    the first step's loss and this rank's gradients' sum of squares of a
    ``ShardedTrainer`` of ``model`` on the mesh of ``par`` on this rank's
    device (the card it joined with, else the CPU), fed seeded tokens of
    ``seq``: ``num_microbatches`` rows a data rank."""
    import torch
    import torch.distributed as dist

    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import OptimizerConfig, ParallelConfig
    from distributed_llm_training_and_inference_system_tpu_torch.parallel\
        .api import ShardedTrainer
    cfg = model_config(model)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    out = {"backend": dist.get_backend()}
    for schedule in ("gpipe", "1f1b"):
        p = ParallelConfig(**par, pipeline_schedule=schedule)
        trainer = ShardedTrainer(cfg, OptimizerConfig(), p, dev)
        trainer.init_state(seed=0)
        rows = p.num_microbatches * trainer.data_size
        g = torch.Generator().manual_seed(0)
        tokens = torch.randint(1, cfg.vocab_size, (rows, seq),
                               generator=g).to(dev)
        got = trainer.gradients(trainer.shard_batch({"tokens": tokens}))
        out[schedule] = {
            "loss": float(got["loss"]),
            "sq": float(sum(t.double().square().sum()
                            for t in got["grads"].values()))}
        del trainer, got
    return out


def jobs_rank(jobs: list):
    """Each job (a function of this module by name, its arguments) in
    turn on every rank: the configurations of one world size in one
    spawn."""
    return [globals()[fn](*args) for fn, args in jobs]


# -- tensor-parallel serving ---------------------------------------------------------

SERVE = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
             prefill_chunk=32, kv_block_size=8, dtype="float32")


def _leaf_parts(leaf) -> tuple:
    return tuple(_np(t) for t in (leaf.tensors() if hasattr(leaf, "tensors")
                                  else (leaf,)))


def serve_rank(tree: dict, cases: dict, shard_kinds=()):
    """Every tp rank builds, for each case ``{name: (ServeConfig
    overrides, [(prompts, sampling, "each" | "together"), ...])}``, a
    gpt-test engine at tensor_parallel = world from ``tree`` (a JAX params
    tree, numpy: quantized whole, then cut, by
    ``weights.rank_params_from_jax``); rank 0 generates, the others
    follow. Returns, on rank 0, {case: {"tokens": [[...], ...] a run,
    "stats", "report"}}, on the others {case: {"report"}}; with
    ``shard_kinds`` (quantization kinds) also every leaf's parts under
    "shards": {kind: {port name: (parts...)}}, and each case's page shape
    under "pages"."""
    import torch

    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import ParallelConfig, ServeConfig, get_model_config
    from distributed_llm_training_and_inference_system_tpu_torch.parallel\
        .mesh import build_mesh
    from distributed_llm_training_and_inference_system_tpu_torch.serve \
        import InferenceEngine, SamplingParams
    from distributed_llm_training_and_inference_system_tpu_torch.weights \
        import rank_params_from_jax
    import torch.distributed as dist
    cfg = get_model_config("gpt-test")
    tp = dist.get_world_size()
    mesh = build_mesh(ParallelConfig(tensor_parallel=tp), torch.device("cpu"))
    out = {"shards": {}}
    for kind in shard_kinds:
        model = rank_params_from_jax(tree, cfg, mesh, kind, device="cpu")
        named = {"embed": model.embed, "final_norm": model.final_norm}
        if model.lm_head is not None:
            named["lm_head"] = model.lm_head
        for i, blk in enumerate(model.blocks):
            named.update({f"blocks.{i}.{n}": leaf
                          for n, leaf in blk.leaves().items()})
        out["shards"][kind] = {n: _leaf_parts(v) for n, v in named.items()}
    for name, (over, runs) in cases.items():
        kw = dict(SERVE, tensor_parallel=tp, **over)
        quant = kw.get("quantization", "none")
        params = rank_params_from_jax(tree, cfg, mesh, quant, device="cpu")
        eng = InferenceEngine(cfg, ServeConfig(**kw), params=params, seed=0,
                              device="cpu")
        res = {"pages": tuple(eng.kv.k_pages.shape if torch.is_tensor(
            eng.kv.k_pages) else eng.kv.k_pages.values.shape)}
        if eng.is_follower:
            eng.follow()
        else:
            res["tokens"] = []
            for prompts, sampling, how in runs:
                sp = SamplingParams(**sampling)
                groups = ([[p] for p in prompts] if how == "each"
                          else [prompts])
                res["tokens"].append([r.generated_tokens for g in groups
                                      for r in eng.generate(g, sp)])
            res["stats"] = eng.stats()
            eng.stop_followers()
        res["report"] = eng.launch_report()
        out[name] = res
    return out


class _Gone(Exception):
    pass


def dead_follower_rank(tree: dict):
    """tp=world on gpt-test: a request is served; then the follower leaves
    on receiving the next request's prefill and closes its sockets, as a
    process that dies does: the leader's generate must raise. Returns, on
    rank 0, (the first request's tokens, the exception's type name, the
    seconds to the raise, what ``recover()`` says)."""
    import time

    import torch
    import torch.distributed as dist

    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import ParallelConfig, ServeConfig, get_model_config
    from distributed_llm_training_and_inference_system_tpu_torch.parallel\
        .mesh import build_mesh
    from distributed_llm_training_and_inference_system_tpu_torch.serve \
        import InferenceEngine, SamplingParams
    from distributed_llm_training_and_inference_system_tpu_torch.weights \
        import rank_params_from_jax
    cfg = get_model_config("gpt-test")
    tp = dist.get_world_size()
    mesh = build_mesh(ParallelConfig(tensor_parallel=tp), torch.device("cpu"))
    eng = InferenceEngine(
        cfg, ServeConfig(**SERVE, tensor_parallel=tp),
        params=rank_params_from_jax(tree, cfg, mesh, device="cpu"), seed=0,
        device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=4)
    if eng.is_follower:
        prefills = [0]
        recv = eng._link.recv

        def counted():
            d = recv()
            if d[0] == "_prefill_dense":
                prefills[0] += 1
                if prefills[0] == 2:
                    raise _Gone
            return d
        eng._link.recv = counted
        try:
            eng.follow()
        except _Gone:
            pass
        dist.destroy_process_group()
        return None
    [first] = eng.generate([[5, 17, 99, 3]], sp)
    t0 = time.monotonic()
    try:
        eng.generate([[1, 2, 3, 4, 5]], sp)
    except Exception as e:              # noqa: BLE001  (reported)
        return (first.generated_tokens, type(e).__name__,
                time.monotonic() - t0, eng.recover())
    return first.generated_tokens, "no error", time.monotonic() - t0, None


# -- collective benchmarks and tuning -------------------------------------------------

def comms_bench_rank(size_mb: float):
    """``bench_all`` over the one axis of a world-rank mesh, then one
    ``CollectiveTuner`` search (its grid cut to 4 configurations). Returns
    (rows, the tuning result's dict, the tuner's cache key)."""
    import torch
    import torch.distributed as dist

    from distributed_llm_training_and_inference_system_tpu_torch.comms \
        .bench import bench_all
    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import ParallelConfig
    from distributed_llm_training_and_inference_system_tpu_torch.parallel\
        .mesh import build_mesh
    from distributed_llm_training_and_inference_system_tpu_torch.plugins\
        .autotuning import AutoTuner, TuningConfig
    mesh = build_mesh(ParallelConfig(data_parallel=dist.get_world_size()),
                      torch.device("cpu"))
    rows = bench_all(mesh, "dp", size_mb)
    tuner = AutoTuner(TuningConfig(max_iterations=4, num_trials=2,
                                   num_warmup=1), device="cpu")
    res = tuner.tune_collective(mesh, "dp", size_mb)
    return rows, res.to_dict(), sorted(tuner.cache)


def odd_shapes_rank():
    """gpt-test with a tied head (the embedding's hidden slice a rank, the
    head's partial logits all-reduced) and an FFN width that tp does not
    divide (replicated on every rank, as JAX's ``_shrink_to_fit`` leaves
    it): rank 0 returns the tp engine's greedy tokens and the one-rank
    engine's on the same weights, with the shapes it holds."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import ServeConfig, get_model_config
    from distributed_llm_training_and_inference_system_tpu_torch.models \
        import gpt
    from distributed_llm_training_and_inference_system_tpu_torch.serve \
        import InferenceEngine, SamplingParams
    tp = dist.get_world_size()
    cfg = dataclasses.replace(get_model_config("gpt-test"),
                              tie_word_embeddings=True, ffn_size=99)
    model = gpt.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    eng = InferenceEngine(cfg, ServeConfig(**SERVE, tensor_parallel=tp),
                          params=model, seed=0, device="cpu")
    if eng.is_follower:
        eng.follow()
        return None
    sp = SamplingParams(temperature=0.0, max_tokens=8)
    prompts = [[5, 17, 99, 3, 42, 7, 23], [1, 2, 3, 4, 5, 6, 7, 8, 9]]
    got = [r.generated_tokens for r in eng.generate(prompts, sp)]
    eng.stop_followers()
    one = InferenceEngine(cfg, ServeConfig(**SERVE), params=model, seed=0,
                          device="cpu")
    want = [r.generated_tokens for r in one.generate(prompts, sp)]
    return got, want, (tuple(eng.params.embed.shape),
                       tuple(eng.params.blocks[0].gate.shape))
