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


def _rank_main(rank, world, port, fn, args, out_dir):
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
        init_distributed(torch.device("cpu"), timeout_s=120)
        result = ("ok", fn(*args))
    except BaseException:           # noqa: BLE001  (reported to the test)
        result = ("error", traceback.format_exc())
    path.write_bytes(pickle.dumps(result))
    if dist.is_initialized():
        dist.destroy_process_group()


# the ranks fork from one server process that has imported these once
# (multiprocessing's forkserver), not from the test process, which holds
# JAX's threads
_PRELOAD = ["torch", "torch.distributed",
            "distributed_llm_training_and_inference_system_tpu_torch.parallel"
            ".api", "torch_dist_ranks"]


def spawn(fn, world: int, *args) -> list:
    import multiprocessing

    import torch.multiprocessing as mp
    multiprocessing.set_forkserver_preload(_PRELOAD)
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_rank_main,
                           args=(world, free_port(), fn, args, out_dir),
                           nprocs=world, join=True,
                           start_method="forkserver")
        results = [pickle.loads((Path(out_dir) / f"{r}.pkl").read_bytes())
                   for r in range(world)]
    errors = [(r, res[1]) for r, res in enumerate(results)
              if res[0] != "ok"]
    if errors:
        raise AssertionError("\n".join(f"rank {r}:\n{tb}"
                                       for r, tb in errors))
    return [res[1] for res in results]


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

def train_rank(model: str, par: dict, params: dict, batches: list,
               attn_impl: str = "xla", opt: dict = None,
               ckpt_dir: str = None):
    """``ShardedTrainer`` of ``model`` on the mesh of ``par``
    (ParallelConfig fields) from ``params`` (a JAX-layout tree by dotted
    path, numpy): a step on this rank's rows of each global batch. Returns
    the first batch's eval loss, the losses and grad norms, this rank's
    shard shapes and specs, its param shards at init and moment shards at
    the end, and on rank 0 the whole final params (JAX layout). With ``ckpt_dir`` rank 0
    saves the final state there in the single-device format."""
    import torch

    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import OptimizerConfig, ParallelConfig, get_model_config
    from distributed_llm_training_and_inference_system_tpu_torch.parallel\
        .api import ShardedTrainer, flatten_tree
    from distributed_llm_training_and_inference_system_tpu_torch.weights \
        import tree_from_named
    cfg = get_model_config(model)
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
