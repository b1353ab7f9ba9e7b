"""The leader/follower protocol of a tensor-parallel serving engine.

The JAX engine serves ``tensor_parallel > 1`` from one controller: its
params and pages are global arrays and GSPMD inserts the collectives. The
port runs one process per rank (``parallel/mesh.py``), each holding its
shard of every weight and its kv heads of every page, and places the
collectives itself (``models.gpt.TPSums``, ``embed_tokens``, ``unembed``).

- **Rank 0 leads.** It owns the scheduler, the HTTP-facing API and every
  piece of host state (page tables, the prefix cache, pins, reservations).
- **Descriptors.** Before every device operation (a prefill, a chunk, a
  decode group, a verify window, a swap extract or restore, a timing
  probe) the leader broadcasts a small host descriptor over a control
  group: the engine method's name, its host arguments and, for the
  decode-side operations, the host arrays they read (last tokens,
  positions, stops, seeds, sampling knobs, block tables). A follower's
  ``InferenceEngine.follow`` runs the same method on its shards, so the
  collectives inside the forwards pair up rank for rank.
- **Sampling.** Every rank samples from the same gathered logits with the
  same keyed noise, so tokens fed back on the device agree with no
  further collective.
- **Swap payloads.** Each rank keeps its own host payload of its heads,
  keyed by the request id.
- **No hang.** The control group is gloo (host memory, whatever the data
  backend) with a long timeout, so an idle leader never times its
  followers out; a follower that dies closes its sockets, and the
  leader's next broadcast or all-reduce raises, which fails the engine's
  step as any other device failure does. Every collective of the forward
  runs under the data group's timeout (``mesh.DEFAULT_TIMEOUT_S``).
"""

from __future__ import annotations

import datetime
import functools

import torch.distributed as dist

# an idle server sends nothing: the followers wait this long for the next
# descriptor (a dead leader closes its sockets and fails them at once)
IDLE_TIMEOUT = datetime.timedelta(days=30)

STOP = "stop"


class RankLink:
    """The tp ranks' control channel: rank 0 of the tp axis sends
    descriptors, the others receive them in order. Every rank of the mesh
    constructs it (``new_group`` is collective)."""

    def __init__(self, mesh):
        self.mesh = mesh
        members = mesh.members("tp")
        self.leader_rank = members[0]
        self.leader = mesh.rank == self.leader_rank
        self.group = dist.new_group(members, backend="gloo",
                                    timeout=IDLE_TIMEOUT)
        self.closed = False

    def send(self, op: str, args: tuple = (), kwargs=None, state=None,
             drops=()) -> None:
        """Broadcast one descriptor (leader only)."""
        if self.closed:
            raise RuntimeError("tensor-parallel followers were stopped")
        box = [(op, args, kwargs or {}, state, list(drops))]
        dist.broadcast_object_list(box, src=self.leader_rank,
                                   group=self.group)

    def recv(self) -> tuple:
        """The next descriptor (followers): (op, args, kwargs, state,
        drops)."""
        box = [None]
        dist.broadcast_object_list(box, src=self.leader_rank,
                                   group=self.group)
        return box[0]

    def stop(self) -> None:
        """Tell the followers to leave ``follow`` (leader; once)."""
        if self.leader and not self.closed:
            self.send(STOP)
            self.closed = True


def on_every_rank(state: bool = False):
    """Decorate an engine method that touches the device: on a
    tensor-parallel leader it first broadcasts itself (its name and host
    arguments, with ``state`` the engine's mirrored host arrays), so each
    follower runs the same method on its shards. The method's arguments
    must be host values (numpy arrays, numbers, tuples)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(self, *args, **kwargs):
            # an object that borrows the method (a replay's shim) has none
            link = getattr(self, "_link", None)
            if link is not None and link.leader:
                link.send(fn.__name__, args, kwargs,
                          self._host_state() if state else None,
                          self._take_drops())
            return fn(self, *args, **kwargs)
        return run
    return wrap
