"""Marker decorators for graftlint (the AST invariant checker).

Every decorator here is a RUNTIME NO-OP: it returns the function
unchanged (no wrapper frame, no closure cell — the engine hot loop and
the aiohttp handlers pay nothing) and only stamps a ``__graftlint__``
attribute for interactive introspection. The real consumer is the
static analyzer (``analysis/``), which reads the decorator NAMES off the
AST — so the annotations work even on code paths that never import at
lint time.

Thread-context vocabulary (the PR-7 extract seam, generalized):

- ``@engine_thread_only`` — touches engine/device state (donated KV page
  buffers, scheduler slots mid-dispatch, pipelined dispatch records)
  that is only coherent ON the engine's stepping thread at a loop
  boundary. The thread-context pass asserts no supervisor-poll or
  aiohttp-handler call path reaches one of these except through a
  ``@thread_seam``.
- ``@supervisor_thread`` — runs on the supervisor poll thread (or a
  deterministic ``poll_once`` caller). A root for the reachability
  check.
- ``@aiohttp_handler`` — runs on the asyncio event loop serving HTTP.
  Also a root; additionally these must never block on engine work
  directly (they go through seams, executors, or queues).
- ``@thread_seam`` — a deliberately thread-safe boundary: safe to call
  from ANY thread because it only enqueues work for the engine thread,
  reads lock-free advisory state, or takes the engine lock for a
  bounded host-only critical section. Traversal STOPS here.

Parity vocabulary (the PR-10 np/jnp twin contract):

- ``@np_twin_of("jnp_name")`` — this ``*_np`` function is the numpy
  twin of a differently-named jnp function; the parity pass signature-
  matches against that name instead of the ``_np``-stripped default.
- ``@np_host_only("reason")`` — this ``*_np`` function has no jnp
  counterpart BY DESIGN (e.g. the courier wire codec runs host-side
  only); the parity pass skips it but records the reason.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def _mark(fn: F, tag: str) -> F:
    marks = getattr(fn, "__graftlint__", ())
    try:
        fn.__graftlint__ = (*marks, tag)
    except (AttributeError, TypeError):   # builtins / slotted callables
        pass
    return fn


def engine_thread_only(fn: F) -> F:
    """Only coherent on the engine's stepping thread at loop boundaries."""
    return _mark(fn, "engine_thread_only")


def supervisor_thread(fn: F) -> F:
    """Runs on the supervisor poll thread (or explicit poll_once)."""
    return _mark(fn, "supervisor_thread")


def aiohttp_handler(fn: F) -> F:
    """Runs on the asyncio event loop serving HTTP."""
    return _mark(fn, "aiohttp_handler")


def thread_seam(fn: F) -> F:
    """Thread-safe boundary between foreign threads and the engine."""
    return _mark(fn, "thread_seam")


def np_twin_of(jnp_name: str) -> Callable[[F], F]:
    """The numpy twin of the named jnp function (parity pass target)."""
    def deco(fn: F) -> F:
        fn.__np_twin_of__ = jnp_name
        return _mark(fn, "np_twin_of")
    return deco


def np_host_only(reason: str) -> Callable[[F], F]:
    """No jnp counterpart by design; ``reason`` documents why."""
    def deco(fn: F) -> F:
        fn.__np_host_only__ = reason
        return _mark(fn, "np_host_only")
    return deco
