"""Device-synchronised timing (the JAX package's ``utils/timing.py``).

``time_fn`` keeps the JAX function's contract: warm-up calls, then
``iters`` timed calls split into ``windows`` pipelined windows, and the
best window's mean seconds a call. On the card each window is bracketed by
CUDA events on the current stream (the calls are queued back to back and
the events time the device); on the CPU the host clock times each window,
which ends once the last call has returned.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ..device import resolve_device


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            windows: int = 3, device=None) -> float:
    """Best-window mean seconds per call of ``fn(*args)``.

    ``iters`` is the TOTAL timed-call budget, split across ``windows``.
    ``device`` is the card (``None``, the default, raises without one) or
    ``"cpu"``."""
    dev = resolve_device(device)
    for _ in range(max(warmup, 1)):
        fn(*args)
    windows = max(min(windows, iters), 1)
    per_window = max(iters // windows, 1)
    best = float("inf")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(windows):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_window):
                fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / per_window)
        return best
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(per_window):
            fn(*args)
        best = min(best, (time.perf_counter() - t0) / per_window)
    return best
