"""Time one heartbeat of the HA fronts' shared file state store.

    python -m distributed_llm_training_and_inference_system_tpu_torch.profile_state_store \
        [--dir D] [--beats 500]

Two fronts attach to a store under ``--dir`` (a temporary directory by
default). The script times, on the host clock, each of ``--beats``:

- the port's ``heartbeat`` (one in-place ``pwrite`` of the front's beat
  file under the store's ``flock``);
- an atomic registry rewrite (``_save_registry``: a temporary file and
  ``os.replace`` under the same lock), what the JAX store's heartbeat does
  on every beat and the port keeps for attach, fence, counters and
  compaction;
- ``fronts_view`` (the registry and every beat file read under the lock).

It prints p50, p99 and max of each in ms, beside the store's default
expiry for a probe interval of 0.05 s (0.25 s) and the 0.05 s expiry the
store's tests use, and exits 1 if a beat's p99 exceeds a tenth of the
tests' expiry. No device is used.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

from .serve.fleet.state import SharedFileStateStore

TEST_EXPIRY_S = 0.05


def _times(fn, n: int) -> dict:
    xs = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        xs.append((time.perf_counter() - t0) * 1e3)
    xs.sort()
    return {"p50_ms": xs[len(xs) // 2], "p99_ms": xs[int(0.99 * len(xs))],
            "max_ms": xs[-1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None,
                    help="store directory (default: a temporary one)")
    ap.add_argument("--beats", type=int, default=500)
    args = ap.parse_args(argv)
    root = args.dir or tempfile.mkdtemp(prefix="llmctl-store-")
    a = SharedFileStateStore(root, front_id="front-a")
    b = SharedFileStateStore(root, front_id="front-b")
    a.attach(info={"port": 1})
    b.attach(info={"port": 2})

    def rewrite():
        with a._locked():
            a._save_registry(a._load_registry())

    out = {"dir": root, "beats": args.beats,
           "heartbeat": _times(
               lambda: a.heartbeat(info={"active_streams": 0}), args.beats),
           "registry_rewrite": _times(rewrite, args.beats),
           "fronts_view": _times(b.fronts_view, args.beats),
           "expiry_default_s": 0.25, "expiry_tests_s": TEST_EXPIRY_S}
    print(json.dumps(out, indent=1))
    return 0 if out["heartbeat"]["p99_ms"] <= TEST_EXPIRY_S * 1e3 / 10 \
        else 1


if __name__ == "__main__":
    raise SystemExit(main())
