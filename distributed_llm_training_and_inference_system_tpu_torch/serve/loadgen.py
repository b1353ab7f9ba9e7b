"""Load generation for one inference engine (the JAX package's
``serve/loadgen.py`` for engine targets).

Drives ``InferenceEngine.step()`` directly (no HTTP), so the numbers are the
engine's, not a web stack's:

- ``run_poisson``: open loop. Arrivals follow a seeded Poisson process of
  rate ``offered_rps`` whatever the engine's progress; the engine steps
  until every admitted request has finished, so late arrivals' tails count.
- ``run_closed_loop``: ``concurrency`` requests in flight, a new one the
  moment one finishes (the saturation probe).

Prompts and arrival gaps come from ``numpy.random.default_rng(seed)`` in
the JAX module's order of draws, so both packages offer the same requests.
Every request is greedy. ``LoadResult.summary()`` reports p50/p99 TTFT
(arrival to first token), p50/p99 TPOT ((finish - first token) / (n - 1)),
goodput (completed tokens over the wall), preemptions and the queue's
high-water mark; ``device_times=True`` adds the TTFT a co-located client
would see (queue wait + the bucket's on-device prefill,
``engine.measure_device_times``).

Fleet targets and the fleet scenarios (``run_returning``,
``FrontStreamClient``, ``run_stream_fronts``, ``run_scenario``) need the
fleet (ROADMAP queue 1 item 9) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .scheduler import Request, RequestState, SamplingParams

_FLEET = ("is a fleet target; the PyTorch port has no fleet yet (ROADMAP "
          "queue 1 item 9, serve/fleet/)")


@dataclass
class LoadResult:
    offered_rps: float
    completed: int = 0
    failed: int = 0
    duration_s: float = 0.0
    ttft_ms: list = field(default_factory=list)
    # queue wait + the on-device prefill of the request's bucket
    ttft_device_ms: list = field(default_factory=list)
    tpot_ms: list = field(default_factory=list)
    preemptions: int = 0
    queue_peak: int = 0
    goodput_tokens_per_s: float = 0.0
    decode_ms_per_token_device: Optional[float] = None

    def percentile(self, xs, q):
        return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")

    def summary(self) -> dict:
        return {
            # None for closed-loop runs (offered load is "as fast as the
            # engine finishes"); inf would serialise as non-standard JSON
            "offered_rps": (round(self.offered_rps, 3)
                            if np.isfinite(self.offered_rps) else None),
            "completed": self.completed,
            "failed": self.failed,
            "duration_s": round(self.duration_s, 2),
            "p50_ttft_ms": round(self.percentile(self.ttft_ms, 50), 1),
            "p99_ttft_ms": round(self.percentile(self.ttft_ms, 99), 1),
            "p50_tpot_ms": round(self.percentile(self.tpot_ms, 50), 2),
            "p99_tpot_ms": round(self.percentile(self.tpot_ms, 99), 2),
            "goodput_tok_s": round(self.goodput_tokens_per_s, 1),
            "preemptions": self.preemptions,
            "queue_peak": self.queue_peak,
            **({"p50_ttft_device_ms":
                round(self.percentile(self.ttft_device_ms, 50), 1),
                "p99_ttft_device_ms":
                round(self.percentile(self.ttft_device_ms, 99), 1),
                "decode_ms_per_token_device":
                round(self.decode_ms_per_token_device, 3)}
               if self.ttft_device_ms else {}),
        }


def _finalize(res: LoadResult, reqs: list, engine, t0: float) -> LoadResult:
    res.duration_s = time.monotonic() - t0
    done_tokens = 0
    for r in reqs:
        if r.state is RequestState.FINISHED:
            res.completed += 1
            done_tokens += len(r.generated_tokens)
            if r.ttft_ms is not None:
                res.ttft_ms.append(r.ttft_ms)
            if len(r.generated_tokens) > 1 and r.finish_time is not None \
                    and r.first_token_time is not None:
                res.tpot_ms.append(
                    (r.finish_time - r.first_token_time) * 1000.0
                    / (len(r.generated_tokens) - 1))
        elif r.state in (RequestState.FAILED, RequestState.CANCELLED):
            res.failed += 1
    res.preemptions = engine.total_preemptions
    res.goodput_tokens_per_s = done_tokens / max(res.duration_s, 1e-9)
    return res


def attach_device_times(res: LoadResult, reqs: list, engine) -> LoadResult:
    """Fill ``res.ttft_device_ms`` from a calibration after the run: per
    request, (prefill dispatch - arrival, a host wait) + the on-device
    prefill time of its bucket. Requests without a dense bucket (suffix
    or chunked prefills) are skipped."""
    cal = engine.measure_device_times()
    for r in reqs:
        if (r.state is RequestState.FINISHED
                and r.prefill_dispatch_time is not None
                and r.prefill_bucket in cal["prefill_ms"]):
            queue_ms = (r.prefill_dispatch_time - r.arrival_time) * 1e3
            res.ttft_device_ms.append(
                queue_ms + cal["prefill_ms"][r.prefill_bucket])
    res.decode_ms_per_token_device = cal["decode_ms_per_token"]
    return res


def _refuse_fleet(target) -> None:
    if hasattr(target, "router"):
        raise NotImplementedError(f"{type(target).__name__} {_FLEET}")


def _hot_prefix(rng, hi, prompt_len, hot_prefix_len: int) -> list:
    """The shared head of every flash-crowd prompt (drawn once a run),
    clamped to leave at least one distinct tail token."""
    k = min(max(hot_prefix_len, 0), max(prompt_len - 1, 0))
    return [int(t) for t in rng.integers(1, hi, size=k)] if k else []


def run_poisson(engine, *, offered_rps: float, num_requests: int,
                prompt_len: int, max_tokens: int, seed: int = 0,
                vocab_hi: Optional[int] = None, prompt_pool: int = 0,
                hot_prefix_len: int = 0, device_times: bool = False
                ) -> LoadResult:
    """Open-loop run; steps until everything admitted drains.
    ``prompt_pool > 0`` draws prompts from that many distinct prompts;
    ``hot_prefix_len > 0`` gives every prompt the same seeded head."""
    _refuse_fleet(engine)
    rng = np.random.default_rng(seed)
    hi = vocab_hi or engine.cfg.vocab_size
    gaps = rng.exponential(1.0 / offered_rps, size=num_requests)
    arrivals = np.cumsum(gaps)
    hot = _hot_prefix(rng, hi, prompt_len, hot_prefix_len)
    pool = [hot + rng.integers(1, hi, size=prompt_len - len(hot)).tolist()
            for _ in range(max(prompt_pool, 1))]

    reqs: list[Request] = []
    res = LoadResult(offered_rps=offered_rps)
    t0 = time.monotonic()
    i = 0
    while i < num_requests or engine.scheduler.active_count > 0 \
            or engine.scheduler.queue_depth > 0 or engine._partial_prefills:
        now = time.monotonic() - t0
        while i < num_requests and arrivals[i] <= now:
            prompt = (pool[int(rng.integers(len(pool)))] if prompt_pool
                      else hot + rng.integers(
                          1, hi, size=prompt_len - len(hot)).tolist())
            r = Request(request_id=f"load-{i}", prompt_tokens=prompt,
                        sampling=SamplingParams(temperature=0.0,
                                                max_tokens=max_tokens))
            if engine.scheduler.add_request(r):
                reqs.append(r)
            else:
                res.failed += 1
            i += 1
        res.queue_peak = max(res.queue_peak, engine.scheduler.queue_depth)
        if engine.step() == 0 and i < num_requests:
            # idle before the next arrival: sleep to it, not spin
            wait = arrivals[i] - (time.monotonic() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.05))
    res = _finalize(res, reqs, engine, t0)
    if device_times:
        attach_device_times(res, reqs, engine)
    return res


def run_closed_loop(engine, *, concurrency: int, num_requests: int,
                    prompt_len: int, max_tokens: int, seed: int = 0,
                    vocab_hi: Optional[int] = None,
                    hot_prefix_len: int = 0,
                    device_times: bool = False) -> LoadResult:
    """Closed-loop run: ``concurrency`` requests in flight, a new one
    arriving the moment one finishes."""
    _refuse_fleet(engine)
    rng = np.random.default_rng(seed)
    hi = vocab_hi or engine.cfg.vocab_size
    hot = _hot_prefix(rng, hi, prompt_len, hot_prefix_len)
    reqs: list[Request] = []
    res = LoadResult(offered_rps=float("inf"))
    submitted = 0
    t0 = time.monotonic()

    def submit():
        nonlocal submitted
        r = Request(request_id=f"load-{submitted}",
                    prompt_tokens=hot + rng.integers(
                        1, hi, size=prompt_len - len(hot)).tolist(),
                    sampling=SamplingParams(temperature=0.0,
                                            max_tokens=max_tokens))
        submitted += 1
        if engine.scheduler.add_request(r):
            reqs.append(r)
        else:
            res.failed += 1

    def in_flight() -> int:
        return sum(1 for r in reqs if r.state in (
            RequestState.QUEUED, RequestState.PREFILLING,
            RequestState.RUNNING))

    while submitted < num_requests or in_flight() > 0:
        while submitted < num_requests and in_flight() < concurrency:
            submit()
        res.queue_peak = max(res.queue_peak, engine.scheduler.queue_depth)
        engine.step()
    res = _finalize(res, reqs, engine, t0)
    if device_times:
        attach_device_times(res, reqs, engine)
    return res


def run_returning(*args, **kwargs):
    """The returning-conversation scenario (the fleet KV store's)."""
    raise NotImplementedError(f"run_returning {_FLEET}")


def run_stream_fronts(*args, **kwargs):
    """Streams through HA fleet fronts."""
    raise NotImplementedError(f"run_stream_fronts {_FLEET}")


def run_scenario(*args, **kwargs):
    """The autoscaler's scenario matrix."""
    raise NotImplementedError(f"run_scenario {_FLEET}")


class FrontStreamClient:
    """The fleet fronts' reconnecting stream client."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"FrontStreamClient {_FLEET}")
