"""The seeded mixed-length serving trace and its counter loop.

The port of the serving benchmark loop of the JAX package's
`tools/bench_transformer.py` (`serving_bench`), with the levers off. The
`np.random.RandomState(seed)` draws come in the same order (per request:
prompt length, new tokens, arrival step, prompt tokens; then one warm-up
prompt per prefill bucket the trace uses), so the same arguments give
the same requests, the same schedule and therefore the same
deterministic counters as the JAX engine: `engine_steps`,
`requests_completed`, `max_step_prefill_tokens`, `goodput`,
`mean_slot_occupancy`, `mean_page_utilization`, `warmup_requests`.
`tokens_per_sec` is host wall time over the measured phase, which ends
each step with the host reading the new tokens back.

    from incubator_mxnet_tpu_torch.serving.trace import run_trace
    out = run_trace(params, cfg, n_requests=12, slots=3, page_size=8,
                    device="cpu")
"""
from __future__ import annotations

import time

import numpy as np

from .engine import ServingEngine

__all__ = ["make_trace", "run_trace"]


def make_trace(rng, n_requests, cfg):
    """Requests of the seeded trace, sorted by arrival step (stable)."""
    max_prompt = max(4, min(cfg.max_len // 2, 3 * cfg.max_len // 4))
    trace = []
    for _ in range(n_requests):
        p_len = int(rng.randint(2, max_prompt))
        m_new = int(rng.randint(1, min(16, cfg.max_len - p_len)))
        arrival = int(rng.randint(0, 2 * n_requests))
        prompt = rng.randint(1, cfg.vocab, p_len).astype(np.int32)
        trace.append({"arrival_step": arrival, "prompt": prompt,
                      "max_new": m_new})
    trace.sort(key=lambda r: r["arrival_step"])
    return trace


def run_trace(params, cfg, *, n_requests=12, slots=3, page_size=8, seed=0,
              device=None):
    """Serve the seeded trace: a warm-up wave (one request per prefill
    bucket the trace uses), then the trace with staggered arrivals.
    Returns the counters as a dict, plus `"trace"` (the requests, each
    with its `"rid"`) and `"results"` ({rid: RequestResult})."""
    eng = ServingEngine(params, cfg, slots=slots, page_size=page_size,
                        device=device)
    rng = np.random.RandomState(seed)
    trace = make_trace(rng, n_requests, cfg)

    # warm-up: one request per distinct bucket the trace will hit (a
    # prompt of exactly the bucket length lands in that bucket)
    buckets = sorted({eng._bucket_for(r["prompt"].size) for r in trace})
    for b in buckets:
        eng.submit(rng.randint(1, cfg.vocab,
                               min(b, cfg.max_len - 2)).astype(np.int32), 2)
    eng.run()
    warm_results = len(eng.results())

    occupancy, utilization = [], []
    # head-of-line bound: the most prefill tokens any single step computed
    prefill_prev = eng.goodput()["prefill"]
    max_step_prefill = 0
    t0 = time.perf_counter()
    pending = list(trace)
    while pending or eng.queue_depth or eng.slots_in_use:
        while pending and pending[0]["arrival_step"] <= eng.steps:
            r = pending.pop(0)
            r["rid"] = eng.submit(r["prompt"], r["max_new"])
        eng.step()
        occupancy.append(eng.slots_in_use)
        utilization.append(
            eng.allocator.num_in_use / max(1, eng.allocator.capacity))
        prefill_cur = eng.goodput()["prefill"]
        max_step_prefill = max(max_step_prefill, prefill_cur - prefill_prev)
        prefill_prev = prefill_cur
    elapsed = time.perf_counter() - t0

    results = eng.results()
    done = [results[r["rid"]] for r in trace if "rid" in r]
    gen_tokens = sum(len(r.tokens) for r in done)
    return {
        "requests_completed": len(done),
        "tokens_per_sec": gen_tokens / max(elapsed, 1e-9),
        "measured_seconds": elapsed,
        "generated_tokens": gen_tokens,
        "mean_slot_occupancy": round(float(np.mean(occupancy)), 3),
        "mean_page_utilization": round(float(np.mean(utilization)), 3),
        "engine_steps": eng.steps,
        "decode_steps": eng.decode_steps,
        "warmup_requests": warm_results,
        "slots": eng.slots,
        "page_size": eng.page_size,
        "seed": seed,
        "goodput": round(eng.goodput()["fraction"], 4),
        "max_step_prefill_tokens": max_step_prefill,
        "trace": trace,
        "results": results,
    }
