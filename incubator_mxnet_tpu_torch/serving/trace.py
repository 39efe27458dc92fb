"""The seeded mixed-length serving trace and its counter loop.

The port of the serving benchmark loop of the JAX package's
`tools/bench_transformer.py` (`serving_bench`), levers included. The
`np.random.RandomState(seed)` draws come in the same order (per request:
prompt length, new tokens, arrival step, prompt tokens; then one warm-up
prompt per prefill bucket the trace uses), and the shared-prefix rewrite
draws from a second stream, `RandomState(seed + 1)`, between the two, so
the same arguments give the same requests, the same schedule and
therefore the same deterministic counters as the JAX engine:
`engine_steps`, `requests_completed`, `max_step_prefill_tokens`,
`goodput`, `mean_slot_occupancy`, `mean_page_utilization`,
`warmup_requests`, and per lever `prefix_hit_rate`,
`prefill_tokens_saved(_frac)`, `cow_copies`, `prefix_cached_pages`,
`prefix_evictions`, `prefill_chunks`, `spec_proposed_tokens`,
`spec_accepted_tokens`, `spec_acceptance` (measured-phase deltas where
the JAX bench takes them). `tokens_per_sec` is host wall time over the
measured phase, which ends each step with the host reading the new
tokens back.

    from incubator_mxnet_tpu_torch.serving.trace import run_trace
    out = run_trace(params, cfg, n_requests=12, slots=3, page_size=8,
                    device="cpu")                       # levers off
    out = run_trace(params, cfg, n_requests=12, slots=3, page_size=8,
                    prefix_cache=1, shared_prefix_frac=0.5, prefix_len=32,
                    device="cpu")                       # prefix-cache leg
"""
from __future__ import annotations

import time

import numpy as np

from ..models import transformer as _tfm
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


def _share_prefix(trace, cfg, seed, frac, prefix_len):
    """Shared-system-prompt mode: rewrite a seeded fraction `frac` of the
    requests to one common prefix of `prefix_len` tokens plus a private
    tail, in place. Draws from `RandomState(seed + 1)`, so the trace's
    own stream is untouched."""
    rng2 = np.random.RandomState(seed + 1)
    pl = max(1, min(prefix_len, 3 * cfg.max_len // 4 - 2))
    shared = rng2.randint(1, cfg.vocab, pl).astype(np.int32)
    n_share = int(round(frac * len(trace)))
    picked = rng2.choice(len(trace), size=n_share, replace=False)
    for i in sorted(int(j) for j in picked):
        r = trace[i]
        new_len = max(int(r["prompt"].size), pl + 2)
        tail = rng2.randint(1, cfg.vocab, new_len - pl).astype(np.int32)
        r["prompt"] = np.concatenate([shared, tail])
        r["max_new"] = max(1, min(r["max_new"], cfg.max_len - new_len))
        r["shared"] = True


def _lever_counters(eng):
    return {"lookups": eng._prefix_lookups, "hits": eng._prefix_hits,
            "saved": eng._prefix_tokens_saved, "cow": eng._cow_copies,
            "proposed": eng._spec_proposed, "accepted": eng._spec_accepted,
            "prefilled": eng.goodput()["prefill"]}


def run_trace(params, cfg, *, n_requests=12, slots=3, page_size=8, seed=0,
              prefix_cache=0, prefill_chunk=0, spec_ngram=0,
              spec_lookahead=4, shared_prefix_frac=0.0, prefix_len=32,
              verify_tokens=False, device=None):
    """Serve the seeded trace: a warm-up wave (one request per prefill
    bucket the trace uses), then the trace with staggered arrivals.
    The lever arguments go to the engine as they are (0 = off, whatever
    the knobs say). `shared_prefix_frac` > 0 rewrites that fraction of
    the requests to share a `prefix_len`-token prefix. With
    `verify_tokens`, every request is recomputed with `generate()` after
    the measured phase and `token_identity` is 1.0 when all agree.
    Returns the counters as a dict, plus `"trace"` (the requests, each
    with its `"rid"`) and `"results"` ({rid: RequestResult})."""
    eng = ServingEngine(params, cfg, slots=slots, page_size=page_size,
                        prefix_cache=prefix_cache,
                        prefill_chunk=prefill_chunk, spec_ngram=spec_ngram,
                        spec_lookahead=spec_lookahead, device=device)
    rng = np.random.RandomState(seed)
    trace = make_trace(rng, n_requests, cfg)
    if shared_prefix_frac > 0:
        _share_prefix(trace, cfg, seed, shared_prefix_frac, prefix_len)

    # warm-up: one request per distinct bucket the trace will hit (a
    # prompt of exactly the bucket length lands in that bucket)
    buckets = sorted({eng._bucket_for(r["prompt"].size) for r in trace})
    for b in buckets:
        eng.submit(rng.randint(1, cfg.vocab,
                               min(b, cfg.max_len - 2)).astype(np.int32), 2)
    eng.run()
    warm_results = len(eng.results())
    # lever counters are cumulative on the engine: the reported figures
    # are measured-phase deltas (the warm-up wave fills the prefix cache
    # but its hits and savings do not count)
    lever0 = _lever_counters(eng)

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
    out = {
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
        "wide_calls": eng.wide_calls,
        "trace": trace,
        "results": results,
    }
    delta = {k: v - lever0[k] for k, v in _lever_counters(eng).items()}
    if eng.prefix_cache is not None:
        saved = delta["saved"]
        out["prefix_hit_rate"] = round(delta["hits"]
                                       / max(1, delta["lookups"]), 4)
        out["prefill_tokens_saved"] = saved
        out["prefill_tokens_saved_frac"] = round(
            saved / max(1, saved + delta["prefilled"]), 4)
        out["cow_copies"] = delta["cow"]
        out["prefix_cached_pages"] = eng.prefix_cache.cached_pages
        out["prefix_evictions"] = eng.prefix_cache.evictions
    if eng.spec_ngram:
        out["spec_proposed_tokens"] = delta["proposed"]
        out["spec_accepted_tokens"] = delta["accepted"]
        out["spec_acceptance"] = round(delta["accepted"]
                                       / max(1, delta["proposed"]), 4)
    if eng.prefill_chunk:
        out["prefill_chunks"] = eng._prefill_chunks  # cumulative, as in JAX
    if verify_tokens:
        out["token_identity"] = float(all(
            results[r["rid"]].tokens == _tfm.generate(
                params, r["prompt"][None], len(results[r["rid"]].tokens),
                cfg, device=eng.device)[0].tolist()
            for r in trace if results[r["rid"]].tokens))
    return out
