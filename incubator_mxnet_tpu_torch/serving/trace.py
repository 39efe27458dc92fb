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
the JAX bench takes them), and the structural counters the perf gate
zero-tolerates: `steady_compiles` and `steady_retraces` (capture-registry
deltas over the measured phase: new CUDA-graph signatures on the card,
first eager calls of a signature on the CPU) and `dense_fallbacks` (the
registered fallback counter; the port has no fallback, so it stays 0).
`tokens_per_sec`, `p50_latency_s`, `p99_latency_s`, `ttft_p99_short_s`
and `ttft_p99_long_s` are host wall time over the measured phase, which
ends each step with the host reading the new tokens back.

    from incubator_mxnet_tpu_torch.serving.trace import run_trace
    out = run_trace(params, cfg, n_requests=12, slots=3, page_size=8,
                    device="cpu")                       # levers off
    out = run_trace(params, cfg, n_requests=12, slots=3, page_size=8,
                    prefix_cache=1, shared_prefix_frac=0.5, prefix_len=32,
                    device="cpu")                       # prefix-cache leg

As a program it prints the JSON line of the JAX package's
`tools/bench_transformer.py --serving`, under the same `"metric"` tags
(`serving`, `serving_prefix`, `serving_chunked`, `serving_spec`), so
`tools/perf_gate.py` reads it unchanged; it runs on the card unless given
`--device cpu`:

    python -m incubator_mxnet_tpu_torch.serving.trace --d-model 32 \
        --n-layers 2 --n-heads 2 --d-ff 64 --vocab 64 --seq 64 \
        --slots 3 --page-size 8 --serving-tag spec --spec-ngram 2 \
        --verify-tokens --device cpu | \
        python tools/perf_gate.py - --subset serving_spec.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import telemetry
from ..models import transformer as _tfm
from ..telemetry import compilereg
from .engine import ServingEngine

__all__ = ["make_trace", "run_trace", "main"]

# the JAX package's fallback counter (`ops/pallas_kernels.py`); the port's
# kernels mask ragged ends themselves, so nothing increments it
DENSE_FALLBACKS_TOTAL = "mxtpu_decode_dense_fallbacks_total"


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


def _pct(values, q):
    """The JAX bench's percentile: the value at rank round(q * (n - 1))."""
    if not values:
        return 0.0
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


def _registry_totals():
    snap = compilereg.snapshot()
    return (sum(v["signatures"] for v in snap.values()),
            sum(v["retraces"] for v in snap.values()))


def _lever_counters(eng):
    return {"lookups": eng._prefix_lookups, "hits": eng._prefix_hits,
            "saved": eng._prefix_tokens_saved, "cow": eng._cow_copies,
            "proposed": eng._spec_proposed, "accepted": eng._spec_accepted,
            "prefilled": eng.goodput()["prefill"]}


def run_trace(params, cfg, *, n_requests=12, slots=3, page_size=8, seed=0,
              prefix_cache=0, prefill_chunk=0, spec_ngram=0,
              spec_lookahead=4, shared_prefix_frac=0.0, prefix_len=32,
              verify_tokens=False, device=None, engine=None):
    """Serve the seeded trace: a warm-up wave (one request per prefill
    bucket the trace uses), then the trace with staggered arrivals.
    The lever arguments go to the engine as they are (0 = off, whatever
    the knobs say). `shared_prefix_frac` > 0 rewrites that fraction of
    the requests to share a `prefix_len`-token prefix. With
    `verify_tokens`, every request is recomputed with `generate()` after
    the measured phase and `token_identity` is 1.0 when all agree.
    `engine` serves the trace on an engine the caller built (and perhaps
    warmed); its own slots, page size and levers then hold, and the
    arguments for them are not read. Telemetry is on for the call (the
    capture registry counts only then), as the JAX bench turns it on.
    Returns the counters as a dict, plus `"trace"` (the requests, each
    with its `"rid"`) and `"results"` ({rid: RequestResult})."""
    was_on = telemetry.enabled()
    telemetry.enable()
    try:
        return _run_trace(params, cfg, n_requests, seed, shared_prefix_frac,
                          prefix_len, verify_tokens, engine or ServingEngine(
                              params, cfg, slots=slots, page_size=page_size,
                              prefix_cache=prefix_cache,
                              prefill_chunk=prefill_chunk,
                              spec_ngram=spec_ngram,
                              spec_lookahead=spec_lookahead, device=device))
    finally:
        if not was_on:
            telemetry.disable()


def _run_trace(params, cfg, n_requests, seed, shared_prefix_frac, prefix_len,
               verify_tokens, eng):
    rng = np.random.RandomState(seed)
    trace = make_trace(rng, n_requests, cfg)
    if shared_prefix_frac > 0:
        _share_prefix(trace, cfg, seed, shared_prefix_frac, prefix_len)

    # warm-up: one request per distinct bucket the trace will hit (a
    # prompt of exactly the bucket length lands in that bucket)
    buckets = sorted({eng._bucket_for(r["prompt"].size) for r in trace})
    # the engine's cumulative counters at the start (a fresh engine's are
    # 0): on an engine that served before, the steps, calls, chunks and
    # requests reported are this call's (goodput stays cumulative)
    start = {"steps": eng.steps, "decode": eng.decode_steps,
             "wide": eng.wide_calls, "chunks": eng._prefill_chunks,
             "results": len(eng.results())}
    sigs0, _ = _registry_totals()
    for b in buckets:
        eng.submit(rng.randint(1, cfg.vocab,
                               min(b, cfg.max_len - 2)).astype(np.int32), 2)
    eng.run()
    warm_results = len(eng.results()) - start["results"]
    sigs1, re1 = _registry_totals()
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
        while (pending and pending[0]["arrival_step"]
               <= eng.steps - start["steps"]):
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
    sigs2, re2 = _registry_totals()

    results = eng.results()
    done = [results[r["rid"]] for r in trace if "rid" in r]
    gen_tokens = sum(len(r.tokens) for r in done)
    latencies = [r.latency_s for r in done]
    # short-vs-long p99 TTFT, split at the trace's median prompt length
    median_len = float(np.median([r["prompt"].size for r in trace]))
    fallbacks = sum(ch.value for _, ch in telemetry.REGISTRY.counter(
        DENSE_FALLBACKS_TOTAL).series())
    out = {
        "requests_completed": len(done),
        "tokens_per_sec": gen_tokens / max(elapsed, 1e-9),
        "p50_latency_s": _pct(latencies, 0.50),
        "p99_latency_s": _pct(latencies, 0.99),
        "ttft_p50_s": _pct([r.ttft_s for r in done], 0.50),
        "ttft_p99_s": _pct([r.ttft_s for r in done], 0.99),
        "ttft_p99_short_s": _pct([r.ttft_s for r in done
                                  if r.prompt_len <= median_len], 0.99),
        "ttft_p99_long_s": _pct([r.ttft_s for r in done
                                 if r.prompt_len > median_len], 0.99),
        "steady_compiles": sigs2 - sigs1,
        "steady_retraces": re2 - re1,
        "dense_fallbacks": fallbacks,
        "warmup_compiles": sigs1 - sigs0,
        "measured_seconds": elapsed,
        "generated_tokens": gen_tokens,
        "mean_slot_occupancy": round(float(np.mean(occupancy)), 3),
        "mean_page_utilization": round(float(np.mean(utilization)), 3),
        "engine_steps": eng.steps - start["steps"],
        "decode_steps": eng.decode_steps - start["decode"],
        "warmup_requests": warm_results,
        "slots": eng.slots,
        "page_size": eng.page_size,
        "seed": seed,
        "goodput": round(eng.goodput()["fraction"], 4),
        "max_step_prefill_tokens": max_step_prefill,
        "wide_calls": eng.wide_calls - start["wide"],
        "platform": "gpu" if eng.device.type == "cuda" else "cpu",
        "trace": trace,
        "results": results,
    }
    goodput = eng.goodput()
    out["tokens_split"] = {k: goodput[k] for k in
                           ("prefill", "decode", "pad", "wasted_evicted")}
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
        # warm-up wave included, as in JAX
        out["prefill_chunks"] = eng._prefill_chunks - start["chunks"]
    if verify_tokens:
        out["token_identity"] = float(all(
            results[r["rid"]].tokens == _tfm.generate(
                params, r["prompt"][None], len(results[r["rid"]].tokens),
                cfg, device=eng.device)[0].tolist()
            for r in trace if results[r["rid"]].tokens))
    if eng.slo is not None:
        slo_snap = eng.slo.snapshot()
        out["slo"] = {name: row["state"] for name, row in slo_snap.items()}
        out["slo_breaches"] = {name: row["breaches"]
                               for name, row in slo_snap.items()}
    telemetry.distributed.flush()  # traced runs: close out the frames
    return out


def main(argv=None):
    """The JAX bench's `--serving` mode on the port: print the trace's
    JSON line (see the module docstring)."""
    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--n-layers", type=int, default=6)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--seq", type=int, default=512, help="max_len")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--serving-requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shared-prefix-frac", type=float, default=0.0)
    ap.add_argument("--prefix-len", type=int, default=32)
    ap.add_argument("--prefix-cache", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--spec-ngram", type=int, default=0)
    ap.add_argument("--spec-lookahead", type=int, default=4)
    ap.add_argument("--serving-tag", default="",
                    help="suffix of the metric name (serving_TAG)")
    ap.add_argument("--verify-tokens", action="store_true")
    ap.add_argument("--metrics-out",
                    help="write the telemetry registry as JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)

    cfg = _tfm.TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=args.seq,
        dtype=args.dtype)
    params = _tfm.init_params(cfg, seed=0, device=args.device)
    out = run_trace(params, cfg, n_requests=args.serving_requests,
                    slots=args.slots, page_size=args.page_size,
                    seed=args.seed, prefix_cache=args.prefix_cache,
                    prefill_chunk=args.prefill_chunk,
                    spec_ngram=args.spec_ngram,
                    spec_lookahead=args.spec_lookahead,
                    shared_prefix_frac=args.shared_prefix_frac,
                    prefix_len=args.prefix_len,
                    verify_tokens=args.verify_tokens, device=args.device)
    line = {"metric": (f"serving_{args.serving_tag}" if args.serving_tag
                       else "serving")}
    line.update((k, v) for k, v in out.items()
                if k not in ("trace", "results"))
    if out["platform"] == "gpu":
        line["device_name"] = torch.cuda.get_device_name(params[
            "embed"].device)
    if args.metrics_out:
        telemetry.dump_json(args.metrics_out)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
