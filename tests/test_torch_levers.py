"""The serving levers of the PyTorch port on the CPU: prefix-cached
copy-on-write pages, chunked prefill and n-gram speculation.

The port's engine is held to its own `generate()` (which
`tests/test_torch_transformer.py` holds to the JAX `generate()`), and its
seeded lever legs to the counters `ci/perf_baseline.json` pins for the
JAX engine, so the port is pinned to the JAX engine without running it.
"""
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.models import transformer as ttfm
from incubator_mxnet_tpu_torch.serving import ServingEngine, run_trace

SMALL = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=64)
BASELINE = os.path.join(os.path.dirname(__file__), "..", "ci",
                        "perf_baseline.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine runs many tiny ops: on a loaded machine (the suite's
    other workers), torch's intra-op thread pool makes them many times
    slower than one thread does, and takes cores from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = ttfm.TransformerConfig(**SMALL)
    return cfg, ttfm.init_params(cfg, seed=3, device="cpu")


def _generate(model, prompt, n):
    cfg, params = model
    return ttfm.generate(params, prompt[None], n, cfg,
                         device="cpu")[0].tolist()


def _mixed_trace(rng, n=6, vocab=64, max_len=64):
    """Seeded mixed trace where later prompts reuse earlier heads: the
    workload prefix caching exists for (as in tests/test_serving.py)."""
    reqs = []
    for i in range(n):
        p_len = int(rng.randint(2, 40))
        prompt = rng.randint(1, vocab, p_len).astype(np.int32)
        if i >= 2 and rng.rand() < 0.7:
            base = reqs[int(rng.randint(0, len(reqs)))][0]
            keep = min(len(base), int(rng.randint(8, 36)))
            tail = rng.randint(1, vocab, max(1, p_len - keep))
            prompt = np.concatenate([base[:keep], tail.astype(np.int32)])
        m_new = int(rng.randint(1, min(12, max_len - prompt.size)))
        reqs.append((prompt, m_new))
    return reqs


@pytest.fixture(scope="module")
def mixed(model):
    reqs = _mixed_trace(np.random.RandomState(11))
    return reqs, [_generate(model, p, m) for p, m in reqs]


@pytest.mark.parametrize("prefix,chunk,spec",
                         list(itertools.product([0, 1], repeat=3)))
def test_engine_token_identity_all_lever_combos(model, mixed, prefix, chunk,
                                                spec):
    """Greedy tokens equal generate() with every on/off combination of
    prefix cache x chunked prefill (chunk 6) x speculation (n-gram 2,
    lookahead 3)."""
    cfg, params = model
    reqs, ref = mixed
    eng = ServingEngine(params, cfg, slots=3, page_size=8, num_pages=25,
                        prefix_cache=prefix, prefill_chunk=6 if chunk else 0,
                        spec_ngram=2 if spec else 0, spec_lookahead=3,
                        device="cpu")
    rids = [eng.submit(p, m) for p, m in reqs]
    res = eng.run()
    for rid, want in zip(rids, ref):
        assert res[rid].tokens == want
    assert eng.slots_in_use == 0
    # only the prefix cache's references outlive the drained engine
    held = (eng.prefix_cache.cached_pages
            if eng.prefix_cache is not None else 0)
    assert eng.allocator.num_in_use == held
    # each lever that is on went through the wide step
    assert (eng.wide_calls > 0) == bool(prefix or chunk or spec)
    snap = eng.debug_snapshot()
    assert (snap["prefix_cache"] is None) == (not prefix)
    assert (snap["chunked_prefill"] is None) == (not chunk)
    assert (snap["speculation"] is None) == (not spec)


def test_engine_prefix_cache_saves_prefill_and_cows_once(model):
    """Resubmitting a prompt maps its cached pages: the second prefill
    computes only the (always recomputed) last token, and each shared
    partial page is copied exactly once per writer."""
    cfg, params = model
    p = np.random.RandomState(2).randint(1, 64, 20).astype(np.int32)
    ref = _generate(model, p, 4)  # 2 full pages of 8 + a tail of 4
    eng = ServingEngine(params, cfg, slots=2, page_size=8, num_pages=16,
                        prefix_cache=1, device="cpu")
    r1 = eng.submit(p, 4)
    res1 = eng.run()
    # first pass: a miss, all 20 tokens prefilled, and the slot's own
    # cached partial page copied on write at its first decode token
    assert eng.prefix_hit_rate == 0.0
    assert eng.goodput()["prefill"] == 20
    assert eng.cow_copies == 1
    r2 = eng.submit(p, 4)
    res2 = eng.run()
    assert res1[r1].tokens == ref and res2[r2].tokens == ref
    # second pass: 19 of 20 tokens came from the cache, plus one
    # admission copy of the cached partial page
    assert eng.prefix_tokens_saved == 19
    assert eng.prefix_hit_rate == 0.5
    assert eng.goodput()["prefill"] == 21
    assert eng.cow_copies == 2
    # identical tail: insert dedups, so no second decode-time copy
    assert eng.allocator.num_in_use == eng.prefix_cache.cached_pages == 3


LEGS = {
    "prefix": dict(prefix_cache=1, shared_prefix_frac=0.5, prefix_len=32),
    "chunked": dict(prefill_chunk=8),
    "spec": dict(spec_ngram=2, spec_lookahead=4),
}
# the counters each leg must report (the JAX bench's lever families)
LEG_COUNTERS = {
    "prefix": {"prefix_hit_rate", "prefill_tokens_saved",
               "prefill_tokens_saved_frac", "cow_copies",
               "prefix_cached_pages", "prefix_evictions"},
    "chunked": {"prefill_chunks"},
    "spec": {"spec_proposed_tokens", "spec_accepted_tokens",
             "spec_acceptance"},
}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_trace_lever_leg_reproduces_ci_counters(leg):
    """The seeded trace at the CI configuration with one lever on
    reproduces every zero-tolerance, non-report-only counter of the
    `serving_<leg>.` family, token_identity 1.0 included, and
    `steady_compiles`, `steady_retraces` and `dense_fallbacks` (from the
    capture registry) at 0: none is missing."""
    with open(BASELINE) as f:
        family = f"serving_{leg}."
        pinned = {k[len(family):]: v
                  for k, v in json.load(f)["metrics"].items()
                  if k.startswith(family)}
    cfg = ttfm.TransformerConfig(**SMALL)
    params = ttfm.init_params(cfg, seed=0, device="cpu")
    out = run_trace(params, cfg, n_requests=12, slots=3, page_size=8,
                    seed=0, verify_tokens=True, device="cpu", **LEGS[leg])
    exact = {k: v["value"] for k, v in pinned.items()
             if v.get("tolerance_pct") == 0 and not v.get("report_only")}
    unreported = {k for k in exact if k not in out}
    assert unreported == set()
    assert LEG_COUNTERS[leg] | {"token_identity", "engine_steps",
                                "max_step_prefill_tokens", "steady_compiles",
                                "steady_retraces", "dense_fallbacks"} <= set(
        exact)
    assert {k: float(out[k]) for k in exact} == exact
    for r in out["trace"]:
        assert len(out["results"][r["rid"]].tokens) == r["max_new"]
    assert out["wide_calls"] > 0


# the CI's bench legs (ci/run_tests.sh): trace CLI arguments per tag
CLI_LEGS = {
    "": [],
    "prefix": ["--prefix-cache", "1", "--shared-prefix-frac", "0.5",
               "--prefix-len", "32", "--verify-tokens"],
    "chunked": ["--prefill-chunk", "8", "--verify-tokens"],
    "spec": ["--spec-ngram", "2", "--spec-lookahead", "4",
             "--verify-tokens"],
}


@pytest.mark.parametrize("tag", sorted(CLI_LEGS))
def test_trace_cli_line_passes_perf_gate(tag, capsys):
    """`python -m incubator_mxnet_tpu_torch.serving.trace` at the CI's
    configuration prints the JSON line that tools/perf_gate.py gates
    against the committed baseline, unchanged: it passes the leg's
    `--subset`, and fails the CI's seeded lost-request regression."""
    from incubator_mxnet_tpu_torch.serving import trace

    assert trace.main(
        ["--d-model", "32", "--n-layers", "2", "--n-heads", "2", "--d-ff",
         "64", "--vocab", "64", "--seq", "64", "--serving-requests", "12",
         "--slots", "3", "--page-size", "8", "--device", "cpu"]
        + (["--serving-tag", tag] if tag else []) + CLI_LEGS[tag]) == 0
    line = capsys.readouterr().out
    family = f"serving_{tag}." if tag else "serving."
    assert json.loads(line)["metric"] == family[:-1]
    gate = [sys.executable, os.path.join(os.path.dirname(BASELINE),
                                         "..", "tools", "perf_gate.py"),
            "-", "--baseline", BASELINE, "--subset", family]
    ok = subprocess.run(gate, input=line, capture_output=True, text=True,
                        timeout=60)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "missing" not in ok.stdout
    bad = subprocess.run(gate + ["--inject",
                                 f"{family}requests_completed=0.5"],
                         input=line, capture_output=True, text=True,
                         timeout=60)
    assert bad.returncode == 1, bad.stdout + bad.stderr
