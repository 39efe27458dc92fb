"""Serving tier of the PyTorch port on the CPU: page allocator, prefix
cache, the continuous-batching engine against the JAX `generate()`, and
the seeded trace against the JAX engine's pinned CI counters."""
import json
import os

import numpy as np

import jax.numpy as jnp
import pytest
import torch

from incubator_mxnet_tpu.models import transformer as jtfm
from incubator_mxnet_tpu_torch import telemetry
from incubator_mxnet_tpu_torch.models import transformer as ttfm
from incubator_mxnet_tpu_torch.serving import (PageAllocator, PrefixCache,
                                               ServingEngine, run_trace)

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


def _engine(model, **kw):
    cfg, params = model
    return ServingEngine(params, cfg, device="cpu", **kw)


def _port_generate(model, prompt, n):
    cfg, params = model
    return ttfm.generate(params, prompt[None], n, cfg, device="cpu")[0]


# -- page allocator ----------------------------------------------------------

def test_allocator_alloc_free_reuse():
    a = PageAllocator(num_pages=6, page_size=4)
    assert a.capacity == 5 and a.num_free == 5
    p1 = a.alloc(3)
    assert len(p1) == 3 and 0 not in p1 and a.num_in_use == 3
    a.free(p1)
    assert a.num_free == 5 and a.num_in_use == 0
    # freed pages come back (FIFO order, never the null page)
    assert sorted(a.alloc(5)) == [1, 2, 3, 4, 5]


def test_allocator_exhaustion_is_all_or_nothing():
    a = PageAllocator(num_pages=4, page_size=2)
    assert a.alloc(2) is not None
    assert a.alloc(2) is None  # only 1 free: nothing gets allocated
    assert a.num_free == 1


@pytest.mark.parametrize("bad", ["double_free", "null_page", "share_dead",
                                 "cow_unallocated"])
def test_allocator_misuse_raises(bad):
    a = PageAllocator(num_pages=4, page_size=2)
    p = a.alloc(1)
    a.free(p)
    with pytest.raises(ValueError):
        {"double_free": lambda: a.free(p),
         "null_page": lambda: a.free([0]),
         "share_dead": lambda: a.share(p),
         "cow_unallocated": lambda: a.cow(99)}[bad]()


def test_allocator_extend():
    a = PageAllocator(num_pages=8, page_size=4)
    p = a.alloc(a.pages_needed(5))  # 2 pages cover 5 tokens
    grown = a.extend(p, 5, 13)  # 13 tokens need 4 pages
    assert len(grown) == 4 and grown[:2] == p
    assert a.extend(grown, 13, 16) == grown  # same page count: no-op
    assert a.extend(grown, 16, 1000) is None  # can't grow: unchanged
    assert a.num_in_use == 4


@pytest.mark.parametrize("n_tokens,pages", [(0, 0), (1, 1), (8, 1), (9, 2)])
def test_allocator_pages_needed(n_tokens, pages):
    assert PageAllocator(num_pages=4, page_size=8).pages_needed(n_tokens) \
        == pages


def test_allocator_share_free_keeps_page_live():
    a = PageAllocator(6, 4)
    pages = a.alloc(2)
    a.share(pages)
    assert all(a.refcount(p) == 2 for p in pages)
    a.free(pages)  # one of two refs: pages stay live
    assert a.num_in_use == 2 and a.num_free == 3
    a.free(pages)  # last deref recycles
    assert a.num_in_use == 0 and a.num_free == 5
    assert all(a.refcount(p) == 0 for p in pages)


def test_allocator_cow_semantics():
    a = PageAllocator(4, 4)
    (p,) = a.alloc(1)
    assert a.cow(p) == p  # refcount 1: no copy needed
    a.share([p])
    fresh = a.cow(p)
    assert fresh not in (None, p)
    assert a.refcount(p) == 1 and a.refcount(fresh) == 1
    a.share([p])
    (last,) = a.alloc(1)
    assert a.cow(p) is None  # pool exhausted: nothing changes
    assert a.refcount(p) == 2
    a.free([last])
    assert a.cow(p) != p  # retry succeeds once a page frees


def test_allocator_gauges_count_shared_pages_once():
    a = PageAllocator(8, 4)
    pages = a.alloc(3)
    a.share(pages)
    a.share(pages[:1])
    assert a.num_in_use == 3  # 3 physical pages, 7 references
    assert a.occupancy() == 3 / 7
    assert a.refcount_histogram() == {2: 2, 3: 1}


def test_prefix_cache_insert_lookup_roundtrip():
    a = PageAllocator(12, 4)
    cache = PrefixCache(a)
    prompt = np.arange(1, 11, dtype=np.int32)  # 10 tokens: 2 full + tail 2
    pages = a.alloc(3)
    assert cache.insert(prompt, pages) == {0, 1, 2}
    assert cache.cached_pages == 3
    assert all(a.refcount(p) == 2 for p in pages)  # owner + cache
    full, partial = cache.lookup(prompt)
    assert full == pages[:2]
    assert partial is not None and partial[0] == pages[2]
    np.testing.assert_array_equal(partial[1], prompt[8:])
    other = np.concatenate([prompt[:4], np.full(6, 63, np.int32)])
    full, partial = cache.lookup(other)
    assert full == pages[:1] and partial is None
    assert cache.insert(prompt, pages) == set()  # nothing new shared


def test_prefix_cache_evicts_lru_only_at_refcount_one():
    a = PageAllocator(12, 4)
    cache = PrefixCache(a)
    p1, p2 = a.alloc(2), a.alloc(2)
    cache.insert(np.arange(1, 9, dtype=np.int32), p1)
    cache.insert(np.arange(20, 28, dtype=np.int32), p2)
    a.free(p2)  # second prompt's owner finished; cache ref only
    assert cache.evict(10) == 2  # only p2's pages may go
    assert all(a.refcount(p) == 2 for p in p1)
    a.free(p1)
    assert cache.evict(10) == 2  # interior nodes go once leaves do
    assert cache.cached_pages == 0 and a.num_in_use == 0


def test_prefix_cache_release_is_leaf_only():
    a = PageAllocator(12, 4)
    cache = PrefixCache(a)
    pages = a.alloc(3)
    cache.insert(np.arange(1, 11, dtype=np.int32), pages)
    assert not cache.release(pages[0])  # mid-trie: children key off it
    assert cache.release(pages[2])      # partial leaf: droppable
    assert cache.cached_pages == 2 and a.refcount(pages[2]) == 1
    assert not cache.release(99)        # unknown page


# -- engine ------------------------------------------------------------------

def test_engine_token_identical_to_jax_generate(model):
    """Mixed-length requests sharing decode steps produce, per request,
    exactly the tokens of sequential greedy JAX generate()."""
    cfg, params = model
    jcfg = jtfm.TransformerConfig(**SMALL)
    jparams = jtfm.init_params(jcfg, seed=3)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 64, size=(L,)).astype(np.int32)
               for L in (4, 11, 7, 3, 19, 5)]
    maxnew = [6, 3, 8, 5, 4, 7]
    eng = _engine(model, slots=3, page_size=8, num_pages=24)
    rids = [eng.submit(p, m) for p, m in zip(prompts, maxnew)]
    res = eng.run()
    assert len(res) == len(prompts)
    assert eng.steps < sum(maxnew)  # depths really interleaved
    for rid, p, m in zip(rids, prompts, maxnew):
        ref = np.asarray(jtfm.generate(jparams, jnp.asarray(p)[None], m,
                                       jcfg))[0]
        np.testing.assert_array_equal(np.array(res[rid].tokens), ref)
        assert res[rid].finish_reason == "length"
    assert eng.allocator.num_in_use == 0 and eng.slots_in_use == 0


def test_engine_eos_stops_early_and_recycles(model):
    p = np.random.RandomState(5).randint(1, 64, size=(6,)).astype(np.int32)
    ref = _port_generate(model, p, 8).tolist()
    eos = ref[2]
    stop = ref.index(eos)  # first occurrence ends the request
    eng = _engine(model, slots=2, page_size=8, num_pages=16)
    rid = eng.submit(p, 8, eos_id=eos)
    out = eng.run()[rid]
    assert out.tokens == ref[:stop + 1]
    assert out.finish_reason == "eos"
    assert eng.allocator.num_in_use == 0


def test_engine_backpressure_queues_until_pages_free(model):
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 64, size=(L,)).astype(np.int32)
               for L in (12, 9, 14, 6)]
    eng = _engine(model, slots=4, page_size=8, num_pages=5)  # ~1 at a time
    rids = [eng.submit(p, 4) for p in prompts]
    eng.step()
    assert eng.slots_in_use >= 1 and eng.queue_depth >= 1  # backpressured
    res = eng.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(np.array(res[rid].tokens),
                                      _port_generate(model, p, 4).numpy())
    assert eng.allocator.num_in_use == 0


@pytest.mark.parametrize("prompt,max_new", [([], 4), ([1, 2], 0),
                                            ([1] * 60, 10)],
                         ids=["empty", "no_tokens", "past_max_len"])
def test_engine_rejects_unservable_requests(model, prompt, max_new):
    with pytest.raises(ValueError):
        _engine(model, slots=2, page_size=8, num_pages=16).submit(
            np.asarray(prompt, np.int32), max_new)


def test_engine_cancel_queued_and_live(model):
    eng = _engine(model, slots=1, page_size=8, num_pages=16)
    live = eng.submit([1, 2, 3], 8)
    queued = eng.submit([4, 5], 3)
    eng.step()  # `live` holds the only slot, `queued` waits
    assert eng.queued_request_ids() == [queued]
    assert list(eng.live_tokens()) == [live]
    assert eng.cancel(queued) and eng.cancel(live)
    assert not eng.cancel(live) and not eng.cancel(99)
    res = eng.results()
    assert res[queued].finish_reason == "cancelled"
    assert res[queued].tokens == []
    assert res[live].finish_reason == "evicted"
    # the evicted request's prompt and tokens count as wasted
    gp = eng.goodput()
    assert gp["wasted_evicted"] == 3 + len(res[live].tokens)
    assert eng.allocator.num_in_use == 0 and eng.slots_in_use == 0
    snap = eng.debug_snapshot()
    assert snap["requests_finished"] == 2 and snap["queue_depth"] == 0


def test_engine_publishes_metrics_when_enabled(model):
    telemetry.enable()
    try:
        telemetry.REGISTRY.reset()
        eng = _engine(model, slots=2, page_size=8, num_pages=16)
        eng.submit([1, 2, 3], 3)
        eng.run()
        names = {m.name for m in telemetry.REGISTRY.collect()}
        for name in ("mxtpu_serving_requests_total",
                     "mxtpu_serving_tokens_total",
                     "mxtpu_serving_request_seconds",
                     "mxtpu_serving_slots_in_use",
                     "mxtpu_serving_pages_in_use",
                     "mxtpu_serving_goodput"):
            assert name in names, name
    finally:
        telemetry.refresh_from_env()
        telemetry.REGISTRY.reset()


@pytest.mark.parametrize("lever", ["prefix_cache", "prefill_chunk",
                                   "spec_ngram"])
@pytest.mark.parametrize("via", ["argument", "knob"])
def test_engine_rejects_unported_levers(model, monkeypatch, lever, via):
    """Each lever turns on by argument or by knob (the name is kept from
    when the port refused them), and an explicit 0 argument wins over the
    knob, as in the JAX engine."""
    knob = {"prefix_cache": "MXTPU_PREFIX_CACHE",
            "prefill_chunk": "MXTPU_PREFILL_CHUNK",
            "spec_ngram": "MXTPU_SPEC_NGRAM"}[lever]

    def lever_on(eng):
        return {"prefix_cache": eng.prefix_cache is not None,
                "prefill_chunk": eng.prefill_chunk == 2,
                "spec_ngram": eng.spec_ngram == 2}[lever]

    kw = {}
    if via == "argument":
        kw[lever] = 2
    else:
        monkeypatch.setenv(knob, "2")
    eng = _engine(model, slots=2, page_size=8, **kw)
    assert lever_on(eng)
    # the lever serves: one request, tokens equal generate()
    p = np.arange(1, 12, dtype=np.int32)
    rid = eng.submit(p, 3)
    assert eng.run()[rid].tokens == _port_generate(model, p, 3).tolist()
    assert eng.wide_calls > 0
    if via == "knob":
        assert not lever_on(_engine(model, slots=2, page_size=8,
                                    **{lever: 0}))


def test_trace_reproduces_ci_serving_counters():
    """The seeded trace at the CI configuration reproduces every
    zero-tolerance serving.* counter the JAX engine is pinned to."""
    with open(BASELINE) as f:
        pinned = {k[len("serving."):]: v
                  for k, v in json.load(f)["metrics"].items()
                  if k.startswith("serving.")}
    cfg = ttfm.TransformerConfig(**SMALL)
    params = ttfm.init_params(cfg, seed=0, device="cpu")
    out = run_trace(params, cfg, n_requests=12, slots=3, page_size=8,
                    seed=0, device="cpu")
    exact = {k: v["value"] for k, v in pinned.items()
             if v.get("tolerance_pct") == 0 and not v.get("report_only")
             and k in out}
    assert {"engine_steps", "requests_completed", "max_step_prefill_tokens",
            "goodput", "mean_slot_occupancy", "mean_page_utilization",
            "warmup_requests"} <= set(exact)
    assert {k: float(out[k]) for k in exact} == exact
    # every request of the trace finished with its full token budget
    for r in out["trace"]:
        res = out["results"][r["rid"]]
        assert len(res.tokens) == r["max_new"]
