"""Runtime sanitizers of the PyTorch port against the JAX package's on the
same scenarios: the lock sanitizer's findings (order inversions, blocking
calls and long holds under a lock), the page sanitizer's (double free,
use-after-free, copy-on-write violation, leak, divergence), the
zero-cost-when-off contract, a full-lever engine run that drains quiescent
with zero findings and logs the JAX engine's `page_lifecycle` events, the
capture lock of `graphs` under concurrent engines, and exact kernel
launch counts across threads."""
import contextlib
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.analysis import sanitizers as jsan
from incubator_mxnet_tpu.models import transformer as jtfm
from incubator_mxnet_tpu.serving import PageAllocator as JPageAllocator
from incubator_mxnet_tpu.serving import ServingEngine as JServingEngine
from incubator_mxnet_tpu.telemetry import recorder as jrec
from incubator_mxnet_tpu_torch import graphs, telemetry
from incubator_mxnet_tpu_torch.analysis import sanitizers as tsan
from incubator_mxnet_tpu_torch.models import transformer as ttfm
from incubator_mxnet_tpu_torch.ops.kernels import launches
from incubator_mxnet_tpu_torch.serving import PageAllocator, ServingEngine
from incubator_mxnet_tpu_torch.telemetry import recorder as trec

# tools/sanitize.py's serving scenario: every lever on
SANITIZE_CFG = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                    max_len=64)
SANITIZE_ENGINE = dict(slots=3, page_size=8, num_pages=25, prefix_cache=1,
                       prefill_chunk=6, spec_ngram=2, spec_lookahead=3)
JOIN_TIMEOUT = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny engine ops: one intra-op thread beside the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    """Findings are global and deduped by (code, detail): isolate tests,
    and leave both packages' sanitizers off."""
    for san in (jsan, tsan):
        san.reset()
    yield
    os.environ.pop("MXTPU_SANITIZERS", None)
    for san in (jsan, tsan):
        san._hold_ms = None
        san.refresh_from_env()


@contextlib.contextmanager
def armed(san, value="locks,pages", hold_ms=None):
    """Arm one package's sanitizers (never both at once: each patches
    `time.sleep` and `queue.Queue` for the whole process) and disarm them
    on the way out; yields the findings list, filled at exit."""
    found = []
    os.environ["MXTPU_SANITIZERS"] = value
    san.refresh_from_env()
    if hold_ms is not None:
        san._hold_ms = hold_ms
    try:
        yield found
        found.extend((d.code, d.detail) for d in san.report())
    finally:
        os.environ.pop("MXTPU_SANITIZERS", None)
        san._hold_ms = None
        san.refresh_from_env()


# -- lock sanitizer -------------------------------------------------------------
# Each scenario runs on one package's sanitizer module; findings carry the
# acquisition and blocking sites (file:line in this file), so both
# packages' details must agree exactly.

def _abba(san):
    a, b = san.san_lock("t.A"), san.san_lock("t.B")

    def order(first, second):
        with first:
            with second:
                pass

    for pair in ((a, b), (b, a)):
        t = threading.Thread(target=order, args=pair, daemon=True)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()


def _sleep_under_lock(san):
    lk = san.san_lock("t.holder")
    for _ in range(2):  # one site reports once, not once per iteration
        with lk:
            time.sleep(0.001)


def _condition_wait(san):
    cv = san.san_condition("t.cv")
    with cv:
        cv.wait(timeout=0.005)  # waiting on only itself is fine
    with san.san_lock("t.outer"):
        with cv:
            cv.wait(timeout=0.005)


def _long_hold(san):
    san._hold_ms = 5.0
    lk = san.san_lock("t.slow")
    lk.acquire()
    san._real_sleep(0.02)  # the unpatched sleep: no MXS002 noise
    lk.release()


def _clean_orders(san):
    a, b, r = san.san_lock("t.A"), san.san_lock("t.B"), san.san_rlock("t.R")
    for _ in range(3):
        with a:
            with b:
                pass
    with r:
        with r:  # re-entry: same lock class, no edge
            pass


LOCK_CASES = {"MXS001": (_abba, ["MXS001"]),
              "MXS002": (_sleep_under_lock, ["MXS002"]),
              "MXS002_condition": (_condition_wait, ["MXS002"]),
              "MXS003": (_long_hold, ["MXS003"]),
              "clean": (_clean_orders, [])}


@pytest.mark.parametrize("case", sorted(LOCK_CASES))
def test_lock_findings_equal_jax(case):
    scenario, codes = LOCK_CASES[case]
    with armed(tsan, "locks") as got:
        assert type(tsan.san_lock("x")).__name__ == "_SanLock"
        scenario(tsan)
    with armed(jsan, "locks") as want:
        scenario(jsan)
    assert sorted(got) == sorted(want)
    assert sorted(c for c, _ in got) == codes
    if case == "MXS001":
        (detail,) = [d for _, d in got]
        assert "t.A" in detail and "t.B" in detail


def test_abba_report_carries_both_stacks():
    with armed(tsan, "locks"):
        _abba(tsan)
        (f,) = tsan.findings("MXS001")
    assert "this acquisition" in f.message and "reverse edge" in f.message
    assert f.severity == tsan.MXS_CATALOG["MXS001"][0]


# -- page sanitizer -------------------------------------------------------------

def _double_free(alloc, san):
    pages = alloc.alloc(1, owner=1)
    alloc.free(pages, owner=1)
    with pytest.raises(ValueError):
        alloc.free(pages, owner=1)


def _share_after_free(alloc, san):
    pages = alloc.alloc(1, owner=1)
    alloc.free(pages, owner=1)
    with pytest.raises(ValueError):
        alloc.share(pages, owner=2)


def _write_shared(alloc, san):
    pages = alloc.alloc(1, owner=1)
    alloc.share(pages, owner=2)
    san.note_write(1, pages)  # owner 1 writes without copy-on-write
    fresh = alloc.cow(pages[0], owner=1)
    san.note_write(1, [fresh])  # after a proper cow: clean


def _leak(alloc, san):
    pages = alloc.alloc(1, owner=1)
    alloc.share(pages)  # anonymous reference: nobody owns it at drain
    with pytest.raises(AssertionError):  # SanitizerError
        san.assert_quiescent()


def _divergence(alloc, san):
    alloc.alloc(2, owner=1)
    alloc._refs[5] = 1  # allocator state changed behind the shadow map
    san.check()


def _balanced(alloc, san):
    pages = alloc.alloc(2, owner=1)
    alloc.share(pages, owner=2)
    moved = alloc.cow(pages[0], owner=2)
    alloc.free([moved, pages[1]], owner=2)
    alloc.free(pages, owner=1)
    assert san.assert_quiescent() and alloc.num_in_use == 0


PAGE_CASES = {"MXS010": (_double_free, ["MXS010"]),
              "MXS011": (_share_after_free, ["MXS011"]),
              "MXS012": (_write_shared, ["MXS012"]),
              "MXS013": (_leak, ["MXS013"]),
              "MXS014": (_divergence, ["MXS014"]),
              "balanced": (_balanced, [])}


@pytest.mark.parametrize("case", sorted(PAGE_CASES))
def test_page_findings_equal_jax(case):
    scenario, codes = PAGE_CASES[case]
    found = {}
    for name, san, alloc_cls in (("port", tsan, PageAllocator),
                                 ("jax", jsan, JPageAllocator)):
        alloc = alloc_cls(8, 4)
        scenario(alloc, san.attach_page_sanitizer(alloc, force=True))
        found[name] = sorted((d.code, d.detail, d.message)
                             for d in san.report())
        san.reset()
    assert found["port"] == found["jax"]
    assert [c for c, _, _ in found["port"]] == codes


def test_disabled_mode_returns_plain_primitives():
    os.environ.pop("MXTPU_SANITIZERS", None)
    tsan.refresh_from_env()
    assert tsan.enabled_set() == frozenset()
    assert type(tsan.san_lock("x")) is type(threading.Lock())
    assert type(tsan.san_rlock("x")) is type(threading.RLock())
    assert isinstance(tsan.san_condition("x"), threading.Condition)
    mutex = threading.Lock()
    assert tsan.san_lock("x", mutex) is mutex  # the mutex itself, unwrapped
    assert tsan._real_sleep is None  # stdlib sleep untouched
    assert tsan.attach_page_sanitizer(PageAllocator(4, 4)) is None
    with pytest.raises(ValueError, match="bogus"):
        os.environ["MXTPU_SANITIZERS"] = "locks,bogus"
        tsan.refresh_from_env()


def test_findings_feed_metrics_and_recorder():
    telemetry.enable()
    telemetry.REGISTRY.reset()
    try:
        alloc = PageAllocator(8, 4)
        _double_free(alloc, tsan.attach_page_sanitizer(alloc, force=True))
        c = telemetry.REGISTRY.counter(tsan.FINDINGS_TOTAL)
        assert c.value(sanitizer="pages", code="MXS010") == 1
        kinds = [e for e in trec.snapshot()
                 if e["kind"] == "sanitizer_finding"]
        assert kinds and kinds[-1]["code"] == "MXS010"
    finally:
        telemetry.refresh_from_env()
        telemetry.REGISTRY.reset()


# -- engine integration ---------------------------------------------------------

def _sanitize_workload():
    rng = np.random.RandomState(17)
    shared = rng.randint(1, 64, size=(9,)).astype(np.int32)
    return [(np.concatenate([shared, rng.randint(1, 64, size=(2 + i,))
                             .astype(np.int32)]), 5 + (i % 3))
            for i in range(6)]


def _lifecycle(recorder):
    return [(e["op"], list(e["pages"]), e["owner"], e["free"])
            for e in recorder.snapshot() if e["kind"] == "page_lifecycle"]


@pytest.fixture(scope="module")
def jax_sanitized_run():
    """The JAX engine through tools/sanitize.py's serving scenario with
    the page sanitizer armed, once per module: results, steps, findings
    and the page_lifecycle events of the run."""
    cfg = jtfm.TransformerConfig(**SANITIZE_CFG)
    params = jtfm.init_params(cfg, seed=3)
    jrec.refresh_from_env()
    with armed(jsan, "pages") as found:
        eng = JServingEngine(params, cfg, **SANITIZE_ENGINE)
        assert eng._page_san is not None
        for prompt, n in _sanitize_workload():
            eng.submit(prompt, n)
        res = eng.run()  # drain proves quiescence
    return {"np_params": {k: np.asarray(v) for k, v in params.items()},
            "tokens": {rid: list(r.tokens) for rid, r in res.items()},
            "steps": eng.steps, "findings": found,
            "events": _lifecycle(jrec),
            "cached": eng.prefix_cache.cached_pages,
            "in_use": eng.allocator.num_in_use}


def test_engine_full_levers_quiescent_equal_jax(jax_sanitized_run):
    """The port's engine with every lever on, under locks and pages:
    run() drains through assert_quiescent(), nothing fires, and the
    page_lifecycle stream, results and step count equal the JAX
    engine's."""
    ref = jax_sanitized_run
    assert ref["findings"] == [] and ref["events"]
    cfg = ttfm.TransformerConfig(**SANITIZE_CFG)
    params = ttfm.params_from_numpy(ref["np_params"], device="cpu")
    trec.refresh_from_env()
    # the engine lock is held through step(): a loaded CPU's slow first
    # calls are benign long holds; a stuck lock still trips 5 s
    with armed(tsan, "locks,pages", hold_ms=5000.0) as found:
        eng = ServingEngine(params, cfg, device="cpu", **SANITIZE_ENGINE)
        assert eng._page_san is not None
        assert type(eng._lock).__name__ == "_SanRLock"
        for prompt, n in _sanitize_workload():
            eng.submit(prompt, n)
        res = eng.run()
    assert found == []
    assert {rid: list(r.tokens) for rid, r in res.items()} == ref["tokens"]
    assert eng.steps == ref["steps"]
    assert _lifecycle(trec) == ref["events"]
    # cached prefix pages are owned by the cache, everything else freed
    assert eng.allocator.num_in_use == eng.prefix_cache.cached_pages \
        == ref["cached"] == ref["in_use"]


def test_engine_note_write_catches_a_shared_write():
    """The decode step's hook sees its write: a slot's page shared behind
    the engine's back is reported as a copy-on-write violation."""
    cfg = ttfm.TransformerConfig(**SANITIZE_CFG)
    params = ttfm.init_params(cfg, seed=3, device="cpu")
    with armed(tsan, "pages") as found:
        eng = ServingEngine(params, cfg, device="cpu", slots=2, page_size=8,
                            num_pages=12)
        eng.submit(np.arange(1, 6, dtype=np.int32), 4)
        eng.step()  # admit + prefill + first decode
        page = eng._slot_pages[0][0]
        eng.allocator.share([page], owner="intruder")
        eng.step()
        eng.allocator.free([page], owner="intruder")
    assert [c for c, _ in found] == ["MXS012"]


def test_engine_without_sanitizers_has_no_shadow():
    cfg = ttfm.TransformerConfig(**SANITIZE_CFG)
    params = ttfm.init_params(cfg, seed=3, device="cpu")
    eng = ServingEngine(params, cfg, device="cpu", slots=2, page_size=8,
                        num_pages=12)
    assert eng._page_san is None and eng.allocator.sanitizer is None
    assert type(eng._lock) is type(threading.RLock())


# -- the capture lock (graphs) --------------------------------------------------

def test_capture_lock_serializes_first_calls_not_replays():
    """A signature's first call (a capture on the card, a registration
    here) takes the process-wide capture lock; calls of known signatures
    (replays) do not. With the lock held, as by a capture on another
    thread: a warmed engine keeps serving from a second thread, and a
    second engine's warm() waits until the lock is released. warm()
    holds no engine lock across its captures; a step that captures
    lazily takes the capture lock under the engine lock. Under the lock
    sanitizer the run records that order, and no finding."""
    cfg = ttfm.TransformerConfig(**SANITIZE_CFG)
    params = ttfm.init_params(cfg, seed=3, device="cpu")
    prompt = np.arange(1, 12, dtype=np.int32)
    want = ttfm.generate(params, torch.as_tensor(prompt)[None], 6, cfg,
                         device="cpu")[0].tolist()
    with armed(tsan, "locks", hold_ms=5000.0) as found:
        serving = ServingEngine(params, cfg, device="cpu", slots=2,
                                page_size=8)
        assert set(serving.warm().values()) == {"eager"}
        late = ServingEngine(params, cfg, device="cpu", slots=2,
                             page_size=8)
        rid = serving.submit(prompt, 6)
        out = {}
        steps = threading.Thread(
            target=lambda: out.update(serving.run()), daemon=True)
        warm = threading.Thread(
            target=lambda: out.update(warm=late.warm()), daemon=True)
        with graphs._capture_lock():
            steps.start()
            steps.join(timeout=60)
            assert not steps.is_alive()  # replays never waited
            warm.start()
            warm.join(timeout=0.5)
            assert warm.is_alive()  # first calls wait for the lock
        warm.join(timeout=60)
        assert not warm.is_alive()
        assert not tsan._edge_info  # no warm() held an engine lock
        lazy = ServingEngine(params, cfg, device="cpu", slots=2,
                             page_size=8)
        lazy_rid = lazy.submit(prompt, 6)
        lazy_tokens = lazy.run()[lazy_rid].tokens
        edges = set(tsan._edge_info)
    assert found == []
    assert out[rid].tokens == want == lazy_tokens
    assert set(out["warm"].values()) == {"eager"}
    assert ("serving.engine", "graphs.capture") in edges
    assert ("graphs.capture", "serving.engine") not in edges


def test_launch_counts_are_exact_across_threads():
    """Replicas credit graph replays from one thread each: no count may
    be lost, and a thread that captures (or observes a warm-up) tallies
    its own counts only, whatever the other threads count meanwhile."""
    class Wrapper:
        launches = 0

    kernel = Wrapper()
    n_threads, n_calls = 8, 2000
    tallies = {}

    def credit(i):
        if i == 0:
            with launches.capturing() as tally:
                for _ in range(n_calls):
                    launches.count(kernel, 3)
            tallies["capture"] = dict(tally)
        elif i == 1:
            with launches.observing() as tally:
                for _ in range(n_calls):
                    launches.count(kernel)
            tallies["observe"] = dict(tally)
        else:
            for _ in range(n_calls):
                launches.count(kernel)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=credit, args=(i,), daemon=True)
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_TIMEOUT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert tallies == {"capture": {kernel: 3 * n_calls},
                       "observe": {kernel: n_calls}}
    # the capture launched nothing; the observed warm-up did
    assert kernel.launches == (n_threads - 1) * n_calls
