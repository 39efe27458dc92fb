"""Continuous-batching greedy decode engine over the paged KV cache.

The PyTorch counterpart of the JAX package's base `ServingEngine`
(iteration-level scheduling over PagedAttention-style storage):

- a FIFO request queue feeding a fixed set of `MXTPU_DECODE_SLOTS`
  decode slots, the batch dimension of every decode step;
- admission = all-or-nothing page allocation (serving/pages.py) for the
  request's worst case, then a bucketed prefill (prompt padded up to one
  of a few lengths) writing prompt K/V straight into the pages;
- one `decode_step_paged` per engine step advances every live slot one
  token, each at its own depth, through the `paged_decode_attention`
  kernel in every layer;
- eviction on EOS or max-tokens recycles pages at once.

Greedy decoding, token-for-token identical to sequential
`models.transformer.generate()` per request.

Every device call is a named site (`graphs.wrap`), as every device call
of the JAX engine is a named compiled program: `serving_decode_step`,
`serving_prefill_b{T_b}` per prefill bucket, `serving_wide_q{n_q}` per
wide-step width and `serving_page_copy`. On CUDA each site is captured
into a CUDA graph once per shape signature, from one memory pool all the
engine's sites share, and replayed from then on; `warm()` captures every
site the enabled levers will call, so the steady state captures nothing
(the capture registry, `telemetry/compilereg.py`, counts it). The host
copies each call's inputs into the graph's static inputs, the argmax runs
inside the graph, and the one host sync of a call is reading its tokens
back.

Three optional levers stack on this, as in the JAX engine; with all of
them off the engine runs exactly the base path above. Each lever's query
rows go through the wide step (`decode_step_paged_wide`, the
`paged_decode_attention_wide` kernel in every layer), one callable per
width (`_wide`):

- `prefix_cache` (`MXTPU_PREFIX_CACHE`): prefix-cached copy-on-write
  pages. Admission maps the longest cached page-aligned prefix of the
  prompt read-only into the slot's table and prefills only the tail (in
  chunks of `_SYNC_TAIL_CHUNK`). A cached partial page is copied at
  admission before the tail writes into it; the slot's own freshly cached
  partial page is copied before its first decode write.
- `prefill_chunk` (`MXTPU_PREFILL_CHUNK`): chunked prefill. Prompts
  stream through the wide step a chunk per engine step, interleaved with
  the batched decode.
- `spec_ngram` / `spec_lookahead` (`MXTPU_SPEC_NGRAM`,
  `MXTPU_SPEC_LOOKAHEAD`): prompt-lookup speculation. The trailing n-gram
  of each slot's history proposes up to `lookahead` tokens; one wide call
  verifies every slot's proposal and accepted prefixes advance in bulk.
  Rejected rows need no rollback: their K/V lies past the slot's
  position, and the next write overwrites it.

An explicit constructor argument wins over its knob.

Observability, as in the JAX engine: the spans `serving.step`,
`serving.prefill` and `serving.prefill_chunk`; with tracing on
(`MXTPU_TRACE_DIR`), per-request lifecycle records (`serving.request` and
its `.queued`, `.prefill` and `.decode` stages, one trace per request,
born in `submit` or adopted from its `trace_ctx`) and one batched
`req_step` record per decode step; an SLO monitor fed by every finished
request (`slo`, or the `MXTPU_SLO_*` knobs); and `debug_snapshot`, served
at `/debug/engine` by the telemetry HTTP server under
`MXTPU_DEBUG_ENDPOINTS`.

Runtime sanitizers (`analysis/sanitizers.py`, `MXTPU_SANITIZERS`), as in
the JAX engine: the engine lock is a `san_rlock("serving.engine")`, so
the lock sanitizer sees its order against the fleet's locks and the
capture lock (`graphs`); with `pages` on, a page sanitizer shadows the
allocator, every device write into the pool is announced first
(`note_write`: chunked and prefix-tail prefill, speculative
verification, the decode step) and `run()` proves quiescence at drain.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque

import numpy as np
import torch

from .. import config, graphs, telemetry
from ..analysis import sanitizers as _sanitizers
from ..config import resolve_device
from ..models import transformer as _tfm
from ..telemetry import compilereg
from ..telemetry import distributed as _dtrace
from ..telemetry import exporters as _exporters
from ..telemetry import recorder as _recorder
from ..telemetry import slo as _slo
from .pages import PageAllocator, PrefixCache

__all__ = ["Request", "RequestResult", "ServingEngine"]

QUEUE_DEPTH = "mxtpu_serving_queue_depth"
SLOTS_IN_USE = "mxtpu_serving_slots_in_use"
PAGES_IN_USE = "mxtpu_serving_pages_in_use"
PAGE_UTILIZATION = "mxtpu_serving_page_utilization"
REQUESTS_TOTAL = "mxtpu_serving_requests_total"
TOKENS_TOTAL = "mxtpu_serving_tokens_total"
REQUEST_SECONDS = "mxtpu_serving_request_seconds"
QUEUE_WAIT_SECONDS = "mxtpu_serving_queue_wait_seconds"
TTFT_SECONDS = "mxtpu_serving_ttft_seconds"
OLDEST_QUEUED = "mxtpu_serving_oldest_queued_seconds"
ADMISSION_BLOCKED = "mxtpu_serving_admission_blocked_total"
WASTED_TOKENS = "mxtpu_serving_wasted_tokens_total"
GOODPUT = "mxtpu_serving_goodput"
PREFIX_LOOKUPS = "mxtpu_serving_prefix_lookups_total"
PREFIX_TOKENS_SAVED = "mxtpu_serving_prefix_tokens_saved_total"
PREFIX_CACHED_PAGES = "mxtpu_serving_prefix_cached_pages"
COW_COPIES = "mxtpu_serving_cow_copies_total"
PREFILL_CHUNKS = "mxtpu_serving_prefill_chunks_total"
SPEC_PROPOSED = "mxtpu_spec_proposed_tokens_total"
SPEC_ACCEPTED = "mxtpu_spec_accepted_tokens_total"

# tail-prefill chunk width when the prefix cache is on and chunked prefill
# is off: the tail still goes through the wide step (the bucketed prefill
# starts only at position 0), in chunks of one fixed width
_SYNC_TAIL_CHUNK = 32

_EMPTY_PROP = np.zeros((0,), np.int32)

# per-request lifecycle record names (registered in telemetry/names.py),
# emitted straight through distributed.record_span: zero cost when tracing
# is off, one lane per request in tools/trace_merge.py --requests
REQ_SPAN = "serving.request"
REQ_QUEUED_SPAN = "serving.request.queued"
REQ_PREFILL_SPAN = "serving.request.prefill"
REQ_DECODE_SPAN = "serving.request.decode"
REQ_STEP_KIND = "req_step"  # batched decode-progress record, one per step

# sub-ms to minutes: decode steps are ms-scale, queued requests can wait
_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


@dataclasses.dataclass
class Request:
    """One generation request: greedy-decode up to `max_new_tokens`
    continuation tokens, stopping early when `eos_id` is produced
    (the EOS token is included in the output)."""
    request_id: int
    prompt: np.ndarray  # (T_p,) int32
    max_new_tokens: int
    eos_id: int | None = None
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    ttft_s: float = 0.0  # set at prefill; 0 until admitted
    trace: dict | None = None  # per-request trace context (tracing on)


@dataclasses.dataclass
class RequestResult:
    request_id: int
    tokens: list  # generated continuation (includes EOS when hit)
    finish_reason: str  # "eos" | "length" | "evicted" | "cancelled"
    prompt_len: int
    queue_wait_s: float
    latency_s: float
    ttft_s: float = 0.0  # 0.0 for cancelled-in-queue requests


def _default_buckets(max_len):
    """Powers of two from 16 up to (and always including) max_len, or
    the MXTPU_PREFILL_BUCKETS list."""
    raw = str(config.get("MXTPU_PREFILL_BUCKETS") or "")
    if raw.strip():
        buckets = sorted({int(b) for b in raw.split(",") if b.strip()})
    else:
        buckets, b = [], 16
        while b < max_len:
            buckets.append(b)
            b *= 2
        buckets.append(max_len)
    return [b for b in buckets if b <= max_len] or [max_len]


class ServingEngine:
    """Continuous-batching greedy-decode engine for one transformer.

    >>> eng = ServingEngine(params, cfg, device="cpu")
    >>> rid = eng.submit([1, 2, 3], max_new_tokens=16, eos_id=0)
    >>> results = eng.run()          # drain queue + slots
    >>> results[rid].tokens

    `step()` runs ONE scheduler iteration (admissions, prefill chunks and
    one decode step) for callers that interleave serving with other work.
    `device=None` means CUDA (and raises without it); the params must
    already lie on the engine's device. The lever arguments default to
    their knobs (None); an explicit value, 0 included, wins. `slo` is an
    `SLOMonitor` (None: built from the `MXTPU_SLO_*` knobs, if any is
    set; False: none).
    """

    def __init__(self, params, cfg, *, slots=None, page_size=None,
                 num_pages=None, max_len=None, clock=time.monotonic,
                 slo=None, prefix_cache=None, prefill_chunk=None,
                 spec_ngram=None, spec_lookahead=None, device=None):
        self.device = resolve_device(device)
        _tfm._check_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.page_size = int(page_size or config.get("MXTPU_PAGE_SIZE"))
        self.slots = int(slots or config.get("MXTPU_DECODE_SLOTS"))
        self.max_len = int(max_len or cfg.max_len)
        if self.max_len > cfg.max_len:
            raise ValueError(f"max_len {self.max_len} exceeds the "
                             f"model's positional table ({cfg.max_len})")
        self.table_width = -(-self.max_len // self.page_size)
        if num_pages is None:
            num_pages = int(config.get("MXTPU_SERVING_PAGES"))
        if not num_pages:  # auto: every slot can hold a full sequence
            num_pages = self.slots * self.table_width + 1
        self.allocator = PageAllocator(num_pages, self.page_size)
        # shadow-state refcount checker (None unless MXTPU_SANITIZERS
        # lists "pages"); run() proves quiescence at drain through it.
        # Writes the sanitizer is told of (`_note_writes`): every wide
        # call's real rows (chunked prefill, the prefix cache's tail
        # prefill, speculative verification) and the decode step's one
        # row a slot, as the JAX engine tells it. Not told, as in JAX:
        # the bucketed prefill and a copy-on-write's page copy, which
        # write fresh pages the slot alone holds, and the masked rows of
        # idle slots and `warm()`'s all-zero calls, which write only the
        # null page, a page no allocator transition covers
        self._page_san = _sanitizers.attach_page_sanitizer(self.allocator)
        self.paged = _tfm.init_paged_kv_cache(cfg, num_pages, self.page_size,
                                              device=self.device)
        self.prefill_buckets = _default_buckets(self.max_len)
        self._clock = clock
        # explicit timeline lane for this engine's trace records (None: the
        # process lane)
        self.trace_lane = None
        # submit/cancel arrive from gateway and fleet threads while the
        # pump thread sits inside step(). Reentrant because step()
        # finishing a request may call back through the public surface;
        # a san_rlock so lockdep sees the ordering against the fleet and
        # journal locks and the capture lock
        self._lock = _sanitizers.san_rlock("serving.engine")

        if prefix_cache is None:
            prefix_cache = int(config.get("MXTPU_PREFIX_CACHE"))
        if prefill_chunk is None:
            prefill_chunk = int(config.get("MXTPU_PREFILL_CHUNK"))
        if spec_ngram is None:
            spec_ngram = int(config.get("MXTPU_SPEC_NGRAM"))
        if spec_lookahead is None:
            spec_lookahead = int(config.get("MXTPU_SPEC_LOOKAHEAD"))
        self.prefill_chunk = max(0, min(int(prefill_chunk), self.max_len))
        self.spec_ngram = max(0, int(spec_ngram))
        self.spec_lookahead = max(1, int(spec_lookahead))
        self.prefix_cache = (
            PrefixCache(self.allocator,
                        max_pages=prefix_cache if prefix_cache > 1 else 0)
            if prefix_cache else None)

        S, W = self.slots, self.table_width
        self._tables = np.zeros((S, W), np.int64)
        self._positions = np.zeros((S,), np.int64)
        self._next_tok = np.zeros((S,), np.int64)
        self._slot_req: list[Request | None] = [None] * S
        self._slot_pages: list[list] = [[] for _ in range(S)]
        self._slot_out: list[list] = [[] for _ in range(S)]
        # lever slot state: the pending prefill descriptor of a slot still
        # prefilling, and the table index whose page must copy-on-write
        # before the slot's next decode write (-1 = none)
        self._slot_prefill: list[dict | None] = [None] * S
        self._slot_cow_idx = [-1] * S
        self._queue: deque[Request] = deque()
        self._results: dict[int, RequestResult] = {}
        self._ids = itertools.count()
        self.steps = 0
        # calls of the single-query decode step (decode_step_paged), and
        # of the wide step at any width (decode_step_paged_wide)
        self.decode_steps = 0
        self.wide_calls = 0

        # host-side goodput accounting (independent of whether the
        # metrics registry is on): token positions the device processed
        # by kind, plus tokens spent on requests later evicted
        self._tokens = {"prefill": 0, "decode": 0, "pad": 0,
                        "spec_rejected": 0}
        self._wasted_evicted = 0
        # lever counters (host source of truth, mirrored to telemetry)
        self._prefix_lookups = 0
        self._prefix_hits = 0
        self._prefix_tokens_saved = 0
        self._cow_copies = 0
        self._prefill_chunks = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        # last-N finished-request timelines, carried by SLO breach dumps
        self._timelines: deque = deque(
            maxlen=max(1, int(config.get("MXTPU_SLO_DUMP_TIMELINES"))))
        if slo is None:
            slo = _slo.from_env(timelines=self.recent_timelines)
        self.slo = slo or None
        _exporters.register_debug_handler("/debug/engine",
                                          self.debug_snapshot)

        # the device calls: one named site each, sharing one graph pool.
        # Lever sites are built only for the levers that are on, and wide
        # sites on first use (`_wide`), so an engine with every lever off
        # has exactly the base sites
        self._pool = graphs.Pool()
        self._decode = self._site("serving_decode_step", self._decode_fn)
        self._prefills = {
            T_b: self._site(f"serving_prefill_b{T_b}", self._prefill_fn)
            for T_b in self.prefill_buckets}
        self._wides: dict = {}
        self._page_copy = (self._site("serving_page_copy", self._copy_fn)
                           if self.prefix_cache is not None else None)

    # -- device calls ------------------------------------------------------
    # Each takes device tensors (the site's static inputs on CUDA) and
    # returns the greedy tokens on the device; all-zero inputs write only
    # the null page (position 0, zero table rows, no real rows), which is
    # what a capture's warm-up runs and `warm()` rely on.

    def _site(self, name, fn):
        return graphs.wrap(name, fn, device=self.device, pool=self._pool)

    def _decode_fn(self, tokens, positions, tables):
        with torch.no_grad():
            logits, _ = _tfm.decode_step_paged(
                self.params, self.paged, tokens, positions, tables, self.cfg)
            return torch.argmax(logits, dim=-1)

    def _prefill_fn(self, prompt, true_len, row):
        with torch.no_grad():
            _, logits = _tfm.prefill_paged(self.params, self.paged, prompt,
                                           true_len, row, self.cfg)
            return torch.argmax(logits, dim=-1)

    def _wide_fn(self, tokens, start, n_real, tables):
        with torch.no_grad():
            logits, _ = _tfm.decode_step_paged_wide(
                self.params, self.paged, tokens, start, n_real, tables,
                self.cfg)
            return torch.argmax(logits, dim=-1)

    def _copy_fn(self, src, dst):
        """Copy page `src` onto page `dst` (0-d indices) in every layer's
        K and V pool, in place: a copy-on-write's device half."""
        with torch.no_grad():
            for pool in (self.paged["k"], self.paged["v"]):
                pool.index_copy_(1, dst.reshape(1),
                                 pool.index_select(1, src.reshape(1)))

    def _wide(self, n_q):
        """The wide-step site for `n_q` query rows per slot,
        `serving_wide_q{n_q}`: one per width (chunked prefill, prefix tail
        prefill and speculative verification each use one), built on first
        use."""
        site = self._wides.get(n_q)
        if site is None:
            site = self._wides[n_q] = self._site(f"serving_wide_q{n_q}",
                                                 self._wide_fn)
        return site

    def _run_wide(self, tokens, start, n_real, tables):
        """One wide step over host arrays (tokens (S, n_q), start (S,),
        n_real (S,), tables (S, W)); returns each row's greedy token,
        (S, n_q), on the host."""
        tok = self._wide(tokens.shape[1])(tokens, start, n_real, tables)
        self.wide_calls += 1
        return tok.cpu().numpy()

    def _copy_page(self, src, dst):
        self._page_copy(np.asarray(src, np.int64), np.asarray(dst, np.int64))

    # -- public API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens, eos_id=None, trace_ctx=None):
        """Queue one request; returns its request id. Validation is
        eager: an unservable request fails here, not mid-decode.

        `trace_ctx` is an optional inbound (trace_id, parent_span_id)
        pair: with tracing on, the request's records join that trace,
        its root parented under that span."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        total = prompt.size + int(max_new_tokens)
        if total > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len ({self.max_len})")
        need = self.allocator.pages_needed(total)
        if need > self.allocator.capacity:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.allocator.capacity}")
        with self._lock:
            rid = next(self._ids)
            req = Request(rid, prompt, int(max_new_tokens), eos_id,
                          submitted_at=self._clock())
            if _dtrace.trace_active():
                # the trace context is born here (or adopted from
                # trace_ctx): tid groups the whole lifecycle, sid is the
                # root "serving.request" span every stage parents under,
                # ns_submit anchors engine-clock deltas to wall time
                tid, psid = trace_ctx if trace_ctx else (None, None)
                req.trace = {"tid": tid or _dtrace.new_id(),
                             "sid": _dtrace.new_id(),
                             "ns_submit": time.time_ns(),
                             "clk_submit": req.submitted_at}
                if psid is not None:
                    req.trace["pid"] = psid
            self._queue.append(req)
            telemetry.set_gauge(QUEUE_DEPTH, len(self._queue))
            telemetry.set_gauge(
                OLDEST_QUEUED,
                self._clock() - self._queue[0].submitted_at)
            return rid

    def step(self):
        """One scheduler iteration: admit queued requests into free
        slots (FIFO, backpressured by page availability), advance pending
        chunked prefills one chunk, then advance every decoding slot in a
        single decode (or speculative) step. Returns the number of live
        slots after the iteration."""
        with self._lock:
            with telemetry.span("serving.step", step=self.steps):
                self._admit()
                if self.prefill_chunk:
                    self._prefill_chunks_once()
                if self.spec_ngram:
                    live = self._decode_spec_once()
                else:
                    live = self._decode_once()
            self.steps += 1
            self._export_gauges()
            return live

    def run(self, max_steps=100_000):
        """Drive step() until the queue and every slot drain; returns
        {request_id: RequestResult} for everything finished so far.
        `max_steps` bounds a scheduler bug (a request that can never
        finish): hitting it raises instead of spinning forever."""
        for _ in range(max_steps):
            with self._lock:
                if not self._queue and not any(self._slot_req):
                    if self._page_san is not None:
                        # every live reference must now be owned by the
                        # prefix cache; anything else leaked (MXS013)
                        self._page_san.assert_quiescent()
                    return dict(self._results)
            self.step()
        raise RuntimeError(f"serving engine did not drain within "
                           f"{max_steps} steps")

    def results(self):
        with self._lock:
            return dict(self._results)

    def live_tokens(self):
        """{request_id: continuation tokens streamed so far} for every
        request holding a slot (mid-prefill slots report []). Queued
        requests do not appear."""
        with self._lock:
            return {r.request_id: list(self._slot_out[s])
                    for s, r in enumerate(self._slot_req) if r is not None}

    def queued_request_ids(self):
        """Request ids still waiting in the admission queue (FIFO
        order)."""
        with self._lock:
            return [r.request_id for r in self._queue]

    @property
    def queue_depth(self):
        return len(self._queue)

    @property
    def slots_in_use(self):
        return sum(r is not None for r in self._slot_req)

    def warm(self):
        """Capture (on the CPU: run once and register) every site the
        enabled levers will call: the decode step, every prefill bucket,
        the wide widths (the prefill chunk, or `_SYNC_TAIL_CHUNK` for the
        prefix cache's tail, and lookahead + 1 for speculation) and the
        page copy, each on all-zero inputs, which write only the KV pool's
        null page. Returns {site: status} with `graphs.Site.warm`'s
        statuses.

        Takes the engine lock only to list the sites, not across the
        captures, as the JAX `warm()` takes none across its compiles; it
        is safe beside a concurrent `step()` all the same: a capture
        replays nothing, captures serialize on the process-wide capture
        lock (`graphs`), and the sites' replays run only in `step()`,
        under the engine lock."""
        S, W = self.slots, self.table_width
        with self._lock:
            calls = [(self._decode, ((S,), (S,), (S, W)))]
            calls += [(site, ((1, T_b), (1,), (1, W)))
                      for T_b, site in self._prefills.items()]
            wide_qs = set()
            if self.prefill_chunk:
                wide_qs.add(self.prefill_chunk)
            elif self.prefix_cache is not None:
                wide_qs.add(min(_SYNC_TAIL_CHUNK, self.max_len))
            if self.spec_ngram:
                wide_qs.add(self.spec_lookahead + 1)
            calls += [(self._wide(q), ((S, q), (S,), (S,), (S, W)))
                      for q in sorted(wide_qs)]
            if self._page_copy is not None:
                calls.append((self._page_copy, ((), ())))
        return {site.name: site.warm(*shapes) for site, shapes in calls}

    def sites(self):
        """{name: graphs.Site} of every site built so far."""
        sites = [self._decode, *self._prefills.values(),
                 *self._wides.values()]
        if self._page_copy is not None:
            sites.append(self._page_copy)
        return {site.name: site for site in sites}

    # -- scheduling internals ----------------------------------------------

    def _free_slot(self):
        for s, r in enumerate(self._slot_req):
            if r is None:
                return s
        return None

    def _bucket_for(self, n):
        for b in self.prefill_buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds the largest "
                         f"prefill bucket {self.prefill_buckets[-1]}")

    def _admit(self):
        """FIFO admission: stop at the first request that can't get a
        slot or its pages (head-of-line order keeps scheduling
        deterministic: no small request overtakes a starved big one)."""
        levered = self.prefix_cache is not None or self.prefill_chunk
        while self._queue:
            slot = self._free_slot()
            if slot is None:
                telemetry.inc(ADMISSION_BLOCKED, reason="slots")
                return
            req = self._queue[0]
            if levered:
                if not self._admit_levered(slot, req):
                    return  # backpressure: wait for an eviction
                continue
            total = req.prompt.size + req.max_new_tokens
            pages = self.allocator.alloc(self.allocator.pages_needed(total),
                                         owner=req.request_id)
            if pages is None:
                telemetry.inc(ADMISSION_BLOCKED, reason="pages")
                return  # backpressure: wait for an eviction
            self._queue.popleft()
            req.admitted_at = self._clock()
            telemetry.observe(QUEUE_WAIT_SECONDS,
                              req.admitted_at - req.submitted_at,
                              buckets=_LATENCY_BUCKETS)
            telemetry.set_gauge(QUEUE_DEPTH, len(self._queue))
            self._emit_queued(req)
            self._prefill_into(slot, req, pages)

    def _prefill_into(self, slot, req, pages):
        T_p = req.prompt.size
        T_b = self._bucket_for(T_p)
        row = np.asarray(
            self.allocator.table_row(pages, self.table_width), np.int64)
        prompt = np.zeros((1, T_b), np.int64)
        prompt[0, :T_p] = req.prompt
        clk_prefill = self._clock()
        with telemetry.span("serving.prefill", request=req.request_id,
                            bucket=T_b):
            tok = self._prefills[T_b](prompt, np.asarray([T_p], np.int64),
                                      row[None])
            first = int(tok.cpu()[0])
        clk_first = self._clock()
        pad = T_b - T_p
        self._tokens["prefill"] += T_p
        telemetry.inc(TOKENS_TOTAL, amount=float(T_p), kind="prefill")
        if pad:
            # padded rows run through the matmuls like real tokens: they
            # are processed-but-wasted, the prefill half of the goodput
            self._tokens["pad"] += pad
            telemetry.inc(TOKENS_TOTAL, amount=float(pad), kind="pad")
            telemetry.inc(WASTED_TOKENS, amount=float(pad),
                          reason="prefill_pad")
        req.ttft_s = clk_first - req.submitted_at
        telemetry.observe(TTFT_SECONDS, req.ttft_s,
                          buckets=_LATENCY_BUCKETS)
        if req.trace is not None:
            req.trace["clk_first"] = clk_first
            self._emit_request_record(
                REQ_PREFILL_SPAN, req.trace,
                ts=self._trace_ts(req.trace, clk_prefill),
                dur_s=clk_first - clk_prefill, pid=req.trace["sid"],
                extra={"request": req.request_id, "bucket": T_b,
                       "prompt_len": T_p, "pad": pad})
        self._slot_req[slot] = req
        self._slot_pages[slot] = pages
        self._slot_out[slot] = [first]
        self._tables[slot] = row
        self._positions[slot] = T_p
        self._next_tok[slot] = first
        if self._is_done(req, [first]):
            self._finish(slot)

    # -- lever path: prefix-cached COW pages + chunked prefill -------------

    def _admit_levered(self, slot, req):
        """Admission with the prefix cache or chunked prefill on: map the
        longest cached page-aligned prefix read-only into the slot's
        table (a host write instead of device prefill), allocate fresh
        pages for the rest, then stream only the uncached tail through
        the wide step: all of it here, or one chunk per step when chunked
        prefill is on. Returns False on page backpressure (the request
        stays queued)."""
        ps = self.page_size
        T_p = req.prompt.size
        w_req = self.allocator.pages_needed(T_p + req.max_new_tokens)
        used_full, part_page, n_part = [], None, 0
        if self.prefix_cache is not None:
            full_pages, partial = self.prefix_cache.lookup(req.prompt)
            # the last prompt token is always recomputed: its logits are
            # the first output token, which a table write cannot give
            limit = T_p - 1
            n_full = min(len(full_pages), limit // ps)
            used_full = full_pages[:n_full]
            if partial is not None and n_full == len(full_pages):
                page, chunk = partial
                n_part = max(0, min(int(chunk.size), limit - n_full * ps))
                part_page = page if n_part else None
        n_cached = len(used_full) * ps + n_part
        # references: mapped full pages are shared for the slot's whole
        # lifetime; the cached partial page is pinned only until its
        # bytes are copied into a fresh page below
        protect = used_full + ([part_page] if part_page is not None
                               else [])
        self.allocator.share(protect, owner=req.request_id)
        fresh = self.allocator.alloc(w_req - len(used_full),
                                     owner=req.request_id)
        if fresh is None and self.prefix_cache is not None:
            # pool pressure: LRU-evict cache pages no live request maps
            deficit = (w_req - len(used_full)) - self.allocator.num_free
            self.prefix_cache.evict(deficit)
            fresh = self.allocator.alloc(w_req - len(used_full),
                                         owner=req.request_id)
        if fresh is None:
            self.allocator.free(protect, owner=req.request_id)
            telemetry.inc(ADMISSION_BLOCKED, reason="pages")
            return False
        if self.prefix_cache is not None:
            self._prefix_lookups += 1
            hit = n_cached > 0
            self._prefix_hits += int(hit)
            self._prefix_tokens_saved += n_cached
            telemetry.inc(PREFIX_LOOKUPS, outcome="hit" if hit else "miss")
            if n_cached:
                telemetry.inc(PREFIX_TOKENS_SAVED, amount=float(n_cached))
        self._queue.popleft()
        req.admitted_at = self._clock()
        telemetry.observe(QUEUE_WAIT_SECONDS,
                          req.admitted_at - req.submitted_at,
                          buckets=_LATENCY_BUCKETS)
        telemetry.set_gauge(QUEUE_DEPTH, len(self._queue))
        self._emit_queued(req)
        pages = used_full + fresh
        row = np.asarray(
            self.allocator.table_row(pages, self.table_width), np.int64)
        if part_page is not None:
            # eager copy-on-write: the tail prefill writes into this
            # page's token range, so the slot gets a private copy of the
            # cached bytes first
            self._copy_page(part_page, fresh[0])
            self.allocator.free([part_page],  # drop the pin only
                                owner=req.request_id)
            self._cow_copies += 1
            telemetry.inc(COW_COPIES, site="admit")
        self._slot_req[slot] = req
        self._slot_pages[slot] = pages
        self._slot_out[slot] = []
        self._slot_prefill[slot] = {
            "prompt": req.prompt, "row": row, "pos": n_cached,
            "n_cached": n_cached, "chunks": 0, "clk_start": self._clock()}
        if not self.prefill_chunk:
            # synchronous tail prefill: every chunk before the next
            # admission (chunked mode leaves the descriptor for step() to
            # advance one chunk per iteration)
            while self._slot_prefill[slot] is not None:
                self._prefill_chunks_once(only_slot=slot)
        return True

    def _prefill_chunks_once(self, only_slot=None):
        """Advance pending prefills one chunk in ONE wide call covering
        every mid-prefill slot; decoding and idle slots ride along masked
        out (n_real 0, zero table rows: their writes land in the null
        page), so the call has one shape."""
        pend = [s for s in range(self.slots)
                if self._slot_prefill[s] is not None
                and (only_slot is None or s == only_slot)]
        if not pend:
            return
        C = self.prefill_chunk or min(_SYNC_TAIL_CHUNK, self.max_len)
        S, W = self.slots, self.table_width
        toks = np.zeros((S, C), np.int64)
        start = np.zeros((S,), np.int64)
        n_real = np.zeros((S,), np.int64)
        tables = np.zeros((S, W), np.int64)
        for s in pend:
            st = self._slot_prefill[s]
            pos, prompt = st["pos"], st["prompt"]
            n = min(C, prompt.size - pos)
            toks[s, :n] = prompt[pos:pos + n]
            start[s] = pos
            n_real[s] = n
            tables[s] = st["row"]
        self._note_writes(pend, start, n_real)
        with telemetry.span("serving.prefill_chunk", slots=len(pend)):
            out = self._run_wide(toks, start, n_real, tables)
        for s in pend:
            st = self._slot_prefill[s]
            n = int(n_real[s])
            st["pos"] += n
            st["chunks"] += 1
            self._prefill_chunks += 1
            self._tokens["prefill"] += n
            telemetry.inc(TOKENS_TOTAL, amount=float(n), kind="prefill")
            telemetry.inc(PREFILL_CHUNKS)
            pad = C - n
            if pad:
                self._tokens["pad"] += pad
                telemetry.inc(TOKENS_TOTAL, amount=float(pad), kind="pad")
                telemetry.inc(WASTED_TOKENS, amount=float(pad),
                              reason="prefill_pad")
            if st["pos"] >= st["prompt"].size:
                self._finish_prefill(s, int(out[s, n - 1]))

    def _finish_prefill(self, slot, first):
        """Last tail chunk done: record the time to first token, install
        the slot's decode state, register the prompt's pages in the prefix
        cache, and arm the lazy copy-on-write if the cache now shares the
        page the first decode token writes into."""
        st = self._slot_prefill[slot]
        self._slot_prefill[slot] = None
        req = self._slot_req[slot]
        prompt = st["prompt"]
        T_p = prompt.size
        clk_first = self._clock()
        req.ttft_s = clk_first - req.submitted_at
        telemetry.observe(TTFT_SECONDS, req.ttft_s,
                          buckets=_LATENCY_BUCKETS)
        if req.trace is not None:
            req.trace["clk_first"] = clk_first
            self._emit_request_record(
                REQ_PREFILL_SPAN, req.trace,
                ts=self._trace_ts(req.trace, st["clk_start"]),
                dur_s=clk_first - st["clk_start"], pid=req.trace["sid"],
                extra={"request": req.request_id, "prompt_len": int(T_p),
                       "cached": int(st["n_cached"]),
                       "chunks": int(st["chunks"])})
        self._slot_out[slot] = [first]
        self._tables[slot] = st["row"]
        self._positions[slot] = T_p
        self._next_tok[slot] = first
        if self.prefix_cache is not None:
            n_prompt_pages = self.allocator.pages_needed(T_p)
            self.prefix_cache.insert(
                prompt, self._slot_pages[slot][:n_prompt_pages])
            telemetry.set_gauge(PREFIX_CACHED_PAGES,
                                self.prefix_cache.cached_pages)
            # the page the first decode token (position T_p) writes into:
            # if insert() just shared the slot's own partial tail page, it
            # must copy-on-write before that write lands
            wi = T_p // self.page_size
            if (T_p % self.page_size
                    and wi < len(self._slot_pages[slot])
                    and self.allocator.refcount(
                        self._slot_pages[slot][wi]) > 1):
                self._slot_cow_idx[slot] = wi
        if self._is_done(req, [first]):
            self._finish(slot)

    def _resolve_cow(self, slot):
        """The slot's next decode write lands in a shared, partly filled
        page: give it a private page first. When the pool has no page for
        the copy: steal the cache's own reference back (the writer then
        holds the only one, and no copy is needed), else LRU-evict one
        cached page and retry."""
        idx = self._slot_cow_idx[slot]
        self._slot_cow_idx[slot] = -1
        page = self._slot_pages[slot][idx]
        rid = self._slot_req[slot].request_id
        new = self.allocator.cow(page, owner=rid)
        if new is None:
            if self.prefix_cache.release(page):
                return  # cache ref dropped; the slot now owns the page
            if self.prefix_cache.evict(1):
                new = self.allocator.cow(page, owner=rid)
        if new is None:
            raise RuntimeError(
                f"copy-on-write of page {page} failed: KV pool exhausted "
                f"and the prefix cache holds no evictable page")
        if new != page:
            self._copy_page(page, new)
            self._slot_pages[slot][idx] = new
            self._tables[slot, idx] = new
            self._cow_copies += 1
            telemetry.inc(COW_COPIES, site="decode")

    def _decoding_slots(self):
        """Live slots past their prefill, their pending copy-on-write
        resolved (the step about to run writes into their pages)."""
        live = [s for s, r in enumerate(self._slot_req)
                if r is not None and self._slot_prefill[s] is None]
        if self.prefix_cache is not None:
            for s in live:
                if self._slot_cow_idx[s] >= 0:
                    self._resolve_cow(s)
        return live

    # -- lever path: n-gram prompt-lookup speculation ----------------------

    def _propose(self, prompt, out, k):
        """Prompt-lookup proposal: match the trailing `spec_ngram` tokens
        of the slot's history (prompt + generated) against earlier
        history and propose up to `k` continuation tokens of the most
        recent earlier match."""
        n = self.spec_ngram
        hist = np.concatenate([prompt, np.asarray(out, np.int32)])
        if hist.size < n + 1:
            return _EMPTY_PROP
        gram = hist[-n:]
        for i in range(hist.size - n - 1, -1, -1):
            if np.array_equal(hist[i:i + n], gram):
                return hist[i + n:i + n + k].astype(np.int32)
        return _EMPTY_PROP

    def _decode_spec_once(self):
        """Speculative decode step: every decoding slot runs
        `lookahead + 1` query rows in one wide call, its next token plus
        its proposal. The longest proposal prefix that matches the model's
        own greedy outputs is accepted in bulk; rejected rows need no
        rollback (their K/V lies past the slot's advanced position, dead
        data the next step overwrites)."""
        live_slots = self._decoding_slots()
        if not live_slots:
            return self.slots_in_use
        S = self.slots
        Q = self.spec_lookahead + 1
        toks = np.zeros((S, Q), np.int64)
        start = np.zeros((S,), np.int64)
        n_real = np.zeros((S,), np.int64)
        props = {}
        for s in live_slots:
            req = self._slot_req[s]
            room = req.max_new_tokens - len(self._slot_out[s]) - 1
            k_s = min(self.spec_lookahead, room)
            prop = (self._propose(req.prompt, self._slot_out[s], k_s)
                    if k_s > 0 else _EMPTY_PROP)
            props[s] = prop
            toks[s, 0] = self._next_tok[s]
            toks[s, 1:1 + prop.size] = prop
            start[s] = self._positions[s]
            n_real[s] = 1 + prop.size
        # rows [start, start+n_real) of each slot land in its table
        self._note_writes(live_slots, start, n_real)
        tok = self._run_wide(toks, start, n_real, self._tables)
        for s in live_slots:
            req = self._slot_req[s]
            prop = props[s]
            # row i's argmax is the model's greedy token i + 1; the
            # proposal is accepted exactly as far as it matches them
            emitted = [int(tok[s, 0])]
            for i in range(prop.size):
                if int(prop[i]) != emitted[i]:
                    break
                emitted.append(int(tok[s, i + 1]))
            accepted = len(emitted) - 1
            self._spec_proposed += int(prop.size)
            self._spec_accepted += accepted
            if prop.size:
                telemetry.inc(SPEC_PROPOSED, amount=float(prop.size))
            if accepted:
                telemetry.inc(SPEC_ACCEPTED, amount=float(accepted))
            applied = 0
            for t in emitted:
                applied += 1
                self._slot_out[s].append(t)
                self._positions[s] += 1
                self._next_tok[s] = t
                if self._is_done(req, self._slot_out[s]):
                    self._finish(s)
                    break
            # the Q device rows split into delivered tokens, rejected or
            # unused speculation rows, and padding rows past the proposal
            rejected = (1 + int(prop.size)) - applied
            pad = Q - 1 - int(prop.size)
            self._tokens["decode"] += applied
            telemetry.inc(TOKENS_TOTAL, amount=float(applied),
                          kind="decode")
            if rejected:
                self._tokens["spec_rejected"] += rejected
                telemetry.inc(TOKENS_TOTAL, amount=float(rejected),
                              kind="spec_rejected")
                telemetry.inc(WASTED_TOKENS, amount=float(rejected),
                              reason="spec_rejected")
            if pad:
                self._tokens["pad"] += pad
                telemetry.inc(TOKENS_TOTAL, amount=float(pad), kind="pad")
                telemetry.inc(WASTED_TOKENS, amount=float(pad),
                              reason="spec_pad")
        self._emit_step_record(s for s in live_slots
                               if self._slot_req[s] is not None)
        return self.slots_in_use

    def _decode_once(self):
        live_slots = self._decoding_slots()
        if not live_slots:
            return self.slots_in_use
        # the step writes one K/V entry per live slot at _positions[s]
        self._note_writes(live_slots, self._positions,
                          np.ones_like(self._positions))
        tok = self._decode(self._next_tok, self._positions,
                           self._tables).cpu().numpy()
        self.decode_steps += 1
        n_live = len(live_slots)
        self._tokens["decode"] += n_live
        telemetry.inc(TOKENS_TOTAL, amount=float(n_live), kind="decode")
        self._emit_step_record(live_slots)
        for s in live_slots:
            req = self._slot_req[s]
            self._slot_out[s].append(int(tok[s]))
            self._positions[s] += 1
            self._next_tok[s] = tok[s]
            if self._is_done(req, self._slot_out[s]):
                self._finish(s)
        return self.slots_in_use

    def _note_writes(self, slots, start, n_real):
        """Tell the page sanitizer (if armed) which pages the coming
        device call writes: rows [start[s], start[s] + n_real[s]) of each
        slot in `slots`, through the slot's pages."""
        if self._page_san is None:
            return
        for s in slots:
            lo = int(start[s]) // self.page_size
            hi = (int(start[s]) + int(n_real[s]) - 1) // self.page_size
            self._page_san.note_write(self._slot_req[s].request_id,
                                      self._slot_pages[s][lo:hi + 1])

    def _is_done(self, req, out):
        if req.eos_id is not None and out and out[-1] == req.eos_id:
            return True
        return len(out) >= req.max_new_tokens

    def _finish(self, slot, reason=None):
        """Evict: record the result and recycle the pages at once.
        `reason` overrides the eos/length inference (mid-stream eviction
        passes "evicted"). Idempotent per occupancy: a slot that already
        finished returns without touching the allocator."""
        req = self._slot_req[slot]
        if req is None:
            return
        out = self._slot_out[slot]
        if reason is None:
            reason = ("eos" if req.eos_id is not None and out
                      and out[-1] == req.eos_id else "length")
        now = self._clock()
        queue_wait = req.admitted_at - req.submitted_at
        latency = now - req.submitted_at
        self._results[req.request_id] = RequestResult(
            request_id=req.request_id, tokens=list(out),
            finish_reason=reason, prompt_len=int(req.prompt.size),
            queue_wait_s=queue_wait, latency_s=latency,
            ttft_s=req.ttft_s)
        telemetry.inc(REQUESTS_TOTAL, outcome=reason)
        telemetry.observe(REQUEST_SECONDS, latency,
                          buckets=_LATENCY_BUCKETS)
        if reason == "evicted":
            # everything this request pushed through the device is now
            # undelivered output (its pad rows are already in the pad kind)
            wasted = int(req.prompt.size) + len(out)
            self._wasted_evicted += wasted
            telemetry.inc(WASTED_TOKENS, amount=float(wasted),
                          reason="evicted")
        self._record_timeline(req, len(out), reason, queue_wait, latency)
        _recorder.log_event("serving_request_finish",
                            request=req.request_id, outcome=reason,
                            tokens=len(out))
        if self.slo is not None:
            self.slo.observe_request(
                ttft=req.ttft_s, queue_wait=queue_wait,
                request_latency=latency,
                goodput=self.goodput()["fraction"])
        tr = req.trace
        if tr is not None:
            clk_first = tr.get("clk_first")
            if clk_first is not None and len(out) > 1:
                self._emit_request_record(
                    REQ_DECODE_SPAN, tr, ts=self._trace_ts(tr, clk_first),
                    dur_s=now - clk_first, pid=tr["sid"],
                    extra={"request": req.request_id,
                           "steps": len(out) - 1})
            self._emit_request_record(
                REQ_SPAN, tr, ts=tr["ns_submit"], dur_s=latency,
                sid=tr["sid"], pid=tr.get("pid"),
                extra={"request": req.request_id,
                       "prompt_len": int(req.prompt.size),
                       "tokens": len(out), "finish": reason,
                       "queue_wait_s": queue_wait,
                       "ttft_s": req.ttft_s, "latency_s": latency,
                       "decode_steps": max(0, len(out) - 1)})
        self.allocator.free(self._slot_pages[slot], owner=req.request_id)
        self._slot_req[slot] = None
        self._slot_pages[slot] = []
        self._slot_out[slot] = []
        self._slot_prefill[slot] = None
        self._slot_cow_idx[slot] = -1
        self._tables[slot] = 0
        self._positions[slot] = 0
        self._next_tok[slot] = 0

    # -- per-request trace plumbing ----------------------------------------

    @staticmethod
    def _trace_ts(tr, clk):
        """Wall-clock ns of an engine-clock instant: deltas come from the
        engine's (injectable) clock, so trace durations agree with the
        latency histograms, anchored to the wall time taken at submit."""
        return tr["ns_submit"] + int((clk - tr["clk_submit"]) * 1e9)

    def _emit_request_record(self, name, tr, *, ts, dur_s, extra,
                             sid=None, pid=None):
        record = {"name": name, "tid": tr["tid"],
                  "sid": sid if sid is not None else _dtrace.new_id(),
                  "ts": int(ts), "dur_ns": max(0, int(dur_s * 1e9)),
                  "extra": extra}
        if pid is not None:
            record["pid"] = pid
        if self.trace_lane is not None:
            record["lane"] = self.trace_lane
        _dtrace.record_span(record)

    def _emit_queued(self, req):
        if req.trace is not None:
            self._emit_request_record(
                REQ_QUEUED_SPAN, req.trace, ts=req.trace["ns_submit"],
                dur_s=req.admitted_at - req.submitted_at,
                pid=req.trace["sid"], extra={"request": req.request_id})

    def _emit_step_record(self, slots):
        """One batched progress record per decode step (not per token):
        [request_id, tokens emitted so far + 1] per slot. Not a span:
        trace_merge takes kind=req_step records out of the span pipeline
        and counts each request's steps with them."""
        if not _dtrace.trace_active():
            return
        rec = {"kind": REQ_STEP_KIND, "ts": time.time_ns(),
               "step": self.steps,
               "slots": [[self._slot_req[s].request_id,
                          len(self._slot_out[s]) + 1] for s in slots]}
        if self.trace_lane is not None:
            rec["lane"] = self.trace_lane
        _dtrace.record_span(rec)

    def _record_timeline(self, req, n_tokens, reason, queue_wait, latency):
        self._timelines.append({
            "request_id": req.request_id,
            "prompt_len": int(req.prompt.size),
            "tokens": n_tokens,
            "finish": reason,
            "queue_wait_s": queue_wait,
            "ttft_s": req.ttft_s if req.admitted_at else None,
            "latency_s": latency,
        })

    # -- introspection ------------------------------------------------------

    def recent_timelines(self):
        """Last-N finished-request timeline dicts (newest last): the
        payload an SLO breach dump carries."""
        return list(self._timelines)

    def goodput(self):
        """Token accounting split: device token positions by kind, the
        wasted share (prefill padding, rejected speculation and evicted
        requests' tokens), and the useful fraction."""
        processed = sum(self._tokens.values())
        useful = (self._tokens["prefill"] + self._tokens["decode"]
                  - self._wasted_evicted)
        return {
            "prefill": self._tokens["prefill"],
            "decode": self._tokens["decode"],
            "pad": self._tokens["pad"],
            "spec_rejected": self._tokens["spec_rejected"],
            "wasted_evicted": self._wasted_evicted,
            "processed": processed,
            "useful": useful,
            "fraction": useful / processed if processed else 1.0,
        }

    @property
    def prefix_hit_rate(self):
        """Fraction of admissions that mapped at least one cached page
        (0.0 when the prefix cache is off or nothing was admitted)."""
        return (self._prefix_hits / self._prefix_lookups
                if self._prefix_lookups else 0.0)

    @property
    def prefix_tokens_saved(self):
        """Prompt tokens never prefilled because their pages came from
        the prefix cache."""
        return self._prefix_tokens_saved

    @property
    def cow_copies(self):
        """Copy-on-write page copies performed (admission + decode)."""
        return self._cow_copies

    @property
    def spec_acceptance(self):
        """Accepted / proposed draft tokens (0.0 before any proposal)."""
        return (self._spec_accepted / self._spec_proposed
                if self._spec_proposed else 0.0)

    def _lever_rows(self):
        """The prefix-cache, speculation and chunked-prefill sections of
        `debug_snapshot` (None for a lever that is off)."""
        cache = self.prefix_cache
        prefix_rows = spec_rows = chunk_rows = None
        if cache is not None:
            prefix_rows = {
                "cached_pages": cache.cached_pages,
                "capacity": cache.max_pages,
                "lookups": self._prefix_lookups,
                "hits": self._prefix_hits,
                "hit_rate": self.prefix_hit_rate,
                "tokens_saved": self._prefix_tokens_saved,
                "evictions": cache.evictions,
                "cow_copies": self._cow_copies,
                "refcount_histogram": {
                    str(k): v for k, v in sorted(
                        self.allocator.refcount_histogram().items())},
            }
        if self.spec_ngram:
            spec_rows = {
                "ngram": self.spec_ngram,
                "lookahead": self.spec_lookahead,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "acceptance": self.spec_acceptance,
            }
        if self.prefill_chunk:
            chunk_rows = {
                "chunk": self.prefill_chunk,
                "in_flight": sum(p is not None for p in self._slot_prefill),
                "chunks_total": self._prefill_chunks,
            }
        return prefix_rows, spec_rows, chunk_rows

    def debug_snapshot(self):
        """Live-engine JSON-able snapshot: slots, queue, page pool, the
        levers, goodput, the sites' capture counts and the SLO states.
        Served at /debug/engine by the telemetry HTTP server
        (MXTPU_DEBUG_ENDPOINTS=1) and rendered by tools/serving_top.py."""
        with self._lock:
            now = self._clock()
            slot_rows = []
            for s, req in enumerate(self._slot_req):
                if req is None:
                    slot_rows.append({"slot": s, "state": "idle"})
                    continue
                pending = self._slot_prefill[s]
                slot_rows.append({
                    "slot": s,
                    "state": "prefilling" if pending else "decoding",
                    "request_id": req.request_id,
                    "age_s": now - req.submitted_at,
                    "prompt_len": int(req.prompt.size),
                    "tokens_out": len(self._slot_out[s]),
                    "position": (int(pending["pos"]) if pending
                                 else int(self._positions[s])),
                    "pages_held": len(self._slot_pages[s]),
                })
            queued = [{"request_id": r.request_id,
                       "age_s": now - r.submitted_at,
                       "prompt_len": int(r.prompt.size),
                       "max_new_tokens": r.max_new_tokens}
                      for r in self._queue]
            prefix_rows, spec_rows, chunk_rows = self._lever_rows()
            compile_rows = {
                fn: {"signatures": v["signatures"],
                     "retraces": v["retraces"]}
                for fn, v in compilereg.snapshot().items()
                if fn.startswith("serving_")}
            return {
                "schema": "mxtpu-torch-serving-engine-debug-v2",
                "device": str(self.device),
                "steps": self.steps,
                "decode_steps": self.decode_steps,
                "wide_calls": self.wide_calls,
                "slots": slot_rows,
                "slots_in_use": self.slots_in_use,
                "queue": queued,
                "queue_depth": len(self._queue),
                "pages": {
                    "capacity": self.allocator.capacity,
                    "in_use": self.allocator.num_in_use,
                    "free": self.allocator.num_free,
                    "page_size": self.allocator.page_size,
                    "occupancy": self.allocator.occupancy(),
                    "fragmentation": self.allocator.fragmentation(),
                },
                "prefix_cache": prefix_rows,
                "speculation": spec_rows,
                "chunked_prefill": chunk_rows,
                "tokens": self.goodput(),
                "compile": compile_rows,
                "slo": (self.slo.snapshot() if self.slo is not None
                        else None),
                "requests_finished": len(self._results),
            }

    def cancel(self, request_id):
        """Cancel a request: still-queued requests finish as "cancelled"
        (nothing was processed); live ones are EVICTED mid-stream, their
        pages recycle at once and every token they pushed through the
        device counts as wasted. Returns True when the request was
        cancelled, False when the id is unknown or already finished."""
        with self._lock:
            for i, req in enumerate(self._queue):
                if req.request_id == request_id:
                    del self._queue[i]
                    waited = self._clock() - req.submitted_at
                    self._results[request_id] = RequestResult(
                        request_id=request_id, tokens=[],
                        finish_reason="cancelled",
                        prompt_len=int(req.prompt.size),
                        queue_wait_s=waited, latency_s=waited)
                    telemetry.inc(REQUESTS_TOTAL, outcome="cancelled")
                    telemetry.set_gauge(QUEUE_DEPTH, len(self._queue))
                    self._record_timeline(req, 0, "cancelled", waited,
                                          waited)
                    _recorder.log_event("serving_request_finish",
                                        request=request_id,
                                        outcome="cancelled", tokens=0)
                    if req.trace is not None:
                        self._emit_request_record(
                            REQ_SPAN, req.trace, ts=req.trace["ns_submit"],
                            dur_s=waited, sid=req.trace["sid"],
                            pid=req.trace.get("pid"),
                            extra={"request": request_id,
                                   "prompt_len": int(req.prompt.size),
                                   "tokens": 0, "finish": "cancelled",
                                   "latency_s": waited, "decode_steps": 0})
                    return True
            for s, req in enumerate(self._slot_req):
                if req is not None and req.request_id == request_id:
                    self._finish(s, reason="evicted")
                    self._export_gauges()
                    return True
            return False

    def _export_gauges(self):
        telemetry.set_gauge(QUEUE_DEPTH, len(self._queue))
        telemetry.set_gauge(SLOTS_IN_USE, self.slots_in_use)
        telemetry.set_gauge(PAGES_IN_USE, self.allocator.num_in_use)
        telemetry.set_gauge(
            PAGE_UTILIZATION,
            self.allocator.num_in_use / max(1, self.allocator.capacity))
        telemetry.set_gauge(
            OLDEST_QUEUED,
            self._clock() - self._queue[0].submitted_at
            if self._queue else 0.0)
        telemetry.set_gauge(GOODPUT, self.goodput()["fraction"])
        if self.prefix_cache is not None:
            telemetry.set_gauge(PREFIX_CACHED_PAGES,
                                self.prefix_cache.cached_pages)
