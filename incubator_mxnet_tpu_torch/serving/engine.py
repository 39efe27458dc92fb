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
`models.transformer.generate()` per request. The argmax stays on the
device; the one host sync of a step is reading the new tokens back.

The JAX engine's three levers (prefix cache, chunked prefill, n-gram
speculation) are not ported yet: turning one on, by argument or knob,
raises NotImplementedError rather than serving without it. Spans,
request tracing, SLOs and the compile registry are not ported yet
either; `debug_snapshot` has no sections for them.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import config, telemetry
from ..config import resolve_device
from ..models import transformer as _tfm
from .pages import PageAllocator

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

    `step()` runs ONE scheduler iteration (admissions + one decode
    step) for callers that interleave serving with other work.
    `device=None` means CUDA (and raises without it); the params must
    already lie on the engine's device.
    """

    def __init__(self, params, cfg, *, slots=None, page_size=None,
                 num_pages=None, max_len=None, clock=time.monotonic,
                 prefix_cache=None, prefill_chunk=None, spec_ngram=None,
                 device=None):
        for arg, value, knob in (
                ("prefix_cache", prefix_cache, "MXTPU_PREFIX_CACHE"),
                ("prefill_chunk", prefill_chunk, "MXTPU_PREFILL_CHUNK"),
                ("spec_ngram", spec_ngram, "MXTPU_SPEC_NGRAM")):
            # an explicit argument wins over the knob, as in the JAX engine
            if int(config.get(knob) if value is None else value):
                raise NotImplementedError(
                    f"serving lever {arg} ({knob}) is not ported yet: it "
                    f"comes with the next slice (paged_decode_attention_"
                    f"wide); leave it 0")
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
        self.paged = _tfm.init_paged_kv_cache(cfg, num_pages, self.page_size,
                                              device=self.device)
        self.prefill_buckets = _default_buckets(self.max_len)
        self._clock = clock
        # submit/cancel may arrive from other threads while step() runs
        self._lock = threading.RLock()

        S, W = self.slots, self.table_width
        self._tables = np.zeros((S, W), np.int64)
        self._positions = np.zeros((S,), np.int64)
        self._next_tok = np.zeros((S,), np.int64)
        self._slot_req: list[Request | None] = [None] * S
        self._slot_pages: list[list] = [[] for _ in range(S)]
        self._slot_out: list[list] = [[] for _ in range(S)]
        self._queue: deque[Request] = deque()
        self._results: dict[int, RequestResult] = {}
        self._ids = itertools.count()
        self.steps = 0
        # engine steps that ran a decode (steps with no live slot do not)
        self.decode_steps = 0

        # host-side goodput accounting (independent of whether the
        # metrics registry is on): token positions the device processed
        # by kind, plus tokens spent on requests later evicted
        self._tokens = {"prefill": 0, "decode": 0, "pad": 0}
        self._wasted_evicted = 0

    # -- public API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens, eos_id=None):
        """Queue one request; returns its request id. Validation is
        eager: an unservable request fails here, not mid-decode."""
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
            self._queue.append(req)
            telemetry.set_gauge(QUEUE_DEPTH, len(self._queue))
            telemetry.set_gauge(
                OLDEST_QUEUED,
                self._clock() - self._queue[0].submitted_at)
            return rid

    def step(self):
        """One scheduler iteration: admit queued requests into free
        slots (FIFO, backpressured by page availability), then advance
        every live slot one token in a single decode step. Returns the
        number of live slots after the iteration."""
        with self._lock:
            self._admit()
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
                    return dict(self._results)
            self.step()
        raise RuntimeError(f"serving engine did not drain within "
                           f"{max_steps} steps")

    def results(self):
        with self._lock:
            return dict(self._results)

    def live_tokens(self):
        """{request_id: continuation tokens streamed so far} for every
        request holding a slot. Queued requests do not appear."""
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

    def _to_device(self, array):
        # a fresh host copy, sent without waiting for the device: the one
        # sync of a step stays the read-back of its tokens
        return torch.tensor(array, dtype=torch.int64).to(self.device,
                                                         non_blocking=True)

    def _admit(self):
        """FIFO admission: stop at the first request that can't get a
        slot or its pages (head-of-line order keeps scheduling
        deterministic: no small request overtakes a starved big one)."""
        while self._queue:
            slot = self._free_slot()
            if slot is None:
                telemetry.inc(ADMISSION_BLOCKED, reason="slots")
                return
            req = self._queue[0]
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
            self._prefill_into(slot, req, pages)

    def _prefill_into(self, slot, req, pages):
        T_p = req.prompt.size
        T_b = self._bucket_for(T_p)
        row = np.asarray(
            self.allocator.table_row(pages, self.table_width), np.int64)
        prompt = np.zeros((1, T_b), np.int64)
        prompt[0, :T_p] = req.prompt
        with torch.no_grad():
            _, logits = _tfm.prefill_paged(
                self.params, self.paged, self._to_device(prompt),
                self._to_device([T_p]), self._to_device(row[None]),
                self.cfg)
            first = int(torch.argmax(logits, dim=-1).cpu()[0])
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
        self._slot_req[slot] = req
        self._slot_pages[slot] = pages
        self._slot_out[slot] = [first]
        self._tables[slot] = row
        self._positions[slot] = T_p
        self._next_tok[slot] = first
        if self._is_done(req, [first]):
            self._finish(slot)

    def _decode_once(self):
        live_slots = [s for s, r in enumerate(self._slot_req)
                      if r is not None]
        if not live_slots:
            return self.slots_in_use
        with torch.no_grad():
            logits, _ = _tfm.decode_step_paged(
                self.params, self.paged, self._to_device(self._next_tok),
                self._to_device(self._positions),
                self._to_device(self._tables), self.cfg)
            tok = torch.argmax(logits, dim=-1).cpu().numpy()
        self.decode_steps += 1
        n_live = len(live_slots)
        self._tokens["decode"] += n_live
        telemetry.inc(TOKENS_TOTAL, amount=float(n_live), kind="decode")
        for s in live_slots:
            req = self._slot_req[s]
            self._slot_out[s].append(int(tok[s]))
            self._positions[s] += 1
            self._next_tok[s] = tok[s]
            if self._is_done(req, self._slot_out[s]):
                self._finish(s)
        return self.slots_in_use

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
        self.allocator.free(self._slot_pages[slot], owner=req.request_id)
        self._slot_req[slot] = None
        self._slot_pages[slot] = []
        self._slot_out[slot] = []
        self._tables[slot] = 0
        self._positions[slot] = 0
        self._next_tok[slot] = 0

    # -- introspection ------------------------------------------------------

    def goodput(self):
        """Token accounting split: device token positions by kind, the
        wasted share (prefill padding + evicted requests' tokens), and the
        useful fraction."""
        processed = sum(self._tokens.values())
        useful = (self._tokens["prefill"] + self._tokens["decode"]
                  - self._wasted_evicted)
        return {
            "prefill": self._tokens["prefill"],
            "decode": self._tokens["decode"],
            "pad": self._tokens["pad"],
            "wasted_evicted": self._wasted_evicted,
            "processed": processed,
            "useful": useful,
            "fraction": useful / processed if processed else 1.0,
        }

    def debug_snapshot(self):
        """Live-engine JSON-able snapshot: slots, queue, page pool and
        goodput."""
        with self._lock:
            now = self._clock()
            slot_rows = []
            for s, req in enumerate(self._slot_req):
                if req is None:
                    slot_rows.append({"slot": s, "state": "idle"})
                    continue
                slot_rows.append({
                    "slot": s,
                    "state": "decoding",
                    "request_id": req.request_id,
                    "age_s": now - req.submitted_at,
                    "prompt_len": int(req.prompt.size),
                    "tokens_out": len(self._slot_out[s]),
                    "position": int(self._positions[s]),
                    "pages_held": len(self._slot_pages[s]),
                })
            queued = [{"request_id": r.request_id,
                       "age_s": now - r.submitted_at,
                       "prompt_len": int(r.prompt.size),
                       "max_new_tokens": r.max_new_tokens}
                      for r in self._queue]
            return {
                "schema": "mxtpu-torch-serving-engine-debug-v1",
                "device": str(self.device),
                "steps": self.steps,
                "decode_steps": self.decode_steps,
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
                "tokens": self.goodput(),
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
