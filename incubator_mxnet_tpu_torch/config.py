"""Runtime knobs read by the PyTorch port, with the JAX package's names,
defaults and environment semantics.

Only the knobs the ported paths read are registered here: the serving
path's, including the serving levers' (`MXTPU_PREFIX_CACHE`,
`MXTPU_PREFILL_CHUNK`, `MXTPU_SPEC_NGRAM`, `MXTPU_SPEC_LOOKAHEAD`; an
engine's constructor argument wins over its knob), telemetry's (tracing,
the flight recorder, the /metrics port, the serving SLOs and the /debug/*
endpoints), and the ResNet train step's `MXTPU_FUSED_EPILOGUE`.
"""
from __future__ import annotations

import dataclasses
import os

import torch

__all__ = ["Knob", "KNOBS", "get", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    default: object
    type: type
    doc: str


KNOBS: dict[str, Knob] = {}


def _register(name, default, type_, doc):
    KNOBS[name] = Knob(name, default, type_, doc)


def get(name, default=None):
    """Read a registered knob from the environment with its typed default
    (read live, as the JAX package's `config.get` does)."""
    knob = KNOBS.get(name)
    if knob is None:
        raise KeyError(f"unregistered config knob {name!r}; add it to "
                       "incubator_mxnet_tpu_torch/config.py")
    raw = os.environ.get(name)
    if raw is None:
        return default if default is not None else knob.default
    if knob.type is bool:
        return raw.lower() not in ("0", "false", "off", "")
    return knob.type(raw)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. `None` means CUDA, and raises
    when CUDA is absent: the port never falls back to the CPU on its own.
    Pass `device="cpu"` to run the plain PyTorch versions of the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


_register("MXNET_TELEMETRY", False, bool,
          "Turn the metrics registry on (off: every inc/set_gauge/observe "
          "returns before touching it).")
_register("MXNET_TELEMETRY_PORT", 0, int,
          "When >0 and telemetry is enabled, serve Prometheus text "
          "exposition at http://0.0.0.0:<port>/metrics from a daemon "
          "thread (stdlib http.server; no client library needed).")
_register("MXTPU_PROCESS_ID", 0, int,
          "This process's rank (ref: ps-lite rank assignment).")

# distributed tracing / flight recorder
_register("MXTPU_TRACE_DIR", "", str,
          "Directory for per-process binary-framed trace files "
          "(span records with trace/span/parent ids). Setting it "
          "activates cluster-wide trace export: every completed span "
          "is appended to <dir>/trace-<pid>-<suffix>.mxtrace; merge "
          "the files with tools/trace_merge.py into one "
          "Chrome-trace/Perfetto timeline. Empty (default) disables "
          "trace export.")
_register("MXTPU_TRACE_BUFFER_SPANS", 256, int,
          "Completed spans buffered in memory before one framed "
          "write+flush to the trace file (atexit flushes the "
          "remainder). Lower = fresher files after a crash, higher "
          "= fewer write calls on the span exit path.")
_register("MXTPU_FLIGHT_RECORDER_EVENTS", 4096, int,
          "Capacity of the always-on flight-recorder ring buffer "
          "(structured events: span boundaries, retries, reconnects, "
          "evictions, checkpoint writes, injected faults). The ring "
          "is a fixed-size in-memory black box costing one list "
          "store per event; 0 disables recording entirely.")
_register("MXTPU_FLIGHT_RECORDER_DIR", "", str,
          "Destination directory for post-mortem flight-recorder "
          "dumps (ring contents + metrics snapshot + config knobs as "
          "JSON), written when a worker dies with an uncaught "
          "exception, a retry policy exhausts, or the server evicts "
          "a rank. Empty falls back to MXTPU_TRACE_DIR; when both "
          "are empty no dump files are ever written (the ring still "
          "records).")
_register("MXTPU_FLIGHT_RECORDER_MAX_DUMPS", 8, int,
          "Cap on post-mortem dump files one process may write "
          "(guards against dump storms from a retry loop that "
          "exhausts repeatedly).")

# serving SLOs (telemetry/slo.py): a threshold of 0 disables that
# objective; when every threshold is 0 the serving engine attaches no
# monitor at all (zero per-request cost)
_register("MXTPU_SLO_TTFT_P99", 0.0, float,
          "Serving SLO: time-to-first-token ceiling in seconds. A "
          "finished request whose TTFT exceeds this burns error "
          "budget; 0 disables the objective.")
_register("MXTPU_SLO_QUEUE_WAIT_P99", 0.0, float,
          "Serving SLO: queue-wait (submit to slot admission) "
          "ceiling in seconds; 0 disables the objective.")
_register("MXTPU_SLO_REQUEST_P99", 0.0, float,
          "Serving SLO: end-to-end request latency ceiling in "
          "seconds; 0 disables the objective.")
_register("MXTPU_SLO_GOODPUT_MIN", 0.0, float,
          "Serving SLO: goodput floor in [0, 1] — the fraction of "
          "processed tokens that were neither prefill padding nor "
          "spent on evicted requests. Samples BELOW the floor burn "
          "budget; 0 disables the objective.")
_register("MXTPU_SLO_BUDGET", 0.01, float,
          "Error budget for every SLO objective: the fraction of "
          "requests allowed to violate their threshold. Burn rate "
          "= bad_fraction / budget (burn 1.0 spends the budget "
          "exactly).")
_register("MXTPU_SLO_WINDOW_SHORT", 32, int,
          "Short burn-rate window in SAMPLES (finished requests). "
          "Count-based, not wall-clock, so burn math is "
          "deterministic under test.")
_register("MXTPU_SLO_WINDOW_LONG", 128, int,
          "Long burn-rate window in samples; breach requires BOTH "
          "windows over MXTPU_SLO_BREACH_BURN (the classic "
          "multi-window guard against paging on a blip).")
_register("MXTPU_SLO_MIN_SAMPLES", 8, int,
          "Samples an objective must see before the state machine "
          "may leave 'ok' (cold-start guard).")
_register("MXTPU_SLO_WARN_BURN", 1.0, float,
          "Short-window burn rate at which an objective enters "
          "'warning'.")
_register("MXTPU_SLO_BREACH_BURN", 10.0, float,
          "Burn rate both windows must reach for 'breach' (bumps "
          "mxtpu_slo_breaches_total and writes one post-mortem "
          "dump); the objective re-arms when the short window "
          "drops back below this.")
_register("MXTPU_SLO_DUMP_TIMELINES", 32, int,
          "Finished-request timelines the serving engine retains "
          "for the breach post-mortem dump (last N).")
_register("MXTPU_DEBUG_ENDPOINTS", False, bool,
          "Serve registered /debug/* JSON endpoints (e.g. "
          "/debug/engine) from the telemetry HTTP server. Off by "
          "default: introspection snapshots expose request ids and "
          "queue contents, which not every /metrics scraper should "
          "see.")

_register("MXTPU_PAGE_SIZE", 16, int,
          "Tokens per KV-cache page in the paged decode pool.")
_register("MXTPU_DECODE_SLOTS", 8, int,
          "Fixed number of decode slots in the continuous-batching engine: "
          "the batch dimension of every paged decode step.")
_register("MXTPU_SERVING_PAGES", 0, int,
          "Total pages in the serving KV pool (page 0 is the reserved null "
          "page). 0 auto-sizes to slots x ceil(max_len / page_size) + 1.")
_register("MXTPU_PREFILL_BUCKETS", "", str,
          "Comma-separated prompt-length buckets for serving prefill. Empty "
          "uses powers of two from 16 up to the model's max_len.")
_register("MXTPU_PREFIX_CACHE", 0, int,
          "Prefix-cached copy-on-write KV pages in the serving engine: "
          "prompts sharing a page-aligned token prefix map the cached pages "
          "read-only instead of prefilling them again. 0 (default) "
          "disables; 1 enables with a cache bounded only by pool pressure; "
          "N > 1 caps the cache at N pages.")
_register("MXTPU_PREFILL_CHUNK", 0, int,
          "Chunked prefill: prompts stream through the wide step this many "
          "tokens per engine step, interleaved with the batched decode. 0 "
          "(default) prefills each prompt in one bucketed call at "
          "admission.")
_register("MXTPU_SPEC_NGRAM", 0, int,
          "N-gram length of draft-free prompt-lookup speculation: the "
          "trailing n-gram of a request's own history proposes the "
          "continuation of its latest earlier match. 0 (default) "
          "disables speculation.")
_register("MXTPU_SPEC_LOOKAHEAD", 4, int,
          "Tokens proposed per speculative step (the wide verification "
          "step runs lookahead + 1 query rows per slot). Read only when "
          "MXTPU_SPEC_NGRAM > 0.")
_register("MXTPU_FUSED_EPILOGUE", False, bool,
          "Route BatchNorm -> ReLU (-> residual add) chains of channels-last "
          "nets through the fused epilogue kernels "
          "(ops/kernels/epilogue.py:bn_act_epilogue): one pass applies the "
          "BN affine folded to per-channel scale/shift, the residual add "
          "and the activation. Off (default) runs every op unfused.")
