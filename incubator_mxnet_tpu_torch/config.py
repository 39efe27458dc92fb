"""Runtime knobs read by the PyTorch port, with the JAX package's names,
defaults and environment semantics.

Only the knobs the ported paths read are registered here: the serving
path's, including the serving levers' (`MXTPU_PREFIX_CACHE`,
`MXTPU_PREFILL_CHUNK`, `MXTPU_SPEC_NGRAM`, `MXTPU_SPEC_LOOKAHEAD`; an
engine's constructor argument wins over its knob), telemetry's (tracing,
the flight recorder, the /metrics port, the serving SLOs and the /debug/*
endpoints), the runtime sanitizers', resilience's (retry, fault
injection), the serving fleet's and gateway's, the step statistics',
the ResNet train step's `MXTPU_FUSED_EPILOGUE` and
`MXTPU_REMAT_POLICY`, and the imperative surface's (NDArray dtype, the
trainer's guardrail, the checkpoint walk-back), the model zoo's
`MXTPU_MODELS_ROOT`, and the training toolkit's (stochastic rounding,
the Trainer's update aggregation, the memory sampling interval), and
the recommender path's (the parameter server's address, secret,
timeouts and dedup window, heartbeats, the embedding shard fleet, row
prefetch and the sparse nnz grid).
"""
from __future__ import annotations

import dataclasses
import os

import torch

__all__ = ["Knob", "KNOBS", "describe", "get", "register_knob",
           "resolve_device"]


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    default: object
    type: type
    doc: str


KNOBS: dict[str, Knob] = {}


def register_knob(name, default, type_, doc):
    """Register knob `name` (its default, type and documentation)."""
    KNOBS[name] = Knob(name, default, type_, doc)
    return KNOBS[name]


_register = register_knob


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


def describe():
    """The environment-variable reference of every registered knob, as
    markdown."""
    lines = ["# Environment variables", ""]
    for knob in sorted(KNOBS.values(), key=lambda k: k.name):
        lines.append(f"- `{knob.name}` (default `{knob.default}`, "
                     f"{knob.type.__name__}): {knob.doc}")
    return "\n".join(lines)


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
_register("MXNET_TELEMETRY_STEPSTATS_WINDOW", 128, int,
          "Rolling-window length (steps) for the step-phase p50/p99 "
          "gauges and the step-anomaly median (telemetry/stepstats.py).")
_register("MXNET_TELEMETRY_ANOMALY_FACTOR", 3.0, float,
          "A step whose wall time exceeds this multiple of the rolling "
          "median step time emits a step_anomaly flight event and bumps "
          "mxtpu_step_anomalies_total.")
_register("MXNET_TELEMETRY_ANOMALY_MIN_STEPS", 8, int,
          "Minimum steps in the step-stats window before anomaly "
          "detection arms (suppresses warm-up and capture outliers).")
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
_register("MXTPU_REMAT_POLICY", "", str,
          "Named rematerialization policy for GluonTrainStep "
          "(fused.resolve_remat_policy), under the JAX package's names: "
          "'convs' (save convolution and matmul results, recompute the "
          "rest), 'dots' (dots_saveable: every matmul), 'dots_no_batch' "
          "(dots_with_no_batch_dims_saveable: mm/addmm only), 'offload' "
          "(offload_dot_with_no_batch_dims: those results kept in pinned "
          "host memory), 'nothing' (nothing_saveable: recompute "
          "everything, remat=True's behaviour) or 'everything' "
          "(everything_saveable: recompute nothing). A non-empty policy "
          "turns remat on; empty (default) leaves remat to the step's "
          "remat argument.")

# runtime sanitizers (analysis/sanitizers.py)
_register("MXTPU_SANITIZERS", "", str,
          "Comma-separated runtime sanitizers from "
          "analysis/sanitizers.py: 'locks' (san_lock primitives "
          "become instrumented — global lock-order graph with "
          "MXS001 deadlock-cycle reports, MXS002 "
          "blocking-op-under-lock, MXS003 long holds), 'pages' "
          "(shadow refcount/generation checking of every "
          "PageAllocator transition — MXS010 double free, MXS011 "
          "use-after-free, MXS012 COW violation, MXS013 leak at "
          "drain, MXS014 shadow divergence), and 'threads' (a token "
          "with no runtime hook). Empty (default) = all off: san_lock "
          "returns plain threading primitives, resolved once at lock "
          "creation — no per-acquire indirection. Findings feed "
          "mxtpu_sanitizer_findings_total and sanitizer_finding "
          "flight events.")
_register("MXTPU_SANITIZER_HOLD_MS", 250.0, float,
          "Lock-hold-time threshold in milliseconds for the locks "
          "sanitizer: releasing a sanitized lock held longer than "
          "this emits an MXS003 long-hold finding with the "
          "acquisition site. Only read while MXTPU_SANITIZERS "
          "includes 'locks'.")

# resilience / fault tolerance (resilience/)
_register("MXTPU_RETRY_MAX_ATTEMPTS", 8, int,
          "Max calls (first try + retries) a resilience.RetryPolicy "
          "makes before re-raising.")
_register("MXTPU_RETRY_BASE_DELAY", 0.05, float,
          "Seconds slept before the first retry; attempt k sleeps "
          "base * 2**k, capped by MXTPU_RETRY_MAX_DELAY.")
_register("MXTPU_RETRY_MAX_DELAY", 2.0, float,
          "Upper bound (seconds) on one exponential-backoff sleep.")
_register("MXTPU_RETRY_DEADLINE", 120.0, float,
          "Overall wall-clock budget (seconds) across all retries of "
          "one operation; the policy re-raises rather than sleep past "
          "it.")
_register("MXTPU_RETRY_JITTER", 0.1, float,
          "Backoff jitter fraction: each sleep is scaled by "
          "1 + U(-j, +j) from a seeded PRNG (deterministic across "
          "runs; 0 disables).")
_register("MXTPU_FAULT_SPEC", "", str,
          "Deterministic fault-injection spec, `site:mode@arg` rules "
          "joined by ';' (e.g. 'replica.kill:fail@8;ckpt.write:fail@2'). "
          "Modes: drop (connection), fail (IO error), torn "
          "(corrupt checkpoint), sigterm (deliver SIGTERM to self — "
          "a deterministic preemption), delay; arg is a probability or "
          "1-based call indices. Empty (default) disables injection.")
_register("MXTPU_FAULT_SEED", 0, int,
          "Seed for the fault injector's per-(site, instance) PRNG "
          "streams; same seed + same spec fires the same faults at "
          "the same calls.")

# serving fleet (serving/fleet.py + serving/gateway.py — health-checked
# routing, journaled mid-stream failover, draining rolling restarts)
_register("MXTPU_FLEET_HEARTBEAT_TIMEOUT", 10.0, float,
          "Seconds without a scheduler-pump heartbeat before the "
          "fleet router declares a serving replica dead and "
          "resubmits its journaled in-flight requests to the "
          "survivors. Must exceed the replica's worst-case single "
          "step (lazy CUDA-graph captures included) or a merely-slow "
          "replica fails over spuriously — harmless for clients "
          "(the journal dedups the zombie's late tokens) but "
          "wasteful.")
_register("MXTPU_FLEET_MAX_RESUBMITS", 3, int,
          "Failover resubmissions a single request may consume "
          "before the router gives up and fails it back to the "
          "client (guards against a poison request that kills "
          "every replica it lands on).")
_register("MXTPU_GATEWAY_PORT", 0, int,
          "TCP port for the serving HTTP gateway "
          "(serving/gateway.py). 0 (default) binds an ephemeral "
          "port — read it back from ServingGateway.port.")
_register("MXTPU_GATEWAY_QUEUE_LIMIT", 64, int,
          "Per-tenant router queue depth at which the gateway "
          "stops admitting that tenant's requests and answers 429 "
          "with Retry-After (bounded queueing instead of unbounded "
          "latency collapse).")
_register("MXTPU_GATEWAY_MAX_OCCUPANCY", 0.95, float,
          "KV page-pool occupancy (on the LEAST loaded healthy "
          "replica) above which the gateway sheds new requests "
          "with 429 — admission control backpressured by the same "
          "PageAllocator that backpressures slot admission.")
_register("MXTPU_GATEWAY_RETRY_AFTER", 1.0, float,
          "Retry-After seconds the gateway attaches to 429/503 "
          "responses.")
_register("MXTPU_GATEWAY_ACCESS_LOG", "", str,
          "Structured NDJSON access log for the serving gateway: "
          "a file path to append one JSON line per request "
          "(tenant, status, token counts, queue-wait/TTFT/latency, "
          "trace id, serving replica, failover count), '-' for "
          "stderr, empty (default) for off.")

# the imperative surface: NDArrays, the trainer's guardrail, checkpoints
_register("MXTPU_DEFAULT_DTYPE", "float32", str,
          "Default dtype for new NDArrays.")
_register("MXTPU_GUARDRAIL_POLICY", "", str,
          "Divergence guardrail in Trainer.step: when non-empty, every "
          "step runs one fused non-finite check over the gradients (one "
          "host read) BEFORE they reach the optimizer. 'skip' drops the "
          "poisoned update; 'rollback' raises GuardrailRollback for the "
          "training loop to restore the last good checkpoint via "
          "auto_resume; 'backoff' needs contrib.amp's loss scaler, not "
          "ported yet, and raises. Empty (default) disables the check.")
_register("MXTPU_CKPT_WALKBACK", 8, int,
          "How many epochs model.latest_valid_checkpoint walks back over "
          "corrupt/missing checkpoints before giving up (each skipped "
          "epoch is logged to the flight recorder). 0 walks all the way "
          "to epoch 0.")

# model zoo
_register("MXTPU_MODELS_ROOT", "", str,
          "Directory of the model zoo's parameter files (default "
          "~/.mxnet/models); nothing is downloaded.")

# the training toolkit: optimizer aggregation, stochastic rounding, memory
_register("MXTPU_STOCHASTIC_ROUNDING", False, bool,
          "Master-free bf16 optimizer updates: for bf16 weights under "
          "multi_precision, skip the f32 master copy and instead "
          "compute the update in f32 from the bf16 weight, then "
          "stochastically round the result back to bf16 (seeded per "
          "(step, param); the unbiased rounding replaces the master's "
          "role of accumulating sub-ulp updates). Cuts the f32 master "
          "read+write from optimizer traffic. Opt-in: equivalence to "
          "the f32-master path is to tolerance, not bit-exact.")
_register("MXNET_OPTIMIZER_AGGREGATION_SIZE", 4096, int,
          "Byte cap (in KB) of one aggregated optimizer-update bucket "
          "on the eager Trainer path: parameters are grouped into "
          "dtype-homogeneous buckets of at most this many KB and each "
          "bucket is updated by ONE batched multi-tensor update instead "
          "of one dispatch per parameter (the reference's knob of the "
          "same name counts tensors; here the cap is bytes). 0 disables "
          "aggregation (always per-param dispatch).")
_register("MXNET_TELEMETRY_MEM_INTERVAL", 1, int,
          "Trainer steps between device-memory watermark samples at "
          "step boundaries (0 disables memory sampling; sampling reads "
          "torch.cuda.memory_stats() per visible card plus host RSS).")

# the recommender path: the parameter server, kvstore heartbeats, the
# sharded embedding service and the sparse nnz grid
_register("MXTPU_COORDINATOR", "", str,
          "host:port of the job's coordinator (ref role: "
          "DMLC_PS_ROOT_URI); the parameter server defaults to its host "
          "and port + 23.")
_register("MXTPU_PS_ADDR", "", str,
          "host:port of the parameter server (default: coordinator "
          "host, coordinator port + 23).")
_register("MXTPU_PS_SECRET", "", str,
          "Shared job secret HMAC-authenticating the parameter "
          "server's optimizer blobs (the only pickled payload on the "
          "PS wire). Set it identically on every worker; unset, each "
          "process draws a random one (same-process pairs only).")
_register("MXTPU_PS_CONNECT_TIMEOUT", 30.0, float,
          "Seconds one PSClient connect attempt may take before it "
          "counts as failed and the retry policy redials.")
_register("MXTPU_PS_SOCKET_TIMEOUT", 320.0, float,
          "Idle timeout (seconds) on an established PSClient socket; "
          "must exceed the server-side sync/barrier wait so a blocked "
          "quorum RPC is not misread as a dead server.")
_register("MXTPU_PS_SYNC_TIMEOUT", 300.0, float,
          "Server-side cap (seconds) on one sync-push merge or "
          "barrier generation wait; heartbeat evictions re-evaluate "
          "the quorum well before this fires.")
_register("MXTPU_PS_DEDUP_WINDOW", 128, int,
          "Mutating RPCs remembered per client for exactly-once "
          "replay suppression across reconnects; must exceed the "
          "deepest pipelining a client does (the eager client "
          "pipelines 1).")
_register("MXTPU_PS_BUCKET_KB", 1024, int,
          "Byte cap (KiB) of one push_many/pull_many bucket on "
          "dist_async_server: list-key pushpulls batch into a single "
          "RPC pair per bucket. 0 disables batching (one RPC pair per "
          "key).")
_register("MXTPU_MAX_WORKERS", 0, int,
          "Elastic world cap for the parameter server: join RPCs may "
          "admit brand-new ranks until num_workers reaches this value "
          "(growth commits at the next barrier boundary). 0 keeps the "
          "world fixed at the configured size; re-admission of "
          "already-known ranks is always allowed.")
_register("MXTPU_HEARTBEAT_INTERVAL", 2.0, float,
          "Seconds between heartbeat touches.")
_register("MXTPU_HEARTBEAT_TIMEOUT", 20.0, float,
          "Heartbeat staleness after which a peer counts as dead "
          "(ref: ps-lite PS_HEARTBEAT_TIMEOUT).")
_register("MXTPU_EMBEDDING_SHARDS", "", str,
          "Comma-separated host:port list of the embedding-shard PS "
          "fleet (embedding.ShardedEmbeddingService). Row r of every "
          "sharded table lives only on server r % num_shards, so no "
          "worker ever materializes a table. Empty (default): the "
          "service must be handed explicit addresses or in-process "
          "servers (tests/bench).")
_register("MXTPU_SPARSE_PREFETCH", True, bool,
          "Overlap embedding-row pulls with dense compute: the sharded "
          "embedding service runs pulls and row-sparse grad pushes on "
          "an ordered background thread, so the next batch's rows "
          "stream in behind the current step's dense forward/backward "
          "(the blocking remainder is the sparse_pull stepstats "
          "phase). Off: every pull is a blocking RPC on the critical "
          "path; same math, no overlap.")
_register("MXTPU_SPARSE_NNZ_BUCKETING", False, bool,
          "Pad sparse (data, indices) buffers and the embedding "
          "service's pull blocks along nnz to the next power-of-2 "
          "bucket (floor 16), so a stream of batches sees a few stable "
          "shapes instead of one per distinct nnz.")
