"""Tracing spans: nested wall-time regions that feed several sinks at once.

The port's copy of the JAX package's `telemetry/spans.py`. A span records
its duration into the metrics registry (`mxtpu_span_seconds{span=...}`),
opens a `torch.profiler.record_function` range while a profiling window
is running (`profiler.set_state("run")`), so spans line up with the
device timeline of a `torch.profiler` trace, and accumulates into the
profiler's per-name aggregate table when `aggregate_stats` is on.

When tracing is active (`MXTPU_TRACE_DIR`), every span also carries
Dapper-style identity (`trace_id`/`span_id`/`parent_id`) and is appended
to this process's trace file on exit. A root span adopts the remote
parent set by `distributed.remote_context`. Completed spans also drop a
boundary event into the flight recorder ring, so a post-mortem dump
shows what the process was doing.

A span whose body raises keeps its timing but is tagged
`error=<ExcType>` (visible in traces and the `mxtpu_span_seconds` series)
and bumps `mxtpu_span_errors_total{name=...}`.

Nesting is tracked per thread; `current_span()` exposes the innermost
active span (its `parent` chain gives the full stack).
"""
from __future__ import annotations

import threading
import time

from .. import profiler as _profiler
from . import distributed as _distributed
from . import recorder as _recorder
from .metrics import REGISTRY

__all__ = ["Span", "current_span", "SPAN_HISTOGRAM", "SPAN_ERRORS"]

SPAN_HISTOGRAM = "mxtpu_span_seconds"
_SPAN_HELP = ("Wall time of named host-side spans (executor forward/backward,"
              " trainer step, ...); tags become extra labels.")
SPAN_ERRORS = "mxtpu_span_errors_total"
_ERRORS_HELP = ("Spans whose body raised, by span name (the exception type "
                "is tagged on the span itself).")

_local = threading.local()


def current_span():
    """Innermost active span on this thread, or None."""
    return getattr(_local, "current", None)


class Span:
    """Context manager for one timed region. Re-enterable is NOT supported
    (create a fresh Span per region); re-use across threads is not either —
    both mirror record_function's contract.

    `metrics=False` builds a trace-only span: it still gets identity and
    lands in the trace file / flight recorder, but skips the registry and
    profiler sinks — the shape `span()` hands out when distributed tracing
    is on while telemetry proper is off."""

    __slots__ = ("name", "tags", "parent", "trace_id", "span_id",
                 "parent_id", "extra", "_start_ns", "_t0", "_annot",
                 "_metrics")

    def __init__(self, name, tags=None, metrics=True):
        self.name = name
        self.tags = dict(tags or {})
        self.parent = None
        self.trace_id = None
        self.span_id = None
        self.parent_id = None
        self.extra = None
        self._start_ns = None
        self._t0 = None
        self._annot = None
        self._metrics = metrics

    def annotate(self, **kv):
        """Attach key/values to the span's trace record (not metric
        labels — no cardinality cost). Used for e.g. the RPC send/recv
        timestamps that drive clock-skew correction in trace_merge."""
        if self.extra is None:
            self.extra = {}
        self.extra.update(kv)
        return self

    def bump(self, key, amount=1):
        """Increment a numeric annotation (e.g. per-span retry count)."""
        if self.extra is None:
            self.extra = {}
        self.extra[key] = self.extra.get(key, 0) + amount
        return self

    def __enter__(self):
        self.parent = getattr(_local, "current", None)
        _local.current = self
        if _distributed.trace_active():
            self.span_id = _distributed.new_id()
            parent = self.parent
            if parent is not None and parent.span_id is not None:
                self.trace_id = parent.trace_id
                self.parent_id = parent.span_id
            else:
                remote = _distributed.remote_parent()
                if remote is not None:
                    self.trace_id, self.parent_id = remote
                else:
                    self.trace_id = _distributed.new_id()
            self._start_ns = time.time_ns()
        if _profiler._STATE["running"]:
            try:
                self._annot = _profiler.scope(self.name)
                self._annot.__enter__()
            except Exception:
                self._annot = None  # tracing must never break the workload
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        dur = time.perf_counter() - self._t0
        if self._annot is not None:
            try:
                self._annot.__exit__(exc_type, exc_val, exc_tb)
            except Exception:
                pass
            self._annot = None
        _local.current = self.parent
        if exc_type is not None:
            self.tags["error"] = getattr(exc_type, "__name__", str(exc_type))
        if self._metrics:
            labels = {"span": self.name}
            for k, v in self.tags.items():
                labels[str(k)] = str(v)
            REGISTRY.histogram(SPAN_HISTOGRAM, _SPAN_HELP).observe(
                dur, **labels)
            if exc_type is not None:
                REGISTRY.counter(SPAN_ERRORS, _ERRORS_HELP).inc(
                    1, name=self.name)
            if _profiler.aggregate_enabled():
                _profiler.record_duration(self.name, dur)
        if self.span_id is not None:
            record = {
                "name": self.name,
                "tid": self.trace_id,
                "sid": self.span_id,
                "pid": self.parent_id,
                "ts": self._start_ns,
                "dur_ns": int(dur * 1e9),
            }
            if self.tags:
                record["tags"] = {str(k): str(v)
                                  for k, v in self.tags.items()}
            if self.extra:
                record["extra"] = self.extra
            _distributed.record_span(record)
        _recorder.log_event(
            "span_end", name=self.name, dur_ns=int(dur * 1e9),
            **({"error": self.tags["error"]} if exc_type is not None else {}))
        return False


class NoopSpan:
    """Shared do-nothing span for the disabled path: one module-level
    instance, safe to re-enter from any thread."""

    __slots__ = ()
    name = None
    tags = {}
    parent = None
    trace_id = None
    span_id = None
    parent_id = None
    extra = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kv):
        return self

    def bump(self, key, amount=1):
        return self


NOOP_SPAN = NoopSpan()
