"""Runtime telemetry for the port: the metrics registry, tracing spans,
request traces, the flight recorder, SLOs, the capture registry, the
train step's phase statistics (`stepstats`), the memory ledger
(`ledger`), memory watermarks at step boundaries (`memory`), the
TensorBoard callback (`tb`) and the exporters, with the JAX package's
names and semantics.

Off by default. `MXNET_TELEMETRY=1` (or `enable()`) turns it on; while
off every instrumented site short-circuits: `span()` hands back a shared
do-nothing context manager and the helpers return before touching the
registry, so the cost is one cached boolean check per site. Tracing
(`MXTPU_TRACE_DIR`) is a switch of its own: with it on and metrics off,
`span()` gives trace-only spans.

    from incubator_mxnet_tpu_torch import telemetry
    telemetry.enable(port=9090)   # /metrics (and /debug/* with
    ...                           # MXTPU_DEBUG_ENDPOINTS=1)
    print(telemetry.prometheus_text())

`MXNET_TELEMETRY_PORT=9090` serves /metrics when telemetry turns on.
"""
from __future__ import annotations

import threading

from .. import config as _config
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, REGISTRY, DEFAULT_BUCKETS,
    BYTES_BUCKETS,
)
from .names import (  # noqa: F401
    METRIC_NAMES, SPAN_NAMES, is_registered_metric, is_registered_span,
)
from . import distributed  # noqa: F401
from . import recorder  # noqa: F401
from .spans import Span, NoopSpan, NOOP_SPAN, current_span, SPAN_HISTOGRAM  # noqa: F401
from .recorder import log_event  # noqa: F401
from .exporters import (  # noqa: F401
    dump_json, prometheus_text, start_http_server, to_dict,
    register_debug_handler, unregister_debug_handler,
)
from . import compilereg  # noqa: F401
from . import slo  # noqa: F401
from . import stepstats  # noqa: F401
from . import ledger  # noqa: F401
from .memory import sample_device_memory, step_boundary  # noqa: F401
from .tb import LogTelemetryCallback  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_BUCKETS", "BYTES_BUCKETS",
    "Span", "NoopSpan", "current_span", "span",
    "distributed", "recorder", "log_event",
    "dump_json", "prometheus_text", "start_http_server", "to_dict",
    "register_debug_handler", "unregister_debug_handler",
    "compilereg", "slo", "stepstats", "ledger",
    "sample_device_memory", "step_boundary", "LogTelemetryCallback",
    "enabled", "enable", "disable", "refresh_from_env",
    "counter", "gauge", "histogram", "inc", "observe", "set_gauge",
    "METRIC_NAMES", "SPAN_NAMES", "is_registered_metric",
    "is_registered_span",
]

_state_lock = threading.Lock()
_enabled = None  # None = not yet resolved from MXNET_TELEMETRY
_http_server = None


def enabled():
    """Master switch. The first call resolves MXNET_TELEMETRY (and starts
    the /metrics endpoint when MXNET_TELEMETRY_PORT is set); afterwards a
    cached-boolean read, the whole cost of the disabled path."""
    e = _enabled
    if e is None:
        e = _set_enabled(bool(_config.get("MXNET_TELEMETRY")))
    return e


def _set_enabled(value):
    global _enabled
    with _state_lock:
        _enabled = bool(value)
        if _enabled:
            _maybe_start_http()
        return _enabled


def _maybe_start_http():
    global _http_server
    if _http_server is not None:
        return
    port = _config.get("MXNET_TELEMETRY_PORT")
    if port > 0:
        _http_server = start_http_server(port)


def enable(port=None):
    """Turn telemetry on for this process (overrides the env default).
    `port` also starts a /metrics endpoint there, bound before the flag
    flips, so an explicit port wins over MXNET_TELEMETRY_PORT. Returns the
    HTTP server, or None."""
    global _http_server
    if port is not None and _http_server is None:
        with _state_lock:
            if _http_server is None:
                _http_server = start_http_server(port)
    _set_enabled(True)
    return _http_server


def disable():
    """Turn telemetry off: instrumented sites go back to the no-op stubs.
    Recorded metrics stay in the registry (reset it explicitly)."""
    _set_enabled(False)


def refresh_from_env():
    """Re-resolve MXNET_TELEMETRY (for tests that monkeypatch the env)."""
    global _enabled
    _enabled = None
    return enabled()


def span(name, **tags):
    """Timed, nestable tracing region; see spans.Span. The shared no-op
    span while both telemetry and tracing are off; a trace-only span (no
    registry or profiler sinks) when only MXTPU_TRACE_DIR is set."""
    if enabled():
        return Span(name, tags)
    if distributed.trace_active():
        return Span(name, tags, metrics=False)
    return NOOP_SPAN


# -- registry conveniences (always live; instrument through the helpers
#    below when the call must be free while disabled) -----------------------

def counter(name, help=""):
    return REGISTRY.counter(name, help)


def gauge(name, help=""):
    return REGISTRY.gauge(name, help)


def histogram(name, help="", buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help, buckets)


# -- guarded fast-path helpers for instrumented sites -------------------------

def inc(name, amount=1.0, help="", **labels):
    if not enabled():
        return
    REGISTRY.counter(name, help).inc(amount, **labels)


def observe(name, value, help="", buckets=DEFAULT_BUCKETS, **labels):
    if not enabled():
        return
    REGISTRY.histogram(name, help, buckets).observe(value, **labels)


def set_gauge(name, value, help="", **labels):
    if not enabled():
        return
    REGISTRY.gauge(name, help).set(value, **labels)
