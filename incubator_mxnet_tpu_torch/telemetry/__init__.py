"""Metrics for the port: the counter/gauge/histogram registry and the
`inc` / `set_gauge` / `observe` helpers the serving engine calls.

Off by default. `MXNET_TELEMETRY=1` (or `enable()`) turns it on; while
off every helper returns before touching the registry, so the cost is
one cached boolean check per site. Spans, request tracing, SLOs,
exporters and debug endpoints are not ported yet.
"""
from __future__ import annotations

import threading

from .. import config as _config
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, REGISTRY, DEFAULT_BUCKETS,
)

__all__ = ["enabled", "enable", "refresh_from_env", "inc",
           "observe", "set_gauge", "REGISTRY", "Counter", "Gauge",
           "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS"]

_state_lock = threading.Lock()
_enabled = None  # None = not yet resolved from MXNET_TELEMETRY


def enabled():
    """Master switch; the first call resolves MXNET_TELEMETRY."""
    e = _enabled
    if e is None:
        e = _set_enabled(bool(_config.get("MXNET_TELEMETRY")))
    return e


def _set_enabled(value):
    global _enabled
    with _state_lock:
        _enabled = bool(value)
        return _enabled


def enable():
    """Turn telemetry on for this process (overrides the env default)."""
    _set_enabled(True)


def refresh_from_env():
    """Re-resolve MXNET_TELEMETRY (for tests that monkeypatch the env)."""
    global _enabled
    _enabled = None
    return enabled()


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
