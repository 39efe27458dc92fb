"""Step-time decomposition: rolling per-phase stats + anomaly events.

The port's copy of the JAX package's `telemetry/stepstats.py`, with its
names and semantics. A train step's host time splits into phases (for
`GluonTrainStep`: `h2d`, the input copies to the device, and `dispatch`,
the forward, backward and update enqueued or a graph replayed). This
module aggregates those phases over a rolling window
(`MXNET_TELEMETRY_STEPSTATS_WINDOW`), exposes per-phase p50/p99 gauges
(`mxtpu_step_phase_seconds{phase=,q=}`), and emits a flight-recorder
`step_anomaly` event when a step exceeds
`MXNET_TELEMETRY_ANOMALY_FACTOR` x the rolling median of recent steps.

Phases are fed two ways:

- ``phase(name)`` — context manager that times a region, opens a
  ``trainer.phase`` span (so traces and flight events line up with the
  breakdown), and accumulates into the current step. Sites that nest
  phases double-count; keep phases flat.
- ``record(name, seconds)`` — for sites that already measured.

``step_end()`` closes the current step; `GluonTrainStep` calls it per
``__call__``. Without an explicit total it uses wall time since the
previous step end, so the breakdown denominator is the full loop
iteration — phase coverage (phase sum / total) then measures how much of
the real step the instrumentation explains. The phases are host time:
the device runs behind the host's enqueue.

Everything here is a no-op while telemetry is disabled: zero registry
writes, zero recorder events.
"""
from __future__ import annotations

import collections
import threading
import time

from .. import config as _config
from .metrics import REGISTRY
from .spans import Span
from . import distributed as _distributed
from . import recorder as _recorder

__all__ = ["phase", "record", "step_end", "snapshot", "reset",
           "PHASE_SPAN", "PHASE_GAUGE", "ANOMALIES_TOTAL"]

PHASE_SPAN = "trainer.phase"
PHASE_GAUGE = "mxtpu_step_phase_seconds"
_PHASE_HELP = ("Rolling per-phase step-time quantiles from StepStats, by "
               "phase and quantile (q=0.5/0.99); phase=total is the whole "
               "step.")
ANOMALIES_TOTAL = "mxtpu_step_anomalies_total"
_ANOM_HELP = ("Steps whose wall time exceeded MXNET_TELEMETRY_ANOMALY_FACTOR"
              " x the rolling median (each also logs a step_anomaly flight "
              "event).")

# canonical phase names (open set — these are the framework-fed ones).
# sparse_pull is the time a step BLOCKED waiting for embedding rows from
# the PS fleet: with MXTPU_SPARSE_PREFETCH the background thread absorbs
# the RPC wall time and this phase shrinks toward zero — the direct
# observatory readout of the pull/forward overlap win.
PHASES = ("data_fetch", "h2d", "sparse_pull", "dispatch", "device_sync",
          "allreduce", "pushpull", "optimizer_update")

_lock = threading.Lock()
_acc = {}            # phase -> accumulated seconds, current step
_window = None       # deque of (total_s, {phase: s}); sized lazily
_last_end = None     # perf_counter at the previous step_end
_steps = 0
_anomalies = 0

_enabled_fn = None   # resolved lazily: the package defines enabled() after
                     # this module is imported


def _on():
    global _enabled_fn
    fn = _enabled_fn
    if fn is None:
        from . import enabled as fn
        _enabled_fn = fn
    return fn()


class _NoopPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_PHASE = _NoopPhase()


class _Phase:
    """Times a region, mirrors it as a trainer.phase span, and feeds the
    current step's accumulator (unless trace-only)."""

    __slots__ = ("name", "_span", "_feed", "_t0")

    def __init__(self, name, span, feed):
        self.name = name
        self._span = span
        self._feed = feed

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        if self._feed:
            record(self.name, dt)
        return self._span.__exit__(exc_type, exc, tb)


def phase(name):
    """Context manager for one step phase. No-op while both telemetry and
    distributed tracing are off; trace-only (span, no stats) when only
    MXTPU_TRACE_DIR is set."""
    if _on():
        return _Phase(name, Span(PHASE_SPAN, {"phase": name}), feed=True)
    if _distributed.trace_active():
        return _Phase(name, Span(PHASE_SPAN, {"phase": name}, metrics=False),
                      feed=False)
    return _NOOP_PHASE


def record(name, seconds):
    """Accumulate `seconds` into phase `name` of the current step (for
    sites that already hold a measurement)."""
    if not _on():
        return
    with _lock:
        _acc[name] = _acc.get(name, 0.0) + float(seconds)


def _get_window():
    global _window
    w = _window
    if w is None:
        size = max(2, int(_config.get("MXNET_TELEMETRY_STEPSTATS_WINDOW")))
        w = _window = collections.deque(maxlen=size)
    return w


def _quantile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def step_end(step_seconds=None):
    """Close the current step: roll the accumulated phases into the
    window, refresh the p50/p99 gauges, and check the anomaly guard.
    With `step_seconds=None` the total is wall time since the previous
    step_end (first step: sum of its phases)."""
    global _last_end, _steps, _anomalies
    if not _on():
        return
    now = time.perf_counter()
    with _lock:
        phases = dict(_acc)
        _acc.clear()
        if step_seconds is not None:
            total = float(step_seconds)
        elif _last_end is not None:
            total = now - _last_end
        else:
            total = sum(phases.values())
        _last_end = now
        win = _get_window()
        prior_totals = [t for t, _ in win]
        win.append((total, phases))
        snap = list(win)
        _steps += 1

    g = REGISTRY.gauge(PHASE_GAUGE, _PHASE_HELP)
    names = set()
    for _, ph in snap:
        names.update(ph)
    for name in names:
        vals = sorted(p.get(name, 0.0) for _, p in snap)
        g.set(_quantile(vals, 0.5), phase=name, q="0.5")
        g.set(_quantile(vals, 0.99), phase=name, q="0.99")
    totals = sorted(t for t, _ in snap)
    g.set(_quantile(totals, 0.5), phase="total", q="0.5")
    g.set(_quantile(totals, 0.99), phase="total", q="0.99")

    min_steps = int(_config.get("MXNET_TELEMETRY_ANOMALY_MIN_STEPS"))
    factor = float(_config.get("MXNET_TELEMETRY_ANOMALY_FACTOR"))
    if factor > 0 and len(prior_totals) >= min_steps:
        median = sorted(prior_totals)[len(prior_totals) // 2]
        if median > 0 and total > factor * median:
            with _lock:
                _anomalies += 1
            REGISTRY.counter(ANOMALIES_TOTAL, _ANOM_HELP).inc()
            _recorder.log_event(
                "step_anomaly", total_s=round(total, 6),
                median_s=round(median, 6), factor=factor,
                phases={k: round(v, 6) for k, v in sorted(phases.items())})


def snapshot():
    """Point-in-time view for benches/tests: per-phase quantiles over the
    window, phase coverage (mean of per-step phase-sum/total), counts."""
    with _lock:
        snap = list(_window) if _window is not None else []
        steps, anomalies = _steps, _anomalies
    out = {"steps": steps, "window": len(snap), "anomalies": anomalies,
           "phases": {}, "total": {}, "coverage": None}
    if not snap:
        return out
    names = set()
    for _, ph in snap:
        names.update(ph)
    for name in sorted(names):
        vals = sorted(p.get(name, 0.0) for _, p in snap)
        out["phases"][name] = {
            "p50": _quantile(vals, 0.5), "p99": _quantile(vals, 0.99),
            "mean": sum(vals) / len(vals)}
    totals = sorted(t for t, _ in snap)
    out["total"] = {"p50": _quantile(totals, 0.5),
                    "p99": _quantile(totals, 0.99),
                    "mean": sum(totals) / len(totals)}
    ratios = [sum(p.values()) / t for t, p in snap if t > 0]
    if ratios:
        out["coverage"] = sum(ratios) / len(ratios)
    return out


def reset():
    """Drop all rolling state (tests; also on registry reset)."""
    global _window, _last_end, _steps, _anomalies
    with _lock:
        _acc.clear()
        _window = None
        _last_end = None
        _steps = 0
        _anomalies = 0
