"""Capture registry: every CUDA graph the port captures, by named site
and shape signature.

The port's counterpart of the JAX package's compile registry
(`incubator_mxnet_tpu/telemetry/compilereg.py`), with its API, counters
and flight-recorder events. Where the JAX package jits one executable per
(function, abstract signature), the port captures one CUDA graph per
(site, signature) (`graphs.wrap`): here a "compile" is one capture, and
`compile_s` is the capture time (its warm-up runs included). On the CPU,
where there is no graph, it is the first eager call of a site for a
signature, so the counters are the same on both devices.

Two events are distinguished:

- first signature for a site -> `mxtpu_compiles_total{fn=}` (+ a
  `compile` flight event);
- a NEW signature for an already-seen site -> additionally
  `mxtpu_retraces_total{fn=}` and a `retrace` flight event naming the
  shape delta (old vs new, per differing position).

Re-registering an already-seen signature is free and counts nothing, so
a steady state that replays its graphs registers zero events: the
`steady_compiles` / `steady_retraces` counters of the serving trace are
deltas of this registry.

All entry points return immediately while telemetry is disabled.
"""
from __future__ import annotations

import hashlib
import threading
import time

from .metrics import REGISTRY
from . import recorder as _recorder

__all__ = ["register", "register_cached", "seen", "annotate",
           "signature_of", "snapshot", "reset", "COMPILES_TOTAL",
           "RETRACES_TOTAL", "COMPILE_SECONDS"]

COMPILES_TOTAL = "mxtpu_compiles_total"
_COMPILES_HELP = ("New (function, shape-signature) pairs registered with "
                  "the compile registry, by fn.")
RETRACES_TOTAL = "mxtpu_retraces_total"
_RETRACES_HELP = ("Recompilations of an already-seen function with a NEW "
                  "shape signature, by fn (each also logs a retrace flight "
                  "event naming the shape delta).")
COMPILE_SECONDS = "mxtpu_compile_seconds"
_COMPILE_S_HELP = ("Trace+compile wall time observed for first-seen shape "
                   "signatures, by fn.")
# compiles run seconds-to-minutes, far past the latency default buckets
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, 120.0, 300.0)

_lock = threading.Lock()
_fns = {}   # fn -> {"order": [sig, ...], "entries": {sig: info}, "retraces": n}

_enabled_fn = None


def _on():
    global _enabled_fn
    fn = _enabled_fn
    if fn is None:
        from . import enabled as fn
        _enabled_fn = fn
    return fn()


def _dtype_name(dt):
    """Canonical dtype spelling: np.dtype('float32').name == 'float32'
    whether the caller held a dtype object, a scalar type, or a string —
    `str(np.float32)` would spell the same dtype three different ways
    and fork the cross-process cache key."""
    name = getattr(dt, "name", None)
    if isinstance(name, str):
        return name
    return getattr(dt, "__name__", None) or str(dt)


def _canon(v):
    """One value -> a canonical, repr-stable signature element. Dicts
    hash by SORTED key (insertion order is a per-process accident);
    containers recurse; arrays collapse to (shape, dtype-name)."""
    if v is None:
        return None
    if isinstance(v, type):
        # scalar types (np.float32) expose a class-level `shape`
        # descriptor — canonicalize dtype-like classes by name instead
        return ("dtype", _dtype_name(v))
    name = getattr(v, "name", None)
    if isinstance(name, str) and getattr(v, "kind", None) is not None:
        # np.dtype instances (duck-typed: .name + .kind, no numpy import)
        return ("dtype", name)
    if hasattr(v, "shape"):
        dt = getattr(v, "dtype", None)
        return (tuple(v.shape), _dtype_name(dt) if dt is not None else "?")
    if isinstance(v, dict):
        return ("dict", tuple(
            (str(k), _canon(v[k])) for k in sorted(v, key=str)))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_canon(x) for x in v))
    if isinstance(v, (bool, int, float, str, bytes)):
        return (type(v).__name__, repr(v))
    return (type(v).__name__,)


def signature_of(*arrays):
    """Canonical abstract signature of positional args: (shape,
    dtype-name) per array, sorted-key tuples for dicts, values for
    plain scalars (None placeholders pass through). repr() of the
    result is identical across processes for the same program — the
    property the persistent compile-cache key requires."""
    return tuple(_canon(a) for a in arrays)


def _fmt_sig(sig):
    s = repr(sig)
    return s if len(s) <= 256 else s[:253] + "..."


def _sig_delta(old, new):
    """Human-readable positional diff between two signatures."""
    if (isinstance(old, tuple) and isinstance(new, tuple)
            and len(old) == len(new)):
        diffs = [f"arg{i}: {o!r} -> {n!r}"
                 for i, (o, n) in enumerate(zip(old, new)) if o != n]
        if diffs:
            return "; ".join(diffs)[:512]
    return f"{_fmt_sig(old)} -> {_fmt_sig(new)}"


def seen(fn, signature):
    """True when (fn, signature) is already registered — callers use this
    to decide whether a dispatch they are about to time is a compile."""
    if not _on():
        return True
    with _lock:
        entry = _fns.get(fn)
        return entry is not None and signature in entry["entries"]


def register(fn, signature, compile_s=None, graph_hash=None, cost=None):
    """Record that `fn` was traced/compiled for `signature`. Returns
    "new" (first signature for fn), "retrace" (new signature, fn already
    seen — counted and flight-logged), or "seen" (no-op)."""
    if not _on():
        return None
    if graph_hash is None:
        # signature-derived default; callers with a real graph fingerprint
        # pass their own
        graph_hash = hashlib.sha1(repr((fn, signature)).encode()).hexdigest()[:16]
    with _lock:
        entry = _fns.setdefault(
            fn, {"order": [], "entries": {}, "retraces": 0})
        if signature in entry["entries"]:
            return "seen"
        prev = entry["order"][-1] if entry["order"] else None
        entry["order"].append(signature)
        entry["entries"][signature] = {
            "graph_hash": graph_hash, "compile_s": compile_s, "cost": cost,
            "ts_ns": time.time_ns()}
        is_retrace = prev is not None
        if is_retrace:
            entry["retraces"] += 1
        n_sigs = len(entry["entries"])
    REGISTRY.counter(COMPILES_TOTAL, _COMPILES_HELP).inc(fn=fn)
    if compile_s is not None:
        REGISTRY.histogram(COMPILE_SECONDS, _COMPILE_S_HELP,
                           buckets=COMPILE_BUCKETS).observe(
            float(compile_s), fn=fn)
    if is_retrace:
        REGISTRY.counter(RETRACES_TOTAL, _RETRACES_HELP).inc(fn=fn)
        _recorder.log_event(
            "retrace", fn=fn, delta=_sig_delta(prev, signature),
            signatures=n_sigs, graph_hash=graph_hash,
            compile_s=compile_s)
        return "retrace"
    _recorder.log_event(
        "compile", fn=fn, signature=_fmt_sig(signature),
        graph_hash=graph_hash, compile_s=compile_s)
    return "new"


def register_cached(fn, signature, graph_hash=None):
    """Record that `fn` resolved `signature` from a persistent cache: the
    signature becomes known (so `seen()` is True and snapshot() lists it
    with cached=True) WITHOUT counting a compile or retrace. The JAX
    package's compile cache calls it; the port has no persistent graph
    cache yet, and keeps the entry point for one.
    Returns "cached", or "seen" when already registered."""
    if not _on():
        return None
    if graph_hash is None:
        graph_hash = hashlib.sha1(
            repr((fn, signature)).encode()).hexdigest()[:16]
    with _lock:
        entry = _fns.setdefault(
            fn, {"order": [], "entries": {}, "retraces": 0})
        if signature in entry["entries"]:
            return "seen"
        entry["order"].append(signature)
        entry["entries"][signature] = {
            "graph_hash": graph_hash, "compile_s": None, "cost": None,
            "cached": True, "ts_ns": time.time_ns()}
    _recorder.log_event(
        "compile_cache_hit", fn=fn, signature=_fmt_sig(signature),
        graph_hash=graph_hash)
    return "cached"


def annotate(fn, signature=None, compile_s=None, cost=None):
    """Attach late-arriving data (cost stats, a measured capture
    time) to a registered signature — the most recent one when
    `signature` is None."""
    if not _on():
        return False
    with _lock:
        entry = _fns.get(fn)
        if entry is None or not entry["order"]:
            return False
        sig = signature if signature is not None else entry["order"][-1]
        info = entry["entries"].get(sig)
        if info is None:
            return False
        if compile_s is not None:
            info["compile_s"] = float(compile_s)
        if cost is not None:
            info["cost"] = dict(cost)
    return True


def snapshot():
    """{fn: {"signatures": n, "retraces": n, "entries": [info...]}} —
    entries carry graph_hash / compile_s / cost / ts_ns per signature."""
    with _lock:
        out = {}
        for fn, entry in _fns.items():
            out[fn] = {
                "signatures": len(entry["entries"]),
                "retraces": entry["retraces"],
                "entries": [
                    {"signature": _fmt_sig(sig), **entry["entries"][sig]}
                    for sig in entry["order"]],
            }
        return out


def reset():
    """Forget every registered executable (tests)."""
    with _lock:
        _fns.clear()
