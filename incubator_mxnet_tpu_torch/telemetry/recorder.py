"""Always-on flight recorder: a black box for post-mortem debugging.

A fixed-size ring buffer of structured events — span boundaries, RPC
retries, reconnects, quorum evictions, checkpoint writes, injected
faults — that records continuously at ~zero cost and is only ever *read*
when something dies. On an uncaught exception (process or thread), on
retry exhaustion, or when `resilience` evicts a rank, the ring is dumped
as one JSON file together with a full metrics snapshot and the resolved
config knobs: everything needed to reconstruct the last N events before
the failure without having had DEBUG logging on.

Lock-free under the GIL: each event claims a monotonically increasing
sequence number from `itertools.count()` (a single atomic bytecode) and
stores `(seq, event)` into `slots[seq % capacity]` — one list-item store,
no lock, no allocation beyond the event dict itself. A reader sorts the
occupied slots by seq; a slot being overwritten mid-snapshot yields a
newer event, never a torn one.

The port's copy of the JAX package's recorder
(`incubator_mxnet_tpu/telemetry/recorder.py`), its locks named for the
lock sanitizer (`analysis.sanitizers.san_lock`) as there.

Knobs: `MXTPU_FLIGHT_RECORDER_EVENTS` (capacity; 0 disables),
`MXTPU_FLIGHT_RECORDER_DIR` (dump destination, falls back to
`MXTPU_TRACE_DIR`; empty = never write files, the ring still records),
`MXTPU_FLIGHT_RECORDER_MAX_DUMPS` (per-process dump cap).
"""
from __future__ import annotations

import itertools
import json
import os
import re
import sys
import threading
import time

from ..analysis.sanitizers import san_lock

__all__ = [
    "FlightRecorder", "log_event", "snapshot", "dump", "recording",
    "refresh_from_env", "install_hooks",
]

_DUMPS_TOTAL = "mxtpu_flight_recorder_dumps_total"
_DUMPS_HELP = ("Post-mortem flight-recorder dump files written, by reason "
               "(uncaught-exception, retry-exhausted-*, eviction, ...).")


class FlightRecorder:
    """The ring itself — usable standalone in tests; the module-level
    `log_event()`/`snapshot()`/`dump()` drive one process-wide instance."""

    __slots__ = ("capacity", "_slots", "_seq")

    def __init__(self, capacity):
        self.capacity = int(capacity)
        self._slots = [None] * self.capacity
        self._seq = itertools.count()

    def record(self, event):
        seq = next(self._seq)
        self._slots[seq % self.capacity] = (seq, event)
        return seq

    def snapshot(self):
        """Events currently in the ring, oldest first."""
        held = [s for s in list(self._slots) if s is not None]
        held.sort()
        return [event for _seq, event in held]

    def total_recorded(self):
        """Events ever recorded (>= len(snapshot()) once wrapped)."""
        held = [seq for seq in (s[0] for s in list(self._slots) if s)] or [-1]
        return max(held) + 1


_state_lock = san_lock("telemetry.recorder_state")
_ring = None          # FlightRecorder, False when capacity == 0, None unresolved
_dump_lock = san_lock("telemetry.recorder_dump")
_dumps_written = 0
_hooks_installed = False


def _get_ring():
    r = _ring
    if r is None:
        from .. import config as _config

        with _state_lock:
            if _ring is None:
                cap = _config.get("MXTPU_FLIGHT_RECORDER_EVENTS")
                globals()["_ring"] = FlightRecorder(cap) if cap > 0 else False
                if _ring:
                    install_hooks()
            r = _ring
    return r


def recording():
    """Whether the ring is active (capacity > 0)."""
    return bool(_get_ring())


def refresh_from_env():
    """Re-resolve the recorder knobs and start an empty ring (tests that
    monkeypatch env). Does not uninstall exception hooks — they are
    idempotent and chain to the previous hook anyway."""
    global _ring, _dumps_written
    with _state_lock:
        _ring = None
        _dumps_written = 0
    return recording()


def log_event(kind, **fields):
    """Append one structured event to the ring. This is THE entry point
    for framework event logging — resilience retries, PS reconnects,
    evictions, checkpoint writes, injected faults all come through here,
    so the crash dump and any future structured-log exporter see one
    schema: `{"ts": epoch_ns, "kind": ..., "lane": ..., **fields}`."""
    ring = _get_ring()
    if not ring:
        return None
    from . import distributed as _distributed

    event = {"ts": time.time_ns(), "kind": kind,
             "lane": _distributed.current_lane()}
    if fields:
        event.update(fields)
    ring.record(event)
    return event


def snapshot():
    """Events currently held by the process-wide ring, oldest first."""
    ring = _get_ring()
    return ring.snapshot() if ring else []


def _dump_dir():
    from .. import config as _config

    return (_config.get("MXTPU_FLIGHT_RECORDER_DIR")
            or _config.get("MXTPU_TRACE_DIR"))


def dump(reason, extra=None):
    """Write the post-mortem dump: ring contents + metrics snapshot +
    resolved config knobs. `extra` (a JSON-serializable dict) is merged
    into the payload top-level — the SLO monitor rides it to attach the
    last-N request timelines to a breach dump. Returns the path, or None
    when no destination directory is configured (the common interactive
    case — the ring is always recording, but files appear only where a
    dump dir was chosen) or the per-process dump cap is spent."""
    global _dumps_written
    directory = _dump_dir()
    if not directory:
        return None
    from .. import config as _config

    with _dump_lock:
        if _dumps_written >= _config.get("MXTPU_FLIGHT_RECORDER_MAX_DUMPS"):
            return None
        _dumps_written += 1
        seq = _dumps_written
    from . import distributed as _distributed
    from .exporters import to_dict
    from .metrics import REGISTRY

    slug = re.sub(r"[^A-Za-z0-9._-]+", "-", str(reason))[:64] or "unknown"
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(
        directory, f"flightrec-{os.getpid()}-{seq}-{slug}.json")
    ring = _get_ring()
    payload = {
        "schema": "mxtpu-flight-recorder-v1",
        "reason": str(reason),
        "pid": os.getpid(),
        "lane": _distributed.current_lane(),
        "time_ns": time.time_ns(),
        "events_recorded_total": ring.total_recorded() if ring else 0,
        "events": ring.snapshot() if ring else [],
        "metrics": to_dict(),
        "config": {name: _config.get(name)
                   for name in sorted(_config.KNOBS)},
    }
    if extra:
        for key, value in extra.items():
            payload.setdefault(key, value)  # core schema keys win
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, separators=(",", ":"), sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    REGISTRY.counter(_DUMPS_TOTAL, _DUMPS_HELP).inc(1, reason=slug)
    return path


# -- fault hooks -------------------------------------------------------------

def install_hooks():
    """Chain the flight recorder into sys.excepthook / threading.excepthook
    so an uncaught exception anywhere dumps the black box before the
    interpreter's (or the previously installed) handler runs. Idempotent;
    installed automatically the first time the ring activates."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True

    prev_sys = sys.excepthook

    def _sys_hook(exc_type, exc, tb):
        try:
            log_event("uncaught_exception",
                      exc=getattr(exc_type, "__name__", str(exc_type)))
            dump("uncaught-exception")
        except Exception:
            pass  # the black box must never mask the original failure
        prev_sys(exc_type, exc, tb)

    sys.excepthook = _sys_hook

    prev_thread = threading.excepthook

    def _thread_hook(args):
        try:
            log_event(
                "uncaught_exception",
                exc=getattr(args.exc_type, "__name__", str(args.exc_type)),
                thread=args.thread.name if args.thread else "?")
            dump("uncaught-thread-exception")
        except Exception:
            pass
        prev_thread(args)

    threading.excepthook = _thread_hook
