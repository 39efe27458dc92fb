"""Profiler (`incubator_mxnet_tpu/profiler.py`): the reference's
set_config / set_state("run" | "stop") / dump, the per-op aggregate
table (`dumps`), the Task / Frame / Event / Domain / Counter / Marker
objects, and the per-program memory table, over `torch.profiler`.

One profiler session at a time: Kineto takes one per process, and a
caller may open its own (`torch.profiler.profile`) around a window that
`set_state("run")` marks. So `set_state("run")` opens no session by
itself. It marks the window running; telemetry spans then annotate
whatever session is open (`scope`, a `record_function` range). The
port's own session (CPU and, with a card, CUDA activities) opens lazily,
at the first registry op dispatched in the window (`nd.<op>` or
`F.<op>`), and only if no session is open already; a window inside a
caller's session shares it and writes no trace of its own.
`set_state("stop")` (or `dump()`) closes the port's session and writes
its chrome trace to `<filename stem>_trace/trace.json`.

With `aggregate_stats=True` in the running window each registry op is
timed into the aggregate table with the device synchronized after it
(its real device time, at the cost of the overlap), and telemetry spans
charge their durations to the same table, as in the JAX package.
`pause()` stops the table from recording until `resume()`.

Where the JAX package reads a compiled program's memory analysis from
XLA, the port's caller measures its own (`GluonTrainStep.memory_stats`,
`memory_analysis` here) and hands the numbers to `record_memory`.
"""
from __future__ import annotations

import os
import time

import torch

__all__ = [
    "set_config", "set_state", "dump", "dumps", "pause", "resume", "Task",
    "Frame", "Event", "Counter", "Marker", "Domain", "scope",
    "aggregate_enabled", "timed_invoke", "record_duration", "reset_stats",
    "memory_analysis", "record_memory", "dumps_memory",
]

_CONFIG = {"filename": "profile.json", "profile_all": False,
           "aggregate_stats": False}
# running: a window is open; paused: the aggregate table records nothing;
# session: the port's own torch.profiler session, opened lazily
_STATE = {"running": False, "paused": False, "dir": None, "session": None}
_MEM_STATS = {}  # program name -> its memory breakdown
_MEM_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
             "code_bytes")


def set_config(**kwargs):
    """The reference's keyword settings: `filename` names the trace
    directory (`<stem>_trace/`); `aggregate_stats=True` records the
    per-op table `dumps()` prints."""
    _CONFIG.update(kwargs)


def set_state(state="stop", profile_process="worker"):
    """"run" opens a profiling window; "stop" closes it (and the port's
    session, writing its trace)."""
    if state not in ("run", "stop"):
        raise ValueError(f"state must be 'run' or 'stop', got {state!r}")
    if state == "run" and not _STATE["running"]:
        stem = os.path.splitext(_CONFIG.get("filename", "profile.json"))[0]
        _STATE.update(running=True, paused=False, dir=stem + "_trace")
        _register().profile_F(True)
    elif state == "stop" and _STATE["running"]:
        _STATE["running"] = False
        _register().profile_F(False)
        session, _STATE["session"] = _STATE["session"], None
        if session is not None:
            session.stop()
            os.makedirs(_STATE["dir"], exist_ok=True)
            session.export_chrome_trace(os.path.join(_STATE["dir"],
                                                     "trace.json"))


def _register():
    # imported here: ndarray.register imports this module
    from .ndarray import register

    return register


def dump(finished=True, profile_process="worker"):
    """Close a running window; returns its trace directory."""
    if _STATE["running"]:
        set_state("stop")
    return _STATE["dir"]


def pause(profile_process="worker"):
    """Stop recording into the aggregate table until `resume()`."""
    _STATE["paused"] = True


def resume(profile_process="worker"):
    _STATE["paused"] = False


def _ensure_session():
    """Open the port's session for the running window unless one (the
    port's or a caller's) is open already."""
    if _STATE["session"] is not None or torch.autograd._profiler_enabled():
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    session = torch.profiler.profile(activities=activities)
    session.start()
    _STATE["session"] = session


def scope(name):
    """Annotation context for the running window: a named range on the
    torch.profiler timeline."""
    return torch.profiler.record_function(name)


# -- the per-op aggregate table (the reference's aggregate_stats.cc) --------

class _OpStat:
    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def add(self, dur):
        self.count += 1
        self.total += dur
        self.min = min(self.min, dur)
        self.max = max(self.max, dur)


_AGG_STATS: dict[str, _OpStat] = {}


def aggregate_enabled():
    return (_STATE["running"] and not _STATE["paused"]
            and _CONFIG.get("aggregate_stats", False))


def _sync(results):
    """Wait for the cards the results live on."""
    outs = results if isinstance(results, (list, tuple)) else [results]
    for r in outs:
        data = getattr(r, "_data", r)
        if torch.is_tensor(data) and data.is_cuda:
            torch.cuda.synchronize(data.device)


def timed_invoke(op_name, call, *args, **kwargs):
    """Run `call`, wait for its outputs' device, and charge the wall time
    to `op_name` in the aggregate table."""
    t0 = time.perf_counter()
    results = call(*args, **kwargs)
    _sync(results)
    record_duration(op_name, time.perf_counter() - t0)
    return results


def profiled_call(op_name, call, *args, **kwargs):
    """A registry op dispatched inside a running window: the port's
    session opened if none is, the op a named range on its timeline, and
    timed into the aggregate table when that is on."""
    _ensure_session()
    with torch.profiler.record_function(op_name):
        if aggregate_enabled():
            return timed_invoke(op_name, call, *args, **kwargs)
        return call(*args, **kwargs)


def record_duration(op_name, dur):
    """Charge `dur` seconds to `op_name` in the aggregate table (also the
    sink telemetry spans feed while aggregate stats are on)."""
    _AGG_STATS.setdefault(op_name, _OpStat()).add(dur)


def reset_stats():
    _AGG_STATS.clear()
    _MEM_STATS.clear()


def dumps(reset=False, sort_by="total", ascending=False):
    """The per-op aggregate table: Name, Count, Time total/min/max/avg in
    ms."""
    key = {
        "total": lambda kv: kv[1].total,
        "count": lambda kv: kv[1].count,
        "min": lambda kv: kv[1].min,
        "max": lambda kv: kv[1].max,
        "avg": lambda kv: kv[1].total / max(kv[1].count, 1),
    }.get(sort_by)
    if key is None:
        raise ValueError(
            f"sort_by must be total/count/min/max/avg, got {sort_by}")
    rows = sorted(_AGG_STATS.items(), key=key, reverse=not ascending)
    lines = [
        "Profile Statistics:",
        f"{'Name':<40s} {'Count':>8s} {'Total(ms)':>12s} {'Min(ms)':>10s} "
        f"{'Max(ms)':>10s} {'Avg(ms)':>10s}",
        "-" * 94,
    ]
    if not rows:
        lines.append("(no ops recorded)")
    for name, s in rows:
        avg = s.total / max(s.count, 1)
        mn = 0.0 if s.count == 0 else s.min
        lines.append(
            f"{name[:40]:<40s} {s.count:>8d} {s.total * 1e3:>12.3f} "
            f"{mn * 1e3:>10.3f} {s.max * 1e3:>10.3f} {avg * 1e3:>10.3f}")
    if reset:
        reset_stats()
    return "\n".join(lines)


# -- the per-program memory table --------------------------------------------

def record_memory(name, stats):
    """Record one program's device memory breakdown under `name` for
    `dumps_memory()`, with the JAX package's keys: `argument_bytes`,
    `output_bytes`, `temp_bytes`, `alias_bytes` and `code_bytes` from
    `stats` (0 where absent) and `peak_bytes` = arguments + outputs +
    temporaries - aliased bytes (what is written in place counts once).
    Returns the recorded dict."""
    out = {k: int(stats.get(k, 0)) for k in _MEM_KEYS}
    out["peak_bytes"] = (out["argument_bytes"] + out["output_bytes"]
                         + out["temp_bytes"] - out["alias_bytes"])
    _MEM_STATS[name] = out
    return out


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)
    elif hasattr(tree, "_data"):
        yield from _tensors(tree._data)


def memory_analysis(fn, *args, name=None, static_argnums=None):
    """Run `fn(*args)` once and record its device memory breakdown: the
    arguments' and outputs' bytes, and as temporaries the caching
    allocator's peak above the arguments and outputs during the call
    (0 on the CPU, which has no allocator statistics)."""
    tensors = list(_tensors(args))
    device = next((t.device for t in tensors if t.is_cuda), None)
    arg_bytes = sum(t.numel() * t.element_size() for t in tensors)
    if device is not None:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    out = fn(*args)
    outs = list(_tensors(out))
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    temp = 0
    if device is not None:
        torch.cuda.synchronize(device)
        temp = max(torch.cuda.max_memory_allocated(device) - base
                   - out_bytes, 0)
    return record_memory(name or getattr(fn, "__name__", "program"),
                         {"argument_bytes": arg_bytes,
                          "output_bytes": out_bytes, "temp_bytes": temp})


def dumps_memory():
    """Formatted per-program memory table, the largest peak first."""
    lines = [
        "Memory Statistics (per compiled program):",
        f"{'Name':<32s} {'Peak(MiB)':>10s} {'Args(MiB)':>10s} "
        f"{'Out(MiB)':>9s} {'Temp(MiB)':>10s} {'Alias(MiB)':>10s}",
        "-" * 85,
    ]
    mib = 1024.0 * 1024.0
    for name, s in sorted(_MEM_STATS.items(),
                          key=lambda kv: -kv[1]["peak_bytes"]):
        lines.append(
            f"{name[:32]:<32s} {s['peak_bytes'] / mib:>10.2f} "
            f"{s['argument_bytes'] / mib:>10.2f} "
            f"{s['output_bytes'] / mib:>9.2f} "
            f"{s['temp_bytes'] / mib:>10.2f} "
            f"{s['alias_bytes'] / mib:>10.2f}")
    return "\n".join(lines)


# -- instrumentation objects (the reference's profiler.h) -------------------

class _Annotated:
    """A named range on the profiler timeline between `start()` and
    `stop()`; constructed as (name) or (domain, name)."""

    def __init__(self, name, *a, **kw):
        self.domain = None
        if isinstance(name, Domain):
            self.domain = name
            if a:
                name = a[0]
            elif "name" in kw:
                name = kw["name"]
            else:
                raise TypeError(
                    f"{type(self).__name__}(domain, name): name is required")
        self.name = name
        self._ctx = None

    def start(self):
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()

    def stop(self):
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class Task(_Annotated):
    """A task range (the reference's ProfileTask)."""


class Frame(_Annotated):
    """A frame range (ProfileFrame)."""


class Event(_Annotated):
    """An event range (ProfileEvent)."""


class Domain:
    """Instrumentation namespace grouping Tasks / Counters / Markers."""

    def __init__(self, name):
        self.name = name

    def new_counter(self, name, value=None):
        return Counter(self, name, value or 0)

    def new_task(self, name):
        return Task(self, name)

    def new_marker(self, name):
        return Marker(self, name)

    def __repr__(self):
        return f"Domain(name={self.name})"


class Counter:
    """A host-side counter (ProfileCounter)."""

    def __init__(self, domain, name, value=0):
        self.domain = domain
        self.name = name
        self.value = value

    def set_value(self, value):
        self.value = value

    def increment(self, delta=1):
        self.value += delta

    def decrement(self, delta=1):
        self.value -= delta

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


class Marker:
    """An instant marker: a zero-length range on the timeline."""

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        with torch.profiler.record_function(self.name):
            pass
