"""Profiler state that telemetry spans read, and the per-program memory
table.

The parts of the JAX package's `profiler.py` that the port's callers
need: whether a profiling window is running (`_STATE["running"]`) and
the annotation a span opens inside it (`scope`), which
`telemetry/spans.py` reads; and `record_memory` / `dumps_memory`, the
per-program memory breakdown `GluonTrainStep.memory_stats` records.

In PyTorch the trace window is the caller's `torch.profiler.profile`;
`set_state("run")` only marks that one is open, so spans annotate it with
`torch.profiler.record_function` and show up by name on its timeline.
Where the JAX package reads a compiled program's memory analysis from
XLA, the port's caller measures its own (see
`GluonTrainStep.memory_stats`) and hands the numbers to `record_memory`.
The rest of the JAX profiler (the per-name aggregate table, trace files,
Task/Frame/Event/Counter objects) is not ported.
"""
from __future__ import annotations

import torch

__all__ = ["set_state", "scope", "record_memory", "dumps_memory"]

_STATE = {"running": False}
_MEM_STATS = {}  # program name -> its memory breakdown
_MEM_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
             "code_bytes")


def set_state(state="stop"):
    """"run" marks a profiling window open (spans then annotate it);
    "stop" closes it."""
    if state not in ("run", "stop"):
        raise ValueError(f"state must be 'run' or 'stop', got {state!r}")
    _STATE["running"] = state == "run"


def scope(name):
    """Annotation context for the running window: a named range on the
    torch.profiler timeline."""
    return torch.profiler.record_function(name)


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
