"""Profiler state that telemetry spans read.

The part of the JAX package's `profiler.py` that `telemetry/spans.py`
needs: whether a profiling window is running (`_STATE["running"]`) and
the annotation a span opens inside it (`scope`).

In PyTorch the trace window is the caller's `torch.profiler.profile`;
`set_state("run")` only marks that one is open, so spans annotate it with
`torch.profiler.record_function` and show up by name on its timeline.
The rest of the JAX profiler (the per-name aggregate table, trace files,
Task/Frame/Event/Counter objects, memory analysis) is not ported.
"""
from __future__ import annotations

import torch

__all__ = ["set_state", "scope"]

_STATE = {"running": False}


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
