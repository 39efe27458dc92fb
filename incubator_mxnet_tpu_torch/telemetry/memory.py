"""Device and host memory watermarks, sampled at step boundaries
(`incubator_mxnet_tpu/telemetry/memory.py`).

Each visible card is read through `torch.cuda.memory_stats()`: the
caching allocator's `allocated_bytes.all.current` is the card's bytes in
use (what `torch.cuda.memory_allocated()` answers) and
`allocated_bytes.all.peak` its high-water mark, under `device="cuda:N"`.
The host process is always sampled (current RSS from /proc/self/statm,
peak from ru_maxrss) under `device="host"`, so a memory series exists on
a machine without a card, as the JAX package's does on its CPU backend.
The gauge and counter names are the JAX package's.
"""
from __future__ import annotations

import os
import threading

import torch

from .metrics import REGISTRY

__all__ = ["sample_device_memory", "step_boundary"]

BYTES_IN_USE = "mxtpu_device_bytes_in_use"
PEAK_BYTES = "mxtpu_device_peak_bytes_in_use"
STEPS_TOTAL = "mxtpu_trainer_steps_total"

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

_step_lock = threading.Lock()
_step_count = 0


def _host_bytes():
    """(current_rss, peak_rss) in bytes; (None, None) if unreadable."""
    current = peak = None
    try:
        with open("/proc/self/statm") as f:
            current = int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (ImportError, OSError):
        pass
    return current, peak


def sample_device_memory(registry=None):
    """Record per-device bytes-in-use gauges and peak watermarks; returns
    the set of device labels sampled."""
    registry = registry or REGISTRY
    in_use = registry.gauge(
        BYTES_IN_USE, "Allocator bytes currently in use, per device "
        "(host RSS under device=\"host\").")
    peak = registry.gauge(
        PEAK_BYTES, "High-watermark of bytes in use, per device.")
    sampled = set()
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue  # a card this process never touched
            label = f"cuda:{i}"
            b = stats.get("allocated_bytes.all.current")
            if b is not None:
                in_use.set(b, device=label)
                sampled.add(label)
            pk = stats.get("allocated_bytes.all.peak", b)
            if pk is not None:
                peak.set_max(pk, device=label)
    current, peak_rss = _host_bytes()
    if current is not None:
        in_use.set(current, device="host")
        sampled.add("host")
    if peak_rss is not None:
        peak.set_max(peak_rss, device="host")
    return sampled


def step_boundary(registry=None):
    """Called by Trainer.step (when telemetry is enabled): bump the step
    counter and sample memory every MXNET_TELEMETRY_MEM_INTERVAL steps.
    The JAX package also samples its HBM ledger here; the port's ledger
    keeps no step samples."""
    global _step_count
    from .. import config as _config

    registry = registry or REGISTRY
    registry.counter(STEPS_TOTAL, "Trainer.step invocations.").inc()
    with _step_lock:
        _step_count += 1
        n = _step_count
    interval = _config.get("MXNET_TELEMETRY_MEM_INTERVAL")
    if interval > 0 and n % interval == 0:
        sample_device_memory(registry)
