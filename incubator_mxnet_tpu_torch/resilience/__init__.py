"""Fault-tolerance layer: retry policies, deterministic fault injection,
crash-consistent checkpoint IO and preemption drains.

The port's copy of the JAX package's `resilience` package, with the same
knobs, fault sites, metric names and error messages:

- `retry`: `RetryPolicy` — exponential backoff with deterministic
  jitter, a per-attempt timeout, and an overall deadline, driven by the
  registered `MXTPU_RETRY_*` knobs, so chaos runs are tunable from one
  place.
- `fault`: a seeded `FaultInjector` parsing `MXTPU_FAULT_SPEC`
  (`site:mode@arg;...`, e.g. `replica.kill:fail@8;ckpt.write:fail@2`).
  Named injection sites inside the framework consult it; with a fixed
  seed the same faults fire at the same calls every run, so a chaos
  failure reproduces under a debugger (cf. Jepsen-style deterministic
  fault schedules).
- `checkpoint`: tmp-file → fsync → atomic-rename writes with a sidecar
  sha256 manifest, verification at load, and the newest-uncorrupted
  walk-back (cf. CheckFreq, Mohan et al., FAST'21 on crash-consistent
  checkpointing).
- `preemption`: SIGTERM/SIGINT drain handlers and the resume bundle
  (parameters, optimizer states, data cursor, generator position).
"""
from __future__ import annotations

from .retry import RetryPolicy  # noqa: F401
from .fault import (  # noqa: F401
    FaultInjector, InjectedConnectionError, InjectedIOError, injector,
    install, refresh_from_env,
)
from .checkpoint import (  # noqa: F401
    atomic_save, atomic_write_bytes, manifest_path, read_manifest, verify,
)
from .preemption import (  # noqa: F401
    PREEMPTED_EXIT_CODE, Preempted, checkpoint_and_exit, clear_bundle,
    maybe_checkpoint_and_exit, read_bundle, write_bundle,
)
from . import preemption  # noqa: F401

__all__ = [
    "RetryPolicy",
    "FaultInjector", "InjectedConnectionError", "InjectedIOError",
    "injector", "install", "refresh_from_env",
    "atomic_save", "atomic_write_bytes", "manifest_path", "read_manifest",
    "verify",
    "PREEMPTED_EXIT_CODE", "Preempted", "checkpoint_and_exit",
    "clear_bundle", "maybe_checkpoint_and_exit", "preemption",
    "read_bundle", "write_bundle",
]
