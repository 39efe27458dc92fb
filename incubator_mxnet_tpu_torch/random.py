"""The global random state (`incubator_mxnet_tpu/random.py`).

As in the JAX package the whole state is a host pair (seed, counter):
`seed(s)` sets it to (s, 0) and every consumer takes the next counter
value. Where JAX folds the counter into a threefry key, the port seeds
an explicit `torch.Generator` from the pair (`next_generator`), so
draws never touch torch's global generators and a `get_state()`
snapshot restored with `set_state()` repeats every later draw exactly.
The bits differ from JAX's threefry; the state's shape is JAX's.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "next_key", "next_generator", "current_seed",
           "get_state", "set_state"]

_LOCK = threading.Lock()
_SEED = 0
_COUNTER = 0

# a generator's seed: the (seed, counter) pair folded into 63 bits
_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def seed(seed_state, ctx="all"):
    """Seed the global generator (mx.random.seed)."""
    global _SEED, _COUNTER
    with _LOCK:
        _SEED = int(seed_state)
        _COUNTER = 0


def current_seed():
    return _SEED


def get_state():
    """The checkpointable position {"seed", "counter"}."""
    with _LOCK:
        return {"seed": _SEED, "counter": _COUNTER}


def set_state(state):
    """Restore a `get_state()` snapshot."""
    global _SEED, _COUNTER
    with _LOCK:
        _SEED = int(state["seed"])
        _COUNTER = int(state["counter"])


def next_key():
    """The next counter's 63-bit generator seed (the state advances)."""
    global _COUNTER
    with _LOCK:
        _COUNTER += 1
        return ((_SEED * _MIX) ^ (_COUNTER * 0xBF58476D1CE4E5B9)) & _MASK


def next_generator(device="cpu"):
    """A fresh `torch.Generator` on `device`, seeded from the next
    counter."""
    gen = torch.Generator(device=device)
    gen.manual_seed(next_key())
    return gen
