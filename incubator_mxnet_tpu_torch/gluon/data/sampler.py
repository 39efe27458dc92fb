"""Index samplers for DataLoader (`incubator_mxnet_tpu/gluon/data/sampler.py`,
the JAX package's module as it is: it is numpy-only, so the shuffle
orders are identical): sequential/random index streams and the batching
wrapper with keep/discard/rollover tail policies.

Expressed generator-first: a sampler is just an index iterable with a
length; the batch wrapper chunks any such iterable, with the tail policy
isolated in `_flush_tail`.

Checkpointable: every sampler carries `state_dict()/load_state_dict()` so
a preempted job resumes MID-EPOCH with a bit-identical index order
(exact resume after preemption). The contract:
`load_state_dict(state, mid_epoch=True)` restores the RNG to the state it
had when the interrupted epoch STARTED, so the next `__iter__` re-derives
the same order and the DataLoader fast-forwards past the batches already
served; `mid_epoch=False` (an epoch-boundary resume) restores the live
state so the next epoch draws fresh.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]

_TAIL_POLICIES = ("keep", "discard", "rollover")


class Sampler:
    """An iterable of dataset indices with a known length."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def state_dict(self):
        """Checkpointable position; stateless samplers return {}."""
        return {}

    def load_state_dict(self, state, mid_epoch=False):
        """Restore `state_dict()` output. `mid_epoch=True` rewinds any
        per-epoch randomness to the interrupted epoch's start so the
        order replays exactly."""


class SequentialSampler(Sampler):
    """Indices start, start+1, ..., start+length-1."""

    def __init__(self, length, start=0):
        self._range = range(start, start + length)

    def __iter__(self):
        return iter(self._range)

    def __len__(self):
        return len(self._range)


class RandomSampler(Sampler):
    """A fresh uniform permutation of [0, length) per epoch.

    Owns its PRNG (seeded from the global numpy stream unless `seed` is
    given) so the shuffle order is checkpointable: `state_dict()` captures
    both the live RNG state and the state at the current epoch's start,
    and a mid-epoch restore replays the interrupted epoch's permutation
    bit-identically.
    """

    def __init__(self, length, seed=None):
        self._length = length
        if seed is None:
            # derived from the global stream: np.random.seed() upstream
            # keeps legacy runs deterministic end-to-end
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        self._rng = np.random.RandomState(seed)
        self._epoch_start = self._rng.get_state()

    def __iter__(self):
        self._epoch_start = self._rng.get_state()
        yield from self._rng.permutation(self._length).tolist()

    def __len__(self):
        return self._length

    def state_dict(self):
        return {"rng": self._rng.get_state(),
                "epoch_start": self._epoch_start}

    def load_state_dict(self, state, mid_epoch=False):
        self._rng.set_state(state["epoch_start"] if mid_epoch
                            else state["rng"])
        self._epoch_start = self._rng.get_state()


class BatchSampler(Sampler):
    """Chunk an index sampler into batch-size lists.

    Tail policy for a short final chunk: 'keep' yields it, 'discard' drops
    it, 'rollover' prepends it to the NEXT epoch's first batch.
    """

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in _TAIL_POLICIES:
            raise ValueError(
                f"last_batch must be one of {_TAIL_POLICIES}, "
                f"got {last_batch!r}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._rolled = []
        self._start_rolled = []

    def __iter__(self):
        # remembered so a mid-epoch restore can re-seed the epoch with the
        # same rolled-over tail the interrupted iteration started with
        self._start_rolled = list(self._rolled)
        batch = self._rolled
        self._rolled = []
        for idx in self._sampler:
            batch.append(idx)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        yield from self._flush_tail(batch)

    def _flush_tail(self, batch):
        if not batch:
            return
        if self._last_batch == "keep":
            yield batch
        elif self._last_batch == "rollover":
            self._rolled = batch
        # 'discard': drop it

    def __len__(self):
        n, b = len(self._sampler), self._batch_size
        if self._last_batch == "keep":
            return -(-n // b)  # ceil
        if self._last_batch == "discard":
            return n // b
        return (n + len(self._rolled)) // b

    def state_dict(self):
        return {"sampler": self._sampler.state_dict(),
                "rolled": list(self._rolled),
                "start_rolled": list(self._start_rolled)}

    def load_state_dict(self, state, mid_epoch=False):
        self._sampler.load_state_dict(state["sampler"], mid_epoch)
        self._rolled = list(state["start_rolled"] if mid_epoch
                            else state["rolled"])
        self._start_rolled = list(self._rolled)
