"""Gluon DataLoader (`incubator_mxnet_tpu/gluon/data/dataloader.py`).

Batches are assembled in numpy, by a thread pool when `num_workers > 0`
(the threaded prefetch path), and yielded as NDArrays on the CPU, as the
JAX package's are; a block called with one moves it to its parameters'
device (`gluon.block.input_copies`). `state_dict` / `load_state_dict`
resume mid-epoch with the same index order.
"""
from __future__ import annotations

import concurrent.futures as _futures
import time as _time

import numpy as np

from ... import telemetry as _telemetry
from ...context import cpu
from ...ndarray.ndarray import NDArray
from ...ndarray.ndarray import array as _array
from ...resilience import fault as _fault
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def nd_array(data):
    return _array(data, ctx=cpu())


def default_batchify_fn(data):
    """Stack samples (tuples column by column) into CPU NDArrays."""
    if isinstance(data[0], NDArray):
        return nd_array(np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    data = np.asarray(data)
    return nd_array(data)


class DataLoader:
    """Batches of `dataset` by `batch_size` (or a `batch_sampler`),
    shuffled from numpy's global stream when `shuffle`."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size required when batch_sampler is None")
            if sampler is None:
                sampler = (RandomSampler(len(dataset)) if shuffle
                           else SequentialSampler(len(dataset)))
            elif shuffle:
                raise ValueError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._prefetch = max(0, prefetch or 2 * max(num_workers, 1))
        # checkpointable position: epoch index + batches served within it
        self._epoch = 0
        self._batches = 0
        self._resume_skip = 0

    def state_dict(self):
        """Checkpointable pipeline position — callable mid-epoch: `batch`
        counts the batches the consumer has already received this epoch."""
        return {"version": 1, "epoch": self._epoch, "batch": self._batches,
                "batch_sampler": self._batch_sampler.state_dict()}

    def load_state_dict(self, state):
        """Restore a `state_dict()`: the next `__iter__` replays the
        interrupted epoch's index order (sampler RNG rewound to its epoch
        start) and fast-forwards past the first `batch` batches WITHOUT
        fetching their data, so a resumed job sees the exact batch
        sequence an uninterrupted run would have."""
        self._epoch = int(state["epoch"])
        self._batches = int(state["batch"])
        self._resume_skip = self._batches
        self._batch_sampler.load_state_dict(state["batch_sampler"],
                                            mid_epoch=self._batches > 0)

    def __iter__(self):
        self._batches = self._resume_skip
        it = self._iter_impl()
        if not _telemetry.enabled():
            # cursor BEFORE yield: the generator suspends at yield, so a
            # state_dict() taken after the consumer received batch k must
            # already read k served
            for batch in it:
                self._batches += 1
                yield batch
        else:
            # batch-fetch latency as the consumer sees it: time blocked in
            # next() — includes batchify for the serial path and result-wait
            # for the prefetched path (a well-fed pipeline reads near zero)
            while True:
                t0 = _time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                dt = _time.perf_counter() - t0
                _telemetry.observe(
                    "mxtpu_dataloader_fetch_seconds", dt,
                    help="Time the training loop blocked fetching a batch.")
                # the same measurement feeds the step breakdown: fetch
                # time belongs to the step that consumes the batch
                _telemetry.stepstats.record("data_fetch", dt)
                self._batches += 1
                yield batch
        # epoch bookkeeping only on normal exhaustion: an abandoned
        # generator leaves the mid-epoch cursor for state_dict() to report
        self._epoch += 1
        self._batches = 0

    def _fetch(self, batch):
        _fault.injector().raise_for("data.fetch")
        return self._batchify_fn([self._dataset[i] for i in batch])

    def _index_iter(self):
        """The epoch's batch-index stream, fast-forwarded past batches a
        restored cursor already served (index-only: skipping is free)."""
        it = iter(self._batch_sampler)
        skip, self._resume_skip = self._resume_skip, 0
        for _ in range(skip):
            try:
                next(it)
            except StopIteration:
                return iter(())
        return it

    def _iter_impl(self):
        if self._num_workers == 0:
            for batch in self._index_iter():
                yield self._fetch(batch)
            return
        # threaded prefetch pipeline. Failure
        # path: the FIRST worker/batchify exception is re-raised promptly
        # with its batch index, and every still-pending future is
        # cancelled — without this, an early failure surfaced only after
        # the whole prefetch window drained, and non-executed futures
        # wedged pool shutdown behind work nobody will consume.
        pool = _futures.ThreadPoolExecutor(self._num_workers)
        try:
            pending = []  # (batch_index, future), consumed in order
            it = self._index_iter()
            n_submitted = 0

            def submit():
                nonlocal n_submitted
                try:
                    batch = next(it)
                except StopIteration:
                    return None
                idx = n_submitted
                n_submitted += 1
                return (idx, pool.submit(self._fetch, batch))

            for _ in range(self._prefetch):
                f = submit()
                if f is None:
                    break
                pending.append(f)
            while pending:
                idx, f = pending.pop(0)
                nxt = submit()
                if nxt is not None:
                    pending.append(nxt)
                _telemetry.set_gauge(
                    "mxtpu_dataloader_queue_depth", len(pending),
                    help="Prefetch batches in flight (0 = pipeline "
                         "starved, consumer about to block).")
                try:
                    yield f.result()
                except Exception as e:
                    for _i, p in pending:
                        p.cancel()
                    raise RuntimeError(
                        f"DataLoader worker failed on batch {idx}: "
                        f"{type(e).__name__}: {e}") from e
        finally:
            # cancel_futures: a generator abandoned mid-epoch (or the
            # failure path above) must not block on unconsumed batches
            pool.shutdown(wait=True, cancel_futures=True)

    def __len__(self):
        return len(self._batch_sampler)
