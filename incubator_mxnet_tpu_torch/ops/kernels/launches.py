"""Thread-safe launch counts for the kernel wrappers.

Each wrapper adds one to its `.launches` through `count` where it
launches its kernel, and nowhere else. Serving replicas replay CUDA
graphs from one thread each, and a replay credits the launches its graph
holds (`graphs.Site`), so counts may move on several threads at once:
they take one leaf lock, never held across a call. A thread may also
tally its own counts: while it captures a graph (`capturing()`) its
wrappers launch nothing, so their counts go to that capture's tally
alone, which each replay of the graph credits; while it observes
(`observing()`, a capture's eager warm-up) they are launches, counted as
always and tallied too, so a caller can tell them from other threads'.
Given the stream the capture or warm-up runs on, the tally also takes
the counts of any thread whose current stream that is: a train step's
backward runs on autograd's device thread, on the forward's stream.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["count", "capturing", "observing"]

_lock = threading.Lock()
_tls = threading.local()
# (device index, stream handle) -> (tally, capturing) of the streams a
# capture or a warm-up runs on
_streams = {}


def _current_stream():
    import torch

    stream = torch.cuda.current_stream()
    return stream.device_index, stream.cuda_stream


def count(wrapper, n=1):
    """Add `n` launches to `wrapper.launches` and to the tally of the
    calling thread or of its current stream, if either keeps one; a
    capture's counts go to its tally only."""
    tally = getattr(_tls, "tally", None)
    capturing = getattr(_tls, "capturing", False)
    if tally is None and _streams:
        tally, capturing = _streams.get(_current_stream(), (None, False))
    if tally is not None:
        with _lock:
            tally[wrapper] = tally.get(wrapper, 0) + n
        if capturing:
            return
    with _lock:
        wrapper.launches += n


@contextlib.contextmanager
def _tallying(capturing, stream):
    saved = getattr(_tls, "tally", None), getattr(_tls, "capturing", False)
    tally = {}
    _tls.tally, _tls.capturing = tally, capturing
    key = None if stream is None else (stream.device_index,
                                       stream.cuda_stream)
    if key is not None:
        with _lock:
            _streams[key] = (tally, capturing)
    try:
        yield tally
    finally:
        _tls.tally, _tls.capturing = saved
        if key is not None:
            with _lock:
                del _streams[key]


def capturing(stream=None):
    """The calling thread's counts (and, given the capture's `stream`,
    those of any thread launching on it) go to a fresh {wrapper:
    launches} tally, yielded, and nowhere else, for the duration."""
    return _tallying(True, stream)


def observing(stream=None):
    """The calling thread's counts (and, given `stream`, those of any
    thread launching on it) are also tallied in a fresh {wrapper:
    launches} tally, yielded, for the duration."""
    return _tallying(False, stream)
