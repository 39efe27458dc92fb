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
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["count", "capturing", "observing"]

_lock = threading.Lock()
_tls = threading.local()


def count(wrapper, n=1):
    """Add `n` launches to `wrapper.launches` and to the calling thread's
    tally, if it keeps one; a capturing thread's go to its tally only."""
    tally = getattr(_tls, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + n
        if _tls.capturing:
            return
    with _lock:
        wrapper.launches += n


@contextlib.contextmanager
def _tallying(capturing):
    saved = getattr(_tls, "tally", None), getattr(_tls, "capturing", False)
    tally = {}
    _tls.tally, _tls.capturing = tally, capturing
    try:
        yield tally
    finally:
        _tls.tally, _tls.capturing = saved


def capturing():
    """The calling thread's counts go to a fresh {wrapper: launches}
    tally, yielded, and nowhere else, for the duration."""
    return _tallying(True)


def observing():
    """The calling thread's counts are also tallied in a fresh {wrapper:
    launches} tally, yielded, for the duration."""
    return _tallying(False)
