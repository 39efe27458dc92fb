"""Named device-call sites, each captured once per shape signature into a
CUDA graph and replayed from then on.

The port's counterpart of the JAX package's `compile_cache.wrap`: where
the JAX engine runs each device call as one jitted executable per named
site, compiled once per signature, the port runs it as one CUDA graph per
site and signature, captured once. `telemetry/compilereg.py` counts both
the same way, so a steady state shows zero compiles and zero retraces.
Unlike `compile_cache.wrap` there is no disk cache: every process
captures its graphs anew.

    site = graphs.wrap("serving_decode_step", fn, device=dev, pool=pool)
    out = site(tokens, positions, tables)   # numpy arrays in, fn's output

`fn` takes device tensors and returns one tensor or None. The inputs are
host numpy arrays (the serving sites') or torch tensors (the train
step's scan: device tensors, copied device to device). On CUDA the
first call for a signature (the inputs' shapes and dtypes):

- warms `fn` on a side stream on zero-filled inputs, as PyTorch's graph
  rules require (the serving sites treat all-zero inputs as a no-op
  outside the KV pool's null page). A site given `state` (a callable
  returning the tensors `fn` updates in place: a train step's weights,
  optimizer states and running stats) snapshots them before its warm-up
  runs and puts them back after, so the warm-up leaves no trace; its
  `warmup_runs` may differ from `WARMUP_RUNS`;
- captures one call into a `torch.cuda.CUDAGraph`, from the memory pool
  `pool` (a `Pool` the caller's sites share);
- registers the signature with `compilereg`, the capture's seconds as
  its `compile_s`.

Every call copies the inputs into the graph's static input tensors
(outside the graph, on the current stream) and replays it; the result is
the graph's static output, valid only until any site of the same pool
replays (the pool may hand one graph's output memory to another graph's
scratch). A capture
that fails raises, naming the site: nothing runs `fn` eagerly in its
place. On the CPU, where there is no graph, `fn` runs eagerly on the
inputs and the site registers a signature on its first call.

Kernel launches: a capture records launches without running them, so the
kernel wrappers' counts made during a capture (on the capturing thread,
or on the capture's stream from another thread: a train step's backward
runs on autograd's device thread) go to the capture's tally
(`ops/kernels/launches.py`) and are kept with that signature's graph
(`.captured_launches`); each replay of the graph adds them to the
wrappers' counts, since it launches those kernels. The eager warm-up
runs before a capture do launch, and count; a site keeps them per
signature (`.warmup_launches`).

Threads: sites of different engines may run on different threads (the
serving fleet pumps each replica from its own). Replays need no lock
across engines; the sites of one pool replay from one thread at a time
(an engine's steps, under its lock). A capture runs in CUDA's
thread-local mode, so another thread's replays, copies and read-backs
neither fail nor spoil it, and it holds one process-wide capture lock
(`graphs.capture` to the lock sanitizer; after `serving.engine` when a
step captures), so two captures, each of which synchronizes the device
and empties the allocator's cache first, never overlap; a capture that
finds its signature captured meanwhile takes that graph. No garbage
collection runs during a capture: one could free a dead site's graph on
the capturing thread, which invalidates the capture. A capture
replays nothing, so it may run beside replays of its own pool. A
signature's first call on the CPU, its registration, takes the same
lock, so the CPU runs the card's lock order.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time

import numpy as np
import torch

from .analysis import sanitizers as _sanitizers
from .ops import kernels as _kernels
from .ops.kernels import launches as _launches
from .telemetry import compilereg

__all__ = ["Pool", "Site", "wrap", "WARMUP_RUNS"]

# eager runs on a side stream before each capture (PyTorch's rule: lazy
# initialisation, e.g. a cuBLAS workspace, must not happen in a capture)
WARMUP_RUNS = 2

# the process-wide capture lock's mutex; `_capture_lock()` hands it to
# the lock sanitizer as the lock class "graphs.capture" while it is on
_CAPTURE_MUTEX = threading.Lock()


def _capture_lock():
    return _sanitizers.san_lock("graphs.capture", _CAPTURE_MUTEX)


@contextlib.contextmanager
def _no_collection():
    """Pause Python's cyclic collector (process-wide) for a capture: a
    collection there may free a dead engine's graphs, and destroying a
    graph on the capturing thread invalidates its capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class Pool:
    """One CUDA-graph memory pool that several sites' graphs share. Sites
    of one pool must not replay at the same time (they run on one stream,
    one after another): a graph's scratch memory may be another's. For
    the same reason a site's output is valid only until any site of the
    pool replays: read it (or copy it) before the next replay."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class _Graph:
    """One capture: the graph, its static inputs and output, the
    (kernel wrapper, launches) pairs one replay runs, and its replays."""
    __slots__ = ("graph", "inputs", "output", "launches", "replays")

    def __init__(self, graph, inputs, output, launches):
        self.graph = graph
        self.inputs = inputs
        self.output = output
        self.launches = launches
        self.replays = 0


class Site:
    """One named device call; see the module docstring. Attributes:
    `replays` (replays of any of its graphs), `capture_seconds`
    ({signature: seconds}), `warmup_launches` ({signature: {kernel
    wrapper name: launches of its capture's eager warm-up runs}}) and
    `pool_bytes` (device memory reserved during its captures: the
    pool's growth)."""

    def __init__(self, name, fn, *, device, pool=None, state=None,
                 warmup_runs=WARMUP_RUNS):
        self.name = name
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool if pool is not None else Pool()
        self.state = state
        self.warmup_runs = warmup_runs
        self.replays = 0
        self.capture_seconds = {}
        self.warmup_launches = {}
        self.pool_bytes = 0
        self._graphs = {}
        self._eager = set()  # signatures run eagerly (CPU)

    @property
    def captured_launches(self):
        """{signature: {kernel wrapper name: launches in one replay of
        that signature's graph}}."""
        return {sig: {k.__name__: n for k, n in g.launches}
                for sig, g in self._graphs.items()}

    def replayed_launches(self):
        """{kernel wrapper name: launches its graphs' replays made}, each
        graph's per-replay counts times its own replays."""
        out = {}
        for g in self._graphs.values():
            for kernel, n in g.launches:
                out[kernel.__name__] = (out.get(kernel.__name__, 0)
                                        + n * g.replays)
        return out

    def __call__(self, *arrays):
        arrays = [a if torch.is_tensor(a) else np.asarray(a, order="C")
                  for a in arrays]
        sig = compilereg.signature_of(*arrays)
        if self.device.type != "cuda":
            return self._eager_call(sig, arrays)
        g = self._graphs.get(sig)
        if g is None:
            g = self._capture(sig, arrays)
        for buf, a in zip(g.inputs, arrays):
            buf.copy_(a if torch.is_tensor(a) else torch.from_numpy(a),
                      non_blocking=True)
        g.graph.replay()
        self.replays += 1
        g.replays += 1
        for kernel, n in g.launches:
            _launches.count(kernel, n)
        return g.output

    def warm(self, *shapes):
        """Capture (on the CPU: run once eagerly and register) the graph
        for int64 inputs of these shapes, all zeros, without a real
        request. Returns "captured", "eager" (CPU), or "memo" when the
        signature is already known to this site."""
        arrays = [np.zeros(s, np.int64) for s in shapes]
        sig = compilereg.signature_of(*arrays)
        if sig in self._graphs or sig in self._eager:
            return "memo"
        if self.device.type != "cuda":
            self._eager_call(sig, arrays)
            return "eager"
        self._capture(sig, arrays)
        return "captured"

    def _eager_call(self, sig, arrays):
        inputs = [(a if torch.is_tensor(a) else torch.from_numpy(a))
                  .to(self.device) for a in arrays]
        if sig not in self._eager:
            with _capture_lock():
                if sig not in self._eager:  # not registered meanwhile
                    t0 = time.perf_counter()
                    out = self.fn(*inputs)
                    self._eager.add(sig)
                    compilereg.register(self.name, sig,
                                        compile_s=time.perf_counter() - t0)
                    return out
        return self.fn(*inputs)

    def _capture(self, sig, arrays):
        """Warm up, then capture under the capture lock. The warm-up runs
        and the release of the allocator's cached blocks (which can take
        a tenth of a second after other engines were freed) come first,
        outside the lock, so it is held for the capture itself."""
        dev = self.device
        t0 = time.perf_counter()
        try:
            inputs = [torch.zeros(a.shape, dtype=_dtype(a), device=dev)
                      for a in arrays]
            warmup = self._warm_up(inputs)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            with _capture_lock():
                g = self._graphs.get(sig)
                if g is not None:  # another thread captured it meanwhile
                    return g
                # a capture starts by emptying the allocator's cache;
                # do it first, so the reserved bytes' growth is the pool's
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(dev)
                graph = torch.cuda.CUDAGraph()
                stream = torch.cuda.Stream(dev)
                # the capture launches nothing: its counts (a backward's
                # too, from autograd's thread on this stream) go to the
                # tally, credited at each replay instead
                with _launches.capturing(stream) as tally, \
                        _no_collection(), \
                        torch.cuda.graph(graph, pool=self.pool.handle(),
                                         stream=stream,
                                         capture_error_mode="thread_local"):
                    output = self.fn(*inputs)
                launches = [(kernel, tally[kernel])
                            for kernel in _kernels.COUNTED
                            if tally.get(kernel)]
                seconds = time.perf_counter() - t0
                self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
                self.capture_seconds[sig] = seconds
                self.warmup_launches[sig] = {kernel.__name__: n
                                             for kernel, n in warmup.items()}
                g = self._graphs[sig] = _Graph(graph, inputs, output,
                                               launches)
                compilereg.register(self.name, sig, compile_s=seconds)
                return g
        except Exception as e:
            raise RuntimeError(f"CUDA-graph capture of site {self.name!r} "
                               f"failed: {e}") from e

    def _warm_up(self, inputs):
        """Run `fn` on `inputs` `warmup_runs` times (on CUDA on a side
        stream, as a capture requires) and put back the tensors `state`
        names, even when a run fails. Returns {kernel: launches} of the
        runs (CUDA) or {} (CPU, where nothing calls it but tests)."""
        saved = self._snapshot()
        try:
            if self.device.type != "cuda":
                for _ in range(self.warmup_runs):
                    self.fn(*inputs)
                return {}
            dev = self.device
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), \
                    _launches.observing(side) as warmup:
                for _ in range(self.warmup_runs):
                    self.fn(*inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            return warmup
        finally:
            self._restore(saved)

    def _snapshot(self):
        """Copies of the tensors `state()` names (None without `state`)."""
        if self.state is None:
            return None
        with torch.no_grad():
            return [(t, t.clone()) for t in self.state()]

    @staticmethod
    def _restore(saved):
        if saved is None:
            return
        with torch.no_grad():
            for t, copy in saved:
                t.copy_(copy)


def _dtype(a):
    return a.dtype if torch.is_tensor(a) else torch.from_numpy(a).dtype


def wrap(name, fn, *, device, pool=None, state=None,
         warmup_runs=WARMUP_RUNS):
    """A `Site` running `fn` under the name `name`; see the module
    docstring."""
    return Site(name, fn, device=device, pool=pool, state=state,
                warmup_runs=warmup_runs)
