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

`fn` takes device tensors and returns one tensor or None. On CUDA the
first call for a signature (the inputs' shapes and dtypes):

- warms `fn` on a side stream on zero-filled inputs, as PyTorch's graph
  rules require (the serving sites treat all-zero inputs as a no-op
  outside the KV pool's null page);
- captures one call into a `torch.cuda.CUDAGraph`, from the memory pool
  `pool` (a `Pool` the caller's sites share);
- registers the signature with `compilereg`, the capture's seconds as
  its `compile_s`.

Every call copies the host inputs into the graph's static input tensors
(outside the graph, on the current stream) and replays it; the result is
the graph's static output, valid only until any site of the same pool
replays (the pool may hand one graph's output memory to another graph's
scratch). A capture
that fails raises, naming the site: nothing runs `fn` eagerly in its
place. On the CPU, where there is no graph, `fn` runs eagerly on the
inputs and the site registers a signature on its first call.

Kernel launches: a capture records launches without running them, so the
kernel wrappers' `.launches` counts taken during a capture are handed
back and kept with that signature's graph (`.captured_launches`); each
replay of the graph adds them to the wrappers' counts, since it launches
those kernels.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .ops import kernels as _kernels
from .telemetry import compilereg

__all__ = ["Pool", "Site", "wrap", "WARMUP_RUNS"]

# eager runs on a side stream before each capture (PyTorch's rule: lazy
# initialisation, e.g. a cuBLAS workspace, must not happen in a capture)
WARMUP_RUNS = 2


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


def _counts():
    return [k.launches for k in _kernels.COUNTED]


class Site:
    """One named device call; see the module docstring. Attributes:
    `replays` (replays of any of its graphs), `capture_seconds`
    ({signature: seconds}) and `pool_bytes` (device memory reserved
    during its captures: the pool's growth)."""

    def __init__(self, name, fn, *, device, pool=None):
        self.name = name
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool if pool is not None else Pool()
        self.replays = 0
        self.capture_seconds = {}
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
        arrays = [np.asarray(a, order="C") for a in arrays]
        sig = compilereg.signature_of(*arrays)
        if self.device.type != "cuda":
            return self._eager_call(sig, arrays)
        g = self._graphs.get(sig)
        if g is None:
            g = self._capture(sig, arrays)
        for buf, a in zip(g.inputs, arrays):
            buf.copy_(torch.from_numpy(a), non_blocking=True)
        g.graph.replay()
        self.replays += 1
        g.replays += 1
        for kernel, n in g.launches:
            kernel.launches += n
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
        t0 = time.perf_counter()
        out = self.fn(*(torch.from_numpy(a).to(self.device) for a in arrays))
        if sig not in self._eager:
            self._eager.add(sig)
            compilereg.register(self.name, sig,
                                compile_s=time.perf_counter() - t0)
        return out

    def _capture(self, sig, arrays):
        dev = self.device
        t0 = time.perf_counter()
        try:
            inputs = [torch.zeros(a.shape, dtype=torch.from_numpy(a).dtype,
                                  device=dev) for a in arrays]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    self.fn(*inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            # a capture starts by emptying the allocator's cache; do it
            # first, so the reserved bytes' growth is the pool's
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            before = _counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool.handle()):
                output = self.fn(*inputs)
        except Exception as e:
            raise RuntimeError(f"CUDA-graph capture of site {self.name!r} "
                               f"failed: {e}") from e
        # the capture launched nothing: hand its counts back, and credit
        # them at each replay instead
        launches = []
        for kernel, b, a in zip(_kernels.COUNTED, before, _counts()):
            kernel.launches = b
            if a > b:
                launches.append((kernel, a - b))
        seconds = time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.capture_seconds[sig] = seconds
        g = self._graphs[sig] = _Graph(graph, inputs, output, launches)
        compilereg.register(self.name, sig, compile_s=seconds)
        return g


def wrap(name, fn, *, device, pool=None):
    """A `Site` running `fn` under the name `name`; see the module
    docstring."""
    return Site(name, fn, device=device, pool=pool)
