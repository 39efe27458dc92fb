"""`GluonTrainStep`: a gluon net, its loss and an optimizer as one train
step on one device (the single-device part of
`incubator_mxnet_tpu/fused.py:GluonTrainStep`).

A step runs the forward in training mode, takes `loss = mean(loss_fn(net,
x, y))` in at least float32, its gradients with `torch.autograd.grad`,
and the optimizer's batched fused update (`fused_updates`) in place on
every parameter whose `grad_req` is not "null", with the step's lr and
update count as float32 tensors. The states come from the optimizer's
`create_fused_state`: multi-precision SGD's (momentum, float32 master)
on a low-precision weight, stochastic rounding's float32 momentum,
Nadam's per-parameter schedule. A user's optimizer that defines only
`update` runs that, with a warning, as in the JAX package. BatchNorm
running stats move once per step
(biased batch variance, `moving * momentum + batch * (1 - momentum)`):
the forward defers their writes (`ops.nn.deferred_moving_writes`) and
the step makes them after the backward, as the JAX step takes them back
as aux outputs, so a recomputed forward writes nothing. The step returns
the loss as a 0-d tensor on the device, without a sync (an NDArray when
the batch comes as NDArrays, as the JAX step answers).

Options, as in the JAX package:

- `compute_dtype` (e.g. "bfloat16"): inside the differentiated forward
  the floating trainable parameters and a floating `x` are cast to it
  (`gluon.block._ParamSubst` hands the forward the copies); the running
  stats stay float32, and the gradients, the update and the optimizer
  states stay in the parameters' dtype (float32 master weights). A net
  cast with `net.cast("bfloat16")` instead trains in bfloat16 outright.
- `remat` / `remat_policy` (or `MXTPU_REMAT_POLICY`): the whole
  `loss_fn(net, x, y)` runs under non-reentrant
  `torch.utils.checkpoint`, its activations recomputed in the backward;
  a policy (`resolve_remat_policy`) chooses what is kept instead of
  recomputed. A non-empty policy turns remat on. Inside that region
  each child of a `HybridSequential` (a residual unit, a layer) has a
  checkpoint of its own, with the same policy: PyTorch recomputes a
  checkpointed region whole at the backward's first use of it, so the
  whole-forward checkpoint alone would hold every activation again at
  once and peak no lower than plain (the JAX package leaves that
  schedule to XLA).
- `scan_steps(xs, ys)`: K steps in one call; on CUDA one CUDA graph per
  (xs, ys) signature, captured once (`graphs.Site`, registered as
  `GluonTrainStep.scan`) and replayed, K unrolled steps in one replay.
- `accum_steps(xs, ys)`: K micro-batches' gradients summed, then one
  update.

The first step resolves deferred parameter shapes with one forward in
predict mode under `torch.no_grad()`, so the BN running stats do not move
(the JAX package runs its warm pass in predict mode too); a net whose
shapes are all known skips it. The step collects the parameters then, so
a `net.cast` made before the first step is honoured. `__call__` and
`accum_steps` run eagerly; there is nothing to compile.

With telemetry on, `__call__` feeds the step statistics (phases `h2d`
and `dispatch`, `step_end()` per call), the memory ledger tracks the
optimizer states as `optimizer_state`, and the step's, the scan's and
the accumulation's signatures are registered with the capture registry
under the JAX site names.

Not ported: `mesh`, `shard_policy` and `shard_optimizer_states` (one
device; ROADMAP Queue A 4) and `init_on_device` (the port initializes on
the card directly) raise `NotImplementedError`.
"""
from __future__ import annotations

import pickle
import time

import numpy as np
import torch
import torch.utils.checkpoint as _checkpoint

from . import config, graphs, profiler
from . import optimizer as _optimizer
from . import telemetry as _telemetry
from .config import resolve_device
from .gluon.block import _ParamSubst, _RematUnits
from .gluon.parameter import _dtype
from .ndarray.ndarray import NDArray
from .ops import nn as _nn
from .telemetry import compilereg as _compilereg
from .telemetry import ledger as _ledger
from .telemetry import stepstats as _stepstats

__all__ = ["GluonTrainStep", "resolve_remat_policy"]

# the friendly tiers of MXTPU_REMAT_POLICY -> the jax.checkpoint_policies
# name each stands for (those exact names are accepted too)
_REMAT_POLICY_ALIASES = {
    "dots": "dots_saveable",
    "dots_no_batch": "dots_with_no_batch_dims_saveable",
    "offload": "offload_dot_with_no_batch_dims",
    "nothing": "nothing_saveable",
    "everything": "everything_saveable",
}
_DOTS = ("mm", "addmm", "bmm", "baddbmm")
_DOTS_NO_BATCH = ("mm", "addmm")
# policy -> (how the chosen results are kept, the aten ops chosen)
_POLICIES = {
    "convs": ("save", ("convolution",) + _DOTS),
    "dots_saveable": ("save", _DOTS),
    "dots_with_no_batch_dims_saveable": ("save", _DOTS_NO_BATCH),
    "offload_dot_with_no_batch_dims": ("offload", _DOTS_NO_BATCH),
    "nothing_saveable": ("save", ()),
    "everything_saveable": ("everything", ()),
}


class RematPolicy:
    """A resolved remat policy: `name` (the JAX policy name), `kept` (the
    aten ops whose results survive to the backward instead of being
    recomputed) and `how` ("save" on the device, "offload" to host
    memory, or "everything": no recompute at all)."""

    def __init__(self, name, how, kept):
        self.name, self.how, self.kept = name, how, kept

    def __repr__(self):
        return f"RematPolicy({self.name!r})"

    def _chosen(self, op):
        return getattr(op, "overloadpacket", op).__name__ in self.kept

    def context_fn(self):
        """The (forward, recompute) context pair for
        `torch.utils.checkpoint.checkpoint(..., context_fn=...)`."""
        if self.how == "offload":
            return _offload_contexts(self._chosen)
        cp = _checkpoint.CheckpointPolicy

        def policy(ctx, op, *args, **kwargs):
            return (cp.MUST_SAVE if self._chosen(op)
                    else cp.PREFER_RECOMPUTE)

        return _checkpoint.create_selective_checkpoint_contexts(policy)


def _offload_contexts(chosen):
    """The offload pair: in the forward each chosen op's result is copied
    to host memory (pinned when it lives on the card); in the recompute
    the op returns that copy, moved back, instead of running. Everything
    else is recomputed. The same mechanism as selective checkpointing's
    saved results, with host memory as the store."""
    from torch.utils._python_dispatch import TorchDispatchMode

    store = []

    class Save(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if chosen(func):
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=out.is_cuda)
                store.append(host.copy_(out, non_blocking=True))
            return out

    class Load(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if chosen(func):
                return store.pop(0).to(args[0].device, non_blocking=True)
            return func(*args, **(kwargs or {}))

    return Save(), Load()


def resolve_remat_policy(name):
    """The `RematPolicy` for an MXTPU_REMAT_POLICY value, or None for the
    empty string (remat, if on, recomputes everything). Names: "convs"
    (keep convolution and matmul results, recompute the rest), "dots" /
    "dots_saveable" (every matmul: mm, addmm, bmm, baddbmm),
    "dots_no_batch" / "dots_with_no_batch_dims_saveable" (mm and addmm),
    "offload" / "offload_dot_with_no_batch_dims" (those, kept in host
    memory), "nothing" / "nothing_saveable" (recompute everything) and
    "everything" / "everything_saveable" (recompute nothing). Any other
    name raises ValueError listing these; the JAX package's other
    `jax.checkpoint_policies` attributes have no port."""
    if not name:
        return None
    key = _REMAT_POLICY_ALIASES.get(name, name)
    if key not in _POLICIES:
        known = ["convs"] + sorted(_REMAT_POLICY_ALIASES) + sorted(
            k for k in _POLICIES if k != "convs")
        raise ValueError(
            f"unknown remat policy {name!r} (MXTPU_REMAT_POLICY); expected "
            f"one of {known}")
    how, kept = _POLICIES[key]
    return RematPolicy(key, how, kept)


def _state_tensors(states):
    """The tensors of optimizer states: each state is None, a tensor or a
    tuple of them and None (Adam's (mean, var), multi-precision SGD's
    (momentum or None, float32 master))."""
    out = []
    for s in states:
        if isinstance(s, tuple):
            out.extend(_state_tensors(s))
        elif s is not None:
            out.append(s)
    return out


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


class GluonTrainStep:
    """step(x, y) -> loss (0-d float tensor on the device, async)."""

    def __init__(self, net, loss_fn, optimizer, device=None, *, mesh=None,
                 compute_dtype=None, init_on_device=False, remat=False,
                 remat_policy=None, shard_policy=None,
                 shard_optimizer_states=False):
        for name, value in (("mesh", mesh), ("init_on_device",
                                             init_on_device),
                            ("shard_policy", shard_policy),
                            ("shard_optimizer_states",
                             shard_optimizer_states)):
            if value:
                raise NotImplementedError(
                    f"GluonTrainStep({name}=...) is not ported: the port's "
                    f"step runs on one device and initializes there")
        self.net = net
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.device = resolve_device(device)
        self.compute_dtype = _dtype(compute_dtype) if compute_dtype else None
        if remat_policy is None:
            remat_policy = config.get("MXTPU_REMAT_POLICY")
        self.remat_policy = remat_policy or ""
        self._policy = resolve_remat_policy(self.remat_policy)
        self.remat = bool(remat) or bool(self.remat_policy)
        _optimizer.warn_if_generic(optimizer)
        self._built = False
        self._n = 0
        self._pending_states = None
        self._scan = None

    # -- building ----------------------------------------------------------

    def _build(self, x, y):
        params = self.net.collect_params()
        if any(p._data is None for p in params.values()):
            was = self.net.training
            self.net.train(False)
            try:
                with torch.no_grad():
                    self.loss_fn(self.net, x, y)
            finally:
                self.net.train(was)
        params = list(self.net.collect_params().items())
        missing = [n for n, p in params if p._data is None]
        if missing:
            raise RuntimeError(f"parameters still uninitialized after a "
                               f"forward: {missing[:5]}")
        self.names = [n for n, p in params if p.grad_req != "null"]
        self.weights = [p.tensor() for n, p in params
                        if p.grad_req != "null"]
        self.aux = [p.tensor() for n, p in params if p.grad_req == "null"]
        self.states = [self.opt.create_fused_state(i, w)
                       for i, w in enumerate(self.weights)]
        if self._pending_states is not None:
            self._load_into_states(self._pending_states)
            self._pending_states = None
        _ledger.track(self.states, "optimizer_state")
        self._built = True

    def _ensure_built(self, x, y):
        if not self._built:
            self._build(x, y)

    def _to_device(self, a):
        if isinstance(a, NDArray):
            a = a._data
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    # -- one step's pieces -------------------------------------------------

    def _loss(self, x, y, moving):
        """mean(loss_fn(net, x, y)) in at least float32, the forward's
        moving-stat writes collected in `moving` (a recompute's go
        nowhere)."""
        cdt = self.compute_dtype
        ws = self.weights
        if cdt is not None:
            ws = [w.to(cdt) if w.is_floating_point() else w for w in ws]
            if x.is_floating_point():
                x = x.to(cdt)
        remat = self.remat and not (self._policy is not None
                                    and self._policy.how == "everything")
        runs = []

        def forward(x, y, *ws):
            sink = moving if not runs else {}
            runs.append(1)
            with _ParamSubst(dict(zip(self.names, ws))), \
                    _nn.deferred_moving_writes(sink), \
                    _RematUnits(self._checkpoint_unit if remat else None):
                loss = self.loss_fn(self.net, x, y)
            return loss.to(torch.promote_types(loss.dtype,
                                               torch.float32)).mean()

        if not remat:
            return forward(x, y, *ws)
        return self._checkpoint(forward, x, y, *ws)

    def _checkpoint(self, fn, *args):
        kwargs = {}
        if self._policy is not None and self._policy.kept:
            # "nothing" keeps nothing: the plain checkpoint, without a
            # dispatch mode watching every op
            kwargs["context_fn"] = self._policy.context_fn
        # the port's gluon layers draw no random numbers, so the
        # recompute needs no saved RNG state (and a CUDA-graph capture
        # could not read one)
        return _checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                      preserve_rng_state=False, **kwargs)

    def _checkpoint_unit(self, fn, x):
        """`fn(x)` (one child of a sequence) under its own checkpoint,
        inside the whole forward's: the backward's recompute of the whole
        forward keeps only each unit's input, and each unit is recomputed
        again when the backward reaches it, so one unit's activations are
        alive at a time. The unit's recompute, which may run on
        autograd's thread, sees the same substituted parameters and
        writes no running stat."""
        mapping, sink = _ParamSubst.current(), _nn.moving_sink()
        runs = []

        def unit(x):
            target = sink if not runs else {}
            runs.append(1)
            with _ParamSubst(mapping), _nn.deferred_moving_writes(target), \
                    _RematUnits(None):
                return fn(x)

        return self._checkpoint(unit, x)

    def _grads(self, x, y):
        """(loss, gradients, {id: (running stat, new value)}) of one
        forward and backward in training mode; nothing is written."""
        moving = {}
        was = self.net.training
        self.net.train(True)  # the recompute, in the backward, reads it
        try:
            loss = self._loss(x, y, moving)
            grads = torch.autograd.grad(loss, self.weights)
        finally:
            self.net.train(was)
        return loss.detach(), grads, moving

    @staticmethod
    def _write_moving(moving):
        with torch.no_grad():
            for target, value in moving.values():
                target.copy_(value)

    def _update(self, grads, lr, t):
        self.opt.fused_updates(self.names, self.weights, grads, self.states,
                               lr, t=t)

    def _step(self, x, y, lr, t):
        loss, grads, moving = self._grads(x, y)
        self._write_moving(moving)
        self._update(grads, lr, t)
        return loss

    def _next_lr(self):
        self._n += 1
        return (self.opt.lr_scheduler(self._n) if self.opt.lr_scheduler
                else self.opt.lr)

    # -- entry points ------------------------------------------------------

    def __call__(self, x, y):
        wrap = isinstance(x, NDArray)
        with _stepstats.phase("h2d"):
            x, y = self._to_device(x), self._to_device(y)
        self._ensure_built(x, y)
        lr = torch.tensor(self._next_lr(), dtype=torch.float32)
        t = torch.tensor(float(self._n), dtype=torch.float32)
        self.opt.num_update = self._n
        telem = _telemetry.enabled()
        sig = _compilereg.signature_of(x, y) if telem else None
        first = telem and not _compilereg.seen("GluonTrainStep.step", sig)
        t0 = time.perf_counter()
        with _stepstats.phase("dispatch"):
            loss = self._step(x, y, lr, t)
        if telem:
            # the first call of a signature stands for JAX's compile
            _compilereg.register(
                "GluonTrainStep.step", sig,
                compile_s=(time.perf_counter() - t0) if first else None)
            _stepstats.step_end()
        return NDArray._from_data(loss) if wrap else loss

    def _scan_fn(self, xs, ys, lrs, ts):
        return torch.stack([self._step(xs[k], ys[k], lrs[k], ts[k])
                            for k in range(xs.shape[0])])

    def _mutable(self):
        """Every tensor a step writes in place."""
        return self.weights + self.aux + _state_tensors(self.states)

    def scan_steps(self, xs, ys):
        """K training steps over xs[k], ys[k] (stacked on axis 0) in one
        call, with no host work between the steps; returns the K losses as
        one float32 tensor. Each step takes its own scheduled lr and
        update count, computed on the host before the call and handed in
        as device tensors.

        On CUDA the K steps are one CUDA graph per (xs, ys) signature: K
        steps unrolled, captured at the signature's first call (after one
        warm-up run of the K steps that leaves the weights, momenta and
        running stats as it found them) and replayed, after a
        device-to-device copy of xs, ys and the schedule into the graph's
        static inputs. On the CPU it is the same K steps, run eagerly."""
        xs, ys = self._to_device(xs), self._to_device(ys)
        self._ensure_built(xs[0], ys[0])
        lrs, ts = [], []
        for _ in range(xs.shape[0]):
            lrs.append(self._next_lr())
            ts.append(float(self._n))
        self.opt.num_update = self._n
        lrs = torch.tensor(lrs, dtype=torch.float32).to(self.device)
        ts = torch.tensor(ts, dtype=torch.float32).to(self.device)
        if self._scan is None:
            self._scan = graphs.wrap(
                "GluonTrainStep.scan", self._scan_fn, device=self.device,
                pool=graphs.Pool() if self.device.type == "cuda" else None,
                state=self._mutable, warmup_runs=1)
        losses = self._scan(xs, ys, lrs, ts)
        # the graph's static output is overwritten by the next replay
        return losses.clone() if self.device.type == "cuda" else losses

    def accum_steps(self, xs, ys):
        """K micro-batches (xs, ys stacked on axis 0) -> ONE optimizer
        update: each micro-batch's forward and backward in turn, with no
        host sync between them; the gradients summed in the parameters'
        dtype in micro-batch order from zeros (set rescale_grad to
        1/(micro_batch * K) for a mean over the effective batch); the BN
        running stats moved every micro-batch. Returns the mean loss,
        accumulated in at least float32."""
        xs, ys = self._to_device(xs), self._to_device(ys)
        self._ensure_built(xs[0], ys[0])
        k = xs.shape[0]
        lr = torch.tensor(self._next_lr(), dtype=torch.float32)
        t = torch.tensor(float(self._n), dtype=torch.float32)
        self.opt.num_update = self._n
        _compilereg.register("GluonTrainStep.accum",
                             _compilereg.signature_of(xs, ys))
        floats = [w.dtype for w in self.weights if w.is_floating_point()]
        acc_dt = torch.float32
        for dt in floats:
            acc_dt = torch.promote_types(acc_dt, dt)
        gsum = [torch.zeros_like(w) for w in self.weights]
        lsum = torch.zeros((), dtype=acc_dt, device=self.device)
        for i in range(k):
            loss, grads, moving = self._grads(xs[i], ys[i])
            self._write_moving(moving)
            for a, g in zip(gsum, grads):
                a.add_(g)
            lsum = lsum + loss.to(acc_dt)
        self._update(gsum, lr, t)
        return lsum / k

    # -- the state surface -------------------------------------------------

    def save_states(self, fname):
        """Pickle the optimizer states and the update count for resume,
        in the JAX package's format: {"n": int, "states": [numpy array or
        None, ...]}, one entry per trained parameter. A bfloat16 state is
        stored as float32 (numpy has no bfloat16 without ml_dtypes; every
        bfloat16 value is a float32 value, and a load casts it back), so
        the files of float32 nets are interchangeable with the JAX
        package's both ways. Parameters travel separately."""
        if not self._built:
            raise RuntimeError("save_states before the first step: "
                               "optimizer states do not exist yet")
        def host(s):
            if s is None:
                return None
            if isinstance(s, tuple):
                return tuple(host(p) for p in s)
            return s.detach().to("cpu", torch.float32
                                 if s.dtype == torch.bfloat16
                                 else s.dtype).numpy()

        states = [host(s) for s in self.states]
        with open(fname, "wb") as f:
            pickle.dump({"n": self._n, "states": states}, f)

    def load_states(self, fname):
        """Restore the optimizer states and the update count saved by
        `save_states` (the port's or the JAX package's). Before the first
        step the states are kept pending and loaded at the build."""
        with open(fname, "rb") as f:
            d = pickle.load(f)
        self._n = int(d["n"])
        self.opt.num_update = self._n
        if self._built:
            self._load_into_states(d["states"])
        else:
            self._pending_states = d["states"]

    def _load_into_states(self, arrays):
        if len(arrays) != len(self.states):
            raise ValueError(f"{len(arrays)} saved states for "
                             f"{len(self.states)} trained parameters")
        with torch.no_grad():
            for s, a in zip(self.states, arrays):
                if (s is None) != (a is None):
                    raise ValueError("saved states do not match the "
                                     "optimizer's (momentum or not)")
                for part, arr in zip(_state_tensors([s]),
                                     _state_tensors([a])):
                    part.copy_(torch.from_numpy(np.asarray(arr))
                               .reshape(part.shape))

    def sync_params(self):
        """A no-op: the port's step updates the net's parameters in place,
        so they are always current (the JAX step writes its arrays back
        here)."""

    def warmup(self, x, y):
        """Build the step for (x, y)-shaped batches and return "disabled":
        the port has no persistent compile or capture cache (the JAX
        package answers the same without MXTPU_COMPILE_CACHE_DIR)."""
        self._ensure_built(self._to_device(x), self._to_device(y))
        return "disabled"

    def cost_stats(self, x, y):
        """{}: the JAX package's answer when the backend exposes no cost
        model. PyTorch runs no compiler whose cost analysis could be
        read."""
        return {}

    def memory_stats(self, x, y, name="train_step"):
        """Device memory of one step on (x, y)-shaped batches, recorded for
        `profiler.dumps_memory()` under `name`, with the keys of the JAX
        package's `record_memory`. `argument_bytes` sums the parameters
        (running stats included), the optimizer states, x and y;
        `alias_bytes` is what the update writes in place (the parameters
        and the states); `output_bytes` that plus the loss. On CUDA,
        `temp_bytes` is the caching allocator's peak over one forward and
        backward (which write nothing: weights, momenta and running stats
        stay as they were) above what was allocated before it; on the CPU,
        which keeps no allocator statistics, it is 0. `peak_bytes` is
        arguments + outputs + temporaries - aliased bytes, as in JAX."""
        x, y = self._to_device(x), self._to_device(y)
        self._ensure_built(x, y)
        temp = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            loss, grads, _ = self._grads(x, y)
            torch.cuda.synchronize(self.device)
            temp = torch.cuda.max_memory_allocated(self.device) - base
            del loss, grads
        state = _nbytes(self.weights + self.aux
                        + _state_tensors(self.states))
        return profiler.record_memory(name, {
            "argument_bytes": state + _nbytes([x, y]),
            "output_bytes": state + 4,
            "temp_bytes": temp,
            "alias_bytes": state})
