"""Optimizers (`incubator_mxnet_tpu/optimizer.py`): the registry
(`register`, `create`), the `Optimizer` base with its learning-rate and
weight-decay multipliers and update counts, `Updater` / `get_updater`,
and the 16 optimizers of JAX's registry: SGD (with momentum,
multi-precision and stochastic rounding), NAG, SGLD, Signum, FTML,
DCASGD, LBSGD, Adam, AdaGrad, RMSProp (plain and centered), AdaDelta,
Ftrl, Adamax, Nadam, AdamW and Test.

Each optimizer has two paths, as in the JAX package:

- the eager `update(index, weight, grad, state)` over NDArrays, through
  the registry's update ops (`ops/optimizer.py`) where JAX's calls
  `_call(...)`, else the same inline math; the results are written into
  the weight's and the states' tensors in place, so a gluon Parameter
  keeps its tensor. `update_multi_precision` routes SGD's (momentum,
  float32 master) states through `mp_sgd_update` / `mp_sgd_mom_update`
  and its stochastic-rounding states through `_sgd_sr_math`.
- the fused `fused_updates(names, weights, grads, states, lr, t=None)`
  over tensors, the batched form of JAX's `_*_fused`, which
  `GluonTrainStep` and the Trainer's aggregated path run: `lr` is a
  Python float or a 0-d float32 tensor (a CUDA graph's static input) and
  `t` the update count (a float32 tensor from a train step, else
  `num_update`). Parameters that share a dtype, a device, an lr
  multiplier, a weight decay and a state layout form a group; an
  elementwise optimizer runs its math (`_step`) once on the group's
  weights, gradients and states gathered into one flat float32 tensor
  each and copies the results back (states first, then weights), so a
  step issues a few dozen device launches in place of a dozen per
  parameter. Each element goes through the same operations as on its
  own; a value per parameter (LBSGD's trust ratio, Nadam's schedule,
  SGLD's and stochastic rounding's hash keys) is repeated over its
  parameter's elements. A low-precision weight is updated in float32 and
  rounded once. `fused_update(name, weight, grad,
  state, lr, t=None)` is the one-parameter form. A user's optimizer that
  defines only `update` runs that through `_generic_fused`, with the
  step's lr in place of its own for the call.

SGD keeps its own fused groups: a float32 group
runs each operation once for the whole group (`torch._foreach_*`); a
low-precision group without a master reproduces, rounding for rounding,
what XLA compiles from JAX's `_sgd_fused` under `jax.jit` (the weakly
typed constants round to the weight's dtype; g = rescale_grad * grad
(clipped) and wd * w each round to it; their sum, the momentum's decay,
the lr product and the new weight stay float32, one rounding at the
end). With `multi_precision` a low-precision weight carries (momentum,
float32 master) and the math runs on the master; with
`MXTPU_STOCHASTIC_ROUNDING` a plain SGD's bfloat16 weight carries a
float32 momentum and no master, and the new weight is rounded
stochastically (`stochastic_round_bf16`) from bits that a counter-based
hash draws from (seed, t, crc32(name), element index): the eager,
aggregated and fused paths, the CPU and the card draw the same bits,
also inside a CUDA graph. JAX draws them from threefry, so the bits
differ; the rounding is unbiased in both. SGLD's fused noise comes from
the same hash (JAX: a fold_in key); its eager noise from the global
random state.

`fused_matches_eager` is False for Nadam (the eager path's m_schedule is
one Python float advanced once per parameter update) and SGLD (other
noise draws), as in JAX: the aggregated Trainer path then keeps them on
the per-parameter path.

`Updater` holds one state per parameter index (None, an NDArray, or a
tuple of them and None); its `get_states` pickles {index: numpy array |
tuple | None}, the JAX package's format (a bfloat16 state as float32),
so float32 state files are interchangeable both ways.

A row-sparse gradient (`ndarray.sparse.RowSparseNDArray`) takes the lazy
paths of SGD (with and without momentum), Adam and AdaGrad: only the
gradient's rows of the weight and the states move (duplicate row ids
summed first, `_sparse_grad_prep`). SGD with `lazy_update=False`, its
multi-precision and stochastic-rounding paths, and Adam with
`lazy_update=False` densify the gradient; the `Updater` densifies it
for an optimizer without a sparse path.
"""
from __future__ import annotations

import binascii
import functools
import math
import pickle
import warnings

import numpy as np
import torch

from . import config
from . import random as _global_random
from .ndarray.ndarray import NDArray
from .ndarray.register import invoke_by_name
from .ops.optimizer import one_minus_pow

__all__ = [
    "Optimizer", "SGD", "NAG", "SGLD", "Signum", "FTML", "DCASGD", "LBSGD",
    "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam",
    "AdamW", "Test", "Updater", "get_updater", "create", "register",
    "stochastic_round_bf16",
]

_LOW = (torch.bfloat16, torch.float16)
_REGISTRY = {}


def register(klass):
    """Register an optimizer class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (or the optimizer itself)."""
    if isinstance(name, Optimizer):
        return name
    return _REGISTRY[name.lower()](**kwargs)


# -- helpers over NDArrays or tensors ------------------------------------------

def _data(x):
    return x._data if isinstance(x, NDArray) else x


def _like(weight, tensor):
    """`tensor` as the kind of `weight`: an NDArray for an NDArray."""
    return NDArray._from_data(tensor) if isinstance(weight, NDArray) \
        else tensor


def _zeros(weight, dtype=None):
    d = _data(weight)
    return _like(weight, torch.zeros_like(
        d, dtype=dtype or d.dtype, memory_format=torch.preserve_format))


def _copy(weight, dtype=None):
    d = _data(weight).detach()
    return _like(weight, d.to(dtype or d.dtype, copy=True))


def _call(name, arrays, attrs):
    return invoke_by_name(name, arrays, attrs)


@torch.no_grad()
def _writeback(targets, results):
    """Write an op's results into the target NDArrays' tensors."""
    if isinstance(results, NDArray):
        results = [results]
    for t, r in zip(targets, results):
        t._data.copy_(r._data)


def _is_row_sparse(grad):
    from .ndarray.sparse import RowSparseNDArray
    return isinstance(grad, RowSparseNDArray)


def _sparse_grad_prep(opt, grad, device):
    """(rows, rescaled and clipped gradient block) of a row-sparse
    gradient for a lazy update, on `device`; duplicate row ids are summed
    into unique rows first (the state writes below are last-write-wins on
    repeats), unless the gradient is marked unique (a recorded lookup's
    is), which spares a sort and a host sync."""
    from .ndarray.sparse import _segment_sum

    idx = grad.indices._data.to(device)
    g = grad.data._data.to(device) * opt.rescale_grad
    if idx.numel() and not grad.unique:
        uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
        if uniq.numel() != idx.numel():
            g = _segment_sum(g, inv, uniq.numel())
            idx = uniq
    return idx, _clip(g, opt.clip_gradient)


def _clip(g, clip):
    return torch.clamp(g, -clip, clip) if clip else g


def _tensors(state):
    """The tensors of a state: None, a tensor, an NDArray or a tuple."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _tensors(s)]
    return [_data(state)]


def _layout(state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_layout(s) for s in state)
    return _data(state).dtype


def _flat(tensors, dtype=None):
    """One flat copy of `tensors` (in `dtype`, else at least float32)."""
    out = torch.cat([t.reshape(-1) for t in tensors])
    return out.to(dtype or torch.promote_types(out.dtype, torch.float32))


def _scatter(targets, flat):
    """Copy consecutive pieces of the 1-d `flat` into `targets`."""
    pieces = flat.split([t.numel() for t in targets])
    torch._foreach_copy_(targets, [p.view(t.shape)
                                   for p, t in zip(pieces, targets)])


def _t_or_eager(opt, t):
    """The update count, at least 1: a train step's float32 tensor as a
    float32 tensor (1 - beta^t then in float32, per replay), a host count
    (the Trainer's, else `num_update`) as a Python float (1 - beta^t in
    double precision, as the eager ops compute it)."""
    if t is None:
        t = opt.num_update
    if torch.is_tensor(t):
        return torch.clamp(t.to(torch.float32), min=1.0)
    return float(max(t, 1))


# -- the counter-based hash behind stochastic rounding and SGLD's fused noise -

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2^32 for x in [0, 2^32), a Python int or an int64
    tensor, without overflowing int64."""
    hi = ((x >> 16) * c) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * c) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


_SEGMENTS = {}
_KEYS = {}


def _segments(sizes, device):
    """(sizes, offsets, total) of consecutive parameters in one flat
    tensor, the first two as int64 tensors on `device`, cached: made
    outside a CUDA graph's capture (at its warm-up run) and only read
    inside it."""
    key = (tuple(sizes), str(device))
    seg = _SEGMENTS.get(key)
    if seg is None:
        if len(_SEGMENTS) > 64:
            _SEGMENTS.clear()
        n = torch.tensor(list(sizes), dtype=torch.int64)
        seg = _SEGMENTS[key] = (n.to(device), (torch.cumsum(n, 0) - n)
                                .to(device), int(n.sum()))
    return seg


def _expand(per_param, sizes, device):
    """A value per parameter repeated over each parameter's elements."""
    n, _, total = _segments(sizes, device)
    return torch.repeat_interleave(per_param, n, output_size=total)


def _hash_keys(seed, names, stream, device):
    """One key per parameter, mixed on the host from (seed, crc32(name),
    stream), as an int64 tensor on `device` (cached as `_segments`)."""
    key = (int(seed), tuple(str(n) for n in names), stream, str(device))
    keys = _KEYS.get(key)
    if keys is None:
        if len(_KEYS) > 64:
            _KEYS.clear()
        keys = _KEYS[key] = torch.tensor(
            [_mix32((int(seed) * 0x9E3779B1
                     + (binascii.crc32(str(n).encode()) & 0x7FFFFFFF)
                     + stream * 0x632BE5AB) & _M32) for n in names],
            dtype=torch.int64).to(device)
    return keys


def _hash_bits(seed, t, names, sizes, device, stream=0):
    """One uint32 (in int64) per element of the parameters `names` of
    `sizes` laid end to end, from (seed, t, crc32(name), the element's
    index in its parameter, stream). `t` (an int, or a 0-d tensor, on the
    device inside a CUDA graph) enters as a scalar operand, so the bits
    are the same on every device, for any grouping of the parameters,
    with no copy to the device in a capture."""
    n, off, total = _segments(sizes, device)
    keys = _hash_keys(seed, names, stream, device)
    idx = torch.arange(total, device=device, dtype=torch.int64)
    if len(sizes) > 1:
        idx = idx - torch.repeat_interleave(off, n, output_size=total)
        keys = torch.repeat_interleave(keys, n, output_size=total)
    t = t.to(torch.int64) if torch.is_tensor(t) else int(t)
    x = _mix32((idx ^ keys) & _M32)
    return _mix32((x + _mul32(t & _M32, 0x85EBCA6B)) & _M32)


def stochastic_round_bf16(x32, bits):
    """Round float32 to bfloat16 with probability proportional to the
    distance to each neighbouring bfloat16 value: add the low 16 bits of
    `bits` (uint32 in int64, one per element) to the float32 bit pattern
    and truncate the low half. Values already in bfloat16 never change;
    non-finite values pass through."""
    u = x32.contiguous().view(torch.int32).to(torch.int64) & _M32
    r = (u + (bits.view(x32.shape) & 0xFFFF)) & 0xFFFF0000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    out = torch.where(torch.isfinite(x32), r.view(torch.float32), x32)
    return out.to(torch.bfloat16)


def _normal_noise(opt, t, names, sizes, device):
    """Standard normal draws per element from the hash (Box-Muller over
    two 24-bit uniforms)."""
    seed = getattr(opt, "fused_seed", 0)
    u1 = ((_hash_bits(seed, t, names, sizes, device, 1) >> 8).float()
          + 1.0) / 16777216.0
    u2 = (_hash_bits(seed, t, names, sizes, device, 2) >> 8).float() \
        / 16777216.0
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


class Optimizer:
    """The base: hyper-parameters, per-parameter multipliers, update
    counts and the generic fused path."""

    # the fused path reproduces `update` step for step: the aggregated
    # Trainer path relies on it (SGLD and Nadam turn it off)
    fused_matches_eager = True
    # `update` takes a RowSparseNDArray gradient (the Updater densifies
    # one for an optimizer without that path)
    row_sparse_update = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, **kwargs):
        if sym is not None:
            raise NotImplementedError("Optimizer(sym=...) waits for the "
                                      "symbolic slice (ROADMAP Queue A 6)")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.aggregate_num = 0

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        return self.create_state(index, weight)

    def create_fused_state(self, index, weight):
        """The fused path's state for a weight tensor."""
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight")
                                or n.endswith("_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _base_lr(self):
        return (self.lr_scheduler(self.num_update)
                if self.lr_scheduler is not None else self.lr)

    def _get_lr(self, index):
        return self._base_lr() * self._mults(self.idx2name.get(index,
                                                               index))[0]

    def _get_wd(self, index):
        return self._mults(self.idx2name.get(index, index))[1]

    def _mults(self, name):
        """(lr_mult, wd) for the parameter `name`: a `param_dict` entry
        takes priority over the `lr_mult` / `wd_mult` dicts."""
        if name in self.param_dict:
            return (self.param_dict[name].lr_mult,
                    self.wd * self.param_dict[name].wd_mult)
        return (self.lr_mult.get(name, 1.0),
                self.wd * self.wd_mult.get(name, 1.0))

    def _common_attrs(self, index):
        return dict(lr=self._get_lr(index), wd=self._get_wd(index),
                    rescale_grad=self.rescale_grad,
                    clip_gradient=(self.clip_gradient if self.clip_gradient
                                   else -1.0))

    def _prep(self, grad):
        """rescale_grad * grad, clipped (a float32 tensor)."""
        return _clip(grad * self.rescale_grad, self.clip_gradient)

    # -- the fused path ------------------------------------------------------

    def fused_update(self, name, weight, grad, state, lr, t=None):
        """One step on `weight` (and its `state`), in place."""
        self.fused_updates([name], [weight], [grad], [state], lr, t=t)

    @torch.no_grad()
    def fused_updates(self, names, weights, grads, states, lr, t=None):
        """One step on every (name, weight, grad, state), in place. The
        base runs each parameter's eager `update` (`_generic_fused`)."""
        for args in zip(names, weights, grads, states):
            _generic_fused(self, *args, lr)


def _generic_fused(opt, name, weight, grad, state, lr):
    """A user's optimizer that defines only `update`: its eager update on
    NDArray views of the tensors, with the step's `lr` as `opt.lr` (and
    no scheduler) for the call; what it rebinds is copied back in place.
    Anything `update` reads from Python state (update counts, host random
    draws) is as the host has it, not per scanned step."""
    def wrap(s):
        if isinstance(s, (tuple, list)):
            return tuple(wrap(e) for e in s)
        return None if s is None else NDArray._from_data(s)

    w, st = NDArray._from_data(weight), wrap(state)
    old_lr, old_sched = opt.lr, opt.lr_scheduler
    opt.lr, opt.lr_scheduler = lr, None
    try:
        opt.update(name, w, NDArray._from_data(grad), st)
    finally:
        opt.lr, opt.lr_scheduler = old_lr, old_sched
    for old, new in zip([weight] + _tensors(state), [w._data]
                        + _tensors(st)):
        if new is not old:
            old.copy_(new)


class _Fused(Optimizer):
    """An optimizer whose fused path is its pure `_step` math over flat
    float32 tensors, run once per group: `sizes` are the group's
    parameter sizes, in the order their elements lie in the flat tensors
    (per-parameter values go through `_expand`), and a state part of one
    value per parameter (Nadam's schedule) is a flat tensor of them."""

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        """(new weight, new state) from float32 tensors."""
        raise NotImplementedError

    @torch.no_grad()
    def fused_updates(self, names, weights, grads, states, lr, t=None):
        groups = {}
        for name, w, g, s in zip(names, weights, grads, states):
            lr_mult, wd = self._mults(name)
            key = (w.dtype, w.device, lr_mult, wd, _layout(s))
            groups.setdefault(key, []).append((name, w, g, s))
        for (_, _, lr_mult, wd, _), group in groups.items():
            self._run(group, lr if lr_mult == 1.0 else lr * lr_mult, wd, t)

    def _run(self, batch, lr, wd, t):
        names, ws, gs, ss = (list(c) for c in zip(*batch))
        w, g = _flat(ws), _flat(gs)
        s = _flat_state(ss)
        new_w, new_s = self._step(names, [x.numel() for x in ws], w, g, s,
                                  lr, wd, t)
        _scatter_state(ss, new_s)
        _scatter(ws, new_w.to(ws[0].dtype))


def _flat_state(states):
    first = states[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return tuple(_flat_state([s[k] for s in states])
                     for k in range(len(first)))
    return _flat(states)


def _scatter_state(states, new):
    first = states[0]
    if first is None or new is None:
        return
    if isinstance(first, (tuple, list)):
        for k in range(len(first)):
            _scatter_state([s[k] for s in states], new[k])
        return
    _scatter(states, new.to(first.dtype))


@functools.lru_cache(maxsize=None)
def _weak(value, dtype):
    """A Python constant as JAX's weak typing hands it to an op on a
    `dtype` array: rounded to that dtype."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


# -- the optimizers ------------------------------------------------------------

@register
class SGD(Optimizer):
    """SGD with momentum and weight decay; multi-precision and
    stochastic-rounding variants for low-precision weights."""

    def __init__(self, momentum=0.0, lazy_update=True,
                 stochastic_rounding=None, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update
        if stochastic_rounding is None:
            stochastic_rounding = config.get("MXTPU_STOCHASTIC_ROUNDING")
        self.stochastic_rounding = bool(stochastic_rounding)

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _sr_active(self, weight):
        """The master-free stochastic-rounding path: plain SGD on
        bfloat16 weights only."""
        return (type(self) is SGD and self.stochastic_rounding
                and _data(weight).dtype == torch.bfloat16)

    def create_state_multi_precision(self, index, weight):
        """(momentum or None, float32 master) for a low-precision weight
        under multi_precision; a float32 momentum alone (or None) for a
        bfloat16 weight under stochastic rounding."""
        if self._sr_active(weight):
            return (_zeros(weight, torch.float32) if self.momentum != 0.0
                    else None)
        if self.multi_precision and _data(weight).dtype in _LOW:
            w32 = _copy(weight, torch.float32)
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    create_fused_state = create_state_multi_precision
    row_sparse_update = True

    def update_multi_precision(self, index, weight, grad, state):
        if not isinstance(state, tuple):
            if self._sr_active(weight):
                self._sr_update(index, weight, grad, state)
                return
            self.update(index, weight, grad, state)
            return
        mom, w32 = state
        self._update_count(index)
        attrs = self._common_attrs(index)
        if _is_row_sparse(grad):
            grad = grad.todense()  # the master-copy path has no lazy form
        if mom is not None:
            _writeback([weight, mom, w32], _call(
                "mp_sgd_mom_update", [weight, grad, mom, w32],
                {**attrs, "momentum": self.momentum}))
        else:
            _writeback([weight, w32],
                       _call("mp_sgd_update", [weight, grad, w32], attrs))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_attrs(index)
        if _is_row_sparse(grad):
            if self.lazy_update:
                self._lazy_update(weight, grad, state, attrs["lr"],
                                  attrs["wd"])
                return
            grad = grad.todense()
        if state is not None:
            _writeback([weight, state], _call(
                "sgd_mom_update", [weight, grad, state],
                {**attrs, "momentum": self.momentum}))
        else:
            _writeback([weight], _call("sgd_update", [weight, grad], attrs))

    @torch.no_grad()
    def _lazy_update(self, weight, grad, state, lr, wd):
        """Only the gradient's rows of the weight (and the momentum)
        move."""
        w = weight._data
        rows, g = _sparse_grad_prep(self, grad, w.device)
        g = g + wd * w[rows]
        if state is not None:
            m = state._data
            m_rows = self.momentum * m[rows] - lr * g
            m[rows] = m_rows
            w[rows] = w[rows] + m_rows
        else:
            w[rows] = w[rows] + (-lr * g)

    @torch.no_grad()
    def _sr_update(self, index, weight, grad, state):
        """The eager master-free bfloat16 step: `_sgd_sr_math` with the
        (seed, t, name) bits of the fused path."""
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        name = self.idx2name.get(index, index)
        if _is_row_sparse(grad):
            grad = grad.todense()  # no lazy stochastic-rounding form
        w = weight._data
        new_w, new_m = self._sgd_sr_math(
            [name], w.reshape(-1), grad._data.reshape(-1),
            None if state is None else state._data.reshape(-1), lr, wd, t)
        if state is not None:
            state._data.copy_(new_m.view(state._data.shape))
        w.copy_(new_w.view(w.shape))

    def _sgd_sr_math(self, names, w, g, mom, lr, wd, t, sizes=None):
        """The stochastic-rounding step on flat tensors: the math in
        float32, the new weight rounded stochastically to bfloat16."""
        w32 = w.float()
        g = _clip(g.float() * self.rescale_grad, self.clip_gradient)
        g = g + wd * w32
        if self.momentum != 0.0 and mom is not None:
            mom = self.momentum * mom - lr * g
            new_w32 = w32 + mom
        else:
            new_w32 = w32 - lr * g
        bits = _hash_bits(getattr(self, "fused_seed", 0), t, names,
                          sizes or [w.numel()], w.device)
        return stochastic_round_bf16(new_w32, bits), mom

    @torch.no_grad()
    def fused_updates(self, names, weights, grads, states, lr, t=None):
        """One step on each weight (and its state), in place, batched by
        group (module docstring); `t` is read by stochastic rounding
        only."""
        if not torch.is_tensor(lr):
            lr = torch.tensor(lr, dtype=torch.float32)
        groups = {}
        for name, w, g, s in zip(names, weights, grads, states):
            lr_mult, wd = self._mults(name)
            if isinstance(s, tuple):
                kind = "mp"
            elif self._sr_active(w):
                kind = "sr"
            else:
                kind = "low" if w.dtype in _LOW else "full"
            momentum = self.momentum != 0.0 and bool(_tensors(s)) and (
                kind != "mp" or s[0] is not None)
            key = (w.dtype, w.device, lr_mult, wd, momentum, kind)
            groups.setdefault(key, []).append((name, w, g, s))
        for (dt, _, lr_mult, wd, momentum, kind), group in groups.items():
            gnames, ws, gs, ss = (list(c) for c in zip(*group))
            glr = lr if lr_mult == 1.0 else lr * lr_mult
            if kind == "mp":
                self._update_mp(ws, gs, ss, momentum, glr, wd)
            elif kind == "sr":
                self._update_sr(gnames, ws, gs, ss if momentum else None,
                                glr, wd, t)
            elif kind == "low":
                self._update_low(dt, ws, gs, ss if momentum else None, glr,
                                 wd)
            else:
                self._update_full(ws, gs, ss if momentum else None, glr, wd)

    def _update_full(self, ws, gs, ss, lr, wd):
        if lr.device.type == "cpu":
            lr = float(lr)  # the same float32 value, as a scalar operand
        g = torch._foreach_mul(gs, self.rescale_grad)
        if self.clip_gradient:
            torch._foreach_clamp_min_(g, -self.clip_gradient)
            torch._foreach_clamp_max_(g, self.clip_gradient)
        torch._foreach_add_(g, torch._foreach_mul(ws, wd))
        step = torch._foreach_mul(g, lr)
        if ss is not None:
            torch._foreach_mul_(ss, self.momentum)
            torch._foreach_sub_(ss, step)
            torch._foreach_add_(ws, ss)
        else:
            torch._foreach_sub_(ws, step)

    def _update_low(self, dt, ws, gs, ss, lr, wd):
        w = _flat(ws, dt)
        g = (_flat(gs) * _weak(self.rescale_grad, dt)).to(dt)
        if self.clip_gradient:
            g = g.clamp(_weak(-self.clip_gradient, dt),
                        _weak(self.clip_gradient, dt))
        g = g.float() + (w.float() * _weak(wd, dt)).to(dt).float()
        if ss is not None:
            mom = _flat(ss) * _weak(self.momentum, dt) - lr * g
            _scatter(ws, (w.float() + mom).to(dt))
            _scatter(ss, mom.to(dt))
        else:
            _scatter(ws, (w.float() - lr * g).to(dt))

    def _update_mp(self, ws, gs, ss, momentum, lr, wd):
        """(momentum, float32 master) states: `mp_sgd(_mom)_update`'s
        math on the masters, the weights refreshed by a cast."""
        w32s = [s[1] for s in ss]
        w32 = _flat(w32s)
        g = _clip(_flat(gs) * self.rescale_grad, self.clip_gradient)
        g = g + wd * w32
        if momentum:
            moms = [s[0] for s in ss]
            mom = self.momentum * _flat(moms) - lr * g
            new = w32 + mom
            _scatter(moms, mom)
        else:
            new = w32 - lr * g
        _scatter(w32s, new)
        _scatter(ws, new.to(ws[0].dtype))

    def _update_sr(self, names, ws, gs, ss, lr, wd, t):
        t = self.num_update if t is None else t
        new_w, new_m = self._sgd_sr_math(
            names, _flat(ws, torch.bfloat16), _flat(gs),
            None if ss is None else _flat(ss), lr, wd, t,
            sizes=[w.numel() for w in ws])
        if ss is not None:
            _scatter(ss, new_m)
        _scatter(ws, new_w)


@register
class NAG(_Fused):
    """Nesterov accelerated SGD."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_attrs(index)
        if state is not None:
            _writeback([weight, state], _call(
                "nag_mom_update", [weight, grad, state],
                {**attrs, "momentum": self.momentum}))
        else:
            _writeback([weight], _call("sgd_update", [weight, grad], attrs))

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        g = self._prep(g) + wd * w
        if self.momentum != 0.0 and s is not None:
            mom = self.momentum * s + g
            return w - lr * (g + self.momentum * mom), mom
        return w - lr * g, None


@register
class SGLD(_Fused):
    """Stochastic gradient Langevin dynamics: the eager path draws its
    noise from the global random state, the fused path from the (seed,
    t, name) hash."""

    fused_matches_eager = False

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        g = self._prep(grad._data)
        gen = _global_random.next_generator(w.device)
        noise = torch.randn(w.shape, generator=gen, device=w.device,
                            dtype=w.dtype) * math.sqrt(lr)
        w.copy_(w - lr / 2 * (g + wd * w) + noise)

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        g = self._prep(g)
        noise = _normal_noise(self, _t_or_eager(self, t), names, sizes,
                              w.device)
        sqrt_lr = torch.sqrt(torch.as_tensor(lr, dtype=torch.float32))
        return w - lr / 2 * (g + wd * w) + noise * sqrt_lr, None


@register
class Signum(_Fused):
    """SignSGD with momentum (signum) or without (signsgd)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_attrs(index)
        if state is not None:
            _writeback([weight, state], _call(
                "signum_update", [weight, grad, state],
                {**attrs, "momentum": self.momentum, "wd_lh": self.wd_lh}))
        else:
            _writeback([weight], _call("signsgd_update", [weight, grad],
                                       attrs))

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        g = self._prep(g)
        if s is not None:
            mom = self.momentum * s - (1 - self.momentum) * (g + wd * w)
            return w * (1 - lr * self.wd_lh) + lr * torch.sign(mom), mom
        return w - lr * (torch.sign(g) + wd * w), None


@register
class FTML(_Fused):
    """Follow The Moving Leader."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        attrs = self._common_attrs(index)
        attrs.pop("clip_gradient")
        d, v, z = state
        _writeback([weight, d, v, z], _call(
            "ftml_update", [weight, grad, d, v, z],
            {**attrs, "beta1": self.beta1, "beta2": self.beta2,
             "epsilon": self.epsilon, "t": t,
             "clip_grad": self.clip_gradient if self.clip_gradient
             else -1.0}))

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        t = _t_or_eager(self, t)
        d, v, z = s
        g = self._prep(g) + wd * w
        v = self.beta2 * v + (1 - self.beta2) * torch.square(g)
        d_t = (one_minus_pow(self.beta1, t) / lr
               * (torch.sqrt(v / one_minus_pow(self.beta2, t))
                  + self.epsilon))
        sigma = d_t - self.beta1 * d
        z = self.beta1 * z + (1 - self.beta1) * g - sigma * w
        return -z / d_t, (d_t, v, z)


@register
class DCASGD(_Fused):
    """Delay-compensated asynchronous SGD."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = _zeros(weight) if self.momentum else None
        return (mom, _copy(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        g = self._prep(grad._data)
        mom, prev = state
        comp = g + wd * w + self.lamda * g * g * (w - prev._data)
        if mom is not None:
            mom._data.copy_(self.momentum * mom._data - lr * comp)
            upd = mom._data
        else:
            upd = -lr * comp
        prev._data.copy_(w)
        w.copy_(w + upd)

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        g = self._prep(g)
        mom, prev = s
        comp = g + wd * w + self.lamda * g * g * (w - prev)
        if mom is not None:
            mom = self.momentum * mom - lr * comp
            return w + mom, (mom, w)
        return w - lr * comp, (None, w)


@register
class LBSGD(SGD):
    """Large-batch SGD with a LARS trust ratio per parameter."""

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(momentum=momentum, **kwargs)
        self.warmup_strategy = warmup_strategy

    create_fused_state = SGD.create_state
    fused_updates = _Fused.fused_updates
    _run = _Fused._run
    row_sparse_update = False

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        new_w, new_m = self._step(
            None, [w.numel()], w.reshape(-1), grad._data.reshape(-1),
            None if state is None else state._data.reshape(-1), lr, wd, None)
        if state is not None:
            state._data.copy_(new_m.view(state._data.shape))
        w.copy_(new_w.view(w.shape))

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        """The LARS trust ratio per parameter; each norm accumulates in
        float64, so the CPU and the card (whose float32 reductions add in
        other orders) give the same ratio."""
        g = self._prep(g)

        def norms(x):
            return torch.stack([torch.linalg.vector_norm(
                p, dtype=torch.float64) for p in x.split(sizes)]).float()

        wnorm, gnorm = norms(w), norms(g)
        ratio = torch.where((wnorm > 0) & (gnorm > 0),
                            wnorm / (gnorm + wd * wnorm + 1e-9),
                            torch.ones_like(wnorm))
        eff_lr = lr * _expand(ratio, sizes, w.device)
        if s is not None:
            mom = self.momentum * s - eff_lr * (g + wd * w)
            return w + mom, mom
        return w - eff_lr * (g + wd * w), None


@register
class Adam(_Fused):
    """Adam with bias-corrected lr: lr * sqrt(1 - beta2^t) / (1 -
    beta1^t), with 1 - beta^t computed as -expm1(t log beta) on the fused
    path."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    row_sparse_update = True

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        attrs = self._common_attrs(index)
        attrs["lr"] = (attrs["lr"] * math.sqrt(1.0 - self.beta2 ** t)
                       / (1.0 - self.beta1 ** t))
        mean, var = state
        if _is_row_sparse(grad):
            if self.lazy_update:
                self._lazy_update(weight, grad, mean, var, attrs["lr"],
                                  attrs["wd"])
                return
            grad = grad.todense()
        _writeback([weight, mean, var], _call(
            "adam_update", [weight, grad, mean, var],
            {**attrs, "beta1": self.beta1, "beta2": self.beta2,
             "epsilon": self.epsilon}))

    @torch.no_grad()
    def _lazy_update(self, weight, grad, mean, var, lr, wd):
        """Moments and weight move only at the gradient's rows."""
        w = weight._data
        rows, g = _sparse_grad_prep(self, grad, w.device)
        g = g + wd * w[rows]
        m_rows = self.beta1 * mean._data[rows] + (1 - self.beta1) * g
        v_rows = (self.beta2 * var._data[rows]
                  + (1 - self.beta2) * torch.square(g))
        mean._data[rows] = m_rows
        var._data[rows] = v_rows
        w[rows] = w[rows] + (-lr * m_rows
                             / (torch.sqrt(v_rows) + self.epsilon))

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        t = _t_or_eager(self, t)
        g = self._prep(g) + wd * w
        mean, var = s
        mean = self.beta1 * mean + (1 - self.beta1) * g
        var = self.beta2 * var + (1 - self.beta2) * torch.square(g)
        c2 = one_minus_pow(self.beta2, t)
        lr_t = (lr * (torch.sqrt(c2) if torch.is_tensor(c2) else
                      math.sqrt(c2)) / one_minus_pow(self.beta1, t))
        return w - lr_t * mean / (torch.sqrt(var) + self.epsilon), \
            (mean, var)


@register
class AdaGrad(_Fused):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    row_sparse_update = True

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if _is_row_sparse(grad):
            # history and weight move only at the gradient's rows
            w, h = weight._data, state._data
            rows, g = _sparse_grad_prep(self, grad, w.device)
            g = g + wd * w[rows]
            h_rows = h[rows] + torch.square(g)
            h[rows] = h_rows
            w[rows] = w[rows] + (-lr * g / (torch.sqrt(h_rows)
                                            + self.float_stable_eps))
            return
        new_w, new_h = self._step(None, None, weight._data, grad._data,
                                  state._data, lr, wd, None)
        state._data.copy_(new_h)
        weight._data.copy_(new_w)

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        g = self._prep(g) + wd * w
        h = s + torch.square(g)
        return w - lr * g / (torch.sqrt(h) + self.float_stable_eps), h


@register
class RMSProp(_Fused):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2, self.epsilon = gamma1, gamma2, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_attrs(index)
        attrs["clip_weights"] = self.clip_weights if self.clip_weights \
            else -1.0
        if self.centered:
            n, g, delta = state
            _writeback([weight, n, g, delta], _call(
                "rmspropalex_update", [weight, grad, n, g, delta],
                {**attrs, "gamma1": self.gamma1, "gamma2": self.gamma2,
                 "epsilon": self.epsilon}))
        else:
            _writeback([weight, state], _call(
                "rmsprop_update", [weight, grad, state],
                {**attrs, "gamma1": self.gamma1, "epsilon": self.epsilon}))

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        gr = self._prep(g) + wd * w
        g1 = self.gamma1
        if self.centered:
            n, gm, delta = s
            n = (1 - g1) * torch.square(gr) + g1 * n
            gm = (1 - g1) * gr + g1 * gm
            delta = self.gamma2 * delta - lr * gr / torch.sqrt(
                n - torch.square(gm) + self.epsilon)
            new_w, new_s = w + delta, (n, gm, delta)
        else:
            n = (1 - g1) * torch.square(gr) + g1 * s
            new_w, new_s = w - lr * gr / torch.sqrt(n + self.epsilon), n
        if self.clip_weights:
            new_w = torch.clamp(new_w, -self.clip_weights, self.clip_weights)
        return new_w, new_s


@register
class AdaDelta(_Fused):
    """AdaDelta (ignores the learning rate)."""

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        new_w, (acc_g, acc_d) = self._step(
            None, None, weight._data, grad._data,
            (state[0]._data, state[1]._data), None, wd, None)
        state[0]._data.copy_(acc_g)
        state[1]._data.copy_(acc_d)
        weight._data.copy_(new_w)

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        g = self._prep(g)
        acc_g, acc_delta = s
        acc_g = self.rho * acc_g + (1 - self.rho) * torch.square(g)
        delta = (torch.sqrt(acc_delta + self.epsilon)
                 / torch.sqrt(acc_g + self.epsilon) * g)
        acc_delta = self.rho * acc_delta + (1 - self.rho) * torch.square(
            delta)
        return w - delta - wd * w, (acc_g, acc_delta)


@register
class Ftrl(_Fused):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_attrs(index)
        z, n = state
        _writeback([weight, z, n], _call(
            "ftrl_update", [weight, grad, z, n],
            {**attrs, "lamda1": self.lamda1, "beta": self.beta}))

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        g = self._prep(g)
        z, n = s
        new_n = n + torch.square(g)
        sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
        z = z + g - sigma * w
        new_w = torch.where(
            torch.abs(z) > self.lamda1,
            -(z - torch.sign(z) * self.lamda1)
            / ((self.beta + torch.sqrt(new_n)) / lr + wd),
            torch.zeros_like(w))
        return new_w, (z, new_n)


@register
class Adamax(_Fused):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        wd = self._get_wd(index)
        w = weight._data
        g = _clip(grad._data * self.rescale_grad + wd * w,
                  self.clip_gradient)
        m, u = state
        m._data.copy_(self.beta1 * m._data + (1 - self.beta1) * g)
        u._data.copy_(torch.maximum(self.beta2 * u._data, torch.abs(g)))
        w.copy_(w - lr * m._data / (u._data + 1e-8))

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        lr = lr / one_minus_pow(self.beta1, _t_or_eager(self, t))
        g = _clip(g * self.rescale_grad + wd * w, self.clip_gradient)
        m, u = s
        m = self.beta1 * m + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * u, torch.abs(g))
        return w - lr * m / (u + 1e-8), (m, u)


@register
class Nadam(_Fused):
    """Nadam. The eager path's m_schedule is one Python float advanced at
    every parameter update (the reference's quirk); the fused path
    carries a per-parameter m_schedule in its state."""

    fused_matches_eager = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def create_fused_state(self, index, weight):
        d = _data(weight)
        return (_zeros(weight), _zeros(weight),
                _like(weight, torch.ones((), dtype=d.dtype,
                                         device=d.device)))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        g = _clip(grad._data * self.rescale_grad + wd * w,
                  self.clip_gradient)
        sd = self.schedule_decay
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * sd))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * sd))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        g_prime = g / (1.0 - self.m_schedule)
        m._data.copy_(self.beta1 * m._data + (1.0 - self.beta1) * g)
        v._data.copy_(self.beta2 * v._data
                      + (1.0 - self.beta2) * torch.square(g))
        m_prime = m._data / (1.0 - m_schedule_next)
        v_prime = v._data / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        w.copy_(w - lr * m_bar / (torch.sqrt(v_prime) + self.epsilon))

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        t = _t_or_eager(self, t)
        g = _clip(g * self.rescale_grad + wd * w, self.clip_gradient)
        m, v, m_sched = s
        sd = self.schedule_decay
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * sd))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * sd))
        m_sched = m_sched * momentum_t  # one per parameter
        m_sched_next = m_sched * momentum_t_1
        g_prime = g / _expand(1.0 - m_sched, sizes, w.device)
        m = self.beta1 * m + (1.0 - self.beta1) * g
        v = self.beta2 * v + (1.0 - self.beta2) * torch.square(g)
        m_prime = m / _expand(1.0 - m_sched_next, sizes, w.device)
        v_prime = v / one_minus_pow(self.beta2, t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        return (w - lr * m_bar / (torch.sqrt(v_prime) + self.epsilon),
                (m, v, m_sched))


@register
class AdamW(_Fused):
    """Adam with decoupled weight decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon, self.eta = (beta1, beta2,
                                                          epsilon, eta)

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_attrs(index)
        mean, var = state
        _writeback([weight, mean, var], _call(
            "adamw_update", [weight, grad, mean, var],
            {**attrs, "beta1": self.beta1, "beta2": self.beta2,
             "epsilon": self.epsilon, "eta": self.eta}))

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        g = self._prep(g)
        mean, var = s
        mean = self.beta1 * mean + (1 - self.beta1) * g
        var = self.beta2 * var + (1 - self.beta2) * torch.square(g)
        new_w = w - self.eta * (lr * mean / (torch.sqrt(var) + self.epsilon)
                                + wd * w)
        return new_w, (mean, var)


@register
class Test(_Fused):
    """w -= rescale_grad * grad (the reference's test optimizer)."""

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight._data.copy_(weight._data - self.rescale_grad * grad._data)

    def _step(self, names, sizes, w, g, s, lr, wd, t):
        return w - self.rescale_grad * g, s


# -- the Updater ---------------------------------------------------------------

def _to_device(state, device):
    """Move a state's NDArrays to `device` (states loaded before the
    first update)."""
    for s in (state if isinstance(state, tuple) else (state,)):
        if isinstance(s, tuple):
            _to_device(s, device)
        elif s is not None and s._data.device != device:
            s._data = s._data.to(device)


def _host(state):
    """A state as the JAX package pickles it (bfloat16 as float32)."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_host(s) for s in state)
    return state.asnumpy()


class Updater:
    """Applies an optimizer per parameter index, holding each index's
    state."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    def state(self, index, weight):
        """The state of `index`, made for `weight` (an NDArray) at the
        first call."""
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        s = self.states[index]
        _to_device(s, weight._data.device)
        return s

    def __call__(self, index, grad, weight):
        """One update of `weight` (an NDArray) by `grad`. What the
        optimizer rebinds instead of writing in place (a user's `update`)
        is copied back into the tensors the weight and the state held."""
        state = self.state(index, weight)
        if _is_row_sparse(grad) and not getattr(
                self.optimizer, "row_sparse_update", False):
            grad = grad.todense()
        before = [weight] + _arrays(state)
        held = [a._data for a in before]
        self.optimizer.update_multi_precision(index, weight, grad, state)
        with torch.no_grad():
            for a, t in zip(before, held):
                if a._data is not t:
                    t.copy_(a._data)
                    a._data = t

    def get_states(self, dump_optimizer=False):
        """The pickled states: {index: numpy array | tuple | None}."""
        if dump_optimizer:
            raise NotImplementedError(
                "get_states(dump_optimizer=True) would pickle the port's "
                "optimizer class, which the JAX package cannot load")
        return pickle.dumps({k: _host(v) for k, v in self.states.items()})

    def set_states(self, states_blob):
        """Restore `get_states` bytes (the port's or the JAX package's);
        states land on the device and in the dtype of the states they
        replace, else on their weight's at its next update."""
        states = pickle.loads(states_blob)
        if isinstance(states, tuple) and len(states) == 2:
            raise NotImplementedError("a states file with a dumped "
                                      "optimizer cannot be loaded here")

        def nd(v, old):
            if v is None:
                return None
            if isinstance(v, (tuple, list)):
                olds = old if isinstance(old, tuple) else (None,) * len(v)
                return tuple(nd(a, o) for a, o in zip(v, olds))
            t = torch.from_numpy(np.array(v))
            if old is not None:
                t = t.to(old._data.device, old._data.dtype)
            return NDArray._from_data(t)

        self.states = {k: nd(v, self.states.get(k))
                       for k, v in states.items()}
        self.states_synced = {k: True for k in self.states}


def _arrays(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _arrays(s)]
    return [state]


def get_updater(optimizer):
    return Updater(optimizer)


def warn_if_generic(opt):
    """Warn (as JAX's GluonTrainStep does) when `opt` has no fused path of
    its own and a train step would run its eager `update`."""
    if type(opt).fused_updates is Optimizer.fused_updates \
            and type(opt) is not Optimizer:
        warnings.warn(
            f"{type(opt).__name__} has no dedicated fused_update; running "
            f"its eager update() instead. Time-dependent or stochastic "
            f"optimizers should implement fused_updates(names, weights, "
            f"grads, states, lr, t=None).", RuntimeWarning)
