"""Optimizers (`incubator_mxnet_tpu/optimizer.py`): the registry
(`register`, `create`), the `Optimizer` base with its learning-rate and
weight-decay multipliers and update counts, `Updater` / `get_updater`,
`SGD` and `Adam`, with the fused updates `GluonTrainStep` and
`gluon.Trainer` apply. The other 14 optimizers are ROADMAP Queue A 3.

`fused_update` follows the JAX package's `_sgd_fused`: g = rescale_grad
* grad, clipped to +-clip_gradient when set, plus wd * w; with momentum,
mom = momentum * mom - lr * g and w += mom, else w -= lr * g. It updates
the weight and the momentum in place (the JAX step returns new arrays
and casts them back to their stored dtypes).

`lr` is a Python float or a 0-d float32 tensor (a CUDA graph's static
input, so that each replay reads its step's scheduled rate). Either way
it enters as float32, as JAX's step hands it in (`jnp.asarray(lr,
jnp.float32)`): a strong float32 operand, which promotes the update math
of a low-precision weight to float32. For a bfloat16 (or float16) weight
the update is the one XLA compiles from `_sgd_fused` under `jax.jit`,
rounding for rounding: the Python constants are weakly typed, so they
round to the weight's dtype; g = rescale_grad * grad (clipped) and wd *
w each round to it; their sum, the momentum's decay, the lr product and
the new weight stay float32 (XLA keeps excess precision there); the new
weight and momentum round once, at the end. For float32 weights it is
the same sequence of float32 operations.

`update` applies the same arithmetic to many parameters at once, as the
train step does: the parameters that share a dtype, an lr multiplier, a
weight decay and whether they carry momentum form one group. A float32
group runs each operation once for the whole group (`torch._foreach_*`);
a low-precision group gathers its weights, gradients and momenta into
one flat tensor each, runs the update on those and copies the results
back. Either way each element goes through the same operations in the
same order as `fused_update` on its own (bit-equal), and a step issues
a few dozen device launches in place of a dozen per parameter.

Per-parameter multipliers follow the JAX `_mults`: a `param_dict`
entry's `lr_mult` / `wd_mult` (a gluon `Parameter`'s) take priority,
else the `lr_mult` / `wd_mult` dicts, keyed by name (`set_lr_mult`;
`set_wd_mult` also zeroes the weight decay of every parameter of
`idx2name` whose name ends in neither `_weight` nor `_gamma`, as the
JAX package does). `num_update` is the largest per-index update count
(`_update_count`); a train step sets it itself, as JAX's does.

`Updater` holds one state per parameter index as NDArrays; its
`get_states` pickles {index: numpy array or None}, the JAX package's
format, so float32 state files are interchangeable both ways.
"""
from __future__ import annotations

import functools
import math
import pickle

import numpy as np
import torch

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register"]

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


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, **kwargs):
        if sym is not None:
            raise NotImplementedError("Optimizer(sym=...) waits for the "
                                      "symbolic slice")
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

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        return self.create_state(index, weight)

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
        """(lr_mult, wd) for the parameter `name`."""
        if name in self.param_dict:
            return (self.param_dict[name].lr_mult,
                    self.wd * self.param_dict[name].wd_mult)
        return (self.lr_mult.get(name, 1.0),
                self.wd * self.wd_mult.get(name, 1.0))

    def fused_update(self, name, weight, grad, state, lr, t=None):
        """One step on `weight` (and its `state`), in place."""
        self.update([name], [weight], [grad], [state], lr, t=t)

    def update(self, names, weights, grads, states, lr, t=None):
        """One step on every (name, weight, grad, state), in place."""
        raise NotImplementedError


@functools.lru_cache(maxsize=None)
def _weak(value, dtype):
    """A Python constant as JAX's weak typing hands it to an op on a
    `dtype` array: rounded to that dtype."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight,
                                    memory_format=torch.preserve_format)
        return None

    @torch.no_grad()
    def update(self, names, weights, grads, states, lr, t=None):
        """One step on each weight (and its momentum state), in place,
        batched by group (see the module docstring); `t` (the update
        count) is unused by SGD."""
        if not torch.is_tensor(lr):
            lr = torch.tensor(lr, dtype=torch.float32)
        groups = {}
        for name, w, g, s in zip(names, weights, grads, states):
            lr_mult, wd = self._mults(name)
            momentum = self.momentum != 0.0 and s is not None
            key = (w.dtype, w.device, lr_mult, wd, momentum)
            groups.setdefault(key, []).append((w, g, s))
        for (dt, _, lr_mult, wd, momentum), group in groups.items():
            ws, gs, ss = (list(c) for c in zip(*group))
            glr = lr if lr_mult == 1.0 else lr * lr_mult
            if dt in _LOW:
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
        flat = lambda ts: torch.cat([t.reshape(-1) for t in ts])  # noqa: E731
        w = flat(ws)
        g = (flat(gs).float() * _weak(self.rescale_grad, dt)).to(dt)
        if self.clip_gradient:
            g = g.clamp(_weak(-self.clip_gradient, dt),
                        _weak(self.clip_gradient, dt))
        g = g.float() + (w.float() * _weak(wd, dt)).to(dt).float()
        if ss is not None:
            mom = flat(ss).float() * _weak(self.momentum, dt) - lr * g
            _scatter(ws, (w.float() + mom).to(dt))
            _scatter(ss, mom.to(dt))
        else:
            _scatter(ws, (w.float() - lr * g).to(dt))


@register
class Adam(Optimizer):
    """Adam with bias-corrected lr (the JAX package's `_adam_fused`): g =
    rescale_grad * grad (clipped) + wd * w; mean = beta1 * mean + (1 -
    beta1) * g; var = beta2 * var + (1 - beta2) * g^2; w -= lr * sqrt(1 -
    beta2^t) / (1 - beta1^t) * mean / (sqrt(var) + epsilon), with 1 -
    beta^t computed as -expm1(t log beta) and t at least 1. The state is
    (mean, var); a low-precision weight updates in float32 and rounds
    once."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, memory_format=torch.preserve_format),
                torch.zeros_like(weight, memory_format=torch.preserve_format))

    @staticmethod
    def _one_minus_pow(beta, t):
        if beta <= 0.0:
            return torch.ones_like(t)
        return -torch.expm1(t * math.log(beta))

    @torch.no_grad()
    def update(self, names, weights, grads, states, lr, t=None):
        """One step on each weight and its (mean, var), in place; `t` is
        the update count (a float32 tensor from a train step), else
        `num_update`."""
        if not torch.is_tensor(lr):
            lr = torch.tensor(lr, dtype=torch.float32)
        if t is None:
            t = float(self.num_update)
        t = torch.clamp(torch.as_tensor(t, dtype=torch.float32), min=1.0)
        coef = (torch.sqrt(self._one_minus_pow(self.beta2, t))
                / self._one_minus_pow(self.beta1, t))
        b1, b2 = self.beta1, self.beta2
        for name, w, g, (mean, var) in zip(names, weights, grads, states):
            lr_mult, wd = self._mults(name)
            wf = w.float()
            g = g.float() * self.rescale_grad
            if self.clip_gradient:
                g = g.clamp(-self.clip_gradient, self.clip_gradient)
            g = g + wd * wf
            new_mean = b1 * mean.float() + (1 - b1) * g
            new_var = b2 * var.float() + (1 - b2) * torch.square(g)
            lr_t = (lr * lr_mult * coef).to(g.device)
            w.copy_(wf - lr_t * new_mean / (torch.sqrt(new_var)
                                             + self.epsilon))
            mean.copy_(new_mean)
            var.copy_(new_var)


def _scatter(targets, flat):
    """Copy consecutive pieces of the 1-d `flat` into `targets`."""
    pieces = flat.split([t.numel() for t in targets])
    torch._foreach_copy_(targets, [p.view(t.shape)
                                   for p, t in zip(pieces, targets)])


class Updater:
    """Applies an optimizer per parameter index, holding each index's
    state (an NDArray, or None)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def _state(self, index, weight):
        from .ndarray.ndarray import NDArray

        if index not in self.states:
            s = self.optimizer.create_state_multi_precision(index, weight)
            self.states[index] = None if s is None else \
                NDArray._from_data(s)
            self.states_synced[index] = True
        s = self.states[index]
        if s is None:
            return None
        if s._data.device != weight.device:  # loaded before the first step
            s._data = s._data.to(weight.device)
        return s._data

    def __call__(self, index, grad, weight):
        """One update of `weight` (an NDArray) by `grad`."""
        self.update([index], [grad], [weight])

    def update(self, indices, grads, weights):
        """One update of every (index, grad, weight), batched by the
        optimizer; each index's count advances first."""
        o = self.optimizer
        ws = [w._data for w in weights]
        states = [self._state(i, w) for i, w in zip(indices, ws)]
        for i in indices:
            o._update_count(i)
        o.update([o.idx2name.get(i, i) for i in indices], ws,
                 [g._data for g in grads], states, o._base_lr())

    def get_states(self, dump_optimizer=False):
        """The pickled states: {index: numpy array or None}."""
        if dump_optimizer:
            raise NotImplementedError(
                "get_states(dump_optimizer=True) would pickle the port's "
                "optimizer class, which the JAX package cannot load")
        states = {k: None if v is None else v.asnumpy()
                  for k, v in self.states.items()}
        return pickle.dumps(states)

    def set_states(self, states_blob):
        """Restore `get_states` bytes (the port's or the JAX package's);
        states land on the device of the states they replace, else on
        their weight's at its next update."""
        from .ndarray.ndarray import NDArray

        states = pickle.loads(states_blob)
        if isinstance(states, tuple) and len(states) == 2:
            raise NotImplementedError("a states file with a dumped "
                                      "optimizer cannot be loaded here")
        out = {}
        for k, v in states.items():
            if v is None:
                out[k] = None
                continue
            old = self.states.get(k)
            t = torch.from_numpy(np.array(v))
            if old is not None:
                t = t.to(old._data.device, old._data.dtype)
            out[k] = NDArray._from_data(t)
        self.states = out
        self.states_synced = {k: True for k in out}


def get_updater(optimizer):
    return Updater(optimizer)
