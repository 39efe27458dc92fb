"""The fused optimizer update operators (`incubator_mxnet_tpu/ops/
optimizer.py`): the registry's fourth family, 20 ops under their JAX
names and attributes.

Each op is functional, as in the JAX package: it returns the new weight
and the new states (weights first, then momenta, then float32 master
weights for the multi-tensor ops) and leaves its inputs alone; the
optimizer's eager path writes the results back into its arrays. The
constants of an op are Python floats, so a float32 update runs in
float32, as JAX's weakly typed constants do. `rescale_grad` (and `lr`
of the multi-tensor ops) may also be a 0-d tensor, as the aggregated
Trainer path hands them in.
"""
from __future__ import annotations

import math

import torch

from .registry import register


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def one_minus_pow(beta, t):
    """1 - beta**t: exact double math for a Python t, else -expm1(t log
    beta) in float32, which keeps the digits the naive form loses at
    small t (beta 0.999, t 1)."""
    if isinstance(t, (int, float)):
        return 1.0 - beta ** t
    t = torch.as_tensor(t, dtype=torch.float32)
    if beta <= 0.0:
        return torch.ones_like(t)
    return -torch.expm1(t * math.log(beta))


@register("sgd_update", no_grad_inputs=("weight", "grad"))
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """SGD step: weight -= lr * (rescaled, clipped grad + wd * weight)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


@register("sgd_mom_update", num_outputs=2,
          no_grad_inputs=("weight", "grad", "mom"))
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """Momentum SGD step: mom = momentum * mom - lr * grad; weight += mom."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom


@register("nag_mom_update", num_outputs=2,
          no_grad_inputs=("weight", "grad", "mom"))
def nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov accelerated SGD step (gradient looked ahead through
    momentum)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@register("adam_update", num_outputs=3,
          no_grad_inputs=("weight", "grad", "mean", "var"))
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """Adam step: first/second-moment EMAs with epsilon-stabilized
    update."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    return (weight - lr * new_mean / (torch.sqrt(new_var) + epsilon),
            new_mean, new_var)


@register("rmsprop_update", num_outputs=2,
          no_grad_inputs=("weight", "grad", "n"))
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """RMSProp step: scale the gradient by the sqrt of a squared-grad
    EMA."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_w = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n


@register("rmspropalex_update", num_outputs=4,
          no_grad_inputs=("weight", "grad", "n", "g", "delta"))
def rmspropalex_update(weight, grad, n, g, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Alex Graves' variant): also tracks the gradient
    mean."""
    gr = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = (1 - gamma1) * torch.square(gr) + gamma1 * n
    new_g = (1 - gamma1) * gr + gamma1 * g
    new_delta = gamma2 * delta - lr * gr / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    new_w = weight + new_delta
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n, new_g, new_delta


@register("ftrl_update", num_outputs=3,
          no_grad_inputs=("weight", "grad", "z", "n"))
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal step with L1/L2 regularization."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) > lamda1,
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd),
        torch.zeros_like(weight))
    return new_w, new_z, new_n


@register("signsgd_update", no_grad_inputs=("weight", "grad"))
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """SignSGD step: weight -= lr * sign(grad)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", num_outputs=2,
          no_grad_inputs=("weight", "grad", "mom"))
def signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Signum step: SignSGD applied to a momentum buffer."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * (g + wd * weight)
    new_w = weight * (1 - lr * wd_lh) + lr * torch.sign(new_mom)
    return new_w, new_mom


@register("ftml_update", num_outputs=4,
          no_grad_inputs=("weight", "grad", "d", "v", "z"))
def ftml_update(weight, grad, d, v, z, *, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0,
                t=1):
    """FTML (Follow The Moving Leader) step."""
    g = _rescale_clip(grad, rescale_grad, clip_grad) + wd * weight
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (one_minus_pow(beta1, t) / lr
           * (torch.sqrt(new_v / one_minus_pow(beta2, t)) + epsilon))
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight
    new_w = -new_z / d_t
    return new_w, d_t, new_v, new_z


@register("adamw_update", num_outputs=3,
          no_grad_inputs=("weight", "grad", "mean", "var"))
def adamw_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """AdamW step: Adam with decoupled weight decay (eta * lr * wd *
    weight)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - eta * (lr * new_mean / (torch.sqrt(new_var) + epsilon)
                            + wd * weight)
    return new_w, new_mean, new_var


# -- the multi-tensor SGD updates: one call over num_weights tensors; all
# updated tensors are returned, weights first, then momenta, then the
# float32 master weights, each group in input order --------------------------

def _nw(attrs):
    nw = attrs.get("num_weights")
    if nw is None:
        raise TypeError("multi update requires num_weights")
    return int(nw)


def _multi_groups(args, group, num_weights):
    if num_weights is None:
        raise TypeError("multi update requires num_weights")
    expected = group * int(num_weights)
    if len(args) != expected:
        raise ValueError(
            f"multi update with num_weights={num_weights} expects "
            f"{expected} tensors ({group} per weight), got {len(args)}")
    return [args[i:i + group] for i in range(0, len(args), group)]


def _per_weight(attr, i, what):
    if attr is None:
        raise TypeError(f"multi update requires {what} (per-weight tuple)")
    if isinstance(attr, (tuple, list)):
        attr = attr[i]
    return attr if torch.is_tensor(attr) else float(attr)


@register("multi_sgd_update", num_outputs=lambda attrs: _nw(attrs))
def multi_sgd_update(*args, lrs, wds, num_weights, rescale_grad=1.0,
                     clip_gradient=-1.0):
    """Aggregated SGD step over many (weight, grad) pairs."""
    return tuple(
        sgd_update(w, g, lr=_per_weight(lrs, i, "lrs"),
                   wd=_per_weight(wds, i, "wds"), rescale_grad=rescale_grad,
                   clip_gradient=clip_gradient)
        for i, (w, g) in enumerate(_multi_groups(args, 2, num_weights)))


@register("multi_sgd_mom_update", num_outputs=lambda attrs: 2 * _nw(attrs))
def multi_sgd_mom_update(*args, lrs, wds, num_weights, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """Aggregated momentum-SGD step over many (weight, grad, mom)
    triples."""
    ws, ms = [], []
    for i, (w, g, m) in enumerate(_multi_groups(args, 3, num_weights)):
        new_w, new_m = sgd_mom_update(
            w, g, m, lr=_per_weight(lrs, i, "lrs"), momentum=momentum,
            wd=_per_weight(wds, i, "wds"), rescale_grad=rescale_grad,
            clip_gradient=clip_gradient)
        ws.append(new_w)
        ms.append(new_m)
    return tuple(ws) + tuple(ms)


@register("multi_mp_sgd_update", num_outputs=lambda attrs: 2 * _nw(attrs))
def multi_mp_sgd_update(*args, lrs, wds, num_weights, rescale_grad=1.0,
                        clip_gradient=-1.0):
    """Mixed precision: per weight (weight, grad, weight32); the math on
    the float32 master, the low-precision weight refreshed by a cast."""
    ws, w32s = [], []
    for i, (w, g, w32) in enumerate(_multi_groups(args, 3, num_weights)):
        new_w32 = sgd_update(
            w32, g.to(w32.dtype), lr=_per_weight(lrs, i, "lrs"),
            wd=_per_weight(wds, i, "wds"), rescale_grad=rescale_grad,
            clip_gradient=clip_gradient)
        ws.append(new_w32.to(w.dtype))
        w32s.append(new_w32)
    return tuple(ws) + tuple(w32s)


@register("multi_mp_sgd_mom_update",
          num_outputs=lambda attrs: 3 * _nw(attrs))
def multi_mp_sgd_mom_update(*args, lrs, wds, num_weights, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0):
    """Aggregated mixed-precision momentum SGD: low-precision weights with
    float32 master copies and momenta."""
    ws, ms, w32s = [], [], []
    for i, (w, g, m, w32) in enumerate(_multi_groups(args, 4, num_weights)):
        new_w32, new_m = sgd_mom_update(
            w32, g.to(w32.dtype), m, lr=_per_weight(lrs, i, "lrs"),
            momentum=momentum, wd=_per_weight(wds, i, "wds"),
            rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        ws.append(new_w32.to(w.dtype))
        ms.append(new_m)
        w32s.append(new_w32)
    return tuple(ws) + tuple(ms) + tuple(w32s)


@register("mp_sgd_update", num_outputs=2,
          no_grad_inputs=("weight", "grad", "weight32"))
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """Mixed-precision SGD: the math on the float32 master copy, the
    low-precision weight refreshed by a cast."""
    new_w32 = sgd_update(weight32, grad.to(weight32.dtype), lr=lr, wd=wd,
                         rescale_grad=rescale_grad,
                         clip_gradient=clip_gradient)
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", num_outputs=3,
          no_grad_inputs=("weight", "grad", "mom", "weight32"))
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    """Mixed-precision momentum SGD on the float32 master copy."""
    new_w32, new_mom = sgd_mom_update(
        weight32, grad.to(weight32.dtype), mom, lr=lr, momentum=momentum,
        wd=wd, rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("_adamw_update", num_outputs=3,
          no_grad_inputs=("weight", "grad", "mean", "var", "rescale_grad"))
def _adamw_update_dyn(weight, grad, mean, var, rescale_grad, *, lr,
                      beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                      clip_gradient=-1.0):
    """AdamW whose rescale factor is a tensor input (dynamic loss
    scaling): a non-finite or zero scale skips the update."""
    scale = rescale_grad.to(torch.float32).reshape(())
    ok = torch.isfinite(scale) & (scale != 0)
    safe = torch.where(ok, scale, torch.ones_like(scale))
    new = adamw_update(weight, grad, mean, var, lr=lr, beta1=beta1,
                       beta2=beta2, epsilon=epsilon, wd=wd, eta=eta,
                       rescale_grad=safe, clip_gradient=clip_gradient)
    return tuple(torch.where(ok, n, o).to(o.dtype)
                 for n, o in zip(new, (weight, mean, var)))


@register("_mp_adamw_update", num_outputs=4,
          no_grad_inputs=("weight", "grad", "mean", "var", "weight32",
                          "rescale_grad"))
def _mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad, *, lr,
                     beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                     clip_gradient=-1.0):
    """Mixed-precision AdamW with a tensor rescale factor."""
    new_w32, new_mean, new_var = _adamw_update_dyn(
        weight32, grad.to(weight32.dtype), mean, var, rescale_grad, lr=lr,
        beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd, eta=eta,
        clip_gradient=clip_gradient)
    return new_w32.to(weight.dtype), new_mean, new_var, new_w32


@register("_contrib_group_adagrad_update", num_outputs=2,
          no_grad_inputs=("weight", "grad", "history"))
def _contrib_group_adagrad_update(weight, grad, history, *, lr,
                                  rescale_grad=1.0, clip_gradient=-1.0,
                                  epsilon=1e-5):
    """Row-wise (grouped) AdaGrad: one accumulator per row."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    if g.dim() > 1:
        new_h = history + torch.mean(torch.square(g),
                                     dim=tuple(range(1, g.dim())),
                                     keepdim=True)
    else:
        new_h = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(new_h) + epsilon), new_h
