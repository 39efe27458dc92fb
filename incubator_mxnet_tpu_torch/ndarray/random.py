"""The `nd.random` namespace (`incubator_mxnet_tpu/ndarray/random.py`):
sampling functions over the registry's random ops, drawing from the
global random state (`random.py`) on `ctx` (None: the current
context)."""
from __future__ import annotations

from ..ops.registry import OP_REGISTRY
from . import register as _register


def _call(name, kwargs):
    return _register.invoke(OP_REGISTRY[name], (), kwargs)


def _t(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None,
            out=None, **kwargs):
    return _call("_random_uniform", dict(low=low, high=high, shape=_t(shape),
                                         dtype=dtype, ctx=ctx, out=out))


def normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None,
           out=None, **kwargs):
    return _call("_random_normal", dict(loc=loc, scale=scale,
                                        shape=_t(shape), dtype=dtype,
                                        ctx=ctx, out=out))


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None, **kwargs):
    return normal(loc=loc, scale=scale, shape=shape or (1,), dtype=dtype,
                  ctx=ctx)


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None,
          out=None, **kwargs):
    return _call("_random_gamma", dict(alpha=alpha, beta=beta,
                                       shape=_t(shape), dtype=dtype, ctx=ctx,
                                       out=out))


def exponential(scale=1.0, shape=(1,), dtype="float32", ctx=None, out=None,
                **kwargs):
    return _call("_random_exponential", dict(lam=1.0 / scale,
                                             shape=_t(shape), dtype=dtype,
                                             ctx=ctx, out=out))


def poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None, out=None,
            **kwargs):
    return _call("_random_poisson", dict(lam=lam, shape=_t(shape),
                                         dtype=dtype, ctx=ctx, out=out))


def negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32", ctx=None,
                      out=None, **kwargs):
    return _call("_random_negative_binomial", dict(k=k, p=p, shape=_t(shape),
                                                   dtype=dtype, ctx=ctx,
                                                   out=out))


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                  dtype="float32", ctx=None, out=None,
                                  **kwargs):
    return _call("_random_generalized_negative_binomial",
                 dict(mu=mu, alpha=alpha, shape=_t(shape), dtype=dtype,
                      ctx=ctx, out=out))


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None,
            **kwargs):
    return _call("_random_randint", dict(low=low, high=high, shape=_t(shape),
                                         dtype=dtype, ctx=ctx, out=out))


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kwargs):
    return _register.invoke(OP_REGISTRY["_sample_multinomial"], (data,),
                            dict(shape=_t(shape), get_prob=get_prob,
                                 dtype=dtype))


def shuffle(data, **kwargs):
    return _register.invoke(OP_REGISTRY["_shuffle"], (data,), {})


def bernoulli(p=0.5, shape=(1,), dtype="float32", ctx=None, out=None,
              **kwargs):
    return _call("_random_bernoulli", dict(p=p, shape=_t(shape), dtype=dtype,
                                           ctx=ctx, out=out))


# seeding lives on the package-level random module
from ..random import seed  # noqa: E402,F401
