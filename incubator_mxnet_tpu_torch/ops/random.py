"""Random sampling operators (`incubator_mxnet_tpu/ops/random.py`): its
19 ops under their 41 names. Each draws from an explicit
`torch.Generator` (`_rng`) that the caller seeds from the global random
state (`random.next_generator`) on the device the samples are made on,
as each JAX op draws from the key the evaluator threads in. The bits
differ from JAX's; the distributions are the same.
"""
from __future__ import annotations

import torch

from ..base import dtype_torch
from .registry import alias, register


def _dt(dtype):
    return dtype_torch(dtype if dtype not in (None, "None") else "float32")


def _uniform(rng, shape, dtype=torch.float32):
    return torch.rand(tuple(shape), generator=rng, device=rng.device,
                      dtype=dtype)


def _gamma(rng, alpha, shape):
    """Standard Gamma(alpha) draws of `shape` (alpha broadcast)."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=rng.device)
    return torch._standard_gamma(a.expand(tuple(shape)).contiguous(),
                                 generator=rng)


def _poisson(rng, lam, shape):
    lam = torch.as_tensor(lam, dtype=torch.float32, device=rng.device)
    return torch.poisson(lam.expand(tuple(shape)).contiguous(),
                         generator=rng)


@register("_random_uniform", aliases=("uniform",), needs_rng=True)
def random_uniform(*, low=0.0, high=1.0, shape=(1,), dtype="float32",
                   _rng=None):
    """Draw Uniform(low, high) samples with the given shape."""
    return torch.empty(tuple(shape), dtype=_dt(dtype),
                       device=_rng.device).uniform_(low, high, generator=_rng)


@register("_random_normal", aliases=("normal",), needs_rng=True)
def random_normal(*, loc=0.0, scale=1.0, shape=(1,), dtype="float32",
                  _rng=None):
    """Draw Normal(loc, scale) samples with the given shape."""
    return loc + scale * torch.randn(tuple(shape), generator=_rng,
                                     device=_rng.device, dtype=_dt(dtype))


@register("_random_gamma", aliases=("gamma_sample",), needs_rng=True)
def random_gamma(*, alpha=1.0, beta=1.0, shape=(1,), dtype="float32",
                 _rng=None):
    """Draw Gamma(alpha, beta) samples with the given shape."""
    return (beta * _gamma(_rng, alpha, shape)).to(_dt(dtype))


@register("_random_exponential", needs_rng=True)
def random_exponential(*, lam=1.0, shape=(1,), dtype="float32", _rng=None):
    """Draw Exponential(lam) samples with the given shape."""
    return torch.empty(tuple(shape), dtype=_dt(dtype),
                       device=_rng.device).exponential_(generator=_rng) / lam


@register("_random_poisson", needs_rng=True)
def random_poisson(*, lam=1.0, shape=(1,), dtype="float32", _rng=None):
    """Draw Poisson(lam) samples with the given shape."""
    return _poisson(_rng, lam, shape).to(_dt(dtype))


@register("_random_negative_binomial", needs_rng=True)
def random_negative_binomial(*, k=1, p=0.5, shape=(1,), dtype="float32",
                             _rng=None):
    """Draw NegativeBinomial(k, p) samples with the given shape."""
    lam = _gamma(_rng, k, shape) * (1 - p) / p
    return torch.poisson(lam, generator=_rng).to(_dt(dtype))


@register("_random_generalized_negative_binomial", needs_rng=True)
def random_gen_neg_binomial(*, mu=1.0, alpha=1.0, shape=(1,),
                            dtype="float32", _rng=None):
    """Draw generalized-negative-binomial (mu, alpha) samples with the given
    shape."""
    r = 1.0 / alpha
    p = r / (r + mu)
    lam = _gamma(_rng, r, shape) * (1 - p) / p
    return torch.poisson(lam, generator=_rng).to(_dt(dtype))


@register("_random_randint", aliases=("randint",), needs_rng=True)
def random_randint(*, low=0, high=1, shape=(1,), dtype="int32", _rng=None):
    """Draw integers uniformly from [low, high) with the given shape."""
    return torch.randint(int(low), int(high), tuple(shape), generator=_rng,
                         device=_rng.device, dtype=_dt(dtype))


@register("_sample_unique_zipfian", needs_rng=True)
def sample_unique_zipfian(*, range_max=1, shape=(1,), _rng=None):
    """Draw samples from an approximate Zipfian over [0, range_max)."""
    u = _uniform(_rng, shape)
    cls = (torch.exp(u * torch.log(torch.tensor(range_max + 1.0)))
           - 1.0).to(torch.int64)
    return torch.clamp(cls, 0, range_max - 1)


@register("_sample_multinomial", aliases=("sample_multinomial",),
          needs_rng=True, no_grad_inputs=("data",),
          num_outputs=lambda attrs: 2 if attrs.get("get_prob") else 1)
def sample_multinomial(data, *, shape=(), get_prob=False, dtype="int32",
                       _rng=None):
    """Draw category indices from each row's probability distribution."""
    shape = tuple(shape) if not isinstance(shape, int) else (shape,)
    n = 1
    for s in shape:
        n *= int(s)
    probs = torch.clamp(data, min=1e-30)
    rows = probs.reshape(-1, data.shape[-1])
    out = torch.multinomial(rows, max(n, 1), replacement=True,
                            generator=_rng)
    lead = () if data.dim() == 1 else (data.shape[0],)
    out = out.reshape(lead + shape)
    sample = out.to(_dt(dtype))
    if not get_prob:
        return sample
    logits = torch.log(probs)
    if data.dim() == 1:
        logp = logits[out.reshape(-1)].reshape(sample.shape)
    else:
        flat = out.reshape(data.shape[0], -1)
        logp = torch.gather(logits, -1, flat).reshape(sample.shape)
    return sample, logp.to(data.dtype)


@register("_shuffle", aliases=("shuffle",), needs_rng=True)
def shuffle(data, *, _rng=None):
    """Randomly permute the input along its first axis."""
    perm = torch.randperm(data.shape[0], generator=_rng, device=_rng.device)
    return data[perm.to(data.device)]


@register("_random_bernoulli", aliases=("bernoulli",), needs_rng=True)
def bernoulli(*, p=0.5, shape=(1,), dtype="float32", _rng=None):
    """Draw Bernoulli samples with probability p."""
    return (_uniform(_rng, shape) < p).to(_dt(dtype))


def _shape_tuple(shape):
    if shape in (None, "None", ()):
        return ()
    return (int(shape),) if isinstance(shape, (int, float)) else tuple(
        int(s) for s in shape)


def _expand(p, shape):
    """Append singleton dims so per-row params broadcast over the draws."""
    return p.reshape(tuple(p.shape) + (1,) * len(shape))


@register("_sample_uniform", aliases=("sample_uniform",), needs_rng=True,
          no_grad_inputs=("low", "high"))
def sample_uniform(low, high, *, shape=(), dtype="float32", _rng=None):
    """Per-row Uniform draws: row i samples from (low[i], high[i])."""
    shape = _shape_tuple(shape)
    u = _uniform(_rng, tuple(low.shape) + shape, _dt(dtype))
    return _expand(low, shape) + u * (_expand(high, shape)
                                      - _expand(low, shape))


@register("_sample_normal", aliases=("sample_normal",), needs_rng=True,
          no_grad_inputs=("mu", "sigma"))
def sample_normal(mu, sigma, *, shape=(), dtype="float32", _rng=None):
    """Per-row Normal draws: row i samples from (mu[i], sigma[i])."""
    shape = _shape_tuple(shape)
    z = torch.randn(tuple(mu.shape) + shape, generator=_rng,
                    device=_rng.device, dtype=_dt(dtype))
    return _expand(mu, shape) + _expand(sigma, shape) * z


@register("_sample_gamma", aliases=("sample_gamma",), needs_rng=True,
          no_grad_inputs=("alpha", "beta"))
def sample_gamma(alpha, beta, *, shape=(), dtype="float32", _rng=None):
    """Per-row Gamma draws from (alpha[i], beta[i])."""
    shape = _shape_tuple(shape)
    full = tuple(alpha.shape) + shape
    g = _gamma(_rng, _expand(alpha, shape).expand(full), full)
    return (_expand(beta, shape) * g).to(_dt(dtype))


@register("_sample_exponential", aliases=("sample_exponential",),
          needs_rng=True, no_grad_inputs=("lam",))
def sample_exponential(lam, *, shape=(), dtype="float32", _rng=None):
    """Per-row Exponential draws from lam[i]."""
    shape = _shape_tuple(shape)
    e = torch.empty(tuple(lam.shape) + shape, dtype=_dt(dtype),
                    device=_rng.device).exponential_(generator=_rng)
    return e / _expand(lam, shape)


@register("_sample_poisson", aliases=("sample_poisson",), needs_rng=True,
          no_grad_inputs=("lam",))
def sample_poisson(lam, *, shape=(), dtype="float32", _rng=None):
    """Per-row Poisson draws from lam[i]."""
    shape = _shape_tuple(shape)
    full = tuple(lam.shape) + shape
    return _poisson(_rng, _expand(lam, shape).expand(full), full).to(
        _dt(dtype))


@register("_sample_negative_binomial", aliases=("sample_negative_binomial",),
          needs_rng=True, no_grad_inputs=("k", "p"))
def sample_negative_binomial(k, p, *, shape=(), dtype="float32", _rng=None):
    """Per-row NegativeBinomial draws from (k[i], p[i])."""
    shape = _shape_tuple(shape)
    full = tuple(k.shape) + shape
    pe = _expand(p, shape)
    lam = _gamma(_rng, _expand(k, shape).expand(full), full) * (1 - pe) / pe
    return torch.poisson(lam, generator=_rng).to(_dt(dtype))


@register("_sample_generalized_negative_binomial",
          aliases=("sample_generalized_negative_binomial",), needs_rng=True,
          no_grad_inputs=("mu", "alpha"))
def sample_gen_neg_binomial(mu, alpha, *, shape=(), dtype="float32",
                            _rng=None):
    """Per-row generalized-negative-binomial draws from (mu[i], alpha[i])."""
    shape = _shape_tuple(shape)
    full = tuple(mu.shape) + shape
    r = 1.0 / _expand(alpha, shape)
    p = r / (r + _expand(mu, shape))
    lam = _gamma(_rng, r.expand(full), full) * (1 - p) / p
    return torch.poisson(lam, generator=_rng).to(_dt(dtype))


for _dist in ("uniform", "normal", "gamma", "exponential", "poisson",
              "negative_binomial", "generalized_negative_binomial",
              "randint"):
    alias(f"_random_{_dist}", f"random_{_dist}")
del _dist
