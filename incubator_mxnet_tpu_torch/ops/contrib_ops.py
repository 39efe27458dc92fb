"""Contrib operators (`incubator_mxnet_tpu/ops/contrib_ops.py`): FFT,
count sketch, quadratic, the Hawkes log-likelihood, cross-device batch
norm on one device, and the name-parity tail (`div_sqrt_dim`,
`gradientmultiplier`, `index_copy`, `getnnz`,
`IdentityAttachKLSparseReg`). `GroupNorm` lives in `ops/nn.py`.

The ops with a hand-made gradient (`gradientmultiplier`,
`IdentityAttachKLSparseReg`) are `torch.autograd.Function`s, as JAX's
are `jax.custom_vjp`s. The Hawkes scan is a Python loop over time.
"""
from __future__ import annotations

import torch

from .registry import register


@register("_contrib_fft")
def fft(data, *, compute_size=128):
    """Forward FFT of (..., d) real -> (..., 2d), real and imaginary parts
    interleaved (cuFFT's layout)."""
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    inter = torch.stack([out.real, out.imag], -1)
    return inter.reshape(tuple(data.shape[:-1])
                         + (2 * data.shape[-1],)).to(torch.float32)


@register("_contrib_ifft")
def ifft(data, *, compute_size=128):
    """Inverse FFT of (..., 2d) interleaved real / imaginary -> (..., d)
    real, not divided by d (cuFFT's unnormalized inverse)."""
    d = data.shape[-1] // 2
    pairs = data.reshape(tuple(data.shape[:-1]) + (d, 2))
    comp = torch.complex(pairs[..., 0].contiguous(),
                         pairs[..., 1].contiguous())
    return (torch.fft.ifft(comp, dim=-1).real * d).to(torch.float32)


@register("_contrib_count_sketch", no_grad_inputs=("h", "s"))
def count_sketch(data, h, s, *, out_dim, processing_batch_size=32):
    """Count-sketch projection: data (N, d), h (d,) buckets in [0,
    out_dim), s (d,) signs -> out[n, h[i]] += s[i] * data[n, i], as one
    one-hot matmul."""
    hh = h.reshape(-1).to(torch.int32).long()
    ss = s.reshape(-1).to(data.dtype)
    onehot = torch.nn.functional.one_hot(hh, int(out_dim)).to(data.dtype)
    return torch.matmul(data * ss[None, :], onehot)


@register("_contrib_quadratic", aliases=("_contrib_backward_quadratic",))
def quadratic(data, *, a=0.0, b=0.0, c=0.0):
    """Elementwise a*x^2 + b*x + c (the reference's tutorial op)."""
    return a * torch.square(data) + b * data + c


@register("_contrib_hawkesll", num_outputs=2, no_grad_inputs=("state",))
def hawkesll(lda, alpha, beta, state, lags, marks, valid_length, *,
             ignore=None):
    """Hawkes-process log-likelihood -> (loglik (N,), new_state (N, K)):
    lda (N, K) background intensity, alpha / beta (K,), state (N, K),
    lags / marks (N, T), valid_length (N,). Steps past a sequence's
    valid length leave its state untouched."""
    n, t = lags.shape
    mk = marks.to(torch.int32).long()
    rows = torch.arange(n, device=lags.device)
    st = state
    ll = torch.zeros(n, dtype=lda.dtype, device=lda.device)
    for i in range(t):
        valid = i < valid_length
        m = mk[:, i]
        decayed = st * torch.exp(-beta * lags[:, i:i + 1])
        lam = lda[rows, m] + alpha[m] * decayed[rows, m]
        ll = ll + torch.where(valid, torch.log(lam.clamp_min(1e-20)),
                              torch.zeros_like(lam))
        bumped = decayed.index_put((rows, m), beta[m], accumulate=True)
        st = torch.where(valid[:, None], bumped.to(st.dtype), st)
    steps = torch.arange(t, device=lags.device)
    horizon = torch.where(steps[None, :] < valid_length[:, None], lags,
                          torch.zeros_like(lags)).sum(1)
    return ll - lda.sum(1) * horizon, st


@register("_contrib_SyncBatchNorm", aux=("moving_mean", "moving_var"),
          needs_training=True)
def sync_batch_norm(data, gamma, beta, moving_mean, moving_var, *,
                    eps=1e-3, momentum=0.9, fix_gamma=True,
                    use_global_stats=False, output_mean_var=False,
                    ndev=1, axis_name=None, key="", _training=False):
    """Cross-device batch norm on one device: channel axis 1, batch
    variance E[x^2] - E[x]^2 in the data's dtype. In training mode the
    return is (out, new_moving_mean, new_moving_var). `axis_name`
    (statistics averaged across a mesh axis) raises: multi-device waits
    for ROADMAP Queue A 4."""
    if axis_name is not None:
        raise NotImplementedError(
            f"_contrib_SyncBatchNorm(axis_name={axis_name!r}): statistics "
            "across devices wait for the multi-device slice (ROADMAP Queue "
            "A 4)")
    g = torch.ones_like(gamma) if fix_gamma else gamma
    dims = tuple(i for i in range(data.dim()) if i != 1)
    bshape = [1] * data.dim()
    bshape[1] = data.shape[1]
    if _training and not use_global_stats:
        mean = data.mean(dim=dims)
        meansq = (data * data).mean(dim=dims)
        var = meansq - mean * mean
        out = (data - mean.reshape(bshape)) * torch.rsqrt(
            var.reshape(bshape) + eps)
        out = out * g.reshape(bshape) + beta.reshape(bshape)
        return (out, momentum * moving_mean + (1 - momentum) * mean,
                momentum * moving_var + (1 - momentum) * var)
    out = (data - moving_mean.reshape(bshape)) * torch.rsqrt(
        moving_var.reshape(bshape) + eps)
    out = out * g.reshape(bshape) + beta.reshape(bshape)
    if _training:  # the moving stats stay as they are
        return out, moving_mean, moving_var
    return out


@register("_contrib_div_sqrt_dim")
def div_sqrt_dim(data):
    """data / sqrt(last dim) (the attention-score scaling helper)."""
    return data / torch.sqrt(torch.tensor(float(data.shape[-1]),
                                          dtype=data.dtype,
                                          device=data.device))


class _GradMult(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scalar):
        ctx.scalar = scalar
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


@register("_contrib_gradientmultiplier",
          aliases=("_contrib_backward_gradientmultiplier",))
def gradientmultiplier(data, *, scalar=1.0):
    """Identity forward, the gradient scaled by `scalar` (gradient
    reversal with scalar=-1)."""
    return _GradMult.apply(data, float(scalar))


@register("_contrib_index_copy", aliases=("_contrib_backward_index_copy",),
          no_grad_inputs=("index",))
def index_copy(old, index, new):
    """old with new's rows written at `index` along axis 0."""
    return old.index_put((index.to(torch.int32).long(),), new)


@register("_contrib_getnnz")
def getnnz(data, *, axis=None):
    """Count of non-zero entries (int32), over `axis` or all."""
    return torch.count_nonzero(data, dim=axis).to(torch.int32)


class _KLSparse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, target, penalty):
        ctx.save_for_backward(torch.sigmoid(data).mean(0))
        ctx.target, ctx.penalty = target, penalty
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (rho_hat,) = ctx.saved_tensors
        # d/da KL(rho || rho_hat(a)) simplifies to rho_hat - rho, finite
        # where the mean activation saturates at 0 or 1
        return g + ctx.penalty * (rho_hat - ctx.target), None, None


@register("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, *, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """Identity that adds a KL sparsity penalty's gradient on the mean
    sigmoid activation (the running-average momentum is subsumed by the
    batch mean)."""
    return _KLSparse.apply(data, float(sparseness_target), float(penalty))
