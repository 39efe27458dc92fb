"""Fused softmax cross-entropy: the transformer loss with `use_fused_xent`.

The counterpart of the softmax-xent part of the JAX package's
`ops/pallas_kernels.py`. Two kernels, hand-written in CUDA for Hopper
(`ops/csrc/xent.cu`), each with a plain PyTorch version beside it:

- `softmax_xent_fwd` (plain: `softmax_xent_fwd_ref`): per row of (N, V)
  logits, lse = logsumexp(row) and loss = lse - row[label], both float32;
- `softmax_xent_bwd` (plain: `softmax_xent_bwd_ref`): dlogits =
  (exp(row - lse) - onehot(label)) * dloss, in the logits' dtype.

`softmax_xent` is the `torch.autograd.Function` around them, the
counterpart of the JAX `_xent` with its `custom_vjp`: it flattens
(..., V) logits to (N, V), casts the labels to int32 as the JAX wrapper
does, saves (logits, labels, lse) and returns the float32 loss of shape
(...). No (N, V) softmax is kept between forward and backward.

A label outside [0, V) matches no column, as the JAX kernels' `iota ==
label` does: its loss is lse and its dlogits carry no one-hot term. The
plain versions pick the label by a mask against `arange(V)` for that
reason (`torch.gather` raises on such a label). bfloat16 logits are read
as bfloat16; all math is float32.

Dispatch rule: a CUDA tensor goes to the kernel (or the wrapper raises),
a CPU tensor goes to the plain version; nothing falls back. Each wrapper
counts its kernel launches in `<wrapper>.launches`.

Not carried over: `block_b`, a TPU tile parameter (the kernels choose
their own blocks), and the JAX wrapper's `vma` / shard_map branch, which
exists for JAX's varying-mesh-axes metadata and its interpret mode.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .decode import _raise_on, _route
from .flash import _stream

__all__ = ["softmax_xent", "softmax_xent_fwd", "softmax_xent_fwd_ref",
           "softmax_xent_bwd", "softmax_xent_bwd_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "mxtpu_softmax_xent_fwd": [_I, _P, _L, _P, _P, _P, _I, _I, _P],
    "mxtpu_softmax_xent_bwd": [_I, _P, _L, _P, _P, _P, _P, _I, _I, _P],
}


def _lib():
    return _build.load("xent", _SIGNATURES)


# -- plain versions ----------------------------------------------------------

def _onehot(labels, vocab, device):
    """(N, V) bool: column == label (no column for a label outside
    [0, V))."""
    cols = torch.arange(vocab, device=device)
    return cols[None, :] == labels.long()[:, None]


def softmax_xent_fwd_ref(logits, labels):
    """Plain forward: logits (N, V) float32 or bfloat16, labels (N,)
    integers -> (loss, lse), each (N,) float32. float32 max, then lse =
    max + log(sum(exp(x - max))); the label's logit is picked by a mask."""
    x = logits.float()
    m = x.amax(-1, keepdim=True)
    lse = (m + torch.log(torch.exp(x - m).sum(-1, keepdim=True)))[:, 0]
    hot = _onehot(labels, x.shape[-1], x.device)
    picked = torch.where(hot, x, 0.0).sum(-1)
    return lse - picked, lse


def softmax_xent_bwd_ref(logits, labels, lse, dloss):
    """Plain backward: (exp(x - lse) - onehot(label)) * dloss in float32,
    returned in the logits' dtype. lse and dloss are (N,)."""
    x = logits.float()
    p = torch.exp(x - lse.float()[:, None])
    hot = _onehot(labels, x.shape[-1], x.device).float()
    return ((p - hot) * dloss.float()[:, None]).to(logits.dtype)


# -- kernel wrappers ---------------------------------------------------------

def _check(name, logits, labels):
    """(logits as the kernels read it, int32 labels, N, V). The kernels
    read rows through a row stride: a view with unit column stride and
    non-overlapping rows is read in place, anything else is copied."""
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits must be (N, V), got "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {logits.dtype} is not float32 or "
                         f"bfloat16")
    N, V = logits.shape
    if V < 1:
        raise ValueError(f"{name}: the vocabulary is empty")
    if tuple(labels.shape) != (N,) or labels.device != logits.device:
        raise ValueError(f"{name}: labels {tuple(labels.shape)} on "
                         f"{labels.device}, logits {tuple(logits.shape)} on "
                         f"{logits.device}")
    if logits.stride(1) != 1 or (N > 1 and logits.stride(0) < V):
        logits = logits.contiguous()
    return logits, labels.to(torch.int32).contiguous(), N, V


def _row_stat(name, t, n, device):
    """A (N,) float32 row statistic (lse, dloss) as a contiguous tensor on
    `device`; dloss arrives expanded from a mean's gradient."""
    if tuple(t.shape) != (n,) or t.device != device:
        raise ValueError(f"{name}: row statistic {tuple(t.shape)} on "
                         f"{t.device}, expected ({n},) on {device}")
    return t.to(torch.float32).contiguous()


def softmax_xent_fwd(logits, labels):
    """Softmax cross-entropy forward: logits (N, V) float32 or bfloat16,
    labels (N,) integers. Returns (loss, lse), each (N,) float32.

    CUDA tensors run the Hopper kernel of `ops/csrc/xent.cu` (one block
    per row, online max and sum of exponentials, 16-byte loads where the
    rows are aligned); CPU tensors run `softmax_xent_fwd_ref`."""
    name = "softmax_xent_fwd"
    if not _route(name, logits):
        return softmax_xent_fwd_ref(logits, labels)
    logits, labels, N, V = _check(name, logits, labels)
    loss = torch.empty(N, dtype=torch.float32, device=logits.device)
    lse = torch.empty(N, dtype=torch.float32, device=logits.device)
    lib = _lib()
    with torch.cuda.device(logits.device):
        err = lib.mxtpu_softmax_xent_fwd(
            _DTYPES[logits.dtype], logits.data_ptr(), logits.stride(0),
            labels.data_ptr(), loss.data_ptr(), lse.data_ptr(), N, V,
            _stream(logits.device))
    _raise_on(lib, err, name)
    softmax_xent_fwd.launches += 1
    return loss, lse


softmax_xent_fwd.launches = 0


def softmax_xent_bwd(logits, labels, lse, dloss):
    """Softmax cross-entropy backward: dlogits (N, V) in the logits' dtype
    from the logits, labels, the forward's lse and the loss gradient dloss
    (both (N,)).

    CUDA tensors run the Hopper kernel (a 2-D grid of rows x chunks of V,
    output from `torch.empty`); CPU tensors run `softmax_xent_bwd_ref`."""
    name = "softmax_xent_bwd"
    if not _route(name, logits):
        return softmax_xent_bwd_ref(logits, labels, lse, dloss)
    logits, labels, N, V = _check(name, logits, labels)
    lse = _row_stat(name, lse, N, logits.device)
    dloss = _row_stat(name, dloss, N, logits.device)
    dlogits = torch.empty((N, V), dtype=logits.dtype, device=logits.device)
    lib = _lib()
    with torch.cuda.device(logits.device):
        err = lib.mxtpu_softmax_xent_bwd(
            _DTYPES[logits.dtype], logits.data_ptr(), logits.stride(0),
            labels.data_ptr(), lse.data_ptr(), dloss.data_ptr(),
            dlogits.data_ptr(), N, V, _stream(logits.device))
    _raise_on(lib, err, name)
    softmax_xent_bwd.launches += 1
    return dlogits


softmax_xent_bwd.launches = 0


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = softmax_xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        return softmax_xent_bwd(logits, labels, lse, dloss), None


def softmax_xent(logits, labels):
    """Per-row softmax cross-entropy: logits (..., V) x integer labels
    (...) -> float32 loss (...), differentiable in the logits through the
    backward kernel (CUDA) or its plain version (CPU)."""
    shape = logits.shape[:-1]
    flat = logits.reshape(-1, logits.shape[-1])
    lab = torch.as_tensor(labels, device=logits.device).reshape(-1)
    loss = _SoftmaxXent.apply(flat, lab.to(torch.int32))
    return loss.reshape(shape)
