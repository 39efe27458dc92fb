"""Fused BatchNorm -> ReLU (-> residual add) epilogue: the ResNet path
with `MXTPU_FUSED_EPILOGUE`.

The counterpart of the epilogue part of the JAX package's
`ops/pallas_kernels.py`. Two kernels, hand-written in CUDA for Hopper
(`ops/csrc/epilogue.cu`), each with a plain PyTorch version beside it:

- `bn_act_epilogue_fwd` (plain: `bn_act_epilogue_fwd_ref`): y =
  relu(x * scale + shift [+ residual]) over a channels-last (R, C)
  activation, float32 math, y in x's dtype;
- `bn_act_epilogue_bwd` (plain: `bn_act_epilogue_bwd_ref`): with mask =
  y > 0, dx = dy * mask * scale, dscale = sum over rows of dy * mask * x,
  dshift = sum over rows of dy * mask and, for the residual variant,
  dres = dy * mask.

`bn_act_epilogue` is the `torch.autograd.Function` around them, the
counterpart of the JAX `bn_act_epilogue` with its custom VJPs
`_epi_plain` / `_epi_res`: it flattens (..., C) to (R, C), saves (x,
scale, y) and not the pre-activation (the backward rebuilds the mask
from y), and returns gradients for x, scale, shift and the residual.

x, the residual and dy are float32, bfloat16 or float16, all of one
dtype; scale
and shift are (C,) and read as float32. dscale and dshift are float32.

Dispatch rule: a CUDA tensor goes to the kernel (or the wrapper raises),
a CPU tensor goes to the plain version; nothing falls back. Each wrapper
counts its kernel launches in `<wrapper>.launches` (the backward's
channel reduction is part of its one launch).

Not carried over: `block_rows`, a TPU tile parameter (the kernels choose
their own grid), and `interpret`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import launches as _launches
from .decode import _raise_on, _route
from .flash import _stream

__all__ = ["bn_act_epilogue", "bn_act_epilogue_fwd",
           "bn_act_epilogue_fwd_ref", "bn_act_epilogue_bwd",
           "bn_act_epilogue_bwd_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "mxtpu_bn_act_epilogue_fwd": [_I, _P, _P, _P, _P, _P, _L, _L, _P],
    "mxtpu_bn_act_epilogue_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                                  _L, _P],
}


def _lib():
    lib = _build.load("epilogue", _SIGNATURES)
    query = lib.mxtpu_bn_act_epilogue_bwd_workspace
    query.argtypes, query.restype = [_I, _L, _L], _L
    return lib


# -- plain versions ----------------------------------------------------------

def bn_act_epilogue_fwd_ref(x, scale, shift, residual=None):
    """Plain forward: x (R, C), scale and shift (C,), residual (R, C) or
    None -> relu(x * scale + shift [+ residual]) in float32, returned in
    x's dtype."""
    y = x.float() * scale.float() + shift.float()
    if residual is not None:
        y = y + residual.float()
    return torch.relu(y).to(x.dtype)


def bn_act_epilogue_bwd_ref(x, scale, y, dy, with_residual=False):
    """Plain backward: (dx, dscale, dshift) and, with `with_residual`,
    dres. The mask is y > 0; x is masked as well as dy, as the JAX kernel
    does, so a NaN in a dead element does not reach the sums."""
    live = y.float() > 0
    g = torch.where(live, dy.float(), 0.0)
    xm = torch.where(live, x.float(), 0.0)
    dx = (g * scale.float()).to(x.dtype)
    dscale, dshift = (g * xm).sum(0), g.sum(0)
    if with_residual:
        return dx, dscale, dshift, g.to(dy.dtype)
    return dx, dscale, dshift


# -- kernel wrappers ---------------------------------------------------------

def _rows(name, t, like):
    """`t` as a contiguous (R, C) tensor of `like`'s shape, dtype and
    device (a non-contiguous view is copied)."""
    if t.shape != like.shape or t.dtype != like.dtype or \
            t.device != like.device:
        raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}, expected {tuple(like.shape)} "
                         f"{like.dtype} on {like.device}")
    return t.contiguous()


def _check(name, x, scale, *channel_vectors):
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (R, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} is not float32, "
                         f"bfloat16 or float16")
    C = x.shape[1]
    if C < 1:
        raise ValueError(f"{name}: no channels")
    out = []
    for v in (scale, *channel_vectors):
        if v.numel() != C or v.device != x.device:
            raise ValueError(f"{name}: channel vector {tuple(v.shape)} on "
                             f"{v.device}, expected ({C},) on {x.device}")
        out.append(v.reshape(C).to(torch.float32).contiguous())
    return x.contiguous(), out


def bn_act_epilogue_fwd(x, scale, shift, residual=None):
    """Epilogue forward: x (R, C) float32, bfloat16 or float16, scale
    and shift (C,), residual (R, C) of x's dtype or None. Returns y (R, C)
    in x's dtype.

    CUDA tensors run the Hopper kernel of `ops/csrc/epilogue.cu` (each
    thread one fixed group of channels, 16-byte loads where C and the
    pointers allow, a grid stride over rows); CPU tensors run
    `bn_act_epilogue_fwd_ref`."""
    name = "bn_act_epilogue_fwd"
    if not _route(name, x):
        return bn_act_epilogue_fwd_ref(x, scale, shift, residual)
    x, (scale, shift) = _check(name, x, scale, shift)
    res = None if residual is None else _rows(name, residual, x)
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.mxtpu_bn_act_epilogue_fwd(
            _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), None if res is None else res.data_ptr(),
            y.data_ptr(), x.shape[0], x.shape[1], _stream(x.device))
    _raise_on(lib, err, name)
    _launches.count(bn_act_epilogue_fwd)
    return y


bn_act_epilogue_fwd.launches = 0


def bn_act_epilogue_bwd(x, scale, y, dy, with_residual=False):
    """Epilogue backward: x, y and dy (R, C) of one dtype (float32,
    bfloat16 or float16), scale (C,). Returns (dx, dscale, dshift) and, with
    `with_residual`, dres: dx and dres (R, C) in x's dtype, dscale and
    dshift (C,) float32.

    CUDA tensors run the Hopper kernels (each block writes its per-channel
    partial sums to an (n_blocks, 2C) float32 workspace, a second kernel
    sums them in a fixed order: deterministic, no atomics; dx and dres
    from `torch.empty`); CPU tensors run `bn_act_epilogue_bwd_ref`."""
    name = "bn_act_epilogue_bwd"
    if not _route(name, x):
        return bn_act_epilogue_bwd_ref(x, scale, y, dy, with_residual)
    x, (scale,) = _check(name, x, scale)
    y, dy = _rows(name, y, x), _rows(name, dy, x)
    R, C = x.shape
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if with_residual else None
    sums = torch.empty(2 * C, dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        floats = lib.mxtpu_bn_act_epilogue_bwd_workspace(_DTYPES[x.dtype],
                                                         R, C)
        workspace = torch.empty(max(floats, 1), dtype=torch.float32,
                                device=x.device)
        err = lib.mxtpu_bn_act_epilogue_bwd(
            _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), y.data_ptr(),
            dy.data_ptr(), dx.data_ptr(),
            None if dres is None else dres.data_ptr(), workspace.data_ptr(),
            sums.data_ptr(), R, C, _stream(x.device))
    _raise_on(lib, err, name)
    _launches.count(bn_act_epilogue_bwd)
    if with_residual:
        return dx, sums[:C], sums[C:], dres
    return dx, sums[:C], sums[C:]


bn_act_epilogue_bwd.launches = 0


class _Epilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, residual):
        y = bn_act_epilogue_fwd(x, scale, shift, residual)
        ctx.save_for_backward(x, scale, y)
        ctx.with_residual = residual is not None
        ctx.shapes = (scale.shape, shift.shape)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, y = ctx.saved_tensors
        out = bn_act_epilogue_bwd(x, scale, y, dy.to(y.dtype),
                                  ctx.with_residual)
        dx, dscale, dshift = out[:3]
        dres = out[3] if ctx.with_residual else None
        return (dx, dscale.reshape(ctx.shapes[0]),
                dshift.reshape(ctx.shapes[1]), dres)


def bn_act_epilogue(x, scale, shift, residual=None):
    """relu(x * scale + shift [+ residual]) on a channels-last (..., C)
    activation in one pass, differentiable in x, scale, shift and the
    residual through the backward kernel (CUDA) or its plain version
    (CPU). scale and shift are (C,): the BN affine folded to scale =
    gamma * rsqrt(var + eps), shift = beta - mean * scale."""
    C = x.shape[-1]
    flat = x.reshape(-1, C)
    res = None if residual is None else residual.reshape(-1, C)
    return _Epilogue.apply(flat, scale, shift, res).reshape(x.shape)
