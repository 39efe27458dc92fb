"""Trainable flash attention: the FlashAttention-2 forward and its
recomputing backward.

The counterpart of the top half of the JAX package's
`ops/pallas_kernels.py`. Three kernels, hand-written in CUDA for Hopper
(`ops/csrc/flash_attention.cu`), each with a plain PyTorch version
beside it:

- `flash_attention_fwd` (plain: `flash_attention_fwd_ref`): o and the
  row logsumexp of softmax(q kᵀ · scale) v, causal or not;
- `flash_attention_dq` (plain: `flash_attention_dq_ref`): dQ, with p
  recomputed from lse;
- `flash_attention_dkv` (plain: `flash_attention_dkv_ref`): dK and dV.

`flash_attention_bwd` computes delta = rowsum(dO · O) in plain PyTorch,
as the JAX package does outside its kernels, then runs the dQ and dK/dV
wrappers. `flash_attention` is the `torch.autograd.Function` around them,
the counterpart of the JAX `jax.custom_vjp`: it saves (q, k, v, o, lse).

Dispatch rule: a CUDA tensor goes to the kernel (or the wrapper raises),
a CPU tensor goes to the plain version, so the CPU tests run the same
Function; nothing falls back. Each wrapper counts its kernel launches in
`<wrapper>.launches`.

Unlike the JAX kernels, whose blocks had to tile T (the JAX transformer
padded causal remainders and fell back to dense attention, counted, for
non-causal ones), the CUDA kernels mask the ragged end themselves: any T
runs them, so the port has no padding, no dense fallback and no fallback
counter. lse is a plain (B, H, T) float32 tensor, without the TPU
kernel's lane replication. `block_q` / `block_k` are TPU parameters and
are not carried over: the kernels choose their own tiles.

Head dims: the JAX kernels take any D, and so do the plain versions (the
CPU route). The CUDA kernels take any D up to `FLASH_MAX_HEAD_DIM` (256,
the decode kernels' limit too), each built for the padded D of
`padded_head_dim(D)` (16, 32, 64, 128 or 256) with the extra columns
staged as zeros; only the CUDA route checks D, and it raises above 256.
All three kernels run on the tensor cores, float32 as error-compensated
TF32 (three TF32 products per float32 product).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .decode import _raise_on, _route

__all__ = ["FLASH_MAX_HEAD_DIM", "padded_head_dim", "flash_attention",
           "flash_attention_fwd",
           "flash_attention_fwd_ref", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_dq",
           "flash_attention_dq_ref", "flash_attention_dkv",
           "flash_attention_dkv_ref"]

FLASH_MAX_HEAD_DIM = 256  # the largest head dim the kernels take
_PADDED_HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims they are built at
_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "mxtpu_flash_attention_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _F, _P],
    "mxtpu_flash_attention_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _F, _P],
    "mxtpu_flash_attention_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _I, _F, _P],
}


def _lib():
    return _build.load("flash_attention", _SIGNATURES)


# -- plain versions ----------------------------------------------------------

def _scores(q, k, causal):
    """float32 scores q kᵀ · scale (B, H, T, T), masked with -1e30 after
    the scale where causal, as the JAX `_causal_mask`."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        T = q.shape[2]
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def _delta(o, do):
    """rowsum(dO · O) in float32, (B, H, T)."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_fwd_ref(q, k, v, causal=False):
    """Plain forward: the dense masked softmax. q, k, v (B, H, T, D) ->
    (o in q's dtype, lse (B, H, T) float32). Math is float32; p is rounded
    to v's dtype before P·V, as in the kernel."""
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _p_ds(q, k, v, do, lse, delta, causal):
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse.float()[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.float()[..., None]) * scale


def flash_attention_dq_ref(q, k, v, do, lse, delta, causal=False):
    """Plain dQ: p = exp(s - lse), ds = p · (dO vᵀ - delta) · scale,
    dq = ds (rounded to k's dtype) · K. Returns dq in q's dtype."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, delta, causal=False):
    """Plain dK/dV: dv = pᵀ (rounded to dO's dtype) · dO, dk = dsᵀ (rounded
    to q's dtype) · Q. Returns (dk, dv) in k's and v's dtypes."""
    p, ds = _p_ds(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal=False):
    """Plain backward: (dq, dk, dv) from the saved (q, k, v, o, lse) and
    the output gradient dO."""
    delta = _delta(o, do)
    dk, dv = flash_attention_dkv_ref(q, k, v, do, lse, delta, causal)
    return flash_attention_dq_ref(q, k, v, do, lse, delta, causal), dk, dv


# -- kernel wrappers ---------------------------------------------------------

def padded_head_dim(d):
    """The head dim the kernels run a head dim `d` at: the smallest of 16,
    32, 64, 128 and 256 at or above it (the same rule as `padded_dim` in
    `flash_attention.cu`). Raises for d outside 1 ... 256."""
    if not 1 <= d <= FLASH_MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside the kernels' range 1 ... "
                         f"{FLASH_MAX_HEAD_DIM}")
    return next(p for p in _PADDED_HEAD_DIMS if p >= d)


def _check(name, q, operands):
    """(B, H, T, D) of q, after checking that every operand has its shape,
    device and dtype and that D is one the kernels take (1 ... 256). Only
    the CUDA route calls it: the plain versions take any D."""
    if q.dim() != 4:
        raise ValueError(f"{name}: operands must be (B, H, T, D), got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} is not float32 or "
                         f"bfloat16")
    for x in operands:
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name}: operands on {x.device} / {x.dtype}, "
                             f"q on {q.device} / {q.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"{name}: operand shape {tuple(x.shape)}, q "
                             f"{tuple(q.shape)}")
    if not 1 <= q.shape[-1] <= FLASH_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[-1]} is outside the "
                         f"kernels' range 1 ... {FLASH_MAX_HEAD_DIM}")
    return q.shape


def _operand(x):
    """x as the kernels read it: D stride 1, any batch/head/row strides
    (the kernels stage with the widest copy every operand's address and
    strides allow); a copy only where the D stride is not 1 (e.g. an
    expanded gradient)."""
    if x.stride(-1) == 1 or x.shape[-1] == 1:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _stat(name, t, shape, device):
    """A contiguous (B, H, T) float32 statistic (lse or delta)."""
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: statistics must be float32 on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: statistic shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    return t.contiguous()


def _strides(*tensors):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_fwd(q, k, v, causal=False):
    """FlashAttention-2 forward: q, k, v (B, H, T, D), all float32 or all
    bfloat16, any T, any D (up to 256 on the card). Returns (o (B, H, T, D)
    in q's dtype and layout, lse (B, H, T) float32).

    CUDA tensors run the Hopper kernel of `ops/csrc/flash_attention.cu`:
    four warps per (b·h, 64 query rows), each owning 16 whole rows (eight
    at a padded D of 256, two per 16 rows over halves of the columns), an
    online softmax over key tiles streamed through a two-stage cp.async
    ring, Q·Kᵀ and P·V on the tensor cores (float32 as 3 × TF32, so the
    lse that the backward recomputes p from keeps float32 accuracy), p
    and the running sums in registers, causal walks stopping at the
    diagonal with row tiles i and n - 1 - i paired in one block. Its bound
    at the training shape is operations (13.0 µs of 3 × TF32 work at
    495 TFLOP/s); it runs at several times that, held back by the
    fragment loads, splits and softmax issued beside each product
    (PERF.md). Each operand is read in place through its strides; CPU
    tensors run `flash_attention_fwd_ref`."""
    name = "flash_attention_fwd"
    if not _route(name, q):
        return flash_attention_fwd_ref(q, k, v, causal)
    B, H, T, D = _check(name, q, (k, v))
    q, k, v = _operand(q), _operand(k), _operand(v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mxtpu_flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), _strides(q, k, v, o), B, H, T, D,
            int(causal), 1.0 / math.sqrt(D), _stream(q.device))
    _raise_on(lib, err, name)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_dq(q, k, v, do, lse, delta, causal=False):
    """dQ of flash attention: q, k, v, do (B, H, T, D) of one dtype, lse
    and delta (B, H, T) float32. Returns dq in q's dtype and layout.

    CUDA tensors run the Hopper kernel (one block per (b·h, 64 query
    rows), walking key tiles up to the diagonal when causal, its products
    on the tensor cores); CPU tensors run `flash_attention_dq_ref`."""
    name = "flash_attention_dq"
    if not _route(name, q):
        return flash_attention_dq_ref(q, k, v, do, lse, delta, causal)
    B, H, T, D = _check(name, q, (k, v, do))
    q, k, v, do = (_operand(x) for x in (q, k, v, do))
    lse = _stat(name, lse, (B, H, T), q.device)
    delta = _stat(name, delta, (B, H, T), q.device)
    dq = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mxtpu_flash_attention_dq(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do, dq), B, H, T, D, int(causal),
            1.0 / math.sqrt(D), _stream(q.device))
    _raise_on(lib, err, name)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, delta, causal=False):
    """dK and dV of flash attention, from the same operands as
    `flash_attention_dq`. Returns (dk, dv) in k's and v's dtype and
    layout.

    CUDA tensors run the Hopper kernel (one block per (b·h, 64 key rows),
    walking query tiles from the diagonal on when causal, its products on
    the tensor cores); CPU tensors run `flash_attention_dkv_ref`."""
    name = "flash_attention_dkv"
    if not _route(name, q):
        return flash_attention_dkv_ref(q, k, v, do, lse, delta, causal)
    B, H, T, D = _check(name, q, (k, v, do))
    q, k, v, do = (_operand(x) for x in (q, k, v, do))
    lse = _stat(name, lse, (B, H, T), q.device)
    delta = _stat(name, delta, (B, H, T), q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mxtpu_flash_attention_dkv(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, do, dk, dv), B, H, T, D,
            int(causal), 1.0 / math.sqrt(D), _stream(q.device))
    _raise_on(lib, err, name)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal=False):
    """FlashAttention-2 backward: (dq, dk, dv) from the saved (q, k, v, o,
    lse) and the output gradient dO. delta = rowsum(dO · O) is plain
    PyTorch; the dQ and dK/dV wrappers then launch one kernel each (CUDA)
    or run their plain versions (CPU)."""
    delta = _delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=False):
    """Trainable attention: q, k, v (B, H, T, D) -> (B, H, T, D), through
    the flash kernels forward and backward (CUDA) or their plain versions
    (CPU)."""
    return _FlashAttention.apply(q, k, v, bool(causal))
