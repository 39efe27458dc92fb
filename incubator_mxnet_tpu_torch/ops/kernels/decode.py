"""Decode attention: query rows of each sequence against its KV cache.

The counterpart of the decode half of the JAX package's
`ops/pallas_kernels.py`. Three kernels, hand-written in CUDA for Hopper
(`ops/csrc/decode.cu`), each with a plain PyTorch version beside it:

- `paged_decode_attention` (plain: `paged_decode_attention_ref`) runs in
  every serving decode step, in every layer: each slot's query attends
  its own pages of a global KV page pool;
- `paged_decode_attention_wide` (plain:
  `paged_decode_attention_wide_ref`) is the same with Q consecutive query
  rows per slot, causal among themselves: the serving levers' wide step
  (chunked prefill, prefix-cache tail prefill, speculative verification);
- `flash_decode` (plain: `flash_decode_ref`, which is
  `dense_decode_attention`) serves `generate` and `beam_search` with
  `use_flash`: the same over a dense `(B, T, H, D)` cache.

Dispatch rule: a CUDA tensor goes to the kernel (or the wrapper raises),
a CPU tensor goes to the plain version; nothing falls back. Each wrapper
counts its kernel launches in `<wrapper>.launches`.

Unlike the JAX `flash_decode`, which fell back to the dense path when
the cache length did not tile into `DECODE_BLOCK` blocks, the CUDA
kernel takes any cache length, so the port has no fallback and no
fallback counter. `DECODE_BLOCK` stays because `init_kv_cache` pads
caches with it, keeping cache shapes equal to the JAX package's.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

__all__ = ["DECODE_BLOCK", "dense_decode_attention", "flash_decode",
           "flash_decode_ref", "paged_decode_attention",
           "paged_decode_attention_ref", "paged_decode_attention_wide",
           "paged_decode_attention_wide_ref"]

DECODE_BLOCK = 128
_NEG_INF = -1e30
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mxtpu_paged_decode_attention": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, ctypes.c_float, _P],
    "mxtpu_flash_decode": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           ctypes.c_float, _P],
    "mxtpu_paged_decode_attention_wide": [_I, _P, _P, _P, _P, _P, _P, _I,
                                          _I, _I, _I, _I, _I, _I,
                                          ctypes.c_float, _P],
}


def _lib():
    return _build.load("decode", _SIGNATURES)


def _raise_on(lib, err, what):
    if err:
        msg = lib.mxtpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def _per_seq_n_valid(n_valid, batch, device, dtype=torch.int64):
    """`n_valid` (python int, 0-d or (B,) tensor) as a (B,) tensor on
    `device`. A python int is filled on the device: copying it from the
    host would make every call wait for the device."""
    if not isinstance(n_valid, torch.Tensor):
        return torch.full((batch,), int(n_valid), dtype=dtype, device=device)
    return n_valid.to(device=device, dtype=dtype).expand(batch).contiguous()


def dense_decode_attention(q, k_cache, v_cache, n_valid):
    """Plain single-query cache attention: q (B, H, D), caches
    (B, T, H, D); each sequence attends its first n_valid positions.
    `n_valid` is a scalar (one depth for the batch) or a (B,) vector.
    Scores, softmax and the weighted sum are float32; the result has
    q's dtype. Masks with -1e30, as the JAX version does."""
    B, T = k_cache.shape[0], k_cache.shape[1]
    D = q.shape[-1]
    nv = _per_seq_n_valid(n_valid, B, q.device)
    s = torch.einsum("bhd,bthd->bht", q.float(), k_cache.float())
    s = s / math.sqrt(D)
    live = torch.arange(T, device=q.device)[None, None] < nv[:, None, None]
    p = torch.softmax(s.masked_fill(~live, _NEG_INF), dim=-1)
    return torch.einsum("bht,bthd->bhd", p, v_cache.float()).to(q.dtype)


flash_decode_ref = dense_decode_attention


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, n_valid):
    """Plain paged decode attention: gather each slot's pages into a
    dense cache, then the masked softmax of `dense_decode_attention`. A
    slot with n_valid == 0 gives zeros, as the kernel does."""
    S, P_max = page_table.shape
    ps = k_pages.shape[1]
    idx = page_table.long()
    kc = k_pages[idx].reshape((S, P_max * ps) + tuple(k_pages.shape[2:]))
    vc = v_pages[idx].reshape((S, P_max * ps) + tuple(v_pages.shape[2:]))
    nv = _per_seq_n_valid(n_valid, S, q.device)
    out = dense_decode_attention(q, kc, vc, nv)
    return out.masked_fill((nv == 0)[:, None, None], 0.0)


def paged_decode_attention_wide_ref(q, k_pages, v_pages, page_table, n_base):
    """Plain wide paged attention: gather each slot's pages into a dense
    cache as `paged_decode_attention_ref` does, then a float32 softmax in
    which row i of slot s attends keys idx < n_base[s] + i + 1, with the
    walk clamped to min(ceil((n_base + Q) / page_size), P_max) pages, as
    the JAX kernel clamps it. Masks with -1e30; the result has q's
    dtype."""
    S, Q, H, D = q.shape
    P_max = page_table.shape[1]
    ps = k_pages.shape[1]
    T = P_max * ps
    idx = page_table.long()
    kc = k_pages[idx].reshape(S, T, H, D)
    vc = v_pages[idx].reshape(S, T, H, D)
    nb = _per_seq_n_valid(n_base, S, q.device)
    walked = torch.clamp((nb + Q + ps - 1) // ps, max=P_max) * ps  # (S,)
    rows = torch.arange(Q, device=q.device)
    limit = torch.minimum(nb[:, None] + rows[None] + 1, walked[:, None])
    live = torch.arange(T, device=q.device)[None, None] < limit[..., None]
    s = torch.einsum("sqhd,sthd->shqt", q.float(), kc.float()) / math.sqrt(D)
    p = torch.softmax(s.masked_fill(~live[:, None], _NEG_INF), dim=-1)
    return torch.einsum("shqt,sthd->sqhd", p, vc.float()).to(q.dtype)


def _check_kv(name, q, caches, shape):
    for c in caches:
        if c.device != q.device:
            raise ValueError(f"{name}: tensors on {q.device} and {c.device}")
        if c.dtype not in _KV_DTYPES:
            raise ValueError(f"{name}: cache dtype {c.dtype} is not float32 "
                             f"or bfloat16")
        if c.dtype != caches[0].dtype:
            raise ValueError(f"{name}: key and value dtypes differ")
        if tuple(c.shape) != tuple(shape):
            raise ValueError(f"{name}: cache shape {tuple(c.shape)}, "
                             f"expected {tuple(shape)}")
        if not c.is_contiguous():
            raise ValueError(f"{name}: caches must be contiguous")
    if q.dtype not in _KV_DTYPES:
        raise ValueError(f"{name}: query dtype {q.dtype} is not float32 or "
                         f"bfloat16")


def _index_vector(name, t, shape, device):
    """An int32 contiguous index tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name}: index tensor on {t.device}, expected "
                         f"{device}")
    if t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: index dtype {t.dtype} is not an integer")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: index shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.to(torch.int32).contiguous()


def _route(name, q):
    """True for the kernel (CUDA tensor), False for the plain version
    (CPU tensor); raises on any other device."""
    if q.is_cuda:
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{q.device}")


def paged_decode_attention(q, k_pages, v_pages, page_table, n_valid):
    """Single-query attention over a paged KV cache.

    q: (S, H, D), one query per decode slot; k_pages / v_pages:
    (num_pages, page_size, H, D), the global page pool (float32 or
    bfloat16, contiguous: a layer's slice of the `(L, P, ps, H, D)` pool
    is); page_table: (S, P_max) integer page ids owned by each slot, in
    sequence order (entries past the live length are not read);
    n_valid: (S,) integer tokens live per slot, or a scalar; 0 marks a
    dead slot, whose output is zeros. Returns (S, H, D) in q's dtype.

    CUDA tensors run the Hopper kernel of `ops/csrc/decode.cu` (one
    thread block per (slot, head), walking only ceil(n_valid /
    page_size) pages); CPU tensors run `paged_decode_attention_ref`."""
    name = "paged_decode_attention"
    if not _route(name, q):
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          n_valid)
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"{name}: q must be (S, H, D) and the pools "
                         f"(P, page_size, H, D)")
    S, H, D = q.shape
    P, ps = k_pages.shape[0], k_pages.shape[1]
    _check_kv(name, q, (k_pages, v_pages), (P, ps, H, D))
    if page_table.dim() != 2:
        raise ValueError(f"{name}: page_table must be (S, P_max)")
    W = page_table.shape[1]
    table = _index_vector(name, page_table, (S, W), q.device)
    nv = _per_seq_n_valid(n_valid, S, q.device, torch.int32)
    qf = q.float().contiguous()
    out = torch.empty_like(qf)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtpu_paged_decode_attention(
            _KV_DTYPES[k_pages.dtype], qf.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), table.data_ptr(), nv.data_ptr(),
            out.data_ptr(), S, H, D, ps, P, W, 1.0 / math.sqrt(D), stream)
    _raise_on(lib, err, name)
    paged_decode_attention.launches += 1
    return out.to(q.dtype)


paged_decode_attention.launches = 0


def paged_decode_attention_wide(q, k_pages, v_pages, page_table, n_base):
    """Q consecutive query rows per slot over a paged KV cache, in one
    launch.

    q: (S, Q, H, D), row i of slot s at position n_base[s] + i;
    k_pages / v_pages: (num_pages, page_size, H, D), the page pool
    (float32 or bfloat16, contiguous), into which the caller has already
    written this call's Q rows; page_table: (S, P_max) integer page ids;
    n_base: (S,) integer tokens cached per slot before row 0, or a scalar.
    Row i attends keys idx < n_base + i + 1 (the paged prefix plus causal
    masking among the call's own rows), the walk clamped to the table, so
    a row past a slot's last owned page reads nothing outside its row.
    Returns (S, Q, H, D) in q's dtype.

    CUDA tensors run the Hopper kernel of `ops/csrc/decode.cu` (one
    thread block per (slot, head, group of 8 rows), K/V tiles staged in
    shared memory once for the group's rows); CPU tensors run
    `paged_decode_attention_wide_ref`."""
    name = "paged_decode_attention_wide"
    if not _route(name, q):
        return paged_decode_attention_wide_ref(q, k_pages, v_pages,
                                               page_table, n_base)
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"{name}: q must be (S, Q, H, D) and the pools "
                         f"(P, page_size, H, D)")
    S, Q, H, D = q.shape
    P, ps = k_pages.shape[0], k_pages.shape[1]
    _check_kv(name, q, (k_pages, v_pages), (P, ps, H, D))
    if page_table.dim() != 2:
        raise ValueError(f"{name}: page_table must be (S, P_max)")
    W = page_table.shape[1]
    table = _index_vector(name, page_table, (S, W), q.device)
    nb = _per_seq_n_valid(n_base, S, q.device, torch.int32)
    qf = q.float().contiguous()
    out = torch.empty_like(qf)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtpu_paged_decode_attention_wide(
            _KV_DTYPES[k_pages.dtype], qf.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), table.data_ptr(), nb.data_ptr(),
            out.data_ptr(), S, Q, H, D, ps, P, W, 1.0 / math.sqrt(D), stream)
    _raise_on(lib, err, name)
    paged_decode_attention_wide.launches += 1
    return out.to(q.dtype)


paged_decode_attention_wide.launches = 0


def flash_decode(q, k_cache, v_cache, n_valid):
    """Single-query attention over a dense cache: q (B, H, D) against
    caches (B, T, H, D) (float32 or bfloat16, contiguous), attending the
    first `n_valid` positions of each sequence (a scalar, or a (B,)
    vector of per-sequence depths). Returns (B, H, D) in q's dtype.

    CUDA tensors run the Hopper kernel of `ops/csrc/decode.cu`, which
    reads the cache in its own layout and streams only the live
    positions; any T is taken. CPU tensors run `flash_decode_ref`."""
    name = "flash_decode"
    if not _route(name, q):
        return flash_decode_ref(q, k_cache, v_cache, n_valid)
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, D) and the caches "
                         f"(B, T, H, D)")
    B, H, D = q.shape
    T = k_cache.shape[1]
    _check_kv(name, q, (k_cache, v_cache), (B, T, H, D))
    nv = _per_seq_n_valid(n_valid, B, q.device, torch.int32)
    qf = q.float().contiguous()
    out = torch.empty_like(qf)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtpu_flash_decode(
            _KV_DTYPES[k_cache.dtype], qf.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), nv.data_ptr(), out.data_ptr(), B, T, H, D,
            1.0 / math.sqrt(D), stream)
    _raise_on(lib, err, name)
    flash_decode.launches += 1
    return out.to(q.dtype)


flash_decode.launches = 0
