"""Decode attention: query rows of each sequence against its KV cache.

The counterpart of the decode half of the JAX package's
`ops/pallas_kernels.py`. Three kernels, hand-written in CUDA for Hopper
(`ops/csrc/decode.cu`), each with a plain PyTorch version beside it:

- `paged_decode_attention` (plain: `paged_decode_attention_ref`; the
  kernel's split walk: `paged_decode_attention_split_ref`) runs in every
  serving decode step, in every layer: each slot's query attends its own
  pages of a global KV page pool;
- `paged_decode_attention_wide` (plain:
  `paged_decode_attention_wide_ref`) is the same with Q consecutive query
  rows per slot, causal among themselves: the serving levers' wide step
  (chunked prefill, prefix-cache tail prefill, speculative verification);
- `flash_decode` (plain: `flash_decode_ref`, `dense_decode_attention`
  with a sequence of no live position giving zeros; the split walk:
  `flash_decode_split_ref`) serves `generate` and `beam_search` with
  `use_flash`: the same over a dense `(B, T, H, D)` cache.

The single-query kernels walk a sequence's keys in splits of
`DECODE_KEYS_PER_SPLIT` across thread blocks, each writing float32
partials into a workspace the wrapper takes from PyTorch's allocator;
the last block of a (sequence, head) to finish merges them in a fixed
order, in the same launch. The host never reads the device, so a CUDA
graph can capture a call. The blocks find the last one by arrival
counters that the wrapper keeps per stream (`_merge_counters`), so
calls on two streams, or in two CUDA graphs, never share them.

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

__all__ = ["DECODE_BLOCK", "DECODE_KEYS_PER_SPLIT", "dense_decode_attention",
           "flash_decode", "flash_decode_ref", "flash_decode_split_ref",
           "paged_decode_attention", "paged_decode_attention_ref",
           "paged_decode_attention_split_ref", "paged_decode_attention_wide",
           "paged_decode_attention_wide_ref",
           "paged_decode_attention_wide_split_ref", "wide_keys_per_split"]

DECODE_BLOCK = 128
# keys a split of the single-query kernels' walk covers (kDecodeKeys in
# decode.cu; tools/kernel_variants.py times 16 and 64 beside it)
DECODE_KEYS_PER_SPLIT = 32
WIDE_MAX_HEAD_DIM = 256  # the largest head dim the decode kernels take
_NEG_INF = -1e30
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mxtpu_paged_decode_attention": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I,
                                     ctypes.c_float, _P],
    "mxtpu_flash_decode": [_I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                           _I, _I, _I, ctypes.c_float, _P],
    "mxtpu_paged_decode_attention_wide": [_I, _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _I, _I, _I,
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


def flash_decode_ref(q, k_cache, v_cache, n_valid):
    """Plain flash decode: `dense_decode_attention`, with a sequence of no
    live position giving zeros, as the JAX kernel and the CUDA kernel do
    (the dense softmax would average every position)."""
    nv = _per_seq_n_valid(n_valid, q.shape[0], q.device)
    out = dense_decode_attention(q, k_cache, v_cache, nv)
    return out.masked_fill((nv <= 0)[:, None, None], 0.0)


def _gather_pages(k_pages, v_pages, page_table):
    """Each slot's pages as dense (S, P_max * page_size, H, D) caches."""
    S, P_max = page_table.shape
    idx = page_table.long()
    shape = (S, P_max * k_pages.shape[1]) + tuple(k_pages.shape[2:])
    return k_pages[idx].reshape(shape), v_pages[idx].reshape(shape)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, n_valid):
    """Plain paged decode attention: gather each slot's pages into a
    dense cache, then the masked softmax of `dense_decode_attention`. A
    slot with n_valid == 0 gives zeros, as the kernel does."""
    kc, vc = _gather_pages(k_pages, v_pages, page_table)
    nv = _per_seq_n_valid(n_valid, q.shape[0], q.device)
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
    kc, vc = _gather_pages(k_pages, v_pages, page_table)
    nb = _per_seq_n_valid(n_base, S, q.device)
    walked = torch.clamp((nb + Q + ps - 1) // ps, max=P_max) * ps  # (S,)
    rows = torch.arange(Q, device=q.device)
    limit = torch.minimum(nb[:, None] + rows[None] + 1, walked[:, None])
    live = torch.arange(T, device=q.device)[None, None] < limit[..., None]
    s = torch.einsum("sqhd,sthd->shqt", q.float(), kc.float()) / math.sqrt(D)
    p = torch.softmax(s.masked_fill(~live[:, None], _NEG_INF), dim=-1)
    return torch.einsum("shqt,sthd->sqhd", p, vc.float()).to(q.dtype)


def wide_keys_per_split(head_dim):
    """Keys one split of the wide kernel's key walk covers at `head_dim`:
    64 up to a head dim of 64, else 4096 / D_p, D_p the power of two at or
    above it (32 at 128, 16 at 256), the same rule as `wide_split_keys` in
    `decode.cu`. Raises for a head dim outside 1 ... 256."""
    if not 1 <= head_dim <= WIDE_MAX_HEAD_DIM:
        raise ValueError(f"head dim {head_dim} is outside the decode "
                         f"kernels' range 1 ... {WIDE_MAX_HEAD_DIM}")
    padded = 16
    while padded < head_dim:
        padded *= 2
    return 64 if padded <= 64 else 4096 // padded


def _split_walk(q, kc, vc, limit, keys_per_split):
    """The split key walk of the kernels, in plain PyTorch: q (S, Q, H, D)
    against dense caches (S, T, H, D), row i of slot s attending keys
    idx < limit[s, i]. The keys are cut into splits of `keys_per_split`;
    each split gives float32 partials for each row (its max m over the
    row's live keys, l = sum exp(s - m), o = sum p v with p rounded to
    the caches' dtype; m = -1e30 and l = 0 where the row sees no key of
    the split), and the partials are merged in split order by the
    log-sum-exp rule, empty ones skipped; a row with no live key gives
    zeros. Returns (S, Q, H, D) float32."""
    S, Q, H, D = q.shape
    T = kc.shape[1]
    n = -(-T // keys_per_split)
    pad = n * keys_per_split - T
    live = (torch.arange(n * keys_per_split, device=q.device)[None, None]
            < limit[..., None])                       # (S, Q, n * K)
    live = live.reshape(S, 1, Q, n, keys_per_split)
    s = torch.einsum("sqhd,sthd->shqt", q.float(), kc.float()) / math.sqrt(D)
    s = torch.nn.functional.pad(s, (0, pad)).reshape(S, H, Q, n,
                                                     keys_per_split)
    m = s.masked_fill(~live, _NEG_INF).amax(-1)       # (S, H, Q, n)
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    vs = torch.nn.functional.pad(vc.float(), (0, 0, 0, 0, 0, pad))
    vs = vs.reshape(S, n, keys_per_split, H, D)
    o = torch.einsum("shqnk,snkhd->shqnd", p.to(vc.dtype).float(), vs)
    seen = l > 0
    top = m.masked_fill(~seen, _NEG_INF).amax(-1)     # (S, H, Q)
    total = torch.zeros_like(top)
    out = torch.zeros((S, H, Q, D), dtype=torch.float32, device=q.device)
    for j in range(n):  # the combine's order
        c = torch.where(seen[..., j], torch.exp(m[..., j] - top),
                        torch.zeros_like(top))
        total = total + l[..., j] * c
        out = out + o[..., j, :] * c[..., None]
    out = out / total.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)


def paged_decode_attention_wide_split_ref(q, k_pages, v_pages, page_table,
                                          n_base, keys_per_split):
    """Plain version of the wide kernel's split key walk (`_split_walk`):
    the same function as `paged_decode_attention_wide_ref`, computed as
    the kernel computes it. Tests hold it against the JAX kernel; the
    main path never calls it."""
    S, Q = q.shape[:2]
    kc, vc = _gather_pages(k_pages, v_pages, page_table)
    nb = _per_seq_n_valid(n_base, S, q.device).clamp(min=0)
    rows = torch.arange(Q, device=q.device)
    limit = torch.clamp(nb[:, None] + rows[None] + 1, max=kc.shape[1])
    return _split_walk(q, kc, vc, limit, keys_per_split).to(q.dtype)


def paged_decode_attention_split_ref(q, k_pages, v_pages, page_table,
                                     n_valid, keys_per_split):
    """Plain version of `paged_decode_attention`'s split key walk
    (`_split_walk`, one row per slot over min(n_valid, P_max * page_size)
    keys): the same function as `paged_decode_attention_ref`, computed as
    the kernel computes it. Tests hold it against the JAX kernel; the
    main path never calls it."""
    kc, vc = _gather_pages(k_pages, v_pages, page_table)
    nv = _per_seq_n_valid(n_valid, q.shape[0], q.device)
    limit = nv.clamp(0, kc.shape[1])[:, None]
    return _split_walk(q[:, None], kc, vc, limit,
                       keys_per_split)[:, 0].to(q.dtype)


def flash_decode_split_ref(q, k_cache, v_cache, n_valid, keys_per_split):
    """Plain version of `flash_decode`'s split key walk (`_split_walk`,
    one row per sequence over min(n_valid, T) keys): the same function
    as `flash_decode_ref`, computed as the kernel computes it. Tests hold
    it against the JAX kernel; the main path never calls it."""
    nv = _per_seq_n_valid(n_valid, q.shape[0], q.device)
    limit = nv.clamp(0, k_cache.shape[1])[:, None]
    return _split_walk(q[:, None], k_cache, v_cache, limit,
                       keys_per_split)[:, 0].to(q.dtype)


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


def _decode_splits(cap):
    """Splits of the single-query kernels' walk over `cap` keys."""
    return -(-cap // DECODE_KEYS_PER_SPLIT)


def _workspace(rows, n_split, H, D, device):
    """float32 partials (o, then m and l) of a split walk, from PyTorch's
    allocator on the current stream."""
    return torch.empty(rows * n_split * H * (D + 2), dtype=torch.float32,
                       device=device)


# (device index, stream handle) -> the merge's arrival counters on it
_COUNTERS = {}


def _merge_counters(rows, device):
    """int32 arrival counters of the single-query kernels' merge, one per
    (sequence, head), zero before the call. The merging block sets its
    counter back to zero, so an array is zeroed only when it is made: one
    per stream, grown when a call needs more, so calls on two streams
    never share one. A call being captured in a CUDA graph gets an array
    of its own, zeroed inside the graph, so two graphs never share one
    either."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(rows, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < rows:
        counters = _COUNTERS[key] = torch.zeros(rows, dtype=torch.int32,
                                                device=device)
    return counters


def paged_decode_attention(q, k_pages, v_pages, page_table, n_valid):
    """Single-query attention over a paged KV cache.

    q: (S, H, D), one query per decode slot (float32 or bfloat16);
    k_pages / v_pages: (num_pages, page_size, H, D), the global page pool
    (float32 or bfloat16, contiguous: a layer's slice of the
    `(L, P, ps, H, D)` pool is); page_table: (S, P_max) integer page ids
    owned by each slot, in sequence order (entries past the live length
    are not read); n_valid: (S,) integer tokens live per slot, or a
    scalar; 0 marks a dead slot, whose output is zeros. Returns (S, H, D)
    in q's dtype.

    CUDA tensors run the Hopper kernel of `ops/csrc/decode.cu`: a split
    key walk (one thread block per (head, slot, split of
    `DECODE_KEYS_PER_SPLIT` keys), splits past a slot's n_valid stopping
    at once) writes float32 partials into a workspace taken here from
    PyTorch's allocator, and the last block of each (slot, head) to
    finish merges them in a fixed order, found by the stream's arrival
    counters (`_merge_counters`). CPU tensors run
    `paged_decode_attention_ref`."""
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
    n_split = _decode_splits(W * ps)
    q = q.contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        work = _workspace(S, n_split, H, D, q.device)
        counters = _merge_counters(S * H, q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtpu_paged_decode_attention(
            _KV_DTYPES[k_pages.dtype], _KV_DTYPES[q.dtype], q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
            nv.data_ptr(), work.data_ptr(), counters.data_ptr(),
            out.data_ptr(), S, H, D, ps, P, W, n_split, 1.0 / math.sqrt(D),
            stream)
    _raise_on(lib, err, name)
    paged_decode_attention.launches += 1
    return out


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

    CUDA tensors run the Hopper kernels of `ops/csrc/decode.cu`: a split
    key walk (one thread block per (head, slot, split of
    `wide_keys_per_split(D)` keys, group of 64 rows), every live K/V row
    of a (slot, head) read once per split for all the group's rows, the
    products on the tensor cores) writes float32 partials into a
    workspace taken here from PyTorch's allocator, and a combine kernel
    merges them in a fixed order; one launch is counted for the two.
    CPU tensors run `paged_decode_attention_wide_ref`."""
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
    n_split = -(-W * ps // wide_keys_per_split(D))
    qf = q.float().contiguous()
    out = torch.empty_like(qf)
    lib = _lib()
    with torch.cuda.device(q.device):
        # the partials (o, then m and l) on the call's stream
        work = torch.empty(S * n_split * Q * H * (D + 2),
                           dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtpu_paged_decode_attention_wide(
            _KV_DTYPES[k_pages.dtype], qf.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), table.data_ptr(), nb.data_ptr(),
            work.data_ptr(), out.data_ptr(), S, Q, H, D, ps, P, W, n_split,
            1.0 / math.sqrt(D), stream)
    _raise_on(lib, err, name)
    paged_decode_attention_wide.launches += 1
    return out.to(q.dtype)


paged_decode_attention_wide.launches = 0


def flash_decode(q, k_cache, v_cache, n_valid):
    """Single-query attention over a dense cache: q (B, H, D) (float32 or
    bfloat16) against caches (B, T, H, D) (float32 or bfloat16,
    contiguous), attending the first `n_valid` positions of each sequence
    (a python int, a 0-d tensor or a (B,) vector of per-sequence depths).
    Returns (B, H, D) in q's dtype.

    CUDA tensors run the Hopper kernel of `ops/csrc/decode.cu`, the split
    key walk and merge of `paged_decode_attention` over the cache read in
    its own layout, any T; a python int n_valid is passed to the kernel by
    value. CPU tensors run `flash_decode_ref`."""
    name = "flash_decode"
    if not _route(name, q):
        return flash_decode_ref(q, k_cache, v_cache, n_valid)
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, D) and the caches "
                         f"(B, T, H, D)")
    B, H, D = q.shape
    T = k_cache.shape[1]
    _check_kv(name, q, (k_cache, v_cache), (B, T, H, D))
    if isinstance(n_valid, torch.Tensor):
        nv, n_all = _per_seq_n_valid(n_valid, B, q.device, torch.int32), 0
    else:  # one depth for every sequence, by value: no device fill
        nv, n_all = None, max(0, min(int(n_valid), T))
    n_split = _decode_splits(T)
    q = q.contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        work = _workspace(B, n_split, H, D, q.device)
        counters = _merge_counters(B * H, q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtpu_flash_decode(
            _KV_DTYPES[k_cache.dtype], _KV_DTYPES[q.dtype], q.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(),
            None if nv is None else nv.data_ptr(), n_all, work.data_ptr(),
            counters.data_ptr(), out.data_ptr(), B, T, H, D, n_split,
            1.0 / math.sqrt(D), stream)
    _raise_on(lib, err, name)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
