"""Decode-attention parity of the PyTorch port with the JAX package (CPU).

The port's plain versions (`paged_decode_attention_ref`,
`flash_decode_ref`) and the plain versions of the kernels' split key
walk (`paged_decode_attention_split_ref`, `flash_decode_split_ref`)
against the JAX Pallas kernels run in interpret mode, as the JAX
package's own tests run them on the CPU; the port's wrappers on CPU
tensors dispatch to the plain versions. The CUDA kernels themselves run
only on the card: `chip_smoke.py` holds them against the plain versions
there.
"""
import functools

import numpy as np

import jax.numpy as jnp
import pytest
import torch

from incubator_mxnet_tpu.ops import pallas_kernels as jpk
from incubator_mxnet_tpu_torch.ops.kernels import decode as tdk
from incubator_mxnet_tpu_torch.serving import PageAllocator

# as tests/test_serving.py and tests/test_pallas.py: float32 softmax sums
# in another order
TOL = dict(rtol=2e-5, atol=2e-5)

# (heads, head_dim, page_size, pool pages, table width, slots)
SHAPES = {
    "small": (2, 32, 8, 16, 4, 4),
    "full": (8, 64, 16, 48, 32, 8),  # the full-width serving head shape
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ragged_case(rng, H, D, ps, P, W, S):
    """Pool, tables and ragged n_valid: a partial page, one token, a
    page-aligned slot, the full table and a dead slot (all-zero row)."""
    q = rng.randn(S, H, D).astype(np.float32)
    kp = rng.randn(P, ps, H, D).astype(np.float32)
    vp = rng.randn(P, ps, H, D).astype(np.float32)
    n_valid = np.array(([13, 1, 2 * ps, 0, W * ps, ps + 3, 5, 3 * ps - 1]
                        * S)[:S], np.int32)
    n_valid = np.minimum(n_valid, W * ps)
    table = np.zeros((S, W), np.int32)
    for s in range(S):
        n = -(-int(n_valid[s]) // ps)
        table[s, :n] = rng.randint(1, P, n)
    return q, kp, vp, table, n_valid


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_paged_ref_matches_jax_ragged(shape):
    H, D, ps, P, W, S = SHAPES[shape]
    q, kp, vp, table, nv = _ragged_case(np.random.RandomState(0), H, D, ps,
                                        P, W, S)
    want = np.asarray(jpk.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(nv)))
    got = tdk.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                         _t(nv)).numpy()
    # the dead slot gives zeros in both (zero-length softmax guard)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(np.isfinite(got)) and not got[nv == 0].any()
    # the wrapper takes the plain version for CPU tensors, without a launch
    before = tdk.paged_decode_attention.launches
    via = tdk.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(nv))
    np.testing.assert_array_equal(via.numpy(), got)
    assert tdk.paged_decode_attention.launches == before


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_paged_ref_reads_recycled_pages(shape):
    """A page freed by one sequence and reallocated to another reads the
    NEW contents: the plain version, like the kernel, keeps no residue."""
    H, D, ps, P, W, _ = SHAPES[shape]
    rng = np.random.RandomState(1)
    alloc = PageAllocator(P, ps)
    first = alloc.alloc(P - 1)  # the whole pool
    kp = rng.randn(P, ps, H, D).astype(np.float32)
    vp = rng.randn(P, ps, H, D).astype(np.float32)
    alloc.free(first)
    pages = alloc.alloc(3)  # FIFO recycling hands back the freed pages
    assert set(pages) <= set(first)
    for pg in pages:  # what prefill writes into reused pages
        kp[pg] = rng.randn(ps, H, D)
        vp[pg] = rng.randn(ps, H, D)
    table = np.array([alloc.table_row(pages, W)], np.int32)
    nv = np.array([3 * ps - 2], np.int32)
    q = rng.randn(1, H, D).astype(np.float32)
    want = np.asarray(jpk.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(nv)))
    got = tdk.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                         _t(nv)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the kernel's split walk reads the new contents too
    for keys in SPLIT_KEYS:
        split = tdk.paged_decode_attention_split_ref(
            _t(q), _t(kp), _t(vp), _t(table), _t(nv), keys).numpy()
        np.testing.assert_allclose(split, want, **TOL)


# splits of the plain split walk: the kernel's and others, 24 ending
# inside a page; D 8, 64 and 256 (the kernels' largest); a table of 5
# pages of 8 (40 keys, a multiple of no split) with the ragged n_valid of
# `_ragged_case`: a dead slot and one at the full table among them
SPLIT_KEYS = (16, 24, 64)
SPLIT_HEADS = {8: 4, 64: 2, 256: 2}  # head dim -> heads


@functools.lru_cache(maxsize=None)
def _jax_paged_split_case(D):
    case = _ragged_case(np.random.RandomState(D), SPLIT_HEADS[D], D, 8, 12,
                        5, 8)
    return case, np.asarray(jpk.paged_decode_attention(
        *(jnp.asarray(a) for a in case)))


@pytest.mark.parametrize("D", sorted(SPLIT_HEADS))
@pytest.mark.parametrize("keys", SPLIT_KEYS)
def test_paged_split_ref_matches_jax(keys, D):
    (q, kp, vp, table, nv), want = _jax_paged_split_case(D)
    assert nv.max() == table.shape[1] * 8 and not nv.min()
    got = tdk.paged_decode_attention_split_ref(_t(q), _t(kp), _t(vp),
                                               _t(table), _t(nv),
                                               keys).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(np.isfinite(got)) and not got[nv == 0].any()


@functools.lru_cache(maxsize=None)
def _jax_flash_split_case(D):
    """B 4 over a cache of T 40 (one JAX block, a multiple of no split):
    one live position, all of them, a dead sequence and 17."""
    rng = np.random.RandomState(100 + D)
    H, T = SPLIT_HEADS[D], 40
    q = rng.randn(4, H, D).astype(np.float32)
    k = rng.randn(4, T, H, D).astype(np.float32)
    v = rng.randn(4, T, H, D).astype(np.float32)
    nv = np.array([1, T, 0, 17], np.int32)
    return (q, k, v, nv), np.asarray(jpk.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(nv)))


@pytest.mark.parametrize("D", sorted(SPLIT_HEADS))
@pytest.mark.parametrize("keys", SPLIT_KEYS)
def test_flash_split_ref_matches_jax(keys, D):
    (q, k, v, nv), want = _jax_flash_split_case(D)
    got = tdk.flash_decode_split_ref(_t(q), _t(k), _t(v), _t(nv),
                                     keys).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the dead sequence gives zeros, as the JAX kernel gives
    assert np.all(np.isfinite(got)) and not got[nv == 0].any()
    np.testing.assert_allclose(
        tdk.flash_decode_ref(_t(q), _t(k), _t(v), _t(nv)).numpy(), want,
        **TOL)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("per_seq", [False, True], ids=["scalar", "vector"])
def test_flash_ref_matches_jax(shape, per_seq):
    H, D, _, _, _, B = SHAPES[shape]
    T = 256 if shape == "full" else 32
    rng = np.random.RandomState(2)
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, T, H, D).astype(np.float32)
    v = rng.randn(B, T, H, D).astype(np.float32)
    if per_seq:
        nv = rng.randint(1, T + 1, size=B).astype(np.int32)
        nv[0], nv[-1] = 1, T
        jnv, tnv = jnp.asarray(nv), _t(nv)
    else:
        jnv = tnv = T // 2 + 3
    want = np.asarray(jpk.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnv))
    got = tdk.flash_decode_ref(_t(q), _t(k), _t(v), tnv).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    before = tdk.flash_decode.launches
    via = tdk.flash_decode(_t(q), _t(k), _t(v), tnv).numpy()
    np.testing.assert_array_equal(via, got)
    assert tdk.flash_decode.launches == before


def test_dense_decode_matches_jax_and_keeps_dtype():
    rng = np.random.RandomState(3)
    B, T, H, D = 3, 24, 2, 8
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, T, H, D).astype(np.float32)
    v = rng.randn(B, T, H, D).astype(np.float32)
    nv = np.array([3, 24, 11], np.int32)
    want = np.asarray(jpk.dense_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(nv)))
    got = tdk.dense_decode_attention(_t(q), _t(k), _t(v), _t(nv))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # bfloat16 caches: float32 math, the result in q's dtype
    half = tdk.dense_decode_attention(_t(q).bfloat16(), _t(k).bfloat16(),
                                      _t(v).bfloat16(), _t(nv))
    assert half.dtype == torch.bfloat16
    np.testing.assert_allclose(half.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.zeros((1, 2, 8), device="meta")
    k = torch.zeros((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tdk.flash_decode(q, k, k, 1)
    with pytest.raises(ValueError, match="no kernel"):
        tdk.paged_decode_attention(q, k, k, torch.zeros((1, 1)), 1)
