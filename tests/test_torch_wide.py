"""Wide paged decode of the PyTorch port against the JAX package (CPU).

`paged_decode_attention_wide_ref` (Q query rows per slot over the page
pool, causal among themselves) against the JAX Pallas kernel in interpret
mode, and the port's `decode_step_paged_wide` against the JAX version.
The CUDA kernel runs only on the card: `chip_smoke.py` holds it against
the plain version there.
"""
import functools

import numpy as np

import jax.numpy as jnp
import pytest
import torch

from incubator_mxnet_tpu.models import transformer as jtfm
from incubator_mxnet_tpu.ops import pallas_kernels as jpk
from incubator_mxnet_tpu_torch.models import transformer as ttfm
from incubator_mxnet_tpu_torch.ops.kernels import decode as tdk

# as tests/test_torch_decode.py: float32 softmax sums in another order
TOL = dict(rtol=2e-5, atol=2e-5)
# two float32 layers, as tests/test_torch_transformer.py
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# (heads, head_dim, page_size, pool pages, table width): the head shapes
# of tests/test_torch_decode.py
SHAPES = {"small": (2, 32, 8, 16, 4), "full": (8, 64, 16, 48, 32)}
SMALL = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _wide_case(rng, Q, H, D, ps, P, W):
    """Six slots: n_base 0, mid-page, page-aligned, the deepest rows past
    the table (some, then all of them: the walk clamp), and a dead slot
    with an all-zero table row."""
    cap = W * ps
    n_base = np.array([0, ps + ps // 2 + 1, 2 * ps, cap - 2, cap, 0],
                      np.int32)
    table = np.zeros((6, W), np.int32)
    for s in range(5):
        n = min(-(-(int(n_base[s]) + Q) // ps), W)
        table[s, :n] = rng.randint(1, P, n)
    q = rng.randn(6, Q, H, D).astype(np.float32)
    kp = rng.randn(P, ps, H, D).astype(np.float32)
    vp = rng.randn(P, ps, H, D).astype(np.float32)
    return q, kp, vp, table, n_base


@pytest.mark.parametrize("Q", [1, 5, 8])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_wide_ref_matches_jax(shape, Q):
    H, D, ps, P, W = SHAPES[shape]
    q, kp, vp, table, nb = _wide_case(np.random.RandomState(Q), Q, H, D, ps,
                                      P, W)
    want = np.asarray(jpk.paged_decode_attention_wide(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(nb)))
    got = tdk.paged_decode_attention_wide_ref(_t(q), _t(kp), _t(vp),
                                              _t(table), _t(nb)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert got.shape == q.shape and np.all(np.isfinite(got))
    # the wrapper takes the plain version for CPU tensors, without a launch
    before = tdk.paged_decode_attention_wide.launches
    via = tdk.paged_decode_attention_wide(_t(q), _t(kp), _t(vp), _t(table),
                                          _t(nb))
    np.testing.assert_array_equal(via.numpy(), got)
    assert tdk.paged_decode_attention_wide.launches == before


@functools.lru_cache(maxsize=None)
def _jax_wide(shape, Q):
    """The case of `_wide_case(RandomState(Q), Q, *SHAPES[shape])` and the
    JAX kernel's output on it (interpret mode), computed once per case."""
    case = _wide_case(np.random.RandomState(Q), Q, *SHAPES[shape])
    return case, np.asarray(jpk.paged_decode_attention_wide(
        *(jnp.asarray(a) for a in case)))


@pytest.mark.parametrize("keys", [16, 24, 64])
@pytest.mark.parametrize("Q", [1, 5, 8])
def test_wide_split_ref_matches_jax(Q, keys):
    """The plain split walk (partials of `keys`-key ranges merged by the
    log-sum-exp rule) against the JAX kernel at the serving head shape
    (page 16: a 24-key split ends inside a page), with n_base 0, rows past
    the table and the dead slot of `_wide_case`."""
    (q, kp, vp, table, nb), want = _jax_wide("full", Q)
    got = tdk.paged_decode_attention_wide_split_ref(
        _t(q), _t(kp), _t(vp), _t(table), _t(nb), keys).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert got.shape == q.shape and np.all(np.isfinite(got))


def test_wide_keys_per_split():
    """The split sizes the kernel is built with (decode.cu's
    wide_split_keys): 64 keys up to D 64, 4096 / D_p above; the wrapper
    sizes the partials' workspace by them."""
    assert [tdk.wide_keys_per_split(d) for d in (1, 16, 48, 64, 65, 128,
                                                 200, 256)] == [
        64, 64, 64, 64, 32, 32, 16, 16]
    for d in (0, 257):
        with pytest.raises(ValueError):
            tdk.wide_keys_per_split(d)


def test_wide_ref_with_one_row_is_paged_decode():
    """Q = 1 at n_base is single-query paged decode over n_base + 1
    keys."""
    H, D, ps, P, W = SHAPES["small"]
    q, kp, vp, table, nb = _wide_case(np.random.RandomState(9), 1, H, D, ps,
                                      P, W)
    live = nb < W * ps  # rows past the table have no single-query twin
    wide = tdk.paged_decode_attention_wide_ref(_t(q), _t(kp), _t(vp),
                                               _t(table), _t(nb))[:, 0]
    single = tdk.paged_decode_attention_ref(_t(q[:, 0]), _t(kp), _t(vp),
                                            _t(table), _t(nb + 1))
    np.testing.assert_allclose(wide.numpy()[live], single.numpy()[live],
                               **TOL)


def test_decode_step_paged_wide_matches_jax():
    """Four slots of five rows over a pool holding earlier K/V: a full
    chunk mid-sequence, a padded chunk (n_real < Q), speculative rows past
    cap, and a dead slot. Logits agree within 1e-4 (the dead slot reads
    the null page, whose contents both sides leave undefined), and every
    page but the null page agrees within 2e-5."""
    jcfg = jtfm.TransformerConfig(**SMALL)
    tcfg = ttfm.TransformerConfig(**SMALL)
    jp = jtfm.init_params(jcfg, seed=3)
    tp = ttfm.init_params(tcfg, seed=3, device="cpu")
    rng = np.random.RandomState(4)
    ps, P, W, Q = 8, 16, 8, 5
    shape = (2, P, ps, 2, 16)  # (L, P, page_size, H, Dh)
    kp = rng.randn(*shape).astype(np.float32)
    vp = rng.randn(*shape).astype(np.float32)
    tokens = rng.randint(1, 64, (4, Q)).astype(np.int32)
    start = np.array([6, 13, 62, 0], np.int32)
    n_real = np.array([5, 2, 5, 0], np.int32)
    table = np.zeros((4, W), np.int32)
    table[0, :2] = [3, 5]
    table[1, :3] = [7, 2, 9]
    table[2] = [1, 4, 6, 8, 10, 11, 12, 13]  # positions 64.. are past cap
    jl, jpaged = jtfm.decode_step_paged_wide(
        jp, {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
        jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(n_real),
        jnp.asarray(table), jcfg)
    tpaged = {"k": _t(kp.copy()), "v": _t(vp.copy())}
    tl, tpaged = ttfm.decode_step_paged_wide(
        tp, tpaged, _t(tokens), _t(start), _t(n_real), _t(table), tcfg)
    assert tuple(tl.shape) == (4, Q, 64)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3],
                               **LOGIT_TOL)
    assert np.all(np.isfinite(tl.numpy()))
    for key in ("k", "v"):
        np.testing.assert_allclose(tpaged[key].numpy()[:, 1:],
                                   np.asarray(jpaged[key])[:, 1:], **TOL)
    # the written rows really landed: slot 0's positions 6..10
    written = tpaged["k"].numpy()[:, [3, 3, 5, 5, 5], [6, 7, 0, 1, 2]]
    assert not np.allclose(written, kp[:, [3, 3, 5, 5, 5], [6, 7, 0, 1, 2]])
