"""Flash-attention parity of the PyTorch port with the JAX package (CPU).

The port's `flash_attention` (a `torch.autograd.Function` whose forward
and backward wrappers run their plain versions on CPU tensors) against the
JAX Pallas FlashAttention-2 kernels in interpret mode, as the JAX
package's own tests run them on the CPU. Outputs and gradients agree at
2e-4, the gradient tolerance of `tests/test_pallas.py`, at every head dim
of the repo's configurations, at 128, and at 160 and 256 above it (the
CPU route, like JAX, takes any head dim). The CUDA kernels themselves
run only on the card: `chip_smoke.py` holds them against the plain
versions there; here the CUDA route's head-dim rule (1 ... 256, padded
to 16, 32, 64, 128 or 256) and its in-place reading of strided operands
are checked.
"""
import numpy as np

import jax
import jax.numpy as jnp
import pytest
import torch

from incubator_mxnet_tpu.models import transformer as jtfm
from incubator_mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
from incubator_mxnet_tpu_torch.models import transformer as ttfm
from incubator_mxnet_tpu_torch.ops.kernels import flash as tfl

TOL = 2e-4  # tests/test_pallas.py: flash gradients against dense


def _qkvg(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


# head dims of the repo's configurations (4, 8, 12, 16; 6 has rows no
# 16-byte copy can stage) and 128; D 16 keeps the ids it had before other
# head dims were added. Above 128, at one batch row: D 160 (padded to 256
# on the card) and 256, the largest the CUDA kernels take (Gemma's)
HEAD_DIM_CASES = [pytest.param(D, causal, id=("" if D == 16 else f"D{D}-")
                               + ("causal" if causal else "full"))
                  for D in (4, 6, 8, 12, 16, 128) for causal in (False, True)]
HEAD_DIM_CASES += [pytest.param(160, False, id="D160-full"),
                   pytest.param(256, True, id="D256-causal")]


@pytest.mark.parametrize("D,causal", HEAD_DIM_CASES)
def test_flash_attention_and_gradients_match_jax(D, causal):
    q, k, v, g = _qkvg(3, (1 if D > 128 else 2, 2, 64, D))

    def jloss(q, k, v):
        o = jflash(q, k, v, causal=causal, block_q=16, block_k=16,
                   interpret=True)
        return (o * g).sum(), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = tfl.flash_attention(tq, tk, tv, causal=causal)
    tgrads = torch.autograd.grad((to * torch.from_numpy(g)).sum(),
                                 (tq, tk, tv))
    assert float(np.abs(to.detach().numpy() - np.asarray(jo)).max()) < TOL
    for name, t, j in zip("qkv", tgrads, jgrads):
        err = float(np.abs(t.numpy() - np.asarray(j)).max())
        assert err < TOL, (name, err)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_lse_is_the_logsumexp_of_the_scores(causal):
    q, k, v, _ = _qkvg(5, (2, 2, 64, 16))
    _, lse = tfl.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(16)
    if causal:
        s = np.where(np.tril(np.ones((64, 64), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 64)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


# the inputs of tests/test_pallas.py's remainder tests: T 40 causal (the
# JAX adapter pads it) and T 24 non-causal (the JAX adapter falls back to
# dense); the port runs its flash path at both
@pytest.mark.parametrize("shape,causal,seed", [
    ((2, 40, 2, 8), True, 0), ((1, 24, 2, 8), False, 1)],
    ids=["T40-causal", "T24-full"])
def test_ragged_adapter_matches_jax(shape, causal, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    want = jtfm._flash_attention_fn(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal, block=16)
    got = ttfm._flash_attention_fn(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    assert got.shape == shape
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < TOL


def test_backward_wrappers_are_the_plain_versions_on_cpu():
    q, k, v, do = (torch.from_numpy(a) for a in _qkvg(7, (1, 2, 32, 16)))
    o, lse = tfl.flash_attention_fwd(q, k, v, causal=True)
    before = (tfl.flash_attention_dq.launches,
              tfl.flash_attention_dkv.launches)
    got = tfl.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = tfl.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # CPU calls run no kernel, so they count no launch
    assert (tfl.flash_attention_dq.launches,
            tfl.flash_attention_dkv.launches) == before


@pytest.mark.parametrize("D", [1, 4, 6, 12, 17, 64, 100, 128])
def test_check_takes_every_head_dim_up_to_128(D):
    q = torch.zeros((1, 2, 8, D))
    assert tfl._check("flash_attention_dq", q, (q, q, q)) == q.shape


@pytest.mark.parametrize("D", [129, 160, 200, 256])
def test_check_takes_head_dims_up_to_256(D):
    q = torch.zeros((1, 2, 8, D))
    assert tfl._check("flash_attention_fwd", q, (q, q)) == q.shape


def test_check_refuses_head_dims_above_128():
    """Named when the CUDA route refused head dims above 128; it now holds
    the CUDA route's check to refusing 257, one above FLASH_MAX_HEAD_DIM
    (256), with a message that names the limit."""
    assert tfl.FLASH_MAX_HEAD_DIM == 256
    q = torch.zeros((1, 2, 8, tfl.FLASH_MAX_HEAD_DIM + 1))
    with pytest.raises(ValueError, match="outside the kernels' range 1 ... "
                                         "256"):
        tfl._check("flash_attention_fwd", q, (q, q))


@pytest.mark.parametrize("D", [256, 257])
def test_cpu_route_has_no_head_dim_limit(D):
    """The CPU route runs the plain versions at any head dim, as the JAX
    kernels take any: the forward against a float64 softmax at 1e-5."""
    q, k, v, _ = _qkvg(9, (1, 1, 16, D))
    got = tfl.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True).numpy()
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(D)
    s = np.where(np.tril(np.ones((16, 16), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_padded_head_dim_is_the_smallest_built_dim_at_or_above():
    assert [tfl.padded_head_dim(d) for d in (4, 12, 100)] == [16, 16, 128]
    assert [tfl.padded_head_dim(d) for d in (1, 16, 17, 32, 33, 64, 65,
                                             128, 129, 256)] == [
        16, 16, 32, 32, 64, 64, 128, 128, 256, 256]
    for d in (0, 257):
        with pytest.raises(ValueError):
            tfl.padded_head_dim(d)


def test_operand_reads_model_layout_in_place_at_any_head_dim():
    # (B, T, H, D) with D 6: row stride H * D = 24 elements, rows 24 bytes
    # apart from one another's 16-byte alignment; the kernels read it as is
    x = torch.randn(2, 5, 4, 6).transpose(1, 2)
    assert tfl._operand(x) is x
    # a view starting one element in: 4-byte aligned only, read in place
    y = x[..., 1:]
    assert tfl._operand(y) is y
    # an expanded gradient (D stride 0) is the one case copied
    e = torch.ones(()).expand(2, 4, 5, 6)
    got = tfl._operand(e)
    assert got is not e and got.stride(-1) == 1 and torch.equal(got, e)
