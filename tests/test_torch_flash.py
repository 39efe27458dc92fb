"""Flash-attention parity of the PyTorch port with the JAX package (CPU).

The port's `flash_attention` (a `torch.autograd.Function` whose forward
and backward wrappers run their plain versions on CPU tensors) against the
JAX Pallas FlashAttention-2 kernels in interpret mode, as the JAX
package's own tests run them on the CPU. Outputs and gradients agree at
2e-4, the gradient tolerance of `tests/test_pallas.py`. The CUDA kernels
themselves run only on the card: `chip_smoke.py` holds them against the
plain versions there.
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


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_and_gradients_match_jax(causal):
    q, k, v, g = _qkvg(3, (2, 2, 64, 16))

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
