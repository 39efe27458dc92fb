"""Fused softmax cross-entropy of the PyTorch port against the JAX
package's Pallas kernels (CPU).

The port's `softmax_xent` (plain versions on the CPU, through its
`torch.autograd.Function`) against the JAX `softmax_xent(...,
interpret=True)` called directly, outside any shard_map, at the shapes of
`tests/test_pallas.py`: forward loss and lse at 1e-5, logits gradient at
rtol 1e-4 / atol 1e-5 (the tolerances there); bfloat16 logits give a
float32 loss at 1e-5 and bfloat16 gradients within 2e-2 of the largest
reference value; labels -1 and V match no column in both.
"""
import numpy as np

import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from incubator_mxnet_tpu.ops import pallas_kernels as pk
from incubator_mxnet_tpu_torch.ops.kernels import xent

# (logits shape, JAX block_b): tests/test_pallas.py's shapes
SHAPES = {"16x50": ((16, 50), 4), "8x33": ((8, 33), 8),
          "2x5x17": ((2, 5, 17), 8)}


def _case(shape, seed, scale=3.0, labels=None):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape) * scale).astype(np.float32)
    if labels is None:
        labels = rng.randint(0, shape[-1], shape[:-1]).astype(np.int32)
    weights = rng.rand(*shape[:-1]).astype(np.float32)  # a non-uniform dloss
    return logits, np.asarray(labels, np.int32), weights


def _jax(logits, labels, weights, block_b):
    def f(l):
        loss = pk.softmax_xent(l, jnp.asarray(labels), block_b=block_b,
                               interpret=True)
        return jnp.sum(loss * weights), loss

    (_, loss), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits))
    flat = jnp.asarray(logits).reshape(-1, logits.shape[-1])
    _, lse = pk._xent_fwd(flat, jnp.asarray(labels).reshape(-1),
                          min(block_b, flat.shape[0]), True, None)
    return np.asarray(loss), np.asarray(lse), np.asarray(g, np.float32)


def _torch(logits, labels, weights):
    t = torch.from_numpy(np.asarray(logits)).requires_grad_(True)
    loss = xent.softmax_xent(t, torch.from_numpy(labels))
    (loss * torch.from_numpy(weights)).sum().backward()
    _, lse = xent.softmax_xent_fwd(t.detach().reshape(-1, t.shape[-1]),
                                   torch.from_numpy(labels).reshape(-1))
    return loss, lse, t.grad


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_forward_and_gradient_match_jax(name):
    shape, block_b = SHAPES[name]
    logits, labels, w = _case(shape, seed=len(name))
    jloss, jlse, jgrad = _jax(logits, labels, w, block_b)
    loss, lse, grad = _torch(logits, labels, w)
    assert loss.dtype == torch.float32 and tuple(loss.shape) == shape[:-1]
    np.testing.assert_allclose(loss.detach().numpy(), jloss, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-4, atol=1e-5)


def test_labels_outside_the_vocabulary_match_the_jax_kernel():
    V = 33
    labels = np.array([-1, V, 0, V - 1, 5, -7, V + 4, 2], np.int32)
    logits, labels, w = _case((8, V), seed=4, labels=labels)
    jloss, jlse, jgrad = _jax(logits, labels, w, 8)
    loss, lse, grad = _torch(logits, labels, w)
    np.testing.assert_allclose(loss.detach().numpy(), jloss, rtol=1e-5,
                               atol=1e-5)
    out = (labels < 0) | (labels >= V)
    # no column matches: the loss is lse and the gradient has no one-hot
    np.testing.assert_allclose(loss.detach().numpy()[out], lse.numpy()[out],
                               rtol=0, atol=0)
    assert (grad.numpy()[out] >= 0).all()
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-4, atol=1e-5)


def test_bfloat16_logits():
    shape = (2, 5, 17)
    logits, labels, w = _case(shape, seed=2, scale=1.0)
    bf = logits.astype(ml_dtypes.bfloat16)
    jloss, _, jgrad = _jax(bf, labels, w, 8)
    t = torch.from_numpy(bf.astype(np.float32)).to(torch.bfloat16)
    t.requires_grad_(True)
    loss = xent.softmax_xent(t, torch.from_numpy(labels))
    (loss * torch.from_numpy(w)).sum().backward()
    assert loss.dtype == torch.float32 and t.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.detach().numpy(), jloss, rtol=1e-5,
                               atol=1e-5)
    err = np.abs(t.grad.float().numpy() - jgrad).max()
    assert err <= 2e-2 * np.abs(jgrad).max(), err


def test_plain_versions_against_log_softmax():
    """The plain forward and backward against the dense log-softmax loss
    and its autograd gradient, on a strided (non-contiguous) view."""
    rng = np.random.RandomState(7)
    wide = torch.from_numpy((rng.randn(6, 64) * 4).astype(np.float32))
    logits = wide[:, 3:53]  # row stride 64, V 50
    labels = torch.from_numpy(rng.randint(0, 50, 6).astype(np.int32))
    dloss = torch.from_numpy(rng.rand(6).astype(np.float32))
    loss, lse = xent.softmax_xent_fwd(logits, labels)
    ref = logits.clone().requires_grad_(True)
    logp = torch.log_softmax(ref, dim=-1)
    want = -logp[torch.arange(6), labels.long()]
    (want * dloss).sum().backward()
    np.testing.assert_allclose(loss.numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(logits, -1).numpy(),
                               rtol=1e-6, atol=1e-6)
    got = xent.softmax_xent_bwd(logits, labels, lse, dloss)
    np.testing.assert_allclose(got.numpy(), ref.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_cpu_tensors_take_the_plain_versions():
    logits = torch.randn(4, 9)
    labels = torch.tensor([0, 8, 3, 9])
    before = (xent.softmax_xent_fwd.launches, xent.softmax_xent_bwd.launches)
    logits.requires_grad_(True)
    xent.softmax_xent(logits, labels).sum().backward()
    assert (xent.softmax_xent_fwd.launches,
            xent.softmax_xent_bwd.launches) == before
    with pytest.raises(ValueError, match="no kernel or plain version"):
        xent.softmax_xent_fwd(torch.zeros(2, 3, device="meta"),
                              torch.zeros(2, dtype=torch.int32,
                                          device="meta"))
