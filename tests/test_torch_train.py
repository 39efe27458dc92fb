"""Training parity of the PyTorch port with the JAX package (CPU).

`apply` with `use_flash` against the JAX `apply` with `use_flash` (its
Pallas flash kernels in interpret mode) at 1e-4, and the port's
`make_train_step` against the JAX `make_gspmd_train_step` on a one-device
('dp', 'ep', 'tp') mesh for three steps: losses at rtol 1e-5 and every
parameter at rtol 2e-4, atol 1e-5, the tolerances of
`tests/test_pallas.py`'s train-step tests. The JAX step donates its
params, so each step is given the params the one before returned.
"""
import numpy as np

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from incubator_mxnet_tpu.models import transformer as jtfm
from incubator_mxnet_tpu_torch.models import transformer as ttfm

SMALL = dict(vocab=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_len=64, use_flash=True)
B, T = 2, 64


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, SMALL["vocab"], (B, T)).astype(np.int32),
            rng.randint(0, SMALL["vocab"], (B, T)).astype(np.int32))


def test_apply_with_flash_matches_jax():
    jcfg = jtfm.TransformerConfig(**SMALL)
    tcfg = ttfm.TransformerConfig(**SMALL)
    jp = jtfm.init_params(jcfg, seed=0)
    tp = ttfm.init_params(tcfg, seed=0, device="cpu")
    tok, _ = _batch(0)
    want, _ = jtfm.apply(jp, jnp.asarray(tok), jcfg)
    got, aux = ttfm.apply(tp, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    assert float(aux) == 0.0


def test_train_step_matches_jax_for_three_steps():
    jcfg = jtfm.TransformerConfig(**SMALL)
    tcfg = ttfm.TransformerConfig(**SMALL)
    mesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1, 1),
                axis_names=("dp", "ep", "tp"))
    jstep, jp = jtfm.make_gspmd_train_step(mesh, jcfg)
    tstep, tp = ttfm.make_train_step(tcfg, device="cpu")
    for i in range(3):
        tok, tgt = _batch(i)
        jloss, jp = jstep(jp, tok, tgt)  # donates the jp it was given
        tloss, tp = tstep(tp, torch.from_numpy(tok), torch.from_numpy(tgt))
        assert tloss.dim() == 0 and not tloss.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want_params = {k: np.asarray(v) for k, v in jp.items()}
    assert sorted(tp) == sorted(want_params)
    for k, want in want_params.items():
        np.testing.assert_allclose(tp[k].detach().numpy(), want, rtol=2e-4,
                                   atol=1e-5, err_msg=k)


def test_fused_xent_still_raises():
    cfg = ttfm.TransformerConfig(**dict(SMALL, use_fused_xent=True))
    step, params = ttfm.make_train_step(cfg, device="cpu")
    tok, tgt = _batch(0)
    with pytest.raises(NotImplementedError, match="softmax-xent"):
        step(params, torch.from_numpy(tok), torch.from_numpy(tgt))
