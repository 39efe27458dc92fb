"""Training parity of the PyTorch port with the JAX package (CPU).

`apply` with `use_flash` against the JAX `apply` with `use_flash` (its
Pallas flash kernels in interpret mode) at 1e-4, and the port's
`make_train_step` against the JAX `make_gspmd_train_step` on a one-device
('dp', 'ep', 'tp') mesh for three steps: losses at rtol 1e-5 and every
parameter at rtol 2e-4, atol 1e-5, the tolerances of
`tests/test_pallas.py`'s train-step tests. The JAX step donates its
params, so each step is given the params the one before returned.

The same three steps run with `use_fused_xent` and with four experts.
There the JAX step computes its fused loss inside `jax.shard_map`, where
interpret-mode `softmax_xent` takes its dense log-softmax form: the
oracle of the port's fused kernels (plain versions here) is JAX's dense
loss. The kernels themselves are held to the JAX Pallas kernels in
`tests/test_torch_xent.py`.
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


def _three_steps_match_jax(steps=3, **kw):
    """Returns the port's losses after holding them, and the parameters
    after `steps` steps, to the JAX step's; `kw` overrides SMALL."""
    jcfg = jtfm.TransformerConfig(**{**SMALL, **kw})
    tcfg = ttfm.TransformerConfig(**{**SMALL, **kw})
    mesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1, 1),
                axis_names=("dp", "ep", "tp"))
    jstep, jp = jtfm.make_gspmd_train_step(mesh, jcfg)
    tstep, tp = ttfm.make_train_step(tcfg, device="cpu")
    losses = []
    for i in range(steps):
        tok, tgt = _batch(i)
        jloss, jp = jstep(jp, tok, tgt)  # donates the jp it was given
        tloss, tp = tstep(tp, torch.from_numpy(tok), torch.from_numpy(tgt))
        assert tloss.dim() == 0 and not tloss.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        losses.append(float(tloss))
    want_params = {k: np.asarray(v) for k, v in jp.items()}
    assert sorted(tp) == sorted(want_params)
    for k, want in want_params.items():
        np.testing.assert_allclose(tp[k].detach().numpy(), want, rtol=2e-4,
                                   atol=1e-5, err_msg=k)
    return losses


def test_train_step_matches_jax_for_three_steps():
    _three_steps_match_jax()


@pytest.mark.parametrize("kw", [dict(use_fused_xent=True),
                                dict(n_experts=4, use_fused_xent=True),
                                dict(n_experts=4)],
                         ids=["fused_xent", "moe_fused_xent", "moe"])
def test_train_step_variants_match_jax_for_three_steps(kw):
    _three_steps_match_jax(**kw)


def test_train_step_at_head_dim_256_matches_jax():
    """One step with use_flash at head dim 256 (d_model 512 over 2 heads,
    as Gemma's heads): the JAX step runs its Pallas flash kernels at any
    head dim, and so does the port (plain versions here, the D_p 256
    kernels on the card)."""
    _three_steps_match_jax(steps=1, d_model=512, n_heads=2, n_layers=1)


def test_fused_xent_still_raises():
    """Named when the fused loss was not ported and raised; it now holds
    the fused step's first loss and updated parameters to the dense-loss
    step's (rtol 1e-5; rtol 2e-4, atol 1e-5) and its loss to float32."""
    tok, tgt = (torch.from_numpy(a) for a in _batch(0))
    out = {}
    for fused in (False, True):
        cfg = ttfm.TransformerConfig(**dict(SMALL, use_fused_xent=fused))
        step, params = ttfm.make_train_step(cfg, device="cpu")
        out[fused] = step(params, tok, tgt)
    assert out[True][0].dtype == torch.float32
    np.testing.assert_allclose(float(out[True][0]), float(out[False][0]),
                               rtol=1e-5)
    for k, w in out[False][1].items():
        np.testing.assert_allclose(out[True][1][k].detach().numpy(),
                                   w.detach().numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=k)
