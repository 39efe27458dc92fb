"""Fused BN -> ReLU (-> add) epilogue of the PyTorch port against the JAX
package's Pallas kernels (CPU).

The port's wrappers run their plain versions on CPU tensors; the JAX
`bn_act_epilogue` runs its Pallas kernels in interpret mode, with a
ragged row grid where the JAX tests use one (75 rows, block_rows 7).
Tolerances are those of `tests/test_memory_traffic.py`: forward atol
1e-6, gradients atol 1e-4, bfloat16 I/O atol 2e-2; float16 I/O rtol
1e-3 forward (one float16 rounding) and 2e-2 for the gradients.
"""
import numpy as np

import jax
import jax.numpy as jnp
import pytest
import torch

from incubator_mxnet_tpu.ops.pallas_kernels import bn_act_epilogue as jax_epi
from incubator_mxnet_tpu_torch.ops.kernels import epilogue as ep


def _case(shape, seed, residual):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    c = shape[-1]
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    shift = rng.randn(c).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32) if residual else None
    return x, scale, shift, res


def _t(a, dtype=torch.float32, grad=False):
    if a is None:
        return None
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


@pytest.mark.parametrize("residual", [False, True],
                         ids=["plain", "residual"])
@pytest.mark.parametrize("shape,block_rows", [((6, 5, 8), 256),
                                              ((75, 4), 7)],
                         ids=["nhwc", "ragged"])
def test_forward_matches_jax(shape, block_rows, residual):
    x, scale, shift, res = _case(shape, 0, residual)
    want = jax_epi(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift),
                   residual=None if res is None else jnp.asarray(res),
                   block_rows=block_rows, interpret=True)
    got = ep.bn_act_epilogue(_t(x), _t(scale), _t(shift), _t(res))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("residual", [False, True],
                         ids=["plain", "residual"])
def test_gradients_match_jax(residual):
    """d/d(x, scale, shift, residual) of sum(y ** 2) on the ragged grid."""
    x, scale, shift, res = _case((75, 4), 2, residual)
    args = [jnp.asarray(a) for a in (x, scale, shift)]

    def f(x, s, b, *r):
        y = jax_epi(x, s, b, residual=r[0] if r else None, block_rows=7,
                    interpret=True)
        return jnp.sum(y ** 2)

    jargs = args + ([jnp.asarray(res)] if residual else [])
    want = jax.grad(f, argnums=tuple(range(len(jargs))))(*jargs)
    targs = [_t(a, grad=True) for a in (x, scale, shift)]
    if residual:
        targs.append(_t(res, grad=True))
    y = ep.bn_act_epilogue(*targs[:3], targs[3] if residual else None)
    (y ** 2).sum().backward()
    for name, t, w in zip(("dx", "dscale", "dshift", "dres"), targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_bfloat16_io():
    x, scale, shift, res = _case((16, 8), 3, True)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    rb = jnp.asarray(res).astype(jnp.bfloat16)
    want = jax_epi(xb, jnp.asarray(scale), jnp.asarray(shift), residual=rb,
                   interpret=True)
    got = ep.bn_act_epilogue(_t(x, torch.bfloat16), _t(scale), _t(shift),
                             _t(res, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2e-2)
    # the backward keeps dx / dres in the activation's dtype, the channel
    # sums in float32
    y = got
    dy = torch.ones_like(y)
    dx, dscale, dshift, dres = ep.bn_act_epilogue_bwd(
        _t(x, torch.bfloat16), _t(scale), y, dy, with_residual=True)
    assert dx.dtype == dres.dtype == torch.bfloat16
    assert dscale.dtype == dshift.dtype == torch.float32
    live = (y.float() > 0).float()
    np.testing.assert_allclose(dshift.numpy(), live.sum(0).numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("residual", [False, True],
                         ids=["plain", "residual"])
def test_float16_matches_jax(residual):
    """float16 activations (what amp.convert_block(net, "float16") makes):
    the plain versions against JAX's kernels in interpret mode, y in
    float16 at rtol 1e-3 (one float16 rounding of the float32 result),
    the gradients of sum(y ** 2) at the bfloat16 tolerance 2e-2, dx and
    dres in float16, dscale and dshift in float32."""
    x, scale, shift, res = _case((75, 8), 6, residual)
    f16 = [None if a is None else jnp.asarray(a).astype(jnp.float16)
           for a in (x, res)]

    def f(x, s, b, *r):
        y = jax_epi(x, s, b, residual=r[0] if r else None, block_rows=7,
                    interpret=True)
        return jnp.sum(y.astype(jnp.float32) ** 2), y

    jargs = [f16[0], jnp.asarray(scale), jnp.asarray(shift)] + \
        ([f16[1]] if residual else [])
    want, jy = jax.grad(f, argnums=tuple(range(len(jargs))),
                        has_aux=True)(*jargs)
    assert jy.dtype == jnp.float16
    targs = [_t(x, torch.float16, True), _t(scale, grad=True),
             _t(shift, grad=True)]
    if residual:
        targs.append(_t(res, torch.float16, True))
    y = ep.bn_act_epilogue(*targs[:3], targs[3] if residual else None)
    assert y.dtype == torch.float16
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(jy, np.float32), rtol=1e-3,
                               atol=0)
    (y.float() ** 2).sum().backward()
    for name, t, w in zip(("dx", "dscale", "dshift", "dres"), targs, want):
        assert t.grad.dtype == t.dtype, name
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w, np.float32), rtol=2e-2,
                                   atol=2e-2, err_msg=name)


def test_dead_elements_keep_nan_out_of_the_sums():
    """A NaN in x where the mask is off must not reach dscale (the JAX
    kernel masks x as well as dy for its padded tail)."""
    x, scale, _, _ = _case((12, 4), 4, False)
    x[3, 1] = np.nan
    y = np.ones_like(x)
    y[3, 1] = 0.0
    dx, dscale, dshift = ep.bn_act_epilogue_bwd(
        _t(x), _t(scale), _t(y), torch.ones(12, 4))
    assert torch.isfinite(dscale).all() and torch.isfinite(dx).all()
    assert float(dshift[1]) == 11.0


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    x, scale, shift, res = _case((9, 4), 5, True)
    before = (ep.bn_act_epilogue_fwd.launches,
              ep.bn_act_epilogue_bwd.launches)
    y = ep.bn_act_epilogue_fwd(_t(x), _t(scale), _t(shift), _t(res))
    torch.testing.assert_close(y, ep.bn_act_epilogue_fwd_ref(
        _t(x), _t(scale), _t(shift), _t(res)), rtol=0, atol=0)
    ep.bn_act_epilogue_bwd(_t(x), _t(scale), y, torch.ones_like(y), True)
    assert (ep.bn_act_epilogue_fwd.launches,
            ep.bn_act_epilogue_bwd.launches) == before


def test_other_devices_raise():
    x = torch.zeros((4, 4), device="meta")
    s = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ep.bn_act_epilogue_fwd(x, s, s)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ep.bn_act_epilogue_bwd(x, s, x, x)
