"""The port's SGD update against the JAX package's `SGD.fused_update`, on
one seeded update of 4096 values (lr 0.05, momentum 0.9, wd 1e-4,
rescale_grad 1/128), followed by JAX's cast back to the stored dtypes
(`w.astype(d.dtype)`, `_cast_state_like`), with momentum, without it and
with clip_gradient 0.05.

bfloat16 weights: the port holds the program `jax.jit` compiles, which is
what the JAX train step runs: 0 weights and 0 momenta may differ. (Run op
by op, JAX rounds every bfloat16 intermediate; the compiled program keeps
the sum g + wd * w, the momentum's decay and the new weight in float32,
which the port reproduces.)

float32 weights: bit-equal to the update run op by op. XLA's CPU code
for the compiled program contracts multiply-adds into fused
multiply-adds, which PyTorch's separate operations do not; against it
the weights and momenta differ by at most one float32 ulp of their
array's largest magnitude (measured: 12-41 of 4096 weights by up to
1.2e-7, 0-1168 momenta by up to 3.7e-9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.optimizer import _cast_state_like
import incubator_mxnet_tpu_torch as tmx

N = 4096


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: beside the suite's other workers torch's thread
    pool makes these small ops many times slower and takes their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LR = 0.05
CASES = {"momentum": dict(momentum=0.9),
         "no_momentum": dict(momentum=0.0),
         "clip": dict(momentum=0.9, clip_gradient=0.05)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _values():
    rng = np.random.RandomState(0)
    w = rng.randn(N).astype(np.float32)
    g = (4.0 * rng.randn(N)).astype(np.float32)
    m = (0.01 * rng.randn(N)).astype(np.float32)
    return w, g, m


def _kw(case):
    return dict(learning_rate=LR, wd=1e-4, rescale_grad=1.0 / 128,
                **CASES[case])


def _jax_update(case, jdt, jit):
    opt = mx.optimizer.SGD(**_kw(case))
    has_mom = CASES[case]["momentum"] != 0.0

    def update(w, g, m, lr):
        new_w, new_m = opt.fused_update("w", w, g, m if has_mom else None, lr)
        return (new_w.astype(w.dtype),
                _cast_state_like(new_m, m) if has_mom else m)

    w, g, m = (jnp.asarray(a).astype(jdt) for a in _values())
    fn = jax.jit(update) if jit else update
    new_w, new_m = fn(w, g, m, jnp.asarray(LR, jnp.float32))
    return (np.asarray(new_w.astype(jnp.float32)),
            np.asarray(new_m.astype(jnp.float32)))


def _port_update(case, tdt, lr=LR):
    opt = tmx.optimizer.SGD(**_kw(case))
    w, g, m = (torch.from_numpy(a).to(tdt) for a in _values())
    state = m if CASES[case]["momentum"] != 0.0 else None
    opt.fused_update("w", w, g, state, lr)
    return w.float().numpy(), m.float().numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_bfloat16_update_equals_the_compiled_jax_update(case):
    want_w, want_m = _jax_update(case, jnp.bfloat16, jit=True)
    got_w, got_m = _port_update(case, torch.bfloat16)
    assert int((got_w != want_w).sum()) == 0
    assert int((got_m != want_m).sum()) == 0


@pytest.mark.parametrize("case", list(CASES))
def test_float32_update_is_bit_equal_to_jax(case):
    want_w, want_m = _jax_update(case, jnp.float32, jit=False)
    got_w, got_m = _port_update(case, torch.float32)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_m, want_m)
    # the compiled program differs by its fused multiply-adds only
    jit_w, jit_m = _jax_update(case, jnp.float32, jit=True)
    for got, want in ((got_w, jit_w), (got_m, jit_m)):
        assert np.abs(got - want).max() <= np.spacing(np.abs(want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lr_as_a_float32_tensor_equals_lr_as_a_float(dtype):
    """A CUDA graph hands the scheduled rate in as a 0-d float32 tensor."""
    tdt = DTYPES[dtype][1]
    by_float = _port_update("momentum", tdt, lr=LR)
    by_tensor = _port_update("momentum", tdt,
                             lr=torch.tensor(LR, dtype=torch.float32))
    for a, b in zip(by_float, by_tensor):
        np.testing.assert_array_equal(a, b)


def test_the_update_keeps_the_weight_and_momentum_objects_and_dtypes():
    opt = tmx.optimizer.SGD(**_kw("momentum"))
    w, g, m = (torch.from_numpy(a).bfloat16() for a in _values())
    w0, m0 = w, m
    opt.fused_update("w", w, g, m, LR)
    assert w is w0 and m is m0
    assert w.dtype == m.dtype == torch.bfloat16
    assert float(m.abs().max()) > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_a_batched_update_equals_one_update_per_parameter(dtype, case):
    """`fused_updates` over many parameters (groups split by lr_mult, wd_mult and
    dtype, as the train step calls it) gives each parameter the bits of
    its own `fused_update`."""
    tdt = DTYPES[dtype][1]
    w, g, m = _values()
    shapes = [(4, 8, 3, 3), (64,), (16, 16), (1000,), (2488,)]
    cuts = np.cumsum([int(np.prod(s)) for s in shapes])[:-1]

    def pieces(a, dt):
        return [torch.from_numpy(p.copy()).to(dt).reshape(s)
                for p, s in zip(np.split(a, cuts), shapes)]

    names = [f"p{i}" for i in range(len(shapes))]
    has_mom = CASES[case]["momentum"] != 0.0
    results = []
    for batched in (False, True):
        opt = tmx.optimizer.SGD(**_kw(case))
        opt.lr_mult = {"p1": 0.5}
        opt.wd_mult = {"p2": 0.0}
        dts = [tdt, tdt, tdt, torch.float32, tdt]
        ws = [p.to(dt) for p, dt in zip(pieces(w, torch.float32), dts)]
        gs = [p.to(dt) for p, dt in zip(pieces(g, torch.float32), dts)]
        ms = [p.to(dt) if has_mom else None
              for p, dt in zip(pieces(m, torch.float32), dts)]
        lr = torch.tensor(LR, dtype=torch.float32)
        if batched:
            opt.fused_updates(names, ws, gs, ms, lr)
        else:
            for args in zip(names, ws, gs, ms):
                opt.fused_update(*args, lr)
        results.append(ws + [s for s in ms if s is not None])
    for a, b in zip(*results):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
