"""The port's NDArray and operator registry against the JAX package's.

One parametrised case per registry name (every op and alias of the
port's `ops/tensor.py`, `ops/nn.py` and `ops/random.py`): the same
seeded numpy inputs go through `nd.<name>` of both packages inside
`autograd.record()`, and the values are held at rtol 1e-5, atol 1e-6
(`tests/test_gluon.py:72,273`) and the inputs' gradients under a seeded
head gradient at rtol 1e-4, atol 1e-5 (`:173`). Sampling ops are held
by their moments. Then the NDArray surface (`tests/test_ndarray.py`'s
cases that apply), `nd.save` files across the packages both ways, and
the global random state.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_cases import (DETERMINISTIC, EXTRA, FAMILY, NO_GRAD, RANDOM,
                            _ALL_CASES, _diff, _heads, _key, _port,
                            _rows_signed, sample_moments)

RTOL, ATOL = 1e-5, 1e-6
GRTOL, GATOL = 1e-4, 1e-5
CPU = tmx.cpu()




def _close(got, want, rtol, atol, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=rtol,
                                   atol=atol, err_msg=what)


# -- the JAX side: every case's forward and vjp in one jitted program -------

def _jax_case(name, inputs, attrs, seed, grad, eager=False):
    """(fn(diff_inputs) -> (outs, grads), diff_inputs) of JAX's op: its
    registry function, with `_training` on and aux inputs stopped, as
    the JAX `nd.<name>` calls it inside record()."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from incubator_mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REG

    op = JAX_REG[name]
    ca = dict(op.attrs)
    ca.update(attrs)
    if op.needs_training:
        ca["_training"] = True
    if op.needs_rng:
        ca["_rng"] = jax.random.PRNGKey(0)
    arrs = [jnp.asarray(a) for a in inputs]
    fi = _diff(name, inputs)
    aux = [op.inputs.index(a) for a in op.aux]
    n = op.num_outputs(ca) if callable(op.num_outputs) else op.num_outputs

    def f(*d):
        full = list(arrs)
        for i, x in zip(fi, d):
            full[i] = x
        for ap in aux:
            full[ap] = lax.stop_gradient(full[ap])
        out = op.fn(*full, **ca)
        return out if isinstance(out, tuple) else (out,)

    diff = [np.asarray(inputs[i]) for i in fi]
    shapes = f(*diff) if eager else jax.eval_shape(f, *diff)
    floating = all(jnp.issubdtype(s.dtype, jnp.floating) for s in shapes)
    heads = _heads([(s.shape, s.dtype) for s in shapes[:n]], seed)

    def g(d):
        if not (grad and diff and floating):
            return f(*d), None
        outs, vjp = jax.vjp(f, *d)
        cts = tuple(heads) + tuple(jnp.zeros(s.shape, s.dtype)
                                   for s in shapes[n:])
        return outs, vjp(cts)

    return g, diff, n


_JAX = {}


def family_keys(family):
    """The case keys of one family of the registry (`FAMILY`): one per
    name of the family and each extra mode of its ops."""
    names = [n for n in DETERMINISTIC if FAMILY[n] == family]
    return ({_key(n) for n in names}
            | {f"extra:{k}" for k, (n, _) in enumerate(EXTRA)
               if FAMILY[n] == family})


def _jax_results(keys=None):
    """{key: (values, gradients, n primary outputs)} of the cases `keys`
    (by default the core family's), the jittable ones compiled as one
    program (one compile, not one per op and primitive); a
    data-dependent shape (boolean_mask) runs eagerly."""
    keys = family_keys("core") if keys is None else set(keys)
    if keys <= set(_JAX):
        return _JAX
    import jax

    fns, args, eager = {}, {}, {}
    for key, (name, case_fn, seed) in _ALL_CASES.items():
        if key not in keys or key in _JAX:
            continue
        inputs, attrs = case_fn(np.random.RandomState(seed))
        grad = OP_REGISTRY[name].name not in NO_GRAD
        eager_op = OP_REGISTRY[name].name == "boolean_mask"
        g, diff, n = _jax_case(name, inputs, attrs, seed + 1, grad,
                               eager_op)
        if eager_op:
            eager[key] = (g, diff, n)
        else:
            fns[key], args[key] = (g, n), diff
    out = jax.jit(lambda a: {k: fns[k][0](a[k]) for k in fns})(args)
    for k, (vals, grads) in out.items():
        _JAX[k] = (vals, grads, fns[k][1])
    for k, (g, diff, n) in eager.items():
        vals, grads = g(diff)
        _JAX[k] = (vals, grads, n)
    return _JAX


def _parity(key, name=None, family="core"):
    """The port's case `key` (of `family`, whose JAX cases compile
    together) against JAX's: values and the inputs after the call at
    RTOL / ATOL, gradients at GRTOL / GATOL."""
    case_name, case_fn, seed = _ALL_CASES[key]
    name = name or case_name
    inputs, attrs = case_fn(np.random.RandomState(seed))
    grad = OP_REGISTRY[name].name not in NO_GRAD
    jvals, jgrads, n = _jax_results(family_keys(family))[key]
    jvals = [np.asarray(v) for v in jvals]
    vals, grads, after = _port(name, inputs, attrs, seed + 1, grad)
    if OP_REGISTRY[name].name == "_linalg_syevd":
        vals[0], jvals[0] = _rows_signed(vals[0]), _rows_signed(jvals[0])
    # JAX's outputs past num_outputs are new aux values, or (box_encode)
    # outputs of an op registered with fewer
    n_vals = n if OP_REGISTRY[name].aux else len(jvals)
    _close(vals, jvals[:n_vals], RTOL, ATOL, f"{name} values")
    if jgrads is not None or grads is not None:
        _close(grads, [np.asarray(x) for x in jgrads], GRTOL, GATOL,
               f"{name} gradients")
    # inputs are untouched, but for aux state: the new moving stats
    want = [np.asarray(a) for a in inputs]
    op = OP_REGISTRY[name]
    for ap, new in zip([op.inputs.index(a) for a in op.aux], jvals[n:]):
        want[ap] = new
    _close(after, want, RTOL, ATOL, f"{name} inputs after the call")


def test_registry_covers_the_jax_ops():
    """Every name of JAX's registry (ops/tensor.py, ops/nn.py with RNN and
    the CTC loss, ops/random.py, ops/optimizer.py's 20 update ops,
    ops/vision.py, ops/contrib_ops.py and ops/quantized.py's 9 int8 ops)
    is registered in the port, with JAX's inputs, attributes and
    non-differentiated inputs (and, for the vision, contrib and quantized
    ops, its aux and optional inputs and output counts). No JAX op is
    missing: `list_ops()` is one set of 288 in both packages."""
    from incubator_mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REG
    from incubator_mxnet_tpu.ops.registry import list_ops as jax_ops
    from incubator_mxnet_tpu_torch.ops.registry import list_ops

    pre = "incubator_mxnet_tpu.ops."
    assert set(OP_REGISTRY) == set(JAX_REG)
    assert len(OP_REGISTRY) == 410
    assert set(list_ops()) == set(jax_ops()) and len(list_ops()) == 288
    for name in OP_REGISTRY:
        j, t = JAX_REG[name], OP_REGISTRY[name]
        assert (t.name, tuple(t.inputs), t.variadic) == \
            (j.name, tuple(j.inputs), j.variadic), name
        assert set(t.attrs) == set(j.attrs), name
        if j.fn.__module__ in (pre + "optimizer", pre + "vision",
                               pre + "contrib_ops", pre + "quantized"):
            assert set(t.no_grad_inputs) == set(j.no_grad_inputs), name
        if j.fn.__module__ in (pre + "vision", pre + "contrib_ops",
                               pre + "quantized"):
            assert (tuple(t.aux), tuple(t.optional), t.needs_training) == \
                (tuple(j.aux), tuple(j.optional), j.needs_training), name
            for attrs in ({}, {"output_score": True}):
                assert _n_outputs(t, attrs) == _n_outputs(j, attrs), name


def _n_outputs(op, attrs):
    n = op.num_outputs
    return n(attrs) if callable(n) else n


@pytest.mark.parametrize("name", [n for n in DETERMINISTIC
                                  if FAMILY[n] == "core"])
def test_op_matches_jax(name):
    assert _key(name) in _ALL_CASES, f"no case for {name}"
    _parity(_key(name), name)


@pytest.mark.parametrize("k", [k for k, (n, _) in enumerate(EXTRA)
                               if FAMILY[n] == "core"])
def test_op_mode_matches_jax(k):
    _parity(f"extra:{k}")




@pytest.mark.parametrize("name", RANDOM)
def test_sampling_op_moments_match_the_distribution(name):
    """Each sampler's draws (4000 per distribution): the mean within 6
    standard errors of the distribution's, the standard deviation within
    10 % of it, the distribution the JAX op draws from (its formula:
    gamma-Poisson mixtures for the negative binomials). `shuffle` gives
    a permutation of its input; `Dropout` in training mode zeroes a
    fraction p and scales the rest by 1 / (1 - p)."""
    sample_moments(name)


def test_random_state_repeats_every_draw():
    tmx.random.seed(7)
    assert tmx.random.get_state() == {"seed": 7, "counter": 0}
    tnd.random.uniform(shape=(3,), ctx=CPU)
    state = tmx.random.get_state()
    assert state == {"seed": 7, "counter": 1}
    a = [tnd.random.normal(shape=(4,), ctx=CPU).asnumpy() for _ in range(3)]
    tmx.random.seed(123)
    tmx.random.set_state(state)
    b = [tnd.random.normal(shape=(4,), ctx=CPU).asnumpy() for _ in range(3)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], a[1])
    # the initializers draw from it too, and no torch global generator
    torch.manual_seed(0)
    before = torch.get_rng_state()
    tmx.random.seed(0)
    w1 = tmx.gluon.nn.Dense(3, in_units=4)
    w1.initialize(tmx.init.Xavier(), ctx=CPU)
    tmx.random.seed(0)
    w2 = tmx.gluon.nn.Dense(3, in_units=4)
    w2.initialize(tmx.init.Xavier(), ctx=CPU)
    assert torch.equal(w1.weight.tensor(), w2.weight.tensor())
    assert torch.equal(torch.get_rng_state(), before)


# -- the NDArray surface (tests/test_ndarray.py) ---------------------------


def test_creation():
    with tmx.cpu():
        a = tnd.zeros((3, 4))
        assert a.shape == (3, 4) and a.asnumpy().sum() == 0
        assert tnd.ones((2, 2), dtype="float32").asnumpy().sum() == 4
        assert (tnd.full((2, 2), 7).asnumpy() == 7).all()
        d = tnd.array([[1, 2], [3, 4]])
        assert d.dtype == np.float32 and d.size == 4 and d.ndim == 2
        assert (tnd.arange(0, 10, 2).asnumpy() == np.arange(0, 10, 2)).all()
        assert (tnd.eye(3).asnumpy() == np.eye(3)).all()
        assert tnd.empty((2, 1)).shape == (2, 1)
        assert tnd.moveaxis(tnd.zeros((2, 3, 4)), 0, 2).shape == (3, 4, 2)
        assert tnd.stack_arrays(a, a, axis=1).shape == (3, 2, 4)


def test_arith_and_comparisons():
    xn = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    yn = np.array([[5.0, 6.0], [7.0, 8.0]], np.float32)
    with tmx.cpu():
        x, y = tnd.array(xn), tnd.array(yn)
        np.testing.assert_allclose((x + y).asnumpy(), xn + yn)
        np.testing.assert_allclose((x - y).asnumpy(), xn - yn)
        np.testing.assert_allclose((x * 2 + 1).asnumpy(), xn * 2 + 1)
        np.testing.assert_allclose((y / x).asnumpy(), yn / xn, rtol=1e-6)
        np.testing.assert_allclose((x ** 2).asnumpy(), xn ** 2)
        np.testing.assert_allclose((-x).asnumpy(), -xn)
        np.testing.assert_allclose((2 - x).asnumpy(), 2 - xn)
        np.testing.assert_allclose((2 / x).asnumpy(), 2 / xn, rtol=1e-6)
        np.testing.assert_allclose((x % 3).asnumpy(), xn % 3)
        np.testing.assert_allclose((x @ y).asnumpy(), xn @ yn)
        eq = x == tnd.array([[1.0, 0.0], [3.0, 0.0]])
        assert eq.dtype == np.float32
        np.testing.assert_array_equal(eq.asnumpy(), [[1, 0], [1, 0]])
        np.testing.assert_array_equal((x > 2).asnumpy(), [[0, 0], [1, 1]])
        assert (x != None) is True  # noqa: E711
        assert float(x[0, 0]) == 1.0 and int(x[1, 1]) == 4
        assert len(x) == 2 and [r.shape for r in x] == [(2,), (2,)]


def test_inplace_and_value_semantics():
    with tmx.cpu():
        x = tnd.ones((2, 2))
        x += 1
        assert (x.asnumpy() == 2).all()
        x *= 3
        assert (x.asnumpy() == 6).all()
        x /= 2
        assert (x.asnumpy() == 3).all()
        x -= 1
        assert (x.asnumpy() == 2).all()
        y = x.reshape(4)   # a copy, as the JAX package's arrays are
        y[0] = 9
        assert x.asnumpy()[0, 0] == 2
        z = x.copy()
        z += 1
        assert x.asnumpy()[0, 0] == 2
        w = x.astype("int32")
        assert w.dtype == np.int32


def test_indexing():
    with tmx.cpu():
        x = tnd.array(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
        assert x[0].shape == (3, 4)
        assert x[0, 1].shape == (4,)
        assert float(x[1, 2, 3].asscalar()) == 23
        assert x[:, 1:3].shape == (2, 2, 4)
        x[0] = 0
        assert x.asnumpy()[0].sum() == 0
        assert x[tnd.array([0, 1])].shape == (2, 3, 4)
        x[1, :, 1:3] = tnd.ones((3, 2))
        assert x.asnumpy()[1, :, 1:3].sum() == 6


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_methods_match_numpy():
    """The NDArray methods against numpy on the same input (the ops they
    dispatch are held to the JAX package above)."""
    xn = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    a = tnd.array(xn, ctx=CPU)
    cases = [
        (a.reshape(2, 6), xn.reshape(2, 6)),
        (a.reshape((4, -1)), xn.reshape(4, -1)),
        (a.reshape(shape=(0, 2, -1)), xn.reshape(3, 2, 2)),
        (a.T, xn.T), (a.transpose((1, 0)), xn.T),
        (a.swapaxes(0, 1), xn.T), (a.flatten(), xn),
        (a.expand_dims(1), xn[:, None]),
        (a.reshape(3, 1, 4).squeeze(1), xn),
        (a[:1].broadcast_to((3, 4)), np.broadcast_to(xn[:1], (3, 4))),
        (a.split(2, axis=1)[1], xn[:, 2:]),
        (a.slice((0, 1), (2, 3)), xn[0:2, 1:3]),
        (a.slice_axis(1, 1, 3), xn[:, 1:3]),
        (a.tile((1, 2)), np.tile(xn, (1, 2))),
        (a.repeat(2, axis=0), np.repeat(xn, 2, axis=0)),
        (a.flip(1), xn[:, ::-1]), (a.diag(), np.diag(xn)),
        (a.sum(), xn.sum()), (a.sum(axis=1, keepdims=True),
                              xn.sum(1, keepdims=True)),
        (a.mean(axis=0), xn.mean(0)), (a.max(axis=1), xn.max(1)),
        (a.min(), xn.min()), (a.abs().prod(), np.abs(xn).prod()),
        (a.norm(), np.linalg.norm(xn)),
        (a.argmax(axis=1), xn.argmax(1)), (a.argmin(axis=0), xn.argmin(0)),
        (a.argsort(axis=1), np.argsort(xn, 1)),
        (a.sort(axis=0, is_ascend=False), np.sort(xn, 0)[::-1]),
        (a.topk(axis=1, k=2, ret_typ="value"), -np.sort(-xn, 1)[:, :2]),
        (a.clip(-0.5, 0.5), np.clip(xn, -0.5, 0.5)),
        (a.sign(), np.sign(xn)), (a.abs().sqrt(), np.sqrt(np.abs(xn))),
        (a.square(), xn ** 2), (a.exp(), np.exp(xn)),
        (a.abs().log(), np.log(np.abs(xn))), (a.tanh(), np.tanh(xn)),
        (a.sigmoid(), 1 / (1 + np.exp(-xn))), (a.relu(), np.maximum(xn, 0)),
        (a.softmax(), _softmax(xn)),
        (a.log_softmax(), np.log(_softmax(xn))),
        ((a * 2).round(), np.round(xn * 2)), (a.floor(), np.floor(xn)),
        (a.ceil(), np.ceil(xn)), (a.dot(a, transpose_b=True), xn @ xn.T),
        (abs(a), np.abs(xn)), (a.take(tnd.array([2, 0], ctx=CPU)),
                               xn[[2, 0]]),
        (a.reshape_like(a.T), xn.reshape(4, 3)),
        (tnd.array([0, 2], ctx=CPU).one_hot(3), np.eye(3)[[0, 2]]),
        (a.broadcast_like(a), xn),
        (1.0 / (a.abs() + 1), 1 / (np.abs(xn) + 1)),
        (2 ** a, 2.0 ** xn), (3 % (a.abs() + 1), 3 % (np.abs(xn) + 1)),
        (a.astype("float16"), xn.astype(np.float16)),
        (a.as_in_context(CPU), xn), (a.copyto(CPU), xn),
        (a.detach(), xn),
    ]
    for k, (got, want) in enumerate(cases):
        np.testing.assert_allclose(got.asnumpy(), want, rtol=RTOL,
                                   atol=1e-6, err_msg=str(k))
    out = tnd.zeros((3, 4), ctx=CPU)
    a.copyto(out)
    np.testing.assert_array_equal(out.asnumpy(), xn)


def test_out_and_positional_attrs():
    with tmx.cpu():
        x = tnd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        out = tnd.zeros((2, 3))
        r = tnd.relu(x - 2, out=out)
        assert r is out
        np.testing.assert_array_equal(out.asnumpy(), np.maximum(
            np.arange(6).reshape(2, 3) - 2, 0))
        oh = tnd.one_hot(tnd.array([0, 2]), 3)  # depth positional
        np.testing.assert_array_equal(oh.asnumpy(), np.eye(3)[[0, 2]])
        with pytest.raises(TypeError):
            tnd.one_hot(tnd.array([0]), 3, depth=3)
        with pytest.raises(TypeError):
            tnd.relu(x, bogus=1)


def test_tensor_calls_answer_as_F():
    """Torch tensors go through the tensor-level F functions, not
    nd.<op>; F takes the device for `_rng` from a tensor passed by
    keyword as well as by position."""
    from incubator_mxnet_tpu_torch.ndarray import register

    x = torch.randn(2, 3)
    out = tnd.F.relu(x)
    assert torch.is_tensor(out)
    assert torch.equal(out, torch.relu(x))
    assert tnd.F.relu is OP_REGISTRY["relu"].fn
    with pytest.raises(TypeError, match="register.F"):
        tnd.relu(x)
    meta = torch.empty(2, device="meta")
    assert register._device_of((), {"data": meta}).type == "meta"
    assert register._device_of((x,), {"data": meta}).type == "cpu"
    with tag.train_mode():
        drop = tnd.F.Dropout(data=torch.ones(1000), p=0.5)
    assert drop.shape == (1000,) and 300 < int((drop == 0).sum()) < 700


def test_wait_and_sync():
    with tmx.cpu():
        x = tnd.ones((10, 10))
        y = tnd.dot(x, x)
        y.wait_to_read()
        tnd.waitall()
        assert y.asnumpy()[0, 0] == 10
        assert "NDArray 10x10 @cpu(0)" in repr(y)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_save_files_are_bit_identical_across_packages(direction, tmp_path):
    rng = np.random.RandomState(4)
    arrays = {"w": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32),
              "i": rng.randint(0, 9, (2, 2)).astype(np.int32),
              "d": rng.randn(2).astype(np.float64)}
    tpath, jpath = str(tmp_path / "port.nd"), str(tmp_path / "jax.nd")
    tnd.save(tpath, {k: tnd.array(v, ctx=CPU, dtype=v.dtype)
                     for k, v in arrays.items()})
    jnd.save(jpath, {k: jnd.array(v) for k, v in arrays.items()
                     if k != "d"} | {"d": arrays["d"]})
    if direction == "port_to_jax":
        loaded = jnd.load(tpath)
        # the JAX package holds no float64 (x64 off): it reads it as
        # float32
        want = dict(arrays, d=arrays["d"].astype(np.float32))
    else:
        loaded = tnd.load(jpath, ctx=CPU)
        want = arrays
    assert sorted(loaded) == sorted(arrays)
    for k, v in want.items():
        np.testing.assert_array_equal(loaded[k].asnumpy(), v)
        assert loaded[k].dtype == v.dtype
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    # lists, and the reference's .params format through legacy_io
    tnd.save(tpath, [tnd.array(arrays["w"], ctx=CPU)])
    assert len(jnd.load(tpath)) == 1
    from incubator_mxnet_tpu.ndarray import legacy_io as jleg
    blob = jleg.save_mxnet_params(None, {"arg:w": arrays["w"]})
    with open(jpath, "wb") as f:
        f.write(blob)
    with tmx.cpu():  # no ctx: the current context
        np.testing.assert_array_equal(tnd.load(jpath)["arg:w"].asnumpy(),
                                      arrays["w"])
    assert tnd.legacy_io.save_mxnet_params(
        None, {"arg:w": tnd.array(arrays["w"], ctx=CPU)}) == blob


def test_bfloat16_save_roundtrip(tmp_path):
    x = torch.randn(3, 5).to(torch.bfloat16)
    path = str(tmp_path / "bf16.nd")
    tnd.save(path, {"x": tnd.NDArray(x)})
    got = tnd.load(path, ctx=CPU)["x"]
    assert got.dtype == "bfloat16"
    assert torch.equal(got._data, x)
    blob = tnd.legacy_io.save_mxnet_params(None, {"x": tnd.NDArray(x)})
    assert torch.equal(
        tnd.legacy_io.load_mxnet_params(blob, ctx=CPU)["x"]._data, x)
    jmx.random.seed(0)  # the JAX package untouched by the port's draws
