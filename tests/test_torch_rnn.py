"""The port's recurrent surface against the JAX package (CPU): the fused
`RNN` op, the `RNN` / `LSTM` / `GRU` layers, every cell of `gluon.rnn`
and `gluon.contrib.rnn` through `unroll`, and the dropout of the op and
the cells by distribution.

The op is held by its registry function on both sides (all JAX cases in
one jitted program): outputs and the gradients in data, parameters and
states under seeded head gradients at rtol 1e-4, atol 1e-5
(`tests/test_gluon.py:173`). Layers and cells carry their weights from
the JAX package's nets by name (`gluon.utils.load_numpy_params`) and are
held as `tests/test_torch_imperative.py` holds layers: values at rtol
1e-5, atol 1e-6, gradients at rtol 1e-4, atol 1e-5. The dropout bits
differ from JAX's threefry, so dropout is held by its keep fraction and
scale; predict mode and p 0 are held by value.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import nn as tnn
from test_torch_imperative import _heads, _jax_block, _port_block

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6
GRTOL, GATOL = 1e-4, 1e-5
T, B, I, H = 5, 3, 4, 6
# XLA's CPU backend without its optimisation passes: the unrolled cells
# compile in a fraction of the time, and the arithmetic is the same ops
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# -- the RNN op ---------------------------------------------------------------

# (mode, layers, bidirectional, states given, state_outputs, clip)
OP_CASES = {
    f"{mode}-L{L}{'-bi' if bi else ''}{'-states' if st else ''}"
    f"{'-out' if so else ''}{'-clip' if clip else ''}":
    (mode, L, bi, st, so, clip)
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu")
    for (L, bi, st, so, clip) in ((1, False, True, True, False),
                                  (2, True, True, False, False),
                                  (2, False, False, False, False),
                                  (1, True, True, True, mode == "lstm"))
}


def _op_inputs(mode, L, bi, st, seed):
    D = 2 if bi else 1
    n = tnn.rnn_param_size(L, I, H, bi, mode)
    x = _np(seed, T, B, I)
    w = _np(seed + 1, n, scale=0.3)
    # a (L*D, 1, H) state broadcasts over the batch in the first case
    h0 = _np(seed + 2, L * D, 1 if L == 1 and not bi else B, H)
    c0 = _np(seed + 3, *h0.shape)
    if not st:
        h0, c0 = np.zeros_like(h0), np.zeros_like(c0)
    return [x, w, h0] + ([c0] if mode == "lstm" else [])


def _op_attrs(mode, L, bi, so, clip):
    attrs = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bi,
                 state_outputs=so)
    if clip:
        attrs.update(lstm_state_clip_min=-0.4, lstm_state_clip_max=0.5)
    return attrs


_JAX = {}


def _jax_op_results():
    """Every op case's outputs and input gradients from JAX's registry
    function, in one jitted program."""
    if _JAX:
        return _JAX
    import jax

    from incubator_mxnet_tpu.ops import nn as jnn

    fns, args = {}, {}
    for k, (key, (mode, L, bi, st, so, clip)) in enumerate(
            OP_CASES.items()):
        inputs = _op_inputs(mode, L, bi, st, 10 * k)
        attrs = _op_attrs(mode, L, bi, so, clip)

        def g(xs, attrs=attrs, seed=10 * k):
            def f(*d):
                out = jnn.rnn(*d, **attrs, _training=True,
                              _rng=jax.random.PRNGKey(0))
                return out if isinstance(out, tuple) else (out,)

            outs, pull = jax.vjp(f, *xs)
            heads = _heads([o.shape for o in outs], seed + 5)
            return outs, pull(tuple(heads))

        fns[key], args[key] = g, inputs
    out = jax.jit(lambda a: {k: fns[k](a[k]) for k in fns},
                  compiler_options=FAST_COMPILE)(args)
    for key, (outs, grads) in out.items():
        _JAX[key] = ([np.asarray(o) for o in outs],
                     [np.asarray(g) for g in grads])
    return _JAX


@pytest.mark.parametrize("key", sorted(OP_CASES))
def test_rnn_op_matches_jax(key):
    mode, L, bi, st, so, clip = OP_CASES[key]
    k = list(OP_CASES).index(key)
    inputs = _op_inputs(mode, L, bi, st, 10 * k)
    want_outs, want_grads = _jax_op_results()[key]
    arrays = [tmx.nd.array(a, ctx=CPU) for a in inputs]
    for a in arrays:
        a.attach_grad()
    with tmx.autograd.record():
        out = tmx.nd.RNN(*arrays, **_op_attrs(mode, L, bi, so, clip))
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    assert len(outs) == len(want_outs) == (
        1 if not so else (3 if mode == "lstm" else 2))
    for o, w in zip(outs, want_outs):
        np.testing.assert_allclose(o.asnumpy(), w, rtol=GRTOL, atol=GATOL)
    heads = _heads([o.shape for o in outs], 10 * k + 5)
    tmx.autograd.backward(outs, [tmx.nd.array(h, ctx=CPU) for h in heads])
    for a, w, what in zip(arrays, want_grads,
                          ("data", "params", "state", "state_cell")):
        np.testing.assert_allclose(a.grad.asnumpy(), w, rtol=GRTOL,
                                   atol=GATOL, err_msg=what)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_param_size_matches_jax(mode):
    from incubator_mxnet_tpu.ops import nn as jnn

    for L, inp, h, bi in ((1, 4, 6, False), (2, 7, 5, True),
                          (3, 650, 650, False)):
        assert tnn.rnn_param_size(L, inp, h, bi, mode) == \
            jnn.rnn_param_size(L, inp, h, bi, mode)


def test_rnn_op_projection_raises_as_jax():
    x, w, h0, c0 = (torch.from_numpy(a)
                    for a in _op_inputs("lstm", 1, False, True, 0))
    with pytest.raises(NotImplementedError, match="LSTMPCell"):
        tnn.rnn(x, w, h0, c0, state_size=H, projection_size=3)


def test_rnn_op_dropout_by_distribution():
    """Inter-layer dropout of a 2-layer rnn_relu whose second layer passes
    its input through (identity i2h, zero h2h and biases): the output is
    the first layer's output with a fraction p zeroed and the rest scaled
    by 1 / (1 - p), in training mode only; p 0 and predict mode are the
    plain output."""
    n, p = 4096, 0.3
    G = 1
    Wx0 = np.eye(H, dtype=np.float32)
    packed = np.concatenate([
        Wx0.ravel(), np.zeros(H * H, np.float32),            # layer 0
        np.eye(H, dtype=np.float32).ravel(),                  # layer 1
        np.zeros(H * H, np.float32),
        np.zeros(4 * G * H, np.float32)])                     # biases
    x = torch.from_numpy(np.abs(_np(0, 1, n, H)) + 0.5)
    h0 = torch.zeros(2, 1, H)
    kw = dict(state_size=H, num_layers=2, mode="rnn_relu")
    plain = tnn.rnn(x, torch.from_numpy(packed), h0, **kw)
    torch.testing.assert_close(plain, x, rtol=0, atol=0)
    gen = torch.Generator().manual_seed(0)
    out = tnn.rnn(x, torch.from_numpy(packed), h0, p=p, _rng=gen,
                  _training=True, **kw)
    zero = (out == 0).float().mean().item()
    se = np.sqrt(p * (1 - p) / out.numel())
    assert abs(zero - p) < 6 * se, zero
    kept = out != 0
    torch.testing.assert_close(out[kept], x[kept] / (1 - p))
    predict = tnn.rnn(x, torch.from_numpy(packed), h0, p=p, _rng=gen,
                      _training=False, **kw)
    torch.testing.assert_close(predict, x, rtol=0, atol=0)


# -- layers and cells through the JAX block harness ---------------------------

def _wrap_states(mx, make_layer):
    """A block calling `layer(x, [states...])`, returning the output and
    the new states as one list."""

    class Wrap(mx.gluon.Block):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.layer = make_layer(mx)

        def forward(self, x, *states):
            if not states:
                return self.layer(x)
            out, new = self.layer(x, list(states))
            return [out] + list(new)

    return Wrap()


def _unroll(mx, make_cell, length, layout, merge, with_vl=False):
    """A block running `cell.unroll` over its input (and begin states),
    returning the outputs and the final states as one list."""

    class Unroll(mx.gluon.Block):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.cell = make_cell(mx)

        def forward(self, x, *rest):
            vl = rest[-1] if with_vl else None
            states = list(rest[:-1] if with_vl else rest) or None
            outs, new = self.cell.unroll(length, x, begin_state=states,
                                         layout=layout,
                                         merge_outputs=merge,
                                         valid_length=vl)
            outs = [outs] if merge else list(outs)
            return outs + list(new)

    return Unroll()


X_TNC = _np(1, T, B, I)
X_NTC = _np(1, B, T, I)
TC = 3  # steps of the cells' unrolls (each step is traced out)
XC_NTC = _np(8, B, TC, I)
XC_TNC = _np(8, TC, B, I)
S_LSTM2 = [_np(2, 2, B, H), _np(3, 2, B, H)]
S_GRU_BI = [_np(4, 2, B, H)]

LAYERS = {
    "LSTM-TNC-deferred": (lambda mx: _wrap_states(
        mx, lambda m: m.gluon.rnn.LSTM(H, num_layers=2)),
        [X_TNC] + S_LSTM2),
    "LSTM-NTC-nostates": (lambda mx: _wrap_states(
        mx, lambda m: m.gluon.rnn.LSTM(H, layout="NTC")), [X_NTC]),
    "GRU-NTC-bi": (lambda mx: _wrap_states(
        mx, lambda m: m.gluon.rnn.GRU(H, layout="NTC", bidirectional=True)),
        [X_NTC] + S_GRU_BI),
    "RNN-relu-TNC": (lambda mx: _wrap_states(
        mx, lambda m: m.gluon.rnn.RNN(H, num_layers=2, input_size=I)),
        [X_TNC]),
    "RNN-tanh-NTC-bi": (lambda mx: _wrap_states(
        mx, lambda m: m.gluon.rnn.RNN(H, activation="tanh", layout="NTC",
                                      bidirectional=True)), [X_NTC]),
}


def _seq_cell(mx):
    cell = mx.gluon.rnn.SequentialRNNCell()
    with cell.name_scope():
        cell.add(mx.gluon.rnn.LSTMCell(H))
        cell.add(mx.gluon.rnn.DropoutCell(0.5))
        cell.add(mx.gluon.rnn.GRUCell(H))
    return cell


def _bi_cell(mx):
    return mx.gluon.rnn.BidirectionalCell(mx.gluon.rnn.LSTMCell(H),
                                          mx.gluon.rnn.GRUCell(H))


VL = np.array([3, 1, 0], np.float32)
CELLS = {
    "RNNCell": (lambda m: m.gluon.rnn.RNNCell(H), "NTC", False, [XC_NTC]),
    "RNNCell-relu-merge": (lambda m: m.gluon.rnn.RNNCell(
        H, activation="relu"), "TNC", True, [XC_TNC]),
    "LSTMCell-merge": (lambda m: m.gluon.rnn.LSTMCell(H), "NTC", True,
                       [XC_NTC]),
    "LSTMCell-states": (lambda m: m.gluon.rnn.LSTMCell(H), "TNC", False,
                        [XC_TNC, _np(5, B, H), _np(6, B, H)]),
    "GRUCell": (lambda m: m.gluon.rnn.GRUCell(H), "NTC", True, [XC_NTC]),
    "SequentialRNNCell(predict)": (_seq_cell, "NTC", True, [XC_NTC]),
    "ZoneoutCell(predict)": (lambda m: m.gluon.rnn.ZoneoutCell(
        m.gluon.rnn.LSTMCell(H), 0.3, 0.2), "NTC", True, [XC_NTC]),
    "ResidualCell": (lambda m: m.gluon.rnn.ResidualCell(
        m.gluon.rnn.GRUCell(I)), "NTC", True, [XC_NTC]),
    "BidirectionalCell": (_bi_cell, "NTC", True, [XC_NTC]),
    "VariationalDropoutCell(predict)": (
        lambda m: m.gluon.contrib.rnn.VariationalDropoutCell(
            m.gluon.rnn.LSTMCell(H), 0.3, 0.3, 0.3), "NTC", True, [XC_NTC]),
    "LSTMPCell": (lambda m: m.gluon.contrib.rnn.LSTMPCell(H, 3), "NTC",
                  True, [XC_NTC]),
}
_CONV_IN = {1: (2, 7), 2: (2, 5, 4), 3: (2, 3, 4, 3)}
for _d in (1, 2, 3):
    for _kind in ("RNN", "LSTM", "GRU"):
        _shape = _CONV_IN[_d]
        CELLS[f"Conv{_d}D{_kind}Cell"] = (
            lambda m, d=_d, kind=_kind, shape=_shape: getattr(
                m.gluon.contrib.rnn, f"Conv{d}D{kind}Cell")(
                    shape, 3, 3 if d < 3 else (1, 3, 1),
                    3 if d < 3 else (1, 3, 3), i2h_pad=1),
            "NTC", True, [_np(7, B, TC, *_shape)])

VL_CELLS = {
    "LSTMCell-valid_length": (lambda m: m.gluon.rnn.LSTMCell(H), "NTC",
                              False, [XC_NTC, VL]),
    "BidirectionalCell-valid_length": (_bi_cell, "NTC", True, [XC_NTC, VL]),
}

_BLOCK_CASES = {
    **{f"layer:{n}": (make, inputs, True)
       for n, (make, inputs) in LAYERS.items()},
    **{f"cell:{n}": (lambda mx, mk=mk, lay=lay, mg=mg:
                     _unroll(mx, mk, TC, lay, mg), inp,
                     "predict" not in n)
       for n, (mk, lay, mg, inp) in CELLS.items()},
    **{f"cell:{n}": (lambda mx, mk=mk, lay=lay, mg=mg:
                     _unroll(mx, mk, TC, lay, mg, with_vl=True), inp, True)
       for n, (mk, lay, mg, inp) in VL_CELLS.items()},
}

_JAX_BLOCKS = {}


def _jax_block_results():
    """Every layer and cell case's JAX result, compiled as one program."""
    if _JAX_BLOCKS:
        return _JAX_BLOCKS
    import jax

    # zeros before the seeded values: a JAX Xavier draw compiles per shape
    built = {key: _jax_block(make, inputs, train, init=jmx.init.Zero())
             for key, (make, inputs, train) in _BLOCK_CASES.items()}
    out = jax.jit(lambda a: {k: built[k][0](*a[k]) for k in built},
                  compiler_options=FAST_COMPILE)(
        {k: b[1] for k, b in built.items()})
    for k, (outs, aux, gp, gx) in out.items():
        _, _, weights, rel, _ = built[k]
        _JAX_BLOCKS[k] = ([np.asarray(o) for o in outs],
                          [np.asarray(x) for x in gx],
                          {n: np.asarray(v) for n, v in zip(rel, gp)},
                          weights)
    return _JAX_BLOCKS


def _block_parity(key):
    make, inputs, train = _BLOCK_CASES[key]
    outs, gx, gp, weights = _jax_block_results()[key]
    got = _port_block(make, inputs, weights, train)
    assert len(got[0]) == len(outs)
    for g, w in zip(got[0], outs):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert len(got[1]) == len(gx)
    for g, w in zip(got[1], gx):
        np.testing.assert_allclose(g, w, rtol=GRTOL, atol=GATOL)
    assert set(got[2]) == set(gp)
    for k in gp:
        np.testing.assert_allclose(got[2][k], gp[k], rtol=GRTOL,
                                   atol=GATOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    _block_parity(f"layer:{name}")


@pytest.mark.parametrize("name", sorted(CELLS) + sorted(VL_CELLS))
def test_cell_unroll_matches_jax(name):
    _block_parity(f"cell:{name}")


def test_layer_parameter_names_and_deferred_shapes_match_jax():
    """Per-layer parameters under JAX's names, in JAX's order, the first
    layer's input size resolved from the first input in both layouts (the
    JAX net's shapes resolved abstractly)."""
    import jax

    from incubator_mxnet_tpu.gluon.parameter import abstract_init_mode
    from incubator_mxnet_tpu.ndarray.ndarray import NDArray

    for layout, x in (("TNC", X_TNC), ("NTC", X_NTC)):
        nets = [mx.gluon.rnn.LSTM(H, num_layers=2, layout=layout,
                                  bidirectional=True) for mx in (jmx, tmx)]
        nets[0].initialize(jmx.init.Zero())
        with abstract_init_mode():
            jax.eval_shape(lambda d: nets[0](NDArray._from_data(d))._data,
                           jax.ShapeDtypeStruct(x.shape, np.float32))
        nets[1].initialize(device="cpu")
        nets[1](tmx.nd.array(x, ctx=CPU))
        got = [[(n[len(net.prefix):], tuple(p.shape))
                for n, p in net.collect_params().items()] for net in nets]
        assert got[0] == got[1]
        assert got[1][0] == ("l0_i2h_weight", (4 * H, I))
        assert len(got[1]) == 16


def test_begin_state_follows_the_parameters_and_the_input():
    layer = tmx.gluon.rnn.LSTM(H, num_layers=2)
    layer.initialize(device="cpu")
    layer.cast("float64")
    states = layer.begin_state(B)
    assert [s.shape for s in states] == [(2, B, H)] * 2
    assert all(s.dtype == np.float64 and s.context == CPU for s in states)
    cell = tmx.gluon.rnn.GRUCell(H)
    cell.initialize(device="cpu")
    x = torch.zeros(B, T, I, dtype=torch.float64)
    cell.cast("float64")
    outs, new = cell.unroll(T, x, merge_outputs=True)
    assert outs.dtype == torch.float64 and outs.shape == (B, T, H)
    assert new[0].device.type == "cpu"


def test_packed_parameters_get_their_gradients_inside_a_train_step():
    """`_pack_params` concatenates inside the recorded forward, so every
    per-layer parameter gets a gradient, also through
    `fused.GluonTrainStep`'s substituted parameters."""
    from incubator_mxnet_tpu_torch.fused import GluonTrainStep

    net = tmx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(tmx.gluon.rnn.LSTM(H, num_layers=2, layout="NTC"))
        net.add(tmx.gluon.nn.Dense(3, flatten=True))
    net.initialize(tmx.init.Xavier(), device="cpu")
    x = torch.from_numpy(X_NTC)
    y = torch.tensor([0.0, 2.0, 1.0])
    net(x)
    before = {n: p.tensor().detach().clone()
              for n, p in net.collect_params().items()}
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = GluonTrainStep(net, lambda n, a, b: loss_fn(n(a), b),
                          tmx.optimizer.SGD(learning_rate=0.5), device="cpu")
    loss = step(x, y)
    assert np.isfinite(float(loss.mean()))
    moved = [n for n, p in net.collect_params().items()
             if not torch.equal(p.tensor().detach(), before[n])]
    assert len(moved) == len(before)


def test_dropout_cell_by_distribution():
    p = 0.4
    cell = tmx.gluon.rnn.DropoutCell(p)
    x = tmx.nd.ones((2, 2048), ctx=CPU)
    with tmx.autograd.record():
        out, _ = cell(x, [])
    o = out.asnumpy()
    assert set(np.unique(o)) <= {0.0, np.float32(1 / (1 - p))}
    se = np.sqrt(p * (1 - p) / o.size)
    assert abs((o == 0).mean() - p) < 6 * se
    out, _ = cell(x, [])  # predict mode
    np.testing.assert_array_equal(out.asnumpy(), x.asnumpy())


def test_zoneout_cell_by_distribution():
    """In training mode an output keeps the previous step's value with
    probability zoneout_outputs (zeros before the first step)."""
    p = 0.3
    base = tmx.gluon.rnn.RNNCell(64)
    cell = tmx.gluon.rnn.ZoneoutCell(base, zoneout_outputs=p)
    cell.initialize(tmx.init.Xavier(), device="cpu")
    x = tmx.nd.array(_np(0, 64, 2, 8), ctx=CPU)
    with tmx.autograd.record():
        outs, _ = cell.unroll(2, x, layout="NTC")
    o = outs[0].asnumpy()
    share = (o == 0).mean()
    se = np.sqrt(p * (1 - p) / o.size)
    assert abs(share - p) < 6 * se, share


def test_variational_dropout_masks_repeat_over_time():
    p = 0.5
    cell = tmx.gluon.contrib.rnn.VariationalDropoutCell(
        tmx.gluon.rnn.RNNCell(256, activation="relu"), drop_outputs=p)
    cell.initialize(tmx.init.One(), device="cpu")
    x = tmx.nd.ones((4, 3, 2), ctx=CPU)
    with tmx.autograd.record():
        outs, _ = cell.unroll(3, x, layout="NTC")
    masks = [o.asnumpy() != 0 for o in outs]
    assert all((m == masks[0]).all() for m in masks[1:])
    share = 1 - masks[0].mean()
    se = np.sqrt(p * (1 - p) / masks[0].size)
    assert abs(share - p) < 6 * se, share
    kept = outs[0].asnumpy()[masks[0]]
    np.testing.assert_allclose(kept, kept.max(), rtol=1e-6)
