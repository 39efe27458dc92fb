"""The port's CTC loss against the JAX package (CPU): the `CTCLoss` op
(optax's forward recursion in JAX) and `gluon.loss.CTCLoss`, and the
train step of `examples/speech_ctc.py` (BiLSTM acoustic model, CTC loss,
Adam) against JAX's `GluonTrainStep`.

The op's loss and data gradient are held at rtol 1e-4, atol 1e-4
(`tests/test_operator.py:575`) for blank "first" and "last", with and
without data and label lengths, padding by 0 and -1, and a label longer
than its data (infeasible: optax's -1e5 floor keeps it finite); all
cases run in one jitted JAX program.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import nn as tnn
from test_torch_imperative import _jax_block, _port_block

CPU = tmx.cpu()
TOL = dict(rtol=1e-4, atol=1e-4)
T, B, C = 10, 4, 6


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# label rows: blank "first" labels are 1-based, padded with 0 (or -1)
LABEL_FIRST = np.array([[1, 2, 2, 0], [3, 5, 0, 0], [4, 4, 4, 4],
                        [2, -1, -1, -1]], np.float32)
LABEL_LAST = np.where(LABEL_FIRST <= 0, -1, LABEL_FIRST - 1)
DATA_LEN = np.array([10, 7, 10, 3], np.float32)
LABEL_LEN = np.array([3, 2, 4, 1], np.float32)
# row 2 needs 7 frames for [4, 4, 4, 4]; 5 make it infeasible
DATA_LEN_SHORT = np.array([10, 7, 5, 3], np.float32)

OP_CASES = {
    "first": ("first", False, False, DATA_LEN),
    "first-data_lengths": ("first", True, False, DATA_LEN),
    "first-label_lengths": ("first", False, True, DATA_LEN),
    "first-both": ("first", True, True, DATA_LEN),
    "first-infeasible": ("first", True, True, DATA_LEN_SHORT),
    "last": ("last", False, False, DATA_LEN),
    "last-both": ("last", True, True, DATA_LEN),
    "last-infeasible": ("last", True, False, DATA_LEN_SHORT),
}


def _op_args(key):
    blank, ud, ul, dlen = OP_CASES[key]
    data = _np(sorted(OP_CASES).index(key), T, B, C) * 2
    label = LABEL_FIRST if blank == "first" else LABEL_LAST
    attrs = dict(use_data_lengths=ud, use_label_lengths=ul,
                 blank_label=blank)
    return data, label, dlen, LABEL_LEN, attrs


_JAX = {}


def _jax_op_results():
    if _JAX:
        return _JAX
    import jax
    import jax.numpy as jnp

    from incubator_mxnet_tpu.ops import nn as jnn

    fns, args = {}, {}
    for key in OP_CASES:
        data, label, dlen, llen, attrs = _op_args(key)

        def g(d, label=label, dlen=dlen, llen=llen, attrs=attrs):
            loss, pull = jax.vjp(
                lambda x: jnn.ctc_loss(x, jnp.asarray(label),
                                       jnp.asarray(dlen), jnp.asarray(llen),
                                       **attrs), d)
            return loss, pull(jnp.ones_like(loss))[0]

        fns[key], args[key] = g, data
    out = jax.jit(lambda a: {k: fns[k](a[k]) for k in fns})(args)
    for key, (loss, grad) in out.items():
        _JAX[key] = (np.asarray(loss), np.asarray(grad))
    return _JAX


@pytest.mark.parametrize("key", sorted(OP_CASES))
def test_ctc_op_matches_jax(key):
    data, label, dlen, llen, attrs = _op_args(key)
    want_loss, want_grad = _jax_op_results()[key]
    arrays = [tmx.nd.array(a, ctx=CPU) for a in (data, label, dlen, llen)]
    arrays[0].attach_grad()
    with tmx.autograd.record():
        loss = tmx.nd.CTCLoss(*arrays, **attrs)
    loss.backward()
    np.testing.assert_allclose(loss.asnumpy(), want_loss, **TOL)
    np.testing.assert_allclose(arrays[0].grad.asnumpy(), want_grad, **TOL)
    assert np.isfinite(arrays[0].grad.asnumpy()).all()
    if "infeasible" in key:
        assert loss.asnumpy()[2] > 1e4  # the floor, not inf


def test_ctc_loss_alias_and_float64():
    """`ctc_loss` is the same op; a float64 call stays float64 and agrees
    with float32 on a feasible batch."""
    data, label, dlen, llen, attrs = _op_args("first-both")
    args = [torch.from_numpy(a) for a in (data, label, dlen, llen)]
    f32 = tnn.ctc_loss(*args, **attrs)
    f64 = tnn.ctc_loss(args[0].double(), *args[1:], **attrs)
    assert f64.dtype == torch.float64
    torch.testing.assert_close(f32.double(), f64, rtol=1e-5, atol=1e-5)
    assert tmx.nd.ctc_loss is not None
    out = tmx.nd.ctc_loss(*[tmx.nd.array(a, ctx=CPU) for a in
                            (data, label, dlen, llen)], **attrs)
    np.testing.assert_allclose(out.asnumpy(), f32.numpy(), rtol=0, atol=0)


# -- gluon.loss.CTCLoss -------------------------------------------------------

def _ctc_block(layout, label_layout, lengths):
    def make(mx):
        class Wrap(mx.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                with self.name_scope():
                    self.loss = mx.gluon.loss.CTCLoss(layout, label_layout)

            def hybrid_forward(self, F, pred, label, *lens):
                return self.loss(pred, label, *lens)

        return Wrap()

    pred = _np(3, T, B, C) if layout == "TNC" else _np(3, B, T, C)
    label = LABEL_FIRST.T.copy() if label_layout == "TN" else LABEL_FIRST
    inputs = [pred, label] + ([DATA_LEN, LABEL_LEN] if lengths else [])
    return make, inputs


LOSS_CASES = {
    "NTC-NT": _ctc_block("NTC", "NT", False),
    "TNC-TN-lengths": _ctc_block("TNC", "TN", True),
    "NTC-TN-lengths": _ctc_block("NTC", "TN", True),
}

_JAX_LOSS = {}


def _jax_loss_results():
    if _JAX_LOSS:
        return _JAX_LOSS
    import jax

    built = {k: _jax_block(make, inputs, True, init=jmx.init.Zero())
             for k, (make, inputs) in LOSS_CASES.items()}
    out = jax.jit(lambda a: {k: built[k][0](*a[k]) for k in built})(
        {k: b[1] for k, b in built.items()})
    for k, (outs, _, _, gx) in out.items():
        _JAX_LOSS[k] = ([np.asarray(o) for o in outs],
                        [np.asarray(x) for x in gx], built[k][2])
    return _JAX_LOSS


@pytest.mark.parametrize("key", sorted(LOSS_CASES))
def test_gluon_ctc_loss_matches_jax(key):
    make, inputs = LOSS_CASES[key]
    outs, gx, weights = _jax_loss_results()[key]
    got = _port_block(make, inputs, weights, True)
    for g, w in zip(got[0], outs):
        np.testing.assert_allclose(g, w, **TOL)
    assert len(got[1]) == len(gx)
    for g, w in zip(got[1], gx):
        np.testing.assert_allclose(g, w, **TOL)


# -- Adam and examples/speech_ctc.py's train step ------------------------------

def test_adam_update_matches_jax():
    """Three Adam steps (rescale, clip, weight decay) on seeded values
    against JAX's fused update, float32."""
    from incubator_mxnet_tpu import optimizer as jopt
    from incubator_mxnet_tpu_torch import optimizer as topt

    rng = np.random.RandomState(0)
    w0 = rng.randn(4096).astype(np.float32)
    grads = [4 * rng.randn(4096).astype(np.float32) for _ in range(3)]
    kw = dict(learning_rate=0.01, rescale_grad=0.5, clip_gradient=1.5,
              wd=1e-3)
    jo, to = jopt.Adam(**kw), topt.Adam(**kw)
    jw = jmx.nd.array(w0)._data
    js = (jw * 0, jw * 0)
    tw = torch.from_numpy(w0.copy())
    ts = to.create_state(0, tw)
    for t, g in enumerate(grads, 1):
        jw, js = jo.fused_update("w", jw, jmx.nd.array(g)._data, js, 0.01,
                                 t=float(t))
        to.fused_updates(["w"], [tw], [torch.from_numpy(g)], [ts],
                         torch.tensor(0.01), t=torch.tensor(float(t)))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


N_DIGITS, FEAT_DIM, HIDDEN = 9, 12, 16


def _acoustic(mx):
    """examples/speech_ctc.py's AcousticModel at hidden 16."""
    nn, rnn = mx.gluon.nn, mx.gluon.rnn

    class AcousticModel(mx.gluon.block.HybridBlock):
        def __init__(self, hidden, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.front = nn.Dense(hidden, activation="relu",
                                      flatten=False)
                self.lstm = rnn.LSTM(hidden, num_layers=1, layout="NTC",
                                     bidirectional=True)
                self.head = nn.Dense(N_DIGITS + 1, flatten=False)

        def hybrid_forward(self, F, x):
            return self.head(self.lstm(self.front(x)))

    return AcousticModel(HIDDEN)


def _speech_batches(steps, batch=8, tokens=3, frames=3):
    rng = np.random.RandomState(0)
    templates = np.vstack([np.zeros(FEAT_DIM)] + [
        rng.randn(FEAT_DIM) * 2 for _ in range(N_DIGITS)]).astype(np.float32)
    out = []
    for _ in range(steps):
        ys = rng.randint(1, N_DIGITS + 1, (batch, tokens))
        xs = templates[np.repeat(ys, frames, axis=1)] + 0.3 * rng.randn(
            batch, tokens * frames, FEAT_DIM)
        out.append((xs.astype(np.float32), ys.astype(np.float32)))
    return out


def test_speech_ctc_train_steps_match_jax():
    """Three steps of speech_ctc's train step (GluonTrainStep, CTCLoss,
    Adam with rescale_grad 1/B): losses at rtol 1e-5, weights after at
    rtol 2e-4, atol 1e-5 (the train tolerances), from the same weights."""
    import jax

    from incubator_mxnet_tpu import fused as jfused
    from incubator_mxnet_tpu.gluon.parameter import abstract_init_mode
    from incubator_mxnet_tpu.ndarray.ndarray import NDArray
    from incubator_mxnet_tpu_torch.fused import GluonTrainStep
    from incubator_mxnet_tpu_torch.gluon.utils import load_numpy_params

    batches = _speech_batches(3)
    jnet = _acoustic(jmx)
    jnet.initialize(jmx.init.Zero())
    with abstract_init_mode():
        jax.eval_shape(lambda d: jnet(NDArray._from_data(d))._data,
                       jax.ShapeDtypeStruct(batches[0][0].shape, np.float32))
    rng = np.random.RandomState(1)
    weights = {}
    for n, p in jnet.collect_params().items():
        weights[n] = (rng.uniform(-0.3, 0.3, p.shape)).astype(np.float32)
        p.set_data(jmx.nd.array(weights[n]))
    jloss = jmx.gluon.loss.CTCLoss(layout="NTC", label_layout="NT")
    jstep = jfused.GluonTrainStep(
        jnet, lambda n, x, y: jloss(n(x), y),
        jmx.optimizer.Adam(learning_rate=3e-3, rescale_grad=1.0 / 8))
    want = [float(jstep(jmx.nd.array(x), jmx.nd.array(y)).asscalar())
            for x, y in batches]
    jstep.sync_params()

    tnet = _acoustic(tmx)
    tnet.initialize(device="cpu")
    load_numpy_params(tnet, weights, prefix=jnet.prefix)
    tloss = tmx.gluon.loss.CTCLoss(layout="NTC", label_layout="NT")
    tstep = GluonTrainStep(
        tnet, lambda n, x, y: tloss(n(x), y),
        tmx.optimizer.Adam(learning_rate=3e-3, rescale_grad=1.0 / 8),
        device="cpu")
    got = [float(tstep(tmx.nd.array(x, ctx=CPU),
                       tmx.nd.array(y, ctx=CPU)).asscalar())
           for x, y in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n, p in jnet.collect_params().items():
        tp = tnet.collect_params()[tnet.prefix + n[len(jnet.prefix):]]
        np.testing.assert_allclose(tp.data().asnumpy(),
                                   p.data().asnumpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=n)
