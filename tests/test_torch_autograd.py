"""The port's autograd (`autograd.py`) against the JAX package's: the
cases of `tests/test_autograd.py` that apply, run through both packages
on the same inputs (values at rtol 1e-5, gradients at rtol 1e-4, atol
1e-5), and the gradient requests, scopes and modes.

Then `examples/gluon_mnist.py`'s loop at a small size (two batches of
32, the JAX net hybridized: the example's `--hybridize` mode), the
imperative loop through autograd end to end.

One difference is the reference's own rule: a variable is marked
(`attach_grad`) before the recorded ops that use it, as torch records
only what requires grad; the JAX package's tape also differentiates
unmarked arrays (`test_grad_function` there).
"""
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6
GRTOL, GATOL = 1e-4, 1e-5


def _both(fn):
    """fn(mx, nd, autograd, array) run by each package -> (port, jax)."""
    def tarray(a):
        return tmx.nd.array(np.asarray(a, np.float32), ctx=CPU)

    def jarray(a):
        return jmx.nd.array(np.asarray(a, np.float32))

    return (fn(tmx, tmx.nd, tmx.autograd, tarray),
            fn(jmx, jmx.nd, jmx.autograd, jarray))


def _same(fn, rtol=GRTOL, atol=GATOL):
    got, want = _both(fn)
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol)
    return got


def test_simple_grad():
    def run(mx, nd, ag, arr):
        x = arr([[1.0, 2.0], [3.0, 4.0]])
        x.attach_grad()
        with ag.record():
            y = (x * x).sum()
        y.backward()
        return x.grad.asnumpy()

    got = _same(run)
    np.testing.assert_allclose(got[0], [[2, 4], [6, 8]])


def test_chain_grad():
    xn = np.random.RandomState(0).randn(3, 4)

    def run(mx, nd, ag, arr):
        x = arr(xn)
        x.attach_grad()
        with ag.record():
            y = nd.exp(x)
            z = (y * 2).sum()
        z.backward()
        return x.grad.asnumpy()

    _same(run)


def test_multi_path_and_head_grads():
    def run(mx, nd, ag, arr):
        x = arr([2.0])
        x.attach_grad()
        with ag.record():
            y = x * x + x * 3
        y.backward()
        g1 = x.grad.asnumpy()
        z = arr([1.0, 2.0])
        z.attach_grad()
        with ag.record():
            w = z * 2
        w.backward(arr([10.0, 100.0]))
        return g1, z.grad.asnumpy()

    got = _same(run)
    np.testing.assert_allclose(got[0], [7.0])
    np.testing.assert_allclose(got[1], [20.0, 200.0])


def test_grad_req_write_overwrites_and_add_accumulates():
    """Two loops without zero_grad: "write" keeps the last gradient,
    "add" their sum, "null" none (torch's own .grad never accumulates)."""
    def run(mx, nd, ag, arr):
        out = []
        for req in ("write", "add"):
            x = arr([1.0, -2.0])
            x.attach_grad(grad_req=req)
            for scale in (2.0, 3.0):
                with ag.record():
                    y = (x * x * scale).sum()
                y.backward()
            out.append(x.grad.asnumpy())
        return out

    got = _same(run)
    np.testing.assert_allclose(got[0], [6.0, -12.0])
    np.testing.assert_allclose(got[1], [10.0, -20.0])
    x = tmx.nd.array([1.0], ctx=CPU)
    x.attach_grad(grad_req="null")
    with tmx.autograd.record():
        y = x * 2
    y.backward()
    assert float(x.grad.asnumpy()[0]) == 0.0
    assert x._data.grad is None


def test_detach_stop_gradient():
    def run(mx, nd, ag, arr):
        x = arr([3.0])
        x.attach_grad()
        with ag.record():
            y = x * x
            z = nd.BlockGrad(y) + x + y.detach()
        z.backward()
        return x.grad.asnumpy()

    np.testing.assert_allclose(_same(run)[0], [1.0])


def test_scopes_and_modes():
    for ag in (tmx.autograd, jmx.autograd):
        assert not ag.is_recording() and not ag.is_training()
        with ag.record():
            assert ag.is_recording() and ag.is_training()
            with ag.pause():
                assert not ag.is_recording() and not ag.is_training()
            with ag.pause(train_mode=True):
                assert ag.is_training()
        with ag.record(train_mode=False):
            assert ag.is_recording() and not ag.is_training()
        with ag.train_mode():
            assert ag.is_training() and not ag.is_recording()
            with ag.predict_mode():
                assert not ag.is_training()
        assert ag.set_recording(True) is False
        assert ag.set_recording(False) is True
        assert ag.set_training(True) is False
        assert ag.set_training(False) is True


def test_ops_outside_record_build_no_graph():
    x = tmx.nd.array([1.0, 2.0], ctx=CPU)
    x.attach_grad()
    y = x * 3
    assert not y._data.requires_grad
    with tmx.autograd.record():
        z = x * 3
    assert z._data.requires_grad


def test_grad_function():
    def run(mx, nd, ag, arr):
        x = arr([1.0, 2.0, 3.0])
        x.attach_grad()
        with ag.record():
            y = (x * x).sum()
        g = ag.grad(y, x)
        return g.asnumpy(), x.grad.asnumpy()

    got = _same(run)
    np.testing.assert_allclose(got[0], [2.0, 4.0, 6.0])
    np.testing.assert_allclose(got[1], 0.0)  # the buffer is untouched


def test_dropout_training_mode():
    with tmx.cpu():
        x = tmx.nd.ones((100, 100))
        with tmx.autograd.record(train_mode=True):
            y = tmx.nd.Dropout(x, p=0.5)
        frac = float((y.asnumpy() == 0).mean())
        assert 0.3 < frac < 0.7
        y2 = tmx.nd.Dropout(x, p=0.5)  # predict mode: the identity
        assert (y2.asnumpy() == 1).all()
        with tmx.autograd.train_mode():
            y3 = tmx.nd.Dropout(x, p=0.5)
        assert (y3.asnumpy() == 0).any()


def test_mark_variables():
    def run(mx, nd, ag, arr):
        x = arr([5.0])
        g = arr([0.0])
        ag.mark_variables([x], [g])
        with ag.record():
            y = x * 4
        y.backward()
        return g.asnumpy()

    np.testing.assert_allclose(_same(run)[0], [4.0])


def test_grad_create_graph_second_derivative():
    def run(mx, nd, ag, arr):
        x = arr([1.0, 2.0, -3.0])
        x.attach_grad()
        with ag.record():
            y = (x * x * x).sum()
            gx = ag.grad(y, x, create_graph=True)
            z = (gx * gx).sum()      # 9 sum x^4
        z.backward()
        return x.grad.asnumpy()

    got = _same(run)
    np.testing.assert_allclose(got[0], 36 * np.array([1, 8, -27.0]),
                               rtol=1e-5)


def test_grad_create_graph_through_layers():
    """A gradient penalty through a Dense layer, the weights carried from
    the JAX package's net."""
    xn = np.random.RandomState(0).rand(4, 3).astype(np.float32)

    def run(mx, nd, ag, arr):
        net = mx.gluon.nn.Dense(1, in_units=3)
        if mx is jmx:
            mx.random.seed(0)
            net.initialize(mx.init.Xavier())
        else:
            net.initialize(ctx=CPU)
            mx.gluon.utils.load_numpy_params(net, _WEIGHTS, prefix="x")
        x = arr(xn)
        x.attach_grad()
        with ag.record():
            y = net(x).sum()
            gx = ag.grad(y, x, create_graph=True)
            penalty = (gx ** 2).sum()
        penalty.backward()
        return x.grad.asnumpy(), net.weight.grad().asnumpy()

    jmx.random.seed(0)
    jnet = jmx.gluon.nn.Dense(1, in_units=3)
    jnet.initialize(jmx.init.Xavier())
    global _WEIGHTS
    _WEIGHTS = {"x" + n[len(jnet.prefix):]: p.data().asnumpy()
                for n, p in jnet.collect_params().items()}
    got = _same(run)
    np.testing.assert_allclose(got[0], 0.0, atol=1e-6)
    np.testing.assert_allclose(got[1], 2 * 4 * _WEIGHTS["xweight"],
                               rtol=1e-5)


_WEIGHTS = {}


def test_grad_wrt_head_and_intermediate_both_paths():
    for cg in (False, True):
        def run(mx, nd, ag, arr):
            x = arr([3.0])
            x.attach_grad()
            with ag.record():
                t = x * 2.0
                t.attach_grad()
                y = t * t
                gy = ag.grad(y, y, create_graph=cg, retain_graph=True)
                gt = ag.grad(y, t, create_graph=cg, retain_graph=True)
            return gy.asnumpy(), gt.asnumpy()

        got = _same(run)
        np.testing.assert_allclose(got[0], [1.0])
        np.testing.assert_allclose(got[1], [12.0])


def test_backward_of_several_heads_and_retain_graph():
    def run(mx, nd, ag, arr):
        x = arr([1.0, 2.0])
        x.attach_grad()
        with ag.record():
            a = x * 3
            b = (x * x).sum()
        ag.backward([a, b], [arr([1.0, 1.0]), None], retain_graph=True)
        g1 = x.grad.asnumpy()
        ag.backward([b])
        return g1, x.grad.asnumpy()

    got = _same(run)
    np.testing.assert_allclose(got[0], [5.0, 7.0])
    np.testing.assert_allclose(got[1], [2.0, 4.0])


def test_second_backward_in_one_record_warns():
    x = tmx.nd.array([1.0], ctx=CPU)
    x.attach_grad()
    with tmx.autograd.record():
        y1 = x * 2
        y2 = x * 3
        y1.backward()
        with pytest.warns(RuntimeWarning, match="overwritten"):
            y2.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [3.0])


def test_parameter_grad_write_then_zero_grad():
    """A Parameter's data and grad are NDArrays; backward writes its
    buffer, zero_grad clears it in place, and grad_req "add" sums."""
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=CPU)
    x = tmx.nd.array(np.ones((4, 3), np.float32), ctx=CPU)
    buf = net.weight.grad()
    for _ in range(2):
        with tmx.autograd.record():
            y = net(x).sum()
        y.backward()
    assert net.weight.grad() is buf
    np.testing.assert_allclose(buf.asnumpy(), 4.0)
    net.collect_params().zero_grad()
    assert float(buf.asnumpy().sum()) == 0.0
    net.collect_params().setattr("grad_req", "add")
    for _ in range(2):
        with tmx.autograd.record():
            y = net(x).sum()
        y.backward()
    np.testing.assert_allclose(net.weight.grad().asnumpy(), 8.0)
    assert isinstance(net.weight.data(), tmx.NDArray)
    assert net.weight.data()._data is net.weight.tensor()
    assert torch.is_tensor(net.weight.tensor())
    assert net.weight.list_grad()[0] is net.weight.grad()


def test_get_symbol_waits_for_the_symbolic_slice():
    with pytest.raises(NotImplementedError):
        tmx.autograd.get_symbol(None)


# -- examples/gluon_mnist.py's loop -----------------------------------------

def _mnist(mx, batches=2, batch=32):
    """`examples/gluon_mnist.py`'s loop at a small size: (losses, correct
    counts, final weights)."""
    mx.random.seed(0)
    np.random.seed(0)
    rng = np.random.RandomState(0)
    proto = rng.rand(10, 1, 28, 28).astype("float32")
    y = rng.randint(0, 10, batches * batch)
    X = proto[y] + 0.1 * rng.randn(batches * batch, 1, 28, 28).astype(
        "float32")
    loader = mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(X, y.astype("float32")),
        batch_size=batch, shuffle=True)
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(20, 5, activation="relu"), nn.MaxPool2D(2, 2),
            nn.Conv2D(50, 5, activation="relu"), nn.MaxPool2D(2, 2),
            nn.Flatten(), nn.Dense(500, activation="relu"), nn.Dense(10))
    if mx is jmx:
        net.initialize(mx.init.Xavier())
        net.hybridize()
    else:
        # the example's layers are named from the process-wide counters
        # (conv0_, dense0_, ...): carry the JAX weights over in order
        net.initialize(mx.init.Xavier(), ctx=CPU)
        for p, v in zip(net.collect_params().values(), _MNIST_INIT):
            p.set_data(v)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, correct = [], []
    for data, label in loader:
        if mx is jmx and not _MNIST_INIT:
            with mx.autograd.predict_mode():
                net(data)
            _MNIST_INIT.extend(p.data().asnumpy()
                               for p in net.collect_params().values())
        with mx.autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(data.shape[0])
        losses.append(float(loss.mean().asscalar()))
        correct.append(int((out.asnumpy().argmax(1)
                            == label.asnumpy()).sum()))
    return losses, correct, [p.data().asnumpy()
                             for p in net.collect_params().values()]


_MNIST_INIT = []


def test_gluon_mnist_loop_matches_jax():
    """Two batches of 32 through the example's loop as written: the same
    shuffle, the step-1 loss and both correct counts, and the weights
    after two steps."""
    _MNIST_INIT.clear()
    want = _mnist(jmx)
    got = _mnist(tmx)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=1e-5)
    assert got[1] == want[1]
    for k, (g, w) in enumerate(zip(got[2], want[2])):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-5,
                                   err_msg=str(k))
    assert os.path.exists(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "gluon_mnist.py"))
    assert got[1] and sum(got[1]) >= 0
