"""The port's int8 path (`ops/quantized.py`, `contrib/quantization.py`)
against the JAX package's on the CPU.

The 9 registry ops on the seeded cases of `tests/torch_op_cases.py`
(their `quantized` family, JAX's cases compiled as one program): integer
outputs bit-equal, float outputs at rtol 1e-6. The int8 products exact
where float32 could not be (K 4608). The KL sweep and entropy
calibration on the same histograms: thresholds equal. Then
`quantize_net` in both calibration modes on LeNet, resnet18 v1 and v2
(narrowed, through `as_chain`) here, and a Fire net, an inception tower
net and a densenet-layer net in `tests/test_torch_quantization_units.py`
(the shapes of `tests/test_quantization_int8.py`, narrowed), weights
drawn in numpy and set on both nets (the port's with
`gluon.utils.load_numpy_params`):

- the port's own program against JAX's: the same steps and float32
  islands, the int8 weights bit-equal, every scale at rtol 1e-6 (the
  calibration's float32 convolutions sum in another order in the two
  packages, which moves a range by an ulp or two), the logits at rtol
  1e-5 and, in minmax mode, JAX's own bar (relative logit error against
  the float32 net under 0.1) held by both;
- JAX's program run by the port's executor: every int8 code entering
  every product and every int32 accumulator bit-equal, the logits at
  rtol 1e-5;
- `quantize_net_from_ranges` rebuilds the port's program bit for bit.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.contrib import quantization as jq
from incubator_mxnet_tpu.ops import quantized as jqops
from incubator_mxnet_tpu_torch.contrib import quantization as tq
from incubator_mxnet_tpu_torch.gluon.utils import load_numpy_params
from incubator_mxnet_tpu_torch.ops import quantized as tqops
from test_torch_ndarray import _jax_results, family_keys
from torch_op_cases import (DETERMINISTIC, EXTRA, FAMILY, _ALL_CASES, _key,
                            _port)

CPU = tmx.cpu()
SCALE_RTOL = 1e-6
LOGIT_RTOL = 1e-5
REL_BAR = 0.1  # tests/test_quantization_int8.py's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one intra-op thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _held(got, want, what):
    """Integer arrays bit-equal (and of one dtype), float ones at rtol
    1e-6."""
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert (g.shape, g.dtype) == (w.shape, w.dtype), \
            (what, g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=what)


def _op_parity(key):
    name, case_fn, seed = _ALL_CASES[key]
    inputs, attrs = case_fn(np.random.RandomState(seed))
    jvals = _jax_results(family_keys("quantized"))[key][0]
    vals, grads, after = _port(name, inputs, attrs, seed + 1, grad=False)
    _held(vals, [np.asarray(v) for v in jvals], name)
    _held(after, inputs, f"{name} inputs after the call")


@pytest.mark.parametrize("name", [n for n in DETERMINISTIC
                                  if FAMILY[n] == "quantized"])
def test_quantized_op_matches_jax(name):
    _op_parity(_key(name))


@pytest.mark.parametrize("k", [k for k, (n, _) in enumerate(EXTRA)
                               if FAMILY[n] == "quantized"])
def test_quantized_op_mode_matches_jax(k):
    _op_parity(f"extra:{k}")


def test_int8_products_are_exact_past_float32():
    """K = 3 * 3 * 512 = 4608 (ResNet-50's widest 3x3): 127^2 * K is past
    2^24, where a float32 sum would round; the port's int32 products
    equal an int64 oracle and JAX's."""
    rng = np.random.RandomState(0)
    x = rng.randint(100, 128, (2, 512, 4, 4)).astype(np.int8)
    w = rng.randint(-40, 128, (8, 512, 3, 3)).astype(np.int8)
    got = tqops.quantized_conv(torch.from_numpy(x), torch.from_numpy(w),
                               kernel=(3, 3), pad=(1, 1), num_filter=8)
    xp = np.pad(x.astype(np.int64), ((0, 0), (0, 0), (1, 1), (1, 1)))
    want = np.zeros((2, 8, 4, 4), np.int64)
    for i in range(3):
        for j in range(3):
            want += np.einsum("nchw,oc->nohw", xp[:, :, i:i + 4, j:j + 4],
                              w[:, :, i, j].astype(np.int64))
    assert got.dtype == torch.int32 and np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jqops.quantized_conv(jnp.asarray(x), jnp.asarray(w), kernel=(3, 3),
                             pad=(1, 1), num_filter=8)))
    xf = rng.randint(-127, 128, (3, 4608)).astype(np.int8)
    wf = rng.randint(-127, 128, (5, 4608)).astype(np.int8)
    np.testing.assert_array_equal(
        tqops.quantized_fully_connected(torch.from_numpy(xf),
                                        torch.from_numpy(wf)).numpy(),
        xf.astype(np.int64) @ wf.astype(np.int64).T)


def test_wire_functions_match_jax():
    """quantize / dequantize / requantize over NDArrays."""
    rng = np.random.RandomState(1)
    w = rng.randn(16, 16).astype(np.float32)
    tq_, tmn, tmx_ = tq.quantize(tmx.nd.array(w, ctx=CPU))
    jq_, jmn, jmx_ = jq.quantize(jmx.nd.array(w))
    _held([tq_.asnumpy(), tmn.asnumpy(), tmx_.asnumpy()],
          [jq_.asnumpy(), jmn.asnumpy(), jmx_.asnumpy()], "quantize")
    _held([tq.dequantize(tq_, tmn, tmx_).asnumpy()],
          [jq.dequantize(jq_, jmn, jmx_).asnumpy()], "dequantize")
    acc = rng.randint(-2 ** 30, 2 ** 30, (4, 5)).astype(np.int32)
    got = tq.requantize(tmx.nd.array(acc, ctx=CPU), -3.0, 4.0, max_calib=2.0)
    want = jq.requantize(jmx.nd.array(acc), -3.0, 4.0, max_calib=2.0)
    _held([a.asnumpy() for a in got], [a.asnumpy() for a in want],
          "requantize")
    back = tq.dequantize(tq_, tmn, tmx_).asnumpy()
    assert np.abs(back - w).max() < float(tmx_.asscalar()) / 127.0 + 1e-6


def test_kl_sweep_and_entropy_calibration_match_jax():
    """The KL sweep on the half-normal histograms of
    tests/test_quantization_int8.py and the streaming entropy calibration
    (range doubling included) pick JAX's thresholds exactly."""
    rng = np.random.RandomState(5)
    samples = np.abs(rng.randn(200000))
    for hi in (5.0, 12.0):
        h = np.histogram(samples, bins=1024, range=(0, hi))[0]
        t = tq._kl_sweep(h, hi)
        assert t == jq._kl_sweep(h, hi)
        assert 3.0 < t <= 5.0 if hi == 5.0 else 3.0 < t < 6.0
    d = np.array([0.0, 3.0, 0.0, 1.0, 5.0])
    np.testing.assert_array_equal(tq._smooth_distribution(d),
                                  jq._smooth_distribution(d))
    draws = [rng.randn(512).astype(np.float32) * s for s in (1.0, 3.0, 0.5)]
    got = tq.calib_entropy(lambda a: a,
                           [[tmx.nd.array(d_, ctx=CPU)] for d_ in draws],
                           num_batches=3, num_bins=256)
    want = jq.calib_entropy(lambda a: a, [[jmx.nd.array(d_)] for d_ in draws],
                            num_batches=3, num_bins=256)
    assert got == want and got[0] == -got[1] < 0
    assert tq.calib_minmax(lambda a: a, [[d_] for d_ in draws], 3) == \
        jq.calib_minmax(lambda a: a, [[d_] for d_ in draws], 3)


# -- quantize_net -----------------------------------------------------------

def _zoo(mx, module):
    return importlib.import_module(
        f"{mx.__name__}.gluon.model_zoo.vision.{module}")


def _lenet(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 5, activation="relu"), nn.MaxPool2D(2),
                nn.Conv2D(16, 5, activation="relu"), nn.MaxPool2D(2),
                nn.Flatten(), nn.Dense(32, activation="relu"),
                nn.Dense(10))
    return net


def _resnet18(version):
    def build(mx):
        return _zoo(mx, "resnet").ResNet(version, [2, 2, 2, 2],
                                         [8, 8, 16, 32, 64], False,
                                         classes=10)
    return build


def _fire_net(mx):
    nn, fire = mx.gluon.nn, _zoo(mx, "squeezenet").Fire
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, strides=2, activation="relu"),
                nn.MaxPool2D(3, 2, ceil_mode=True), fire(4), fire(4),
                nn.MaxPool2D(3, 2, ceil_mode=True), fire(6),
                nn.Dropout(0.5), nn.Conv2D(5, 1, activation="relu"),
                nn.GlobalAvgPool2D(), nn.Flatten())
    return net


def _tower_net(mx):
    nn, inc = mx.gluon.nn, _zoo(mx, "inception")
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, activation="relu"))
        net.add(inc._Tower([
            [inc._conv(8, 1)],
            [inc._conv(4, 1), inc._conv(8, 3, 1, 1)],
            [("avgpool",), inc._conv(4, 1)],
            [("split", [inc._conv(4, 1)], [inc._conv(6, 3, 1, 1)],
              [inc._conv(6, 1)])],
        ]))
        net.add(nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(5))
    return net


def _dense_net(mx):
    nn, layer = mx.gluon.nn, _zoo(mx, "densenet")._DenseLayer
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, activation="relu"))
        net.add(layer(growth_rate=4, bn_size=2, dropout=0))
        net.add(layer(growth_rate=4, bn_size=2, dropout=0))
        net.add(nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(5))
    return net


# name -> (build, image shape, through as_chain, units and their count)
NETS = {
    "lenet": (_lenet, (1, 28, 28), False, None),
    "resnet18_v1": (_resnet18(1), (3, 32, 32), True, ("resunit", 8)),
    "resnet18_v2": (_resnet18(2), (3, 32, 32), True, ("resunit2", 8)),
    "fire": (_fire_net, (3, 32, 32), False, ("fire", 3)),
    "tower": (_tower_net, (3, 12, 12), False, ("tower", 1)),
    "dense": (_dense_net, (3, 10, 10), False, ("tower", 2)),
}


def _nets(build, image, seed):
    """(JAX net, port net, probe, rng) with the same weights, drawn in
    numpy: He-normal weights, small biases and BatchNorm parameters and
    statistics away from the identity (so that the folds are not
    trivial). The JAX net's shapes come from a forward of the probe
    under a zero initializer (a JAX random draw compiles per shape)."""
    rng = np.random.RandomState(seed)
    jnet = build(jmx)
    jnet.initialize(jmx.init.Zero())
    probe = rng.rand(2, *image).astype(np.float32)
    jnet(jmx.nd.array(probe))
    weights = {}
    for name, p in sorted(jnet.collect_params().items()):
        shape = p.data().shape
        if name.endswith(("running_var", "gamma")):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith(("running_mean", "beta", "bias")):
            a = 0.1 * rng.randn(*shape)
        else:
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        weights[name] = a.astype(np.float32)
        p.set_data(jmx.nd.array(weights[name]))
    tnet = build(tmx)
    tnet.initialize(tmx.init.Zero(), device="cpu")
    load_numpy_params(tnet, weights, prefix=jnet.prefix)
    return jnet, tnet, probe, rng


class _Recorder:
    """Patches a package's quantized conv / FC / pooling functions to
    record each call's int8 input and its output, in call order."""

    NAMES = ("quantized_conv", "quantized_fully_connected",
             "quantized_pooling")

    def __init__(self, monkeypatch, module):
        self.seen = []
        for name in self.NAMES:
            monkeypatch.setattr(module, name, self._wrap(getattr(module,
                                                                 name)))

    def _wrap(self, fn):
        def call(q, *args, **kwargs):
            out = fn(q, *args, **kwargs)
            self.seen += [q, out]
            return out
        return call


def _steps_equal(got, want, where, exact_scales):
    """The port's steps against JAX's: the same keys and kinds, int
    arrays bit-equal, float arrays and numbers at SCALE_RTOL (or equal)."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            if k != "fn":
                _steps_equal(got[k], want[k], f"{where}.{k}", exact_scales)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _steps_equal(g, w, f"{where}[{i}]", exact_scales)
    elif isinstance(want, (jax.Array, np.ndarray)):
        g, w = got.numpy(), np.asarray(want)
        assert (g.shape, g.dtype) == (w.shape, w.dtype), where
        if np.issubdtype(w.dtype, np.integer) and where.endswith(".qw"):
            np.testing.assert_array_equal(g, w, err_msg=where)
        elif np.issubdtype(w.dtype, np.integer):
            # a bias is rounded in the product scale s_in * s_w: an ulp of
            # s_in may move it by one
            assert np.abs(g.astype(np.int64) - w).max() <= (
                0 if exact_scales else 1), where
        elif exact_scales:
            np.testing.assert_array_equal(g, w, err_msg=where)
        else:
            np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, err_msg=where)
    elif isinstance(want, float):
        assert got == want if exact_scales else \
            abs(got - want) <= SCALE_RTOL * abs(want), (where, got, want)
    else:
        assert got == want, (where, got, want)


def _to_port(steps):
    """JAX's program steps with every array as a CPU tensor."""
    if isinstance(steps, dict):
        return {k: _to_port(v) for k, v in steps.items()}
    if isinstance(steps, list):
        return [_to_port(v) for v in steps]
    if isinstance(steps, jax.Array):
        return torch.from_numpy(np.array(steps))
    return steps


def _rel(got, ref, net_name):
    """JAX's relative logit error: of the largest entries for LeNet, of
    the means for the others (tests/test_quantization_int8.py)."""
    err, size = np.abs(got - ref), np.abs(ref)
    if net_name == "lenet":
        return float(err.max() / (size.max() + 1e-9))
    return float(err.mean() / (size.mean() + 1e-9))


def net_parity(net_name, monkeypatch):
    """`quantize_net` of NETS[net_name] in both packages, in both
    calibration modes (the module docstring's three checks)."""
    build, image, chain, units = NETS[net_name]
    jnet, tnet, probe, rng = _nets(build, image, 0)
    prev = (jmx.autograd.set_training(False),
            tmx.autograd.set_training(False))
    try:
        if chain:
            jnet = jq.as_chain(jnet, probe=jmx.nd.array(probe))
            tnet = tq.as_chain(tnet, probe=tmx.nd.array(probe, ctx=CPU))
        calib = [rng.rand(4, *image).astype(np.float32) for _ in range(2)]
        x = rng.rand(8, *image).astype(np.float32)
        ref = jnet(jmx.nd.array(x)).asnumpy()
        np.testing.assert_allclose(tnet(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                                   ref, rtol=1e-4, atol=1e-5)
        for mode in ("minmax", "entropy"):
            jp = jq.quantize_net(jnet, [[jmx.nd.array(c)] for c in calib],
                                 num_calib_batches=2, calib_mode=mode)
            tp = tq.quantize_net(tnet,
                                 [[tmx.nd.array(c, ctx=CPU)] for c in calib],
                                 num_calib_batches=2, calib_mode=mode)
            assert tp.num_fp32_islands == jp.num_fp32_islands == 0
            if units is not None:
                assert sum(s["kind"] == units[0] for s in tp._steps) == \
                    units[1]
            _steps_equal(tp._steps, jp._steps, f"{net_name} {mode}", False)
            # JAX's program (jitted, its products recorded) and the port's
            # executor on it: bit-equal codes and accumulators
            jrec = _Recorder(monkeypatch, jqops)
            trec = _Recorder(monkeypatch, tqops)
            run = jax.jit(lambda a: (jp._run(a), list(jrec.seen)))
            jl, jseen = run(jnp.asarray(x))
            jl = np.asarray(jl)
            port = tq.QuantizedNet(_to_port(jp._steps), jp._s_in, "cpu")
            np.testing.assert_allclose(
                port.apply(torch.from_numpy(x)).numpy(), jl,
                rtol=LOGIT_RTOL, atol=0)
            assert len(trec.seen) == len(jseen) > 0
            for i, (g, w) in enumerate(zip(trec.seen, jseen)):
                assert g.dtype in (torch.int8, torch.int32), i
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=str(i))
            # the port's own program
            tl = tp(tmx.nd.array(x, ctx=CPU)).asnumpy()
            np.testing.assert_allclose(tl, jl, rtol=LOGIT_RTOL,
                                       atol=LOGIT_RTOL * np.abs(jl).max())
            if mode == "minmax":  # where JAX's tests hold JAX to the bar
                assert _rel(jl, ref, net_name) < REL_BAR
                assert _rel(tl, ref, net_name) < REL_BAR
            monkeypatch.undo()
            again = tq.quantize_net_from_ranges(tnet, tp.ranges)
            _steps_equal(again._steps, _numpy_steps(tp._steps),
                         f"{net_name} {mode} rebuilt", True)
    finally:
        jmx.autograd.set_training(prev[0])
        tmx.autograd.set_training(prev[1])


@pytest.mark.parametrize("net_name", ["lenet", "resnet18_v1",
                                      "resnet18_v2"])
def test_quantize_net_matches_jax(net_name, monkeypatch):
    net_parity(net_name, monkeypatch)


def _numpy_steps(steps):
    if isinstance(steps, dict):
        return {k: _numpy_steps(v) for k, v in steps.items()}
    if isinstance(steps, list):
        return [_numpy_steps(v) for v in steps]
    if isinstance(steps, torch.Tensor):
        return steps.numpy()
    return steps


def test_quantize_net_refuses_what_jax_refuses():
    _, tnet, _, rng = _nets(_lenet, (1, 28, 28), 0)
    calib = [[tmx.nd.array(rng.rand(2, 1, 28, 28).astype(np.float32),
                           ctx=CPU)]]
    with pytest.raises(ValueError, match="calib_mode"):
        tq.quantize_net(tnet, calib, calib_mode="bogus")
    with pytest.raises(ValueError, match="empty calibration"):
        tq.quantize_net(tnet, [])
    with pytest.raises(ValueError, match="only int8"):
        tq.quantize_net(tnet, calib, quantized_dtype="uint8")
    with pytest.raises(ValueError, match="features/output"):
        tq.as_chain(tmx.gluon.nn.Dense(3))
    for op in (tqops._contrib_quantize_v2,):
        with pytest.raises(NotImplementedError, match="uint8"):
            op(torch.zeros(2), out_type="uint8")
