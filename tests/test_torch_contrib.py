"""The port's contrib and gluon-level surfaces of this slice against the
JAX package's (CPU): `operator.CustomOp` forward and backward, `contrib`
control flow with gradients, the legacy `contrib.autograd`, the DGL graph
samplers, `SVRGTrainer` over a few epochs, `gluon.data.vision`
transforms and datasets, `gluon.Constant`, `gluon.utils.check_sha1`,
`model.load_params` / `bootstrap_params` over a local parameter server,
`runtime.Features`, the DLPack round trips, the `nd.contrib` /
`nd.image` / `nd.linalg` namespaces, `config.describe` and
`test_utils`. Values at rtol 1e-5, atol 1e-6 and gradients at rtol 1e-4,
atol 1e-5 (`tests/test_torch_ndarray.py`)."""
import hashlib
import random as pyrandom

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
GRTOL, GATOL = 1e-4, 1e-5
CPU = tmx.cpu()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: on a loaded machine (the suite's other workers), torch's
    intra-op thread pool makes them many times slower than one thread
    does, and takes cores from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both():
    return ((tmx, tmx.nd.array, tmx.cpu()), (jmx, jmx.nd.array, jmx.cpu()))


# -- operator.CustomOp --------------------------------------------------------

def _register_softmax_xent(mx, name):
    class Op(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x, y = in_data[0].asnumpy(), in_data[1].asnumpy()
            e = np.exp(x - x.max(1, keepdims=True))
            p = e / e.sum(1, keepdims=True)
            loss = -np.log(p[np.arange(len(y)), y.astype(int)]).mean()
            self.assign(out_data[0], req[0], np.asarray([loss], np.float32))
            self.assign(out_data[1], req[1], p.astype(np.float32))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = in_data[1].asnumpy()
            g = out_data[1].asnumpy().copy()
            g[np.arange(len(y)), y.astype(int)] -= 1.0
            g *= out_grad[0].asnumpy()[0] / len(y)
            self.assign(in_grad[0], req[0], g.astype(np.float32))
            self.assign(in_grad[1], req[1], np.zeros_like(y))

    @mx.operator.register(name)
    class Prop(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["loss", "prob"]

        def infer_shape(self, in_shape):
            return in_shape, [(1,), in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Op()

    return Prop


def test_custom_op_forward_and_backward_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 4).astype(np.float32)
    y = rng.randint(0, 4, 5).astype(np.float32)
    outs = []
    for mx, arr, ctx in _both():
        _register_softmax_xent(mx, "t_softmax_xent")
        xd, yd = arr(x, ctx=ctx), arr(y, ctx=ctx)
        xd.attach_grad()
        with mx.autograd.record():
            loss, prob = mx.nd.Custom(xd, yd, op_type="t_softmax_xent")
        loss.backward()
        outs.append((loss.asnumpy(), prob.asnumpy(), xd.grad.asnumpy()))
        assert hasattr(mx.nd, "Custom_t_softmax_xent")
    for got, want in zip(*outs):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(KeyError):
        tmx.nd.Custom(tmx.nd.array(x, ctx=CPU), op_type="no_such_op")


# -- contrib control flow and the legacy autograd ----------------------------

def _control_flow(mx, arr, ctx):
    cf = mx.contrib
    rng = np.random.RandomState(1)
    xs = arr(rng.randn(4, 3).astype(np.float32), ctx=ctx)
    s0 = arr(rng.randn(3).astype(np.float32), ctx=ctx)
    for v in (xs, s0):
        v.attach_grad()
    with mx.autograd.record():
        outs, final = cf.foreach(lambda x, s: (x * s + 1, s * 0.5 + x),
                                 xs, s0)
        loss = (outs * outs).sum() + final.sum()
    loss.backward()
    res = [outs.asnumpy(), final.asnumpy(), xs.grad.asnumpy(),
           s0.grad.asnumpy()]

    i0 = arr(np.array([0.0], np.float32), ctx=ctx)
    v0 = arr(rng.rand(2).astype(np.float32) + 0.5, ctx=ctx)
    v0.attach_grad()
    with mx.autograd.record():
        steps, (i_end, v_end) = cf.while_loop(
            lambda vs: vs[0] < 3,
            lambda vs: (vs[1] * 2, [vs[0] + 1, vs[1] * 1.5]),
            [i0, v0], max_iterations=5)
        loss = steps.sum() + v_end.sum()
    loss.backward()
    res += [steps.asnumpy(), i_end.asnumpy(), v_end.asnumpy(),
            v0.grad.asnumpy()]

    a = arr(rng.randn(3).astype(np.float32), ctx=ctx)
    a.attach_grad()
    for p in (1.0, 0.0):
        with mx.autograd.record():
            out = cf.cond(arr(np.array([p], np.float32), ctx=ctx),
                          lambda v: v * 3, lambda v: v * v, [a])
            out.sum().backward()
        res += [out.asnumpy(), a.grad.asnumpy()]

    g, loss = mx.contrib.autograd.grad_and_loss(
        lambda u, w: (u * w).sum() + (u * u).sum())(
            arr(np.arange(3, dtype=np.float32), ctx=ctx),
            arr(np.ones(3, np.float32), ctx=ctx))
    res += [x.asnumpy() for x in g] + [loss.asnumpy()]
    return res


def test_control_flow_and_gradients_match_jax():
    port = _control_flow(tmx, tmx.nd.array, CPU)
    ref = _control_flow(jmx, jmx.nd.array, jmx.cpu())
    assert port[4].shape == (5, 2)        # while_loop pads to 5 rows
    assert not port[4][3:].any()
    for k, (got, want) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(got, want, rtol=GRTOL, atol=GATOL,
                                   err_msg=str(k))


# -- contrib.graph (DGL sampling over CSR) ------------------------------------

def _graph(mx, ctx):
    rng = np.random.RandomState(2)
    n = 12
    dense = (rng.rand(n, n) < 0.3).astype(np.float32)
    np.fill_diagonal(dense, 0)
    rows, cols = np.nonzero(dense)
    indptr = np.concatenate([[0], np.cumsum(dense.sum(1))]).astype(np.int64)
    eids = np.arange(len(cols), dtype=np.int64)
    nd = mx.nd
    csr = nd.sparse.CSRNDArray(nd.array(eids, ctx=ctx),
                               nd.array(indptr, ctx=ctx),
                               nd.array(cols.astype(np.int64), ctx=ctx),
                               (n, n))
    seeds = nd.array(np.array([0, 5], np.int64), ctx=ctx)
    g = mx.contrib.graph
    res = []

    def dense_of(c):
        return c.asnumpy() if hasattr(c, "asnumpy") else c

    uni = g.csr_neighbor_uniform_sample(
        csr, seeds, num_hops=2, num_neighbor=2, max_num_vertices=6,
        rng=np.random.default_rng(0))
    res += [dense_of(u) for u in uni]
    prob = nd.array(rng.rand(n).astype(np.float32), ctx=ctx)
    non = g.csr_neighbor_non_uniform_sample(
        csr, prob, seeds, num_hops=1, num_neighbor=2, max_num_vertices=5,
        rng=np.random.default_rng(1))
    res += [dense_of(u) for u in non]
    vids = nd.array(np.array([1, 3, 4, 7, 9], np.int64), ctx=ctx)
    sub, mapping = g.dgl_subgraph(csr, vids, return_mapping=True)
    res += [sub.asnumpy(), mapping.asnumpy()]
    res.append(g.edge_id(csr, nd.array(np.array([0, 1, 2], np.int64),
                                       ctx=ctx),
                         nd.array(np.array([3, 4, 5], np.int64),
                                  ctx=ctx)).asnumpy())
    res.append(g.dgl_adjacency(csr).asnumpy())
    compact = g.dgl_graph_compact(uni[1], uni[0],
                                  graph_sizes=int(dense_of(uni[0])[-1]))
    res.append(compact.asnumpy())
    res.append(nd.contrib.edge_id(
        csr, nd.array(np.array([0], np.int64), ctx=ctx),
        nd.array(np.array([3], np.int64), ctx=ctx)).asnumpy())
    return res


def test_graph_samplers_match_jax():
    port, ref = _graph(tmx, CPU), _graph(jmx, jmx.cpu())
    assert len(port) == len(ref)
    for k, (got, want) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=str(k))


# -- SVRG -------------------------------------------------------------------

def _svrg(mx, ctx, epochs=3):
    rng = np.random.RandomState(0)
    scales = np.logspace(0, 1, 6).astype(np.float32)
    x = (rng.randn(64, 6) * scales).astype(np.float32)
    y = (x @ rng.randn(6, 1) + 0.01 * rng.randn(64, 1)).astype(np.float32)
    batches = [(mx.nd.array(x[i:i + 16], ctx=ctx),
                mx.nd.array(y[i:i + 16], ctx=ctx)) for i in range(0, 64, 16)]
    mx.random.seed(3)
    net = mx.gluon.nn.Dense(1, in_units=6, prefix="svrg_")
    net.initialize(mx.init.Zero(), ctx=ctx)

    def mse(n, a, b):
        err = n(a) - b
        return (err * err).mean()

    tr = mx.contrib.svrg.SVRGTrainer(net, mse, optimizer="sgd",
                                     optimizer_params={"learning_rate": 2e-3},
                                     update_freq=2)
    losses = []
    for epoch in range(epochs):
        if epoch % tr.update_freq == 0:
            tr.update_full_grads(batches)
        for a, b in batches:
            losses.append(float(tr.step(a, b).asnumpy()))
    return losses, [p.data().asnumpy() for p in
                    net.collect_params().values()]


def test_svrg_trainer_matches_jax():
    got_l, got_w = _svrg(tmx, CPU)
    want_l, want_w = _svrg(jmx, jmx.cpu())
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL, atol=ATOL)
    for g, w in zip(got_w, want_w):
        np.testing.assert_allclose(g, w, rtol=GRTOL, atol=GATOL)
    assert got_l[-1] < got_l[0]


# -- gluon.data.vision --------------------------------------------------------

def _transforms(mx):
    T = mx.gluon.data.vision.transforms
    img = np.random.RandomState(4).randint(0, 256, (12, 10, 3)).astype(
        np.uint8)
    x = mx.nd.array(img, ctx=mx.cpu(), dtype="uint8")
    out = [T.Compose([T.ToTensor(), T.Normalize((0.4, 0.5, 0.6),
                                                (0.2, 0.3, 0.4))])(x),
           T.Cast("float16")(x), T.CenterCrop((6, 8))(x)]
    xf = mx.nd.array(img.astype(np.float32), ctx=mx.cpu())
    pyrandom.seed(9)
    np.random.seed(9)
    for t in (T.RandomFlipLeftRight(), T.RandomFlipTopBottom(),
              T.RandomBrightness(0.3), T.RandomContrast(0.3),
              T.RandomSaturation(0.3), T.RandomHue(0.2),
              T.RandomLighting(0.1), T.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
              T.Resize((7, 5)), T.RandomResizedCrop(6)):
        out.append(t(xf))
    return [o.asnumpy() for o in out]


def test_transforms_match_jax():
    port, ref = _transforms(tmx), _transforms(jmx)
    for k, (got, want) in enumerate(zip(port, ref)):
        assert got.shape == want.shape, k
        # resizing: OpenCV in the JAX package, interpolate here
        tol = (dict(rtol=1e-3, atol=1e-2) if k >= len(port) - 2
               else dict(rtol=RTOL, atol=1e-4))
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), err_msg=str(k),
                                   **tol)


def test_vision_datasets_read_local_files(tmp_path):
    """MNIST idx files and CIFAR-10 batches written here read back as the
    JAX package reads them; SyntheticImageDataset draws JAX's items."""
    rng = np.random.RandomState(5)
    imgs = rng.randint(0, 256, (3, 28, 28)).astype(np.uint8)
    lbls = np.array([7, 1, 4], np.uint8)
    with open(tmp_path / "t10k-images-idx3-ubyte", "wb") as f:
        f.write(np.array([2051, 3, 28, 28], ">i4").tobytes() + imgs.tobytes())
    with open(tmp_path / "t10k-labels-idx1-ubyte", "wb") as f:
        f.write(np.array([2049, 3], ">i4").tobytes() + lbls.tobytes())
    cifar = rng.randint(0, 256, (2, 3073)).astype(np.uint8)
    cifar.tofile(tmp_path / "test_batch.bin")
    sets = []
    for mx in (tmx, jmx):
        V = mx.gluon.data.vision
        m = V.MNIST(root=str(tmp_path), train=False)
        c = V.CIFAR10(root=str(tmp_path), train=False)
        s = V.SyntheticImageDataset(num_samples=4, shape=(3, 5, 5),
                                    num_classes=3, seed=2)
        sets.append([(d[i][0].asnumpy(), int(d[i][1])) for d in (m, c, s)
                     for i in range(len(d) if len(d) < 4 else 2)])
        with pytest.raises(FileNotFoundError):
            V.MNIST(root=str(tmp_path / "none"))
    for (gx, gy), (wx, wy) in zip(*sets):
        np.testing.assert_array_equal(gx, wx)
        assert gy == wy
    assert len(tmx.gluon.data.vision.MNIST(root=str(tmp_path),
                                           train=False)) == 3


# -- gluon.Constant, check_sha1, model.load_params / bootstrap_params ---------

def test_constant_parameter_matches_jax():
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    vals = []
    for mx, _, ctx in _both():
        c = mx.gluon.Constant("const", value)
        c.initialize(ctx=ctx)
        assert c.grad_req == "null"
        pd = mx.gluon.ParameterDict("blk_")
        k = pd.get_constant("k", value * 2)
        pd.initialize(ctx=ctx)
        vals.append((c.data().asnumpy(), k.data().asnumpy(), k.name))
    for got, want in zip(*vals):
        np.testing.assert_array_equal(got, want)


def test_check_sha1(tmp_path):
    path = tmp_path / "blob.bin"
    path.write_bytes(b"detection" * 1000)
    digest = hashlib.sha1(path.read_bytes()).hexdigest()
    for mx in (tmx, jmx):
        assert mx.gluon.utils.check_sha1(str(path), digest)
        assert not mx.gluon.utils.check_sha1(str(path), "0" * 40)
    with pytest.raises(RuntimeError):
        tmx.gluon.utils.download("http://localhost/x")


def test_load_params_reads_an_epoch_checkpoint(tmp_path):
    prefix = str(tmp_path / "net")
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    m = np.ones(3, np.float32)
    jmx.nd.save(f"{prefix}-0003.params", {"arg:fc_weight": jmx.nd.array(w),
                                          "aux:bn_mean": jmx.nd.array(m)})
    with tmx.cpu():
        arg, aux = tmx.model.load_params(prefix, 3)
    jarg, jaux = jmx.model.load_params(prefix, 3)
    assert sorted(arg) == sorted(jarg) and sorted(aux) == sorted(jaux)
    np.testing.assert_array_equal(arg["fc_weight"].asnumpy(), w)
    np.testing.assert_array_equal(aux["bn_mean"].asnumpy(), m)
    with tmx.cpu(), pytest.raises(FileNotFoundError):
        tmx.model.load_params(prefix, 4)


def test_bootstrap_params_over_a_local_server():
    from incubator_mxnet_tpu import ps as jps
    from incubator_mxnet_tpu_torch import ps as tps

    srv = tps.ParameterServer(num_workers=1, host="127.0.0.1", port=0)
    c = tps.PSClient("127.0.0.1", srv.port)
    jc = jps.PSClient("127.0.0.1", srv.port)
    try:
        w = np.arange(12, dtype=np.float32).reshape(4, 3)
        c.init("w", w)
        c.push("w", np.ones((4, 3), np.float32))
        with tmx.cpu():
            got = tmx.model.bootstrap_params(c)
        want = jmx.model.bootstrap_params(jc)
        assert sorted(got) == sorted(want) == ["w"]
        np.testing.assert_array_equal(got["w"].asnumpy(), w + 1)
        np.testing.assert_array_equal(got["w"].asnumpy(),
                                      want["w"].asnumpy())
    finally:
        c.stop_server()
        c.close()
        jc.close()
        srv.shutdown()


# -- runtime, DLPack, namespaces, config, test_utils -------------------------

def test_features_keep_the_jax_names():
    feats = tmx.runtime.Features()
    assert set(jmx.runtime.Features()) <= set(feats)
    assert feats.is_enabled("CPU") and not feats.is_enabled("TPU")
    assert feats.is_enabled("CUDA") == torch.cuda.is_available()
    for name in ("CUDA", "CUDNN", "NCCL", "CUDA_KERNELS"):
        assert isinstance(feats[name].enabled, bool)
    assert not tmx.util.is_np_array()


def test_dlpack_round_trips():
    nd = tmx.nd
    t = torch.arange(6, dtype=torch.float32)
    a = nd.from_dlpack(t)
    t[0] = 10.0                     # shares the producer's memory
    assert a.asnumpy()[0] == 10.0
    b = nd.from_dlpack(torch.utils.dlpack.to_dlpack(t))
    np.testing.assert_array_equal(b.asnumpy(), t.numpy())
    c = nd.array(np.arange(4, dtype=np.float32), ctx=CPU)
    r = torch.utils.dlpack.from_dlpack(nd.to_dlpack_for_read(c))
    np.testing.assert_array_equal(r.numpy(), c.asnumpy())
    wv = torch.utils.dlpack.from_dlpack(nd.to_dlpack_for_write(c))
    wv += 1                         # the writer's changes show in c
    np.testing.assert_array_equal(c.asnumpy(), np.arange(4) + 1)
    np.testing.assert_array_equal(
        nd.from_dlpack(np.arange(3.0)).asnumpy(), np.arange(3.0))
    # JAX's NDArray hands its buffer to the port through the protocol
    j = jmx.nd.array(np.arange(5, dtype=np.float32))
    np.testing.assert_array_equal(nd.from_dlpack(j._data).asnumpy(),
                                  np.arange(5))


def test_nd_namespaces_cover_jax():
    """Every public function of JAX's nd.contrib (the quantized family's
    9 among them), nd.image and nd.linalg is in the port's."""
    for sub in ("contrib", "image", "linalg"):
        want = {n for n in dir(getattr(jmx.nd, sub)) if not n.startswith("_")
                and callable(getattr(getattr(jmx.nd, sub), n))}
        have = set(dir(getattr(tmx.nd, sub)))
        missing = want - {"NDArray", "OP_REGISTRY"} - have
        assert not missing, (sub, sorted(missing))
    assert {"quantize", "quantize_v2", "dequantize", "requantize",
            "quantized_conv", "quantized_fully_connected",
            "quantized_pooling", "quantized_flatten",
            "quantized_concat"} <= set(dir(tmx.nd.contrib))
    rng = np.random.RandomState(6)
    a = rng.randn(3, 4).astype(np.float32)
    for fn, args in ((lambda nd, x: nd.contrib.index_copy(
            x, nd.array(np.array([2.0, 0.0], np.float32), ctx=x.context),
            nd.array(np.ones((2, 4), np.float32), ctx=x.context)), ()),
                     (lambda nd, x: nd.contrib.index_array(x), ()),
                     (lambda nd, x: nd.contrib.arange_like(x, axis=1), ()),
                     (lambda nd, x: nd.linalg.syrk(x, alpha=0.5), ()),
                     (lambda nd, x: nd.contrib.div_sqrt_dim(x), ())):
        got = fn(tmx.nd, tmx.nd.array(a, ctx=CPU)).asnumpy()
        want = fn(jmx.nd, jmx.nd.array(a)).asnumpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    img = rng.rand(4, 5, 3).astype(np.float32) * 255
    got = tmx.nd.image.normalize(tmx.nd.image.to_tensor(
        tmx.nd.array(img, ctx=CPU)), 0.5, 0.25).asnumpy()
    want = jmx.nd.image.normalize(jmx.nd.image.to_tensor(
        jmx.nd.array(img)), 0.5, 0.25).asnumpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_config_register_knob_and_describe():
    from incubator_mxnet_tpu_torch import config

    knob = config.register_knob("MXTPU_TEST_ONLY_KNOB", 3, int, "A test.")
    try:
        assert config.get("MXTPU_TEST_ONLY_KNOB") == 3
        text = config.describe()
        assert "`MXTPU_TEST_ONLY_KNOB` (default `3`, int): A test." in text
        assert "`MXTPU_FUSED_EPILOGUE`" in text
        assert knob.name == "MXTPU_TEST_ONLY_KNOB"
    finally:
        config.KNOBS.pop("MXTPU_TEST_ONLY_KNOB")


def test_test_utils():
    with tmx.cpu():
        _test_utils()


def _test_utils():
    tu = tmx.test_utils
    tu.assert_almost_equal(np.ones(3), tmx.nd.ones((3,), ctx=CPU))
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(np.ones(3), np.zeros(3))
    tu.set_default_context(CPU)
    try:
        assert tu.default_context() == CPU
        a = tu.rand_ndarray((2, 3), ctx=CPU)
        assert a.shape == (2, 3) and np.abs(a.asnumpy()).max() <= 1
        assert tu.rand_ndarray((4, 3), stype="csr", ctx=CPU).stype == "csr"
    finally:
        tu.set_default_context(None)
    assert tu.same(tu.create_2d_tensor(2, 3).asnumpy(),
                   jmx.test_utils.create_2d_tensor(2, 3).asnumpy())
    with pytest.raises(NotImplementedError):
        tu.check_consistency(None, [])


def test_bench_device_batch_is_seeded():
    """`BENCH_ONDEVICE`'s batch: uniform [0, 1) images cast to the
    bench's dtype and integer labels below 1000 as float32, the same for
    a seed."""
    from incubator_mxnet_tpu_torch.bench import device_batch

    shape = (4, 8, 8, 3)
    x, y = device_batch(0, shape, torch.bfloat16, torch.device("cpu"))
    x2, y2 = device_batch(0, shape, torch.bfloat16, torch.device("cpu"))
    xs, ys = device_batch(1, shape, torch.float32, torch.device("cpu"),
                          lead=(3,))
    assert x.shape == shape and x.dtype == torch.bfloat16
    assert y.shape == (4,) and y.dtype == torch.float32
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert xs.shape == (3,) + shape and ys.shape == (3, 4)
    assert 0 <= float(xs.min()) and float(xs.max()) < 1
    assert float(x.max()) <= 1      # bfloat16 rounds up to 1.0
    assert torch.equal(y, y.round()) and float(y.max()) < 1000
