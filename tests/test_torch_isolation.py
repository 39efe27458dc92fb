"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package (nor `torchvision`, which the card's machine lacks), calls no
library attention, loss or compiler in place of its kernels, and never
falls back to the CPU on its own."""
import ast
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "incubator_mxnet_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu", "torchvision")


def _sources(include_smoke=True):
    paths = [os.path.join(d, f) for d, _, files in os.walk(PORT)
             for f in files if f.endswith(".py")]
    if include_smoke:
        paths.append(os.path.join(ROOT, "chip_smoke.py"))
    return sorted(paths)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    assert len(_sources()) > 10
    bad = [(os.path.relpath(p, ROOT), mod) for p in _sources()
           for mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_calls_no_library_attention_or_compiler():
    """Nor the library's loss (`cross_entropy`, `nll_loss`) where the
    softmax-xent kernels belong, nor its recurrent or CTC entry points
    (cuDNN's fused RNN through `torch._VF` or `torch.nn.LSTM` / `GRU` /
    `RNN`, `functional.ctc_loss` / `torch.ctc_loss`) where the port's
    `RNN` and `CTCLoss` ops belong. Each word is banned as a substring
    (the port's own `gluon.rnn.LSTM` and `ctc_loss` alias contain none);
    only the registry op's own name, `softmax_cross_entropy` as a whole
    token (the JAX package's op, written out in tensor ops), is taken
    out of the text first."""
    for path in _sources(include_smoke=False):
        with open(path) as f:
            text = re.sub(r"\bsoftmax_cross_entropy\b", "", f.read())
        for word in ("scaled_dot_product_attention", "torch.compile",
                     "triton", "cross_entropy", "nll_loss", "torch._VF",
                     "_VF.", "torch.nn.LSTM", "torch.nn.GRU",
                     "torch.nn.RNN", "nn.modules.rnn", "cudnn_rnn",
                     "functional.ctc_loss", "F.ctc_loss",
                     "torch.ctc_loss"):
            assert word not in text, (os.path.relpath(path, ROOT), word)


def test_importing_the_port_and_chip_smoke_loads_no_jax():
    code = ("import sys; import incubator_mxnet_tpu_torch, chip_smoke; "
            "from incubator_mxnet_tpu_torch.serving import trace; "
            "from incubator_mxnet_tpu_torch import fused, gluon, ndarray, "
            "initializer, optimizer; "
            "from incubator_mxnet_tpu_torch.gluon.model_zoo import vision; "
            "from incubator_mxnet_tpu_torch.ops import epilogue, nn; "
            "from incubator_mxnet_tpu_torch.ops.kernels import epilogue; "
            "from incubator_mxnet_tpu_torch import graphs, profiler; "
            "from incubator_mxnet_tpu_torch import autograd, context, "
            "model, random; "
            "from incubator_mxnet_tpu_torch.ndarray import legacy_io, "
            "register; "
            "from incubator_mxnet_tpu_torch.ops import random, registry, "
            "tensor; "
            "from incubator_mxnet_tpu_torch.gluon import data, loss, nn, "
            "trainer, utils; "
            "from incubator_mxnet_tpu_torch.telemetry import compilereg, "
            "distributed, exporters, names, recorder, slo, spans; "
            "from incubator_mxnet_tpu_torch.ops.nn import rnn, ctc_loss; "
            "from incubator_mxnet_tpu_torch.gluon import rnn, contrib; "
            "from incubator_mxnet_tpu_torch.gluon.rnn import rnn_cell, "
            "rnn_layer; "
            "from incubator_mxnet_tpu_torch.gluon.contrib import data, nn, "
            "rnn; "
            "from incubator_mxnet_tpu_torch.gluon.contrib.rnn import "
            "conv_rnn_cell; "
            "from incubator_mxnet_tpu_torch.contrib import text; "
            "from incubator_mxnet_tpu_torch.gluon.loss import CTCLoss; "
            "from incubator_mxnet_tpu_torch.gluon.model_zoo import "
            "model_store; "
            "from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import "
            "alexnet, densenet, inception, mobilenet, squeezenet, vgg, "
            "get_model; "
            "from incubator_mxnet_tpu_torch.profiler import set_config, "
            "set_state, dump, dumps, Domain, Task, Counter, Marker; "
            "from incubator_mxnet_tpu_torch import bench, embedding, kv, "
            "kvstore, kvstore_server, ps; "
            "from incubator_mxnet_tpu_torch.ndarray import sparse; "
            "from incubator_mxnet_tpu_torch.models import dlrm, DLRM; "
            "from incubator_mxnet_tpu_torch.gluon.contrib.nn import "
            "SparseEmbedding; "
            "from incubator_mxnet_tpu_torch.ops import contrib_ops, vision; "
            "from incubator_mxnet_tpu_torch.ndarray import contrib, image, "
            "linalg; "
            "from incubator_mxnet_tpu_torch import operator, runtime, "
            "test_utils, util; "
            "from incubator_mxnet_tpu_torch.contrib import autograd, "
            "control_flow, graph, svrg; "
            "from incubator_mxnet_tpu_torch.gluon.data.vision import "
            "datasets, transforms; "
            "from incubator_mxnet_tpu_torch.gluon import Constant; "
            "from incubator_mxnet_tpu_torch.contrib import amp, "
            "quantization; "
            "from incubator_mxnet_tpu_torch.ops import quantized; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    from incubator_mxnet_tpu_torch.models import transformer as ttfm
    from incubator_mxnet_tpu_torch.serving import ServingEngine, trace

    cfg = ttfm.TransformerConfig(vocab=16, d_model=8, n_heads=2, n_layers=1,
                                 d_ff=16, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttfm.init_params(cfg)
    params = ttfm.init_params(cfg, device="cpu")
    for call in (lambda: ttfm.generate(params, [[1, 2]], 2, cfg),
                 lambda: ttfm.init_kv_cache(cfg, 1),
                 lambda: ServingEngine(params, cfg),
                 lambda: trace.run_trace(params, cfg),
                 lambda: trace.main(["--d-model", "8", "--n-heads", "2",
                                     "--n-layers", "1", "--d-ff", "16",
                                     "--vocab", "16", "--seq", "16"]),
                 lambda: ttfm.make_train_step(cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_gluon_entry_points_default_to_cuda():
    """`net.initialize()` and `GluonTrainStep(...)` with device=None mean
    CUDA and raise without it; device="cpu" runs the plain path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch.fused import GluonTrainStep
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet18_v1(classes=4, layout="NHWC")
    loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for call in (lambda: net.initialize(tmx.init.Xavier()),
                 lambda: GluonTrainStep(net, lambda n, x, y: loss(n(x), y),
                                        tmx.optimizer.SGD())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    net.initialize(tmx.init.Xavier(), device="cpu")
    GluonTrainStep(net, lambda n, x, y: loss(n(x), y), tmx.optimizer.SGD(),
                   device="cpu")


def test_recommender_entry_points_default_to_cuda():
    """Sparse arrays, a sparse-gradient embedding, DLRM (local arm) and
    the recommender bench with no context mean the card, which raises
    without CUDA; the parameter server's store is host memory by design
    and needs none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    import numpy as np

    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import bench, gluon, nd
    from incubator_mxnet_tpu_torch.models import DLRM

    for call in (lambda: nd.sparse.zeros("row_sparse", (4, 2)),
                 lambda: nd.sparse.row_sparse_array(
                     (np.ones((1, 2), np.float32), [1]), shape=(4, 2)),
                 lambda: nd.sparse.csr_matrix(np.eye(3, dtype=np.float32)),
                 lambda: gluon.nn.Embedding(5, 2,
                                            sparse_grad=True).initialize(),
                 lambda: gluon.contrib.nn.SparseEmbedding(5, 2).initialize(),
                 lambda: DLRM([5, 6], num_dense=2, embed_dim=2).initialize(),
                 lambda: bench.recommender_main()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with tmx.cpu():
        rsp = nd.sparse.zeros("row_sparse", (4, 2))
        assert rsp.context == tmx.cpu()
    srv = tmx.ps.ParameterServer(num_workers=1, host="127.0.0.1", port=0)
    srv.shutdown()


def test_imperative_entry_points_default_to_cuda(tmp_path):
    """`gpu()`, `nd.array`, `nd.zeros`, `nd.load`, initializing a layer
    or a recurrent layer or cell, a cell's `begin_state`, a block called
    with a DataLoader batch and a `Trainer` over card parameters: no
    context means the card, which raises without CUDA; `cpu()` runs the
    plain path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    import numpy as np

    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd

    path = str(tmp_path / "x.nd")
    nd.save(path, {"x": nd.array([1.0], ctx=tmx.cpu())})
    for call in (lambda: tmx.gpu().torch_device(),
                 lambda: tmx.current_context().torch_device(),
                 lambda: nd.array([1.0, 2.0]),
                 lambda: nd.zeros((2, 3)),
                 lambda: nd.ones((2,)),
                 lambda: nd.random.uniform(shape=(2,)),
                 lambda: nd.load(path),
                 lambda: gluon.nn.Dense(2).initialize(),
                 lambda: gluon.rnn.LSTM(4).initialize(),
                 lambda: gluon.rnn.LSTMCell(4).begin_state(2),
                 lambda: gluon.contrib.rnn.LSTMPCell(4, 2).initialize()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(ValueError, match="gpu"):
        tmx.tpu()
    assert tmx.context.num_tpus() == 0 and tmx.num_gpus() == 0
    # the loader yields CPU arrays; a block on card parameters would move
    # them (counted), one on CPU parameters uses them as they are
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(
        np.ones((4, 3), np.float32), np.zeros(4, np.float32)), batch_size=2)
    x, y = next(iter(loader))
    assert x.context == tmx.cpu() and y.context == tmx.cpu()
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=tmx.cpu())
    trainer = gluon.Trainer(net.collect_params(), "sgd")
    before = gluon.block.input_copies
    with autograd.record():
        out = net(x)
    out.backward()
    trainer.step(2)
    assert gluon.block.input_copies == before
    assert out.context == tmx.cpu()
    with tmx.cpu():
        assert nd.zeros((1,)).context == tmx.cpu()
        assert nd.load(path)["x"].context == tmx.cpu()


def test_vision_entry_points_default_to_cuda():
    """The vision and contrib ops over arrays with no context, a Constant
    initialized with none and a loaded epoch mean the card, which raises
    without CUDA; the vision transforms and datasets make host arrays."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    import numpy as np

    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import gluon, nd

    rows = np.array([[[0, 0.9, 0, 0, 2, 2], [0, 0.8, 0, 0, 2, 2]]],
                    np.float32)
    for call in (lambda: nd.contrib.box_nms(rows),
                 lambda: nd.ROIPooling(np.ones((1, 1, 4, 4), np.float32),
                                       np.array([[0, 0, 0, 3, 3]],
                                                np.float32),
                                       pooled_size=2, spatial_scale=1.0),
                 lambda: gluon.Constant("c", [1.0, 2.0]).initialize(),
                 lambda: tmx.model.load_params("no_such_prefix", 0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with tmx.cpu():
        kept = nd.contrib.box_nms(nd.array(rows)).asnumpy()
    assert kept[0, 1, 0] == -1
    t = gluon.data.vision.transforms.ToTensor()(np.zeros((2, 2, 3),
                                                         np.uint8))
    assert t.context == tmx.cpu()


def test_quantized_net_and_scaler_default_to_cuda():
    """A quantized net, the int8 wire functions and the loss scaler's
    overflow check on arrays with no context mean the card, which raises
    without CUDA; with device="cpu" / cpu() they run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    import numpy as np

    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch.contrib import amp
    from incubator_mxnet_tpu_torch.contrib import quantization as q

    net = tmx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(tmx.gluon.nn.Dense(3, in_units=4))
    x = np.ones((2, 4), np.float32)
    for call in (lambda: net.initialize(),
                 lambda: q.quantize_net(net, [[x]]),
                 lambda: q.quantize(x),
                 lambda: amp.DynamicLossScaler().has_overflow([x])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    net.initialize(device="cpu")
    with tmx.cpu():
        qnet = q.quantize_net(net, [[x]])
        assert qnet.device == torch.device("cpu")
        assert qnet(x).shape == (2, 3)
        assert q.quantize(x)[0].context == tmx.cpu()
        assert not amp.DynamicLossScaler().has_overflow([x])
