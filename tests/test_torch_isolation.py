"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, calls no library attention, loss or compiler in place of its
kernels, and never falls back to the CPU on its own."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "incubator_mxnet_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu")


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
    softmax-xent kernels belong."""
    for path in _sources(include_smoke=False):
        with open(path) as f:
            text = f.read()
        for word in ("scaled_dot_product_attention", "torch.compile",
                     "triton", "cross_entropy", "nll_loss"):
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
            "from incubator_mxnet_tpu_torch.telemetry import compilereg, "
            "distributed, exporters, names, recorder, slo, spans; "
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
