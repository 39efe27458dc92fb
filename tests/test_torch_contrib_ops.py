"""The port's contrib operators (`ops/contrib_ops.py`) against the JAX
package's: one case per registry name and each extra mode (seeded inputs
of `tests/torch_op_cases.py`) through `nd.<name>` of both packages
inside `autograd.record()`, values at rtol 1e-5, atol 1e-6 and the
inputs' gradients under a seeded head gradient at rtol 1e-4, atol 1e-5
(`tests/test_torch_ndarray.py`'s tolerances), the JAX cases compiled as
one program; then `gluon.contrib.nn.SyncBatchNorm` over the registry op.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd as tag
from torch_op_cases import DETERMINISTIC, EXTRA, FAMILY, _key
from test_torch_ndarray import _parity

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


@pytest.mark.parametrize("name", [n for n in DETERMINISTIC
                                  if FAMILY[n] == "contrib"])
def test_contrib_op_matches_jax(name):
    _parity(_key(name), name, family="contrib")


@pytest.mark.parametrize("k", [k for k, (n, _) in enumerate(EXTRA)
                               if FAMILY[n] == "contrib"])
def test_contrib_op_mode_matches_jax(k):
    _parity(f"extra:{k}", family="contrib")


def test_sync_batch_norm_layer_runs_the_registry_op(monkeypatch):
    """The layer calls `_contrib_SyncBatchNorm` (the registry op) and
    matches JAX's layer: training-mode output and moving stats, then the
    predict-mode output."""
    from incubator_mxnet_tpu.gluon.contrib.nn import SyncBatchNorm as JBN
    from incubator_mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm
    from incubator_mxnet_tpu_torch.ops.registry import OP_REGISTRY

    calls = []
    op = OP_REGISTRY["_contrib_SyncBatchNorm"]
    real = op.fn
    monkeypatch.setattr(op, "fn", lambda *a, **k: calls.append(1)
                        or real(*a, **k))
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 2, 2).astype(np.float32)
    outs = []
    for mod, nd, ag, bn in ((tmx, tmx.nd, tag, SyncBatchNorm(in_channels=3)),
                            (jmx, jmx.nd, jmx.autograd,
                             JBN(in_channels=3))):
        bn.initialize(ctx=mod.cpu())
        with ag.record():
            y = bn(nd.array(x, ctx=mod.cpu()))
        stats = [bn.running_mean.data().asnumpy(),
                 bn.running_var.data().asnumpy()]
        z = bn(nd.array(x, ctx=mod.cpu()))
        outs.append([y.asnumpy()] + stats + [z.asnumpy()])
    assert calls, "the layer did not call the registry op"
    for got, want in zip(*outs):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
