"""incubator_mxnet_tpu_torch: the PyTorch/CUDA port of incubator_mxnet_tpu.

The JAX package beside it is the reference; this package holds the same
functions on PyTorch, with every TPU kernel on the ported path rewritten
by hand in CUDA for Hopper (`ops/csrc/`). Ported so far: the
continuous-batching transformer server (`models.transformer`,
`serving`), with the `paged_decode_attention`, `paged_decode_attention_wide`
and `flash_decode` kernels, behind the fault-tolerant fleet and its HTTP
gateway (`serving.FleetRouter`, `serving.ServingGateway`, with the
runtime sanitizers of `analysis` and the fault injection of
`resilience`), and the transformer's single-device train step
(`make_train_step`, `loss_fn`), whose attention with `use_flash` runs the
FlashAttention-2 forward, dQ and dK/dV kernels and whose loss with
`use_fused_xent` runs the fused softmax cross-entropy kernels, for every
`TransformerConfig` (with `n_experts`, the mixture-of-experts FFN of
`parallel`); and ResNet training through the gluon front end (`gluon`,
`fused.GluonTrainStep`, `optimizer.SGD`, `initializer`), whose
BatchNorm -> ReLU (-> add) chains with `MXTPU_FUSED_EPILOGUE` run the
fused epilogue kernels; and gluon's imperative surface: the `NDArray`
(`nd`) over the operator registry, `autograd.record` / `backward`, the
global random state (`random`), device contexts (`cpu()`, `gpu()`),
`gluon.Trainer` (with aggregated updates), `gluon.data` and the nn
layers and losses; and the training toolkit: the 16 optimizers and their
registry update ops, `lr_scheduler`, `metric`, `callback`, every
initializer and the memory and TensorBoard telemetry; and the
recommender path: row-sparse storage (`nd.sparse`) with the lazy
optimizer updates, the parameter server (`ps`, `kvstore_server`),
`kvstore` (`kv`), the sharded embedding service (`embedding`) and DLRM
(`models.DLRM`); and the vision and contrib op families (detection:
NMS, `Proposal`, `ROIPooling`, `ROIAlign`, the MultiBox ops, samplers;
`nd.contrib`, `nd.image`, `nd.linalg`), Python custom ops (`operator`),
`contrib` control flow, graph sampling and SVRG, and
`gluon.data.vision`, so the reference's loop runs as written:

    with autograd.record():
        loss = loss_fn(net(data), label)
    loss.backward()
    trainer.step(data.shape[0])

Entry points take `device=None`, meaning CUDA; without CUDA they raise
unless the caller passes `device="cpu"`, which runs each kernel's plain
PyTorch version instead.
"""
from . import (analysis, autograd, callback, config,  # noqa: F401
               context, contrib, fused, gluon, initializer, lr_scheduler,
               metric, model, models, ndarray, ops, optimizer, parallel,
               random, resilience, serving, telemetry)
from . import embedding, kvstore, kvstore_server, ps  # noqa: F401
from . import operator, runtime, test_utils, util  # noqa: F401
from .context import (Context, cpu, current_context, gpu,  # noqa: F401
                      num_gpus, tpu)
from .models import loss_fn, make_train_step  # noqa: F401
from .ndarray.ndarray import NDArray  # noqa: F401

init = initializer
nd = ndarray
kv = kvstore

__all__ = ["analysis", "autograd", "callback", "config", "context",
           "contrib", "fused", "gluon", "init", "initializer",
           "lr_scheduler", "metric", "model", "models", "nd", "ndarray",
           "ops", "optimizer", "parallel", "random", "resilience",
           "serving", "telemetry", "loss_fn", "make_train_step", "Context",
           "cpu", "gpu", "tpu", "current_context", "num_gpus", "NDArray",
           "embedding", "kv", "kvstore", "kvstore_server", "ps",
           "operator", "runtime", "test_utils", "util"]

# a process launched in the server role serves here and exits, as the
# reference's import does (kvstore_server.py:92)
kvstore_server._init_kvstore_server_module()
