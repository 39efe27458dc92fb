"""incubator_mxnet_tpu_torch: the PyTorch/CUDA port of incubator_mxnet_tpu.

The JAX package beside it is the reference; this package holds the same
functions on PyTorch, with every TPU kernel on the ported path rewritten
by hand in CUDA for Hopper (`ops/csrc/`). Ported so far: the
continuous-batching transformer server (`models.transformer`,
`serving`), with the `paged_decode_attention`, `paged_decode_attention_wide`
and `flash_decode` kernels, and the transformer's single-device train step
(`make_train_step`, `loss_fn`), whose attention with `use_flash` runs the
FlashAttention-2 forward, dQ and dK/dV kernels and whose loss with
`use_fused_xent` runs the fused softmax cross-entropy kernels, for every
`TransformerConfig` (with `n_experts`, the mixture-of-experts FFN of
`parallel`); and ResNet training through the gluon front end (`gluon`,
`fused.GluonTrainStep`, `optimizer.SGD`, `initializer`), whose
BatchNorm -> ReLU (-> add) chains with `MXTPU_FUSED_EPILOGUE` run the
fused epilogue kernels.

Entry points take `device=None`, meaning CUDA; without CUDA they raise
unless the caller passes `device="cpu"`, which runs each kernel's plain
PyTorch version instead.
"""
from . import (config, fused, gluon, initializer, models, ndarray,  # noqa: F401
               ops, optimizer, parallel, serving, telemetry)
from .models import loss_fn, make_train_step  # noqa: F401

init = initializer

__all__ = ["config", "fused", "gluon", "init", "initializer", "models",
           "ndarray", "ops", "optimizer", "parallel", "serving",
           "telemetry", "loss_fn", "make_train_step"]
