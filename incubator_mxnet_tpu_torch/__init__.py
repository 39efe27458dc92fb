"""incubator_mxnet_tpu_torch: the PyTorch/CUDA port of incubator_mxnet_tpu.

The JAX package beside it is the reference; this package holds the same
functions on PyTorch, with every TPU kernel on the ported path rewritten
by hand in CUDA for Hopper (`ops/csrc/`). Ported so far: the
continuous-batching transformer server (`models.transformer`,
`serving`), with the `paged_decode_attention`, `paged_decode_attention_wide`
and `flash_decode` kernels, and the transformer's single-device train step
(`make_train_step`, `loss_fn`), whose attention with `use_flash` runs the
FlashAttention-2 forward, dQ and dK/dV kernels.

Entry points take `device=None`, meaning CUDA; without CUDA they raise
unless the caller passes `device="cpu"`, which runs each kernel's plain
PyTorch version instead.
"""
from . import config, models, ops, serving, telemetry  # noqa: F401
from .models import loss_fn, make_train_step  # noqa: F401

__all__ = ["config", "models", "ops", "serving", "telemetry", "loss_fn",
           "make_train_step"]
