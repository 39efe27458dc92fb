"""Contrib layers (`incubator_mxnet_tpu/gluon/contrib/nn/`).

`SparseEmbedding` is not ported: it needs sparse storage and the
parameter-server embedding service (ROADMAP Queue A 5)."""
from .basic_layers import (  # noqa: F401
    Concurrent, HybridConcurrent, Identity, SyncBatchNorm,
    PixelShuffle1D, PixelShuffle2D, PixelShuffle3D,
)
