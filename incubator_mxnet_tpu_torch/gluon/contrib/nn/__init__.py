"""Contrib layers (`incubator_mxnet_tpu/gluon/contrib/nn/`)."""
from .basic_layers import (  # noqa: F401
    Concurrent, HybridConcurrent, Identity, SparseEmbedding, SyncBatchNorm,
    PixelShuffle1D, PixelShuffle2D, PixelShuffle3D,
)
