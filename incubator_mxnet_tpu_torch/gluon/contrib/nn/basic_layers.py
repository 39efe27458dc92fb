"""Contrib basic layers
(`incubator_mxnet_tpu/gluon/contrib/nn/basic_layers.py`): `Concurrent`,
`HybridConcurrent`, `Identity`, `SparseEmbedding` (local, or a table on
a parameter-server shard fleet), `SyncBatchNorm` on one device and
`PixelShuffle{1,2,3}D`."""
from __future__ import annotations

import math

import numpy as np
import torch

from ....embedding import host_ids, lookup_block
from ...block import HybridBlock, training_mode
from ...nn.basic_layers import (BatchNorm, Embedding, HybridSequential,
                                Sequential)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class Concurrent(Sequential):
    """Run the children on the same input and concatenate their outputs
    along `axis`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as nd

        outs = [block(x) for block in self._modules.values()]
        if torch.is_tensor(outs[0]):
            return torch.cat(outs, dim=self.axis)
        return nd.concat(*outs, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """`Concurrent` over tensors."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.Concat(*[block(x) for block in self._modules.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """Returns its input."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Embedding):
    """An embedding with row-sparse gradients; given a
    `ShardedEmbeddingService`, a table that lives only on the
    parameter-server shard fleet.

    Local mode (`service=None`): `Embedding(sparse_grad=True)`.

    Remote mode (`service=` an `embedding.ShardedEmbeddingService`): no
    weight Parameter exists here. The table is registered on the fleet
    (rows hash-sharded, initialized by the servers), and each forward
    pulls only the batch's deduplicated, bucket-padded unique rows into a
    block on the current context (ledger role `embedding`), looks the
    ids up in it and, under `autograd.record()`, marks the block as a
    variable whose gradient the service pushes back row sparse.
    `per_key=True` takes the naive blocking one-RPC-per-table wire (the
    recommender bench's baseline); the arithmetic is the same."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=True, service=None,
                 table=None, scale=0.05, seed=0, per_key=False, **kwargs):
        if service is None:
            self._remote = None
            super().__init__(input_dim, output_dim, dtype=dtype,
                             weight_initializer=weight_initializer,
                             sparse_grad=sparse_grad, **kwargs)
            return
        HybridBlock.__init__(self, **kwargs)
        self._input_dim = int(input_dim)
        self._output_dim = int(output_dim)
        self._service = service
        self._per_key = bool(per_key)
        self._remote = service.table(table or self.name, input_dim,
                                     output_dim, dtype=dtype, scale=scale,
                                     seed=seed)

    def prefetch(self, x):
        """Queue the pull of ids `x` on the service's background worker
        (a no-op in local and per-key modes)."""
        if self._remote is None or self._per_key:
            return
        self._service.prefetch([(self._remote.name,
                                 host_ids(x).reshape(-1))])

    def forward(self, x, *args):
        if self._remote is None:
            return super().forward(x, *args)
        raw = host_ids(x).reshape(-1)
        if self._per_key:
            block, inv, n_uniq = self._service.pull_per_key(
                self._remote.name, raw)
        else:
            block, inv, n_uniq = self._remote.pull(raw)
        out = lookup_block(self._service, self._remote.name, raw, block,
                           inv, n_uniq)
        return out.reshape(tuple(x.shape) + (self._output_dim,))


class SyncBatchNorm(BatchNorm):
    """Cross-device batch normalization on one device: the statistics are
    the local batch's (`num_devices` 1). An `axis_name` (statistics
    averaged across the devices of a mesh axis) raises: multi-device
    waits for ROADMAP Queue A 4."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, axis_name=None, **kwargs):
        if axis_name is not None:
            raise NotImplementedError(
                f"SyncBatchNorm(axis_name={axis_name!r}): statistics across "
                "devices wait for the multi-device slice (ROADMAP Queue A 4)")
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F._contrib_SyncBatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats,
            ndev=self._num_devices or 1, _training=training_mode(self))


class _PixelShuffle(HybridBlock):
    def __init__(self, factor, ndim):
        super().__init__()
        self._factor = ((factor,) * ndim if np.isscalar(factor)
                        else tuple(factor))
        self._ndim = ndim

    def hybrid_forward(self, F, x):
        # (N, C_out * f1..fk, d1..dk) -> (N, C_out, d1 * f1, ..., dk * fk)
        f = self._factor
        n, c, spatial = x.shape[0], x.shape[1], tuple(x.shape[2:])
        c_out = c // math.prod(f)
        x = F.reshape(x, shape=(n, c_out) + f + spatial)
        perm = [0, 1]
        for i in range(self._ndim):
            perm += [2 + self._ndim + i, 2 + i]
        x = F.transpose(x, axes=tuple(perm))
        out_spatial = tuple(d * fi for d, fi in zip(spatial, f))
        return F.reshape(x, shape=(n, c_out) + out_spatial)


class PixelShuffle1D(_PixelShuffle):
    """(N, C f, W) -> (N, C, W f)."""

    def __init__(self, factor):
        super().__init__(factor, 1)


class PixelShuffle2D(_PixelShuffle):
    """(N, C f1 f2, H, W) -> (N, C, H f1, W f2)."""

    def __init__(self, factor):
        super().__init__(factor, 2)


class PixelShuffle3D(_PixelShuffle):
    """(N, C f1 f2 f3, D, H, W) -> (N, C, D f1, H f2, W f3)."""

    def __init__(self, factor):
        super().__init__(factor, 3)
