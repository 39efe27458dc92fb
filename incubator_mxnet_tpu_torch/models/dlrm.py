"""DLRM, the recommender (`incubator_mxnet_tpu/models/dlrm.py`): a dense
MLP tower, one embedding table per categorical field and the pairwise
feature interaction.

The sparse arm either lives on a PS-row-sharded service
(`embedding.ShardedEmbeddingService`, `_SparseArm`: one step pulls every
field's deduplicated, bucket-padded rows with one multi-table RPC per
shard server, or one RPC per table per shard with `per_key=True`) or,
with `service=None`, in local `SparseEmbedding` tables whose gradients
are row sparse (`_LocalArm`). The forward runs on the NDArrays' device;
the tables of the local arm live where `initialize` puts them.
"""
from __future__ import annotations

import numpy as np

from .. import ndarray as nd
from ..embedding import host_ids, lookup_block
from ..gluon import nn
from ..gluon.block import Block
from ..gluon.contrib.nn import SparseEmbedding

__all__ = ["DLRM"]


class _SparseArm(Block):
    """F per-field tables on one service; forward turns an id batch
    (B, F) into field embeddings (B, F, E) with ONE multi-table pull."""

    def __init__(self, service, field_vocabs, dim, table_prefix, scale,
                 seed, per_key, **kwargs):
        super().__init__(**kwargs)
        self._service = service
        self._dim = int(dim)
        self._per_key = bool(per_key)
        self._tables = [
            service.table(f"{table_prefix}f{i}", v, dim, scale=scale,
                          seed=seed + i)
            for i, v in enumerate(field_vocabs)]

    def _requests(self, ids):
        ids = np.asarray(ids, np.int64)
        return [(t.name, ids[:, i]) for i, t in enumerate(self._tables)]

    def prefetch(self, ids):
        if not self._per_key:
            self._service.prefetch(self._requests(ids))

    def forward(self, ids):

        ids = host_ids(ids)
        b = ids.shape[0]
        requests = self._requests(ids)
        if self._per_key:
            pulled = [self._service.pull_per_key(name, raw)
                      for name, raw in requests]
        else:
            blocks, plan = self._service.pull(requests)
            pulled = [(blk, inv, n)
                      for blk, (_name, inv, n, _ids) in zip(blocks, plan)]
        outs = []
        for (name, raw), (block, inv, n_uniq) in zip(requests, pulled):
            out = lookup_block(self._service, name, raw, block, inv, n_uniq)
            outs.append(out.reshape((b, 1, self._dim)))
        return nd.concat(*outs, dim=1)


class _LocalArm(Block):
    """service=None fallback: per-field local sparse-grad embeddings."""

    def __init__(self, field_vocabs, dim, **kwargs):
        super().__init__(**kwargs)
        self._dim = int(dim)
        with self.name_scope():
            for i, v in enumerate(field_vocabs):
                self.register_child(SparseEmbedding(v, dim), f"f{i}")

    def prefetch(self, ids):
        pass

    def forward(self, ids):
        if not hasattr(ids, "asnumpy"):
            ids = nd.array(host_ids(ids))
        b = int(ids.shape[0])
        outs = [emb(ids[:, i]).reshape((b, 1, self._dim))
                for i, emb in enumerate(self._modules.values())]
        return nd.concat(*outs, dim=1)


class DLRM(Block):
    """`forward(dense_x, sparse_ids)` -> logits (B, 1).

    dense_x: (B, num_dense) float features -> bottom MLP -> (B, embed_dim).
    sparse_ids: (B, num_fields) int ids, field f in [0, field_vocabs[f]).
    Interaction: the bottom output joins the field embeddings as an extra
    "field" and all pairwise dot products (flattened (F+1)^2 Gram matrix)
    concat with the bottom output into the top MLP.
    """

    def __init__(self, field_vocabs, num_dense=4, embed_dim=8,
                 bottom_units=(32, 16), top_units=(32, 16), service=None,
                 per_key=False, table_prefix="dlrm_", scale=0.05, seed=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.field_vocabs = tuple(int(v) for v in field_vocabs)
        self.num_fields = len(self.field_vocabs)
        self.embed_dim = int(embed_dim)
        with self.name_scope():
            if service is not None:
                self.sparse_arm = _SparseArm(
                    service, self.field_vocabs, embed_dim, table_prefix,
                    scale, seed, per_key)
            else:
                self.sparse_arm = _LocalArm(self.field_vocabs, embed_dim)
            self.bottom = nn.HybridSequential()
            for u in bottom_units:
                self.bottom.add(nn.Dense(u, activation="relu"))
            # the bottom tower must land in embedding space to join the
            # interaction as an extra field
            self.bottom.add(nn.Dense(self.embed_dim, activation="relu"))
            self.top = nn.HybridSequential()
            for u in top_units:
                self.top.add(nn.Dense(u, activation="relu"))
            self.top.add(nn.Dense(1))

    def prefetch(self, sparse_ids):
        """Queue the next batch's row pulls on the service's background
        worker (a no-op in local and per-key modes)."""
        self.sparse_arm.prefetch(host_ids(sparse_ids))

    def forward(self, dense_x, sparse_ids):
        emb = self.sparse_arm(sparse_ids)             # (B, F, E)
        bot = self.bottom(dense_x)                    # (B, E)
        b = int(emb.shape[0])
        z = nd.concat(bot.reshape((b, 1, self.embed_dim)), emb, dim=1)
        gram = nd.batch_dot(z, z, transpose_b=True)   # (B, F+1, F+1)
        feats = nd.concat(bot, gram.reshape((b, -1)), dim=1)
        return self.top(feats)
