"""KVStore, the parameter synchronization API (`incubator_mxnet_tpu/kvstore.py`;
ref: include/mxnet/kvstore.h, src/kvstore/).

- `KVStore` ('local', 'device', ...): one process. `push` sums a list of
  values (row-sparse values sparsely) and runs the updater on the stored
  weight, or accumulates without one; `pull` copies the stored value
  into the outputs; `pushpull` without an updater is a merge-and-reset
  allreduce; `row_sparse_pull` gathers only the requested rows. 2-bit
  gradient compression keeps an error-feedback residual per key
  (`TwoBitCompressor`).
- `KVStoreDistAsyncServer` ('dist_async_server'): the reference's
  parameter-server semantics over `ps.ParameterServer`, which rank 0
  hosts in-process; every worker pushes gradients and pulls the weights
  the server's optimizer updated. Rank and world size come from
  `torch.distributed` when it is initialized, else 0 and 1.
- `_TcpHeartbeat`: worker heartbeats over the parameter server's control
  plane, answering `num_dead` from beat staleness.

'dist_sync', 'dist_device_sync' and 'dist_async' (collectives across
processes) are ROADMAP Queue A 4: `create` raises for them.
"""
from __future__ import annotations

import functools
import logging
import threading
import time

import numpy as np
import torch

from . import telemetry as _telemetry
from .analysis.sanitizers import san_lock
from .ndarray.ndarray import NDArray
from .ndarray.sparse import BaseSparseNDArray, RowSparseNDArray

logger = logging.getLogger(__name__)

__all__ = ["KVStore", "KVStoreDistAsyncServer", "TwoBitCompressor",
           "create", "create_kvstore_for_module"]


def _to_data(v):
    if isinstance(v, NDArray):
        return v._data
    if torch.is_tensor(v):
        return v
    return torch.as_tensor(np.asarray(v))


@torch.no_grad()
def _assign(out, value):
    """Write `value` into the array `out` (in place when the shapes
    agree, so a parameter keeps its tensor)."""
    if out._data.shape == value.shape:
        out._data.copy_(value)
    else:
        out._data = value.detach().clone().to(out._data.device)


class TwoBitCompressor:
    """2-bit gradient compression with an error-feedback residual (ref:
    src/kvstore/gradient_compression.h:37). `encode` maps each element
    of gradient + residual to {-threshold, 0, +threshold}, packs four
    codes a byte and keeps the quantization error for the next push."""

    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)
        self._residual = {}

    def _acc(self, key, grad):
        res = self._residual.get(key)
        return grad + res if res is not None else grad + 0.0

    def encode(self, key, grad):
        """grad -> (packed uint8 payload, element count); updates the
        key's residual."""
        acc = self._acc(key, grad)
        codes = torch.where(acc >= self.threshold, 1,
                            torch.where(acc <= -self.threshold, 2, 0)).to(
                                torch.uint8)
        self._residual[key] = acc - self._decode_codes(codes, acc.dtype)
        flat = codes.reshape(-1)
        pad = (-flat.numel()) % 4
        flat = torch.nn.functional.pad(flat, (0, pad))
        quads = flat.reshape(-1, 4)
        packed = (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
                  | (quads[:, 3] << 6))
        return packed, grad.numel()

    def decode(self, packed, shape):
        """The dense gradient of a packed payload."""
        n = int(np.prod(shape)) if shape else 1
        quads = torch.stack([(packed >> s) & 0x3 for s in (0, 2, 4, 6)],
                            dim=1)
        codes = quads.reshape(-1)[:n].reshape(shape)
        return self._decode_codes(codes, torch.float32)

    def _decode_codes(self, codes, dtype):
        t = torch.full(codes.shape, self.threshold, dtype=dtype,
                       device=codes.device)
        return torch.where(codes == 1, t, torch.where(codes == 2, -t, 0.0))

    def roundtrip(self, key, grad):
        """The local store's path: the same quantization and error
        feedback as a compressed push, with no wire."""
        acc = self._acc(key, grad)
        t = torch.full_like(acc, self.threshold)
        q = torch.where(acc >= self.threshold, t,
                        torch.where(acc <= -self.threshold, -t, 0.0))
        self._residual[key] = acc - q
        return q


def _make_compressor(params):
    if params is None:
        return None
    if params.get("type") == "2bit":
        return TwoBitCompressor(float(params.get("threshold", 0.5)))
    raise ValueError(f"unsupported gradient compression {params!r}")


class KVStore:
    """The single-process store (ref: kvstore_local.h / comm.h)."""

    supports_bucketed_allreduce = True

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compression = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        pass

    @property
    def num_dead_node(self):
        return 0

    def set_gradient_compression(self, compression_params):
        self._compression = _make_compressor(dict(compression_params))

    def init(self, key, value):
        """(ref: KVStore::Init) — the store keeps its own copy."""
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        v = value[0] if isinstance(value, (list, tuple)) else value
        self._store[key] = NDArray._from_data(_to_data(v).detach().clone())
        _telemetry.ledger.track(self._store[key]._data, "kv_buffers")

    def _reduce(self, value):
        """The sum of a list of values: row-sparse values reduce sparsely
        and stay sparse for the updater. Returns a sparse array or a
        tensor."""
        from .ndarray.sparse import add_n

        if not isinstance(value, (list, tuple)):
            return value if isinstance(value, BaseSparseNDArray) \
                else _to_data(value)
        if any(isinstance(v, BaseSparseNDArray) for v in value):
            r = add_n(*value)
            return r if isinstance(r, BaseSparseNDArray) else r._data
        acc = _to_data(value[0])
        for v in value[1:]:
            acc = acc + _to_data(v)
        return acc

    def _apply_sparse_push(self, key, grad):
        """A sparse gradient reaches the updater sparse (its lazy paths);
        compression does not apply."""
        if self._updater is not None:
            self._updater(key, grad, self._store[key])
        elif key in self._store:
            s = self._store[key]
            s._data = s._data + grad.todense()._data.to(s._data.device)
        else:
            self._store[key] = grad.todense()

    def _apply_dense(self, key, grad):
        if self._updater is not None:
            self._updater(key, NDArray._from_data(grad), self._store[key])
        elif key in self._store:
            s = self._store[key]
            s._data = s._data + grad.to(s._data.device)
        else:
            self._store[key] = NDArray._from_data(grad)

    def push(self, key, value, priority=0):
        """(ref: KVStore::Push) — reduce, then update or accumulate."""
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.push(k, v, priority)
            return
        grad = self._reduce(value)
        if isinstance(grad, BaseSparseNDArray):
            self._apply_sparse_push(key, grad)
            return
        if self._compression is not None:
            grad = self._compression.roundtrip(key, grad)
        self._apply_dense(key, grad)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """(ref: KVStore::Pull) — the stored value into each output."""
        if isinstance(key, (list, tuple)):
            for k, o in zip(key, out):
                self.pull(k, o, priority)
            return
        src = self._store[key]
        for o in out if isinstance(out, (list, tuple)) else [out]:
            if o is not None:
                _assign(o, src._data)
        return src

    def pushpull(self, key, value, out=None, priority=0):
        if isinstance(key, (list, tuple)):
            outs = out if isinstance(out, (list, tuple)) else \
                [out] * len(key)
            for k, v, o in zip(key, value, outs):
                self.pushpull(k, v, o, priority)
            return
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)
            if self._updater is None:
                # allreduce: the accumulator resets after the pull
                del self._store[key]

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """(ref: KVStore::PullRowSparse) — only the requested rows."""
        src = self._store[key]._data
        rid = row_ids[0] if isinstance(row_ids, (list, tuple)) else row_ids
        idx = _to_data(rid).to(device=src.device, dtype=torch.int64)
        rows = src[idx]
        for o in out if isinstance(out, (list, tuple)) else [out]:
            if isinstance(o, RowSparseNDArray):
                o.data._data = rows
                o.indices._data = idx
            else:
                full = torch.zeros_like(src)
                full[idx] = rows
                _assign(o, full)
        return out

    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """The optimizer becomes the store's updater."""
        from . import optimizer as opt

        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def _dist_rank_world():
    """(rank, world size) of torch.distributed when it is initialized,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class KVStoreDistAsyncServer(KVStore):
    """'dist_async_server': a server (a host thread at rank 0) owns the
    weights and applies each worker's update the instant its push
    arrives (ref: kvstore_dist_server.h:348-358)."""

    supports_bucketed_allreduce = False
    supports_hierarchical_pushpull = True

    def __init__(self, kv_type="dist_async_server"):
        super().__init__(kv_type)
        from . import config as _config
        from . import ps as _ps

        self._rank, self._world = _dist_rank_world()
        host, port = _ps.default_server_addr()
        self._server = None
        if self.rank == 0:
            self._server = _ps.ParameterServer(self.num_workers, host=host,
                                               port=port)
            port = self._server.port
            host = self._server.host
        self._client = _ps.PSClient(host, port)
        self._shapes = {}
        self._member = self._client.join(self.rank)
        self._hb_stop = threading.Event()
        self._hb_client = None
        self._left = False
        if self.num_workers > 1:
            # beats ride a client of their own: the main one serializes
            # request/response and would hold a beat behind a blocked
            # rendezvous
            self._hb_client = _ps.PSClient(host, port,
                                           instance=f"hb{self.rank}")
            interval = _config.get("MXTPU_HEARTBEAT_INTERVAL")
            self._hb_client.heartbeat(self.rank)

            def _beat_loop():
                while not self._hb_stop.wait(interval):
                    try:
                        self._hb_client.heartbeat(self.rank)
                    except (ConnectionError, OSError, RuntimeError):
                        pass

            threading.Thread(target=_beat_loop, daemon=True,
                             name=f"mxtpu-ps-beat-r{self.rank}").start()

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._world

    def barrier(self):
        from . import ps as _ps

        try:
            self._client.barrier()
        except _ps.StaleEpochError:
            self.refresh_membership()
            self._client.barrier()

    def refresh_membership(self):
        """Re-read {epoch, num_workers, quorum} after a membership
        change."""
        info = self._client.membership()
        logger.info("dist_async_server r%d: membership epoch %s, world %s",
                    self.rank, info["epoch"], info["num_workers"])
        return info

    def init(self, key, value):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        v = value[0] if isinstance(value, (list, tuple)) else value
        t = _to_data(v)
        self._shapes[key] = tuple(t.shape)
        if self.rank == 0:
            self._client.init(key, t.detach().cpu())
        self._client.barrier()

    def set_optimizer(self, optimizer):
        """Ship the optimizer to the server (ref: CommandType::kController)."""
        self._optimizer = optimizer
        if self.rank == 0:
            self._client.set_optimizer(optimizer)
        self._client.barrier()

    def set_updater(self, updater):
        raise NotImplementedError(
            "dist_async_server applies updates server-side; use "
            "set_optimizer")

    def set_gradient_compression(self, compression_params):
        """The worker sends the packed 2-bit payload and the server
        decodes it."""
        super().set_gradient_compression(compression_params)
        if self.rank == 0:
            self._client.set_compression(dict(compression_params))
        self._client.barrier()

    def set_optimizer_attrs(self, attrs):
        """Live optimizer changes (lr, rescale_grad) on the server's copy;
        its state survives."""
        if self.rank == 0:
            self._client.set_optimizer_attrs(dict(attrs))
        self._client.barrier()

    def push(self, key, value, priority=0):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.push(k, v, priority)
            return
        grad = self._reduce(value)
        if isinstance(grad, BaseSparseNDArray):
            if not isinstance(grad, RowSparseNDArray):
                grad = grad.tostype("row_sparse")
            # only the occupied rows cross the wire, applied lazily there
            self._client.push_rows(key, grad.indices._data.cpu(),
                                   grad.data._data.detach().cpu())
            return
        if self._compression is not None:
            payload, _n = self._compression.encode(key, grad)
            self._client.push_compressed(key, payload.cpu(),
                                         tuple(grad.shape))
            return
        self._client.push(key, grad.detach().cpu(), sync=False)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if isinstance(key, (list, tuple)):
            for k, o in zip(key, out):
                self.pull(k, o, priority)
            return
        val = _to_data(self._client.pull(key))
        for o in out if isinstance(out, (list, tuple)) else [out]:
            if o is not None:
                _assign(o, val.to(o._data.device))
        return NDArray._from_data(val)

    def pushpull(self, key, value, out=None, priority=0):
        if isinstance(key, (list, tuple)):
            outs = out if isinstance(out, (list, tuple)) else \
                [out] * len(key)
            if self._hierarchical_ok(value):
                self._pushpull_hierarchical(list(key), list(value),
                                            list(outs))
                return
            for k, v, o in zip(key, value, outs):
                self.pushpull(k, v, o, priority)
            return
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def _hierarchical_ok(self, values):
        """Dense, uncompressed list pushes batch into push_many buckets;
        sparse and compressed gradients keep their own wire formats."""
        from . import config as _config

        if self._compression is not None:
            return False
        if _config.get("MXTPU_PS_BUCKET_KB") <= 0:
            return False
        for v in values:
            vs = v if isinstance(v, (list, tuple)) else [v]
            if any(isinstance(x, BaseSparseNDArray) for x in vs):
                return False
        return True

    def _pushpull_hierarchical(self, keys, values, outs):
        """One push_many / pull_many RPC pair per byte-capped bucket; the
        server applies each key through the same optimizer path, so the
        weights equal the per-key path's."""
        from . import config as _config

        cap = _config.get("MXTPU_PS_BUCKET_KB") * 1024
        grads = [_to_data(self._reduce(v)).detach().cpu() for v in values]
        buckets, cur, cur_bytes = [], [], 0
        for i, g in enumerate(grads):
            nb = g.numel() * g.element_size()
            if cur and cur_bytes + nb > cap:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nb
        if cur:
            buckets.append(cur)
        for bucket in buckets:
            bkeys = [keys[i] for i in bucket]
            self._client.push_many(bkeys, [grads[i] for i in bucket],
                                   sync=False)
            vals = self._client.pull_many(bkeys)
            for i, val in zip(bucket, vals):
                o = outs[i]
                for oo in o if isinstance(o, (list, tuple)) else [o]:
                    if oo is not None:
                        _assign(oo, _to_data(val).to(oo._data.device))
        _telemetry.inc(_KV_BYTES, int(sum(g.numel() * g.element_size()
                                          for g in grads)),
                       help="Payload bytes through kvstore push/pull.",
                       op="pushpull_hierarchical", store=self.type)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Only the requested rows cross the wire, deduplicated and
        bucket-padded to the MXTPU_SPARSE_NNZ_BUCKETING grid."""
        from .ndarray.sparse import pad_row_ids

        rid = row_ids[0] if isinstance(row_ids, (list, tuple)) else row_ids
        idx = _to_data(rid).detach().cpu().numpy().astype(np.int64)
        uniq, inv = np.unique(idx, return_inverse=True)
        wire, _n = pad_row_ids(uniq)
        block = _to_data(self._client.pull_rows(key, wire))
        rows = block[torch.from_numpy(inv.reshape(-1))]
        idx_t = torch.from_numpy(idx.reshape(-1))
        for o in out if isinstance(out, (list, tuple)) else [out]:
            if isinstance(o, RowSparseNDArray):
                dev = o.data._data.device
                o.data._data = rows.to(dev)
                o.indices._data = idx_t.to(dev)
            else:
                full = torch.zeros(self._shapes[key], dtype=rows.dtype)
                full[idx_t] = rows
                _assign(o, full.to(o._data.device))
        return out

    def sync_all(self, alpha=1.0):
        """The server's weights are authoritative: nothing to reconcile."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The optimizer state lives on the server: fetch it."""
        from . import resilience as _resilience

        blob = self._client.get_optimizer_states(dump_optimizer)
        _resilience.atomic_write_bytes(fname, blob, site="ckpt.states")

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            blob = f.read()
        if self.rank == 0:
            self._client.set_optimizer_states(blob)
        self._client.barrier()

    def leave(self):
        """Graceful departure: stop beating and tell the server, so the
        survivors' quorum shrinks now. Idempotent."""
        if self._left:
            return
        self._left = True
        self._hb_stop.set()
        try:
            self._client.leave(self.rank)
        except (ConnectionError, OSError, RuntimeError) as e:
            logger.warning("dist_async_server r%d: graceful leave failed "
                           "(%s: %s); survivors will evict by heartbeat",
                           self.rank, type(e).__name__, e)

    def close(self):
        self._hb_stop.set()
        if not self._left:
            try:
                self.barrier()
            except (ConnectionError, OSError, RuntimeError) as e:
                logger.warning("dist_async_server close: farewell barrier "
                               "failed (%s: %s); shutting down anyway",
                               type(e).__name__, e)
        if self._server is not None:
            self._server.shutdown()
        if self._hb_client is not None:
            self._hb_client.close()
        self._client.close()
        if not self._left and self.num_workers > 1:
            import torch.distributed as dist
            dist.barrier()


# -- telemetry: latency and bytes per scalar-key push / pull --------------------

_KV_SECONDS = "mxtpu_kvstore_seconds"
_KV_BYTES = "mxtpu_kvstore_bytes_total"


def _payload_nbytes(value):
    """Bytes of an NDArray / sparse NDArray / tensor payload (or a list of
    them)."""
    total = 0
    for v in value if isinstance(value, (list, tuple)) else [value]:
        if v is None:
            continue
        if isinstance(v, BaseSparseNDArray):
            total += _payload_nbytes([v.data, v.indices,
                                      getattr(v, "indptr", None)])
            continue
        data = getattr(v, "_data", v)
        if torch.is_tensor(data):
            total += int(data.numel() * data.element_size())
        elif hasattr(data, "nbytes"):
            total += int(data.nbytes)
    return total


def _instrument_kv(op, method):
    @functools.wraps(method)
    def wrapped(self, key, *args, **kwargs):
        if not _telemetry.enabled() or isinstance(key, (list, tuple)):
            return method(self, key, *args, **kwargs)
        t0 = time.perf_counter()
        try:
            return method(self, key, *args, **kwargs)
        finally:
            _telemetry.observe(
                _KV_SECONDS, time.perf_counter() - t0,
                help="Latency of scalar-key kvstore operations.",
                op=op, store=self.type)
            payload = kwargs.get("value" if op == "push" else "out",
                                 args[0] if args else None)
            nbytes = _payload_nbytes(payload)
            if nbytes:
                _telemetry.inc(
                    _KV_BYTES, nbytes,
                    help="Payload bytes through kvstore push/pull.",
                    op=op, store=self.type)
    return wrapped


for _cls in (KVStore, KVStoreDistAsyncServer):
    for _op in ("push", "pull"):
        if _op in _cls.__dict__:
            setattr(_cls, _op, _instrument_kv(_op, _cls.__dict__[_op]))
del _cls, _op


class _TcpHeartbeat:
    """Worker heartbeats for dead-node detection over the parameter
    server's control plane (ref: ps-lite Heartbeat/GetDeadNodes): rank 0
    hosts a ParameterServer, every worker beats its rank from a daemon
    thread, and `num_dead` is answered by the server from beat
    staleness."""

    _singleton = None
    _singleton_lock = san_lock("kvstore.hb_singleton")

    def __init__(self, rank, num_workers, host, port, interval, timeout):
        from . import ps as _ps

        self.rank = rank
        self.timeout = timeout
        self._created = time.time()
        self._server = None
        if rank == 0:
            self._server = _ps.ParameterServer(num_workers, host=host,
                                               port=port)
            port = self._server.port
            host = self._server.host
        self._client = _ps.PSClient(host, port, instance=f"hb{rank}")
        self._client.heartbeat(rank)
        self._stop = threading.Event()
        self._interval = interval
        threading.Thread(target=self._loop, daemon=True,
                         name="mxtpu-heartbeat").start()

    @classmethod
    def get(cls, rank, num_workers, host, port, interval, timeout):
        """One heartbeat service per process."""
        with cls._singleton_lock:
            if cls._singleton is None:
                cls._singleton = cls(rank, num_workers, host, port,
                                     interval, timeout)
            return cls._singleton

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                self._client.heartbeat(self.rank)
            except (ConnectionError, OSError, RuntimeError):
                pass

    def num_dead(self):
        # never-seen peers count as dead only once this observer's own
        # startup grace has passed
        grace = time.time() - self._created > self.timeout
        try:
            return int(self._client.num_dead(self.rank, self.timeout,
                                             grace))
        except (ConnectionError, OSError, RuntimeError):
            return 1

    def stop(self):
        """Stop beating and close the client (and rank 0's server)."""
        self._stop.set()
        self._client.close()
        if self._server is not None:
            self._server.shutdown()


def create(name="local"):
    """(ref: KVStore::Create src/kvstore/kvstore.cc:40)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name == "dist_async_server":
        return KVStoreDistAsyncServer(name)
    if "dist" in name:
        raise NotImplementedError(
            f"kvstore {name!r}: collective kvstores across processes are "
            "not ported yet (ROADMAP Queue A 4); 'dist_async_server' is")
    return KVStore(name)


def create_kvstore_for_module(kvstore, num_device, arg_params):
    """(ref: model.py:82 _create_kvstore) -> (kvstore or None,
    update_on_kvstore)."""
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        kv = None if num_device == 1 and "dist" not in kvstore \
            else create(kvstore)
    else:
        raise TypeError(f"bad kvstore type {type(kvstore)}")
    if kv is None:
        return None, False
    if isinstance(kv, KVStoreDistAsyncServer):
        return kv, True
    return kv, "dist" not in kv.type
