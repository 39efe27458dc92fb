"""The sharded embedding tier (`incubator_mxnet_tpu/embedding.py`): tables
row-sharded over parameter-server shards, with deduplicated, bucketed,
prefetch-overlapped row pulls (ref: kvstore_dist row-sparse paths,
src/kvstore/kvstore_dist_server.h DataHandleRowSparse).

- Row sharding: global row r of every table lives only on shard server
  r % num_shards (local row r // num_shards). The servers initialize the
  rows from a deterministic spec keyed by (seed, global row id), so no
  worker materializes a shard; a worker holds only the pulled blocks
  (ledger role `embedding`), O(batch uniques).
- Deduplicated, bucketed pulls: a step's ids are made unique on the host,
  padded to the MXTPU_SPARSE_NNZ_BUCKETING grid with a sticky per-table
  bucket (each pull's signature registers with `telemetry.compilereg`
  under `embedding.pull`) and fetched with one `pull_rows_multi` RPC per
  shard server for every table. `pull_per_key` is the naive blocking
  wire (one RPC per table per shard) the recommender bench compares.
- Overlap: with MXTPU_SPARSE_PREFETCH an ordered background worker runs
  every shard RPC; gradient pushes queue behind the dense work and the
  next batch's pull behind them, so push(N) happens before pull(N+1)
  and the overlap changes the wall time, never the arithmetic. The
  blocking remainder is the `sparse_pull` stepstats phase.

Gradients: a remote `gluon.contrib.nn.SparseEmbedding` (or DLRM's arm)
marks the pulled block as an autograd variable (`lookup_block`);
`push_grads` ships the [:n_uniq] rows of its gradient to the owning
shards, whose optimizer applies them through its lazy row-sparse path
on the host.

`snapshot` writes each shard's rows as an `nd.save` file in a directory
with a sha256 manifest beside it (the JAX package writes an orbax
checkpoint there, so snapshot files do not cross packages; the tables'
deterministic init does), and `restore_shard` seeds a replacement
server from a verified snapshot.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from . import config as _config
from .analysis.sanitizers import san_lock
from .ndarray.sparse import bucket_nnz, pad_row_ids  # noqa: F401 (re-export)

__all__ = ["ShardedEmbeddingService", "RemoteEmbeddingTable",
           "launch_local_fleet", "lookup_block"]

PULL_RPCS_TOTAL = "mxtpu_embedding_pull_rpcs_total"
_PULL_RPCS_HELP = ("Row-pull RPCs issued by the sharded embedding service, "
                   "by path (batched = one multi-table RPC per server, "
                   "per_key = naive one RPC per table per server).")
PUSH_RPCS_TOTAL = "mxtpu_embedding_push_rpcs_total"
_PUSH_RPCS_HELP = ("Row-sparse grad-push RPCs issued by the sharded "
                   "embedding service, by path (batched / per_key).")
ROWS_PULLED_TOTAL = "mxtpu_embedding_rows_pulled_total"
_ROWS_HELP = ("Embedding rows fetched over the wire by the sharded "
              "embedding service (after dedup, including bucket padding).")
DEDUP_SAVED_TOTAL = "mxtpu_embedding_dedup_saved_rows_total"
_DEDUP_HELP = ("Embedding row fetches avoided by per-step id dedup: "
               "requested ids minus unique ids, summed over pulls (the "
               "zipfian dedup win in rows).")
PREFETCH_HITS_TOTAL = "mxtpu_embedding_prefetch_hits_total"
_PREFETCH_HELP = ("Embedding pulls served from a completed or in-flight "
                  "background prefetch, by outcome (ready = zero blocking, "
                  "wait = blocked on the remainder).")

# ledger role for worker-side pulled row blocks: the acceptance contract is
# live bytes O(batch uniques), never O(vocab)
LEDGER_ROLE = "embedding"


def _shard_of(ids, num_shards):
    """Route global row ids -> (shard index vector, local id vector)."""
    ids = np.asarray(ids, np.int64)
    return ids % num_shards, ids // num_shards


class _Pull:
    """A pull in flight on the worker thread (or completed inline)."""

    __slots__ = ("event", "blocks", "error", "started")

    def __init__(self):
        self.event = threading.Event()
        self.blocks = None
        self.error = None
        self.started = False


class RemoteEmbeddingTable:
    """Handle to one PS-sharded table: shape metadata + the id plan. All
    wire traffic goes through the owning service (so multi-table steps
    share one RPC per server)."""

    def __init__(self, service, name, vocab, dim, dtype):
        self.service = service
        self.name = name
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.dtype = str(dtype)

    def pull(self, raw_ids):
        """Fetch the unique rows for `raw_ids` (deduped, bucket-padded).
        Returns (rows_block np.ndarray, inv, n_uniq): block[inv[:len]]
        reconstructs the per-position rows; rows [n_uniq:] are bucket
        padding (repeats) and must never see gradient math."""
        (block,), plan = self.service.pull([(self.name, raw_ids)])
        return block, plan[0][1], plan[0][2]

    def full_table(self):
        """Gather the whole table onto THIS host (verification only —
        workers never do this on the training path; O(vocab) here by
        construction)."""
        return self.service.full_table(self.name)


class ShardedEmbeddingService:
    """Client of an embedding-shard PS fleet. Not thread-safe for
    concurrent steps; ONE training loop drives it (the background worker
    is an internal pipeline stage, not a concurrency API)."""

    def __init__(self, addrs=None, clients=None, prefetch=None):
        from .ps import PSClient

        if clients is None:
            if addrs is None:
                raw = _config.get("MXTPU_EMBEDDING_SHARDS")
                addrs = [a for a in str(raw).split(",") if a.strip()]
            if not addrs:
                raise ValueError(
                    "no embedding shards: pass addrs/clients or set "
                    "MXTPU_EMBEDDING_SHARDS=host:port,host:port,...")
            clients = []
            for addr in addrs:
                host, _, port = str(addr).strip().rpartition(":")
                clients.append(PSClient(host, int(port)))
        self._clients = list(clients)
        self._tables = {}
        self._bucket_floor = {}  # table -> sticky high-water pull bucket
        self._optimizer = None
        self._pending_grads = []   # [(name, uniq_ids, rows_nd, n_uniq)]
        self._prefetched = {}      # plan key -> _Pull
        self._prefetch_on = (_config.get("MXTPU_SPARSE_PREFETCH")
                             if prefetch is None else bool(prefetch))
        self._jobs = None
        self._worker = None
        # cross-thread error handoff: the worker WRITES under this lock,
        # the training thread's _check_worker does an atomic
        # read-and-clear under it (an unlocked swap here was the classic
        # lost-error race the lock sanitizer exists to flag)
        self._worker_error_lock = san_lock("embedding.worker_error")
        self._worker_error = None
        if self._prefetch_on:
            self._jobs = queue.Queue()
            self._worker = threading.Thread(
                target=self._worker_loop, name="mxtpu-embedding-prefetch",
                daemon=True)
            self._worker.start()

    # -- fleet ---------------------------------------------------------------
    @property
    def num_shards(self):
        return len(self._clients)

    @property
    def clients(self):
        return list(self._clients)

    def set_optimizer(self, optimizer):
        """Ship the optimizer to every shard server (server-side lazy
        sparse apply — the worker never runs the embedding update)."""
        self._optimizer = optimizer
        for c in self._clients:
            c.set_optimizer(optimizer)

    def table(self, name, vocab, dim, dtype="float32", init="uniform",
              scale=0.05, seed=0):
        """Create (or re-open) a sharded table: shard s materializes its
        local rows server-side from the deterministic spec. Idempotent —
        init_rows is first-writer-wins per server."""
        handle = self._tables.get(name)
        if handle is not None:
            return handle
        vocab, dim = int(vocab), int(dim)
        S = self.num_shards
        for s, c in enumerate(self._clients):
            local_rows = (vocab - s + S - 1) // S
            spec = (("zeros",) if init == "zeros"
                    else ("uniform", float(scale), int(seed), s, S))
            c.init_rows(name, local_rows, dim, dtype, spec)
        handle = RemoteEmbeddingTable(self, name, vocab, dim, dtype)
        self._tables[name] = handle
        return handle

    # -- pull plane ----------------------------------------------------------
    def _plan(self, requests):
        """Host-side id plan for one step's pulls: dedup each table's ids,
        pad the unique set to its nnz bucket (knob-gated), register the
        resulting shape signature with the compile registry. Returns
        [(name, inv, n_uniq, padded_uniq_ids)].

        The bucket is a STICKY per-table high-water mark: once a table
        has pulled a 32-row bucket it keeps pulling 32 even when a later
        batch's uniques fit 16. A uniq count hovering at a bucket
        boundary would otherwise flip the wire/gather shape every few
        steps — and every flip back is a retrace; padding rows are far
        cheaper than recompiles."""
        from . import telemetry as _telemetry

        plan = []
        for name, raw in requests:
            raw = np.asarray(raw, np.int64).reshape(-1)
            uniq, inv = np.unique(raw, return_inverse=True)
            padded, n_uniq = pad_row_ids(uniq)
            if _config.get("MXTPU_SPARSE_NNZ_BUCKETING"):
                floor = self._bucket_floor.get(name, 0)
                if padded.size < floor:
                    padded = np.concatenate(
                        [padded,
                         np.full(floor - padded.size, padded[-1], np.int64)])
                else:
                    self._bucket_floor[name] = padded.size
            _telemetry.inc(DEDUP_SAVED_TOTAL, raw.size - n_uniq,
                           help=_DEDUP_HELP)
            dim = self._tables[name].dim
            _telemetry.compilereg.register(
                "embedding.pull",
                (("table", name), ("block", (int(padded.size), dim)),
                 ("inv", int(raw.size))))
            plan.append((name, inv.astype(np.int64), n_uniq, padded))
        return plan

    def _rpc_pull(self, plan):
        """The wire half: ONE pull_rows_multi RPC per shard server that
        owns any requested row, covering every table in the plan."""
        from . import telemetry as _telemetry

        S = self.num_shards
        blocks = [_empty_block(p[3].size, self._tables[p[0]])
                  for p in plan]
        per_server = [([], []) for _ in range(S)]  # (names, local ids)
        slots = [[] for _ in range(S)]             # (plan idx, positions)
        for i, (name, _inv, _n, ids) in enumerate(plan):
            shard, local = _shard_of(ids, S)
            for s in range(S):
                pos = np.nonzero(shard == s)[0]
                if pos.size == 0:
                    continue
                per_server[s][0].append(name)
                per_server[s][1].append(local[pos])
                slots[s].append((i, pos))
        with _telemetry.span("embedding.pull"):
            for s in range(S):
                names, locals_ = per_server[s]
                if not names:
                    continue
                out = self._clients[s].pull_rows_multi(names, locals_)
                _telemetry.inc(PULL_RPCS_TOTAL, 1, help=_PULL_RPCS_HELP,
                               path="batched")
                for (i, pos), rows in zip(slots[s], out):
                    blocks[i][_pos(blocks[i], pos)] = rows
        _telemetry.inc(ROWS_PULLED_TOTAL,
                       sum(p[3].size for p in plan), help=_ROWS_HELP)
        return blocks

    def _plan_key(self, plan):
        return tuple((name, ids.tobytes()) for name, _i, _n, ids in plan)

    def prefetch(self, requests):
        """Enqueue the NEXT batch's pulls on the background worker: they
        run after every already-enqueued grad push (so the math matches
        the blocking path bit for bit) while the caller's dense compute
        proceeds. No-op when prefetch is off."""
        if not self._prefetch_on:
            return None
        plan = self._plan(requests)
        fut = _Pull()
        self._prefetched[self._plan_key(plan)] = fut
        self._jobs.put(("pull", plan, fut))
        return fut

    def pull(self, requests):
        """Fetch row blocks for `requests` = [(table_name, raw_ids)].
        Served from a matching prefetch when one is outstanding;
        otherwise the pull runs now — still ORDERED behind any pending
        async pushes. Blocking time lands in the sparse_pull stepstats
        phase. Returns (blocks, plan)."""
        from . import telemetry as _telemetry
        from .telemetry import stepstats as _stepstats

        self._check_worker()
        plan = self._plan(requests)
        fut = self._prefetched.pop(self._plan_key(plan), None)
        if fut is not None:
            _telemetry.inc(
                PREFETCH_HITS_TOTAL, 1, help=_PREFETCH_HELP,
                outcome="ready" if fut.event.is_set() else "wait")
            with _stepstats.phase("sparse_pull"):
                fut.event.wait()
            if fut.error is not None:
                raise fut.error
            return fut.blocks, plan
        with _stepstats.phase("sparse_pull"):
            if self._prefetch_on:
                # an unprefetched pull still queues, so it cannot overtake
                # an in-flight grad push of rows it is about to read
                fut = _Pull()
                self._jobs.put(("pull", plan, fut))
                fut.event.wait()
                if fut.error is not None:
                    raise fut.error
                return fut.blocks, plan
            return self._rpc_pull(plan), plan

    def pull_per_key(self, name, raw_ids):
        """The naive baseline the recommender bench A/Bs against: one
        BLOCKING pull_rows RPC per table per shard, no bucketing, no
        overlap (the id dedup itself is framework behavior — both paths
        share it, so weights stay comparable). Returns
        (rows_block, inv, n_uniq)."""
        from . import telemetry as _telemetry
        from .telemetry import stepstats as _stepstats

        raw = np.asarray(raw_ids, np.int64).reshape(-1)
        uniq, inv = np.unique(raw, return_inverse=True)
        _telemetry.inc(DEDUP_SAVED_TOTAL, raw.size - uniq.size,
                       help=_DEDUP_HELP)
        table = self._tables[name]
        _telemetry.compilereg.register(
            "embedding.pull",
            (("table", name), ("block", (int(uniq.size), table.dim)),
             ("inv", int(raw.size))))
        block = _empty_block(uniq.size, table)
        shard, local = _shard_of(uniq, self.num_shards)
        with _stepstats.phase("sparse_pull"), \
                _telemetry.span("embedding.pull"):
            for s in range(self.num_shards):
                pos = np.nonzero(shard == s)[0]
                if pos.size == 0:
                    continue
                block[_pos(block, pos)] = self._clients[s].pull_rows(
                    name, local[pos])
                _telemetry.inc(PULL_RPCS_TOTAL, 1, help=_PULL_RPCS_HELP,
                               path="per_key")
        _telemetry.inc(ROWS_PULLED_TOTAL, uniq.size, help=_ROWS_HELP)
        return block, inv.astype(np.int64), int(uniq.size)

    # -- push plane ----------------------------------------------------------
    def stash_grad(self, name, uniq_ids, rows_nd, n_uniq):
        """Called by SparseEmbedding's forward: remember where backward
        will deposit this block's gradient."""
        self._pending_grads.append((name, uniq_ids, rows_nd, n_uniq))

    def push_grads(self, grads=None, per_key=False):
        """Push row-sparse grads to their owning shards. Default source is
        the stashed pending set (after loss.backward()). With the worker
        on, the push enqueues and returns immediately — asynchronously
        behind the dense allreduce — and the NEXT pull queues behind it.
        `per_key` forces the naive one-RPC-per-table blocking wire."""
        if grads is None:
            grads = [(name, ids[:n], _grad_of(rows_nd, n))
                     for name, ids, rows_nd, n in self._pending_grads]
            self._pending_grads.clear()
        if not grads:
            return
        self._check_worker()
        if self._prefetch_on and not per_key:
            self._jobs.put(("push", list(grads)))
            return
        self._rpc_push(grads, per_key=per_key)

    def _rpc_push(self, grads, per_key=False):
        """One push_rows_multi RPC per shard server (or per-key blocking
        RPCs for the baseline). Rows ride the dedup envelope and epoch
        fence; the server applies them through the lazy sparse path."""
        from . import telemetry as _telemetry

        path = "per_key" if per_key else "batched"
        S = self.num_shards
        per_server = [([], [], []) for _ in range(S)]
        for name, ids, rows in grads:
            ids = np.asarray(ids, np.int64)
            if not torch.is_tensor(rows):
                rows = np.asarray(rows)
            shard, local = _shard_of(ids, S)
            for s in range(S):
                pos = np.nonzero(shard == s)[0]
                if pos.size == 0:
                    continue
                per_server[s][0].append(name)
                per_server[s][1].append(local[pos])
                per_server[s][2].append(rows[_pos(rows, pos)])
        with _telemetry.span("embedding.push"):
            for s in range(S):
                names, ids_l, rows_l = per_server[s]
                if not names:
                    continue
                if per_key:
                    for name, ids, rows in zip(names, ids_l, rows_l):
                        self._clients[s].push_rows(name, ids, rows)
                        _telemetry.inc(PUSH_RPCS_TOTAL, 1,
                                       help=_PUSH_RPCS_HELP, path=path)
                else:
                    self._clients[s].push_rows_multi(names, ids_l, rows_l)
                    _telemetry.inc(PUSH_RPCS_TOTAL, 1,
                                   help=_PUSH_RPCS_HELP, path=path)

    # -- background worker ---------------------------------------------------
    def _worker_loop(self):
        while True:
            job = self._jobs.get()
            kind = job[0]
            if kind == "stop":
                return
            try:
                if kind == "push":
                    self._rpc_push(job[1])
                else:  # pull
                    _k, plan, fut = job
                    fut.started = True
                    fut.blocks = self._rpc_pull(plan)
                    fut.event.set()
            except Exception as e:  # surfaced on the next wait/flush
                if kind == "pull":
                    job[2].error = e
                    job[2].event.set()
                else:
                    with self._worker_error_lock:
                        self._worker_error = e

    def _check_worker(self):
        with self._worker_error_lock:
            err, self._worker_error = self._worker_error, None
        if err is not None:
            raise err

    def flush(self):
        """Drain the background queue (epoch boundary / before reading
        weights): every enqueued push and prefetch has reached the
        servers when this returns."""
        if not self._prefetch_on:
            return
        done = threading.Event()
        fut = _Pull()
        fut.event = done
        self._jobs.put(("pull", [], fut))  # empty plan = queue barrier
        done.wait()
        self._check_worker()

    # -- verification / chaos ------------------------------------------------
    def full_table(self, name):
        """Reassemble a table from its shards (tests/bench only)."""
        table = self._tables[name]
        S = self.num_shards
        out = _empty_block(table.vocab, table)
        for s, c in enumerate(self._clients):
            out[s::S] = c.pull(name)
        return out

    def snapshot(self, directory):
        """Write every shard's rows to `directory`/shard-<s> (pulled
        through the manifest-verified bootstrap) with a sha256 manifest
        beside it: the source a replacement shard server restores from."""
        import os

        self.flush()
        paths = []
        for s, c in enumerate(self._clients):
            state = c.bootstrap()  # manifest-verified {key: rows}
            path = os.path.join(directory, f"shard-{s}")
            _snapshot_save(path, state)
            if not _snapshot_verify(path):
                raise RuntimeError(
                    f"embedding snapshot shard {s} failed manifest "
                    "verification")
            paths.append(path)
        return paths

    def restore_shard(self, shard, directory, client):
        """Seed a REPLACEMENT server for `shard` from a snapshot: verify
        the manifest, init every key's local rows from the restored
        bytes, re-ship the optimizer, and swap the client into the
        fleet."""
        import os

        path = os.path.join(directory, f"shard-{shard}")
        if not _snapshot_verify(path):
            raise RuntimeError(
                f"embedding snapshot shard {shard} failed manifest "
                "verification at restore")
        state = _snapshot_restore(path)
        for key, arr in state.items():
            client.init(key, arr)
        if self._optimizer is not None:
            client.set_optimizer(self._optimizer)
        old, self._clients[shard] = self._clients[shard], client
        try:
            old.close()
        except Exception:
            pass
        return state

    def close(self):
        if self._prefetch_on and self._worker is not None:
            self._jobs.put(("stop",))
            self._worker.join(timeout=10)
            self._worker = None
        for c in self._clients:
            try:
                c.close()
            except Exception:
                pass


def _grad_of(rows_nd, n_uniq):
    """The [:n_uniq] slice of a pulled block's deposited gradient, on the
    host in its dtype (bucket padding rows never reach the wire or the
    optimizer)."""
    g = getattr(rows_nd, "_grad", None)
    if g is None:
        raise RuntimeError(
            "SparseEmbedding forward ran under record() but no gradient "
            "was deposited — did loss.backward() run?")
    return g._data[:n_uniq].detach().cpu()


def _empty_block(n, table):
    """An (n, dim) host block of the table's dtype: numpy, or a torch
    tensor for a dtype numpy cannot name (bfloat16)."""
    from .ps import _dtype_by_name

    dt = _dtype_by_name(table.dtype)
    if isinstance(dt, torch.dtype):
        return torch.empty((int(n), table.dim), dtype=dt)
    return np.empty((int(n), table.dim), dt)


def _pos(block, pos):
    """Row positions indexing `block` (a torch index for a tensor)."""
    return torch.from_numpy(pos) if torch.is_tensor(block) else pos


def host_ids(ids):
    """An id batch (NDArray, tensor or array-like) as host int64, its shape
    kept."""
    if hasattr(ids, "asnumpy"):
        ids = ids.asnumpy()
    elif torch.is_tensor(ids):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids).astype(np.int64)


def lookup_block(service, name, raw, block, inv, n_uniq):
    """The forward half of a remote table's lookup: the pulled `block`
    becomes an array on the current context (ledger role `embedding`),
    marked, under `autograd.record()`, as a variable whose gradient
    `service.push_grads` ships; returns the looked-up rows, an NDArray
    of shape (len(raw), dim)."""
    from . import autograd as _ag
    from . import ndarray as nd
    from .telemetry import ledger as _ledger

    rows_nd = nd.array(block)
    if _ag.is_recording():
        _ag.mark_variables([rows_nd], [nd.zeros(
            tuple(rows_nd.shape), ctx=rows_nd.context,
            dtype=rows_nd._data.dtype)])
        service.stash_grad(name, np.unique(raw), rows_nd, n_uniq)
    _ledger.track(rows_nd._data, LEDGER_ROLE)
    ids = nd.array(np.asarray(inv, np.int64), ctx=rows_nd.context)
    return nd.Embedding(ids, rows_nd, input_dim=int(block.shape[0]),
                        output_dim=int(block.shape[1]))


# -- the snapshot files: nd.save's container and a sha256 manifest ------------

_MANIFEST_SUFFIX = ".sha256"


def _dir_manifest_entries(path):
    import hashlib
    import os

    entries = {}
    for root, _dirs, files in os.walk(path):
        for name in sorted(files):
            full = os.path.join(root, name)
            h = hashlib.sha256()
            with open(full, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            entries[os.path.relpath(full, path)] = {
                "sha256": h.hexdigest(), "size": os.path.getsize(full)}
    return entries


def _snapshot_save(path, state):
    """`state` ({table: rows}) into the directory `path` as one `nd.save`
    file, and the directory's manifest beside it."""
    import json
    import os

    from . import ndarray as nd
    from .ndarray.ndarray import NDArray

    os.makedirs(path, exist_ok=True)
    nd.save(os.path.join(path, "rows.nd"), {
        str(k): NDArray._from_data(torch.as_tensor(v) if not
                                   torch.is_tensor(v) else v)
        for k, v in state.items()})
    payload = json.dumps({"files": _dir_manifest_entries(path),
                          "version": 1}, sort_keys=True).encode("utf-8")
    tmp = path + _MANIFEST_SUFFIX + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path + _MANIFEST_SUFFIX)


def _snapshot_verify(path):
    """True iff the snapshot directory matches its manifest."""
    import json
    import os

    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return False
    try:
        with open(path + _MANIFEST_SUFFIX, "rb") as f:
            manifest = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return False
    return manifest.get("files", {}) == _dir_manifest_entries(path)


def _snapshot_restore(path):
    """{table: rows (a CPU tensor)} of a snapshot directory."""
    import os

    from . import ndarray as nd
    from .context import cpu

    loaded = nd.load(os.path.join(path, "rows.nd"), ctx=cpu())
    return {k: v._data for k, v in loaded.items()}


def launch_local_fleet(num_shards, host="127.0.0.1"):
    """In-process shard fleet for tests/bench: returns (servers, service).
    Each shard is a real ParameterServer on a real socket (num_workers=1
    — embedding pushes are async applies, never sync rendezvous)."""
    from .ps import ParameterServer, PSClient

    servers = [ParameterServer(num_workers=1, host=host, port=0)
               for _ in range(int(num_shards))]
    clients = [PSClient(host, s.port) for s in servers]
    return servers, ShardedEmbeddingService(clients=clients)
