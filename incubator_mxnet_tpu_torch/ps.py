"""The parameter server behind `dist_async_server` and the sharded
embedding service (`incubator_mxnet_tpu/ps.py`; ref:
src/kvstore/kvstore_dist_server.h KVStoreDistServer: the async path
applies an update the moment a push arrives, the sync path aggregates
num_workers contributions before one update, workers ship the optimizer
to the server (CommandType::kController) and row-sparse pulls are served
row by row).

`ParameterServer` is host code: one handler thread per worker
connection, per-key locks, weights as CPU tensors. Its updater runs on
those tensors in place, so a lazy row-sparse update touches only the
pushed rows and nothing crosses to the card. `PSClient` speaks the JAX
package's length-prefixed wire, frame for frame: the closed
tag-length-value codec (never pickle, except the HMAC'd optimizer blob),
the ("mut", client_id, seq, ...) envelope the server deduplicates, the
("trc", ...) tracing wrapper. A port client talks to a JAX server and a
JAX client to a port server.

The codec names dtypes, as the reference's does ('float32',
'bfloat16'). numpy has no bfloat16 without `ml_dtypes`, so a bfloat16
array crosses as a torch tensor: encoded from its bits, decoded into a
`torch.bfloat16` tensor; every other dtype decodes to numpy. Reconnects
ride `resilience.RetryPolicy`; locks are the sanitizers' `san_lock` /
`san_condition`.
"""
from __future__ import annotations

import collections
import hashlib
import hmac
import itertools
import logging
import os
import pickle
import secrets
import socket
import struct
import threading
import time
import zlib

import numpy as np
import torch

from .analysis.sanitizers import san_condition, san_lock

logger = logging.getLogger(__name__)

__all__ = ["ParameterServer", "PSClient", "default_server_addr",
           "StaleEpochError", "JoinRejectedError"]

_RECONNECT_METRIC = "mxtpu_ps_reconnects_total"
_RECONNECT_HELP = ("PSClient transparent reconnects after a mid-frame "
                   "socket error, by cause.")
_DEDUP_METRIC = "mxtpu_ps_dedup_hits_total"
_DEDUP_HELP = ("Retried mutating RPCs the ParameterServer suppressed via "
               "the per-client dedup window, by command.")
_EVICT_METRIC = "mxtpu_ps_evictions_total"
_EVICT_HELP = ("Workers evicted from the barrier/sync quorum after "
               "heartbeat staleness (dist graceful degradation).")
_JOIN_METRIC = "mxtpu_ps_joins_total"
_JOIN_HELP = ("Join RPCs the ParameterServer accepted, by outcome "
              "(registered / readmitted / pending).")
_READMIT_METRIC = "mxtpu_ps_readmissions_total"
_READMIT_HELP = ("Evicted ranks re-admitted to the quorum, via a fresh "
                 "heartbeat or a join RPC (elastic membership).")
_STALE_METRIC = "mxtpu_ps_stale_epoch_rejections_total"
_STALE_HELP = ("Sync contributions rejected for carrying a stale "
               "membership epoch, by command.")
_LEAVE_METRIC = "mxtpu_ps_leaves_total"
_LEAVE_HELP = ("Ranks that left the sync quorum via the graceful-leave "
               "RPC (preemption drain) — the quorum shrinks immediately, "
               "without waiting for a heartbeat timeout.")
_EPOCH_METRIC = "mxtpu_ps_membership_epoch"
_EPOCH_HELP = ("Current membership epoch of the ParameterServer; bumps on "
               "every membership change (readmission, rank takeover, "
               "world growth).")

# wire/socket errors after which a frame exchange cannot be trusted; the
# client closes and redials rather than reuse the poisoned socket
_WIRE_ERRORS = (OSError, EOFError, struct.error)


class StaleEpochError(RuntimeError):
    """A sync push/barrier carried a membership epoch older than the
    server's: the sender missed a membership change (join, readmission,
    takeover) and must refresh via PSClient.membership() before it may
    contribute again. Raised instead of silently merging the stale
    contribution, which would skew the synchronous gradient math."""


class JoinRejectedError(RuntimeError):
    """The server cannot admit this rank right now (the elastic world is
    at its MXTPU_MAX_WORKERS cap); the joiner backs off under its
    RetryPolicy and retries."""


# server-side errors cross the wire as "ClassName: message"; these names
# re-raise as their class on the client so callers can catch the protocol
# condition rather than parse a RuntimeError string
_ERR_CLASSES = {"StaleEpochError": StaleEpochError,
                "JoinRejectedError": JoinRejectedError}

# commands that ride the control plane every couple of seconds (the
# heartbeat thread) — never spanned/traced, they would drown the timeline
_UNTRACED_COMMANDS = frozenset({"heartbeat", "num_dead"})

_LEN = struct.Struct(">Q")
_U32 = struct.Struct(">I")
_F64 = struct.Struct(">d")

# ---------------------------------------------------------------------------
# Wire codec. The data plane (keys, tensors, shapes, attr dicts) crosses the
# socket in a closed tag-length-value format — NEVER pickle, so a host that
# can reach the port cannot execute code by connecting (the reference's
# ps-lite likewise shipped raw tensor bytes). The ONE pickle on the wire is
# the optimizer blob (ref: CommandType::kController ships a serialized
# optimizer); it travels as opaque bytes and is HMAC-authenticated with the
# job secret before either side unpickles it.
# ---------------------------------------------------------------------------


def _enc(obj, out):
    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, (int, np.integer)):
        b = str(int(obj)).encode("ascii")
        out.append(b"I" + _U32.pack(len(b)) + b)
    elif isinstance(obj, (float, np.floating)):
        out.append(b"f" + _F64.pack(float(obj)))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(b"S" + _U32.pack(len(b)) + b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(b"B" + _U32.pack(len(b)) + b)
    elif torch.is_tensor(obj):
        a = obj.detach().cpu().contiguous()
        dt = _dtype_name(a).encode("ascii")
        out.append(b"A" + _U32.pack(len(dt)) + dt + _U32.pack(a.dim()))
        for d in a.shape:
            out.append(_LEN.pack(d))
        raw = _raw(a)
        out.append(_LEN.pack(len(raw)) + raw)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise TypeError("object arrays cannot cross the PS wire")
        a = np.ascontiguousarray(obj)
        # dtype travels by NAME ('float32', 'bfloat16', ...) — .str would
        # collapse extension dtypes like ml_dtypes.bfloat16 to raw-void
        # '<V2' and silently corrupt them on decode
        if a.dtype.kind == "V" and a.dtype.name.startswith("void"):
            raise TypeError(f"dtype {a.dtype} cannot cross the PS wire")
        dt = a.dtype.name.encode("ascii")
        out.append(b"A" + _U32.pack(len(dt)) + dt + _U32.pack(a.ndim))
        for d in a.shape:
            out.append(_LEN.pack(d))
        raw = a.tobytes()
        out.append(_LEN.pack(len(raw)) + raw)
    elif isinstance(obj, (list, tuple)):
        out.append(b"L" + _U32.pack(len(obj)))
        for item in obj:
            _enc(item, out)
    elif isinstance(obj, dict):
        out.append(b"D" + _U32.pack(len(obj)))
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    else:
        raise TypeError(
            f"{type(obj).__name__} cannot cross the PS wire; allowed: "
            "None/bool/int/float/str/bytes/ndarray/tensor/list/dict")


def _dec(buf, pos):
    tag = buf[pos:pos + 1]
    pos += 1
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"I":
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        return int(buf[pos:pos + n]), pos + n
    if tag == b"f":
        (v,) = _F64.unpack_from(buf, pos)
        return v, pos + 8
    if tag == b"S":
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if tag == b"B":
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        return bytes(buf[pos:pos + n]), pos + n
    if tag == b"A":
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        dtype = _dtype_by_name(buf[pos:pos + n].decode("ascii"))
        pos += n
        if isinstance(dtype, np.dtype) and dtype.hasobject:
            raise ValueError("object arrays cannot cross the PS wire")
        (ndim,) = _U32.unpack_from(buf, pos)
        pos += 4
        shape = []
        for _ in range(ndim):
            (d,) = _LEN.unpack_from(buf, pos)
            shape.append(d)
            pos += 8
        (nbytes,) = _LEN.unpack_from(buf, pos)
        pos += 8
        raw = buf[pos:pos + nbytes]
        if isinstance(dtype, torch.dtype):
            arr = torch.frombuffer(bytearray(raw), dtype=dtype) if raw \
                else torch.empty(0, dtype=dtype)
            return arr.reshape(shape), pos + nbytes
        arr = np.frombuffer(raw, dtype=dtype)
        return arr.reshape(shape).copy(), pos + nbytes
    if tag == b"L":
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        items = []
        for _ in range(n):
            item, pos = _dec(buf, pos)
            items.append(item)
        return tuple(items), pos
    if tag == b"D":
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _dec(buf, pos)
            v, pos = _dec(buf, pos)
            d[k] = v
        return d, pos
    raise ValueError(f"bad PS wire tag {tag!r}")


# low-precision dtypes numpy cannot name: carried as torch tensors, their
# bits unchanged (the reference decodes them through ml_dtypes)
_EXT_DTYPES = {name: getattr(torch, name) for name in (
    "bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
    "float8_e5m2fnuz") if hasattr(torch, name)}
_TORCH_NAMES = {v: k for k, v in _EXT_DTYPES.items()}


def _dtype_by_name(name):
    """The numpy dtype of a wire dtype name, or the torch dtype of one
    numpy has no name for (bfloat16)."""
    if name in _EXT_DTYPES:
        return _EXT_DTYPES[name]
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"unknown dtype {name!r} on the PS wire") from None


def _dtype_name(t):
    """The wire name of a tensor's dtype ('float32', 'bfloat16', ...)."""
    return _TORCH_NAMES.get(t.dtype) or str(t.dtype).replace("torch.", "")


def _raw(a):
    """The bytes of a tensor or numpy array, in memory order."""
    if torch.is_tensor(a):
        a = a.detach().cpu().contiguous().reshape(-1)
        if a.dtype in _TORCH_NAMES:
            a = a.view(torch.uint8)
        return a.numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def _tensor(value):
    """A CPU tensor of a wire value (a numpy array keeps its memory)."""
    if torch.is_tensor(value):
        return value.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


def _wire(value):
    """A wire payload: a tensor stays one, anything else is numpy."""
    if torch.is_tensor(value):
        return value
    if hasattr(value, "_data") and torch.is_tensor(value._data):
        return value._data
    return np.asarray(value)


def manifest_entry(data):
    """{"sha256", "size"} of an in-memory payload (the state-transfer
    manifest's entry, the sharded-checkpoint manifest's shape)."""
    return {"sha256": hashlib.sha256(data).hexdigest(), "size": len(data)}


def verify_wire_entry(entry, data):
    """True iff `data` matches a manifest_entry (extra keys ignored)."""
    return (len(data) == entry.get("size")
            and hashlib.sha256(data).hexdigest() == entry.get("sha256"))


def _send_msg(sock, obj):
    out = []
    _enc(obj, out)
    payload = b"".join(out)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    obj, _ = _dec(_recv_exact(sock, n), 0)
    return obj


# Fallback secret when MXTPU_PS_SECRET is unset: random per process, so a
# same-process server+client pair (unit tests, single-host trainer) works
# out of the box while cross-process use without the launcher fails loudly.
_PROCESS_SECRET = secrets.token_bytes(32)


def _ps_secret():
    from . import config as _config

    s = _config.get("MXTPU_PS_SECRET")
    return s.encode("utf-8") if s else _PROCESS_SECRET


def _sign_blob(blob):
    return hmac.new(_ps_secret(), blob, hashlib.sha256).digest() + blob


def _verify_blob(signed):
    mac, blob = signed[:32], signed[32:]
    if not hmac.compare_digest(
            mac, hmac.new(_ps_secret(), blob, hashlib.sha256).digest()):
        raise PermissionError(
            "optimizer blob failed HMAC authentication; set "
            "MXTPU_PS_SECRET to the same value on every worker "
            "(tools/launch.py exports one automatically)")
    return blob


def default_server_addr():
    """Server address derived from the launcher's coordinator: same host,
    coordinator port + 23 (the launcher reserves adjacent ports)."""
    from . import config as _config

    addr = _config.get("MXTPU_PS_ADDR")
    if addr:
        host, port = addr.rsplit(":", 1)
        return host, int(port)
    coord = _config.get("MXTPU_COORDINATOR")
    if ":" in coord:
        host, port = coord.rsplit(":", 1)
        return host, int(port) + 23
    return "127.0.0.1", 9923


class ParameterServer:
    """Authoritative weight store + server-side optimizer
    (ref: KVStoreDistServer, kvstore_dist_server.h:200).

    One handler thread per worker connection; per-key locks make the async
    apply atomic per key while pushes to different keys proceed in
    parallel (the reference got this from ps-lite's per-key request
    serialization).
    """

    def __init__(self, num_workers, host=None, port=9923):
        if host is None:
            # default to the coordinator interface, NOT 0.0.0.0 — the
            # server should only be reachable over the interface the job
            # actually uses (an unauthenticated data plane on all
            # interfaces is a needless exposure)
            host = default_server_addr()[0]
        self.host = host
        self.num_workers = num_workers
        self._store = {}           # key -> np.ndarray (authoritative)
        self._locks = {}           # key -> threading.Lock
        self._locks_guard = san_lock("ps.locks_guard")
        self._updater = None
        self._compressor = None
        # sync-mode aggregation (ref: DataHandleDefault sync path :346)
        self._merge = {}           # key -> (buf, count)
        self._sync_cv = san_condition("ps.sync_cv")
        self._versions = {}        # key -> applied-update count
        # barrier bookkeeping (ref: ps-lite Postoffice::Barrier)
        self._barrier_cv = san_condition("ps.barrier_cv")
        self._barrier_count = 0
        self._barrier_gen = 0
        # worker heartbeats (ref: ps-lite Heartbeat/GetDeadNodes) — rides
        # the same TCP control plane, so dead-node detection works
        # cross-host with no shared filesystem
        self._beats = {}
        self._beats_lock = san_lock("ps.beats")
        self._start_time = time.time()
        from . import config as _config

        # rendezvous waits and replay suppression (docs/FAULT_TOLERANCE.md)
        self._sync_timeout = _config.get("MXTPU_PS_SYNC_TIMEOUT")
        self._dedup_window = max(1, _config.get("MXTPU_PS_DEDUP_WINDOW"))
        self._evict_timeout = _config.get("MXTPU_HEARTBEAT_TIMEOUT")
        self._dedup = {}           # client_id -> OrderedDict(seq -> entry)
        self._dedup_lock = san_lock("ps.dedup")
        # ranks seen via heartbeat then gone stale: they shrink the
        # barrier/sync quorum instead of hanging every survivor until the
        # rendezvous timeout; a fresh beat re-admits them
        self._evicted = set()
        # ranks that left via the graceful-leave RPC: unlike staleness
        # evictions, a stray late beat from the dying process must NOT
        # re-admit them — only an explicit join() does
        self._departed = set()
        # elastic membership (docs/FAULT_TOLERANCE.md — Elastic
        # membership): a monotonically-increasing epoch versions the rank
        # set; sync contributions carry it and stale ones are fenced.
        # Growth joins park in _pending_ranks until a barrier boundary so
        # no in-flight merge generation changes its expected world.
        self._epoch = 0
        self._owners = {}          # rank -> owning client_id
        self._pending_ranks = set()
        self._max_workers = _config.get("MXTPU_MAX_WORKERS")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, port))
        except OSError as e:
            import errno
            import warnings

            if e.errno != errno.EADDRNOTAVAIL:
                raise
            # the advertised address is not a local interface (NAT'd
            # external IP, docker-mapped name): fall back to all
            # interfaces so the job still comes up — loudly, since this
            # widens the listener beyond the coordinator interface
            warnings.warn(
                f"parameter server cannot bind {host!r} (not a local "
                "interface); listening on all interfaces instead")
            self._sock.bind(("0.0.0.0", port))
            self.host = "127.0.0.1"  # local clients reach it via loopback
        # backlog sized for the elastic cap, not just the starting world:
        # a mass rejoin may dial more sockets than num_workers
        self._sock.listen(max(num_workers, self._max_workers) + 2)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads = []
        self._conns = set()
        self._conns_lock = san_lock("ps.conns")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="mxtpu-ps-accept")
        self._accept_thread.start()

    # --- plumbing ---------------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if self._stop.is_set():
                conn.close()
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True, name="mxtpu-ps-worker")
            t.start()
            self._threads.append(t)

    def _key_lock(self, key):
        with self._locks_guard:
            return self._locks.setdefault(key, san_lock("ps.key"))

    def _serve(self, conn):
        try:
            while True:
                msg = _recv_msg(conn)
                ctx = None
                if msg[0] == "trc":
                    # tracing wrapper: ("trc", {tid, sid}, inner_frame) —
                    # the sender's span becomes this request's parent
                    info = msg[1]
                    if isinstance(info, dict) and info.get("sid"):
                        ctx = (info.get("tid"), info.get("sid"))
                    msg = msg[2]
                cmd = msg[0]
                if cmd == "stop":
                    _send_msg(conn, ("ok",))
                    self.shutdown()
                    return
                if cmd == "mut":
                    # reliable envelope: ("mut", client_id, seq, cmd, *args)
                    resp = self._handle_mut(msg[1], int(msg[2]), msg[3],
                                            msg[4:], ctx)
                else:
                    resp = self._dispatch(cmd, msg[1:], ctx)
                _send_msg(conn, resp)
        except (ConnectionError, OSError, EOFError, ValueError,
                struct.error):
            pass  # malformed frame or peer gone: drop the connection
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def _dispatch(self, cmd, args, ctx=None):
        try:
            if cmd in _UNTRACED_COMMANDS:
                return getattr(self, "_cmd_" + cmd)(*args)
            from . import telemetry as _telemetry
            from .telemetry import distributed as _distributed

            # the child span opens HERE, not in _serve: _handle_mut routes
            # only the owning frame of each (client, seq) through dispatch,
            # so a retried (deduped) mutation yields exactly one server span
            with _distributed.remote_context(ctx, lane="server"):
                with _telemetry.span("ps.server.handle", command=cmd):
                    return getattr(self, "_cmd_" + cmd)(*args)
        except Exception as e:  # ship the failure to the worker
            return ("err", f"{type(e).__name__}: {e}")

    def _handle_mut(self, client_id, seq, cmd, args, ctx=None):
        """Exactly-once apply for mutating RPCs: each (client_id, seq) is
        executed by the first frame that carries it; a retransmit (same
        client redialing after a mid-frame drop) waits for the original's
        result instead of re-executing — even when the original is still
        blocked in a sync/barrier rendezvous on the dead connection.
        The window is keyed by CLIENT, not connection, so it survives
        reconnects (ref: ps-lite Resender's seq-based dedup)."""
        with self._dedup_lock:
            window = self._dedup.setdefault(client_id,
                                            collections.OrderedDict())
            entry = window.get(seq)
            owner = entry is None
            if owner:
                entry = {"done": threading.Event(), "resp": None}
                window[seq] = entry
                while len(window) > self._dedup_window:
                    oldest = next(iter(window))
                    if not window[oldest]["done"].is_set():
                        break  # never evict an in-flight original
                    window.pop(oldest)
        if owner:
            resp = self._dispatch(cmd, args, ctx)
            entry["resp"] = resp
            entry["done"].set()
            return resp
        from . import telemetry as _telemetry

        _telemetry.inc(_DEDUP_METRIC, 1, help=_DEDUP_HELP, command=cmd)
        _telemetry.log_event("ps_dedup_hit", command=cmd, seq=seq,
                             client=client_id)
        logger.debug("ps: duplicate %s seq=%d from %s suppressed",
                     cmd, seq, client_id)
        # generous slack over the longest a legitimate original can run
        # (a full sync/barrier rendezvous wait)
        if not entry["done"].wait(timeout=self._sync_timeout + 60):
            return ("err", "TimeoutError: duplicate of an in-flight "
                           f"{cmd} seq={seq} never completed")
        return entry["resp"]

    def _quorum(self):
        """Workers a rendezvous must wait for: the configured world minus
        heartbeat-evicted ranks. Eviction needs the rank to have beaten at
        least once (a never-seen rank may still be starting up); a fresh
        beat re-admits. Only meaningful while heartbeats ride this server
        (tcp transport) — without beats the quorum is the full world."""
        now = time.time()
        newly = []
        readmitted = []
        with self._beats_lock:
            for rank, last in self._beats.items():
                if now - last > self._evict_timeout:
                    if rank not in self._evicted:
                        self._evicted.add(rank)
                        newly.append(rank)
                elif rank in self._evicted:
                    # the quorum grows back: a fresh beat re-admits
                    self._evicted.discard(rank)
                    readmitted.append(rank)
            quorum = max(1, self.num_workers - len(self._evicted))
        for rank in readmitted:
            self._note_readmission(rank, "heartbeat", quorum)
        if newly:
            from . import telemetry as _telemetry
            from .telemetry import recorder as _recorder

            for rank in newly:
                logger.warning(
                    "ps: worker %d heartbeat stale >%.1fs; evicting from "
                    "the rendezvous quorum (now %d/%d)", rank,
                    self._evict_timeout, quorum, self.num_workers)
                _telemetry.inc(_EVICT_METRIC, 1, help=_EVICT_HELP)
                _telemetry.log_event(
                    "ps_eviction", rank=rank, quorum=quorum,
                    world=self.num_workers,
                    stale_s=round(self._evict_timeout, 3))
            # a rank just fell out of the job: preserve the black box
            _recorder.dump("eviction")
        return quorum

    # --- elastic membership ----------------------------------------------
    def _note_readmission(self, rank, via, quorum=None):
        from . import telemetry as _telemetry

        if quorum is None:
            quorum = max(1, self.num_workers - len(self._evicted))
        logger.info("ps: rank %d re-admitted to the quorum via %s "
                    "(now %d/%d)", rank, via, quorum, self.num_workers)
        _telemetry.inc(_READMIT_METRIC, 1, help=_READMIT_HELP, via=via)
        _telemetry.log_event("ps_readmission", rank=int(rank), via=via,
                             quorum=quorum, world=self.num_workers,
                             epoch=self._epoch)

    def _publish_epoch(self, reason):
        from . import telemetry as _telemetry

        _telemetry.set_gauge(_EPOCH_METRIC, self._epoch, help=_EPOCH_HELP)
        _telemetry.log_event("ps_membership_epoch", epoch=self._epoch,
                             reason=reason, world=self.num_workers)

    def _check_epoch(self, epoch, command):
        """Fence a sync contribution against the membership epoch it was
        computed under. `None` (a client that never joined) is always
        accepted — the protocol is opt-in, so pre-elastic clients keep
        working. The check runs at ENTRY, before the contribution touches
        any merge buffer, so a rejection leaves the rendezvous untouched
        and the gradient math bit-exact."""
        if epoch is None or int(epoch) == self._epoch:
            return
        from . import telemetry as _telemetry

        _telemetry.inc(_STALE_METRIC, 1, help=_STALE_HELP, command=command)
        _telemetry.log_event("ps_stale_epoch", command=command,
                             got=int(epoch), want=self._epoch)
        raise StaleEpochError(
            f"{command} carried membership epoch {int(epoch)} but the "
            f"server is at {self._epoch}; the rank set changed — refresh "
            "via membership() and re-contribute")

    def _admit_pending(self):
        """Commit parked growth joins at a barrier boundary: the new ranks
        only count toward generations that START after this one, so no
        in-flight merge ever waits on a contribution that was not part of
        its world — which is what keeps elastic growth bit-exact."""
        with self._beats_lock:
            if not self._pending_ranks:
                return
            admitted = sorted(self._pending_ranks)
            self._pending_ranks.clear()
            self.num_workers = max(self.num_workers, admitted[-1] + 1)
            self._epoch += 1
        from . import telemetry as _telemetry

        for rank in admitted:
            _telemetry.log_event("ps_admission", rank=rank,
                                 world=self.num_workers, epoch=self._epoch)
            logger.info("ps: rank %d admitted at the epoch boundary "
                        "(world now %d, membership epoch %d)", rank,
                        self.num_workers, self._epoch)
        self._publish_epoch("admit")

    # --- commands ---------------------------------------------------------
    def _cmd_join(self, rank, client_id):
        """Versioned membership join (ref: ps-lite dynamic node groups —
        AddNode reassigned ids at the scheduler; here the server IS the
        scheduler). Confirms or assigns a rank and returns the current
        epoch + key directory. Three outcomes: an evicted rank re-admits
        immediately (the quorum grows back NOW — survivors are already
        rendezvousing without it); a brand-new rank parks in
        _pending_ranks until the next barrier boundary; a live rank's
        takeover by a new client_id fences the old incarnation. Every
        membership change bumps the epoch so stale contributions are
        rejected rather than merged."""
        from . import telemetry as _telemetry

        rank = int(rank)
        with self._beats_lock:
            world = self.num_workers
            cap = self._max_workers if self._max_workers > 0 else world
            if rank < 0:
                # no preference: reuse the lowest dead rank, else grow
                evicted = sorted(self._evicted)
                rank = evicted[0] if evicted else world
            readmitted = rank in self._evicted
            takeover = (not readmitted
                        and self._owners.get(rank, client_id) != client_id)
            pending = rank in self._pending_ranks
            if rank >= world and not pending:
                if rank >= cap:
                    raise JoinRejectedError(
                        f"rank {rank} exceeds the elastic world cap "
                        f"({world} configured, MXTPU_MAX_WORKERS={cap}); "
                        "retry after an eviction or raise the cap")
                self._pending_ranks.add(rank)
                pending = True
            self._owners[rank] = client_id
            self._evicted.discard(rank)
            self._departed.discard(rank)  # an explicit rejoin is real
            if rank in self._beats:
                # re-arm staleness from the join, not the pre-death beat
                self._beats[rank] = time.time()
            if readmitted or takeover:
                self._epoch += 1
            epoch = self._epoch
        # a grown-back quorum may complete a parked rendezvous
        with self._barrier_cv:
            self._barrier_cv.notify_all()
        with self._sync_cv:
            self._sync_cv.notify_all()
        outcome = ("readmitted" if readmitted
                   else "pending" if pending else "registered")
        _telemetry.inc(_JOIN_METRIC, 1, help=_JOIN_HELP, outcome=outcome)
        _telemetry.log_event("ps_join", rank=rank, outcome=outcome,
                             epoch=epoch, world=self.num_workers,
                             client=str(client_id))
        if readmitted:
            self._note_readmission(rank, "join")
        if readmitted or takeover:
            self._publish_epoch("join")
        logger.info("ps: rank %d joined (%s) at membership epoch %d",
                    rank, outcome, epoch)
        return ("val", {"epoch": epoch, "rank": rank, "pending": pending,
                        "readmitted": readmitted,
                        "num_workers": self.num_workers,
                        "keys": sorted(self._store, key=str)})

    def _cmd_leave(self, rank):
        """Graceful departure (the preemption drain's farewell): the rank
        is marked evicted NOW, so survivors' rendezvous quorum shrinks
        without waiting out a heartbeat timeout. The leaver's beat record
        is dropped too — unlike a staleness eviction, a stray late beat
        from the dying process must not re-admit it. Symmetric with
        eviction, a leave does NOT bump the membership epoch (the world
        only shrank; survivors' in-flight contributions stay valid), and
        a later join() of the same rank re-admits it through the normal
        versioned path."""
        from . import telemetry as _telemetry
        from .telemetry import recorder as _recorder

        rank = int(rank)
        with self._beats_lock:
            already = rank in self._evicted
            self._beats.pop(rank, None)
            self._owners.pop(rank, None)
            if rank < self.num_workers:
                self._evicted.add(rank)
                self._departed.add(rank)
            quorum = max(1, self.num_workers - len(self._evicted))
        # a shrunk quorum may complete a parked rendezvous
        with self._barrier_cv:
            self._barrier_cv.notify_all()
        with self._sync_cv:
            self._sync_cv.notify_all()
        if not already:
            logger.info("ps: rank %d left the quorum gracefully "
                        "(now %d/%d)", rank, quorum, self.num_workers)
            _telemetry.inc(_LEAVE_METRIC, 1, help=_LEAVE_HELP)
            _telemetry.log_event("ps_leave", rank=rank, quorum=quorum,
                                 world=self.num_workers, epoch=self._epoch)
            # a planned departure still closes a chapter: keep the black
            # box, same as an unplanned eviction does
            _recorder.dump("leave")
        return ("ok", quorum)

    def _cmd_membership(self):
        """Read-only membership snapshot — the recovery RPC after a
        StaleEpochError."""
        return ("val", {"epoch": self._epoch,
                        "num_workers": self.num_workers,
                        "quorum": self._quorum(),
                        "pending": sorted(self._pending_ranks)})

    def _cmd_state_manifest(self):
        """Key directory with per-tensor sha256 in the sharded_checkpoint
        manifest shape — the joiner's state-transfer contract: it pulls
        each key and verifies the bytes against this manifest, so a
        server applying concurrent updates surfaces as a clean mismatch
        (and a refetch) instead of silent skew."""
        files = {}
        for key in sorted(self._store, key=str):
            with self._key_lock(key):
                arr = self._store[key]
                entry = manifest_entry(_raw(arr))
                entry["dtype"] = _dtype_name(arr)
                entry["shape"] = list(int(d) for d in arr.shape)
                files[str(key)] = entry
        return ("val", {"version": 1, "epoch": self._epoch,
                        "files": files})

    def _cmd_init(self, key, value):
        """First writer wins (rank 0 inits; ref: kvstore_dist.h Init)."""
        with self._key_lock(key):
            if key not in self._store:
                self._store[key] = _tensor(value).clone()
                self._versions[key] = 0
        return ("ok",)

    def _cmd_set_optimizer(self, blob):
        """(ref: CommandType::kController — the worker ships the pickled
        optimizer, the server builds its updater from it). The blob is
        unpickled ONLY after HMAC authentication against the job secret."""
        from . import optimizer as _opt

        self._updater = _opt.get_updater(pickle.loads(_verify_blob(blob)))
        return ("ok",)

    def _cmd_get_optimizer_states(self, dump_optimizer):
        if self._updater is None:
            raise RuntimeError("no optimizer set on the server")
        return ("val", _sign_blob(self._updater.get_states(dump_optimizer)))

    def _cmd_set_optimizer_states(self, blob):
        if self._updater is None:
            raise RuntimeError("no optimizer set on the server")
        self._updater.set_states(_verify_blob(blob))
        return ("ok",)

    def _cmd_set_optimizer_attrs(self, attrs):
        """Live optimizer mutation (lr schedules, rescale_grad) without
        rebuilding the updater — state survives."""
        if self._updater is None:
            raise RuntimeError("no optimizer set on the server")
        opt = self._updater.optimizer
        for name, value in attrs.items():
            if not hasattr(opt, name):
                raise AttributeError(f"optimizer has no attribute {name!r}")
            setattr(opt, name, value)
        return ("ok",)

    def _cmd_set_compression(self, params):
        from .kvstore import _make_compressor

        self._compressor = _make_compressor(dict(params))
        return ("ok",)

    def _apply(self, key, grad):
        """Apply a dense gradient: through the updater on the stored CPU
        tensor, in place, else by accumulation. Caller holds the key
        lock."""
        from .ndarray.ndarray import NDArray

        stored = self._store[key]
        grad = _tensor(grad)
        if self._updater is not None:
            # pass the key through untouched: string keys carry the
            # idx2name/lr_mult/wd_mult identity the optimizer looks up
            self._updater(key, NDArray._from_data(grad),
                          NDArray._from_data(stored))
        else:
            self._store[key] = stored + grad
        self._versions[key] += 1

    def _cmd_push(self, key, grad, sync, epoch=None):
        from . import telemetry as _telemetry

        grad = _tensor(grad)
        if not sync:
            # async: apply instantly, nobody waits (ref: :348-358)
            with _telemetry.span("ps.server.merge", sync="0"):
                with self._key_lock(key):
                    self._apply(key, grad)
            return ("ok",)
        self._check_epoch(epoch, "push")
        # sync: aggregate one contribution per live worker, apply once,
        # release everyone at the new version (ref: :346 merge buffer
        # path). Waits run in short slices so a heartbeat eviction
        # mid-generation shrinks the quorum and releases the survivors
        # instead of hanging them until the rendezvous timeout.
        with _telemetry.span("ps.server.merge", sync="1"), self._sync_cv:
            buf, count = self._merge.get(key, (None, 0))
            buf = grad if buf is None else buf + grad
            count += 1
            self._merge[key] = (buf, count)
            target = self._versions[key] + 1
            deadline = time.monotonic() + self._sync_timeout
            while self._versions[key] < target:
                pend, npend = self._merge.get(key, (None, 0))
                if pend is not None and npend >= self._quorum():
                    with self._key_lock(key):
                        self._apply(key, pend)
                    self._merge[key] = (None, 0)
                    self._sync_cv.notify_all()
                    break
                if time.monotonic() > deadline:
                    # drop the stale buffer so a retry cannot double-count,
                    # and surface the failure
                    self._merge[key] = (None, 0)
                    raise TimeoutError(
                        f"sync push on {key!r} waited "
                        f"{self._sync_timeout:.0f}s with {npend}/"
                        f"{self._quorum()} contributions")
                self._sync_cv.wait(timeout=1.0)
        return ("ok",)

    def _cmd_push_many(self, keys, grads, sync, epoch=None):
        """One RPC, many keys — the inter-host half of the hierarchical
        allreduce (the worker already reduced intra-host over the GSPMD
        mesh, so exactly one contribution per key per host arrives here).
        Sync mode rendezvouses the whole bucket as ONE unit under a
        synthetic bucket key: a single merge wait per bucket instead of
        one per key, which is also the single choke point where
        membership changes take effect between generations. Per-key
        optimizer math is unchanged (each key still applies through
        _apply under its own lock), so results stay bit-identical to the
        flat per-key path."""
        from . import telemetry as _telemetry

        keys = tuple(keys)
        grads = [_tensor(g) for g in grads]
        if len(keys) != len(grads):
            raise ValueError(f"push_many got {len(keys)} keys but "
                             f"{len(grads)} gradients")
        if not sync:
            with _telemetry.span("ps.server.merge", sync="0",
                                 bucket=str(len(keys))):
                for key, grad in zip(keys, grads):
                    with self._key_lock(key):
                        self._apply(key, grad)
            return ("ok",)
        self._check_epoch(epoch, "push_many")
        bkey = ("__bucket__",) + keys
        with _telemetry.span("ps.server.merge", sync="1",
                             bucket=str(len(keys))), self._sync_cv:
            buf, count = self._merge.get(bkey, (None, 0))
            buf = (list(grads) if buf is None
                   else [b + g for b, g in zip(buf, grads)])
            count += 1
            self._merge[bkey] = (buf, count)
            target = self._versions.setdefault(bkey, 0) + 1
            deadline = time.monotonic() + self._sync_timeout
            while self._versions[bkey] < target:
                pend, npend = self._merge.get(bkey, (None, 0))
                if pend is not None and npend >= self._quorum():
                    for key, grad in zip(keys, pend):
                        with self._key_lock(key):
                            self._apply(key, grad)
                    self._merge[bkey] = (None, 0)
                    self._versions[bkey] = target
                    self._sync_cv.notify_all()
                    break
                if time.monotonic() > deadline:
                    self._merge[bkey] = (None, 0)
                    raise TimeoutError(
                        f"sync push_many on {len(keys)} keys waited "
                        f"{self._sync_timeout:.0f}s with {npend}/"
                        f"{self._quorum()} contributions")
                self._sync_cv.wait(timeout=1.0)
        return ("ok",)

    def _cmd_pull_many(self, keys):
        out = []
        for key in keys:
            with self._key_lock(key):
                out.append(self._store[key].clone())
        return ("val", out)

    def _apply_rows(self, key, indices, rows):
        """Apply one key's row-sparse grad through the optimizer's
        sparse/lazy path — only the touched rows of the stored tensor
        move (ref: DataHandleRowSparse :499). Caller holds the key lock."""
        from .ndarray.ndarray import NDArray
        from .ndarray.sparse import RowSparseNDArray

        stored = self._store[key]
        indices, rows = _tensor(indices), _tensor(rows)
        if self._updater is not None:
            # the update runs on the stored CPU tensor, in place: a lazy
            # path touches only the pushed rows
            rsp = RowSparseNDArray(NDArray._from_data(rows),
                                   NDArray._from_data(indices),
                                   stored.shape)
            self._updater(key, rsp, NDArray._from_data(stored))
        else:
            upd = stored.clone()
            upd.index_put_((indices,), rows.to(upd.dtype), accumulate=True)
            self._store[key] = upd
        self._versions[key] += 1

    def _cmd_push_rows(self, key, indices, rows, epoch=None):
        """Sparse push: apply only the occupied rows, through the
        optimizer's sparse/lazy path (ref: DataHandleRowSparse :499)."""
        self._check_epoch(epoch, "push_rows")
        indices = _tensor(indices).to(torch.int64)
        with self._key_lock(key):
            self._apply_rows(key, indices, rows)
        return ("ok",)

    # --- sharded embedding tables ------------------------------------------
    # One server of an embedding-shard fleet stores ONLY its local rows of
    # each table (global row r lives on server r % num_shards as local row
    # r // num_shards; the client owns the mapping). The commands below are
    # the shard-fleet data plane: a deterministic server-side init (so no
    # worker ever materializes even a shard), and multi-key row pull/push
    # so one RPC per SERVER carries every table's rows for a step —
    # mirroring push_many's one-RPC-per-bucket hierarchy. State transfer
    # (chaos replacement) rides the existing state_manifest/pull contract
    # unchanged, because a shard is just a dense tensor under its key.

    def _cmd_init_rows(self, key, num_rows, width, dtype, spec):
        """Declare this server's shard of an embedding table: materialize
        `num_rows` local rows SERVER-SIDE from a deterministic init spec
        (first writer wins, like init). spec is ("zeros",) or
        ("uniform", scale, seed, shard, num_shards): local row i is drawn
        from a counter-based stream keyed by (seed, global row id), so a
        row's initial value depends only on its global id — stable across
        fleet layouts and never shipped over the wire."""
        num_rows, width = int(num_rows), int(width)
        with self._key_lock(key):
            if key in self._store:
                return ("ok",)
            dt = _dtype_by_name(str(dtype))
            np_dt = np.float32 if isinstance(dt, torch.dtype) else dt
            kind = spec[0]
            if kind == "zeros":
                block = np.zeros((num_rows, width), np_dt)
            elif kind == "uniform":
                scale, seed, shard, num_shards = (
                    float(spec[1]), int(spec[2]), int(spec[3]),
                    int(spec[4]))
                global_ids = shard + num_shards * np.arange(num_rows)
                seeds = np.empty((num_rows, 2), np.uint64)
                seeds[:, 0] = np.uint64(seed)
                seeds[:, 1] = global_ids.astype(np.uint64)
                block = np.empty((num_rows, width),
                                 np.float64 if np_dt is not dt else dt)
                for i in range(num_rows):
                    rng = np.random.Philox(key=seeds[i])
                    block[i] = np.random.Generator(rng).uniform(
                        -scale, scale, width).astype(block.dtype)
            else:
                raise ValueError(f"unknown embedding init spec {kind!r}")
            block = torch.from_numpy(block)
            if isinstance(dt, torch.dtype):
                block = block.to(dt)
            self._store[key] = block
            self._versions[key] = 0
        return ("ok",)

    def _cmd_pull_rows_multi(self, keys, ids_list):
        """Serve the requested rows of MANY keys in one response — the
        per-server half of the deduped/bucketed embedding pull (one RPC
        per server per step instead of one per key)."""
        out = []
        for key, ids in zip(keys, ids_list):
            ids = _tensor(ids).to(torch.int64)
            with self._key_lock(key):
                out.append(self._store[key][ids])
        return ("val", out)

    def _cmd_push_rows_multi(self, keys, ids_list, rows_list, epoch=None):
        """Apply many keys' row-sparse grads in one mutating RPC, each
        through the lazy sparse optimizer path. Rides the dedup envelope
        (exactly-once across client retries) and the membership-epoch
        fence, like push_many."""
        self._check_epoch(epoch, "push_rows_multi")
        if not (len(keys) == len(ids_list) == len(rows_list)):
            raise ValueError(
                f"push_rows_multi got {len(keys)} keys, {len(ids_list)} "
                f"id vectors, {len(rows_list)} row blocks")
        for key, ids, rows in zip(keys, ids_list, rows_list):
            ids = _tensor(ids).to(torch.int64)
            with self._key_lock(key):
                self._apply_rows(key, ids, rows)
        return ("ok",)

    def _cmd_push_compressed(self, key, payload, shape):
        """Decode the worker's packed 2-bit payload server-side
        (ref: DataHandleCompressed kvstore_dist_server.h:394)."""
        if self._compressor is None:
            raise RuntimeError("server has no compressor configured")
        grad = self._compressor.decode(_tensor(payload), tuple(shape))
        with self._key_lock(key):
            self._apply(key, grad)
        return ("ok",)

    def _cmd_pull(self, key):
        with self._key_lock(key):
            return ("val", self._store[key].clone())

    def _cmd_pull_rows(self, key, row_ids):
        """Serve only the requested rows (ref: DataHandleRowSparse :499)."""
        rows = _tensor(row_ids).to(torch.int64)
        with self._key_lock(key):
            return ("val", self._store[key][rows])

    def _cmd_barrier(self, epoch=None):
        from . import telemetry as _telemetry

        self._check_epoch(epoch, "barrier")
        # generation-counted rendezvous (ref: ps-lite Postoffice::Barrier).
        # Short wait slices re-evaluate the quorum so heartbeat evictions
        # release the survivors; whichever waiter first observes
        # count >= quorum opens the generation. A retransmitted barrier
        # never double-counts: it rides the dedup window in _handle_mut.
        # Barriers are the epoch boundaries of elastic membership: parked
        # growth joins commit when a generation opens, and every waiter
        # returns the (possibly new) epoch so joined clients stay current.
        with _telemetry.span("ps.server.barrier"), self._barrier_cv:
            gen = self._barrier_gen
            self._barrier_count += 1
            deadline = time.monotonic() + self._sync_timeout
            while self._barrier_gen == gen:
                if self._barrier_count >= self._quorum():
                    self._barrier_count = 0
                    self._barrier_gen += 1
                    self._admit_pending()
                    self._barrier_cv.notify_all()
                    break
                if time.monotonic() > deadline:
                    self._barrier_count -= 1
                    raise TimeoutError(
                        f"barrier waited {self._sync_timeout:.0f}s with "
                        f"only {self._barrier_count + 1}/{self._quorum()} "
                        "workers present")
                self._barrier_cv.wait(timeout=1.0)
        return ("ok", self._epoch)

    def _cmd_heartbeat(self, rank):
        rank = int(rank)
        with self._beats_lock:
            if rank in self._departed:
                # a straggler beat from a rank that already said goodbye:
                # it is draining, not back — only join() readmits it
                return ("ok",)
            self._beats[rank] = time.time()
            readmitted = rank in self._evicted
            self._evicted.discard(rank)  # a live beat re-admits
        if readmitted:
            self._note_readmission(rank, "heartbeat")
        with self._barrier_cv:
            self._barrier_cv.notify_all()  # quorum may have changed
        with self._sync_cv:
            self._sync_cv.notify_all()
        return ("ok",)

    def _cmd_num_dead(self, requester, timeout, grace_elapsed):
        """Ranks whose heartbeat is stale (or never arrived), excluding the
        requester — the KVStore::get_num_dead_node analog served over TCP.
        `grace_elapsed` tells whether the REQUESTER's own startup grace has
        passed (mirrors the file transport, where never-seen peers count
        as dead only relative to the observer's start, so late-joining
        workers are not reported dead by early starters)."""
        now = time.time()
        dead = 0
        with self._beats_lock:
            for r in range(self.num_workers):
                if r == int(requester):
                    continue
                last = self._beats.get(r)
                if last is None:
                    if grace_elapsed and now - self._start_time > timeout:
                        dead += 1
                elif now - last > timeout:
                    dead += 1
        return ("val", dead)

    def _cmd_keys(self):
        return ("val", sorted(self._store, key=str))

    def serve_forever(self):
        """Block this thread until a worker sends the stop command or
        shutdown() is called — the dedicated-server-process entry
        (kvstore_server.KVStoreServer.run)."""
        self._stop.wait()
        self._accept_thread.join(timeout=10)
        # the handler threads end (their sockets were shut down) before
        # the caller's process may exit under them
        for t in list(self._threads):
            t.join(timeout=10)

    def shutdown(self):
        """Stop accepting, and end every open connection."""
        self._stop.set()
        # shutdown() (not just close()) wakes a thread blocked in accept();
        # close() alone leaves it blocked on a stale fd which the NEXT
        # server's listener can reuse — the old loop would then steal the
        # new server's connections
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._accept_thread.join(timeout=10)


# per-process client-id disambiguator: the server's dedup window is keyed
# by (client_id, seq), so the id must be unique per CLIENT OBJECT and
# stable across that object's reconnects
_CLIENT_IDS = itertools.count()


class PSClient:
    """Worker-side connection (ref: kvstore_dist.h push/pull over ps-lite).

    Thread-safe: one socket, request/response framing under a lock.

    Resilient: a mid-frame socket error (or injected drop) closes the
    socket and transparently redials + resends under a RetryPolicy —
    never reuses a socket whose framing may be poisoned. Every mutating
    RPC carries this client's monotonic sequence id in a ("mut", ...)
    envelope so the server applies a retransmit exactly once; reads
    (pull/keys/heartbeat/...) are idempotent and resend bare.
    """

    def __init__(self, host, port, retries=60, instance=None):
        from . import config as _config
        from .resilience import RetryPolicy

        self._host, self._port = host, int(port)
        self._lock = san_lock("ps.client")
        self._sock = None
        self._seq = 0
        self._client_id = (f"{socket.gethostname()}:{os.getpid()}:"
                           f"{next(_CLIENT_IDS)}")
        # stable tag for the fault injector's per-client streams: the
        # worker rank by default, so a seeded chaos schedule replays
        # per-worker regardless of thread interleaving
        self._instance = (instance if instance is not None
                          else f"w{_config.get('MXTPU_PROCESS_ID')}")
        self._connect_timeout = _config.get("MXTPU_PS_CONNECT_TIMEOUT")
        # the socket timeout outlives the server's rendezvous waits, which
        # raise a proper error instead of this socket timing out first
        self._socket_timeout = _config.get("MXTPU_PS_SOCKET_TIMEOUT")
        # distinct backoff jitter per client: every worker redialing after
        # the same network blip must NOT share one seed, or the whole
        # fleet sleeps and retries in lockstep and the mass rejoin
        # thundering-herds the server. The heartbeat sender's reconnect
        # rides these policies too, so beats desynchronize the same way.
        self._policy_seed = zlib.crc32(
            f"{self._instance}:{self._client_id}".encode("utf-8"))
        # first connect keeps the caller-visible `retries` contract (the
        # server may simply not be up yet) on the knob-driven schedule
        self._connect_policy = RetryPolicy.from_knobs(
            max_attempts=max(1, int(retries)), seed=self._policy_seed)
        self._rpc_policy = RetryPolicy.from_knobs(seed=self._policy_seed)
        # membership epoch last observed (None until join/membership —
        # epoch-less clients are always accepted, see _check_epoch)
        self._epoch = None
        self._rank = None
        with self._lock:
            self._reconnect_locked(first=True)

    # --- connection management -------------------------------------------
    def _close_locked(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _dial_once(self, _attempt):
        from .resilience import fault as _fault

        _fault.injector().raise_for("ps.connect", self._instance)
        sock = socket.create_connection(
            (self._host, self._port), timeout=self._connect_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self._socket_timeout)
        return sock

    def _reconnect_locked(self, first=False, cause="redial"):
        self._close_locked()

        def _log(attempt, exc, remaining):
            logger.debug(
                "PSClient redial %s:%d attempt %d failed (%s: %s); "
                "%.1fs of deadline remaining", self._host, self._port,
                attempt + 1, type(exc).__name__, exc, remaining)

        try:
            self._sock = self._connect_policy.call(
                self._dial_once, OSError, site="ps.connect", on_retry=_log)
        except OSError as e:
            raise ConnectionError(
                f"parameter server at {self._host}:{self._port} "
                f"unreachable: {e}") from e
        if not first:
            from . import telemetry as _telemetry

            _telemetry.inc(_RECONNECT_METRIC, 1, help=_RECONNECT_HELP,
                           cause=cause)
            _telemetry.log_event("ps_reconnect", cause=cause,
                                 addr=f"{self._host}:{self._port}")
            logger.debug("PSClient reconnected to %s:%d (%s)",
                         self._host, self._port, cause)

    # --- framing ----------------------------------------------------------
    def _rpc_attempt(self, frame):
        from .resilience import fault as _fault
        from .telemetry.spans import current_span

        inj = _fault.injector()
        # attach the current trace context so the server's child span joins
        # this trace; the ("trc", ...) wrapper only exists when a span is
        # live, so the untraced wire format is byte-identical to before
        sp = current_span()
        traced = sp is not None and sp.span_id is not None
        if traced:
            frame = ("trc", {"tid": sp.trace_id, "sid": sp.span_id}, frame)
        with self._lock:
            if self._sock is None:
                self._reconnect_locked(cause="redial")
            try:
                inj.raise_for("ps.rpc", self._instance)
                if traced:
                    # send/recv wall clocks of the SUCCESSFUL attempt
                    # (annotate overwrites across retries) — paired with
                    # the server span's start/end by trace_merge for
                    # NTP-style clock-skew correction
                    sp.annotate(send_ns=time.time_ns())
                _send_msg(self._sock, frame)
                # separate post-send site: a drop HERE leaves the request
                # applied server-side, which is exactly what the dedup
                # window must absorb on the retransmit
                inj.raise_for("ps.rpc.recv", self._instance)
                resp = _recv_msg(self._sock)
                if traced:
                    sp.annotate(recv_ns=time.time_ns())
                return resp
            except _WIRE_ERRORS as e:
                self._close_locked()  # poisoned mid-frame: next try redials
                self._last_cause = type(e).__name__
                if sp is not None:
                    sp.bump("retries")
                raise

    def _call(self, frame, site):
        from . import telemetry as _telemetry

        command = site.rpartition(".")[2]
        if command in _UNTRACED_COMMANDS:
            return self._call_inner(frame, site)
        with _telemetry.span("ps.client.rpc", command=command):
            return self._call_inner(frame, site)

    def _call_inner(self, frame, site):
        resp = self._rpc_policy.call(
            lambda _a: self._rpc_attempt(frame), _WIRE_ERRORS, site=site)
        if resp[0] == "err":
            name = str(resp[1]).split(":", 1)[0]
            cls = _ERR_CLASSES.get(name, RuntimeError)
            raise cls(f"parameter server: {resp[1]}")
        return resp[1] if len(resp) > 1 else None

    def _rpc(self, *msg):
        """Idempotent RPC: resent bare across reconnects."""
        return self._call(tuple(msg), site="ps." + msg[0])

    def _mut_rpc(self, cmd, *args):
        """Mutating RPC: one sequence id for ALL resends of this call, so
        the server's dedup window applies it exactly once."""
        with self._lock:
            self._seq += 1
            frame = ("mut", self._client_id, self._seq, cmd) + args
        return self._call(frame, site="ps." + cmd)

    # --- API --------------------------------------------------------------
    def init(self, key, value):
        return self._mut_rpc("init", key, _wire(value))

    def push(self, key, grad, sync=False):
        return self._mut_rpc("push", key, _wire(grad), bool(sync),
                             self._epoch)

    def push_many(self, keys, grads, sync=False):
        """One mutating RPC carrying a whole bucket of gradients — the
        client half of the hierarchical allreduce."""
        return self._mut_rpc("push_many", tuple(keys),
                             tuple(_wire(g) for g in grads),
                             bool(sync), self._epoch)

    def pull_many(self, keys):
        return list(self._rpc("pull_many", tuple(keys)))

    def push_compressed(self, key, payload, shape):
        return self._mut_rpc("push_compressed", key, _wire(payload),
                             tuple(shape))

    def push_rows(self, key, indices, rows):
        return self._mut_rpc("push_rows", key, _wire(indices),
                             _wire(rows), self._epoch)

    # --- sharded embedding tables ------------------------------------------
    def init_rows(self, key, num_rows, width, dtype, spec):
        """Create this server's shard of an embedding table from a
        deterministic init spec (server-side materialization)."""
        return self._mut_rpc("init_rows", key, int(num_rows), int(width),
                             str(dtype), tuple(spec))

    def pull_rows_multi(self, keys, ids_list):
        """One RPC, many keys: fetch each key's requested rows."""
        return list(self._rpc("pull_rows_multi", tuple(keys),
                              [np.asarray(i, np.int64) for i in ids_list]))

    def push_rows_multi(self, keys, ids_list, rows_list):
        """One mutating RPC applying many keys' row-sparse grads through
        the server's lazy sparse optimizer path (epoch-fenced, deduped)."""
        return self._mut_rpc("push_rows_multi", tuple(keys),
                             [np.asarray(i, np.int64) for i in ids_list],
                             [_wire(r) for r in rows_list],
                             self._epoch)

    def set_optimizer_attrs(self, attrs):
        return self._mut_rpc("set_optimizer_attrs", dict(attrs))

    def set_compression(self, params):
        return self._mut_rpc("set_compression", dict(params))

    def get_optimizer_states(self, dump_optimizer=False):
        return _verify_blob(
            self._rpc("get_optimizer_states", bool(dump_optimizer)))

    def set_optimizer_states(self, blob):
        return self._mut_rpc("set_optimizer_states", _sign_blob(blob))

    def pull(self, key):
        return self._rpc("pull", key)

    def pull_rows(self, key, row_ids):
        return self._rpc("pull_rows", key, _wire(row_ids))

    def set_optimizer(self, optimizer):
        return self._mut_rpc("set_optimizer",
                             _sign_blob(pickle.dumps(
                                 optimizer,
                                 protocol=pickle.HIGHEST_PROTOCOL)))

    def barrier(self):
        epoch = self._mut_rpc("barrier", self._epoch)
        if self._epoch is not None and epoch is not None:
            # boundaries publish the (possibly bumped) membership epoch
            self._epoch = int(epoch)
        return epoch

    def heartbeat(self, rank):
        return self._rpc("heartbeat", int(rank))

    # --- elastic membership ----------------------------------------------
    @property
    def epoch(self):
        """Membership epoch last observed (None before join)."""
        return self._epoch

    @property
    def rank(self):
        """Rank the server assigned at join (None before join)."""
        return self._rank

    def join(self, rank=-1, wait=True, policy=None):
        """Join (or rejoin) the membership: returns the server's verdict
        {epoch, rank, pending, readmitted, num_workers, keys}. rank=-1
        lets the server pick (lowest evicted rank, else world growth). A
        world-full rejection backs off and retries under `policy` — the
        rejoin backoff — and with wait=True a growth join also polls
        until the next barrier boundary commits the admission."""
        from .resilience import RetryPolicy

        if policy is None:
            policy = RetryPolicy.from_knobs(seed=self._policy_seed)
        rank = -1 if rank is None else int(rank)
        info = policy.call(
            lambda _a: self._mut_rpc("join", rank, self._client_id),
            JoinRejectedError, site="ps.join")
        self._epoch = int(info["epoch"])
        self._rank = int(info["rank"])
        if wait and info["pending"]:
            self.wait_admitted(policy=policy)
        return info

    def membership(self):
        """Refresh {epoch, num_workers, quorum, pending} from the server
        — the recovery step after a StaleEpochError."""
        info = self._rpc("membership")
        self._epoch = int(info["epoch"])
        return info

    def leave(self, rank=None):
        """Graceful departure (preemption drain): tell the server this
        rank is gone so the survivors' quorum shrinks NOW instead of
        after a heartbeat timeout. Defaults to the rank join() assigned.
        Returns the post-leave quorum; rejoin later via join()."""
        r = self._rank if rank is None else int(rank)
        if r is None:
            raise RuntimeError("leave() before join(): no rank to retire "
                               "(pass rank= explicitly)")
        return self._mut_rpc("leave", int(r))

    def wait_admitted(self, policy=None):
        """Backoff-poll until this rank is inside the world (its parked
        growth join was committed by a barrier boundary)."""
        from .resilience import RetryPolicy

        if self._rank is None:
            raise RuntimeError("wait_admitted before join()")
        if policy is None:
            policy = RetryPolicy.from_knobs(seed=self._policy_seed)
        info = self.membership()
        if self._rank < int(info["num_workers"]):
            return info
        for delay in policy.delays():
            time.sleep(delay)
            info = self.membership()
            if self._rank < int(info["num_workers"]):
                return info
        raise TimeoutError(
            f"rank {self._rank} was never admitted (world stuck at "
            f"{info['num_workers']}); admissions commit at a barrier "
            "boundary — is any live worker reaching one?")

    def state_manifest(self):
        return self._rpc("state_manifest")

    def bootstrap(self, keys=None):
        """State transfer on admit: pull every key in the server's
        directory and verify the bytes against its sharded_checkpoint-
        format manifest. A mismatch (the server applied a push between
        manifest and pull) refetches the manifest once; returns
        {key: np.ndarray (a torch tensor for bfloat16)}."""
        from . import telemetry as _telemetry

        if keys is None:
            keys = self.keys()
        manifest = self.state_manifest()
        out = {}
        for key in keys:
            for _attempt in range(2):
                entry = manifest["files"].get(str(key))
                val = self.pull(key)
                if entry is None or verify_wire_entry(entry, _raw(val)):
                    break
                manifest = self.state_manifest()
            else:
                raise RuntimeError(
                    f"bootstrap of key {key!r} never matched the server's "
                    "state manifest — the server is applying concurrent "
                    "updates; join at an epoch boundary instead")
            out[key] = val
        _telemetry.log_event("ps_bootstrap", keys=len(out),
                             epoch=self._epoch)
        return out

    def num_dead(self, rank, timeout, grace_elapsed=True):
        return self._rpc("num_dead", int(rank), float(timeout),
                         bool(grace_elapsed))

    def keys(self):
        return self._rpc("keys")

    def stop_server(self):
        # deliberately NOT retried: at teardown a dead server is success,
        # and a retry loop here would stall interpreter exit
        try:
            with self._lock:
                if self._sock is None:
                    self._sock = self._dial_once(0)
                _send_msg(self._sock, ("stop",))
                _recv_msg(self._sock)
        except (RuntimeError, ConnectionError, EOFError, OSError,
                struct.error):
            pass

    def close(self):
        with self._lock:
            self._close_locked()
