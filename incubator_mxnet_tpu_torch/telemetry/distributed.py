"""Causal tracing: trace-context propagation and trace export.

The port's copy of the JAX package's `telemetry/distributed.py`. Every
span carries `trace_id`/`span_id`/`parent_id` (Dapper-style), a peer's
context is adopted through `remote_context`, and W3C `traceparent`
headers map onto the internal ids.

Export: when `MXTPU_TRACE_DIR` is set, every completed span is appended
to a per-process binary-framed trace file

    <dir>/trace-<pid>-<suffix>.mxtrace
    file   := MAGIC frame*
    frame  := u32_be(len) json_utf8(span record)

(one frame per span; a reader can stop at the first torn frame after a
crash and keep everything before it). The format is the JAX package's
byte for byte, so `tools/trace_merge.py` merges the port's files and the
JAX package's alike into one Chrome-trace/Perfetto timeline.

Lanes: each record carries a `lane`. The per-process default is
`r<MXTPU_PROCESS_ID>`; a thread may override it (`set_thread_lane`), and
`remote_context` may set one for the spans it covers.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import re
import secrets
import struct
import threading

__all__ = [
    "TRACE_MAGIC", "trace_active", "refresh_from_env", "new_id",
    "current_context", "remote_context", "remote_parent",
    "set_thread_lane", "current_lane", "record_span", "flush",
    "read_trace_file", "format_traceparent", "parse_traceparent",
]

TRACE_MAGIC = b"MXTRACE1"
_FRAME = struct.Struct(">I")

# span/trace ids: 16 hex chars — a per-process random prefix (collision
# avoidance across the cluster without coordination) + a monotonic
# counter (uniqueness + cheapness within the process)
_ID_PREFIX = secrets.token_hex(4)
_ID_COUNTER = itertools.count(1)

_tls = threading.local()

_state_lock = threading.Lock()
_active = None      # None = not yet resolved from MXTPU_TRACE_DIR
_writer = None      # _TraceWriter once the first span is recorded
_proc_lane = None   # cached per-process default lane


def new_id():
    """A new 16-hex-char span/trace id, unique across the cluster."""
    return f"{_ID_PREFIX}{next(_ID_COUNTER) & 0xFFFFFFFF:08x}"


# -- activation --------------------------------------------------------------

def trace_active():
    """Whether trace export is on (MXTPU_TRACE_DIR set). First call
    resolves the knob; afterwards a cached-boolean read, so the disabled
    path costs the same as disabled telemetry."""
    a = _active
    if a is None:
        from .. import config as _config

        with _state_lock:
            if _active is None:
                globals()["_active"] = bool(_config.get("MXTPU_TRACE_DIR"))
            a = _active
    return a


def refresh_from_env():
    """Re-resolve MXTPU_TRACE_DIR (tests that monkeypatch env); flushes
    and detaches any open trace file first."""
    global _active, _writer, _proc_lane
    with _state_lock:
        if _writer is not None:
            _writer.close()
        _writer = None
        _active = None
        _proc_lane = None
    return trace_active()


# -- lanes -------------------------------------------------------------------

def current_lane():
    """The timeline lane for this thread: thread override, else
    r<MXTPU_PROCESS_ID> (role-qualified for server processes)."""
    lane = getattr(_tls, "lane", None)
    if lane is not None:
        return lane
    global _proc_lane
    if _proc_lane is None:
        from .. import config as _config

        role = os.environ.get("MXTPU_ROLE", "")  # mxlint: disable=MXL007
        _proc_lane = ("server" if role == "server"
                      else f"r{_config.get('MXTPU_PROCESS_ID')}")
    return _proc_lane


def set_thread_lane(lane):
    """Override this thread's lane (None restores the process default).
    Returns the previous override — callers restore it when simulating
    multiple ranks from one process."""
    prev = getattr(_tls, "lane", None)
    _tls.lane = lane
    return prev


# -- remote (cross-process) parent context -----------------------------------

def current_context():
    """(trace_id, span_id) of the innermost active span on this thread,
    or None — what an RPC client attaches to its envelope."""
    from .spans import current_span

    sp = current_span()
    if sp is None or getattr(sp, "span_id", None) is None:
        return None
    return (sp.trace_id, sp.span_id)


def remote_parent():
    """The (trace_id, span_id) a remote peer shipped for this thread, or
    None. A root span adopts it as its parent, linking the server-side
    subtree into the client's trace."""
    return getattr(_tls, "remote", None)


class remote_context:
    """Adopt a peer's trace context (and optionally a lane) for the
    spans this thread opens inside the `with` block. `ctx` is the
    (trace_id, span_id) pair off the wire — None/missing deactivates
    cleanly so untraced requests cost nothing."""

    __slots__ = ("_ctx", "_lane", "_prev", "_prev_lane", "_set_lane")

    def __init__(self, ctx, lane=None):
        self._ctx = tuple(ctx) if ctx else None
        self._lane = lane
        self._set_lane = lane is not None

    def __enter__(self):
        self._prev = getattr(_tls, "remote", None)
        _tls.remote = self._ctx
        if self._set_lane:
            self._prev_lane = set_thread_lane(self._lane)
        return self

    def __exit__(self, *exc):
        _tls.remote = self._prev
        if self._set_lane:
            set_thread_lane(self._prev_lane)
        return False


# -- W3C traceparent interop (the gateway's external correlation seam) -------

# https://www.w3.org/TR/trace-context/: 00-<32hex trace>-<16hex parent>-<2hex>
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def format_traceparent(trace_id, span_id):
    """Render an internal (trace_id, span_id) pair as a W3C traceparent
    header value. Internal ids are 16 hex chars; the 32-hex W3C trace-id
    field is left-padded with zeros (an inbound 32-hex id adopted by
    `parse_traceparent` round-trips unchanged). Flags are always 01
    (sampled) — a traceparent only exists while tracing is active."""
    return f"00-{str(trace_id).zfill(32)}-{span_id}-01"


def parse_traceparent(header):
    """Parse a W3C traceparent header into an internal
    (trace_id, parent_span_id) pair, or None when the header is missing
    or malformed (the request then starts a fresh trace). The 32-hex
    trace id is adopted verbatim minus redundant left zero-padding, so
    a client-minted id survives the echo and internally-minted 16-hex
    ids round-trip through `format_traceparent`."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(str(header).strip().lower())
    if m is None:
        return None
    trace_hex, parent_hex = m.group(1), m.group(2)
    if set(trace_hex) == {"0"} or set(parent_hex) == {"0"}:
        return None  # all-zero ids are invalid per the spec
    trimmed = trace_hex.lstrip("0")
    trace_id = trace_hex[-16:] if len(trimmed) <= 16 else trace_hex
    return (trace_id, parent_hex)


# -- trace file writer -------------------------------------------------------

class _TraceWriter:
    """Buffered, thread-safe appender of framed span records."""

    def __init__(self, directory, buffer_spans):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(
            directory, f"trace-{os.getpid()}-{secrets.token_hex(3)}.mxtrace")
        self._lock = threading.Lock()
        self._buf = []
        self._cap = max(1, buffer_spans)
        self._file = open(self.path, "wb")
        self._file.write(TRACE_MAGIC)

    def add(self, record):
        with self._lock:
            self._buf.append(record)
            if len(self._buf) >= self._cap:
                self._flush_locked()

    def _flush_locked(self):
        if not self._buf or self._file is None:
            return
        chunks = []
        for rec in self._buf:
            payload = json.dumps(rec, separators=(",", ":"),
                                 sort_keys=True).encode("utf-8")
            chunks.append(_FRAME.pack(len(payload)) + payload)
        self._buf = []
        self._file.write(b"".join(chunks))
        self._file.flush()

    def flush(self):
        with self._lock:
            self._flush_locked()

    def close(self):
        with self._lock:
            self._flush_locked()
            if self._file is not None:
                self._file.close()
                self._file = None


def _sink():
    global _writer
    w = _writer
    if w is None:
        from .. import config as _config

        with _state_lock:
            if _writer is None:
                _writer = _TraceWriter(
                    _config.get("MXTPU_TRACE_DIR"),
                    _config.get("MXTPU_TRACE_BUFFER_SPANS"))
                atexit.register(_writer.close)
            w = _writer
    return w


def record_span(record):
    """Append one completed-span record to this process's trace file
    (no-op unless trace export is active)."""
    if not trace_active():
        return
    if "lane" not in record:
        record["lane"] = current_lane()
    # thread id separates concurrently-open spans (server handler threads)
    # into distinct Chrome-trace rows inside the lane
    record.setdefault("thr", threading.get_ident() % 1000000)
    _sink().add(record)


def flush():
    """Flush buffered spans to disk (tests; end-of-phase barriers)."""
    if _active and _writer is not None:
        _writer.flush()


# -- reader (used by tools/trace_merge.py and tests) -------------------------

def read_trace_file(path):
    """Decode one .mxtrace file into a list of span records. Stops at the
    first torn/truncated frame (everything before it is intact — the
    crash-tolerance the framing exists for); raises ValueError on a bad
    magic header."""
    records = []
    with open(path, "rb") as f:
        magic = f.read(len(TRACE_MAGIC))
        if magic != TRACE_MAGIC:
            raise ValueError(f"{path}: not a trace file "
                             f"(bad magic {magic!r})")
        while True:
            head = f.read(_FRAME.size)
            if len(head) < _FRAME.size:
                break
            (n,) = _FRAME.unpack(head)
            payload = f.read(n)
            if len(payload) < n:
                break  # torn tail frame: crash mid-write
            try:
                records.append(json.loads(payload.decode("utf-8")))
            except ValueError:
                break
    return records
