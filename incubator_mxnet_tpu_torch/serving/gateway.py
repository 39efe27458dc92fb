"""HTTP serving gateway: streaming generation in front of the fleet.

The port's copy of the JAX package's `serving/gateway.py`: the same
routes, status codes, headers, NDJSON events, metrics, span and access
log.

A small stdlib HTTP front end (the telemetry /metrics server is the
pattern — no web framework, `ThreadingHTTPServer` + one daemon thread)
that turns the FleetRouter into a service:

- `POST /v1/generate` — body `{"prompt": [ids...], "max_new_tokens": N,
  "eos_id": id?, "tenant": "name"?, "stream": true?}`. With
  `stream: true` (the default) the response is close-delimited NDJSON
  (HTTP/1.0, no Content-Length): one `{"event": "token", ...}` line per
  generated token as it is produced, then a terminal `done`/`failed`
  line. Tokens stream straight off the request journal, so a mid-stream
  replica failover is invisible here beyond a pause: the journal's
  epoch fence guarantees every index appears exactly once, in order.
- `GET /healthz` — fleet liveness for load balancers: 200 while at
  least one replica is healthy, 503 when draining or empty.

Admission control is backpressure, not buffering: a request is REJECTED
with `429 Retry-After` when its tenant's queue already holds
`MXTPU_GATEWAY_QUEUE_LIMIT` waiting requests or when every healthy
replica's KV page pool is above `MXTPU_GATEWAY_MAX_OCCUPANCY` — the
caller retries against a fleet that said so honestly instead of timing
out against one that lied. A draining fleet (rolling restart's final
step, SIGTERM) answers `503 Retry-After`: new work belongs on the
replacement fleet, in-flight work finishes here.

The `gateway.accept` fault site is consulted once per HTTP request
before admission (`drop`/`fail` → a clean 503 with outcome "injected",
`delay` → a slow accept path), which is how the chaos legs separate
"the gateway shed load" from "the fleet lost a request" — the former is
allowed, the latter never is.

Observability (the fleet observatory's front end):

- With tracing on (`MXTPU_TRACE_DIR`), every request gets a root
  `gateway.request` span on lane "gateway". An inbound W3C
  `traceparent` header is adopted (external client correlation); the
  response carries a `Traceparent` header naming the gateway span, the
  NDJSON stream opens with a `{"event": "trace", ...}` line, and the
  context rides `router.submit(trace_ctx=...)` down through
  `fleet.dispatch` into each replica's `serving.request` span — one
  trace per request, fleet-wide.
- `GET /metrics` is the fleet metrics federation point: the router's
  rollup + per-replica gauges are refreshed, then the whole process
  registry is rendered as Prometheus text.
- `MXTPU_GATEWAY_ACCESS_LOG` (a path, or `-` for stderr) turns on an
  NDJSON access log: one line per generate request with tenant,
  status, token counts, queue-wait/TTFT/latency, trace id, serving
  replica, and failover count — replacing the silently-discarded
  `log_message` default.
"""
from __future__ import annotations

import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import config, telemetry
from ..analysis import sanitizers as _sanitizers
from ..resilience import fault as _fault
from ..telemetry import distributed as _dtrace

__all__ = ["ServingGateway"]

GW_REQUESTS_TOTAL = "mxtpu_gateway_requests_total"
GW_INFLIGHT = "mxtpu_gateway_inflight"
GW_ACCESS_LINES_TOTAL = "mxtpu_gateway_access_log_lines_total"

GATEWAY_SPAN = "gateway.request"
GATEWAY_LANE = "gateway"


class _Reject(Exception):
    """Admission refused: (status, outcome label, body dict)."""

    def __init__(self, status, outcome, body, retry_after=None):
        super().__init__(body.get("error", outcome))
        self.status = status
        self.outcome = outcome
        self.body = body
        self.retry_after = retry_after


class _GatewayServer(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of concurrent clients past it, and each dropped one connects
    # only on the kernel's retry a second later (a 1 s TTFT outlier)
    request_queue_size = 128
    gateway = None  # set by ServingGateway before serving


class _AccessLog:
    """NDJSON access log behind `MXTPU_GATEWAY_ACCESS_LOG`: one JSON
    line per request, appended to the configured path (`-` = stderr,
    empty = off). Thread-safe; the file opens lazily on first write so
    an idle gateway never touches disk."""

    def __init__(self, target):
        self._target = str(target or "")
        self._lock = _sanitizers.san_lock("serving.gateway_access_log")
        self._file = None

    @property
    def enabled(self):
        return bool(self._target)

    def write(self, record):
        if not self._target:
            return
        line = json.dumps(record, sort_keys=True) + "\n"
        with self._lock:
            if self._target == "-":
                sys.stderr.write(line)
            else:
                if self._file is None:
                    self._file = open(self._target, "a", encoding="utf-8")
                self._file.write(line)
                self._file.flush()
        telemetry.inc(GW_ACCESS_LINES_TOTAL)

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.0: responses are close-delimited, which is what lets the
    # token stream flush line-by-line without chunked-encoding framing
    protocol_version = "HTTP/1.0"
    _trace = None  # gateway.request trace context for this request

    def log_message(self, fmt, *args):
        # BaseHTTPRequestHandler's default stderr chatter stays off;
        # non-generate traffic (healthz, metrics, 404s) gets a basic
        # access-log line, while /v1/generate writes its rich line from
        # handle_generate (with journal-derived latency/replica fields)
        gw = self.server.gateway
        if gw is None or self.path == "/v1/generate":
            return
        gw.access_log.write({"ts": time.time(), "method": self.command,
                             "path": self.path, "line": fmt % args})

    def _reply(self, status, body, retry_after=None):
        data = (json.dumps(body) + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if retry_after is not None:
            self.send_header("Retry-After", f"{retry_after:g}")
        if self._trace is not None:
            self.send_header("Traceparent", _dtrace.format_traceparent(
                self._trace["tid"], self._trace["sid"]))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        gw = self.server.gateway
        if self.path == "/healthz":
            status, body = gw.health()
            self._reply(status, body)
        elif self.path == "/metrics":
            data = gw.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._reply(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):
        gw = self.server.gateway
        if self.path != "/v1/generate":
            self._reply(404, {"error": f"unknown path {self.path!r}"})
            return
        gw.handle_generate(self)


class ServingGateway:
    """The fleet's HTTP front door. Binds 127.0.0.1:`port` (the
    `MXTPU_GATEWAY_PORT` knob; 0 = ephemeral, read the bound port back
    from `.port`) and serves until `close()`."""

    def __init__(self, router, *, port=None, queue_limit=None,
                 max_occupancy=None, retry_after=None,
                 request_timeout=600.0):
        self.router = router
        self.queue_limit = int(
            queue_limit if queue_limit is not None
            else config.get("MXTPU_GATEWAY_QUEUE_LIMIT"))
        self.max_occupancy = float(
            max_occupancy if max_occupancy is not None
            else config.get("MXTPU_GATEWAY_MAX_OCCUPANCY"))
        self.retry_after = float(
            retry_after if retry_after is not None
            else config.get("MXTPU_GATEWAY_RETRY_AFTER"))
        self.request_timeout = float(request_timeout)
        self.access_log = _AccessLog(config.get("MXTPU_GATEWAY_ACCESS_LOG"))
        self._inflight = 0
        self._inflight_lock = _sanitizers.san_lock("serving.gateway")
        bind_port = int(port if port is not None
                        else config.get("MXTPU_GATEWAY_PORT"))
        self._server = _GatewayServer(("127.0.0.1", bind_port), _Handler)
        self._server.gateway = self
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="mxtpu-gateway-http")
        self._thread.start()
        telemetry.log_event("gateway_started", port=self.port)

    @property
    def port(self):
        return self._server.server_address[1]

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10.0)
        self.access_log.close()

    def metrics_text(self):
        """Fleet metrics federation: refresh the router's rollup and
        per-replica gauges, then render the whole process registry —
        in-process replicas share it, so one scrape sees the gateway,
        the router, and every replica's engine under one namespace."""
        self.router.export_fleet_gauges()
        return telemetry.prometheus_text()

    # -- request path ------------------------------------------------------

    def health(self):
        healthy = self.router.healthy_count()
        if self.router.draining:
            return 503, {"status": "draining", "healthy_replicas": healthy,
                         "retry_after_s": self.retry_after}
        if not healthy:
            return 503, {"status": "unhealthy", "healthy_replicas": 0}
        return 200, {"status": "ok", "healthy_replicas": healthy}

    def _admit(self, raw, tr=None):
        """Fault site, drain check, parse, backpressure, journal submit.
        Returns (entry_id, tenant, event queue); raises _Reject."""
        try:
            _fault.injector().raise_for("gateway.accept")
        except (ConnectionError, OSError) as e:
            raise _Reject(503, "injected",
                          {"error": f"fault injection: {e}"},
                          retry_after=self.retry_after) from None
        if self.router.draining:
            raise _Reject(503, "draining",
                          {"error": "fleet is draining (rolling restart); "
                                    "retry against the replacement fleet"},
                          retry_after=self.retry_after)
        try:
            payload = json.loads(raw or b"{}")
            prompt = payload["prompt"]
            max_new = int(payload["max_new_tokens"])
        except (ValueError, TypeError, KeyError) as e:
            raise _Reject(400, "error",
                          {"error": f"bad request body: {e!r}"}) from None
        tenant = str(payload.get("tenant", "default"))
        if self.router.tenant_depth(tenant) >= self.queue_limit:
            raise _Reject(429, "rejected",
                          {"error": f"tenant {tenant!r} queue is full "
                                    f"({self.queue_limit})"},
                          retry_after=self.retry_after)
        if self.router.min_occupancy() >= self.max_occupancy:
            raise _Reject(429, "rejected",
                          {"error": "KV page pools above "
                                    f"{self.max_occupancy:.0%} on every "
                                    "healthy replica"},
                          retry_after=self.retry_after)
        events = queue.Queue()
        try:
            entry_id = self.router.submit(
                prompt, max_new, eos_id=payload.get("eos_id"),
                tenant=tenant, sink=events.put,
                trace_ctx=(tr["tid"], tr["sid"]) if tr else None)
        except ValueError as e:
            raise _Reject(400, "error", {"error": str(e)}) from None
        except RuntimeError as e:
            raise _Reject(503, "draining" if "draining" in str(e)
                          else "error", {"error": str(e)},
                          retry_after=self.retry_after) from None
        return entry_id, tenant, payload.get("stream", True), events

    def handle_generate(self, handler):
        raw = handler.rfile.read(
            int(handler.headers.get("Content-Length") or 0))
        t0 = time.monotonic()
        tr = None
        if _dtrace.trace_active():
            # root span context: adopt the client's traceparent when it
            # sent one (external correlation), else start a fresh trace
            inbound = _dtrace.parse_traceparent(
                handler.headers.get("traceparent"))
            tr = {"tid": inbound[0] if inbound else _dtrace.new_id(),
                  "pid": inbound[1] if inbound else None,
                  "sid": _dtrace.new_id(), "ns": time.time_ns()}
            handler._trace = tr
        entry_id = tenant = None
        try:
            entry_id, tenant, stream, events = self._admit(raw, tr)
        except _Reject as rej:
            telemetry.inc(GW_REQUESTS_TOTAL, outcome=rej.outcome)
            handler._reply(rej.status, rej.body,
                           retry_after=rej.retry_after)
            self._finish_http(tr, t0, status=rej.status,
                              outcome=rej.outcome, tenant=tenant,
                              entry_id=None)
            return
        with self._inflight_lock:
            self._inflight += 1
            telemetry.set_gauge(GW_INFLIGHT, self._inflight)
        try:
            outcome = (self._stream_response(handler, entry_id, events)
                       if stream else
                       self._unary_response(handler, entry_id, events))
        except (BrokenPipeError, ConnectionResetError):
            outcome = "error"  # client went away mid-stream
        finally:
            with self._inflight_lock:
                self._inflight -= 1
                telemetry.set_gauge(GW_INFLIGHT, self._inflight)
        telemetry.inc(GW_REQUESTS_TOTAL, outcome=outcome)
        self._finish_http(tr, t0,
                          status=200 if outcome == "ok" else 500,
                          outcome=outcome, tenant=tenant,
                          entry_id=entry_id)

    def _finish_http(self, tr, t0, *, status, outcome, tenant, entry_id):
        """End-of-request bookkeeping: close the gateway.request root
        span and write the access-log line (rich journal-derived fields
        when the request got far enough to have an entry)."""
        dur_s = time.monotonic() - t0
        if tr is not None:
            rec = {"name": GATEWAY_SPAN, "tid": tr["tid"],
                   "sid": tr["sid"], "ts": tr["ns"],
                   "dur_ns": max(0, int(dur_s * 1e9)),
                   "lane": GATEWAY_LANE,
                   "extra": {"status": status, "outcome": outcome,
                             "tenant": tenant, "entry": entry_id}}
            if tr.get("pid"):
                rec["pid"] = tr["pid"]
            _dtrace.record_span(rec)
        if not self.access_log.enabled:
            return
        line = {"ts": time.time(), "method": "POST",
                "path": "/v1/generate", "status": status,
                "outcome": outcome, "tenant": tenant, "entry": entry_id,
                "latency_s": round(dur_s, 6),
                "trace_id": tr["tid"] if tr else None}
        if entry_id is not None:
            e = self.router.journal.get(entry_id)
            line.update({
                "tenant": e.tenant,
                "prompt_tokens": int(e.prompt.size),
                "output_tokens": len(e.tokens),
                "replica": e.replica_id,
                "failovers": e.resubmits,
                "finish_reason": e.finish_reason,
                "queue_wait_s": (round(e.assigned_at - e.submitted_at, 6)
                                 if e.assigned_at else None),
                "ttft_s": (round(e.first_token_at - e.submitted_at, 6)
                           if e.first_token_at else None)})
            if e.finished_at:
                line["latency_s"] = round(
                    e.finished_at - e.submitted_at, 6)
        self.access_log.write(line)

    def _next_event(self, events):
        try:
            return events.get(timeout=self.request_timeout)
        except queue.Empty:
            return {"event": "failed",
                    "error": f"gateway timeout after "
                             f"{self.request_timeout:g}s"}

    def _stream_response(self, handler, entry_id, events):
        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.send_header("X-Entry-Id", str(entry_id))
        tr = handler._trace
        if tr is not None:
            handler.send_header("Traceparent", _dtrace.format_traceparent(
                tr["tid"], tr["sid"]))
        # no Content-Length: HTTP/1.0 + Connection: close delimit the
        # stream, each event line flushes as the fleet produces it
        handler.send_header("Connection", "close")
        handler.end_headers()
        if tr is not None:
            # trace echo: streaming clients learn the trace id first,
            # before any token, so a hung stream is already correlatable
            handler.wfile.write((json.dumps(
                {"event": "trace", "trace_id": tr["tid"],
                 "entry_id": entry_id}) + "\n").encode())
            handler.wfile.flush()
        while True:
            ev = self._next_event(events)
            handler.wfile.write((json.dumps(ev) + "\n").encode())
            handler.wfile.flush()
            if ev.get("event") == "done":
                return "ok"
            if ev.get("event") == "failed":
                return "error"

    def _unary_response(self, handler, entry_id, events):
        while True:
            ev = self._next_event(events)
            if ev.get("event") == "done":
                body = {"entry_id": entry_id,
                        "tokens": ev["tokens"],
                        "finish_reason": ev["finish_reason"],
                        "resubmits": ev.get("resubmits", 0)}
                if handler._trace is not None:
                    body["trace_id"] = handler._trace["tid"]
                handler._reply(200, body)
                return "ok"
            if ev.get("event") == "failed":
                handler._reply(500, {"entry_id": entry_id,
                                     "error": ev.get("error", "failed")})
                return "error"
