"""Exporters: JSON dump, Prometheus text exposition, /metrics endpoint.

The port's copy of the JAX package's `telemetry/exporters.py`: the same
JSON schema, exposition text and quantile estimate, and the same
`/debug/*` handler registry (served only under MXTPU_DEBUG_ENDPOINTS).

`to_dict()`/`dump_json()` give a round-trippable JSON view of the whole
registry; `prometheus_text()` renders text exposition format 0.0.4
(the format every Prometheus/VictoriaMetrics/Grafana-agent scraper
speaks); `start_http_server()` serves it from a stdlib daemon thread —
no third-party client library, per the no-new-deps constraint.
"""
from __future__ import annotations

import json
import threading

from .metrics import REGISTRY

__all__ = ["to_dict", "dump_json", "prometheus_text", "start_http_server",
           "register_debug_handler", "unregister_debug_handler",
           "debug_handlers"]

# /debug/* endpoint registry: path -> zero-arg callable returning a
# JSON-serializable snapshot. Served by the telemetry HTTP server only
# when MXTPU_DEBUG_ENDPOINTS is on (introspection snapshots expose
# request ids — not every /metrics scraper should see them). Last
# registration per path wins: a replaced engine takes over its path.
_debug_lock = threading.Lock()
_debug_handlers: dict = {}


def register_debug_handler(path, provider):
    """Expose `provider()` (returning JSON-serializable data) at `path`
    on the telemetry HTTP server, gated by MXTPU_DEBUG_ENDPOINTS."""
    if not path.startswith("/debug/"):
        raise ValueError(f"debug handlers live under /debug/, got {path!r}")
    with _debug_lock:
        _debug_handlers[path] = provider


def unregister_debug_handler(path):
    with _debug_lock:
        _debug_handlers.pop(path, None)


def debug_handlers():
    """Snapshot of the registered /debug/* paths."""
    with _debug_lock:
        return dict(_debug_handlers)


def _fmt(value):
    """Prometheus sample value: integers render bare, floats via repr
    (repr round-trips; exposition format accepts scientific notation)."""
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(value):
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _render_labels(labels, extra=None):
    items = list(labels.items())
    if extra:
        items += list(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + body + "}"


def to_dict(registry=None):
    """Registry snapshot as plain JSON-serializable data. Histograms carry
    count/sum/min/max plus per-upper-bound bucket counts (non-cumulative;
    the exposition renderer cumulates)."""
    registry = registry or REGISTRY
    metrics = {}
    for metric in registry.collect():
        series = []
        for labels, child in metric.series():
            if metric.kind == "histogram":
                bounds, buckets, count, total, mn, mx = child.snapshot()
                series.append({
                    "labels": labels,
                    "count": count,
                    "sum": total,
                    "min": mn,
                    "max": mx,
                    "buckets": {str(b): n for b, n in zip(bounds, buckets)},
                    "overflow": buckets[-1],  # observations above max bound
                })
            else:
                series.append({"labels": labels, "value": child.value})
        metrics[metric.name] = {
            "type": metric.kind,
            "help": metric.help,
            "series": series,
        }
    return {"version": 1, "metrics": metrics}


def dump_json(path=None, registry=None):
    """Snapshot the registry; when `path` is given also write it as JSON.
    Returns the snapshot dict either way."""
    data = to_dict(registry)
    if path is not None:
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
    return data


def _estimate_quantile(bounds, buckets, count, mn, mx, q):
    """Quantile estimate by linear interpolation inside the bucket the
    target rank lands in (non-cumulative bucket counts; observations
    past the last bound resolve to the recorded max). Clamped to the
    child's [min, max] so sparse low buckets can't report a value no
    observation ever had."""
    if not count:
        return None
    target = q * count
    cum = 0.0
    lo = 0.0
    est = None
    for b, n in zip(bounds, buckets):
        if n and cum + n >= target:
            est = lo + (b - lo) * ((target - cum) / n)
            break
        cum += n
        lo = b
    if est is None:  # rank lives in the +Inf overflow bucket
        est = mx
    if mn is not None:
        est = max(est, mn)
    if mx is not None:
        est = min(est, mx)
    return est


# precomputed summary quantiles emitted per histogram child — scrapers
# get p50/p95/p99 without PromQL histogram_quantile math
_SUMMARY_QUANTILES = (("0.5", 0.5), ("0.95", 0.95), ("0.99", 0.99))


def prometheus_text(registry=None):
    """Text exposition format 0.0.4. Histogram buckets are cumulative and
    always include le="+Inf"; each histogram child also carries
    precomputed p50/p95/p99 samples under a `quantile` label (summary
    convention); counters keep whatever name they were registered under
    (instrumented sites use the `_total` convention)."""
    registry = registry or REGISTRY
    lines = []
    for metric in registry.collect():
        lines.append(f"# HELP {metric.name} {metric.help}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        for labels, child in metric.series():
            if metric.kind == "histogram":
                bounds, buckets, count, total, mn, mx = child.snapshot()
                cum = 0
                for b, n in zip(bounds, buckets):
                    cum += n
                    lines.append(
                        f"{metric.name}_bucket"
                        f"{_render_labels(labels, {'le': _fmt(b)})} {cum}")
                lines.append(
                    f"{metric.name}_bucket"
                    f"{_render_labels(labels, {'le': '+Inf'})} {count}")
                lines.append(
                    f"{metric.name}_sum{_render_labels(labels)} {_fmt(total)}")
                lines.append(
                    f"{metric.name}_count{_render_labels(labels)} {count}")
                for qlabel, q in _SUMMARY_QUANTILES:
                    est = _estimate_quantile(bounds, buckets, count, mn, mx, q)
                    if est is not None:
                        lines.append(
                            f"{metric.name}"
                            f"{_render_labels(labels, {'quantile': qlabel})}"
                            f" {_fmt(est)}")
            else:
                lines.append(
                    f"{metric.name}{_render_labels(labels)} "
                    f"{_fmt(child.value)}")
    return "\n".join(lines) + "\n"


class _MetricsServer:
    """Stdlib HTTP server answering GET /metrics with the exposition text.
    Daemon-threaded; `close()` for deterministic shutdown in tests."""

    def __init__(self, port, registry=None, host="0.0.0.0"):
        import http.server

        registry = registry or REGISTRY
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, body, content_type):
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from .. import config as _config

                path = self.path.split("?")[0]
                if path in ("/metrics", "/"):
                    self._reply(prometheus_text(outer.registry).encode(),
                                "text/plain; version=0.0.4")
                    return
                provider = debug_handlers().get(path)
                if (provider is not None
                        and _config.get("MXTPU_DEBUG_ENDPOINTS")):
                    try:
                        body = json.dumps(provider(), default=str).encode()
                    except Exception as e:  # snapshot bug: surface, not 404
                        self.send_error(
                            500, f"{type(e).__name__}: {e}")
                        return
                    self._reply(body, "application/json")
                    return
                self.send_error(404)

            def log_message(self, *args):
                pass  # scrapes must not spam the training logs

        self.registry = registry
        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="mxtpu-telemetry-http")
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def start_http_server(port, registry=None, host="0.0.0.0"):
    """Serve Prometheus exposition at http://host:port/metrics (port 0
    picks an ephemeral port; read it back from the returned server)."""
    return _MetricsServer(port, registry, host)
