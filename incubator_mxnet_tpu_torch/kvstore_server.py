"""The server role (`incubator_mxnet_tpu/kvstore_server.py`; ref:
python/mxnet/kvstore_server.py KVStoreServer).

The server loop is `ps.ParameterServer`, the weight store behind
kvstore type 'dist_async_server'. A process launched with
`MXTPU_ROLE=server` (or `DMLC_ROLE=server`) runs the loop when the
package is imported and exits when a worker stops it; `python -m
incubator_mxnet_tpu_torch.kvstore_server` is an explicit request to
serve.
"""
from __future__ import annotations

import logging
import os
import sys

from .ps import ParameterServer, default_server_addr

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


def _server_metrics_port(num_workers):
    """/metrics port for a PS server process: the configured base port
    offset by the worker count, so on a shared host the workers (who sit
    at the base port) and the server never collide. None when no port is
    configured."""
    from . import config as _config

    base = _config.get("MXNET_TELEMETRY_PORT")
    if base <= 0:
        return None
    return base + int(num_workers)


class KVStoreServer:
    """Blocking wrapper running the parameter-server loop in this
    process."""

    def __init__(self, kvstore=None, num_workers=None, host=None, port=None):
        self.kvstore = kvstore  # accepted for API parity; the server loop
        # here is self-contained and does not need a worker-side store
        if num_workers is None:
            # launcher wire protocol (reference DMLC_* pairing) -- raw env
            # read by design, like MXTPU_ROLE below
            num_workers = int(os.environ.get(  # mxlint: disable=MXL007
                "MXTPU_NUM_WORKERS",
                os.environ.get("DMLC_NUM_WORKER", "1")))
        self.metrics_server = None
        from . import config as _config

        if _config.get("MXNET_TELEMETRY"):
            # server-side counters (dedup hits, evictions) are useless if
            # nobody can scrape them: bind this role's offset port BEFORE
            # telemetry auto-resolution can grab the base one
            metrics_port = _server_metrics_port(num_workers)
            if metrics_port is not None:
                from . import telemetry as _telemetry

                self.metrics_server = _telemetry.enable(port=metrics_port)
        addr_host, addr_port = default_server_addr()
        self._server = ParameterServer(
            num_workers=num_workers,
            host=host if host is not None else addr_host,
            port=port if port is not None else addr_port)
        # elastic membership state, visible from process start: the
        # epoch gauge must exist (at 0) before the first join bumps it,
        # so dashboards can tell "no membership change yet" from "no
        # server"
        cap = _config.get("MXTPU_MAX_WORKERS")
        from . import telemetry as _telemetry

        _telemetry.set_gauge(
            "mxtpu_ps_membership_epoch", 0,
            help="Current membership epoch of the ParameterServer; bumps "
                 "on every membership change (readmission, rank "
                 "takeover, world growth).")
        logging.getLogger(__name__).info(
            "parameter server on %s:%d — world %d, elastic cap %s",
            self._server.host, self._server.port, num_workers,
            cap if cap > 0 else "off (fixed world)")

    def run(self):
        """Serve until every worker has disconnected (the reference's
        MXKVStoreRunServer blocking contract)."""
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)-15s Server %(message)s")
        self._server.serve_forever()


def _init_kvstore_server_module():
    """If this process was launched in the server role, run the server
    loop and exit — mirrors the reference's import-time role check."""
    # launcher wire protocol, read before any framework import may
    # finish (paired with the reference DMLC_* names) -- stays a raw
    # env read by design
    role = os.environ.get("MXTPU_ROLE",  # mxlint: disable=MXL007
                          os.environ.get("DMLC_ROLE", ""))
    if role == "server":
        server = KVStoreServer()
        server.run()
        sys.exit(0)


if __name__ == "__main__":
    # `python -m incubator_mxnet_tpu_torch.kvstore_server` is an explicit
    # request to serve: override any inherited role env
    os.environ["MXTPU_ROLE"] = "server"
    _init_kvstore_server_module()
