"""Online serving: continuous batching over a paged KV cache, and the
fault-tolerant fleet in front of it.

`pages.PageAllocator` owns the global KV page pool; `engine.ServingEngine`
advances a fixed set of decode slots one token per step through the
`paged_decode_attention` kernel; `trace.run_trace` drives the seeded
mixed-length trace and reports the engine's deterministic counters.
`fleet.FleetRouter` journals requests over several engines (`Replica`s)
with heartbeat failover, drains and rolling restarts, and
`gateway.ServingGateway` serves it over HTTP with streaming and
backpressure.
"""
from .pages import NULL_PAGE, PageAllocator, PrefixCache  # noqa: F401
from .engine import Request, RequestResult, ServingEngine  # noqa: F401
from .trace import make_trace, run_trace  # noqa: F401
from .fleet import (  # noqa: F401
    FleetRouter, JournalEntry, Replica, RequestJournal)
from .gateway import ServingGateway  # noqa: F401

__all__ = ["NULL_PAGE", "PageAllocator", "PrefixCache", "Request",
           "RequestResult", "ServingEngine", "make_trace", "run_trace",
           "FleetRouter", "JournalEntry", "Replica", "RequestJournal",
           "ServingGateway"]
