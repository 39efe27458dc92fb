"""Online serving: continuous batching over a paged KV cache.

`pages.PageAllocator` owns the global KV page pool; `engine.ServingEngine`
advances a fixed set of decode slots one token per step through the
`paged_decode_attention` kernel; `trace.run_trace` drives the seeded
mixed-length trace and reports the engine's deterministic counters.
"""
from .pages import NULL_PAGE, PageAllocator, PrefixCache  # noqa: F401
from .engine import Request, RequestResult, ServingEngine  # noqa: F401
from .trace import make_trace, run_trace  # noqa: F401

__all__ = ["NULL_PAGE", "PageAllocator", "PrefixCache", "Request",
           "RequestResult", "ServingEngine", "make_trace", "run_trace"]
