"""Runtime analysis: the sanitizers (codes MXS0xx) and the structured
diagnostics they report through.

`sanitizers` holds opt-in runtime checkers for the threaded serving
runtime: lock-order/deadlock detection, blocking calls and long holds
under a lock, and the KV-page refcount shadow state, enabled per process
with `MXTPU_SANITIZERS=locks,pages,threads` and free when off. The JAX
package's static passes (`passes`, `mxlint`) are not ported.
"""
from .diagnostics import Diagnostic, Report, Severity  # noqa: F401
from .sanitizers import (  # noqa: F401
    MXS_CATALOG, PageSanitizer, SanitizerError, attach_page_sanitizer,
    san_condition, san_lock, san_rlock,
)

__all__ = [
    "Diagnostic", "Report", "Severity",
    "MXS_CATALOG", "PageSanitizer", "SanitizerError",
    "attach_page_sanitizer", "san_condition", "san_lock", "san_rlock",
]
