"""Runtime sanitizers for the threaded runtime: lockdep + page refcounts.

The port's copy of the JAX package's `analysis/sanitizers.py`, with the
same MXS codes, metric, flight-recorder events and knobs. It covers what
only execution can see: lock-order inversions between the serving
fleet's threads (router, replica pumps, gateway handlers), blocking
calls made while a lock is held, and refcount bugs in the copy-on-write
KV page pool. The design follows kernel lockdep (a global lock-ORDER
graph over lock classes, so a potential ABBA deadlock is reported from a
single-threaded run that merely *establishes* both edges) and
ThreadSanitizer's shadow-state idea (an independent refcount/generation
map validates every page transition), scoped to what Python threads +
the GIL actually need.

Everything is off unless `MXTPU_SANITIZERS` lists a sanitizer:

    MXTPU_SANITIZERS=locks,pages,threads

- ``locks``  — `san_lock(name)` / `san_rlock(name)` / `san_condition(name)`
  return instrumented primitives that maintain the lock-order graph,
  flag blocking ops under a held lock (`time.sleep`, `queue.Queue`
  waits, condition waits, and explicit `note_blocking()` sites), and
  flag long hold times (> `MXTPU_SANITIZER_HOLD_MS`).
- ``pages``  — `attach_page_sanitizer(allocator)` arms a shadow-state
  checker that validates every alloc/share/cow/free against its own
  refcount map and per-page generation counters; `assert_quiescent()`
  proves at engine drain that every live reference is owned.
- ``threads`` — accepted for the JAX package's knob value; it has no
  runtime hook (it gates a lint the port does not have).

When the knob is UNSET the factories return *plain* `threading`
primitives — the only cost of the disabled path is one module-load
branch at lock-creation time; there is no per-acquire indirection.
`san_lock(name, lock)` instruments an existing mutex instead of a new
one: a process-wide lock created before the sanitizers were armed
(`graphs`' capture lock) takes part in the order graph whenever the
locks sanitizer is on at the time it is acquired.

Findings carry stable `MXS0xx` codes (catalog below) through the
`Diagnostic`/`Report` machinery of `diagnostics`, feed the
`mxtpu_sanitizer_findings_total{sanitizer,code}` counter, and log
`sanitizer_finding` flight-recorder events, so a test, a dashboard, and
a post-mortem dump all see the same shape.
"""
from __future__ import annotations

import atexit
import queue
import sys
import threading
import time
import traceback

from .. import config as _config
from .diagnostics import Diagnostic, Report, Severity

__all__ = [
    "MXS_CATALOG", "SanitizerError", "PageSanitizer",
    "enabled", "enabled_set", "refresh_from_env", "reset",
    "san_lock", "san_rlock", "san_condition",
    "note_blocking", "report", "findings",
    "attach_page_sanitizer",
]

FINDINGS_TOTAL = "mxtpu_sanitizer_findings_total"
_FINDINGS_HELP = ("Findings emitted by the runtime sanitizers "
                  "(MXTPU_SANITIZERS), by sanitizer and MXS code.")

# code -> (severity, one-line summary); tests assert every emitted code
# is cataloged.
MXS_CATALOG = {
    # LockSanitizer
    "MXS001": (Severity.ERROR, "lock-order inversion: the lock-order "
                               "graph contains a cycle (potential ABBA "
                               "deadlock)"),
    "MXS002": (Severity.WARNING, "blocking operation (sleep / queue wait "
                                 "/ condition wait / socket) invoked "
                                 "while holding a sanitized lock"),
    "MXS003": (Severity.WARNING, "lock held longer than "
                                 "MXTPU_SANITIZER_HOLD_MS"),
    # PageSanitizer
    "MXS010": (Severity.ERROR, "page double-free: free/release of a page "
                               "whose shadow refcount is already zero"),
    "MXS011": (Severity.ERROR, "page use-after-free: a mapping or write "
                               "refers to a page whose generation counter "
                               "moved on (freed and reallocated)"),
    "MXS012": (Severity.ERROR, "copy-on-write violation: write into a "
                               "page whose refcount is > 1 (shared "
                               "read-only)"),
    "MXS013": (Severity.ERROR, "refcount leak at drain: live references "
                               "not accounted for by any registered "
                               "owner mapping"),
    "MXS014": (Severity.ERROR, "shadow-state divergence: allocator "
                               "refcounts disagree with the sanitizer's "
                               "shadow map"),
}

_VALID = frozenset({"locks", "pages", "threads"})


class SanitizerError(AssertionError):
    """Raised by `assert_quiescent()` (and other hard checks) with the
    sanitizer report attached."""

    def __init__(self, rep):
        self.report = rep
        super().__init__(str(rep))


# -- knob resolution (module-load branch; refresh_from_env for tests) --------

def _parse(raw):
    toks = {t.strip().lower() for t in str(raw or "").split(",") if t.strip()}
    if toks - _VALID:
        raise ValueError(
            f"MXTPU_SANITIZERS: unknown sanitizer(s) {sorted(toks - _VALID)}"
            f"; valid: {sorted(_VALID)}")
    return frozenset(toks)


_enabled_set = _parse(_config.get("MXTPU_SANITIZERS"))


def enabled_set():
    """The active sanitizer set (frozenset of 'locks'/'pages'/'threads')."""
    return _enabled_set


def enabled(kind):
    """Whether one sanitizer ('locks', 'pages', 'threads') is active."""
    return kind in _enabled_set


def refresh_from_env():
    """Re-resolve MXTPU_SANITIZERS (tests that monkeypatch env) and
    clear all sanitizer state. Only PRIMITIVES CREATED AFTER the refresh
    pick up the new setting — locks are resolved plain-vs-instrumented
    at creation time (that is the zero-cost-when-off contract)."""
    global _enabled_set
    reset()
    _deactivate_blocking_patches()
    _enabled_set = _parse(_config.get("MXTPU_SANITIZERS"))
    if "locks" in _enabled_set:
        _activate_blocking_patches()
    return _enabled_set


# -- findings sink ------------------------------------------------------------

_report = Report(graph_name="sanitizers")
_seen = {}                     # (code, detail) -> Diagnostic
_findings_lock = threading.Lock()


def _emit(code, sanitizer, message, detail):
    """Record one deduped finding and fan it out to telemetry + the
    flight recorder. Dedup key is (code, detail) so a hot loop reports a
    site once, not once per iteration; a re-emission returns the
    already-recorded diagnostic (repeated drain checks stay truthful)."""
    with _findings_lock:
        prior = _seen.get((code, detail))
        if prior is not None:
            return prior
        diag = Diagnostic(code=code, severity=MXS_CATALOG[code][0],
                          message=message, detail=detail)
        _seen[(code, detail)] = diag
        _report.append(diag)
    try:
        from .. import telemetry
        telemetry.inc(FINDINGS_TOTAL, help=_FINDINGS_HELP,
                      sanitizer=sanitizer, code=code)
        telemetry.recorder.log_event("sanitizer_finding",
                                     sanitizer=sanitizer, code=code,
                                     detail=detail)
    except Exception:
        pass  # a finding must never take the runtime down with it
    return diag


def report():
    """Snapshot Report of every finding so far."""
    with _findings_lock:
        return Report(list(_report), graph_name="sanitizers")


def findings(code=None):
    """Finding list, optionally filtered by MXS code."""
    rep = report()
    return rep.by_code(code) if code else list(rep)


def reset():
    """Clear findings, the lock-order graph, and held-lock state (the
    enabled set is untouched — use refresh_from_env to re-resolve)."""
    global _report
    with _findings_lock:
        _report = Report(graph_name="sanitizers")
        _seen.clear()
    with _graph_lock:
        _adj.clear()
        _edge_info.clear()
    _tls.__dict__.clear()


_hold_ms = None


def _hold_threshold_ms():
    global _hold_ms
    if _hold_ms is None:
        _hold_ms = float(_config.get("MXTPU_SANITIZER_HOLD_MS"))
    return _hold_ms


# ============================================================================
# LockSanitizer: lock-order graph + blocking-op + hold-time checks
# ============================================================================

_tls = threading.local()          # per-thread: held = [(name, t0, site)]
_graph_lock = threading.Lock()
_adj: dict = {}                   # name -> set(successor names)
_edge_info: dict = {}             # (a, b) -> {"site", "stack"}


def _held():
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _call_site(depth=3):
    """file:line of the first frame outside this module — the
    acquisition site that keys the order graph's provenance."""
    f = sys._getframe(depth)
    while f is not None and f.f_code.co_filename.endswith("sanitizers.py"):
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


def _stack():
    return "".join(traceback.format_stack(sys._getframe(3), limit=10))


def _find_path(src, dst):
    """DFS path src -> dst over the order graph (None when absent)."""
    stack, seen = [(src, [src])], {src}
    while stack:
        node, path = stack.pop()
        for nxt in _adj.get(node, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _before_acquire(name):
    """Called BEFORE blocking on `name`: record order edges held->name
    and check for a cycle. Running before the blocking acquire means an
    actual deadlock still gets its report out."""
    held = _held()
    if not held:
        return
    site = _call_site()
    for held_name, _t0, held_site in held:
        if held_name == name:
            continue  # same lock class re-entry (RLock) — not an edge
        edge = (held_name, name)
        with _graph_lock:
            if edge in _edge_info:
                continue
            _edge_info[edge] = {"site": f"{held_site} -> {site}",
                                "stack": _stack()}
            _adj.setdefault(held_name, set()).add(name)
            back = _find_path(name, held_name)
        if back is not None:
            cycle = [held_name] + back  # held -> name -> ... -> held
            rev = _edge_info.get((back[0], back[1])) if len(back) > 1 \
                else None
            _emit(
                "MXS001", "locks",
                "potential deadlock: acquiring "
                f"{name!r} while holding {held_name!r} closes the "
                f"lock-order cycle {' -> '.join(cycle)}.\n"
                f"-- this acquisition ({held_site} -> {site}):\n"
                f"{_edge_info[edge]['stack']}"
                + (f"-- prior reverse edge "
                   f"({rev['site']}):\n{rev['stack']}" if rev else ""),
                detail=" -> ".join(_canonical_cycle(cycle)))


def _canonical_cycle(cycle):
    """Rotate a cycle (last element == first) so the lexicographically
    smallest name leads — one stable dedup key per distinct cycle."""
    ring = cycle[:-1]
    k = ring.index(min(ring))
    ring = ring[k:] + ring[:k]
    return ring + [ring[0]]


def _after_acquire(name):
    _held().append((name, time.monotonic(), _call_site()))


def _after_release(name):
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == name:
            _n, t0, site = held.pop(i)
            dt_ms = (time.monotonic() - t0) * 1000.0
            if dt_ms > _hold_threshold_ms():
                _emit("MXS003", "locks",
                      f"lock {name!r} held {dt_ms:.1f} ms at {site} "
                      f"(threshold MXTPU_SANITIZER_HOLD_MS="
                      f"{_hold_threshold_ms():g})",
                      detail=f"{name}@{site}")
            return


def note_blocking(op, exclude=None):
    """Report MXS002 when the calling thread holds any sanitized lock
    (other than `exclude`). Instrumented blocking sites (sockets, other
    waits) call this; `time.sleep` and `queue.Queue` waits are
    patched automatically while the locks sanitizer is active."""
    held = [h for h in _held() if h[0] != exclude]
    if not held:
        return
    names = [h[0] for h in held]
    site = _call_site()
    _emit("MXS002", "locks",
          f"blocking operation {op!r} at {site} while holding "
          f"lock(s) {names} — a peer waiting on {names[-1]!r} stalls "
          f"behind this wait",
          detail=f"{op}@{site}:{names[-1]}")


# -- blocking-op patches (installed only while the locks sanitizer is on) ----

_real_sleep = None
_real_qget = None
_real_qput = None


def _activate_blocking_patches():
    global _real_sleep, _real_qget, _real_qput
    if _real_sleep is not None:
        return
    _real_sleep = time.sleep
    _real_qget = queue.Queue.get
    _real_qput = queue.Queue.put

    def _sleep(secs):
        note_blocking(f"time.sleep({secs})")
        return _real_sleep(secs)

    def _get(self, block=True, timeout=None):
        if block:
            note_blocking("queue.Queue.get")
        return _real_qget(self, block, timeout)

    def _put(self, item, block=True, timeout=None):
        if block and self.maxsize > 0:
            note_blocking("queue.Queue.put")
        return _real_qput(self, item, block, timeout)

    time.sleep = _sleep
    queue.Queue.get = _get
    queue.Queue.put = _put


def _deactivate_blocking_patches():
    global _real_sleep, _real_qget, _real_qput
    if _real_sleep is None:
        return
    time.sleep = _real_sleep
    queue.Queue.get = _real_qget
    queue.Queue.put = _real_qput
    _real_sleep = _real_qget = _real_qput = None


if "locks" in _enabled_set:
    _activate_blocking_patches()


# -- instrumented primitives --------------------------------------------------

class _SanLock:
    """Instrumented threading.Lock: order-graph edges, blocking-op and
    hold-time checks. Same duck type as threading.Lock."""

    __slots__ = ("name", "_lock")

    def __init__(self, name, lock=None):
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, blocking=True, timeout=-1):
        if blocking:
            _before_acquire(self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _after_acquire(self.name)
        return ok

    def release(self):
        self._lock.release()
        _after_release(self.name)

    def locked(self):
        return self._lock.locked()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<SanLock {self.name!r} {self._lock!r}>"


class _SanRLock:
    """Instrumented threading.RLock; re-entrant acquires of the same
    lock add no order edges (lockdep's same-class rule)."""

    __slots__ = ("name", "_lock", "_depth")

    def __init__(self, name):
        self.name = name
        self._lock = threading.RLock()
        self._depth = 0  # guarded by _lock itself

    def acquire(self, blocking=True, timeout=-1):
        first = not self._lock._is_owned() \
            if hasattr(self._lock, "_is_owned") else True
        if blocking and first:
            _before_acquire(self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._depth += 1
            if self._depth == 1:
                _after_acquire(self.name)
        return ok

    def release(self):
        self._depth -= 1
        last = self._depth == 0
        self._lock.release()
        if last:
            _after_release(self.name)

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


class _SanCondition:
    """Instrumented threading.Condition. `wait` is itself a blocking op:
    waiting while holding any OTHER sanitized lock reports MXS002 (the
    classic lost-wakeup/deadlock shape)."""

    __slots__ = ("name", "_cond")

    def __init__(self, name):
        self.name = name
        self._cond = threading.Condition()

    def acquire(self, blocking=True, timeout=-1):
        if blocking:
            _before_acquire(self.name)
        ok = self._cond.acquire(blocking, timeout) if timeout != -1 \
            else self._cond.acquire(blocking)
        if ok:
            _after_acquire(self.name)
        return ok

    def release(self):
        self._cond.release()
        _after_release(self.name)

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def wait(self, timeout=None):
        note_blocking(f"condition.wait({self.name})", exclude=self.name)
        _after_release(self.name)  # wait() drops the lock for its nap
        try:
            return self._cond.wait(timeout)
        finally:
            _after_acquire(self.name)

    def wait_for(self, predicate, timeout=None):
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n=1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()


def san_lock(name, lock=None):
    """Named lock factory for the runtime packages. Plain
    `threading.Lock()` when the locks sanitizer is off (resolved once,
    at creation — no per-acquire indirection); an instrumented lock
    participating in the global order graph when it is on. `name` is the
    lock CLASS (lockdep sense): every replica's lock shares one class.
    `lock` is an existing mutex to hand back (off) or instrument (on)
    in place of a new one."""
    if "locks" not in _enabled_set:
        return lock if lock is not None else threading.Lock()
    return _SanLock(name, lock)


def san_rlock(name):
    if "locks" not in _enabled_set:
        return threading.RLock()
    return _SanRLock(name)


def san_condition(name):
    if "locks" not in _enabled_set:
        return threading.Condition()
    return _SanCondition(name)


# ============================================================================
# PageSanitizer: shadow refcounts + generation counters for the KV pool
# ============================================================================

class PageSanitizer:
    """Shadow-state checker for a `serving.pages.PageAllocator`.

    Maintains an INDEPENDENT refcount map and a per-page generation
    counter (bumped on every allocation), plus an owner->page->generation
    mapping registry fed by the `owner=` provenance the allocator call
    sites pass (request ids, "prefix_cache"). Every transition the
    allocator performs is validated against the shadow state:

    - free/release at shadow refcount 0         -> MXS010 (double free)
    - share/cow/write of a page whose recorded
      generation moved on                       -> MXS011 (use-after-free)
    - write into a page with refcount > 1       -> MXS012 (COW violation)
    - drain-time references owned by nobody     -> MXS013 (leak)
    - shadow map != allocator refcounts         -> MXS014 (divergence)
    """

    def __init__(self, allocator=None):
        self.allocator = allocator
        self._refs: dict[int, int] = {}
        self._gen: dict[int, int] = {}
        self._next_gen = 0
        self._maps: dict = {}   # owner -> {page: gen-at-map-time}

    # -- transition hooks (called by PageAllocator) -----------------------

    def on_alloc(self, pages, owner=None):
        for p in pages:
            if self._refs.get(p, 0) != 0:
                self._emit_page(
                    "MXS014",
                    f"alloc handed out page {p} which the shadow map "
                    f"still holds at refcount {self._refs[p]}",
                    f"alloc:{p}")
            self._next_gen += 1
            self._refs[p] = 1
            self._gen[p] = self._next_gen
            self._map(owner, p)

    def on_share(self, pages, owner=None):
        for p in pages:
            if self._refs.get(p, 0) == 0:
                self._emit_page(
                    "MXS011",
                    f"share of page {p} at shadow refcount 0 — the new "
                    f"table would read recycled garbage "
                    f"(generation {self._gen.get(p, 0)})",
                    f"share:{p}:g{self._gen.get(p, 0)}")
                continue
            self._refs[p] += 1
            self._map(owner, p)

    def on_cow(self, page, new_page, owner=None):
        """cow() moved one reference off shared `page` onto exclusive
        `new_page` (whose alloc hook already ran). `new_page is None`
        means the pool had no page for the copy (no transition)."""
        if self._refs.get(page, 0) == 0:
            self._emit_page(
                "MXS011",
                f"cow of page {page} at shadow refcount 0",
                f"cow:{page}:g{self._gen.get(page, 0)}")
            return
        if new_page is None or new_page == page:
            return  # exhausted, or caller already exclusive
        self._refs[page] -= 1
        self._unmap(owner, page)
        self._map(owner, new_page)

    def on_free(self, pages, owner=None):
        for p in pages:
            refs = self._refs.get(p, 0)
            if refs == 0:
                self._emit_page(
                    "MXS010",
                    f"double free of page {p} (shadow refcount already "
                    f"0; generation {self._gen.get(p, 0)})",
                    f"free:{p}:g{self._gen.get(p, 0)}")
                continue
            self._refs[p] = refs - 1
            if self._refs[p] == 0:
                del self._refs[p]
            self._unmap(owner, p)

    # -- owner mapping registry -------------------------------------------

    def _map(self, owner, page):
        if owner is None:
            return
        self._maps.setdefault(owner, {})[page] = self._gen.get(page, 0)

    def _unmap(self, owner, page):
        if owner is None:
            return
        m = self._maps.get(owner)
        if m is not None:
            m.pop(page, None)
            if not m:
                self._maps.pop(owner, None)

    # -- write-side checks (engine decode/prefill paths) -------------------

    def note_write(self, owner, pages):
        """The engine is about to write K/V into `pages` on behalf of
        `owner`: a shared page here means the COW discipline failed."""
        for p in pages:
            refs = self._refs.get(p, 0)
            if refs == 0:
                self._emit_page(
                    "MXS011",
                    f"write into page {p} by {owner!r} at shadow "
                    f"refcount 0 (freed page still mapped in a table "
                    f"row)",
                    f"write-uaf:{p}:g{self._gen.get(p, 0)}")
            elif refs > 1:
                self._emit_page(
                    "MXS012",
                    f"write into SHARED page {p} (refcount {refs}) by "
                    f"{owner!r} — other tables map it read-only; it "
                    f"must copy-on-write first",
                    f"write-shared:{p}:{owner}")
            m = self._maps.get(owner)
            if m is not None and p in m and m[p] != self._gen.get(p, 0):
                self._emit_page(
                    "MXS011",
                    f"stale mapping: {owner!r} mapped page {p} at "
                    f"generation {m[p]} but the page is now generation "
                    f"{self._gen.get(p, 0)} (freed and reallocated "
                    f"under a live table row)",
                    f"stale:{p}:{owner}")

    # -- drain-time accounting ---------------------------------------------

    def check(self):
        """Run the quiescence accounting WITHOUT raising; returns the
        list of new findings. At drain every live shadow reference must
        be owned by a registered mapping at the current generation, and
        the shadow map must agree with the allocator."""
        out = []

        def keep(d):
            if d is not None:
                out.append(d)

        # stale mappings (generation moved under a registered owner)
        for owner, m in sorted(self._maps.items(), key=lambda kv: str(kv[0])):
            for p, g in sorted(m.items()):
                if self._gen.get(p, 0) != g:
                    keep(self._emit_page(
                        "MXS011",
                        f"{owner!r} still maps page {p} at generation "
                        f"{g}; page is now generation "
                        f"{self._gen.get(p, 0)}",
                        f"drain-stale:{p}:{owner}"))
        # per-page reference accounting: refs == number of owner mappings
        owned: dict[int, int] = {}
        for m in self._maps.values():
            for p in m:
                owned[p] = owned.get(p, 0) + 1
        for p, refs in sorted(self._refs.items()):
            n_owned = owned.get(p, 0)
            if refs != n_owned:
                owners = sorted(str(o) for o, m in self._maps.items()
                                if p in m)
                keep(self._emit_page(
                    "MXS013",
                    f"page {p} holds {refs} reference(s) at drain but "
                    f"only {n_owned} owner mapping(s) account for them "
                    f"(owners: {owners or 'none'}) — "
                    f"{refs - n_owned:+d} leaked reference(s)",
                    f"leak:{p}"))
        # shadow vs allocator divergence (an allocator bug, not a user one)
        if self.allocator is not None:
            actual = dict(getattr(self.allocator, "_refs", {}))
            if actual != self._refs:
                delta = {p: (self._refs.get(p, 0), actual.get(p, 0))
                         for p in set(actual) | set(self._refs)
                         if actual.get(p, 0) != self._refs.get(p, 0)}
                keep(self._emit_page(
                    "MXS014",
                    f"shadow refcounts diverged from the allocator: "
                    f"{{page: (shadow, actual)}} = {delta}",
                    "divergence"))
        return out

    def assert_quiescent(self):
        """Raise SanitizerError when drain-time accounting finds a leak,
        a stale mapping, or shadow divergence. Serving tests and the
        bench call this at end of run."""
        bad = self.check()
        if bad:
            raise SanitizerError(Report(bad, graph_name="page-sanitizer"))
        return True

    # -- plumbing ----------------------------------------------------------

    @staticmethod
    def _emit_page(code, message, detail):
        return _emit(code, "pages", message, detail)


def attach_page_sanitizer(allocator, force=False):
    """Arm a PageSanitizer on `allocator` when the pages sanitizer is
    enabled (or `force=True`, for tests): the allocator's transition
    hooks start feeding it. Returns the sanitizer, or None when off."""
    if not force and "pages" not in _enabled_set:
        return None
    san = PageSanitizer(allocator)
    allocator.sanitizer = san
    return san


# -- end-of-process visibility ------------------------------------------------

@atexit.register
def _report_at_exit():
    """Print the findings summary at interpreter exit so subprocess
    scenarios surface findings without a side channel. Stable grep
    token: '[sanitizers]'."""
    if not _enabled_set:
        return
    rep = report()
    if rep:
        print(f"[sanitizers] {len(rep)} finding(s):", file=sys.stderr)
        for d in rep:
            print(f"[sanitizers] {d.code} {d.severity}: "
                  f"{d.message.splitlines()[0]}", file=sys.stderr)
