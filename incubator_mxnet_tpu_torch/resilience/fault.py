"""Deterministic seeded fault injection for chaos runs.

The port's copy of the JAX package's `resilience/fault.py`: the same
grammar, sites and per-(site, instance) `random.Random` streams, so a
spec and seed fire the same faults at the same calls in both packages.

`MXTPU_FAULT_SPEC` names the faults; the framework's injection sites
consult the process-wide injector at well-defined points. Grammar::

    spec     := rule (";" rule)*
    rule     := site ":" mode "@" arg
    site     := dotted name (ps.rpc | ps.rpc.recv | ps.connect |
                ckpt.write | data.fetch | grad.nonfinite | train.step |
                gateway.accept | replica.rpc | replica.kill)
    mode     := drop | fail | torn | sigterm | delay
    arg      := probability (float in [0,1)) | call indices (int[,int...])
    arg      := ms | ms "x" (probability | indices)      # delay mode only

Examples::

    ps.rpc:drop@0.05            # drop ~5% of RPC sends (seeded PRNG)
    ps.rpc.recv:drop@3,7        # drop the reply of calls 3 and 7 exactly
    ckpt.write:fail@2           # the 2nd checkpoint write raises mid-write
    ckpt.write:torn@3           # the 3rd write leaves a torn canonical file
    data.fetch:fail@4           # the 4th DataLoader batch fetch raises
    grad.nonfinite:fail@7       # poison step 7's gradients with a NaN
    train.step:sigterm@5        # deliver SIGTERM to self at step 5
                                # (a deterministic preemption)
    gateway.accept:fail@0.1     # the serving gateway 503s ~10% of accepts
    replica.kill:fail@8         # a serving replica dies abruptly at its
                                # 8th scheduler pump (mid-stream failover)
    replica.rpc:delay@50        # every router<->replica exchange takes
                                # 50 ms extra (a SLOW replica, not a dead
                                # one — heartbeats go stale while the
                                # replica keeps producing)
    replica.rpc:delay@50x3,4    # only exchanges 3 and 4 are slow
    replica.rpc:delay@50x0.2    # ~20% of exchanges are slow (seeded)

`sigterm` is the preemption mode: the site delivers SIGTERM to its own
process, exercising the graceful-shutdown drain (resilience.preemption)
at an exactly reproducible step. `grad.nonfinite` is consulted by the
Trainer's divergence guardrail: any fired mode at that site multiplies
the gradients by NaN before the non-finite check, so guardrail policies
(skip / backoff / rollback) replay deterministically. `delay` is the
slow-node mode: a fired call sleeps its rule's milliseconds in place
(sites consult it through `sleep_for`/`raise_for`), which is how the
serving fleet's chaos legs produce a live-but-stale replica whose
requests fail over while it still streams (the duplicate-delivery path
the journal must dedup). The serving-fleet sites: `gateway.accept` is
consulted once per HTTP request before admission, `replica.rpc` once
per router->replica dispatch and once per scheduler pump (the instance
tag is the replica id), and `replica.kill` once per pump — ANY fired
mode there kills the replica abruptly: no drain, no more heartbeats,
its in-flight requests recover only through journal failover.

Determinism: every (site, instance) pair owns an independent call counter
and PRNG stream seeded from `MXTPU_FAULT_SEED` — concurrent clients do
not interleave each other's streams, so a chaos schedule replays exactly
when each client's own call sequence is deterministic. `instance` is a
caller-chosen stable tag (e.g. the worker rank); the empty instance is a
shared stream for single-threaded sites.

Faults raise dedicated exception types (`InjectedConnectionError`,
`InjectedIOError`) that subclass what the real failure would raise, so
every handler on the real path is exercised while logs stay attributable.
"""
from __future__ import annotations

import random
import threading
import time

__all__ = ["FaultInjector", "InjectedConnectionError", "InjectedIOError",
           "injector", "install", "refresh_from_env"]

_FAULT_METRIC = "mxtpu_fault_injections_total"
_FAULT_HELP = ("Faults fired by the deterministic injector "
               "(MXTPU_FAULT_SPEC), by site and mode.")

_MODES = ("drop", "fail", "torn", "sigterm", "delay")


class InjectedConnectionError(ConnectionError):
    """A fault-injected connection drop (mode `drop`)."""


class InjectedIOError(OSError):
    """A fault-injected IO failure (mode `fail`)."""


class _Rule:
    __slots__ = ("site", "mode", "prob", "indices", "delay_ms")

    def __init__(self, site, mode, prob, indices, delay_ms=None):
        self.site = site
        self.mode = mode
        self.prob = prob          # float or None
        self.indices = indices    # frozenset of 1-based call indices or None
        self.delay_ms = delay_ms  # float ms (mode "delay" only)


def _parse_spec(spec):
    rules = {}
    for part in filter(None, (p.strip() for p in (spec or "").split(";"))):
        try:
            site, rest = part.split(":", 1)
            mode, arg = rest.split("@", 1)
        except ValueError:
            raise ValueError(
                f"bad MXTPU_FAULT_SPEC rule {part!r}; expected "
                "site:mode@arg (see docs/FAULT_TOLERANCE.md)") from None
        site, mode = site.strip(), mode.strip()
        if mode not in _MODES:
            raise ValueError(
                f"bad MXTPU_FAULT_SPEC mode {mode!r} in {part!r}; "
                f"expected one of {_MODES}")
        prob = indices = delay_ms = None
        if mode == "delay":
            # delay arg: "<ms>" (every call) or "<ms>x<prob-or-indices>"
            ms, sep, arg = arg.partition("x")
            if sep and not arg:
                raise ValueError(
                    f"bad MXTPU_FAULT_SPEC delay selector in {part!r}; "
                    "expected delay@msxselector")
            try:
                delay_ms = float(ms)
            except ValueError:
                raise ValueError(
                    f"bad MXTPU_FAULT_SPEC delay {ms!r} in {part!r}; "
                    "expected milliseconds (delay@ms or "
                    "delay@msxselector)") from None
            if delay_ms < 0:
                raise ValueError(
                    f"MXTPU_FAULT_SPEC delay in {part!r} must be >= 0 ms")
            if not arg:  # no selector: the rule fires on every call
                if site in rules:
                    raise ValueError(
                        f"duplicate MXTPU_FAULT_SPEC site {site!r}")
                rules[site] = _Rule(site, mode, None, None, delay_ms)
                continue
        try:
            indices = frozenset(int(s) for s in arg.split(","))
        except ValueError:
            try:
                prob = float(arg)
            except ValueError:
                raise ValueError(
                    f"bad MXTPU_FAULT_SPEC arg {arg!r} in {part!r}; "
                    "expected a probability or 1-based call indices"
                ) from None
            if not 0.0 <= prob < 1.0:
                raise ValueError(
                    f"MXTPU_FAULT_SPEC probability {prob!r} in {part!r} "
                    "must be in [0, 1)")
        else:
            if any(i < 1 for i in indices):
                raise ValueError(
                    f"MXTPU_FAULT_SPEC call indices in {part!r} must "
                    "be >= 1 (1-based)")
        if site in rules:
            raise ValueError(f"duplicate MXTPU_FAULT_SPEC site {site!r}")
        rules[site] = _Rule(site, mode, prob, indices, delay_ms)
    return rules


class FaultInjector:
    """Process-wide fault oracle; thread-safe, deterministic per stream."""

    def __init__(self, spec="", seed=0):
        self.spec = spec or ""
        self.seed = int(seed)
        self._rules = _parse_spec(self.spec)
        self._lock = threading.Lock()
        self._calls = {}    # (site, instance) -> call count
        self._rngs = {}     # (site, instance) -> PRNG stream
        self._fired = {}    # (site, mode) -> injection count

    @property
    def active(self):
        return bool(self._rules)

    def action(self, site, instance=""):
        """Advance the (site, instance) stream one call; return the fault
        mode to apply at this call ('drop' | 'fail' | 'torn' | 'sigterm'
        | 'delay') or None."""
        rule = self._rules.get(site)
        if rule is None:
            return None
        key = (site, instance)
        with self._lock:
            n = self._calls.get(key, 0) + 1
            self._calls[key] = n
            if rule.indices is not None:
                hit = n in rule.indices
            elif rule.prob is None:
                hit = True  # selector-less delay rule: every call
            else:
                rng = self._rngs.get(key)
                if rng is None:
                    rng = self._rngs[key] = random.Random(
                        f"{self.seed}:{site}:{instance}")
                hit = rng.random() < rule.prob
            if not hit:
                return None
            k = (site, rule.mode)
            self._fired[k] = self._fired.get(k, 0) + 1
        from .. import telemetry as _telemetry

        _telemetry.inc(_FAULT_METRIC, 1, help=_FAULT_HELP, site=site,
                       mode=rule.mode)
        _telemetry.log_event("fault_injected", site=site, mode=rule.mode,
                             instance=instance, call=n)
        return rule.mode

    def raise_for(self, site, instance=""):
        """Site helper for connection-shaped faults: raises the injected
        error for `drop`/`fail`, sleeps a fired `delay` in place;
        returns any other action (or None) for the site to interpret."""
        act = self.action(site, instance)
        if act == "drop":
            raise InjectedConnectionError(
                f"fault injection: dropped connection at {site!r}")
        if act == "fail":
            raise InjectedIOError(
                f"fault injection: IO failure at {site!r}")
        if act == "delay":
            time.sleep(self._rules[site].delay_ms / 1000.0)
        return act

    def sleep_for(self, site, instance=""):
        """Site helper for latency-shaped faults: a fired `delay` rule
        sleeps its milliseconds here; every action (or None) is
        returned for the site to interpret."""
        act = self.action(site, instance)
        if act == "delay":
            time.sleep(self._rules[site].delay_ms / 1000.0)
        return act

    def delay_ms(self, site):
        """Configured delay for `site`'s rule (0.0 when the site has no
        delay rule) — for sites that model the latency themselves
        (e.g. a synthetic clock) instead of really sleeping."""
        rule = self._rules.get(site)
        return float(rule.delay_ms) if rule is not None \
            and rule.delay_ms is not None else 0.0

    def fired(self, site=None, mode=None):
        """Injection count, optionally filtered by site and/or mode."""
        with self._lock:
            return sum(n for (s, m), n in self._fired.items()
                       if (site is None or s == site)
                       and (mode is None or m == mode))

    def stats(self):
        with self._lock:
            return {f"{s}:{m}": n for (s, m), n in sorted(self._fired.items())}


_NOOP = FaultInjector("", 0)
_installed = None
_install_lock = threading.Lock()


def injector():
    """The process-wide injector; first call resolves MXTPU_FAULT_SPEC /
    MXTPU_FAULT_SEED. The no-spec injector is a shared no-op."""
    global _installed
    inj = _installed
    if inj is None:
        from .. import config as _config

        spec = _config.get("MXTPU_FAULT_SPEC")
        seed = _config.get("MXTPU_FAULT_SEED")
        with _install_lock:
            if _installed is None:
                _installed = FaultInjector(spec, seed) if spec else _NOOP
            inj = _installed
    return inj


def install(inj):
    """Install an injector programmatically (tests, chaos drivers);
    `install(None)` resets to unresolved so the env is re-read."""
    global _installed
    with _install_lock:
        _installed = inj
    return inj


def refresh_from_env():
    """Re-resolve the injector from the environment (monkeypatched
    tests)."""
    install(None)
    return injector()
