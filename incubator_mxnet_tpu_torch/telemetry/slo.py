"""SLO burn-rate monitor for the serving engine (SRE multi-window form).

The port's copy of the JAX package's `telemetry/slo.py`: the same
objectives, burn math, state machine and breach dumps.

An `Objective` declares a per-request threshold — a latency CEILING
(TTFT, queue wait, end-to-end latency: the sample is bad when it exceeds
the threshold) or a FLOOR (goodput: bad when it dips below). Each
finished request contributes one boolean sample per configured
objective; the monitor keeps the last `window_long` samples and computes

    burn = bad_fraction(window) / error_budget

over the short and the long window. Burn 1.0 means the objective is
spending its budget exactly; burn 10 with a 1% budget means one request
in ten is violating. The state machine is the classic multi-window
guard:

    ok      -> warning   when burn(short) >= warn_burn
    warning -> breach    when burn(short) AND burn(long) >= breach_burn
    breach  -> re-arm    when burn(short) drops back below breach_burn

Windows are counted in SAMPLES, not wall-clock seconds, so the math is
deterministic under test and independent of request rate. No transition
fires before `min_samples` observations (cold-start guard).

A breach transition bumps `mxtpu_slo_breaches_total{objective}`, logs an
`slo_breach` flight-recorder event, and writes exactly ONE post-mortem
dump (`recorder.dump`) carrying the monitor snapshot and the last-N
request timelines supplied by the engine — the artifact a fleet router
pages on. Re-arming and breaching again writes a fresh dump.

Construction is either explicit (tests) or `from_env()`: the serving
engine calls `from_env()` at build time and attaches the monitor only
when at least one `MXTPU_SLO_*` threshold is set, so an unconfigured
engine pays nothing per request.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from .. import config as _config
from . import recorder as _recorder
from .names import METRIC_NAMES

__all__ = ["Objective", "SLOMonitor", "from_env",
           "BURN_RATE", "SLO_STATE", "BREACHES_TOTAL", "STATES"]

BURN_RATE = "mxtpu_slo_burn_rate"
SLO_STATE = "mxtpu_slo_state"
BREACHES_TOTAL = "mxtpu_slo_breaches_total"

STATES = ("ok", "warning", "breach")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective. `kind` decides the violation
    direction: "ceiling" flags samples above the threshold (latencies),
    "floor" flags samples below it (goodput)."""
    name: str
    threshold: float
    kind: str = "ceiling"
    budget: float = 0.01

    def __post_init__(self):
        if self.kind not in ("ceiling", "floor"):
            raise ValueError(f"objective kind must be ceiling|floor, "
                             f"got {self.kind!r}")
        if not self.budget > 0:
            raise ValueError(f"error budget must be > 0, got {self.budget}")

    def is_bad(self, value):
        if self.kind == "floor":
            return value < self.threshold
        return value > self.threshold


class _ObjectiveState:
    __slots__ = ("objective", "samples", "state", "breaches", "total")

    def __init__(self, objective, window_long):
        self.objective = objective
        self.samples = deque(maxlen=window_long)  # booleans, newest last
        self.state = "ok"
        self.breaches = 0
        self.total = 0


class SLOMonitor:
    """Burn-rate evaluation over a fixed set of objectives.

    `timelines` is an optional zero-arg callable returning the last-N
    request-timeline dicts to embed in the breach dump; `dump=False`
    keeps the state machine but suppresses post-mortem files (unit
    tests of the burn math)."""

    def __init__(self, objectives, *, window_short=32, window_long=128,
                 min_samples=8, warn_burn=1.0, breach_burn=10.0,
                 timelines=None, dump=True):
        if not objectives:
            raise ValueError("SLOMonitor needs at least one objective")
        if window_short < 1 or window_long < window_short:
            raise ValueError(
                f"need 1 <= window_short <= window_long, got "
                f"{window_short}/{window_long}")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.window_short = int(window_short)
        self.window_long = int(window_long)
        self.min_samples = int(min_samples)
        self.warn_burn = float(warn_burn)
        self.breach_burn = float(breach_burn)
        self._timelines = timelines
        self._dump = dump
        self._obj = {o.name: _ObjectiveState(o, self.window_long)
                     for o in objectives}

    @property
    def objectives(self):
        return [st.objective for st in self._obj.values()]

    def observe(self, name, value):
        """Feed one sample to one objective; runs the state machine and
        publishes the burn gauges. Returns the objective's new state."""
        st = self._obj[name]
        st.samples.append(st.objective.is_bad(float(value)))
        st.total += 1
        return self._evaluate(st)

    def observe_request(self, **samples):
        """Feed one finished request: keyword per objective name; keys
        without a configured objective are ignored, so the engine can
        always pass its full sample set."""
        for name, value in samples.items():
            if name in self._obj and value is not None:
                self.observe(name, value)

    def state(self, name):
        return self._obj[name].state

    def _burns(self, st):
        samples = st.samples
        n_long = len(samples)
        n_short = min(self.window_short, n_long)
        if not n_long:
            return 0.0, 0.0
        budget = st.objective.budget
        recent = list(samples)[-n_short:]
        burn_short = (sum(recent) / n_short) / budget
        burn_long = (sum(samples) / n_long) / budget
        return burn_short, burn_long

    def _evaluate(self, st):
        from . import set_gauge  # late: avoid import cycle at module load

        name = st.objective.name
        burn_short, burn_long = self._burns(st)
        set_gauge(BURN_RATE, burn_short,
                  help=METRIC_NAMES[BURN_RATE][1],
                  objective=name, window="short")
        set_gauge(BURN_RATE, burn_long,
                  help=METRIC_NAMES[BURN_RATE][1],
                  objective=name, window="long")

        prev = st.state
        if st.total >= self.min_samples:
            if (burn_short >= self.breach_burn
                    and burn_long >= self.breach_burn):
                new = "breach"
            elif prev == "breach" and burn_short >= self.breach_burn:
                new = "breach"  # long window decays first: stay latched
            elif burn_short >= self.warn_burn:
                new = "warning"
            else:
                new = "ok"
            if new != prev:
                st.state = new
                self._transition(st, prev, new, burn_short, burn_long)
        set_gauge(SLO_STATE, STATES.index(st.state),
                  help=METRIC_NAMES[SLO_STATE][1], objective=name)
        return st.state

    def _transition(self, st, prev, new, burn_short, burn_long):
        from . import inc  # late import, same cycle as set_gauge

        name = st.objective.name
        _recorder.log_event("slo_transition", objective=name,
                            prev=prev, state=new,
                            burn_short=round(burn_short, 3),
                            burn_long=round(burn_long, 3))
        if new != "breach":
            return
        st.breaches += 1
        inc(BREACHES_TOTAL, help=METRIC_NAMES[BREACHES_TOTAL][1],
            objective=name)
        _recorder.log_event("slo_breach", objective=name,
                            threshold=st.objective.threshold,
                            burn_short=round(burn_short, 3),
                            burn_long=round(burn_long, 3))
        if self._dump:
            timelines = list(self._timelines()) if self._timelines else []
            _recorder.dump(f"slo-breach-{name}", extra={
                "slo": self.snapshot(),
                "request_timelines": timelines,
            })

    def snapshot(self):
        """JSON-ready view: per-objective state, burns, and counters."""
        out = {}
        for name, st in self._obj.items():
            burn_short, burn_long = self._burns(st)
            out[name] = {
                "state": st.state,
                "threshold": st.objective.threshold,
                "kind": st.objective.kind,
                "budget": st.objective.budget,
                "burn_short": burn_short,
                "burn_long": burn_long,
                "samples": st.total,
                "breaches": st.breaches,
            }
        return out


# objective name -> (threshold knob, violation direction); the names
# double as the observe_request() keywords the engine feeds
_ENV_OBJECTIVES = (
    ("ttft", "MXTPU_SLO_TTFT_P99", "ceiling"),
    ("queue_wait", "MXTPU_SLO_QUEUE_WAIT_P99", "ceiling"),
    ("request_latency", "MXTPU_SLO_REQUEST_P99", "ceiling"),
    ("goodput", "MXTPU_SLO_GOODPUT_MIN", "floor"),
)


def from_env(timelines=None):
    """Build the monitor the MXTPU_SLO_* knobs describe, or None when
    no threshold is set (the zero-cost default)."""
    budget = _config.get("MXTPU_SLO_BUDGET")
    objectives = []
    for name, knob, kind in _ENV_OBJECTIVES:
        threshold = _config.get(knob)
        if threshold > 0:
            objectives.append(Objective(name, threshold, kind, budget))
    if not objectives:
        return None
    return SLOMonitor(
        objectives,
        window_short=_config.get("MXTPU_SLO_WINDOW_SHORT"),
        window_long=_config.get("MXTPU_SLO_WINDOW_LONG"),
        min_samples=_config.get("MXTPU_SLO_MIN_SAMPLES"),
        warn_burn=_config.get("MXTPU_SLO_WARN_BURN"),
        breach_burn=_config.get("MXTPU_SLO_BREACH_BURN"),
        timelines=timelines)
