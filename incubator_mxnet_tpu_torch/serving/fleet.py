"""Fault-tolerant serving fleet: journal, replicas, health-checked router.

The port's copy of the JAX package's `serving/fleet.py`, with the same
public names, metric names, fault sites, span names and error messages,
over the port's `ServingEngine`, whose steps are CUDA graphs on the card.

One ServingEngine is a single point of failure: the process dies and
every in-flight request dies with it. This module is the fleet layer
that composes the repo's robustness primitives into a serving stack
that survives replica death mid-stream:

- `RequestJournal` — the durable record of every accepted request:
  (prompt, sampling params, tokens streamed so far). Token deliveries
  are tagged with the entry's ASSIGNMENT EPOCH and absolute position;
  only current-epoch tokens extending the accepted stream are taken, so
  a failed-over request resumes exactly after its last delivered token
  and a zombie replica (slow, declared dead, still streaming) can never
  duplicate one. Greedy decode makes the replayed continuation
  token-identical to the undisturbed run — the chaos gate asserts it.
- `Replica` — one ServingEngine behind the router's RPC seam. `pump()`
  runs one scheduler step, updates the replica's heartbeat, and
  forwards newly streamed tokens to the journal. The fault sites live
  here: `replica.kill` (abrupt death — no drain, no more heartbeats)
  and `replica.rpc` (drop/fail = a lost exchange, delay = a SLOW
  replica whose heartbeats go stale while it keeps producing).
- `FleetRouter` — membership, health, scheduling. Replicas are marked
  dead after `MXTPU_FLEET_HEARTBEAT_TIMEOUT` seconds without a pump
  heartbeat (failure detection is ONLY heartbeats — a dead replica
  answers nothing, so nothing else is trustworthy); their journaled
  in-flight requests are deterministically resubmitted to survivors,
  resuming from the last streamed token. Admission is per-tenant fair
  round-robin to the least-loaded healthy replica. `drain()` is the
  rolling-restart handshake (the training drain's SIGTERM discipline
  extended to serving): stop admitting, hand queued work back to the router,
  finish in-slot requests, leave; process SIGTERM drains the whole
  fleet. A full rolling restart drops zero requests.

Two execution modes share all of that logic: `tick()` runs one router
iteration inline (the deterministic manual-pump mode every test and
chaos scenario drives), while `start()` runs one pump thread per
replica plus a router thread (the live mode behind serving/gateway.py —
per-replica threads so one slow replica cannot stall the others'
heartbeats).

Lock order (lockdep-checked under MXTPU_SANITIZERS=locks):
serving.fleet -> serving.replica -> serving.engine -> serving.journal,
and serving.engine -> graphs.capture (a step's lazy capture, a warm()).

On the card, `warm()` every engine before `add_replica`: a replica that
joins a started fleet pumps at once, and a signature it would capture
lazily holds its pump, and so its heartbeat, for the capture's length.
A capture beside running replicas is safe (`graphs`), only slow.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque

import numpy as np

from .. import config, telemetry
from ..analysis import sanitizers as _sanitizers
from ..resilience import fault as _fault
from ..resilience import preemption as _preemption
from ..telemetry import distributed as _dtrace
from ..telemetry import exporters as _exporters
from ..telemetry import recorder as _recorder

__all__ = ["JournalEntry", "RequestJournal", "Replica", "FleetRouter"]

FLEET_REPLICAS = "mxtpu_fleet_replicas"
FAILOVERS_TOTAL = "mxtpu_fleet_failovers_total"
RESUBMITS_TOTAL = "mxtpu_fleet_resubmits_total"
DRAINS_TOTAL = "mxtpu_fleet_drains_total"
DUP_DROPPED_TOTAL = "mxtpu_fleet_dup_tokens_dropped_total"
LOST_TOTAL = "mxtpu_fleet_lost_requests_total"
# fleet-level rollups + per-replica federation gauges (the gateway's
# /metrics aggregation; an autoscaler's input)
FLEET_QUEUE_DEPTH = "mxtpu_fleet_queue_depth"
FLEET_OLDEST_QUEUED = "mxtpu_fleet_oldest_queued_seconds"
FLEET_REPLICA_HEALTH = "mxtpu_fleet_replica_health"
FLEET_TOTAL_QUEUE_DEPTH = "mxtpu_fleet_total_queue_depth"
FLEET_PAGE_OCCUPANCY = "mxtpu_fleet_page_occupancy"
FLEET_REPLICA_QUEUE_DEPTH = "mxtpu_fleet_replica_queue_depth"
FLEET_REPLICA_SLOTS = "mxtpu_fleet_replica_slots_in_use"
FLEET_REPLICA_OCCUPANCY = "mxtpu_fleet_replica_page_occupancy"

REPLICA_STATES = ("healthy", "draining", "dead", "left")

# router-side trace records (registered in telemetry/names.py): the
# causal chain gateway.request -> fleet.dispatch -> serving.request,
# with fleet.failover spanning the outage window between losing a
# replica and re-dispatching on the survivor. Emitted straight through
# distributed.record_span — zero-cost when tracing is off.
DISPATCH_SPAN = "fleet.dispatch"
FAILOVER_SPAN = "fleet.failover"
RESUBMIT_SPAN = "fleet.resubmit"
# journal token-delivery record (not a span): absolute positions each
# accepted delivery covered — trace_merge --fleet --check proves no
# position was ever delivered twice from these
DELIVERY_KIND = "fleet_delivery"
ROUTER_LANE = "router"


def _trace_ts(tr, clk):
    """Wall-clock ns for a router-clock instant: deltas come from the
    injectable fleet clock (fake clocks in tests/chaos), anchored to the
    wall time captured when the entry was journaled."""
    return tr["ns_submit"] + int((clk - tr["clk_submit"]) * 1e9)


@dataclasses.dataclass
class JournalEntry:
    """One accepted request's full recovery record. `tokens` is the
    client-visible stream: every token in it has been delivered exactly
    once, and a resubmission's engine prompt is `prompt + tokens` so the
    continuation picks up right after the last delivered token."""
    entry_id: int
    tenant: str
    prompt: np.ndarray  # (T_p,) int32
    max_new_tokens: int
    eos_id: int | None
    submitted_at: float
    sink: object = None          # callable(event dict) or None
    tokens: list = dataclasses.field(default_factory=list)
    epoch: int = 0               # bumped on every (re)assignment release
    state: str = "queued"        # queued | assigned | done | failed
    replica_id: str | None = None
    engine_rid: int | None = None
    resubmits: int = 0           # failover resubmissions consumed
    assigned_at: float = 0.0     # first assignment (queue-wait anchor)
    first_token_at: float = 0.0
    finished_at: float = 0.0
    finish_reason: str | None = None
    error: str | None = None
    # distributed-trace context (None with tracing off): tid shared by
    # every span the request produces anywhere in the fleet, psid the
    # gateway's root span id, ns_submit/clk_submit the wall/router-clock
    # anchor pair, plus transient dispatch/failover bookkeeping
    trace: dict | None = None


class RequestJournal:
    """Requests the gateway accepted and what each has streamed so far.

    Deliveries carry (epoch, absolute position): stale epochs are the
    zombie-replica path, positions below the accepted length are
    duplicates — both are counted and dropped, never re-emitted, so the
    client-facing sink sees every position exactly once, in order."""

    def __init__(self, clock=time.monotonic, slo=None):
        self._lock = _sanitizers.san_lock("serving.journal")
        self._clock = clock
        self._entries: dict[int, JournalEntry] = {}
        self._ids = itertools.count()
        self.slo = slo or None
        self.dup_dropped = 0
        self.lost = 0

    def record(self, prompt, max_new_tokens, eos_id, tenant, sink):
        with self._lock:
            entry = JournalEntry(
                entry_id=next(self._ids), tenant=str(tenant),
                prompt=np.asarray(prompt, np.int32).reshape(-1),
                max_new_tokens=int(max_new_tokens),
                eos_id=eos_id, submitted_at=self._clock(), sink=sink)
            self._entries[entry.entry_id] = entry
            return entry

    def get(self, entry_id):
        with self._lock:
            return self._entries[entry_id]

    def bind(self, entry, replica_id, engine_rid):
        with self._lock:
            entry.state = "assigned"
            entry.replica_id = str(replica_id)
            entry.engine_rid = engine_rid
            if not entry.assigned_at:
                entry.assigned_at = self._clock()

    def release(self, entry):
        """Unbind for resubmission: the epoch bump is the dedup fence —
        anything the old assignment still delivers is stale."""
        with self._lock:
            entry.epoch += 1
            entry.state = "queued"
            entry.replica_id = None
            entry.engine_rid = None

    def on_tokens(self, entry_id, epoch, start, tokens):
        """Accept a delivery of continuation tokens at absolute
        positions [start, start+len). Returns how many were accepted."""
        with self._lock:
            entry = self._entries[entry_id]
            taken = 0
            if entry.state in ("done", "failed") or epoch != entry.epoch:
                dropped = len(tokens)
            else:
                dropped = 0
                now = self._clock()
                for j, tok in enumerate(tokens):
                    pos = start + j
                    if pos < len(entry.tokens):
                        dropped += 1  # duplicate of a delivered position
                        continue
                    if pos > len(entry.tokens):
                        raise RuntimeError(
                            f"journal gap: entry {entry_id} delivered "
                            f"position {pos} with only "
                            f"{len(entry.tokens)} tokens accepted")
                    entry.tokens.append(int(tok))
                    taken += 1
                    if not entry.first_token_at:
                        entry.first_token_at = now
                    self._emit_locked(entry, {
                        "event": "token", "index": pos, "token": int(tok)})
                if taken and entry.trace is not None:
                    # accepted-delivery record: the absolute position
                    # range this delivery appended. trace_merge --fleet
                    # --check proves per-entry contiguity (monotone
                    # journal positions, no position delivered twice).
                    tr = entry.trace
                    _dtrace.record_span({
                        "kind": DELIVERY_KIND, "ts": _trace_ts(tr, now),
                        "tid": tr["tid"], "entry": entry.entry_id,
                        "epoch": epoch,
                        "start": len(entry.tokens) - taken, "n": taken,
                        "replica": entry.replica_id, "lane": ROUTER_LANE})
            if dropped:
                self.dup_dropped += dropped
                telemetry.inc(DUP_DROPPED_TOTAL, amount=float(dropped))
            return taken

    def on_finish(self, entry_id, epoch, reason):
        """A replica reports the entry finished ('eos' | 'length').
        Stale epochs (the zombie finishing after failover already
        re-ran the request) are ignored."""
        with self._lock:
            entry = self._entries[entry_id]
            if entry.state in ("done", "failed") or epoch != entry.epoch:
                return False
            self._finish_locked(entry, reason)
            return True

    def finish_direct(self, entry, reason):
        """Router-side completion without a replica: a resubmission
        whose streamed tokens already satisfy EOS/length."""
        with self._lock:
            if entry.state in ("done", "failed"):
                return
            self._finish_locked(entry, reason)

    def fail(self, entry, error):
        with self._lock:
            if entry.state in ("done", "failed"):
                return
            entry.state = "failed"
            entry.error = str(error)
            entry.finished_at = self._clock()
            self.lost += 1
            telemetry.inc(LOST_TOTAL)
            telemetry.log_event("fleet_request_lost",
                                entry=entry.entry_id, error=str(error))
            self._emit_locked(entry, {
                "event": "failed", "entry_id": entry.entry_id,
                "error": str(error)})

    def _finish_locked(self, entry, reason):
        entry.state = "done"
        entry.finish_reason = reason
        entry.finished_at = self._clock()
        self._emit_locked(entry, {
            "event": "done", "entry_id": entry.entry_id,
            "finish_reason": reason, "tokens": list(entry.tokens),
            "resubmits": entry.resubmits})
        if self.slo is not None:
            self.slo.observe_request(
                ttft=(entry.first_token_at - entry.submitted_at
                      if entry.first_token_at else None),
                queue_wait=(entry.assigned_at - entry.submitted_at
                            if entry.assigned_at else None),
                request_latency=entry.finished_at - entry.submitted_at)

    @staticmethod
    def _emit_locked(entry, event):
        if entry.sink is not None:
            entry.sink(event)

    def assigned_to(self, replica_id):
        with self._lock:
            return sorted(
                (e for e in self._entries.values()
                 if e.state == "assigned" and e.replica_id == replica_id),
                key=lambda e: e.entry_id)

    def unfinished(self):
        with self._lock:
            return sorted(
                (e for e in self._entries.values()
                 if e.state not in ("done", "failed")),
                key=lambda e: e.entry_id)

    def snapshot(self):
        with self._lock:
            states = {}
            for e in self._entries.values():
                states[e.state] = states.get(e.state, 0) + 1
            return {"entries": len(self._entries), "states": states,
                    "dup_tokens_dropped": self.dup_dropped,
                    "lost": self.lost}

    def dump_entries(self):
        """Per-entry forensics rows (the failover post-mortem dump's
        journal snapshot): enough to replay the resume decision for
        every request that was in flight when a replica died."""
        with self._lock:
            return [{
                "entry": e.entry_id, "tenant": e.tenant,
                "state": e.state, "epoch": e.epoch,
                "replica": e.replica_id, "engine_rid": e.engine_rid,
                "tokens_delivered": len(e.tokens),
                "max_new_tokens": e.max_new_tokens,
                "resubmits": e.resubmits,
                "finish_reason": e.finish_reason, "error": e.error,
                "trace_id": (e.trace or {}).get("tid"),
            } for e in sorted(self._entries.values(),
                              key=lambda e: e.entry_id)]


class Replica:
    """One ServingEngine behind the router's RPC seam.

    The replica's heartbeat IS its scheduler pump: every successful
    `pump()` stamps `last_beat`. A replica that stops pumping — killed
    by the `replica.kill` fault site, `kill()` from a chaos driver, or
    a real crash in the live mode — simply goes silent, and the router
    learns the only way a router can: the heartbeat timeout."""

    def __init__(self, replica_id, engine, journal, clock=time.monotonic):
        self.replica_id = str(replica_id)
        self.engine = engine
        self.journal = journal
        self._clock = clock
        # the replica id is the engine's timeline lane: every
        # serving.request span this engine emits lands on a per-replica
        # lane in the merged fleet trace
        if getattr(engine, "trace_lane", None) is None:
            engine.trace_lane = self.replica_id
        self._lock = _sanitizers.san_lock("serving.replica")
        self.state = "healthy"
        self.last_beat = clock()
        self.pumps = 0
        # silent death (replica.kill fault, chaos silent_kill, a real
        # crash): the replica stops pumping and beating but the
        # ROUTER-visible state stays as-is — the router must discover
        # the corpse the honest way, through the heartbeat timeout
        self._failed = False
        # engine rid -> [entry_id, epoch, base, delivered]: the delivery
        # cursor. `base` = journal tokens at (re)submission, so engine
        # continuation position i is absolute position base + i.
        self._bindings: dict = {}
        self._orphans: list = []

    # -- router-facing RPC surface ----------------------------------------

    def dispatch(self, entry, allow_draining=False):
        """Submit a journal entry (or its resumption) into the engine.
        The resume prompt is `prompt + tokens streamed so far`, with the
        token budget reduced by what was already delivered — greedy
        decode then continues token-identically. `replica.rpc` faults
        apply (drop/fail raise to the router; delay slows the call).
        `allow_draining` is the fleet-wide-shutdown exception: with no
        healthy survivors left, draining replicas finish the stragglers."""
        _fault.injector().raise_for("replica.rpc", self.replica_id)
        with self._lock:
            ok = ("healthy", "draining") if allow_draining else ("healthy",)
            if self._failed or self.state not in ok:
                raise ConnectionError(
                    f"replica {self.replica_id} is {self.state}, "
                    f"not accepting dispatches")
            base = len(entry.tokens)
            prompt = entry.prompt if not base else np.concatenate(
                [entry.prompt, np.asarray(entry.tokens, np.int32)])
            # the engine's serving.request span adopts the fleet trace
            # id and parents under this dispatch's fleet.dispatch span
            tr = entry.trace
            ctx = ((tr["tid"], tr.get("dispatch_sid"))
                   if tr is not None else None)
            rid = self.engine.submit(prompt, entry.max_new_tokens - base,
                                     entry.eos_id, trace_ctx=ctx)
            self._bindings[rid] = [entry.entry_id, entry.epoch, base, 0]
            return rid

    def pump(self):
        """One scheduler heartbeat: consult the fault sites, run one
        engine step when there is work, stamp the heartbeat, forward
        new tokens/finishes to the journal. Returns False once dead."""
        with self._lock:
            if self._failed or self.state in ("dead", "left"):
                return False
            if _fault.injector().action("replica.kill", self.replica_id):
                # abrupt death: engine state (KV pages, queue,
                # half-streamed outputs) is gone; no drain, no further
                # heartbeats — and no state change the router could
                # cheat off. Recovery is journal failover only, after
                # the heartbeat timeout exposes the corpse.
                self._failed = True
                self._bindings.clear()
                telemetry.log_event("fleet_replica_killed",
                                    replica=self.replica_id)
                return False
        # the router<->replica exchange: a delay here is a SLOW replica
        # (heartbeat stamped late), drop/fail a lost exchange (no step,
        # no heartbeat) — both without killing anything
        act = _fault.injector().sleep_for("replica.rpc", self.replica_id)
        if act in ("drop", "fail"):
            return True
        with self._lock:
            if self._failed or self.state in ("dead", "left"):
                return False
            if self.engine.queue_depth or self.engine.slots_in_use:
                self.engine.step()
            self.last_beat = self._clock()
            self.pumps += 1
            if self._bindings:
                self._deliver_locked()
            return True

    def _deliver_locked(self):
        results = self.engine.results()
        live = self.engine.live_tokens()
        for rid in list(self._bindings):
            entry_id, epoch, base, delivered = b = self._bindings[rid]
            res = results.get(rid)
            toks = res.tokens if res is not None else live.get(rid)
            if toks is not None and len(toks) > delivered:
                self.journal.on_tokens(entry_id, epoch,
                                       base + delivered, toks[delivered:])
                b[3] = len(toks)
            if res is None:
                continue
            del self._bindings[rid]
            if res.finish_reason in ("eos", "length"):
                self.journal.on_finish(entry_id, epoch, res.finish_reason)
            else:
                # evicted/cancelled without the router unbinding first:
                # a replica-local loss the router must requeue
                self._orphans.append(entry_id)

    # -- drain handshake (rolling restarts) --------------------------------

    def begin_drain(self, handoff=True):
        """Stop admitting; hand engine-QUEUED requests back to the
        router for immediate placement elsewhere (they hold no pages —
        nothing is lost by moving them); in-slot requests decode to
        completion here. Returns the handed-off journal entry ids.
        `handoff=False` is the fleet-wide-shutdown variant: with every
        replica draining there is nowhere to hand work to, so queued
        requests are finished locally instead."""
        with self._lock:
            if self.state != "healthy":
                return []
            self.state = "draining"
            handed = []
            for rid in self.engine.queued_request_ids() if handoff else ():
                b = self._bindings.pop(rid, None)
                # unbound BEFORE the cancel: the engine's "cancelled"
                # result then has no binding, so no client-facing event
                self.engine.cancel(rid)
                if b is not None:
                    handed.append(b[0])
            telemetry.log_event("fleet_replica_draining",
                                replica=self.replica_id,
                                handed_off=len(handed))
            return handed

    def drained(self):
        with self._lock:
            return (self.state == "draining"
                    and not self.engine.queue_depth
                    and not self.engine.slots_in_use
                    and not self._bindings)

    def leave(self):
        """Drain complete: leave the router. With the page sanitizer
        armed this is also a quiescence proof — a drained replica that
        still holds page references leaked them (MXS013)."""
        with self._lock:
            if self.state != "draining":
                return False
            self.state = "left"
        san = getattr(self.engine, "_page_san", None)
        if san is not None:
            san.assert_quiescent()
        telemetry.log_event("fleet_replica_left", replica=self.replica_id)
        return True

    def silent_kill(self, when=None):
        """Chaos helper: abrupt, silent death. Heartbeats stop NOW,
        nothing is handed off, and the router-visible state does NOT
        change — detection must come from the heartbeat timeout. With
        `when`, a predicate called under the replica's lock (the lock its
        pump steps and delivers under), the death happens only if it
        holds, so what it saw is what the replica dies with. Returns
        whether the replica died here."""
        with self._lock:
            if self._failed or self.state in ("dead", "left"):
                return False
            if when is not None and not when():
                return False
            self._failed = True
            self._bindings.clear()
            return True

    def mark_dead(self):
        """Router-side transition once the heartbeat timeout expired:
        the replica is now officially a corpse."""
        with self._lock:
            if self.state in ("dead", "left"):
                return
            self.state = "dead"
            self._failed = True
            self._bindings.clear()

    # -- introspection -----------------------------------------------------

    def heartbeat_age(self, now):
        with self._lock:
            return now - self.last_beat

    def inflight(self):
        with self._lock:
            return len(self._bindings)

    def take_orphans(self):
        with self._lock:
            orphans, self._orphans = self._orphans, []
            return orphans


class FleetRouter:
    """Health-checked router over a fleet of serving replicas.

    `tick()` is one router iteration (manual-pump mode): SIGTERM check,
    heartbeat health check + failover, drain progression, per-tenant
    fair dispatch, one pump per live replica. `start()` runs the same
    phases on background threads for the live HTTP gateway."""

    def __init__(self, *, clock=time.monotonic, heartbeat_timeout=None,
                 max_resubmits=None, slo=None):
        self._clock = clock
        self.heartbeat_timeout = float(
            heartbeat_timeout if heartbeat_timeout is not None
            else config.get("MXTPU_FLEET_HEARTBEAT_TIMEOUT"))
        self.max_resubmits = int(
            max_resubmits if max_resubmits is not None
            else config.get("MXTPU_FLEET_MAX_RESUBMITS"))
        self._lock = _sanitizers.san_lock("serving.fleet")
        self.journal = RequestJournal(clock=clock, slo=slo)
        self._replicas: dict[str, Replica] = {}
        self._tenants: dict[str, deque] = {}
        self._tenant_order: list = []
        self._rr = 0
        self._rid_ids = itertools.count(1)
        self.failovers = 0
        self.resubmits = 0
        self.drains = 0
        self.draining = False  # fleet-wide (SIGTERM): stop admitting
        self.ticks = 0
        # seeded lost-request negative: silently skip ONE failover
        # resubmission — the zero-lost-requests gate MUST catch this
        self._chaos_lose_one = False
        # seeded broken-chain negative: drop ONE resubmitted
        # entry's trace context before redispatch, orphaning the
        # survivor's serving.request span — trace_merge --fleet --check
        # MUST catch the broken causal chain
        self._chaos_break_trace = False
        self._stop = threading.Event()
        self._threads: dict = {}
        self._started = False
        self._interval = 0.002
        _exporters.register_debug_handler("/debug/fleet",
                                          self.debug_snapshot)

    # -- membership --------------------------------------------------------

    def add_replica(self, engine, replica_id=None):
        """Join a replica (a fresh ServingEngine) to the fleet; returns
        the Replica handle. In threaded mode its pump thread starts
        immediately — this is the rolling-restart replacement path."""
        with self._lock:
            rid = str(replica_id if replica_id is not None
                      else f"r{next(self._rid_ids)}")
            live = self._replicas.get(rid)
            if live is not None and live.state in ("healthy", "draining"):
                raise ValueError(f"replica id {rid!r} is already active")
            rep = Replica(rid, engine, self.journal, clock=self._clock)
            self._replicas[rid] = rep
            started = self._started
        telemetry.log_event("fleet_replica_joined", replica=rep.replica_id)
        if started:
            self._spawn_replica_thread(rep)
        return rep

    def replica(self, replica_id):
        with self._lock:
            return self._replicas[str(replica_id)]

    def _active_locked(self):
        return [self._replicas[rid] for rid in sorted(self._replicas)
                if self._replicas[rid].state in ("healthy", "draining")]

    # -- admission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens, eos_id=None,
               tenant="default", sink=None, trace_ctx=None):
        """Journal one request and queue it for dispatch; returns the
        journal entry id. Validation mirrors ServingEngine.submit so an
        unservable request fails HERE (the gateway's 400), never on a
        replica. `trace_ctx` is the gateway root span's
        (trace_id, span_id) — every fleet/replica span of this request
        shares the trace id and chains up to that root."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        with self._lock:
            if self.draining:
                raise RuntimeError("fleet is draining; not admitting")
            healthy = [r for r in self._replicas.values()
                       if r.state == "healthy"]
            if not healthy:
                raise RuntimeError("no healthy replicas")
            total = prompt.size + int(max_new_tokens)
            max_len = min(r.engine.max_len for r in healthy)
            if total > max_len:
                raise ValueError(
                    f"prompt ({prompt.size}) + max_new_tokens "
                    f"({max_new_tokens}) exceeds the fleet's max_len "
                    f"({max_len})")
            if all(r.engine.allocator.pages_needed(total)
                   > r.engine.allocator.capacity for r in healthy):
                raise ValueError(
                    f"request needs more KV pages than any healthy "
                    f"replica's pool holds")
            entry = self.journal.record(prompt, max_new_tokens, eos_id,
                                        tenant, sink)
            if _dtrace.trace_active():
                tid, psid = trace_ctx if trace_ctx else (None, None)
                entry.trace = {
                    "tid": tid or _dtrace.new_id(), "psid": psid,
                    "ns_submit": time.time_ns(),
                    "clk_submit": entry.submitted_at}
            self._enqueue_locked(entry, front=False)
            return entry.entry_id

    def _enqueue_locked(self, entry, front):
        dq = self._tenants.get(entry.tenant)
        if dq is None:
            dq = self._tenants[entry.tenant] = deque()
            self._tenant_order.append(entry.tenant)
        if front:
            dq.appendleft(entry)
        else:
            dq.append(entry)

    # -- the router iteration ----------------------------------------------

    def tick(self):
        """One router iteration (manual-pump mode). Deterministic given
        a deterministic clock: replicas pump in sorted-id order."""
        if _preemption.requested() and not self.draining:
            self.drain_all()
        self._health_check()
        self._progress_drains()
        self._dispatch()
        with self._lock:
            reps = self._active_locked()
        for rep in reps:
            rep.pump()
        self._collect_orphans()
        # again after the pumps: a replica whose LAST in-slot request
        # just finished leaves this tick, not next
        self._progress_drains()
        self.ticks += 1
        self._export_gauges()

    def _health_check(self):
        now = self._clock()
        with self._lock:
            stale = [r for r in self._replicas.values()
                     if r.state in ("healthy", "draining")
                     and r.heartbeat_age(now) > self.heartbeat_timeout]
            for rep in stale:
                self._declare_dead_locked(rep)

    def _declare_dead_locked(self, rep):
        rep.mark_dead()
        self.failovers += 1
        telemetry.inc(FAILOVERS_TOTAL)
        telemetry.log_event("fleet_replica_dead", replica=rep.replica_id,
                            timeout_s=self.heartbeat_timeout)
        entries = self.journal.assigned_to(rep.replica_id)
        if self._chaos_lose_one and entries:
            # seeded negative: drop one in-flight request on the floor.
            # It stays "assigned" to a corpse forever — exactly the bug
            # the zero-lost-requests chaos gate exists to catch.
            entries.pop(0)
            self._chaos_lose_one = False
        self._dump_failover_locked(rep, entries)
        for entry in reversed(entries):  # appendleft keeps id order
            self._requeue_locked(entry, reason="failover",
                                 cause="heartbeat_timeout")

    def _dump_failover_locked(self, rep, entries):
        """Flight-recorder post-mortem on every replica death: the full
        journal snapshot plus every replica's recent request timelines
        (victim AND survivors — the forensics view of what each side
        was doing when the heartbeat timeout fired)."""
        timelines = {}
        for rid in sorted(self._replicas):
            other = self._replicas[rid]
            try:
                timelines[rid] = other.engine.recent_timelines()
            except Exception:  # a corpse's engine may be torn down
                timelines[rid] = []
        _recorder.dump("fleet-failover", extra={
            "fleet": {
                "victim": rep.replica_id,
                "cause": "heartbeat_timeout",
                "heartbeat_timeout_s": self.heartbeat_timeout,
                "failovers": self.failovers,
                "requeued_entries": [e.entry_id for e in entries],
                "journal": self.journal.snapshot(),
                "journal_entries": self.journal.dump_entries(),
                "replica_timelines": timelines,
            }})

    def _emit_fleet_record(self, name, tr, *, ts, dur_s=0.0, extra=None,
                           sid=None, pid=None):
        rec = {"name": name, "tid": tr["tid"],
               "sid": sid if sid is not None else _dtrace.new_id(),
               "ts": int(ts), "dur_ns": max(0, int(dur_s * 1e9)),
               "lane": ROUTER_LANE}
        if pid is not None:
            rec["pid"] = pid
        if extra:
            rec["extra"] = extra
        _dtrace.record_span(rec)

    def _requeue_locked(self, entry, reason, cause=None):
        """Resubmission path: bump the epoch (the dedup fence), then
        either finish directly (the streamed tokens already satisfy
        EOS/length), fail (failover budget exhausted), or requeue at
        the FRONT of the tenant queue so recovered requests do not wait
        behind fresh arrivals. `cause` (failovers only) names what
        killed the old assignment: heartbeat_timeout | rpc_fault."""
        victim = entry.replica_id
        self.journal.release(entry)
        self.resubmits += 1
        telemetry.inc(RESUBMITS_TOTAL, reason=reason)
        tr = entry.trace
        now = self._clock()
        if tr is not None:
            self._emit_fleet_record(
                RESUBMIT_SPAN, tr, ts=_trace_ts(tr, now),
                pid=tr.get("psid"), extra={
                    "entry": entry.entry_id, "reason": reason,
                    "epoch": entry.epoch,
                    "resume_pos": len(entry.tokens),
                    "resubmits_remaining":
                        self.max_resubmits - entry.resubmits
                        - (1 if reason == "failover" else 0)})
            if reason == "failover":
                # the failover span covers the outage window: it opens
                # here (the requeue) and closes at the next successful
                # dispatch, which fills in the survivor replica id
                tr["failover"] = {"cause": cause, "victim": victim,
                                  "clk": now}
        if reason == "failover":
            # only unplanned resubmits consume budget: a rolling restart
            # may hand the same request off any number of times
            entry.resubmits += 1
            if entry.resubmits > self.max_resubmits:
                self.journal.fail(
                    entry, f"failover budget exhausted after "
                           f"{entry.resubmits - 1} resubmissions")
                self._resolve_failover_locked(entry, None)
                return
        if (entry.eos_id is not None and entry.tokens
                and entry.tokens[-1] == entry.eos_id):
            self.journal.finish_direct(entry, "eos")
            self._resolve_failover_locked(entry, None)
            return
        if len(entry.tokens) >= entry.max_new_tokens:
            self.journal.finish_direct(entry, "length")
            self._resolve_failover_locked(entry, None)
            return
        self._enqueue_locked(entry, front=True)

    def _resolve_failover_locked(self, entry, survivor):
        """Close a pending fleet.failover span: the outage window ran
        from the requeue to this moment — the survivor's dispatch, or a
        terminal router-side decision (budget exhausted / finished
        directly), in which case `survivor` is None."""
        tr = entry.trace
        if tr is None:
            return
        stash = tr.pop("failover", None)
        if stash is None:
            return
        now = self._clock()
        self._emit_fleet_record(
            FAILOVER_SPAN, tr, ts=_trace_ts(tr, stash["clk"]),
            dur_s=now - stash["clk"], pid=tr.get("psid"), extra={
                "entry": entry.entry_id, "cause": stash["cause"],
                "victim": stash["victim"], "survivor": survivor,
                "epoch": entry.epoch,
                "resume_pos": len(entry.tokens),
                "resubmits_remaining":
                    self.max_resubmits - entry.resubmits})

    def _progress_drains(self):
        with self._lock:
            # fleet-wide drain: nobody leaves while undispatched work
            # remains — a momentarily-empty replica must stay to take
            # the stragglers (there are no healthy survivors to)
            if self.draining and any(self._tenants.values()):
                return
            draining = [r for r in self._replicas.values()
                        if r.state == "draining"]
        for rep in draining:
            if rep.drained() and rep.leave():
                with self._lock:
                    self.drains += 1
                telemetry.inc(DRAINS_TOTAL)

    def _dispatch(self):
        with self._lock:
            n = len(self._tenant_order)
            if not n:
                return
            dispatched = True
            while dispatched:
                dispatched = False
                for k in range(n):
                    tenant = self._tenant_order[(self._rr + k) % n]
                    dq = self._tenants.get(tenant)
                    if not dq:
                        continue
                    best = self._pick_replica_locked()
                    if best is None:
                        return  # no capacity anywhere: stop the sweep
                    entry = dq.popleft()
                    if self._chaos_break_trace and entry.resubmits:
                        # seeded negative: lose the resubmission's trace
                        # context, so the survivor's serving.request
                        # span starts a fresh, orphaned trace — exactly
                        # the broken chain --fleet --check must flag
                        entry.trace = None
                        self._chaos_break_trace = False
                    tr = entry.trace
                    dispatch_clk = self._clock()
                    if tr is not None:
                        # pre-mint the dispatch span id so the engine's
                        # serving.request span can parent under it
                        tr["dispatch_sid"] = _dtrace.new_id()
                    try:
                        erid = best.dispatch(
                            entry, allow_draining=self.draining)
                    except (ConnectionError, OSError):
                        # dispatch RPC lost: back to the front, retry
                        # next tick (the health check owns giving up)
                        dq.appendleft(entry)
                        self.resubmits += 1
                        telemetry.inc(RESUBMITS_TOTAL, reason="rpc")
                        return
                    self.journal.bind(entry, best.replica_id, erid)
                    if tr is not None:
                        self._emit_fleet_record(
                            DISPATCH_SPAN, tr,
                            ts=_trace_ts(tr, dispatch_clk),
                            dur_s=self._clock() - dispatch_clk,
                            sid=tr.pop("dispatch_sid"),
                            pid=tr.get("psid"), extra={
                                "entry": entry.entry_id,
                                "replica": best.replica_id,
                                "request": erid, "epoch": entry.epoch,
                                "resume_pos": len(entry.tokens),
                                "resubmits": entry.resubmits})
                        self._resolve_failover_locked(
                            entry, best.replica_id)
                    dispatched = True
                self._rr = (self._rr + 1) % n

    def _pick_replica_locked(self):
        """Least-loaded healthy replica with an uncommitted slot. The
        router never queues more onto a replica than its slots — queued
        work holds no pages and is trivially movable, so keeping the
        per-replica queue shallow keeps drains and failovers cheap."""
        # fleet-wide drain: no healthy survivors will ever appear, so
        # draining replicas take the stragglers (zero-drop shutdown)
        ok = ("healthy", "draining") if self.draining else ("healthy",)
        best, best_load = None, None
        for rid in sorted(self._replicas):
            rep = self._replicas[rid]
            if rep.state not in ok or rep._failed:
                continue
            eng = rep.engine
            load = eng.slots_in_use + eng.queue_depth
            if load >= eng.slots:
                continue
            if best is None or load < best_load:
                best, best_load = rep, load
        return best

    def _collect_orphans(self):
        with self._lock:
            reps = list(self._replicas.values())
            for rep in reps:
                for entry_id in rep.take_orphans():
                    self._requeue_locked(self.journal.get(entry_id),
                                         reason="failover",
                                         cause="rpc_fault")

    # -- drains / rolling restarts -----------------------------------------

    def drain(self, replica_id, handoff=True):
        """Begin the drain handshake on one replica: stop admitting to
        it, requeue its engine-queued requests NOW, let in-slot
        requests finish. The replica leaves the router once empty."""
        with self._lock:
            rep = self._replicas[str(replica_id)]
            for entry_id in rep.begin_drain(handoff=handoff):
                self._requeue_locked(self.journal.get(entry_id),
                                     reason="drain")

    def drain_all(self):
        """Fleet-wide drain — the process-SIGTERM path (the training
        drain protocol extended to serving): stop admitting at the gateway,
        finish or hand off everything in flight, every replica leaves."""
        with self._lock:
            self.draining = True
            reps = [r.replica_id for r in self._replicas.values()
                    if r.state == "healthy"]
        telemetry.log_event("fleet_drain_all", replicas=len(reps))
        for rid in reps:
            # no handoff: every replica is draining, so queued work has
            # nowhere to go — each replica finishes its own backlog
            self.drain(rid, handoff=False)

    def kill(self, replica_id, when=None):
        """Chaos helper: abrupt silent death of one replica. Detection
        still happens the honest way — heartbeat timeout. `when`: see
        `Replica.silent_kill` (a port addition: a threaded fleet's chaos
        run kills a replica mid-stream without racing its pump). Returns
        whether it died."""
        return self.replica(replica_id).silent_kill(when)

    # -- threaded mode -----------------------------------------------------

    def start(self, interval=0.002):
        """Run the fleet on background threads: one pump loop per
        replica (a slow replica cannot stall the others' heartbeats)
        plus one router loop for health, dispatch, and drains."""
        with self._lock:
            if self._started:
                return
            self._started = True
            self._interval = float(interval)
            reps = self._active_locked()
        self._stop.clear()
        t = threading.Thread(target=self._router_loop, daemon=True,
                             name="mxtpu-fleet-router")
        self._threads["__router__"] = t
        t.start()
        for rep in reps:
            self._spawn_replica_thread(rep)

    def _spawn_replica_thread(self, rep):
        t = threading.Thread(target=self._replica_loop, args=(rep,),
                             daemon=True,
                             name=f"mxtpu-replica-{rep.replica_id}")
        self._threads[rep.replica_id] = t
        t.start()

    def _replica_loop(self, rep):
        while not self._stop.is_set():
            if not rep.pump():
                return  # dead or left: the corpse stops consuming CPU
            self._stop.wait(self._interval)

    def _router_loop(self):
        while not self._stop.is_set():
            if _preemption.requested() and not self.draining:
                self.drain_all()
            self._health_check()
            self._progress_drains()
            self._dispatch()
            self._collect_orphans()
            self._progress_drains()
            self._export_gauges()
            self._stop.wait(self._interval)

    def stop(self):
        self._stop.set()
        for t in list(self._threads.values()):
            t.join(timeout=10.0)
        with self._lock:
            self._started = False
            self._threads.clear()

    # -- convenience / introspection ---------------------------------------

    def run_until_idle(self, max_ticks=10_000):
        """Manual-pump drive: tick until every journal entry reached a
        terminal state and the tenant queues are empty. Returns True on
        idle, False when max_ticks ran out first (a LOST request)."""
        for _ in range(max_ticks):
            if self.idle():
                return True
            self.tick()
        return self.idle()

    def idle(self):
        with self._lock:
            if any(self._tenants.values()):
                return False
        return not self.journal.unfinished()

    def result(self, entry_id):
        """Terminal view of one request: (tokens, finish_reason) — or
        state/error while unfinished/failed."""
        e = self.journal.get(entry_id)
        return {"entry_id": e.entry_id, "state": e.state,
                "tokens": list(e.tokens),
                "finish_reason": e.finish_reason,
                "resubmits": e.resubmits, "error": e.error}

    def min_occupancy(self):
        """KV page-pool occupancy of the LEAST loaded healthy replica —
        the gateway's admission-control signal (1.0 with no healthy
        replica: shed everything)."""
        with self._lock:
            occ = [r.engine.allocator.occupancy()
                   for r in self._replicas.values()
                   if r.state == "healthy"]
        return min(occ) if occ else 1.0

    def tenant_depth(self, tenant):
        with self._lock:
            dq = self._tenants.get(str(tenant))
            return len(dq) if dq else 0

    def healthy_count(self):
        with self._lock:
            return sum(r.state == "healthy"
                       for r in self._replicas.values())

    def export_fleet_gauges(self):
        """Refresh the fleet's rollup + per-replica federation gauges
        in the process registry — called each router iteration and by
        the gateway right before serving /metrics, so a scrape always
        sees current values."""
        self._export_gauges()

    def _export_gauges(self):
        now = self._clock()
        with self._lock:
            counts = {}
            per_replica = []
            for rid in sorted(self._replicas):
                r = self._replicas[rid]
                counts[r.state] = counts.get(r.state, 0) + 1
                eng = r.engine
                per_replica.append(
                    (rid, r.state, eng.queue_depth, eng.slots_in_use,
                     eng.allocator.occupancy()))
            front_depth = sum(len(dq) for dq in self._tenants.values())
            oldest = min(
                (e.submitted_at for dq in self._tenants.values()
                 for e in dq), default=None)
        for state in REPLICA_STATES:
            telemetry.set_gauge(FLEET_REPLICAS, counts.get(state, 0),
                                state=state)
        # router front queue (requests journaled but not yet on any
        # replica) — the autoscaler's backlog signal
        telemetry.set_gauge(FLEET_QUEUE_DEPTH, front_depth)
        telemetry.set_gauge(FLEET_OLDEST_QUEUED,
                            (now - oldest) if oldest is not None else 0.0)
        # fleet rollups across live replicas
        live = [p for p in per_replica if p[1] in ("healthy", "draining")]
        telemetry.set_gauge(
            FLEET_TOTAL_QUEUE_DEPTH,
            front_depth + sum(p[2] for p in live))
        telemetry.set_gauge(
            FLEET_PAGE_OCCUPANCY,
            sum(p[4] for p in live) / len(live) if live else 0.0)
        # per-replica federation: one labelled series per replica, and
        # a one-hot health-state matrix (value 1 on the current state)
        for rid, state, qd, slots, occ in per_replica:
            for s in REPLICA_STATES:
                telemetry.set_gauge(FLEET_REPLICA_HEALTH,
                                    1.0 if s == state else 0.0,
                                    replica=rid, state=s)
            telemetry.set_gauge(FLEET_REPLICA_QUEUE_DEPTH, qd,
                                replica=rid)
            telemetry.set_gauge(FLEET_REPLICA_SLOTS, slots, replica=rid)
            telemetry.set_gauge(FLEET_REPLICA_OCCUPANCY, occ,
                                replica=rid)

    def debug_snapshot(self):
        """Live-fleet JSON snapshot, served at /debug/fleet by the
        telemetry HTTP server (MXTPU_DEBUG_ENDPOINTS=1) and rendered as
        per-replica rows by tools/serving_top.py — the operator's view
        of a rolling restart."""
        now = self._clock()
        with self._lock:
            reps = [{
                "replica": rep.replica_id,
                "state": rep.state,
                "slots_in_use": rep.engine.slots_in_use,
                "slots": rep.engine.slots,
                "queue_depth": rep.engine.queue_depth,
                "inflight": rep.inflight(),
                "occupancy": rep.engine.allocator.occupancy(),
                "heartbeat_age_s": (rep.heartbeat_age(now)
                                    if rep.state in ("healthy", "draining")
                                    else None),
                "pumps": rep.pumps,
            } for _, rep in sorted(self._replicas.items())]
            tenants = {t: len(dq) for t, dq in sorted(self._tenants.items())}
            counters = {"failovers": self.failovers,
                        "resubmits": self.resubmits,
                        "drains": self.drains,
                        "ticks": self.ticks}
            draining = self.draining
            oldest = min(
                (e.submitted_at for dq in self._tenants.values()
                 for e in dq), default=None)
            front_queue = {
                "depth": sum(len(dq) for dq in self._tenants.values()),
                "oldest_s": (now - oldest) if oldest is not None else 0.0,
            }
        return {
            "schema": "mxtpu-serving-fleet-debug-v1",
            "draining": draining,
            "heartbeat_timeout_s": self.heartbeat_timeout,
            "replicas": reps,
            "tenants": tenants,
            "front_queue": front_queue,
            "counters": counters,
            "journal": self.journal.snapshot(),
        }
