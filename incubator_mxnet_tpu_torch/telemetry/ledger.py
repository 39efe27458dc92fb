"""Device memory ledger: role-tagged live-bytes accounting for tensors.

The port's copy of the JAX package's `telemetry/ledger.py`, with its
roles, metrics and events. PyTorch's caching allocator knows its blocks
but not what they hold; this ledger keeps the framework-side view: every
tracked tensor contributes its bytes to a per-role total (params / grads
/ optimizer_state / activations / kv_buffers), released when the tensor
is collected. `GluonTrainStep` tracks its optimizer states as
`optimizer_state`.

The accounting feeds the gauges `mxtpu_ledger_live_bytes{role=}` and
`mxtpu_ledger_peak_bytes`, with peak attribution: `peak_info()` names the
span (and phase tag) active when the high-watermark was set.

Every entry point returns immediately while telemetry is disabled (no
registry writes); weakref callbacks from entries tracked while enabled
keep the *internal* byte counts consistent but also skip the registry
when the switch is off. Not carried over: the JAX ledger's per-shard
bytes of mesh-placed arrays and `donate` (the port runs on one device
and donates no buffer), and what only `telemetry/memory.py` calls, which
the port does not have yet (ROADMAP Queue A): `untrack`, the step
samples (`step_sample`, `samples`), the leak heuristic and its
`mxtpu_ledger_leak_events_total` counter, and the trace's `mem` records.
"""
from __future__ import annotations

import weakref

from ..analysis.sanitizers import san_lock
from .metrics import REGISTRY
from .spans import current_span

__all__ = ["track", "live_bytes", "peak_info", "reset", "ROLES"]

ROLES = ("params", "grads", "optimizer_state", "activations", "kv_buffers",
         "embedding")

LIVE_BYTES = "mxtpu_ledger_live_bytes"
_LIVE_HELP = ("Live NDArray bytes tracked by the HBM ledger, by role "
              "(params/grads/optimizer_state/activations/kv_buffers).")
PEAK_BYTES = "mxtpu_ledger_peak_bytes"
_PEAK_HELP = ("High-watermark of ledger-tracked live bytes; "
              "ledger.peak_info() names the span active at the peak.")
_lock = san_lock("telemetry.ledger")
_entries = {}        # token (weakref | int) -> (role, nbytes, obj_id, ref)
_by_id = {}          # id(obj) -> token
_by_role = {}        # role -> live bytes
_total = 0
_peak = 0
_peak_span = None
_peak_breakdown = {}

_enabled_fn = None


def _on():
    global _enabled_fn
    fn = _enabled_fn
    if fn is None:
        from . import enabled as fn
        _enabled_fn = fn
    return fn()


def _nbytes(obj):
    """A tensor's bytes (0 for anything without storage)."""
    try:
        return int(obj.numel() * obj.element_size())
    except (AttributeError, RuntimeError, TypeError):
        return 0


def _add_locked(role, nbytes):
    """Caller holds _lock. Returns True when a new peak was set."""
    global _total, _peak, _peak_span, _peak_breakdown
    _by_role[role] = _by_role.get(role, 0) + nbytes
    _total += nbytes
    if nbytes > 0 and _total > _peak:
        _peak = _total
        sp = current_span()
        if sp is not None and getattr(sp, "name", None):
            tag = (sp.tags or {}).get("phase")
            _peak_span = f"{sp.name}[{tag}]" if tag else sp.name
        else:
            _peak_span = None
        _peak_breakdown = dict(_by_role)
        return True
    return False


def _publish(role, new_peak):
    REGISTRY.gauge(LIVE_BYTES, _LIVE_HELP).set(_by_role.get(role, 0),
                                               role=role)
    if new_peak:
        REGISTRY.gauge(PEAK_BYTES, _PEAK_HELP).set_max(_peak)


def track(obj, role):
    """Start accounting `obj` (a tensor, or a tuple/list of them —
    optimizer states may come as tuples) under `role`. Bytes are
    released when the object is collected. Returns the number of bytes
    tracked."""
    if not _on():
        return 0
    if isinstance(obj, (tuple, list)):
        return sum(track(o, role) for o in obj)
    if obj is None:
        return 0
    nbytes = _nbytes(obj)
    if nbytes <= 0:
        return 0
    obj_id = id(obj)
    ref = None
    try:
        ref = weakref.ref(obj, _dead)
        hash(ref)  # a weakref hashes via its referent...
        token = ref
    except TypeError:
        # ...and a referent that is weakref-able but unhashable is keyed
        # by id, with an id-based death callback kept inside the entry
        token = obj_id
        try:
            ref = weakref.ref(obj, lambda _r, _i=obj_id: _dead_id(_i))
        except TypeError:
            ref = None
    with _lock:
        if obj_id in _by_id:
            return 0  # already tracked; first role wins
        _entries[token] = (role, nbytes, obj_id, ref)
        _by_id[obj_id] = token
        new_peak = _add_locked(role, nbytes)
    _publish(role, new_peak)
    return nbytes


def _release_token(token):
    with _lock:
        entry = _entries.pop(token, None)
        if entry is None:
            return None
        role, nbytes, obj_id = entry[:3]
        _by_id.pop(obj_id, None)
        _add_locked(role, -nbytes)
    return role, nbytes


def _dead(ref):
    released = _release_token(ref)
    if released is not None and _on():
        _publish(released[0], False)


def _dead_id(obj_id):
    """Death callback for id-keyed entries (unhashable referents)."""
    with _lock:
        token = _by_id.get(obj_id)
    if token is None:
        return
    released = _release_token(token)
    if released is not None and _on():
        _publish(released[0], False)


def live_bytes(role=None):
    """Current tracked bytes, for one role or in total."""
    with _lock:
        if role is None:
            return _total
        return _by_role.get(role, 0)


def peak_info():
    """The high-watermark: bytes, the span active when it was set (None
    when outside any span), and the per-role breakdown at that moment."""
    with _lock:
        return {"peak_bytes": _peak, "span": _peak_span,
                "breakdown": dict(_peak_breakdown)}


def reset():
    """Forget everything tracked (tests). Live objects stay alive; their
    later weakref deaths find no entry and are no-ops."""
    global _total, _peak, _peak_span, _peak_breakdown
    with _lock:
        _entries.clear()
        _by_id.clear()
        _by_role.clear()
        _total = 0
        _peak = 0
        _peak_span = None
        _peak_breakdown = {}
