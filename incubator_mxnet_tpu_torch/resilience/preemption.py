"""Preemption-safe graceful shutdown: drain the step, bundle the state,
leave the quorum, exit with a distinct code.

The port's copy of the JAX package's `resilience/preemption.py`, but for
the generator position the bundle records (below).

Cloud GPU capacity is routinely reclaimed with a short notice window:
the kernel delivers SIGTERM and the job has seconds to get its state to
durable storage. The naive reaction — die mid-step — costs the epoch
(checkpoints are per-epoch) and, in a PS job, stalls every survivor until
the heartbeat timeout evicts the corpse. This module implements the
drain protocol instead (cf. Varuna, Athlur et al., EuroSys'22 on
low-priority/spot training):

1. `install()` chains SIGTERM/SIGINT handlers (same discipline as the
   flight recorder's excepthooks: previous handlers still run). The
   handler ONLY sets a flag — no IO, no locks; a Python signal handler
   interrupts the main thread between bytecodes, so touching the
   telemetry ring or the checkpoint path from it could deadlock against
   the very code it interrupted. A SECOND signal escalates: the handler
   raises `Preempted` immediately for jobs stuck in a long step.
2. The training loop polls `requested()` (or calls
   `maybe_checkpoint_and_exit`) at step/epoch boundaries — the in-flight
   step always completes, so the bundle is taken at a consistent point.
3. `write_bundle()` captures the FULL resume state crash-consistently:
   parameters, optimizer states, the data pipeline's mid-epoch cursor
   (`loader.state_dict()`), and the global generator position
   (`random.get_state()`, the (seed, counter) pair), each through the
   tmp/fsync/rename + manifest protocol.
4. `checkpoint_and_exit()` additionally retires this rank from the PS
   sync group via the graceful-leave RPC (survivors' quorum shrinks NOW,
   no heartbeat-timeout stall), dumps the flight recorder, and exits
   with `PREEMPTED_EXIT_CODE` (83) so supervisors can distinguish "was
   preempted, resume me" from a crash.

`read_bundle` hands the bundle back to a resuming job, which continues
from the batch after the drain point with the same data order and
generator position.
"""
from __future__ import annotations

import logging
import os
import pickle
import signal
import threading

from .. import random as _random
from . import checkpoint as _checkpoint

logger = logging.getLogger(__name__)

__all__ = ["PREEMPTED_EXIT_CODE", "Preempted", "install", "uninstall",
           "requested", "reset", "bundle_paths", "write_bundle",
           "read_bundle", "clear_bundle", "checkpoint_and_exit",
           "maybe_checkpoint_and_exit"]

# distinct from any Python default so a supervisor can branch on it:
# "exit 83 == drained cleanly, resubmit with auto_resume"
PREEMPTED_EXIT_CODE = 83

_PREEMPT_METRIC = "mxtpu_preemptions_total"
_PREEMPT_HELP = ("Preemption drains completed: a termination signal "
                 "arrived, the in-flight step finished, and a resume "
                 "bundle was written, by signal.")

BUNDLE_SUFFIX = "-preempt.bundle"
_PARAMS_SUFFIX = "-preempt.params"
_STATES_SUFFIX = "-preempt.states"


class Preempted(SystemExit):
    """Raised (or escalated to) when a preemption drain ends the process;
    carries `PREEMPTED_EXIT_CODE` so `sys.exit` semantics apply."""

    def __init__(self, signum=None):
        super().__init__(PREEMPTED_EXIT_CODE)
        self.signum = signum


# handler state: flag + signum, written ONLY from the signal handler
_lock = threading.Lock()
_requested_event = threading.Event()
_signum = None
_prev_handlers = None   # {signum: previous handler} while installed


def install(signals=(signal.SIGTERM, signal.SIGINT)):
    """Chain drain handlers onto `signals` (idempotent). The first
    delivery marks the request and lets the previous handler run; a
    second delivery of any installed signal escalates to an immediate
    `Preempted` raise (the operator pressed Ctrl-C twice, or the
    platform re-signaled a job that is stuck mid-step)."""
    global _prev_handlers
    with _lock:
        if _prev_handlers is not None:
            return
        _prev_handlers = {}
        for sig in signals:
            prev = signal.getsignal(sig)
            _prev_handlers[sig] = prev

            def _handler(signum, frame, _prev=prev):
                global _signum
                if _requested_event.is_set():
                    raise Preempted(signum)
                _signum = signum
                _requested_event.set()
                if callable(_prev):
                    _prev(signum, frame)

            signal.signal(sig, _handler)
    logger.info("preemption: drain handlers installed for %s",
                [signal.Signals(s).name for s in signals])


def uninstall():
    """Restore the pre-install handlers (tests; idempotent)."""
    global _prev_handlers
    with _lock:
        if _prev_handlers is None:
            return
        for sig, prev in _prev_handlers.items():
            signal.signal(sig, prev)
        _prev_handlers = None


def requested():
    """True once a termination signal arrived; poll this at step/epoch
    boundaries to drain instead of dying mid-step."""
    return _requested_event.is_set()


def reset():
    """Clear the request flag (tests / a job that decided not to die)."""
    global _signum
    _requested_event.clear()
    _signum = None


def bundle_paths(prefix):
    """(bundle, params, states) paths for `prefix` — the resume bundle's
    fixed on-disk shape."""
    prefix = str(prefix)
    return (prefix + BUNDLE_SUFFIX, prefix + _PARAMS_SUFFIX,
            prefix + _STATES_SUFFIX)


def write_bundle(prefix, trainer=None, net=None, loader=None, epoch=0):
    """Crash-consistently capture the full resume state under `prefix`.

    Writes `-preempt.params` (when `net` is given), `-preempt.states`
    (when `trainer` is given), then the `-preempt.bundle` descriptor —
    LAST, so a crash mid-bundle leaves no descriptor pointing at absent
    payloads. The descriptor records the epoch being interrupted, the
    global PRNG position, and the data pipeline's mid-epoch cursor.
    """
    bundle, params, states = bundle_paths(prefix)
    if net is not None:
        _checkpoint.atomic_save(params, net.save_parameters)
    if trainer is not None:
        trainer.save_states(states)
    payload = {
        "version": 1,
        "epoch": int(epoch),
        "rng": _random.get_state(),
        "loader": None if loader is None else loader.state_dict(),
        "has_params": net is not None,
        "has_states": trainer is not None,
    }
    _checkpoint.atomic_write_bytes(bundle, pickle.dumps(payload))
    logger.info("preemption: resume bundle written at %s (epoch %d, "
                "loader %s)", bundle, int(epoch),
                "mid-epoch" if loader is not None else "absent")
    return bundle


def read_bundle(prefix):
    """The verified bundle descriptor for `prefix`, or None.

    Stricter than `verify()` alone: a bundle file MUST carry a manifest
    (they are always written with one), so the legacy no-manifest
    loophole cannot admit a torn bundle whose sidecar was lost. Payload
    files the descriptor declares are verified too."""
    bundle, params, states = bundle_paths(prefix)
    if not os.path.isfile(bundle):
        return None
    if _checkpoint.read_manifest(bundle) is None \
            or not _checkpoint.verify(bundle):
        logger.warning("preemption: bundle %s failed verification; "
                       "ignoring it", bundle)
        return None
    try:
        with open(bundle, "rb") as f:
            payload = pickle.loads(f.read())
    except (OSError, ValueError, pickle.UnpicklingError, EOFError) as e:
        logger.warning("preemption: bundle %s unreadable (%s: %s); "
                       "ignoring it", bundle, type(e).__name__, e)
        return None
    if not isinstance(payload, dict) or payload.get("version") != 1:
        logger.warning("preemption: bundle %s has unknown layout; "
                       "ignoring it", bundle)
        return None
    if payload.get("has_params") and not _checkpoint.verify(params):
        logger.warning("preemption: bundle %s names a params payload "
                       "that fails verification; ignoring it", bundle)
        return None
    if payload.get("has_states") and not _checkpoint.verify(states):
        logger.warning("preemption: bundle %s names a states payload "
                       "that fails verification; ignoring it", bundle)
        return None
    return payload


def clear_bundle(prefix):
    """Remove the bundle files (+ manifests) — called once a resume has
    consumed them, so a later crash cannot resurrect a stale position."""
    for path in bundle_paths(prefix):
        for p in (path, _checkpoint.manifest_path(path)):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass


def checkpoint_and_exit(prefix, trainer=None, net=None, loader=None,
                        epoch=0, kv=None):
    """The drain endgame: bundle the state, retire from the sync group,
    dump the black box, raise `Preempted` (exit code 83).

    `kv` (or `trainer`'s kvstore) is asked to `leave()` when it knows
    how — the PS quorum shrinks immediately instead of stalling
    survivors until the heartbeat timeout. Telemetry happens HERE, on
    the main thread, never in the signal handler."""
    from .. import telemetry as _telemetry
    from ..telemetry import recorder as _recorder

    signum = _signum
    signame = (signal.Signals(signum).name
               if signum is not None else "request")
    _telemetry.log_event("preemption_drain", prefix=str(prefix),
                         epoch=int(epoch), signal=signame)
    write_bundle(prefix, trainer=trainer, net=net, loader=loader,
                 epoch=epoch)
    if kv is None and trainer is not None:
        kv = getattr(trainer, "_kvstore", None)
    leave = getattr(kv, "leave", None)
    if callable(leave):
        try:
            leave()
        except Exception as e:
            # dying anyway; the bundle is safe on disk and survivors
            # will evict this rank by heartbeat instead
            logger.warning("preemption: graceful leave failed (%s: %s); "
                           "exiting regardless", type(e).__name__, e)
    _telemetry.inc(_PREEMPT_METRIC, 1, help=_PREEMPT_HELP, signal=signame)
    # preserve the timeline of the drained run before the process goes
    _recorder.dump("preemption")
    logger.info("preemption: drain complete; exiting %d",
                PREEMPTED_EXIT_CODE)
    raise Preempted(signum)


def maybe_checkpoint_and_exit(prefix, trainer=None, net=None, loader=None,
                              epoch=0, kv=None):
    """Poll-and-drain helper for training loops: no-op until a signal
    arrived, then runs the full drain. Call at step/epoch boundaries."""
    if requested():
        checkpoint_and_exit(prefix, trainer=trainer, net=net,
                            loader=loader, epoch=epoch, kv=kv)
