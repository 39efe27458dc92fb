"""Checkpoint discovery and parameter transfer (`incubator_mxnet_tpu/
model.py`): the newest verified epoch checkpoint under a prefix, the
walk-back that `gluon.Trainer.auto_resume` starts from, `load_params`
(an epoch's arg and aux parameters, verified against the checkpoint's
manifest), `bootstrap_params` (a joining worker's parameters from the
parameter server) and `BatchEndParam`, what batch-end callbacks receive.
The rest of `model.py` (the legacy `FeedForward` and the checkpoint
helpers of the symbolic API) waits for the symbolic slice.
"""
from __future__ import annotations

import collections
import logging
import os
import re

from . import config as _config
from . import resilience as _resilience
from . import telemetry as _telemetry

__all__ = ["BatchEndParam", "bootstrap_params", "latest_valid_checkpoint",
           "load_params"]

BatchEndParam = collections.namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])

logger = logging.getLogger(__name__)


def latest_valid_checkpoint(prefix):
    """Newest epoch under `prefix` whose params file passes manifest
    verification, or None — the recovery entry point: after a crash,
    resume from this epoch and every torn/corrupt newer file is skipped.

    The walk-back is BOUNDED by MXTPU_CKPT_WALKBACK (0 = unbounded):
    many consecutive corrupt epochs usually mean a sick filesystem, not
    a torn tail — better to stop and say so than to silently resume
    from days-old weights. Every skipped epoch lands in the flight
    recorder."""
    d = os.path.dirname(prefix) or "."
    pat = re.compile(re.escape(os.path.basename(prefix))
                     + r"-(\d{4,})\.params$")
    try:
        names = os.listdir(d)
    except OSError:
        return None
    epochs = sorted({int(m.group(1)) for n in names
                     if (m := pat.match(n))}, reverse=True)
    bound = max(0, int(_config.get("MXTPU_CKPT_WALKBACK")))
    for i, epoch in enumerate(epochs):
        if bound and i >= bound:
            logger.warning(
                "latest_valid_checkpoint: gave up after %d corrupt "
                "epochs under %s (MXTPU_CKPT_WALKBACK=%d); refusing to "
                "walk back further — inspect the checkpoint directory",
                bound, prefix, bound)
            _telemetry.log_event("ckpt_walkback_exhausted",
                                 prefix=str(prefix), bound=bound,
                                 newest=epochs[0])
            return None
        if _resilience.verify(f"{prefix}-{epoch:04d}.params"):
            return epoch
        logger.warning("latest_valid_checkpoint: epoch %d under %s "
                       "failed verification; walking back", epoch, prefix)
        _telemetry.log_event("ckpt_skipped", prefix=str(prefix),
                             epoch=int(epoch))
    return None


def load_params(prefix, epoch):
    """(arg_params, aux_params) of `prefix-EPOCH.params` ("arg:" and
    "aux:" names), on the current context. A file that exists but fails
    its manifest's checksum raises OSError; a missing one
    FileNotFoundError."""
    from . import ndarray as nd

    _telemetry.log_event("model_load", prefix=str(prefix), epoch=int(epoch))
    path = f"{prefix}-{epoch:04d}.params"
    if os.path.isfile(path) and not _resilience.verify(path):
        raise OSError(
            f"checkpoint {path} failed checksum verification (torn or "
            "corrupted write); latest_valid_checkpoint(prefix) finds the "
            "newest epoch that still verifies")
    arg_params, aux_params = {}, {}
    for k, v in nd.load(path).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def bootstrap_params(client, keys=None):
    """A freshly admitted worker's parameters: the parameter server's
    keys (all, or `keys`), each verified against the server's state
    manifest, as {key: NDArray} on the current context. `client` is a
    `ps.PSClient` that has joined."""
    from . import ndarray as nd

    raw = client.bootstrap(keys)
    _telemetry.log_event("model_bootstrap", keys=len(raw),
                         epoch=client.epoch)
    return {k: nd.array(v) for k, v in raw.items()}
