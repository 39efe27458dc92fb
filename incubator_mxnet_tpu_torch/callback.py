"""Training callbacks (`incubator_mxnet_tpu/callback.py`, the port's own
copy): the Speedometer is a small timer state machine (`_Window`)
separate from its logging. Batch-end callbacks get a
`model.BatchEndParam` (.epoch, .nbatch, .eval_metric, .locals).

`do_checkpoint` and `module_checkpoint` save a symbol and a module, which
wait for the symbolic slice (ROADMAP Queue A 6): they raise
NotImplementedError.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint",
           "LogValidationMetricsCallback",
           "log_train_metric", "ProgressBar"]


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving `prefix-symbol.json` and
    `prefix-NNNN.params`: it needs a symbol, which waits for the symbolic
    slice."""
    raise NotImplementedError(
        "callback.do_checkpoint saves a symbol; the symbolic API is not "
        "ported yet (ROADMAP Queue A 6). Use Trainer.save_checkpoint")


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback delegating to a module's checkpointing: the
    module API waits for the symbolic slice."""
    raise NotImplementedError(
        "callback.module_checkpoint needs the module API, which is not "
        "ported yet (ROADMAP Queue A 6)")


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the running training metric
    (ref: callback.py log_train_metric)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class _Window:
    """Samples/sec over the batches since the last report or reset."""

    def __init__(self):
        self.t0 = None
        self.nbatch0 = 0

    def restart(self, nbatch):
        self.t0 = time.time()
        self.nbatch0 = nbatch

    def rate(self, nbatch, batch_size):
        dt = time.time() - self.t0
        return (nbatch - self.nbatch0) * batch_size / dt if dt > 0 else 0.0


class Speedometer:
    """Batch-end throughput logger (ref: callback.py Speedometer). Reading
    the metric forces a device sync, same as the reference's WaitToRead."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._win = _Window()
        self._last_nbatch = 0

    def __call__(self, param):
        wrapped = param.nbatch < self._last_nbatch  # new epoch restarted at 0
        self._last_nbatch = param.nbatch
        if self._win.t0 is None or wrapped:
            self._win.restart(param.nbatch)
            return
        if param.nbatch % self.frequent != 0 or param.nbatch == self._win.nbatch0:
            return
        speed = self._win.rate(param.nbatch, self.batch_size)
        if param.eval_metric is not None:
            pairs = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s",
                         param.epoch, param.nbatch, speed,
                         "\t".join(f"{n}={v:f}" for n, v in pairs))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, speed)
        self._win.restart(param.nbatch)


class ProgressBar:
    """Batch-end textual progress bar (ref: callback.py ProgressBar)."""

    def __init__(self, total, length=80):
        self.total = total
        self.length = length

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        filled = int(round(self.length * frac))
        logging.info("[%s] %s%%",
                     "=" * filled + "-" * (self.length - filled),
                     int(round(100 * frac)))


class LogValidationMetricsCallback:
    """Log eval metrics at epoch end (ref: callback.py
    LogValidationMetricsCallback) — the eval_end_callback counterpart of
    log_train_metric."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
