"""TensorBoard metric logging (`incubator_mxnet_tpu/contrib/
tensorboard.py`, the port's own copy): `LogMetricsCallback`, a
Speedometer-shaped batch or eval callback that writes scalar summaries
instead of printing.

Backend: an injected `summary_writer` (anything with add_scalar and
flush), else `torch.utils.tensorboard.SummaryWriter`, which needs the
`tensorboard` package; without it the constructor raises ImportError."""
from __future__ import annotations

from ..telemetry.tb import LogTelemetryCallback  # noqa: F401 — the registry-
# sourced sibling of LogMetricsCallback (same callback protocol, same
# SummaryWriter gating); lives in telemetry/tb.py, re-exported here so both
# tensorboard callbacks are importable from one place.

__all__ = ["LogMetricsCallback", "LogTelemetryCallback"]


class LogMetricsCallback:
    """Write each metric's current value as a TensorBoard scalar, keyed
    `prefix/metric_name`, at every callback invocation."""

    def __init__(self, logging_dir, prefix=None, flush_secs=5,
                 summary_writer=None):
        self.prefix = prefix
        self.step = 0
        self._flush_secs = flush_secs
        self._last_flush = 0.0
        if summary_writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "LogMetricsCallback needs a tensorboard writer; "
                    "install `tensorboard` (torch.utils.tensorboard "
                    "backend) or inject summary_writer=") from e
            summary_writer = SummaryWriter(logging_dir)
        self.summary_writer = summary_writer

    def __call__(self, param):
        """BatchEndParam/epoch-end callback protocol."""
        if param.eval_metric is None:
            return
        self.step += 1
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = f"{self.prefix}/{name}"
            self.summary_writer.add_scalar(name, value, self.step)
        import time

        now = time.monotonic()
        if now - self._last_flush >= self._flush_secs:
            # fit() never calls flush(); throttled flushing keeps events
            # visible for short runs without per-batch file IO
            self._last_flush = now
            self.summary_writer.flush()

    def flush(self):
        self.summary_writer.flush()

    def close(self):
        self.summary_writer.close()
