"""Periodic TensorBoard logger for the telemetry registry
(`incubator_mxnet_tpu/telemetry/tb.py`, the port's own copy).

Callback-protocol compatible with `contrib.tensorboard.LogMetricsCallback`
(callable on a BatchEndParam, safe to drop into a `batch_end_callback`
list), but sourcing scalars from the metrics registry instead of an
eval_metric: counters and gauges log their value, histograms log count /
rate-friendly sum / mean.
"""
from __future__ import annotations

__all__ = ["LogTelemetryCallback"]


class LogTelemetryCallback:
    """Every `interval` invocations, write each registry series as a
    TensorBoard scalar keyed `prefix/metric_name[/label=value,...]`.

    `summary_writer` may be injected (anything with add_scalar/flush);
    otherwise torch's SummaryWriter backs it, with the same ImportError
    gating as contrib.tensorboard.LogMetricsCallback.
    """

    def __init__(self, logging_dir=None, interval=1, prefix="telemetry",
                 registry=None, summary_writer=None):
        from .metrics import REGISTRY

        self.interval = max(1, int(interval))
        self.prefix = prefix
        self.registry = registry or REGISTRY
        self.step = 0
        if summary_writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "LogTelemetryCallback needs a tensorboard writer; "
                    "install `tensorboard` (torch.utils.tensorboard "
                    "backend) or inject summary_writer=") from e
            summary_writer = SummaryWriter(logging_dir)
        self.summary_writer = summary_writer

    def _tag(self, name, labels):
        if not labels:
            return f"{self.prefix}/{name}"
        body = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        return f"{self.prefix}/{name}/{body}"

    def __call__(self, param=None):
        """BatchEndParam/epoch-end callback protocol; `param` is unused —
        the registry is the data source."""
        self.step += 1
        if self.step % self.interval:
            return
        for metric in self.registry.collect():
            for labels, child in metric.series():
                tag = self._tag(metric.name, labels)
                if metric.kind == "histogram":
                    _b, _n, count, total, _mn, _mx = child.snapshot()
                    self.summary_writer.add_scalar(
                        f"{tag}/count", count, self.step)
                    self.summary_writer.add_scalar(
                        f"{tag}/sum", total, self.step)
                    if count:
                        self.summary_writer.add_scalar(
                            f"{tag}/mean", total / count, self.step)
                else:
                    self.summary_writer.add_scalar(
                        tag, child.value, self.step)
        self.summary_writer.flush()

    def flush(self):
        self.summary_writer.flush()

    def close(self):
        if hasattr(self.summary_writer, "close"):
            self.summary_writer.close()
