"""Retry core: exponential backoff + deterministic jitter + deadline.

The port's copy of the JAX package's `resilience/retry.py`: one policy
object for every reconnect/redial loop. The knobs are registered in
config.py (`MXTPU_RETRY_*`) so a chaos run or a flaky-network deployment
tunes all of them from the environment; call sites may override any field
for loops with different economics (a first connect waits much longer
than a mid-training resend).

Jitter is drawn from a seeded PRNG, NOT `random.random()` — the point of
the fault-injection harness is that two runs with the same seed retry at
the same instants, so a reproduced chaos failure replays its timing too.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import time

logger = logging.getLogger(__name__)

__all__ = ["RetryPolicy"]

_RETRY_METRIC = "mxtpu_retry_attempts_total"
_RETRY_HELP = ("Retry attempts issued by resilience.RetryPolicy, by site "
               "and outcome (retried = will try again; exhausted = "
               "attempts/deadline spent, error re-raised).")


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry schedule.

    attempt `k` (0-based) sleeps `min(max_delay, base_delay * 2**k)`
    scaled by `1 + U(-jitter, +jitter)` before trying again; retries stop
    when `max_attempts` calls were made or when the next sleep would cross
    `deadline` seconds since the first attempt. `attempt_timeout` is
    advisory for the call site (e.g. a socket connect/settimeout) — the
    policy itself never interrupts a running attempt.
    """

    max_attempts: int = 8
    base_delay: float = 0.05
    max_delay: float = 2.0
    deadline: float = 120.0
    jitter: float = 0.1
    attempt_timeout: float = 30.0
    seed: int = 0

    @classmethod
    def from_knobs(cls, **overrides):
        """Policy from the registered MXTPU_RETRY_* knobs; keyword
        overrides win (call sites with different economics)."""
        from .. import config as _config

        fields = dict(
            max_attempts=_config.get("MXTPU_RETRY_MAX_ATTEMPTS"),
            base_delay=_config.get("MXTPU_RETRY_BASE_DELAY"),
            max_delay=_config.get("MXTPU_RETRY_MAX_DELAY"),
            deadline=_config.get("MXTPU_RETRY_DEADLINE"),
            jitter=_config.get("MXTPU_RETRY_JITTER"),
        )
        fields.update(overrides)
        return cls(**fields)

    def delays(self):
        """The deterministic backoff schedule (one delay per retry gap);
        exposed for tests and for call sites that drive their own loop."""
        rng = random.Random(self.seed)
        for k in range(max(0, self.max_attempts - 1)):
            d = min(self.max_delay, self.base_delay * (2.0 ** k))
            if self.jitter:
                d *= 1.0 + rng.uniform(-self.jitter, self.jitter)
            yield max(0.0, d)

    def call(self, fn, retry_on, site="", on_retry=None):
        """Run `fn(attempt)` until it returns, raises a non-retryable
        error, or the policy is exhausted (re-raises the last error).

        `on_retry(attempt, exc, remaining)` fires before each sleep with
        the 0-based failed attempt, the exception, and the seconds left
        until the deadline — the hook every call site uses for its debug
        redial log.
        """
        from .. import telemetry as _telemetry

        start = time.monotonic()
        delays = self.delays()
        attempt = 0
        while True:
            try:
                return fn(attempt)
            except retry_on as e:
                delay = next(delays, None)
                elapsed = time.monotonic() - start
                remaining = self.deadline - elapsed
                if delay is None or elapsed + delay > self.deadline:
                    from ..telemetry import recorder as _recorder

                    _telemetry.inc(_RETRY_METRIC, 1, help=_RETRY_HELP,
                                   site=site or "unknown",
                                   outcome="exhausted")
                    _recorder.log_event(
                        "retry_exhausted", site=site or "unknown",
                        attempts=attempt + 1, exc=type(e).__name__,
                        elapsed_s=round(elapsed, 3))
                    # the caller is about to see the error its retries
                    # were hiding — this rank is likely going down, so
                    # preserve the black box now
                    _recorder.dump(f"retry-exhausted-{site or 'unknown'}")
                    raise
                _telemetry.inc(_RETRY_METRIC, 1, help=_RETRY_HELP,
                               site=site or "unknown", outcome="retried")
                _telemetry.log_event(
                    "retry", site=site or "unknown", attempt=attempt + 1,
                    exc=type(e).__name__, delay_s=round(delay, 4))
                if on_retry is not None:
                    on_retry(attempt, e, remaining)
                else:
                    logger.debug(
                        "retry[%s]: attempt %d failed (%s: %s); retrying "
                        "in %.3fs, %.1fs of deadline remaining",
                        site or "?", attempt + 1, type(e).__name__, e,
                        delay, remaining)
                time.sleep(delay)
                attempt += 1
