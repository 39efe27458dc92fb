"""The gluon Trainer (`incubator_mxnet_tpu/gluon/trainer.py`), on one
device.

`step(batch_size)` sets the optimizer's `rescale_grad` to
`scale / batch_size` and updates every parameter whose `grad_req` is
not "null" from its gradient buffer (`Parameter.grad()`, which
`autograd.backward` wrote), through the optimizer's batched update
(`Updater.update` -> `SGD.update`: one `torch._foreach_*` call per
operation for a float32 group). The JAX Trainer's aggregated and
per-parameter paths compute the same values (`_aggregation_supported`);
the port has the one batched path. `allreduce_grads` is a no-op: there
is no `dist` kvstore on one device, as `_init_kvstore` makes it there.
kvstore, ZeRO and the sparse embedding service wait for ROADMAP Queue A
4-5 (`kvstore` names containing "dist" raise).

The divergence guardrail (`MXTPU_GUARDRAIL_POLICY`) checks the
gradients with one fused non-finite sweep (one host read) before they
reach the optimizer: "skip" drops the update, "rollback" raises
`GuardrailRollback`; "backoff" needs contrib.amp's loss scaler (Queue A
6) and raises, naming it. With telemetry on a step is the
`trainer.step` span, observes `mxtpu_trainer_step_seconds` and closes
the step statistics (`stepstats.step_end()`).

`save_states` / `load_states` use the Updater's pickle ({index: numpy
array}, the JAX package's format); `save_checkpoint`, `save_bundle` and
`auto_resume` write and read crash-consistent checkpoints and the
preemption bundle through `resilience`.
"""
from __future__ import annotations

import os
import signal
import time

import torch

from .. import config as _config
from .. import optimizer as opt
from .. import telemetry as _telemetry
from ..resilience import fault as _fault
from .parameter import ParameterDict

__all__ = ["GuardrailRollback", "Trainer"]

_GUARDRAIL_METRIC = "mxtpu_guardrail_trips_total"
_GUARDRAIL_HELP = ("Divergence-guardrail trips in Trainer.step, by policy "
                   "(skip/backoff/rollback) and reason.")
_GUARDRAIL_POLICIES = ("skip", "backoff", "rollback")


class GuardrailRollback(RuntimeError):
    """The divergence guardrail (MXTPU_GUARDRAIL_POLICY=rollback) saw
    non-finite gradients: the step was not applied and the training loop
    should restore the last good checkpoint via `Trainer.auto_resume`
    and replay from there."""


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if isinstance(kvstore, str) and "dist" in kvstore:
            raise NotImplementedError(
                f"kvstore={kvstore!r}: distributed kvstores are not ported "
                "yet (ROADMAP Queue A 4)")
        if update_on_kvstore:
            raise NotImplementedError("update_on_kvstore needs a "
                                      "parameter server (ROADMAP Queue A 5)")
        self._params = [p for p in params if p.grad_req != "null"]
        self._all_params = list(params)
        self._scale = 1.0
        idx2name = {i: p.name for i, p in enumerate(self._params)}
        if isinstance(optimizer, str):
            self._optimizer = opt.create(optimizer, param_idx2name=idx2name,
                                         **dict(optimizer_params or {}))
        else:
            self._optimizer = optimizer
            self._optimizer.idx2name.update(idx2name)
        self._updater = opt.get_updater(self._optimizer)
        self._kvstore = None

    @property
    def learning_rate(self):
        return self._optimizer.lr

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self):
        """A no-op on one device (no dist kvstore)."""
        with _telemetry.span("trainer.allreduce_grads"), \
                _telemetry.stepstats.phase("allreduce"):
            pass

    # -- the guardrail ------------------------------------------------------

    def _live(self):
        return [p for p in self._params if p._data is not None]

    def _grads_nonfinite(self):
        """One fused non-finite sweep over every gradient, one host read."""
        flags = [~torch.isfinite(p.grad()._data).all() for p in self._live()]
        return bool(torch.stack(flags).any()) if flags else False

    def _guardrail_check(self, where):
        """True when the caller must skip this step's update; `rollback`
        raises instead."""
        policy = _config.get("MXTPU_GUARDRAIL_POLICY")
        if not policy:
            return False
        if policy not in _GUARDRAIL_POLICIES:
            raise ValueError(
                f"MXTPU_GUARDRAIL_POLICY={policy!r}; expected one of "
                f"{_GUARDRAIL_POLICIES} (or empty to disable)")
        if policy == "backoff":
            raise NotImplementedError(
                "MXTPU_GUARDRAIL_POLICY=backoff halves contrib.amp's "
                "dynamic loss scale, and contrib.amp is not ported yet "
                "(ROADMAP Queue A 6); use skip or rollback")
        inj = _fault.injector()
        if inj.active and inj.action("grad.nonfinite") is not None:
            live = self._live()
            if live:  # poison one gradient at a reproducible step
                g = live[0].grad()
                g._data = g._data * float("nan")
        if not self._grads_nonfinite():
            return False
        from ..telemetry import recorder as _recorder

        _telemetry.inc(_GUARDRAIL_METRIC, 1, help=_GUARDRAIL_HELP,
                       policy=policy, reason="nonfinite-grad")
        _telemetry.log_event("guardrail_trip", policy=policy,
                             reason="nonfinite-grad", where=where)
        _recorder.dump("guardrail-trip")
        if policy == "rollback":
            raise GuardrailRollback(
                "non-finite gradients detected; the step was not applied "
                "— restore the last good checkpoint (Trainer.auto_resume) "
                "and replay")
        return True

    # -- stepping -----------------------------------------------------------

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale the gradients by 1 / batch_size and update."""
        if not _telemetry.enabled():
            return self._step_impl(batch_size, ignore_stale_grad)
        t0 = time.perf_counter()
        with _telemetry.span("trainer.step"):
            try:
                return self._step_impl(batch_size, ignore_stale_grad)
            finally:
                _telemetry.observe(
                    "mxtpu_trainer_step_seconds", time.perf_counter() - t0,
                    help="End-to-end Trainer.step latency (allreduce + "
                         "optimizer update; excludes forward/backward).")
                _telemetry.stepstats.step_end()

    def _step_impl(self, batch_size, ignore_stale_grad=False):
        inj = _fault.injector()
        if inj.active and inj.action("train.step") == "sigterm":
            # deterministic preemption: the drain handler only flags it,
            # the step completes and the loop's boundary poll bundles
            os.kill(os.getpid(), signal.SIGTERM)
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        if self._guardrail_check("local_update"):
            return
        with _telemetry.stepstats.phase("optimizer_update"):
            self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of `step` without the allreduce."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._guardrail_check("update"):
            return
        with _telemetry.stepstats.phase("optimizer_update"):
            self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        live = [(i, p) for i, p in enumerate(self._params)
                if p._data is not None]
        if not live:
            return
        self._updater.update([i for i, _ in live],
                             [p.grad() for _, p in live],
                             [p.data() for _, p in live])

    # -- state --------------------------------------------------------------

    def save_states(self, fname):
        from .. import resilience as _resilience

        _resilience.atomic_write_bytes(
            fname, self._updater.get_states(dump_optimizer=False),
            site="ckpt.states")

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def save_checkpoint(self, prefix, epoch, net=None):
        """`prefix-%04d.params` (when `net` is given) and
        `prefix-%04d.states`, crash-consistently."""
        from .. import resilience as _resilience

        _telemetry.log_event("trainer_checkpoint", prefix=str(prefix),
                             epoch=int(epoch))
        if net is not None:
            _resilience.atomic_save(f"{prefix}-{epoch:04d}.params",
                                    net.save_parameters)
        self.save_states(f"{prefix}-{epoch:04d}.states")

    def save_bundle(self, prefix, epoch, net=None, loader=None):
        """The preemption resume bundle: parameters, optimizer states, the
        loader's cursor and the global random state, crash-consistently
        (`resilience.preemption.write_bundle`)."""
        from ..resilience import preemption as _preemption

        return _preemption.write_bundle(prefix, trainer=self, net=net,
                                        loader=loader, epoch=epoch)

    def auto_resume(self, prefix, net=None, loader=None):
        """Resume under `prefix`: a verified preemption bundle at least as
        new as the epoch checkpoints (returns its epoch, the loader
        fast-forwarded), else the newest verified epoch checkpoint
        (returns that epoch + 1), else 0."""
        from .. import model as _model
        from .. import random as _random
        from .. import resilience as _resilience
        from ..resilience import preemption as _preemption

        epoch = _model.latest_valid_checkpoint(prefix)
        bundle = _preemption.read_bundle(prefix)
        if bundle is not None and (epoch is None
                                   or bundle["epoch"] >= epoch + 1):
            b_paths = _preemption.bundle_paths(prefix)
            _telemetry.log_event("trainer_resume", prefix=str(prefix),
                                 epoch=int(bundle["epoch"]), fresh=False,
                                 bundle=True)
            if net is not None and bundle["has_params"]:
                net.load_parameters(b_paths[1])
            if bundle["has_states"]:
                self.load_states(b_paths[2])
            if loader is not None and bundle["loader"] is not None:
                loader.load_state_dict(bundle["loader"])
            _random.set_state(bundle["rng"])
            return int(bundle["epoch"])
        if epoch is None:
            _telemetry.log_event("trainer_resume", prefix=str(prefix),
                                 epoch=-1, fresh=True)
            return 0
        _telemetry.log_event("trainer_resume", prefix=str(prefix),
                             epoch=int(epoch), fresh=False)
        if net is not None:
            net.load_parameters(f"{prefix}-{epoch:04d}.params")
        states = f"{prefix}-{epoch:04d}.states"
        if os.path.isfile(states) and _resilience.verify(states):
            self.load_states(states)
        return epoch + 1
