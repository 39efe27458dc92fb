"""The gluon Trainer (`incubator_mxnet_tpu/gluon/trainer.py`).

`step(batch_size)` sets the optimizer's `rescale_grad` to
`scale / batch_size` and updates every parameter whose `grad_req` is
not "null" from its gradient buffer (`Parameter.grad()`, which
`autograd.backward` wrote; a `RowSparseNDArray` for a row-sparse
embedding, which the optimizer's lazy path takes).

The kvstore (`_init_kvstore`, at the first step): `kvstore=
"dist_async_server"` (or `update_on_kvstore=True` with a local store, or
a `kvstore.KVStore` given with it) makes the store apply the optimizer:
the Trainer ships the optimizer and the weights once, then each step
pushes the gradients and pulls the updated weights, with no local
update. A `KVStore` given without `update_on_kvstore` is an allreduce
buffer: `allreduce_grads` push-pulls each dense gradient through it (on
one worker the sum of one); a row-sparse gradient stays as it is. Other
strings ("device", "local") mean one device and no store. The
collective 'dist_sync' / 'dist_async' stores are ROADMAP Queue A 4
(`kvstore.create` raises). `attach_sparse_service` wires a
`ShardedEmbeddingService` into the step: its stashed row-sparse
gradients are pushed after the dense work. ZeRO waits for Queue A 4.

Updates go one of two ways, as in the JAX Trainer. The aggregated path
groups the dense-typed parameters (a parameter with a row-sparse
`stype` or `grad_stype` goes to the per-parameter rest), in order, into
dtype-homogeneous buckets of at
most `MXNET_OPTIMIZER_AGGREGATION_SIZE` KB (the layout re-derived when
the parameters' dtypes or shapes change) and updates each bucket with
one batched call of the optimizer's `fused_updates`, the arithmetic the
train step runs. The per-parameter path calls the `Updater` once per
parameter (the optimizer's eager `update`, through the registry's update
ops). The per-parameter path is taken when the knob is 0, for
`ignore_stale_grad`, for an optimizer without a batched form of its own
(a user's, which defines only `update`) and for one whose batched form
does not reproduce its eager update (`fused_matches_eager` False: Nadam,
SGLD). Both count `mxtpu_trainer_dispatches_total{kind=
"optimizer_update", path="aggregated" | "per_param"}` (one per bucket,
one per parameter) and the aggregated path observes each bucket's bytes
(`mxtpu_trainer_bucket_bytes`), as JAX counts them. The states live in
the Updater either way, so `save_states` / `load_states` see one set.

The divergence guardrail (`MXTPU_GUARDRAIL_POLICY`) checks the
gradients with one fused non-finite sweep (one host read) before they
reach the optimizer: "skip" drops the update, "rollback" raises
`GuardrailRollback`, "backoff" drops it and halves contrib.amp's loss
scale (attaching a unit scaler pinned at 1.0 when none is attached, so
that later steps keep the overflow check). A scaler attached by
`amp.init_trainer` skips a step whose gradients overflowed and unscales
the others by the scale `amp.scale_loss` applied, at both local update
sites (`step`, `update`); it is refused with server-side updates. With
telemetry on a step is the
`trainer.step` span, observes `mxtpu_trainer_step_seconds`, samples the
memory watermarks (`telemetry.step_boundary()`) and closes the step
statistics (`stepstats.step_end()`).

`save_states` / `load_states` use the Updater's pickle ({index: numpy
array | tuple | None}, the JAX package's format); `save_checkpoint`,
`save_bundle` and `auto_resume` write and read crash-consistent
checkpoints and the preemption bundle through `resilience`.
"""
from __future__ import annotations

import os
import signal
import time

import torch

from .. import config as _config
from .. import kvstore as kvs
from .. import optimizer as opt
from .. import telemetry as _telemetry
from ..ndarray.ndarray import NDArray
from ..resilience import fault as _fault
from .parameter import ParameterDict

__all__ = ["GuardrailRollback", "Trainer"]

_DISPATCHES = "mxtpu_trainer_dispatches_total"
_DISPATCH_HELP = (
    "Optimizer-update dispatches issued by the eager Trainer, by kind "
    "(optimizer_update) and path (aggregated = one per bucket; per_param "
    "= one per tensor).")
_BUCKET_BYTES = "mxtpu_trainer_bucket_bytes"
_BUCKET_HELP = ("Payload bytes of one aggregated-dispatch bucket "
                "(kind: optimizer_update).")

_GUARDRAIL_METRIC = "mxtpu_guardrail_trips_total"
_GUARDRAIL_HELP = ("Divergence-guardrail trips in Trainer.step, by policy "
                   "(skip/backoff/rollback) and reason.")
_GUARDRAIL_POLICIES = ("skip", "backoff", "rollback")


def _grad_tensor(g):
    """The values of a gradient: a dense one's tensor, a row-sparse
    one's rows."""
    from ..ndarray.sparse import BaseSparseNDArray
    return g.data._data if isinstance(g, BaseSparseNDArray) else g._data


def _sparse_typed(p):
    return (getattr(p, "stype", "default") != "default"
            or getattr(p, "grad_stype", "default") != "default")


def _state_data(state):
    """An Updater state's tensors, in its layout."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_data(s) for s in state)
    return state._data


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
        self._kvstore_arg = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
        self._kv_shipped_rescale = None
        self._sparse_service = None
        # the aggregation cap is read once; the bucket layout is derived
        # again whenever the parameters' signature changes
        self._agg_bytes = max(
            0, int(_config.get("MXNET_OPTIMIZER_AGGREGATION_SIZE"))) * 1024
        self._agg_sig = None
        self._agg_buckets = []
        self._agg_rest = []

    @property
    def learning_rate(self):
        return self._optimizer.lr

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)
        self._ship_optimizer_attrs(lr=lr)

    def attach_sparse_service(self, service):
        """Push the row-sparse gradients `service` (a
        `ShardedEmbeddingService`) stashed during the forward at each
        step, after the dense work: with prefetch on, the push only
        queues on the service's ordered worker, ahead of the next step's
        pull."""
        self._sparse_service = service
        return service

    def _ship_optimizer_attrs(self, **attrs):
        """Live optimizer changes reach a server's copy (a snapshot of the
        one shipped; a local store updates with this optimizer itself)."""
        if self._update_on_kvstore and isinstance(
                self._kvstore, kvs.KVStoreDistAsyncServer):
            self._kvstore.set_optimizer_attrs(attrs)

    def _init_kvstore(self):
        """Create (or adopt) the store at the first step; with
        update_on_kvstore, ship the optimizer and the weights to it."""
        if self._kv_initialized:
            return
        arg = self._kvstore_arg
        if isinstance(arg, kvs.KVStore):
            kv = arg
        elif isinstance(arg, str) and ("dist" in arg
                                       or self._update_on_kvstore):
            kv = kvs.create(arg)
        else:
            kv = None
        server = isinstance(kv, kvs.KVStoreDistAsyncServer)
        if self._update_on_kvstore is None:
            self._update_on_kvstore = server
        if server and not self._update_on_kvstore:
            raise ValueError("dist_async_server requires "
                             "update_on_kvstore=True (the server applies "
                             "the optimizer)")
        if kv is not None and self._update_on_kvstore:
            kv.set_optimizer(self._optimizer)
            self._kv_shipped_rescale = self._optimizer.rescale_grad
            for i, p in enumerate(self._params):
                kv.init(i, p.data())
        self._update_on_kvstore = bool(self._update_on_kvstore
                                       and kv is not None)
        self._kvstore = kv
        self._kv_initialized = True

    def allreduce_grads(self):
        """Sum each dense gradient over the store's workers (a no-op
        without a store)."""
        with _telemetry.span("trainer.allreduce_grads"), \
                _telemetry.stepstats.phase("allreduce"):
            self._init_kvstore()
            if self._update_on_kvstore:
                raise ValueError(
                    "allreduce_grads() is not supported when the optimizer "
                    "runs on the kvstore; call step()")
            if self._kvstore is None:
                return
            n = 0
            for i, p in enumerate(self._params):
                g = p.grad()
                if isinstance(g, NDArray):
                    self._kvstore.pushpull(i, g, out=g)
                    n += 1
            _telemetry.inc(_DISPATCHES, n, kind="allreduce",
                           path="per_key", help=_DISPATCH_HELP)

    # -- the guardrail ------------------------------------------------------

    def _live(self):
        return [p for p in self._params if p._data is not None]

    def _grads_nonfinite(self):
        """One fused non-finite sweep over every gradient, one host read."""
        flags = [~torch.isfinite(_grad_tensor(p.grad())).all()
                 for p in self._live()]
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
        inj = _fault.injector()
        if inj.active and inj.action("grad.nonfinite") is not None:
            live = self._live()
            if live:  # poison one gradient at a reproducible step
                g = live[0].grad()
                if isinstance(g, NDArray):
                    g._data = g._data * float("nan")
                else:
                    g.data._data = g.data._data * float("nan")
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
        if policy == "backoff":
            scaler = getattr(self, "_amp_scaler", None)
            if scaler is None:
                # no AMP in play: a unit scaler pinned at 1.0 (a huge
                # window forbids growth) gives later steps the overflow
                # check without rescaling unscaled losses
                from ..contrib import amp as _amp

                scaler = _amp.DynamicLossScaler(
                    init_scale=1.0, scale_window=10 ** 9, min_scale=1.0)
                self._amp_scaler = scaler
            scaler.update_scale(True)
        return True

    def _amp_pre_update(self, rescale):
        """(skip_step, effective_rescale) for loss-scaled gradients (ref:
        contrib/amp's loss-scaled step). Runs whenever a scaler is
        attached: even at loss_scale 1.0 the overflow check keeps
        non-finite gradients out of the weights."""
        scaler = getattr(self, "_amp_scaler", None)
        if scaler is None:
            return False, rescale
        # scale_loss records the scale it applied (a caller may override
        # it); else the live scale
        applied = getattr(self, "_amp_applied_scale", None)
        if applied is None:
            applied = scaler.loss_scale
        if scaler.has_overflow([p.grad() for p in self._live()]):
            scaler.update_scale(True)
            return True, rescale
        scaler.update_scale(False)
        return False, rescale / applied

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
                # the step boundary: where memory watermarks are sampled
                _telemetry.step_boundary()
                _telemetry.stepstats.step_end()

    def _step_impl(self, batch_size, ignore_stale_grad=False):
        inj = _fault.injector()
        if inj.active and inj.action("train.step") == "sigterm":
            # deterministic preemption: the drain handler only flags it,
            # the step completes and the loop's boundary poll bundles
            os.kill(os.getpid(), signal.SIGTERM)
        rescale = self._scale / batch_size
        self._optimizer.rescale_grad = rescale
        self._init_kvstore()
        if self._update_on_kvstore:
            self._step_on_kvstore(rescale)
            return
        if self._kvstore is not None:
            self.allreduce_grads()
        if self._sparse_service is not None:
            self._sparse_service.push_grads()
        if self._guardrail_check("local_update"):
            return
        skip, eff = self._amp_pre_update(rescale)
        if skip:
            return
        self._optimizer.rescale_grad = eff
        with _telemetry.stepstats.phase("optimizer_update"):
            self._update(ignore_stale_grad)

    def _step_on_kvstore(self, rescale):
        """Push the gradients and pull the weights the store updated."""
        if getattr(self, "_amp_scaler", None) is not None:
            # per-worker overflow skips and scales would feed the shared
            # server optimizer inconsistently: refuse
            raise NotImplementedError(
                "amp loss scaling is not supported with server-side "
                "updates (update_on_kvstore); train in allreduce mode "
                "or without a loss scaler")
        if rescale != self._kv_shipped_rescale:
            self._ship_optimizer_attrs(rescale_grad=rescale)
            self._kv_shipped_rescale = rescale
        if self._guardrail_check("server_push"):
            return
        kv = self._kvstore
        with _telemetry.stepstats.phase("pushpull"):
            if getattr(kv, "supports_hierarchical_pushpull", False) and \
                    not any(_sparse_typed(p) for p in self._params):
                kv.pushpull(list(range(len(self._params))),
                            [p.grad() for p in self._params],
                            out=[p.data() for p in self._params])
                _telemetry.inc(_DISPATCHES, 1, kind="server_pushpull",
                               path="hierarchical", help=_DISPATCH_HELP)
            else:
                for i, p in enumerate(self._params):
                    kv.push(i, p.grad())
                    kv.pull(i, out=p.data())
                _telemetry.inc(_DISPATCHES, len(self._params),
                               kind="server_pushpull", path="per_key",
                               help=_DISPATCH_HELP)
        if self._sparse_service is not None:
            self._sparse_service.push_grads()

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of `step` without the allreduce."""
        self._init_kvstore()
        if self._update_on_kvstore:
            raise ValueError("update() is not supported when the optimizer "
                             "runs on the kvstore; call step()")
        rescale = self._scale / batch_size
        self._optimizer.rescale_grad = rescale
        if self._guardrail_check("update"):
            return
        skip, eff = self._amp_pre_update(rescale)
        if skip:
            return
        self._optimizer.rescale_grad = eff
        with _telemetry.stepstats.phase("optimizer_update"):
            self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        if not ignore_stale_grad and self._aggregation_supported():
            self._update_aggregated()
            return
        n = 0
        for i, p in enumerate(self._params):
            if p._data is None:
                continue
            self._updater(i, p.grad(), p.data())
            n += 1
        _telemetry.inc(_DISPATCHES, n, kind="optimizer_update",
                       path="per_param", help=_DISPATCH_HELP)

    # -- the aggregated multi-tensor update ---------------------------------

    def _aggregation_supported(self):
        """A batched form of the optimizer's own that reproduces its eager
        update; a user's optimizer (only `update`) stays per parameter."""
        o = self._optimizer
        return (self._agg_bytes > 0
                and type(o).fused_updates is not opt.Optimizer.fused_updates
                and o.fused_matches_eager)

    def _bucket_signature(self):
        return tuple(None if p._data is None else
                     (p._data.dtype, tuple(p._data.shape),
                      _sparse_typed(p))
                     for p in self._params)

    def _build_update_buckets(self):
        """Greedy in-order grouping into dtype-homogeneous buckets of at
        most the byte cap (a parameter larger than the cap is a bucket of
        its own); sparse-typed parameters go to the per-parameter rest.
        Returns (buckets, rest)."""
        buckets, rest, cur, cur_bytes, cur_dt = [], [], [], 0, None
        for i, p in enumerate(self._params):
            if p._data is None:
                continue
            if _sparse_typed(p):
                rest.append(i)
                continue
            d = p._data
            nb = d.numel() * d.element_size()
            if cur and (d.dtype != cur_dt
                        or cur_bytes + nb > self._agg_bytes):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nb
            cur_dt = d.dtype
        if cur:
            buckets.append(cur)
        return buckets, rest

    def _update_aggregated(self):
        sig = self._bucket_signature()
        if sig != self._agg_sig:
            self._agg_buckets, self._agg_rest = self._build_update_buckets()
            self._agg_sig = sig
        per_param = list(self._agg_rest)
        for bucket in self._agg_buckets:
            if any(not isinstance(self._params[i].grad(), NDArray)
                   for i in bucket):
                # a dense-typed parameter with a sparse gradient: the lazy
                # update exists on the per-parameter path only
                per_param += bucket
                continue
            self._dispatch_bucket(bucket)
        for i in per_param:
            p = self._params[i]
            self._updater(i, p.grad(), p.data())
        if per_param:
            _telemetry.inc(_DISPATCHES, len(per_param),
                           kind="optimizer_update", path="per_param",
                           help=_DISPATCH_HELP)

    def _dispatch_bucket(self, bucket):
        """One batched update of a bucket: every count advances first (so
        each parameter of step n sees num_update n, as on the eager
        path), then `fused_updates` per distinct update count (one call
        when the bucket stepped together)."""
        o, u = self._optimizer, self._updater
        weights = [self._params[i].data() for i in bucket]
        new = [i for i in bucket if i not in u.states]
        states = [u.state(i, w) for i, w in zip(bucket, weights)]
        if new:
            _telemetry.ledger.track(
                [_state_data(u.states[i]) for i in new], "optimizer_state")
        for i in bucket:
            o._update_count(i)
        lr = torch.tensor(o._base_lr(), dtype=torch.float32)
        by_t = {}
        for k, i in enumerate(bucket):
            by_t.setdefault(o._index_update_count[i], []).append(k)
        for t, ks in by_t.items():
            o.fused_updates(
                [o.idx2name.get(bucket[k], bucket[k]) for k in ks],
                [weights[k]._data for k in ks],
                [self._params[bucket[k]].grad()._data for k in ks],
                [_state_data(states[k]) for k in ks], lr, t=t)
        _telemetry.inc(_DISPATCHES, 1, kind="optimizer_update",
                       path="aggregated", help=_DISPATCH_HELP)
        _telemetry.observe(
            _BUCKET_BYTES, sum(w._data.numel() * w._data.element_size()
                               for w in weights),
            help=_BUCKET_HELP, buckets=_telemetry.BYTES_BUCKETS,
            kind="optimizer_update")

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
