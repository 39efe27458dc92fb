"""`GluonTrainStep`: a gluon net, its loss and an optimizer as one train
step on one device (the single-device part of
`incubator_mxnet_tpu/fused.py:GluonTrainStep`).

A step runs the forward in training mode, takes `loss = mean(loss_fn(net,
x, y))` in at least float32, its gradients with `torch.autograd.grad`,
and the optimizer's fused update in place on every parameter whose
`grad_req` is not "null". BatchNorm running stats are updated once per
step by the forward itself (biased batch variance, `moving * momentum +
batch * (1 - momentum)`). The step returns the loss as a 0-d tensor on
the device, without a sync.

The first step resolves deferred parameter shapes with one forward in
predict mode under `torch.no_grad()`, so the BN running stats do not move
(the JAX package runs its warm pass in predict mode too); a net whose
shapes are all known skips it. There is nothing to compile: PyTorch runs
eagerly.

Not ported: `mesh`, `remat`, `remat_policy`, `shard_policy`,
`shard_optimizer_states`, `compute_dtype`, `init_on_device`,
`scan_steps` and `accum_steps` raise `NotImplementedError`.
"""
from __future__ import annotations

import torch

from .config import resolve_device

__all__ = ["GluonTrainStep"]


class GluonTrainStep:
    """step(x, y) -> loss (0-d float tensor on the device, async)."""

    def __init__(self, net, loss_fn, optimizer, device=None, *, mesh=None,
                 compute_dtype=None, init_on_device=False, remat=False,
                 remat_policy=None, shard_policy=None,
                 shard_optimizer_states=False):
        for name, value in (("mesh", mesh), ("compute_dtype", compute_dtype),
                            ("init_on_device", init_on_device),
                            ("remat", remat), ("remat_policy", remat_policy),
                            ("shard_policy", shard_policy),
                            ("shard_optimizer_states",
                             shard_optimizer_states)):
            if value:
                raise NotImplementedError(
                    f"GluonTrainStep({name}=...) is not ported: the port's "
                    f"step runs on one device, without remat or mixed "
                    f"precision")
        self.net = net
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.device = resolve_device(device)
        self._built = False
        self._n = 0

    def _build(self, x, y):
        params = self.net.collect_params()
        if any(p._data is None for p in params.values()):
            was = self.net.training
            self.net.train(False)
            try:
                with torch.no_grad():
                    self.loss_fn(self.net, x, y)
            finally:
                self.net.train(was)
        params = list(self.net.collect_params().items())
        missing = [n for n, p in params if p._data is None]
        if missing:
            raise RuntimeError(f"parameters still uninitialized after a "
                               f"forward: {missing[:5]}")
        self.names = [n for n, p in params if p.grad_req != "null"]
        self.weights = [p.data() for n, p in params if p.grad_req != "null"]
        self.states = [self.opt.create_state(i, w)
                       for i, w in enumerate(self.weights)]
        self._built = True

    def __call__(self, x, y):
        x = torch.as_tensor(x).to(self.device, non_blocking=True)
        y = torch.as_tensor(y).to(self.device, non_blocking=True)
        if not self._built:
            self._build(x, y)
        self._n += 1
        lr = (self.opt.lr_scheduler(self._n) if self.opt.lr_scheduler
              else self.opt.lr)
        was = self.net.training
        self.net.train(True)
        try:
            loss = self.loss_fn(self.net, x, y)
        finally:
            self.net.train(was)
        loss = loss.to(torch.promote_types(loss.dtype, torch.float32)).mean()
        grads = torch.autograd.grad(loss, self.weights)
        for name, w, g, s in zip(self.names, self.weights, grads,
                                 self.states):
            self.opt.fused_update(name, w, g, s, lr)
        return loss.detach()

    def scan_steps(self, xs, ys):
        raise NotImplementedError("GluonTrainStep.scan_steps is not ported")

    def accum_steps(self, xs, ys):
        raise NotImplementedError("GluonTrainStep.accum_steps is not ported")
