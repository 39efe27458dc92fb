"""SVRG optimization (`incubator_mxnet_tpu/contrib/svrg.py`):
Stochastic Variance-Reduced Gradient (Johnson & Zhang 2013). Every
`update_freq` epochs the weights w~ are snapshot and the full-data
gradient mu = (1/N) sum_i grad_i(w~) computed; each step then applies
g_i(w) - g_i(w~) + mu.

A gluon `SVRGTrainer` over eager autograd: the snapshot gradient comes
from the net with w~ copied into its parameters for the pass, then the
current weights copied back (the parameters update in place)."""
from __future__ import annotations

import contextlib

import torch

from .. import autograd
from .. import optimizer as opt_mod
from ..ndarray.ndarray import NDArray

__all__ = ["SVRGTrainer"]


class SVRGTrainer:
    """Variance-reduced trainer. Per epoch::

        if epoch % trainer.update_freq == 0:
            trainer.update_full_grads(batches)   # snapshot w~, compute mu
        for x, y in batches:
            loss = trainer.step(x, y)
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 update_freq=2):
        self.net = net
        self.loss_fn = loss_fn
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self.optimizer = optimizer
        self.update_freq = int(update_freq)
        self._params = list(net.collect_params().items())
        self._states = {}
        self._snapshot = None  # name -> weights at w~
        self._mu = None        # name -> full-data gradient at w~

    def _batch_grads(self, x, y):
        """(loss, gradients of the batch loss) at the current weights."""
        for _, p in self._params:
            if p.grad_req != "null":
                p.zero_grad()
        with autograd.record():
            loss = self.loss_fn(self.net, x, y)
        loss.backward()
        return loss, {n: p.grad()._data.clone() for n, p in self._params
                      if p.grad_req != "null"}

    @contextlib.contextmanager
    def _with_params(self, values):
        """The net's parameters set to `values` (name -> tensor) for the
        block, restored after."""
        saved = {n: p.tensor().detach().clone() for n, p in self._params}
        try:
            with torch.no_grad():
                for n, p in self._params:
                    if n in values:
                        p.tensor().copy_(values[n])
            yield
        finally:
            with torch.no_grad():
                for n, p in self._params:
                    p.tensor().copy_(saved[n])

    def update_full_grads(self, batches):
        """Snapshot w~ := w and mu := the mean over `batches` of the batch
        gradients at w~."""
        self._snapshot = {n: p.tensor().detach().clone()
                          for n, p in self._params}
        acc, count = {}, 0
        for batch in batches:
            x, y = batch if isinstance(batch, (tuple, list)) else \
                (batch.data[0], batch.label[0])
            _, g = self._batch_grads(x, y)
            for n, v in g.items():
                acc[n] = v if n not in acc else acc[n] + v
            count += 1
        if count == 0:
            raise ValueError("update_full_grads: empty batch iterable")
        self._mu = {n: v / count for n, v in acc.items()}

    def step(self, x, y):
        """One variance-reduced update; returns the batch loss."""
        if self._snapshot is None:
            raise RuntimeError("call update_full_grads() before step() "
                               "(the SVRG schedule needs a snapshot)")
        loss, g_cur = self._batch_grads(x, y)
        with self._with_params(self._snapshot):
            _, g_snap = self._batch_grads(x, y)
        for i, (n, p) in enumerate(self._params):
            if p.grad_req == "null" or n not in g_cur:
                continue
            vr = g_cur[n] - g_snap[n] + self._mu[n]
            if n not in self._states:
                self._states[n] = self.optimizer.create_state(i, p.data())
            self.optimizer.update(i, p.data(), NDArray._from_data(vr),
                                  self._states[n])
        return loss
