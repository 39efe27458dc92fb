"""Activation blocks (`incubator_mxnet_tpu/gluon/nn`): the one ResNet
needs."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """`F.Activation(x, act_type=activation)`; its name prefix is the
    activation's (`relu0_`), as in the reference."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation  # before super(): _alias() uses it
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)
