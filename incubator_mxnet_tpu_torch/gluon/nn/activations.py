"""Activation blocks (`incubator_mxnet_tpu/gluon/nn/activations.py`):
`Activation`, the slope activations over the LeakyReLU op, `PReLU`
(a learned slope) and `Swish`."""
from __future__ import annotations

from ... import initializer as init_mod
from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish"]


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


def _slope_activation(name, act_type, default_slope, doc):
    """A HybridBlock over F.LeakyReLU(act_type=...)."""

    if default_slope is None:
        def __init__(self, **kwargs):
            HybridBlock.__init__(self, **kwargs)

        def hybrid_forward(self, F, x):
            return F.LeakyReLU(x, act_type=act_type)
    else:
        def __init__(self, alpha=default_slope, **kwargs):
            HybridBlock.__init__(self, **kwargs)
            self._alpha = alpha

        def hybrid_forward(self, F, x):
            return F.LeakyReLU(x, act_type=act_type, slope=self._alpha)

    return type(name, (HybridBlock,), {
        "__init__": __init__, "hybrid_forward": hybrid_forward,
        "__doc__": doc})


LeakyReLU = _slope_activation("LeakyReLU", "leaky", 0.01,
                              "max(x, alpha * x)")
ELU = _slope_activation("ELU", "elu", 1.0,
                        "x if x > 0 else alpha * (exp(x) - 1)")
SELU = _slope_activation("SELU", "selu", None, "scaled ELU")
GELU = _slope_activation("GELU", "gelu", None,
                         "Gaussian error linear unit (exact erf form)")


class PReLU(HybridBlock):
    """Leaky relu whose per-channel slope is learned."""

    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(in_channels,),
                init=alpha_initializer or init_mod.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class Swish(HybridBlock):
    """x * sigmoid(beta * x)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
