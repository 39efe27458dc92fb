"""Gluon recurrent layers (`incubator_mxnet_tpu/gluon/rnn/rnn_layer.py`):
`RNN`, `LSTM` and `GRU` over the fused `RNN` op.

The parameters are stored per layer and direction under the JAX
package's names, `{l,r}{k}_{i2h,h2h}_{weight,bias}`, and packed into the
op's flat vector inside the forward (every weight, then every bias), so
that the packing is recorded with the ops and each parameter gets its
gradient; inside `fused.GluonTrainStep` the packed tensors are the step's
compute-dtype substitutes. The first layer's input size may be left 0
and is resolved from the first input (TNC or NTC).

Where the JAX package's `begin_state` makes zeros on the default context
(for the port that would be the card), the port's follow the input: the
states a forward makes for itself have the input's device and dtype,
and `begin_state()` makes them on the parameters' device in their dtype
unless `ctx` / `dtype` say otherwise.
"""
from __future__ import annotations

import torch

from ... import initializer as init_mod
from ...ndarray.ndarray import NDArray
from ...ops.nn import _GATES
from ..block import HybridBlock, training_mode
from ..parameter import _dtype

__all__ = ["RNN", "LSTM", "GRU", "begin_states"]


def begin_states(block, infos, func=None, ctx=None, dtype=None, **kwargs):
    """NDArrays of zeros for each state in `infos`, on `ctx` or the
    parameters' device, in `dtype` or the parameters' dtype; with `func`,
    `func(shape=..., ctx=..., dtype=..., **kwargs)` makes each."""
    from ...context import current_context, to_device

    if dtype is None:
        dtype = next((p.dtype for p in block.collect_params().values()),
                     "float32")
    if func is not None:
        if ctx is not None:
            kwargs["ctx"] = ctx
        return [func(shape=info["shape"], dtype=dtype, **kwargs)
                for info in infos]
    device = to_device(ctx) if ctx is not None else block._param_device()
    if device is None:
        device = current_context().torch_device()
    return [NDArray._from_data(torch.zeros(info["shape"], dtype=_dtype(dtype),
                                           device=device))
            for info in infos]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"layout must be TNC or NTC, got {layout!r}")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        self._gates = _GATES[mode]
        self._unfused_params = []
        ni = input_size
        with self.name_scope():
            for layer in range(num_layers):
                for d in (["l", "r"] if bidirectional else ["l"]):
                    self._register_layer_params(layer, d, ni)
                ni = hidden_size * self._dir

    def _register_layer_params(self, layer, d, input_size):
        ng, nh = self._gates, self._hidden_size
        for kind, shape in (("i2h_weight", (ng * nh, input_size)),
                            ("h2h_weight", (ng * nh, nh)),
                            ("i2h_bias", (ng * nh,)),
                            ("h2h_bias", (ng * nh,))):
            name = f"{d}{layer}_{kind}"
            p = self.params.get(
                name, shape=shape,
                init=init_mod.Zero() if kind.endswith("bias") else None,
                allow_deferred_init=True)
            setattr(self, name, p)
            self._unfused_params.append(name)

    def _pre_forward(self, inputs, *args):
        if self._input_size == 0:
            self._input_size = in_size = inputs.shape[2]
            for name in self._unfused_params:
                p = getattr(self, name)
                if name.endswith("i2h_weight") and not p._shape_known():
                    layer = int(name[1:].split("_")[0])
                    isz = (in_size if layer == 0
                           else self._hidden_size * self._dir)
                    p.shape = (self._gates * self._hidden_size, isz)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero initial states (NDArrays) for a batch of `batch_size`."""
        return begin_states(self, self.state_info(batch_size), func,
                            **kwargs)

    def _pack_params(self, params):
        """The op's flat parameter vector: every weight, then every bias,
        concatenated where the forward records."""
        ws = [params[n].reshape(-1) for n in self._unfused_params
              if n.endswith("weight")]
        bs = [params[n].reshape(-1) for n in self._unfused_params
              if n.endswith("bias")]
        return torch.cat(ws + bs)

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        batch_size = inputs.shape[1]
        skip_states = states is None
        if skip_states:
            states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for info in self.state_info(batch_size)]
        if torch.is_tensor(states):
            states = [states]
        out = F.RNN(inputs, self._pack_params(params), *states,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=not skip_states,
                    _training=training_mode(self))
        if skip_states:
            output, new_states = out, []
        else:
            output, new_states = out[0], list(out[1:])
        if self._layout == "NTC":
            output = F.swapaxes(output, dim1=0, dim2=1)
        if skip_states:
            return output
        return output, new_states

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"layers={self._num_layers}, "
                f"bidirectional={self._dir == 2})")


class RNN(_RNNLayer):
    """Elman RNN with a relu or tanh activation."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, mode, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]


class LSTM(_RNNLayer):
    """Long short-term memory; states [h, c]."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape}, {"shape": shape}]


class GRU(_RNNLayer):
    """Gated recurrent unit."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]
