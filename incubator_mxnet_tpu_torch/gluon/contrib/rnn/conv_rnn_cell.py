"""Convolutional recurrent cells
(`incubator_mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py`): ConvRNN,
ConvLSTM and ConvGRU in 1, 2 and 3 spatial dimensions (Shi et al. 2015).

One base implements the nine cells: the gates' pre-activations are an
input and a state convolution, and the mode picks the recurrence. The
i2h padding is the caller's; the h2h kernel must be odd (same padding),
so the state keeps its spatial shape.
"""
from __future__ import annotations

from .... import initializer as init_mod
from ...rnn.rnn_cell import RecurrentCell

__all__ = [
    "Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
    "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
    "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
]

_GATES = {"rnn": 1, "lstm": 4, "gru": 3}


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvRNNCellBase(RecurrentCell):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 mode, dims, i2h_pad=0, activation="tanh", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_shape = tuple(input_shape)  # (C, *spatial)
        self._hc = hidden_channels
        self._dims = dims
        self._mode = mode
        self._act = activation
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError(
                f"h2h_kernel {self._h2h_kernel} must be odd so the hidden "
                f"state keeps its spatial shape")
        self._i2h_pad = _tup(i2h_pad, dims)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        # the spatial shape after the input convolution (stride 1)
        self._spatial = tuple(
            s + 2 * p - k + 1
            for s, k, p in zip(self._input_shape[1:], self._i2h_kernel,
                               self._i2h_pad))
        g = _GATES[mode]
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight",
                shape=(g * hidden_channels, self._input_shape[0])
                + self._i2h_kernel)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(g * hidden_channels, hidden_channels)
                + self._h2h_kernel)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(g * hidden_channels,),
                init=init_mod.Zero())
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(g * hidden_channels,),
                init=init_mod.Zero())

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hc) + self._spatial
        return [{"shape": shape}
                for _ in range(2 if self._mode == "lstm" else 1)]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        g = _GATES[self._mode] * self._hc
        act = getattr(F, self._act)
        h = states[0]
        pre_i = F.Convolution(inputs, i2h_weight, i2h_bias,
                              kernel=self._i2h_kernel, pad=self._i2h_pad,
                              num_filter=g)
        pre_h = F.Convolution(h, h2h_weight, h2h_bias,
                              kernel=self._h2h_kernel, pad=self._h2h_pad,
                              num_filter=g)
        if self._mode == "rnn":
            h_new = act(pre_i + pre_h)
            return h_new, [h_new]
        if self._mode == "lstm":
            i, f, gg, o = F.split(pre_i + pre_h, num_outputs=4, axis=1)
            c_new = F.sigmoid(f) * states[1] + F.sigmoid(i) * act(gg)
            h_new = F.sigmoid(o) * act(c_new)
            return h_new, [h_new, c_new]
        ir, iz, inew = F.split(pre_i, num_outputs=3, axis=1)
        hr, hz, hnew = F.split(pre_h, num_outputs=3, axis=1)
        r = F.sigmoid(ir + hr)
        z = F.sigmoid(iz + hz)
        n = act(inew + r * hnew)
        h_new = (1 - z) * n + z * h
        return h_new, [h_new]


def _make(mode, dims):
    kind = {"rnn": "RNN", "lstm": "LSTM", "gru": "GRU"}[mode]

    class Cell(_ConvRNNCellBase):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, activation="tanh", prefix=None,
                     params=None):
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, mode, dims, i2h_pad=i2h_pad,
                             activation=activation, prefix=prefix,
                             params=params)

    Cell.__name__ = f"Conv{dims}D{kind}Cell"
    Cell.__qualname__ = Cell.__name__
    Cell.__doc__ = f"{dims}-D Conv{kind} cell."
    return Cell


Conv1DRNNCell = _make("rnn", 1)
Conv2DRNNCell = _make("rnn", 2)
Conv3DRNNCell = _make("rnn", 3)
Conv1DLSTMCell = _make("lstm", 1)
Conv2DLSTMCell = _make("lstm", 2)
Conv3DLSTMCell = _make("lstm", 3)
Conv1DGRUCell = _make("gru", 1)
Conv2DGRUCell = _make("gru", 2)
Conv3DGRUCell = _make("gru", 3)
