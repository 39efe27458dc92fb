"""Contrib recurrent cells
(`incubator_mxnet_tpu/gluon/contrib/rnn/rnn_cell.py`)."""
from __future__ import annotations

import torch

from .... import initializer as init_mod
from .... import random as _random
from ...block import training_mode
from ...rnn.rnn_cell import ModifierCell, RecurrentCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Variational dropout around `base_cell`: one mask each for the
    inputs, the states and the outputs, drawn at the first step of an
    unroll and reused at every step; training mode only."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    @staticmethod
    def _mask_like(p, arr):
        """A float32 mask of `arr`'s shape: 1 / (1 - p) with probability
        1 - p, else 0, from the global random state."""
        keep = 1.0 - p
        gen = _random.next_generator(arr.device)
        u = torch.rand(arr.shape, generator=gen, device=arr.device)
        return (u < keep).to(torch.float32) / keep

    def hybrid_forward(self, F, inputs, states):
        if not training_mode(self):
            return self.base_cell(inputs, states)
        if self.drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._mask_like(self.drop_inputs, inputs)
            inputs = inputs * self._input_mask
        if self.drop_states:
            if self._state_masks is None:
                self._state_masks = [self._mask_like(self.drop_states, s)
                                     for s in states]
            states = [s * m for s, m in zip(states, self._state_masks)]
        out, nstates = self.base_cell(inputs, states)
        if self.drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._mask_like(self.drop_outputs, out)
            out = out * self._output_mask
        return out, nstates


class LSTMPCell(RecurrentCell):
    """LSTM with a projection of the hidden state (LSTMP, Sak et al.
    2014): states [r, c], r = (o * tanh(c)) W_h2r^T of `projection_size`
    columns."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, projection_size))
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size))
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,), init=init_mod.Zero())
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,), init=init_mod.Zero())

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def _pre_forward(self, x, states):
        if not self.i2h_weight._shape_known():
            self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        r, c = states
        n = 4 * self._hidden_size
        gates = (F.FullyConnected(inputs, i2h_weight, i2h_bias,
                                  num_hidden=n)
                 + F.FullyConnected(r, h2h_weight, h2h_bias, num_hidden=n))
        i, f, g, o = F.SliceChannel(gates, num_outputs=4, axis=1)
        i = F.Activation(i, act_type="sigmoid")
        f = F.Activation(f, act_type="sigmoid")
        g = F.Activation(g, act_type="tanh")
        o = F.Activation(o, act_type="sigmoid")
        c_next = f * c + i * g
        h = o * F.Activation(c_next, act_type="tanh")
        r_next = F.FullyConnected(h, h2r_weight, None,
                                  num_hidden=self._projection_size,
                                  no_bias=True)
        return r_next, [r_next, c_next]
