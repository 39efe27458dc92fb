"""Gluon recurrent cells (`incubator_mxnet_tpu/gluon/rnn/rnn_cell.py`).

A cell maps (input, states) to (output, new states) for one step;
`unroll` steps it over a sequence (layouts NTC and TNC, outputs as a
list or merged, `valid_length` masking as SequenceMask + SequenceLast).
Cells are `HybridBlock`s over tensors: called with NDArrays (states a
list of NDArrays) they answer NDArrays, and `unroll` takes and returns
the kind it is given. The states a cell makes for itself follow the
input's device and dtype (see `rnn_layer`).
"""
from __future__ import annotations

import torch

from ... import initializer as init_mod
from ...ndarray.ndarray import NDArray
from ..block import HybridBlock, imperative_call, training_mode
from .rnn_layer import begin_states

__all__ = [
    "RecurrentCell", "RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
    "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
    "BidirectionalCell",
]


def _has_ndarray(tree):
    if isinstance(tree, NDArray):
        return True
    if isinstance(tree, (list, tuple)):
        return any(_has_ndarray(t) for t in tree)
    return False


def _steps(length, inputs, layout):
    """A sequence tensor split along its time axis into `length` steps (a
    list of steps is returned as it is)."""
    if isinstance(inputs, (list, tuple)):
        return list(inputs)
    axis = layout.find("T")
    if inputs.shape[axis] != length:
        raise ValueError(f"inputs have {inputs.shape[axis]} steps along "
                         f"{layout}'s T axis, not {length}")
    return list(torch.unbind(inputs, axis))


class RecurrentCell(HybridBlock):
    """Base of the cells: states, `begin_state` and `unroll`."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.reset()

    def reset(self):
        """Reset the step counters (and the children's) before a new
        sequence."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._modules.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (NDArrays of zeros) for a batch of
        `batch_size`."""
        infos = self.state_info(batch_size)
        self._init_counter += len(infos)
        return begin_states(self, infos, func, **kwargs)

    def _zero_states(self, x):
        """Zero initial states on `x`'s device, in its dtype."""
        return [torch.zeros(info["shape"], dtype=x.dtype, device=x.device)
                for info in self.state_info(x.shape[0])]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell over `length` steps of `inputs` (a tensor in
        `layout` or a list of steps). Returns (outputs, states): outputs
        a list of steps, or one tensor stacked along T with
        `merge_outputs`. With `valid_length` (B,), outputs past each
        sequence's length are zeros and each state is the sequence's
        state after its last valid step."""
        if _has_ndarray((inputs, begin_state, valid_length)):
            return imperative_call(self, self._unroll, length, inputs,
                                   begin_state, layout, merge_outputs,
                                   valid_length)
        return self._unroll(length, inputs, begin_state, layout,
                            merge_outputs, valid_length)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        self.reset()
        inputs = _steps(length, inputs, layout)
        states = (list(begin_state) if begin_state is not None
                  else self._zero_states(inputs[0]))
        begin = states
        outputs, step_states = [], []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                step_states.append(states)
        if valid_length is not None:
            outputs, states = _mask_valid(outputs, begin, step_states,
                                          valid_length, length)
        if merge_outputs:
            outputs = torch.stack(outputs, layout.find("T"))
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


def _valid_tensor(valid_length, like):
    return torch.as_tensor(valid_length, device=like.device)


def _mask_valid(outputs, begin, step_states, valid_length, length):
    """Outputs zeroed past each sequence's length, and each state the
    sequence's state after its last valid step (one-hot over the begin
    state and the T step states: a length of 0 keeps the begin state)."""
    vl = _valid_tensor(valid_length, outputs[0])
    masked = []
    for i, out in enumerate(outputs):
        alive = (vl > float(i)).to(out.dtype)
        masked.append(out * alive.reshape((-1,) + (1,) * (out.dim() - 1)))
    sel = torch.nn.functional.one_hot(vl.to(torch.int64), length + 1)
    final = []
    for k in range(len(begin)):
        stacked = torch.stack([begin[k]] + [s[k] for s in step_states])
        w = sel.t().reshape((length + 1, -1) + (1,) * (begin[k].dim() - 1))
        final.append(torch.sum(stacked * w.to(stacked.dtype), 0))
    return masked, final


class _GateCell(RecurrentCell):
    """A cell with i2h and h2h weights and biases of `gates` x hidden
    rows; the input size may be left 0 (resolved at the first step)."""

    _gates = 1

    def __init__(self, hidden_size, input_size=0, prefix=None, params=None,
                 i2h_weight_initializer=None, h2h_weight_initializer=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        g = self._gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g, input_size),
                allow_deferred_init=True, init=i2h_weight_initializer)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g, hidden_size),
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get("i2h_bias", shape=(g,),
                                            init=init_mod.Zero())
            self.h2h_bias = self.params.get("h2h_bias", shape=(g,),
                                            init=init_mod.Zero())

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def _pre_forward(self, x, states):
        if not self.i2h_weight._shape_known():
            self.i2h_weight.shape = (self._gates * self._hidden_size,
                                     x.shape[-1])

    def _projections(self, F, inputs, h, p):
        n = self._gates * self._hidden_size
        return (F.FullyConnected(inputs, p["i2h_weight"], p["i2h_bias"],
                                 num_hidden=n),
                F.FullyConnected(h, p["h2h_weight"], p["h2h_bias"],
                                 num_hidden=n))


class RNNCell(_GateCell):
    """h' = act(x W_i2h^T + b_i2h + h W_h2h^T + b_h2h)."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 prefix=None, params=None, i2h_weight_initializer=None,
                 h2h_weight_initializer=None):
        super().__init__(hidden_size, input_size, prefix, params,
                         i2h_weight_initializer, h2h_weight_initializer)
        self._activation = activation

    def hybrid_forward(self, F, inputs, states, **p):
        i2h, h2h = self._projections(F, inputs, states[0], p)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GateCell):
    """LSTM step, gates [i, f, g, o]; states [h, c]."""

    _gates = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def hybrid_forward(self, F, inputs, states, **p):
        h, c = states
        i2h, h2h = self._projections(F, inputs, h, p)
        i, f, g, o = F.split(i2h + h2h, num_outputs=4, axis=-1)
        c_new = F.sigmoid(f) * c + F.sigmoid(i) * F.tanh(g)
        h_new = F.sigmoid(o) * F.tanh(c_new)
        return h_new, [h_new, c_new]


class GRUCell(_GateCell):
    """GRU step, gates [r, z, n], n = tanh(nx + r * nh)."""

    _gates = 3

    def hybrid_forward(self, F, inputs, states, **p):
        h = states[0]
        gx, gh = self._projections(F, inputs, h, p)
        rx, zx, nx = F.split(gx, num_outputs=3, axis=-1)
        rh, zh, nh = F.split(gh, num_outputs=3, axis=-1)
        r = F.sigmoid(rx + rh)
        z = F.sigmoid(zx + zh)
        n = F.tanh(nx + r * nh)
        h_new = (1 - z) * n + z * h
        return h_new, [h_new]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, the states of all of
    them concatenated."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._modules.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def begin_state(self, batch_size=0, **kwargs):
        states = []
        for cell in self._modules.values():
            states.extend(cell.begin_state(batch_size, **kwargs))
        return states

    def hybrid_forward(self, F, inputs, states):
        next_states, p = [], 0
        for cell in self._modules.values():
            n = len(cell.state_info())
            inputs, new = cell(inputs, states[p:p + n])
            next_states.extend(new)
            p += n
        return inputs, next_states

    def __len__(self):
        return len(self._modules)


class DropoutCell(RecurrentCell):
    """Dropout on the input (training mode only); no states."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes,
                               _training=training_mode(self))
        return inputs, states


class ModifierCell(RecurrentCell):
    """A cell wrapping `base_cell` (prefix `<base prefix>mod_`) with its
    states."""

    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix + "mod_", params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)


class ZoneoutCell(ModifierCell):
    """Zoneout: in training mode each output (state) element keeps its
    previous value with probability `zoneout_outputs`
    (`zoneout_states`)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if training_mode(self):
            def mask(p, new, old):
                m = F.Dropout(torch.ones_like(new), p=p, mode="always")
                return torch.where(m > 0, new, old)

            prev = (self._prev_output if self._prev_output is not None
                    else torch.zeros_like(next_output))
            output = (mask(self.zoneout_outputs, next_output, prev)
                      if self.zoneout_outputs > 0 else next_output)
            if self.zoneout_states > 0:
                next_states = [mask(self.zoneout_states, ns, s)
                               for ns, s in zip(next_states, states)]
        else:
            output = next_output
        self._prev_output = output
        return output, next_states


class ResidualCell(ModifierCell):
    """output = base output + input."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """Two cells over the sequence, the second reversed; outputs
    concatenated. `unroll()` only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return (self._modules["l_cell"].state_info(batch_size)
                + self._modules["r_cell"].state_info(batch_size))

    def begin_state(self, batch_size=0, **kwargs):
        return (self._modules["l_cell"].begin_state(batch_size, **kwargs)
                + self._modules["r_cell"].begin_state(batch_size, **kwargs))

    def __call__(self, inputs, states):
        raise NotImplementedError("BidirectionalCell supports unroll() only")

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        from ...ops.tensor import sequence_reverse

        inputs = _steps(length, inputs, layout)
        l_cell, r_cell = self._modules["l_cell"], self._modules["r_cell"]
        begin = (list(begin_state) if begin_state
                 else self._zero_states(inputs[0]))
        nl = len(l_cell.state_info())
        if valid_length is None:
            l_out, l_states = l_cell._unroll(length, inputs, begin[:nl],
                                             "NTC", None, None)
            r_out, r_states = r_cell._unroll(length, inputs[::-1],
                                             begin[nl:], "NTC", None, None)
            r_out = r_out[::-1]
        else:
            # the reverse direction sees each sequence's valid prefix
            # reversed, not its padding first
            vl = _valid_tensor(valid_length, inputs[0])
            rev = sequence_reverse(torch.stack(inputs), vl,
                                   use_sequence_length=True)
            l_out, l_states = l_cell._unroll(length, inputs, begin[:nl],
                                             "NTC", None, vl)
            r_out, r_states = r_cell._unroll(length, list(rev), begin[nl:],
                                             "NTC", None, vl)
            r_out = list(sequence_reverse(torch.stack(r_out), vl,
                                          use_sequence_length=True))
        outputs = [torch.cat([lo, ro], -1) for lo, ro in zip(l_out, r_out)]
        if merge_outputs:
            outputs = torch.stack(outputs, layout.find("T"))
        return outputs, l_states + r_states
