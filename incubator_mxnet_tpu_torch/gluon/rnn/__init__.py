"""Gluon recurrent layers and cells (`incubator_mxnet_tpu/gluon/rnn/`)."""
from .rnn_layer import RNN, LSTM, GRU  # noqa: F401
from .rnn_cell import (  # noqa: F401
    RecurrentCell, RNNCell, LSTMCell, GRUCell, SequentialRNNCell,
    DropoutCell, ModifierCell, ZoneoutCell, ResidualCell, BidirectionalCell,
)
