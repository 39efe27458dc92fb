"""Contrib recurrent cells (`incubator_mxnet_tpu/gluon/contrib/rnn/`)."""
from .rnn_cell import VariationalDropoutCell, LSTMPCell  # noqa: F401
from .conv_rnn_cell import (  # noqa: F401
    Conv1DRNNCell, Conv2DRNNCell, Conv3DRNNCell,
    Conv1DLSTMCell, Conv2DLSTMCell, Conv3DLSTMCell,
    Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell,
)
