"""Gluon contrib (`incubator_mxnet_tpu/gluon/contrib/`): layers, recurrent
cells and the language-model datasets."""
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import data  # noqa: F401
