"""Gluon nn layers (`incubator_mxnet_tpu/gluon/nn/`): the ones ResNet
needs."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
