"""Vision model zoo (`incubator_mxnet_tpu/gluon/model_zoo/vision/`): the
ResNets."""
from .resnet import *  # noqa: F401,F403
