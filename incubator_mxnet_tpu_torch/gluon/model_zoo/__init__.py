"""Gluon model zoo (`incubator_mxnet_tpu/gluon/model_zoo/`)."""
from . import vision  # noqa: F401
