"""Gluon, the imperative front end (`incubator_mxnet_tpu/gluon/`), on
`torch.nn`: the blocks, layers, loss and model zoo that ResNet training
needs. Not ported yet: `Trainer`, `autograd.record` and the other layers,
losses and models."""
from .parameter import (DeferredInitializationError, Parameter,  # noqa: F401
                        ParameterDict)
from .block import Block, HybridBlock  # noqa: F401
from . import loss, model_zoo, nn, utils  # noqa: F401
