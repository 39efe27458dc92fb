"""Gluon, the imperative front end (`incubator_mxnet_tpu/gluon/`), on
`torch.nn`: parameters, blocks, the nn layers, the losses, the Trainer,
the data API and the model zoo's ResNets. Not ported yet: `gluon.rnn`,
the other model-zoo nets, `SymbolBlock` / `export` and `CTCLoss`."""
from .parameter import (DeferredInitializationError, Parameter,  # noqa: F401
                        ParameterDict)
from .block import Block, HybridBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import data, loss, model_zoo, nn, utils  # noqa: F401
