"""Gluon, the imperative front end (`incubator_mxnet_tpu/gluon/`), on
`torch.nn`: parameters, blocks, the nn layers, the losses, the Trainer,
the data API, the recurrent layers and cells (`rnn`), `contrib` and the
vision model zoo. Not ported yet: `SymbolBlock` / `export` (the symbolic
slice)."""
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .block import Block, HybridBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import data, loss, model_zoo, nn, rnn, utils  # noqa: F401
from . import contrib  # noqa: F401
