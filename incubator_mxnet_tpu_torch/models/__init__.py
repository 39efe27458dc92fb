"""Models of the port: the transformer LM, served and trained, and the
DLRM recommender (eager gluon)."""
from . import transformer  # noqa: F401
from .transformer import loss_fn, make_train_step  # noqa: F401
from . import dlrm  # noqa: F401
from .dlrm import DLRM  # noqa: F401

__all__ = ["transformer", "loss_fn", "make_train_step", "dlrm", "DLRM"]
