"""Models of the port: the transformer LM, served and trained."""
from . import transformer  # noqa: F401
from .transformer import loss_fn, make_train_step  # noqa: F401

__all__ = ["transformer", "loss_fn", "make_train_step"]
