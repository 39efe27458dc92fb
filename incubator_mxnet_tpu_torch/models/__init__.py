"""Models of the port."""
from . import transformer  # noqa: F401

__all__ = ["transformer"]
