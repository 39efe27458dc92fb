"""Parallel building blocks of the port: so far the single-device
mixture-of-experts FFN (`moe`)."""
from . import moe  # noqa: F401
from .moe import moe_dispatch, moe_ffn  # noqa: F401

__all__ = ["moe", "moe_dispatch", "moe_ffn"]
