"""Kernel wrappers, each beside its plain PyTorch version."""
from .decode import (  # noqa: F401
    DECODE_BLOCK, dense_decode_attention, flash_decode, flash_decode_ref,
    paged_decode_attention, paged_decode_attention_ref,
    paged_decode_attention_wide, paged_decode_attention_wide_ref)

__all__ = ["DECODE_BLOCK", "dense_decode_attention", "flash_decode",
           "flash_decode_ref", "paged_decode_attention",
           "paged_decode_attention_ref", "paged_decode_attention_wide",
           "paged_decode_attention_wide_ref"]
