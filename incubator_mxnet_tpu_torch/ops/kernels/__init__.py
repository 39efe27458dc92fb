"""Kernel wrappers, each beside its plain PyTorch version: the decode
attention kernels of the serving path (`decode`) and the trainable flash
attention of the train step (`flash`)."""
from .decode import (  # noqa: F401
    DECODE_BLOCK, dense_decode_attention, flash_decode, flash_decode_ref,
    paged_decode_attention, paged_decode_attention_ref,
    paged_decode_attention_wide, paged_decode_attention_wide_ref)
from .flash import (  # noqa: F401
    FLASH_HEAD_DIMS, flash_attention, flash_attention_bwd,
    flash_attention_bwd_ref, flash_attention_dkv, flash_attention_dkv_ref,
    flash_attention_dq, flash_attention_dq_ref, flash_attention_fwd,
    flash_attention_fwd_ref)

__all__ = ["DECODE_BLOCK", "dense_decode_attention", "flash_decode",
           "flash_decode_ref", "paged_decode_attention",
           "paged_decode_attention_ref", "paged_decode_attention_wide",
           "paged_decode_attention_wide_ref", "FLASH_HEAD_DIMS",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_dkv",
           "flash_attention_dkv_ref", "flash_attention_dq",
           "flash_attention_dq_ref", "flash_attention_fwd",
           "flash_attention_fwd_ref"]
