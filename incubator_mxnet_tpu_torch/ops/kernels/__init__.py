"""Kernel wrappers, each beside its plain PyTorch version: the decode
attention kernels of the serving path (`decode`), the trainable flash
attention (`flash`) and fused softmax cross-entropy (`xent`) of the
transformer train step, and the fused BN -> ReLU (-> add) epilogue
(`epilogue`) of the ResNet train step."""
from .decode import (  # noqa: F401
    DECODE_BLOCK, dense_decode_attention, flash_decode, flash_decode_ref,
    paged_decode_attention, paged_decode_attention_ref,
    paged_decode_attention_wide, paged_decode_attention_wide_ref)
from .epilogue import (  # noqa: F401
    bn_act_epilogue, bn_act_epilogue_bwd, bn_act_epilogue_bwd_ref,
    bn_act_epilogue_fwd, bn_act_epilogue_fwd_ref)
from .flash import (  # noqa: F401
    FLASH_MAX_HEAD_DIM, flash_attention, flash_attention_bwd,
    flash_attention_bwd_ref, flash_attention_dkv, flash_attention_dkv_ref,
    flash_attention_dq, flash_attention_dq_ref, flash_attention_fwd,
    flash_attention_fwd_ref, padded_head_dim)
from .xent import (  # noqa: F401
    softmax_xent, softmax_xent_bwd, softmax_xent_bwd_ref, softmax_xent_fwd,
    softmax_xent_fwd_ref)

# every wrapper that counts its kernel's launches in `.launches` (a CUDA
# graph's capture hands its counts back and each replay adds them:
# `graphs.Site`)
COUNTED = (paged_decode_attention, paged_decode_attention_wide, flash_decode,
           flash_attention_fwd, flash_attention_dq, flash_attention_dkv,
           softmax_xent_fwd, softmax_xent_bwd, bn_act_epilogue_fwd,
           bn_act_epilogue_bwd)

__all__ = ["COUNTED", "bn_act_epilogue", "bn_act_epilogue_bwd",
           "bn_act_epilogue_bwd_ref", "bn_act_epilogue_fwd",
           "bn_act_epilogue_fwd_ref", "DECODE_BLOCK", "dense_decode_attention", "flash_decode",
           "flash_decode_ref", "paged_decode_attention",
           "paged_decode_attention_ref", "paged_decode_attention_wide",
           "paged_decode_attention_wide_ref", "FLASH_MAX_HEAD_DIM",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_dkv",
           "flash_attention_dkv_ref", "flash_attention_dq",
           "flash_attention_dq_ref", "flash_attention_fwd",
           "flash_attention_fwd_ref", "padded_head_dim", "softmax_xent",
           "softmax_xent_bwd",
           "softmax_xent_bwd_ref", "softmax_xent_fwd", "softmax_xent_fwd_ref"]
