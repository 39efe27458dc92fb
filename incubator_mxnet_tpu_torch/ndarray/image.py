"""The `nd.image` namespace (`incubator_mxnet_tpu/ndarray/image.py`): the
`_image_*` registry ops under friendly names."""
from __future__ import annotations

from ..ops.registry import OP_REGISTRY
from . import register as _register

__all__ = ["to_tensor", "normalize", "resize"]


def to_tensor(data):
    """HWC / NHWC [0, 255] -> CHW / NCHW float32 [0, 1]."""
    return _register.invoke(OP_REGISTRY["_image_to_tensor"], (data,), {})


def normalize(data, mean=(0.0,), std=(1.0,)):
    """(x - mean) / std per channel; a scalar or a sequence each."""
    mean = tuple(mean) if hasattr(mean, "__len__") else (float(mean),)
    std = tuple(std) if hasattr(std, "__len__") else (float(std),)
    return _register.invoke(OP_REGISTRY["_image_normalize"], (data,),
                            dict(mean=mean, std=std))


def resize(data, size, keep_ratio=False, interp=1):
    return _register.invoke(
        OP_REGISTRY["_image_resize"], (data,),
        dict(size=size, keep_ratio=keep_ratio, interp=interp))
