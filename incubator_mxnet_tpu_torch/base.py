"""dtype names shared by the NDArray, the operators and their files:
MXNet's numpy-style names (`"float32"`, `np.float32`, ...) and their
`torch.dtype`s. numpy has no bfloat16: an NDArray's `dtype` reports
bfloat16 data as the string "bfloat16"."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dtype_torch", "dtype_np", "dtype_name"]

_TORCH = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAME = {v: k for k, v in _TORCH.items()}


def dtype_torch(dtype):
    """The torch dtype of a name, numpy dtype or torch dtype (None:
    float32)."""
    if dtype is None or dtype == "None":
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return _TORCH[dtype]
    return _TORCH[np.dtype(dtype).name]


def dtype_name(dtype):
    """The MXNet name of a torch dtype."""
    return _NAME[dtype]


def dtype_np(dtype):
    """The numpy dtype of a torch dtype (bfloat16: the name, numpy has
    none)."""
    name = _NAME[dtype_torch(dtype)]
    return name if name == "bfloat16" else np.dtype(name)
