"""Runtime feature detection (`incubator_mxnet_tpu/runtime.py`).

The feature names of the JAX package's list stay, with the port's
values: `TPU`, `XLA` and `PALLAS` are off. Beside them the port reports
`CUDA` (a card is visible), `CUDNN`, `NCCL` and `CUDA_KERNELS` (every
kernel source of `ops/csrc` has its library built for this checkout).
"""
from __future__ import annotations

import collections
import importlib.util

import torch

__all__ = ["Feature", "feature_list", "Features"]

Feature = collections.namedtuple("Feature", ["name", "enabled"])


def _kernels_built():
    from .ops import _build

    return all(_build._target(name)[1].exists() for name in _build.SOURCES)


def _detect():
    import torch.distributed as dist

    return {
        "TPU": False, "CPU": True, "XLA": False, "PALLAS": False,
        "CUDA": torch.cuda.is_available(),
        "CUDNN": torch.backends.cudnn.is_available(),
        "NCCL": dist.is_available() and dist.is_nccl_available(),
        "CUDA_KERNELS": _kernels_built(),
        "BF16": True, "F16C": True, "INT64_TENSOR_SIZE": True,
        "DIST_KVSTORE": True,
        "OPENCV": importlib.util.find_spec("cv2") is not None,
        "BLAS_OPEN": True, "SIGNAL_HANDLER": False, "PROFILER": True,
    }


def feature_list():
    return [Feature(k, v) for k, v in _detect().items()]


class Features(dict):
    def __init__(self):
        super().__init__({f.name: f for f in feature_list()})

    def is_enabled(self, name):
        return self[name].enabled
