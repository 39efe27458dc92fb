"""Operators: the registry and its tensor, nn, random, optimizer, vision,
contrib and quantized op families (`incubator_mxnet_tpu/ops/`), the
fused epilogue rewrite, and the hand-written CUDA kernels (`ops/kernels`,
`ops/csrc`)."""
from .registry import (OP_REGISTRY, OpDef, alias, get_op,  # noqa: F401
                       list_ops, register)
from . import tensor  # noqa: F401
from . import nn  # noqa: F401
from . import random  # noqa: F401
from . import optimizer  # noqa: F401
from . import vision  # noqa: F401
from . import contrib_ops  # noqa: F401
from . import quantized  # noqa: F401
