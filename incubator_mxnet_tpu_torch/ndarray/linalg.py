"""The `nd.linalg` namespace (`incubator_mxnet_tpu/ndarray/linalg.py`):
the `_linalg_*` registry ops under their short names."""
from __future__ import annotations

from ..ops.registry import OP_REGISTRY
from . import register as _register


def _fn(name):
    def f(*args, **kwargs):
        return _register.invoke(OP_REGISTRY[name], args, kwargs)

    f.__name__ = name.replace("_linalg_", "")
    return f


gemm = _fn("_linalg_gemm")
gemm2 = _fn("_linalg_gemm2")
potrf = _fn("_linalg_potrf")
potri = _fn("_linalg_potri")
trsm = _fn("_linalg_trsm")
trmm = _fn("_linalg_trmm")
syrk = _fn("_linalg_syrk")
sumlogdiag = _fn("_linalg_sumlogdiag")
extractdiag = _fn("_linalg_extractdiag")
makediag = _fn("_linalg_makediag")
