"""Contrib modules (`incubator_mxnet_tpu/contrib/`): `text` (vocabularies
and token embeddings), `tensorboard` (the TensorBoard callbacks),
`control_flow` (`foreach`, `while_loop`, `cond`), `autograd` (the legacy
experimental API), `graph` (DGL sampling over CSR arrays), `svrg`
(`SVRGTrainer`), `amp` (mixed precision and the dynamic loss scaler) and
`quantization` (int8 calibration and `quantize_net`). The rest (onnx,
tensorrt, ...) is not ported yet (ROADMAP Queue A 6)."""
from . import amp  # noqa: F401
from . import autograd  # noqa: F401
from . import control_flow  # noqa: F401
from .control_flow import cond, foreach, while_loop  # noqa: F401
from . import graph  # noqa: F401
from . import quantization  # noqa: F401
from . import svrg  # noqa: F401
from . import tensorboard  # noqa: F401
from . import text  # noqa: F401
