"""Contrib modules (`incubator_mxnet_tpu/contrib/`): `text` (vocabularies
and token embeddings) and `tensorboard` (the TensorBoard callbacks). The
rest (quantization, amp, onnx, ...) is not ported yet (ROADMAP Queue A
6)."""
from . import tensorboard  # noqa: F401
from . import text  # noqa: F401
