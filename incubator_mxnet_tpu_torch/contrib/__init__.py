"""Contrib modules (`incubator_mxnet_tpu/contrib/`): `text` (vocabularies
and token embeddings). The rest (quantization, amp, onnx, ...) is not
ported yet (ROADMAP Queue A 6)."""
from . import text  # noqa: F401
