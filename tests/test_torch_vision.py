"""The port's vision and detection operators (`ops/vision.py`) against
the JAX package's.

One case per registry name and each extra mode (seeded inputs of
`tests/torch_op_cases.py`, NMS over 20-32 boxes) through `nd.<name>` of
both packages inside `autograd.record()`: values at rtol 1e-5, atol 1e-6
and the inputs' gradients under a seeded head gradient at rtol 1e-4,
atol 1e-5 (`tests/test_torch_ndarray.py`'s tolerances; ROIAlign and
DeformablePSROIPooling meet them too, tighter than their own JAX test's
1e-4 / 1e-5), the JAX cases compiled as one program. NMS's tie and chain
cases and the detection pass are in `tests/test_torch_detection.py`.
"""
import pytest
import torch

from torch_op_cases import DETERMINISTIC, EXTRA, FAMILY, _key
from test_torch_ndarray import _parity


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: on a loaded machine (the suite's other workers), torch's
    intra-op thread pool makes them many times slower than one thread
    does, and takes cores from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", [n for n in DETERMINISTIC
                                  if FAMILY[n] == "vision"])
def test_vision_op_matches_jax(name):
    _parity(_key(name), name, family="vision")


@pytest.mark.parametrize("k", [k for k, (n, _) in enumerate(EXTRA)
                               if FAMILY[n] == "vision"])
def test_vision_op_mode_matches_jax(k):
    _parity(f"extra:{k}", family="vision")
