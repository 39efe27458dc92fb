"""`quantize_net`'s composite units in the port against the JAX
package's on the CPU: a squeezenet Fire net, an inception tower net
(with a fanned-out split) and a densenet-layer net, in both calibration
modes, held as `tests/test_torch_quantization.py` holds LeNet and the
ResNets (its `net_parity`; the two files split the JAX package's
per-shape compiles, each under 30 s)."""
import pytest
import torch

from test_torch_quantization import net_parity


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one intra-op thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("net_name", ["fire", "tower", "dense"])
def test_quantize_net_matches_jax(net_name, monkeypatch):
    net_parity(net_name, monkeypatch)
