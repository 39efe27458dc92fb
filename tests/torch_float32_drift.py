"""How far float32 ResNet training drifts, on the CPU: the measurements
behind the tolerances of `tests/test_torch_resnet.py` and of
`chip_smoke.py`'s ResNet-50 legs. Not collected by pytest; run it as

    JAX_PLATFORMS=cpu python tests/torch_float32_drift.py

1. The thin test net of `tests/test_torch_resnet.py` (same weights, data
   and SGD), 3 chained GluonTrainStep steps in each package, knob off and
   on: the relative loss gap per step between the port and JAX, and
   between JAX's own knob-off and knob-on runs.
2. ResNet-50 v1 as `chip_smoke.py` builds it (seeded Xavier,
   RandomState(0) images), at batch 4 and 128 x 128: the relative 2-norm
   distance of the step-1 gradient (all trained parameters) from the
   float64 gradient of the port's unfused path, for the port unfused, the
   port fused and the JAX package (unfused, the same weights), and the
   largest difference on the stem's weight relative to its largest
   entry.
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import gluon, nd  # noqa: E402
from incubator_mxnet_tpu.fused import GluonTrainStep  # noqa: E402
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision  # noqa: E402
from incubator_mxnet_tpu.gluon.parameter import abstract_init_mode  # noqa: E402
from incubator_mxnet_tpu.ndarray.ndarray import NDArray  # noqa: E402

import chip_smoke  # noqa: E402
import incubator_mxnet_tpu_torch as tmx  # noqa: E402
import test_torch_resnet as thin  # noqa: E402

KNOB = "MXTPU_FUSED_EPILOGUE"


def chained_losses():
    x, y = thin._data()
    jax_losses, port_losses = {}, {}
    for knob in ("0", "1"):
        os.environ[KNOB] = knob
        jnet = thin._jax_net(x)
        net = thin._port_net(thin._values(jnet))
        jloss = gluon.loss.SoftmaxCrossEntropyLoss()
        jstep = GluonTrainStep(jnet, lambda n, a, b: jloss(n(a), b),
                               mx.optimizer.SGD(**thin.SGD))
        ploss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        pstep = tmx.fused.GluonTrainStep(
            net, lambda n, a, b: ploss(n(a), b),
            tmx.optimizer.SGD(**thin.SGD), device="cpu")
        jax_losses[knob] = [float(jstep(nd.array(x), nd.array(y)).asnumpy())
                            for _ in range(thin.STEPS)]
        port_losses[knob] = [float(pstep(torch.from_numpy(x),
                                         torch.from_numpy(y)))
                             for _ in range(thin.STEPS)]

    def gaps(a, b):
        return ", ".join(f"{abs(p - q) / abs(q):.2e}" for p, q in zip(a, b))

    for knob in ("0", "1"):
        print(f"thin net, knob {knob}: port vs JAX loss gap per step "
              f"{gaps(port_losses[knob], jax_losses[knob])}")
    print(f"thin net, JAX knob on vs off: {gaps(jax_losses['1'], jax_losses['0'])}")


def jax_grads(net, x, y):
    """The JAX package's float32 step-1 gradient at `net`'s weights, read
    from one SGD step with lr 1, no momentum, no decay."""
    os.environ[KNOB] = "0"
    jnet = jvision.resnet50_v1(classes=chip_smoke.RESNET["classes"],
                               layout="NHWC")
    jnet.initialize(mx.init.Xavier())
    with abstract_init_mode():
        jax.eval_shape(lambda d: jnet(NDArray._from_data(d))._data,
                       jax.ShapeDtypeStruct(tuple(x.shape), np.float32))
    ours = {n[len(net.prefix):]: p for n, p in net.collect_params().items()}
    params = jnet.collect_params()
    for name, p in params.items():
        p.set_data(nd.array(ours[name[len(jnet.prefix):]].data().detach()
                            .numpy()))
    before = {n: np.array(p.data()._data) for n, p in params.items()}
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    step = GluonTrainStep(jnet, lambda n, a, b: loss(n(a), b),
                          mx.optimizer.SGD(learning_rate=1.0))
    step(nd.array(x.numpy()), nd.array(y.numpy())).asnumpy()
    step.sync_params()
    return {n[len(jnet.prefix):]: torch.from_numpy(
        before[n] - np.array(p.data()._data))
        for n, p in params.items() if p.grad_req != "null"}


def gradient_distances():
    chip_smoke.RESNET.update(batch=4, image=128)
    cpu = torch.device("cpu")
    batch = chip_smoke.resnet_batch(cpu)
    exact = chip_smoke.exact_grads(batch, cpu)
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in exact.values()))
    legs = {}
    for leg, knob in (("port unfused", "0"), ("port fused", "1")):
        os.environ[KNOB] = knob
        net = chip_smoke.resnet50(batch[0], cpu)
        legs[leg] = chip_smoke.resnet_grads(net, *batch)
    legs["JAX unfused"] = jax_grads(net, *batch)
    stem = "conv2d0_weight"
    for leg, grads in legs.items():
        d = chip_smoke.grad_distance(grads, exact)
        s = float((grads[stem].double() - exact[stem]).abs().max()
                  / exact[stem].abs().max())
        print(f"ResNet-50 batch 4, 128x128, {leg}: relative 2-norm distance "
              f"from float64 {d / norm:.3e}; stem weight, largest "
              f"difference / largest entry {s:.3e}")


if __name__ == "__main__":
    chained_losses()
    gradient_distances()
    os.environ.pop(KNOB, None)
