#!/usr/bin/env python3
"""Run examples/gluon_mnist.py's loop in the JAX package on the CPU at
seeds 0..N (`mx.random.seed` and `np.random.seed`; the example itself
fixes 0) and print each draw's epoch losses and accuracies, and how many
land epoch-1 accuracy under tests/test_examples.py's bar (0.85): the
reference's rate, beside what tools/torch_mnist_draws.py prints for the
PyTorch port.

    JAX_PLATFORMS=cpu python3 tools/mnist_reference_draws.py [--seeds 30]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import autograd, gluon  # noqa: E402
from incubator_mxnet_tpu.gluon import nn  # noqa: E402

BAR = 0.85


def draw(seed):
    mx.random.seed(seed)
    np.random.seed(seed)
    rng = np.random.RandomState(0)
    proto = rng.rand(10, 1, 28, 28).astype("float32")
    y = rng.randint(0, 10, 4000)
    X = proto[y] + 0.1 * rng.randn(4000, 1, 28, 28).astype("float32")
    loader = gluon.data.DataLoader(
        gluon.data.ArrayDataset(X, y.astype("float32")), batch_size=100,
        shuffle=True)
    net = nn.HybridSequential()
    net.add(nn.Conv2D(20, 5, activation="relu"), nn.MaxPool2D(2, 2),
            nn.Conv2D(50, 5, activation="relu"), nn.MaxPool2D(2, 2),
            nn.Flatten(), nn.Dense(500, activation="relu"), nn.Dense(10))
    net.initialize(mx.init.Xavier())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses, accs = [], []
    for _ in range(2):
        total, correct, cum_loss = 0, 0, 0.0
        for data, label in loader:
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(data.shape[0])
            cum_loss += float(loss.mean().asscalar()) * data.shape[0]
            correct += int((out.asnumpy().argmax(1)
                            == label.asnumpy()).sum())
            total += data.shape[0]
        losses.append(cum_loss / total)
        accs.append(correct / total)
    return losses, accs


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=30)
    args = p.parse_args()
    under = 0
    for seed in range(args.seeds + 1):
        losses, accs = draw(seed)
        under += not accs[1] > BAR
        print(f"  reference seed {seed}: epoch losses {losses[0]:.6g} "
              f"{losses[1]:.6g}, accuracies {accs[0]:.5f} {accs[1]:.5f}",
              flush=True)
    print(f"  reference (JAX package, CPU): {under} of {args.seeds + 1} "
          f"draws with epoch-1 accuracy not above {BAR}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
