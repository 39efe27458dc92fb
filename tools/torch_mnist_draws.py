#!/usr/bin/env python3
"""Run examples/gluon_mnist.py's loop in the PyTorch port many times
(`chip_smoke.mnist_run`: 2 epochs at its defaults, batch 100, lr 0.1,
momentum 0.9) and print, for each run, its epoch accuracies and losses,
the first step whose loss is not finite, and the largest gap of its step
losses from the first run of the same setting.

    python3 tools/torch_mnist_draws.py [--repeats 20] [--seeds 10] [--cpu]

On the card it runs `--repeats` times at seed 0 with cuDNN's
non-deterministic algorithms allowed, as many times at seed 0 with them
barred, and once at each of seeds 1..`--seeds` with them barred: how often
the example's seeded run lands under tests/test_examples.py's bar (0.85),
and whether the deterministic runs repeat bit for bit. `--cpu` runs the
seeds on the CPU instead. Prints the card's name and power limit.
"""
import argparse
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import incubator_mxnet_tpu_torch as tmx  # noqa: E402

BAR = 0.85


def report(label, runs):
    first = runs[0]["steps"]
    under = 0
    for k, run in enumerate(runs):
        bad = next((i for i, v in enumerate(run["steps"])
                    if not math.isfinite(v)), None)
        a, b = np.array(run["steps"]), np.array(first)
        gap = float(np.max(np.where(np.isnan(a) & np.isnan(b), 0.0,
                                    np.abs(a - b))))
        under += not run["accs"][1] > BAR
        print(f"  {label} run {k}: epoch accuracies "
              f"{run['accs'][0]:.5f} {run['accs'][1]:.5f}, epoch losses "
              f"{run['losses'][0]:.6g} {run['losses'][1]:.6g}, first "
              f"non-finite step {bad}, largest step-loss gap from run 0 "
              f"{gap:.3e}")
    print(f"  {label}: {under} of {len(runs)} runs with epoch-1 accuracy "
          f"not above {BAR}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--seeds", type=int, default=10)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()
    if args.cpu:
        with tmx.cpu():
            report("cpu seeds", [cs.mnist_run(seed=s)
                                 for s in range(args.seeds + 1)])
        return 0
    if not torch.cuda.is_available():
        print("torch_mnist_draws: needs one CUDA card (or --cpu)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = cs.card()
    print(gpu)
    t0 = time.perf_counter()
    report("seed 0, cuDNN non-deterministic",
           [cs.mnist_run(deterministic=False) for _ in range(args.repeats)])
    report("seed 0, cuDNN deterministic",
           [cs.mnist_run(deterministic=True) for _ in range(args.repeats)])
    report("seeds 0.., cuDNN deterministic",
           [cs.mnist_run(deterministic=True, seed=s)
            for s in range(args.seeds + 1)])
    print(f"  {time.perf_counter() - t0:.1f} s [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
