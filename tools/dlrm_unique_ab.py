#!/usr/bin/env python3
"""A DLRM step at the Criteo Kaggle widths (chip_smoke.py phase 4f (b):
local arm, 2.16 GB of tables on the card, batch 128, lazy SGD) with and
without the lazy update's duplicate fold for a recorded lookup's
gradient, in one process.

"skip" is the port as it is: the lookup's row-sparse gradient is marked
unique, so `optimizer._sparse_grad_prep` runs no `torch.unique` on it.
"fold" clears the mark, as the port did before it had one: one more
sort and host sync a table a step. Turns alternate fold, skip, skip,
fold, each from the same start weights over the same batches; the
arms' final weights must be bit-equal. Prints, per arm, the median host
ms and CUDA-event ms a step over every turn, and from one traced window
of 5 steps the kernel launches a step, the kernel ms and the busy share
(with the top kernels), beside the card's name and power limit.

    python3 tools/dlrm_unique_ab.py [--steps 20] [--turns 4]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch import autograd  # noqa: E402

WARM = 3  # steps of each turn left out of the medians


_SPARSE_GRADS = autograd._sparse_grads


def arm(name):
    """Make the lookups' row-sparse gradients marked unique ("skip") or
    not ("fold")."""
    def grads(taps, got):
        out = _SPARSE_GRADS(taps, got)
        for rsp in out.values():
            rsp.unique = name == "skip"
        return out
    autograd._sparse_grads = grads


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=cs.DLRM_STEPS)
    p.add_argument("--turns", type=int, default=4)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    gpu = cs.card()
    ctx = cs.tmx.gpu(0)
    batches = cs.dlrm_batches(cs.KAGGLE, args.steps)
    cs.tmx.random.seed(42)
    net, params = cs.dlrm_local(ctx, cs.tmx.init.Xavier(), batches[0])
    start = {n: p.data()._data.detach().clone() for n, p in params.items()}
    order = (["fold", "skip", "skip", "fold"] * args.turns)[:args.turns]
    times = {"fold": [], "skip": []}
    finals = {}
    for name in order:
        arm(name)
        with torch.no_grad():
            for n, p in params.items():
                p.data()._data.copy_(start[n])
        timed = []
        cs.dlrm_run(net, params, batches, ctx, timed=timed)
        times[name] += timed[WARM:]
        if name not in finals:
            finals[name] = {n: p.data()._data.detach().clone()
                            for n, p in params.items()}
    same = all(torch.equal(finals["fold"][n], finals["skip"][n])
               for n in params)
    loss_fn = cs.tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    for name in ("fold", "skip"):
        arm(name)
        trainer = cs.tmx.gluon.Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": cs.DLRM_LR})
        it = iter(batches * 2)
        stats = {}
        _, events = cs.busy_share(
            lambda: cs.dlrm_step(net, trainer, loss_fn, next(it), ctx)
            .asnumpy(), f"{name}: Kaggle DLRM step (local arm)", gpu,
            steps=5, kinds=True, stats=stats)
        launches = sum(n for e, n in events.items()
                       if not e.startswith(("Memcpy", "Memset")))
        host = float(np.median([t for t, _ in times[name]])) * 1e3
        dev = float(np.median([d for _, d in times[name]]))
        print(f"{name}: host {host:.3f} ms, CUDA events {dev:.3f} ms a step "
              f"(median of {len(times[name])} steps over "
              f"{order.count(name)} turns), {launches / 5:.0f} launches a "
              f"step, kernels {stats['busy'] * stats['wall_s'] / 5 * 1e3:.3f}"
              f" ms, busy {stats['busy']:.1%} (traced window) [{gpu}]",
              flush=True)
    print(f"final weights of the two arms bit-equal: {same} [{gpu}]")
    arm("skip")
    if not same:
        sys.exit(1)


if __name__ == "__main__":
    main()
