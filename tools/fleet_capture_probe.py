#!/usr/bin/env python3
"""Probe the port's CUDA-graph captures beside a serving fleet, on one card.

    python3 tools/fleet_capture_probe.py [--rolls N] [--no-pause]

Runs `chip_smoke.py`'s rolling fleet leg (full width, every lever on,
under MXTPU_SANITIZERS=locks,pages) N times in one process, each leg's
engines left to the collector, and prints per leg the longest and the
99th-percentile hold of every sanitized lock and whether the leg held its
gates. Then `chip_smoke.warm_without_collections`: an engine's warm()
with the collector run at every allocation, counting collections inside
captures.
Last, after one more leg, warms an engine whose first capture runs
`gc.collect()` inside the capture, and prints whether the capture held.

`--no-pause` makes `graphs._no_collection` a no-op for the run: the
captures then run with the collector on, as before the pause existed.
Needs the card; builds the kernels like `chip_smoke.py`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch import graphs  # noqa: E402
from incubator_mxnet_tpu_torch.analysis import sanitizers  # noqa: E402
from incubator_mxnet_tpu_torch.models import transformer as tfm  # noqa: E402
from incubator_mxnet_tpu_torch.ops import _build  # noqa: E402
from incubator_mxnet_tpu_torch.serving import make_trace  # noqa: E402

HOLDS: dict = {}
_release = sanitizers._after_release


def _timed_release(name):
    for held_name, t0, _site in reversed(sanitizers._held()):
        if held_name == name:
            HOLDS.setdefault(name, []).append(
                1e3 * (time.monotonic() - t0))
            break
    return _release(name)


def _holds_line():
    parts = []
    for name in ("graphs.capture", "serving.engine", "serving.replica"):
        ms = sorted(HOLDS.get(name, [0.0]))
        parts.append(f"{name} max {ms[-1]:.1f} p99 "
                     f"{ms[int(0.99 * (len(ms) - 1))]:.1f} ms "
                     f"(n {len(ms)})")
    HOLDS.clear()
    return "; ".join(parts)


def collect_in_capture(cfg, params, device):
    """warm() an engine whose first capture runs gc.collect() inside it."""
    eng = cs.ServingEngine(params, cfg, slots=cs.SLOTS, page_size=cs.PAGE,
                           device=device)
    site, fn = eng._decode, eng._decode.fn
    collected = []

    def collecting(*args):
        if torch.cuda.is_current_stream_capturing() and not collected:
            collected.append(gc.collect())
        return fn(*args)

    site.fn = collecting
    try:
        eng.warm()
        return f"held (collected {collected[0]} objects inside it)"
    except RuntimeError as e:
        return f"failed ({str(e)[:160]})"
    finally:
        site.fn = fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rolls", type=int, default=10)
    ap.add_argument("--no-pause", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fleet_capture_probe: needs a CUDA device")
    if args.no_pause:
        graphs._no_collection = contextlib.nullcontext
    sanitizers._after_release = _timed_release
    print(cs.card(), flush=True)
    _build.build()
    device = torch.device("cuda")
    cfg = tfm.TransformerConfig(**cs.FULL)
    params = tfm.init_params(cfg, seed=0, device=device)
    flash_cfg = dataclasses.replace(cfg, use_flash=True)
    oracle = []
    for r in make_trace(np.random.RandomState(0), 16, cfg):
        prompt = torch.as_tensor(r["prompt"], device=device)
        oracle.append({"prompt": r["prompt"], "max_new": r["max_new"],
                       "ref": tfm.generate(params, prompt[None],
                                           r["max_new"], flash_cfg,
                                           device=device)[0].tolist()})
    print(f"pause of the collector in captures: "
          f"{'off (--no-pause)' if args.no_pause else 'on'}", flush=True)
    failed = 0
    for k in range(args.rolls):
        t0 = time.perf_counter()
        try:
            cs.fleet_rolling(cfg, params, oracle, device)
            verdict = "held"
        except Exception as e:  # report and go on: the probe counts them
            failed += 1
            verdict = f"FAILED: {type(e).__name__}: {str(e)[:200]}"
        print(f"rolling leg {k}: {time.perf_counter() - t0:.1f} s, "
              f"{verdict}; {_holds_line()}", flush=True)
    print(f"rolling legs: {args.rolls}, failed {failed}", flush=True)
    try:
        cs.warm_without_collections(cfg, params, device)
    except AssertionError as e:
        print(f"  {e}", flush=True)
    # last: a failed capture may leave the process unable to capture
    cs.fleet_rolling(cfg, params, oracle, device)
    print(f"a capture after a rolling leg with gc.collect() inside it: "
          f"{collect_in_capture(cfg, params, device)}", flush=True)


if __name__ == "__main__":
    main()
