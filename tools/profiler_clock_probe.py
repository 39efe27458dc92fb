#!/usr/bin/env python3
"""Where a torch.profiler window places its device records, against the
host calls that launched them, over a process's life on the card.

Serves `chip_smoke.py` phase 3's prefix-cache leg (the full-width
transformer, its engine's sites captured into CUDA graphs) again and
again; every `--every` traces one more runs inside a bare profiler window
(no idle margin at either end). For each window it prints: the wide
kernel's device records against the launches its wrapper counted; the
least and the median of (a device record's start minus the start of the
host call that launched it: `cudaGraphLaunch`, `cudaLaunchKernel`, ...),
which is never negative on one clock; and how far the window's first
device record starts after its first host record. A negative lead shows
how far a device record's mapped time can stray before its own launch,
and so how near the edge of a window a kernel can be dropped from its
records. The last line sums the windows, beside the card's name and
power limit.

    python3 tools/profiler_clock_probe.py [--seconds 240] [--every 20]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cuLaunchKernel",
                "cudaMemcpyAsync")


def window(run):
    """One bare profiler window around `run()`: (wide records, leads in
    ns, first device record minus first host record in ns)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    dev = [e for e in events if e.device_type() == cuda]
    host = [e for e in events if e.device_type() != cuda]
    launch = {e.correlation_id(): e.start_ns() for e in host
              if e.name().startswith(LAUNCH_CALLS)}
    leads = sorted(e.start_ns() - launch[e.correlation_id()] for e in dev
                   if e.correlation_id() in launch)
    wide = sum(1 for e in dev if cs.DEVICE_KERNELS["wide"] in e.name())
    first = (min(e.start_ns() for e in dev)
             - min(e.start_ns() for e in host))
    return wide, leads, first


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0,
                    help="stop opening windows after this long")
    ap.add_argument("--every", type=int, default=20,
                    help="untraced traces between two windows")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_clock_probe: needs a CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.card()
    cs._build.build()
    cfg = cs.tfm.TransformerConfig(**cs.FULL)
    params = cs.tfm.init_params(cfg, seed=0, device=device)
    cs.telemetry.enable()
    levers = cs.LEVER_LEGS["prefix"]
    eng = cs.serve(cfg, params, 16, device, **levers)["engine"]
    rest = {k: v for k, v in levers.items() if k not in cs.ENGINE_LEVERS}

    def run():
        cs.run_trace(params, cfg, n_requests=16, seed=0, engine=eng, **rest)

    wide_kernel = cs.dk.paged_decode_attention_wide
    n = short = negative = 0
    least = None
    while time.perf_counter() - t_start < args.seconds:
        for _ in range(args.every):
            run()
        wide_kernel.launches = 0
        wide, leads, first = window(run)
        n += 1
        short += wide != wide_kernel.launches
        negative += leads[0] < 0
        least = leads[0] if least is None else min(least, leads[0])
        print(f"t {time.perf_counter() - t_start:6.1f} s: wide records "
              f"{wide} of {wide_kernel.launches} launches; device record "
              f"minus its launch call: least {leads[0] / 1e3:.1f} us, median "
              f"{leads[len(leads) // 2] / 1e3:.1f} us over {len(leads)}; "
              f"first device record {first / 1e3:.1f} us after the first "
              f"host record", flush=True)
    print(f"{n} bare windows: {short} with wide records missing, {negative} "
          f"with a device record before its launch call, the least lead "
          f"{least / 1e3:.1f} us [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
