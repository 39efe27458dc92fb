#!/usr/bin/env python3
"""Measure the tensor-core rates one card reaches: mma.sync in TF32
(m16n8k8) and bfloat16 (m16n8k16), and wgmma in TF32 (m64n64k8, A from
shared memory or registers), each in a loop of independent products
(`tools/tensor_core_rate.cu`), timed with CUDA events.

    python3 tools/tensor_core_rate.py

The yardstick for the flash backward kernels' use of the tensor cores
(`PERF.md`): what a bare loop of each instruction reaches on this card,
against the data sheet's 495 TFLOP/s TF32 and 989 bfloat16. Needs one
CUDA card and nvcc; prints the card's name and power limit.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch.ops import _build  # noqa: E402

SOURCE = os.path.join(ROOT, "tools", "tensor_core_rate.cu")
LIB = os.path.join(ROOT, "build", "tensor_core_rate.so")
ITERS = 2000


def seconds(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def main():
    if not torch.cuda.is_available():
        print("tensor_core_rate: needs one CUDA card", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", LIB, SOURCE],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(LIB)
    lib.mxtpu_tensor_core_rate.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int]
    gpu = cs.card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 512, device="cuda")

    def run(kind, blocks, threads):
        err = lib.mxtpu_tensor_core_rate(kind, out.data_ptr(), blocks,
                                         threads, ITERS)
        if err:
            raise RuntimeError(f"launch failed: cuda error {err}")

    for kind, name, flop in ((0, "mma.sync TF32 m16n8k8", 2 * 16 * 8 * 8),
                             (1, "mma.sync bf16 m16n8k16", 2 * 16 * 8 * 16)):
        for warps in (4, 8, 16):
            blocks = 4 * sms
            sec = seconds(lambda: run(kind, blocks, 32 * warps))
            total = blocks * warps * ITERS * 8 * flop
            print(f"  {name}, {blocks} blocks of {warps} warps: "
                  f"{total / sec / 1e12:.1f} TFLOP/s [{gpu}]")
    for kind, name in ((2, "A in shared memory"), (3, "A in registers")):
        for per_sm in (1, 2, 4):
            blocks = per_sm * sms
            sec = seconds(lambda: run(kind, blocks, 128))
            total = blocks * ITERS * 8 * 2 * 64 * 64 * 8
            print(f"  wgmma TF32 m64n64k8, {name}, {blocks} blocks: "
                  f"{total / sec / 1e12:.1f} TFLOP/s [{gpu}]")
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
