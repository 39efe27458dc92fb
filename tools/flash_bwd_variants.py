#!/usr/bin/env python3
"""Time variants of the port's flash-attention backward kernels on one card.

    python3 tools/flash_bwd_variants.py

Builds copies of `incubator_mxnet_tpu_torch/ops/csrc/flash_attention.cu`,
each with one design choice undone by a text substitution, into
`build/flash_variants/`, and times the dQ and dK/dV kernels of each at the
transformer train step's shape (B 8, H 8, T 512, D 64, causal, the model's
(B, T, H, D) layout) in float32 and bfloat16: CUDA events, median of 25
behind a device-side sleep with the L2 flushed, the variants in turns,
twice. Beside each time stands the largest error against the plain
versions. The "one TF32 pass" variant drops the two correction products
of 3 x TF32: it measures what they cost, and its float32 error is expected
above the 2e-4 gate. Needs one CUDA card and nvcc; prints the card's name
and power limit.
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
from incubator_mxnet_tpu_torch.ops.kernels import flash as fl  # noqa: E402

SOURCE = os.path.join(ROOT, cs.FLASH_SOURCE)
OUT = os.path.join(ROOT, "build", "flash_variants")
WM = "  static constexpr int WM = D <= 64 ? 2 : 1;"
BN = "  static constexpr int BN = D <= 64 && !kDkv ? 64 : 32;"
PAIR = "  return causal && n - 1 - i > i ? n - 1 - i : -1;"
GRID = "grid_for(batch, heads, seq, causal), kBwdThreads"
CORRECTION = """  if constexpr (kIsFloat<T>) {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
"""
VARIANTS = {
    "shipped": [],
    "one row tile per block (no causal pairing)": [
        (PAIR, "  return -1;"), (GRID, "grid_for(batch, heads, seq), "
                                     "kBwdThreads")],
    "warps 4 x 1, 16 rows each": [(WM, WM.replace("D <= 64 ? 2 : 1",
                                                  "1"))],
    "walked tile 32 rows in dQ": [(BN, BN.replace("D <= 64 && !kDkv ? 64 "
                                                  ": 32", "32"))],
    "one TF32 pass (no correction products)": [(CORRECTION, "")],
}


def build():
    """{variant: loaded library}, every copy compiled at once."""
    os.makedirs(OUT, exist_ok=True)
    text = open(SOURCE).read()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{name}: {old.strip()!r} is not in "
                                   f"{cs.FLASH_SOURCE}")
            src = src.replace(old, new)
        path = os.path.join(OUT, f"variant{i}.cu")
        open(path, "w").write(src)
        so = path[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in fl._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print("flash_bwd_variants: needs one CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    gpu = cs.card()
    libs = build()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    B, H, T, D, causal, _ = cs.ATTN_CASES["B8 H8 T512 D64 causal (training)"]
    print(f"flash backward variants, B{B} H{H} T{T} D{D} causal, model "
          f"layout [{gpu}]")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = cs.attn_case(device, dtype, B, H, T, D, True)
        o, lse = fl.flash_attention_fwd_ref(q, k, v, causal)
        args = (q, k, v, do, lse, fl._delta(o, do), causal)
        want = (fl.flash_attention_dq_ref(*args),
                *fl.flash_attention_dkv_ref(*args))
        for _ in range(2):
            for name, lib in libs.items():
                fl._lib = lambda lib=lib: lib
                got = (fl.flash_attention_dq(*args),
                       *fl.flash_attention_dkv(*args))
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
                dq_ms = cs.device_ms(lambda: fl.flash_attention_dq(*args),
                                     flush=flush)
                dkv_ms = cs.device_ms(lambda: fl.flash_attention_dkv(*args),
                                      flush=flush)
                print(f"  {str(dtype)[6:]:8s} {name:44s} dQ "
                      f"{dq_ms * 1e3:7.1f} us  dK/dV {dkv_ms * 1e3:7.1f} us  "
                      f"max abs err {err:.2e}", flush=True)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
