#!/usr/bin/env python3
"""Time variants of the port's attention kernels on one card.

    python3 tools/kernel_variants.py [flash] [wide] [decode]

Builds copies of `incubator_mxnet_tpu_torch/ops/csrc/flash_attention.cu`
and `decode.cu` (with `tf32_mma.cuh` inlined), each with one design choice
undone by a text substitution, into `build/kernel_variants/`, and times
them in turns, twice: CUDA events, median of 25 behind a device-side sleep
with the L2 flushed (`chip_smoke.device_ms`), float32 and bfloat16. Beside
each time stands the largest error against the plain version. The
arguments name the groups to run (default: all three).

- flash backward (dQ and dK/dV) and flash forward, at the transformer
  train step's shape (B 8, H 8, T 512, D 64, causal, the model's (B, T, H,
  D) layout). The "one TF32 pass" variants drop the two correction
  products of 3 x TF32: they measure what those cost, and their float32
  error is expected above the gates.
- the wide paged decode kernel at the serving shape (`chip_smoke.
  wide_case`, Q 5, 32 and 64), with the device time of its split and
  combine kernels from one profiler window. The "no products" variant
  skips the tensor-core products (its output is wrong): it measures what
  the products add to the split kernel's time.
- the single-query decode kernels (`paged_decode_attention` at the
  serving shape, `chip_smoke.paged_case`; `flash_decode` at generate()'s
  B 1, T 512, n_valid 270): splits of 16, 32 and 64 keys, and the merge
  done by the last block of each (slot, head) to finish (one launch)
  against the combine kernel (two; `COMBINE` below puts it back, float32
  only), with the device time of each kernel of the call from one
  profiler window; beside them, as a yardstick, the
  wide kernel at Q = 1 with n_base = n_valid - 1, which computes the
  same function on every live slot, `flash_decode` with its n_valid
  filled on the device first (as a python int was before it went to the
  kernel by value), and the floor of any timed call (one launch of a
  one-element fill).

Needs one CUDA card and nvcc; prints the card's name and power limit.
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
from incubator_mxnet_tpu_torch.ops.kernels import decode as dk  # noqa: E402
from incubator_mxnet_tpu_torch.ops.kernels import flash as fl  # noqa: E402

OUT = os.path.join(ROOT, "build", "kernel_variants")
HEADER = "tf32_mma.cuh"
CORRECTION = """  if constexpr (kIsFloat<TA>) mma_tf32(c, al, bh0, bh1);
  if constexpr (kIsFloat<TB>) mma_tf32(c, ah, bl0, bl1);
"""
# flash_attention.cu
WM = "  static constexpr int WM = D <= 64 ? 2 : 1;"
BN = "      D <= 64 && !kDkv ? 64 : D <= 128 ? 32 : 16;"
FWD_BN = "  static constexpr int BN = D <= 64 ? 64 : D <= 128 ? 32 : 16;"
PAIR = "  return causal && n - 1 - i > i ? n - 1 - i : -1;"
GRID = "grid_for(batch, heads, seq, causal), Cols<D>::kThreads"
FLASH_VARIANTS = {
    "shipped": [],
    "one row tile per block (no causal pairing)": [
        (PAIR, "  return -1;"), (GRID, "grid_for(batch, heads, seq), "
                                     "Cols<D>::kThreads")],
    "backward warps 4 x 1, 16 rows each": [
        (WM, WM.replace("D <= 64 ? 2 : 1", "1"))],
    "dQ walked tile 32 rows": [(BN, BN.replace("D <= 64 && !kDkv ? 64 : ",
                                               ""))],
    "forward key tile 32 rows": [(FWD_BN, FWD_BN.replace("D <= 64 ? 64 : ",
                                                         ""))],
    "one TF32 pass (no correction products)": [(CORRECTION, "")],
}
# decode.cu: split sizes change the kernel's tile and the host's rule
WIDE_BN = "  static constexpr int BN = D <= 64 ? 64 : 4096 / D;"
WIDE_RULE = "  return p <= 64 ? 64 : 4096 / p;"
WIDE_VARIANTS = {
    "shipped (64 keys a split)": ([], 64),
    "32 keys a split": ([(WIDE_BN, WIDE_BN.replace("? 64 :", "? 32 :")),
                         (WIDE_RULE, WIDE_RULE.replace("? 64 :", "? 32 :"))],
                        32),
    "16 keys a split": ([(WIDE_BN, WIDE_BN.replace("? 64 :", "? 16 :")),
                         (WIDE_RULE, WIDE_RULE.replace("? 64 :", "? 16 :"))],
                        16),
    "no products (wrong output)": (
        [("  if (live_warp) {\n    sum_over_d", "  if (false) {\n    "
          "sum_over_d"), ("if (live_warp) sum_over_rows",
                          "if (false) sum_over_rows")], 64),
}
# decode.cu: the single-query kernels' split size (the host's rule is
# dk.DECODE_KEYS_PER_SPLIT) and their merge
KEYS = "constexpr int kDecodeKeys = 32;"
# The merge in a second launch: dead splits write empty partials, no block
# merges, and wide_combine_kernel at n_q = 1 (which writes float32, so the
# variant takes a float32 q only) merges the partials.
COMBINE = [
    ("""    if (n_live == 0 && split == 0)
      for (int d = tid; d < head_dim; d += kDecodeThreads)
        out[(int64_t(b) * heads + h) * head_dim + d] = from_float<TQ>(0.f);
    return;""", """    if (tid == 0) {  // an empty partial, for the combine kernel
      part_ml[2 * at] = kNegInf;
      part_ml[2 * at + 1] = 0.f;
    }
    return;"""),
    ("  __shared__ bool last;", "  return;\n  __shared__ bool last;"),
    ("  return cudaGetLastError();\n}\n\n}  // namespace",
     """  if (const cudaError_t err = cudaGetLastError()) return err;
  if (!std::is_same<TQ, float>::value) return cudaErrorInvalidValue;
  return launch_combine<R>(part_o, part_ml, out, slots, 1, heads, head_dim,
                           n_split, stream);
}

}  // namespace"""),
]


def _keys(n):
    return (KEYS, KEYS.replace("32", str(n)))


DECODE_VARIANTS = {
    "shipped (last block merges, 32 keys)": ([], 32),
    "last block merges, 16 keys": ([_keys(16)], 16),
    "last block merges, 64 keys": ([_keys(64)], 64),
    "combine kernel (two launches), 32 keys": (COMBINE, 32),
    "combine kernel, 16 keys": ([*COMBINE, _keys(16)], 16),
    "combine kernel, 64 keys": ([*COMBINE, _keys(64)], 64),
}


def build(name, variants, signatures, tag=""):
    """{variant: loaded library} of ops/csrc/<name>.cu, every copy compiled
    at once (into files named by `tag`, so groups of one source do not
    overwrite each other)."""
    os.makedirs(OUT, exist_ok=True)
    src_dir = _build.SRC_DIR
    # the shared header inlined, so that a substitution may reach into it
    text = (src_dir / f"{name}.cu").read_text().replace(
        f'#include "{HEADER}"', (src_dir / HEADER).read_text())
    procs = {}
    for i, (variant, subs) in enumerate(variants.items()):
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{variant}: {old.strip()!r} is not in "
                                   f"{name}.cu")
            src = src.replace(old, new)
        path = os.path.join(OUT, f"{name}{tag}{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = path[:-3] + ".so"
        procs[variant] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for variant, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {variant}:\n{out}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
        libs[variant] = lib
    return libs


def err(got, want):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def flash_round(libs, device, flush):
    B, H, T, D, causal, _ = cs.ATTN_CASES["B8 H8 T512 D64 causal (training)"]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = cs.attn_case(device, dtype, B, H, T, D, True)
        o, lse = fl.flash_attention_fwd_ref(q, k, v, causal)
        args = (q, k, v, do, lse, fl._delta(o, do), causal)
        want = (fl.flash_attention_dq_ref(*args),
                *fl.flash_attention_dkv_ref(*args))
        for name, lib in libs.items():
            fl._lib = lambda lib=lib: lib
            e_fwd = err(fl.flash_attention_fwd(q, k, v, causal), (o, lse))
            e_bwd = err((fl.flash_attention_dq(*args),
                         *fl.flash_attention_dkv(*args)), want)
            fwd_ms, dq_ms, dkv_ms = (cs.device_ms(fn, flush=flush) for fn in (
                lambda: fl.flash_attention_fwd(q, k, v, causal),
                lambda: fl.flash_attention_dq(*args),
                lambda: fl.flash_attention_dkv(*args)))
            print(f"  {str(dtype)[6:]:8s} {name:42s} forward "
                  f"{fwd_ms * 1e3:6.1f} us (err {e_fwd:.2e})  dQ "
                  f"{dq_ms * 1e3:6.1f} us  dK/dV {dkv_ms * 1e3:6.1f} us "
                  f"(err {e_bwd:.2e})", flush=True)


def wide_round(libs, device, flush, profile):
    rule = dk.wide_keys_per_split
    for dtype in (torch.float32, torch.bfloat16):
        for Q in cs.WIDE_Q:
            args = cs.wide_case(device, dtype, Q)
            want = dk.paged_decode_attention_wide_ref(*args)
            for name, (lib, keys) in libs.items():
                dk._lib = lambda lib=lib: lib
                dk.wide_keys_per_split = (
                    lambda d, keys=keys: keys if d <= 64 else rule(d))
                e = err((dk.paged_decode_attention_wide(*args),), (want,))
                ms = cs.device_ms(lambda: dk.paged_decode_attention_wide(
                    *args), flush=flush)
                split = ""
                if profile:  # every kernel of the call, dtype casts too
                    split = "; ".join(
                        f"{us:.1f} us {kname.split('::')[-1][:28]}"
                        for kname, us in cs.library_kernels(
                            lambda: dk.paged_decode_attention_wide(*args)))
                print(f"  {str(dtype)[6:]:8s} Q {Q:2d} {name:46s} "
                      f"{ms * 1e3:6.1f} us (err {e:.2e}) {split}",
                      flush=True)
    dk.wide_keys_per_split = rule


def decode_round(libs, device, flush, profile):
    """Kernels 8 and 9 in each variant (library, keys a split), then the
    wide kernel of the shipped library at Q = 1 on the same inputs."""
    rule = dk.DECODE_KEYS_PER_SPLIT
    shipped = next(iter(libs.values()))[0]
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, table, nv = paged = cs.paged_case(device, dtype)
        flash = cs.flash_case(device, dtype, 1, 512, 270)
        calls = {"paged_decode_attention S8 H8 D64 n_valid 0...512": (
                     dk.paged_decode_attention, dk.paged_decode_attention_ref,
                     paged),
                 "flash_decode B1 H8 D64 T512 n_valid 270": (
                     dk.flash_decode, dk.flash_decode_ref, flash)}
        for label, (kernel, plain, args) in calls.items():
            want = plain(*args)
            for name, (lib, keys) in libs.items():
                if name.startswith("combine") and dtype != torch.float32:
                    continue  # the combine writes float32
                dk._lib = lambda lib=lib: lib
                dk.DECODE_KEYS_PER_SPLIT = keys
                e = err((kernel(*args),), (want,))
                ms = cs.device_ms(lambda: kernel(*args), flush=flush)
                split = ""
                if profile:  # every kernel of the call
                    split = "; ".join(
                        f"{us:.1f} us {kname.split('::')[-1][:28]}"
                        for kname, us in cs.library_kernels(
                            lambda: kernel(*args)))
                print(f"  {str(dtype)[6:]:8s} {label} {name:44s} "
                      f"{ms * 1e3:6.1f} us (err {e:.2e}) {split}",
                      flush=True)
        # flash_decode as generate() called it before n_valid went by
        # value: the python int filled on the device first
        dk._lib = lambda: shipped
        dk.DECODE_KEYS_PER_SPLIT = rule
        fq, fk, fv, n = flash
        ms = cs.device_ms(lambda: dk.flash_decode(fq, fk, fv, torch.full(
            (1,), n, dtype=torch.int32, device=device)), flush=flush)
        print(f"  {str(dtype)[6:]:8s} flash_decode, n_valid filled on the "
              f"device first (a second launch): {ms * 1e3:6.1f} us",
              flush=True)
        # the floor of a timed call: one launch of a one-element fill
        one = torch.empty(1, device=device)
        floor = cs.device_ms(lambda: one.zero_(), flush=flush)
        print(f"  {str(dtype)[6:]:8s} floor: one launch of a one-element "
              f"fill: {floor * 1e3:6.1f} us", flush=True)
        # the yardstick: row 0 at position n_valid - 1 sees n_valid keys
        wide = (q[:, None], kp, vp, table, nv - 1)
        live = nv > 0
        e = err((dk.paged_decode_attention_wide(*wide)[:, 0][live],),
                (dk.paged_decode_attention_ref(*paged)[live],))
        ms = cs.device_ms(lambda: dk.paged_decode_attention_wide(*wide),
                          flush=flush)
        print(f"  {str(dtype)[6:]:8s} yardstick: paged_decode_attention_wide "
              f"Q 1, n_base = n_valid - 1, S8 H8 D64: {ms * 1e3:6.1f} us "
              f"(err on the live slots {e:.2e})", flush=True)
    dk.DECODE_KEYS_PER_SPLIT = rule


def main(groups):
    if not torch.cuda.is_available():
        print("kernel_variants: needs one CUDA card", file=sys.stderr)
        return 2
    groups = set(groups or ("flash", "wide", "decode"))
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    gpu = cs.card()
    if "flash" in groups:
        flash_libs = build("flash_attention", FLASH_VARIANTS, fl._SIGNATURES)
    if "wide" in groups:
        wide_libs = build("decode", {k: v[0] for k, v in
                                     WIDE_VARIANTS.items()}, dk._SIGNATURES)
        wide_libs = {k: (lib, WIDE_VARIANTS[k][1])
                     for k, lib in wide_libs.items()}
    if "decode" in groups:
        decode_libs = build("decode", {k: v[0] for k, v in
                                       DECODE_VARIANTS.items()},
                            dk._SIGNATURES, tag="single")
        decode_libs = {k: (lib, DECODE_VARIANTS[k][1])
                       for k, lib in decode_libs.items()}
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    for rnd in range(2):
        if "flash" in groups:
            print(f"flash variants, B8 H8 T512 D64 causal, model layout, "
                  f"round {rnd + 1} [{gpu}]")
            flash_round(flash_libs, device, flush)
        if "wide" in groups:
            print(f"wide decode variants, S8 H8 D64 page 16, round "
                  f"{rnd + 1} [{gpu}]")
            wide_round(wide_libs, device, flush, profile=rnd == 0)
        if "decode" in groups:
            print(f"single-query decode variants, round {rnd + 1} [{gpu}]")
            decode_round(decode_libs, device, flush, profile=rnd == 0)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
