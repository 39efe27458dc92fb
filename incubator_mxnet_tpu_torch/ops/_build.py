"""Build and load the port's hand-written CUDA kernels.

Each source `ops/csrc/<name>.cu` is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface and loaded
with `ctypes`. Builds happen at first use, into `build/torch_kernels/`
at the root of the checkout (listed in `.gitignore`), and each library
is named by a hash of its source, the shared headers (`csrc/*.cuh`) and
the compiler flags: an edited source or header rebuilds, an unchanged
one loads at once. `build()` starts one
`nvcc` per source, all at the same time. A missing `nvcc` or a failed
compile raises with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_DIR", "build", "load"]

SOURCES = ("decode", "flash_attention", "xent", "epilogue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "toolkit is needed to build the port's kernels")


def _target(name):
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):  # what the sources include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES):
    """Compile every named source that is not built yet, one `nvcc` each,
    all started together. Returns {name: {"path", "seconds", "output",
    "cached"}} (`output` holds the compiler's report, `ptxas -v`
    included); raises with the compiler output of every source that
    failed."""
    built, procs = {}, {}
    t0 = time.perf_counter()
    try:
        for name in names:
            src, out = _target(name)
            if out.exists():
                built[name] = {"path": out, "seconds": 0.0, "output": "",
                               "cached": True}
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            output, _ = proc.communicate()
            built[name] = {"path": out, "seconds": time.perf_counter() - t0,
                           "output": output, "cached": False}
            if proc.returncode:
                errors.append(f"nvcc failed on {name}.cu (exit "
                              f"{proc.returncode}):\n{output}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return built


def load(name, signatures):
    """The loaded library of `ops/csrc/<name>.cu`, built on first use, with
    the argument types of each function in `signatures` ({name: argtypes};
    each returns a CUDA error code as an int) and of the library's
    `mxtpu_cuda_error_string` declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]["path"]))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib
