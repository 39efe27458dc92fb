#!/usr/bin/env python3
"""Drive the PyTorch port's serving path (through CUDA graphs), its
transformer train step and its ResNet-50 train step on one CUDA card and
hold its hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels build for sm_90a) and the CUDA
toolkit's nvcc; imports only torch, numpy and `incubator_mxnet_tpu_torch`.
Phases, in order; any failure raises and the exit code is non-zero:

1. build: nvcc compiles every kernel source of the port (one process per
   source, all at once) into build/torch_kernels/;
2. kernels: each kernel against its plain version on the card, in
   float32 and bfloat16. The decode kernels at the shapes the serving
   path gives them (tolerance 2e-5 and 2e-2); the single-query ones
   (paged_decode_attention, flash_decode) also at (H, D) (8, 8), (4, 100)
   and (2, 256), each against the dense softmax and its split walk, a
   dead slot or row giving zeros, bit-equal across two launches, and
   each captured in a CUDA graph and replayed after n_valid and the page
   table changed in place; the wide kernel at Q = 5,
   32 and 64 rows per slot and at a head dim of 80 (Q 5, 4 heads), each
   against the dense softmax and the split walk at the kernel's split
   size, bit-equal across two launches, and captured in two CUDA graphs
   (Q 5 and 64) replayed after n_base and the page table changed in
   place; the flash-attention forward,
   dQ and dK/dV
   kernels at the training shape (B 8, H 8, T 512, D 64, causal, in the
   model's (B, T, H, D) layout), non-causal at T 512, at a causal ragged
   T 200, a non-causal ragged T 24, at D 16, at the padded head dims 4,
   6, 8, 12, 128, 160 and 256 (B 2, H 4, T 200, causal), D 128 at T 512
   and D 256 non-causal at a ragged T 130 (o and
   lse 2e-5 and 2e-2; dQ, dK, dV 2e-4 in float32 and, in bfloat16, 2e-2
   of the largest reference value), o, lse, dQ, dK and dV bit-equal across
   two launches, and 2 train steps with use_flash at head dims 12, 128
   and 256 (losses finite, step 1 equal to dense at rtol 1e-5); the
   softmax-xent
   forward and backward kernels at the train step's (4096, 32000), at the
   JAX tests' N 16 / V 50, N 8 / V 33 and a batched (2, 5, 17) through
   the autograd Function, and on strided, unaligned and transposed views,
   with labels -1 and V in every batch
   (loss and lse 1e-5; dlogits rtol 1e-4, atol 1e-5 in float32 and 2e-2
   of the largest reference value in bfloat16); the BN -> ReLU (-> add)
   epilogue forward and backward kernels at a ragged R 1001 with C 64 and
   2048, at C 67 (one-element loads), on unaligned views and at ResNet-50's
   stem, stage-1 and stage-4 shapes, with and without the residual, in
   float32 and bfloat16 (forward 1e-6 and 2e-2; dx, dres 1e-4 and 2e-2;
   the channel sums rtol 1e-4, atol 1e-4 * sqrt(R / 75)), the backward
   bit-equal across two runs, and the autograd Function's four gradients;
3. serving: the full-width transformer (d_model 512, 6 layers, 8 heads,
   d_ff 2048, vocab 32000, max_len 512, float32, random weights from
   seed 0) serves the seeded trace through the engine (8 slots, page 16)
   with the levers off, then once with each lever on (prefix cache over
   a half-shared 32-token prefix, chunked prefill of 64, n-gram 2
   speculation with lookahead 4), each on an engine whose every site
   warm() captured into a CUDA graph first. Every site must be captured
   and the run must capture nothing (steady and warm-up compiles and
   retraces 0); every request must complete with its full budget; the
   paged kernel must run once per layer per decode step and the wide
   kernel once per layer per wide step, every launch in a graph replay
   (the launches each graph holds x its replays); every request's tokens
   must equal generate() with use_flash, which runs the flash_decode
   kernel. The levers-off leg serves the trace once more with
   MXTPU_TRACE_DIR set: its MXTRACE1 file must parse with the port's
   reader, with one complete causal chain per request;
4. training: the same full-width model with use_flash (batch 8, seq 512,
   lr 0.1, aux_weight 0.01, tokens and targets from RandomState(0) as
   tools/bench_transformer.py draws them) takes 10 steps of
   make_train_step. Every loss must be finite; the forward, dQ and dK/dV
   kernels must each launch once per layer per step; the first 3 losses
   must equal a second run through apply with dense attention at rtol
   1e-5, and one step's gradients must agree with the dense path at rtol
   2e-4, atol 1e-5. The fused leg adds use_fused_xent: 10 steps, the
   xent kernels once each per step and the flash kernels once per layer,
   the first 3 losses equal to the flash leg's (dense xent) at rtol 1e-5
   and one step's gradients at rtol 2e-4, atol 1e-5. The moe leg takes 5
   steps of the same widths with 4 experts, flash and the fused xent:
   finite losses, a positive balance loss, and layer 0's moe_ffn on the
   card at its full-width input (4096 tokens, capacity 2048) equal to the
   CPU's at 1e-4, routing identical but for counted near ties (top-2
   probability gap below 1e-5). Two ResNet-50 v1 legs follow bench.py
   (NHWC, float32, batch 128 at 224 x 224, Xavier from a seeded
   generator, SGD lr 0.05, momentum 0.9, wd 1e-4, rescale_grad 1/128,
   images and labels from RandomState(0)): 10 steps of GluonTrainStep with
   MXTPU_FUSED_EPILOGUE off, then on from the same weights. The fused leg
   must launch each epilogue kernel 49 times per step (the unfused leg
   none), its step-1 loss must equal the unfused leg's at rtol 1e-5, atol
   1e-6 and its gradients at rtol 2e-4, atol 1e-5; every loss finite, the
   largest relative loss gap printed;
5. times (CUDA events; warm-up first, median of 25 or more): decode step,
   prefill, the wide step at Q 5 and 64, tokens/s, TTFT and request
   latency over each trace (through graphs), the decode step eager
   against its CUDA graph in 6 alternating turns (host clock with the
   read-back, device time), the train step and train tokens/s of
   each training leg, and each kernel beside its plain version, its bound
   and, for flash_decode, the flash-attention and the softmax-xent
   kernels, one library call (the flash backward's: the library's
   backward alone, its kernels named from a profiler window, beside the
   tensor-core bound and the HMMA / HGMMA count of the flash and wide
   kernels' SASS, which must not be 0; the flash kernels and the wide
   kernel (Q 5, 32, 64) in float32 and bfloat16, the decode kernels in
   bfloat16 too, and the flash kernels at D 256 (B 8, H 2, T 512);
   none computes the epilogue kernels, which
   are timed beside the BN -> ReLU (-> add) chain they replace); each
   ResNet-50 leg's step, host time and images/s; then
   traced windows (torch.profiler) over decode steps (eager and
   graphed), over each trace (through graphs, where the serving.step
   span must show up by name) and over train steps (both models) give
   the device's busy share and the kernels that take its time.

The last lines are the whole call's seconds, the card (`nvidia-smi` name
and power limit), one JSON object describing the kernels, and the status
JSON.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.fused import GluonTrainStep
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.models import transformer as tfm
from incubator_mxnet_tpu_torch.ops import _build
from incubator_mxnet_tpu_torch.ops import epilogue as rewrite
from incubator_mxnet_tpu_torch.ops.kernels import decode as dk
from incubator_mxnet_tpu_torch.ops.kernels import epilogue as ep
from incubator_mxnet_tpu_torch.ops.kernels import flash as fl
from incubator_mxnet_tpu_torch.ops.kernels import xent as xt
from incubator_mxnet_tpu_torch.parallel import moe
from incubator_mxnet_tpu_torch import profiler, telemetry
from incubator_mxnet_tpu_torch.serving import (PageAllocator, ServingEngine,
                                               run_trace)
from incubator_mxnet_tpu_torch.telemetry import distributed as tdist

FULL = dict(vocab=32000, d_model=512, n_heads=8, n_layers=6, d_ff=2048,
            max_len=512)
SLOTS, PAGE = 8, 16
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores
TF32_OPS_PER_S = 495e12    # tensor cores, dense (float32 as 3 x TF32)
BF16_OPS_PER_S = 989e12    # tensor cores, dense
NEAR_TIE = 1e-4
WIDE_Q = (5, 32, 64)  # speculation (lookahead 4), prefix tail, chunk 64
LEVER_LEGS = {
    "prefix": dict(prefix_cache=1, shared_prefix_frac=0.5, prefix_len=32),
    "chunked": dict(prefill_chunk=64),
    "spec": dict(spec_ngram=2, spec_lookahead=4),
}
TRAIN = dict(batch=8, seq=512, lr=0.1, aux_weight=0.01, steps=10)
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SOURCES = {name: f"incubator_mxnet_tpu_torch/ops/csrc/{name}.cu"
           for name in _build.SOURCES}
DECODE_SOURCE, FLASH_SOURCE, XENT_SOURCE, EPILOGUE_SOURCE = (
    SOURCES[name] for name in ("decode", "flash_attention", "xent",
                               "epilogue"))
JAX_KERNELS = "incubator_mxnet_tpu/ops/pallas_kernels.py"


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(label, got, want, tol, atol=None):
    """got within rtol `tol` and atol `atol` (default: `tol`) of want."""
    atol = tol if atol is None else atol
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=atol)
    print(f"  {label}: max_abs_err {err:.3e} (tolerance {tol:g}"
          + ("" if atol == tol else f", atol {atol:g}") + ")")
    if not (ok and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


# -- phase 2: kernels against their plain versions --------------------------

def paged_case(device, dtype, seed=0, H=8, D=64):
    """The serving shape: 8 slots, 8 heads of 64, pages of 16, table 32,
    pool 257; ragged n_valid including 0, 1, 16, 511 and 512."""
    S, W, P = SLOTS, 512 // PAGE, SLOTS * 512 // PAGE + 1
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_valid = torch.tensor([0, 1, 16, 17, 200, 300, 511, 512])
    alloc = PageAllocator(P, PAGE)
    table = torch.zeros((S, W), dtype=torch.int32)
    for s in range(S):
        pages = alloc.alloc(alloc.pages_needed(int(n_valid[s])))
        table[s, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
    q = torch.randn((S, H, D), generator=g)
    kp = torch.randn((P, PAGE, H, D), generator=g)
    vp = torch.randn((P, PAGE, H, D), generator=g)
    args = (q, kp, vp, table, n_valid.to(torch.int32))
    return tuple(a.to(device=device, dtype=dtype)
                 if a.is_floating_point() else a.to(device) for a in args)


def recycled_case(device, dtype, seed=1, **head):
    """Slot 5's pages freed and handed to a new sequence, which writes new
    K/V into them: the kernel must read the new contents."""
    q, kp, vp, table, nv = (a.clone() for a in paged_case(device, dtype,
                                                          **head))
    g = torch.Generator(device="cpu").manual_seed(seed)
    pages = table[5, :-(-300 // PAGE)].tolist()
    new = list(reversed(pages))  # the same ids, in another order
    for pg in new:
        kp[pg] = torch.randn(kp.shape[1:], generator=g).to(kp)
        vp[pg] = torch.randn(vp.shape[1:], generator=g).to(vp)
    table[5] = 0
    table[5, :len(new)] = torch.tensor(new, dtype=torch.int32)
    nv[5] = len(new) * PAGE - 3
    return q, kp, vp, table, nv


def wide_case(device, dtype, Q, seed=3, H=8, D=64):
    """The serving shape with Q rows per slot: 8 slots, 8 heads of 64,
    pages of 16, table 32, pool 257; ragged n_base, and rows past the
    table (cap 512) in the last two slots, the last one wholly past."""
    S, W, P = SLOTS, 512 // PAGE, SLOTS * 512 // PAGE + 1
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_base = torch.tensor([0, 1, 15, 16, 200, 300, 511 - Q // 2, 512])
    alloc = PageAllocator(P, PAGE)
    table = torch.zeros((S, W), dtype=torch.int32)
    for s in range(S):
        pages = alloc.alloc(alloc.pages_needed(min(int(n_base[s]) + Q, 512)))
        table[s, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
    q = torch.randn((S, Q, H, D), generator=g)
    kp = torch.randn((P, PAGE, H, D), generator=g)
    vp = torch.randn((P, PAGE, H, D), generator=g)
    args = (q, kp, vp, table, n_base.to(torch.int32))
    return tuple(a.to(device=device, dtype=dtype)
                 if a.is_floating_point() else a.to(device) for a in args)


def wide_recycled_case(device, dtype, Q, seed=4, **head):
    """Slot 5's pages handed, in another order, to a new sequence with
    new K/V and another n_base: the kernel must read the new contents."""
    q, kp, vp, table, nb = (a.clone() for a in wide_case(device, dtype, Q,
                                                          **head))
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_pages = int((table[5] != 0).sum())
    new = list(reversed(table[5, :n_pages].tolist()))
    for pg in new:
        kp[pg] = torch.randn(kp.shape[1:], generator=g).to(kp)
        vp[pg] = torch.randn(vp.shape[1:], generator=g).to(vp)
    table[5] = 0
    table[5, :len(new)] = torch.tensor(new, dtype=torch.int32)
    nb[5] = len(new) * PAGE - Q - 3
    return q, kp, vp, table, nb


# (Q, head shape) of the wide kernel's checks: the serving head shape at
# the levers' widths, and a head dim that is no power of two (D_p 128)
WIDE_CASES = (*((Q, dict(H=8, D=64)) for Q in WIDE_Q), (5, dict(H=4, D=80)))


def wide_against_plain(label, args, tol):
    """The wide kernel against both plain versions: the dense softmax and
    the split walk at the kernel's own split size."""
    got = dk.paged_decode_attention_wide(*args)
    keys = dk.wide_keys_per_split(args[0].shape[-1])
    return max(
        check(f"paged_decode_attention_wide {label}", got,
              dk.paged_decode_attention_wide_ref(*args), tol),
        check(f"paged_decode_attention_wide {label} vs the split walk "
              f"({keys} keys a split)", got,
              dk.paged_decode_attention_wide_split_ref(*args, keys), tol))


def wide_deterministic(device, dtype):
    """Two launches of the wide kernel give bit-equal outputs (no
    atomics, the combine's order fixed) at every width of WIDE_Q."""
    for Q in WIDE_Q:
        args = wide_case(device, dtype, Q)
        if not torch.equal(dk.paged_decode_attention_wide(*args),
                           dk.paged_decode_attention_wide(*args)):
            raise AssertionError(f"paged_decode_attention_wide differs "
                                 f"between two launches (Q {Q}, {dtype})")
    print(f"  paged_decode_attention_wide {str(dtype)[6:]} Q {WIDE_Q}: "
          f"bit-equal across two launches")


def flash_case(device, dtype, B, T, n_valid, seed=2, H=8, D=64):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, H, D), generator=g)
    k = torch.randn((B, T, H, D), generator=g)
    v = torch.randn((B, T, H, D), generator=g)
    if not isinstance(n_valid, int):
        n_valid = torch.tensor(n_valid, dtype=torch.int32, device=device)
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            n_valid)


FLASH_CASES = {
    "B8 T512 scalar n_valid 300": (8, 512, 300),
    "B8 T512 (B,) n_valid": (8, 512, [1, 2, 127, 128, 129, 300, 511, 512]),
    "B8 T200 scalar n_valid 137": (8, 200, 137),
    "B8 T200 (B,) n_valid": (8, 200, [1, 5, 64, 100, 128, 150, 199, 200]),
    "B8 T200 (B,) n_valid, a dead row": (8, 200, [0, 5, 31, 32, 33, 150,
                                                  199, 200]),
    "B1 T512 scalar n_valid 270 (generate)": (1, 512, 270),
}
# (heads, head dim) of kernels 8-9 beside the serving head (8, 64): the
# smallest lane count, a head dim that is no power of two and the largest
DECODE_HEADS = ((8, 64), (8, 8), (4, 100), (2, 256))


def decode_against_plain(device, dtype, tol):
    """Kernels 8 and 9 against both plain versions (the dense softmax and
    the split walk at the kernel's split size) at every head shape of
    DECODE_HEADS: the paged kernel on the ragged and recycled-page cases
    (a dead slot must give zeros), flash_decode on FLASH_CASES at the
    serving head and on its (B,) cases at the others. Returns the largest
    error of each."""
    name = str(dtype).replace("torch.", "")
    keys = dk.DECODE_KEYS_PER_SPLIT
    err = {"paged_decode_attention": 0.0, "flash_decode": 0.0}
    for H, D in DECODE_HEADS:
        head = dict(H=H, D=D)
        for label, make in (("ragged", paged_case),
                            ("recycled pages", recycled_case)):
            args = make(device, dtype, **head)
            got = dk.paged_decode_attention(*args)
            tag = f"paged_decode_attention {name} H{H} D{D} {label}"
            err["paged_decode_attention"] = max(
                err["paged_decode_attention"],
                check(tag, got, dk.paged_decode_attention_ref(*args), tol),
                check(f"{tag} vs the split walk ({keys} keys a split)", got,
                      dk.paged_decode_attention_split_ref(*args, keys), tol))
            if got[args[4] == 0].any():
                raise AssertionError("a dead slot must give zeros")
        for label, (B, T, nv) in FLASH_CASES.items():
            if (H, D) != (8, 64) and isinstance(nv, int):
                continue
            args = flash_case(device, dtype, B, T, nv, **head)
            got = dk.flash_decode(*args)
            tag = f"flash_decode {name} H{H} D{D} {label}"
            err["flash_decode"] = max(
                err["flash_decode"],
                check(tag, got, dk.flash_decode_ref(*args), tol),
                check(f"{tag} vs the split walk", got,
                      dk.flash_decode_split_ref(*args, keys), tol))
            if not isinstance(nv, int) and got[args[3] == 0].any():
                raise AssertionError("a dead row must give zeros")
    return err


def decode_deterministic(device, dtype):
    """Two launches of kernels 8 and 9 give bit-equal outputs (no atomics
    on data, the merge's order fixed) at every head shape of
    DECODE_HEADS."""
    for H, D in DECODE_HEADS:
        calls = ((dk.paged_decode_attention,
                  paged_case(device, dtype, H=H, D=D)),
                 (dk.flash_decode,
                  flash_case(device, dtype, *FLASH_CASES[
                      "B8 T512 (B,) n_valid"], H=H, D=D)))
        for kernel, args in calls:
            if not torch.equal(kernel(*args), kernel(*args)):
                raise AssertionError(f"{kernel.__name__} differs between two "
                                     f"launches (H{H} D{D}, {dtype})")
    print(f"  paged_decode_attention, flash_decode {str(dtype)[6:]} at "
          f"(H, D) {DECODE_HEADS}: bit-equal across two launches")


def decode_graphs(device, dtype, tol):
    """Each of kernels 8 and 9 captured in two CUDA graphs (one call each,
    after a warm-up call outside them), then n_valid and the page table
    changed in place and both graphs replayed at once on two streams: each
    output must equal the plain version on the changed inputs. The capture
    itself fails if a call reads the device from the host or allocates
    outside PyTorch's allocator."""
    name = str(dtype).replace("torch.", "")
    paged = paged_case(device, dtype)
    flash = flash_case(device, dtype, *FLASH_CASES["B8 T512 (B,) n_valid"])
    for kernel, plain, args, change in (
            (dk.paged_decode_attention, dk.paged_decode_attention_ref, paged,
             lambda a: (a[3].copy_(a[3].roll(1, 0)),
                        a[4].copy_(a[4].roll(1, 0)))),
            (dk.flash_decode, dk.flash_decode_ref, flash,
             lambda a: a[3].copy_(a[3].flip(0) - 1))):
        kernel(*args)
        torch.cuda.synchronize()
        graphs, outs = [torch.cuda.CUDAGraph() for _ in range(2)], []
        for graph in graphs:
            with torch.cuda.graph(graph):
                outs.append(kernel(*args))
        change(args)
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream(device) for _ in graphs]
        for graph, stream in zip(graphs, streams):
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        want = plain(*args)
        for i, out in enumerate(outs):
            check(f"{kernel.__name__} {name} CUDA graph {i + 1} of 2 replayed "
                  f"beside the other after n_valid and the table changed in "
                  f"place", out, want, tol)
        del graphs


def wide_graphs(device, dtype, tol):
    """Kernel 10 captured in two CUDA graphs, at Q 5 and Q 64 (one call
    each, after a warm-up call outside them), then n_base and the page
    table changed in place and both graphs replayed one after the other:
    each output must equal the plain version on the changed inputs. The
    wrapper's workspace and its second (combine) kernel must land in the
    graph, on the capture's stream."""
    name = str(dtype).replace("torch.", "")
    cases = [wide_case(device, dtype, Q) for Q in (WIDE_Q[0], WIDE_Q[-1])]
    for args in cases:
        dk.paged_decode_attention_wide(*args)
    torch.cuda.synchronize()
    graphs, outs = [torch.cuda.CUDAGraph() for _ in cases], []
    for graph, args in zip(graphs, cases):
        with torch.cuda.graph(graph):
            outs.append(dk.paged_decode_attention_wide(*args))
    for args in cases:
        args[3].copy_(args[3].roll(1, 0))
        args[4].copy_(args[4].roll(1, 0))
    torch.cuda.synchronize()
    for graph in graphs:
        graph.replay()
    torch.cuda.synchronize()
    for args, out in zip(cases, outs):
        check(f"paged_decode_attention_wide {name} Q {args[0].shape[1]}, "
              f"CUDA graph replayed after n_base and the table changed in "
              f"place", out, dk.paged_decode_attention_wide_ref(*args), tol)
    del graphs


def decode_streams(device, dtype, tol):
    """Kernels 8 and 9 called on two streams at once, four calls each
    interleaved: the merge's arrival counters are the stream's, so every
    output must equal the plain version."""
    name = str(dtype).replace("torch.", "")
    paged = paged_case(device, dtype)
    flash = flash_case(device, dtype, *FLASH_CASES["B8 T512 (B,) n_valid"])
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    for kernel, plain, args in (
            (dk.paged_decode_attention, dk.paged_decode_attention_ref, paged),
            (dk.flash_decode, dk.flash_decode_ref, flash)):
        want = plain(*args)
        outs = []
        for stream in streams:
            stream.wait_stream(torch.cuda.current_stream(device))
        for _ in range(4):
            for stream in streams:
                with torch.cuda.stream(stream):
                    outs.append(kernel(*args))
        torch.cuda.synchronize()
        check(f"{kernel.__name__} {name}, 8 calls on two streams at once",
              torch.stack(outs), want.expand(len(outs), *want.shape), tol)


def check_rel(label, got, want, tol):
    """max |got - want| within `tol` of the largest |want|."""
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    print(f"  {label}: max_abs_err {err:.3e} (tolerance {tol:g} x max "
          f"|reference| {top:.3e})")
    if not (err <= tol * top and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


# (B, H, T, D, causal, model layout): the training shape first; then the
# padded head dims of the repo's configurations (D 4, 8, 12, and 6, whose
# rows in the model layout allow 4-byte copies in float32 and only
# one-element ones in bfloat16) and D 128
ATTN_CASES = {
    "B8 H8 T512 D64 causal (training)": (8, 8, 512, 64, True, True),
    "B8 H8 T512 D64 non-causal": (8, 8, 512, 64, False, True),
    "B8 H8 T200 D64 causal (ragged)": (8, 8, 200, 64, True, True),
    "B2 H8 T24 D64 non-causal (ragged)": (2, 8, 24, 64, False, True),
    "B2 H4 T200 D16 causal, (B, H, T, D) layout": (2, 4, 200, 16, True,
                                                  False),
    **{f"B2 H4 T200 D{D} causal": (2, 4, 200, D, True, True)
       for D in (4, 6, 8, 12, 128, 160, 256)},
    "B2 H4 T512 D128 causal": (2, 4, 512, 128, True, True),
    "B2 H2 T130 D256 non-causal (ragged)": (2, 2, 130, 256, False, True),
}
# head dims of a few train steps with use_flash: d_model 48 over 4 heads
# (D 12, examples/transformer_generate.py's), 512 over 4 (D 128) and 512
# over 2 (D 256, the padded head dim of its own tile)
HEAD_DIM_STEPS = {12: dict(d_model=48, n_heads=4),
                  128: dict(d_model=512, n_heads=4),
                  256: dict(d_model=512, n_heads=2)}


def attn_case(device, dtype, B, H, T, D, model_layout, seed=5):
    """q, k, v, dO as the kernels get them: (B, H, T, D) views of the
    model's (B, T, H, D) tensors, or contiguous (B, H, T, D)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (B, T, H, D) if model_layout else (B, H, T, D)
    out = [torch.randn(shape, generator=g).to(device, dtype)
           for _ in range(4)]
    return [t.transpose(1, 2) if model_layout else t for t in out]


def flash_against_plain(device, errs):
    """The three flash-attention kernels against their plain versions;
    the backward kernels get the plain forward's o and lse."""
    for dtype, tol in TOL.items():
        name = str(dtype).replace("torch.", "")
        for label, (B, H, T, D, causal, model) in ATTN_CASES.items():
            q, k, v, do = attn_case(device, dtype, B, H, T, D, model)
            o, lse = fl.flash_attention_fwd(q, k, v, causal)
            o_ref, lse_ref = fl.flash_attention_fwd_ref(q, k, v, causal)
            err = max(check(f"flash_attention_fwd {name} {label} o", o,
                            o_ref, tol),
                      check(f"flash_attention_fwd {name} {label} lse", lse,
                            lse_ref, tol))
            delta = fl._delta(o_ref, do)
            args = (q, k, v, do, lse_ref, delta, causal)
            dq = fl.flash_attention_dq(*args)
            dk_got, dv_got = fl.flash_attention_dkv(*args)
            dk_ref, dv_ref = fl.flash_attention_dkv_ref(*args)
            grad_check = check if dtype == torch.float32 else check_rel
            gtol = GRAD_TOL[dtype]
            e_dq = grad_check(f"flash_attention_dq {name} {label}", dq,
                              fl.flash_attention_dq_ref(*args), gtol)
            e_dkv = max(grad_check(f"flash_attention_dkv {name} {label} "
                                   f"dk", dk_got, dk_ref, gtol),
                        grad_check(f"flash_attention_dkv {name} {label} "
                                   f"dv", dv_got, dv_ref, gtol))
            if dtype == torch.float32:
                for kernel, e in (("flash_attention_fwd", err),
                                  ("flash_attention_dq", e_dq),
                                  ("flash_attention_dkv", e_dkv)):
                    errs[kernel] = max(errs[kernel], e)
        flash_deterministic(device, dtype)
    return errs


def flash_deterministic(device, dtype):
    """Two launches of the forward, of the dQ and of the dK/dV kernel on
    the training shape give bit-equal o, lse and gradients (no atomics,
    fixed summation order)."""
    B, H, T, D, causal, _ = ATTN_CASES["B8 H8 T512 D64 causal (training)"]
    q, k, v, do = attn_case(device, dtype, B, H, T, D, True)
    o, lse = fl.flash_attention_fwd_ref(q, k, v, causal)
    args = (q, k, v, do, lse, fl._delta(o, do), causal)

    def launch():
        return (*fl.flash_attention_fwd(q, k, v, causal),
                fl.flash_attention_dq(*args), *fl.flash_attention_dkv(*args))

    first, again = launch(), launch()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), first, again):
        if not torch.equal(a, b):
            raise AssertionError(f"flash {name} differs between two launches "
                                 f"({dtype})")
    print(f"  flash_attention_fwd / _dq / _dkv {str(dtype)[6:]} training "
          f"shape: o, lse, dq, dk, dv bit-equal across two launches")


def flash_head_dim_steps(device):
    """make_train_step with use_flash at the head dims of HEAD_DIM_STEPS
    (2 layers, vocab 512, batch 2 x 128, 2 steps): finite losses, each
    flash kernel once per layer per step, step 1's loss equal to the dense
    path's at rtol 1e-5."""
    tok, tgt = (torch.from_numpy(np.random.RandomState(seed).randint(
        0, 512, (2, 128)).astype(np.int32)).to(device) for seed in (0, 1))
    for D, widths in HEAD_DIM_STEPS.items():
        cfg = tfm.TransformerConfig(vocab=512, n_layers=2,
                                    d_ff=4 * widths["d_model"], max_len=128,
                                    use_flash=True, **widths)
        losses = {}
        for flash in (True, False):
            step, params = tfm.make_train_step(
                dataclasses.replace(cfg, use_flash=flash), device=device)
            before = [k.launches for k in FLASH_KERNELS]
            losses[flash] = [float(step(params, tok, tgt)[0])
                             for _ in range(2)]
            counts = [k.launches - b for k, b in zip(FLASH_KERNELS, before)]
            if counts != [2 * cfg.n_layers * flash] * 3:
                raise AssertionError(f"head dim {D}: flash kernels launched "
                                     f"{counts} times in 2 steps")
        if not (np.isfinite(losses[True]).all() and np.allclose(
                losses[True][0], losses[False][0], rtol=1e-5, atol=0)):
            raise AssertionError(f"head dim {D}: flash losses "
                                 f"{losses[True]}, dense {losses[False]}")
        print(f"  make_train_step use_flash, head dim {D} (d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads): losses {losses[True]}, "
              f"step 1 equal to dense {losses[False][0]:.6f} (rtol 1e-5)")


# (logits shape, view): the train step's (B·T, V) first, then the JAX
# tests' shapes; "strided" reads rows 32004 elements apart in place,
# "offset" starts each row one element in (so unaligned: the scalar
# path), "transposed" is copied by the wrapper
XENT_CASES = {
    "N4096 V32000 (training)": ((4096, 32000), None),
    "N16 V50": ((16, 50), None),
    "N8 V33": ((8, 33), None),
    "(2, 5, 17) batched, through softmax_xent": ((2, 5, 17), None),
    "N64 V32000 strided rows": ((64, 32000), "strided"),
    "N64 V32000 offset rows": ((64, 32000), "offset"),
    "N64 V4000 transposed": ((64, 4000), "transposed"),
}
XENT_TOL = 1e-5  # loss and lse (tests/test_pallas.py)
XENT_GRAD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: 2e-2}


def xent_case(device, dtype, shape, view, seed=6):
    """Logits (scale 3), labels with -1 and V among them, and a dloss of
    the row shape (a weighted loss, as a mean's gradient is uniform)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    V = shape[-1]
    if view == "transposed":
        logits = torch.randn(shape[::-1], generator=g).to(device, dtype).T
    elif view is None:
        logits = (torch.randn(shape, generator=g) * 3).to(device, dtype)
    else:
        wide = (torch.randn((shape[0], V + 4), generator=g) * 3).to(device,
                                                                    dtype)
        logits = wide[:, :V] if view == "strided" else wide[:, 1:V + 1]
    labels = torch.randint(0, V, shape[:-1], generator=g).reshape(-1)
    labels[0], labels[1] = -1, V  # outside the vocabulary: no column
    dloss = torch.rand(shape[:-1], generator=g)
    return (logits, labels.reshape(shape[:-1]).to(device, torch.int32),
            dloss.to(device))


def xent_against_plain(device, errs):
    """The softmax-xent forward and backward kernels against their plain
    versions; the backward gets the plain forward's lse. The batched case
    runs the autograd Function (kernels) against the plain versions on
    the flattened rows."""
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for label, (shape, view) in XENT_CASES.items():
            logits, labels, dloss = xent_case(device, dtype, shape, view)
            flat = logits.reshape(-1, shape[-1])
            lab, dl = labels.reshape(-1), dloss.reshape(-1)
            loss_ref, lse_ref = xt.softmax_xent_fwd_ref(flat, lab)
            g_ref = xt.softmax_xent_bwd_ref(flat, lab, lse_ref, dl)
            if view is None and len(shape) > 2:
                leaf = logits.detach().clone().requires_grad_(True)
                loss = xt.softmax_xent(leaf, labels)
                g = torch.autograd.grad(loss, leaf, dloss)[0]
                loss, g = loss.detach().reshape(-1), g.reshape(flat.shape)
                lse = lse_ref
            else:
                loss, lse = xt.softmax_xent_fwd(flat, lab)
                g = xt.softmax_xent_bwd(flat, lab, lse_ref, dl)
            e_fwd = max(check(f"softmax_xent_fwd {name} {label} loss", loss,
                              loss_ref, XENT_TOL),
                        check(f"softmax_xent_fwd {name} {label} lse", lse,
                              lse_ref, XENT_TOL))
            if g.dtype != dtype or loss.dtype != torch.float32:
                raise AssertionError(f"softmax_xent {name} {label}: loss "
                                     f"{loss.dtype}, dlogits {g.dtype}")
            if dtype == torch.float32:
                rtol, atol = XENT_GRAD_TOL[dtype]
                e_bwd = check(f"softmax_xent_bwd {name} {label} dlogits", g,
                              g_ref, rtol, atol)
                errs["softmax_xent_fwd"] = max(errs["softmax_xent_fwd"],
                                               e_fwd)
                errs["softmax_xent_bwd"] = max(errs["softmax_xent_bwd"],
                                               e_bwd)
            else:
                check_rel(f"softmax_xent_bwd {name} {label} dlogits", g,
                          g_ref, XENT_GRAD_TOL[dtype])
    return errs


# (R, C, residual) per case: ragged R at C 64 and 2048 (both variants),
# C 67 for the one-element path, then the ResNet-50 shapes at batch 128:
# the stem (plain), the stage-1 join and the stage-4 join (residual)
EPI_CASES = {
    "ragged R1001 C64": (1001, 64), "ragged R1001 C2048": (1001, 2048),
    "R999 C67 (scalar loads)": (999, 67),
    "stem R1605632 C64": (128 * 112 * 112, 64),
    "stage-1 join R401408 C256": (128 * 56 * 56, 256),
    "stage-4 join R6272 C2048": (128 * 7 * 7, 2048),
}
EPI_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}  # forward
EPI_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # dx, dres
EPI_SUM_ROWS = 75  # rows of tests/test_memory_traffic.py's gradient check


def epi_case(device, dtype, R, C, residual, seed=7, offset=0):
    """x, scale (0.5-1.5), shift, residual and dy, drawn on the device;
    with `offset` the activations are views one element into their
    buffers (no 16-byte alignment)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def act():
        flat = torch.randn(R * C + offset, generator=g, device=device)
        return flat.to(dtype)[offset:].view(R, C)

    x = act()
    scale = torch.rand(C, generator=g, device=device) + 0.5
    shift = torch.randn(C, generator=g, device=device)
    res = act() if residual else None
    return x, scale, shift, res, act()


def epi_grad_tol(out, dtype, R):
    """(rtol, atol) of one backward output: dx and dres at the JAX
    tolerance; the channel sums at rtol 1e-4 and atol 1e-4 * sqrt(R / 75)
    (see epilogue_against_plain)."""
    if out in ("dscale", "dshift"):
        return 1e-4, 1e-4 * math.sqrt(max(R / EPI_SUM_ROWS, 1.0))
    return EPI_GRAD_TOL[dtype], EPI_GRAD_TOL[dtype]


def epilogue_against_plain(device, errs):
    """Kernels 6 and 7 against their plain versions, float32 and bfloat16,
    with and without the residual, and the backward run twice for bit
    equality (its channel sums take a fixed order). Forward 1e-6 (2e-2
    bfloat16), dx and dres 1e-4 (2e-2): tests/test_memory_traffic.py's.
    The channel sums differ from the plain version's only in the order of
    float32 additions, whose error grows as the square root of the rows
    summed: they are held to 1e-4 scaled by sqrt(R / 75), 1e-4 at the
    75 rows where that test sets it."""
    cases = [(label, R, C, res, 0) for label, (R, C) in EPI_CASES.items()
             for res in (False, True)]
    cases.append(("unaligned R1001 C64", 1001, 64, True, 1))
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for label, R, C, residual, offset in cases:
            x, scale, shift, res, dy = epi_case(device, dtype, R, C,
                                                residual, offset=offset)
            tag = f"{name} {label}{' residual' if residual else ''}"
            y = ep.bn_act_epilogue_fwd(x, scale, shift, res)
            y_ref = ep.bn_act_epilogue_fwd_ref(x, scale, shift, res)
            e_fwd = check(f"bn_act_epilogue_fwd {tag}", y, y_ref,
                          EPI_TOL[dtype])
            got = ep.bn_act_epilogue_bwd(x, scale, y_ref, dy, residual)
            want = ep.bn_act_epilogue_bwd_ref(x, scale, y_ref, dy, residual)
            again = ep.bn_act_epilogue_bwd(x, scale, y_ref, dy, residual)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"bn_act_epilogue_bwd {tag}: two runs "
                                     f"differ")
            e_bwd = 0.0
            for out, a, b in zip(("dx", "dscale", "dshift", "dres"), got,
                                 want):
                if a.dtype != b.dtype:
                    raise AssertionError(f"bn_act_epilogue_bwd {tag} {out}: "
                                         f"{a.dtype}, expected {b.dtype}")
                e_bwd = max(e_bwd, check(f"bn_act_epilogue_bwd {tag} {out}",
                                         a, b, *epi_grad_tol(out, dtype, R)))
            if dtype == torch.float32:
                errs["bn_act_epilogue_fwd"] = max(
                    errs["bn_act_epilogue_fwd"], e_fwd)
                errs["bn_act_epilogue_bwd"] = max(
                    errs["bn_act_epilogue_bwd"], e_bwd)
    # the autograd Function: gradients of x, scale, shift and the residual
    x, scale, shift, res, dy = epi_case(device, torch.float32, 1001, 64,
                                        True)
    leaves = [t.clone().requires_grad_() for t in (x, scale, shift, res)]
    y = ep.bn_act_epilogue(*leaves)
    grads = torch.autograd.grad(y, leaves, dy)
    y_ref = ep.bn_act_epilogue_fwd_ref(x, scale, shift, res)
    want = ep.bn_act_epilogue_bwd_ref(x, scale, y_ref, dy, True)
    for out, a, b in zip(("dx", "dscale", "dshift", "dres"), grads, want):
        check(f"bn_act_epilogue autograd {out}", a, b,
              *epi_grad_tol(out, torch.float32, 1001))
    return errs


def kernels_against_plain(device):
    """Phase 2. Returns {kernel: max abs err in float32}."""
    errs = {"paged_decode_attention": 0.0, "flash_decode": 0.0,
            "paged_decode_attention_wide": 0.0, "flash_attention_fwd": 0.0,
            "flash_attention_dq": 0.0, "flash_attention_dkv": 0.0,
            "softmax_xent_fwd": 0.0, "softmax_xent_bwd": 0.0,
            "bn_act_epilogue_fwd": 0.0, "bn_act_epilogue_bwd": 0.0}
    for dtype, tol in TOL.items():
        name = str(dtype).replace("torch.", "")
        for kernel, err in decode_against_plain(device, dtype, tol).items():
            if dtype == torch.float32:
                errs[kernel] = max(errs[kernel], err)
        decode_deterministic(device, dtype)
        decode_graphs(device, dtype, tol)
        decode_streams(device, dtype, tol)
        for Q, head in WIDE_CASES:
            for label, make in (("ragged, rows past the table", wide_case),
                                ("recycled pages", wide_recycled_case)):
                err = wide_against_plain(f"{name} Q {Q} H{head['H']} "
                                         f"D{head['D']} {label}",
                                         make(device, dtype, Q, **head), tol)
                if dtype == torch.float32:
                    errs["paged_decode_attention_wide"] = max(
                        errs["paged_decode_attention_wide"], err)
        wide_deterministic(device, dtype)
        wide_graphs(device, dtype, tol)
    errs = xent_against_plain(device, flash_against_plain(device, errs))
    flash_head_dim_steps(device)
    return epilogue_against_plain(device, errs)


# -- phase 3: the serving path at full width --------------------------------

# the levers that configure the engine (the rest shape the trace)
ENGINE_LEVERS = ("prefix_cache", "prefill_chunk", "spec_ngram",
                 "spec_lookahead")


def serve(cfg, params, n_requests, device, **levers):
    """Serve the seeded trace with `levers` (none: the levers off) on an
    engine whose every site `warm()` captured into a CUDA graph first, so
    the run captures nothing: steady and warm-up-wave compiles and
    retraces must all be 0. The paged and wide kernels' launches are
    counted from zero over exactly this run; each must equal the engine's
    calls of its step x layers, and equal the launches each graph of the
    sites holds x that graph's replays in the run (so no launch was
    eager). `device_launches` counts them again, from the device's own
    kernel records."""
    eng = ServingEngine(params, cfg, slots=SLOTS, page_size=PAGE,
                        device=device, **{k: v for k, v in levers.items()
                                          if k in ENGINE_LEVERS})
    t0 = time.perf_counter()
    warm = eng.warm()
    warm_s = time.perf_counter() - t0
    if set(warm.values()) != {"captured"}:
        raise AssertionError(f"warm() did not capture every site: {warm}")
    replays0 = {name: site.replays for name, site in eng.sites().items()}
    replayed0 = {name: site.replayed_launches()
                 for name, site in eng.sites().items()}
    kernels = {"paged": dk.paged_decode_attention,
               "wide": dk.paged_decode_attention_wide}
    for kernel in kernels.values():
        kernel.launches = 0
    out = run_trace(params, cfg, n_requests=n_requests, seed=0, engine=eng,
                    **{k: v for k, v in levers.items()
                       if k not in ENGINE_LEVERS})
    out["launches"] = {k: kernel.launches for k, kernel in kernels.items()}
    sites = eng.sites()
    out["sites"] = {name: {"capture_s": sum(site.capture_seconds.values()),
                           "replays": site.replays - replays0.get(name, 0)}
                    for name, site in sites.items()}
    replayed = {}
    for name, site in sites.items():
        for kernel, n in site.replayed_launches().items():
            replayed[kernel] = (replayed.get(kernel, 0) + n
                                - replayed0.get(name, {}).get(kernel, 0))
    out.update(engine=eng, warm=warm, warm_s=warm_s,
               pool_bytes=sum(site.pool_bytes for site in sites.values()))
    for key in ("steady_compiles", "steady_retraces", "warmup_compiles",
                "dense_fallbacks"):
        if out[key] != 0:
            raise AssertionError(f"{key} is {out[key]} after warm()")
    if out["requests_completed"] != n_requests:
        raise AssertionError(f"{out['requests_completed']} of {n_requests} "
                             f"requests completed")
    for r in out["trace"]:
        if len(out["results"][r["rid"]].tokens) != r["max_new"]:
            raise AssertionError(f"request {r['rid']} stopped early")
    for key, calls, what in (("paged", out["decode_steps"], "decode steps"),
                             ("wide", out["wide_calls"], "wide steps")):
        want = calls * cfg.n_layers
        in_graphs = replayed.get(kernels[key].__name__, 0)
        if not out["launches"][key] == in_graphs == want:
            raise AssertionError(
                f"{key} kernel launched {out['launches'][key]} times, "
                f"{in_graphs} of them in graph replays; expected {want} "
                f"({what} x layers), all replayed")
    used = "wide" if levers else "paged"
    if not out["launches"][used]:
        raise AssertionError(f"the {used} kernel never ran on this path")
    return out


# the kernel function each counted wrapper launches once per call (the
# wide wrapper's combine kernel is not counted)
DEVICE_KERNELS = {"paged": "decode_split_kernel",
                  "wide": "paged_decode_wide_kernel"}


def device_launches(cfg, out, events, leg):
    """A graphed trace's paged and wide launches counted a second way,
    independent of the wrappers' counts a replay adds: from the kernel
    records of the profiler window `events` ({device event name: count})
    the run `out` was traced in. Each must equal the engine's steps x
    layers, and the wrappers' counts over the same run."""
    counted = {"paged": dk.paged_decode_attention.launches,
               "wide": dk.paged_decode_attention_wide.launches}
    seen = {key: sum(n for name, n in events.items() if frag in name)
            for key, frag in DEVICE_KERNELS.items()}
    want = {"paged": out["decode_steps"] * cfg.n_layers,
            "wide": out["wide_calls"] * cfg.n_layers}
    print(f"    levers {leg}: the device ran {seen} paged / wide kernels "
          f"in the window; wrappers counted {counted}; layers x steps "
          f"{want}")
    if not seen == counted == want:
        raise AssertionError(f"levers {leg}: device kernel records {seen}, "
                             f"wrapper counts {counted}, expected {want} "
                             f"(layers x steps)")


def traced_chains(cfg, params, eng, trace_dir):
    """Serve the trace once more on `eng` with MXTPU_TRACE_DIR set: the
    MXTRACE1 file must parse with the port's own reader, and every request
    of the run must have one complete causal chain (its root, its queued,
    prefill and, past one token, decode stages under the root, one
    req_step entry per decode step) whose figures equal its result."""
    shutil.rmtree(trace_dir, ignore_errors=True)
    before = set(eng.results())
    os.environ["MXTPU_TRACE_DIR"] = trace_dir
    tdist.refresh_from_env()
    try:
        out = run_trace(params, cfg, n_requests=16, seed=0, engine=eng)
    finally:
        del os.environ["MXTPU_TRACE_DIR"]
        tdist.refresh_from_env()  # flushes and closes the trace file
    files = [os.path.join(trace_dir, f) for f in sorted(os.listdir(trace_dir))
             if f.endswith(".mxtrace")]
    records = [rec for f in files for rec in tdist.read_trace_file(f)]
    results = {rid: res for rid, res in out["results"].items()
               if rid not in before}
    roots = {r["extra"]["request"]: r for r in records
             if r.get("name") == "serving.request"}
    if set(roots) != set(results):
        raise AssertionError(f"trace roots {sorted(roots)} != requests "
                             f"{sorted(results)}")
    steps = [r for r in records if r.get("kind") == "req_step"]
    for rid, res in results.items():
        root = roots[rid]
        stages = {r["name"]: r for r in records
                  if r.get("name", "").startswith("serving.request.")
                  and r["extra"].get("request") == rid}
        want = {"serving.request.queued", "serving.request.prefill"}
        if len(res.tokens) > 1:
            want.add("serving.request.decode")
        progressed = sum(1 for r in steps for slot in r["slots"]
                         if slot[0] == rid)
        if (set(stages) != want
                or any(st["tid"] != root["tid"] or st["pid"] != root["sid"]
                       for st in stages.values())
                or root["extra"]["tokens"] != len(res.tokens)
                or root["extra"]["finish"] != res.finish_reason
                or progressed != len(res.tokens) - 1):
            raise AssertionError(f"request {rid}: broken trace chain "
                                 f"{sorted(stages)}, {progressed} steps")
    return len(files), len(records), len(results)


def top2_margin(params, cfg, seq):
    logits, _ = tfm.apply(params, seq[None], cfg)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def match_generate(cfg, params, served, device):
    """Every request's tokens against generate(use_flash=True), counting
    the flash_decode kernel's launches from zero over these calls."""
    flash_cfg = dataclasses.replace(cfg, use_flash=True)
    dk.flash_decode.launches = 0
    expected, ties = 0, 0
    for r in served["trace"]:
        got = served["results"][r["rid"]].tokens
        ref = tfm.generate(params, r["prompt"][None], len(got), flash_cfg,
                           device=device)[0].tolist()
        expected += (len(got) - 1) * cfg.n_layers
        if got == ref:
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
        seq = torch.as_tensor(np.concatenate([r["prompt"], ref[:i]]),
                              device=device)
        margin = top2_margin(params, cfg, seq)
        if margin >= NEAR_TIE:
            raise AssertionError(
                f"request {r['rid']}: token {i} is {got[i]}, generate() "
                f"gives {ref[i]} (top-2 margin {margin:.3e})")
        ties += 1
        print(f"  request {r['rid']}: near tie at token {i} (top-2 margin "
              f"{margin:.3e} < {NEAR_TIE:g}); rest of it not compared")
    if dk.flash_decode.launches != expected:
        raise AssertionError(f"flash_decode launched "
                             f"{dk.flash_decode.launches} times, expected "
                             f"{expected}")
    return dk.flash_decode.launches, ties


# -- phase 4: training at full width ----------------------------------------

FLASH_KERNELS = (fl.flash_attention_fwd, fl.flash_attention_dq,
                 fl.flash_attention_dkv)


def train_batch(cfg, device):
    """Tokens and targets as tools/bench_transformer.py draws them."""
    rng = np.random.RandomState(0)
    shape = (TRAIN["batch"], TRAIN["seq"])
    tok = rng.randint(0, cfg.vocab, shape).astype(np.int32)
    tgt = rng.randint(0, cfg.vocab, shape).astype(np.int32)
    return torch.from_numpy(tok).to(device), torch.from_numpy(tgt).to(device)


def run_steps(cfg, device, steps, per_step):
    """`steps` steps of make_train_step on the seeded batch, the launches
    of each kernel in `per_step` ({wrapper: launches per step}) counted
    from zero over exactly those steps; any other count in any step fails.
    Returns (step, params, batch, losses, launches)."""
    tok, tgt = batch = train_batch(cfg, device)
    step, params = tfm.make_train_step(cfg, lr=TRAIN["lr"],
                                       aux_weight=TRAIN["aux_weight"],
                                       device=device)
    for kernel in per_step:
        kernel.launches = 0
    losses = []
    for i in range(steps):
        before = {k: k.launches for k in per_step}
        losses.append(step(params, tok, tgt)[0])
        for k, want in per_step.items():
            if k.launches - before[k] != want:
                raise AssertionError(f"{k.__name__} launched "
                                     f"{k.launches - before[k]} times in step "
                                     f"{i + 1}, expected {want}")
    launches = {k.__name__: k.launches for k in per_step}
    losses = torch.stack(losses).tolist()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    print(f"  loss after step 1: {losses[0]:.6f}; after step {steps}: "
          f"{losses[-1]:.6f}; launches {launches}")
    return step, params, batch, losses, launches


def grads_match(cfg, other, batch, device, what):
    """One step's gradients of loss_fn (init_params seed 0) under `cfg`
    against `other` for every parameter, at rtol 2e-4, atol 1e-5."""
    tok, tgt = batch
    grads = []
    for c in (cfg, other):
        p = tfm.init_params(c, seed=0, device=device)
        for w in p.values():
            w.requires_grad_(True)
        loss = tfm.loss_fn(p, tok, tgt, c, TRAIN["aux_weight"])
        grads.append(dict(zip(p, torch.autograd.grad(loss,
                                                     list(p.values())))))
    worst = 0.0
    for name, g in grads[0].items():
        d = grads[1][name]
        err = float((g - d).abs().max())
        if not torch.allclose(g, d, rtol=2e-4, atol=1e-5):
            raise AssertionError(f"gradient of {name}: {what} differ beyond "
                                 f"rtol 2e-4, atol 1e-5 (max abs diff "
                                 f"{err:.3e})")
        worst = max(worst, err)
    print(f"  one step's gradients agree ({what}) for all {len(grads[0])} "
          f"parameters (rtol 2e-4, atol 1e-5; max abs diff {worst:.3e})")


def train(cfg, device):
    """Phase 4, the flash leg: `TRAIN["steps"]` steps of make_train_step
    with use_flash, each flash kernel once per layer per step; then the
    dense path (apply resolves attention to `_dense_attention` without
    use_flash) for the first 3 losses and one step's gradients. Returns
    (step, params, batch, losses, launches)."""
    step, params, batch, losses, launches = run_steps(
        cfg, device, TRAIN["steps"], {k: cfg.n_layers for k in FLASH_KERNELS})
    tok, tgt = batch
    dense_cfg = dataclasses.replace(cfg, use_flash=False)
    dstep, dparams = tfm.make_train_step(dense_cfg, lr=TRAIN["lr"],
                                         aux_weight=TRAIN["aux_weight"],
                                         device=device)
    dense = torch.stack([dstep(dparams, tok, tgt)[0]
                         for _ in range(3)]).tolist()
    del dstep, dparams
    if not np.allclose(losses[:3], dense, rtol=1e-5, atol=0):
        raise AssertionError(f"flash losses {losses[:3]} differ from dense "
                             f"{dense} beyond rtol 1e-5")
    print(f"  first 3 losses equal the dense path's (rtol 1e-5): flash "
          f"{losses[:3]}, dense {dense}")
    grads_match(cfg, dense_cfg, batch, device, "flash and dense")
    return step, params, batch, losses, launches


XENT_KERNELS = (xt.softmax_xent_fwd, xt.softmax_xent_bwd)
MOE = dict(n_experts=4, steps=5)  # examples/multi_axis_parallel.py's 4
NEAR_TIE_PROB = 1e-5  # top-2 router probability gap of a routing near tie


def path_kernels(cfg):
    """{wrapper: launches per train step} of a use_flash, use_fused_xent
    step: each flash kernel once per layer, each xent kernel once."""
    return {**{k: cfg.n_layers for k in FLASH_KERNELS},
            **{k: 1 for k in XENT_KERNELS}}


def train_fused(cfg, flash_losses, device):
    """Phase 4, the fused leg: the flash leg's model with use_fused_xent;
    its first 3 losses must equal the flash leg's (dense xent) at rtol
    1e-5, one step's gradients that leg's at rtol 2e-4, atol 1e-5.
    Returns (step, params, batch, launches)."""
    step, params, batch, losses, launches = run_steps(
        cfg, device, TRAIN["steps"], path_kernels(cfg))
    if not np.allclose(losses[:3], flash_losses[:3], rtol=1e-5, atol=0):
        raise AssertionError(f"fused-xent losses {losses[:3]} differ from "
                             f"the dense-xent leg's {flash_losses[:3]} beyond "
                             f"rtol 1e-5")
    print(f"  first 3 losses equal the dense-xent leg's (rtol 1e-5): fused "
          f"{losses[:3]}, dense xent {flash_losses[:3]}")
    grads_match(cfg, dataclasses.replace(cfg, use_fused_xent=False), batch,
                device, "fused and dense xent")
    return step, params, batch, launches


def moe_layer_input(params, cfg, tok):
    """Layer 0's FFN input, ln2(x) flattened to (B·T, d), as the train
    step computes it (flash attention)."""
    B, T = tok.shape
    x = params["embed"][tok.long()] + params["pos"][:T][None]
    lp = tfm._layer_params(params, 0)
    h = tfm._ln(x, lp["ln1_g"], lp["ln1_b"])
    q, k, v = (tfm._split_heads(h @ lp[w], cfg.n_heads)
               for w in ("wq", "wk", "wv"))
    a = tfm._flash_attention_fn(q, k, v)
    x = x + a.reshape(B, T, cfg.d_model) @ lp["wo"]
    return tfm._ln(x, lp["ln2_g"], lp["ln2_b"]).reshape(B * T, -1), lp


def moe_card_against_cpu(params, cfg, tok):
    """One layer's moe_ffn on the card at its full-width input against the
    same call on the CPU: routing (expert and keep) identical but for
    near ties (top-2 probability gap < NEAR_TIE_PROB, counted), every
    other token's output and the balance loss at 1e-4."""
    with torch.no_grad():
        h, lp = moe_layer_input(params, cfg, tok)
        args = (h, lp["router"], lp["w1"], lp["w2"])
        out, aux = moe.moe_ffn(*args)
        out_c, aux_c = moe.moe_ffn(*(a.cpu() for a in args))
        N, E = h.shape[0], cfg.n_experts
        C = max(1, int(2.0 * N / E))
        routes = []
        for a in (args, [a.cpu() for a in args]):
            probs = torch.softmax(a[0] @ a[1], dim=-1)
            disp = moe.moe_dispatch(a[0], a[1], E, C)[0]
            routes.append((probs.argmax(-1).cpu(),
                           (disp.sum((1, 2)) > 0).cpu(), probs.cpu()))
    (ex, keep, _), (ex_c, keep_c, probs_c) = routes
    top2 = torch.topk(probs_c, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    differ = (ex != ex_c) | (keep != keep_c)
    if (gap[differ] >= NEAR_TIE_PROB).any():
        bad = torch.nonzero(differ & (gap >= NEAR_TIE_PROB))[:, 0]
        raise AssertionError(f"tokens {bad.tolist()[:10]} route differently "
                             f"on the card and the CPU with top-2 gaps "
                             f"{gap[bad].tolist()[:10]}")
    ties = int((gap < NEAR_TIE_PROB).sum())
    print(f"  moe_ffn layer 0, {N} tokens, E {E}, C {C}: {int(keep.sum())} "
          f"kept on the card, {int(keep_c.sum())} on the CPU; "
          f"{int(differ.sum())} tokens route differently, {ties} near ties "
          f"(top-2 gap < {NEAR_TIE_PROB:g})")
    same = ~differ
    check(f"moe_ffn card against CPU, {int(same.sum())} tokens routed alike",
          out.cpu()[same], out_c[same], 1e-4)
    check("moe_ffn balance loss, card against CPU", aux.cpu(), aux_c, 1e-4)


def train_moe(cfg, device):
    """Phase 4, the moe leg: the same widths with experts, flash and the
    fused xent, `MOE["steps"]` steps; finite losses, a positive balance
    loss, and one layer's moe_ffn on the card against the CPU. Returns
    (step, params, batch, launches)."""
    step, params, batch, losses, launches = run_steps(
        cfg, device, MOE["steps"], path_kernels(cfg))
    with torch.no_grad():
        aux = float(tfm.apply(params, batch[0], cfg)[1])
    if not aux > 0:
        raise AssertionError(f"balance loss {aux} is not positive")
    print(f"  balance loss after {MOE['steps']} steps: {aux:.6f}")
    moe_card_against_cpu(params, cfg, batch[0])
    return step, params, batch, launches


# bench.py's headline setup: ResNet-50 v1, NHWC, float32, batch 128 at
# 224 x 224, 1000 classes, Xavier, SGD(lr 0.05, momentum 0.9, wd 1e-4,
# rescale_grad 1/128)
RESNET = dict(batch=128, image=224, classes=1000, steps=10, seed=0)
RESNET_SGD = dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
                  rescale_grad=1.0 / 128)
EPI_KERNELS = (ep.bn_act_epilogue_fwd, ep.bn_act_epilogue_bwd)
EPI_PER_STEP = 49  # the stem + 3 per bottleneck unit x 16 units


def resnet_batch(device):
    """Images and labels as bench.py draws them on the host: rand NCHW
    transposed to NHWC, integer labels as float32, from RandomState(0)."""
    B, S = RESNET["batch"], RESNET["image"]
    rng = np.random.RandomState(0)
    x = np.ascontiguousarray(rng.rand(B, 3, S, S).astype(np.float32)
                             .transpose(0, 2, 3, 1))
    y = rng.randint(0, RESNET["classes"], size=B).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


RESNET_LOSS = tmx.gluon.loss.SoftmaxCrossEntropyLoss()


def resnet_loss(net, x, y):
    return RESNET_LOSS(net(x), y)


def resnet50(x, device):
    """ResNet-50 v1 drawn from the seeded generator, its shapes resolved by
    a predict-mode forward of two images."""
    net = vision.resnet50_v1(classes=RESNET["classes"], layout="NHWC")
    net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                   .manual_seed(RESNET["seed"])),
                   device=device)
    with torch.no_grad():
        net(x[:2])
    return net


def exact_grads(batch, device):
    """The float64 gradient of the unfused path at the legs' first weights
    and batch: the yardstick of both float32 legs' gradients."""
    os.environ["MXTPU_FUSED_EPILOGUE"] = "0"
    x, y = batch
    net = resnet50(x, device)
    net.cast("float64")
    grads = resnet_grads(net, x.double(), y)
    del net
    torch.cuda.empty_cache()
    return grads


def resnet_grads(net, x, y):
    """{name without the net's prefix: gradient} of mean(loss) in training
    mode at the net's current weights; the running stats this forward
    moves are put back."""
    params = net.collect_params()
    stats = {n: p.data().clone() for n, p in params.items()
             if p.grad_req == "null"}
    net.train()
    loss = resnet_loss(net, x, y)
    loss = loss.to(torch.promote_types(loss.dtype, torch.float32)).mean()
    net.train(False)
    names = [n for n, p in params.items() if p.grad_req != "null"]
    grads = torch.autograd.grad(loss, [params[n].data() for n in names])
    with torch.no_grad():
        for n, v in stats.items():
            params[n].data().copy_(v)
    return {n[len(net.prefix):]: g for n, g in zip(names, grads)}


def train_resnet(fused, batch, device):
    """Phase 4, a ResNet-50 leg with MXTPU_FUSED_EPILOGUE on (`fused`) or
    off: the net drawn from a seeded generator, its shapes resolved by one
    predict-mode forward, one step's gradients taken, then
    `RESNET["steps"]` steps of GluonTrainStep; the fused leg must launch
    each epilogue kernel EPI_PER_STEP times per step, the unfused leg
    neither. Returns a dict of the leg's net, step, losses, gradients,
    launches and rewrites per step."""
    os.environ["MXTPU_FUSED_EPILOGUE"] = "1" if fused else "0"
    x, y = batch
    net = resnet50(x, device)
    grads = resnet_grads(net, x, y)
    step = GluonTrainStep(net, resnet_loss, tmx.optimizer.SGD(**RESNET_SGD),
                          device=device)
    want = EPI_PER_STEP if fused else 0
    for k in EPI_KERNELS:
        k.launches = 0
    rewrite.rewrites_applied = 0
    losses = []
    for i in range(RESNET["steps"]):
        before = [k.launches for k in EPI_KERNELS]
        losses.append(step(x, y))
        for k, b in zip(EPI_KERNELS, before):
            if k.launches - b != want:
                raise AssertionError(f"{k.__name__} launched "
                                     f"{k.launches - b} times in step "
                                     f"{i + 1}, expected {want}")
    launches = {k.__name__: k.launches for k in EPI_KERNELS}
    rewrites = rewrite.rewrites_applied / RESNET["steps"]
    losses = torch.stack(losses).tolist()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    print(f"  loss after step 1: {losses[0]:.6f}; after step "
          f"{RESNET['steps']}: {losses[-1]:.6f}; launches {launches}; "
          f"rewrites per step {rewrites:g}")
    return dict(net=net, step=step, losses=losses, grads=grads,
                launches=launches, rewrites=rewrites)


def grad_distance(grads, exact):
    """The float64 2-norm of grads - exact over every trained parameter."""
    return math.sqrt(sum(float(((grads[n].double() - g) ** 2).sum())
                         for n, g in exact.items()))


def resnet_legs(device):
    """Phase 4's ResNet-50 legs, unfused then fused on the same weights and
    batch. Step 1's loss must agree at rtol 1e-5, atol 1e-6
    (tests/test_memory_traffic.py); every loss must be finite, and the
    largest relative loss gap over the steps is printed, not bounded
    (later steps follow two float32 trajectories).

    Step 1's gradients are held to the float64 gradient of the unfused
    path at the same weights: the fused leg's distance to it (2-norm over
    all trained parameters) must be at most twice the unfused leg's. At
    this initialization float32 itself puts the early layers' gradients
    a few per cent off the float64 values, in the JAX package as in the
    port, so two float32 orderings cannot agree at rtol 2e-4; how many
    parameters do is printed. That tolerance holds one full-width BN ->
    ReLU (-> add) layer instead (`bn_layer_check`)."""
    batch = resnet_batch(device)
    legs = {}
    try:
        exact = exact_grads(batch, device)
        for leg, fused in (("unfused", False), ("fused", True)):
            print(f" leg resnet50_v1 {leg} (MXTPU_FUSED_EPILOGUE="
                  f"{int(fused)})")
            legs[leg] = train_resnet(fused, batch, device)
    finally:
        os.environ.pop("MXTPU_FUSED_EPILOGUE", None)
    base, fused = legs["unfused"], legs["fused"]
    if not np.allclose(fused["losses"][0], base["losses"][0], rtol=1e-5,
                       atol=1e-6):
        raise AssertionError(f"step 1 loss: fused {fused['losses'][0]}, "
                             f"unfused {base['losses'][0]}")
    norm = math.sqrt(sum(float((g ** 2).sum()) for g in exact.values()))
    d_base, d_fused = (grad_distance(leg["grads"], exact)
                       for leg in (base, fused))
    if not d_fused <= 2 * d_base:
        raise AssertionError(f"step 1 gradients: the fused leg is "
                             f"{d_fused:.3e} from the float64 gradient, "
                             f"over twice the unfused leg's {d_base:.3e}")
    close = sum(torch.allclose(fused["grads"][n], base["grads"][n],
                               rtol=2e-4, atol=1e-5) for n in exact)
    worst = max(float((fused["grads"][n] - base["grads"][n]).abs().max())
                for n in exact)
    gaps = [abs(a - b) / abs(b) for a, b in zip(fused["losses"],
                                                base["losses"])]
    print(f"  step 1 loss equal (rtol 1e-5): fused {fused['losses'][0]:.7f},"
          f" unfused {base['losses'][0]:.7f}")
    print(f"  step 1 gradients against float64 (2-norm over "
          f"{len(exact)} trained parameters, relative to the gradient's "
          f"{norm:.4e}): unfused {d_base / norm:.3e}, fused "
          f"{d_fused / norm:.3e}; fused against unfused: {close} of "
          f"{len(exact)} parameters within rtol 2e-4, atol 1e-5, max abs "
          f"diff {worst:.3e}")
    print(f"  largest relative loss gap over {len(gaps)} steps "
          f"{max(gaps):.3e} (step {int(np.argmax(gaps)) + 1}); losses "
          f"unfused {[round(v, 6) for v in base['losses']]}, fused "
          f"{[round(v, 6) for v in fused['losses']]}")
    legs["batch"] = batch
    return legs


def bn_layer_check(device):
    """One training-mode BatchNorm -> ReLU (-> add) layer of the ResNet-50
    step at full width, `ops.epilogue.bn_act` with the knob on against
    off on the same seeded inputs (gamma and beta drawn too). y at rtol
    1e-5, atol 1e-5 (the folded affine rounds differently). The two y
    differ by ulps, so an element whose pre-activation lies that close to
    0 may be live in one path and dead in the other: such elements must
    have y below 1e-5 in both and are counted; dx and dres are held at
    rtol 2e-4, atol 1e-5 on every other element, and dgamma and dbeta
    (sums over R rows) at rtol 2e-4 and the channel-sum atol of phase 2
    once the flipped elements' own terms (dy * xhat, dy) are taken out.
    The running stats at 1e-6."""
    for label, (B, H, W, C, residual) in EPI_TIMED.items():
        R = B * H * W
        x, _, _, res, dy = epi_case(device, torch.float32, R, C, residual,
                                    seed=11)
        g = torch.Generator(device=device).manual_seed(12)
        gamma = torch.rand(C, generator=g, device=device) + 0.5
        beta = torch.randn(C, generator=g, device=device)
        out = {}
        try:
            for knob in ("0", "1"):
                os.environ["MXTPU_FUSED_EPILOGUE"] = knob
                norm = tmx.gluon.nn.BatchNorm(axis=-1, in_channels=C)
                norm.initialize(device=device)
                norm.gamma.set_data(gamma)
                norm.beta.set_data(beta)
                norm.train()
                leaves = [x.view(B, H, W, C).detach().requires_grad_(),
                          norm.gamma.data(), norm.beta.data()]
                r = None
                if residual:
                    r = res.view(B, H, W, C).detach().requires_grad_()
                    leaves.append(r)
                y = rewrite.bn_act(norm, leaves[0], r)
                grads = torch.autograd.grad(y, leaves, dy.view(B, H, W, C))
                out[knob] = (y.detach().view(R, C),
                             [t.reshape(-1, C) if t.dim() > 1 else t
                              for t in grads],
                             norm.running_mean.data(),
                             norm.running_var.data())
        finally:
            os.environ.pop("MXTPU_FUSED_EPILOGUE", None)
        (y0, g0, m0, v0), (y1, g1, m1, v1) = out["0"], out["1"]
        tag = f"BN layer {label} R{R} C{C}"
        check(f"{tag} y fused vs unfused", y1, y0, 1e-5)
        live0, live1 = y0 > 0, y1 > 0
        flips = live0 != live1
        kink = float(torch.maximum(y0, y1)[flips].max()) if flips.any() \
            else 0.0
        print(f"  {tag}: {int(flips.sum())} of {R * C} elements live in one "
              f"path only, y at most {kink:.3e} there")
        if kink > 1e-5:
            raise AssertionError(f"{tag}: an element {kink:.3e} above 0 is "
                                 f"live in one path only")
        keep = ~flips
        flip = live1.float() - live0.float()
        mean, var = x.mean(0), x.var(0, unbiased=False)
        xhat = (x - mean) * torch.rsqrt(var + 1e-5)
        terms = {"dgamma": (dy * xhat * flip).sum(0),
                 "dbeta": (dy * flip).sum(0)}
        for name, a, b in zip(("dx", "dgamma", "dbeta", "dres"), g1, g0):
            if name in terms:
                check(f"{tag} {name} (flipped terms out)", a - terms[name],
                      b, 2e-4, epi_grad_tol("dscale", torch.float32, R)[1])
            else:
                check(f"{tag} {name} (elsewhere)", a[keep], b[keep], 2e-4,
                      1e-5)
        check(f"{tag} running mean", m1, m0, 1e-6)
        check(f"{tag} running var", v1, v0, 1e-6)


# -- phase 5: times ----------------------------------------------------------

def device_ms(fn, reps=25, warmup=3, flush=None, sleep_cycles=1_000_000):
    """Median device time of fn() in ms, from CUDA events. Each call
    starts behind a device-side sleep of `sleep_cycles` clocks, long
    enough that the host enqueues all of fn's work before the device
    reaches it, so the events time the device alone; with `flush`, the
    L2 is cold (a buffer larger than the L2 is zeroed first)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(n_valid, T_cap, H, D, elem, B, extra_bytes=0, q_elem=4):
    """Least time for one call on this card: each live key and value row
    read once, q read and the output written once (`q_elem` bytes each),
    against the memory rate; the 4*D operations per row against the
    float32 rate. Returns (ms, "bytes" or "operations")."""
    rows = int(torch.clamp(n_valid.cpu().long(), 0, T_cap).sum())
    nbytes = rows * H * D * 2 * elem + 2 * B * H * D * q_elem + extra_bytes
    ops = 4 * rows * H * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def wide_bound_ms(n_base, Q, cap, H, D, elem, S, extra_bytes=0):
    """Least time for one wide call: each (slot, head) reads the live K/V
    rows its deepest row needs once, q is read and the output written once
    (float32), against the memory rate; 4*D operations per (row, live
    key) pair against the float32 rate. Returns (ms, "bytes" or
    "operations")."""
    nb = n_base.cpu().long().clamp(min=0)
    keys = int(torch.clamp(nb + Q, max=cap).sum())
    pairs = int(torch.clamp(nb[:, None] + torch.arange(1, Q + 1)[None],
                            max=cap).sum())
    nbytes = keys * H * D * 2 * elem + 2 * S * Q * H * D * 4 + extra_bytes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 4 * pairs * H * D / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_rows(errs, launches, flush, device, gpu):
    """Times of each decode kernel at the serving path's shapes, float32
    (the JSON rows) and bfloat16 (pool, q and output)."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        args = paged_case(device, dtype)
        q, kp, _, table, nv = args
        S, H, D = q.shape
        pages_read = int(((nv.long() + PAGE - 1) // PAGE).sum())
        b_ms, b_by = bound_ms(nv, table.shape[1] * PAGE, H, D,
                              kp.element_size(), S,
                              extra_bytes=4 * pages_read + 4 * S,
                              q_elem=q.element_size())
        ms = device_ms(lambda: dk.paged_decode_attention(*args), flush=flush)
        plain = device_ms(lambda: dk.paged_decode_attention_ref(*args),
                          flush=flush)
        print(f"  paged_decode_attention {name} S{S} H{H} D{D} page {PAGE} "
              f"n_valid {nv.tolist()}: kernel {ms * 1e3:.1f} us, plain "
              f"{plain * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}) "
              f"[{gpu}]")
        if dtype == torch.float32:
            rows.append({
                "name": "paged_decode_attention", "route": "cuda",
                "source": DECODE_SOURCE, "replaces": f"{JAX_KERNELS}:719",
                "launches": launches["paged"],
                "max_abs_err": errs["paged_decode_attention"], "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None})

    generate_shape = "B1 T512 n_valid 270 (generate)"
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for label, (B, T, n) in ((generate_shape, (1, 512, 270)),
                                 ("B8 T512 (B,) n_valid",
                                  FLASH_CASES["B8 T512 (B,) n_valid"])):
            fq, fk, fv, fnv = flash_case(device, dtype, B, T, n)
            nv_vec = dk._per_seq_n_valid(fnv, B, device)
            f_ms, f_by = bound_ms(nv_vec, T, 8, 64, fk.element_size(), B,
                                  extra_bytes=0 if isinstance(n, int)
                                  else 4 * B, q_elem=fq.element_size())
            ms = device_ms(lambda: dk.flash_decode(fq, fk, fv, fnv),
                           flush=flush)
            plain = device_ms(lambda: dk.flash_decode_ref(fq, fk, fv, fnv),
                              flush=flush)
            # yardstick only: one library call for the same function, on
            # the transposed cache with a length mask (the port never
            # calls it)
            mask = (torch.arange(T, device=device)[None]
                    < nv_vec[:, None])[:, None, None, :]
            lq, lk, lv = (fq[:, :, None], fk.transpose(1, 2),
                          fv.transpose(1, 2))
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=mask), flush=flush)
            print(f"  flash_decode {name} {label}: kernel {ms * 1e3:.1f} us,"
                  f" plain {plain * 1e3:.1f} us, library {lib * 1e3:.1f} us,"
                  f" bound {f_ms * 1e3:.2f} us ({f_by}) [{gpu}]")
            if label == generate_shape and dtype == torch.float32:
                rows.append({  # the JSON row: generate()'s shape
                    "name": "flash_decode", "route": "cuda",
                    "source": DECODE_SOURCE, "replaces": f"{JAX_KERNELS}:455",
                    "launches": launches["flash"],
                    "max_abs_err": errs["flash_decode"], "ms": ms,
                    "plain_ms": plain, "bound_ms": f_ms, "bound_by": f_by,
                    "library_ms": lib})

    wide = {}
    for dtype in (torch.float32, torch.bfloat16):
        for Q in WIDE_Q:
            q, kp, _, table, nb = args = wide_case(device, dtype, Q)
            S, _, H, D = q.shape
            pages_read = int(((torch.clamp(nb.long() + Q, max=512) + PAGE
                               - 1) // PAGE).sum())
            w_ms, w_by = wide_bound_ms(nb, Q, table.shape[1] * PAGE, H, D,
                                       kp.element_size(), S,
                                       extra_bytes=4 * pages_read + 4 * S)
            ms = device_ms(lambda: dk.paged_decode_attention_wide(*args),
                           flush=flush)
            plain = device_ms(lambda: dk.paged_decode_attention_wide_ref(
                *args), flush=flush)
            print(f"  paged_decode_attention_wide {str(dtype)[6:]} S{S} Q{Q} "
                  f"H{H} D{D} page {PAGE} n_base {nb.tolist()}: kernel "
                  f"{ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, bound "
                  f"{w_ms * 1e3:.2f} us ({w_by}) [{gpu}]")
            if dtype == torch.float32:
                wide[Q] = (ms, plain, w_ms, w_by)
    # the JSON row: speculative verification's Q, the other widths beside
    ms, plain, w_ms, w_by = wide[WIDE_Q[0]]
    rows.append({
        "name": "paged_decode_attention_wide", "route": "cuda",
        "source": DECODE_SOURCE, "replaces": f"{JAX_KERNELS}:808",
        "launches": launches["wide"],
        "max_abs_err": errs["paged_decode_attention_wide"],
        "ms": ms, "plain_ms": plain, "bound_ms": w_ms, "bound_by": w_by,
        "library_ms": None,
        "ms_by_q": {str(Q): t[0] for Q, t in wide.items()},
        "bound_ms_by_q": {str(Q): t[2] for Q, t in wide.items()}})
    return rows


def flash_bound_ms(B, H, T, D, causal, elem, kernel, ops_per_s=None):
    """Least time for one flash-attention kernel call on this card: each
    (B, H, T, D) operand read or written once and each (B, H, T) float32
    statistic (lse; delta) once, against the memory rate; per (query row,
    live key) pair 4*D operations for the forward, 6*D for dQ and 8*D for
    dK/dV, against `ops_per_s` (default: the float32 SIMT rate). Returns
    (ms, "bytes" or "operations")."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    per_pair, tensors, stats = {"flash_attention_fwd": (4, 4, 1),
                                "flash_attention_dq": (6, 5, 2),
                                "flash_attention_dkv": (8, 6, 2)}[kernel]
    nbytes = tensors * B * H * T * D * elem + stats * B * H * T * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = per_pair * D * pairs / (ops_per_s or F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tensor_core_bound(B, H, T, D, causal, elem, kernel):
    """flash_bound_ms at the tensor cores' rate: float32 as three TF32
    products at 495 TFLOP/s, bfloat16 at 989."""
    if elem == 4:
        return flash_bound_ms(B, H, T, D, causal, 4, kernel,
                              TF32_OPS_PER_S / 3)
    return flash_bound_ms(B, H, T, D, causal, elem, kernel, BF16_OPS_PER_S)


MMA_KERNELS = {"flash_attention": ("flash_fwd_kernel", "flash_dq_kernel",
                                    "flash_dkv_kernel"),
               "decode": ("paged_decode_wide_kernel",)}


def mma_counts(lib, kernels):
    """{kernel fragment: (HMMA, HGMMA) instructions in its SASS, summed
    over its variants} from `cuobjdump -sass` of the built library `lib`,
    or None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                        "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return None
    path = _build.build([lib])[lib]["path"]
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, current = {k: [0, 0] for k in kernels}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if k in line), None)
        elif current:
            counts[current][0] += " HMMA." in line
            counts[current][1] += " HGMMA." in line
    return {k: tuple(v) for k, v in counts.items()}


def library_kernels(fn, top_n=6):
    """Names and device time of the kernels one call of fn launches, from
    one torch.profiler window (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] = (kernels.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us())
    return sorted(kernels.items(), key=lambda kv: -kv[1])[:top_n]


FLASH_LINES = {"flash_attention_fwd": 50, "flash_attention_dq": 86,
               "flash_attention_dkv": 116}


def flash_rows(errs, launches, flush, device, gpu):
    """Times of the flash-attention kernels at the training shape
    (float32, the model's layout), each beside its plain version, its
    bound (float32 SIMT, the kernels line's; and at the tensor cores'
    rate) and the library's fused attention: forward alone for the
    forward, backward alone for dQ and dK/dV together (forward +
    backward printed too). Then the three kernels in bfloat16 beside the
    library's bfloat16 forward, the library's backward kernels by name,
    and the tensor-core instructions in the SASS of the flash and wide
    kernels, none of which may have none."""
    B, H, T, D, causal, _ = ATTN_CASES["B8 H8 T512 D64 causal (training)"]
    q, k, v, do = attn_case(device, torch.float32, B, H, T, D, True)
    o, lse = fl.flash_attention_fwd(q, k, v, causal)
    args = (q, k, v, do, lse, fl._delta(o, do), causal)
    calls = {
        "flash_attention_fwd": (lambda: fl.flash_attention_fwd(q, k, v,
                                                               causal),
                                lambda: fl.flash_attention_fwd_ref(
                                    q, k, v, causal)),
        "flash_attention_dq": (lambda: fl.flash_attention_dq(*args),
                               lambda: fl.flash_attention_dq_ref(*args)),
        "flash_attention_dkv": (lambda: fl.flash_attention_dkv(*args),
                                lambda: fl.flash_attention_dkv_ref(*args)),
    }
    # yardsticks only: the port never calls the library's attention
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal), flush=flush)
    lib_fwd_bwd = device_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal),
        (lq, lk, lv), do), flush=flush)
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)

    def lib_backward():
        return torch.autograd.grad(lib_out, (lq, lk, lv), do,
                                   retain_graph=True)

    lib_bwd = device_ms(lib_backward, flush=flush)
    print(f"  scaled_dot_product_attention B{B} H{H} T{T} D{D} causal: "
          f"forward {lib_fwd * 1e3:.1f} us, forward + backward "
          f"{lib_fwd_bwd * 1e3:.1f} us, backward alone {lib_bwd * 1e3:.1f} "
          f"us [{gpu}]")
    print("  its backward's kernels (one profiler window): " + "; ".join(
        f"{us:.1f} us {name[:100]}"
        for name, us in library_kernels(lib_backward)))
    for lib, kernels in MMA_KERNELS.items():
        counts = mma_counts(lib, kernels)
        print(f"  tensor-core instructions in {lib}'s SASS (HMMA, HGMMA): "
              + ("cuobjdump not found" if counts is None else "; ".join(
                  f"{k} {v[0]}, {v[1]}" for k, v in counts.items())))
        if counts is not None and not all(sum(v) for v in counts.values()):
            raise AssertionError(f"a kernel of {lib} has no tensor-core "
                                 f"instruction: {counts}")
    rows = []
    for name, (kernel, plain) in calls.items():
        ms = device_ms(kernel, flush=flush)
        plain_ms = device_ms(plain, flush=flush)
        b_ms, b_by = flash_bound_ms(B, H, T, D, causal, 4, name)
        tc_ms, tc_by = tensor_core_bound(B, H, T, D, causal, 4, name)
        lib = lib_fwd if name == "flash_attention_fwd" else lib_bwd
        print(f"  {name} B{B} H{H} T{T} D{D} causal: kernel "
              f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}, float32 SIMT); tensor-core "
              f"bound {tc_ms * 1e3:.2f} us ({tc_by}, 3 x TF32) [{gpu}]")
        rows.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": f"{JAX_KERNELS}:{FLASH_LINES[name]}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib})
    q, k, v, do = attn_case(device, torch.bfloat16, B, H, T, D, True)
    o, lse = fl.flash_attention_fwd(q, k, v, causal)
    bf_args = (q, k, v, do, lse, fl._delta(o, do), causal)
    lib_bf = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal), flush=flush)
    print(f"  scaled_dot_product_attention bfloat16 B{B} H{H} T{T} D{D} "
          f"causal: forward {lib_bf * 1e3:.1f} us [{gpu}]")
    for name, kernel in (
            ("flash_attention_fwd",
             lambda: fl.flash_attention_fwd(q, k, v, causal)),
            ("flash_attention_dq", lambda: fl.flash_attention_dq(*bf_args)),
            ("flash_attention_dkv",
             lambda: fl.flash_attention_dkv(*bf_args))):
        ms = device_ms(kernel, flush=flush)
        b_ms, b_by = flash_bound_ms(B, H, T, D, causal, 2, name)
        tc_ms, tc_by = tensor_core_bound(B, H, T, D, causal, 2, name)
        print(f"  {name} bfloat16 B{B} H{H} T{T} D{D} causal: kernel "
              f"{ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}, "
              f"float32 SIMT); tensor-core bound {tc_ms * 1e3:.2f} us "
              f"({tc_by}, bfloat16) [{gpu}]")
    flash_wide_head_times(flush, device, gpu)
    return rows


def flash_wide_head_times(flush, device, gpu):
    """The three flash kernels at head dim 256 (D_p 256's own tile), at the
    head-dim-256 model's train shape (d_model 512 over 2 heads, batch 8 x
    seq 512, causal: the training shape's operations), float32 and
    bfloat16, each beside its plain version, its bounds and, for the
    forward, the library's."""
    B, H, T, D, causal = 8, 2, 512, 256, True
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        q, k, v, do = attn_case(device, dtype, B, H, T, D, True)
        o, lse = fl.flash_attention_fwd(q, k, v, causal)
        args = (q, k, v, do, lse, fl._delta(o, do), causal)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), flush=flush)
        for kernel_name, kernel, plain in (
                ("flash_attention_fwd",
                 lambda: fl.flash_attention_fwd(q, k, v, causal),
                 lambda: fl.flash_attention_fwd_ref(q, k, v, causal)),
                ("flash_attention_dq", lambda: fl.flash_attention_dq(*args),
                 lambda: fl.flash_attention_dq_ref(*args)),
                ("flash_attention_dkv", lambda: fl.flash_attention_dkv(*args),
                 lambda: fl.flash_attention_dkv_ref(*args))):
            ms = device_ms(kernel, flush=flush)
            plain_ms = device_ms(plain, flush=flush)
            elem = q.element_size()
            b_ms, b_by = flash_bound_ms(B, H, T, D, causal, elem,
                                        kernel_name)
            tc_ms, tc_by = tensor_core_bound(B, H, T, D, causal, elem,
                                             kernel_name)
            extra = (f", library {lib * 1e3:.1f} us"
                     if kernel_name == "flash_attention_fwd" else "")
            print(f"  {kernel_name} {name} B{B} H{H} T{T} D{D} causal: "
                  f"kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us"
                  f"{extra}, bound {b_ms * 1e3:.2f} us ({b_by}, float32 "
                  f"SIMT); tensor-core bound {tc_ms * 1e3:.2f} us ({tc_by})"
                  f" [{gpu}]")


XENT_LINES = {"softmax_xent_fwd": 291, "softmax_xent_bwd": 306}


def xent_bound_ms(N, V, elem, kernel):
    """Least time for one softmax-xent kernel call on this card: the
    forward reads the (N, V) logits and the labels once and writes loss
    and lse; the backward reads the logits, labels, lse and dloss once and
    writes dlogits; against the memory rate. Operations per logit, about 4
    forward (max, subtract, exponential, add) and 3 backward (subtract,
    exponential, multiply), against the float32 rate. Returns (ms,
    "bytes" or "operations")."""
    if kernel == "softmax_xent_fwd":
        nbytes, ops = N * V * elem + N * 4 + 2 * N * 4, 4 * N * V
    else:
        nbytes, ops = 2 * N * V * elem + 3 * N * 4, 3 * N * V
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def xent_rows(errs, launches, flush, device, gpu):
    """Times of the softmax-xent kernels at the train step's shape (N
    4096, V 32000), each beside its plain version, its bound and the
    library's cross_entropy: forward alone for the forward, forward +
    backward for the backward; float32 (the JSON rows), then bfloat16."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        (N, V), _ = XENT_CASES["N4096 V32000 (training)"]
        logits, labels, dloss = xent_case(device, dtype, (N, V), None)
        loss, lse = xt.softmax_xent_fwd(logits, labels)
        calls = {
            "softmax_xent_fwd": (lambda: xt.softmax_xent_fwd(logits, labels),
                                 lambda: xt.softmax_xent_fwd_ref(logits,
                                                                 labels)),
            "softmax_xent_bwd": (lambda: xt.softmax_xent_bwd(
                logits, labels, lse, dloss), lambda: xt.softmax_xent_bwd_ref(
                    logits, labels, lse, dloss)),
        }
        # yardsticks only: the port never calls the library's loss
        lab = labels.long().clamp(0, V - 1)
        leaf = logits.detach().clone().requires_grad_()
        lib_fwd = device_ms(lambda: F.cross_entropy(
            logits, lab, reduction="none"), flush=flush)
        lib_fwd_bwd = device_ms(lambda: torch.autograd.grad(
            F.cross_entropy(leaf, lab, reduction="none"), leaf, dloss),
            flush=flush)
        print(f"  cross_entropy N{N} V{V} {name}: forward "
              f"{lib_fwd * 1e3:.1f} us, forward + backward "
              f"{lib_fwd_bwd * 1e3:.1f} us [{gpu}]")
        for kernel_name, (kernel, plain) in calls.items():
            ms = device_ms(kernel, flush=flush)
            plain_ms = device_ms(plain, flush=flush)
            b_ms, b_by = xent_bound_ms(N, V, logits.element_size(),
                                       kernel_name)
            lib = lib_fwd if kernel_name == "softmax_xent_fwd" else lib_fwd_bwd
            print(f"  {kernel_name} N{N} V{V} {name}: kernel {ms * 1e3:.1f} "
                  f"us, plain {plain_ms * 1e3:.1f} us, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}) [{gpu}]")
            if dtype == torch.float32:
                rows.append({
                    "name": kernel_name, "route": "cuda",
                    "source": XENT_SOURCE,
                    "replaces": f"{JAX_KERNELS}:{XENT_LINES[kernel_name]}",
                    "launches": launches[kernel_name],
                    "max_abs_err": errs[kernel_name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib})
    return rows


EPI_LINES = {"bn_act_epilogue_fwd": "550", "bn_act_epilogue_bwd": "591"}
# the largest single calls of the ResNet-50 step at batch 128
EPI_TIMED = {"stem": (128, 112, 112, 64, False),
             "stage-1 join": (128, 56, 56, 256, True)}


def epilogue_bound_ms(R, C, elem, kernel, residual):
    """Least time for one epilogue call on this card: the forward reads x
    (and the residual) once and writes y, about 3 (4) float operations an
    element; the backward reads x, y and dy and writes dx (and dres) once,
    and the (C,) channel sums, about 7 operations an element (the mask,
    two selects, the dx product, a product and two sums). Returns (ms,
    "bytes" or "operations")."""
    n = R * C
    if kernel == "bn_act_epilogue_fwd":
        nbytes = n * elem * (3 if residual else 2) + 2 * C * 4
        ops = n * (4 if residual else 3)
    else:
        nbytes = n * elem * (5 if residual else 4) + 3 * C * 4
        ops = n * 7
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def epilogue_rows(errs, launches, flush, device, gpu):
    """Times of kernels 6 and 7 at the stem and stage-1 join shapes,
    float32, each beside its plain version and its bound (no single
    library call computes either function), then the chain each replaces
    in the knob-off leg: `ops.epilogue.bn_act` with the knob off (the
    training-mode BatchNorm, the add and the ReLU) and with it on (the
    batch moments, the folded scale and shift and the kernel), forward
    and forward + backward. The JSON rows are the stage-1 join's."""
    rows = []
    for label, (B, H, W, C, residual) in EPI_TIMED.items():
        R = B * H * W
        x, scale, shift, res, dy = epi_case(device, torch.float32, R, C,
                                            residual)
        y = ep.bn_act_epilogue_fwd(x, scale, shift, res)
        calls = {
            "bn_act_epilogue_fwd": (
                lambda: ep.bn_act_epilogue_fwd(x, scale, shift, res),
                lambda: ep.bn_act_epilogue_fwd_ref(x, scale, shift, res)),
            "bn_act_epilogue_bwd": (
                lambda: ep.bn_act_epilogue_bwd(x, scale, y, dy, residual),
                lambda: ep.bn_act_epilogue_bwd_ref(x, scale, y, dy,
                                                   residual)),
        }
        for kernel_name, (kernel, plain) in calls.items():
            ms = device_ms(kernel, flush=flush)
            plain_ms = device_ms(plain, flush=flush)
            b_ms, b_by = epilogue_bound_ms(R, C, 4, kernel_name, residual)
            print(f"  {kernel_name} {label} R{R} C{C}"
                  f"{' residual' if residual else ''}: kernel "
                  f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}) [{gpu}]")
            if label == "stage-1 join":
                rows.append({
                    "name": kernel_name, "route": "cuda",
                    "source": EPILOGUE_SOURCE,
                    "replaces": f"{JAX_KERNELS}:{EPI_LINES[kernel_name]}",
                    "launches": launches[kernel_name],
                    "max_abs_err": errs[kernel_name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
        chain_times(label, (B, H, W, C), x, res, dy, flush, device, gpu)
    return rows


def chain_times(label, shape, x, res, dy, flush, device, gpu):
    """Device time of `ops.epilogue.bn_act` on one training-mode
    BatchNorm at `shape`, knob off and on, forward and forward +
    backward."""
    norm = tmx.gluon.nn.BatchNorm(axis=-1)
    norm.initialize(device=device)
    norm.train()
    xs = x.view(shape).detach().requires_grad_()
    rs = None if res is None else res.view(shape)
    gs = dy.view(shape)
    out = []
    try:
        for knob in ("0", "1"):
            os.environ["MXTPU_FUSED_EPILOGUE"] = knob
            norm(xs[:1].detach())  # resolves the BN's shapes
            leaves = [xs, norm.gamma.data(), norm.beta.data()]
            fwd = device_ms(lambda: rewrite.bn_act(norm, xs, rs),
                            flush=flush)
            both = device_ms(lambda: torch.autograd.grad(
                rewrite.bn_act(norm, xs, rs), leaves, gs), flush=flush)
            out.append((fwd, both))
    finally:
        os.environ.pop("MXTPU_FUSED_EPILOGUE", None)
    (off_f, off_b), (on_f, on_b) = out
    print(f"  BN -> ReLU{' (-> add)' if res is not None else ''} chain, "
          f"{label}, training mode: unfused (knob off) forward "
          f"{off_f * 1e3:.1f} us, forward + backward {off_b * 1e3:.1f} us; "
          f"fused (knob on) {on_f * 1e3:.1f} us, {on_b * 1e3:.1f} us "
          f"[{gpu}]")


def resnet_times(leg, out, batch, gpu):
    """Device and host time of one ResNet-50 step of `leg`, images/s over
    10 steps (host clock, one sync at the end), and a traced window; the
    knob is set as the leg trains (each forward reads it)."""
    step = out["step"]
    x, y = batch
    os.environ["MXTPU_FUSED_EPILOGUE"] = "1" if leg == "fused" else "0"
    try:
        # ~100 ms of sleep covers the host's enqueue ahead of a whole step
        dev = device_ms(lambda: step(x, y), reps=10, warmup=2,
                        sleep_cycles=200_000_000)
        host = host_ms(lambda: step(x, y).item(), reps=5, warmup=1)
        n = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            loss = step(x, y)
        loss.item()
        seconds = time.perf_counter() - t0
        print(f"  ResNet-50 step, {leg} leg (batch {x.shape[0]}, "
              f"{x.shape[1]}x{x.shape[2]}, NHWC float32): device {dev:.3f} "
              f"ms; with the loss read-back, host clock {host:.3f} ms; "
              f"{n * x.shape[0] / seconds:.1f} images/s over {n} steps "
              f"({seconds:.3f} s, host clock) [{gpu}]")
        busy_share(lambda: step(x, y).item(), f"ResNet-50 step ({leg} leg) "
                   f"+ loss read-back", gpu, steps=5, top_n=12, kinds=True)
    finally:
        os.environ.pop("MXTPU_FUSED_EPILOGUE", None)


def train_times(step, params, batch, gpu, leg="flash"):
    """Device and host time of one full-width train step of `leg`, train
    tokens/s over 20 steps (host clock, one sync at the end), and a traced
    window."""
    tok, tgt = batch
    n_tok = tok.numel()
    # ~50 ms of sleep covers the host's enqueue of a whole step
    dev = device_ms(lambda: step(params, tok, tgt), reps=25,
                    sleep_cycles=100_000_000)
    host = host_ms(lambda: step(params, tok, tgt)[0].item(), reps=10)
    n = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        loss, _ = step(params, tok, tgt)
    loss.item()
    seconds = time.perf_counter() - t0
    print(f"  train step, {leg} leg (B{tok.shape[0]} T{tok.shape[1]}): device "
          f"{dev:.3f} ms; with the loss read-back, host clock {host:.3f} "
          f"ms; {n * n_tok / seconds:.1f} train tokens/s over {n} steps "
          f"({seconds:.3f} s, host clock) [{gpu}]")
    busy_share(lambda: step(params, tok, tgt)[0].item(),
               f"train step ({leg} leg) + loss read-back", gpu, steps=5)


def path_times(cfg, params, device, gpu):
    """Median device time of one full-width decode step (8 live slots at
    ragged depths), of one prefill of a 200-token prompt (bucket 256) and
    of one wide step (8 slots of 5 and of 64 rows from the same depths),
    then a traced window over decode steps."""
    W = 512 // PAGE
    paged = tfm.init_paged_kv_cache(cfg, SLOTS * W + 1, PAGE, device=device)
    positions = torch.tensor([5, 40, 77, 120, 160, 199, 230, 269],
                             device=device)
    table = (torch.arange(SLOTS * W, device=device).reshape(SLOTS, W) + 1)
    tokens = torch.arange(1, SLOTS + 1, device=device)
    with torch.no_grad():
        # ~10 ms of sleep covers the host's enqueue of a whole step
        step_ms = device_ms(lambda: tfm.decode_step_paged(
            params, paged, tokens, positions, table, cfg)[0].argmax(-1),
            reps=30, sleep_cycles=20_000_000)
        prompt = torch.randint(1, cfg.vocab, (1, 256), device=device,
                               generator=torch.Generator(device=device)
                               .manual_seed(3))
        lens = torch.tensor([200], device=device)
        prefill_ms = device_ms(lambda: tfm.prefill_paged(
            params, paged, prompt, lens, table[:1], cfg)[1].argmax(-1),
            reps=25, sleep_cycles=20_000_000)
        step_host = host_ms(lambda: tfm.decode_step_paged(
            params, paged, tokens, positions, table, cfg)[0].argmax(-1)
            .cpu())
        print(f"  decode step (8 slots, positions {positions.tolist()}): "
              f"device {step_ms:.3f} ms; with the token read-back, host "
              f"clock {step_host:.3f} ms [{gpu}]")
        print(f"  prefill (1 x 256 bucket, 200 tokens): device "
              f"{prefill_ms:.3f} ms [{gpu}]")
        for Q in (WIDE_Q[0], WIDE_Q[-1]):  # speculation, a prefill chunk
            wide_tok = torch.randint(1, cfg.vocab, (SLOTS, Q), device=device,
                                     generator=torch.Generator(
                                         device=device).manual_seed(4))
            n_real = torch.full((SLOTS,), Q, device=device)
            wide_ms = device_ms(lambda: tfm.decode_step_paged_wide(
                params, paged, wide_tok, positions, n_real, table,
                cfg)[0].argmax(-1), reps=25, sleep_cycles=20_000_000)
            print(f"  wide step ({SLOTS} slots x {Q} rows from positions "
                  f"{positions.tolist()}): device {wide_ms:.3f} ms [{gpu}]")
        busy_share(lambda: tfm.decode_step_paged(
            params, paged, tokens, positions, table, cfg)[0].argmax(-1)
            .cpu(), "decode step + token read-back", gpu)


def graph_vs_eager(cfg, params, device, gpu, turns=6):
    """One full-width decode step (8 live slots at path_times' ragged
    depths) run eagerly against its CUDA graph (the engine's
    `serving_decode_step` site after warm()), timed in alternating turns
    (eager, graphed, graphed, eager, ...): the host clock with the token
    read-back, and the device time (CUDA events behind a device-side
    sleep, so they time the device alone), each the median of its turn's
    reps; then a traced window over graphed steps."""
    eng = ServingEngine(params, cfg, slots=SLOTS, page_size=PAGE,
                        device=device)
    eng.warm()
    W = eng.table_width
    inputs = (np.arange(1, SLOTS + 1, dtype=np.int64),
              np.array([5, 40, 77, 120, 160, 199, 230, 269], np.int64),
              np.arange(1, SLOTS * W + 1, dtype=np.int64).reshape(SLOTS, W))
    steps = {
        "eager": lambda: eng._decode_fn(*(
            torch.from_numpy(a).to(device, non_blocking=True)
            for a in inputs)),
        "graphed": lambda: eng._decode(*inputs)}
    if not torch.equal(steps["eager"]().cpu(), steps["graphed"]().cpu()):
        raise AssertionError("the graphed decode step's tokens differ from "
                             "the eager step's")
    times = {label: {"host": [], "device": []} for label in steps}
    for turn in range(turns):
        for label in (("eager", "graphed") if turn % 2 == 0
                      else ("graphed", "eager")):
            fn = steps[label]
            times[label]["host"].append(host_ms(lambda: fn().cpu()))
            times[label]["device"].append(device_ms(
                fn, reps=25, sleep_cycles=20_000_000))
    for label, t in times.items():
        print(f"  decode step {label}, {turns} turns: host clock with the "
              f"token read-back " + ", ".join(f"{x:.3f}" for x in t["host"])
              + " ms; device " + ", ".join(f"{x:.3f}" for x in t["device"])
              + f" ms [{gpu}]")
    busy_share(lambda: steps["graphed"]().cpu(),
               "decode step through its CUDA graph + token read-back", gpu)


def ptxas_lines(output):
    """One line per variant of the flash-attention and decode kernels from
    ptxas -v's report: registers, and spill stores / loads in bytes."""
    lines, name = [], None
    types = {"f": "float", "13__nv_bfloat16": "bf16"}
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '.*?((?:flash_(?:fwd|dq|dkv)"
                      r"|paged_decode_wide)_kernel)I(f|13__nv_bfloat16)"
                      r"Li(\d+)E", line)
        split = re.search(r"Compiling entry function '.*?decode_split_kernel"
                          r"I(f|13__nv_bfloat16)(f|13__nv_bfloat16)Li(\d+)E"
                          r"NS_9(Dense|Paged)Rows", line)
        if m:
            name = f"{m.group(1)}<{types[m.group(2)]}, {m.group(3)}>"
        elif split:
            name = (f"decode_split_kernel<{types[split.group(1)]}, "
                    f"{types[split.group(2)]}, {split.group(3)}, "
                    f"{split.group(4)}Rows>")
        elif name and "spill stores" in line:
            spill = re.findall(r"(\d+) bytes spill", line)
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{name}: {regs} registers, spill stores / loads "
                         f"{' / '.join(spill)} bytes")
            name = None
    return lines


def host_ms(fn, reps=30, warmup=3):
    """Median host-clock time of fn() in ms; fn must end in a sync."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


# kernel-name fragments -> kind, for the ResNet step's breakdown
KINDS = (("epilogue_", "epilogue kernels"),
         *((frag, "convolution/GEMM") for frag in (
             "cudnn", "xmma", "conv", "gemm", "wgrad", "dgrad", "fprop")),
         ("reduce_kernel", "reductions"), ("elementwise", "elementwise"))


def busy_share(fn, label, gpu, steps=20, warm=True, top_n=6, kinds=False,
               spans=()):
    """Traced window (torch.profiler) over `steps` calls: the share of
    wall time with a kernel running, and the `top_n` kernels taking the
    most device time (with `kinds`, the device time by kind of kernel
    too). Tracing adds host time, so the busy share is a lower bound for
    an untraced run. Each name in `spans` must appear among the window's
    host ranges (a telemetry span's record_function); the spans' counts
    are printed, and their ranges are no kernel time. Returns the last
    call's result and {device event name: events in the window}."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            result = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, ranges, events = {}, {}, {}
    for evt in prof.events():
        if evt.name in telemetry.SPAN_NAMES:
            # a span's range: on the host, and mirrored on the device
            # timeline (not a kernel)
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                ranges[evt.name] = ranges.get(evt.name, 0) + 1
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] = (kernels.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us())
            events[evt.name] = events.get(evt.name, 0) + 1
    if spans:
        print(f"  {label}: telemetry spans in the window: {ranges}")
        if not set(spans) <= set(ranges):
            raise AssertionError(f"spans {sorted(set(spans) - set(ranges))} "
                                 f"missing from the profiler window")
    if not kernels:
        print(f"  {label}: the profiler saw no device time; busy share "
              f"not measured [{gpu}]")
        return result, events
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:top_n]
    print(f"  {label}, traced over {steps} calls: wall "
          f"{wall_us / steps / 1e3:.3f} ms per call, device busy "
          f"{busy / wall_us:.1%} (idle {1 - busy / wall_us:.1%}) [{gpu}]")
    for name, us in top:
        print(f"    {us / steps:9.1f} us/call  {us / busy:6.1%}  "
              f"{name[:90]}")
    if kinds:
        by_kind = {}
        for name, us in kernels.items():
            kind = next((k for frag, k in KINDS if frag in name), "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + us
        print("    by kind: " + "; ".join(
            f"{k} {us / steps / 1e3:.3f} ms ({us / busy:.1%})"
            for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    return result, events


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN")

    print("phase 1: build")
    t0 = t_call = time.perf_counter()
    built = _build.build()
    for name, rec in built.items():
        regs = [ln.strip() for ln in rec["output"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}.cu: {rec['seconds']:.1f} s "
              f"({'cached' if rec['cached'] else 'nvcc'}); ptxas: "
              f"{len(regs)} lines, first: {regs[:2]}")
    print(f"  build {time.perf_counter() - t0:.1f} s")
    for lib in MMA_KERNELS:
        for line in ptxas_lines(built[lib]["output"]):
            print(f"  {line}")
    print(gpu)

    print("phase 2: kernels against their plain versions")
    errs = kernels_against_plain(device)

    print("phase 3: serving at full width")
    cfg = tfm.TransformerConfig(**FULL)
    params = tfm.init_params(cfg, seed=0, device=device)
    legs = {"off": {}, **LEVER_LEGS}
    served, flash_launches = {}, {}
    telemetry.enable()  # the capture registry counts only while it is on
    for leg, levers in legs.items():
        out = served[leg] = serve(cfg, params, 16, device, **levers)
        print(f"  levers {leg} {levers}: warm() captured {len(out['warm'])} "
              f"sites in {out['warm_s']:.2f} s, graph pool "
              f"{out['pool_bytes'] / 2**20:.1f} MiB; "
              + "; ".join(f"{name} {row['capture_s'] * 1e3:.1f} ms, "
                          f"{row['replays']} replays"
                          for name, row in out["sites"].items()))
        print(f"    {out['requests_completed']} requests, "
              f"{out['generated_tokens']} tokens, {out['engine_steps']} "
              f"engine steps, {out['decode_steps']} decode steps, "
              f"{out['wide_calls']} wide steps; launches {out['launches']}, "
              f"all in graph replays; steady_compiles "
              f"{out['steady_compiles']}, steady_retraces "
              f"{out['steady_retraces']}; max_step_prefill_tokens "
              f"{out['max_step_prefill_tokens']}; "
              + ", ".join(f"{k} {out[k]}" for k in (
                  "prefill_tokens_saved", "cow_copies", "prefix_hit_rate",
                  "prefill_chunks", "spec_accepted_tokens",
                  "spec_proposed_tokens") if k in out))
        flash_launches[leg], ties = match_generate(cfg, params, out, device)
        print(f"    tokens equal generate(use_flash=True) for every request "
              f"({ties} near ties); flash_decode launches "
              f"{flash_launches[leg]}")
    n_files, n_records, n_requests = traced_chains(
        cfg, params, served["off"]["engine"],
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_trace"))
    print(f"  MXTPU_TRACE_DIR run, levers off: {n_files} MXTRACE1 file(s), "
          f"{n_records} records, one complete chain for each of "
          f"{n_requests} requests")
    if not (served["prefix"]["prefill_tokens_saved"] > 0
            and served["prefix"]["cow_copies"] >= 1):
        raise AssertionError("the prefix leg saved no prefill or copied no "
                             "page")
    if not (served["chunked"]["max_step_prefill_tokens"]
            < served["off"]["max_step_prefill_tokens"]):
        raise AssertionError("chunked prefill did not lower the most "
                             "prefill tokens of any step")

    print("phase 4: training at full width")
    print(" leg flash (dense xent)")
    train_cfg = dataclasses.replace(cfg, use_flash=True)
    step, train_params, batch, flash_losses, train_launches = train(
        train_cfg, device)
    print(" leg fused (use_fused_xent)")
    fused_cfg = dataclasses.replace(train_cfg, use_fused_xent=True)
    legs4 = {"fused": train_fused(fused_cfg, flash_losses, device)}
    print(f" leg moe (n_experts {MOE['n_experts']}, use_fused_xent)")
    legs4["moe"] = train_moe(dataclasses.replace(
        fused_cfg, n_experts=MOE["n_experts"]), device)
    resnet = resnet_legs(device)
    bn_layer_check(device)

    print("phase 5: times")
    for leg, out in served.items():
        print(f"  tokens/s over the trace, levers {leg}: "
              f"{out['tokens_per_sec']:.1f} ({out['generated_tokens']} "
              f"tokens in {out['measured_seconds']:.3f} s, host clock) "
              f"[{gpu}]")
    for leg, out in served.items():
        print(f"  levers {leg}, through CUDA graphs: TTFT p50 "
              f"{out['ttft_p50_s'] * 1e3:.3f} ms, p99 "
              f"{out['ttft_p99_s'] * 1e3:.3f} ms; request latency p50 "
              f"{out['p50_latency_s'] * 1e3:.3f} ms, p99 "
              f"{out['p99_latency_s'] * 1e3:.3f} ms (host clock) [{gpu}]")
    path_times(cfg, params, device, gpu)
    graph_vs_eager(cfg, params, device, gpu)
    profiler.set_state("run")  # spans annotate the windows below
    for leg, levers in legs.items():
        for kernel in (dk.paged_decode_attention,
                       dk.paged_decode_attention_wide):
            kernel.launches = 0
        out, events = busy_share(lambda: run_trace(
            params, cfg, n_requests=16, seed=0,
            engine=served[leg]["engine"],
            **{k: v for k, v in levers.items() if k not in ENGINE_LEVERS}),
            f"whole trace through CUDA graphs, levers {leg}", gpu, steps=1,
            warm=False, spans=("serving.step",))
        device_launches(cfg, out, events, leg)
    profiler.set_state("stop")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    rows = kernel_rows(
        errs, {"paged": served["off"]["launches"]["paged"],
               "flash": flash_launches["off"],
               "wide": sum(served[leg]["launches"]["wide"]
                           for leg in LEVER_LEGS)}, flush, device, gpu)
    train_times(step, train_params, batch, gpu)
    for leg, (leg_step, leg_params, leg_batch, _) in legs4.items():
        train_times(leg_step, leg_params, leg_batch, gpu, leg=leg)
    rows += flash_rows(errs, train_launches, flush, device, gpu)
    rows += xent_rows(errs, legs4["fused"][3], flush, device, gpu)
    for leg in ("unfused", "fused"):
        resnet_times(leg, resnet[leg], resnet["batch"], gpu)
    rows += epilogue_rows(errs, resnet["fused"]["launches"], flush, device,
                          gpu)
    torch.cuda.synchronize()

    print(f"whole call: {time.perf_counter() - t_call:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
