#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and its train step on one CUDA
card and hold its hand-written kernels against their plain PyTorch
versions.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels build for sm_90a) and the CUDA
toolkit's nvcc; imports only torch, numpy and `incubator_mxnet_tpu_torch`.
Phases, in order; any failure raises and the exit code is non-zero:

1. build: nvcc compiles every kernel source of the port (one process per
   source, all at once) into build/torch_kernels/;
2. kernels: each kernel against its plain version on the card, in
   float32 and bfloat16. The decode kernels at the shapes the serving
   path gives them (tolerance 2e-5 and 2e-2), the wide kernel at Q = 5,
   32 and 64 rows per slot; the flash-attention forward, dQ and dK/dV
   kernels at the training shape (B 8, H 8, T 512, D 64, causal, in the
   model's (B, T, H, D) layout), non-causal at T 512, at a causal ragged
   T 200, a non-causal ragged T 24 and at D 16 (o and lse 2e-5 and 2e-2;
   dQ, dK, dV 2e-4 in float32 and, in bfloat16, 2e-2 of the largest
   reference value);
3. serving: the full-width transformer (d_model 512, 6 layers, 8 heads,
   d_ff 2048, vocab 32000, max_len 512, float32, random weights from
   seed 0) serves the seeded trace through the engine (8 slots, page 16)
   with the levers off, then once with each lever on (prefix cache over
   a half-shared 32-token prefix, chunked prefill of 64, n-gram 2
   speculation with lookahead 4). Every request must complete with its
   full budget; the paged kernel must run once per layer per decode step
   and the wide kernel once per layer per wide step; every request's
   tokens must equal generate() with use_flash, which runs the
   flash_decode kernel;
4. training: the same full-width model with use_flash (batch 8, seq 512,
   lr 0.1, aux_weight 0.01, tokens and targets from RandomState(0) as
   tools/bench_transformer.py draws them) takes 10 steps of
   make_train_step. Every loss must be finite; the forward, dQ and dK/dV
   kernels must each launch once per layer per step; the first 3 losses
   must equal a second run through apply with dense attention at rtol
   1e-5, and one step's gradients must agree with the dense path at rtol
   2e-4, atol 1e-5;
5. times (CUDA events; warm-up first, median of 25 or more): decode step,
   prefill, tokens/s over each trace, the train step and train tokens/s,
   and each kernel beside its plain version, its bound and, for
   flash_decode and the flash-attention kernels, one library call; then
   traced windows (torch.profiler) over decode steps, over each trace and
   over train steps give the device's busy share and the kernels that
   take its time.

The last lines are the card (`nvidia-smi` name and power limit), one JSON
object describing the kernels, and the status JSON.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from incubator_mxnet_tpu_torch.models import transformer as tfm
from incubator_mxnet_tpu_torch.ops import _build
from incubator_mxnet_tpu_torch.ops.kernels import decode as dk
from incubator_mxnet_tpu_torch.ops.kernels import flash as fl
from incubator_mxnet_tpu_torch.serving import PageAllocator, run_trace

FULL = dict(vocab=32000, d_model=512, n_heads=8, n_layers=6, d_ff=2048,
            max_len=512)
SLOTS, PAGE = 8, 16
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores
NEAR_TIE = 1e-4
WIDE_Q = (5, 32, 64)  # speculation (lookahead 4), prefix tail, chunk 64
LEVER_LEGS = {
    "prefix": dict(prefix_cache=1, shared_prefix_frac=0.5, prefix_len=32),
    "chunked": dict(prefill_chunk=64),
    "spec": dict(spec_ngram=2, spec_lookahead=4),
}
TRAIN = dict(batch=8, seq=512, lr=0.1, aux_weight=0.01, steps=10)
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SOURCES = [f"incubator_mxnet_tpu_torch/ops/csrc/{name}.cu"
           for name in _build.SOURCES]
DECODE_SOURCE, FLASH_SOURCE = SOURCES
JAX_KERNELS = "incubator_mxnet_tpu/ops/pallas_kernels.py"


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(label, got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    print(f"  {label}: max_abs_err {err:.3e} (tolerance {tol:g})")
    if not (ok and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


# -- phase 2: kernels against their plain versions --------------------------

def paged_case(device, dtype, seed=0):
    """The serving shape: 8 slots, 8 heads of 64, pages of 16, table 32,
    pool 257; ragged n_valid including 0, 1, 16, 511 and 512."""
    S, H, D, W, P = SLOTS, 8, 64, 512 // PAGE, SLOTS * 512 // PAGE + 1
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


def recycled_case(device, dtype, seed=1):
    """Slot 5's pages freed and handed to a new sequence, which writes new
    K/V into them: the kernel must read the new contents."""
    q, kp, vp, table, nv = (a.clone() for a in paged_case(device, dtype))
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


def wide_case(device, dtype, Q, seed=3):
    """The serving shape with Q rows per slot: 8 slots, 8 heads of 64,
    pages of 16, table 32, pool 257; ragged n_base, and rows past the
    table (cap 512) in the last two slots, the last one wholly past."""
    S, H, D, W, P = SLOTS, 8, 64, 512 // PAGE, SLOTS * 512 // PAGE + 1
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


def wide_recycled_case(device, dtype, Q, seed=4):
    """Slot 5's pages handed, in another order, to a new sequence with
    new K/V and another n_base: the kernel must read the new contents."""
    q, kp, vp, table, nb = (a.clone() for a in wide_case(device, dtype, Q))
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


def flash_case(device, dtype, B, T, n_valid, seed=2):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, 8, 64), generator=g)
    k = torch.randn((B, T, 8, 64), generator=g)
    v = torch.randn((B, T, 8, 64), generator=g)
    if not isinstance(n_valid, int):
        n_valid = torch.tensor(n_valid, dtype=torch.int32, device=device)
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            n_valid)


FLASH_CASES = {
    "B8 T512 scalar n_valid 300": (8, 512, 300),
    "B8 T512 (B,) n_valid": (8, 512, [1, 2, 127, 128, 129, 300, 511, 512]),
    "B8 T200 scalar n_valid 137": (8, 200, 137),
    "B8 T200 (B,) n_valid": (8, 200, [1, 5, 64, 100, 128, 150, 199, 200]),
    "B1 T512 scalar n_valid 270 (generate)": (1, 512, 270),
}


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


# (B, H, T, D, causal, model layout): the training shape first
ATTN_CASES = {
    "B8 H8 T512 D64 causal (training)": (8, 8, 512, 64, True, True),
    "B8 H8 T512 D64 non-causal": (8, 8, 512, 64, False, True),
    "B8 H8 T200 D64 causal (ragged)": (8, 8, 200, 64, True, True),
    "B2 H8 T24 D64 non-causal (ragged)": (2, 8, 24, 64, False, True),
    "B2 H4 T200 D16 causal, (B, H, T, D) layout": (2, 4, 200, 16, True,
                                                  False),
}


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
    return errs


def kernels_against_plain(device):
    """Phase 2. Returns {kernel: max abs err in float32}."""
    errs = {"paged_decode_attention": 0.0, "flash_decode": 0.0,
            "paged_decode_attention_wide": 0.0, "flash_attention_fwd": 0.0,
            "flash_attention_dq": 0.0, "flash_attention_dkv": 0.0}
    for dtype, tol in TOL.items():
        name = str(dtype).replace("torch.", "")
        for label, make in (("ragged", paged_case),
                            ("recycled pages", recycled_case)):
            args = make(device, dtype)
            got = dk.paged_decode_attention(*args)
            want = dk.paged_decode_attention_ref(*args)
            err = check(f"paged_decode_attention {name} {label}", got, want,
                        tol)
            if got[args[4] == 0].float().abs().max() != 0:
                raise AssertionError("a dead slot must give zeros")
            if dtype == torch.float32:
                errs["paged_decode_attention"] = max(
                    errs["paged_decode_attention"], err)
        for label, (B, T, nv) in FLASH_CASES.items():
            args = flash_case(device, dtype, B, T, nv)
            err = check(f"flash_decode {name} {label}",
                        dk.flash_decode(*args), dk.flash_decode_ref(*args),
                        tol)
            if dtype == torch.float32:
                errs["flash_decode"] = max(errs["flash_decode"], err)
        for Q in WIDE_Q:
            for label, make in (("ragged, rows past the table", wide_case),
                                ("recycled pages", wide_recycled_case)):
                args = make(device, dtype, Q)
                err = check(f"paged_decode_attention_wide {name} Q {Q} "
                            f"{label}", dk.paged_decode_attention_wide(*args),
                            dk.paged_decode_attention_wide_ref(*args), tol)
                if dtype == torch.float32:
                    errs["paged_decode_attention_wide"] = max(
                        errs["paged_decode_attention_wide"], err)
    return flash_against_plain(device, errs)


# -- phase 3: the serving path at full width --------------------------------

def serve(cfg, params, n_requests, device, **levers):
    """Serve the seeded trace with `levers` (none: the levers off); the
    paged and wide kernels' launches are counted from zero over exactly
    this run, and each must match the engine's calls of its step."""
    dk.paged_decode_attention.launches = 0
    dk.paged_decode_attention_wide.launches = 0
    out = run_trace(params, cfg, n_requests=n_requests, slots=SLOTS,
                    page_size=PAGE, seed=0, device=device, **levers)
    out["launches"] = {"paged": dk.paged_decode_attention.launches,
                       "wide": dk.paged_decode_attention_wide.launches}
    if out["requests_completed"] != n_requests:
        raise AssertionError(f"{out['requests_completed']} of {n_requests} "
                             f"requests completed")
    for r in out["trace"]:
        if len(out["results"][r["rid"]].tokens) != r["max_new"]:
            raise AssertionError(f"request {r['rid']} stopped early")
    for kernel, calls, what in (
            ("paged", out["decode_steps"], "decode steps"),
            ("wide", out["wide_calls"], "wide steps")):
        want = calls * cfg.n_layers
        if out["launches"][kernel] != want:
            raise AssertionError(f"{kernel} kernel launched "
                                 f"{out['launches'][kernel]} times, "
                                 f"expected {want} ({what} x layers)")
    used = "wide" if levers else "paged"
    if not out["launches"][used]:
        raise AssertionError(f"the {used} kernel never ran on this path")
    return out


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


def train(cfg, device):
    """Phase 4: `TRAIN["steps"]` steps of make_train_step with use_flash,
    the flash kernels' launches counted from zero over exactly those
    steps; then the dense path (apply resolves attention to
    `_dense_attention` without use_flash) for the first 3 losses and one
    step's gradients. Returns (step, params, batch, launches)."""
    tok, tgt = batch = train_batch(cfg, device)
    kw = dict(lr=TRAIN["lr"], aux_weight=TRAIN["aux_weight"], device=device)
    step, params = tfm.make_train_step(cfg, **kw)
    for kernel in FLASH_KERNELS:
        kernel.launches = 0
    losses = []
    for i in range(TRAIN["steps"]):
        before = [k.launches for k in FLASH_KERNELS]
        losses.append(step(params, tok, tgt)[0])
        for k, b in zip(FLASH_KERNELS, before):
            if k.launches - b != cfg.n_layers:
                raise AssertionError(f"{k.__name__} launched "
                                     f"{k.launches - b} times in step "
                                     f"{i + 1}, expected {cfg.n_layers} "
                                     f"(one per layer)")
    launches = {k.__name__: k.launches for k in FLASH_KERNELS}
    losses = torch.stack(losses).tolist()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    print(f"  loss after step 1: {losses[0]:.6f}; after step "
          f"{TRAIN['steps']}: {losses[-1]:.6f}; launches {launches}")

    dense_cfg = dataclasses.replace(cfg, use_flash=False)
    dstep, dparams = tfm.make_train_step(dense_cfg, **kw)
    dense = torch.stack([dstep(dparams, tok, tgt)[0]
                         for _ in range(3)]).tolist()
    del dstep, dparams
    if not np.allclose(losses[:3], dense, rtol=1e-5, atol=0):
        raise AssertionError(f"flash losses {losses[:3]} differ from dense "
                             f"{dense} beyond rtol 1e-5")
    print(f"  first 3 losses equal the dense path's (rtol 1e-5): flash "
          f"{losses[:3]}, dense {dense}")

    grads = {}
    for label, c in (("flash", cfg), ("dense", dense_cfg)):
        p = tfm.init_params(c, seed=0, device=device)
        for w in p.values():
            w.requires_grad_(True)
        loss = tfm.loss_fn(p, tok, tgt, c, TRAIN["aux_weight"])
        grads[label] = dict(zip(p, torch.autograd.grad(loss,
                                                       list(p.values()))))
    worst = 0.0
    for name, g in grads["flash"].items():
        d = grads["dense"][name]
        err = float((g - d).abs().max())
        if not torch.allclose(g, d, rtol=2e-4, atol=1e-5):
            raise AssertionError(f"gradient of {name}: flash and dense "
                                 f"differ beyond rtol 2e-4, atol 1e-5 (max "
                                 f"abs diff {err:.3e})")
        worst = max(worst, err)
    print(f"  one step's gradients equal the dense path's for all "
          f"{len(grads['flash'])} parameters (rtol 2e-4, atol 1e-5; max abs "
          f"diff {worst:.3e})")
    return step, params, batch, launches


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


def bound_ms(n_valid, T_cap, H, D, elem, B, extra_bytes=0):
    """Least time for one call on this card: each live key and value row
    read once, q read and the output written once (float32), against the
    memory rate; the 4*D operations per row against the float32 rate.
    Returns (ms, "bytes" or "operations")."""
    rows = int(torch.clamp(n_valid.cpu().long(), 0, T_cap).sum())
    nbytes = rows * H * D * 2 * elem + 2 * B * H * D * 4 + extra_bytes
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
    """Times of each kernel at the serving path's shapes, float32."""
    rows = []
    args = paged_case(device, torch.float32)
    q, kp, _, table, nv = args
    S, H, D = q.shape
    pages_read = int(((nv.long() + PAGE - 1) // PAGE).sum())
    b_ms, b_by = bound_ms(nv, table.shape[1] * PAGE, H, D, 4, S,
                          extra_bytes=4 * pages_read + 4 * S)
    ms = device_ms(lambda: dk.paged_decode_attention(*args), flush=flush)
    plain = device_ms(lambda: dk.paged_decode_attention_ref(*args),
                      flush=flush)
    rows.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": DECODE_SOURCE, "replaces": f"{JAX_KERNELS}:719",
        "launches": launches["paged"],
        "max_abs_err": errs["paged_decode_attention"], "ms": ms,
        "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None})
    print(f"  paged_decode_attention S{S} H{H} D{D} page {PAGE} n_valid "
          f"{nv.tolist()}: kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f}"
          f" us, bound {b_ms * 1e3:.2f} us ({b_by}) [{gpu}]")

    generate_shape = "B1 T512 n_valid 270 (generate)"
    for label, (B, T, n) in ((generate_shape, (1, 512, 270)),
                             ("B8 T512 (B,) n_valid",
                              FLASH_CASES["B8 T512 (B,) n_valid"])):
        fq, fk, fv, fnv = flash_case(device, torch.float32, B, T, n)
        nv_vec = dk._per_seq_n_valid(fnv, B, device)
        f_ms, f_by = bound_ms(nv_vec, T, 8, 64, 4, B, extra_bytes=4 * B)
        ms = device_ms(lambda: dk.flash_decode(fq, fk, fv, fnv), flush=flush)
        plain = device_ms(lambda: dk.flash_decode_ref(fq, fk, fv, fnv),
                          flush=flush)
        # yardstick only: one library call for the same function, on the
        # transposed cache with a length mask (the port never calls it)
        mask = (torch.arange(T, device=device)[None]
                < nv_vec[:, None])[:, None, None, :]
        lq, lk, lv = fq[:, :, None], fk.transpose(1, 2), fv.transpose(1, 2)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=mask), flush=flush)
        print(f"  flash_decode {label}: kernel {ms * 1e3:.1f} us, plain "
              f"{plain * 1e3:.1f} us, library {lib * 1e3:.1f} us, bound "
              f"{f_ms * 1e3:.2f} us ({f_by}) [{gpu}]")
        if label == generate_shape:  # the JSON row: generate()'s shape
            rows.append({
                "name": "flash_decode", "route": "cuda",
                "source": DECODE_SOURCE, "replaces": f"{JAX_KERNELS}:455",
                "launches": launches["flash"],
                "max_abs_err": errs["flash_decode"], "ms": ms,
                "plain_ms": plain, "bound_ms": f_ms, "bound_by": f_by,
                "library_ms": lib})

    for Q in WIDE_Q:
        q, kp, _, table, nb = args = wide_case(device, torch.float32, Q)
        S, _, H, D = q.shape
        pages_read = int(((torch.clamp(nb.long() + Q, max=512) + PAGE - 1)
                          // PAGE).sum())
        w_ms, w_by = wide_bound_ms(nb, Q, table.shape[1] * PAGE, H, D, 4, S,
                                   extra_bytes=4 * pages_read + 4 * S)
        ms = device_ms(lambda: dk.paged_decode_attention_wide(*args),
                       flush=flush)
        plain = device_ms(lambda: dk.paged_decode_attention_wide_ref(*args),
                          flush=flush)
        print(f"  paged_decode_attention_wide S{S} Q{Q} H{H} D{D} page "
              f"{PAGE} n_base {nb.tolist()}: kernel {ms * 1e3:.1f} us, plain "
              f"{plain * 1e3:.1f} us, bound {w_ms * 1e3:.2f} us ({w_by}) "
              f"[{gpu}]")
        if Q == WIDE_Q[0]:  # the JSON row: speculative verification
            rows.append({
                "name": "paged_decode_attention_wide", "route": "cuda",
                "source": DECODE_SOURCE, "replaces": f"{JAX_KERNELS}:808",
                "launches": launches["wide"],
                "max_abs_err": errs["paged_decode_attention_wide"],
                "ms": ms, "plain_ms": plain, "bound_ms": w_ms,
                "bound_by": w_by, "library_ms": None})
    return rows


def flash_bound_ms(B, H, T, D, causal, elem, kernel):
    """Least time for one flash-attention kernel call on this card: each
    (B, H, T, D) operand read or written once and each (B, H, T) float32
    statistic (lse; delta) once, against the memory rate; per (query row,
    live key) pair 4*D operations for the forward, 6*D for dQ and 8*D for
    dK/dV, against the float32 rate. Returns (ms, "bytes" or
    "operations")."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    per_pair, tensors, stats = {"flash_attention_fwd": (4, 4, 1),
                                "flash_attention_dq": (6, 5, 2),
                                "flash_attention_dkv": (8, 6, 2)}[kernel]
    nbytes = tensors * B * H * T * D * elem + stats * B * H * T * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = per_pair * D * pairs / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


FLASH_LINES = {"flash_attention_fwd": 50, "flash_attention_dq": 86,
               "flash_attention_dkv": 116}


def flash_rows(errs, launches, flush, device, gpu):
    """Times of the flash-attention kernels at the training shape
    (float32, the model's layout), each beside its plain version, its
    bound and the library's fused attention: forward alone for the
    forward, forward + backward for dQ and dK/dV together."""
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
    print(f"  scaled_dot_product_attention B{B} H{H} T{T} D{D} causal: "
          f"forward {lib_fwd * 1e3:.1f} us, forward + backward "
          f"{lib_fwd_bwd * 1e3:.1f} us [{gpu}]")
    rows = []
    for name, (kernel, plain) in calls.items():
        ms = device_ms(kernel, flush=flush)
        plain_ms = device_ms(plain, flush=flush)
        b_ms, b_by = flash_bound_ms(B, H, T, D, causal, 4, name)
        lib = lib_fwd if name == "flash_attention_fwd" else lib_fwd_bwd
        print(f"  {name} B{B} H{H} T{T} D{D} causal: kernel "
              f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}) [{gpu}]")
        rows.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": f"{JAX_KERNELS}:{FLASH_LINES[name]}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib})
    return rows


def train_times(step, params, batch, gpu):
    """Device and host time of one full-width train step, train tokens/s
    over 20 steps (host clock, one sync at the end), and a traced
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
    print(f"  train step (B{tok.shape[0]} T{tok.shape[1]}): device "
          f"{dev:.3f} ms; with the loss read-back, host clock {host:.3f} "
          f"ms; {n * n_tok / seconds:.1f} train tokens/s over {n} steps "
          f"({seconds:.3f} s, host clock) [{gpu}]")
    busy_share(lambda: step(params, tok, tgt)[0].item(),
               "train step + loss read-back", gpu, steps=5)


def path_times(cfg, params, device, gpu):
    """Median device time of one full-width decode step (8 live slots at
    ragged depths) and of one prefill of a 200-token prompt (bucket 256),
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
        busy_share(lambda: tfm.decode_step_paged(
            params, paged, tokens, positions, table, cfg)[0].argmax(-1)
            .cpu(), "decode step + token read-back", gpu)


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


def busy_share(fn, label, gpu, steps=20, warm=True):
    """Traced window (torch.profiler) over `steps` calls: the share of
    wall time with a kernel running, and the kernels taking the most
    device time. Tracing adds host time, so the busy share is a lower
    bound for an untraced run."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] = (kernels.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us())
    if not kernels:
        print(f"  {label}: the profiler saw no device time; busy share "
              f"not measured [{gpu}]")
        return
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"  {label}, traced over {steps} calls: wall "
          f"{wall_us / steps / 1e3:.3f} ms per call, device busy "
          f"{busy / wall_us:.1%} (idle {1 - busy / wall_us:.1%}) [{gpu}]")
    for name, us in top:
        print(f"    {us / steps:9.1f} us/call  {us / busy:6.1%}  "
              f"{name[:90]}")


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
    t0 = time.perf_counter()
    for name, rec in _build.build().items():
        regs = [ln.strip() for ln in rec["output"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}.cu: {rec['seconds']:.1f} s "
              f"({'cached' if rec['cached'] else 'nvcc'}); ptxas: "
              f"{len(regs)} lines, first: {regs[:2]}")
    print(f"  build {time.perf_counter() - t0:.1f} s")
    print(gpu)

    print("phase 2: kernels against their plain versions")
    errs = kernels_against_plain(device)

    print("phase 3: serving at full width")
    cfg = tfm.TransformerConfig(**FULL)
    params = tfm.init_params(cfg, seed=0, device=device)
    legs = {"off": {}, **LEVER_LEGS}
    served, flash_launches = {}, {}
    for leg, levers in legs.items():
        out = served[leg] = serve(cfg, params, 16, device, **levers)
        print(f"  levers {leg} {levers}: {out['requests_completed']} "
              f"requests, {out['generated_tokens']} tokens, "
              f"{out['engine_steps']} engine steps, {out['decode_steps']} "
              f"decode steps, {out['wide_calls']} wide steps; launches "
              f"{out['launches']}; max_step_prefill_tokens "
              f"{out['max_step_prefill_tokens']}; "
              + ", ".join(f"{k} {out[k]}" for k in (
                  "prefill_tokens_saved", "cow_copies", "prefix_hit_rate",
                  "prefill_chunks", "spec_accepted_tokens",
                  "spec_proposed_tokens") if k in out))
        flash_launches[leg], ties = match_generate(cfg, params, out, device)
        print(f"  tokens equal generate(use_flash=True) for every request "
              f"({ties} near ties); flash_decode launches "
              f"{flash_launches[leg]}")
    if not (served["prefix"]["prefill_tokens_saved"] > 0
            and served["prefix"]["cow_copies"] >= 1):
        raise AssertionError("the prefix leg saved no prefill or copied no "
                             "page")
    if not (served["chunked"]["max_step_prefill_tokens"]
            < served["off"]["max_step_prefill_tokens"]):
        raise AssertionError("chunked prefill did not lower the most "
                             "prefill tokens of any step")

    print("phase 4: training at full width")
    train_cfg = dataclasses.replace(cfg, use_flash=True)
    step, train_params, batch, train_launches = train(train_cfg, device)

    print("phase 5: times")
    for leg, out in served.items():
        print(f"  tokens/s over the trace, levers {leg}: "
              f"{out['tokens_per_sec']:.1f} ({out['generated_tokens']} "
              f"tokens in {out['measured_seconds']:.3f} s, host clock) "
              f"[{gpu}]")
    path_times(cfg, params, device, gpu)
    for leg, levers in legs.items():
        busy_share(lambda: run_trace(params, cfg, n_requests=16,
                                     slots=SLOTS, page_size=PAGE, seed=0,
                                     device=device, **levers),
                   f"whole trace, levers {leg}", gpu, steps=1, warm=False)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    rows = kernel_rows(
        errs, {"paged": served["off"]["launches"]["paged"],
               "flash": flash_launches["off"],
               "wide": sum(served[leg]["launches"]["wide"]
                           for leg in LEVER_LEGS)}, flush, device, gpu)
    train_times(step, train_params, batch, gpu)
    rows += flash_rows(errs, train_launches, flush, device, gpu)
    torch.cuda.synchronize()

    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
