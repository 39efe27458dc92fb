#!/usr/bin/env python3
"""Drive the PyTorch port's serving path (through CUDA graphs, and behind
the fault-tolerant fleet and its HTTP gateway), its transformer train
step, its ResNet-50 train step, gluon's surfaces, the recommender path
(DLRM, the parameter server) and a Faster R-CNN detection pass on one
CUDA card and hold its hand-written kernels against their plain PyTorch
versions.

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
   float32, bfloat16 and float16 (forward 1e-6, 2e-2 and 1e-3; dx, dres
   1e-4, 2e-2 and 2e-2; the channel sums rtol 1e-4, atol 1e-4 *
   sqrt(R / 75)), the backward
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
3b. the fleet: first, an engine's warm() with the collector set to run
   at every allocation must start no collection inside a capture; then
   the same model behind `serving.FleetRouter`, every engine warm()ed
   before it joins, the 16 requests over two tenants, held to
   phase 3's generate(use_flash=True) tokens. Three legs: failover
   (manual ticks on a fake clock, two replicas; the one serving request 0
   dies silently once it has streamed, the heartbeat finds it, a
   replacement joins), rolling (manual ticks, prefix cache, chunked
   prefill of 64 and n-gram speculation on, under
   MXTPU_SANITIZERS=locks,pages: every replica drains in turn after its
   replacement joined, and leaves quiescent) and wire (start() behind a
   `ServingGateway` on 127.0.0.1, 16 concurrent streaming clients, one
   replica silently killed mid-stream and found by a 1 s real-clock
   heartbeat, a replacement warmed while the fleet serves joins it, a
   queue_limit=0 gateway answers 429 with Retry-After; traced, its
   gateway.request -> fleet.dispatch -> serving.request chains, failover
   spans and journal deliveries checked as `tools/trace_merge.py --fleet
   --check` checks them). Every leg: every request done with the
   oracle's tokens, each stream's indexes sequential, nothing lost or
   deduplicated, the expected failovers, no capture after warm(), the
   paged and wide kernels' launches all graph replays equal to layers x
   the replicas' steps; no sanitizer finding in the rolling leg;
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
   largest relative loss gap printed. Then bench.py's headline path from
   the same seeded weights: bfloat16 nets (`net.cast("bfloat16")`)
   unfused and fused, 10 steps each (49 launches of each epilogue kernel
   a step fused, none unfused; step-1 losses within 2e-2 of each other
   and of the float32 unfused leg's; weights and momenta stay bfloat16);
   `compute_dtype="bfloat16"` on the float32 net, fused, 5 steps (float32
   masters and momenta, step 1 within 2e-2); `scan_steps` with K 8,
   float32 and bfloat16, fused, against 8 eager steps of the same step
   over the same batches from the same state, cuDNN deterministic (all 8
   losses at rtol 1e-5 float32, 1e-3 bfloat16; the weights, momenta and
   running stats after the first call against the eager steps', the gap
   over the eager steps' movement at most 1e-5 and 1e-3;
   a planted fault, the warm-up run without its state restore, must fail
   these gates; the first call captures one CUDA graph, a second
   captures nothing and launches each epilogue kernel 49 x 8 times, all
   in its replay); `accum_steps` over 2 micro-batches of 64 (one update,
   the loss the micro-batches' mean at rtol 1e-5, 2 x 49 launches); and
   3 steps each plain and under remat_policy "nothing" and "convs",
   cuDNN deterministic (step 1's loss the unfused leg's at rtol 1e-5,
   steps 2-3 the plain leg's at 1e-5, the running stats after step 1 a
   plain step's at rtol 1e-6, step 1's peak allocation printed; "nothing"
   must peak below plain);
4c. gluon's imperative surface: (a) ResNet-50 v1 at bench.py's setup,
   fused, through examples/gluon_mnist.py's loop (`DataLoader` over an
   `ArrayDataset` of 3 batches from RandomState(0), shuffled ->
   `autograd.record()` -> `net(x)` -> `SoftmaxCrossEntropyLoss` ->
   `backward()` -> `gluon.Trainer("sgd").step(128)`), 6 steps, cuDNN
   deterministic: each epilogue kernel 49 times per step; every loss
   equal to `GluonTrainStep`'s (eager, same weights, batches and SGD) at
   rtol 1e-5, the state after the steps within 1e-5 of its (gap over
   movement) and step 1's gradients of the first and last convolution at
   rtol 2e-4, atol 1e-5; images/s of the loop, of its step and of
   `GluonTrainStep` on the same batches, the host's enqueue time per
   step and the device's busy share over 3 steps; (b) gluon_mnist's loop
   as written, on the card, 2 epochs, cuDNN deterministic, at the
   example's seed 0 and seeds 1-10: every step loss finite, seed 0
   repeated bit for bit, epoch-1 accuracy above 0.85 in more than half
   the draws (one draw is a lottery on rounding at the example's lr);
   (c) every registry op name and extra mode on the card against the
   port's CPU result on tests/torch_op_cases.py's seeded inputs (values
   rtol 1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-5) and every
   sampler by its moments;
4d. gluon's recurrent surface (no kernel of the ten runs on it): (a)
   the reference word LM (example/gluon/word_language_model) at its
   medium width: embedding 650, 2 LSTM layers of 650, dropout 0.5, the
   decoder tied to the embedding, vocabulary 33,278 (WikiText-2's),
   bptt 35, batch 32, tokens drawn as the WikiText-2 stand-in draws
   them; the RNN op against torch.nn.LSTM with the same weights (outputs
   and final states at rtol 1e-4, atol 1e-5); step 1 at dropout 0
   against a float64 run of the port on the CPU (loss rtol 1e-5,
   gradients before clipping rtol 2e-4, atol 1e-5); 10 steps of the
   imperative loop (record, backward, clip_global_norm to 0.2 x bptt x
   batch, Trainer("sgd", lr 20).step) carrying the hidden state
   detached: the loss must fall; tokens/s, step host and device ms,
   busy share and CUDA launches a step; (b) examples/speech_ctc.py as
   written at its defaults (BiLSTM, CTCLoss, Adam through
   GluonTrainStep, 250 steps) with the port's imports: its greedy
   decode must recover the digits; the CTCLoss op on the card against
   float64 on the CPU with and without data and label lengths (rtol
   1e-4, atol 1e-4); (c) alexnet, vgg16_bn, squeezenet1.1, densenet121,
   mobilenet1.0, mobilenetv2_1.0 at 224 and inceptionv3 at 299 (1000
   classes, NCHW, Xavier): batch-2 logits against float64 (rtol 1e-4)
   and the bfloat16-cast net against float32 (rtol 0.1, atol 0.08),
   each atol a share of the largest logit; 2 GluonTrainStep steps at
   batch 32 with finite losses, images/s; (d) the profiler over 2 LM
   steps (aggregate stats on): its chrome trace names the LM's kernels,
   dumps() counts RNN, FullyConnected and Embedding once a step and
   Dropout twice; (e) phase 4c (c) holds the RNN and CTCLoss registry
   cases;
4e. the training toolkit, ResNet-50 v1 at bench.py's setup with the
   epilogue on, cuDNN deterministic: (a) the net cast to bfloat16, SGD lr
   0.05, momentum 0.9, wd 1e-4, multi_precision, MultiFactorScheduler
   (step [2, 4], factor 0.1), 6 steps through the imperative loop
   (Trainer, aggregated), through GluonTrainStep eager and through one
   scan_steps call of K 6: the three losses at rtol 1e-5, the float32
   masters and momenta within 1e-5 of GluonTrainStep's (gap over
   movement), weights bfloat16 and masters float32, each step's rate
   the scheduler's (in float32), 49 launches of each epilogue kernel a
   step (294 credited to the scan's replay), metric.Accuracy and
   TopKAccuracy(5) on each step's logits equal to numpy's; (b) from one
   step's gradients of the float32 net, each case of
   tests/test_optimizer.py's _FUSED_CASES and SGLD at its defaults, 3
   updates fused, through the Trainer's aggregated path and per
   parameter (the registry ops): the three at rtol 1e-5, atol 1e-6, and
   the fused card result against the same updates on the CPU (the stem,
   stage 1 and the classifier); Nadam's fused path and SGLD as JAX holds
   them (SGLD's noise by its moments); 2 GluonTrainStep steps each with
   finite losses and 49 launches a step; each update's device time
   beside its byte bound; (c) MXTPU_STOCHASTIC_ROUNDING on the bfloat16
   net: float32 momenta and no master, 5 updates per parameter,
   aggregated and fused bit-equal, 5 GluonTrainStep steps with finite
   losses and 49 launches a step, and the mean rounding error over 4096
   draws of 1024 values within 4 sigma of 0; (d) at each step boundary
   of (a)'s loop mxtpu_device_bytes_in_use{device="cuda:0"} equal to
   torch.cuda.memory_allocated() and the peak no lower,
   LogTelemetryCallback and Speedometer (injected writer, a log
   handler) recording each step, and `python3 -m
   incubator_mxnet_tpu_torch.bench` --dispatch-overhead and
   --observatory giving ci/perf_baseline.json's deterministic counters;
   then the bfloat16 step's device and host ms and images/s with plain
   SGD, float32 masters and stochastic rounding, cuDNN's default
   algorithms;
4f. the recommender path (no kernel of the ten runs on it: gathers,
   segment sums and lazy updates, plain in the JAX package too): (a)
   the port's `bench.py --recommender --assert` at its defaults (3
   fields, 2 shards, batch 32, 6 batches x 2 epochs, naive then opt),
   its nine exact counters equal to ci/perf_baseline.json's; (b) DLRM
   at the Criteo Kaggle widths (facebookresearch/dlrm
   bench/dlrm_s_criteo_kaggle.sh: 26 tables of the Kaggle category
   counts, 33,762,577 rows x 16 float32 = 2.16 GB on the card, 13 dense
   features, bottom 512-256-64, top 512-256), local arm, random Xavier
   weights (seed 42), batch 128 drawn as the bench draws (zipf(1.3)
   ids, RandomState(11)), SGD lr 0.1 lazy on the tables, 20 steps of
   `autograd.record` -> `backward` -> `Trainer.step`: the first 3 held
   to the CPU path from the same weights (losses rtol 1e-5; touched
   rows and towers rtol 1e-5, atol 1e-6), the 20 rerun from the same
   start bit-equal; host ms, kernel ms and busy share (profiler window),
   launches, unique rows, samples/s and peak allocation a step; (c) the
   same widths through launch_local_fleet(2) with each field capped at
   20,000 rows (207,398 rows, 13.3 MB; the servers' per-row init costs
   about 10 us a row), naive then opt, 2 epochs over 6 batches:
   weights bit-identical, pull RPCs a step opt <= 2 < naive, steady
   retraces 0, worker embedding bytes below the full table's, the
   sparse_pull p50s, through the bench's own `recommender_run`; (d)
   examples/matrix_factorization.py as written, its imports replaced by
   the port's (lazy Adam, 512 x 256 x 16, 4 epochs): RMSE falls,
   per-epoch RMSE equal
   to the CPU's at rtol 1e-5, the user table's gradient row sparse on
   the card with <= 64 rows;
4g. the vision and contrib op families (no kernel of the ten runs on
   them: the JAX package's vision ops are plain jnp too): (a) the
   two-stage detector of examples/rcnn_proposal.py at the widths of the
   reference's Faster R-CNN (Apache MXNet v1.4 example/rcnn, --network
   resnet50, test settings): one 600 x 1000 image (RandomState(0), NCHW),
   ResNet-50 v1 features[:7] as C4 (stride 16, a 38 x 63 x 1024 map),
   an RPN (3 x 3 conv 512 + ReLU, 1 x 1 convs to 18 scores and 36
   deltas), `nd.softmax` over each anchor's pair, `nd._contrib_Proposal`
   (scales 8, 16, 32, ratios 0.5, 1, 2: 21,546 anchors; pre-NMS 6000,
   post-NMS 300, NMS 0.7, min size 16), `nd.ROIPooling` and
   `nd.contrib.ROIAlign` (14 x 14 at 1/16, sample ratio 2),
   features[7] + global pooling + Dense(21) / Dense(84), `nd.softmax`,
   `nd.contrib.box_decode` and `nd.contrib.box_nms` per class (NMS 0.3,
   top 100), Xavier weights (seed 42), float32; each stage held to the
   CPU on the card's own inputs: the Proposal's rois and the final
   NMS's rows at rtol 1e-5, atol 1e-5, or else every decision of the
   card's NMS the greedy rule's under the CPU's IoU but for pairs within
   1e-5 of the threshold (near ties), ROIPooling exactly, ROIAlign at
   rtol 1e-4, atol 1e-5, and one backward through each pooler at rtol
   1e-4, atol 1e-5; the forward's, the Proposal's and each pooler's ms
   (CUDA events, median of 5 after a warm-up), the NMS pass counts and
   the peak allocation; (b) examples/rcnn_proposal.py (recall >= 0.7),
   custom_op_numpy.py and svrg_regression.py as written with the port's
   imports, each printing its OK line; (c) is phase 4c (c), whose
   registry cases include the vision and contrib ops;
4h. reduced precision: (a) ResNet-50 v1 at bench.py's setup through
   `amp.convert_block(net, "float16")` (BatchNorm float32) with the
   knob on (kernels 6-7 in float16, EPI_PER_STEP launches of each a
   step), SGD (momentum 0.9, wd 1e-4, multi_precision) under
   `amp.init_trainer`'s default scaler, steps of the imperative loop
   with `amp.scale_loss` until AMP_APPLIED were applied (the summed
   batch-128 loss's gradients overflow float16 from 2^16 down to about
   2^6, and each overflow halves the scale), each held to the
   reference's policy (an overflowed step leaves every weight and
   optimizer state bit-equal and halves the scale, a clean one moves the
   weights), the scale trail printed; a scale_window 2 scaler from half
   the settled scale that grows it;
   the first applied step against the knob-off chain's (the float32
   masters' gap printed, relative 2-norm over the net; the step's
   movement no farther from a float32 step's than AMP_GAP_FACTOR times
   the unfused chain's); the backoff guardrail with
   grad.nonfinite at a fixed step (skipped, weights bit-equal, one trip,
   a unit scaler at 1.0); one bfloat16 step; (b) ResNet-50 v1 at
   ImageNet widths (NCHW, Xavier seed 0) through `as_chain` and
   `quantize_net` (minmax and entropy over 4 seeded batches of 32): no
   float32 island, the int8 forward's ms against float32 (CUDA events,
   median of 5) and its peak allocation, the mean relative logit error
   against float32, and on 2 images the program rebuilt on the CPU from
   the card's ranges: int8 weights and scales bit-equal, every int8
   code equal, logits at rtol 1e-5; (c) examples/quantized_inference.py
   as written with the port's imports (its own asserts);
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
   ResNet-50 leg's step, host time and images/s (the bfloat16 fused leg
   too), kernels 6-7 in bfloat16 and float16 at the stem and stage-1
   join (float16 held to the plain versions, with its launches in phase
   4h (a)), and
   `python3 -m incubator_mxnet_tpu_torch.bench` with the epilogue on
   (images/s eager and scan, bfloat16 and float32); the fleet's wire
   leg
   (tokens/s, TTFT and request latency p50 and largest, the failover
   pause from the kill to the survivor's first token of a resubmitted
   request, and the device's busy share over a threaded round); then
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
import faulthandler
import gc
import http.client
import importlib.util
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.analysis import sanitizers
from incubator_mxnet_tpu_torch.contrib import amp
from incubator_mxnet_tpu_torch.contrib import quantization as q
from incubator_mxnet_tpu_torch.fused import GluonTrainStep
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.gluon.utils import load_numpy_params
from incubator_mxnet_tpu_torch.models import transformer as tfm
from incubator_mxnet_tpu_torch.ops import _build
from incubator_mxnet_tpu_torch.ops import epilogue as rewrite
from incubator_mxnet_tpu_torch.ops.kernels import decode as dk
from incubator_mxnet_tpu_torch.ops.kernels import epilogue as ep
from incubator_mxnet_tpu_torch.ops.kernels import flash as fl
from incubator_mxnet_tpu_torch.ops.kernels import xent as xt
from incubator_mxnet_tpu_torch.ops import quantized as qops
from incubator_mxnet_tpu_torch.ops import vision as tv
from incubator_mxnet_tpu_torch.parallel import moe
from incubator_mxnet_tpu_torch.resilience import fault
from incubator_mxnet_tpu_torch import profiler, telemetry
from incubator_mxnet_tpu_torch.serving import (
    FleetRouter, PageAllocator, ServingEngine, ServingGateway, run_trace)
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
# Idle host time at each end of a profiler window. Kineto keeps only the
# device records whose times, mapped onto the host clock, fall inside its
# window, and a mapped record strays from its own launch call by up to
# milliseconds (tools/profiler_clock_probe.py); without the margins the
# first or last kernels of a window can go missing from its records.
WINDOW_MARGIN_S = 0.05
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
# forward: float16 is one rounding of the float32 result (rtol 1e-3)
EPI_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2, torch.float16: 1e-3}
EPI_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2,
                torch.float16: 2e-2}  # dx, dres
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
    """Kernels 6 and 7 against their plain versions, float32, bfloat16 and
    float16, with and without the residual, and the backward run twice for
    bit equality (its channel sums take a fixed order). Forward 1e-6 (2e-2
    bfloat16, 1e-3 float16), dx and dres 1e-4 (2e-2):
    tests/test_memory_traffic.py's (the bfloat16 one for float16).
    The channel sums differ from the plain version's only in the order of
    float32 additions, whose error grows as the square root of the rows
    summed: they are held to 1e-4 scaled by sqrt(R / 75), 1e-4 at the
    75 rows where that test sets it."""
    cases = [(label, R, C, res, 0) for label, (R, C) in EPI_CASES.items()
             for res in (False, True)]
    cases.append(("unaligned R1001 C64", 1001, 64, True, 1))
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
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


def near_tie(cfg, params, label, prompt, got, ref, device):
    """0 when `got` equals the reference tokens `ref`; 1 when they part at
    a near tie (top-2 margin below NEAR_TIE at the first difference, the
    rest not compared); raises otherwise."""
    if got == ref:
        return 0
    i = next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b),
             min(len(got), len(ref)))
    if i >= min(len(got), len(ref)):
        raise AssertionError(f"{label}: {len(got)} tokens, the reference "
                             f"has {len(ref)}")
    seq = torch.as_tensor(np.concatenate([prompt, ref[:i]]), device=device)
    margin = top2_margin(params, cfg, seq)
    if margin >= NEAR_TIE:
        raise AssertionError(
            f"{label}: token {i} is {got[i]}, generate() gives {ref[i]} "
            f"(top-2 margin {margin:.3e})")
    print(f"  {label}: near tie at token {i} (top-2 margin {margin:.3e} < "
          f"{NEAR_TIE:g}); rest of it not compared")
    return 1


def match_generate(cfg, params, served, device):
    """Every request's tokens against generate(use_flash=True), counting
    the flash_decode kernel's launches from zero over these calls.
    Returns the launches, the near ties and the oracle: each request's
    prompt, budget and generate() tokens, in trace order."""
    flash_cfg = dataclasses.replace(cfg, use_flash=True)
    dk.flash_decode.launches = 0
    expected, ties, oracle = 0, 0, []
    for r in served["trace"]:
        got = served["results"][r["rid"]].tokens
        ref = tfm.generate(params, r["prompt"][None], len(got), flash_cfg,
                           device=device)[0].tolist()
        expected += (len(got) - 1) * cfg.n_layers
        oracle.append({"prompt": r["prompt"], "max_new": r["max_new"],
                       "ref": ref})
        ties += near_tie(cfg, params, f"request {r['rid']}", r["prompt"],
                         got, ref, device)
    if dk.flash_decode.launches != expected:
        raise AssertionError(f"flash_decode launched "
                             f"{dk.flash_decode.launches} times, expected "
                             f"{expected}")
    return dk.flash_decode.launches, ties, oracle


# -- phase 3b: the fleet at full width ---------------------------------------

FLEET_HEARTBEAT = 0.4  # heartbeat timeout of the manual legs, fake seconds
FLEET_TICK = 0.05      # fake seconds per manual tick
WIRE_HEARTBEAT = 1.0   # heartbeat timeout of the wire leg, real seconds
# seconds phase 3b may run before every thread's stack is printed and the
# process exits: a hung fleet fails the call instead of holding the card
FLEET_WATCHDOG = 300
ROLLING_LEVERS = dict(prefix_cache=1, prefill_chunk=64, spec_ngram=2,
                      spec_lookahead=4)
FLEET_KERNELS = {"paged": dk.paged_decode_attention,
                 "wide": dk.paged_decode_attention_wide}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def site_signatures(eng):
    """{(site, signature)} an engine has captured (on the CPU: run)."""
    return {(name, sig) for name, site in eng.sites().items()
            for sig in (*site._graphs, *site._eager)}


class FleetLeg:
    """One fleet leg: its engines, every one `warm()`ed before it joins,
    and the gates every leg holds."""

    def __init__(self, label, cfg, params, device, clock=None, levers=None):
        self.label, self.cfg, self.params = label, cfg, params
        self.device, self.clock = device, clock
        self.levers = levers or {}
        self.engines, self.warmed = [], {}
        self.counting = False
        # eager launches of the captures' warm-up runs of engines warmed
        # after the counts were zeroed: real launches, not replays
        self.warmup = {key: 0 for key in FLEET_KERNELS}
        self.t0 = time.perf_counter()

    def engine(self):
        kw = {} if self.clock is None else {"clock": self.clock}
        eng = ServingEngine(self.params, self.cfg, slots=SLOTS,
                            page_size=PAGE, device=self.device, **kw,
                            **self.levers)
        warm = eng.warm()
        want = "captured" if self.device.type == "cuda" else "eager"
        if set(warm.values()) != {want}:
            raise AssertionError(f"{self.label}: warm() left sites "
                                 f"uncaptured: {warm}")
        self.warmed[id(eng)] = site_signatures(eng)
        self.engines.append(eng)
        if self.counting:
            for key, kernel in FLEET_KERNELS.items():
                self.warmup[key] += sum(
                    n.get(kernel.__name__, 0)
                    for site in eng.sites().values()
                    for n in site.warmup_launches.values())
        return eng

    def start_counting(self):
        for kernel in FLEET_KERNELS.values():
            kernel.launches = 0
        self.counting = True

    def check(self, router, ids, oracle, streams, failovers):
        """Every request done with the oracle's tokens (or a near tie),
        each client stream's indexes sequential, nothing lost or deduped,
        the failovers expected, no capture after warm(), and the paged and
        wide kernels' launches all graph replays, equal to layers x the
        replicas' steps (the dead replica's included), but for the eager
        warm-up runs of the captures of replacements warmed in the leg."""
        if not router.idle():
            raise AssertionError(f"{self.label}: fleet never went idle; "
                                 f"journal {router.journal.snapshot()}")
        ties = 0
        for i, (eid, r) in enumerate(zip(ids, oracle)):
            res = router.result(eid)
            if res["state"] != "done":
                raise AssertionError(f"{self.label}: request {i} ended "
                                     f"{res['state']} ({res['error']})")
            ties += near_tie(self.cfg, self.params,
                             f"{self.label} request {i}", r["prompt"],
                             res["tokens"], r["ref"], self.device)
            toks = [ev for ev in streams[i] if ev.get("event") == "token"]
            if ([ev["index"] for ev in toks] != list(range(len(toks)))
                    or [ev["token"] for ev in toks] != res["tokens"]):
                raise AssertionError(f"{self.label}: request {i}'s stream "
                                     f"is not its tokens in order")
        snap = router.journal.snapshot()
        if snap["lost"] or snap["dup_tokens_dropped"]:
            raise AssertionError(f"{self.label}: journal {snap}")
        if router.failovers != failovers:
            raise AssertionError(f"{self.label}: {router.failovers} "
                                 f"failovers, expected {failovers}")
        steady = sum(len(site_signatures(eng) - self.warmed[id(eng)])
                     for eng in self.engines)
        if steady:
            raise AssertionError(f"{self.label}: {steady} captures after "
                                 f"warm()")
        steps = {"paged": sum(e.decode_steps for e in self.engines),
                 "wide": sum(e.wide_calls for e in self.engines)}
        launches = {}
        for key, kernel in FLEET_KERNELS.items():
            replayed = sum(site.replayed_launches().get(kernel.__name__, 0)
                           for eng in self.engines
                           for site in eng.sites().values())
            want = steps[key] * self.cfg.n_layers
            if self.device.type == "cuda" and not (
                    kernel.launches - self.warmup[key] == replayed == want):
                raise AssertionError(
                    f"{self.label}: {key} kernel launched {kernel.launches} "
                    f"times, {self.warmup[key]} in the warm-up runs of "
                    f"captures, {replayed} in graph replays; expected "
                    f"{want} (steps x layers) replayed")
            launches[key] = replayed
        used = "wide" if self.levers.get("spec_ngram") else "paged"
        if self.device.type == "cuda" and not launches[used]:
            raise AssertionError(f"{self.label}: the {used} kernel never "
                                 f"ran")
        return {"ties": ties, "launches": launches, "steps": steps,
                "warmup": dict(self.warmup),
                "capture_ms": 1e3 * max(
                    (sec for eng in self.engines
                     for site in eng.sites().values()
                     for sec in site.capture_seconds.values()), default=0.0),
                "engines": len(self.engines), "resubmits": router.resubmits,
                "failovers": router.failovers, "drains": router.drains,
                "journal": snap, "seconds": time.perf_counter() - self.t0}


def fleet_report(label, out):
    print(f"  {label}: {len(out['ids'])} requests done, tokens equal to "
          f"generate(use_flash=True) ({out['ties']} near ties), every "
          f"stream sequential; failovers {out['failovers']}, resubmits "
          f"{out['resubmits']}, drains {out['drains']}, lost "
          f"{out['journal']['lost']}, dup_tokens_dropped "
          f"{out['journal']['dup_tokens_dropped']}; {out['engines']} "
          f"engines, decode / wide steps {out['steps']['paged']} / "
          f"{out['steps']['wide']}, paged / wide launches "
          f"{out['launches']['paged']} / {out['launches']['wide']} in "
          f"graph replays, layers x steps (and {out['warmup']['paged']} / "
          f"{out['warmup']['wide']} eager in the warm-up runs of "
          f"replacements' captures); steady captures 0, the slowest "
          f"capture {out['capture_ms']:.1f} ms; "
          f"{out['seconds']:.1f} s")


def submit_all(router, oracle, streams, first=0, count=None):
    stop = len(oracle) if count is None else first + count
    return [router.submit(r["prompt"], r["max_new"], tenant=f"t{i % 2}",
                          sink=streams[i].append)
            for i, r in enumerate(oracle[first:stop], start=first)]


def fleet_failover(cfg, params, oracle, device):
    """Manual ticks on a fake clock, two replicas: the one serving request
    0 dies silently once it has streamed some tokens, the heartbeat
    timeout finds it, its requests resume on the survivor, and a
    replacement joins."""
    clk = FakeClock()
    leg = FleetLeg("failover", cfg, params, device, clock=clk)
    router = FleetRouter(clock=clk, heartbeat_timeout=FLEET_HEARTBEAT)
    for _ in range(2):
        router.add_replica(leg.engine())
    leg.start_counting()
    streams = [[] for _ in oracle]
    ids = submit_all(router, oracle, streams)
    entry = router.journal.get(ids[0])
    for _ in range(100):
        router.tick()
        clk.t += FLEET_TICK
        if 0 < len(entry.tokens) < entry.max_new_tokens:
            break
    else:
        raise AssertionError("failover: request 0 never streamed mid-way")
    victim, streamed = entry.replica_id, len(entry.tokens)
    router.kill(victim)
    replaced = False
    for _ in range(5000):
        if router.idle():
            break
        router.tick()
        clk.t += FLEET_TICK
        if not replaced and router.healthy_count() < 2:
            router.add_replica(leg.engine())
            replaced = True
    out = leg.check(router, ids, oracle, streams, failovers=1)
    if not replaced or entry.resubmits != 1:
        raise AssertionError("failover: no replacement joined, or request "
                             "0 was not resubmitted once")
    out.update(ids=ids, victim=victim, streamed=streamed)
    return out


def fleet_rolling(cfg, params, oracle, device):
    """Manual ticks, every lever on, under MXTPU_SANITIZERS=locks,pages
    (armed for this leg only: its patches are process-wide): every
    replica drains in turn after its replacement joined, requests keep
    arriving, and each replica that leaves proves its pages quiescent."""
    os.environ["MXTPU_SANITIZERS"] = "locks,pages"
    sanitizers.refresh_from_env()
    try:
        clk = FakeClock()
        leg = FleetLeg("rolling", cfg, params, device, clock=clk,
                       levers=ROLLING_LEVERS)
        router = FleetRouter(clock=clk, heartbeat_timeout=30.0)
        old = [router.add_replica(leg.engine()) for _ in range(2)]
        for rep in old:
            if (type(rep.engine._lock).__name__ != "_SanRLock"
                    or rep.engine._page_san is None):
                raise AssertionError("rolling: the engine is not sanitized")
        leg.start_counting()
        streams = [[] for _ in oracle]
        n0 = len(oracle) // 2
        ids = submit_all(router, oracle, streams, 0, n0)
        for _ in range(3):
            router.tick()
            clk.t += 0.01
        per_roll = -(-(len(oracle) - n0) // len(old))
        for rep in old:
            router.add_replica(leg.engine())
            router.drain(rep.replica_id)
            ids += submit_all(router, oracle, streams, len(ids), per_roll)
            for _ in range(5000):
                if rep.state == "left":
                    break
                router.tick()
                clk.t += 0.01
            else:
                raise AssertionError(f"rolling: {rep.replica_id} never "
                                     f"finished draining")
        for _ in range(5000):
            if router.idle():
                break
            router.tick()
            clk.t += 0.01
        out = leg.check(router, ids, oracle, streams, failovers=0)
        findings = sanitizers.report()
    finally:
        del os.environ["MXTPU_SANITIZERS"]
        sanitizers.refresh_from_env()
    if router.drains != len(old) or len(ids) != len(oracle):
        raise AssertionError(f"rolling: {router.drains} drains, {len(ids)} "
                             f"requests")
    if findings:
        raise AssertionError(f"rolling: sanitizer findings:\n{findings}")
    out.update(ids=ids, findings=len(findings))
    return out


def wire_client(port, i, r, out):
    """One streaming HTTP client: each NDJSON event stamped with the host
    clock as it arrives."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t_send = time.monotonic()
        conn.request("POST", "/v1/generate", json.dumps(
            {"prompt": [int(t) for t in r["prompt"]],
             "max_new_tokens": r["max_new"], "tenant": f"t{i % 2}"}))
        resp = conn.getresponse()
        events = []
        for line in iter(resp.readline, b""):
            if line.strip():
                events.append(dict(json.loads(line), t=time.monotonic()))
        out[i] = (resp.status, events, t_send)
    finally:
        conn.close()


def wire_round(port, oracle, during=None):
    """16 concurrent streaming clients; `during()` runs on this thread
    while they stream. Returns {i: (status, events, send time)}."""
    out = {}
    threads = [threading.Thread(target=wire_client, args=(port, i, r, out),
                                daemon=True, name=f"smoke-client-{i}")
               for i, r in enumerate(oracle)]
    for t in threads:
        t.start()
    if during is not None:
        during()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise AssertionError(f"wire: {t.name} never finished")
    for i in range(len(oracle)):
        status, events, _ = out[i]
        if status != 200 or [e["event"] for e in events][-1] != "done":
            raise AssertionError(f"wire: client {i}: HTTP {status}, "
                                 f"{events[-2:]}")
    return out


def fleet_chains(records, ids, router):
    """The wire leg's MXTRACE1 records, checked as `tools/trace_merge.py
    --fleet --check` checks them (that tool imports the JAX package):
    every request has its gateway.request root, every fleet.dispatch
    parents under its request's root and every serving.request under a
    fleet.dispatch of the same trace; each failed-over request has one
    fleet.failover span per failover fleet.resubmit, with spans of its
    trace on the survivor's lane, and on the victim's when it streamed
    there before the kill; the journal's
    deliveries tile each request's positions once, in order."""
    spans = [r for r in records if r.get("kind") is None]
    deliveries = [r for r in records if r.get("kind") == "fleet_delivery"]

    def named(name):
        return [r for r in spans if r["name"] == name]

    roots = {r["extra"]["entry"]: r for r in named("gateway.request")
             if r["extra"]["entry"] is not None}  # not the 429's
    if set(roots) != set(ids):
        raise AssertionError(f"trace: gateway roots for {sorted(roots)}, "
                             f"requests {sorted(ids)}")
    dispatch = {r["sid"]: r for r in named("fleet.dispatch")}
    for r in dispatch.values():
        root = roots[r["extra"]["entry"]]
        if r["tid"] != root["tid"] or r.get("pid") != root["sid"]:
            raise AssertionError(f"trace: dispatch of entry "
                                 f"{r['extra']['entry']} not under its root")
    served = named("serving.request")
    for r in served:
        parent = dispatch.get(r.get("pid"))
        if parent is None or parent["tid"] != r["tid"]:
            raise AssertionError(f"trace: serving.request on {r['lane']} "
                                 f"orphaned (broken causal chain)")
    if {r["tid"] for r in served} != {r["tid"] for r in roots.values()}:
        raise AssertionError("trace: a request has no finished "
                             "serving.request")
    lanes = {}
    for r in records:
        lanes.setdefault(r.get("tid"), set()).add(r.get("lane"))
    failovers = named("fleet.failover")
    resubs = [r for r in named("fleet.resubmit")
              if r["extra"]["reason"] == "failover"]
    if not failovers or sorted(r["extra"]["entry"] for r in failovers) \
            != sorted(r["extra"]["entry"] for r in resubs):
        raise AssertionError(f"trace: {len(failovers)} failover spans for "
                             f"{len(resubs)} failover resubmissions")
    for r in failovers:
        # the victim's lane holds the request's spans once it streamed
        # there; one dispatched to it just before the kill never ran
        sides = ("victim", "survivor") if r["extra"]["resume_pos"] \
            else ("survivor",)
        for side in sides:
            if r["extra"][side] not in lanes[r["tid"]]:
                raise AssertionError(f"trace: entry {r['extra']['entry']} "
                                     f"has no span on its {side}'s lane")
    for eid in ids:
        pos = 0
        for d in sorted((d for d in deliveries if d["entry"] == eid),
                        key=lambda d: d["start"]):
            if d["start"] != pos:
                raise AssertionError(f"trace: entry {eid} delivered position "
                                     f"{d['start']} at {pos}")
            pos += d["n"]
        if pos != len(router.result(eid)["tokens"]):
            raise AssertionError(f"trace: entry {eid}: {pos} positions "
                                 f"delivered")
    return {"records": len(records), "failover_spans": len(failovers),
            "deliveries": len(deliveries)}


def fleet_wire(cfg, params, oracle, device, gpu, trace_dir):
    """start() plus a ServingGateway on 127.0.0.1, tracing on: 16
    concurrent streaming clients over two tenants; one replica silently
    killed mid-stream and found by the real-clock heartbeat; a replacement
    warmed while the fleet serves (its captures beside the survivor's
    replays) joins the running fleet; a queue_limit=0 gateway answers 429
    with Retry-After. Then one more round on the healed fleet, untraced,
    under the profiler: the device's busy share."""
    leg = FleetLeg("wire", cfg, params, device)
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.environ["MXTPU_TRACE_DIR"] = trace_dir
    tdist.refresh_from_env()
    router = FleetRouter(heartbeat_timeout=WIRE_HEARTBEAT)
    gw = None
    try:
        reps = [router.add_replica(leg.engine()) for _ in range(2)]
        leg.start_counting()
        router.start()
        gw = ServingGateway(router, port=0, queue_limit=64,
                            max_occupancy=0.99)
        kill = {}

        def kill_and_replace():
            victim = reps[0].replica_id
            deadline = time.monotonic() + 60

            def mid_stream():
                return any(0 < len(e.tokens) < e.max_new_tokens
                           for e in router.journal.assigned_to(victim))

            # checked under the victim's lock: it cannot finish the
            # request between the check and its death
            while not router.kill(victim, when=mid_stream):
                if time.monotonic() > deadline:
                    raise AssertionError("wire: nothing streamed mid-way "
                                         "on the victim")
                time.sleep(0.001)
            kill["t"] = time.monotonic()
            # positions the survivors resume from: nothing more arrives
            # from the victim once kill() returned
            kill["resume"] = {e.entry_id: len(e.tokens)
                              for e in router.journal.assigned_to(victim)}
            t0 = time.perf_counter()
            kill["replacement"] = router.add_replica(leg.engine())
            kill["warm_s"] = time.perf_counter() - t0

        t_start = time.monotonic()
        got = wire_round(gw.port, oracle, during=kill_and_replace)
        t_end = time.monotonic()
        ids = [events[-1]["entry_id"] for _, events, _ in
               (got[i] for i in range(len(oracle)))]
        streams = [got[i][1] for i in range(len(oracle))]
        out = leg.check(router, ids, oracle, streams, failovers=1)
        gw2 = ServingGateway(router, port=0, queue_limit=0,
                             max_occupancy=0.99)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", gw2.port,
                                              timeout=30)
            conn.request("POST", "/v1/generate", json.dumps(
                {"prompt": [1, 2, 3], "max_new_tokens": 4}))
            resp = conn.getresponse()
            retry_after = resp.getheader("Retry-After")
            resp.read()
            conn.close()
        finally:
            gw2.close()
        if resp.status != 429 or not retry_after:
            raise AssertionError(f"wire: a queue_limit=0 gateway answered "
                                 f"{resp.status} (Retry-After "
                                 f"{retry_after})")
        del os.environ["MXTPU_TRACE_DIR"]
        tdist.refresh_from_env()  # flushes and closes the trace file
        records = [rec for f in sorted(os.listdir(trace_dir))
                   if f.endswith(".mxtrace")
                   for rec in tdist.read_trace_file(
                       os.path.join(trace_dir, f))]
        out["trace"] = fleet_chains(records, ids, router)
        entries = [router.journal.get(eid) for eid in ids]
        pauses = [ev["t"] - kill["t"] for i, eid in enumerate(ids)
                  if eid in kill["resume"] for ev in got[i][1]
                  if ev["event"] == "token"
                  and ev["index"] == kill["resume"][eid]]
        if not pauses:
            raise AssertionError("wire: no resubmitted request streamed "
                                 "after the kill")
        ttft = [e.first_token_at - e.submitted_at for e in entries]
        latency = [e.finished_at - e.submitted_at for e in entries]
        tokens = sum(len(e.tokens) for e in entries)
        out.update(
            ids=ids, tokens=tokens, wall_s=t_end - t_start,
            tokens_per_s=tokens / (t_end - t_start),
            ttft_p50=float(np.median(ttft)), ttft_max=max(ttft),
            latency_p50=float(np.median(latency)), latency_max=max(latency),
            pause_s=min(pauses), resubmitted=len(pauses),
            replacement_warm_s=kill["warm_s"], status_429=resp.status)
        # the healed fleet (the survivor and the replacement), untraced,
        # under the profiler, whose start may stall the pump threads: a
        # longer heartbeat keeps that from reading as a death
        router.heartbeat_timeout = 30.0
        t0 = time.perf_counter()
        wire_round(gw.port, oracle)
        out["round_s"] = time.perf_counter() - t0
        busy = {}
        busy_share(lambda: wire_round(gw.port, oracle),
                   "threaded fleet, 2 replicas behind the gateway, 16 "
                   "streams", gpu, steps=1, warm=False, stats=busy)
        if router.failovers != 1 or router.journal.snapshot()["lost"]:
            raise AssertionError(f"wire: the profiled round: failovers "
                                 f"{router.failovers}, journal "
                                 f"{router.journal.snapshot()}")
        out["busy"], out["profiled_s"] = busy.get("busy"), busy.get("wall_s")
    finally:
        if os.environ.pop("MXTPU_TRACE_DIR", None) is not None:
            tdist.refresh_from_env()  # a failed leg: close the trace
        if gw is not None:
            gw.close()
        router.stop()
    return out


def warm_without_collections(cfg, params, device):
    """warm() a full-width engine with the collector set to run at almost
    every allocation, and count the collections that started on a thread
    inside a capture: there must be none. One there can free a dead
    engine's graphs, which invalidates the capture (ROADMAP Queue C 4);
    `graphs` pauses the collector for the capture proper. Collections
    outside the captures must have run, or the check saw nothing."""
    inside, outside = [], []

    def watch(phase, info):
        if phase == "start":
            (inside if torch.cuda.is_current_stream_capturing()
             else outside).append(info["generation"])

    eng = ServingEngine(params, cfg, slots=SLOTS, page_size=PAGE,
                        device=device)
    threshold = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(1, 10**9, 10**9)  # the youngest generation only
    try:
        warm = eng.warm()
    finally:
        gc.set_threshold(*threshold)
        gc.callbacks.remove(watch)
    if inside or not outside or set(warm.values()) != {"captured"}:
        raise AssertionError(f"warm() with a busy collector: {len(inside)} "
                             f"collections inside captures, "
                             f"{len(outside)} outside; {warm}")
    print(f"  warm() with the collector run at every allocation: "
          f"{len(warm)} captures, {len(outside)} collections outside "
          f"them, none inside")


def fleet_legs(cfg, params, oracle, device, gpu, trace_dir):
    """Phase 3b: the three fleet legs over phase 3's model, each held to
    phase 3's generate(use_flash=True) tokens."""
    faulthandler.dump_traceback_later(FLEET_WATCHDOG, exit=True)
    try:
        return _fleet_legs(cfg, params, oracle, device, gpu, trace_dir)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _fleet_legs(cfg, params, oracle, device, gpu, trace_dir):
    t0 = time.perf_counter()
    warm_without_collections(cfg, params, device)
    legs = {"failover": fleet_failover(cfg, params, oracle, device)}
    fleet_report("failover (manual ticks, fake clock, 2 replicas + 1)",
                 legs["failover"])
    print(f"    victim {legs['failover']['victim']} killed after request 0 "
          f"streamed {legs['failover']['streamed']} token(s)")
    legs["rolling"] = fleet_rolling(cfg, params, oracle, device)
    fleet_report(f"rolling (manual ticks, {ROLLING_LEVERS}, "
                 f"MXTPU_SANITIZERS=locks,pages)", legs["rolling"])
    print(f"    sanitizer findings {legs['rolling']['findings']}; every "
          f"replica left quiescent")
    legs["wire"] = fleet_wire(cfg, params, oracle, device, gpu, trace_dir)
    fleet_report("wire (start(), gateway, 16 streaming clients, real-clock "
                 "heartbeat 1 s)", legs["wire"])
    w = legs["wire"]
    print(f"    replacement warmed beside the serving fleet in "
          f"{w['replacement_warm_s']:.2f} s and joined it; queue_limit=0 "
          f"gateway: HTTP {w['status_429']} with Retry-After; traced: "
          f"{w['trace']['records']} records, chains complete, "
          f"{w['trace']['failover_spans']} fleet.failover span(s), "
          f"{w['trace']['deliveries']} deliveries, no position twice")
    legs["seconds"] = time.perf_counter() - t0
    print(f"  phase 3b: {legs['seconds']:.1f} s")
    return legs


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
    stats = {n: p.tensor().clone() for n, p in params.items()
             if p.grad_req == "null"}
    net.train()
    loss = resnet_loss(net, x, y)
    loss = loss.to(torch.promote_types(loss.dtype, torch.float32)).mean()
    net.train(False)
    names = [n for n, p in params.items() if p.grad_req != "null"]
    grads = torch.autograd.grad(loss, [params[n].tensor() for n in names])
    with torch.no_grad():
        for n, v in stats.items():
            params[n].tensor().copy_(v)
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
                          norm.gamma.tensor(), norm.beta.tensor()]
                r = None
                if residual:
                    r = res.view(B, H, W, C).detach().requires_grad_()
                    leaves.append(r)
                y = rewrite.bn_act(norm, leaves[0], r)
                grads = torch.autograd.grad(y, leaves, dy.view(B, H, W, C))
                out[knob] = (y.detach().view(R, C),
                             [t.reshape(-1, C) if t.dim() > 1 else t
                              for t in grads],
                             norm.running_mean.tensor(),
                             norm.running_var.tensor())
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


# -- phase 4: bench.py's headline path (bfloat16, scan, accum, remat) --------

SCAN_K = 8        # bench.py's BENCH_SCAN
ACCUM = (2, 64)   # micro-batches x micro-batch size
TOL_BF16 = 2e-2


def resnet_net(batch, device, cast=None):
    """`resnet50` at the seeded weights, cast to `cast` if given."""
    net = resnet50(batch[0], device)
    if cast is not None:
        net.cast(cast)
    return net


def resnet_step(net, device, **kw):
    return GluonTrainStep(net, resnet_loss, tmx.optimizer.SGD(**RESNET_SGD),
                          device=device, **kw)


def running_stats(net):
    """{name without the net's prefix: a copy of the running stat}."""
    return {n[len(net.prefix):]: p.tensor().clone()
            for n, p in net.collect_params().items() if p.grad_req == "null"}


def eager_leg(label, batch, device, fused, steps, cast=None, per_step=None,
              **kw):
    """`steps` eager steps of a fresh seeded ResNet-50 (cast to `cast`,
    GluonTrainStep options `kw`), the knob set by `fused`; each step must
    launch each epilogue kernel `per_step` times (EPI_PER_STEP fused, 0
    unfused, by default). Returns the net, step, losses, the running stats
    after step 1 and the step's peak growth of allocated device memory
    (step 1, above what was allocated before it)."""
    os.environ["MXTPU_FUSED_EPILOGUE"] = "1" if fused else "0"
    want = (EPI_PER_STEP if fused else 0) if per_step is None else per_step
    x, y = batch
    net = resnet_net(batch, device, cast)
    if cast is not None:
        x = x.to(getattr(torch, cast))
    step = resnet_step(net, device, **kw)
    losses, stats1, peak = [], None, None
    t0 = time.perf_counter()
    for i in range(steps):
        before = [k.launches for k in EPI_KERNELS]
        if i == 0:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        losses.append(step(x, y))
        if i == 0:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            stats1 = running_stats(net)
        for k, b in zip(EPI_KERNELS, before):
            if k.launches - b != want:
                raise AssertionError(f"{label}: {k.__name__} launched "
                                     f"{k.launches - b} times in step "
                                     f"{i + 1}, expected {want}")
    losses = torch.stack(losses).tolist()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: non-finite loss {losses}")
    seconds = time.perf_counter() - t0
    print(f"  {label}: {steps} steps in {seconds:.1f} s; losses "
          f"{[round(v, 5) for v in losses]}; {want} launches of each "
          f"epilogue kernel per step; step 1 allocated "
          f"{peak / 2**30:.3f} GiB above its start")
    return dict(net=net, step=step, losses=losses, stats1=stats1, peak=peak,
                x=x, y=y)


def near(label, got, want, rtol):
    if not np.isclose(got, want, rtol=rtol, atol=0):
        raise AssertionError(f"{label}: {got} against {want} (rtol {rtol})")
    print(f"  {label}: {got:.6f} against {want:.6f} (rtol {rtol:g})")


def dtypes_of(step, dtype, label):
    bad = [str(t.dtype) for t in step.weights + [s for s in step.states
                                                 if s is not None]
           if t.dtype != dtype]
    if bad:
        raise AssertionError(f"{label}: weights or momenta left {dtype}: "
                             f"{sorted(set(bad))}")


def bf16_legs(batch, device, f32_loss1):
    """bfloat16 nets (`net.cast("bfloat16")`), unfused then fused, 10 eager
    steps each from the same weights; then `compute_dtype="bfloat16"` on
    a float32 net, fused, 5 steps. Step-1 losses within 2e-2 of each other
    and of the float32 unfused leg's; weights and momenta keep their
    dtypes."""
    t0 = time.perf_counter()
    legs = {}
    for leg, fused in (("bf16 unfused", False), ("bf16 fused", True)):
        legs[leg] = eager_leg(f"leg resnet50_v1 {leg}", batch, device, fused,
                              RESNET["steps"], cast="bfloat16")
        dtypes_of(legs[leg]["step"], torch.bfloat16, leg)
    near("bf16 step 1 loss, fused against unfused",
         legs["bf16 fused"]["losses"][0], legs["bf16 unfused"]["losses"][0],
         TOL_BF16)
    for leg in ("bf16 unfused", "bf16 fused"):
        near(f"{leg} step 1 loss against float32 unfused",
             legs[leg]["losses"][0], f32_loss1, TOL_BF16)
    legs["compute_dtype"] = eager_leg(
        "leg resnet50_v1 compute_dtype=bfloat16 fused", batch, device, True,
        5, compute_dtype="bfloat16")
    dtypes_of(legs["compute_dtype"]["step"], torch.float32, "compute_dtype")
    near("compute_dtype step 1 loss against float32 unfused",
         legs["compute_dtype"]["losses"][0], f32_loss1, TOL_BF16)
    print(f"  bfloat16 legs {time.perf_counter() - t0:.1f} s")
    return legs


# scan against eager, both under cuDNN's deterministic algorithms (with
# its default ones float32 trajectories part after step 1, as PERF.md
# records; bfloat16 ones did not): the losses (step 1, later steps) at
# these rtols, and the state gaps ||scan - eager|| / ||eager - start||
# over the weights, the momenta and the running stats, each group whole
SCAN_LOSS_RTOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-3, 1e-3)}
SCAN_STATE_GAP = {"float32": 1e-5, "bfloat16": 1e-3}


def state_copies(step):
    return [t.detach().clone() for t in step._mutable()]


def set_state(step, state):
    with torch.no_grad():
        for t, v in zip(step._mutable(), state):
            t.copy_(v)


def state_gaps(step, got, want, start):
    """{group: ||got - want|| / ||want - start||} over the weights, the
    running stats and the momenta (`step._mutable()`'s order)."""
    n_w, n_a = len(step.weights), len(step.aux)
    out = {}
    for group, sl in (("weights", slice(0, n_w)),
                      ("running stats", slice(n_w, n_w + n_a)),
                      ("momenta", slice(n_w + n_a, None))):
        diff = sum(float((g.double() - w.double()).norm() ** 2)
                   for g, w in zip(got[sl], want[sl]))
        moved = sum(float((w.double() - s.double()).norm() ** 2)
                    for w, s in zip(want[sl], start[sl]))
        out[group] = (diff / moved) ** 0.5 if moved else float(diff > 0)
    return out


def scan_check(label, dtype, got, want, gaps):
    """The failures of a scan's losses and state against eager's."""
    (rtol1, rtol), limit = SCAN_LOSS_RTOL[dtype], SCAN_STATE_GAP[dtype]
    bad = [f"step {k + 1} loss {a} against {b}"
           for k, (a, b) in enumerate(zip(got, want))
           if not np.isclose(a, b, rtol=rtol if k else rtol1, atol=0)]
    bad += [f"{g} gap {v:.3e}" for g, v in gaps.items() if not v <= limit]
    return bad


def scan_leg(label, device, cast, planted_fault=False):
    """`scan_steps` with K = SCAN_K, fused, against SCAN_K eager steps of
    the same step object over the same batches from the same state (one
    eager step in, so the momenta and running stats are not at their
    initial values): all K losses at SCAN_LOSS_RTOL, and the weights,
    momenta and running stats after the scan's first call (its warm-up
    and capture included) against those after the eager steps at
    SCAN_STATE_GAP. The first call captures one graph; a second call
    captures nothing, and each epilogue kernel's launches in it are
    EPI_PER_STEP * K, all credited to replays. cuDNN runs its
    deterministic algorithms throughout the leg, so that the scan and the
    eager steps do the same sums. With `planted_fault` the
    check is shown able to fail: the state put back at the start, the
    capture's warm-up run again without its state restore, as a faulty
    site would leave it, then the scan replayed; the same gates must
    reject it."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _scan_leg(label, device, cast, planted_fault)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _scan_leg(label, device, cast, planted_fault):
    os.environ["MXTPU_FUSED_EPILOGUE"] = "1"
    t0 = time.perf_counter()
    B, S = RESNET["batch"], RESNET["image"]
    g = torch.Generator(device=device).manual_seed(RESNET["seed"] + 1)
    dt = torch.float32 if cast is None else getattr(torch, cast)
    dname = str(dt).split(".")[-1]
    xs = torch.rand((SCAN_K + 1, B, S, S, 3), generator=g,
                    device=device).to(dt)
    ys = torch.randint(0, RESNET["classes"], (SCAN_K + 1, B), generator=g,
                       device=device).float()
    x0, y0, xs, ys = xs[0], ys[0], xs[1:].contiguous(), ys[1:].contiguous()
    net = resnet_net((x0, y0), device, cast)
    step = resnet_step(net, device)
    step(x0, y0)
    n0, start = step._n, state_copies(step)
    want = torch.stack([step(xs[k], ys[k]) for k in range(SCAN_K)]).tolist()
    eager = state_copies(step)
    set_state(step, start)
    step._n = n0
    compiles0 = snapshot_signatures()
    got = step.scan_steps(xs, ys).tolist()
    gaps = state_gaps(step, state_copies(step), eager, start)
    site = step._scan
    after_first = snapshot_signatures()
    before = [k.launches for k in EPI_KERNELS]
    replayed = site.replayed_launches()
    losses2 = step.scan_steps(xs, ys)
    torch.cuda.synchronize()
    after_second = snapshot_signatures()
    launches = [k.launches - b for k, b in zip(EPI_KERNELS, before)]
    credited = {k: n - replayed.get(k, 0)
                for k, n in site.replayed_launches().items()}
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"  {label}: scan losses {[round(v, 5) for v in got]}; eager "
          f"{[round(v, 5) for v in want]}; largest relative gap "
          f"{max(loss_gaps):.3e} (step {int(np.argmax(loss_gaps)) + 1}; "
          f"limits {SCAN_LOSS_RTOL[dname]}); state after the first call "
          f"against eager (gap / movement): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (limit {SCAN_STATE_GAP[dname]:g})")
    bad = scan_check(label, dname, got, want, gaps)
    if bad:
        raise AssertionError(f"{label}: the scan parts from eager: {bad}")
    new_first = after_first.get("GluonTrainStep.scan", 0) - compiles0.get(
        "GluonTrainStep.scan", 0)
    steady = sum(after_second.values()) - sum(after_first.values())
    if new_first != 1 or steady != 0:
        raise AssertionError(f"{label}: the first scan call registered "
                             f"{new_first} captures (want 1), the second "
                             f"{steady} (want 0)")
    wanted = EPI_PER_STEP * SCAN_K
    for k, n in zip(EPI_KERNELS, launches):
        if n != wanted or credited.get(k.__name__) != wanted:
            raise AssertionError(f"{label}: {k.__name__} launched {n} times "
                                 f"in a replayed scan call ({credited}), "
                                 f"expected {wanted}, all replays")
    if not torch.isfinite(losses2).all():
        raise AssertionError(f"{label}: non-finite scan losses {losses2}")
    dtypes_of(step, dt, label)
    print(f"  {label}: first call captured 1 graph ({site.capture_seconds}"
          f" s with its warm-up); the second captured 0; {wanted} launches "
          f"of each epilogue kernel per call, all replays")
    if planted_fault:
        set_state(step, start)
        step._n = n0
        site.state, keep = None, site.state
        try:
            site._warm_up([torch.zeros_like(xs), torch.zeros_like(ys),
                           torch.zeros(SCAN_K, device=device),
                           torch.zeros(SCAN_K, device=device)])
        finally:
            site.state = keep
        bad_got = step.scan_steps(xs, ys).tolist()
        bad_gaps = state_gaps(step, state_copies(step), eager, start)
        caught = scan_check(label, dname, bad_got, want, bad_gaps)
        print(f"  {label}, planted fault (warm-up without its state "
              f"restore): largest relative loss gap "
              f"{max(abs(a - b) / abs(b) for a, b in zip(bad_got, want)):.3e}"
              f"; state gaps " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in bad_gaps.items())
              + f"; the gates reject it: {caught}")
        if not caught:
            raise AssertionError(f"{label}: the planted fault passed the "
                                 f"scan's gates")
    print(f"  {label}: {time.perf_counter() - t0:.1f} s")
    return dict(net=net, step=step, xs=xs, ys=ys)


def snapshot_signatures():
    return {fn: row["signatures"] for fn, row in
            telemetry.compilereg.snapshot().items()}


def train_forward_loss(net, x, y):
    """mean(loss) of a training-mode forward without gradient and without
    moving the running stats."""
    from incubator_mxnet_tpu_torch.ops import nn as opnn

    net.train()
    try:
        with torch.no_grad(), opnn.deferred_moving_writes({}):
            return float(resnet_loss(net, x, y).float().mean())
    finally:
        net.train(False)


def accum_leg(batch, device):
    """`accum_steps` over ACCUM[0] micro-batches of ACCUM[1], float32,
    fused: the update count advances by one, the loss is the mean of the
    micro-batch losses at the same weights (rtol 1e-5) and each epilogue
    kernel launches EPI_PER_STEP per micro-batch."""
    os.environ["MXTPU_FUSED_EPILOGUE"] = "1"
    t0 = time.perf_counter()
    K, b = ACCUM
    x, y = batch
    xs, ys = x[:K * b].reshape(K, b, *x.shape[1:]), y[:K * b].reshape(K, b)
    net = resnet_net(batch, device)
    step = resnet_step(net, device)
    step(xs[0], ys[0])  # builds; the accumulation starts from step 1's weights
    n0 = step._n
    want = float(np.mean([train_forward_loss(net, xs[k], ys[k])
                          for k in range(K)]))
    before = [k.launches for k in EPI_KERNELS]
    got = float(step.accum_steps(xs, ys))
    launches = [k.launches - b for k, b in zip(EPI_KERNELS, before)]
    if step._n != n0 + 1 or step.opt.num_update != n0 + 1:
        raise AssertionError(f"accum: update count {n0} -> {step._n}")
    near("accum loss against the micro-batches' mean", got, want, 1e-5)
    if launches != [EPI_PER_STEP * K] * 2:
        raise AssertionError(f"accum: epilogue launches {launches}, "
                             f"expected {EPI_PER_STEP * K} each")
    print(f"  accum ({K} x {b}): update count {n0} -> {step._n}; launches "
          f"{launches}; {time.perf_counter() - t0:.1f} s")


def remat_legs(batch, device, unfused):
    """3 steps each of plain, remat_policy "nothing" and "convs", float32,
    unfused, from the float32 unfused leg's first weights, under cuDNN's
    deterministic algorithms: step 1's loss equal to the unfused leg's
    (rtol 1e-5), steps 2 and 3 equal to the plain leg's (rtol 1e-5; a
    recompute does the same sums), the running stats after step 1 equal
    to the plain step's (rtol 1e-6: moved once), and each step 1's peak
    allocation printed; "nothing" must peak below plain (each unit is
    checkpointed inside the whole forward's checkpoint, so one unit's
    activations are alive at a time)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _remat_legs(batch, device, unfused)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _remat_legs(batch, device, unfused):
    t0 = time.perf_counter()
    plain = eager_leg("leg remat plain", batch, device, False, 3)
    near("plain step 1 loss against the unfused leg", plain["losses"][0],
         unfused["losses"][0], 1e-5)
    peaks = {"plain": plain["peak"]}
    stats, want = plain["stats1"], plain["losses"]
    del plain
    for policy in ("nothing", "convs"):
        leg = eager_leg(f"leg remat_policy={policy}", batch, device, False, 3,
                        remat_policy=policy)
        near(f"remat {policy} step 1 loss against the unfused leg",
             leg["losses"][0], unfused["losses"][0], 1e-5)
        for k in (1, 2):
            near(f"remat {policy} step {k + 1} loss against the plain leg",
                 leg["losses"][k], want[k], 1e-5)
        for name, v in stats.items():
            if not torch.allclose(leg["stats1"][name], v, rtol=1e-6,
                                  atol=0):
                raise AssertionError(f"remat {policy}: running stat {name} "
                                     f"after step 1 differs from the plain "
                                     f"step's")
        peaks[policy] = leg["peak"]
        del leg
        torch.cuda.empty_cache()
    print(f"  running stats after step 1 equal the plain step's (rtol 1e-6, "
          f"{len(stats)} tensors) under both policies")
    print("  step 1 peak allocation above its start: " + ", ".join(
        f"{k} {v / 2**30:.3f} GiB" for k, v in peaks.items())
        + f"; remat legs {time.perf_counter() - t0:.1f} s")
    if not peaks["nothing"] < peaks["plain"]:
        raise AssertionError("remat nothing does not peak below plain")
    return peaks


def bench_runs(gpu):
    """`python3 -m incubator_mxnet_tpu_torch.bench` (bfloat16 then float32,
    bench.py's defaults) with the epilogue on; each child's final line
    parsed and printed. (Phase 5 times the unfused legs' eager steps;
    the module's own run with the epilogue off, which chip_smoke's time
    limit leaves out, is `MXTPU_FUSED_EPILOGUE=0 python3 -m
    incubator_mxnet_tpu_torch.bench`.)"""
    out = {}
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    env = dict(os.environ, MXTPU_FUSED_EPILOGUE="1")
    run = subprocess.run([sys.executable, "-m",
                          "incubator_mxnet_tpu_torch.bench"], env=env,
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"bench exited {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    finals = [json.loads(ln) for ln in run.stdout.splitlines()
              if ln.startswith("{") and '"final": true' in ln]
    if [f["dtype"] for f in finals] != ["bfloat16", "float32"] or any(
            f["platform"] != "gpu" or not f["fused_epilogue"]
            for f in finals):
        raise AssertionError(f"bench: final lines {finals}")
    for f in finals:
        out[f["dtype"]] = f
        print(f"  bench {f['dtype']}, epilogue on: {f['ips']} images/s "
              f"eager, {f['scan_ips']} images/s scan (K {f['scan_k']}); "
              f"compile_s {f['compile_s']}; loss {f['loss']:.5f} [{gpu}]")
    print(f"  bench: {time.perf_counter() - t0:.1f} s")
    return out

# -- phase 4c: gluon's imperative surface ------------------------------------

IMP_BATCHES = 3   # ArrayDataset of 3 batches (231 MB of images)
IMP_STEPS = 6     # two epochs of the loader
IMP_SGD = dict(learning_rate=0.05, momentum=0.9, wd=1e-4)
IMP_STATE_GAP = 1e-5
ROOT = os.path.dirname(os.path.abspath(__file__))


def imperative_data():
    """IMP_BATCHES batches of bench.py's images and labels, drawn as
    `resnet_batch` draws them, from RandomState(0), on the host."""
    B, S = RESNET["batch"], RESNET["image"]
    rng = np.random.RandomState(0)
    n = IMP_BATCHES * B
    x = np.ascontiguousarray(rng.rand(n, 3, S, S).astype(np.float32)
                             .transpose(0, 2, 3, 1))
    y = rng.randint(0, RESNET["classes"], size=n).astype(np.float32)
    return x, y


def imperative_step(net, loss_fn, trainer, data, label):
    """One step of examples/gluon_mnist.py's loop: record, forward, loss,
    backward, Trainer.step; returns the loss (an NDArray, per sample)."""
    with tmx.autograd.record():
        out = net(data)
        loss = loss_fn(out, label)
    loss.backward()
    trainer.step(data.shape[0])
    return loss


def imperative_resnet(device, gpu):
    """Phase 4c (a): ResNet-50 v1 at bench.py's setup (NHWC, float32,
    batch 128 at 224 x 224, Xavier from the seeded generator, SGD lr 0.05
    momentum 0.9 wd 1e-4) through the imperative loop with
    MXTPU_FUSED_EPILOGUE=1: `DataLoader(ArrayDataset(...), batch_size=128,
    shuffle=True)` -> `autograd.record()` -> `net(x)` ->
    `SoftmaxCrossEntropyLoss` -> `loss.backward()` ->
    `gluon.Trainer("sgd").step(128)`, IMP_STEPS steps (two epochs of
    IMP_BATCHES batches), cuDNN deterministic. Each step must launch each
    epilogue kernel EPI_PER_STEP times. Oracle: `GluonTrainStep` (eager,
    SGD with rescale_grad 1, as its loss is already the batch mean) on a
    net drawn from the same seed, from the same weights, momenta and
    running stats, on the same batches: every step loss at rtol 1e-5,
    the state after the steps within IMP_STATE_GAP (gap / movement, as
    the scan leg), and step 1's gradients of the first and last
    convolution (`Parameter.grad()`, scaled by 1/128: the loop's loss is
    a sum over the batch) at rtol 2e-4, atol 1e-5."""
    os.environ["MXTPU_FUSED_EPILOGUE"] = "1"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _imperative_resnet(device, gpu)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        os.environ.pop("MXTPU_FUSED_EPILOGUE", None)


def _imperative_resnet(device, gpu):
    t0 = time.perf_counter()
    B = RESNET["batch"]
    x, y = imperative_data()
    t_data = time.perf_counter() - t0
    np.random.seed(0)
    loader = tmx.gluon.data.DataLoader(
        tmx.gluon.data.ArrayDataset(x, y), batch_size=B, shuffle=True)
    two = torch.from_numpy(x[:2]).to(device)
    net = resnet50(two, device)
    onet = resnet50(two, device)
    params = net.collect_params()
    trainer = tmx.gluon.Trainer(params, "sgd", dict(IMP_SGD))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    ostep = GluonTrainStep(onet, resnet_loss,
                           tmx.optimizer.SGD(rescale_grad=1.0, **IMP_SGD),
                           device=device)
    convs = [n for n in params if n.endswith("weight")
             and params[n].tensor().dim() == 4]
    convs = [convs[0], convs[-1]]
    copies0 = tmx.gluon.block.input_copies
    for k in EPI_KERNELS:
        k.launches = 0
    batches, losses, grads1 = [], [], None
    while len(batches) < IMP_STEPS:
        for data, label in loader:
            before = [k.launches for k in EPI_KERNELS]
            loss = imperative_step(net, loss_fn, trainer, data, label)
            for k, b in zip(EPI_KERNELS, before):
                if k.launches - b != EPI_PER_STEP:
                    raise AssertionError(
                        f"imperative leg: {k.__name__} launched "
                        f"{k.launches - b} times in step "
                        f"{len(batches) + 1}, expected {EPI_PER_STEP}")
            losses.append(loss.mean()._data)
            if grads1 is None:
                grads1 = {n: params[n].grad()._data.clone() for n in convs}
            batches.append((data, label))
            if len(batches) == IMP_STEPS:
                break
    launches = {k.__name__: k.launches for k in EPI_KERNELS}
    copies = tmx.gluon.block.input_copies - copies0
    losses = torch.stack(losses).tolist()
    if not np.isfinite(losses).all():
        raise AssertionError(f"imperative leg: non-finite loss {losses}")
    # the oracle: step 1's gradients from the start, then the steps
    names = [n[len(net.prefix):] for n in params
             if params[n].grad_req != "null"]
    ostep._ensure_built(*[t._data.to(device) for t in batches[0]])
    start = state_copies(ostep)
    _, ograds, _ = ostep._grads(*[t._data.to(device) for t in batches[0]])
    ograds = dict(zip(names, ograds))
    olosses = torch.stack([ostep(d._data, l._data)
                           for d, l in batches]).tolist()
    bad = [f"step {k + 1}: {a} against {b}"
           for k, (a, b) in enumerate(zip(losses, olosses))
           if not np.isclose(a, b, rtol=1e-5, atol=0)]
    got = [t.detach() for t in
           [params[n].tensor() for n in params
            if params[n].grad_req != "null"]
           + [params[n].tensor() for n in params
              if params[n].grad_req == "null"]
           + [trainer._updater.states[i]._data
              for i in range(len(trainer._params))]]
    gaps = state_gaps(ostep, got, state_copies(ostep), start)
    exact = all(torch.equal(g, w) for g, w in zip(got, state_copies(ostep)))
    bad += [f"{g} gap {v:.3e}" for g, v in gaps.items()
            if not v <= IMP_STATE_GAP]
    gerr = {}
    for n in convs:
        rel = n[len(net.prefix):]
        mine = grads1[n] / B
        gerr[rel] = float((mine - ograds[rel]).abs().max())
        if not torch.allclose(mine, ograds[rel], rtol=2e-4, atol=1e-5):
            bad.append(f"{rel} step-1 gradient: max abs diff {gerr[rel]:.3e}")
    print(f"  (a) ResNet-50 v1 imperative, fused: {IMP_STEPS} steps over "
          f"{len(loader)} batches x 2 epochs (data drawn in {t_data:.1f} s); "
          f"losses {[round(v, 6) for v in losses]}; GluonTrainStep oracle "
          f"{[round(v, 6) for v in olosses]}; state after the steps against "
          f"the oracle (gap / movement): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (limit {IMP_STATE_GAP:g}); bit-equal: {exact}; step-1 "
          f"gradients of {list(gerr)} max abs diff "
          f"{[f'{v:.3e}' for v in gerr.values()]} (rtol 2e-4, atol 1e-5)")
    print(f"  (a) epilogue launches over the {IMP_STEPS} steps {launches} "
          f"({EPI_PER_STEP} of each per step); CPU arrays moved to the "
          f"card by the blocks: {copies} ({copies / IMP_STEPS:g} per step: "
          f"the images and the labels)")
    if bad:
        raise AssertionError(f"imperative leg parts from GluonTrainStep: "
                             f"{bad}")
    timing = imperative_times(net, loss_fn, trainer, loader, batches, ostep,
                              device, gpu)
    del onet, ostep
    seconds = time.perf_counter() - t0
    print(f"  (a) {seconds:.1f} s [{gpu}]")
    return dict(launches=launches, copies=copies, losses=losses,
                gaps=gaps, exact=exact, seconds=seconds, **timing)


def imperative_times(net, loss_fn, trainer, loader, batches, ostep, device,
                     gpu):
    """images/s and ms per step (host clock, one sync at the end of each
    window) of the imperative loop with its DataLoader, of the imperative
    step on batches already fetched, and of GluonTrainStep's eager step on
    the same batches; the host's enqueue time per imperative step (no
    sync); and the device's busy share over 3 imperative steps."""
    B = RESNET["batch"]
    n = len(batches)

    def window(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def loop():
        k = 0
        for data, label in loader:
            imperative_step(net, loss_fn, trainer, data, label)
            k += 1
        return k

    def steps():
        hosts = []
        for data, label in batches:
            h0 = time.perf_counter()
            imperative_step(net, loss_fn, trainer, data, label)
            hosts.append(time.perf_counter() - h0)
        return hosts

    def oracle():
        for data, label in batches:
            ostep(data._data, label._data)

    t_loop, k_loop = window(loop)
    t_steps, hosts = window(steps)
    t_oracle, _ = window(oracle)
    out = dict(loop_ips=k_loop * B / t_loop, step_ips=n * B / t_steps,
               oracle_ips=n * B / t_oracle, step_ms=t_steps / n * 1e3,
               oracle_ms=t_oracle / n * 1e3,
               host_ms=float(np.median(hosts)) * 1e3)
    print(f"  (a) images/s, host clock: imperative loop with its "
          f"DataLoader {out['loop_ips']:.1f} ({k_loop} steps, "
          f"{t_loop / k_loop * 1e3:.3f} ms per step); imperative step on "
          f"fetched batches {out['step_ips']:.1f} ({out['step_ms']:.3f} ms "
          f"per step; host enqueue median {out['host_ms']:.3f} ms); "
          f"GluonTrainStep eager on the same batches {out['oracle_ips']:.1f} "
          f"({out['oracle_ms']:.3f} ms per step) [{gpu}]")
    it = iter(batches)
    stats = {}
    busy_share(lambda: imperative_step(net, loss_fn, trainer, *next(it)),
               "imperative ResNet-50 step", gpu, steps=3, warm=False,
               top_n=6, kinds=True, stats=stats)
    out["busy"] = stats.get("busy")
    return out


def mnist_run(deterministic=True, seed=0):
    """examples/gluon_mnist.py's loop as written, with
    incubator_mxnet_tpu_torch in place of incubator_mxnet_tpu, for 2 epochs
    at its defaults (batch 100, lr 0.1, momentum 0.9, Xavier, the default
    context: the card), `seed` for its `mx.random.seed` and
    `np.random.seed`, under cuDNN's deterministic algorithms or not (the
    others sum a convolution's weight gradient in an order that changes
    from run to run). Returns each epoch's accuracy and mean loss, every
    step's loss, and the count of CPU arrays moved to the card."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon
    from incubator_mxnet_tpu_torch.gluon import nn

    copies0 = gluon.block.input_copies
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        mx.random.seed(seed)
        np.random.seed(seed)
        rng = np.random.RandomState(0)
        proto = rng.rand(10, 1, 28, 28).astype("float32")
        y = rng.randint(0, 10, 4000)
        X = proto[y] + 0.1 * rng.randn(4000, 1, 28, 28).astype("float32")
        dataset = gluon.data.ArrayDataset(X, y.astype("float32"))
        loader = gluon.data.DataLoader(dataset, batch_size=100, shuffle=True)
        net = nn.HybridSequential()
        net.add(nn.Conv2D(20, 5, activation="relu"), nn.MaxPool2D(2, 2),
                nn.Conv2D(50, 5, activation="relu"), nn.MaxPool2D(2, 2),
                nn.Flatten(), nn.Dense(500, activation="relu"), nn.Dense(10))
        net.initialize(mx.init.Xavier())
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        accs, losses, steps = [], [], []
        for epoch in range(2):
            total, correct, cum_loss = 0, 0, 0.0
            for data, label in loader:
                with autograd.record():
                    out = net(data)
                    loss = loss_fn(out, label)
                loss.backward()
                trainer.step(data.shape[0])
                steps.append(float(loss.mean().asscalar()))
                cum_loss += steps[-1] * data.shape[0]
                correct += int((out.asnumpy().argmax(1)
                                == label.asnumpy()).sum())
                total += data.shape[0]
            accs.append(correct / total)
            losses.append(cum_loss / total)
    finally:
        torch.backends.cudnn.deterministic = was
    return dict(accs=accs, losses=losses, steps=steps,
                copies=gluon.block.input_copies - copies0,
                steps_per_epoch=len(loader))


MNIST_DRAWS = 11   # the example's seed 0, then seeds 1..10
MNIST_BAR = 0.85   # tests/test_examples.py's test_gluon_mnist


def imperative_mnist(gpu):
    """Phase 4c (b): `mnist_run` on the card, cuDNN deterministic, at the
    example's seed 0 and at seeds 1..10. At its defaults (lr 0.1, momentum
    0.9, inputs in [0, 1] not centred) the example's training kills its
    ReLUs from some draws, and a rounding difference is such a draw: the
    same seed lands on either side of the bar on the CPU and on the card,
    and from run to run under cuDNN's other algorithms
    (tools/torch_mnist_draws.py). So one draw cannot say whether the loop
    trains on the card; a majority of reproducible draws can. Each draw's
    step losses must be finite, seed 0 run twice must repeat bit for bit,
    and epoch-1 accuracy must exceed 0.85 in more than half the draws."""
    t0 = time.perf_counter()
    runs = [mnist_run(deterministic=True, seed=s) for s in range(MNIST_DRAWS)]
    again = mnist_run(deterministic=True, seed=0)
    seconds = time.perf_counter() - t0
    for seed, run in enumerate(runs):
        print(f"  (b) gluon_mnist seed {seed}: epoch losses "
              f"{run['losses'][0]:.6g} {run['losses'][1]:.6g}, accuracies "
              f"{run['accs'][0]:.5f} {run['accs'][1]:.5f}")
    above = sum(run["accs"][1] > MNIST_BAR for run in runs)
    copies = sum(run["copies"] for run in runs + [again])
    print(f"  (b) gluon_mnist: {MNIST_DRAWS + 1} runs of 2 epochs of "
          f"{runs[0]['steps_per_epoch']} steps in {seconds:.1f} s, cuDNN "
          f"deterministic, {copies} CPU arrays moved to the card; epoch-1 "
          f"accuracy above {MNIST_BAR} in {above} of {MNIST_DRAWS} draws "
          f"(bar: more than half); seed 0 again: step losses "
          f"{'equal' if again['steps'] == runs[0]['steps'] else 'differ'} "
          f"[{gpu}]")
    bad = [seed for seed, run in enumerate(runs)
           if not all(math.isfinite(v) for v in run["steps"])]
    if bad:
        raise AssertionError(f"gluon_mnist: a step loss is not finite at "
                             f"seeds {bad}")
    if again["steps"] != runs[0]["steps"]:
        raise AssertionError("gluon_mnist: seed 0 under cuDNN's "
                             "deterministic algorithms did not repeat")
    if not 2 * above > MNIST_DRAWS:
        raise AssertionError(
            f"gluon_mnist: epoch-1 accuracy above {MNIST_BAR} in only "
            f"{above} of {MNIST_DRAWS} draws: "
            f"{[run['accs'][1] for run in runs]}")
    return dict(accs=[run["accs"] for run in runs], above=above,
                seconds=seconds, copies=copies)


def _lq_signed(lq):
    """gelqf's (L, Q) with each Q row's largest-magnitude entry positive
    and L's columns flipped to match (a sign convention of the solver)."""
    L, Q = (np.array(v) for v in lq)
    s = np.sign(np.take_along_axis(Q, np.abs(Q).argmax(-1)[..., None], -1))
    return [L * np.swapaxes(s, -1, -2), Q * s]


def _eig_recomposed(vals):
    """syevd's (U, L) as (U^T diag(L) U, L): the eigenvectors are defined
    only up to sign and within close eigenvalues, so two solvers are held
    by the matrix they decompose and by the eigenvalues."""
    U, L = (np.asarray(v, np.float64) for v in vals)
    return [np.swapaxes(U, -1, -2) @ (L[..., None] * U), L]


def registry_on_card(gpu):
    """Phase 4c (c): every registry name (and each op's extra modes) on the
    card against the port's CPU result, on the seeded inputs of
    tests/test_torch_ndarray.py (`tests/torch_op_cases.py`): values at
    rtol 1e-5, atol 1e-6, the inputs' gradients under the same head
    gradients at rtol 1e-4, atol 1e-5 (LQ signs normalised, and syevd
    held by U^T diag(L) U and L: solver conventions; the CPU test holds
    U itself against the JAX package's LAPACK call; the quantized
    family's integer outputs bit-equal); the samplers by
    their moments on the card (mean within 6 standard errors, standard
    deviation within 10 % of the distribution's)."""
    from incubator_mxnet_tpu_torch.ndarray.register import F as opF
    from incubator_mxnet_tpu_torch.ops.registry import OP_REGISTRY

    # loaded by its path: tests/ stays off sys.path for the later phases
    spec = importlib.util.spec_from_file_location(
        "torch_op_cases", os.path.join(ROOT, "tests", "torch_op_cases.py"))
    oc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oc)

    t0 = time.perf_counter()
    card_ctx = tmx.gpu(0)
    cases = [(n, oc._ALL_CASES[oc._key(n)]) for n in oc.DETERMINISTIC]
    cases += [(name, (name, fn, 10 + k))
              for k, (name, fn) in enumerate(oc.EXTRA)]
    bad, worst, worst_g = [], (0.0, ""), (0.0, "")
    for name, (_, case_fn, seed) in cases:
        inputs, attrs = case_fn(np.random.RandomState(seed))
        op = OP_REGISTRY[name].name
        grad = op not in oc.NO_GRAD
        runs = [oc._port(name, inputs, attrs, seed + 1, grad, ctx=c)
                for c in (oc.CPU, card_ctx)]
        for vals, _, _ in runs:
            if op == "_linalg_syevd":
                vals[:] = _eig_recomposed(vals)
            if op == "_linalg_gelqf":
                vals[:] = _lq_signed(vals)
        # the quantized family's integer outputs (int8 codes, int32
        # accumulators) are exact on both devices
        exact = oc.FAMILY[name] == "quantized"
        for what, k, rtol, atol in (("values", 0, 1e-5, 1e-6),
                                    ("gradients", 1, 1e-4, 1e-5),
                                    ("inputs after", 2, 1e-5, 1e-6)):
            want, got = runs[0][k], runs[1][k]
            if (want is None) != (got is None) or (
                    want is not None and len(want) != len(got)):
                bad.append(f"{name} {what}: {got} against {want}")
                continue
            for g, w in zip(got or (), want or ()):
                if exact and np.issubdtype(np.asarray(w).dtype, np.integer):
                    if not np.array_equal(g, w) or \
                            np.asarray(g).dtype != np.asarray(w).dtype:
                        bad.append(f"{name} {what}: integer output not "
                                   f"bit-equal to the CPU's")
                    continue
                g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
                if g.shape != w.shape or not np.allclose(
                        g, w, rtol=rtol, atol=atol, equal_nan=True):
                    err = (float(np.nanmax(np.abs(g - w)))
                           if g.shape == w.shape else float("inf"))
                    bad.append(f"{name} {what}: max abs diff {err:.3e}")
                elif g.size:
                    err = float(np.nanmax(np.abs(g - w)))
                    if k == 1:
                        worst_g = max(worst_g, (err, name))
                    else:
                        worst = max(worst, (err, name))
    zs = {name: oc.sample_moments(name, ctx=card_ctx) for name in oc.RANDOM}
    # an op that draws, called through F with its tensor by keyword: the
    # generator is made on that tensor's card (zero share within 6
    # standard errors of p, the kept elements scaled by 1 / (1 - p))
    x = torch.ones(1 << 20, device=card_ctx.torch_device())
    with tmx.autograd.train_mode():
        drop = opF.Dropout(data=x, p=0.5)
    share = float((drop == 0).float().mean())
    kw_ok = (drop.device == x.device and abs(share - 0.5) < 6 * 0.5 / 1024
             and bool(((drop == 0) | (drop == 2.0)).all()))
    if not kw_ok:
        bad.append(f"F.Dropout(data=<card tensor>): on {drop.device}, zero "
                   f"share {share:.6f}")
    seconds = time.perf_counter() - t0
    n_ops = len({OP_REGISTRY[n].name for n in oc.DETERMINISTIC + oc.RANDOM})
    print(f"  (c) registry on the card: {len(oc.DETERMINISTIC)} names and "
          f"{len(oc.EXTRA)} extra modes against the CPU result (largest "
          f"value diff {worst[0]:.3e} in {worst[1]}, largest gradient diff "
          f"{worst_g[0]:.3e} in {worst_g[1]}); {len(zs)} sampler names by "
          f"their moments (largest mean offset "
          f"{max(zs.values()):.2f} standard errors); F.Dropout by keyword "
          f"on the card: zero share {share:.6f}; {n_ops} ops in all; "
          f"{seconds:.1f} s [{gpu}]")
    if bad:
        raise AssertionError(f"registry ops on the card part from the CPU: "
                             f"{bad[:20]} ({len(bad)} in all)")
    return dict(names=len(oc.DETERMINISTIC) + len(zs), seconds=seconds)


def imperative_leg(device, gpu):
    """Phase 4c: parts (a), (b) and (c); returns their results and the
    leg's seconds."""
    t0 = time.perf_counter()
    out = {"resnet": imperative_resnet(device, gpu)}
    gc.collect()
    torch.cuda.empty_cache()
    out["mnist"] = imperative_mnist(gpu)
    out["ops"] = registry_on_card(gpu)
    out["seconds"] = time.perf_counter() - t0
    print(f"  imperative leg: {out['seconds']:.1f} s [{gpu}]")
    return out


# -- phase 4d: gluon's recurrent surface, CTC, the zoo and the profiler ------

LM = dict(vocab=33278, width=650, layers=2, dropout=0.5, bptt=35, batch=32,
          lr=20.0, clip=0.2, steps=10, seed=0)
LM_LOSS_TOL = 1e-5               # train tolerances (PERF.md section 2)
LM_GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
LSTM_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_rnn_cell.py:131
CTC_TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_operator.py:575
ZOO = (("alexnet", 224), ("vgg16_bn", 224), ("squeezenet1.1", 224),
       ("densenet121", 224), ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224),
       ("inceptionv3", 299))
ZOO_BATCH = 32


def _ctx(device):
    """The port's context for `device` (the card in this script; the CPU
    when its phase functions are rehearsed there)."""
    return tmx.gpu(0) if torch.device(device).type == "cuda" else tmx.cpu()


def rnn_model(vocab, width, layers, dropout):
    """The reference word LM's RNNModel
    (example/gluon/word_language_model): embedding, dropout, an LSTM of
    `layers` layers, dropout, and a decoder tied to the embedding's
    weight."""
    nn, rnn = tmx.gluon.nn, tmx.gluon.rnn

    class RNNModel(tmx.gluon.Block):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(vocab, width)
                self.rnn = rnn.LSTM(width, layers, dropout=dropout,
                                    input_size=width)
                self.decoder = nn.Dense(vocab, in_units=width,
                                        params=self.encoder.params)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, width))), hidden

        def begin_state(self, *args, **kwargs):
            return self.rnn.begin_state(*args, **kwargs)

    return RNNModel()


def lm_corpus():
    """LM["steps"] + 1 batches of token ids (bptt x batch, batchified as
    the reference's `batchify`), drawn as the WikiText-2 stand-in draws
    its corpus (Zipf over the vocabulary, numpy RandomState seeded with
    the crc32 of "wikitext-2/train") over WikiText-2's 33,278 words."""
    import zlib

    from incubator_mxnet_tpu_torch.gluon.contrib.data.text import (
        _synthetic_tokens)

    n = LM["batch"] * (LM["steps"] * LM["bptt"] + 1)
    seed = zlib.crc32(b"wikitext-2/train") % (2 ** 31)
    ids = np.array([int(w[1:]) for w in _synthetic_tokens(n, LM["vocab"],
                                                          seed)], np.int64)
    return ids.reshape(LM["batch"], -1).T.astype(np.float32)  # (T, B)


def lm_step(net, loss_fn, trainer, data, target, hidden):
    """One step of the reference loop: record, forward, loss, backward,
    clip_global_norm over every gradient, Trainer.step; returns (loss
    NDArray, new hidden, norm before clipping)."""
    with tmx.autograd.record():
        output, hidden = net(data, hidden)
        L = loss_fn(output, target.reshape((-1,)))
        L.backward()
    grads = [p.grad() for p in net.collect_params().values()]
    norm = tmx.gluon.utils.clip_global_norm(
        grads, LM["clip"] * LM["bptt"] * LM["batch"])
    trainer.step(LM["batch"] * LM["bptt"])
    return L, [h.detach() for h in hidden], norm


def lm_grads(net, data, target, hidden):
    """(mean loss, {name: gradient}) of one recorded forward and backward
    (the loss summed over the batch, as the reference's backward)."""
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        output, _ = net(data, hidden)
        L = loss_fn(output, target.reshape((-1,)))
        L.backward()
    return (float(L.mean().asscalar()),
            {n[len(net.prefix):]: p.grad().asnumpy()
             for n, p in net.collect_params().items()})


def lstm_oracle(layer, x, h0, c0):
    """torch.nn.LSTM with `layer`'s weights (TF32 off in cuDNN and
    matmul): its output and final (h, c) for input x (T, B, I)."""
    H, L = layer._hidden_size, layer._num_layers
    ref = torch.nn.LSTM(x.shape[-1], H, L).to(x.device)
    with torch.no_grad():
        for k in range(L):
            for kind in ("i2h_weight", "h2h_weight", "i2h_bias",
                         "h2h_bias"):
                name = {"i2h_weight": "weight_ih", "h2h_weight": "weight_hh",
                        "i2h_bias": "bias_ih", "h2h_bias": "bias_hh"}[kind]
                getattr(ref, f"{name}_l{k}").copy_(
                    getattr(layer, f"l{k}_{kind}").tensor())
        return ref(x, (h0, c0))


def word_lm(device, gpu):
    """Phase 4d (a): the LSTM LM at full width (LM) through the
    imperative loop, 10 batches with the hidden state carried and
    detached; the RNN op against torch.nn.LSTM; step 1 at dropout 0
    against a float64 CPU run through the port; the loss must fall."""
    t0 = time.perf_counter()
    source = lm_corpus()
    V, W = LM["vocab"], LM["width"]
    card_ctx = _ctx(device)
    tmx.random.seed(LM["seed"])
    net = rnn_model(V, W, LM["layers"], LM["dropout"])
    net.initialize(tmx.init.Xavier(), ctx=card_ctx)
    weights = {n[len(net.prefix):]: p.data().asnumpy()
               for n, p in net.collect_params().items()}
    n_params = sum(w.size for w in weights.values())

    def batch(i, ctx=card_ctx, dtype=None):
        lo = i * LM["bptt"]
        return (tmx.nd.array(source[lo:lo + LM["bptt"]], ctx=ctx),
                tmx.nd.array(source[lo + 1:lo + 1 + LM["bptt"]], ctx=ctx))

    # the RNN op (through the layer's packed parameters) against cuDNN's
    x = torch.randn(LM["bptt"], LM["batch"], W, device=device,
                    generator=torch.Generator(device).manual_seed(5))
    h0, c0 = (0.5 * torch.randn(LM["layers"], LM["batch"], W, device=device,
                                generator=torch.Generator(device)
                                .manual_seed(s)) for s in (6, 7))
    with torch.no_grad():
        out, (hN, cN) = net.rnn(x, [h0, c0])
        ref, (rh, rc) = lstm_oracle(net.rnn, x, h0, c0)
    for label, got, want in (("output", out, ref), ("final h", hN, rh),
                             ("final c", cN, rc)):
        err = float((got - want).abs().max())
        print(f"  (a) RNN op {label} (T {LM['bptt']}, B {LM['batch']}, H "
              f"{W}, 2 layers) against torch.nn.LSTM: max_abs_err "
              f"{err:.3e} (rtol {LSTM_TOL['rtol']:g}, atol "
              f"{LSTM_TOL['atol']:g})")
        if not torch.allclose(got, want, **LSTM_TOL):
            raise AssertionError(f"RNN op {label} disagrees with "
                                 f"torch.nn.LSTM: {err:.3e}")

    # step 1 at dropout 0: the card against float64 on the CPU
    grads = {}
    for key, ctx in (("card", card_ctx), ("cpu64", tmx.cpu())):
        ref_net = rnn_model(V, W, LM["layers"], 0.0)
        ref_net.initialize(ctx=ctx)
        load_numpy_params(ref_net, weights)
        if key == "cpu64":
            ref_net.cast("float64")
        data, target = batch(0, ctx)
        hidden = ref_net.begin_state(batch_size=LM["batch"], ctx=ctx)
        grads[key] = lm_grads(ref_net, data, target, hidden)
        del ref_net
    loss_err = abs(grads["card"][0] - grads["cpu64"][0])
    print(f"  (a) step 1 at dropout 0: loss {grads['card'][0]:.6f} on the "
          f"card, {grads['cpu64'][0]:.6f} in float64 on the CPU (rtol "
          f"{LM_LOSS_TOL:g})")
    if loss_err > LM_LOSS_TOL * abs(grads["cpu64"][0]):
        raise AssertionError(f"LM step-1 loss off float64 by {loss_err}")
    worst = (0.0, "")
    for name, want in grads["cpu64"][1].items():
        got = grads["card"][1][name].astype(np.float64)
        worst = max(worst, (float(np.abs(got - want).max()), name))
        if not np.allclose(got, want, **LM_GRAD_TOL):
            raise AssertionError(f"LM step-1 gradient {name} off float64: "
                                 f"{np.abs(got - want).max():.3e}")
    print(f"  (a) step-1 gradients before clipping within rtol "
          f"{LM_GRAD_TOL['rtol']:g}, atol {LM_GRAD_TOL['atol']:g} of float64 "
          f"(largest diff {worst[0]:.3e} in {worst[1]})")

    # 10 steps at dropout 0.5
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": LM["lr"]})
    hidden = net.begin_state(func=tmx.nd.zeros, batch_size=LM["batch"],
                             ctx=card_ctx)
    losses, norms, times = [], [], []
    for i in range(LM["steps"]):
        data, target = batch(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        L, hidden, norm = lm_step(net, loss_fn, trainer, data, target,
                                  hidden)
        losses.append(float(L.mean().asscalar()))
        times.append(time.perf_counter() - t1)
        norms.append(norm)
    print(f"  (a) {LM['steps']} steps (dropout {LM['dropout']}, lr {LM['lr']:g}, clip "
          f"{LM['clip']:g} x bptt x batch): losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; gradient norms before clipping {norms[0]:.1f} .. "
          f"{norms[-1]:.1f}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"LM loss did not fall: {losses}")
    step_s = float(np.median(times[2:]))
    tokens = LM["bptt"] * LM["batch"]
    data, target = batch(LM["steps"] - 1)
    state = {"hidden": hidden}

    def one_step():
        _, state["hidden"], _ = lm_step(net, loss_fn, trainer, data, target,
                                        state["hidden"])
        torch.cuda.synchronize()

    stats = {}
    _, events = busy_share(one_step, "LM step (imperative, 650 x 2, vocab "
                           "33,278)", gpu, steps=3, top_n=6, kinds=True,
                           stats=stats)
    launches = sum(events.values()) / 3
    device_step = (stats["busy"] * stats["wall_s"] / 3
                   if stats.get("busy") is not None else None)
    print(f"  (a) LM at full width ({n_params} parameters, tied): "
          f"{tokens / step_s:.1f} tokens/s, step {step_s * 1e3:.3f} ms on "
          f"the host clock (median of steps 3-10, each ending in the "
          f"loss read-back), device "
          + (f"{device_step * 1e3:.3f} ms a step (busy "
             f"{stats['busy']:.1%})" if device_step is not None
             else "not measured")
          + f", {launches:.0f} CUDA launches a step; "
          f"{time.perf_counter() - t0:.1f} s [{gpu}]")
    return dict(net=net, source=source, losses=losses, step_s=step_s,
                launches=launches, busy=stats.get("busy"),
                device_step=device_step, tokens_per_s=tokens / step_s)


def run_example(name):
    """examples/<name>.py as written, its imports replaced by the port's;
    returns its stdout."""
    import contextlib
    import io

    path = os.path.join(ROOT, "examples", f"{name}.py")
    with open(path) as f:
        src = f.read().replace("incubator_mxnet_tpu", "incubator_mxnet_tpu_torch")
    module = {"__name__": f"{name}_port", "__file__": path}
    exec(compile(src, path, "exec"), module)
    argv, sys.argv = sys.argv, [path]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            module["main"]()
    finally:
        sys.argv = argv
    return out.getvalue()


def speech_ctc(device, gpu):
    """Phase 4d (b): examples/speech_ctc.py as written, at its defaults
    (BiLSTM, CTCLoss, Adam through fused.GluonTrainStep, 250 steps, then
    the greedy decode of 64 held-out utterances, which must recover the
    digits as the example asserts), its imports replaced by the port's;
    and the CTCLoss op on the card against float64 on the CPU, with and
    without data and label lengths."""
    t0 = time.perf_counter()
    log = run_example("speech_ctc")
    for line in log.splitlines():
        print(f"  (b) {line}")
    if "speech_ctc OK" not in log:
        raise AssertionError("speech_ctc did not finish")
    seconds = time.perf_counter() - t0

    # the op: speech_ctc's shapes (T 16, B 32, 10 classes, 4 labels)
    rng = np.random.RandomState(3)
    data = 2 * rng.randn(16, 32, 10)
    label = rng.randint(1, 10, (32, 4)).astype(np.float64)
    label[::3, 3] = 0  # padded rows
    dlen = rng.randint(10, 17, 32).astype(np.float64)
    llen = (label > 0).sum(1).astype(np.float64)
    worst = 0.0
    for ud, ul in ((False, False), (True, False), (False, True),
                   (True, True)):
        runs = []
        for dev, dt in ((device, torch.float32), ("cpu", torch.float64)):
            x = torch.tensor(data, dtype=dt, device=dev, requires_grad=True)
            args = [torch.tensor(a, dtype=dt, device=dev)
                    for a in (label, dlen, llen)]
            loss = tmx.ndarray.register.F.CTCLoss(
                x, *args, use_data_lengths=ud, use_label_lengths=ul)
            loss.sum().backward()
            runs.append((loss.detach().cpu().double(),
                         x.grad.cpu().double()))
        for got, want, what in ((runs[0][0], runs[1][0], "loss"),
                                (runs[0][1], runs[1][1], "gradient")):
            worst = max(worst, float((got - want).abs().max()))
            if not torch.allclose(got, want, **CTC_TOL):
                raise AssertionError(
                    f"CTCLoss {what} (data lengths {ud}, label lengths "
                    f"{ul}) on the card off float64: "
                    f"{float((got - want).abs().max()):.3e}")
    print(f"  (b) CTCLoss on the card against float64 on the CPU, with and "
          f"without data / label lengths: loss and gradient within rtol "
          f"{CTC_TOL['rtol']:g}, atol {CTC_TOL['atol']:g} (largest diff "
          f"{worst:.3e}); speech_ctc {seconds:.1f} s (250 steps and the "
          f"decode) [{gpu}]")
    return dict(seconds=seconds)


def zoo_legs(device, gpu):
    """Phase 4d (c): the zoo nets at full size (ZOO; 1000 classes, NCHW,
    float32, Xavier from the seeded global generator): batch-2 logits in
    predict mode against a float64 forward of the same net on the card at
    rtol 1e-4 (atol 1e-4 of the largest logit); the bfloat16-cast net's
    logits against float32 at rtol 0.1, atol 0.08 (tests/test_gluon.py:925;
    the atol as a share of the largest logit, since Xavier nets' logits
    shrink with depth); 2 GluonTrainStep steps at batch 32 (SGD) with
    finite losses; images/s of the second step."""
    out = {}
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for name, size in ZOO:
        t0 = time.perf_counter()
        tmx.random.seed(1)
        net = vision.get_model(name, classes=1000)
        net.initialize(tmx.init.Xavier(), ctx=_ctx(device))
        g = torch.Generator(device).manual_seed(2)
        x = torch.rand(2, 3, size, size, device=device, generator=g)
        logits = {}
        for dt in (torch.float32, torch.float64, torch.bfloat16):
            net.cast({torch.float32: "float32", torch.float64: "float64",
                      torch.bfloat16: "bfloat16"}[dt])
            with torch.no_grad():
                logits[dt] = net(x.to(dt)).double()
        # Xavier nets shrink their activations layer by layer: the
        # absolute parts of the tolerances scale with the logits' size
        scale = float(logits[torch.float64].abs().max())
        err64 = float((logits[torch.float32] - logits[torch.float64])
                      .abs().max())
        err16 = float((logits[torch.bfloat16] - logits[torch.float32])
                      .abs().max())
        if not torch.allclose(logits[torch.float32], logits[torch.float64],
                              rtol=1e-4, atol=1e-4 * scale):
            raise AssertionError(f"{name}: float32 logits off float64 by "
                                 f"{err64:.3e} (largest logit {scale:.3e})")
        if not torch.allclose(logits[torch.bfloat16], logits[torch.float32],
                              rtol=0.1, atol=0.08 * scale):
            raise AssertionError(f"{name}: bfloat16 logits off float32 by "
                                 f"{err16:.3e} (largest logit {scale:.3e})")
        net.cast("float32")
        step = GluonTrainStep(net, lambda n, a, b: loss_fn(n(a), b),
                              tmx.optimizer.SGD(learning_rate=0.01,
                                                momentum=0.9),
                              device=device)
        xb = torch.rand(ZOO_BATCH, 3, size, size, device=device,
                        generator=g)
        yb = torch.randint(0, 1000, (ZOO_BATCH,), device=device,
                           generator=g).float()
        losses, times = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(step(xb, yb)))
            times.append(time.perf_counter() - t1)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: train losses {losses}")
        out[name] = ZOO_BATCH / times[1]
        print(f"  (c) {name} at {size}x{size}: largest logit "
              f"{scale:.3e}; float32 logits vs float64 max diff "
              f"{err64:.3e} (rtol 1e-4, atol 1e-4 x largest), bfloat16 vs "
              f"float32 {err16:.3e} (rtol 0.1, atol 0.08 x largest); 2 "
              f"train steps at batch "
              f"{ZOO_BATCH}, losses {losses[0]:.4f} {losses[1]:.4f}, "
              f"{out[name]:.1f} images/s (step 2, host clock); "
              f"{time.perf_counter() - t0:.1f} s [{gpu}]")
        del net, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def profiler_leg(lm, device, gpu):
    """Phase 4d (d): the port's profiler over 2 LM steps:
    set_config(aggregate_stats=True), set_state("run"), the steps,
    dump(). The window's chrome trace must name the LM's CUDA kernels,
    and dumps() must count RNN, FullyConnected and Embedding once a step
    and Dropout twice."""
    net, source = lm["net"], lm["source"]
    stem = os.path.join(ROOT, "build", "chip_smoke_profile")
    shutil.rmtree(stem + "_trace", ignore_errors=True)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": LM["lr"]})
    ctx = _ctx(device)
    hidden = net.begin_state(batch_size=LM["batch"], ctx=ctx)
    profiler.set_config(filename=stem + ".json", aggregate_stats=True)
    profiler.reset_stats()
    profiler.set_state("run")
    try:
        for i in range(2):
            lo = i * LM["bptt"]
            data = tmx.nd.array(source[lo:lo + LM["bptt"]], ctx=ctx)
            target = tmx.nd.array(source[lo + 1:lo + 1 + LM["bptt"]],
                                  ctx=ctx)
            _, hidden, _ = lm_step(net, loss_fn, trainer, data, target,
                                   hidden)
    finally:
        trace_dir = profiler.dump()
        profiler.set_config(filename="profile.json", aggregate_stats=False)
    table = profiler.dumps()
    counts = {}
    for line in table.splitlines()[3:]:
        parts = line.split()
        if len(parts) == 6 and parts[1].isdigit():
            counts[parts[0]] = int(parts[1])
    want = {"RNN": 2, "FullyConnected": 2, "Embedding": 2, "Dropout": 4}
    got = {k: counts.get(k) for k in want}
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    print(f"  (d) profiler over 2 LM steps: dumps() counts {got} (of "
          f"{len(counts)} names); trace {trace_dir}/trace.json with "
          f"{sum(kernels.values())} CUDA kernel events of {len(kernels)} "
          f"kernels, most launched: "
          + "; ".join(f"{n[:60]} x{c}" for n, c in top) + f" [{gpu}]")
    profiler.reset_stats()
    if got != want:
        raise AssertionError(f"profiler counts {got}, expected {want}")
    if not kernels or not any("gemm" in n.lower() or "elementwise" in n
                              for n in kernels):
        raise AssertionError("the profiler's trace names no LM kernel")


def recurrent_leg(device, gpu):
    """Phase 4d: parts (a)-(d) ((e) is phase 4c (c): the registry cases
    cover RNN and CTCLoss); returns the results and the leg's seconds."""
    t0 = time.perf_counter()
    out = {"lm": word_lm(device, gpu)}
    profiler_leg(out["lm"], device, gpu)
    out["lm"].pop("net")
    gc.collect()
    torch.cuda.empty_cache()
    out["ctc"] = speech_ctc(device, gpu)
    out["zoo"] = zoo_legs(device, gpu)
    out["seconds"] = time.perf_counter() - t0
    print(f"  recurrent leg: {out['seconds']:.1f} s [{gpu}]")
    return out


# -- phase 4e: the training toolkit ------------------------------------------

TK_STEPS = 6      # the imperative loop's, GluonTrainStep's and the scan's
TK_SCHED = dict(step=[2, 4], factor=0.1)  # fit.py's step schedule, cut
TK_SGD = dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
              multi_precision=True)
TK_GAP = 1e-5     # masters and momenta, gap over movement
UPD_RTOL, UPD_ATOL = 1e-5, 1e-6   # tests/test_optimizer.py's fused check
# tests/test_optimizer.py's _FUSED_CASES, then SGLD at its defaults
OPT_CASES = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("sgd", dict(learning_rate=0.1)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("signum", dict(learning_rate=0.1, momentum=0.9, wd_lh=0.01)),
    ("ftml", dict(learning_rate=0.1, wd=0.01)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("lbsgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adam", dict(learning_rate=0.1, wd=0.01)),
    ("adagrad", dict(learning_rate=0.1, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.1, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.1, centered=True)),
    ("adadelta", dict(wd=0.01)),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.01)),
    ("adamax", dict(learning_rate=0.1, wd=0.01)),
    ("nadam", dict(learning_rate=0.1, wd=0.01)),
    ("adamw", dict(learning_rate=0.1, wd=0.01)),
    ("test", dict(rescale_grad=0.5)),
    ("sgld", dict()),
]
OPT_UPDATES = 3
SR_STEPS = 5
SR_DRAWS = 4096


class ScalarWriter:
    """A summary writer for the TensorBoard callbacks: (tag, value,
    step) in memory (the card's machine has no tensorboard package)."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        pass


class LogLines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def toolkit_sgd():
    sched = tmx.lr_scheduler.MultiFactorScheduler(**TK_SCHED)
    return tmx.optimizer.SGD(lr_scheduler=sched, **TK_SGD)


def record_rates(opt):
    """Wrap `opt.fused_updates` to record the host rate of each call
    (rates that already live on the card, inside a graph, are not
    read)."""
    rates, inner = [], opt.fused_updates

    def fused_updates(names, weights, grads, states, lr, t=None):
        if not (torch.is_tensor(lr) and lr.is_cuda):
            rates.append(float(lr))
        return inner(names, weights, grads, states, lr, t=t)

    opt.fused_updates = fused_updates
    return rates


def count_step(label, k, fn):
    """fn() with the epilogue counts read around it: each kernel must
    launch EPI_PER_STEP times."""
    before = [kern.launches for kern in EPI_KERNELS]
    out = fn()
    for kern, b in zip(EPI_KERNELS, before):
        if kern.launches - b != EPI_PER_STEP:
            raise AssertionError(f"{label}: {kern.__name__} launched "
                                 f"{kern.launches - b} times in step "
                                 f"{k + 1}, expected {EPI_PER_STEP}")
    return out


def group_gap(got, want, start):
    diff = sum(float((g.double() - w.double()).norm() ** 2)
               for g, w in zip(got, want))
    moved = sum(float((w.double() - s.double()).norm() ** 2)
                for w, s in zip(want, start))
    return (diff / moved) ** 0.5 if moved else float(diff > 0)


def toolkit_telemetry():
    """Phase 4e (d) hooks: memory sampled at each step boundary against
    `torch.cuda.memory_allocated()` read there; returns (samples,
    restore)."""
    from incubator_mxnet_tpu_torch.telemetry import memory as tmem

    samples, inner = [], tmem.sample_device_memory

    def sample(registry=None):
        allocated = torch.cuda.memory_allocated()
        out = inner(registry)
        reg = registry or telemetry.REGISTRY
        samples.append((allocated,
                        reg.get("mxtpu_device_bytes_in_use").value(
                            device="cuda:0"),
                        reg.get("mxtpu_device_peak_bytes_in_use").value(
                            device="cuda:0")))
        return out

    tmem.sample_device_memory = sample

    def restore():
        tmem.sample_device_memory = inner

    return samples, restore


def toolkit_mp(device, gpu, batch):
    """Phase 4e (a) and (d): the bfloat16 net with float32 masters, three
    ways, plus the telemetry of the imperative loop."""
    x, y = batch
    xb = x.bfloat16()
    sched = tmx.lr_scheduler.MultiFactorScheduler(**TK_SCHED)
    sched.base_lr = TK_SGD["learning_rate"]
    # the rates as the steps hand them in: float32
    want_lr = [float(np.float32(sched(n))) for n in range(1, TK_STEPS + 1)]
    t0 = time.perf_counter()
    # the imperative loop (Trainer, aggregated), with the telemetry
    net = resnet_net(batch, device, "bfloat16")
    opt_i = toolkit_sgd()
    rates_i = record_rates(opt_i)
    trainer = tmx.gluon.Trainer(net.collect_params(), opt_i)
    acc, top5 = tmx.metric.Accuracy(), tmx.metric.TopKAccuracy(5)
    writer, lines = ScalarWriter(), LogLines()
    tb = tmx.telemetry.LogTelemetryCallback(interval=1,
                                            summary_writer=writer)
    speedo = tmx.callback.Speedometer(RESNET["batch"], frequent=1,
                                      auto_reset=False)
    logging.getLogger().addHandler(lines)
    level = logging.getLogger().level
    logging.getLogger().setLevel(logging.INFO)
    telemetry.enable()
    samples, restore = toolkit_telemetry()
    losses_i, rates_by_step, metric_bad, tb_counts = [], [], [], []
    data = tmx.nd.NDArray._from_data(xb)
    label = tmx.nd.NDArray._from_data(y)
    try:
        for k in range(TK_STEPS):
            def one():
                with tmx.autograd.record():
                    out = net(data)
                    loss = RESNET_LOSS(out, label)
                loss.backward()
                trainer.step(RESNET["batch"])
                return out, loss
            n_rates = len(rates_i)
            out, loss = count_step("mp imperative", k, one)
            rates_by_step.append(sorted(set(rates_i[n_rates:])))
            losses_i.append(float(loss._data.detach().float().mean()))
            logits = out._data.detach().float().cpu().numpy()
            yy = y.cpu().numpy().astype(np.int64)
            a, t5 = tmx.metric.Accuracy(), tmx.metric.TopKAccuracy(5)
            a.update([label], [out])
            t5.update([label], [out])
            acc.update([label], [out])
            top5.update([label], [out])
            np_acc = float((logits.argmax(1) == yy).mean())
            np_top5 = float((np.argsort(logits, axis=-1)[:, -5:]
                             == yy[:, None]).any(1).mean())
            if (a.get()[1], t5.get()[1]) != (np_acc, np_top5):
                metric_bad.append((k, a.get()[1], np_acc, t5.get()[1],
                                   np_top5))
            param = tmx.model.BatchEndParam(0, k, acc, locals())
            tb(param)
            speedo(param)
            tb_counts.append(len(writer.scalars))
    finally:
        restore()
        logging.getLogger().removeHandler(lines)
        logging.getLogger().setLevel(level)
    bad = []
    if rates_by_step != [[r] for r in want_lr]:
        bad.append(f"imperative rates {rates_by_step} against {want_lr}")
    if metric_bad:
        bad.append(f"metrics against numpy {metric_bad}")
    mem_bad = [s for s in samples if s[0] != s[1] or s[2] < s[1]]
    if len(samples) != TK_STEPS or mem_bad:
        bad.append(f"memory samples {samples}")
    tag = "telemetry/mxtpu_device_bytes_in_use/device=cuda:0"
    per_step = np.diff([0] + tb_counts)
    if not (per_step > 0).all() or tag not in {t for t, _, _ in
                                               writer.scalars}:
        bad.append(f"LogTelemetryCallback scalars per step {per_step}")
    speeds = [ln for ln in lines.lines if "samples/sec" in ln]
    if len(speeds) != TK_STEPS - 1:
        bad.append(f"Speedometer lines {speeds}")
    masters_i = [trainer._updater.states[i][1]._data
                 for i in range(len(trainer._params))]
    moms_i = [trainer._updater.states[i][0]._data
              for i in range(len(trainer._params))]
    weights_i = [p.tensor() for p in trainer._params]
    # GluonTrainStep, eager
    enet = resnet_net(batch, device, "bfloat16")
    opt_e = toolkit_sgd()
    rates_e = record_rates(opt_e)
    estep = GluonTrainStep(enet, resnet_loss, opt_e, device=device)
    estep._ensure_built(xb, y)
    start = [s[1].detach().clone() for s in estep.states]
    losses_e = [float(count_step("mp GluonTrainStep", k,
                                 lambda: estep(xb, y)))
                for k in range(TK_STEPS)]
    if rates_e != want_lr:
        bad.append(f"GluonTrainStep rates {rates_e} against {want_lr}")
    # one scan_steps call of K steps
    snet = resnet_net(batch, device, "bfloat16")
    sstep = GluonTrainStep(snet, resnet_loss, toolkit_sgd(), device=device)
    xs = xb.unsqueeze(0).expand(TK_STEPS, *xb.shape).contiguous()
    ys = y.unsqueeze(0).expand(TK_STEPS, *y.shape).contiguous()
    before = [kern.launches for kern in EPI_KERNELS]
    losses_s = sstep.scan_steps(xs, ys).tolist()
    credited = sstep._scan.replayed_launches()
    scan_launches = [kern.launches - b for kern, b in zip(EPI_KERNELS,
                                                          before)]
    for kern in EPI_KERNELS:
        if credited.get(kern.__name__) != EPI_PER_STEP * TK_STEPS:
            bad.append(f"scan replay credited {credited}")
    loss_bad = [(k, a, b, c) for k, (a, b, c) in
                enumerate(zip(losses_i, losses_e, losses_s))
                if not (np.isclose(a, b, rtol=1e-5, atol=0)
                        and np.isclose(c, b, rtol=1e-5, atol=0))
                or not np.isfinite([a, b, c]).all()]
    if loss_bad:
        bad.append(f"losses part: {loss_bad}")
    masters_e = [s[1] for s in estep.states]
    moms_e = [s[0] for s in estep.states]
    zeros = [torch.zeros_like(m) for m in moms_e]
    gaps = {"imperative masters": group_gap(masters_i, masters_e, start),
            "imperative momenta": group_gap(moms_i, moms_e, zeros),
            "scan masters": group_gap([s[1] for s in sstep.states],
                                      masters_e, start),
            "scan momenta": group_gap([s[0] for s in sstep.states], moms_e,
                                      zeros)}
    bad += [f"{k} gap {v:.3e}" for k, v in gaps.items() if not v <= TK_GAP]
    dts = {str(t.dtype) for t in weights_i + estep.weights + sstep.weights}
    mdt = {str(t.dtype) for t in masters_i + masters_e + moms_i + moms_e}
    if dts != {"torch.bfloat16"} or mdt != {"torch.float32"}:
        bad.append(f"weights {dts}, masters and momenta {mdt}")
    print(f"  (a) bfloat16 ResNet-50 with float32 masters, SGD lr 0.05 "
          f"MultiFactorScheduler(step=[2, 4], factor=0.1): losses "
          f"imperative {[round(v, 6) for v in losses_i]}, GluonTrainStep "
          f"{[round(v, 6) for v in losses_e]}, one scan_steps call "
          f"{[round(v, 6) for v in losses_s]}; rates {want_lr}; masters "
          f"and momenta against GluonTrainStep (gap / movement): "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (limit {TK_GAP:g}); accuracy {acc.get()[1]:.6f}, top-5 "
          f"{top5.get()[1]:.6f} over the steps, each step's equal to "
          f"numpy's; {EPI_PER_STEP} launches of each epilogue kernel a "
          f"step eagerly, the scan's first call {scan_launches} with "
          f"{EPI_PER_STEP * TK_STEPS} credited to its replay")
    print(f"  (d) at each of the {TK_STEPS} step boundaries "
          f"mxtpu_device_bytes_in_use{{device=cuda:0}} equals "
          f"torch.cuda.memory_allocated(): "
          f"{[s[1] for s in samples]} (peak {samples[-1][2]}); "
          f"LogTelemetryCallback wrote {[int(v) for v in per_step]} scalars "
          f"a step, "
          f"Speedometer {len(speeds)} lines: "
          f"{(speeds or [''])[-1][:90]!r}")
    if bad:
        raise AssertionError(f"phase 4e (a)/(d): {bad}")
    print(f"  (a) {time.perf_counter() - t0:.1f} s [{gpu}]")
    return dict(losses=losses_i, gaps=gaps)


def step_times(step, x, y, steps=10):
    """(device ms, host ms, images/s) of one eager step: device time from
    CUDA events (median of 25), host time per step over `steps` steps
    closed by a read-back."""
    dev = device_ms(lambda: step(x, y))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        loss = step(x, y)
    loss.item()
    host = (time.perf_counter() - t) / steps * 1e3
    return dev, host, RESNET["batch"] / host * 1e3


def update_bytes(weights, states):
    """Bytes one update must move: each weight read and written, its
    gradient read, each state tensor read and written."""
    n = 0
    for w, s in zip(weights, states):
        k = w.numel() * w.element_size()
        n += 3 * k
        for part in (s if isinstance(s, tuple) else (s,)):
            if part is not None and part.dim():
                n += 2 * part.numel() * part.element_size()
    return n


def _err_text(v):
    return str(v) if isinstance(v, tuple) else f"{v:.2e}"


def toolkit_optimizers(device, gpu, batch):
    """Phase 4e (b): every optimizer case on the float32 net, from one
    step's gradients."""
    x, y = batch
    t0 = time.perf_counter()
    net = resnet_net(batch, device)
    gstep = resnet_step(net, device)
    gstep._ensure_built(x, y)
    _, grads, _ = gstep._grads(x, y)
    names = list(gstep.names)
    pdict = net.collect_params()
    params = [pdict[n] for n in names]
    w0 = [w.detach().clone() for w in gstep.weights]
    del gstep
    sub = list(range(40)) + [len(w0) - 2, len(w0) - 1]
    w0_cpu = [w0[i].cpu() for i in sub]
    g_cpu = [grads[i].cpu() for i in sub]
    for p, g in zip(params, grads):
        p.grad()._data.copy_(g)

    def reset():
        with torch.no_grad():
            for p, w in zip(params, w0):
                p.tensor().copy_(w)

    def fused(device_ws, gs, nm, name, kw):
        o = tmx.optimizer.create(name, **kw)
        ws = [w.clone() for w in device_ws]
        st = [o.create_fused_state(i, w) for i, w in enumerate(ws)]
        for t in range(1, OPT_UPDATES + 1):
            o.fused_updates(nm, ws, gs, st, o.lr,
                            t=torch.tensor(float(t)))
        return ws, st, o

    def trainer_run(name, kw, knob):
        os.environ["MXNET_OPTIMIZER_AGGREGATION_SIZE"] = knob
        reset()
        rescale = kw.get("rescale_grad", 1.0)
        tr = tmx.gluon.Trainer(params, name, dict(kw))
        for _ in range(OPT_UPDATES):
            tr.step(1.0 / rescale)
        return [p.tensor().detach().clone() for p in params]

    rows, bad = [], []
    knob = os.environ.get("MXNET_OPTIMIZER_AGGREGATION_SIZE")
    try:
        for name, kw in OPT_CASES:
            label = f"{name} {kw}"
            ws, st, o = fused(w0, list(grads), names, name, kw)
            agg = trainer_run(name, kw, "4096")
            eager = trainer_run(name, kw, "0")
            cpu_ws, _, _ = fused(w0_cpu, g_cpu, [names[i] for i in sub],
                                 name, kw)
            finite = all(bool(torch.isfinite(w).all())
                         for w in ws + agg + eager)
            if not finite:
                bad.append(f"{label}: non-finite weights")
            errs = {}
            if name == "sgld":
                # the noise of one fused update: w1 - (w0 - lr/2 (g + wd w0))
                o1 = tmx.optimizer.create(name, **kw)
                wn = [w.clone() for w in w0]
                o1.fused_updates(names, wn, list(grads), [None] * len(wn),
                                 o1.lr, t=torch.tensor(1.0))
                noise = torch.cat([(a - (w - o1.lr / 2 * g)).reshape(-1)
                                   for a, w, g in zip(wn, w0, grads)])
                sd = math.sqrt(o1.lr)
                m, s = float(noise.mean()), float(noise.std())
                errs["noise mean / sd"] = (m / sd, s / sd)
                if abs(m) > 5 * sd / math.sqrt(noise.numel()) or \
                        abs(s / sd - 1) > 1e-2:
                    bad.append(f"{label}: noise mean {m}, sd {s} (want 0, "
                               f"{sd})")
            else:
                pairs = [("aggregated", agg, eager)]
                if name != "nadam":
                    pairs += [("fused", ws, eager), ("fused", ws, agg)]
                pairs += [("card fused against CPU", [ws[i] for i in sub],
                           [w.to(device) for w in cpu_ws])]
                for what, got, want in pairs:
                    err = max(float((a - b).abs().max())
                              for a, b in zip(got, want))
                    errs[what] = max(errs.get(what, 0.0), err)
                    if not all(torch.allclose(a, b, rtol=UPD_RTOL,
                                              atol=UPD_ATOL)
                               for a, b in zip(got, want)):
                        bad.append(f"{label}: {what} max abs diff {err:.3e}")
            # 2 train steps from the start
            reset()
            tstep = GluonTrainStep(net, resnet_loss,
                                   tmx.optimizer.create(name, **kw),
                                   device=device)
            losses = [float(count_step(label, k, lambda: tstep(x, y)))
                      for k in range(2)]
            if not np.isfinite(losses).all():
                bad.append(f"{label}: train-step losses {losses}")
            lr_t = torch.tensor(float(o.lr or 0.0), device=device)
            t_t = torch.tensor(4.0, device=device)
            ms = device_ms(lambda: o.fused_updates(names, ws, list(grads),
                                                   st, lr_t, t=t_t))
            nbytes = update_bytes(ws, st)
            bms = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append((label, ms, bms, nbytes, losses, errs))
            print(f"  (b) {label}: one update over ResNet-50's "
                  f"{sum(w.numel() for w in ws)} parameters {ms:.3f} ms, "
                  f"bound {bms:.3f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s, "
                  f"{bms / ms:.2f} of it); paths "
                  + ", ".join(f"{k} {_err_text(v)}" for k, v in errs.items())
                  + f"; 2 GluonTrainStep losses "
                  f"{[round(v, 5) for v in losses]} [{gpu}]")
            del ws, st, o, agg, eager, tstep
    finally:
        if knob is None:
            os.environ.pop("MXNET_OPTIMIZER_AGGREGATION_SIZE", None)
        else:
            os.environ["MXNET_OPTIMIZER_AGGREGATION_SIZE"] = knob
    if bad:
        raise AssertionError(f"phase 4e (b): {bad}")
    print(f"  (b) {len(OPT_CASES)} optimizer cases, each {OPT_UPDATES} "
          f"updates fused, aggregated and per parameter: "
          f"{time.perf_counter() - t0:.1f} s [{gpu}]")
    return rows


def toolkit_sr(device, gpu, batch):
    """Phase 4e (c): stochastic rounding on the bfloat16 net."""
    x, y = batch
    xb = x.bfloat16()
    t0 = time.perf_counter()
    os.environ["MXTPU_STOCHASTIC_ROUNDING"] = "1"
    knob = os.environ.get("MXNET_OPTIMIZER_AGGREGATION_SIZE")
    kw = dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
              multi_precision=True)
    bad = []
    try:
        net = resnet_net(batch, device, "bfloat16")
        step = GluonTrainStep(net, resnet_loss, tmx.optimizer.SGD(**kw),
                              device=device)
        step._ensure_built(xb, y)
        if any(isinstance(s, tuple) or s.dtype != torch.float32
               for s in step.states):
            bad.append("stochastic rounding states are not float32 "
                       "momenta alone")
        _, grads, _ = step._grads(xb, y)
        pdict = net.collect_params()
        params = [pdict[n] for n in step.names]
        names = [p.name for p in params]
        w0 = [w.detach().clone() for w in step.weights]
        for p, g in zip(params, grads):
            p.grad()._data.copy_(g)

        def reset():
            with torch.no_grad():
                for p, w in zip(params, w0):
                    p.tensor().copy_(w)

        finals = {}
        for path, knob_v in (("per_param", "0"), ("aggregated", "4096")):
            os.environ["MXNET_OPTIMIZER_AGGREGATION_SIZE"] = knob_v
            reset()
            tr = tmx.gluon.Trainer(params, tmx.optimizer.SGD(**kw))
            for _ in range(SR_STEPS):
                tr.step(1)
            finals[path] = ([p.tensor().detach().clone() for p in params],
                            [tr._updater.states[i]._data.clone()
                             for i in range(len(params))])
        o = tmx.optimizer.SGD(**kw)
        ws = [w.clone() for w in w0]
        st = [o.create_fused_state(i, w) for i, w in enumerate(ws)]
        for t in range(1, SR_STEPS + 1):
            o.fused_updates(names, ws, list(grads), st,
                            torch.tensor(0.05), t=torch.tensor(float(t)))
        finals["fused"] = (ws, st)
        ref_w, ref_m = finals["fused"]
        for path in ("per_param", "aggregated"):
            got_w, got_m = finals[path]
            same = all(torch.equal(a, b) for a, b in zip(got_w, ref_w)) \
                and all(torch.equal(a, b) for a, b in zip(got_m, ref_m))
            if not same:
                bad.append(f"{path} parts from the fused path's bits")
        moved = sum(int((a != b).sum()) for a, b in zip(ref_w, w0))
        # GluonTrainStep, 5 steps from the start
        reset()
        tstep = GluonTrainStep(net, resnet_loss, tmx.optimizer.SGD(**kw),
                               device=device)
        losses = [float(count_step("SR GluonTrainStep", k,
                                   lambda: tstep(xb, y)))
                  for k in range(SR_STEPS)]
        if not np.isfinite(losses).all():
            bad.append(f"SR losses {losses}")
        # unbiasedness over SR_DRAWS draws of a fixed vector: the error
        # in bfloat16 ulps, against the Bernoulli sigma of its mean
        vec = torch.randn(1024, generator=torch.Generator().manual_seed(5))
        vec = (vec * (1 + 2 ** -12)).to(device)
        tiled = vec.repeat(SR_DRAWS)
        bits = tmx.optimizer._hash_bits(0, 1, ["sr"], [tiled.numel()],
                                        device)
        r = tmx.optimizer.stochastic_round_bf16(tiled, bits).float()
        ulp = (tiled.view(torch.int32) & 0x7F800000).view(
            torch.float32) * 2 ** -7
        lo = (tiled.view(torch.int32) & -65536).view(torch.float32)
        frac = ((tiled - lo) / ulp).abs()
        err = float(((r.abs() - tiled.abs()) / ulp).mean())
        sigma = float((frac * (1 - frac)).mean().sqrt()) / math.sqrt(
            tiled.numel())
        if not abs(err) < 4 * sigma:
            bad.append(f"SR mean error {err} ulp, sigma {sigma}")
    finally:
        os.environ.pop("MXTPU_STOCHASTIC_ROUNDING", None)
        if knob is None:
            os.environ.pop("MXNET_OPTIMIZER_AGGREGATION_SIZE", None)
        else:
            os.environ["MXNET_OPTIMIZER_AGGREGATION_SIZE"] = knob
    print(f"  (c) stochastic rounding, bfloat16 ResNet-50: float32 momenta, "
          f"no master; {SR_STEPS} updates per parameter, aggregated and "
          f"fused bit-equal ({moved} weights moved); {SR_STEPS} "
          f"GluonTrainStep losses {[round(v, 5) for v in losses]} with "
          f"{EPI_PER_STEP} launches of each epilogue kernel a step; mean "
          f"rounding error over {SR_DRAWS} draws of 1024 values "
          f"{err:.3e} ulp (4 sigma {4 * sigma:.3e}); "
          f"{time.perf_counter() - t0:.1f} s [{gpu}]")
    if bad:
        raise AssertionError(f"phase 4e (c): {bad}")
    return dict(losses=losses, err=err, sigma=sigma)


def toolkit_times(device, gpu, batch):
    """Phase 4e's times: the bfloat16 ResNet-50 step of GluonTrainStep,
    eager, under cuDNN's default algorithms, with plain SGD (bfloat16
    momenta), with float32 masters and with stochastic rounding, in
    turn."""
    x, y = batch
    xb = x.bfloat16()
    plain = {k: v for k, v in TK_SGD.items() if k != "multi_precision"}
    out = {}
    for label, kw, sr in (("plain SGD", plain, False),
                          ("float32 masters", TK_SGD, False),
                          ("stochastic rounding", TK_SGD, True)):
        if sr:
            os.environ["MXTPU_STOCHASTIC_ROUNDING"] = "1"
        try:
            net = resnet_net(batch, device, "bfloat16")
            step = GluonTrainStep(net, resnet_loss, tmx.optimizer.SGD(**kw),
                                  device=device)
            out[label] = step_times(step, xb, y)
        finally:
            os.environ.pop("MXTPU_STOCHASTIC_ROUNDING", None)
        del net, step
        gc.collect()
        torch.cuda.empty_cache()
        dev, host, ips = out[label]
        print(f"  bfloat16 ResNet-50 step, {label} (GluonTrainStep, eager, "
              f"cuDNN's default algorithms): device {dev:.3f} ms, host "
              f"{host:.3f} ms, {ips:.1f} images/s [{gpu}]")
    return out


def bench_modes_start():
    """The port's bench in its dispatch-overhead and observatory modes,
    each a child process on the card, started together."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    env.pop("MXNET_OPTIMIZER_AGGREGATION_SIZE", None)
    return {mode: subprocess.Popen(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.bench", flag],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
        for mode, flag in (("trainer_dispatch", "--dispatch-overhead"),
                           ("observatory", "--observatory"))}


BENCH_COUNTERS = {
    "trainer_dispatch": dict(params=200, steps=5, per_param_dispatches=1000,
                             aggregated_dispatches=5, weights_match=True),
    "observatory": dict(steps=16, retraces_epoch1=0, retraces_epoch2=0,
                        anomalies=0),
}


def bench_modes_finish(procs, gpu):
    bad = []
    for mode, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"bench {mode} exited {proc.returncode}: "
                                 f"{err[-2000:]}")
        line = json.loads(out.strip().splitlines()[-1])
        want = BENCH_COUNTERS[mode]
        got = {k: line.get(k) for k in want}
        if got != want:
            bad.append(f"{mode}: {got} against {want}")
        secs = {k: line[k] for k in ("per_param_s", "aggregated_s", "value")
                if k in line}
        print(f"  (d) python3 -m incubator_mxnet_tpu_torch.bench, {mode}: "
              f"{got}; seconds and ratios {secs}; "
              + (f"phase coverage {line['value']}, ledger peak "
                 f"{line['hbm_peak_bytes']} B in {line['hbm_peak_span']}, "
                 f"compiled_fns {line['compiled_fns']}"
                 if mode == "observatory" else "")
              + f" [{gpu}]")
    if bad:
        raise AssertionError(f"phase 4e (d) bench modes: {bad}")


def toolkit_leg(device, gpu):
    """Phase 4e: parts (a)-(d); returns their results and the leg's
    seconds."""
    t0 = time.perf_counter()
    batch = resnet_batch(device)
    os.environ["MXTPU_FUSED_EPILOGUE"] = "1"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {"mp": toolkit_mp(device, gpu, batch)}
        gc.collect()
        torch.cuda.empty_cache()
        out["optimizers"] = toolkit_optimizers(device, gpu, batch)
        gc.collect()
        torch.cuda.empty_cache()
        out["sr"] = toolkit_sr(device, gpu, batch)
        torch.backends.cudnn.deterministic = deterministic
        gc.collect()
        torch.cuda.empty_cache()
        out["times"] = toolkit_times(device, gpu, batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        os.environ.pop("MXTPU_FUSED_EPILOGUE", None)
    # alone on the card, after the timed steps
    bench_modes_finish(bench_modes_start(), gpu)
    out["seconds"] = time.perf_counter() - t0
    print(f"  training toolkit leg: {out['seconds']:.1f} s [{gpu}]")
    return out


# -- phase 4f: the recommender path ------------------------------------------

# the 26 Criteo Kaggle category counts (facebookresearch/dlrm
# bench/dlrm_s_criteo_kaggle.sh): 33,762,577 rows
KAGGLE = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
          8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
          15, 286181, 105, 142572)
DLRM_WIDTHS = dict(num_dense=13, embed_dim=16, bottom_units=(512, 256, 64),
                   top_units=(512, 256))
DLRM_BATCH = 128
DLRM_STEPS = 20
DLRM_HELD = 3         # steps held against the CPU path
DLRM_RTOL, DLRM_ATOL = 1e-5, 1e-6
DLRM_LR = 0.1
PS_CAP = 20000        # rows a field on the PS leg (the per-row init's cost)
PS_BATCHES, PS_EPOCHS = 6, 2
REC_EXACT = ("dedup_factor", "full_table_bytes", "num_servers", "num_tables",
             "rpc_per_step", "rpc_per_step_naive", "steady_retraces",
             "weights_match", "worker_embedding_bytes")
REC_REPORT = ("value", "throughput_naive", "sparse_pull_p50_opt",
              "sparse_pull_p50_naive", "prefetch_ready")
# examples/matrix_factorization.py's defaults, which phase 4f (d) runs
MF = dict(users=512, items=256, factors=16, epochs=4)
MF_RTOL = 1e-5


def recommender_bench(gpu):
    """(a) the port's `bench.py --recommender --assert` at its defaults;
    its nine exact counters against ci/perf_baseline.json."""
    from incubator_mxnet_tpu_torch import bench

    out = bench.recommender_main(assert_mode=True, ctx=tmx.gpu(0))
    with open(os.path.join(ROOT, "ci", "perf_baseline.json")) as f:
        base = json.load(f)["metrics"]
    bad = {k: (out[k], base[f"recommender.{k}"]["value"]) for k in REC_EXACT
           if out[k] != base[f"recommender.{k}"]["value"]}
    if bad:
        raise AssertionError(f"phase 4f (a): counters against "
                             f"ci/perf_baseline.json: {bad}")
    print(f"  (a) bench --recommender --assert: "
          + ", ".join(f"{k} {out[k]}" for k in REC_EXACT)
          + " (all equal ci/perf_baseline.json); report only: "
          + ", ".join(f"{k} {out[k]}" for k in REC_REPORT) + f" [{gpu}]")
    return out


def dlrm_batches(vocabs, n, seed=11):
    """`n` batches drawn as bench.py's recommender draws them: dense
    `rand`, ids (zipf(1.3) - 1) % vocab per field, labels `randint`."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xd = rng.rand(DLRM_BATCH, DLRM_WIDTHS["num_dense"]).astype("float32")
        ids = np.stack([(rng.zipf(1.3, size=DLRM_BATCH) - 1) % v
                        for v in vocabs], axis=1)
        y = rng.randint(0, 2, (DLRM_BATCH, 1)).astype("float32")
        out.append((xd, ids, y))
    return out


def dlrm_step(net, trainer, loss_fn, batch, ctx):
    """One step of the reference's loop: record, backward, step."""
    xd, ids, y = batch
    with ctx:
        x, lab = tmx.nd.array(xd), tmx.nd.array(y)
        with tmx.autograd.record():
            loss = loss_fn(net(x, ids), lab).mean()
        loss.backward()
        trainer.step(1)
    return loss


def dlrm_local(ctx, init, batch):
    """DLRM at the Kaggle widths with the local arm on `ctx`, its deferred
    tower shapes resolved by a forward of `batch` outside record()."""
    from incubator_mxnet_tpu_torch.models import DLRM

    net = DLRM(KAGGLE, **DLRM_WIDTHS)
    net.initialize(init, ctx=ctx)
    with ctx, tmx.autograd.pause():
        net(tmx.nd.array(batch[0]), batch[1])
    return net, net._collect_params_with_prefix()


def dlrm_run(net, params, batches, ctx, record_at=None, timed=None):
    """Steps over `batches` with a fresh Trainer (plain SGD, lazy on the
    tables); returns the losses and, at step `record_at`, the host state
    {name: array}; `timed` (a list) gets (host s, device ms) a step."""
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": DLRM_LR})
    loss_fn = tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    losses, held = [], None
    for i, batch in enumerate(batches):
        if timed is not None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
        loss = dlrm_step(net, trainer, loss_fn, batch, ctx)
        if timed is not None:
            end.record()
        losses.append(float(loss.asnumpy()))
        if timed is not None:
            timed.append((time.perf_counter() - t0, start.elapsed_time(end)))
        if record_at is not None and i + 1 == record_at:
            held = {n: p.data()._data.detach().to("cpu", copy=True)
                    for n, p in params.items()}
    return losses, held


def touched_rows(batches):
    """{table param name: the ids `batches` touch}."""
    return {f"sparse_arm.f{i}.weight": np.unique(np.concatenate(
        [b[1][:, i] for b in batches])) for i in range(len(KAGGLE))}


def dlrm_kaggle_leg(device, gpu):
    """(b) DLRM at the Criteo Kaggle widths, local arm on the card."""
    t0 = time.perf_counter()
    card_ctx, cpu_ctx = tmx.gpu(0), tmx.cpu()
    batches = dlrm_batches(KAGGLE, DLRM_STEPS)
    tmx.random.seed(42)
    torch.cuda.reset_peak_memory_stats()
    net, params = dlrm_local(card_ctx, tmx.init.Xavier(), batches[0])
    init_s = time.perf_counter() - t0
    tables = [p for n, p in params.items() if n.startswith("sparse_arm.")]
    table_bytes = sum(p.data()._data.numel() * p.data()._data.element_size()
                      for p in tables)
    if len(tables) != len(KAGGLE) or not all(
            p.data()._data.device.type == device.type
            for p in params.values()):
        raise AssertionError("phase 4f (b): the tables are not all on the "
                             "card")
    start = {n: p.data()._data.detach().clone() for n, p in params.items()}
    # the CPU path from the same weights: every table carried to the host
    cpu_net, cpu_params = dlrm_local(cpu_ctx, tmx.init.Zero(), batches[0])
    for n, p in cpu_params.items():
        p.set_data(start[n].cpu())
    cpu_losses, cpu_held = dlrm_run(cpu_net, cpu_params,
                                    batches[:DLRM_HELD], cpu_ctx,
                                    record_at=DLRM_HELD)
    del cpu_net, cpu_params
    gc.collect()
    timed = []
    losses, held = dlrm_run(net, params, batches, card_ctx,
                            record_at=DLRM_HELD, timed=timed)
    peak = torch.cuda.max_memory_allocated()
    if not np.allclose(losses[:DLRM_HELD], cpu_losses, rtol=DLRM_RTOL,
                       atol=0):
        raise AssertionError(f"phase 4f (b): card losses "
                             f"{losses[:DLRM_HELD]} against the CPU's "
                             f"{cpu_losses}")
    rows = touched_rows(batches[:DLRM_HELD])
    worst = 0.0
    for n in held:
        got, want = held[n], cpu_held[n]
        if n in rows:
            idx = torch.from_numpy(rows[n])
            got, want = got[idx], want[idx]
        worst = max(worst, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=DLRM_RTOL, atol=DLRM_ATOL):
            raise AssertionError(f"phase 4f (b): {n} after {DLRM_HELD} "
                                 f"steps differs from the CPU path by "
                                 f"{float((got - want).abs().max()):.3e}")
    final = {n: p.data()._data.detach().clone() for n, p in params.items()}
    # the same 20 steps again from the same start: bit-equal
    with torch.no_grad():
        for n, p in params.items():
            p.data()._data.copy_(start[n])
    again, _ = dlrm_run(net, params, batches, card_ctx)
    same = again == losses and all(torch.equal(p.data()._data, final[n])
                                   for n, p in params.items())
    if not same:
        raise AssertionError("phase 4f (b): a rerun of the 20 steps from "
                             "the same start is not bit-equal")
    del start, final
    uniq = np.mean([sum(len(np.unique(b[1][:, f])) for f in range(len(
        KAGGLE))) for b in batches])
    host = [t for t, _ in timed[DLRM_HELD:]]
    dev = [d for _, d in timed[DLRM_HELD:]]
    loss_fn = tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": DLRM_LR})
    stats = {}
    it = iter(batches * 2)
    _, events = busy_share(
        lambda: dlrm_step(net, trainer, loss_fn, next(it), card_ctx)
        .asnumpy(), "Kaggle DLRM step (local arm)", gpu, steps=5,
        kinds=True, stats=stats)
    launches = sum(n for name, n in events.items()
                   if not name.startswith(("Memcpy", "Memset")))
    kernel_ms = (stats["busy"] * stats["wall_s"] / 5 * 1e3
                 if stats.get("busy") is not None else None)
    out = dict(losses=losses, table_bytes=table_bytes,
               host_ms=float(np.median(host)) * 1e3,
               event_ms=float(np.median(dev)), kernel_ms=kernel_ms,
               samples_per_s=DLRM_BATCH / float(np.median(host)),
               launches_per_step=launches / 5, uniq_rows=uniq,
               busy=stats.get("busy"), peak_bytes=peak, init_s=init_s,
               held_err=worst)
    print(f"  (b) DLRM at the Criteo Kaggle widths, local arm: 26 tables, "
          f"{sum(KAGGLE)} rows x 16 float32 = {table_bytes / 1e9:.3f} GB on "
          f"the card (initialized in {init_s:.1f} s); {DLRM_STEPS} steps at "
          f"batch {DLRM_BATCH}, losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"the first {DLRM_HELD} equal the CPU path's from the same weights "
          f"(losses rtol {DLRM_RTOL:g}; touched rows and towers rtol "
          f"{DLRM_RTOL:g}, atol {DLRM_ATOL:g}, largest gap {worst:.3e}); a "
          f"rerun from the same start bit-equal")
    print(f"      a step: host {out['host_ms']:.3f} ms, CUDA events "
          f"{out['event_ms']:.3f} ms (the step's host syncs included; "
          f"median of steps {DLRM_HELD + 1}-{DLRM_STEPS}), "
          + (f"kernels {kernel_ms:.3f} ms, busy {out['busy']:.1%} (the "
             f"profiler window), " if kernel_ms is not None else
             "kernel time and busy share not measured, ")
          + f"{out['launches_per_step']:.0f} kernel launches, "
          f"{uniq:.1f} unique rows; {out['samples_per_s']:.1f} samples/s "
          f"(host clock); peak allocation {peak / 2**30:.3f} GiB; leg "
          f"{time.perf_counter() - t0:.1f} s [{gpu}]")
    del net, params, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ps_leg(gpu):
    """(c) the Kaggle widths through the PS-sharded service, each field
    capped at PS_CAP rows, naive then opt, by the bench's own
    `recommender_run`."""
    from incubator_mxnet_tpu_torch import bench

    vocabs = [min(v, PS_CAP) for v in KAGGLE]
    # PS_EPOCHS passes over the same PS_BATCHES batches: the second epoch
    # is the steady state whose pulls must register no new signature
    batches = dlrm_batches(vocabs, PS_BATCHES, seed=11) * PS_EPOCHS
    telemetry.enable()
    with tmx.gpu(0):
        runs = {mode: bench.recommender_run(mode, vocabs, batches,
                                            PS_BATCHES, widths=DLRM_WIDTHS,
                                            lr=DLRM_LR)
                for mode in ("naive", "opt")}
    naive, opt = runs["naive"], runs["opt"]
    full = sum(vocabs) * DLRM_WIDTHS["embed_dim"] * 4
    per_step = {m: (r["pull_rpcs_batched"] + r["pull_rpcs_per_key"])
                / r["steps"] for m, r in runs.items()}
    problems = []
    if naive["weights_sha"] != opt["weights_sha"]:
        problems.append("naive and opt weights differ")
    if not per_step["opt"] <= 2 < per_step["naive"]:
        problems.append(f"pull RPCs a step {per_step}")
    if opt["steady_retraces"] != 0:
        problems.append(f"steady retraces {opt['steady_retraces']}")
    emb_bytes = opt["worker_embedding_bytes"]
    if not 0 < emb_bytes < full:
        problems.append(f"worker embedding bytes {emb_bytes} against "
                        f"the full table's {full}")
    if problems:
        raise AssertionError(f"phase 4f (c): {problems}")
    print(f"  (c) the Kaggle widths through 2 PS shards ({sum(vocabs)} rows, "
          f"{full / 1e6:.1f} MB; each field capped at {PS_CAP} rows), "
          f"{PS_EPOCHS} x {PS_BATCHES} batches of {DLRM_BATCH}: naive and opt "
          f"weights bit-identical; pull RPCs a step naive "
          f"{per_step['naive']:g}, opt {per_step['opt']:g}; steady retraces "
          f"{opt['steady_retraces']:g}; prefetch ready "
          f"{opt['prefetch_ready']:g}; worker embedding bytes {emb_bytes} "
          f"(full table {full}); sparse_pull p50 naive "
          f"{naive['sparse_pull_p50'] * 1e3:.3f} ms, opt "
          f"{opt['sparse_pull_p50'] * 1e3:.3f} ms; steps/s naive "
          f"{naive['steps_per_s']:.2f}, opt {opt['steps_per_s']:.2f} (host "
          f"clock; server-side init {naive['init_s']:.1f} s and "
          f"{opt['init_s']:.1f} s) [{gpu}]")
    return runs


def mf_run(ctx):
    """examples/matrix_factorization.py as written, at its defaults (the
    sizes of MF), its imports replaced by the port's, on `ctx`; returns
    the per-epoch RMSE (unrounded, from the example's own log records)
    and the user table's gradient of its closing 64-sample step."""
    import contextlib
    import io
    import logging

    path = os.path.join(ROOT, "examples", "matrix_factorization.py")
    with open(path) as f:
        src = f.read().replace("incubator_mxnet_tpu", "incubator_mxnet_tpu_torch")
    module = {"__name__": "matrix_factorization_port", "__file__": path}
    exec(compile(src, path, "exec"), module)
    nets = []

    class MFBlock(module["MFBlock"]):
        """The example's block, kept to read its gradient afterwards."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            nets.append(self)

    module["MFBlock"] = MFBlock
    rmse = []

    class Epochs(logging.Handler):
        def emit(self, record):  # "epoch %d  rmse %.4f", epoch, rmse
            rmse.append(float(record.args[1]))

    log, root = logging.getLogger("mf"), logging.getLogger()
    root_handlers, root_level = root.handlers[:], root.level
    handler = Epochs()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False
    argv, sys.argv = sys.argv, [path]
    out = io.StringIO()
    try:
        with ctx, contextlib.redirect_stdout(out):
            module["main"]()
    finally:
        sys.argv = argv
        log.removeHandler(handler)
        log.propagate = True
        log.setLevel(logging.NOTSET)
        # the example's basicConfig must not leave the root logging
        root.handlers[:] = root_handlers
        root.setLevel(root_level)
    if "matrix_factorization OK" not in out.getvalue():
        raise AssertionError("phase 4f (d): matrix_factorization did not "
                             "finish")
    if len(rmse) != MF["epochs"]:
        raise AssertionError(f"phase 4f (d): {len(rmse)} epochs logged")
    return rmse, nets[-1].user.weight.grad()


def mf_leg(gpu):
    """(d) the matrix-factorization loop on the card against the CPU."""
    t0 = time.perf_counter()
    rmse, g = mf_run(tmx.gpu(0))
    card_s = time.perf_counter() - t0
    cpu_rmse, _ = mf_run(tmx.cpu())
    if not rmse[-1] < rmse[0]:
        raise AssertionError(f"phase 4f (d): RMSE did not fall: {rmse}")
    if not (isinstance(g, tmx.nd.sparse.RowSparseNDArray) and g.data._data
            .is_cuda and g.indices.shape[0] <= 64):
        raise AssertionError(f"phase 4f (d): the user table's gradient is "
                             f"{type(g).__name__}, not row-sparse rows of "
                             f"the batch on the card")
    if not np.allclose(rmse, cpu_rmse, rtol=MF_RTOL, atol=0):
        raise AssertionError(f"phase 4f (d): per-epoch RMSE {rmse} against "
                             f"the CPU's {cpu_rmse}")
    print(f"  (d) examples/matrix_factorization.py as written "
          f"({MF['users']} users x {MF['items']} "
          f"items x {MF['factors']} factors, lazy Adam, {MF['epochs']} "
          f"epochs): RMSE {', '.join(f'{x:.5f}' for x in rmse)} equal to "
          f"the CPU's at rtol {MF_RTOL:g}; the user grad row-sparse, "
          f"{g.indices.shape[0]} rows; {card_s:.1f} s on the card [{gpu}]")
    return rmse


def recommender_leg(device, gpu):
    """Phase 4f: parts (a)-(d); returns their results and the leg's
    seconds."""
    t0 = time.perf_counter()
    out = {"bench": recommender_bench(gpu)}
    out["kaggle"] = dlrm_kaggle_leg(device, gpu)
    out["ps"] = ps_leg(gpu)
    out["mf"] = mf_leg(gpu)
    out["seconds"] = time.perf_counter() - t0
    print(f"  recommender leg: {out['seconds']:.1f} s [{gpu}]")
    return out


# -- phase 4g: the vision and contrib op families ----------------------------

# the reference's Faster R-CNN (Apache MXNet v1.4 example/rcnn, --network
# resnet50, test settings): a 600 x 1000 image, ResNet-50 v1 C4 at stride
# 16 (1024 channels, a 38 x 63 map), anchors at scales (8, 16, 32) and
# ratios (0.5, 1, 2), RPN pre-NMS top 6000, post-NMS top 300, NMS 0.7, min
# size 16, ROIPooling 14 x 14 at 1/16, stage 5 as the ROI head, 21 classes
DET = dict(image=(600, 1000), depth=50, stride=16, scales=(8, 16, 32),
           ratios=(0.5, 1, 2), pre=6000, post=300, nms=0.7, min_size=16,
           pooled=14, classes=21, final_nms=0.3, final_top=100,
           image_seed=0, weight_seed=42)
# Proposal / final NMS rows: rtol 1e-5, and 1e-5 of the image's extent
# absolute (an edge coordinate cy - (h - 1) / 2 loses digits: the first
# card run read y1 0.3265076 against the CPU's 0.3264923, from one ulp of
# exp in a 400-pixel height)
DET_ROIS = dict(rtol=1e-5, atol=1e-5 * max(DET["image"]))
DET_ALIGN = dict(rtol=1e-4, atol=1e-5)   # ROIAlign, tests/test_vision.py
DET_GRAD = dict(rtol=1e-4, atol=1e-5)    # the poolers' backward
NEAR_IOU = 1e-5   # a pair this close to the NMS threshold is a near tie
EXAMPLES_4G = ("rcnn_proposal", "custom_op_numpy", "svrg_regression")


class Detector:
    """The two-stage detector of examples/rcnn_proposal.py at `cfg`'s
    widths, from the port's public pieces: ResNet v1 features[:7] as C4,
    an RPN (3 x 3 conv 512 + ReLU, 1 x 1 convs to 2A scores and 4A
    deltas), `nd.softmax` over each anchor's score pair,
    `nd._contrib_Proposal`, `nd.ROIPooling` (and `nd.contrib.ROIAlign`
    beside it), features[7] + global pooling + Dense(classes) /
    Dense(4 classes), `nd.softmax`, `nd.contrib.box_decode` and
    `nd.contrib.box_nms` per class."""

    def __init__(self, cfg, ctx):
        vision_zoo = tmx.gluon.model_zoo.vision
        nn = tmx.gluon.nn
        self.cfg, self.ctx = cfg, ctx
        self.anchors = len(cfg["scales"]) * len(cfg["ratios"])
        tmx.random.seed(cfg["weight_seed"])
        base = vision_zoo.get_model(f"resnet{cfg['depth']}_v1")
        self.c4, self.stage5 = base.features[:7], base.features[7]
        self.rpn = nn.HybridSequential()
        self.rpn.add(nn.Conv2D(512, 3, padding=1, activation="relu"))
        self.rpn_cls = nn.Conv2D(2 * self.anchors, 1)
        self.rpn_reg = nn.Conv2D(4 * self.anchors, 1)
        self.pool = nn.GlobalAvgPool2D()
        self.cls = nn.Dense(cfg["classes"])
        self.reg = nn.Dense(4 * cfg["classes"])
        for block in (base, self.rpn, self.rpn_cls, self.rpn_reg, self.cls,
                      self.reg):
            block.initialize(tmx.init.Xavier(), ctx=ctx)

    def image(self):
        h, w = self.cfg["image"]
        return np.random.RandomState(self.cfg["image_seed"]).rand(
            1, 3, h, w).astype(np.float32)

    def rpn_out(self, x):
        nd = tmx.nd
        feat = self.c4(x)
        r = self.rpn(feat)
        scores, deltas = self.rpn_cls(r), self.rpn_reg(r)
        _, _, fh, fw = scores.shape
        prob = nd.softmax(scores.reshape((1, 2, self.anchors, fh, fw)),
                          axis=1).reshape((1, 2 * self.anchors, fh, fw))
        return feat, prob, deltas

    def proposal(self, prob, deltas):
        c = self.cfg
        h, w = c["image"]
        info = tmx.nd.array(np.array([[h, w, 1.0]], np.float32),
                            ctx=prob.context)
        return tmx.nd._contrib_Proposal(
            prob, deltas, info, scales=c["scales"], ratios=c["ratios"],
            feature_stride=c["stride"], rpn_pre_nms_top_n=c["pre"],
            rpn_post_nms_top_n=c["post"], threshold=c["nms"],
            rpn_min_size=c["min_size"])

    def roi_pool(self, feat, rois):
        p = self.cfg["pooled"]
        return tmx.nd.ROIPooling(feat, rois, pooled_size=(p, p),
                                 spatial_scale=1.0 / self.cfg["stride"])

    def roi_align(self, feat, rois):
        p = self.cfg["pooled"]
        return tmx.nd.contrib.ROIAlign(feat, rois, pooled_size=(p, p),
                                       spatial_scale=1.0 / self.cfg["stride"],
                                       sample_ratio=2)

    def head(self, pooled):
        h = self.pool(self.stage5(pooled)).reshape((pooled.shape[0], -1))
        return self.cls(h), self.reg(h)

    def rows(self, logits, deltas, rois):
        """(1, R * classes, 6) rows [class, score, x1, y1, x2, y2] of
        every ROI and class: softmax scores and the decoded boxes."""
        nd = tmx.nd
        r, k = logits.shape
        prob = nd.softmax(logits)
        anchors = nd.repeat(rois[:, 1:5], repeats=k, axis=0).reshape(
            (1, r * k, 4))
        boxes = nd.contrib.box_decode(deltas.reshape((1, r * k, 4)),
                                      anchors)
        ids = nd.array(np.tile(np.arange(k, dtype=np.float32), r),
                       ctx=logits.context).reshape((1, r * k, 1))
        return nd.concat(ids, prob.reshape((1, r * k, 1)), boxes, dim=2)

    def final_nms(self, rows):
        c = self.cfg
        return tmx.nd.contrib.box_nms(rows, overlap_thresh=c["final_nms"],
                                      topk=c["final_top"], id_index=0,
                                      background_id=0, valid_thresh=0.0)

    def forward(self, x):
        feat, prob, deltas = self.rpn_out(x)
        rois = self.proposal(prob, deltas)
        pooled = self.roi_pool(feat, rois)
        aligned = self.roi_align(feat, rois)
        logits, box_deltas = self.head(pooled)
        dets = self.final_nms(self.rows(logits, box_deltas, rois))
        return dict(feat=feat, prob=prob, deltas=deltas, rois=rois,
                    pooled=pooled, aligned=aligned, logits=logits,
                    box_deltas=box_deltas, dets=dets)


def _cpu(arr):
    return tmx.nd.array(arr.asnumpy(), ctx=tmx.cpu())


def nms_near_ties(label, trace, thresh):
    """Hold the card's NMS decisions to the greedy rule under the CPU's
    IoU of the card's own candidates: candidate j is kept iff it is
    valid and no kept candidate before it (of its class) overlaps it
    above `thresh`. A decision that parts from the rule must hinge on a
    pair whose IoU lies within NEAR_IOU of `thresh` (a near tie), else
    the check fails. Returns the number of near-tie decisions."""
    boxes, valid, keep = trace["boxes"], trace["valid"], trace["keep"]
    n = boxes.shape[0]
    idx = torch.arange(n)
    pairs = idx[:, None] < idx[None, :]
    if trace["ids"] is not None:
        pairs &= trace["ids"][:, None] == trace["ids"][None, :]
    iou = tv._pair_iou(boxes, boxes)
    above = (iou > thresh) & pairs
    near = ((iou - thresh).abs() <= NEAR_IOU) & pairs
    rule = valid & ~(keep[:, None] & above).any(0)
    parted = rule != keep
    hinged = (keep[:, None] & near).any(0)
    if (parted & ~hinged).any():
        j = int(torch.nonzero(parted & ~hinged)[0])
        raise AssertionError(
            f"phase 4g (a) {label}: candidate {j} of {n} kept "
            f"{bool(keep[j])} on the card, {bool(rule[j])} by the CPU's IoU, "
            f"with no pair within {NEAR_IOU:g} of IoU {thresh}")
    return int(parted.sum())


def rows_or_near_ties(label, got, want, trace, thresh):
    """The card's NMS output `got` equal to the CPU's `want` at DET_ROIS,
    or the card's decisions each the greedy rule's but for near ties
    (`nms_near_ties`). Returns (rows that part, near-tie decisions)."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n_near = nms_near_ties(label, trace, thresh)
    close = np.isclose(g, w, **DET_ROIS).all(-1)
    if close.all():
        return 0, n_near
    if n_near == 0:
        raise AssertionError(
            f"phase 4g (a) {label}: {int((~close).sum())} rows part from the "
            f"CPU's, and no decision of the card's NMS hinges on a near tie")
    print(f"  (a) {label}: {int((~close).sum())} rows part from the CPU's; "
          f"{n_near} decision(s) of the card's NMS hinge on a pair within "
          f"{NEAR_IOU:g} of IoU {thresh}: near ties")
    return int((~close).sum()), n_near


def detection_pass(device, gpu, cfg=DET):
    """Phase 4g (a): the two-stage detector at `cfg`'s widths, each stage
    held to the CPU on the card's own inputs, one backward through each
    pooler against the CPU, and times (CUDA events, median of 5 after a
    warm-up), NMS passes and the peak allocation."""
    t0 = time.perf_counter()
    ctx = tmx.gpu(0) if device.type == "cuda" else tmx.cpu()
    det = Detector(cfg, ctx)
    x = tmx.nd.array(det.image(), ctx=ctx)
    torch.cuda.reset_peak_memory_stats()
    tv.NMS_PASSES.clear()
    tv.NMS_TRACE = []
    try:
        with torch.no_grad():
            out = det.forward(x)
            torch.cuda.synchronize()
    finally:
        traces, tv.NMS_TRACE = tv.NMS_TRACE, None
    passes = list(tv.NMS_PASSES)
    peak = torch.cuda.max_memory_allocated()
    rois = out["rois"].asnumpy()
    dets = out["dets"].asnumpy()
    if rois.shape != (cfg["post"], 5) or not np.isfinite(rois).all():
        raise AssertionError(f"phase 4g (a): rois {rois.shape}")
    kept = dets[0][dets[0, :, 0] >= 0]
    for k in ("logits", "box_deltas", "pooled", "aligned"):
        if not np.isfinite(out[k].asnumpy()).all():
            raise AssertionError(f"phase 4g (a): {k} not finite")

    # each stage on the CPU from the card's own inputs
    cpu_rois = det.proposal(_cpu(out["prob"]), _cpu(out["deltas"]))
    part_p, near_p = rows_or_near_ties("Proposal rois", rois,
                                       cpu_rois.asnumpy(), traces[0],
                                       cfg["nms"])
    feat_cpu, rois_cpu = _cpu(out["feat"]), _cpu(out["rois"])
    cpu_pool = det.roi_pool(feat_cpu, rois_cpu).asnumpy()
    if not np.array_equal(out["pooled"].asnumpy(), cpu_pool):
        raise AssertionError("phase 4g (a): ROIPooling on the card is not "
                             "the CPU's exactly")
    cpu_align = det.roi_align(feat_cpu, rois_cpu).asnumpy()
    align_err = float(np.abs(out["aligned"].asnumpy() - cpu_align).max())
    if not np.allclose(out["aligned"].asnumpy(), cpu_align, **DET_ALIGN):
        raise AssertionError(f"phase 4g (a): ROIAlign on the card off the "
                             f"CPU's by {align_err:.3e}")
    with torch.no_grad():
        rows = det.rows(out["logits"], out["box_deltas"], out["rois"])
    cpu_dets = det.final_nms(_cpu(rows)).asnumpy()
    part_f, near_f = rows_or_near_ties("final NMS", dets[0], cpu_dets[0],
                                       traces[1], cfg["final_nms"])

    # one backward through each pooler, card against CPU
    head = np.random.RandomState(7).randn(
        *out["pooled"].shape).astype(np.float32)
    grad_err = {}
    for name, fn in (("ROIPooling", det.roi_pool), ("ROIAlign",
                                                    det.roi_align)):
        grads = []
        for f, r in ((out["feat"], out["rois"]), (feat_cpu, rois_cpu)):
            f = f.copy()
            f.attach_grad()
            with tmx.autograd.record():
                y = fn(f, r)
            y.backward(tmx.nd.array(head, ctx=f.context))
            grads.append(f.grad.asnumpy())
        grad_err[name] = float(np.abs(grads[0] - grads[1]).max())
        if not np.allclose(grads[0], grads[1], **DET_GRAD):
            raise AssertionError(f"phase 4g (a): {name}'s backward on the "
                                 f"card off the CPU's by "
                                 f"{grad_err[name]:.3e}")

    # times: the whole forward, the Proposal and each pooler
    def timed(fn, reps=5):
        fn()
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return float(np.median(ms))

    with torch.no_grad():
        t_fwd = timed(lambda: det.forward(x))
        t_prop = timed(lambda: det.proposal(out["prob"], out["deltas"]))
        t_pool = timed(lambda: det.roi_pool(out["feat"], out["rois"]))
        t_align = timed(lambda: det.roi_align(out["feat"], out["rois"]))
    fh, fw = out["feat"].shape[2:]
    print(f"  (a) detection pass at {cfg['image'][0]} x {cfg['image'][1]} "
          f"(ResNet-{cfg['depth']} v1 C4, map {fh} x {fw} x "
          f"{out['feat'].shape[1]}, {fh * fw * det.anchors} anchors, pre "
          f"{cfg['pre']} / post {cfg['post']}, pooled {cfg['pooled']}, "
          f"{cfg['classes']} classes): {len(kept)} detections after the "
          f"per-class NMS; Proposal rois the CPU's ({part_p} rows part, "
          f"{near_p} near-tie decisions), ROIPooling exact, ROIAlign within "
          f"rtol {DET_ALIGN['rtol']:g} (largest diff {align_err:.3e}), final "
          f"NMS the CPU's ({part_f} rows part, {near_f} near-tie "
          f"decisions); backward ROIPooling / ROIAlign "
          f"largest diff {grad_err['ROIPooling']:.3e} / "
          f"{grad_err['ROIAlign']:.3e}")
    print(f"  (a) NMS passes (Proposal, final): {passes}; forward "
          f"{t_fwd:.3f} ms, Proposal {t_prop:.3f} ms, ROIPooling "
          f"{t_pool:.3f} ms, ROIAlign {t_align:.3f} ms (CUDA events, median "
          f"of 5 after a warm-up); peak allocation {peak / 2**30:.3f} GiB; "
          f"{time.perf_counter() - t0:.1f} s [{gpu}]")
    return dict(passes=passes, fwd_ms=t_fwd, proposal_ms=t_prop,
                pool_ms=t_pool, align_ms=t_align, peak=peak,
                detections=len(kept))


def examples_4g(gpu):
    """Phase 4g (b): rcnn_proposal, custom_op_numpy and svrg_regression as
    written, on the card; each must print its OK line, rcnn_proposal a
    recall of at least 0.7."""
    for name in EXAMPLES_4G:
        t0 = time.perf_counter()
        log = run_example(name)
        lines = log.strip().splitlines()
        if f"{name} OK" not in log:
            raise AssertionError(f"phase 4g (b): {name} did not finish: "
                                 f"{lines[-3:]}")
        if name == "rcnn_proposal":
            recall = float(re.search(r"recall@0.5: ([0-9.]+)",
                                     log).group(1))
            if recall < 0.7:
                raise AssertionError(f"phase 4g (b): recall {recall}")
        print(f"  (b) {name}: {' | '.join(lines[-2:])} "
              f"({time.perf_counter() - t0:.1f} s) [{gpu}]")


def vision_leg(device, gpu):
    """Phase 4g: (a) the detection pass, (b) the three examples; (c) is
    phase 4c (c), which holds the vision and contrib registry cases on
    the card."""
    t0 = time.perf_counter()
    out = {"detection": detection_pass(device, gpu)}
    examples_4g(gpu)
    out["seconds"] = time.perf_counter() - t0
    print(f"  vision leg: {out['seconds']:.1f} s [{gpu}]")
    return out


# -- phase 4h: reduced precision (amp float16, int8 inference) ---------------

AMP_APPLIED = 3    # applied steps the float16 leg runs to ...
AMP_MAX_STEPS = 24  # ... within this many (a summed batch-128 loss's
                    # gradients overflow float16 until the scale is ~2^6)
AMP_SGD = dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
               multi_precision=True)
# the fused float16 step's movement may part from a float32 step's by at
# most this many times the unfused float16 chain's gap (the two float16
# chains part from each other by more than 2e-2: the scale settles at
# 2^6, where small gradients underflow float16)
AMP_GAP_FACTOR = 2.0
AMP_WINDOW = 2     # the growth run's scale_window, from half the scale
                   # the default scaler settled at
BACKOFF_AT = 2    # the guardrail leg's poisoned step
INT8 = dict(batch=32, calib_batches=4, held=2, seed=1)
INT8_LOGIT_RTOL = 1e-5


def _params_of(trainer):
    """The trainer's parameters with data, in its order."""
    return [p for p in trainer._params if p._data is not None]


def _state_tensors(trainer):
    return [t for s in trainer._updater.states.values()
            for t in (s if isinstance(s, tuple) else (s,))
            if t is not None]


def _masters(trainer):
    """{index: float32 master} of a multi-precision trainer's parameters
    (the float32 copy of the weight where no state exists yet)."""
    out = {}
    for i, p in enumerate(trainer._params):
        s = trainer._updater.states.get(i)
        w = s[1]._data if isinstance(s, tuple) else p.tensor()
        out[i] = w.detach().float().clone()
    return out


def amp_steps(trainer, scaler, net, data, label, steps, fused, record=None,
              applied=None):
    """Up to `steps` loss-scaled steps through the imperative loop (fewer
    once `applied` steps were applied), each held to the reference's
    policy: an overflowed step leaves every weight and optimizer state
    bit-equal and halves the scale; a clean one moves the weights and
    keeps the scale until the window doubles it. Each step must launch
    each epilogue kernel EPI_PER_STEP times with the knob on (`fused`),
    none with it off. With `record`, the float32 masters before and after
    the first applied step are kept in it. Returns the scale trail
    [(scale applied, overflowed, loss)]."""
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    trail = []
    want = EPI_PER_STEP if fused else 0
    for i in range(steps):
        if applied is not None and \
                sum(not o for _, o, _ in trail) >= applied:
            break
        before = [p.tensor().detach().clone() for p in _params_of(trainer)]
        states = [t._data.clone() for t in _state_tensors(trainer)]
        masters = _masters(trainer) if record is not None and \
            "after" not in record else None
        scale, window = scaler.loss_scale, scaler._unskipped
        launched = [k.launches for k in EPI_KERNELS]
        with tmx.autograd.record():
            loss = loss_fn(net(data), label)
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
        overflow = scaler.has_overflow(
            [p.grad() for p in _params_of(trainer)])
        trainer.step(data.shape[0])
        for k, b in zip(EPI_KERNELS, launched):
            if k.launches - b != want:
                raise AssertionError(f"phase 4h (a): {k.__name__} launched "
                                     f"{k.launches - b} times in step "
                                     f"{i + 1}, expected {want}")
        same = all(torch.equal(a, p.tensor())
                   for a, p in zip(before, _params_of(trainer)))
        if overflow:
            same_states = all(torch.equal(a, t._data) for a, t in
                              zip(states, _state_tensors(trainer)))
            if not (same and same_states and scaler.loss_scale == max(
                    scaler.min_scale, scale / scaler.scale_factor)):
                raise AssertionError(
                    f"phase 4h (a): overflowed step {i + 1} (scale "
                    f"{scale:g}) moved the weights or states ({not same}, "
                    f"{not same_states}) or set the scale to "
                    f"{scaler.loss_scale:g}")
        else:
            grown = window + 1 >= scaler.scale_window
            if same or scaler.loss_scale != (
                    scale * scaler.scale_factor if grown else scale):
                raise AssertionError(
                    f"phase 4h (a): clean step {i + 1} (scale {scale:g}) "
                    f"left the weights ({same}) or set the scale to "
                    f"{scaler.loss_scale:g}")
            if record is not None and "after" not in record:
                record["before"], record["after"] = masters, \
                    _masters(trainer)
        mean = float(loss.asnumpy().astype(np.float32).mean())
        if not math.isfinite(mean):
            raise AssertionError(f"phase 4h (a): loss {mean} at step {i + 1}")
        trail.append((scale, bool(overflow), mean))
    return trail


def _trail_text(trail):
    return ", ".join(f"{s:g}{' skipped' if o else ''} (loss {l:.4f})"
                     for s, o, l in trail)


def amp_net(x, device, dtype, fused):
    os.environ["MXTPU_FUSED_EPILOGUE"] = "1" if fused else "0"
    net = resnet50(x, device)
    amp.convert_block(net, dtype)
    return net


def amp_leg(batch, device, gpu):
    """Phase 4h (a): ResNet-50 v1 at bench.py's setup converted to float16
    (`amp.convert_block`, BatchNorm float32), SGD (momentum 0.9, wd 1e-4,
    multi_precision) under the default scaler through the imperative
    loop with the knob on: the scale trail and each step's policy; the
    first applied step against the knob-off chain's; a scale_window 2
    run that grows the scale; the backoff guardrail; one bfloat16 step.
    Returns the float16 leg's epilogue launches and its trail."""
    x, y = batch
    data = tmx.nd.NDArray._from_data(x.half())
    label = tmx.nd.NDArray._from_data(y)
    try:
        net = amp_net(x, device, "float16", True)
        for k in EPI_KERNELS:
            k.launches = 0
        dtypes = {str(p.data().dtype).replace("torch.", "")
                  for p in net.collect_params().values()}
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    dict(AMP_SGD))
        scaler = amp.init_trainer(trainer)
        on = {}
        t0 = time.perf_counter()
        trail = amp_steps(trainer, scaler, net, data, label, AMP_MAX_STEPS,
                          True, record=on, applied=AMP_APPLIED)
        seconds = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in EPI_KERNELS}
        skipped = [i + 1 for i, (_, o, _) in enumerate(trail) if o]
        print(f"  (a) float16, knob on, default scaler: parameter dtypes "
              f"{sorted(dtypes)}; scale trail {_trail_text(trail)}; "
              f"skipped steps {skipped}; epilogue launches {launches} "
              f"({EPI_PER_STEP} of each a step); {len(trail)} steps in "
              f"{seconds:.1f} s [{gpu}]")
        if "after" not in on:
            raise AssertionError("phase 4h (a): no step was applied")
        # the scale grows after a window of clean steps
        start = scaler.loss_scale / 2
        growth = amp.init_trainer(trainer, amp.DynamicLossScaler(
            init_scale=start, scale_window=AMP_WINDOW))
        g_trail = amp_steps(trainer, growth, net, data, label,
                            AMP_WINDOW + 1, True)
        if max(s for s, _, _ in g_trail) <= start and \
                growth.loss_scale <= start:
            raise AssertionError(f"phase 4h (a): scale_window "
                                 f"{AMP_WINDOW} grew no scale: {g_trail}")
        print(f"      scale_window {AMP_WINDOW} from {start:g}: "
              f"{_trail_text(g_trail)}, then {growth.loss_scale:g}")
        del trainer, growth, scaler
        # the knob-off chain to its first applied step
        net_off = amp_net(x, device, "float16", False)
        trainer = tmx.gluon.Trainer(net_off.collect_params(), "sgd",
                                    dict(AMP_SGD))
        off = {}
        off_trail = amp_steps(trainer, amp.init_trainer(trainer), net_off,
                              data, label, len(skipped) + 1, False,
                              record=off)
        if [o for _, o, _ in off_trail] != \
                [o for _, o, _ in trail[:len(off_trail)]]:
            raise AssertionError(f"phase 4h (a): the knob-off trail "
                                 f"{off_trail} parts from {trail}")
        names = [p.name[len(net_off.prefix):] for p in trainer._params]
        masters_gap = math.sqrt(
            sum(float(((on["after"][i] - off["after"][i]) ** 2).sum())
                for i in range(len(names)))
            / sum(float((off["after"][i] ** 2).sum())
                  for i in range(len(names))))
        del net_off, trainer
        gaps = movement_gaps(names, on, off, f32_movement(x, y, device))
        print(f"      first applied step (scale "
              f"{trail[len(skipped)][0]:g}), knob on against knob off (the "
              f"unfused chain): float32 masters {masters_gap:.3e} apart "
              f"(relative 2-norm over the net); the step's "
              f"movement, relative 2-norm over the net: on against off "
              f"{gaps['on_off']:.3e}, on against a float32 step "
              f"{gaps['on']:.3e}, off against it {gaps['off']:.3e} "
              f"(fused within {AMP_GAP_FACTOR:g} x the unfused gap); the "
              f"largest parameter gaps on / off against float32: "
              f"{gaps['worst_on'][1]} {gaps['worst_on'][0]:.3e}, "
              f"{gaps['worst_off'][1]} {gaps['worst_off'][0]:.3e}")
        if gaps["on"] > AMP_GAP_FACTOR * gaps["off"]:
            raise AssertionError(f"phase 4h (a): knob on against off: "
                                 f"masters {masters_gap}, {gaps}")
        backoff_leg(net, data, label, gpu)
        del net
        gc.collect()
        torch.cuda.empty_cache()
        bf16_amp_step(x, y, device, gpu)
    finally:
        os.environ.pop("MXTPU_FUSED_EPILOGUE", None)
    return dict(launches=launches, trail=trail, seconds=seconds)


def f32_movement(x, y, device):
    """{index: movement} of one float32 imperative step (knob off, TF32
    off) from the float16 legs' initial weights: the yardstick of their
    first applied step."""
    net = amp_net(x, device, "float32", False)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(AMP_SGD))
    before = [p.tensor().detach().clone() for p in trainer._params]
    imperative_step(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), trainer,
                    tmx.nd.NDArray._from_data(x),
                    tmx.nd.NDArray._from_data(y))
    return {i: p.tensor().detach() - b
            for i, (p, b) in enumerate(zip(trainer._params, before))}


def movement_gaps(names, on, off, ref):
    """Relative 2-norm gaps over the net of the first applied step's
    movements (float32 masters): knob on against off, and each against
    the float32 step `ref`; conv biases (before a BatchNorm: true
    gradient 0) left out. Also each chain's largest gap of one
    parameter against `ref`."""
    keep = [i for i, n in enumerate(names)
            if not ("conv" in n and n.endswith("bias"))]
    mv = {k: {i: d["after"][i] - d["before"][i] for i in keep}
          for k, d in (("on", on), ("off", off))}

    def gap(a, b):
        num = sum(float(((a[i] - b[i]) ** 2).sum()) for i in keep)
        return math.sqrt(num / sum(float((b[i] ** 2).sum()) for i in keep))

    out = {"on_off": gap(mv["on"], mv["off"]), "on": gap(mv["on"], ref),
           "off": gap(mv["off"], ref)}
    for k in ("on", "off"):
        out[f"worst_{k}"] = max(
            (float((mv[k][i] - ref[i]).norm() / ref[i].norm()), names[i])
            for i in keep)
    return out


def backoff_leg(net, data, label, gpu):
    """MXTPU_GUARDRAIL_POLICY=backoff with grad.nonfinite at step
    BACKOFF_AT of a Trainer with no loss scaler: that step is skipped
    (the weights bit-equal), the trip counter goes up by one and the
    unit scaler attached stays at 1.0."""
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    was = telemetry.enabled()
    telemetry.enable()
    os.environ["MXTPU_GUARDRAIL_POLICY"] = "backoff"
    fault.install(fault.FaultInjector(f"grad.nonfinite:fail@{BACKOFF_AT}",
                                      0))
    trips = telemetry.counter("mxtpu_guardrail_trips_total")
    try:
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    dict(AMP_SGD))
        n0 = trips.value(policy="backoff", reason="nonfinite-grad")
        seen = []
        for i in range(BACKOFF_AT + 1):
            before = [p.tensor().detach().clone()
                      for p in _params_of(trainer)]
            with tmx.autograd.record():
                loss = loss_fn(net(data), label)
            loss.backward()
            trainer.step(data.shape[0])
            same = all(torch.equal(a, p.tensor())
                       for a, p in zip(before, _params_of(trainer)))
            scaler = getattr(trainer, "_amp_scaler", None)
            seen.append((same, None if scaler is None else
                         scaler.loss_scale))
        n1 = trips.value(policy="backoff", reason="nonfinite-grad")
    finally:
        fault.install(None)
        os.environ.pop("MXTPU_GUARDRAIL_POLICY", None)
        if not was:
            telemetry.disable()
    want = [(False, None)] * (BACKOFF_AT - 1) + [(True, 1.0), (False, 1.0)]
    print(f"      backoff guardrail, grad.nonfinite at step {BACKOFF_AT}: "
          f"(weights unchanged, scale) per step {seen}; "
          f"mxtpu_guardrail_trips_total{{policy=\"backoff\"}} {n0:g} -> "
          f"{n1:g}")
    if seen != want or n1 != n0 + 1:
        raise AssertionError(f"phase 4h (a) backoff: {seen}, trips "
                             f"{n0} -> {n1}")


def bf16_amp_step(x, y, device, gpu):
    """One step of convert_block(net, "bfloat16") (the JAX package's
    default target) with the knob on and no loss scaler: kernels 6-7 in
    bfloat16 EPI_PER_STEP times each, BatchNorm parameters float32."""
    net = amp_net(x, device, "bfloat16", True)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                dict(AMP_SGD))
    launched = [k.launches for k in EPI_KERNELS]
    loss = imperative_step(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                           trainer,
                           tmx.nd.NDArray._from_data(x.bfloat16()),
                           tmx.nd.NDArray._from_data(y))
    counts = [k.launches - b for k, b in zip(EPI_KERNELS, launched)]
    kinds = {n.rsplit("_", 1)[-1]: str(p.data().dtype).replace("torch.", "")
             for n, p in net.collect_params().items()}
    mean = float(loss.asnumpy().astype(np.float32).mean())
    print(f"      bfloat16 step, knob on: loss {mean:.4f}, epilogue "
          f"launches {counts}, weight {kinds['weight']}, gamma "
          f"{kinds['gamma']}, running_var {kinds['var']} [{gpu}]")
    if counts != [EPI_PER_STEP] * 2 or not math.isfinite(mean) or \
            (kinds["weight"], kinds["gamma"]) != ("bfloat16", "float32"):
        raise AssertionError(f"phase 4h (a) bfloat16: {counts}, {mean}, "
                             f"{kinds}")


def events_ms(fn, reps=5):
    """Median of `reps` CUDA-event timings of fn() after one warm-up:
    the wall time of the device's work, host enqueue gaps included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def int8_batches():
    rng = np.random.RandomState(INT8["seed"])
    S = RESNET["image"]
    return [rng.rand(INT8["batch"], 3, S, S).astype(np.float32)
            for _ in range(INT8["calib_batches"])]


def _host_steps(steps):
    """The program's tensors on the host, by path."""
    out = {}

    def walk(v, path):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(x, f"{path}.{k}")
        elif isinstance(v, list):
            for i, x in enumerate(v):
                walk(x, f"{path}[{i}]")
        elif isinstance(v, torch.Tensor):
            out[path] = v.cpu()
        elif isinstance(v, float):
            out[path] = v
    walk(steps, "")
    return out


def int8_leg(device, gpu):
    """Phase 4h (b): ResNet-50 v1 at ImageNet widths (1000 classes, 224^2,
    NCHW, Xavier seed 0, float32) through `as_chain` and `quantize_net`
    (minmax, then entropy) over INT8["calib_batches"] seeded batches of
    32: no float32 island; the int8 forward against the float32 one at
    batch 32 (CUDA events, median of 5; peak allocation); the programs'
    mean relative logit error against the float32 net; and on 2 images
    the program rebuilt on the CPU from the card's ranges: int8 weights,
    biases and scales bit-equal, every int8 code along the chain equal,
    the logits at rtol 1e-5."""
    t0 = time.perf_counter()
    calls0 = qops.INT_MM_CALLS
    net = vision.resnet50_v1(classes=RESNET["classes"])
    net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                   .manual_seed(RESNET["seed"])),
                   device=device)
    batches = int8_batches()
    probe = tmx.nd.NDArray._from_data(
        torch.from_numpy(batches[0][:2]).to(device))
    with tmx.autograd.predict_mode():
        net(probe)
        chain = q.as_chain(net, probe=probe)
        calib = [[tmx.nd.NDArray._from_data(
            torch.from_numpy(b).to(device))] for b in batches]
        progs, calib_s = {}, {}
        for mode in ("minmax", "entropy"):
            t = time.perf_counter()
            progs[mode] = q.quantize_net(chain, calib,
                                         num_calib_batches=len(calib),
                                         calib_mode=mode)
            torch.cuda.synchronize()
            calib_s[mode] = time.perf_counter() - t
            if progs[mode].num_fp32_islands != 0:
                raise AssertionError(f"phase 4h (b): {mode}: "
                                     f"{progs[mode].num_fp32_islands} "
                                     f"float32 islands")
        xb = calib[0][0]._data
        with torch.no_grad():
            ref = chain(xb)
            f32_ms = events_ms(lambda: chain(xb))
        rel = {}
        for mode, prog in progs.items():
            got = prog.apply(xb)
            rel[mode] = float((got - ref).abs().mean() / ref.abs().mean())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        int8_ms = events_ms(lambda: progs["minmax"].apply(xb))
        peak = torch.cuda.max_memory_allocated() - base
        calls = qops.INT_MM_CALLS - calls0
        units = sum(s["kind"] == "resunit" for s in progs["minmax"]._steps)
        print(f"  (b) int8 ResNet-50 v1, {RESNET['classes']} classes, "
              f"{RESNET['image']}^2, batch "
              f"{INT8['batch']}: {units} int8 residual units, 0 float32 "
              f"islands in both modes; calibration over "
              f"{INT8['calib_batches']} batches minmax "
              f"{calib_s['minmax']:.1f} s, entropy "
              f"{calib_s['entropy']:.1f} s; forward int8 {int8_ms:.2f} ms "
              f"against float32 {f32_ms:.2f} ms (CUDA events, median of 5, "
              f"TF32 off; peak allocation of the int8 forward "
              f"{peak / 2**20:.1f} MiB over its inputs); mean relative "
              f"logit error against float32: minmax {rel['minmax']:.4f}, "
              f"entropy {rel['entropy']:.4f}; _int_mm calls {calls} "
              f"[{gpu}]")
        if calls == 0:
            raise AssertionError("phase 4h (b): no int8 product went "
                                 "through torch._int_mm")
        int8_against_cpu(net, progs["minmax"], xb[:INT8["held"]], gpu)
    out = dict(int8_ms=int8_ms, f32_ms=f32_ms, peak=peak, rel=rel,
               seconds=time.perf_counter() - t0)
    del net, chain, progs, calib
    gc.collect()
    torch.cuda.empty_cache()
    return out


def int8_against_cpu(net, prog, x, gpu):
    """The card's minmax program against the one rebuilt on the CPU from
    its calibrated ranges (a CPU copy of the net's weights): the int8
    weights, biases and scales bit-equal, every int8 code the chain makes
    equal, the logits at INT8_LOGIT_RTOL."""
    t0 = time.perf_counter()
    cpu_net = vision.resnet50_v1(classes=RESNET["classes"])
    cpu_net.initialize(tmx.init.Zero(), device="cpu")
    load_numpy_params(cpu_net, {n: p.data().asnumpy() for n, p in
                                net.collect_params().items()},
                      prefix=net.prefix)
    cpu_prog = q.quantize_net_from_ranges(q.as_chain(cpu_net), prog.ranges)
    card, host = _host_steps(prog._steps), _host_steps(cpu_prog._steps)
    if card.keys() != host.keys() or not all(
            (torch.equal(card[k], host[k]) if isinstance(card[k],
                                                         torch.Tensor)
             else card[k] == host[k]) for k in card):
        bad = [k for k in card if k not in host or not (
            torch.equal(card[k], host[k]) if isinstance(card[k],
                                                        torch.Tensor)
            else card[k] == host[k])]
        raise AssertionError(f"phase 4h (b): the CPU program's weights or "
                             f"scales part from the card's: {bad[:5]}")
    codes_card, codes_cpu = [], []
    got = prog.apply(x, codes=codes_card).cpu()
    want = cpu_prog.apply(x.cpu(), codes=codes_cpu)
    parted = [i for i, (a, b) in enumerate(zip(codes_card, codes_cpu))
              if not torch.equal(a.cpu(), b)]
    n_codes = sum(c.numel() for c in codes_cpu)
    print(f"      held to the CPU on {x.shape[0]} images: {len(card)} "
          f"program tensors and scales bit-equal; {len(codes_cpu)} int8 "
          f"activations ({n_codes} codes), {len(parted)} parted; logits "
          f"max abs diff {float((got - want).abs().max()):.3e} "
          f"({time.perf_counter() - t0:.1f} s)")
    if len(codes_card) != len(codes_cpu) or parted:
        raise AssertionError(f"phase 4h (b): int8 codes part from the CPU "
                             f"at activations {parted[:5]}")
    if not torch.allclose(got, want, rtol=INT8_LOGIT_RTOL, atol=0):
        raise AssertionError("phase 4h (b): logits part from the CPU's")


def quantized_example(gpu):
    """Phase 4h (c): examples/quantized_inference.py as written (the
    port's imports), its own asserts: int8 accuracy within 1 % of
    float32 on LeNet, resnet18_v1 with 0 islands and rel < 0.1."""
    t0 = time.perf_counter()
    log = run_example("quantized_inference")
    lines = log.strip().splitlines()
    if "quantized inference OK" not in log:
        raise AssertionError(f"phase 4h (c): the example did not finish: "
                             f"{lines[-3:]}")
    print(f"  (c) quantized_inference: {' | '.join(lines[-3:])} "
          f"({time.perf_counter() - t0:.1f} s) [{gpu}]")


def reduced_precision_leg(batch, device, gpu):
    """Phase 4h: (a) amp float16 (and one bfloat16 step), (b) int8
    ResNet-50, (c) examples/quantized_inference.py."""
    t0 = time.perf_counter()
    out = {"amp": amp_leg(batch, device, gpu)}
    out["int8"] = int8_leg(device, gpu)
    quantized_example(gpu)
    out["seconds"] = time.perf_counter() - t0
    print(f"  reduced-precision leg: {out['seconds']:.1f} s [{gpu}]")
    return out


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
        time.sleep(WINDOW_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(WINDOW_MARGIN_S)
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


def epilogue_rows(errs, launches, flush, device, gpu, f16_launches):
    """Times of kernels 6 and 7 at the stem and stage-1 join shapes,
    float32, each beside its plain version and its bound (no single
    library call computes either function), then the chain each replaces
    in the knob-off leg: `ops.epilogue.bn_act` with the knob off (the
    training-mode BatchNorm, the add and the ReLU) and with it on (the
    batch moments, the folded scale and shift and the kernel), forward
    and forward + backward; then each in bfloat16 and float16. The JSON
    rows are the stage-1 join's."""
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
        epilogue_half_times(label, torch.bfloat16, R, C, residual, flush,
                            device, gpu)
        epilogue_half_times(label, torch.float16, R, C, residual, flush,
                            device, gpu, f16_launches)
    return rows


def epilogue_half_times(label, dtype, R, C, residual, flush, device, gpu,
                        launches=None):
    """Kernels 6 and 7 in bfloat16 or float16 (the activations of the
    nets `amp.convert_block` casts) at one of EPI_TIMED's shapes, each
    held to its plain version (at EPI_TOL / the channel sums' tolerance)
    and timed beside it and its bound (half of the float32 bytes for the
    activations); `launches`, the kernels' launches on the path that ran
    them in this dtype (phase 4h (a) for float16), is printed beside."""
    x, scale, shift, res, dy = epi_case(device, dtype, R, C, residual)
    y = ep.bn_act_epilogue_fwd(x, scale, shift, res)
    name = str(dtype).replace("torch.", "")
    check(f"bn_act_epilogue_fwd {name} {label}", y,
          ep.bn_act_epilogue_fwd_ref(x, scale, shift, res), EPI_TOL[dtype])
    got = ep.bn_act_epilogue_bwd(x, scale, y, dy, residual)
    want = ep.bn_act_epilogue_bwd_ref(x, scale, y, dy, residual)
    for out, a, b in zip(("dx", "dscale", "dshift", "dres"), got, want):
        check(f"bn_act_epilogue_bwd {name} {label} {out}", a, b,
              *epi_grad_tol(out, dtype, R))
    calls = {
        "bn_act_epilogue_fwd": (
            lambda: ep.bn_act_epilogue_fwd(x, scale, shift, res),
            lambda: ep.bn_act_epilogue_fwd_ref(x, scale, shift, res)),
        "bn_act_epilogue_bwd": (
            lambda: ep.bn_act_epilogue_bwd(x, scale, y, dy, residual),
            lambda: ep.bn_act_epilogue_bwd_ref(x, scale, y, dy, residual)),
    }
    for kernel_name, (kernel, plain) in calls.items():
        ms = device_ms(kernel, flush=flush)
        plain_ms = device_ms(plain, flush=flush)
        b_ms, b_by = epilogue_bound_ms(R, C, 2, kernel_name, residual)
        print(f"  {kernel_name} {name} {label} R{R} C{C}"
              f"{' residual' if residual else ''}: kernel {ms * 1e3:.1f} "
              f"us, plain {plain_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} "
              f"us ({b_by})"
              + ("" if launches is None else
                 f"; launches on phase 4h (a)'s float16 path "
                 f"{launches[kernel_name]}") + f" [{gpu}]")


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
            leaves = [xs, norm.gamma.tensor(), norm.beta.tensor()]
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


def resnet_times(leg, out, batch, gpu, fused=None, dtype="float32"):
    """Device and host time of one ResNet-50 step of `leg`, images/s over
    10 steps (host clock, one sync at the end), and a traced window; the
    knob is set as the leg trains (each forward reads it)."""
    step = out["step"]
    x, y = batch
    fused = leg == "fused" if fused is None else fused
    os.environ["MXTPU_FUSED_EPILOGUE"] = "1" if fused else "0"
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
              f"{x.shape[1]}x{x.shape[2]}, NHWC {dtype}): device {dev:.3f} "
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
               spans=(), stats=None):
    """Traced window (torch.profiler) over `steps` calls: the share of
    wall time with a kernel running, and the `top_n` kernels taking the
    most device time (with `kinds`, the device time by kind of kernel
    too). Tracing adds host time, so the busy share is a lower bound for
    an untraced run. Each name in `spans` must appear among the window's
    host ranges (a telemetry span's record_function); the spans' counts
    are printed, and their ranges are no kernel time. Returns the last
    call's result and {device event name: events in the window}; `stats`
    (a dict) gets the busy share as "busy" and the window's wall seconds
    as "wall_s"."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_MARGIN_S)
        t0 = time.perf_counter()
        for _ in range(steps):
            result = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(WINDOW_MARGIN_S)
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
    if stats is not None:
        stats.update(busy=busy / wall_us, wall_s=wall_us / 1e6)
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


def phase_seconds(t_phase):
    """Print the seconds since `t_phase` (a phase's start); return now."""
    now = time.perf_counter()
    print(f"  (phase took {now - t_phase:.1f} s)")
    return now


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
    t0 = t_call = t_phase = time.perf_counter()
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

    t_phase = phase_seconds(t_phase)
    print("phase 2: kernels against their plain versions")
    errs = kernels_against_plain(device)

    t_phase = phase_seconds(t_phase)
    print("phase 3: serving at full width")
    cfg = tfm.TransformerConfig(**FULL)
    params = tfm.init_params(cfg, seed=0, device=device)
    legs = {"off": {}, **LEVER_LEGS}
    served, flash_launches, oracles = {}, {}, {}
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
        flash_launches[leg], ties, oracle = match_generate(cfg, params, out,
                                                           device)
        oracles[leg] = oracle
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

    t_phase = phase_seconds(t_phase)
    print("phase 3b: the fleet at full width")
    fleet = fleet_legs(
        cfg, params, oracles["off"], device, gpu,
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_fleet_trace"))

    t_phase = phase_seconds(t_phase)
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
    print(" bench.py's headline path: bfloat16, scan, accum, remat")
    rbatch = resnet["batch"]
    try:
        legs11 = bf16_legs(rbatch, device, resnet["unfused"]["losses"][0])
        scan_leg("scan float32", device, None, planted_fault=True)
        scan_leg("scan bfloat16", device, "bfloat16")
        accum_leg(rbatch, device)
        remat_legs(rbatch, device, resnet["unfused"])
    finally:
        os.environ.pop("MXTPU_FUSED_EPILOGUE", None)
    for leg in ("bf16 unfused", "compute_dtype"):
        del legs11[leg]
    gc.collect()
    torch.cuda.empty_cache()

    t_phase = phase_seconds(t_phase)
    print("phase 4c: gluon's imperative surface")
    imperative_leg(device, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    t_phase = phase_seconds(t_phase)
    print("phase 4d: gluon's recurrent surface, CTC, the zoo, the profiler")
    recurrent_leg(device, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    t_phase = phase_seconds(t_phase)
    print("phase 4e: the training toolkit")
    toolkit_leg(device, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    t_phase = phase_seconds(t_phase)
    print("phase 4f: the recommender path (no kernel of the ten runs on it)")
    recommender_leg(device, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    t_phase = phase_seconds(t_phase)
    print("phase 4g: the vision and contrib op families (no kernel of the "
          "ten runs on them)")
    vision_leg(device, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    t_phase = phase_seconds(t_phase)
    print("phase 4h: reduced precision, amp float16 and int8 (kernels 6-7 "
          "in float16 and bfloat16)")
    reduced = reduced_precision_leg(resnet["batch"], device, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    t_phase = phase_seconds(t_phase)
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
    w = fleet["wire"]
    print(f"  fleet, wire leg (2 replicas, one killed, a replacement; 16 "
          f"streams through the gateway, host clock): {w['tokens']} tokens "
          f"in {w['wall_s']:.3f} s, {w['tokens_per_s']:.1f} tokens/s; TTFT "
          f"p50 {w['ttft_p50'] * 1e3:.3f} ms, largest "
          f"{w['ttft_max'] * 1e3:.3f} ms; request latency p50 "
          f"{w['latency_p50'] * 1e3:.3f} ms, largest "
          f"{w['latency_max'] * 1e3:.3f} ms; failover pause (kill to the "
          f"survivor's first token of a resubmitted request, heartbeat "
          f"timeout {WIRE_HEARTBEAT:g} s) {w['pause_s'] * 1e3:.1f} ms over "
          f"{w['resubmitted']} resubmitted request(s); a round on the "
          f"healed fleet {w['round_s'] * 1e3:.1f} ms untraced; device busy "
          + (f"{w['busy']:.1%} of a profiled round "
             f"({w['profiled_s'] * 1e3:.1f} ms)" if w["busy"] is not None
             else "not measured")
          + f"; phase 3b {fleet['seconds']:.1f} s [{gpu}]")
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
    bf16 = legs11["bf16 fused"]
    resnet_times("bf16 fused", bf16, (bf16["x"], bf16["y"]), gpu, fused=True,
                 dtype="bfloat16")
    del legs11, bf16
    gc.collect()
    torch.cuda.empty_cache()
    bench_runs(gpu)
    rows += epilogue_rows(errs, resnet["fused"]["launches"], flush, device,
                          gpu, reduced["amp"]["launches"])
    torch.cuda.synchronize()

    phase_seconds(t_phase)
    print(f"whole call: {time.perf_counter() - t_call:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
