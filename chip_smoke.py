#!/usr/bin/env python3
"""Chip check of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the repository root on a machine with one CUDA device.  Phases, in
order; any failure ends the run with a non-zero exit and no result line:

1. device   — CUDA must be available; prints the card's name and power limit
              as ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. build    — compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``
              (one ``nvcc`` per source, started together).
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the serving and training paths' shapes (WKV-6 at rwkv6-1.6b's
              B 8, T 512, H 32, N 64), in f32 and bf16, with
              the stated tolerance; times the kernel, the plain version and
              one PyTorch library call computing the same function (L2
              flushed before every timed launch, the device kept busy
              until the host has queued it), beside the least time the
              card could take (the f32 flash kernels at the 3xTF32 rate
              of the tensor cores they use); a second launch of every
              kernel but dq and dk/dv must give the same bits.  The
              RMSNorm forward is also held at d 20000 (wider than a
              16-warp team holds) and on inputs off a 16-byte boundary,
              and its device time is printed (torch.profiler); the
              backward at d 4096, a ragged d 1001 and 5 rows, with its two
              launches' device times.  Flash-decode (one launch: the
              splits merged inside a thread-block cluster) is held against
              the plain splits and combine at splits 1, 2, 4 and 12, and
              at B 8, ctx 4096, with its device time.  At
              the training shape it also times ``attention_delta``, prints
              dq + dk/dv + delta against SDPA's backward, and names the
              kernels SDPA's backward ran.  Then the flash forward, dq,
              dk/dv and WKV-6 at the per-rank shapes of tensor
              parallelism (qwen3's H 8/4/2/1 with Kv 4/2/1/1 at tp
              2/4/8/16, rwkv6's H 16/8/4 at tp 2/4/8; B 8, S 512), in f32
              and bf16, each against its plain version and timed beside
              its bound.
4. serve    — qwen3-0.6b at full width and depth (28 layers, f32, random
              weights from a seed) serves 12 requests over 8 slots (prompts
              of 17-200 tokens, 48 greedy new tokens) through the paged
              engine on the kernels.  Launch counters are zeroed just before
              and read just after: RMSNorm must launch 57 times per forward
              call, flash-decode 28 times per decode step.
              Then the served tokens are fed again (teacher forcing) through
              the kernel path and the plain ``"torch"`` path on the same
              weights, and every step's logits must agree.
5. train    — qwen3-0.6b at full width and depth (f32, seed 0) takes 6 AdamW
              steps on synthetic batches of 8 x 512 tokens through
              ``train_loop`` on the kernels.  Counters zeroed just before and
              read just after: per step 57 RMSNorm forward and 57 backward
              launches, 28 each of the flash-attention forward, dq and dk/dv.
              Every loss must be finite and the last below the first.  Then,
              from the same initial weights and one batch, the loss and every
              gradient of the kernel path must agree with the plain path's.
6. strategy — qwen3-0.6b at full width and depth under ``fsdp_bf16``
              (f32 master weights, bf16 compute) through the functions the
              train CLI calls (``strategy.resolve`` -> ``to_plan`` ->
              ``core.parallel.apply_plan``, the tensor-parallel lowering:
              every parameter a ``DTensor`` on the (data 1, model 1) NCCL
              mesh with ``param_placements``' placement on the model axis,
              checked, under FSDP2 -> ``train_loop``; no tensor-parallel
              collective may run on a model axis of 1, and the layers'
              ``to_local`` views are timed on the host): 6 AdamW steps of
              8 x 512 tokens, each step
              57 RMSNorm forward and backward launches and 28 each of the
              flash forward, dq and dk/dv, every one on bf16 tensors; its
              step p50, tokens/s, peak memory and host spans (dispatch
              printed beside the f32 phase's).  Then the bf16 kernel path
              against the bf16 plain path on one batch (loss within 2e-2,
              every gradient within 0.15 of its scale, their median within
              5e-2), and the bf16 loss within 2e-2 of the f32 plain
              path's.  Then ``fsdp_fp8`` at the same shape on the same mesh:
              3 AdamW steps (launches as above, on bf16 tensors; step
              p50 and peak memory printed); from the initial weights,
              every layer unit's FSDP2 all-gather buffer must be
              float8_e4m3fn with a quarter of f32's bytes and the root
              unit's (embedding, final norm) f32, and the loss and
              gradients must agree with the plain path that rounds the
              layers' parameters itself (``wire_round``) at the bf16 bars.
              The ``fsdp_bf16`` run feeds a drift monitor built as
              ``launch.train --drift_report`` builds it (cell D1: the
              cost model's decomposition for the plan, ``H100`` profile,
              host topology of 1): prints the predicted terms, every
              logging window's measured terms and ratios, the mean ratio
              per term and ``train/mfu``; fails without a window, with a
              ``step`` ratio not finite and positive, or with
              ``train/mfu`` outside (0, 1].  No target ratio is checked.
   CK1      — checkpointing and resilience: qwen3-0.6b at full width and
              depth, f32, under ``fsdp`` on the 1-rank NCCL mesh (every
              parameter and moment a ``DTensor``), B 8 x S 512.  Run A: 4
              uninterrupted steps; run A': the same again (a control for
              nondeterminism); run B: ``supervise_training`` with async
              saves every 2 steps (keep 1) and a crash injected at step 3:
              it saves step 2, crashes, restores step 2 and runs steps 2-3
              again (5 steps run, their launches exact).  B's parameters and
              moments, gathered through the bridge, must equal A's bit for
              bit (or lie no further from A than A' does); the event log
              one recovered failure (step_failed 3, restore_step 2).  Then a
              sync ``save_checkpoint`` of B's state, ``validate_checkpoint``
              clean, a CRC-verified restore into fresh parameters equal bit
              for bit, and an async save: bytes on disk, the seconds of
              each, and the cost model's ``checkpoint_write_time`` for the
              plan beside them.  Needs 16 GB free in the temporary
              directory (a 7.15 GB checkpoint, two while keep 1 commits),
              which it removes.
   dryrun   — cell D2: the port's dry run (``launch.dryrun.lower_fresh``,
              a fresh process on a fake process group of one rank, fake
              tensors on the card, the kernel path) of the strategy
              phase's plan at its shape; its tracked peak must lie within
              10 % of the strategy phase's ``max_memory_allocated``.
              Then ``qwen3-0.6b x train_4k`` on the pod topology (256 fake
              ranks) must trace and record a census and the resilience
              block.
7. pipeline — qwen3-0.6b at full width and depth, f32, in two spawned
              processes sharing the one card (pipe 2, 14 layers a rank, 7
              a chunk under ``1f1b_i2``; data and model groups of one rank
              on NCCL, the pipe group on gloo: activations and cotangents
              cross through host memory, ``pipe_via_host``), B 8 x S 512,
              4 microbatches: ``gpipe``, ``1f1b``, ``1f1b_i2`` and ``zb``,
              2 AdamW steps each from the same seed through the train
              CLI's functions.  Per rank and schedule: the ops run equal
              its column of the table; the most microbatch graphs held
              equal the table's (over the ranks ``inflight_microbatches``);
              launches per step exact (4 x 14 flash forwards, dq and dk/dv,
              twice as many RMSNorms and the final norm's 4 on the last
              stage); the first step's loss within 1e-5 relative and every
              gradient (from AdamW's first moment) within 1e-4 of its
              scale of the unpipelined f32 step on the card.  Prints the
              step time (two processes time-slicing one card, not
              pipeline speed) and the peak memory per rank.  Then each
              rank runs the bubble probe (``perf.pipeline_probe``: the
              schedule at M 4 and 8 microbatches of 2 x 128 tokens on a
              4-layer reduced qwen3, plain layers): its record is
              printed, ``bubble_predicted`` must be the schedule's
              formula and the record must carry ``virtual_stages`` and
              ``fit_unreliable``; the measured bubble is not checked (two
              processes time-slice the card).  A rank that fails or
              outlives 600 s fails the run.
8. rwkv6    — the same for rwkv6-1.6b at full width and depth (24 layers,
              d_model 2048, d_ff 7168, vocab 65536; f32, seed 0, WKV chunk
              32 as the train CLI): 6 AdamW steps (lr 1e-4) of 8 x 512
              tokens, exactly 24 WKV-6 launches per step and none of any
              other kernel; then kernel path vs plain path at a batch of
              2 x 512: the loss within 1e-4, and the gradient errors'
              median and maximum over the leaves within 1e-3 or 4x the
              plain path's own when its WKV outputs are perturbed by a
              relative 1e-7 (the kernel's rounding; at full depth the
              backward amplifies it in the first layers), then at 2
              layers of full width every gradient within 1e-3.  The
              earlier phases' tensors are freed first.
9. SS1      — qwen3-0.6b at full width and depth, f32, served statically
              (``ServeEngine.generate_static``: dense KV caches) on the
              kernels: B 8, prompts of 128 tokens, 64 greedy new tokens.
              Prints the prefill (synchronized), ms per decode step, tok/s
              and peak memory; launches of one run exact: 57 RMSNorms per
              forward, 28 flash forwards (the prefill), nothing else.
              Teacher-forced logits kernel vs plain within LOGIT_ATOL,
              greedy agreement at least MIN_AGREEMENT; the paged engine's
              tokens on the same prompts agree with the static ones at
              MIN_AGREEMENT (on the card the two decode attentions sum in
              other orders; the CPU tests hold them bit for bit).
10. SS3     — SS1 through the serve CLI's ``make_engine`` on a 1-rank NCCL
              group: ``--strategy auto`` (the planner's decode plan, its
              tokens equal to the unsharded engine at the plan's dtypes)
              and ``--strategy fsdp`` (f32: tokens equal to SS1's), each
              with SS1's launches; under ``fsdp`` the peak of one decode
              step is measured for D3.
11. D3      — the dry run (``launch.dryrun.lower_fresh``, fake tensors on
              the card) of SS3's ``fsdp`` decode step: its tracked peak
              within D3_MEM_REL of the measured one; then ``qwen3-0.6b x
              decode_32k`` on the pod topology (256 fake ranks) must trace
              with its caches.
12. SS4     — 4 layers of qwen3-0.6b at full width under ``fsdp_tp2`` in
              two spawned processes sharing the card, every collective on
              gloo (NCCL cannot hold two ranks of one card): the
              sequence-sharded cache, the log-sum-exp merge across ranks
              and the k/v gathers; each rank's greedy tokens equal a
              one-process static run's, its logits within SS4_LOGIT_REL
              of their scale.  Correctness only.
13. SS2     — rwkv6-1.6b at full width and depth, f32, served statically
              (B 4, prompts of 64, 32 greedy tokens; no kernel launches:
              the prefill from the cache's state runs the chunked form,
              decode ``wkv_step``), its decode logits held against the
              teacher-forced training forward on the kernel path (24
              WKV-6 launches) within max(SS2_LOGIT_ATOL, FLOOR_FACTOR x
              the plain forward's own move under a 1e-7 relative
              perturbation of its WKV outputs).
14. report  — one JSON line listing every kernel (its f32 case, and a
              ``bf16`` entry with the strategy phase's bf16 launches; the
              launches count every main-path run above), then the device
              line ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch import checkpointing as ckpt_lib  # noqa: E402
from repro_torch import strategy  # noqa: E402
from repro_torch import telemetry as tel  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core import parallel as par  # noqa: E402
from repro_torch.data import Batcher, SyntheticSource  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import wkv6 as wkv  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import init_distributed, shutdown  # noqa: E402
from repro_torch.launch.train import drift_monitor  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import rwkv6 as rwkv_lib  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import Runtime  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.resilience import (FaultPlan, SupervisorConfig,  # noqa: E402
                                    supervise_training)
from repro_torch.serve import ServeEngine, init_paged_pools  # noqa: E402
from repro_torch.strategy.topology import mesh_shape  # noqa: E402
from repro_torch.train import TrainConfig, train_loop  # noqa: E402
from repro_torch.train.trainer import (batch_to_device,  # noqa: E402
                                      prng_key_data)

# published H100 SXM peaks (dense): device memory, f32 outside the tensor
# cores, bf16 tensor cores
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# dense TF32 tensor cores.  The flash kernels multiply there: f32
# operands as 3xTF32 (three MMAs per product, so 495 / 3 = 165 TFLOP/s of
# f32 products); bf16 operands are exact in TF32, so a product of two
# inputs takes one MMA and a product with the f32 p or ds two
TF32_OPS_S = 495e12
F32_3XTF32_OPS_S = TF32_OPS_S / 3
# |kernel - plain| <= atol + rtol * |plain|: f32 differs only by summation
# order and rsqrt/exp rounding; bf16 outputs round an f32 value that may
# differ in its last bits, i.e. by up to one bf16 ulp (2^-8..2^-7 relative)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
# gradients, relative to the tensor's scale (max |plain|): f32 sums the
# same terms in another order over up to S * G of them; bf16 outputs are
# rounded once, at the end, and may differ by one bf16 ulp
GRAD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LOGIT_ATOL = 1e-3         # f32 logits after 28 layers, kernel vs plain path
MIN_AGREEMENT = 0.95      # greedy argmax agreement under teacher forcing
# train phase, kernel path vs plain path from the same weights and batch,
# f32 through 28 layers: loss within 1e-4; every gradient within 1e-3 of
# its leaf's scale (the JAX kernel tests' bar, tests/test_kernels.py)
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GRAD_REL = 1e-3
# rwkv6-1.6b at full depth from random weights: its backward amplifies a
# 1e-7 relative change of the WKV outputs (the kernel's rounding against
# the plain version) into gradient changes of up to ~0.4-0.6 of a leaf's
# scale in the first layers (measured on an H100).  There the kernel
# path's gradient errors, their median and their maximum over the leaves,
# are held to FLOOR_FACTOR times the plain path's own under such a change
# (a leaf's own movement is too noisy a yardstick: the kernel's rounding
# moved one leaf 10x further than the random perturbation did); at 2
# layers of the same width every leaf is held to the plain 1e-3 bar
WKV_NOISE_REL = 1e-7
FLOOR_FACTOR = 4
RWKV_SHALLOW_LAYERS = 2
TRAIN_STEPS = 6
TRAIN_BATCH, TRAIN_SEQ = 8, 512      # the JAX train CLI's defaults
RWKV_STEPS = 6
RWKV_CHUNK = 32                      # the train CLIs' WKV chunk
# rwkv6-1.6b from random weights: at lr 3e-4 with one warmup step its loss
# spikes (11.6 -> 16.2 at step 3, 11.8 at step 4) before it falls
RWKV_LR = 1e-4
RWKV_CHECK_BATCH = 2                 # kernel vs plain gradients, 2 x 512
# WKV-6 kernel vs plain, relative to the output's scale: f32 1e-4 (the
# chunked form multiplies e^{lc} by e^{-lc} factors whose rounding the
# kernel's sequential sums and the plain matmuls expose differently);
# bf16: the same f32 value rounded once, so 2 bf16 ulps, or 1e-5 of scale
# where an output is so small that 2 ulps fall below the f32 rounding
WKV_REL_TOL = 1e-4
# strategy phase: qwen3-0.6b under this spec (f32 master weights, bf16
# compute) through the train CLI's functions on a 1-rank NCCL mesh
STRATEGY_SPEC = "fsdp_bf16"
# its bf16 kernel path against the bf16 plain path from the same weights
# and batch at full depth, set before the first run on the card: a kernel
# output may differ from its plain version by one bf16 ulp (2^-8
# relative), and 28 layers of bf16 products carry such differences on.
# On the CPU at 2 layers the kernels' plain versions and the plain layers
# differ in bf16 by up to 2.1e-2 of a leaf's scale (median 1.2e-2), about
# what bf16 and f32 differ by; these bars catch a wrong kernel, not
# rounding
BF16_LOSS_ATOL = 2e-2
BF16_GRAD_REL = 0.15
BF16_GRAD_MEDIAN = 5e-2
# the bf16 loss against the f32 plain path's, the JAX package's bar
# (tests/test_precision.py::test_bf16_train_step_numerics_match_f32)
BF16_VS_F32_REL = 2e-2
# then the fp8 policy at the same shape: every layer's FSDP2 all-gather in
# float8_e4m3fn, its loss and gradients held to the plain path that
# rounds each layer's parameters itself (``wire_round``) at the bf16 bars
FP8_SPEC = "fsdp_fp8"
FP8_STEPS = 3
# cell D2: the dry run's tracked peak of the strategy phase's plan against
# the phase's measured max_memory_allocated, fixed before the first run
CK_SPEC = "fsdp"                    # f32 on the 1-rank NCCL mesh
CK_STEPS, CK_EVERY, CK_CRASH = 4, 2, 3
CK_RUNS_B = 5                       # steps 0-2, crash at 3, steps 2-3 again
CK_MIN_FREE = 16e9                  # two 7.15 GB checkpoints while keep 1
#                                     commits the next
DRYRUN_MEM_REL = 0.10
DRYRUN_OUT = "results/dryrun_torch"   # the pod dry run's record
# pipeline phase: qwen3-0.6b at full width and depth, f32, in two
# processes on the one card (pipe 2; data and model groups of one rank on
# NCCL, the pipe group on gloo through host memory), each schedule from
# the same seed; the first step's loss within 1e-5 relative and every
# gradient within 1e-4 of its scale of the unpipelined f32 step on the
# card (the port's f32 bar)
PIPE_SCHEDULES = ("gpipe", "1f1b", "1f1b_i2", "zb")
PIPE_STAGES, PIPE_MICROBATCHES, PIPE_STEPS = 2, 4, 2
PIPE_LOSS_REL, PIPE_GRAD_REL = 1e-5, 1e-4
PIPE_TIMEOUT_S = 600
FLUSH_BYTES = 256 << 20   # > 50 MB L2: every timed launch starts cold
# after the flush the device spins this long (~0.5 ms at the H100's ~2 GHz)
# before the start event, so the host's part of the timed call (a
# wrapper's checks and allocations) is done before the device gets there
# and only device time falls between the events
SPIN_CYCLES = 1_000_000
SEED = 0


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound_ms(n_bytes, n_ops, dtype, ops_s=None):
    """The larger of the bytes over the memory rate and the operations over
    ``ops_s`` (default: PEAK_OPS_S of ``dtype``), in ms."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / (ops_s or PEAK_OPS_S[dtype])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_kernel_names(fn):
    """Names of the CUDA kernels one call of ``fn`` launches, by device
    time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and str(getattr(e, "device_type", "CUDA")).endswith("CUDA")]
    rows.sort(key=lambda e: -e.device_time_total)
    return [(e.key, e.device_time_total / 1e3) for e in rows]


def kernel_split_ms(fn, flush, match, iters=20):
    """Mean device time per call of each CUDA kernel ``fn`` launches whose
    name contains ``match`` (torch.profiler), L2 flushed before each call:
    -> {kernel name: ms}."""
    def calls():
        for _ in range(iters):
            flush.zero_()
            fn()
    fn()
    return {k.replace("void ", "").replace("(anonymous namespace)::", "")
            .split("(")[0]: t / iters
            for k, t in cuda_kernel_names(calls) if match in k}


def time_ms(fn, flush, iters=50):
    """Median device time of one call, L2 flushed before each call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def max_err(a, b, dtype):
    a, b = a.float(), b.float()
    atol, rtol = TOL[dtype]
    err = (a - b).abs()
    return err.max().item(), bool((err <= atol + rtol * b.abs()).all())


def rel_err(a, b):
    """max |a - b| over the scale of b (max |b|)."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# (n, d, offset), checked but not timed: a width wider than a 16-warp team
# holds (walked in slices), and inputs one element off a 16-byte boundary
# (scalar loads)
RMS_FWD_CHECKED = [(64, 20000, 0), (37, 1024, 1), (4099, 1024, 1)]


def rmsnorm_phase(dev, flush, gen):
    """RMSNorm forward at the serving path's decode rows (8, 32 and a ragged
    37 of d 1024) and the training path's (B x S = 4096, and an odd 4099
    rows), timed; then RMS_FWD_CHECKED.  A second launch must give the same
    bits."""
    rows = []
    timed = [(n, 1024, 0) for n in (8, 32, 37, 4096, 4099)]
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        for n, d, offset in timed + RMS_FWD_CHECKED:
            x = torch.randn(n * d + offset, generator=gen, device=dev
                            ).to(dtype)[offset:].view(n, d)
            s = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
            y, rstd = rms.rmsnorm_cuda(x, s, 1e-6)
            y2, rstd2 = rms.rmsnorm_cuda(x, s, 1e-6)
            y0, rstd0 = rms.rmsnorm_plain(x, s, 1e-6)
            torch.cuda.synchronize()
            err, ok = max_err(y, y0, dtype)
            rerr, rok = max_err(rstd, rstd0, torch.float32)
            shape = f"({n},{d})" + (f" offset {offset}" if offset else "")
            check(ok and rok, f"rmsnorm {dt} {shape}: |dy| {err:.3g}, "
                              f"|drstd| {rerr:.3g} over tolerance")
            check(torch.equal(y, y2) and torch.equal(rstd, rstd2),
                  f"rmsnorm {dt} {shape}: a second launch on the same "
                  f"inputs gave other bits")
            if (n, d, offset) not in timed:
                rows.append(dict(name="rmsnorm", dtype=dt, shape=shape,
                                 timed=False, max_abs_err=err))
                print(f"[kernels] rmsnorm {dt} {shape}: err {err:.3g}, rstd "
                      f"err {rerr:.3g}; same bits twice")
                continue
            isz = x.element_size()
            bnd, by = bound_ms(2 * n * d * isz + 4 * d + 4 * n, 4 * n * d,
                               dtype)
            w = s.to(dtype)
            row = dict(name="rmsnorm", dtype=dt, shape=shape, timed=True,
                       max_abs_err=err,
                       ms=time_ms(lambda: rms.rmsnorm_cuda(x, s, 1e-6), flush),
                       device_ms=sum(kernel_split_ms(
                           lambda: rms.rmsnorm_cuda(x, s, 1e-6), flush,
                           "rmsnorm_fwd").values()),
                       plain_ms=time_ms(lambda: rms.rmsnorm_plain(x, s, 1e-6),
                                        flush),
                       library_ms=time_ms(
                           lambda: F.rms_norm(x, (d,), w, 1e-6), flush),
                       bound_ms=bnd, bound_by=by)
            rows.append(row)
            print(f"[kernels] rmsnorm {dt} {shape}: "
                  f"err {err:.3g} (tol atol={TOL[dtype][0]} "
                  f"rtol={TOL[dtype][1]}) kernel {row['ms']:.4f} ms "
                  f"(device {row['device_ms']:.4f}), plain "
                  f"{row['plain_ms']:.4f} ms, F.rms_norm "
                  f"{row['library_ms']:.4f} ms, bound {bnd:.5f} ms ({by})")
    return rows


def decode_case(dev, dtype, gen, B=8, nb=20, ctx=(320, 1, 17, 100, 255, 64,
                                                   200, 33)):
    """H 16, Kv 8, D 128, bs 16: by default the serving shape, ragged ctx
    up to 320 (a full table of 20 blocks); permuted pool blocks, -1 table
    tails."""
    H, Kv, D, bs = 16, 8, 128, 16
    P = B * nb + 5
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(dtype)
    k_pool = torch.randn(P, bs, Kv, D, generator=gen, device=dev).to(dtype)
    v_pool = torch.randn(P, bs, Kv, D, generator=gen, device=dev).to(dtype)
    ctx = torch.tensor(ctx, dtype=torch.int32, device=dev)
    perm = torch.randperm(P, generator=gen, device=dev)[:B * nb].view(B, nb)
    live = (ctx[:, None] + bs - 1) // bs
    tbl = torch.where(torch.arange(nb, device=dev)[None] < live,
                      perm, -1).to(torch.int32).contiguous()
    return q, k_pool, v_pool, tbl, ctx


# (splits, long context, decode_case arguments): the serving shape (its
# splits 4 row is reported), then B 8 at ctx 4096 (256 blocks, 268 MB of
# f32 K/V); at splits 12 each CTA of a cluster of 4 takes 3 splits
DECODE_CASES = [((1, 2, 4, 12), False, {}),
                ((4, 12), True, dict(B=8, nb=256, ctx=(4096,) * 8))]


def flash_decode_phase(dev, flush, gen):
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for splits_list, long_ctx, kw in DECODE_CASES:
            case = decode_case(dev, dtype, gen, **kw)
            rows += decode_rows(dev, flush, dtype, case, splits_list,
                                long_ctx)
            del case
    return rows


def decode_rows(dev, flush, dtype, case, splits_list, long_ctx):
    """The one-launch kernel (splits and their merge) against the plain
    splits merged by the plain combine; a second launch must give the same
    bits."""
    rows = []
    q, k_pool, v_pool, tbl, ctx = case
    B, _, H, D = q.shape
    Kv, isz = k_pool.shape[2], q.element_size()
    nb = tbl.shape[1]
    n_pos = int(ctx.sum())
    # library yardstick: SDPA with GQA over K/V gathered by the table
    kg = k_pool[tbl.clamp(min=0).long()].reshape(B, -1, Kv, D) \
        .transpose(1, 2).contiguous()
    vg = v_pool[tbl.clamp(min=0).long()].reshape(B, -1, Kv, D) \
        .transpose(1, 2).contiguous()
    mask = (torch.arange(kg.shape[2], device=dev)[None] < ctx[:, None]
            )[:, None, None, :]
    qs = q.transpose(1, 2).contiguous()
    dt = str(dtype).split(".")[-1]
    ctx_s = f"ctx{int(ctx.max())}" if long_ctx else "ctx<=320"
    # bytes: q, the K/V rows below ctx, the table, ctx and the output (the
    # splits' partials stay on chip)
    bnd, by = bound_ms(2 * B * H * D * isz + 2 * n_pos * Kv * D * isz
                       + 4 * B * nb + 4 * B, 4 * n_pos * H * D, dtype)
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask, enable_gqa=True), flush)
    for n_splits in splits_list:
        out = fd.decode_cuda(*case, n_splits)
        again = fd.decode_cuda(*case, n_splits)
        ref = fd.combine_plain(*fd.split_plain(*case, n_splits))
        torch.cuda.synchronize()
        err, ok = max_err(out, ref.reshape(out.shape), dtype)
        check(ok, f"flash-decode {dt} {ctx_s} splits={n_splits}: err "
                  f"{err:.3g} over tolerance")
        check(torch.equal(out, again),
              f"flash-decode {dt} {ctx_s} splits={n_splits}: a second "
              f"launch on the same inputs gave other bits")
        del ref, again
        shape = f"B{B} H{H} Kv{Kv} D{D} bs16 {ctx_s} splits{n_splits}"
        row = dict(
            name="flash_decode", dtype=dt, shape=shape, long_ctx=long_ctx,
            max_abs_err=err, n_splits=n_splits,
            ms=time_ms(lambda: fd.decode_cuda(*case, n_splits), flush),
            device_ms=sum(kernel_split_ms(
                lambda: fd.decode_cuda(*case, n_splits), flush,
                "flash_decode").values()),
            plain_ms=time_ms(lambda: fd.decode_plain(*case, n_splits),
                             flush, 5 if long_ctx else 50),
            library_ms=sdpa_ms, bound_ms=bnd, bound_by=by)
        rows.append(row)
        print(f"[kernels] flash_decode {dt} {ctx_s} splits={n_splits}: "
              f"err {err:.3g} kernel {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
              f"SDPA {sdpa_ms:.4f} ms, bound {bnd:.5f} ms ({by}; "
              f"{bnd / row['ms']:.3f} of it); same bits twice")
    return rows


# (n, d), timed: the training path's rows (B x S = 4096 of d 1024, the
# reported case) and a row count that is no multiple of the 16-row CTA;
# then checked: 4 warps per row (d 4096), a ragged width off the 16-byte
# vectors (d 1001), and fewer rows than one CTA takes
RMS_BWD_CASES = [((4096, 1024), True), ((4099, 1024), True),
                 ((4096, 4096), False), ((4096, 1001), False),
                 ((5, 1024), False)]


def rmsnorm_bwd_phase(dev, flush, gen):
    """RMSNorm backward against its plain version; a second launch must
    give the same bits (dscale's partials are summed in a fixed order)."""
    rows = []
    eps = 1e-6
    for dtype in (torch.float32, torch.bfloat16):
        for (n, d), timed in RMS_BWD_CASES:
            x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
            gy = torch.randn(n, d, generator=gen, device=dev).to(dtype)
            s = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
            _, rstd = rms.rmsnorm_plain(x, s, eps)
            dx, ds = rms.rmsnorm_bwd_cuda(x, s, rstd, gy)
            dx2, ds2 = rms.rmsnorm_bwd_cuda(x, s, rstd, gy)
            dx0, ds0 = rms.rmsnorm_bwd_plain(x, s, rstd, gy)
            torch.cuda.synchronize()
            err, ok = max_err(dx, dx0, dtype)
            ds_rel = rel_err(ds, ds0)
            dt = str(dtype).split(".")[-1]
            check(ok and ds_rel <= GRAD_REL_TOL[torch.float32],
                  f"rmsnorm backward {dt} ({n},{d}): |ddx| {err:.3g}, "
                  f"dscale rel {ds_rel:.3g} over tolerance")
            check(torch.equal(dx, dx2) and torch.equal(ds, ds2),
                  f"rmsnorm backward {dt} ({n},{d}): a second launch on "
                  f"the same inputs gave other bits")
            row = dict(name="rmsnorm_bwd", dtype=dt, shape=f"({n},{d})",
                       timed=timed,
                       max_abs_err=max(err, (ds - ds0).abs().max().item()))
            rows.append(row)
            if not timed:
                print(f"[kernels] rmsnorm_bwd {dt} ({n},{d}): dx err "
                      f"{err:.3g}, dscale rel {ds_rel:.3g}; same bits twice")
                continue
            isz = x.element_size()
            bnd, by = bound_ms(3 * n * d * isz + 4 * n + 8 * d, 11 * n * d,
                               dtype)
            with torch.enable_grad():
                xr = x.detach().requires_grad_()
                w = s.to(dtype).detach().requires_grad_()
                y = F.rms_norm(xr, (d,), w, eps)
                lib = time_ms(lambda: torch.autograd.grad(
                    y, (xr, w), gy, retain_graph=True), flush)
            row.update(ms=time_ms(lambda: rms.rmsnorm_bwd_cuda(x, s, rstd, gy),
                                  flush),
                       plain_ms=time_ms(
                           lambda: rms.rmsnorm_bwd_plain(x, s, rstd, gy),
                           flush),
                       library_ms=lib, bound_ms=bnd, bound_by=by)
            # the backward is two launches: the rows, then dscale's reduce
            row["launch_split_ms"] = kernel_split_ms(
                lambda: rms.rmsnorm_bwd_cuda(x, s, rstd, gy), flush, "rmsnorm")
            print(f"[kernels] rmsnorm_bwd {dt} ({n},{d}): dx err {err:.3g}, "
                  f"dscale rel {ds_rel:.3g}; kernel {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, F.rms_norm backward "
                  f"{lib:.4f} ms, bound {bnd:.5f} ms ({by}); device ms per "
                  f"launch: " + "; ".join(
                      f"{k} {t:.4f}"
                      for k, t in row["launch_split_ms"].items()))
    return rows


def visible_pairs(S, window):
    """(query, key) pairs a causal (windowed) attention computes per head."""
    n = torch.arange(1, S + 1)
    if window:
        n = n.clamp(max=window)
    return int(n.sum())


# B, S, H, Kv, D, window: the training shape (timed), then ragged S, a
# sliding window and MQA (checked, not timed)
FLASH_CASES = [(8, 512, 16, 8, 128, 0), (2, 300, 16, 8, 128, 0),
               (2, 300, 16, 8, 128, 128), (2, 512, 16, 1, 128, 0)]


def flash_case(dev, gen, dtype, B, S, H, Kv, D, window):
    """Random q/k/v/do of one shape through the flash forward, dq and dk/dv
    kernels and their plain versions (the backward kernels take the plain
    forward's lse and delta, so each kernel is held alone), each held to
    its tolerance, the forward also to its own bits on a second launch ->
    (q, k, v, do, the plain lse and o, the backward's arguments, each
    kernel's max |kernel - plain|, the shape's label)."""
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen,
                               device=dev).to(dtype)
                   for h in (H, Kv, Kv, H))
    o, lse = fa.forward_cuda(q, k, v, True, window)
    o2, lse2 = fa.forward_cuda(q, k, v, True, window)
    o0, lse0 = fa.forward_plain(q, k, v, True, window)
    delta = fa.attention_delta(o0, do)
    args = (q, k, v, do, lse0, delta, True, window)
    dq, (dk, dv) = fa.dq_cuda(*args), fa.dkv_cuda(*args)
    dq0, (dk0, dv0) = fa.dq_plain(*args), fa.dkv_plain(*args)
    torch.cuda.synchronize()
    e_o, ok = max_err(o, o0, dtype)
    e_lse = (lse - lse0).abs().max().item()
    rels = {"dq": rel_err(dq, dq0), "dk": rel_err(dk, dk0),
            "dv": rel_err(dv, dv0)}
    shape = f"B{B} S{S} H{H} Kv{Kv} D{D} causal window{window}"
    dt = str(dtype).split(".")[-1]
    check(ok and e_lse <= 1e-5 and max(rels.values())
          <= GRAD_REL_TOL[dtype],
          f"flash attention {dt} {shape}: |do| {e_o:.3g}, |dlse| "
          f"{e_lse:.3g}, grads rel {rels} over tolerance")
    check(torch.equal(o, o2) and torch.equal(lse, lse2),
          f"flash forward {dt} {shape}: a second launch on the same "
          f"inputs gave other bits")
    print(f"[kernels] flash_attention {dt} {shape}: o err {e_o:.3g}"
          f", lse err {e_lse:.3g}; dq/dk/dv rel err "
          + "/".join(f"{r:.3g}" for r in rels.values()))
    errs = {"flash_attention": max(e_o, e_lse),
            "flash_attention_dq": (dq - dq0).abs().max().item(),
            "flash_attention_dkv": max((dk - dk0).abs().max().item(),
                                       (dv - dv0).abs().max().item())}
    return q, k, v, do, o0, args, errs, shape


def flash_bounds(dtype, B, S, H, Kv, D, window):
    """-> ({kernel: (bound ms, bound by)}, {kernel: notes}) of the flash
    forward, dq and dk/dv at one shape."""
    isz = torch.tensor([], dtype=dtype).element_size()
    pairs = visible_pairs(S, window) * B * H
    q_bytes, kv_bytes = B * S * H * D * isz, B * S * Kv * D * isz
    row_bytes = B * H * S * 4
    # all three kernels multiply on the tensor cores.  f32: bound at the
    # 3xTF32 rate they use, the f32 SIMT bound (PEAK_OPS_S) kept beside it
    # in bound_peak_ms.  bf16: bound at the card's bf16 rate; the kernels
    # run it on TF32 MMAs (one per product of two inputs, two with p or
    # ds), whose bound is noted in bound_arith
    fwd_bytes = 2 * q_bytes + 2 * kv_bytes + row_bytes
    dq_bytes = 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes
    dkv_bytes = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
    work = {"flash_attention": (fwd_bytes, 4 * D * pairs, 6 * D * pairs),
            "flash_attention_dq": (dq_bytes, 6 * D * pairs, 8 * D * pairs),
            "flash_attention_dkv": (dkv_bytes, 8 * D * pairs,
                                    12 * D * pairs)}
    bounds, notes = {}, {}
    for name, (n_bytes, n_ops, tf32_mmas) in work.items():
        if dtype == torch.float32:
            bounds[name] = bound_ms(n_bytes, n_ops, dtype, F32_3XTF32_OPS_S)
            notes[name] = dict(
                bound_arith="3xTF32",
                bound_peak_ms=bound_ms(n_bytes, n_ops, dtype)[0])
        else:
            bounds[name] = bound_ms(n_bytes, n_ops, dtype)
            tf32 = bound_ms(n_bytes, tf32_mmas, dtype, TF32_OPS_S)[0]
            notes[name] = dict(bound_arith=(
                f"bf16 tensor cores; on the TF32 MMAs the kernel runs "
                f"{tf32:.5f} ms"))
    return bounds, notes


def flash_phase(dev, flush, gen):
    """Flash-attention forward (o, lse), dq and dk/dv kernels against their
    plain versions (:func:`flash_case`); at the training shape each is
    timed beside its plain version, its bound and SDPA."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (B, S, H, Kv, D, window) in enumerate(FLASH_CASES):
            q, k, v, do, o0, args, errs, shape = flash_case(
                dev, gen, dtype, B, S, H, Kv, D, window)
            dt = str(dtype).split(".")[-1]
            base = dict(dtype=dt, shape=shape, timed=ci == 0)
            if ci:
                rows += [dict(base, name=n, max_abs_err=e)
                         for n, e in errs.items()]
                continue
            bounds, notes = flash_bounds(dtype, B, S, H, Kv, D, window)
            qs, ks, vs, dos = (t.transpose(1, 2).contiguous()
                               for t in (q, k, v, do))
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True), flush, 20)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (qs, ks, vs)]
                out = F.scaled_dot_product_attention(
                    *leaves, is_causal=True, enable_gqa=True)
                sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
                    out, leaves, dos, retain_graph=True)
                lib_bwd = time_ms(sdpa_bwd, flush, 20)
                lib_kernels = cuda_kernel_names(sdpa_bwd)
            delta_ms = time_ms(lambda: fa.attention_delta(o0, do), flush, 20)
            timings = {
                "flash_attention": (
                    lambda: fa.forward_cuda(q, k, v, True, window),
                    lambda: fa.forward_plain(q, k, v, True, window),
                    lib_fwd, "forward"),
                "flash_attention_dq": (lambda: fa.dq_cuda(*args),
                                       lambda: fa.dq_plain(*args), lib_bwd,
                                       "backward"),
                "flash_attention_dkv": (lambda: fa.dkv_cuda(*args),
                                        lambda: fa.dkv_plain(*args), lib_bwd,
                                        "backward")}
            for name, (kern, plain, lib, lib_what) in timings.items():
                bnd, by = bounds[name]
                row = dict(base, name=name, max_abs_err=errs[name],
                           ms=time_ms(kern, flush, 20),
                           plain_ms=time_ms(plain, flush, 20),
                           library_ms=lib, bound_ms=bnd, bound_by=by,
                           sdpa_forward_ms=lib_fwd,
                           sdpa_backward_ms=lib_bwd)
                row.update(notes.get(name, {}))
                arith = "".join(f"; {k} {v:.5f} ms" if isinstance(v, float)
                                else f"; {v}"
                                for k, v in notes.get(name, {}).items())
                rows.append(row)
                print(f"[kernels] {name} {dt} {shape}: kernel "
                      f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                      f"SDPA {lib_what} {lib:.4f} ms, bound {bnd:.5f} ms "
                      f"({by}{arith})")
            t_dq, t_dkv = rows[-2]["ms"], rows[-1]["ms"]
            ours = t_dq + t_dkv + delta_ms
            rows.append(dict(base, name="attention_delta", ms=delta_ms,
                             sdpa_backward_ms=lib_bwd,
                             sdpa_backward_kernels=lib_kernels))
            print(f"[kernels] flash backward {dt} {shape}: dq + dk/dv + "
                  f"delta {ours:.4f} ms ({t_dq:.4f} + {t_dkv:.4f} + "
                  f"{delta_ms:.4f}) vs SDPA backward {lib_bwd:.4f} ms "
                  f"({ours / lib_bwd:.3f}x)")
            print(f"[kernels] SDPA backward {dt} kernels (device ms): "
                  + "; ".join(f"{k} {t:.4f}" for k, t in lib_kernels[:4]))
    return rows


def bf16_ulp(x):
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


def wkv6_ops(B, T, H, N, chunk):
    """f32 operations the chunked WKV-6 needs for these shapes: per chunk
    the strictly lower qp·kpᵀ and its product with v (C(C-1)/2 pairs of N
    multiply-adds each) and the state's decay; per token the log, cumsum
    and exps (~10 per channel), the u diagonal and its product with v
    (~5 per channel), qp·S and the state's kᵀv (2 N² multiply-adds)."""
    nc = -(-T // chunk)
    per_head = nc * (2 * chunk * (chunk - 1) * N + 2 * N * N) \
        + T * (15 * N + 4 * N * N)
    return B * H * per_head


# B, T, H, chunk (N 64): the rwkv6-1.6b training shape (timed), then chunk
# 16 and 64, ragged T and T below the chunk (checked, not timed)
WKV_CASES = [(8, 512, 32, RWKV_CHUNK), (2, 512, 32, 16), (2, 512, 32, 64),
             (2, 300, 32, 32), (2, 20, 32, 64)]


def wkv6_case(dev, gen, dtype, B, T, H, chunk, N=64):
    """Random r/k/v/w/u of one shape, with the JAX kernel tests' input
    distribution (decay per step e^{-0.03} to e^{-0.4}, harder than the
    model's w0 in [-6, -4)), through the WKV-6 kernel and its plain
    version: y and the final state held to their tolerance, and to their
    own bits on a second launch -> (the inputs, max |kernel - plain|, the
    shape's label)."""
    r, k, v = ((0.5 * torch.randn(B, T, H, N, generator=gen,
                                  device=dev)).to(dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * torch.randn(
        B, T, H, N, generator=gen, device=dev) - 2.5))
    u = 0.3 * torch.randn(H, N, generator=gen, device=dev)
    args = (r, k, v, w, u)
    y, st = wkv.wkv6_cuda(*args, chunk)
    y2, st2 = wkv.wkv6_cuda(*args, chunk)
    y0, st0 = wkv.wkv6_plain(*args, None, chunk)
    torch.cuda.synchronize()
    e_y, e_s = rel_err(y, y0), rel_err(st, st0)
    if dtype == torch.float32:
        ok = e_y <= WKV_REL_TOL
    else:
        a, b = y.float(), y0.float()
        ok = bool(((a - b).abs() <= torch.maximum(
            2 * bf16_ulp(torch.maximum(a.abs(), b.abs())),
            1e-5 * b.abs().max())).all())
    dt = str(dtype).split(".")[-1]
    shape = f"B{B} T{T} H{H} N{N} chunk{chunk}"
    check(ok and e_s <= WKV_REL_TOL,
          f"wkv6 {dt} {shape}: y rel err {e_y:.3g}, state rel err "
          f"{e_s:.3g} over tolerance")
    check(torch.equal(y, y2) and torch.equal(st, st2),
          f"wkv6 {dt} {shape}: a second launch on the same inputs "
          f"gave other bits")
    err = max((y.float() - y0.float()).abs().max().item(),
              (st - st0).abs().max().item())
    print(f"[kernels] wkv6 {dt} {shape}: y rel err {e_y:.3g}, state "
          f"rel err {e_s:.3g}")
    return args, err, shape


def wkv6_bound(dtype, B, T, H, chunk, N=64):
    """(bound ms, bound by) of the WKV-6 forward at one shape."""
    isz = torch.tensor([], dtype=dtype).element_size()
    n = B * T * H * N
    return bound_ms(4 * n * isz + 4 * n + 4 * H * N + 4 * B * H * N * N,
                    wkv6_ops(B, T, H, N, chunk), dtype)


def wkv6_phase(dev, flush, gen):
    """WKV-6 kernel against its plain version (:func:`wkv6_case`); at the
    training shape timed beside its plain version, its bound and the
    backward the training step runs."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (B, T, H, chunk) in enumerate(WKV_CASES):
            args, err, shape = wkv6_case(dev, gen, dtype, B, T, H, chunk)
            dt = str(dtype).split(".")[-1]
            base = dict(name="wkv6", dtype=dt, shape=shape, timed=ci == 0,
                        max_abs_err=err)
            if ci:
                rows.append(base)
                continue
            bnd, by = wkv6_bound(dtype, B, T, H, chunk)
            # the backward the training step runs: the plain chunked form
            # replayed under autograd (WKV6Fn), not a kernel
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in args]
                y_fn, _ = wkv.WKV6Fn.apply(*leaves, chunk)
                gy = torch.randn(y_fn.shape, generator=gen, device=dev
                                 ).to(dtype)
                bwd_ms = time_ms(lambda: torch.autograd.grad(
                    y_fn, leaves, gy, retain_graph=True), flush, 10)
            row = dict(base,
                       ms=time_ms(lambda: wkv.wkv6_cuda(*args, chunk), flush,
                                  20),
                       plain_ms=time_ms(
                           lambda: wkv.wkv6_plain(*args, None, chunk), flush,
                           20),
                       library_ms=None, bound_ms=bnd, bound_by=by,
                       backward_ms=bwd_ms)
            rows.append(row)
            print(f"[kernels] wkv6 {dt} {shape}: kernel {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, no library call, bound "
                  f"{bnd:.5f} ms ({by}); backward (plain replay) "
                  f"{bwd_ms:.4f} ms")
    return rows


# the per-rank shapes of tensor parallelism at the training shape: qwen3-
# 0.6b's 16 heads and 8 KV heads over a model axis of tp 2, 4 and 8, and
# of 16 with its KV heads replicated (a rank takes the KV head of its one
# query head); rwkv6-1.6b's 32 WKV heads over tp 2, 4 and 8
TP_FLASH_CASES = [(2, 8, 4), (4, 4, 2), (8, 2, 1), (16, 1, 1)]  # tp, H, Kv
TP_WKV_CASES = [(2, 16), (4, 8), (8, 4)]                          # tp, H


def tp_kernels_phase(dev, flush, gen):
    """The flash forward, dq and dk/dv and WKV-6 at the per-rank shapes of
    tensor parallelism, in f32 and bf16: each against its plain version
    (:func:`flash_case`, :func:`wkv6_case`) and timed beside its bound."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        for tp, H, Kv in TP_FLASH_CASES:
            B, S, D = TRAIN_BATCH, TRAIN_SEQ, 128
            q, k, v, do, o0, args, errs, shape = flash_case(
                dev, gen, dtype, B, S, H, Kv, D, 0)
            bounds, _ = flash_bounds(dtype, B, S, H, Kv, D, 0)
            kernels = {"flash_attention": lambda: fa.forward_cuda(
                q, k, v, True, 0),
                "flash_attention_dq": lambda: fa.dq_cuda(*args),
                "flash_attention_dkv": lambda: fa.dkv_cuda(*args)}
            for name, kern in kernels.items():
                bnd, by = bounds[name]
                rows.append(dict(name=name, dtype=dt, shape=shape, tp=tp,
                                 max_abs_err=errs[name],
                                 ms=time_ms(kern, flush, 20), bound_ms=bnd,
                                 bound_by=by))
                print(f"[kernels] tp {tp}: {name} {dt} {shape}: kernel "
                      f"{rows[-1]['ms']:.4f} ms, bound {bnd:.5f} ms ({by})")
        for tp, H in TP_WKV_CASES:
            B, T = TRAIN_BATCH, TRAIN_SEQ
            args, err, shape = wkv6_case(dev, gen, dtype, B, T, H,
                                         RWKV_CHUNK)
            bnd, by = wkv6_bound(dtype, B, T, H, RWKV_CHUNK)
            rows.append(dict(name="wkv6", dtype=dt, shape=shape, tp=tp,
                             max_abs_err=err, ms=time_ms(
                                 lambda: wkv.wkv6_cuda(*args, RWKV_CHUNK),
                                 flush, 20), bound_ms=bnd, bound_by=by))
            print(f"[kernels] tp {tp}: wkv6 {dt} {shape}: kernel "
                  f"{rows[-1]['ms']:.4f} ms, bound {bnd:.5f} ms ({by})")
    return rows


# ---------------------------------------------------------------------------
# phase 4: serve at full width, then teacher-forced logits
# ---------------------------------------------------------------------------

def teacher_forced(cfg, params, prompts, gens, dev, chunk, block_size):
    """Feed the served tokens through the kernel path and the plain path in
    lock step (separate pools, same weights); -> (max |logit diff|, greedy
    agreement kernel vs plain, agreement of the kernel path with the
    served tokens)."""
    rts = {"kernel": Runtime(), "torch": Runtime(attn_impl="torch",
                                                 norm_impl="torch")}
    B, n_new = len(prompts), gens.shape[1]
    nb = -(-(max(map(len, prompts)) + chunk + n_new + 1) // block_size)
    caches = {k: init_paged_pools(cfg, B * nb, block_size, torch.float32,
                                  dev) for k in rts}
    tbl = torch.arange(B * nb, dtype=torch.int32, device=dev).view(B, nb)
    worst, agree, served, total = 0.0, 0, 0, 0

    def step(batch, tbl_, ctx_):
        out = {}
        for k, rt in rts.items():
            caches[k]["paged"] = {"tbl": tbl_, "ctx": ctx_}
            out[k] = tfm.forward(cfg, params, batch, rt, caches[k]).float()
        return out

    firsts = []
    for b, p in enumerate(prompts):            # chunked prefill, per request
        for s in range(0, len(p), chunk):
            piece = np.zeros(chunk, np.int32)
            real = len(p[s:s + chunk])
            piece[:real] = p[s:s + chunk]
            ctx0 = torch.tensor([s], dtype=torch.int32, device=dev)
            lg = step({"tokens": torch.as_tensor(piece[None], device=dev),
                       "pos": ctx0[:, None]}, tbl[b:b + 1], ctx0)
            worst = max(worst, (lg["kernel"] - lg["torch"]).abs().max().item())
        firsts.append((lg["kernel"][0, real - 1], lg["torch"][0, real - 1]))
    for b, (lk, lt) in enumerate(firsts):
        agree += int(lk.argmax() == lt.argmax())
        served += int(lk.argmax().item() == gens[b, 0])
        total += 1
    ctx = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device=dev)
    toks = torch.as_tensor(gens, device=dev)
    for t in range(n_new - 1):                 # decode, all rows together
        lg = step({"tokens": toks[:, t:t + 1], "pos": ctx[:, None]}, tbl, ctx)
        worst = max(worst, (lg["kernel"] - lg["torch"]).abs().max().item())
        ak, at = lg["kernel"][:, 0].argmax(-1), lg["torch"][:, 0].argmax(-1)
        agree += int((ak == at).sum())
        served += int((ak == toks[:, t + 1]).sum())
        total += B
        ctx = ctx + 1
    return worst, agree / total, served / total


def serve_phase(dev):
    cfg = get_config("qwen3-0.6b")
    n_req, n_slots, n_new, chunk, bs = 12, 8, 48, 32, 16
    rng = np.random.default_rng(SEED)
    lens = rng.integers(17, 201, n_req)
    lens[:2] = (17, 200)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lens]
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, f32 weights from seed "
          f"{SEED} in {time.perf_counter() - t0:.1f}s")
    kw = dict(max_len=int(lens.max()) + n_new, n_slots=n_slots,
              block_size=bs, prefill_chunk=chunk, steps_per_tick=8,
              device=dev)
    rt = Runtime()                             # the kernel path
    warm = ServeEngine(cfg, params, rt, **kw)  # first-call costs, untimed
    warm.generate(np.stack([prompts[0][:17]] * 2), 8)
    del warm

    rec = tel.Recorder()
    eng = ServeEngine(cfg, params, rt, telemetry=rec, **kw)
    rids = [eng.submit(p, n_new) for p in prompts]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained(seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    fwd, steps = eng.stats["forward_calls"], eng.stats["decode_steps"]
    expect = {"rmsnorm": (2 * cfg.n_layers + 1) * fwd, "rmsnorm_bwd": 0,
              "flash_decode": cfg.n_layers * steps,
              "flash_attention": 0, "flash_attention_dq": 0,
              "flash_attention_dkv": 0, "wkv6": 0}
    print(f"[serve] {fwd} forward calls ({steps} decode steps); launches "
          f"{counts}, expected {expect}")
    check(counts == expect, f"launch counts {counts} != expected {expect}")
    check(fwd > 0 and steps > 0, f"{fwd} forward calls, {steps} decode steps")

    gens = np.stack([done[r] for r in rids])
    check(gens.shape == (n_req, n_new), f"served shape {gens.shape}")
    check(bool(((gens >= 0) & (gens < cfg.vocab_size)).all()),
          "served token ids out of range")
    snap = rec.metrics.snapshot()
    ttft, tok = snap["serve/ttft_s"], snap["serve/token_latency_s"]
    res = dict(requests=n_req, slots=n_slots, new_tokens=n_new,
               prompt_lens=[int(x) for x in lens], wall_s=wall,
               tok_s=n_req * n_new / wall,
               ttft_p50_ms=ttft["p50"] * 1e3, ttft_p99_ms=ttft["p99"] * 1e3,
               token_p50_ms=tok["p50"] * 1e3, token_p99_ms=tok["p99"] * 1e3,
               forward_calls=fwd, decode_steps=steps, launches=counts,
               peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    print(f"[serve] {n_req * n_new} tokens in {wall:.3f}s = "
          f"{res['tok_s']:.1f} tok/s; TTFT p50 {res['ttft_p50_ms']:.2f} ms "
          f"p99 {res['ttft_p99_ms']:.2f} ms; per-token p50 "
          f"{res['token_p50_ms']:.3f} ms p99 {res['token_p99_ms']:.3f} ms")

    t0 = time.perf_counter()
    with torch.no_grad():
        worst, agree, served = teacher_forced(cfg, params, prompts, gens, dev,
                                              chunk, bs)
    print(f"[serve] teacher forcing ({time.perf_counter() - t0:.1f}s): max "
          f"|logits kernel - plain| {worst:.3g} (tol {LOGIT_ATOL}); greedy "
          f"agreement kernel/plain {agree:.4f}, kernel path/served "
          f"{served:.4f}")
    check(worst <= LOGIT_ATOL, f"logits differ by {worst:.3g}")
    # near-ties of random-weight logits may flip a rare argmax when the
    # batch shape changes the matmul's summation order; a broken path
    # agrees almost nowhere
    check(min(agree, served) >= MIN_AGREEMENT,
          f"greedy agreement {agree:.4f} / {served:.4f} < {MIN_AGREEMENT}")
    res.update(logits_max_abs_err=worst, greedy_agreement=agree)
    return res


# ---------------------------------------------------------------------------
# phase 5: train at full width and depth, then kernel vs plain gradients
# ---------------------------------------------------------------------------

class _Events(tel.Sink):
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)


def loss_and_grads(cfg, params, batch, rt):
    for p in params.parameters():
        p.grad = None
    loss, _ = tfm.loss_fn(cfg, params, batch, rt)
    loss.backward()
    grads = {n: p.grad for n, p in params.named_parameters()}
    for p in params.parameters():
        p.grad = None
    return loss.item(), grads


def train_phase(dev, card, cfg, steps, lr, rt, plain_rt, expect,
                check_batch, tag, floor=0.0):
    """``steps`` AdamW steps (peak ``lr``) of ``cfg`` at full width and
    depth on batches of TRAIN_BATCH x TRAIN_SEQ through ``train_loop`` on
    the kernel path ``rt``, launch counts held to ``expect`` (per step);
    then :func:`grad_check` at ``check_batch`` x TRAIN_SEQ."""
    tc = TrainConfig(steps=steps, warmup=max(steps // 20, 1), log_every=1,
                     opt=AdamWConfig(lr=lr))
    res = run_steps(dev, card, cfg, rt, tc,
                    tfm.init_params(cfg, seed=SEED, device=dev), expect, tag)
    res.update(grad_check(dev, cfg, rt, plain_rt, check_batch, tag, floor))
    return res


def run_steps(dev, card, cfg, rt, tc, params, expect, tag, plan=None,
              expect_bf16=None, rec=None, drift=None):
    """Train ``params`` for ``tc.steps`` steps through ``train_loop`` (under
    ``plan`` when given, recording to ``rec`` and feeding ``drift`` when
    given) on seeded synthetic batches; launch counts zeroed just before
    and read just after, held to ``expect`` per step (and the bf16
    launches to ``expect_bf16``); losses finite and falling.  -> the run's
    measurements; frees the run's tensors."""
    steps = tc.steps
    n_params = sum(p.numel() for p in params.parameters())
    batches = Batcher(SyntheticSource(cfg.vocab_size, seed=SEED), TRAIN_SEQ,
                      TRAIN_BATCH)
    rec = rec or tel.Recorder()
    spans = rec.add_sink(_Events())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, opt_state, history = train_loop(cfg, rt, tc, batches, params,
                                            telemetry=rec, plan=plan,
                                            drift=drift)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    bf16 = ops.launch_counts(torch.bfloat16)
    peak = torch.cuda.max_memory_allocated(dev)
    expect = {k: v * steps for k, v in expect.items()}
    print(f"[{tag}] {steps} steps; launches {counts}, expected {expect}; "
          f"bf16 launches {bf16}")
    check(counts == expect, f"launch counts {counts} != expected {expect}")
    if expect_bf16 is not None:
        want = {k: v * steps for k, v in expect_bf16.items()}
        check(bf16 == want, f"bf16 launch counts {bf16} != expected {want}")
    losses = [h["loss"] for h in history]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    def durs(name):
        return [e["dur"] for e in spans.events if e["name"] == name]

    steps_s = durs("train/step")
    p50 = statistics.median(steps_s)
    # host spans per step, first step (one-time set-up) left out
    host = {name: statistics.mean(durs(f"train/{name}")[1:]) for name in
            ("dispatch", "data", "wait")}
    res = dict(arch=cfg.name, params=n_params, steps=steps, lr=tc.opt.lr,
               batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, losses=losses,
               step_s=steps_s, step_p50_s=p50, host_span_s=host,
               tok_s=TRAIN_BATCH * TRAIN_SEQ / p50, wall_s=wall,
               peak_mem_gib=peak / 2 ** 30, peak_mem_bytes=peak,
               launches=counts,
               launches_bf16=bf16, compute_dtype=str(rt.compute_dtype))
    print(f"[{tag}] {cfg.name} ({n_params / 1e9:.3f} B parameters) "
          f"{str(rt.compute_dtype).split('.')[-1]} compute, "
          f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens/step: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; step p50 {p50 * 1e3:.1f} ms "
          f"({', '.join(f'{t * 1e3:.1f}' for t in steps_s)} ms), "
          f"{res['tok_s']:.0f} tokens/s at p50; host spans per step "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in host.items())
          + f"; peak memory {res['peak_mem_gib']:.2f} GiB; on {card}")
    del params, opt_state, history, batches
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_placements(cfg, plan, params):
    """Every parameter is a ``DTensor`` on the plan's (data, model) mesh,
    on the model axis with ``param_placements``' placement -> {placement:
    count}."""
    want = par.param_placements(cfg, plan, params)
    dims = plan.mesh.mesh_dim_names
    counts = {}
    for name, p in params.named_parameters():
        check(isinstance(p, DTensor) and p.device_mesh.mesh_dim_names == dims
              and p.placements[dims.index(plan.tp)] == want[name],
              f"{name}: {type(p).__name__} "
              f"{getattr(p, 'placements', None)} on "
              f"{getattr(getattr(p, 'device_mesh', None), 'mesh_dim_names', None)}"
              f", want {want[name]} on the model axis of {dims}")
        key = str(p.placements)
        counts[key] = counts.get(key, 0) + 1
    print(f"[strategy] {len(want)} parameters are DTensors on {dims}: "
          + ", ".join(f"{n} x {k}" for k, n in counts.items()))
    return counts


def local_views_ms(params, reps=20):
    """Host ms to take every layer's ``to_local`` views once (what a
    forward adds on the tensor-parallel lowering), with the layers'
    parameters gathered as in their forward."""
    for layer in params.layers:
        layer.unshard()
    t0 = time.perf_counter()
    for _ in range(reps):
        for layer in params.layers:
            layers.local_params(layer)
    took = (time.perf_counter() - t0) / reps * 1e3
    for layer in params.layers:
        layer.reshard()
    return took


def strategy_phase(dev, card, expect):
    """qwen3-0.6b at full width and depth under STRATEGY_SPEC through the
    functions the train CLI calls (``resolve`` -> ``to_plan`` ->
    ``apply_plan`` -> ``train_loop``) on a 1-rank NCCL group: TRAIN_STEPS
    AdamW steps, every kernel launch held to ``expect`` per step and all
    of them on bf16 tensors; then the bf16 kernel path against the bf16
    plain path on one batch, and the bf16 loss against the f32 plain
    path's."""
    cfg = get_config("qwen3-0.6b")
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    init_distributed(dev)
    try:
        topo = strategy.host_topology()
        strat, planned = strategy.resolve(STRATEGY_SPEC, cfg, topo, shape)
        plan = strat.to_plan(cfg, topo, shape)
        rt = par.make_runtime(cfg, plan, shape)
        check(rt.compute_dtype == torch.bfloat16
              and rt.param_dtype == torch.float32,
              f"{STRATEGY_SPEC}: runtime dtypes {rt}")
        print(f"[strategy] {strat.format()} on {topo.name} (mesh "
              f"{mesh_shape(plan.mesh)}, {dist.get_world_size()} rank, "
              f"{dist.get_backend()})")
        tc = TrainConfig(steps=TRAIN_STEPS,
                         warmup=max(TRAIN_STEPS // 20, 1), log_every=1,
                         grad_accum=strat.grad_accum, opt=AdamWConfig())
        params = par.apply_plan(tfm.init_params(cfg, seed=SEED, device=dev),
                                plan, cfg)
        placed = check_placements(cfg, plan, params)
        views_ms = local_views_ms(params)
        layers.reset_collective_counts()
        rec = tel.Recorder()
        drift = drift_monitor(cfg, strat, planned, topo, shape, rec)
        res = run_steps(dev, card, cfg, rt, tc, params, expect,
                        "strategy", plan=plan, expect_bf16=expect, rec=rec,
                        drift=drift)
        res["drift"] = drift_report(drift, rec, card)
        # FSDP2's modules hold reference cycles: collect them, or the
        # parameters outlive the phase
        del params
        gc.collect()
        torch.cuda.empty_cache()
        check(not any(layers.COLLECTIVES.values()),
              f"a model axis of 1 ran tensor-parallel collectives: "
              f"{layers.COLLECTIVES}")
        res.update(spec=strat.format(), mesh=mesh_shape(plan.mesh),
                   ranks=dist.get_world_size(), backend=dist.get_backend(),
                   placements=placed, local_views_ms=views_ms)
        print(f"[strategy] step p50 {res['step_p50_s'] * 1e3:.1f} ms through "
              f"the tensor-parallel lowering (model axis 1); the layers' "
              f"to_local views take {views_ms:.2f} ms of host time per "
              f"forward")
        res["fp8"] = fp8_run(dev, card, cfg, shape, expect)
    finally:
        shutdown()
    plain_rt = dataclasses.replace(rt, attn_impl="torch", norm_impl="torch")
    res.update(grad_check(dev, cfg, rt, plain_rt, TRAIN_BATCH, "strategy",
                          loss_atol=BF16_LOSS_ATOL, grad_rel=BF16_GRAD_REL,
                          median_rel=BF16_GRAD_MEDIAN))
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    batch = batch_to_device(next(iter(Batcher(
        SyntheticSource(cfg.vocab_size, seed=SEED), TRAIN_SEQ,
        TRAIN_BATCH))), dev)
    with torch.no_grad():
        loss32 = tfm.loss_fn(cfg, params, batch, Runtime(
            attn_impl="torch", norm_impl="torch"))[0].item()
    del params, batch
    torch.cuda.empty_cache()
    rel = abs(res["loss_kernel"] - loss32) / abs(loss32)
    res.update(loss_f32_plain=loss32, bf16_vs_f32_rel=rel)
    print(f"[strategy] bf16 kernel-path loss {res['loss_kernel']:.6f} vs f32 "
          f"plain {loss32:.6f}: rel {rel:.3g} (tol {BF16_VS_F32_REL})")
    check(rel <= BF16_VS_F32_REL, f"bf16 loss off the f32 loss by {rel:.3g}")
    return res


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k],
                                                              path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _tree_leaves(v, path + (i,))]
    return [("/".join(map(str, path)), np.asarray(tree))]


def tree_distance(a, b):
    """-> (max |a - b| over every leaf, leaves that differ, leaves); the
    two trees must have the same keys, shapes and dtypes."""
    la, lb = _tree_leaves(a), _tree_leaves(b)
    check([k for k, _ in la] == [k for k, _ in lb], "state trees differ in "
          "their leaves")
    worst, differ = 0.0, []
    for (k, x), (_, y) in zip(la, lb):
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"{k}: {x.dtype}{x.shape} vs {y.dtype}{y.shape}")
        if not np.array_equal(x, y):
            differ.append(k)
            worst = max(worst, float(np.max(np.abs(
                x.astype(np.float64) - y.astype(np.float64)))))
    return worst, differ, len(la)


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def ck1_phase(dev, card, expect):
    """Cell CK1: qwen3-0.6b at full width and depth, f32, under ``fsdp`` on
    the 1-rank NCCL mesh (every parameter and moment a ``DTensor``).  Run
    A trains CK_STEPS steps uninterrupted, run A' again as a control for
    nondeterminism, run B under ``supervise_training`` saves every
    CK_EVERY steps asynchronously (keep 1), crashes at the top of step
    CK_CRASH and resumes from step 2.  B's state must equal A's bit for
    bit (or lie no further from A than A' does), the event log must show
    one recovered failure, and each run's launches must be exact.  Then a
    sync save of B's state, its validation and a CRC-verified restore into
    fresh parameters (bit-equal), and an async save; their seconds are
    printed beside the cost model's ``checkpoint_write_time``.  The
    checkpoints go to a temporary directory, removed at the end."""
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    print(f"[CK1] {free / 1e9:.1f} GB free under {tmp}")
    check(free >= CK_MIN_FREE,
          f"CK1 needs {CK_MIN_FREE / 1e9:.0f} GB free under {tmp}, has "
          f"{free / 1e9:.1f} GB: {(CK_MIN_FREE - free) / 1e9:.1f} GB short")
    root = Path(tempfile.mkdtemp(prefix="ck1-"))
    cfg = get_config("qwen3-0.6b")
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    tc = TrainConfig(steps=CK_STEPS, warmup=max(CK_STEPS // 20, 1),
                     log_every=1, opt=AdamWConfig())
    res = dict(spec=CK_SPEC, steps=CK_STEPS, ckpt_every=CK_EVERY,
               crash_at=CK_CRASH, card=card)

    def batches():
        return Batcher(SyntheticSource(cfg.vocab_size, seed=SEED), TRAIN_SEQ,
                       TRAIN_BATCH)

    def counted(tag, n_steps, run):
        ops.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {k: v * n_steps for k, v in expect.items()}
        print(f"[CK1] {tag}: launches {counts}, expected {want}")
        check(counts == want, f"CK1 {tag} launches {counts} != {want}")
        return out, counts

    def release():
        # FSDP2's modules hold reference cycles: collect them, or the
        # parameters outlive their run
        gc.collect()
        torch.cuda.empty_cache()

    init_distributed(dev)
    try:
        topo = strategy.host_topology()
        strat = strategy.parse(CK_SPEC)
        plan = strat.to_plan(cfg, topo, shape)
        rt = par.make_runtime(cfg, plan, shape)
        check(rt.param_dtype == rt.compute_dtype == torch.float32,
              f"CK1 runtime dtypes {rt}")

        def uninterrupted():
            params = par.apply_plan(tfm.init_params(cfg, seed=SEED,
                                                    device=dev), plan, cfg)
            params, opt, hist = train_loop(cfg, rt, tc, batches(), params,
                                           plan=plan)
            torch.cuda.synchronize()
            tree = bridge.train_state_to_tree(params, opt, cfg)
            del params, opt
            release()
            return tree, [h["loss"] for h in hist]

        (a, losses), counts_a = counted("A", CK_STEPS, uninterrupted)
        (a2, _), counts_a2 = counted("A'", CK_STEPS, uninterrupted)
        d_ctl, differ_ctl, n_leaves = tree_distance(a2, a)
        del a2
        print(f"[CK1] A' vs A: max |d| {d_ctl:.3g}, {len(differ_ctl)} of "
              f"{n_leaves} leaves differ"
              + (f" (first: {differ_ctl[:4]})" if differ_ctl else ""))

        rec = tel.Recorder()
        spans = rec.add_sink(_Events())
        log = root / "events.json"
        tc_b = dataclasses.replace(tc, ckpt_every=CK_EVERY,
                                   ckpt_dir=str(root / "B"), ckpt_async=True,
                                   ckpt_keep=1)

        def supervised():
            t0 = time.perf_counter()
            params, opt, hist, sup = supervise_training(
                cfg, strat, topo, shape, tc_b, batches, seed=SEED,
                device=dev, fault_plan=FaultPlan.crashes_at(CK_CRASH),
                sup_cfg=SupervisorConfig(backoff_base_s=0.0,
                                         event_log_path=str(log)),
                telemetry=rec)
            torch.cuda.synchronize()
            return params, opt, hist, time.perf_counter() - t0

        (p_b, o_b, hist_b, wall_b), counts_b = counted("B", CK_RUNS_B,
                                                       supervised)
        b = bridge.train_state_to_tree(p_b, o_b, cfg)
        d_b, differ_b, _ = tree_distance(b, a)
        print(f"[CK1] B vs A: max |d| {d_b:.3g}, {len(differ_b)} of "
              f"{n_leaves} leaves differ; bit for bit: {not differ_b}")
        check(d_b <= d_ctl and (differ_ctl or not differ_b),
              f"CK1: the resumed run B is {d_b:.3g} from A ({differ_b[:4]}),"
              f" further than the control A' ({d_ctl:.3g})")
        del a
        events = json.loads(log.read_text())
        fails = [e for e in events["events"] if e["kind"] == "failure"]
        check(events["n_failures"] == 1 and len(fails) == 1
              and fails[0]["step_failed"] == CK_CRASH
              and fails[0]["restore_step"] == CK_EVERY,
              f"CK1 event log: {events}")
        check(ckpt_lib.list_steps(tc_b.ckpt_dir) == [CK_STEPS],
              f"CK1 keep 1: {ckpt_lib.list_steps(tc_b.ckpt_dir)}")
        stalls = [e["dur"] for e in spans.events
                  if e["name"] == "train/ckpt"]
        shutil.rmtree(root / "B")

        # a sync save of B's state, validated, restored into fresh params
        meta = {"step": CK_STEPS, "batches_consumed": CK_STEPS,
                "prng": prng_key_data(SEED)}
        t0 = time.perf_counter()
        tree = bridge.train_state_to_tree(p_b, o_b, cfg)
        gather_s = time.perf_counter() - t0
        del p_b, o_b
        release()
        t0 = time.perf_counter()
        ckpt_lib.save_checkpoint(str(root / "S"), CK_STEPS, tree, meta)
        save_s = time.perf_counter() - t0
        n_bytes = _dir_bytes(root / "S")
        t0 = time.perf_counter()
        problems = ckpt_lib.validate_checkpoint(str(root / "S"), CK_STEPS)
        validate_s = time.perf_counter() - t0
        check(problems == [], f"CK1 validation: {problems}")
        fresh = par.apply_plan(tfm.init_params(cfg, seed=SEED + 1,
                                               device=dev), plan, cfg)
        fresh_opt = init_opt_state(fresh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = ckpt_lib.latest_valid_step(str(root / "S"), verify=True)
        loaded = ckpt_lib.restore_checkpoint(
            str(root / "S"), step, bridge.train_state_target(fresh, cfg))
        bridge.load_train_state(loaded, fresh, fresh_opt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del loaded
        d_r, differ_r, _ = tree_distance(
            bridge.train_state_to_tree(fresh, fresh_opt, cfg), b)
        check(not differ_r, f"CK1 restore differs in {differ_r[:4]} by "
              f"{d_r:.3g}")
        del fresh, fresh_opt
        release()
        shutil.rmtree(root / "S")

        # an async save of the same state: the stall and the background
        # write
        ck = ckpt_lib.AsyncCheckpointer(str(root / "A"))
        stall_s = ck.save(CK_STEPS, tree, meta)
        ck.close()
        write_s = ck.stats[0]["write_s"]
        del tree, b
        t_pred = cm.checkpoint_write_time(cfg, topo.hw,
                                          strat.to_cost_strategy(cfg, topo))
        pred_bytes = cm.checkpoint_bytes(cfg, "f32")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutdown()
    res.update(
        losses=losses, control_max_abs=d_ctl,
        control_leaves_differ=differ_ctl, b_max_abs=d_b,
        b_leaves_differ=differ_b, bit_for_bit=not differ_b,
        leaves=n_leaves, event_log=events, wall_b_s=wall_b,
        loop_ckpt_stall_s=stalls, bytes_on_disk=n_bytes,
        predicted_bytes=pred_bytes, gather_s=gather_s, sync_save_s=save_s,
        validate_s=validate_s, restore_s=restore_s, async_stall_s=stall_s,
        async_write_s=write_s, t_ckpt_predicted_s=t_pred,
        predicted_over_sync_save=t_pred / save_s,
        predicted_over_async_write=t_pred / write_s,
        launches={k: counts_a[k] + counts_a2[k] + counts_b[k]
                  for k in counts_a},
        launches_b=counts_b)
    print(f"[CK1] {n_bytes / 1e9:.3f} GB on disk (cost model "
          f"{pred_bytes / 1e9:.3f} GB); gather {gather_s:.2f} s, sync save "
          f"{save_s:.2f} s, validate {validate_s:.2f} s, CRC-verified "
          f"restore {restore_s:.2f} s; async save stall {stall_s:.2f} s, "
          f"background write {write_s:.2f} s; in-loop train/ckpt spans "
          + ", ".join(f"{t:.2f}" for t in stalls) + " s; run B "
          f"{wall_b:.1f} s; on {card}")
    print(f"[CK1] cost model t_ckpt {t_pred:.2f} s ({topo.hw.ckpt_bw / 1e9:.0f}"
          f" GB/s per writer, {cm.distinct_writers(strat.to_cost_strategy(cfg, topo))}"
          f" writer): predicted/measured {t_pred / save_s:.3g} (sync save), "
          f"{t_pred / write_s:.3g} (async write)")
    return res


def drift_report(drift, rec, card):
    """Cell D1: the cost model's predicted step decomposition for the
    strategy phase's plan against each logging window's measured one
    (``train_loop``'s drift windows, as ``launch.train --drift_report``
    records them) and the ``train/mfu`` gauge.  A measurement: it holds no
    target ratio, only that there are windows, that the ``step`` ratio is
    finite and positive and that ``train/mfu`` lies in (0, 1]."""
    doc = drift.report()
    mean = doc["mean_predicted_over_measured"]
    check(doc["n_windows"] >= 1, "the drift monitor saw no window")
    check(np.isfinite(mean.get("step", float("nan")))
          and mean["step"] > 0,
          f"predicted/measured step ratio {mean.get('step')}")
    meta = doc["meta"]
    mfu = [meta["model_flops_per_step"] / w["measured"]["step"]
           / meta["cluster_peak_flops"] for w in doc["windows"]]
    gauge = rec.metrics.snapshot()["train/mfu"]["value"]
    check(0 < gauge <= 1 and abs(gauge - mfu[-1]) <= 1e-9 * mfu[-1],
          f"train/mfu {gauge} (windows {mfu})")
    steady = [w["predicted_over_measured"]["step"]
              for w in doc["windows"][1:]]
    print(f"[drift] predicted ({meta['spec']} on {meta['topology']}, "
          f"{meta['hardware']} profile): "
          + ", ".join(f"{k} {v * 1e3:.3f} ms"
                      for k, v in doc["predicted"].items()))
    for w in doc["windows"]:
        print(f"[drift] window {w['window']}: measured "
              + ", ".join(f"{k} {v * 1e3:.1f} ms"
                          for k, v in w["measured"].items())
              + "; predicted/measured "
              + ", ".join(f"{k} {v:.4g}" if v is not None else f"{k} null"
                          for k, v in w["predicted_over_measured"].items()))
    print(f"[drift] mean predicted/measured over {doc['n_windows']} windows: "
          + ", ".join(f"{k} {v:.4g}" for k, v in mean.items())
          + (f" (step, windows after the first: "
             f"{statistics.mean(steady):.4g})" if steady else "")
          + f"; train/mfu {gauge:.4g} (windows "
          + ", ".join(f"{m:.4g}" for m in mfu) + f"); on {card}")
    return dict(report=doc, mfu=mfu, mfu_gauge=gauge,
                step_ratio_after_first=statistics.mean(steady)
                if steady else None)


def dryrun_phase(card, measured_peak):
    """Cell D2: the port's dry run of the strategy phase's plan at its
    shape (``fsdp_bf16``, B TRAIN_BATCH x S TRAIN_SEQ, the host topology
    as one fake rank, the kernel path) -> its tracked peak against the
    strategy phase's ``torch.cuda.max_memory_allocated``, within
    DRYRUN_MEM_REL; then ``qwen3-0.6b x train_4k`` on the pod topology
    (256 fake ranks), which must trace."""
    cfg = get_config("qwen3-0.6b")
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    topo = strategy.host_topology(n_devices=1)
    strat, _ = strategy.resolve(STRATEGY_SPEC, cfg, topo, shape)
    rec = dryrun.lower_fresh(cfg, shape, strat, topo, device="cuda")
    mem = rec["memory"]
    tracked = mem["peak_bytes_per_device"]
    rel = abs(tracked - measured_peak) / measured_peak
    print(f"[dryrun] {strat.format()} B{TRAIN_BATCH} x S{TRAIN_SEQ} on one "
          f"fake rank (kernel path, traced in {rec['trace_s']} s): tracked "
          f"peak {tracked / 2**30:.3f} GiB ("
          + ", ".join(f"{k[:-6]} {v / 2**30:.3f}" for k, v in mem.items()
                      if k != "peak_bytes_per_device")
          + f" GiB) vs the strategy phase's max_memory_allocated "
          f"{measured_peak / 2**30:.3f} GiB: rel {rel:.3g} (tol "
          f"{DRYRUN_MEM_REL}); collectives {rec['collectives']}; on {card}")
    check(rel <= DRYRUN_MEM_REL,
          f"dry-run peak {tracked} B vs measured {measured_peak} B")
    t0 = time.perf_counter()
    pod = dryrun.run_one("qwen3-0.6b", "train_4k", False, DRYRUN_OUT,
                         device="cuda")
    check(pod["status"] == "ok" and pod["n_devices"] == 256
          and pod["collectives"] and "resilience" in pod,
          f"pod dry run: {pod.get('status')} {pod.get('error')}")
    print(f"[dryrun] qwen3-0.6b x train_4k on pod ({pod['strategy']}, "
          f"{pod['n_devices']} fake ranks) in "
          f"{time.perf_counter() - t0:.1f} s: peak/dev "
          f"{pod['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB, "
          f"collective bytes {pod['collective_bytes_total']:.4g}")
    return dict(d2=dict(memory=mem, measured_peak_bytes=measured_peak,
                        rel=rel, trace_s=rec["trace_s"],
                        collectives=rec["collectives"]),
                pod=pod)


def fp8_run(dev, card, cfg, shape, expect):
    """FP8_SPEC at the strategy phase's shape on its 1-rank NCCL mesh:
    FP8_STEPS AdamW steps (launches held to ``expect`` per step, all on
    bf16 tensors); then, from the initial weights and one batch, each
    layer unit's all-gather buffer must be float8_e4m3fn with a quarter of
    f32's bytes and the root unit's f32, and the loss and gradients must
    agree with the plain path that rounds each layer's parameters through
    float8_e4m3fn itself (``wire_round``, the oracle) within the bf16
    bars."""
    topo = strategy.host_topology()
    strat, _ = strategy.resolve(FP8_SPEC, cfg, topo, shape)
    plan = strat.to_plan(cfg, topo, shape)
    rt = par.make_runtime(cfg, plan, shape)
    check(rt.gather_dtype == torch.float8_e4m3fn and rt.fsdp_wire
          and rt.compute_dtype == torch.bfloat16,
          f"{FP8_SPEC}: runtime {rt}")
    tc = TrainConfig(steps=FP8_STEPS, warmup=max(FP8_STEPS // 20, 1),
                     log_every=1, opt=AdamWConfig())
    res = run_steps(dev, card, cfg, rt, tc, par.apply_plan(
        tfm.init_params(cfg, seed=SEED, device=dev), plan, cfg), expect,
        "fp8", plan=plan, expect_bf16=expect)
    gc.collect()
    torch.cuda.empty_cache()
    batch = batch_to_device(next(iter(Batcher(
        SyntheticSource(cfg.vocab_size, seed=SEED), TRAIN_SEQ,
        TRAIN_BATCH))), dev)
    params = par.apply_plan(tfm.init_params(cfg, seed=SEED, device=dev),
                            plan, cfg)
    loss_w, grads_w = loss_and_grads(cfg, params, batch, rt)
    grads_w = {n: g.full_tensor() for n, g in grads_w.items()}
    wire = [par.all_gather_buffers(layer) for layer in params.layers]
    root = par.all_gather_buffers(params)
    f32 = [4 * sum(p.numel() for p in layer.parameters())
           for layer in params.layers]
    root_f32 = 4 * sum(p.numel() for n, p in params.named_parameters()
                       if not n.startswith("layers."))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for i, (got, full) in enumerate(zip(wire, f32)):
        check(got == {torch.float8_e4m3fn: full // 4},
              f"layer {i} all-gather buffers {got}, want float8_e4m3fn "
              f"{full // 4} bytes (f32 {full})")
    check(root == {torch.float32: root_f32},
          f"root unit all-gather buffers {root}, want f32 {root_f32}")
    oracle = Runtime(compute_dtype=torch.bfloat16,
                     gather_dtype=torch.float8_e4m3fn, attn_impl="torch",
                     norm_impl="torch")
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    loss_p, grads_p = loss_and_grads(cfg, params, batch, oracle)
    del params, batch
    rels = {n: rel_err(grads_w[n], grads_p[n]) for n in grads_p}
    del grads_w, grads_p
    torch.cuda.empty_cache()
    worst = max(rels, key=rels.get)
    med = statistics.median(rels.values())
    res.update(spec=strat.format(),
               wire_bytes_per_layer={str(k): v for k, v in wire[0].items()},
               f32_bytes_per_layer=f32[0],
               root_wire={str(k): v for k, v in root.items()},
               loss_wire=loss_w, loss_oracle=loss_p,
               grad_rel_err_max=rels[worst], grad_rel_err_worst_leaf=worst,
               grad_rel_err_median=med)
    print(f"[fp8] {len(wire)} layer units gather float8_e4m3fn "
          f"({sum(sum(w.values()) for w in wire) / 2 ** 20:.1f} MiB a "
          f"gather of all layers, f32 {sum(f32) / 2 ** 20:.1f} MiB), the "
          f"root unit f32 ({root_f32 / 2 ** 20:.1f} MiB); kernel path on "
          f"the fp8 wire vs the plain wire_round path: loss {loss_w:.6f} vs "
          f"{loss_p:.6f} (|diff| {abs(loss_w - loss_p):.3g}, tol "
          f"{BF16_LOSS_ATOL}); gradients rel err max {rels[worst]:.3g} "
          f"({worst}), median {med:.3g} (tol {BF16_GRAD_REL}, median "
          f"{BF16_GRAD_MEDIAN}); step p50 {res['step_p50_s'] * 1e3:.1f} ms, "
          f"peak memory {res['peak_mem_gib']:.2f} GiB; on {card}")
    check(abs(loss_w - loss_p) <= BF16_LOSS_ATOL,
          f"fp8 loss differs by {abs(loss_w - loss_p):.3g}")
    check(rels[worst] <= BF16_GRAD_REL,
          f"fp8 gradient {worst} differs by {rels[worst]:.3g} of its scale")
    check(med <= BF16_GRAD_MEDIAN,
          f"fp8 gradient errors' median {med:.3g} over {BF16_GRAD_MEDIAN}")
    return res


# ---------------------------------------------------------------------------
# phase 7: pipeline schedules, two processes on the one card
# ---------------------------------------------------------------------------

def _pipe_expect(cfg, rank):
    """Kernel launches per step on pipe rank ``rank``: each of its
    PIPE_MICROBATCHES microbatches runs its L / P layers (two RMSNorms and
    one flash attention each, forward and backward), and the last stage
    the final norm."""
    n = PIPE_MICROBATCHES * cfg.n_layers // PIPE_STAGES
    norms = 2 * n + (PIPE_MICROBATCHES if rank == PIPE_STAGES - 1 else 0)
    return {"rmsnorm": norms, "rmsnorm_bwd": norms, "flash_decode": 0,
            "flash_attention": n, "flash_attention_dq": n,
            "flash_attention_dkv": n, "wkv6": 0}


def _pipe_rank(rank, port, out_dir):
    """One pipe rank of the pipeline phase (a spawned process): the
    unpipelined f32 step's loss and gradients on the card first, then
    every schedule of PIPE_SCHEDULES through the train CLI's functions;
    writes its measurements to ``out_dir/rank<r>.json``."""
    import datetime
    from repro_torch.configs import reduced
    from repro_torch.core import pipeline as pipe_lib
    from repro_torch.perf.pipeline_probe import measure_bubble, probe_layers
    from repro_torch.train.trainer import make_train_step
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # NCCL for the card's tensors (the data and model groups, one rank
    # each), gloo for host tensors (the pipe group's point-to-point):
    # NCCL cannot put two ranks of one card in one communicator
    dist.init_process_group(
        "cpu:gloo,cuda:nccl", init_method=f"tcp://localhost:{port}",
        rank=rank, world_size=PIPE_STAGES,
        timeout=datetime.timedelta(seconds=PIPE_TIMEOUT_S // 2))
    try:
        cfg = get_config("qwen3-0.6b")
        shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
        it = iter(Batcher(SyntheticSource(cfg.vocab_size, seed=SEED),
                          TRAIN_SEQ, TRAIN_BATCH))
        host_batches = [next(it) for _ in range(PIPE_STEPS)]
        first = batch_to_device(host_batches[0], dev)
        loss_ref, grads_ref = loss_and_grads(
            cfg, tfm.init_params(cfg, seed=SEED, device=dev), first,
            Runtime())
        out = {"rank": rank, "loss_ref": loss_ref, "schedules": {}}
        for sched in PIPE_SCHEDULES:
            spec = f"fsdp_pp{PIPE_STAGES}_mb{PIPE_MICROBATCHES}" + (
                "" if sched == "gpipe" else f"_{sched}")
            s = strategy.parse(spec)
            topo = strategy.host_topology()
            plan = s.to_plan(cfg, topo, shape)
            rt = par.make_runtime(cfg, plan, shape, pipe_via_host=True)
            params = par.apply_plan(
                tfm.init_params(cfg, seed=SEED, device=dev), plan, cfg)
            step = make_train_step(cfg, rt, TrainConfig(
                steps=PIPE_STEPS, warmup=1, opt=AdamWConfig()), plan)
            state = init_opt_state(params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launch_counts()
            metrics, step_s, runs = [], [], []
            for b in host_batches:
                t0 = time.perf_counter()
                _, state, m = step(params, state, batch_to_device(b, dev))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                metrics.append({k: float(v) for k, v in m.items()})
                runs.append(step.last_run)
                if len(metrics) == 1:
                    # the first step's gradients: AdamW's first moment is
                    # (1 - b1) x the clipped gradient
                    clip = min(1.0, 1.0 / max(m["grad_norm"].item(), 1e-9))
                    grad_rel = {
                        n: rel_err(state["m"][n].to_local()
                                   / ((1 - AdamWConfig().b1) * clip),
                                   grads_ref[n])
                        for n in state["m"]}
            counts = ops.launch_counts()
            out["schedules"][sched] = dict(
                spec=spec, launches=counts,
                launches_per_step={k: v / PIPE_STEPS
                                   for k, v in counts.items()},
                expect_per_step=_pipe_expect(cfg, rank),
                ops=[[list(op) for op in r.ops] for r in runs],
                table_ops=[list(op) for op in pipe_lib.rank_ops(
                    s.sched, PIPE_STAGES, PIPE_MICROBATCHES, rank)],
                peak_held=[r.peak_held for r in runs],
                table_peak_held=pipe_lib.peak_held(
                    s.sched, PIPE_STAGES, PIPE_MICROBATCHES, rank),
                inflight_microbatches=pipe_lib.inflight_microbatches(
                    PIPE_STAGES, PIPE_MICROBATCHES, s.sched),
                metrics=metrics, step_s=step_s,
                peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                grad_rel_err=grad_rel,
                layers=sorted({int(n.split(".")[1]) for n, _ in
                               params.named_parameters()
                               if n.startswith("layers.")}))
            del params, state, step, runs
            gc.collect()
            torch.cuda.empty_cache()
            # the bubble probe (after the counted steps): the port's
            # pipelined step at M and 2M microbatches of a reduced config
            out["schedules"][sched]["probe"] = measure_bubble(
                reduced(cfg, n_layers=probe_layers(PIPE_STAGES, s.sched)),
                s, topo, dev, pipe_via_host=True)
            gc.collect()
            torch.cuda.empty_cache()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _spans(ids):
    """[0, 1, 2, 7, 8] -> '0-2,7-8'."""
    out, start = [], ids[0]
    for a, b in zip(ids, ids[1:] + [None]):
        if b != a + 1:
            out.append(f"{start}-{a}")
            start = b
    return ",".join(out)


def pipeline_phase(card):
    """Spawn PIPE_STAGES processes on the one card (``_pipe_rank``), wait
    for them within PIPE_TIMEOUT_S, and hold what each reports: the ops it
    ran equal its table column, the most microbatch graphs it held equal
    the table's (and over the ranks ``inflight_microbatches``), its kernel
    launches per step exact, the first step's loss and gradients those of
    the unpipelined f32 step, the loss the same on every rank.  -> the
    phase's measurements."""
    import multiprocessing
    import socket
    import tempfile
    from repro_torch.core import pipeline as pipe_lib
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_pipe")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_pipe_rank, args=(r, port, out_dir))
             for r in range(PIPE_STAGES)]
    for p in procs:
        p.start()
    deadline = time.time() + PIPE_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    check(codes == [0] * PIPE_STAGES,
          f"pipeline ranks exited with {codes} (None: still running after "
          f"{PIPE_TIMEOUT_S} s)")
    ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
             for r in range(PIPE_STAGES)]
    launches = {k: 0 for k in ops.launch_counts()}
    res = {"card": card, "schedules": {}}
    for sched in PIPE_SCHEDULES:
        got = [r["schedules"][sched] for r in ranks]
        peaks = set()
        for rank, g in enumerate(got):
            for ran in g["ops"]:
                check(ran == g["table_ops"],
                      f"{sched} rank {rank} ran {ran}, its table column is "
                      f"{g['table_ops']}")
            for peak in g["peak_held"]:
                check(peak == g["table_peak_held"],
                      f"{sched} rank {rank} held {peak} microbatch graphs, "
                      f"its table {g['table_peak_held']}")
                peaks.add(peak)
            check(g["launches_per_step"] == g["expect_per_step"],
                  f"{sched} rank {rank} launches per step "
                  f"{g['launches_per_step']} != {g['expect_per_step']}")
            loss = g["metrics"][0]["loss"]
            ref = ranks[rank]["loss_ref"]
            check(abs(loss - ref) <= PIPE_LOSS_REL * abs(ref),
                  f"{sched} rank {rank}: first loss {loss} vs unpipelined "
                  f"{ref}")
            worst = max(g["grad_rel_err"], key=g["grad_rel_err"].get)
            check(g["grad_rel_err"][worst] <= PIPE_GRAD_REL,
                  f"{sched} rank {rank}: gradient {worst} differs by "
                  f"{g['grad_rel_err'][worst]:.3g} of its scale")
            check(all(np.isfinite(m["loss"]) for m in g["metrics"]),
                  f"{sched} rank {rank}: losses {g['metrics']}")
            for k, v in g["launches"].items():
                launches[k] += v
        check(got[0]["metrics"] == got[1]["metrics"],
              f"{sched}: the ranks report different metrics")
        check(max(peaks) == got[0]["inflight_microbatches"],
              f"{sched}: most graphs held {max(peaks)} != "
              f"inflight_microbatches {got[0]['inflight_microbatches']}")
        probes = [g["probe"] for g in got]
        v = probes[0]["virtual_stages"]
        P, M = PIPE_STAGES, PIPE_MICROBATCHES
        formula = (2 * (P - 1) / (3 * M + 2 * P - 2) if sched == "zb"
                   else (P - 1) / (v * M + P - 1))
        for rank, pr in enumerate(probes):
            check(abs(pr["bubble_predicted"] - formula) <= 1e-12
                  and "fit_unreliable" in pr
                  and pr["virtual_stages"] == pipe_lib.virtual_stages(sched),
                  f"{sched} rank {rank}: probe record {pr}")
        worst = max((max(g["grad_rel_err"].values()), rank)
                    for rank, g in enumerate(got))
        p50 = [statistics.median(g["step_s"]) for g in got]
        res["schedules"][sched] = dict(
            spec=got[0]["spec"], losses=[m["loss"] for m in got[0]["metrics"]],
            loss_ref=ranks[0]["loss_ref"], grad_rel_err_max=worst[0],
            step_s=[g["step_s"] for g in got], step_p50_s=p50,
            peak_mem_gib=[g["peak_mem_gib"] for g in got],
            peak_held=[g["table_peak_held"] for g in got],
            launches_per_step=[g["launches_per_step"] for g in got],
            layers=[g["layers"] for g in got], probe=probes)
        print(f"[pipeline] {got[0]['spec']}: ranks hold layers "
              f"{' / '.join(_spans(g['layers']) for g in got)}; ops per "
              f"rank as the table; "
              f"graphs held {[g['table_peak_held'] for g in got]} "
              f"(inflight_microbatches {got[0]['inflight_microbatches']}); "
              f"first loss {got[0]['metrics'][0]['loss']:.6f} vs unpipelined "
              f"{ranks[0]['loss_ref']:.6f}, gradients within "
              f"{worst[0]:.3g} of scale; step p50 "
              f"{', '.join(f'{t * 1e3:.1f}' for t in p50)} ms per rank "
              f"(two processes time-slicing one card, not pipeline speed); "
              f"peak memory "
              f"{', '.join(f'{g["peak_mem_gib"]:.2f}' for g in got)} GiB "
              f"per rank; on {card}")
        print(f"[pipeline] {sched} bubble probe ({probes[0]['probe_cfg']}, "
              f"{probes[0]['pp']} stages, M {probes[0]['microbatches']}, "
              f"v {v}): predicted {probes[0]['bubble_predicted']:.4f}; "
              "per rank measured "
              + ", ".join(f"{pr['bubble_measured']:.4f} (t(M) "
                          f"{pr['t_step_s'] * 1e3:.1f} ms, t(2M) "
                          f"{pr['t_step_2m_s'] * 1e3:.1f} ms, fit_unreliable "
                          f"{pr['fit_unreliable']})" for pr in probes)
              + " — two processes time-slice one card: not a bubble")
    res["launches"] = launches
    return res


@contextlib.contextmanager
def wkv_output_noise(rel, dev):
    """Within the block, the plain WKV output is multiplied by (1 + rel *
    N(0, 1)) (seeded): a perturbation the size of the kernel's measured
    rounding difference, to read how far the gradients move for it."""
    plain = rwkv_lib.wkv_chunked
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def noisy(r, k, v, w, u, state, chunk):
        y, s = plain(r, k, v, w, u, state, chunk)
        eps = torch.randn(y.shape, generator=gen, device=y.device)
        return y * (1 + rel * eps), s

    rwkv_lib.wkv_chunked = noisy
    try:
        yield
    finally:
        rwkv_lib.wkv_chunked = plain


def grad_check(dev, cfg, rt, plain_rt, check_batch, tag, floor=0.0,
               loss_atol=TRAIN_LOSS_ATOL, grad_rel=TRAIN_GRAD_REL,
               median_rel=None):
    """The loss and every gradient of the kernel path ``rt`` against the
    plain path from the same initial weights and one batch of
    ``check_batch`` x TRAIN_SEQ: the loss within ``loss_atol``, each
    leaf's error within ``grad_rel`` of its scale (and, with
    ``median_rel``, their median within it).  With ``floor`` > 0 the plain
    path runs a second time with its WKV outputs perturbed by a relative
    ``floor``, and the median and the maximum of the leaves' errors are
    instead each held to ``grad_rel`` or FLOOR_FACTOR times the same
    statistic of the leaves' movement under that perturbation, whichever
    is larger."""
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    batch = batch_to_device(next(iter(Batcher(
        SyntheticSource(cfg.vocab_size, seed=SEED), TRAIN_SEQ,
        check_batch))), dev)
    loss_k, grads_k = loss_and_grads(cfg, params, batch, rt)
    loss_p, grads_p = loss_and_grads(cfg, params, batch, plain_rt)
    rels = {name: rel_err(grads_k[name], grads_p[name]) for name in grads_k}
    del grads_k
    res = dict(layers=cfg.n_layers, check_batch=check_batch,
               loss_kernel=loss_k, loss_plain=loss_p)
    if floor:
        with wkv_output_noise(floor, dev):
            loss_n, grads_n = loss_and_grads(cfg, params, batch, plain_rt)
        moved = {name: rel_err(grads_n[name], grads_p[name])
                 for name in grads_n}
        del grads_n
        worst_n = max(moved, key=moved.get)
        res.update(noise_rel=floor, loss_noise=loss_n,
                   noise_grad_rel_err_max=moved[worst_n],
                   noise_grad_rel_err_worst_leaf=worst_n,
                   noise_grad_rel_err_median=statistics.median(
                       moved.values()))
    worst = max(rels, key=rels.get)
    res.update(grad_rel_err_max=rels[worst], grad_rel_err_worst_leaf=worst,
               grad_rel_err_median=statistics.median(rels.values()),
               leaves=len(rels),
               leaves_within_grad_rel=sum(r <= grad_rel
                                          for r in rels.values()))
    print(f"[{tag}] kernel vs plain path, {cfg.n_layers} layers, "
          f"{check_batch}x{TRAIN_SEQ} ({time.perf_counter() - t0:.1f}s): "
          f"loss {loss_k:.6f} vs {loss_p:.6f} (|diff| "
          f"{abs(loss_k - loss_p):.3g}, tol {loss_atol}); gradients "
          f"rel err max {rels[worst]:.3g} ({worst}), median "
          f"{res['grad_rel_err_median']:.3g}; "
          f"{res['leaves_within_grad_rel']} of {len(rels)} leaves within "
          f"{grad_rel}")
    if floor:
        print(f"[{tag}] plain path vs itself with its WKV outputs perturbed "
              f"by a relative {floor}: loss |diff| "
              f"{abs(res['loss_noise'] - loss_p):.3g}; gradients rel err max "
              f"{res['noise_grad_rel_err_max']:.3g} ({worst_n}), median "
              f"{res['noise_grad_rel_err_median']:.3g}; the kernel path's "
              f"median and max held to max({grad_rel}, "
              f"{FLOOR_FACTOR} x these)")
    check(abs(loss_k - loss_p) <= loss_atol,
          f"loss differs by {abs(loss_k - loss_p):.3g}")
    if floor:
        for stat in ("median", "max"):
            got, own = (res[f"{pre}grad_rel_err_{stat}"]
                        for pre in ("", "noise_"))
            bar = max(grad_rel, FLOOR_FACTOR * own)
            check(got <= bar, f"gradient error {stat} {got:.3g} over "
                              f"{bar:.3g} ({FLOOR_FACTOR} x the plain path's "
                              f"own {own:.3g})")
    else:
        check(rels[worst] <= grad_rel,
              f"gradient {worst} differs by {rels[worst]:.3g} of its scale")
    if median_rel is not None:
        check(res["grad_rel_err_median"] <= median_rel,
              f"gradient errors' median {res['grad_rel_err_median']:.3g} "
              f"over {median_rel}")
    return res


# ---------------------------------------------------------------------------
# phases 9-13: static serving from dense caches (SS1-SS4) and D3
# ---------------------------------------------------------------------------

SS_BATCH, SS_PROMPT, SS_NEW = 8, 128, 64       # SS1, SS3 (SS4: SS4_NEW)
SS2_BATCH, SS2_PROMPT, SS2_NEW = 4, 64, 32
SS_RWKV_CHUNK = 16                  # the serve CLIs' WKV chunk
# static decode vs the teacher-forced training forward (kernel path) of
# rwkv6-1.6b at full depth: on the CPU the two differ by 2.0e-5 at 4
# layers of full width and 2.5e-5 at 24 layers of width 256, whence 1e-3
# (10x the larger, extrapolated to 24 layers of full width).  On the card
# the forward at full depth is as sensitive as its backward (the rwkv6
# train phase): the plain forward against itself with its WKV outputs
# perturbed by a relative WKV_NOISE_REL moves the logits by 1.17e-3, more
# than 1e-3.  So the bar is 1e-3 or FLOOR_FACTOR x that floor, measured in
# the same run, whichever is larger (the rwkv6 train phase's rule for its
# gradients)
SS2_LOGIT_ATOL = 1e-3
SS4_LAYERS, SS4_SPEC, SS4_NEW = 4, "fsdp_tp2", 32
SS4_LOGIT_REL = 1e-4                 # of the logits' scale
SS4_TIMEOUT_S = 600
D3_MEM_REL = 0.10


def _static_prompts(vocab, B, S):
    return np.random.default_rng(SEED).integers(
        0, vocab, (B, S)).astype(np.int32)


def _static_expect(cfg, n_new, kinds=("rmsnorm", "flash_attention")):
    """Launches of one ``generate_static`` (1 prefill + n_new - 1 decode
    steps) of an attention stack on the kernel path: 2L + 1 RMSNorms per
    forward, L flash forwards in the prefill, nothing else."""
    out = {k: 0 for k in ops.launch_counts()}
    if "rmsnorm" in kinds:
        out["rmsnorm"] = (2 * cfg.n_layers + 1) * n_new
    if "flash_attention" in kinds:
        out["flash_attention"] = cfg.n_layers
    return out


def static_logits(cfg, params, rt, prompts, tokens, dev):
    """Teacher forcing through the static path: a prefill of ``prompts``
    (B, S) into fresh dense caches, then a decode step for each of
    ``tokens`` (B, n) but the last -> (B, n, V) f32 logits, the n next-
    token distributions."""
    n = tokens.shape[1]
    with torch.no_grad():
        lg, cache = tfm.prefill(cfg, params, {"tokens": torch.as_tensor(
            prompts, device=dev)}, rt, prompts.shape[1] + n)
        out = [lg[:, -1].float()]
        toks = torch.as_tensor(tokens, device=dev)
        for t in range(n - 1):
            lg, cache = tfm.decode_step(cfg, params, cache,
                                        toks[:, t:t + 1],
                                        prompts.shape[1] + t, rt)
            out.append(lg[:, 0].float())
    return torch.stack(out, 1)


def _timed_static(eng, prompts, n_new, dev):
    """(prefill ms, synchronized; ms per decode step over n_new - 1 greedy
    steps, synchronized once) of ``eng``'s static path."""
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = eng._prefill(eng.params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        del lg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_new - 1):
            lg, cache = eng._step(eng.params, cache, tok,
                                  prompts.shape[1] + t)
            tok = lg[:, 0].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (n_new - 1)
    return prefill_ms, step_ms


def _counted_static(eng, prompts, n_new, expect, tag):
    """One counted ``generate_static``: counters zeroed just before, read
    just after; -> (tokens, wall s, counts)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate_static(prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"[{tag}] launches {counts}, expected {expect}")
    check(counts == expect, f"{tag}: launch counts {counts} != {expect}")
    return out, wall, counts


def static_phase(dev, card):
    """SS1: qwen3-0.6b at full width and depth, f32, ``generate_static``
    of a closed batch on the kernel path: timings, exact launches,
    teacher-forced logits kernel vs plain, and the paged engine's tokens
    on the same prompts."""
    cfg = get_config("qwen3-0.6b")
    prompts = _static_prompts(cfg.vocab_size, SS_BATCH, SS_PROMPT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    eng = ServeEngine(cfg, params, Runtime(), max_len=SS_PROMPT + SS_NEW,
                      device=dev)
    # first-call costs (cuBLAS picks per shape): the timed shapes, once
    eng.generate_static(prompts, 2)
    prefill_ms, step_ms = _timed_static(eng, prompts, SS_NEW, dev)
    out, wall, counts = _counted_static(eng, prompts, SS_NEW,
                                        _static_expect(cfg, SS_NEW), "SS1")
    gens = out[:, SS_PROMPT:]
    check(gens.shape == (SS_BATCH, SS_NEW)
          and bool(((gens >= 0) & (gens < cfg.vocab_size)).all()),
          f"SS1 tokens {gens.shape} out of range")
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    tok_s = SS_BATCH * SS_NEW / wall
    print(f"[SS1] {cfg.name} B{SS_BATCH} prompt {SS_PROMPT} +{SS_NEW} "
          f"greedy (f32, kernel path, static): prefill {prefill_ms:.2f} ms, "
          f"{step_ms:.3f} ms a decode step, {tok_s:.1f} tok/s over "
          f"{wall:.3f} s, peak {peak:.3f} GiB; on {card}")
    plain = Runtime(attn_impl="torch", norm_impl="torch")
    lk = static_logits(cfg, params, Runtime(), prompts, gens, dev)
    lp = static_logits(cfg, params, plain, prompts, gens, dev)
    worst = (lk - lp).abs().max().item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    served = (lk.argmax(-1).cpu().numpy() == gens).mean()
    del lk, lp
    paged = ServeEngine(cfg, params, Runtime(), max_len=SS_PROMPT + SS_NEW,
                        n_slots=SS_BATCH, device=dev).generate(
                            prompts, SS_NEW)[:, SS_PROMPT:]
    paged_agree = float((paged == gens).mean())
    print(f"[SS1] teacher forcing: max |logits kernel - plain| {worst:.3g} "
          f"(tol {LOGIT_ATOL}), greedy agreement {agree:.4f}, kernel path/"
          f"served {served:.4f}; paged engine's tokens agree with the "
          f"static ones at {paged_agree:.4f} (bar {MIN_AGREEMENT})")
    check(worst <= LOGIT_ATOL, f"SS1 logits differ by {worst:.3g}")
    check(min(agree, served, paged_agree) >= MIN_AGREEMENT,
          f"SS1 agreement {agree:.4f} / {served:.4f} / {paged_agree:.4f}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(card=card, batch=SS_BATCH, prompt=SS_PROMPT, new=SS_NEW,
                prefill_ms=prefill_ms, decode_step_ms=step_ms, tok_s=tok_s,
                wall_s=wall, peak_mem_gib=peak, launches=counts,
                logits_max_abs_err=worst, greedy_agreement=agree,
                paged_agreement=paged_agree, tokens=gens.tolist())


def static_plan_phase(dev, card, ss1_tokens):
    """SS3: SS1's serving through the serve CLI's ``make_engine`` on a
    1-rank NCCL group: ``--strategy auto`` (the planner's decode plan;
    its tokens equal the unsharded engine's at the plan's dtypes) and
    ``--strategy fsdp`` (f32: its tokens equal SS1's).  Under ``fsdp``
    the peak of one decode step is measured for D3."""
    from repro_torch.launch.serve import make_engine
    cfg = get_config("qwen3-0.6b")
    prompts = _static_prompts(cfg.vocab_size, SS_BATCH, SS_PROMPT)
    ss1 = np.asarray(ss1_tokens, np.int32)
    res = {"card": card}
    launches = {k: 0 for k in ops.launch_counts()}
    init_distributed(dev)
    try:
        for spec in ("auto", "fsdp"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            eng, plan = make_engine(cfg, dev, strategy=spec,
                                    batch=SS_BATCH,
                                    max_len=SS_PROMPT + SS_NEW,
                                    seed=SEED, verbose=True)
            eng.generate_static(prompts, 2)
            prefill_ms, step_ms = _timed_static(eng, prompts, SS_NEW, dev)
            out, wall, counts = _counted_static(
                eng, prompts, SS_NEW, _static_expect(cfg, SS_NEW),
                f"SS3 {spec}")
            launches = {k: launches[k] + counts[k] for k in launches}
            gens = out[:, SS_PROMPT:]
            r = dict(plan=str(plan.precision), mesh=mesh_shape(plan.mesh),
                     compute_dtype=str(eng.rt.compute_dtype),
                     prefill_ms=prefill_ms, decode_step_ms=step_ms,
                     tok_s=SS_BATCH * SS_NEW / wall,
                     agreement_with_ss1=float((gens == ss1).mean()))
            if spec == "auto":
                ref = ServeEngine(cfg, tfm.init_params(cfg, SEED, dev),
                                  Runtime(compute_dtype=eng.rt.compute_dtype,
                                          rwkv_chunk=16),
                                  max_len=SS_PROMPT + SS_NEW, device=dev)
                same = np.array_equal(
                    ref.generate_static(prompts, SS_NEW)[:, SS_PROMPT:],
                    gens)
                del ref
                check(same, "SS3 auto: tokens differ from the unsharded "
                            "engine at the plan's dtypes")
            else:
                check(np.array_equal(gens, ss1),
                      "SS3 fsdp: tokens differ from SS1's")
                r["decode_step_peak_bytes"] = _decode_step_peak(
                    eng, prompts, dev, base)
            print(f"[SS3] --strategy {spec}: {plan.precision} on mesh "
                  f"{mesh_shape(plan.mesh)}, prefill {prefill_ms:.2f} ms, "
                  f"{step_ms:.3f} ms a decode step, {r['tok_s']:.1f} tok/s; "
                  f"tokens agree with SS1's at {r['agreement_with_ss1']:.4f}"
                  f"; on {card}")
            res[spec] = r
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutdown()
    res["launches"] = launches
    return res


def _decode_step_peak(eng, prompts, dev, base):
    """Bytes allocated at the peak of one decode step of ``eng`` after a
    prefill (its logits freed), above ``base``."""
    with torch.no_grad():
        lg, cache = eng._prefill(eng.params, {"tokens": torch.as_tensor(
            prompts, device=dev)})
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        del lg
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        eng._step(eng.params, cache, tok, torch.tensor(
            SS_PROMPT, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        del cache, tok
    return peak


def static_dryrun_phase(card, measured_peak):
    """D3: the dry run of SS3's ``fsdp`` decode step (one fake rank, fake
    tensors on the card, the kernel path) against its measured peak, then
    ``qwen3-0.6b x decode_32k`` on the pod topology (256 fake ranks)."""
    cfg = get_config("qwen3-0.6b")
    shape = ShapeConfig("chip_smoke", SS_PROMPT + SS_NEW, SS_BATCH, "decode")
    rec = dryrun.lower_fresh(cfg, shape, strategy.parse("fsdp"),
                             strategy.host_topology(n_devices=1),
                             device="cuda")
    mem = rec["memory"]
    tracked = mem["peak_bytes_per_device"]
    rel = abs(tracked - measured_peak) / measured_peak
    print(f"[D3] fsdp decode step B{SS_BATCH} x {SS_PROMPT + SS_NEW} slots "
          f"on one fake rank (traced in {rec['trace_s']} s): tracked peak "
          f"{tracked / 2**30:.4f} GiB ("
          + ", ".join(f"{k[:-6]} {v / 2**30:.4f}" for k, v in mem.items()
                      if k != "peak_bytes_per_device")
          + f" GiB; cache {rec['cache_bytes_per_device']} B) vs the step's "
          f"measured {measured_peak / 2**30:.4f} GiB: rel {rel:.3g} (tol "
          f"{D3_MEM_REL}); on {card}")
    check(rel <= D3_MEM_REL,
          f"D3 dry-run peak {tracked} B vs measured {measured_peak} B")
    t0 = time.perf_counter()
    pod = dryrun.run_one("qwen3-0.6b", "decode_32k", False, DRYRUN_OUT,
                         device="cuda")
    check(pod["status"] == "ok" and pod["n_devices"] == 256
          and pod.get("cache_bytes_per_device"),
          f"pod decode dry run: {pod.get('status')} {pod.get('error')}")
    print(f"[D3] qwen3-0.6b x decode_32k on pod ({pod['strategy']}, cache "
          f"axes {pod['plan']['decode_cache_axes']}) in "
          f"{time.perf_counter() - t0:.1f} s: peak/dev "
          f"{pod['memory']['peak_bytes_per_device'] / 2**30:.4f} GiB, cache "
          f"{pod['cache_bytes_per_device'] / 2**30:.4f} GiB, collective bytes "
          f"{pod['collective_bytes_total']:.4g}")
    return dict(d3=dict(memory=mem, measured_peak_bytes=measured_peak,
                        rel=rel, trace_s=rec["trace_s"],
                        cache_bytes_per_device=rec["cache_bytes_per_device"],
                        collectives=rec["collectives"]), pod=pod)


def _ss4_rank(rank, port, out_dir, device_type="cuda"):
    """One rank of SS4 (a spawned process on the card, gloo for every
    collective: NCCL cannot put two ranks of one card in a
    communicator): SS1's prompts through ``generate_static`` under
    SS4_SPEC at SS4_LAYERS layers, then teacher-forced logits along the
    one-process run's tokens, gathered whole, against its logits."""
    import datetime
    dev = torch.device(device_type, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=SS4_TIMEOUT_S // 2))
    try:
        ref = np.load(Path(out_dir, "ref.npz"))
        cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                                  n_layers=SS4_LAYERS)
        prompts = _static_prompts(cfg.vocab_size, SS_BATCH, SS_PROMPT)
        max_len = SS_PROMPT + SS4_NEW
        shape = ShapeConfig("chip_smoke", max_len, SS_BATCH, "decode")
        plan = strategy.parse(SS4_SPEC).to_plan(
            cfg, strategy.host_topology(), shape, device_type=dev.type)
        rt = par.make_runtime(cfg, plan, shape)
        params = par.apply_plan(tfm.init_params(cfg, seed=SEED, device=dev),
                                plan, cfg)
        eng = ServeEngine(cfg, params, rt, max_len=max_len, plan=plan,
                          device=dev)
        eng.generate_static(prompts, 2)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = eng.generate_static(prompts, SS4_NEW)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        tokens = ref["tokens"]
        worst, scale = 0.0, float(np.abs(ref["logits"]).max())
        with torch.no_grad():
            lg, cache = eng._prefill(params, {"tokens": torch.as_tensor(
                prompts, device=dev)})
            k = cache["layers"][0]["kv"]["k"]
            for t in range(SS4_NEW):
                whole = eng._whole_logits(lg[:, -1]).cpu().numpy()
                worst = max(worst, float(np.abs(whole - ref["logits"][:, t])
                                         .max()))
                if t + 1 < SS4_NEW:
                    lg, cache = eng._step(params, cache, torch.as_tensor(
                        tokens[:, t:t + 1], device=dev), SS_PROMPT + t)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(dict(
            tokens=out[:, SS_PROMPT:].tolist(), launches=counts,
            logits_max_abs_err=worst, logits_scale=scale,
            k_local_shape=list(k.shape), cache_shard=rt.cache_shard,
            tp_size=rt.tp_size)))
    finally:
        dist.destroy_process_group()


def static_tp_phase(dev, card):
    """SS4: SS4_LAYERS layers of qwen3-0.6b at full width under SS4_SPEC in
    two processes sharing the card over gloo: the sequence-sharded cache,
    the cross-rank merge and the k/v gathers on the card; tokens equal a
    one-process static run of the same model, logits within SS4_LOGIT_REL
    of its scale.  No time is meaningful (two processes time-slice one
    card)."""
    import multiprocessing
    import socket
    import tempfile
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=SS4_LAYERS)
    prompts = _static_prompts(cfg.vocab_size, SS_BATCH, SS_PROMPT)
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    eng = ServeEngine(cfg, params, Runtime(), max_len=SS_PROMPT + SS4_NEW,
                      device=dev)
    gens = eng.generate_static(prompts, SS4_NEW)[:, SS_PROMPT:]
    logits = static_logits(cfg, params, Runtime(), prompts, gens, dev)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ss4")
    np.savez(Path(out_dir, "ref.npz"), tokens=gens,
             logits=logits.cpu().numpy())
    del eng, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_ss4_rank, args=(r, port, out_dir, dev.type))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.time() + SS4_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    check(codes == [0, 0], f"SS4 ranks exited with {codes} (None: still "
                           f"running after {SS4_TIMEOUT_S} s)")
    ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
             for r in range(2)]
    expect = _static_expect(cfg, SS4_NEW)
    launches = {k: 0 for k in ops.launch_counts()}
    for r, got in enumerate(ranks):
        check(got["launches"] == expect,
              f"SS4 rank {r} launches {got['launches']} != {expect}")
        check(np.array_equal(np.asarray(got["tokens"]), gens),
              f"SS4 rank {r}: tokens differ from the one-process run")
        rel = got["logits_max_abs_err"] / got["logits_scale"]
        check(rel <= SS4_LOGIT_REL, f"SS4 rank {r}: logits differ by "
                                    f"{rel:.3g} of their scale")
        check(got["k_local_shape"][1] == (SS_PROMPT + SS4_NEW) // 2
              and got["tp_size"] == 2,
              f"SS4 rank {r}: cache shard {got['k_local_shape']}")
        launches = {k: launches[k] + got["launches"][k] for k in launches}
    print(f"[SS4] {SS4_SPEC} at {SS4_LAYERS} layers in 2 processes (gloo) "
          f"in {time.perf_counter() - t0:.1f} s: tokens equal one "
          f"process's; logits max |diff| "
          + " / ".join(f"{g['logits_max_abs_err']:.3g}" for g in ranks)
          + f" of scale {ranks[0]['logits_scale']:.3g}; KV slots per rank "
          f"{ranks[0]['k_local_shape'][1]} of {SS_PROMPT + SS4_NEW} (shards "
          f"{[g['cache_shard'] for g in ranks]}); on {card}")
    return dict(card=card, ranks=ranks, launches=launches)


def static_rwkv_phase(dev, card):
    """SS2: rwkv6-1.6b at full width and depth, f32, served statically (a
    prefill from a zero state through the chunked form, then ``wkv_step``
    per token: no kernel launches), its decode logits against the
    teacher-forced training forward on the kernel path (24 WKV-6
    launches)."""
    cfg = get_config("rwkv6-1.6b")
    prompts = _static_prompts(cfg.vocab_size, SS2_BATCH, SS2_PROMPT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    rt = Runtime(rwkv_chunk=SS_RWKV_CHUNK)
    eng = ServeEngine(cfg, params, rt, max_len=SS2_PROMPT + SS2_NEW,
                      device=dev)
    eng.generate_static(prompts, 2)
    prefill_ms, step_ms = _timed_static(eng, prompts, SS2_NEW, dev)
    out, wall, counts = _counted_static(
        eng, prompts, SS2_NEW, _static_expect(cfg, SS2_NEW, ()), "SS2")
    gens = out[:, SS2_PROMPT:]
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    steps = static_logits(cfg, params, rt, prompts, gens, dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        tf = tfm.forward(cfg, params, {"tokens": torch.as_tensor(
            out[:, :-1], device=dev)}, rt)[:, SS2_PROMPT - 1:].float()
    tf_counts = ops.launch_counts()
    check(tf_counts["wkv6"] == cfg.n_layers,
          f"SS2 teacher-forced forward: {tf_counts}")
    worst = (steps - tf).abs().max().item()
    agree = (steps.argmax(-1) == tf.argmax(-1)).float().mean().item()
    # what rounding alone moves: the plain forward against itself with its
    # WKV outputs perturbed by a relative WKV_NOISE_REL (reported, not held)
    plain = Runtime(attn_impl="torch", norm_impl="torch",
                    rwkv_chunk=SS_RWKV_CHUNK)
    toks = torch.as_tensor(out[:, :-1], device=dev)
    with torch.no_grad():
        tfp = tfm.forward(cfg, params, {"tokens": toks}, plain)[
            :, SS2_PROMPT - 1:].float()
        with wkv_output_noise(WKV_NOISE_REL, dev):
            tfn = tfm.forward(cfg, params, {"tokens": toks}, plain)[
                :, SS2_PROMPT - 1:].float()
    floor = (tfp - tfn).abs().max().item()
    kernel_plain = (tf - tfp).abs().max().item()
    scale = tf.abs().max().item()
    del tfp, tfn
    print(f"[SS2] {cfg.name} B{SS2_BATCH} prompt {SS2_PROMPT} +{SS2_NEW} "
          f"greedy (f32, static): prefill {prefill_ms:.2f} ms, {step_ms:.3f} "
          f"ms a decode step, {SS2_BATCH * SS2_NEW / wall:.1f} tok/s, peak "
          f"{peak:.3f} GiB; static decode vs the teacher-forced forward "
          f"({tf_counts['wkv6']} WKV-6 launches): max |logits diff| "
          f"{worst:.3g} (bar max({SS2_LOGIT_ATOL}, {FLOOR_FACTOR} x the "
          f"floor below); logits' scale {scale:.3g}), "
          f"greedy agreement {agree:.4f}; teacher-forced kernel vs plain "
          f"{kernel_plain:.3g}; plain vs itself with its WKV outputs "
          f"perturbed by a relative {WKV_NOISE_REL:g}: {floor:.3g}; on "
          f"{card}")
    bar = max(SS2_LOGIT_ATOL, FLOOR_FACTOR * floor)
    check(worst <= bar, f"SS2 logits differ by {worst:.3g} (bar {bar:.3g})")
    check(agree >= MIN_AGREEMENT, f"SS2 agreement {agree:.4f}")
    del eng, params, steps, tf
    gc.collect()
    torch.cuda.empty_cache()
    return dict(card=card, batch=SS2_BATCH, prompt=SS2_PROMPT, new=SS2_NEW,
                prefill_ms=prefill_ms, decode_step_ms=step_ms,
                tok_s=SS2_BATCH * SS2_NEW / wall, peak_mem_gib=peak,
                launches=counts, teacher_forced_launches=tf_counts,
                logits_max_abs_err=worst, greedy_agreement=agree,
                logits_scale=scale, kernel_vs_plain=kernel_plain,
                wkv_noise_floor=floor)


# ---------------------------------------------------------------------------

SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:24"),
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:33"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:36, :147-153"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:60"),
    "flash_attention_dq": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                           "src/repro/kernels/flash_attention.py:102"),
    "flash_attention_dkv": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:134"),
    "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6.py:24"),
}
# the case each kernel's line reports, f32 throughout: the serving path's
# decode shape (the RMSNorm forward's training rows are printed beside it),
# the training paths' norm rows, attention shape and WKV-6 shape
REPORTED = {"rmsnorm": dict(shape="(8,1024)"),
            "rmsnorm_bwd": dict(shape="(4096,1024)"),
            "flash_decode": dict(n_splits=4, long_ctx=False),
            "flash_attention": dict(timed=True),
            "flash_attention_dq": dict(timed=True),
            "flash_attention_dkv": dict(timed=True),
            "wkv6": dict(timed=True)}


# the bf16 case of each kernel: the training rows for the RMSNorm forward
REPORTED_BF16 = dict(REPORTED, rmsnorm=dict(shape="(4096,1024)"))


def kernels_line(rows, launches, launches_bf16, card):
    """One entry per kernel at its f32 reported case, with a ``bf16``
    entry of the same keys at its bf16 case (launches: the strategy
    phase's bf16 launches)."""
    def pick(mine, dtype, reported):
        return next(r for r in mine if r["dtype"] == dtype and all(
            r.get(k) == v for k, v in reported.items()))

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    out = []
    for name, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["name"] == name]
        rep = pick(mine, "float32", REPORTED[name])
        b16 = pick(mine, "bfloat16", REPORTED_BF16[name])
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine
                               if r["dtype"] == "float32"),
            **{k: rep[k] for k in keys}, "dtype": "float32",
            "shape": rep["shape"], "card": card,
            "bf16": {"launches": launches_bf16[name],
                     "max_abs_err": max(r["max_abs_err"] for r in mine
                                        if r["dtype"] == "bfloat16"),
                     **{k: b16[k] for k in keys}, "shape": b16["shape"]}})
    return {"kernels": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="also write every measurement as JSON here")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    took = build.build_all(verbose=True)
    print(f"[build] {took} -> {build.BUILD_DIR} in "
          f"{time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    with torch.no_grad():
        rows = rmsnorm_phase(dev, flush, gen)
        rows += rmsnorm_bwd_phase(dev, flush, gen)
        rows += flash_decode_phase(dev, flush, gen)
        rows += flash_phase(dev, flush, gen)
        rows += wkv6_phase(dev, flush, gen)
        tp_rows = tp_kernels_phase(dev, flush, gen)
    del flush
    print(f"[kernels] ok in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    served = serve_phase(dev)
    print(f"[serve] ok in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    n_norm, L = 2 * cfg.n_layers + 1, cfg.n_layers
    trained = train_phase(
        dev, card, cfg, TRAIN_STEPS, AdamWConfig().lr, Runtime(),
        Runtime(attn_impl="torch", norm_impl="torch"),
        {"rmsnorm": n_norm, "rmsnorm_bwd": n_norm, "flash_decode": 0,
         "flash_attention": L,
         "flash_attention_dq": L, "flash_attention_dkv": L, "wkv6": 0},
        TRAIN_BATCH, "train")
    print(f"[train] ok in {time.perf_counter() - t0:.1f}s")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    strat = strategy_phase(
        dev, card, {"rmsnorm": n_norm, "rmsnorm_bwd": n_norm,
                    "flash_decode": 0, "flash_attention": L,
                    "flash_attention_dq": L, "flash_attention_dkv": L,
                    "wkv6": 0})
    print(f"[strategy] host train/dispatch per step: "
          f"{strat['host_span_s']['dispatch'] * 1e3:.1f} ms under "
          f"{strat['spec']} (FSDP2, bf16) vs "
          f"{trained['host_span_s']['dispatch'] * 1e3:.1f} ms unsharded f32")
    print(f"[strategy] ok in {time.perf_counter() - t0:.1f}s")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ck1 = ck1_phase(
        dev, card, {"rmsnorm": n_norm, "rmsnorm_bwd": n_norm,
                    "flash_decode": 0, "flash_attention": L,
                    "flash_attention_dq": L, "flash_attention_dkv": L,
                    "wkv6": 0})
    print(f"[CK1] ok in {time.perf_counter() - t0:.1f}s")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = dryrun_phase(card, strat["peak_mem_bytes"])
    print(f"[dryrun] ok in {time.perf_counter() - t0:.1f}s")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    piped = pipeline_phase(card)
    print(f"[pipeline] ok in {time.perf_counter() - t0:.1f}s")

    # free the qwen3 phase's tensors before the larger model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg = get_config("rwkv6-1.6b")
    rwkv_trained = train_phase(
        dev, card, cfg, RWKV_STEPS, RWKV_LR, Runtime(rwkv_chunk=RWKV_CHUNK),
        Runtime(attn_impl="torch", norm_impl="torch", rwkv_chunk=RWKV_CHUNK),
        {k: 0 for k in ops.launch_counts()} | {"wkv6": cfg.n_layers},
        RWKV_CHECK_BATCH, "rwkv6", floor=WKV_NOISE_REL)
    rwkv_trained["shallow"] = grad_check(
        dev, dataclasses.replace(cfg, n_layers=RWKV_SHALLOW_LAYERS),
        Runtime(rwkv_chunk=RWKV_CHUNK),
        Runtime(attn_impl="torch", norm_impl="torch", rwkv_chunk=RWKV_CHUNK),
        RWKV_CHECK_BATCH, "rwkv6")
    print(f"[rwkv6] ok in {time.perf_counter() - t0:.1f}s")

    # static serving from dense caches, after the training phases' cells
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ss1 = static_phase(dev, card)
    print(f"[SS1] ok in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ss3 = static_plan_phase(dev, card, ss1["tokens"])
    print(f"[SS3] ok in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    d3 = static_dryrun_phase(card, ss3["fsdp"]["decode_step_peak_bytes"])
    print(f"[D3] ok in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ss4 = static_tp_phase(dev, card)
    print(f"[SS4] ok in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ss2 = static_rwkv_phase(dev, card)
    print(f"[SS2] ok in {time.perf_counter() - t0:.1f}s")

    # each kernel's launches on the main paths: the serve phase's run plus
    # each train phase's run and each static serving run, each counted
    # from 0
    launches = {k: served["launches"][k] + trained["launches"][k]
                + strat["launches"][k] + strat["fp8"]["launches"][k]
                + ck1["launches"][k]
                + piped["launches"][k] + rwkv_trained["launches"][k]
                + ss1["launches"][k] + ss3["launches"][k]
                + ss4["launches"][k] + ss2["launches"][k]
                for k in trained["launches"]}
    line = kernels_line(rows, launches, strat["launches_bf16"], card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": rows, "kernels_tp": tp_rows,
             "serve": served,
             "train": trained, "train_strategy": strat, "dryrun": dry,
             "checkpoint_ck1": ck1,
             "train_pipeline": piped,
             "train_rwkv6": rwkv_trained, "static_ss1": ss1,
             "static_ss2": ss2, "static_ss3": ss3, "static_ss4": ss4,
             "dryrun_d3": d3, "build_s": took,
             "total_s": time.perf_counter() - t_start}, indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
