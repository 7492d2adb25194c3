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
              at B 8, ctx 4096, with its device time; then at
              granite-20b's heads (H 48 over Kv 1: three head tiles of
              16), qwen2-1.5b's (H 12 over Kv 2), deepseek-moe-16b's (H
              16 over Kv 16: G 1) and dbrx-132b's (H 48 over Kv 8: G 6),
              at both contexts.  At
              the training shape it also times ``attention_delta``, prints
              dq + dk/dv + delta against SDPA's backward, and names the
              kernels SDPA's backward ran; the same at h2o-danube-1.8b's
              training shape (B 8, S 512, H 32, Kv 8, head dim 80), with
              and without a window of 128.  Then the flash forward, dq,
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
   CK1      — checkpointing and resilience: qwen3-0.6b at full width cut
              to 4 of its 28 layers (the script's time), f32, under
              ``fsdp`` on the 1-rank NCCL mesh (every
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
              directory (a 2.6 GB checkpoint, two while keep 1 commits),
              which it removes.
   D2       — (in the pods phase) the port's dry run (``launch.dryrun.
              lower_one`` in a fresh process on a fake process group of
              one rank, fake tensors on the card, the kernel path) of the
              strategy phase's plan at its shape; its tracked peak must
              lie within 10 % of the strategy phase's
              ``max_memory_allocated``; and ``qwen3-0.6b x train_4k`` on
              the pod topology (256 fake ranks) must trace and record a
              census and the resilience block.
7. pipeline — qwen3-0.6b at full width cut to 8 of its 28 layers (the
              script's time), f32, in two spawned
              processes sharing the one card (pipe 2, 4 layers a rank, 2
              a chunk under ``1f1b_i2``; data and model groups of one rank
              on NCCL, the pipe group on gloo: activations and cotangents
              cross through host memory, ``pipe_via_host``), B 8 x S 512,
              4 microbatches: ``gpipe``, ``1f1b``, ``1f1b_i2`` and ``zb``,
              2 AdamW steps each from the same seed through the train
              CLI's functions.  Per rank and schedule: the ops run equal
              its column of the table; the most microbatch graphs held
              equal the table's (over the ranks ``inflight_microbatches``);
              launches per step exact (4 x 4 flash forwards, dq and dk/dv,
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
11. D3      — (in the pods phase) the dry run of SS3's ``fsdp`` decode
              step (fake tensors on the card): its tracked peak within
              D3_MEM_REL of the measured one; and ``qwen3-0.6b x
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
14. Q2      — qwen2-1.5b at full width and depth (28 layers, 12 heads
              over Kv 2, qkv bias), f32: the serve phase's 12 requests
              through the paged engine (flash-decode at G 6, launches
              exact, teacher forcing kernel vs plain); B 8 prompts of 128
              + 32 greedy tokens through ``generate_static`` (launches
              exact, teacher-forced logits kernel vs plain) and the paged
              engine, whose tokens must equal the static ones, every
              one; 4 AdamW steps of 8 x 512 (lr warmed up over
              the 4 to 5e-5: DENSE_LR), launches exact, losses finite and
              falling, then kernel vs plain gradients at 2 x 512.
15. H1      — h2o-danube-1.8b at full width and depth (24 layers, head dim
              80, window 4096), f32: Q2's training on the head-dim-80
              flash kernels; then one request of 4,200 tokens (past the
              window) + 32 greedy tokens through the static engine (a ring
              of 4,096 slots, the prefill on the windowed flash forward)
              and the paged engine (the window mask on the plain path, as
              the reference gates flash-decode), held as in Q2.
16. G1      — granite-20b at full width (d 6144, 48 heads over Kv 1, d_ff
              24576, layernorm, GELU, sinusoidal positions) cut to 4
              layers (52 hold 81 GB of f32 weights), f32: Q2's serving
              (flash-decode at G 48); 6 AdamW steps under ``fsdp`` on the
              1-rank NCCL mesh (lr warmed up to 1e-5: G1_LR), launches
              exact, losses finite and falling; kernel vs plain gradients
              at 2 x 512; the dry run of that plan against its
              ``max_memory_allocated`` within 10 % and its pod dry run,
              D4, run with the others at the end.
17. M1      — deepseek-moe-16b at full width (d 2048, 16 heads over Kv
              16, 64 experts top 6 with 2 shared, the dense first layer of
              d_ff 10944) cut to 4 layers (28 hold 262 GB of f32 training
              state), f32: Q2's serving (flash-decode at G 1) and static
              vs paged; 4 unplanned AdamW steps (the dense dispatch: B S E
              = 2**18), launches exact; kernel vs plain gradients; 4 steps
              under ``fsdp`` on the 1-rank NCCL mesh (the dropping
              dispatch); the dry run of that plan against its measured
              peak within 10 % (at the end, with the others).
18. M2      — dbrx-132b at full width (d 6144, 48 heads over Kv 8, 16
              experts top 4) cut to 2 layers: Q2's serving (flash-decode
              at G 6) and static vs paged; kernel vs plain gradients of
              one forward and backward at 1 layer, B 2 x 512 (its f32
              training state does not fit one card: no steps).
19. E1      — ``fsdp_ep2`` on deepseek-moe-16b at 4 layers in two
              processes sharing the card over gloo (NCCL cannot hold two
              ranks of one card): the expert all-to-all on the card; the
              first loss within 1e-5 relative and every gradient within
              1e-4 of its scale of one process's dropping step with 2
              dispatch groups, the gradients read from AdamW's first
              moment after one ``make_train_step``; every MoE layer took
              the all-to-all (``DISPATCH_STATS``).  Correctness only.
20. MT1     — ``fsdp_tp2`` on deepseek-moe-16b at full width and 4 layers
              in two processes sharing the card over gloo: each rank routes
              every token and runs 32 of the 64 experts (stacks [32, 2048,
              1408]), the combine reduce-scattered over the model axis
              once a MoE layer; one ``make_train_step``: loss within 1e-5
              and every gradient (AdamW's first moment) within 1e-4 of
              scale of one process's dropping step.
21. MP1     — ``fsdp_pp2_mb2_1f1b`` on dbrx-132b at full width and 2 layers:
              the dry run of each pipe rank's train step on the card
              (with remat: each stage's layers checkpointed), its peak
              printed.  A stage's step needs more than the card
              holds, so no pair trains it here; the pipelined aux is held
              against the JAX package on the CPU.
22. C1      — ``fsdp_cp2`` on qwen3-0.6b at full width and 4 layers in two
              processes over gloo: a ``make_train_step`` at B 4 x S 1024
              (each rank its half of every sequence, the offset flash
              launches counted exactly) against one process's; then
              static serving of B 8 x 128 + 32 greedy tokens, every token
              one process's; then rwkv6-1.6b at full width and 4 layers
              under ``fsdp_cp2`` (each rank's time mix scanning the whole
              gathered sequence on its 16 heads through the WKV-6 kernel,
              its channel mix shifting across the split): one
              ``make_train_step`` at B 4 x S 512 against one process's at
              the rwkv6 phase's rule (loss 1e-4; the gradient errors'
              median and max within 1e-3 or 4x their move under a 1e-7
              perturbation of one process's RWKV-6 products), its 4 WKV-6
              launches and 8 sequence gathers a rank exact.
              The kernel phase (K-CP) holds the three flash kernels at a
              query offset (B 4, 512 rows at q0 0 and 512 against 1024
              keys) against their plain versions, each timed beside its
              bound and SDPA with an explicit boolean mask.
23. AU1     — musicgen-medium at full width and depth (48 layers, d 1536,
              24 heads of 64, layernorm, GELU, sinusoidal positions; f32):
              ``generate_static`` of 8 token prompts (codec tokens) of 128
              + 64 greedy tokens (the paged engine refuses the arch, as
              the JAX gate does), launches exact, its logits and tokens
              against the teacher-forced training forward (kernel and
              plain); a prefill of 128 frame embeddings and 8 decode steps
              that each take a frame embedding (``decode_step(extra=)``)
              against the forward over all 136 embeddings; 4 steps of
              ``make_train_step`` under ``fsdp`` on the 1-rank NCCL mesh on
              B 8 x S 512 frame embeddings (the head-dim-64 flash kernels'
              launches exact, the unused token table decayed as AdamW
              decays a leaf with a zero gradient), the peak; kernel vs
              plain loss and gradients at B 2 x S 512.  The kernel phase
              (K-D64) holds the three flash kernels at musicgen's shape (B
              8, S 512, H 24, Kv 24, D 64; timed beside their bounds and
              SDPA), a ragged S and a G 2 case.
24. VL1     — qwen2-vl-2b at full width and depth (28 layers, d 1536, 12
              heads over Kv 2, qkv bias, M-RoPE (16, 24, 24), tied; f32):
              the same static serving of text prompts (M-RoPE's t = h = w
              fallback); a prefill of 256 vision embeddings (a 16 x 16
              patch grid at t 0) and 64 text tokens with their 3-D
              position ids, then 8 decode steps, against the forward over
              the whole stream; 4 ``make_train_step`` steps of B 8 x S
              512 in that layout, and kernel vs plain gradients.
25. J1      — jamba-v0.1-52b at full width (d 4096, 32 heads over Kv 8,
              d_ff 14336, 16 experts top 2, d_state 16, d_conv 4, expand
              2, dt_rank 256, vocab 65536; f32).  Serving at 8 of its 32
              layers (one period: Mamba on 0-6, attention on 7, MoE on 1,
              3, 5, 7): ``generate_static`` of B 4 prompts of 128 + 32
              greedy tokens (the paged engine refuses the hybrid), the
              RMSNorm and flash-forward launches exact; its decode logits
              against the teacher-forced forward on the kernel and the
              plain path (LOGIT_ATOL, MIN_AGREEMENT); the prefill's and a
              decode step's wall time with the selective scan's share
              (CUDA events around every scan).  Training at 2 layers with
              attention every 2nd (Mamba + dense SwiGLU, attention + the
              16-expert MoE): 4 ``make_train_step`` steps under ``fsdp``
              on the 1-rank NCCL mesh at B 4 x S 512 (lr warmed up to
              DENSE_LR), launches exact, losses finite and falling, the
              scan's share of a step; then kernel vs plain loss and
              gradients at B 2 x 512 within 1e-4 of scale; its plan's dry
              run (in the pods phase) within 10 % of the measured peak.
26. RM1     — block remat (``Runtime.remat``; every measured step above
              runs without it, as the train CLIs do).  (a) qwen3-0.6b at
              full width and depth under ``fsdp`` on the 1-rank NCCL mesh,
              f32, at B 8 x S 512 and at B 2 x S 4096 (the largest B
              whose step fits the card without remat): from the same
              weights and batch a forward and backward and then 4 AdamW
              steps with remat off and on, each on weights of its own:
              launches exact (remat adds each layer's two RMSNorm
              forwards and its flash forward, rerun in the backward),
              losses equal within 1e-4, every gradient within 1e-4 of
              its scale of the step without remat; each run's
              ``max_memory_allocated`` and step p50 printed, and at S 4096
              the remat peak must lie below the one without.  Both remat
              steps' dry runs (in the pods phase, with remat) within 10 %
              of their measured peaks.  (b) J1's training config (one
              block of 2 layers) under ``fsdp``: a forward and backward
              with remat and with remat + ``remat_inner`` against one
              without, launches exact, gradients at the same bar.
27. pods    — every dry run, each in a process of its own, all at once:
              the full-depth points on the pod topology (256 fake ranks,
              each through the dry-run CLI), each of which must trace: D2's
              and D3's (above); D4 ``granite-20b x
              train_4k`` (52 layers); D5 ``deepseek-moe-16b x train_4k``
              (28 layers) under ``fsdp_ep8``, its census holding the
              expert all-to-all; D6 ``qwen2-1.5b x train_4k`` under
              ``fsdp_tp8`` (context attention) and ``dbrx-132b x
              train_4k`` under what ``--strategy auto`` ranks first; D7
              ``musicgen-medium`` and ``qwen2-vl-2b x train_4k`` (both
              resolve tp 16 to context attention); D8 ``jamba-v0.1-52b``
              (32 layers) x train_4k under what ``--strategy auto`` ranks
              first and x long_500k on the pod layout.  The pod points
              are traced as the JAX dry run lowers them: a train shape
              with remat, whose recompute gathers K and V (D6, D7) and
              dispatches every MoE layer (D5) again; D6's dbrx-132b and
              D8's jamba x train_4k under ``auto`` print their peak,
              parameter and optimizer bytes beside the planner's
              ``memory_per_device``.  MP1's two stages are traced with
              remat too.  Beside them the plans of D2, D3, G1, M1, AU1
              and VL1 (D7), J1 and RM1 are traced at their shapes, one
              fake rank each, against the steps' measured peaks (RM1's
              with remat, the others without).
28. R1      — the roofline against the card: the schema check
              (``python -m repro_torch.telemetry``) over the JSONL
              streams and Chrome traces that the serve phases (S1, Q2,
              H1, G1, M1, M2) and the strategy phase wrote under
              ``results/telemetry_torch``, exit 0; the three-term
              roofline (``perf/roofline.py`` on the cost model's H100
              profile) of every pod point above, each term finite and
              positive; for each measured step with a one-rank trace (D2
              = the strategy phase's T5, G1, M1, AU1, VL1, J1) the terms
              at its own shape and precision on one H100, its p50, the
              share of its roofline it reaches (roofline step / p50; over
              1.0 fails) and its measured MFU (6ND / p50 / 990e12); the
              report (``python -m repro_torch.perf.report``) over this
              run's records, exit 0, into ``results/EXPERIMENTS_torch.md``.
29. X1      — the four examples' ``main`` in this process on the card:
              ``torch_quickstart`` (reduced qwen3 trained 60 steps under
              ``fsdp``, then served by the paged engine),
              ``torch_train_100m --steps 60 --ckpt_every 30``,
              ``torch_serve_batched`` (reduced jamba from dense caches)
              and ``torch_parallelism_explorer``; each one's launches
              exact (RMSNorm forward and backward and the flash kernels
              at head dim 64 a layer a step, flash-decode a layer a
              decode step, the static prefill's flash forward).
30. report  — one JSON line listing every kernel (its f32 case, and a
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
from repro_torch.configs import (SHAPES, ShapeConfig, get_config,  # noqa: E402
                                 reduced)
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
from repro_torch.launch import specs as specs_lib  # noqa: E402
from repro_torch.launch.mesh import init_distributed, shutdown  # noqa: E402
from repro_torch.launch.train import drift_monitor  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import mamba as mamba_lib  # noqa: E402
from repro_torch.models import rwkv6 as rwkv_lib  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import Runtime  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.optim.schedule import linear_warmup_cosine  # noqa: E402
from repro_torch.perf import flops as flops_lib  # noqa: E402
from repro_torch.perf import roofline  # noqa: E402
from repro_torch.perf.comms import total_bytes  # noqa: E402
from repro_torch.resilience import (FaultPlan, SupervisorConfig,  # noqa: E402
                                    supervise_training)
from repro_torch.serve import ServeEngine, init_paged_pools  # noqa: E402
from repro_torch.strategy.topology import mesh_shape  # noqa: E402
from repro_torch.train import (TrainConfig, make_train_step,  # noqa: E402
                               train_loop)
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
CK_LAYERS = 4                       # of qwen3's 28: a 2.6 GB state
CK_MIN_FREE = 16e9                  # two checkpoints while keep 1
#                                     commits the next
DRYRUN_MEM_REL = 0.10
DRYRUN_OUT = "results/dryrun_torch"   # the pod dry run's record
TELEMETRY_OUT = "results/telemetry_torch"   # the serve and strategy
#                                             phases' JSONL and traces
REPORT_OUT = "results/EXPERIMENTS_torch.md"
# pipeline phase: qwen3-0.6b at full width and PIPE_LAYERS, f32, in two
# processes on the one card (pipe 2; data and model groups of one rank on
# NCCL, the pipe group on gloo through host memory), each schedule from
# the same seed; the first step's loss within 1e-5 relative and every
# gradient within 1e-4 of its scale of the unpipelined f32 step on the
# card (the port's f32 bar)
PIPE_SCHEDULES = ("gpipe", "1f1b", "1f1b_i2", "zb")
PIPE_STAGES, PIPE_MICROBATCHES, PIPE_STEPS = 2, 4, 2
PIPE_LAYERS = 8                     # of qwen3's 28 (the script's time)
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
                                                   200, 33), H=16, Kv=8):
    """D 128, bs 16: by default qwen3's serving shape (H 16, Kv 8), ragged
    ctx up to 320 (a full table of 20 blocks); permuted pool blocks, -1
    table tails."""
    D, bs = 128, 16
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


# (model, splits, long context, decode_case arguments): qwen3's serving
# shape (its splits 4 row is reported), then B 8 at ctx 4096 (256 blocks,
# 268 MB of f32 K/V); at splits 12 each CTA of a cluster of 4 takes 3
# splits.  Then granite-20b's heads (H 48 over Kv 1: three head tiles of
# 16, each its own cluster), qwen2-1.5b's (H 12 over Kv 2, G 6),
# deepseek-moe-16b's (H 16 over Kv 16, G 1) and dbrx-132b's (H 48 over Kv
# 8, G 6), at the same batch and contexts
LONG = dict(B=8, nb=256, ctx=(4096,) * 8)
GRANITE_HEADS, QWEN2_HEADS = dict(H=48, Kv=1), dict(H=12, Kv=2)
DEEPSEEK_HEADS, DBRX_HEADS = dict(H=16, Kv=16), dict(H=48, Kv=8)
DECODE_CASES = [("qwen3", (1, 2, 4, 12), False, {}),
                ("qwen3", (4, 12), True, LONG),
                ("granite", (4, 12), False, GRANITE_HEADS),
                ("granite", (4,), True, dict(LONG, **GRANITE_HEADS)),
                ("qwen2", (4,), False, QWEN2_HEADS),
                ("qwen2", (4,), True, dict(LONG, **QWEN2_HEADS)),
                ("deepseek", (4,), False, DEEPSEEK_HEADS),
                ("deepseek", (4,), True, dict(LONG, **DEEPSEEK_HEADS)),
                ("dbrx", (4,), False, DBRX_HEADS),
                ("dbrx", (4,), True, dict(LONG, **DBRX_HEADS))]


def flash_decode_phase(dev, flush, gen):
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for model, splits_list, long_ctx, kw in DECODE_CASES:
            case = decode_case(dev, dtype, gen, **kw)
            rows += [dict(r, case=model) for r in decode_rows(
                dev, flush, dtype, case, splits_list, long_ctx)]
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
        print(f"[kernels] flash_decode {dt} H{H} Kv{Kv} {ctx_s} "
              f"splits={n_splits}: "
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


def visible_pairs(S, window, Sk=None, q0=0):
    """(query, key) pairs a causal (windowed) attention computes per head:
    S query rows at positions q0.. against Sk keys (default S)."""
    n = (q0 + torch.arange(1, S + 1)).clamp(max=Sk or S)
    if window:
        n = n.clamp(max=window)
    return int(n.sum())


# B, S, H, Kv, D, window, timed: qwen3's training shape (timed; the
# reported row), then ragged S, a sliding window and MQA (checked, not
# timed); then h2o-danube-1.8b's training shape at head dim 80 (timed),
# with a window that bites at that length (timed), and ragged S; then
# K-D64: musicgen-medium's training shape at head dim 64 (timed; the
# reported row of the ``_d64`` kernels), ragged S, and the reduced
# qwen2-vl's G 2 (Kv 2)
FLASH_CASES = [(8, 512, 16, 8, 128, 0, True), (2, 300, 16, 8, 128, 0, False),
               (2, 300, 16, 8, 128, 128, False),
               (2, 512, 16, 1, 128, 0, False),
               (8, 512, 32, 8, 80, 0, True), (8, 512, 32, 8, 80, 128, True),
               (2, 300, 32, 8, 80, 0, False),
               (8, 512, 24, 24, 64, 0, True), (2, 300, 24, 24, 64, 0, False),
               (2, 512, 4, 2, 64, 0, False)]
FLASH_REPORTED = "B8 S512 H16 Kv8 D128 causal window0"
FLASH_D64_REPORTED = "B8 S512 H24 Kv24 D64 causal window0"
D64_KERNELS = tuple(fa.counter_name(k, 64) for k in fa.KERNELS)


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
    errs = {fa.counter_name("flash_attention", D): max(e_o, e_lse),
            fa.counter_name("flash_attention_dq", D):
                (dq - dq0).abs().max().item(),
            fa.counter_name("flash_attention_dkv", D):
                max((dk - dk0).abs().max().item(),
                    (dv - dv0).abs().max().item())}
    return q, k, v, do, o0, args, errs, shape


def flash_bounds(dtype, B, S, H, Kv, D, window, Sk=None, q0=0):
    """-> ({kernel: (bound ms, bound by)}, {kernel: notes}) of the flash
    forward, dq and dk/dv at one shape (S query rows at positions q0..
    against Sk keys, by default self-attention), keyed by the kernels'
    base names (``fa.KERNELS``)."""
    isz = torch.tensor([], dtype=dtype).element_size()
    pairs = visible_pairs(S, window, Sk, q0) * B * H
    q_bytes, kv_bytes = B * S * H * D * isz, B * (Sk or S) * Kv * D * isz
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
        for B, S, H, Kv, D, window, timed in FLASH_CASES:
            q, k, v, do, o0, args, errs, shape = flash_case(
                dev, gen, dtype, B, S, H, Kv, D, window)
            dt = str(dtype).split(".")[-1]
            base = dict(dtype=dt, shape=shape, timed=timed)
            if not timed:
                rows += [dict(base, name=n, max_abs_err=e)
                         for n, e in errs.items()]
                continue
            bounds, notes = flash_bounds(dtype, B, S, H, Kv, D, window)
            qs, ks, vs, dos = (t.transpose(1, 2).contiguous()
                               for t in (q, k, v, do))
            # SDPA takes the causal window as a boolean mask
            mask = None if not window else (
                lambda i: (i[None] <= i[:, None])
                & (i[None] > i[:, None] - window))(
                    torch.arange(S, device=dev))
            sdpa_kw = (dict(is_causal=True) if mask is None
                       else dict(attn_mask=mask))
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, enable_gqa=True, **sdpa_kw), flush, 20)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (qs, ks, vs)]
                out = F.scaled_dot_product_attention(
                    *leaves, enable_gqa=True, **sdpa_kw)
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
            for base_name, (kern, plain, lib, lib_what) in timings.items():
                bnd, by = bounds[base_name]
                name = fa.counter_name(base_name, D)
                row = dict(base, name=name, max_abs_err=errs[name],
                           ms=time_ms(kern, flush, 20),
                           plain_ms=time_ms(plain, flush, 20),
                           library_ms=lib, bound_ms=bnd, bound_by=by,
                           sdpa_forward_ms=lib_fwd,
                           sdpa_backward_ms=lib_bwd)
                row.update(notes.get(base_name, {}))
                arith = "".join(f"; {k} {v:.5f} ms" if isinstance(v, float)
                                else f"; {v}"
                                for k, v in notes.get(base_name,
                                                      {}).items())
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


def serve_expect(cfg, forward_calls, decode_steps):
    """Launches of a paged run on the kernel path: 2L + 1 RMSNorms per
    forward (none for a layernorm stack), L flash-decodes per decode step
    (none with a sliding window: the plain path, as the reference's
    gate)."""
    out = {k: 0 for k in ops.launch_counts()}
    if cfg.norm == "rmsnorm":
        out["rmsnorm"] = (2 * cfg.n_layers + 1) * forward_calls
    if not cfg.sliding_window:
        out["flash_decode"] = cfg.n_layers * decode_steps
    return out


def telemetry_recorder(tag):
    """A recorder streaming its events as JSONL and writing a Chrome trace
    under TELEMETRY_OUT (``<tag>.jsonl``, ``<tag>_trace.json`` on close),
    for R1's schema check."""
    return tel.Recorder(sinks=[
        tel.JsonlSink(os.path.join(TELEMETRY_OUT, f"{tag}.jsonl")),
        tel.ChromeTraceSink(os.path.join(TELEMETRY_OUT, f"{tag}_trace.json"),
                            process_name=f"chip_smoke {tag}")])


def serve_phase(dev, cfg=None, tag="serve", params=None):
    """``cfg`` (qwen3-0.6b by default) serves 12 requests over 8 slots
    through the paged engine on the kernels, launches exact; then teacher
    forcing, kernel vs plain.  ``params``, when given, are freed by the
    caller."""
    cfg = cfg or get_config("qwen3-0.6b")
    n_req, n_slots, n_new, chunk, bs = 12, 8, 48, 32, 16
    rng = np.random.default_rng(SEED)
    lens = rng.integers(17, 201, n_req)
    lens[:2] = (17, 200)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lens]
    t0 = time.perf_counter()
    if params is None:
        params = tfm.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, f32 weights from seed "
          f"{SEED} in {time.perf_counter() - t0:.1f}s")
    kw = dict(max_len=int(lens.max()) + n_new, n_slots=n_slots,
              block_size=bs, prefill_chunk=chunk, steps_per_tick=8,
              device=dev)
    rt = Runtime()                             # the kernel path
    warm = ServeEngine(cfg, params, rt, **kw)  # first-call costs, untimed
    warm.generate(np.stack([prompts[0][:17]] * 2), 8)
    del warm

    rec = telemetry_recorder(tag)
    eng = ServeEngine(cfg, params, rt, telemetry=rec, **kw)
    rids = [eng.submit(p, n_new) for p in prompts]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained(seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec.close()
    counts = ops.launch_counts()
    fwd, steps = eng.stats["forward_calls"], eng.stats["decode_steps"]
    expect = serve_expect(cfg, fwd, steps)
    print(f"[{tag}] {fwd} forward calls ({steps} decode steps); launches "
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
    print(f"[{tag}] {n_req * n_new} tokens in {wall:.3f}s = "
          f"{res['tok_s']:.1f} tok/s; TTFT p50 {res['ttft_p50_ms']:.2f} ms "
          f"p99 {res['ttft_p99_ms']:.2f} ms; per-token p50 "
          f"{res['token_p50_ms']:.3f} ms p99 {res['token_p99_ms']:.3f} ms")

    t0 = time.perf_counter()
    with torch.no_grad():
        worst, agree, served = teacher_forced(cfg, params, prompts, gens, dev,
                                              chunk, bs)
    print(f"[{tag}] teacher forcing ({time.perf_counter() - t0:.1f}s): max "
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
              expect_bf16=None, rec=None, drift=None, batch=TRAIN_BATCH):
    """Train ``params`` for ``tc.steps`` steps through ``train_loop`` (under
    ``plan`` when given, recording to ``rec`` and feeding ``drift`` when
    given) on seeded synthetic batches of ``batch`` x TRAIN_SEQ; launch
    counts zeroed just before and read just after, held to ``expect`` per
    step (and the bf16 launches to ``expect_bf16``); losses finite and
    falling.  -> the run's measurements; frees the run's tensors."""
    steps = tc.steps
    n_params = sum(p.numel() for p in params.parameters())
    batches = Batcher(SyntheticSource(cfg.vocab_size, seed=SEED), TRAIN_SEQ,
                      batch)
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
               batch=batch, seq_len=TRAIN_SEQ, losses=losses,
               step_s=steps_s, step_p50_s=p50, host_span_s=host,
               tok_s=batch * TRAIN_SEQ / p50, wall_s=wall,
               peak_mem_gib=peak / 2 ** 30, peak_mem_bytes=peak,
               launches=counts,
               launches_bf16=bf16, compute_dtype=str(rt.compute_dtype))
    print(f"[{tag}] {cfg.name} ({n_params / 1e9:.3f} B parameters) "
          f"{str(rt.compute_dtype).split('.')[-1]} compute, "
          f"{batch}x{TRAIN_SEQ} tokens/step: loss {losses[0]:.4f} -> "
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
        rt = par.make_runtime(cfg, plan, shape, remat=False)
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
        rec = telemetry_recorder("strategy")
        drift = drift_monitor(cfg, strat, planned, topo, shape, rec)
        res = run_steps(dev, card, cfg, rt, tc, params, expect,
                        "strategy", plan=plan, expect_bf16=expect, rec=rec,
                        drift=drift)
        rec.close()
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


def ck_cfg():
    """CK1's model: qwen3-0.6b at full width cut to CK_LAYERS layers."""
    return dataclasses.replace(get_config("qwen3-0.6b"), n_layers=CK_LAYERS)


def ck1_phase(dev, card, expect):
    """Cell CK1: qwen3-0.6b at full width cut to CK_LAYERS layers (the
    script's time: the whole depth took ~120 s of save, restore and
    CRC), f32, under ``fsdp`` on
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
    cfg = ck_cfg()
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
        rt = par.make_runtime(cfg, plan, shape, remat=False)
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
                cfg, strat, topo, shape, tc_b, batches,
                rt_overrides=dict(remat=False), seed=SEED,
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


def d2_case(strat_res):
    """Cell D2: the strategy phase's plan at its shape (``fsdp_bf16``, B
    TRAIN_BATCH x S TRAIN_SEQ, the host topology as one fake rank, the
    kernel path) for :func:`plan_traces`, against the phase's
    ``torch.cuda.max_memory_allocated`` within DRYRUN_MEM_REL (traced in
    the pods phase, with ``qwen3-0.6b x train_4k`` on the pod:
    :func:`d2_report`)."""
    return (get_config("qwen3-0.6b"),
            ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train"),
            STRATEGY_SPEC, strat_res["peak_mem_bytes"], None, DRYRUN_MEM_REL)


def d2_report(trace, pod):
    """D2's pod point: ``qwen3-0.6b x train_4k`` on the pod topology (256
    fake ranks) must trace and record a census and the resilience
    block."""
    check(pod["collectives"] and "resilience" in pod,
          f"pod dry run: {pod.get('status')} {pod.get('error')}")
    print(f"[dryrun] qwen3-0.6b x train_4k on pod ({pod['strategy']}, "
          f"{pod['n_devices']} fake ranks) in {pod['wall_s']:.1f} s: "
          f"peak/dev {pod['memory']['peak_bytes_per_device'] / 2**30:.2f} "
          f"GiB, collective bytes {pod['collective_bytes_total']:.4g}")
    return dict(d2=trace, pod=pod)


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
    rt = par.make_runtime(cfg, plan, shape, remat=False)
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
    return {k: 0 for k in ops.launch_counts()} | {
        "rmsnorm": norms, "rmsnorm_bwd": norms, "flash_attention": n,
        "flash_attention_dq": n, "flash_attention_dkv": n}


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
        cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                                  n_layers=PIPE_LAYERS)
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
            rt = par.make_runtime(cfg, plan, shape, remat=False,
                                  pipe_via_host=True)
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


@contextlib.contextmanager
def product_noise(rel, dev):
    """Within the block, every product of an RWKV-6 layer (``rwkv6._mm``:
    its projections, LoRAs and channel mix) is multiplied by (1 + rel *
    N(0, 1)) (seeded): the rounding a plan changes where it splits those
    products over the model axis and sums their parts."""
    exact = rwkv_lib._mm
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def noisy(a, w, dt):
        y = exact(a, w, dt)
        eps = torch.randn(y.shape, generator=gen, device=y.device,
                          dtype=y.dtype)
        return y * (1 + rel * eps)

    rwkv_lib._mm = noisy
    try:
        yield
    finally:
        rwkv_lib._mm = exact


def grad_rel_err(name, grads, ref):
    """The error of gradient ``name`` relative to its scale in ``ref``; but
    a key bias's (``...mixer.bk``) gradient is zero but for rounding
    (adding bk adds q·bk to every score of a query, which its softmax
    ignores), so it is measured against the scale of the query bias's
    gradient beside it."""
    if not name.endswith(".mixer.bk"):
        return rel_err(grads[name], ref[name])
    scale = ref[name[:-2] + "bq"].abs().max().clamp_min(1e-30)
    return ((grads[name] - ref[name]).abs().max() / scale).item()


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
    rels = {name: grad_rel_err(name, grads_k, grads_p) for name in grads_k}
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


def attn_layers(cfg):
    """The layers of ``cfg`` that mix by attention (all of an attention
    stack's; jamba-v0.1-52b's every 8th)."""
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def _static_expect(cfg, n_new, kinds=("rmsnorm", "flash_attention")):
    """Launches of one ``generate_static`` (1 prefill + n_new - 1 decode
    steps) on the kernel path: 2L + 1 RMSNorms per forward (none for a
    layernorm stack), a flash forward per attention layer in the prefill,
    nothing else."""
    out = {k: 0 for k in ops.launch_counts()}
    if "rmsnorm" in kinds and cfg.norm == "rmsnorm":
        out["rmsnorm"] = (2 * cfg.n_layers + 1) * n_new
    if "flash_attention" in kinds:
        out[fa.counter_name("flash_attention", cfg.head_dim_)] = \
            attn_layers(cfg)
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


def d3_case(ss3):
    """D3: SS3's ``fsdp`` decode step (B SS_BATCH, SS_PROMPT + SS_NEW
    slots, one fake rank, the kernel path) for :func:`plan_traces`,
    against its measured peak within D3_MEM_REL (traced in the pods
    phase, with ``qwen3-0.6b x decode_32k`` on the pod:
    :func:`d3_report`)."""
    return (get_config("qwen3-0.6b"),
            ShapeConfig("chip_smoke", SS_PROMPT + SS_NEW, SS_BATCH,
                        "decode"),
            "fsdp", ss3["fsdp"]["decode_step_peak_bytes"], None, D3_MEM_REL)


def d3_report(trace, pod):
    """D3's pod point: ``qwen3-0.6b x decode_32k`` on the pod topology
    (256 fake ranks) must trace with its caches."""
    check(pod.get("cache_bytes_per_device"),
          f"pod decode dry run: {pod.get('status')} {pod.get('error')}")
    print(f"[D3] qwen3-0.6b x decode_32k on pod ({pod['strategy']}, cache "
          f"axes {pod['plan']['decode_cache_axes']}) in "
          f"{pod['wall_s']:.1f} s: peak/dev "
          f"{pod['memory']['peak_bytes_per_device'] / 2**30:.4f} GiB, cache "
          f"{pod['cache_bytes_per_device'] / 2**30:.4f} GiB, collective bytes "
          f"{pod['collective_bytes_total']:.4g}")
    return dict(d3=trace, pod=pod)


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

# ---------------------------------------------------------------------------
# phases 14-16: the dense extensions (Q2, H1, G1) and the granite dry runs
# ---------------------------------------------------------------------------

DENSE_STEPS = 4                     # AdamW steps of each dense training run
# peak lr of those runs, reached by a linear warmup over all of them.
# After one warmup step Adam's first update (every weight moved by about
# the lr) sent these wide models from random weights up the loss on an
# H100: h2o-danube-1.8b at 3e-4 10.80 -> 14.71 -> 12.86 -> 14.41 (gradient
# norm 140 at step 2), granite-20b's 4 layers at 1e-4 11.34 -> 22.71 ->
# 13.77 -> 12.22 (gradient norm 134)
DENSE_LR = 5e-5
DENSE_CHECK_BATCH = 2               # kernel vs plain gradients, 2 x 512
DENSE_PROMPT, DENSE_NEW = 128, 32   # static vs paged tokens, B SS_BATCH
H1_PROMPT, H1_NEW = 4200, 32        # past h2o-danube-1.8b's window of 4096
H1_CHUNK = 512                      # the paged engine's prefill chunk there
G1_LAYERS = 4                       # granite-20b: 52 layers hold 81 GB f32
G1_SPEC = "fsdp"                    # f32 on the 1-rank NCCL mesh
# granite-20b climbs the loss even at DENSE_LR's ramp (11.34 -> 15.37 ->
# 11.51 -> 11.45, gradient norm 138 at step 2), on the kernel and the
# plain path alike (the same losses to 4 decimals on an H100): the model's
# own response to Adam's first updates.  At 1e-5 over 6 steps it falls
# (11.34 -> 10.23, one climb at step 3).
G1_LR, G1_STEPS = 1e-5, 6
G1_MEM_REL = 0.10


def train_expect(cfg):
    """Launches of one f32 train step on the kernel path: 2L + 1 RMSNorm
    forwards and backwards (none for a layernorm stack), one each of the
    flash forward, dq and dk/dv per attention layer."""
    out = {k: 0 for k in ops.launch_counts()}
    if cfg.norm == "rmsnorm":
        out["rmsnorm"] = out["rmsnorm_bwd"] = 2 * cfg.n_layers + 1
    for k in fa.KERNELS:
        out[fa.counter_name(k, cfg.head_dim_)] = attn_layers(cfg)
    return out


def add_launches(*runs):
    """The sum of several runs' launch counts, kernel by kernel."""
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def static_vs_paged(dev, card, cfg, params, prompts, n_new, tag,
                    paged_kw=None):
    """One ``generate_static`` of ``prompts`` on the kernel path (launches
    exact), its teacher-forced logits kernel vs plain (LOGIT_ATOL,
    MIN_AGREEMENT), and the paged engine's tokens on the same prompts,
    which must equal the static ones, every one."""
    B, S = prompts.shape
    eng = ServeEngine(cfg, params, Runtime(), max_len=S + n_new, device=dev)
    out, wall, counts = _counted_static(eng, prompts, n_new,
                                        _static_expect(cfg, n_new), tag)
    gens = out[:, S:]
    check(bool(((gens >= 0) & (gens < cfg.vocab_size)).all()),
          f"{tag} static tokens out of range")
    plain = Runtime(attn_impl="torch", norm_impl="torch")
    lk = static_logits(cfg, params, Runtime(), prompts, gens, dev)
    lp = static_logits(cfg, params, plain, prompts, gens, dev)
    worst = (lk - lp).abs().max().item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    del lk, lp
    paged_eng = ServeEngine(cfg, params, Runtime(), max_len=S + n_new,
                            n_slots=B, device=dev, **(paged_kw or {}))
    ops.reset_launch_counts()
    paged = paged_eng.generate(prompts, n_new)[:, S:]
    torch.cuda.synchronize()
    paged_counts = ops.launch_counts()
    want = serve_expect(cfg, paged_eng.stats["forward_calls"],
                        paged_eng.stats["decode_steps"])
    check(paged_counts == want,
          f"{tag} paged launches {paged_counts} != {want}")
    same = float((paged == gens).mean())
    print(f"[{tag}] static B{B} prompt {S} +{n_new} greedy in {wall:.3f} s "
          f"(f32, kernel path): teacher forcing max |logits kernel - plain| "
          f"{worst:.3g} (tol {LOGIT_ATOL}), greedy agreement {agree:.4f}; "
          f"the paged engine's tokens equal the static ones at {same:.4f} "
          f"(bar 1.0); "
          f"paged launches {paged_counts}; on {card}")
    check(worst <= LOGIT_ATOL, f"{tag} static logits differ by {worst:.3g}")
    check(agree >= MIN_AGREEMENT, f"{tag} greedy agreement {agree:.4f}")
    check(same == 1.0, f"{tag} paged tokens differ from the static ones: "
          f"{same:.4f} equal")
    del eng, paged_eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(batch=B, prompt=S, new=n_new, wall_s=wall,
                launches=add_launches(counts, paged_counts),
                logits_max_abs_err=worst, greedy_agreement=agree,
                paged_equal=same, tokens=gens.tolist(),
                paged_tokens=paged.tolist())


def dense_serve(dev, card, cfg, tag):
    """Paged serving (:func:`serve_phase`), then static vs paged
    (:func:`static_vs_paged`) of ``cfg`` at full width, f32, one set of
    weights."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    res = serve_phase(dev, cfg, tag, params)
    prompts = _static_prompts(cfg.vocab_size, SS_BATCH, DENSE_PROMPT)
    res["static"] = static_vs_paged(dev, card, cfg, params, prompts,
                                    DENSE_NEW, tag)
    res["launches"] = add_launches(res["launches"],
                                   res["static"]["launches"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def dense_train(dev, card, cfg, tag):
    """DENSE_STEPS AdamW steps of ``cfg`` at full width, f32, B TRAIN_BATCH
    x S TRAIN_SEQ through ``train_loop`` on the kernels (launches exact,
    losses finite and falling), then kernel vs plain gradients at
    DENSE_CHECK_BATCH x TRAIN_SEQ."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tc = TrainConfig(steps=DENSE_STEPS, warmup=DENSE_STEPS, log_every=1,
                     opt=AdamWConfig(lr=DENSE_LR))
    res = run_steps(dev, card, cfg, Runtime(), tc,
                    tfm.init_params(cfg, seed=SEED, device=dev),
                    train_expect(cfg), tag)
    res.update(grad_check(dev, cfg, Runtime(), Runtime(
        attn_impl="torch", norm_impl="torch"), DENSE_CHECK_BATCH, tag))
    return res


def q2_phase(dev, card):
    """Cell Q2: qwen2-1.5b at full width and depth (28 layers, 12 heads
    over Kv 2, qkv bias), f32: paged serving on flash-decode at G 6,
    static vs paged, training."""
    cfg = get_config("qwen2-1.5b")
    res = dense_serve(dev, card, cfg, "Q2")
    res["train"] = dense_train(dev, card, cfg, "Q2")
    res["launches"] = add_launches(res["launches"],
                                   res["train"]["launches"])
    return res


def h1_phase(dev, card):
    """Cell H1: h2o-danube-1.8b at full width and depth (24 layers, head
    dim 80, window 4096), f32: training on the head-dim-80 flash kernels;
    then one request of H1_PROMPT tokens, past the window, and H1_NEW
    greedy tokens through the static engine (its ring of 4096 slots; the
    prefill on the flash forward with the window) and the paged engine
    (the window mask, plain attention as the reference's gate)."""
    cfg = get_config("h2o-danube-1.8b")
    res = dict(train=dense_train(dev, card, cfg, "H1"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    prompts = _static_prompts(cfg.vocab_size, 1, H1_PROMPT)
    t0 = time.perf_counter()
    res["long"] = static_vs_paged(dev, card, cfg, params, prompts, H1_NEW,
                                  "H1", dict(prefill_chunk=H1_CHUNK))
    res["long"].update(
        phase_s=time.perf_counter() - t0,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        ring_slots=attn_lib.cache_slots(cfg, H1_PROMPT + H1_NEW))
    check(res["long"]["ring_slots"] == cfg.sliding_window,
          f"H1 ring of {res['long']['ring_slots']} slots")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["launches"] = add_launches(res["train"]["launches"],
                                   res["long"]["launches"])
    return res


def g1_phase(dev, card):
    """Cell G1: granite-20b at full width (d 6144, 48 heads over Kv 1,
    d_ff 24576, layernorm, GELU, sinusoidal positions) cut to G1_LAYERS
    layers, f32: paged serving on flash-decode at G 48 (three head tiles),
    static vs paged; training under G1_SPEC on the 1-rank NCCL mesh
    (``resolve`` -> ``to_plan`` -> ``apply_plan`` -> ``train_loop``),
    launches exact; kernel vs plain gradients (the dry run of that plan,
    :func:`g1_case`, and cell D4, its pod dry run at full depth, are
    traced by :func:`pod_phase`)."""
    cfg = dataclasses.replace(get_config("granite-20b"), n_layers=G1_LAYERS)
    res = dense_serve(dev, card, cfg, "G1")
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    init_distributed(dev)
    try:
        topo = strategy.host_topology()
        strat, _ = strategy.resolve(G1_SPEC, cfg, topo, shape)
        plan = strat.to_plan(cfg, topo, shape)
        rt = par.make_runtime(cfg, plan, shape, remat=False)
        check(rt.param_dtype == rt.compute_dtype == torch.float32,
              f"G1 runtime dtypes {rt}")
        tc = TrainConfig(steps=G1_STEPS, warmup=DENSE_STEPS, log_every=1,
                         opt=AdamWConfig(lr=G1_LR))
        params = par.apply_plan(tfm.init_params(cfg, seed=SEED, device=dev),
                                plan, cfg)
        res["placements"] = check_placements(cfg, plan, params)
        res["train"] = run_steps(dev, card, cfg, rt, tc, params,
                                 train_expect(cfg), "G1", plan=plan)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutdown()
    res["train"].update(spec=strat.format(), mesh=mesh_shape(plan.mesh))
    res["train"].update(grad_check(
        dev, cfg, Runtime(), Runtime(attn_impl="torch", norm_impl="torch"),
        DENSE_CHECK_BATCH, "G1"))
    res["launches"] = add_launches(res["launches"],
                                   res["train"]["launches"])

    return res


def g1_case(g1):
    """G1's training plan for :func:`plan_traces`: its dry run (a fresh
    process, fake tensors on the card) against the measured
    ``max_memory_allocated``, within G1_MEM_REL."""
    return (dataclasses.replace(get_config("granite-20b"),
                                n_layers=G1_LAYERS),
            ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train"),
            G1_SPEC, g1["train"]["peak_mem_bytes"], None, G1_MEM_REL)


def d4_report(pod):
    """Cell D4: ``granite-20b x train_4k`` at full depth on the pod
    topology (256 fake ranks), traced by :func:`pod_phase`."""
    check("resilience" in pod and pod["collectives"],
          f"D4 granite-20b pod dry run: {pod}")
    print(f"[D4] granite-20b x train_4k ({get_config('granite-20b').n_layers}"
          f" layers) on pod ({pod['strategy']}, {pod['n_devices']} fake "
          f"ranks) in {pod['wall_s']:.1f} s: peak/dev "
          f"{pod['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB, "
          f"collective bytes {pod['collective_bytes_total']:.4g}")
    return pod


# ---------------------------------------------------------------------------
# phases 17-20: mixture of experts (M1, M2), the expert all-to-all (E1), D5
# ---------------------------------------------------------------------------

M1_LAYERS = 4                       # deepseek-moe-16b: layer 0 dense + 3 MoE
M1_SPEC = "fsdp"                    # f32 on the 1-rank NCCL mesh: dropping
M2_LAYERS, M2_CHECK_LAYERS = 2, 1   # dbrx-132b: 31.0 GB at 2 layers, f32
M2_CHECK_BATCH = 2                  # its kernel vs plain gradients, 2 x 512
E1_SPEC = "fsdp_ep2"
E1_BATCH = 4                        # rows of E1's step (2 a rank)
E1_LOSS_REL, E1_GRAD_REL = 1e-5, 1e-4
D5_SPEC = "fsdp_ep8"


def _moe_cfg(arch, n_layers):
    return dataclasses.replace(get_config(arch), n_layers=n_layers)


def m1_phase(dev, card):
    """Cell M1: deepseek-moe-16b at full width cut to M1_LAYERS layers
    (the dense first layer and 3 MoE layers), f32: paged serving on
    flash-decode at G 1 and static vs paged; DENSE_STEPS unplanned AdamW
    steps (``auto``: the dense dispatch at B S E = 2**18) and kernel vs
    plain gradients; DENSE_STEPS steps under M1_SPEC on the 1-rank NCCL
    mesh (the plan's dropping dispatch), launches exact (the dry run of
    that plan, :func:`m1_case`, runs in :func:`pod_phase`)."""
    cfg = _moe_cfg("deepseek-moe-16b", M1_LAYERS)
    res = dense_serve(dev, card, cfg, "M1")
    res["train"] = dense_train(dev, card, cfg, "M1")
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    init_distributed(dev)
    try:
        strat, _ = strategy.resolve(M1_SPEC, cfg, strategy.host_topology(),
                                    shape)
        plan = strat.to_plan(cfg, strategy.host_topology(), shape)
        rt = par.make_runtime(cfg, plan, shape, remat=False)
        check(rt.moe_impl == "dropping" and rt.moe_groups == 1,
              f"M1 plan runtime: moe_impl {rt.moe_impl}, groups "
              f"{rt.moe_groups}")
        tc = TrainConfig(steps=DENSE_STEPS, warmup=DENSE_STEPS, log_every=1,
                         opt=AdamWConfig(lr=DENSE_LR))
        params = par.apply_plan(tfm.init_params(cfg, seed=SEED, device=dev),
                                plan, cfg)
        res["plan_train"] = run_steps(dev, card, cfg, rt, tc, params,
                                      train_expect(cfg), "M1", plan=plan)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutdown()
    res["plan_train"].update(spec=strat.format(), mesh=mesh_shape(plan.mesh))
    res["launches"] = add_launches(res["launches"],
                                   res["train"]["launches"],
                                   res["plan_train"]["launches"])
    return res


def m1_case(m1):
    """M1's planned training for :func:`plan_traces`, within G1_MEM_REL
    of its measured peak."""
    return (_moe_cfg("deepseek-moe-16b", M1_LAYERS),
            ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train"),
            M1_SPEC, m1["plan_train"]["peak_mem_bytes"], None, G1_MEM_REL)


def m2_phase(dev, card):
    """Cell M2: dbrx-132b at full width cut to M2_LAYERS layers, f32:
    paged serving on flash-decode at G 6 and static vs paged; then kernel
    vs plain gradients of one forward and backward at M2_CHECK_LAYERS
    layer(s), M2_CHECK_BATCH x TRAIN_SEQ (parameters and two sets of
    gradients; the f32 training state of even one layer, 71.9 GB before
    activations, leaves no room for AdamW on the card)."""
    cfg = _moe_cfg("dbrx-132b", M2_LAYERS)
    res = dense_serve(dev, card, cfg, "M2")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    res["grads"] = grad_check(
        dev, _moe_cfg("dbrx-132b", M2_CHECK_LAYERS), Runtime(),
        Runtime(attn_impl="torch", norm_impl="torch"), M2_CHECK_BATCH, "M2")
    res["grads"]["peak_mem_gib"] = \
        torch.cuda.max_memory_allocated(dev) / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _e1_batch(cfg):
    return next(iter(Batcher(SyntheticSource(cfg.vocab_size, seed=SEED),
                             TRAIN_SEQ, E1_BATCH)))


def _e1_rank(rank, port, out_dir, device_type="cuda"):
    """One rank of E1 (a spawned process on the card, gloo for every
    collective): one process's dropping step (2 dispatch groups) on the
    whole batch as the reference, then the first E1_SPEC train step on
    this rank's rows; every local gradient against the reference's cut of
    it."""
    dev = _pair_group(rank, port, device_type)
    try:
        cfg = _moe_cfg("deepseek-moe-16b", M1_LAYERS)
        batch = batch_to_device(_e1_batch(cfg), dev)
        ref_loss, ref = _reference(cfg, batch, dev, Runtime(
            moe_impl="dropping", moe_groups=2))
        got = _first_step(cfg, E1_SPEC, batch, dev)
        errs = _grad_errs(got["moments"], ref)
        worst = max(errs, key=errs.get)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(dict(
            loss=got["loss"], ref_loss=ref_loss,
            grad_rel_err_max=errs[worst], worst_leaf=worst,
            leaves=len(errs), dispatch=got["dispatch"],
            all_to_all=got["collectives"]["all_to_all"],
            launches=got["launches"],
            expert_local_shape=got["shapes"]["layers.1.ffn.w_up"],
            peak_mem_gib=got["peak_mem_gib"])))
    finally:
        dist.destroy_process_group()


def e1_phase(dev, card):
    """E1: E1_SPEC on deepseek-moe-16b at M1_LAYERS layers in two
    processes sharing the card over gloo: the dispatch and combine
    all-to-all, the router's statistics all-reduce and the expert units'
    reduction on the card; each rank's first train step (its loss the
    mean over the ranks) and its local gradients against one process's
    dropping step (2 dispatch groups, the two ranks' rows) computed in the
    rank itself.  No time is meaningful (two processes time-slice one
    card)."""
    cfg = _moe_cfg("deepseek-moe-16b", M1_LAYERS)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_e1")
    t0 = time.perf_counter()
    ranks = _pair("E1", _e1_rank, out_dir, dev.type)
    shutil.rmtree(out_dir, ignore_errors=True)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    expect = train_expect(cfg)
    for r, got in enumerate(ranks):
        rel = abs(got["loss"] - got["ref_loss"]) / abs(got["ref_loss"])
        check(rel <= E1_LOSS_REL, f"E1 rank {r}: loss {got['loss']} vs "
                                  f"{got['ref_loss']} ({rel:.3g} relative)")
        check(got["grad_rel_err_max"] <= E1_GRAD_REL,
              f"E1 rank {r}: gradient {got['worst_leaf']} differs by "
              f"{got['grad_rel_err_max']:.3g} of its scale")
        check(got["dispatch"]["ep_calls"] == n_moe
              and got["all_to_all"] == 4 * n_moe,
              f"E1 rank {r}: dispatch {got['dispatch']}, "
              f"{got['all_to_all']} all-to-alls")
        check(got["expert_local_shape"][0] == cfg.moe.n_experts // 2,
              f"E1 rank {r}: expert stack shard {got['expert_local_shape']}")
        check(got["launches"] == expect,
              f"E1 rank {r} launches {got['launches']} != {expect}")
    launches = add_launches(*(g["launches"] for g in ranks))
    print(f"[E1] {E1_SPEC} at {M1_LAYERS} layers in 2 processes (gloo) in "
          f"{time.perf_counter() - t0:.1f} s: loss {ranks[0]['loss']:.6f} vs "
          f"one process's {ranks[0]['ref_loss']:.6f}; gradients rel err "
          f"max " + " / ".join(f"{g['grad_rel_err_max']:.3g} "
                               f"({g['worst_leaf']})" for g in ranks)
          + f" (tol {E1_GRAD_REL}); each rank {n_moe} EP calls, "
          f"{ranks[0]['all_to_all']} all-to-alls, expert stacks "
          f"{ranks[0]['expert_local_shape']}; launches {launches}; "
          f"on {card}")
    return dict(card=card, ranks=ranks, launches=launches)


def d5_report(pod):
    """Cell D5: deepseek-moe-16b x train_4k at full depth (28 layers) on
    the pod topology (256 fake ranks) under D5_SPEC, traced by
    :func:`pod_phase`: the expert all-to-all in its census and every MoE
    layer's call on the all-to-all path."""
    cfg = get_config("deepseek-moe-16b")
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    a2a = pod.get("collectives", {}).get("all-to-all", {})
    # under remat the backward's recompute dispatches every MoE layer
    # again: its dispatch and combine exchanges a third time
    remat = pod["remat"]
    check(pod["plan"]["expert"] == "expert" and remat
          and pod["moe_dispatch"]["ep_calls"] == n_moe * (1 + remat)
          and a2a.get("count") == (4 + 2 * remat) * n_moe,
          f"D5 deepseek-moe-16b pod dry run: {pod.get('moe_dispatch')} "
          f"{a2a}")
    print(f"[D5] deepseek-moe-16b x train_4k ({cfg.n_layers} layers) on pod "
          f"({pod['strategy']}, mesh {pod['plan']['mesh']}, remat "
          f"{remat}) in "
          f"{pod['wall_s']:.1f} s: peak/dev "
          f"{pod['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB; "
          f"all-to-all {a2a['count']} x, {a2a['bytes']:.4g} B of "
          f"{pod['collective_bytes_total']:.4g} B collective bytes")
    return pod


# ---------------------------------------------------------------------------
# phases 21-25: the flash kernels at a query offset (K-CP), MoE under
# tensor (MT1) and pipeline (MP1) parallelism, context parallelism (C1),
# and the dry runs of the new compositions (D6)
# ---------------------------------------------------------------------------

# K-CP: C1's per-rank attention, B 4, S_loc 512 of Sk 1024, at q0 0 and 512
KCP_SHAPE = (4, 512, 1024, 16, 8, 128)        # B, S_loc, Sk, H, Kv, D
KCP_OFFSETS = (0, 512)
KCP_REPORTED = "B4 S512 Sk1024 H16 Kv8 D128 causal q0 512"
Q0_KERNELS = ("flash_attention_q0", "flash_attention_dq_q0",
              "flash_attention_dkv_q0")
MT1_SPEC, MT1_LAYERS, MT1_BATCH = "fsdp_tp2", 4, 2
MT1_LOSS_REL, MT1_GRAD_REL = 1e-5, 1e-4
# MP1: dbrx-132b's 2-layer pipeline at full width, traced by the dry run
# on the card.  Its pair does not run: a stage's train step holds ~96 GiB
# a rank (the dry run's reading: the stage's MoE layer, the embedding and
# head every pipe rank holds, FSDP2's unsharded copies, the gradients and
# AdamW's moments), past the card for one rank at any sequence length
MP1_SPEC, MP1_LAYERS, MP1_BATCH = "fsdp_pp2_mb2_1f1b", 2, 2
C1_SPEC, C1_LAYERS, C1_BATCH, C1_SEQ = "fsdp_cp2", 4, 4, 1024
C1_SERVE_B, C1_PROMPT, C1_NEW = 8, 128, 32
C1_LOSS_REL, C1_GRAD_REL = 1e-5, 1e-4
# C1's recurrent case: rwkv6-1.6b at full width cut to 4 layers under
# C1_SPEC, held to one process's step by the rwkv6 phase's rule: the loss
# within TRAIN_LOSS_ATOL, the gradient errors' median and maximum within
# TRAIN_GRAD_REL or FLOOR_FACTOR x their move under a WKV_NOISE_REL
# perturbation, here of one process's RWKV-6 products (``product_noise``:
# the rounding the plan changes, splitting them over the model axis).  Its
# backward amplifies f32 rounding: on an H100 layer 0's wk came 4.52e-3 of
# its scale from one process's step, where the WKV-output perturbation
# moves the gradients by 3.1e-4; ``cp_rounding.py`` (the CPU, B 4 x S
# 128) reads the two steps 4.69e-3 apart (median 2.36e-3) in f32 and
# 9.51e-8 in f64 (the f32 moments' own rounding), and a 1e-7
# perturbation of the products moving them by 5.87e-3 (2.86e-3)
C1_RWKV_LAYERS, C1_RWKV_BATCH = 4, 4
PAIR_TIMEOUT_S = 600
D6_POINTS = (("qwen2-1.5b", "fsdp_tp8"), ("dbrx-132b", "auto"))


def kcp_phase(dev, flush, gen):
    """K-CP: the flash forward, dq and dk/dv kernels with a query offset at
    C1's per-rank shape (KCP_SHAPE), q0 in KCP_OFFSETS, f32 and bf16,
    against their plain versions at the same offset (the forward also to
    its own bits on a second launch); each timed beside its plain version,
    its bound (``flash_bounds`` over the visible pairs of the offset rows)
    and SDPA with an explicit boolean mask of the same visibility (its
    ``is_causal`` is top-left aligned)."""
    B, S, Sk, H, Kv, D = KCP_SHAPE
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        q_all, do_all = (torch.randn(B, Sk, H, D, generator=gen, device=dev)
                         .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, Sk, Kv, D, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        for q0 in KCP_OFFSETS:
            q = q_all[:, q0:q0 + S].contiguous()
            do = do_all[:, q0:q0 + S].contiguous()
            o, lse = fa.forward_cuda(q, k, v, True, 0, q0)
            o2, lse2 = fa.forward_cuda(q, k, v, True, 0, q0)
            o0, lse0 = fa.forward_plain(q, k, v, True, 0, q0)
            delta = fa.attention_delta(o0, do)
            args = (q, k, v, do, lse0, delta, True, 0, q0)
            dq, (dk, dv) = fa.dq_cuda(*args), fa.dkv_cuda(*args)
            dq0, (dk0, dv0) = fa.dq_plain(*args), fa.dkv_plain(*args)
            torch.cuda.synchronize()
            e_o, ok = max_err(o, o0, dtype)
            e_lse = (lse - lse0).abs().max().item()
            rels = {"dq": rel_err(dq, dq0), "dk": rel_err(dk, dk0),
                    "dv": rel_err(dv, dv0)}
            shape = f"B{B} S{S} Sk{Sk} H{H} Kv{Kv} D{D} causal q0 {q0}"
            check(ok and e_lse <= 1e-5
                  and max(rels.values()) <= GRAD_REL_TOL[dtype],
                  f"K-CP {dt} {shape}: |do| {e_o:.3g}, |dlse| {e_lse:.3g},"
                  f" grads rel {rels} over tolerance")
            check(torch.equal(o, o2) and torch.equal(lse, lse2),
                  f"K-CP forward {dt} {shape}: a second launch gave other "
                  f"bits")
            errs = dict(zip(Q0_KERNELS, (
                max(e_o, e_lse), (dq - dq0).abs().max().item(),
                max((dk - dk0).abs().max().item(),
                    (dv - dv0).abs().max().item()))))
            bounds, notes = flash_bounds(dtype, B, S, H, Kv, D, 0, Sk, q0)
            qs, ks, vs, dos = (t.transpose(1, 2).contiguous()
                               for t in (q, k, v, do))
            i = torch.arange(Sk, device=dev)
            mask = i[None] <= (q0 + i[:S])[:, None]          # (S, Sk)
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True), flush, 20)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (qs, ks, vs)]
                out = F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask, enable_gqa=True)
                lib_bwd = time_ms(lambda: torch.autograd.grad(
                    out, leaves, dos, retain_graph=True), flush, 20)
            timings = dict(zip(Q0_KERNELS, (
                (lambda: fa.forward_cuda(q, k, v, True, 0, q0),
                 lambda: fa.forward_plain(q, k, v, True, 0, q0), lib_fwd),
                (lambda: fa.dq_cuda(*args), lambda: fa.dq_plain(*args),
                 lib_bwd),
                (lambda: fa.dkv_cuda(*args), lambda: fa.dkv_plain(*args),
                 lib_bwd))))
            for (name, (kern, plain, lib)), base in zip(
                    timings.items(), Q0_KERNELS):
                bnd, by = bounds[base.replace("_q0", "")]
                row = dict(name=name, dtype=dt, shape=shape, timed=True,
                           max_abs_err=errs[name],
                           ms=time_ms(kern, flush, 20),
                           plain_ms=time_ms(plain, flush, 20),
                           library_ms=lib, bound_ms=bnd, bound_by=by,
                           sdpa_masked_forward_ms=lib_fwd,
                           sdpa_masked_backward_ms=lib_bwd,
                           **notes[base.replace("_q0", "")])
                rows.append(row)
                print(f"[K-CP] {name} {dt} {shape}: err "
                      f"{errs[name]:.3g}; kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms, masked SDPA "
                      f"{'forward' if name == Q0_KERNELS[0] else 'backward'}"
                      f" {lib:.4f} ms, bound {bnd:.5f} ms ({by})")
    return rows


def _pair(tag, target, out_dir, *args):
    """Two spawned processes of ``target(rank, port, out_dir, *args)``
    sharing the card (gloo for every collective: NCCL cannot put two
    ranks of one card in one communicator) -> each rank's JSON record
    (``out_dir/rank<r>.json``); both must exit cleanly within
    PAIR_TIMEOUT_S, and none is left running."""
    import multiprocessing
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, port, out_dir, *args))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + PAIR_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    check(codes == [0, 0], f"{tag} ranks exited with {codes} (None: still "
                           f"running after {PAIR_TIMEOUT_S} s)")
    return [json.loads(Path(out_dir, f"rank{r}.json").read_text())
            for r in range(2)]


def _pair_group(rank, port, device_type):
    """This pair rank's device (the card; the host for a rehearsal) and
    its gloo group of 2."""
    import datetime
    dev = torch.device("cpu")
    if device_type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=PAIR_TIMEOUT_S // 2))
    return dev


def _reference(cfg, batch, dev, rt):
    """One process's loss and gradients of ``batch`` under ``rt``, the
    gradients held on the host (the planned step needs the card) and the
    model freed."""
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    loss, grads = loss_and_grads(cfg, params, batch, rt)
    grads = {n: g.cpu() for n, g in grads.items()}
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return loss, grads


def _first_step(cfg, spec, batch, dev):
    """This rank's first train step of ``batch`` under ``spec`` through
    the train CLI's functions: the plan, its runtime and the planned
    parameters as ``launch.train`` builds them, ``make_train_step`` and a
    fresh AdamW state without clipping, its counters set to 0 just before
    the step -> {'loss' (the step's global one), 'moments' ({leaf: AdamW's
    first moment: (1 - b1) x this rank's gradient, as the pipeline phase
    reads it}), 'shapes' (each leaf's local shape), 'launches',
    'dispatch', 'collectives', 'sites', 'rt', 'peak_mem_gib'}."""
    from repro_torch.core import expert as expert_lib
    from repro_torch.train.trainer import make_train_step
    B, S = batch["labels"].shape
    shape = ShapeConfig("chip_smoke", S, B, "train")
    plan = strategy.parse(spec).to_plan(cfg, strategy.host_topology(),
                                        shape, device_type=dev.type)
    rt = par.make_runtime(cfg, plan, shape, remat=False)
    params = par.apply_plan(tfm.init_params(cfg, seed=SEED, device=dev),
                            plan, cfg)
    step = make_train_step(cfg, rt, TrainConfig(
        steps=1, warmup=1, opt=AdamWConfig(grad_clip=0.0)), plan)
    state = init_opt_state(params)
    expert_lib.reset_dispatch_stats()
    layers.reset_collective_counts()
    ops.reset_launch_counts()
    _, state, metrics = step(params, state, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(
        loss=float(metrics["loss"]), moments=state["m"],
        shapes={n: list(m.to_local().shape) for n, m in state["m"].items()},
        launches=ops.launch_counts(),
        dispatch=expert_lib.dispatch_stats_snapshot(),
        collectives=dict(layers.COLLECTIVES),
        sites=dict(layers.COLLECTIVE_SITES), rt=rt,
        peak_mem_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                      if dev.type == "cuda" else None))


def _grad_errs(moments, ref):
    """{leaf: max |this rank's gradient (its first moment over 1 - b1) -
    the reference's cut of it| over the reference's scale}."""
    b1 = AdamWConfig().b1
    out = {}
    for name, m in moments.items():
        got = m.to_local() / (1 - b1)
        want = bridge._local_cut(ref[name], m).to(got.device)
        out[name] = float((got - want).abs().max()
                          / ref[name].abs().max().clamp_min(1e-30))
    return out


def _mt1_rank(rank, port, out_dir, device_type="cuda"):
    """One rank of MT1: one process's step (the plan's dropping dispatch,
    one group: every model rank routes the whole batch) as the reference,
    then MT1_SPEC's first train step on this rank's share of the
    experts."""
    dev = _pair_group(rank, port, device_type)
    try:
        cfg = _moe_cfg("deepseek-moe-16b", MT1_LAYERS)
        batch = batch_to_device(next(iter(Batcher(SyntheticSource(
            cfg.vocab_size, seed=SEED), TRAIN_SEQ, MT1_BATCH))), dev)
        ref_loss, ref = _reference(cfg, batch, dev, Runtime(
            moe_impl="dropping", moe_groups=1))
        got = _first_step(cfg, MT1_SPEC, batch, dev)
        errs = _grad_errs(got["moments"], ref)
        worst = max(errs, key=errs.get)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(dict(
            loss=got["loss"], ref_loss=ref_loss,
            grad_rel_err_max=errs[worst], worst_leaf=worst,
            leaves=len(errs), launches=got["launches"],
            dispatch=got["dispatch"], sites=got["sites"],
            tp_size=got["rt"].tp_size,
            expert_local_shape=got["shapes"]["layers.1.ffn.w_up"],
            peak_mem_gib=got["peak_mem_gib"])))
    finally:
        dist.destroy_process_group()


def mt1_phase(dev, card):
    """MT1: deepseek-moe-16b at full width cut to MT1_LAYERS layers, f32,
    under MT1_SPEC in two processes sharing the card over gloo: each rank
    routes the whole batch with the router whole and runs 32 of the 64
    experts (stacks [32, 2048, 1408]), its shared experts and attention
    heads split like a dense layer's, the partial outputs reduce-scattered
    along S (Megatron-SP).  One train step: each rank's loss within
    MT1_LOSS_REL of one process's dropping step, every local gradient
    within MT1_GRAD_REL of its scale; one combine over the model axis per
    MoE layer; launches exact.  No time is meaningful (two processes
    time-slice one card)."""
    cfg = _moe_cfg("deepseek-moe-16b", MT1_LAYERS)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mt1")
    t0 = time.perf_counter()
    ranks = _pair("MT1", _mt1_rank, out_dir, dev.type)
    shutil.rmtree(out_dir, ignore_errors=True)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    expect = train_expect(cfg)
    m = cfg.moe
    for r, got in enumerate(ranks):
        rel = abs(got["loss"] - got["ref_loss"]) / abs(got["ref_loss"])
        check(rel <= MT1_LOSS_REL, f"MT1 rank {r}: loss {got['loss']} vs "
                                   f"{got['ref_loss']} ({rel:.3g} relative)")
        check(got["grad_rel_err_max"] <= MT1_GRAD_REL,
              f"MT1 rank {r}: gradient {got['worst_leaf']} differs by "
              f"{got['grad_rel_err_max']:.3g} of its scale")
        check(got["expert_local_shape"] == [m.n_experts // 2, cfg.d_model,
                                            m.expert_d_ff],
              f"MT1 rank {r}: expert stacks {got['expert_local_shape']}")
        check(got["sites"]["moe_combine"] == n_moe
              and got["tp_size"] == 2,
              f"MT1 rank {r}: dispatch {got['dispatch']}, sites "
              f"{got['sites']}")
        check(got["launches"] == expect,
              f"MT1 rank {r} launches {got['launches']} != {expect}")
    launches = add_launches(*(g["launches"] for g in ranks))
    print(f"[MT1] {MT1_SPEC} deepseek-moe-16b at {MT1_LAYERS} layers, B"
          f"{MT1_BATCH} x S{TRAIN_SEQ}, one train step in 2 processes "
          f"(gloo) in {time.perf_counter() - t0:.1f} s: loss "
          f"{ranks[0]['loss']:.6f} vs one process's "
          f"{ranks[0]['ref_loss']:.6f}; gradients rel err max "
          + " / ".join(f"{g['grad_rel_err_max']:.3g} ({g['worst_leaf']})"
                       for g in ranks)
          + f" (tol {MT1_GRAD_REL}); expert stacks "
          f"{ranks[0]['expert_local_shape']} a rank; {n_moe} combines over "
          f"the model axis; peak "
          + " / ".join(f"{g['peak_mem_gib']:.2f}" for g in ranks)
          + f" GiB; launches {launches}; on {card}")
    return dict(card=card, ranks=ranks, launches=launches)


def mp1_phase(card):
    """MP1: dbrx-132b, the MoE config that pipelines (a uniform stack),
    under MP1_SPEC at full width and MP1_LAYERS layers, B MP1_BATCH x S
    TRAIN_SEQ, through the dry run on the card (a fake process group of
    two pipe ranks), each pipe rank's train step in a fresh process, both
    at once: each
    must trace, its MoE layer's dispatch recorded, and its peak is
    printed.  No pair of processes trains it here: one stage's step needs
    more than the card holds (the peak the dry run reads), so the
    pipelined aux is held against the JAX package on the CPU only
    (tests/test_torch_moe_pp.py)."""
    cfg = _moe_cfg("dbrx-132b", MP1_LAYERS)
    s = strategy.parse(MP1_SPEC)
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, MP1_BATCH, "train")
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    out = {"card": card, "card_gib": card_gib, "ranks": []}
    import concurrent.futures
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            s.pp, mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1) as ex:
        futs = [ex.submit(dryrun.lower_one, cfg, shape, s,
                          strategy.host_topology(n_devices=s.pp), rank=rank,
                          device="cuda") for rank in range(s.pp)]
        recs = [f.result(timeout=POD_TIMEOUT_S) for f in futs]
    for rank, rec in enumerate(recs):
        peaks = {k.replace("_bytes", ""): v / 2 ** 30
                 for k, v in rec["memory"].items()}
        check(peaks["peak_per_device"] > 0,
              f"MP1 pipe rank {rank}: memory record {peaks}")
        out["ranks"].append(dict(peaks_gib=peaks, trace_s=rec["trace_s"],
                                 remat=rec["remat"]))
        print(f"[MP1] dry run of {MP1_SPEC} on dbrx-132b at full width, "
              f"{MP1_LAYERS} layers, B{MP1_BATCH} x S{TRAIN_SEQ}, remat "
              f"{rec['remat']} (each stage's layers), pipe rank "
              f"{rank} of {s.pp} (fake) on the card in {rec['trace_s']} s, "
              "GiB: " + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
              + f" (the card holds {card_gib:.2f}); on {card}")
    return out


def _c1_expect(cfg, kinds):
    out = {k: 0 for k in ops.launch_counts()}
    out["rmsnorm"] = kinds["norms"]
    if "rmsnorm_bwd" in kinds:
        out["rmsnorm_bwd"] = kinds["rmsnorm_bwd"]
    for name in kinds.get("flash", ()):
        out[name] = cfg.n_layers
    return out


def _c1_rank(rank, port, out_dir, device_type="cuda"):
    """One rank of C1: one process's step on the whole batch as the
    reference, then C1_SPEC's first train step on this rank's half of
    every sequence; then static serving under C1_SPEC (its serving
    shape), the prompts' prefill split over the ranks."""
    dev = _pair_group(rank, port, device_type)
    try:
        cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                                  n_layers=C1_LAYERS)
        batch = batch_to_device(next(iter(Batcher(SyntheticSource(
            cfg.vocab_size, seed=SEED), C1_SEQ, C1_BATCH))), dev)
        ref_loss, ref = _reference(cfg, batch, dev, Runtime())
        got = _first_step(cfg, C1_SPEC, batch, dev)
        errs = _grad_errs(got["moments"], ref)
        worst = max(errs, key=errs.get)
        train = dict(loss=got["loss"], ref_loss=ref_loss,
                     grad_rel_err_max=errs[worst], worst_leaf=worst,
                     launches=got["launches"], sites=got["sites"],
                     context=got["rt"].context, tp_size=got["rt"].tp_size)
        del got, ref
        gc.collect()
        torch.cuda.empty_cache()
        max_len = C1_PROMPT + C1_NEW
        shape = ShapeConfig("chip_smoke", max_len, C1_SERVE_B, "decode")
        plan = strategy.parse(C1_SPEC).to_plan(
            cfg, strategy.host_topology(), shape, device_type=dev.type)
        srt = par.make_runtime(cfg, plan, shape)
        params = par.apply_plan(tfm.init_params(cfg, seed=SEED, device=dev),
                                plan, cfg)
        eng = ServeEngine(cfg, params, srt, max_len=max_len, plan=plan,
                          device=dev)
        prompts = _static_prompts(cfg.vocab_size, C1_SERVE_B, C1_PROMPT)
        layers.reset_collective_counts()
        ops.reset_launch_counts()
        with torch.no_grad():
            _, cache = eng._prefill(params, {"tokens": torch.as_tensor(
                prompts, device=dev)})
        k_local = list(cache["layers"][0]["kv"]["k"].shape)
        del cache
        ops.reset_launch_counts()
        out = eng.generate_static(prompts, C1_NEW)
        torch.cuda.synchronize()
        serve_launches = ops.launch_counts()
        serve_sites = dict(layers.COLLECTIVE_SITES)
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
        rcfg = dataclasses.replace(get_config("rwkv6-1.6b"),
                                   n_layers=C1_RWKV_LAYERS)
        rbatch = batch_to_device(next(iter(Batcher(SyntheticSource(
            rcfg.vocab_size, seed=SEED), TRAIN_SEQ, C1_RWKV_BATCH))), dev)
        ref_loss, ref = _reference(rcfg, rbatch, dev, Runtime())
        # the floor of its bars: how far one process's plain-path
        # gradients move when its products move by WKV_NOISE_REL
        plain = Runtime(attn_impl="torch", norm_impl="torch")
        _, pgrads = _reference(rcfg, rbatch, dev, plain)
        with product_noise(WKV_NOISE_REL, dev):
            _, ngrads = _reference(rcfg, rbatch, dev, plain)
        moved = [rel_err(ngrads[n], pgrads[n]) for n in pgrads]
        del pgrads, ngrads
        got = _first_step(rcfg, C1_SPEC, rbatch, dev)
        errs = _grad_errs(got["moments"], ref)
        worst = max(errs, key=errs.get)
        rwkv = dict(loss=got["loss"], ref_loss=ref_loss,
                    grad_rel_err_max=errs[worst], worst_leaf=worst,
                    grad_rel_err_median=statistics.median(errs.values()),
                    noise_grad_rel_err_max=max(moved),
                    noise_grad_rel_err_median=statistics.median(moved),
                    launches=got["launches"], sites=got["sites"],
                    context=got["rt"].context, tp_size=got["rt"].tp_size)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(dict(
            train=train, tokens=out[:, C1_PROMPT:].tolist(),
            serve_launches=serve_launches, serve_sites=serve_sites,
            k_local=k_local, cache_shard=srt.cache_shard, rwkv=rwkv,
            peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)))
    finally:
        dist.destroy_process_group()


def c1_phase(dev, card):
    """C1: qwen3-0.6b at full width cut to C1_LAYERS layers, f32, under
    C1_SPEC in two processes sharing the card over gloo.  Train: B
    C1_BATCH x S C1_SEQ, each rank its 512 positions of every row, K and V
    gathered over the model axis and its queries attended at q0 = 512
    rank through the flash kernels' offset launches (their ``_q0``
    counts exact; no self-attention launch); the loss within C1_LOSS_REL
    of one process's and every gradient within C1_GRAD_REL of its scale.
    Serve: a static prefill of C1_SERVE_B x C1_PROMPT (each rank half the
    prompt, K/V gathered, the cache's slots split over the ranks) and
    C1_NEW greedy tokens over the sharded cache, every token equal to a
    one-process static run's.  No time is meaningful."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=C1_LAYERS)
    prompts = _static_prompts(cfg.vocab_size, C1_SERVE_B, C1_PROMPT)
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    eng = ServeEngine(cfg, params, Runtime(), max_len=C1_PROMPT + C1_NEW,
                      device=dev)
    gens = eng.generate_static(prompts, C1_NEW)[:, C1_PROMPT:]
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_c1")
    t0 = time.perf_counter()
    ranks = _pair("C1", _c1_rank, out_dir, dev.type)
    shutil.rmtree(out_dir, ignore_errors=True)
    L = cfg.n_layers
    train_want = _c1_expect(cfg, dict(norms=2 * L + 1, rmsnorm_bwd=2 * L + 1,
                                      flash=Q0_KERNELS))
    serve_want = _c1_expect(cfg, dict(norms=(2 * L + 1) * C1_NEW,
                                      flash=Q0_KERNELS[:1]))
    # the WKV-6 forward of each layer on the gathered sequence, this
    # rank's heads (its backward replays the plain chunked form)
    rwkv_want = {k: 0 for k in ops.launch_counts()} | {
        "wkv6": C1_RWKV_LAYERS}
    for r, got in enumerate(ranks):
        tr = got["train"]
        rel = abs(tr["loss"] - tr["ref_loss"]) / abs(tr["ref_loss"])
        check(rel <= C1_LOSS_REL, f"C1 rank {r}: loss {tr['loss']} vs "
                                  f"{tr['ref_loss']} ({rel:.3g} relative)")
        check(tr["grad_rel_err_max"] <= C1_GRAD_REL,
              f"C1 rank {r}: gradient {tr['worst_leaf']} differs by "
              f"{tr['grad_rel_err_max']:.3g} of its scale")
        check(tr["launches"] == train_want,
              f"C1 rank {r} train launches {tr['launches']} != {train_want}")
        check(tr["context"] and tr["tp_size"] == 2
              and tr["sites"]["context_kv_gather"] == 2 * L,
              f"C1 rank {r}: sites {tr['sites']}")
        check(np.array_equal(np.asarray(got["tokens"]), gens),
              f"C1 rank {r}: served tokens differ from the one-process run")
        check(got["serve_launches"] == serve_want,
              f"C1 rank {r} serve launches {got['serve_launches']} != "
              f"{serve_want}")
        check(got["k_local"][1] == (C1_PROMPT + C1_NEW) // 2,
              f"C1 rank {r}: cache shard {got['k_local']}")
        rw = got["rwkv"]
        check(abs(rw["loss"] - rw["ref_loss"]) <= TRAIN_LOSS_ATOL,
              f"C1 rwkv6 rank {r}: loss {rw['loss']} vs {rw['ref_loss']}")
        for stat in ("median", "max"):
            err, own = (rw[f"{pre}grad_rel_err_{stat}"]
                        for pre in ("", "noise_"))
            bar = max(TRAIN_GRAD_REL, FLOOR_FACTOR * own)
            check(err <= bar, f"C1 rwkv6 rank {r}: gradient error {stat} "
                              f"{err:.3g} ({rw['worst_leaf']}) over {bar:.3g}"
                              f" ({FLOOR_FACTOR} x one process's own "
                              f"{own:.3g})")
        check(rw["launches"] == rwkv_want,
              f"C1 rwkv6 rank {r} launches {rw['launches']} != {rwkv_want}")
        check(rw["context"] and rw["tp_size"] == 2
              and rw["sites"]["context_seq_gather"] == 2 * C1_RWKV_LAYERS
              and rw["sites"]["context_kv_gather"] == 0,
              f"C1 rwkv6 rank {r}: sites {rw['sites']}")
    launches = add_launches(*(g["train"]["launches"] for g in ranks),
                            *(g["serve_launches"] for g in ranks),
                            *(g["rwkv"]["launches"] for g in ranks))
    tr = [g["train"] for g in ranks]
    print(f"[C1] {C1_SPEC} qwen3-0.6b at {L} layers in 2 processes (gloo) "
          f"in {time.perf_counter() - t0:.1f} s: train B{C1_BATCH} x "
          f"S{C1_SEQ}: loss {tr[0]['loss']:.6f} vs one process's "
          f"{tr[0]['ref_loss']:.6f}; gradients rel err max "
          + " / ".join(f"{g['grad_rel_err_max']:.3g} ({g['worst_leaf']})"
                       for g in tr)
          + f" (tol {C1_GRAD_REL}); serve B{C1_SERVE_B} x {C1_PROMPT} + "
          f"{C1_NEW}: tokens equal one process's, KV slots per rank "
          f"{ranks[0]['k_local'][1]} of {C1_PROMPT + C1_NEW}; peak "
          + " / ".join(f"{g['peak_mem_gib']:.2f}" for g in ranks)
          + f" GiB; launches {launches}; on {card}")
    rw = [g["rwkv"] for g in ranks]
    print(f"[C1] {C1_SPEC} rwkv6-1.6b at {C1_RWKV_LAYERS} layers, B"
          f"{C1_RWKV_BATCH} x S{TRAIN_SEQ} (each layer's time mix scanning "
          f"the gathered sequence on its 16 heads, the WKV-6 kernel; its "
          f"channel mix shifting across the split): loss {rw[0]['loss']:.6f}"
          f" vs one process's {rw[0]['ref_loss']:.6f} (tol "
          f"{TRAIN_LOSS_ATOL}); gradients rel err max, median "
          + " / ".join(f"{g['grad_rel_err_max']:.3g} ({g['worst_leaf']}), "
                       f"{g['grad_rel_err_median']:.3g}" for g in rw)
          + f"; one process's plain path under a {WKV_NOISE_REL} "
          f"perturbation of its products moves them by "
          f"{rw[0]['noise_grad_rel_err_max']:.3g}"
          f", {rw[0]['noise_grad_rel_err_median']:.3g} (bars max("
          f"{TRAIN_GRAD_REL}, {FLOOR_FACTOR} x those)); sequence gathers a "
          f"rank {rw[0]['sites']['context_seq_gather']}; on {card}")
    return dict(card=card, ranks=ranks, launches=launches)


POD_TIMEOUT_S = 600


def _point_shape(point):
    """A pod point's input shape: (arch, spec) is train_4k, (arch, spec,
    shape) names its own."""
    return point[2] if len(point) > 2 else "train_4k"


def pod_dryruns(points):
    """Start the dry run of each (arch, spec[, shape]) point (train_4k
    unless it names a shape) on the pod topology (256 fake ranks; spec ''
    the legacy layout), each through the dry-run CLI in a process of its
    own, all at once -> the running points, for :func:`pod_records`."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, ["src", os.environ.get("PYTHONPATH")])))
    return {point: (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         point[0], "--shape", _point_shape(point), "--out", DRYRUN_OUT]
        + (["--strategy", point[1]] if point[1] else []),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for point in points}


def pod_records(running, tag):
    """Wait for the points :func:`pod_dryruns` started -> {point:
    record, with the seconds from its start until its end was read as
    ``wall_s``}; each must have traced on 256 fake ranks.  Kills what is
    left on failure."""
    out = {}
    try:
        for point, (t0, proc) in running.items():
            arch, spec = point[:2]
            log, _ = proc.communicate(timeout=POD_TIMEOUT_S)
            _, label = dryrun.run_label(arch, _point_shape(point), False,
                                        spec)
            path = Path(DRYRUN_OUT) / f"{label}.json"
            rec = json.loads(path.read_text()) if path.exists() else {}
            check(proc.returncode == 0 and rec.get("status") == "ok"
                  and rec.get("n_devices") == 256,
                  f"{tag} {arch} under {spec or 'the legacy layout'}: rc "
                  f"{proc.returncode}, {rec.get('status')} "
                  f"{rec.get('error')}; {log[-2000:]}")
            rec["wall_s"] = time.perf_counter() - t0
            out[point] = rec
    finally:
        for _, proc in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def d6_points():
    """D6's (arch, spec) points, ``auto`` resolved on the pod."""
    return [(arch, strategy.resolve("auto", get_config(arch),
                                    strategy.pod_topology(),
                                    SHAPES["train_4k"])[0].format()
             if spec == "auto" else spec) for arch, spec in D6_POINTS]


def auto_memory(tag, arch, rec):
    """An ``auto`` train_4k pod point of ``arch`` (traced with remat, as the
    JAX dry run lowers it) beside the planner's ``memory_per_device`` for
    the plan it ranked first -> both, in GiB."""
    planned = strategy.resolve("auto", get_config(arch),
                               strategy.pod_topology(),
                               SHAPES["train_4k"])[1]
    gib = {k.replace("_bytes", "").replace("_per_device", ""): v / 2 ** 30
           for k, v in rec["memory"].items()}
    out = dict(gib, planner=planned.report.memory_per_device / 2 ** 30,
               remat=rec["remat"], strategy=rec["strategy"])
    print(f"[{tag}] {arch} x train_4k under auto ({rec['strategy']}, remat "
          f"{rec['remat']}): traced peak/dev {gib['peak']:.2f} GiB ("
          + ", ".join(f"{k} {v:.2f}" for k, v in gib.items() if k != "peak")
          + f") vs the planner's memory_per_device {out['planner']:.2f} GiB")
    return out


def d6_report(recs):
    """D6: full-depth dry runs on the pod topology (256 fake ranks) of the
    new compositions, traced by :func:`pod_phase`: qwen2-1.5b x train_4k
    under fsdp_tp8 (its 12 heads do not split 8 ways: context attention,
    K/V gathered in every layer), and dbrx-132b x train_4k under what
    ``--strategy auto`` ranks first (printed)."""
    out = {}
    for arch, spec in d6_points():
        rec = recs[arch, spec]
        cfg = get_config(arch)
        sites = rec["collective_sites"]
        if arch == "qwen2-1.5b":
            # K and V gathered in each layer's forward and its recompute
            check(rec["plan"]["attn"] == "context" and rec["remat"]
                  and sites["context_kv_gather"] == 4 * cfg.n_layers,
                  f"D6 qwen2-1.5b: plan {rec['plan']}, sites {sites}")
        print(f"[D6] {arch} x train_4k ({cfg.n_layers} layers) on pod under "
              f"{spec} (mesh {rec['plan']['mesh']}, attn "
              f"{rec['plan']['attn']}, expert '{rec['plan']['expert']}') in "
              f"{rec['wall_s']:.1f} s: peak/dev "
              f"{rec['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB; "
              f"sites {sites}; moe dispatch {rec.get('moe_dispatch')}; "
              f"collectives {rec['collectives']}")
        out[arch] = rec
        if arch == "dbrx-132b":
            out["dbrx_auto_memory"] = auto_memory("D6", arch, rec)
    return out


# ---------------------------------------------------------------------------
# phases 25-27: non-token inputs — musicgen-medium (AU1), qwen2-vl-2b (VL1)
# and their dry runs (D7)
# ---------------------------------------------------------------------------

IN_DECODE = 8                       # decode steps of AU1's and VL1's streams
VL1_GRID = (16, 16)                 # VL1's 256 patches: a grid at t 0
VL1_TEXT = 64                       # text positions after the grid
IN_STEPS = 4                        # make_train_step steps of AU1, VL1
IN_SPEC = "fsdp"                    # f32 on the 1-rank NCCL mesh
D7_MEM_REL = 0.10
D7_ARCHS = ("musicgen-medium", "qwen2-vl-2b")


def _plain_rt():
    return Runtime(attn_impl="torch", norm_impl="torch")


def input_static(dev, card, cfg, params, tag):
    """``generate_static`` of SS_BATCH token prompts of SS_PROMPT +
    SS_NEW greedy tokens on the kernel path (the paged engine refuses a
    non-token arch, as the JAX package's gate does), launches exact; the
    static path's logits and greedy tokens against the teacher-forced
    training forward over the prompts and the generated tokens, on the
    kernel path and on the plain path."""
    prompts = _static_prompts(cfg.vocab_size, SS_BATCH, SS_PROMPT)
    eng = ServeEngine(cfg, params, Runtime(), max_len=SS_PROMPT + SS_NEW,
                      device=dev)
    check(not eng.paged_ok, f"{tag}: the paged engine must refuse "
                            f"{cfg.input_mode!r} inputs")
    eng.generate_static(prompts, 2)
    prefill_ms, step_ms = _timed_static(eng, prompts, SS_NEW, dev)
    out, wall, counts = _counted_static(eng, prompts, SS_NEW,
                                        _static_expect(cfg, SS_NEW), tag)
    gens = out[:, SS_PROMPT:]
    check(gens.shape == (SS_BATCH, SS_NEW)
          and bool(((gens >= 0) & (gens < cfg.vocab_size)).all()),
          f"{tag} static tokens {gens.shape} out of range")
    static = static_logits(cfg, params, Runtime(), prompts, gens, dev)
    seq = torch.as_tensor(np.concatenate([prompts, gens[:, :-1]], 1),
                          device=dev)
    forced = {}
    with torch.no_grad():
        for name, rt in (("kernel", Runtime()), ("plain", _plain_rt())):
            forced[name] = tfm.forward(cfg, params, {"tokens": seq},
                                       rt)[:, SS_PROMPT - 1:].float()
    worst = (static - forced["kernel"]).abs().max().item()
    worst_plain = (forced["kernel"] - forced["plain"]).abs().max().item()
    served = float((forced["kernel"].argmax(-1).cpu().numpy()
                    == gens).mean())
    agree = (forced["kernel"].argmax(-1)
             == forced["plain"].argmax(-1)).float().mean().item()
    del static, forced
    print(f"[{tag}] static B{SS_BATCH} prompt {SS_PROMPT} +{SS_NEW} greedy "
          f"(f32, kernel path): prefill {prefill_ms:.2f} ms, {step_ms:.3f} "
          f"ms a decode step, {SS_BATCH * SS_NEW / wall:.1f} tok/s over "
          f"{wall:.3f} s; teacher-forced forward: max |static - forward| "
          f"{worst:.3g}, |kernel - plain| {worst_plain:.3g} (tol "
          f"{LOGIT_ATOL}); served tokens = the forward's argmax at "
          f"{served:.4f}, kernel/plain argmax {agree:.4f} (bar "
          f"{MIN_AGREEMENT}); on {card}")
    check(max(worst, worst_plain) <= LOGIT_ATOL,
          f"{tag} static/forward logits differ by {worst:.3g} / "
          f"{worst_plain:.3g}")
    check(min(served, agree) >= MIN_AGREEMENT,
          f"{tag} agreement {served:.4f} / {agree:.4f}")
    del eng
    return dict(batch=SS_BATCH, prompt=SS_PROMPT, new=SS_NEW,
                prefill_ms=prefill_ms, decode_step_ms=step_ms,
                tok_s=SS_BATCH * SS_NEW / wall, wall_s=wall, launches=counts,
                logits_max_abs_err=worst, plain_max_abs_err=worst_plain,
                served_agreement=served, greedy_agreement=agree)


def input_decode(dev, card, cfg, params, full, prefill_batch, steps, tag):
    """A prefill of ``prefill_batch`` into dense caches, then one
    ``decode_step`` per entry of ``steps`` ((tokens, pos, extra)) on the
    kernel path, launches exact; every logit against the forward over the
    whole stream ``full`` (the kernel path)."""
    S0 = tfm.batch_dims(prefill_batch)[1]
    n = len(steps)
    want = _static_expect(cfg, 1 + n)
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        lg, cache = tfm.prefill(cfg, params, prefill_batch, Runtime(),
                                S0 + n)
        outs = [lg.float()]
        for tokens, pos, extra in steps:
            lg, cache = tfm.decode_step(cfg, params, cache, tokens, pos,
                                        Runtime(), extra=extra)
            outs.append(lg.float())
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ref = tfm.forward(cfg, params, full, Runtime()).float()
    err_prefill = (outs[0] - ref[:, :S0]).abs().max().item()
    err_decode = (torch.cat(outs[1:], 1) - ref[:, S0:]).abs().max().item()
    del outs, ref, cache
    print(f"[{tag}] prefill of {S0} positions + {n} decode steps (B"
          f"{SS_BATCH}): max |logits - the whole stream's forward| "
          f"{err_prefill:.3g} (prefill), {err_decode:.3g} (decode; tol "
          f"{LOGIT_ATOL}); launches {counts}, expected {want}; on {card}")
    check(counts == want, f"{tag} decode launches {counts} != {want}")
    check(max(err_prefill, err_decode) <= LOGIT_ATOL,
          f"{tag} decode logits differ by {err_prefill:.3g} / "
          f"{err_decode:.3g}")
    return dict(prefill_len=S0, decode_steps=n, launches=counts,
                prefill_max_abs_err=err_prefill,
                decode_max_abs_err=err_decode)


def input_grads(dev, cfg, batch, tag):
    """The loss and every gradient of the kernel path against the plain
    path from the same initial weights on ``batch``: loss within
    TRAIN_LOSS_ATOL, each leaf within TRAIN_GRAD_REL of its scale; a leaf
    the inputs leave unused (the token table under frame embeddings) has
    no gradient on either path."""
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    loss_k, grads_k = loss_and_grads(cfg, params, batch, Runtime())
    loss_p, grads_p = loss_and_grads(cfg, params, batch, _plain_rt())
    unused = sorted(n for n, g in grads_k.items() if g is None)
    check(unused == sorted(n for n, g in grads_p.items() if g is None),
          f"{tag}: kernel and plain paths leave other leaves unused")
    rels = {n: grad_rel_err(n, grads_k, grads_p) for n in grads_k
            if grads_k[n] is not None}
    worst = max(rels, key=rels.get)
    B, S = tfm.batch_dims(batch)
    print(f"[{tag}] kernel vs plain path, {cfg.n_layers} layers, {B}x{S} "
          f"({time.perf_counter() - t0:.1f}s): loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (|diff| {abs(loss_k - loss_p):.3g}, tol "
          f"{TRAIN_LOSS_ATOL}); gradients rel err max {rels[worst]:.3g} "
          f"({worst}), median {statistics.median(rels.values()):.3g} "
          f"(tol {TRAIN_GRAD_REL}); no gradient: {unused}")
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL,
          f"{tag} loss differs by {abs(loss_k - loss_p):.3g}")
    check(rels[worst] <= TRAIN_GRAD_REL,
          f"{tag} gradient {worst} differs by {rels[worst]:.3g}")
    del params, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    return dict(check_batch=B, loss_kernel=loss_k, loss_plain=loss_p,
                grad_rel_err_max=rels[worst], grad_rel_err_worst_leaf=worst,
                grad_rel_err_median=statistics.median(rels.values()),
                unused_leaves=unused)


def input_train(dev, card, cfg, batch, tag):
    """IN_STEPS steps of ``make_train_step`` under IN_SPEC on the 1-rank
    NCCL mesh on one fixed ``batch`` (TRAIN_BATCH x TRAIN_SEQ), the lr
    warmed up over all of them to DENSE_LR: launches exact, losses finite
    and falling, the peak; a leaf without a gradient (the token table
    under frame embeddings) only decayed, by prod(1 - lr_t wd) as the
    JAX package's AdamW moves a leaf whose gradient is zero."""
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    tc = TrainConfig(steps=IN_STEPS, warmup=IN_STEPS,
                     opt=AdamWConfig(lr=DENSE_LR))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_distributed(dev)
    try:
        topo = strategy.host_topology()
        strat, _ = strategy.resolve(IN_SPEC, cfg, topo, shape)
        plan = strat.to_plan(cfg, topo, shape)
        rt = par.make_runtime(cfg, plan, shape, remat=False)
        params = par.apply_plan(tfm.init_params(cfg, seed=SEED, device=dev),
                                plan, cfg)
        embeds = "embeds" in batch
        tok0 = params.embed["tok"].to_local().detach().clone() if embeds \
            else None
        opt_state = init_opt_state(params)
        step = make_train_step(cfg, rt, tc, plan)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        losses, step_s, unused = [], [], None
        for _ in range(IN_STEPS):
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            losses.append(m["loss"].item())
            step_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        tok = params.embed["tok"].to_local().detach()
        if embeds:
            decay = np.float32(1.0)
            for i in range(IN_STEPS):
                lr = np.float32(tc.opt.lr) * np.float32(linear_warmup_cosine(
                    i, tc.warmup, tc.steps))
                decay *= np.float32(1.0) - lr * np.float32(
                    tc.opt.weight_decay)
            unused = ((tok - float(decay) * tok0).abs().max()
                      / tok0.abs().max()).item()
        del params, opt_state, tok, tok0
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutdown()
    want = {k: v * IN_STEPS for k, v in train_expect(cfg).items()}
    p50 = statistics.median(step_s[1:])
    print(f"[{tag}] {IN_STEPS} make_train_step steps under "
          f"{strat.format()} (mesh {mesh_shape(plan.mesh)}), f32, "
          f"B{TRAIN_BATCH} x S{TRAIN_SEQ}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} ({', '.join(f'{x:.4f}' for x in losses)}); "
          f"step p50 {p50 * 1e3:.1f} ms after the first ("
          f"{', '.join(f'{s * 1e3:.1f}' for s in step_s)} ms); peak "
          f"{peak / 2**30:.2f} GiB; launches {counts}"
          + ("" if unused is None else
             f"; the unused token table's distance from its decay "
             f"{unused:.3g} of scale")
          + f"; on {card}")
    check(counts == want, f"{tag} launches {counts} != {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{tag} losses {losses}")
    if unused is not None:
        check(unused <= 1e-6, f"{tag}: the token table moved {unused:.3g} "
                              f"of scale from its weight decay")
    return dict(spec=strat.format(), steps=IN_STEPS, losses=losses,
                step_s=step_s, step_p50_s=p50,
                tok_s=TRAIN_BATCH * TRAIN_SEQ / p50, peak_mem_bytes=peak,
                peak_mem_gib=peak / 2 ** 30, launches=counts,
                unused_decay_err=unused)


def _in_launches(*runs):
    return add_launches(*(r["launches"] for r in runs))


def au1_phase(dev, card):
    """Cell AU1: musicgen-medium at full width and depth, f32 (see the
    module docstring)."""
    cfg = get_config("musicgen-medium")
    check(cfg.head_dim_ == 64, f"musicgen head dim {cfg.head_dim_}")
    torch.cuda.reset_peak_memory_stats(dev)
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    res = dict(card=card, static=input_static(dev, card, cfg, params, "AU1"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n = SS_PROMPT + IN_DECODE
    emb = torch.randn(SS_BATCH, n, cfg.d_model, generator=gen,
                      device=dev) * 0.1
    toks = torch.zeros(SS_BATCH, 1, dtype=torch.int32, device=dev)
    res["decode"] = input_decode(
        dev, card, cfg, params, {"embeds": emb},
        {"embeds": emb[:, :SS_PROMPT]},
        [(toks, t, {"embeds": emb[:, t:t + 1]})
         for t in range(SS_PROMPT, n)], "AU1")
    del params, emb
    gc.collect()
    torch.cuda.empty_cache()
    batch = specs_lib.concrete_train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                           seed=SEED, device=dev)
    res["train"] = input_train(dev, card, cfg, batch, "AU1")
    res["train"].update(input_grads(dev, cfg, tfm.batch_rows(
        batch, 0, DENSE_CHECK_BATCH), "AU1"))
    res["launches"] = _in_launches(res["static"], res["decode"],
                                   res["train"])
    return res


def _vl1_batch(cfg, dev, B, S, seed):
    """B rows of S positions of VL1's layout: 256 patch embeddings over the
    first positions (a VL1_GRID grid at t 0) and text after them, with
    their 3-D position ids; tokens and labels uniform over the
    vocabulary."""
    batch = specs_lib.concrete_train_batch(cfg, B, S, seed=seed, device=dev)
    batch["position_ids"] = specs_lib.grid_position_ids(B, S, *VL1_GRID,
                                                        device=dev)
    return batch


def vl1_phase(dev, card):
    """Cell VL1: qwen2-vl-2b at full width and depth, f32 (see the module
    docstring)."""
    cfg = get_config("qwen2-vl-2b")
    check(cfg.vision_tokens == VL1_GRID[0] * VL1_GRID[1],
          f"qwen2-vl-2b vision tokens {cfg.vision_tokens}")
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    res = dict(card=card, static=input_static(dev, card, cfg, params, "VL1"))
    S0 = cfg.vision_tokens + VL1_TEXT
    full = _vl1_batch(cfg, dev, SS_BATCH, S0 + IN_DECODE, SEED + 1)
    full.pop("labels")
    ids, toks = full["position_ids"], full["tokens"]
    pre = dict(full, tokens=toks[:, :S0], position_ids=ids[:, :, :S0])
    res["decode"] = input_decode(
        dev, card, cfg, params, full, pre,
        [(toks[:, t:t + 1], t, {"position_ids": ids[:, :, t:t + 1]})
         for t in range(S0, S0 + IN_DECODE)], "VL1")
    del params, full, pre
    gc.collect()
    torch.cuda.empty_cache()
    batch = _vl1_batch(cfg, dev, TRAIN_BATCH, TRAIN_SEQ, SEED)
    res["train"] = input_train(dev, card, cfg, batch, "VL1")
    res["train"].update(input_grads(dev, cfg, tfm.batch_rows(
        batch, 0, DENSE_CHECK_BATCH), "VL1"))
    res["launches"] = _in_launches(res["static"], res["decode"],
                                   res["train"])
    return res


def plan_traces(card, cases):
    """The dry run of each case's training plan (one fake rank, fake
    tensors on the card, the kernel path), each in a process of its own,
    at once, against the measured peak of the step it traces: {tag: (cfg,
    shape, spec, measured bytes, runtime overrides, tolerance)} -> {tag:
    the record's memory, the measured peak, their relative difference and
    the trace's seconds}.  A step is traced without remat, as the measured
    steps ran, unless its overrides say otherwise."""
    import concurrent.futures
    import multiprocessing
    topo = strategy.host_topology(n_devices=1)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            len(cases), mp_context=ctx, max_tasks_per_child=1) as ex:
        futs = {}
        for tag, (cfg, shape, spec, _, over, _) in cases.items():
            strat, _ = strategy.resolve(spec, cfg, topo, shape)
            futs[tag] = ex.submit(dryrun.lower_one, cfg, shape, strat, topo,
                                  rt_overrides={"remat": False,
                                                **(over or {})},
                                  device="cuda")
        recs = {tag: f.result(timeout=POD_TIMEOUT_S)
                for tag, f in futs.items()}
    out = {}
    for tag, (cfg, shape, spec, measured, _, tol) in cases.items():
        rec = recs[tag]
        tracked = rec["memory"]["peak_bytes_per_device"]
        rel = abs(tracked - measured) / measured
        print(f"[{tag}] dry run of its {spec} {shape.mode} step "
              f"(remat {rec['remat']}), B"
              f"{shape.global_batch} x S{shape.seq_len}, {cfg.n_layers} "
              f"layers, one fake rank (traced in {rec['trace_s']} s): "
              f"tracked peak {tracked / 2**30:.3f} GiB ("
              + ", ".join(f"{k[:-6]} {v / 2**30:.3f}"
                          for k, v in rec["memory"].items()
                          if k != "peak_bytes_per_device")
              + f" GiB) vs max_memory_allocated {measured / 2**30:.3f} GiB:"
              f" rel {rel:.3g} (tol {tol}); on {card}")
        check(rel <= tol, f"{tag} dry-run peak {tracked} B vs measured "
                          f"{measured} B")
        out[tag] = dict(measured_peak_bytes=measured, rel=rel,
                        **{k: rec[k] for k in (
                            "memory", "trace_s", "collectives",
                            "moe_dispatch", "cache_bytes_per_device")
                           if k in rec})
    return out


def d7_cases(au1, vl1):
    """D7: AU1's and VL1's training plans (IN_SPEC, B TRAIN_BATCH x S
    TRAIN_SEQ) for :func:`plan_traces`, within D7_MEM_REL."""
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    return {tag: (get_config(arch), shape, IN_SPEC,
                  res["train"]["peak_mem_bytes"], None, D7_MEM_REL)
            for tag, arch, res in zip(("AU1", "VL1"), D7_ARCHS, (au1, vl1))}


def d7_report(recs):
    """D7's pod points, traced by :func:`pod_phase`: musicgen-medium and
    qwen2-vl-2b x train_4k on the legacy layout (tp 16 resolves to context
    attention for 24 and 12 heads: K/V gathered in every layer)."""
    out = {}
    for arch in D7_ARCHS:
        rec = recs[arch, ""]
        sites = rec["collective_sites"]
        n_layers = get_config(arch).n_layers
        # K and V gathered in each layer's forward and its recompute
        check(rec["plan"]["attn"] == "context" and rec["remat"]
              and sites["context_kv_gather"] == 4 * n_layers,
              f"D7 {arch}: plan {rec['plan']}, sites {sites}")
        peak = rec["memory"]["peak_bytes_per_device"] / 2**30
        print(f"[D7] {arch} x train_4k ({n_layers} layers) on pod "
              f"({rec['strategy']}, mesh {rec['plan']['mesh']}, attn "
              f"{rec['plan']['attn']}) in {rec['wall_s']:.1f} s (trace "
              f"{rec['trace_s']} s): peak/dev {peak:.2f} GiB; sites {sites};"
              f" collective bytes {rec['collective_bytes_total']:.4g}")
        out[arch] = rec
    return out


# ---------------------------------------------------------------------------
# phase 26: jamba-v0.1-52b (J1) — Mamba layers among attention and MoE
# layers; its pod dry runs (D8)
# ---------------------------------------------------------------------------

JAMBA = "jamba-v0.1-52b"
# serving: one whole period of the 32 layers, Mamba on 0-6, attention on
# 7, MoE on 1, 3, 5 and 7 (13.3 B parameters, 53.2 GB of f32)
J1_SERVE_LAYERS = 8
J1_SERVE_B, J1_PROMPT, J1_NEW = 4, 128, 32
# training: 2 layers with attention every 2nd, Mamba with the dense SwiGLU
# and attention with the 16-expert MoE (3.68 B parameters, 59 GB of f32
# AdamW state; one period, 213 GB of it, is past one card); the dry run
# of its plan tracks a 72.3 GiB peak at B 4 of the card's 79.2
J1_TRAIN_LAYERS, J1_TRAIN_B, J1_CHECK_BATCH = 2, 4, 2
J1_SPEC = "fsdp"                    # f32 on the 1-rank NCCL mesh
J1_SERVE_CHUNK, J1_TRAIN_CHUNK = 32, 64   # the serve and train CLIs' scans
J1_GRAD_REL = 1e-4                  # kernel vs plain gradients (f32 bar)
D8_LONG = "long_500k"


def j1_serve_cfg():
    return dataclasses.replace(get_config(JAMBA), n_layers=J1_SERVE_LAYERS)


def j1_train_cfg():
    return dataclasses.replace(get_config(JAMBA), n_layers=J1_TRAIN_LAYERS,
                               attn_every=2)


class ScanTimer:
    """CUDA events around every selective scan of the Mamba layers while
    :meth:`active`: a layer's chunked scan (forward), each chunk's
    backward and a decode step's one-step scan -> their device time."""

    def __init__(self):
        self.events, self._depth = [], 0

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)

    def _timed(self, fn):
        def run(*args, **kw):
            if self._depth:             # a chunk inside a timed scan
                return fn(*args, **kw)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            self._depth += 1
            start.record()
            try:
                out = fn(*args, **kw)
            finally:
                self._depth -= 1
            end.record()
            self.events.append((start, end))
            return out
        return run

    @contextlib.contextmanager
    def active(self):
        fns = (mamba_lib.selective_scan, mamba_lib._selective_scan_chunk,
               mamba_lib._ScanChunk.backward)
        mamba_lib.selective_scan = self._timed(fns[0])
        mamba_lib._selective_scan_chunk = self._timed(fns[1])
        mamba_lib._ScanChunk.backward = staticmethod(self._timed(fns[2]))
        try:
            yield self
        finally:
            mamba_lib.selective_scan, mamba_lib._selective_scan_chunk = \
                fns[:2]
            mamba_lib._ScanChunk.backward = staticmethod(fns[2])


def j1_serve(dev, card):
    """J1's serving: ``generate_static`` of J1_SERVE_B prompts of J1_PROMPT
    + J1_NEW greedy tokens on the kernel path (the paged engine refuses
    the hybrid), launches exact; its decode logits (a prefill, then a
    decode step a token) against the teacher-forced forward over the
    whole stream, on the kernel path and on the plain path; the prefill's
    and a decode step's wall time and the selective scan's share of
    each."""
    cfg = j1_serve_cfg()
    torch.cuda.reset_peak_memory_stats(dev)
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    rt = Runtime(mamba_chunk=J1_SERVE_CHUNK)
    plain = Runtime(attn_impl="torch", norm_impl="torch",
                    mamba_chunk=J1_SERVE_CHUNK)
    prompts = _static_prompts(cfg.vocab_size, J1_SERVE_B, J1_PROMPT)
    eng = ServeEngine(cfg, params, rt, max_len=J1_PROMPT + J1_NEW,
                      device=dev)
    check(not eng.paged_ok, "J1: the paged engine took the hybrid")
    out, wall, counts = _counted_static(eng, prompts, J1_NEW,
                                        _static_expect(cfg, J1_NEW), "J1")
    gens = out[:, J1_PROMPT:]
    check(bool(((gens >= 0) & (gens < cfg.vocab_size)).all()),
          "J1 static tokens out of range")
    scan = ScanTimer()
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    with torch.no_grad(), scan.active():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = eng._prefill(eng.params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        scan_prefill_ms = scan.ms()
        scan.events = []
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        del lg
        t0 = time.perf_counter()
        for t in range(J1_NEW - 1):
            lg, cache = eng._step(eng.params, cache, tok, J1_PROMPT + t)
            tok = lg[:, 0].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (J1_NEW - 1)
        scan_step_ms = scan.ms() / (J1_NEW - 1)
    del cache, lg
    stream = torch.as_tensor(np.concatenate([prompts, gens[:, :-1]], 1),
                             device=dev)
    paths = {}
    for name, r in (("kernel", rt), ("plain", plain)):
        dec = static_logits(cfg, params, r, prompts, gens, dev)
        with torch.no_grad():
            fwd = tfm.forward(cfg, params, {"tokens": stream}, r)[
                :, J1_PROMPT - 1:].float()
        paths[name] = dict(
            max_abs_err=(dec - fwd).abs().max().item(),
            scale=fwd.abs().max().item(),
            agreement=(dec.argmax(-1) == fwd.argmax(-1)).float().mean()
            .item())
        del dec, fwd
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[J1] {cfg.name} at {cfg.n_layers} layers ({n_params / 1e9:.3f} B "
          f"parameters, f32): static B{J1_SERVE_B} prompt {J1_PROMPT} "
          f"+{J1_NEW} greedy in {wall:.3f} s; prefill {prefill_ms:.1f} ms "
          f"(selective scan {scan_prefill_ms:.1f} ms of device time: "
          f"{scan_prefill_ms / prefill_ms:.1%}), decode step {step_ms:.2f} "
          f"ms (scan {scan_step_ms:.3f} ms: {scan_step_ms / step_ms:.1%}); "
          f"decode logits vs the teacher-forced forward: "
          + "; ".join(f"{k} path max |diff| {v['max_abs_err']:.3g} (logits "
                      f"scale {v['scale']:.3g}, tol {LOGIT_ATOL}), greedy "
                      f"agreement {v['agreement']:.4f}"
                      for k, v in paths.items())
          + f"; peak {peak / 2**30:.2f} GiB; on {card}")
    for name, v in paths.items():
        check(v["max_abs_err"] <= LOGIT_ATOL,
              f"J1 {name} path: decode logits differ from the forward's by "
              f"{v['max_abs_err']:.3g}")
        check(v["agreement"] >= MIN_AGREEMENT,
              f"J1 {name} path: greedy agreement {v['agreement']:.4f}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, params=n_params, batch=J1_SERVE_B,
                prompt=J1_PROMPT, new=J1_NEW, wall_s=wall, launches=counts,
                prefill_ms=prefill_ms, decode_step_ms=step_ms,
                scan_prefill_ms=scan_prefill_ms, scan_step_ms=scan_step_ms,
                paths=paths, peak_mem_gib=peak / 2**30,
                tokens=gens.tolist())


def j1_train(dev, card):
    """J1's training: DENSE_STEPS steps under J1_SPEC on the 1-rank NCCL
    mesh at J1_TRAIN_B x TRAIN_SEQ (the plan's dropping dispatch),
    launches exact, losses finite and falling, the selective scan's share
    of a step; its training state freed, kernel vs plain loss and
    gradients at J1_CHECK_BATCH x TRAIN_SEQ within J1_GRAD_REL."""
    cfg = j1_train_cfg()
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, J1_TRAIN_B, "train")
    scan = ScanTimer()
    init_distributed(dev)
    try:
        topo = strategy.host_topology()
        strat, _ = strategy.resolve(J1_SPEC, cfg, topo, shape)
        plan = strat.to_plan(cfg, topo, shape)
        rt = par.make_runtime(cfg, plan, shape, remat=False,
                              mamba_chunk=J1_TRAIN_CHUNK)
        check(rt.moe_impl == "dropping" and rt.compute_dtype == torch.float32,
              f"J1 plan runtime {rt}")
        tc = TrainConfig(steps=DENSE_STEPS, warmup=DENSE_STEPS, log_every=1,
                         opt=AdamWConfig(lr=DENSE_LR))
        params = par.apply_plan(tfm.init_params(cfg, seed=SEED, device=dev),
                                plan, cfg)
        # FSDP2 gathers the MoE layer's 10.66 GiB and frees it twice a
        # step: in fixed segments that left 14.61 GiB reserved but
        # unallocated and the third step out of memory at 72.27 GiB held
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
        with scan.active():
            res = run_steps(dev, card, cfg, rt, tc, params,
                            train_expect(cfg), "J1", plan=plan,
                            batch=J1_TRAIN_B)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
        shutdown()
    scan_ms = scan.ms() / DENSE_STEPS
    res.update(spec=strat.format(), mesh=mesh_shape(plan.mesh),
               scan_ms_per_step=scan_ms,
               scan_share=scan_ms / 1e3 / res["step_p50_s"])
    print(f"[J1] train under {res['spec']}: the selective scan (forward "
          f"and backward, 1 Mamba layer) {scan_ms:.1f} ms of device time a "
          f"step, {res['scan_share']:.1%} of the step's p50 "
          f"{res['step_p50_s'] * 1e3:.1f} ms; on {card}")
    res.update(grad_check(
        dev, cfg, Runtime(mamba_chunk=J1_TRAIN_CHUNK),
        Runtime(attn_impl="torch", norm_impl="torch",
                mamba_chunk=J1_TRAIN_CHUNK), J1_CHECK_BATCH, "J1",
        grad_rel=J1_GRAD_REL))
    return res


def j1_phase(dev, card):
    """Cell J1: jamba-v0.1-52b at full width (d 4096, 32 heads over Kv 8,
    d_ff 14336, 16 experts top 2, d_state 16, d_conv 4, expand 2, dt_rank
    256, vocab 65536), f32: :func:`j1_serve` at J1_SERVE_LAYERS layers,
    then :func:`j1_train` at J1_TRAIN_LAYERS (its dry run runs with the
    pod dry runs, :func:`pod_phase`)."""
    res = dict(serve=j1_serve(dev, card), train=j1_train(dev, card))
    res["launches"] = add_launches(res["serve"]["launches"],
                                   res["train"]["launches"])
    return res


def j1_case(j1):
    """J1's training plan for :func:`plan_traces`, within G1_MEM_REL."""
    return (j1_train_cfg(), ShapeConfig("chip_smoke", TRAIN_SEQ, J1_TRAIN_B,
                                        "train"),
            J1_SPEC, j1["train"]["peak_mem_bytes"],
            dict(mamba_chunk=J1_TRAIN_CHUNK), G1_MEM_REL)


# ---------------------------------------------------------------------------
# phase 26: block remat (RM1) — qwen3-0.6b's step with and without remat at
# two shapes, and J1's block of two layers
# ---------------------------------------------------------------------------

RM1_SPEC = "fsdp"                   # f32 on the 1-rank NCCL mesh
RM1_LONG_SEQ = 4096
# the largest B whose step at S 4096 fits the card without remat (at B 3
# its backward asks for 6.96 GiB more with 73.99 of 79.18 GiB allocated)
RM1_LONG_BATCH = 2
RM1_STEPS = 4                       # AdamW steps a run; p50 of the last 3
RM1_GRAD_REL = GRAD_REL_TOL[torch.float32]   # 1e-4 of each leaf's scale
# (RMSNorm, flash) forwards the recompute adds to J1's step (a block of a
# Mamba and an attention + MoE layer): the block's rerun runs layer 0 and
# layer 1 up to its MoE FFN; under remat_inner it stops at layer 1's
# checkpointed input, and each layer's own rerun follows
RM1_J1_EXTRA = {"remat": (4, 1), "remat_inner": (6, 1)}


def rm1_expect(cfg, extra_norms=0, extra_flash=0):
    """Launches of one f32 train step (:func:`train_expect`), plus the
    RMSNorm and flash forwards the backward's recompute reruns."""
    out = train_expect(cfg)
    out["rmsnorm"] += extra_norms
    out[fa.counter_name(fa.KERNELS[0], cfg.head_dim_)] += extra_flash
    return out


def _rm1_grads(cfg, params, batch, rt, expect, dev, tag):
    """One forward and backward of ``batch`` (launches held to ``expect``)
    -> (loss, {leaf: gradient, whole, on the card}, launches, peak
    bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    loss, grads = loss_and_grads(cfg, params, batch, rt)
    torch.cuda.synchronize()
    counts, peak = ops.launch_counts(), torch.cuda.max_memory_allocated(dev)
    check(counts == expect, f"{tag} gradient pass launches {counts} != "
                            f"expected {expect}")
    grads = {n: g.full_tensor() if isinstance(g, DTensor) else g
             for n, g in grads.items()}
    return loss, grads, counts, peak


def _rm1_compare(tag, base, got, dev):
    """The loss and every gradient of ``got`` (on the card) against
    ``base`` (on the host), each (loss, grads, ...): the loss within
    TRAIN_LOSS_ATOL, each leaf within RM1_GRAD_REL of its scale -> (loss
    diff, worst error, its leaf)."""
    rels = {}
    for n, g in got[1].items():
        ref = {k: base[1][k].to(dev) for k in (n, n[:-2] + "bq")
               if k in base[1]}
        rels[n] = grad_rel_err(n, {n: g}, ref)
    worst = max(rels, key=rels.get)
    diff = abs(got[0] - base[0])
    check(diff <= TRAIN_LOSS_ATOL, f"{tag}: loss {got[0]} vs {base[0]}")
    check(rels[worst] <= RM1_GRAD_REL,
          f"{tag}: gradient {worst} off by {rels[worst]:.3g} of its scale")
    return diff, rels[worst], worst


def _on_host(run):
    """A gradient pass's result with its gradients moved to the host."""
    return (run[0], {n: g.cpu() for n, g in run[1].items()}, *run[2:])


def rm1_qwen3(dev, card, strat, topo, B, S):
    """RM1 (a) at B x S: from the same seeded weights and batch, under
    RM1_SPEC, a forward and backward and then RM1_STEPS AdamW steps with
    remat off and on (each run on weights of its own, freed after it):
    launches exact, the gradients against each other, each run's
    ``max_memory_allocated`` over its steps and its step p50."""
    cfg = get_config("qwen3-0.6b")
    shape = ShapeConfig("chip_smoke", S, B, "train")
    plan = strat.to_plan(cfg, topo, shape)
    batch = batch_to_device(next(iter(Batcher(
        SyntheticSource(cfg.vocab_size, seed=SEED), S, B))), dev)
    runs = {}
    for remat in (False, True):
        tag = f"RM1 B{B} S{S} remat {remat}"
        rt = par.make_runtime(cfg, plan, shape, remat=remat)
        check(rt.remat is remat and not rt.remat_inner, f"{tag}: {rt}")
        expect = rm1_expect(cfg, 2 * cfg.n_layers * remat,
                            attn_layers(cfg) * remat)
        params = par.apply_plan(tfm.init_params(cfg, seed=SEED, device=dev),
                                plan, cfg)
        grad_run = _rm1_grads(cfg, params, batch, rt, expect, dev, tag)
        loss, grad_counts, grad_peak = grad_run[0], grad_run[2], grad_run[3]
        if remat:
            diff, worst, leaf = _rm1_compare(f"RM1 B{B} S{S}", base,
                                             grad_run, dev)
        else:
            base = _on_host(grad_run)
        del grad_run
        state = init_opt_state(params)
        step = make_train_step(cfg, rt, TrainConfig(
            steps=RM1_STEPS, warmup=1, opt=AdamWConfig(lr=DENSE_LR)), plan)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        times, losses = [], []
        for _ in range(RM1_STEPS):
            t0 = time.perf_counter()
            state, m = step(params, state, batch)[1:]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        want = {k: v * RM1_STEPS for k, v in expect.items()}
        check(counts == want, f"{tag}: launches {counts} != {want}")
        check(all(np.isfinite(losses)), f"{tag}: losses {losses}")
        del params, state, step
        gc.collect()
        torch.cuda.empty_cache()
        p50 = statistics.median(times[1:])
        runs[remat] = dict(
            remat=remat, batch=B, seq_len=S, loss=loss, losses=losses,
            step_s=times, step_p50_s=p50, tok_s=B * S / p50,
            peak_mem_bytes=peak, peak_mem_gib=peak / 2 ** 30,
            grad_pass_peak_gib=grad_peak / 2 ** 30,
            launches=add_launches(counts, grad_counts),
            launches_per_step=expect)
        print(f"[{tag}] {RM1_SPEC}, {cfg.n_layers} layers: loss {loss:.6f}; "
              f"{RM1_STEPS} steps p50 {p50 * 1e3:.1f} ms ("
              + ", ".join(f"{t * 1e3:.1f}" for t in times)
              + f" ms), {B * S / p50:.0f} tokens/s; max_memory_allocated "
              f"{peak / 2 ** 30:.3f} GiB over the steps (the gradient pass "
              f"{grad_peak / 2 ** 30:.3f}); launches a step {expect}; on "
              f"{card}")
    del base
    off, on = runs[False], runs[True]
    print(f"[RM1 B{B} S{S}] remat vs none: loss |diff| {diff:.3g}, "
          f"gradients rel err max {worst:.3g} ({leaf}); peak "
          f"{on['peak_mem_gib']:.3f} vs {off['peak_mem_gib']:.3f} GiB "
          f"({on['peak_mem_bytes'] / off['peak_mem_bytes']:.4f}x); step "
          f"p50 {on['step_p50_s'] * 1e3:.1f} vs "
          f"{off['step_p50_s'] * 1e3:.1f} ms "
          f"({on['step_p50_s'] / off['step_p50_s']:.4f}x); on {card}")
    return dict(off=off, on=on, loss_diff=diff, grad_rel_err_max=worst,
                grad_rel_err_worst_leaf=leaf,
                launches=add_launches(off["launches"], on["launches"]))


def rm1_jamba(dev, card):
    """RM1 (b): J1's training config (a block of period 2) under J1_SPEC
    at J1_TRAIN_B x TRAIN_SEQ: a forward and backward without remat, with
    remat and with remat + remat_inner from the same weights and batch,
    each's launches exact and gradients against no remat's."""
    cfg = j1_train_cfg()
    check(tfm.layer_plan(cfg)[1:3] == (0, 2),
          f"RM1 jamba layer plan {tfm.layer_plan(cfg)}")
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, J1_TRAIN_B, "train")
    batch = batch_to_device(next(iter(Batcher(
        SyntheticSource(cfg.vocab_size, seed=SEED), TRAIN_SEQ,
        J1_TRAIN_B))), dev)
    out = {}
    init_distributed(dev)
    try:
        topo = strategy.host_topology()
        plan = strategy.resolve(J1_SPEC, cfg, topo, shape)[0].to_plan(
            cfg, topo, shape)
        params = par.apply_plan(tfm.init_params(cfg, seed=SEED, device=dev),
                                plan, cfg)
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
        for name, over in (("none", dict(remat=False)),
                           ("remat", dict(remat=True)),
                           ("remat_inner", dict(remat=True,
                                                remat_inner=True))):
            rt = par.make_runtime(cfg, plan, shape,
                                  mamba_chunk=J1_TRAIN_CHUNK, **over)
            extra = RM1_J1_EXTRA.get(name, (0, 0))
            run = _rm1_grads(cfg, params, batch, rt, rm1_expect(cfg, *extra),
                             dev, f"RM1 jamba {name}")
            res = dict(loss=run[0], launches=run[2],
                       peak_mem_gib=run[3] / 2 ** 30)
            if name == "none":
                base = _on_host(run)
            else:
                res.update(zip(("loss_diff", "grad_rel_err_max",
                                "grad_rel_err_worst_leaf"),
                               _rm1_compare(f"RM1 jamba {name}", base, run,
                                            dev)))
            del run
            out[name] = res
            print(f"[RM1 jamba {name}] {cfg.n_layers} layers (one block of "
                  f"2) under {J1_SPEC}, B{J1_TRAIN_B} x S{TRAIN_SEQ}: loss "
                  f"{res['loss']:.6f}; launches {res['launches']}; gradient "
                  f"pass peak {res['peak_mem_gib']:.3f} GiB"
                  + (f"; vs none: loss |diff| {res['loss_diff']:.3g}, "
                     f"gradients rel err max {res['grad_rel_err_max']:.3g}"
                     f" ({res['grad_rel_err_worst_leaf']})"
                     if name != "none" else "") + f"; on {card}")
        del params, base
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
        shutdown()
    out["launches"] = add_launches(*(out[k]["launches"] for k in
                                     ("none", "remat", "remat_inner")))
    return out


def rm1_phase(dev, card):
    """Cell RM1: block remat on the card.  (a) qwen3-0.6b at full width
    and depth under RM1_SPEC, at B TRAIN_BATCH x S TRAIN_SEQ and at B
    RM1_LONG_BATCH x S RM1_LONG_SEQ (:func:`rm1_qwen3`; at S 4096 the
    remat step's peak must lie below the one without); (b) J1's block of
    two layers (:func:`rm1_jamba`).  The remat steps' dry runs run in the
    pods phase (:func:`rm1_cases`)."""
    torch.cuda.reset_peak_memory_stats(dev)
    init_distributed(dev)
    try:
        topo = strategy.host_topology()
        cfg = get_config("qwen3-0.6b")
        strat = strategy.resolve(RM1_SPEC, cfg, topo, ShapeConfig(
            "chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train"))[0]
        res = {"short": rm1_qwen3(dev, card, strat, topo, TRAIN_BATCH,
                                  TRAIN_SEQ),
               "long": rm1_qwen3(dev, card, strat, topo, RM1_LONG_BATCH,
                                 RM1_LONG_SEQ)}
    finally:
        shutdown()
    long = res["long"]
    check(long["on"]["peak_mem_bytes"] < long["off"]["peak_mem_bytes"],
          f"RM1 at S {RM1_LONG_SEQ}: remat peak {long['on']} not below "
          f"{long['off']}")
    res["jamba"] = rm1_jamba(dev, card)
    res["launches"] = add_launches(res["short"]["launches"],
                                   long["launches"],
                                   res["jamba"]["launches"])
    return res


def rm1_cases(rm1):
    """RM1's remat steps (a) for :func:`plan_traces`, within
    DRYRUN_MEM_REL of their measured peaks."""
    cfg = get_config("qwen3-0.6b")
    return {f"RM1 S{run['on']['seq_len']}": (
        cfg, ShapeConfig("chip_smoke", run["on"]["seq_len"],
                         run["on"]["batch"], "train"),
        RM1_SPEC, run["on"]["peak_mem_bytes"], dict(remat=True),
        DRYRUN_MEM_REL) for run in (rm1["short"], rm1["long"])}


def d8_points():
    """D8's points: jamba-v0.1-52b x train_4k under what ``--strategy
    auto`` ranks first on the pod, and x long_500k on the pod layout."""
    auto = strategy.resolve("auto", get_config(JAMBA),
                            strategy.pod_topology(),
                            SHAPES["train_4k"])[0].format()
    return [(JAMBA, auto), (JAMBA, "", D8_LONG)]


def d8_report(recs):
    """D8: jamba-v0.1-52b at all 32 layers on the pod, traced by
    :func:`pod_phase`."""
    out = {}
    cfg = get_config(JAMBA)
    for point in d8_points():
        rec = recs[point]
        shape = _point_shape(point)
        print(f"[D8] {JAMBA} x {shape} ({cfg.n_layers} layers) on pod under "
              f"{rec['strategy']} (mesh {rec['plan']['mesh']}, attn "
              f"{rec['plan']['attn']}, expert '{rec['plan']['expert']}') in "
              f"{rec['wall_s']:.1f} s (trace {rec['trace_s']} s): peak/dev "
              f"{rec['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB"
              + (f", cache {rec['cache_bytes_per_device'] / 2**30:.3f} GiB"
                 if "cache_bytes_per_device" in rec else "")
              + f"; moe dispatch {rec.get('moe_dispatch')}; collective bytes "
              f"{rec['collective_bytes_total']:.4g}")
        out[shape] = rec
    out["auto_memory"] = auto_memory("D8", JAMBA, out["train_4k"])
    return out


QWEN_PODS = (("qwen3-0.6b", "", "train_4k"),     # D2's
             ("qwen3-0.6b", "", "decode_32k"))   # D3's


def pod_phase(card, res):
    """Every dry run, all at once, each in a process of its own: the
    full-depth points on the pod topology (256 fake ranks, the dry-run
    CLI) of D2, D3, D4, D5, D6, D7 and D8, and beside them the one-rank
    traces of the plans whose steps ran above (D2's strategy phase, D3's
    SS3 decode step, G1, M1, AU1 and VL1 (D7), J1) against their
    measured peaks; then each cell's checks.  ``res``: the earlier
    phases' results by name."""
    t0 = time.perf_counter()
    running = pod_dryruns([*QWEN_PODS, ("granite-20b", ""),
                           ("deepseek-moe-16b", D5_SPEC), *d6_points(),
                           *((arch, "") for arch in D7_ARCHS),
                           *d8_points()])
    try:
        traces = plan_traces(card, {
            "D2": d2_case(res["strategy"]), "D3": d3_case(res["SS3"]),
            "G1": g1_case(res["G1"]), "M1": m1_case(res["M1"]),
            **d7_cases(res["AU1"], res["VL1"]), "J1": j1_case(res["J1"]),
            **rm1_cases(res["RM1"])})
    finally:
        recs = pod_records(running, "pod dry runs")
    out = dict(d2=d2_report(traces["D2"], recs[QWEN_PODS[0]]),
               d3=d3_report(traces["D3"], recs[QWEN_PODS[1]]),
               g1_dryrun=traces["G1"], m1_dryrun=traces["M1"],
               d4=d4_report(recs["granite-20b", ""]),
               d5=d5_report(recs["deepseek-moe-16b", D5_SPEC]),
               d6=d6_report(recs),
               d7={k: traces[k] for k in ("AU1", "VL1")} | d7_report(recs),
               d8=d8_report(recs), j1_dryrun=traces["J1"],
               rm1_dryrun={k: v for k, v in traces.items()
                           if k.startswith("RM1")}, records=recs)
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phases 28-29: the roofline against the card (R1), the examples (X1)
# ---------------------------------------------------------------------------

SUBPROCESS_TIMEOUT_S = 300


def _module(args):
    """Start ``python -m <args>`` from the repository root (stdout piped)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, ["src", os.environ.get("PYTHONPATH")])))
    return subprocess.Popen([sys.executable, "-m", *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, what):
    """Wait for a :func:`_module` process -> its stdout; fails the run on a
    non-zero exit (the caller kills it if this raises)."""
    out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
    check(proc.returncode == 0, f"{what}: rc {proc.returncode}; {err[-2000:]}")
    return out


def measured_steps(res, pods):
    """The measured training steps that have a one-rank trace: {tag:
    (cfg, shape, spec, step p50 s, the trace)} (D2 = the strategy phase's
    T5 step)."""
    d7 = d7_cases(res["AU1"], res["VL1"])
    cases = {"D2": (d2_case(res["strategy"]), res["strategy"],
                    pods["d2"]["d2"]),
             "G1": (g1_case(res["G1"]), res["G1"]["train"],
                    pods["g1_dryrun"]),
             "M1": (m1_case(res["M1"]), res["M1"]["plan_train"],
                    pods["m1_dryrun"]),
             "AU1": (d7["AU1"], res["AU1"]["train"], pods["d7"]["AU1"]),
             "VL1": (d7["VL1"], res["VL1"]["train"], pods["d7"]["VL1"]),
             "J1": (j1_case(res["J1"]), res["J1"]["train"],
                    pods["j1_dryrun"])}
    return {tag: (case[0], case[1], case[2], run["step_p50_s"], trace)
            for tag, (case, run, trace) in cases.items()}


def r1_phase(card, pods, res):
    """R1: the schema check over the serve and strategy phases' telemetry
    (``python -m repro_torch.telemetry``) and the report over this run's
    records (``python -m repro_torch.perf.report`` -> REPORT_OUT), both
    in processes of their own, exit 0; the roofline on the cost model's
    H100 profile of every pod point of this run (each term finite and
    positive); and each measured step's roofline at its own shape and
    precision on one H100 against its p50: the share of its roofline it
    reaches (roofline step / measured step) must not pass 1.0."""
    check_proc = _module(["repro_torch.telemetry", TELEMETRY_OUT])
    report_proc = _module(["repro_torch.perf.report"])
    out = {}
    try:
        meshes = {}
        for rec in pods["records"].values():
            meshes.setdefault(rec["mesh"], set()).add(
                (rec["arch"], rec["shape"]))
        rows = []
        for mesh, points in sorted(meshes.items()):
            got = [r for r in roofline.table(DRYRUN_OUT, mesh, hw=cm.H100)
                   if (r["arch"], r["shape"]) in points]
            check(len(got) == len(points),
                  f"R1 roofline on {mesh}: rows {got}, points {points}")
            rows += got
        for r in rows:
            terms = [r[k] for k in ("t_compute_s", "t_memory_s",
                                    "t_collective_s")]
            check(all(np.isfinite(terms)) and min(terms) > 0,
                  f"R1 roofline row {r['arch']} {r['shape']} {r['mesh']}: "
                  f"terms {terms}")
        print(f"[R1] roofline of this run's {len(rows)} pod records on the "
              f"cost model's H100 profile ({cm.H100.flops_bf16 / 1e12:.0f} "
              f"TFLOP/s bf16, {cm.H100.hbm_bw / 1e12:.2f} TB/s HBM):\n"
              + roofline.markdown(rows))
        out["pods"] = rows
        steps = {}
        for tag, (cfg, shape, spec, p50, trace) in \
                measured_steps(res, pods).items():
            precision = strategy.parse(spec).precision
            t = roofline.roofline_terms(
                cfg, shape, 1, total_bytes(trace["collectives"]),
                remat=False, hw=cm.H100, precision=precision)
            model = flops_lib.model_flops(cfg, shape)
            share = t["roofline_step_s"] / p50
            mfu = model / p50 / cm.H100.flops_bf16
            print(f"[R1] {tag} ({cfg.name}, {cfg.n_layers} layers, "
                  f"{spec}, B{shape.global_batch} x S{shape.seq_len}): "
                  f"compute {t['t_compute_s'] * 1e3:.3f} ms "
                  f"({t['compiled_flops']:.4g} FLOP at "
                  f"{t['peak_flops'] / 1e12:.0f} TFLOP/s {precision}), "
                  f"memory {t['t_memory_s'] * 1e3:.3f} ms "
                  f"({t['hbm_bytes_per_device']:.4g} B), collective "
                  f"{t['t_collective_s'] * 1e3:.3f} ms: {t['dominant']}-"
                  f"bound, roofline step {t['roofline_step_s'] * 1e3:.3f} "
                  f"ms; measured p50 {p50 * 1e3:.1f} ms: roofline / "
                  f"measured {share:.4f}; measured MFU {mfu:.4f} (6ND "
                  f"{model:.4g} / p50 / {cm.H100.flops_bf16:.3g}); on {card}")
            check(all(np.isfinite([t["t_compute_s"], t["t_memory_s"],
                                   t["t_collective_s"]]))
                  and t["roofline_step_s"] > 0,
                  f"R1 {tag} roofline terms {t}")
            check(share <= 1.0, f"R1 {tag}: the measured step ({p50} s) is "
                                f"shorter than its roofline ({t})")
            steps[tag] = dict(t, arch=cfg.name, n_layers=cfg.n_layers,
                              spec=spec, batch=shape.global_batch,
                              seq_len=shape.seq_len, precision=precision,
                              step_p50_s=p50, roofline_share=share,
                              measured_mfu=mfu, model_flops=model)
        out["steps"] = steps
        print(_finish(check_proc, "R1 telemetry schema check").strip())
        report = _finish(report_proc, "R1 report")
    finally:
        for proc in (check_proc, report_proc):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    Path(REPORT_OUT).write_text(report)
    print(f"[R1] report: {len(report.splitlines())} lines -> {REPORT_OUT}")
    return out


X1_100M_STEPS = 60                 # torch_train_100m --steps
X1_CKPT_EVERY = 30                 # two checkpoints of its ~1.3 GB state
X1_CKPT_DIR = "results/ckpt/llama-100m"   # the example's


def _example(name):
    """An example's module, loaded from ``examples/`` beside this script."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def x1_phase(dev, card):
    """X1: the four examples' ``main`` in this process on the card, each
    with the launch counts zeroed just before and read just after, held
    exactly to what it runs: the training examples the RMSNorm forward and
    backward and the flash forward, dq and dk/dv at head dim 64 a layer a
    step, the quickstart's paged serving the RMSNorms of every forward
    and a flash-decode a layer a decode step, the batched server the
    RMSNorms of every forward and the flash forward in each prefill's
    attention layer; the explorer none."""
    out, launches = {}, []

    def run(name, argv, expect):
        mod = _example(name)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = expect(mod, res)
        print(f"[X1] {' '.join([name, *argv])}: {wall:.1f} s; launches "
              f"{counts}, expected {want}; on {card}")
        check(counts == want, f"X1 {name}: launches {counts} != {want}")
        launches.append(counts)
        return res, wall

    def trained(cfg, steps):
        return {k: v * steps for k, v in train_expect(cfg).items()}

    def quick(mod, res):
        cfg = reduced(get_config("qwen3-0.6b"))
        st = res["serve_stats"]
        check(cfg.head_dim_ == 64, f"quickstart head dim {cfg.head_dim_}")
        return add_launches(trained(cfg, res["steps"]),
                            serve_expect(cfg, st["forward_calls"],
                                         st["decode_steps"]))

    res, wall = run("torch_quickstart", [], quick)
    print(f"[X1] torch_quickstart: loss {res['losses'][0]:.4f} -> "
          f"{res['losses'][-1]:.4f} over {res['steps']} "
          f"steps; served {res['serve_stats']['decode_steps']} decode "
          f"steps, first sequence tail {res['tokens'][0, -16:].tolist()}")
    out["quickstart"] = dict(losses=res["losses"], wall_s=wall,
                             serve_stats=res["serve_stats"])

    shutil.rmtree(X1_CKPT_DIR, ignore_errors=True)
    argv = ["--steps", str(X1_100M_STEPS), "--ckpt_every",
            str(X1_CKPT_EVERY)]
    res, wall = run("torch_train_100m", argv,
                    lambda mod, res: trained(mod.M100, X1_100M_STEPS))
    saved = ckpt_lib.list_steps(X1_CKPT_DIR)
    shutil.rmtree(X1_CKPT_DIR, ignore_errors=True)
    print(f"[X1] torch_train_100m: loss {res['losses'][0]:.4f} -> "
          f"{res['losses'][-1]:.4f} ({len(res['losses'])} logged steps), "
          f"checkpoints at steps {saved}; {X1_100M_STEPS / wall:.2f} "
          f"steps/s over the whole run")
    check(saved == list(range(X1_CKPT_EVERY, X1_100M_STEPS + 1,
                              X1_CKPT_EVERY)), f"X1 checkpoints {saved}")
    out["train_100m"] = dict(losses=res["losses"], wall_s=wall,
                             checkpoints=saved)

    def served(mod, res):
        cfg = reduced(get_config("jamba-v0.1-52b"))
        return {k: 3 * v for k, v in _static_expect(cfg, 24).items()}

    res, wall = run("torch_serve_batched", [], served)
    print(f"[X1] torch_serve_batched: 3 x {res['tokens']} tokens "
          f"(greedy {res['greedy_s']:.2f} s, sampled {res['sampled_s']:.2f} "
          f"s); greedy tail {res['greedy'][0, -8:].tolist()}")
    out["serve_batched"] = dict(tokens=res["tokens"], wall_s=wall,
                                greedy_s=res["greedy_s"],
                                sampled_s=res["sampled_s"])

    res, wall = run("torch_parallelism_explorer", [],
                    lambda mod, res: {k: 0 for k in ops.launch_counts()})
    best = res["ranked"][0]
    print(f"[X1] torch_parallelism_explorer: {len(res['ranked'])} ranked, "
          f"best {best.spec} (predicted MFU {best.report.mfu:.3f}), Pareto "
          f"front {sorted(res['front'])}")
    out["explorer"] = dict(n_ranked=len(res["ranked"]), best=best.spec,
                           wall_s=wall)
    out["launches"] = add_launches(*launches)
    return out


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
    # the three flash kernels' launches with a query offset (K-CP, C1)
    "flash_attention_q0": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                           "src/repro/kernels/flash_attention.py:60"),
    "flash_attention_dq_q0": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:102"),
    "flash_attention_dkv_q0": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:134"),
    # the three flash kernels at head dim 64 (K-D64, AU1)
    "flash_attention_d64": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:60"),
    "flash_attention_dq_d64": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:102"),
    "flash_attention_dkv_d64": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:134"),
}
# the case each kernel's line reports, f32 throughout: the serving path's
# decode shape (the RMSNorm forward's training rows are printed beside it),
# the training paths' norm rows, attention shape and WKV-6 shape
REPORTED = {"rmsnorm": dict(shape="(8,1024)"),
            "rmsnorm_bwd": dict(shape="(4096,1024)"),
            "flash_decode": dict(n_splits=4, long_ctx=False, case="qwen3"),
            "flash_attention": dict(shape=FLASH_REPORTED),
            "flash_attention_dq": dict(shape=FLASH_REPORTED),
            "flash_attention_dkv": dict(shape=FLASH_REPORTED),
            "wkv6": dict(timed=True),
            **{name: dict(shape=KCP_REPORTED) for name in Q0_KERNELS},
            **{name: dict(shape=FLASH_D64_REPORTED) for name in D64_KERNELS}}


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
    shutil.rmtree(TELEMETRY_OUT, ignore_errors=True)   # R1 checks this run's
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

    def phase(name, fn, *a):
        """Run one phase between the card's memory being released before
        it and its wall time printed after it."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = fn(*a)
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f}s")
        return res

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
        rows += kcp_phase(dev, flush, gen)
    del flush
    print(f"[kernels] ok in {time.perf_counter() - t0:.1f}s")

    served = phase("serve", serve_phase, dev)

    cfg = get_config("qwen3-0.6b")
    qwen3_step = train_expect(cfg)
    trained = phase(
        "train", train_phase, dev, card, cfg, TRAIN_STEPS, AdamWConfig().lr,
        Runtime(), Runtime(attn_impl="torch", norm_impl="torch"), qwen3_step,
        TRAIN_BATCH, "train")
    strat = phase("strategy", strategy_phase, dev, card, qwen3_step)
    print(f"[strategy] host train/dispatch per step: "
          f"{strat['host_span_s']['dispatch'] * 1e3:.1f} ms under "
          f"{strat['spec']} (FSDP2, bf16) vs "
          f"{trained['host_span_s']['dispatch'] * 1e3:.1f} ms unsharded f32")
    ck1 = phase("CK1", ck1_phase, dev, card, train_expect(ck_cfg()))
    piped = phase("pipeline", pipeline_phase, card)

    def rwkv6():
        # free the qwen3 phases' tensors before the larger model
        torch.cuda.reset_peak_memory_stats(dev)
        rcfg = get_config("rwkv6-1.6b")
        res = train_phase(
            dev, card, rcfg, RWKV_STEPS, RWKV_LR,
            Runtime(rwkv_chunk=RWKV_CHUNK),
            Runtime(attn_impl="torch", norm_impl="torch",
                    rwkv_chunk=RWKV_CHUNK),
            {k: 0 for k in ops.launch_counts()} | {"wkv6": rcfg.n_layers},
            RWKV_CHECK_BATCH, "rwkv6", floor=WKV_NOISE_REL)
        res["shallow"] = grad_check(
            dev, dataclasses.replace(rcfg, n_layers=RWKV_SHALLOW_LAYERS),
            Runtime(rwkv_chunk=RWKV_CHUNK),
            Runtime(attn_impl="torch", norm_impl="torch",
                    rwkv_chunk=RWKV_CHUNK), RWKV_CHECK_BATCH, "rwkv6")
        return res
    rwkv_trained = phase("rwkv6", rwkv6)

    # static serving from dense caches, after the training phases' cells
    ss1 = phase("SS1", static_phase, dev, card)
    ss3 = phase("SS3", static_plan_phase, dev, card, ss1["tokens"])
    ss4 = phase("SS4", static_tp_phase, dev, card)
    ss2 = phase("SS2", static_rwkv_phase, dev, card)

    # the dense extensions: qwen2-1.5b, h2o-danube-1.8b, granite-20b
    q2 = phase("Q2", q2_phase, dev, card)
    h1 = phase("H1", h1_phase, dev, card)
    g1 = phase("G1", g1_phase, dev, card)

    # mixture of experts: deepseek-moe-16b, dbrx-132b, the all-to-all
    m1 = phase("M1", m1_phase, dev, card)
    m2 = phase("M2", m2_phase, dev, card)
    e1 = phase("E1", e1_phase, dev, card)

    # MoE under tensor and pipeline parallelism; context parallelism
    mt1 = phase("MT1", mt1_phase, dev, card)
    mp1 = phase("MP1", mp1_phase, card)
    c1 = phase("C1", c1_phase, dev, card)

    # non-token inputs: musicgen-medium's frame embeddings, qwen2-vl-2b's
    # vision embeddings and M-RoPE
    au1 = phase("AU1", au1_phase, dev, card)
    vl1 = phase("VL1", vl1_phase, dev, card)

    # jamba-v0.1-52b: Mamba layers among attention and MoE layers
    j1 = phase("J1", j1_phase, dev, card)

    # block remat: qwen3-0.6b with and without it, J1's block of two
    rm1 = phase("RM1", rm1_phase, dev, card)

    # every dry run at once: the pod points of D2-D8 and the one-rank
    # traces of the plans whose steps ran above
    res = dict(strategy=strat, SS3=ss3, G1=g1, M1=m1, AU1=au1, VL1=vl1,
               J1=j1, RM1=rm1)
    pods = phase("pod dry runs", pod_phase, card, res)

    # the roofline of the pod points and of the measured steps, the
    # telemetry schema check and the report; then the examples
    r1 = phase("R1", r1_phase, card, pods, res)
    x1 = phase("X1", x1_phase, dev, card)

    # each kernel's launches on the main paths: every run above, each
    # counted from 0
    launches = add_launches(
        served["launches"], trained["launches"], strat["launches"],
        strat["fp8"]["launches"], ck1["launches"], piped["launches"],
        rwkv_trained["launches"], ss1["launches"], ss3["launches"],
        ss4["launches"], ss2["launches"], q2["launches"], h1["launches"],
        g1["launches"], m1["launches"], m2["launches"], e1["launches"],
        mt1["launches"], c1["launches"], au1["launches"], vl1["launches"],
        j1["launches"], rm1["launches"], x1["launches"])
    line = kernels_line(rows, launches, strat["launches_bf16"], card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": rows, "kernels_tp": tp_rows,
             "serve": served,
             "train": trained, "train_strategy": strat,
             "dryrun": pods["d2"],
             "checkpoint_ck1": ck1,
             "train_pipeline": piped,
             "train_rwkv6": rwkv_trained, "static_ss1": ss1,
             "static_ss2": ss2, "static_ss3": ss3, "static_ss4": ss4,
             "dryrun_d3": pods["d3"], "dense_q2": q2, "dense_h1": h1,
             "dense_g1": g1, "moe_m1": m1, "moe_m2": m2, "ep_e1": e1,
             "moe_tp_mt1": mt1, "moe_pp_mp1": mp1, "cp_c1": c1,
             "inputs_au1": au1, "inputs_vl1": vl1, "jamba_j1": j1,
             "remat_rm1": rm1,
             "dryrun_pod": {k: v for k, v in pods.items()
                            if k != "records"},
             "roofline_r1": r1, "examples_x1": x1,
             "build_s": took,
             "total_s": time.perf_counter() - t_start}, indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
