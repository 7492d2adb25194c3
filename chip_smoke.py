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
              flushed before every timed launch), beside the least time the
              card could take (the f32 flash kernels at the 3xTF32 rate
              of the tensor cores they use); a second launch of the flash
              forward and of WKV-6 must give the same bits.  At the training
              shape it also times ``attention_delta``, prints dq + dk/dv +
              delta against SDPA's backward, and names the kernels SDPA's
              backward ran (torch.profiler).
4. serve    — qwen3-0.6b at full width and depth (28 layers, f32, random
              weights from a seed) serves 12 requests over 8 slots (prompts
              of 17-200 tokens, 48 greedy new tokens) through the paged
              engine on the kernels.  Launch counters are zeroed just before
              and read just after: RMSNorm must launch 57 times per forward
              call, flash-decode and its combine 28 times per decode step.
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
6. rwkv6    — the same for rwkv6-1.6b at full width and depth (24 layers,
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
7. report   — one JSON line listing every kernel, then the device line
              ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import telemetry as tel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import Batcher, SyntheticSource  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import wkv6 as wkv  # noqa: E402
from repro_torch.models import rwkv6 as rwkv_lib  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import Runtime  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serve import ServeEngine, init_paged_pools  # noqa: E402
from repro_torch.train import TrainConfig, train_loop  # noqa: E402
from repro_torch.train.trainer import batch_to_device  # noqa: E402

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
FLUSH_BYTES = 256 << 20   # > 50 MB L2: every timed launch starts cold
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


def time_ms(fn, flush, iters=50):
    """Median device time of one call, L2 flushed before each call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        flush.zero_()
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

def rmsnorm_phase(dev, flush, gen):
    """RMSNorm forward at the serving path's decode rows (8, 32 and a ragged
    37 of d 1024) and the training path's (B x S = 4096, and an odd 4099
    rows)."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, d in ((8, 1024), (32, 1024), (37, 1024), (4096, 1024),
                     (4099, 1024)):
            x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
            s = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
            y, rstd = rms.rmsnorm_cuda(x, s, 1e-6)
            y0, rstd0 = rms.rmsnorm_plain(x, s, 1e-6)
            torch.cuda.synchronize()
            err, ok = max_err(y, y0, dtype)
            rerr, rok = max_err(rstd, rstd0, torch.float32)
            check(ok and rok, f"rmsnorm {dtype} ({n},{d}): |dy| {err:.3g}, "
                              f"|drstd| {rerr:.3g} over tolerance")
            isz = x.element_size()
            bnd, by = bound_ms(2 * n * d * isz + 4 * d + 4 * n, 4 * n * d,
                               dtype)
            w = s.to(dtype)
            row = dict(name="rmsnorm", dtype=str(dtype).split(".")[-1],
                       shape=f"({n},{d})",
                       max_abs_err=err,
                       ms=time_ms(lambda: rms.rmsnorm_cuda(x, s, 1e-6), flush),
                       plain_ms=time_ms(lambda: rms.rmsnorm_plain(x, s, 1e-6),
                                        flush),
                       library_ms=time_ms(
                           lambda: F.rms_norm(x, (d,), w, 1e-6), flush),
                       bound_ms=bnd, bound_by=by)
            rows.append(row)
            print(f"[kernels] rmsnorm {row['dtype']} {row['shape']}: "
                  f"err {err:.3g} (tol atol={TOL[dtype][0]} "
                  f"rtol={TOL[dtype][1]}) kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, F.rms_norm "
                  f"{row['library_ms']:.4f} ms, bound {bnd:.5f} ms ({by})")
    return rows


def decode_case(dev, dtype, gen):
    """B 8, H 16, Kv 8, D 128, bs 16; ragged ctx up to 320 (a full table of
    20 blocks), permuted pool blocks, -1 table tails."""
    B, H, Kv, D, bs, nb = 8, 16, 8, 128, 16, 20
    P = B * nb + 5
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(dtype)
    k_pool = torch.randn(P, bs, Kv, D, generator=gen, device=dev).to(dtype)
    v_pool = torch.randn(P, bs, Kv, D, generator=gen, device=dev).to(dtype)
    ctx = torch.tensor([320, 1, 17, 100, 255, 64, 200, 33], dtype=torch.int32,
                       device=dev)
    perm = torch.randperm(P, generator=gen, device=dev)[:B * nb].view(B, nb)
    live = (ctx[:, None] + bs - 1) // bs
    tbl = torch.where(torch.arange(nb, device=dev)[None] < live,
                      perm, -1).to(torch.int32).contiguous()
    return q, k_pool, v_pool, tbl, ctx


def flash_decode_phase(dev, flush, gen):
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        case = decode_case(dev, dtype, gen)
        q, k_pool, v_pool, tbl, ctx = case
        B, _, H, D = q.shape
        Kv, isz = k_pool.shape[2], q.element_size()
        G, nb = H // Kv, tbl.shape[1]
        n_pos = int(ctx.sum())
        # library yardstick: SDPA with GQA over K/V gathered by the table
        kg = k_pool[tbl.clamp(min=0).long()].reshape(B, -1, Kv, D) \
            .transpose(1, 2).contiguous()
        vg = v_pool[tbl.clamp(min=0).long()].reshape(B, -1, Kv, D) \
            .transpose(1, 2).contiguous()
        mask = (torch.arange(kg.shape[2], device=dev)[None] < ctx[:, None]
                )[:, None, None, :]
        qs = q.transpose(1, 2).contiguous()
        for n_splits in (1, 4):
            splits, _ = fd.plan_splits(nb, n_splits)
            parts = fd.split_cuda(*case, n_splits)
            parts0 = fd.split_plain(*case, n_splits)
            out_k = fd.combine_cuda(*parts, dtype)
            torch.cuda.synchronize()
            # split kernel: its partials, merged by the plain combine
            e_split, ok1 = max_err(fd.combine_plain(*parts),
                                   fd.combine_plain(*parts0), torch.float32)
            # combine kernel: the same partials, merged by both
            e_comb, ok2 = max_err(out_k, fd.combine_plain(*parts).to(dtype),
                                  dtype)
            check(ok1 and ok2, f"flash-decode {dtype} splits={n_splits}: "
                               f"split err {e_split:.3g}, combine err "
                               f"{e_comb:.3g} over tolerance")
            part_bytes = B * Kv * splits * G * (D + 2) * 4
            b_split, by_split = bound_ms(
                B * H * D * isz + 2 * n_pos * Kv * D * isz + 4 * B * nb
                + 4 * B + part_bytes, 4 * n_pos * H * D, dtype)
            b_comb, by_comb = bound_ms(part_bytes + B * H * D * isz,
                                       4 * B * H * D * splits, dtype)
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qs, kg, vg, attn_mask=mask, enable_gqa=True), flush)
            shape = (f"B{B} H{H} Kv{Kv} D{D} bs16 ctx<=320 "
                     f"splits{n_splits}")
            dt = str(dtype).split(".")[-1]
            split_row = dict(
                name="flash_decode", dtype=dt, shape=shape,
                max_abs_err=e_split, n_splits=n_splits,
                ms=time_ms(lambda: fd.split_cuda(*case, n_splits), flush),
                plain_ms=time_ms(lambda: fd.split_plain(*case, n_splits),
                                 flush),
                library_ms=sdpa_ms, bound_ms=b_split, bound_by=by_split)
            comb_row = dict(
                name="flash_decode_combine", dtype=dt, shape=shape,
                max_abs_err=e_comb, n_splits=n_splits,
                ms=time_ms(lambda: fd.combine_cuda(*parts, dtype), flush),
                plain_ms=time_ms(lambda: fd.combine_plain(*parts).to(dtype),
                                 flush),
                library_ms=None, bound_ms=b_comb, bound_by=by_comb)
            rows += [split_row, comb_row]
            for r in (split_row, comb_row):
                lib = ("" if r["library_ms"] is None
                       else f", SDPA {r['library_ms']:.4f} ms")
                print(f"[kernels] {r['name']} {dt} splits={n_splits}: err "
                      f"{r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms, "
                      f"plain {r['plain_ms']:.4f} ms{lib}, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    return rows


def rmsnorm_bwd_phase(dev, flush, gen):
    """RMSNorm backward at the training path's rows (B x S = 4096 of d
    1024) and a ragged row count (not a multiple of the 16-row CTA)."""
    rows = []
    eps = 1e-6
    for dtype in (torch.float32, torch.bfloat16):
        for n, d in ((4096, 1024), (4099, 1024)):
            x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
            gy = torch.randn(n, d, generator=gen, device=dev).to(dtype)
            s = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
            _, rstd = rms.rmsnorm_plain(x, s, eps)
            dx, ds = rms.rmsnorm_bwd_cuda(x, s, rstd, gy)
            dx0, ds0 = rms.rmsnorm_bwd_plain(x, s, rstd, gy)
            torch.cuda.synchronize()
            err, ok = max_err(dx, dx0, dtype)
            ds_rel = rel_err(ds, ds0)
            check(ok and ds_rel <= GRAD_REL_TOL[torch.float32],
                  f"rmsnorm backward {dtype} ({n},{d}): |ddx| {err:.3g}, "
                  f"dscale rel {ds_rel:.3g} over tolerance")
            isz = x.element_size()
            bnd, by = bound_ms(3 * n * d * isz + 4 * n + 8 * d, 11 * n * d,
                               dtype)
            with torch.enable_grad():
                xr = x.detach().requires_grad_()
                w = s.to(dtype).detach().requires_grad_()
                y = F.rms_norm(xr, (d,), w, eps)
                lib = time_ms(lambda: torch.autograd.grad(
                    y, (xr, w), gy, retain_graph=True), flush)
            row = dict(name="rmsnorm_bwd", dtype=str(dtype).split(".")[-1],
                       shape=f"({n},{d})",
                       max_abs_err=max(err, (ds - ds0).abs().max().item()),
                       ms=time_ms(lambda: rms.rmsnorm_bwd_cuda(x, s, rstd, gy),
                                  flush),
                       plain_ms=time_ms(
                           lambda: rms.rmsnorm_bwd_plain(x, s, rstd, gy),
                           flush),
                       library_ms=lib, bound_ms=bnd, bound_by=by)
            rows.append(row)
            print(f"[kernels] rmsnorm_bwd {row['dtype']} {row['shape']}: "
                  f"dx err {err:.3g}, dscale rel {ds_rel:.3g}; kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"F.rms_norm backward {lib:.4f} ms, bound {bnd:.5f} ms "
                  f"({by})")
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


def flash_phase(dev, flush, gen):
    """Flash-attention forward (o, lse), dq and dk/dv kernels against their
    plain versions; the backward kernels take the plain forward's lse and
    delta, so each kernel is held alone."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (B, S, H, Kv, D, window) in enumerate(FLASH_CASES):
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
            base = dict(dtype=dt, shape=shape, timed=ci == 0)
            errs = {"flash_attention": max(e_o, e_lse),
                    "flash_attention_dq": (dq - dq0).abs().max().item(),
                    "flash_attention_dkv": max((dk - dk0).abs().max().item(),
                                               (dv - dv0).abs().max().item())}
            if ci:
                rows += [dict(base, name=n, max_abs_err=e)
                         for n, e in errs.items()]
                continue
            isz = q.element_size()
            pairs = visible_pairs(S, window) * B * H
            q_bytes, kv_bytes = B * S * H * D * isz, B * S * Kv * D * isz
            row_bytes = B * H * S * 4
            # all three kernels multiply on the tensor cores.  f32: bound
            # at the 3xTF32 rate they use, the f32 SIMT bound (PEAK_OPS_S)
            # kept beside it in bound_peak_ms.  bf16: bound at the card's
            # bf16 rate; the kernels run it on TF32 MMAs (one per product
            # of two inputs, two with p or ds), whose bound is noted in
            # bound_arith
            fwd_bytes = 2 * q_bytes + 2 * kv_bytes + row_bytes
            dq_bytes = 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes
            dkv_bytes = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
            work = {"flash_attention": (fwd_bytes, 4 * D * pairs,
                                        6 * D * pairs),
                    "flash_attention_dq": (dq_bytes, 6 * D * pairs,
                                           8 * D * pairs),
                    "flash_attention_dkv": (dkv_bytes, 8 * D * pairs,
                                            12 * D * pairs)}
            bounds, notes = {}, {}
            for name, (n_bytes, n_ops, tf32_mmas) in work.items():
                if dtype == torch.float32:
                    bounds[name] = bound_ms(n_bytes, n_ops, dtype,
                                            F32_3XTF32_OPS_S)
                    notes[name] = dict(
                        bound_arith="3xTF32",
                        bound_peak_ms=bound_ms(n_bytes, n_ops, dtype)[0])
                else:
                    bounds[name] = bound_ms(n_bytes, n_ops, dtype)
                    tf32 = bound_ms(n_bytes, tf32_mmas, dtype, TF32_OPS_S)[0]
                    notes[name] = dict(bound_arith=(
                        f"bf16 tensor cores; on the TF32 MMAs the kernel "
                        f"runs {tf32:.5f} ms"))
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
                           library_ms=lib, bound_ms=bnd, bound_by=by)
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


def wkv6_phase(dev, flush, gen):
    """WKV-6 kernel against its plain version, y and the final state, with
    the JAX kernel tests' input distribution (decay per step e^{-0.03} to
    e^{-0.4}, harder than the model's w0 in [-6, -4))."""
    rows = []
    N = 64
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (B, T, H, chunk) in enumerate(WKV_CASES):
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
            base = dict(name="wkv6", dtype=dt, shape=shape, timed=ci == 0,
                        max_abs_err=err)
            if ci:
                rows.append(base)
                continue
            isz = r.element_size()
            n = B * T * H * N
            bnd, by = bound_ms(4 * n * isz + 4 * n + 4 * H * N
                               + 4 * B * H * N * N,
                               wkv6_ops(B, T, H, N, chunk), dtype)
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
              "flash_decode_combine": cfg.n_layers * steps,
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
    params = tfm.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    batches = Batcher(SyntheticSource(cfg.vocab_size, seed=SEED), TRAIN_SEQ,
                      TRAIN_BATCH)
    rec = tel.Recorder()
    spans = rec.add_sink(_Events())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, opt_state, history = train_loop(cfg, rt, tc, batches, params,
                                            telemetry=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    expect = {k: v * steps for k, v in expect.items()}
    print(f"[{tag}] {steps} steps; launches {counts}, expected {expect}")
    check(counts == expect, f"launch counts {counts} != expected {expect}")
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
    res = dict(arch=cfg.name, params=n_params, steps=steps, lr=lr,
               batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, losses=losses,
               step_s=steps_s, step_p50_s=p50, host_span_s=host,
               tok_s=TRAIN_BATCH * TRAIN_SEQ / p50, wall_s=wall,
               peak_mem_gib=peak / 2 ** 30, launches=counts)
    print(f"[{tag}] {cfg.name} ({n_params / 1e9:.3f} B parameters) f32, "
          f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens/step: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; step p50 {p50 * 1e3:.1f} ms "
          f"({', '.join(f'{t * 1e3:.1f}' for t in steps_s)} ms), "
          f"{res['tok_s']:.0f} tokens/s at p50; host spans per step "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in host.items())
          + f"; peak memory {res['peak_mem_gib']:.2f} GiB; on {card}")
    del params, opt_state, history, batches
    torch.cuda.empty_cache()

    res.update(grad_check(dev, cfg, rt, plain_rt, check_batch, tag, floor))
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


def grad_check(dev, cfg, rt, plain_rt, check_batch, tag, floor=0.0):
    """The loss and every gradient of the kernel path ``rt`` against the
    plain path from the same initial weights and one batch of
    ``check_batch`` x TRAIN_SEQ: each leaf's error within TRAIN_GRAD_REL
    of its scale.  With ``floor`` > 0 the plain path runs a second time
    with its WKV outputs perturbed by a relative ``floor``, and the median
    and the maximum of the leaves' errors are instead each held to
    TRAIN_GRAD_REL or FLOOR_FACTOR times the same statistic of the leaves'
    movement under that perturbation, whichever is larger."""
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
               leaves_within_grad_rel=sum(r <= TRAIN_GRAD_REL
                                          for r in rels.values()))
    print(f"[{tag}] kernel vs plain path, {cfg.n_layers} layers, "
          f"{check_batch}x{TRAIN_SEQ} ({time.perf_counter() - t0:.1f}s): "
          f"loss {loss_k:.6f} vs {loss_p:.6f} (|diff| "
          f"{abs(loss_k - loss_p):.3g}, tol {TRAIN_LOSS_ATOL}); gradients "
          f"rel err max {rels[worst]:.3g} ({worst}), median "
          f"{res['grad_rel_err_median']:.3g}; "
          f"{res['leaves_within_grad_rel']} of {len(rels)} leaves within "
          f"{TRAIN_GRAD_REL}")
    if floor:
        print(f"[{tag}] plain path vs itself with its WKV outputs perturbed "
              f"by a relative {floor}: loss |diff| "
              f"{abs(res['loss_noise'] - loss_p):.3g}; gradients rel err max "
              f"{res['noise_grad_rel_err_max']:.3g} ({worst_n}), median "
              f"{res['noise_grad_rel_err_median']:.3g}; the kernel path's "
              f"median and max held to max({TRAIN_GRAD_REL}, "
              f"{FLOOR_FACTOR} x these)")
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL,
          f"loss differs by {abs(loss_k - loss_p):.3g}")
    if floor:
        for stat in ("median", "max"):
            got, own = (res[f"{pre}grad_rel_err_{stat}"]
                        for pre in ("", "noise_"))
            bar = max(TRAIN_GRAD_REL, FLOOR_FACTOR * own)
            check(got <= bar, f"gradient error {stat} {got:.3g} over "
                              f"{bar:.3g} ({FLOOR_FACTOR} x the plain path's "
                              f"own {own:.3g})")
    else:
        check(rels[worst] <= TRAIN_GRAD_REL,
              f"gradient {worst} differs by {rels[worst]:.3g} of its scale")
    return res


# ---------------------------------------------------------------------------

SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:24"),
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:33"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:36"),
    "flash_decode_combine": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                             "src/repro/kernels/flash_decode.py:147"),
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
            "flash_decode": dict(n_splits=4),
            "flash_decode_combine": dict(n_splits=4),
            "flash_attention": dict(timed=True),
            "flash_attention_dq": dict(timed=True),
            "flash_attention_dkv": dict(timed=True),
            "wkv6": dict(timed=True)}


def kernels_line(rows, launches, card):
    out = []
    for name, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["name"] == name]
        rep = next(r for r in mine if r["dtype"] == "float32" and all(
            r.get(k) == v for k, v in REPORTED[name].items()))
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine
                               if r["dtype"] == "float32"),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "dtype": "float32",
            "shape": rep["shape"], "card": card})
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
         "flash_decode_combine": 0, "flash_attention": L,
         "flash_attention_dq": L, "flash_attention_dkv": L, "wkv6": 0},
        TRAIN_BATCH, "train")
    print(f"[train] ok in {time.perf_counter() - t0:.1f}s")

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

    # each kernel's launches on the main paths: the serve phase's run plus
    # each train phase's run, each counted from 0
    launches = {k: served["launches"][k] + trained["launches"][k]
                + rwkv_trained["launches"][k] for k in trained["launches"]}
    line = kernels_line(rows, launches, card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": rows, "serve": served,
             "train": trained, "train_rwkv6": rwkv_trained, "build_s": took,
             "total_s": time.perf_counter() - t_start}, indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
