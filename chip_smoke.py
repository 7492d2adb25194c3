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
              the serving path's shapes, in f32 and bf16, with the stated
              tolerance; times the kernel, the plain version and one PyTorch
              library call computing the same function (L2 flushed before
              every timed launch), beside the least time the card could take.
4. serve    — qwen3-0.6b at full width and depth (28 layers, f32, random
              weights from a seed) serves 12 requests over 8 slots (prompts
              of 17-200 tokens, 48 greedy new tokens) through the paged
              engine on the kernels.  Launch counters are zeroed just before
              and read just after: RMSNorm must launch 57 times per forward
              call, flash-decode and its combine 28 times per decode step.
              Then the served tokens are fed again (teacher forcing) through
              the kernel path and the plain ``"torch"`` path on the same
              weights, and every step's logits must agree.
5. report   — one JSON line listing every kernel, then the device line
              ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import argparse
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
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import Runtime  # noqa: E402
from repro_torch.serve import ServeEngine, init_paged_pools  # noqa: E402

# published H100 SXM peaks (dense): device memory, f32 outside the tensor
# cores, bf16 tensor cores
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# |kernel - plain| <= atol + rtol * |plain|: f32 differs only by summation
# order and rsqrt/exp rounding; bf16 outputs round an f32 value that may
# differ in its last bits, i.e. by up to one bf16 ulp (2^-8..2^-7 relative)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
LOGIT_ATOL = 1e-3         # f32 logits after 28 layers, kernel vs plain path
MIN_AGREEMENT = 0.95      # greedy argmax agreement under teacher forcing
FLUSH_BYTES = 256 << 20   # > 50 MB L2: every timed launch starts cold
SEED = 0


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound_ms(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def rmsnorm_phase(dev, flush, gen):
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, d in ((8, 1024), (32, 1024), (37, 1024)):
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
            row = dict(dtype=str(dtype).split(".")[-1], shape=f"({n},{d})",
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
    expect = {"rmsnorm": (2 * cfg.n_layers + 1) * fwd,
              "flash_decode": cfg.n_layers * steps,
              "flash_decode_combine": cfg.n_layers * steps}
    print(f"[serve] {fwd} forward calls ({steps} decode steps); launches "
          f"{counts}, expected {expect}")
    check(counts == expect, f"launch counts {counts} != expected {expect}")
    check(all(v > 0 for v in counts.values()), f"a kernel never ran: {counts}")

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

SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:24"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:36"),
    "flash_decode_combine": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                             "src/repro/kernels/flash_decode.py:147"),
}
# the case each kernel's line reports: the serving path's f32 decode shape
REPORTED = {"rmsnorm": ("float32", "(8,1024)", None),
            "flash_decode": ("float32", None, 4),
            "flash_decode_combine": ("float32", None, 4)}


def kernels_line(rms_rows, fd_rows, launches, card):
    out = []
    for name, (src, replaces) in SOURCES.items():
        rows = ([dict(r, name="rmsnorm") for r in rms_rows]
                if name == "rmsnorm" else
                [r for r in fd_rows if r["name"] == name])
        dtype, shape, splits = REPORTED[name]
        rep = next(r for r in rows if r["dtype"] == dtype
                   and (shape is None or r["shape"] == shape)
                   and (splits is None or r["n_splits"] == splits))
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["dtype"] == "float32"),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "dtype": dtype,
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
        rms_rows = rmsnorm_phase(dev, flush, gen)
        fd_rows = flash_decode_phase(dev, flush, gen)
    del flush
    print(f"[kernels] ok in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    served = serve_phase(dev)
    print(f"[serve] ok in {time.perf_counter() - t0:.1f}s")

    line = kernels_line(rms_rows, fd_rows, served["launches"], card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": rms_rows + fd_rows, "serve": served,
             "build_s": took, "total_s": time.perf_counter() - t_start},
            indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
