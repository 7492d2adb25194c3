"""Serving CLI of the port: batched generation through the paged engine.

``python -m repro_torch.launch.serve --arch qwen3-0.6b --n_new 32``

Runs on CUDA (``--device cuda``, the default) with the hand-written
kernels (``--kernels cuda``) or the plain PyTorch layers
(``--kernels torch``); ``--device cpu`` runs on the host, where the kernel
path uses each kernel's plain version.  Without a card and without
``--device cpu`` it raises.  Weights are random, from ``--seed``.

``--profile DIR`` serves the same prompts a second time (warm) under
``torch.profiler``, writes the op table ``DIR/ops.txt`` (by device time
and by host time), and prints one JSON line: wall time per decode step,
the device's busy share inside decode segments, and the kernels that fill
it.  Profiling slows the host several-fold, so the busy share it prints
is a lower bound; time the run without it.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import telemetry as tel
from repro_torch.configs import get_config, reduced
from repro_torch.device import card_description, resolve_device
from repro_torch.models import Runtime, init_params
from repro_torch.serve import ServeEngine

IMPLS = {"cuda": "kernel", "torch": "torch"}


def decode_breakdown(prof, steps_per_segment: int, top: int = 12):
    """Device time inside the engine's ``serve/decode_segment`` spans.

    Each segment ends by reading its tokens back, so every kernel it
    launched has finished before its span closes.  -> {wall and device ms
    per decode step, busy share, top kernels by device time}; device
    numbers are None when the profiler recorded no kernels.
    """
    n_seg, wall, busy, by_name, counts = tel.device_time_in_spans(
        prof, "serve/decode_segment")
    steps = n_seg * steps_per_segment
    out = {"decode_segments": n_seg, "decode_steps": steps,
           "wall_ms_per_step": wall / 1e3 / max(steps, 1),
           "device_ms_per_step": None, "device_busy_share": None,
           "kernel_launches_per_step": None, "top_kernels": []}
    if counts and steps:
        out.update(
            device_ms_per_step=busy / 1e3 / steps,
            device_busy_share=busy / wall,
            kernel_launches_per_step=sum(counts.values()) / steps,
            top_kernels=[{"name": n[:80], "ms_per_step": t / 1e3 / steps,
                          "launches_per_step": counts[n] / steps}
                         for n, t in by_name.most_common(top)])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--n_new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kernels", default="cuda", choices=sorted(IMPLS),
                    help="cuda: RMSNorm and paged decode attention on the "
                         "hand-written kernels; torch: plain PyTorch layers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_slots", type=int, default=8,
                    help="in-flight batch bound of the paged engine")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace/Perfetto JSON of engine "
                         "ticks/prefill/decode spans here")
    ap.add_argument("--metrics_jsonl", default="",
                    help="stream every telemetry event as JSONL here")
    ap.add_argument("--profile", default="",
                    help="serve the prompts again under torch.profiler and "
                         "write ops.txt into this directory")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    max_len = args.prompt_len + args.n_new
    impl = IMPLS[args.kernels]
    rt = Runtime(attn_impl=impl, norm_impl=impl)
    params = init_params(cfg, args.seed, device)

    recorder = tel.Recorder()
    if args.metrics_jsonl:
        recorder.add_sink(tel.JsonlSink(args.metrics_jsonl))
    if args.trace:
        recorder.add_sink(tel.ChromeTraceSink(
            args.trace, process_name=f"serve {cfg.name}"))
    engine = ServeEngine(cfg, params, rt, max_len=max_len, seed=args.seed,
                         n_slots=args.n_slots, telemetry=recorder,
                         device=device)

    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    # warm-up: one short request runs the prefill-chunk (1, C) and decode
    # (n_slots, 1) shapes once, so the timed run excludes kernel builds and
    # first-use library loads (both shapes are fixed whatever the traffic)
    engine.generate(prompts[:1, :min(args.prompt_len, engine.prefill_chunk)],
                    1 + min(args.n_new, 1))
    recorder.metrics = tel.MetricsRegistry()   # report the timed run only
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.n_new, temperature=args.temperature,
                          seed=args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    where = card_description(device) if device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.n_new} kernels={args.kernels} device={device}")
    print(f"generated {args.batch * args.n_new} tokens in {dt:.2f}s "
          f"({args.batch * args.n_new / dt:.1f} tok/s on {where})")
    print("first sequence tail:", out[0, -min(16, args.n_new):].tolist())
    snap = recorder.metrics.snapshot()
    for name, label in (("serve/ttft_s", "ttft"),
                        ("serve/token_latency_s", "token latency")):
        h = snap.get(name)
        if h and h.get("count"):
            print(f"[telemetry] {label} p50 {h['p50'] * 1e3:.2f}ms "
                  f"p99 {h['p99'] * 1e3:.2f}ms over {h['count']}")
    recorder.close()
    if args.trace:
        print(f"[telemetry] trace written to {args.trace}")
    if out.shape != (args.batch, args.prompt_len + args.n_new):
        raise RuntimeError(f"unexpected output shape {out.shape}")
    if args.profile:
        profile_run(engine, prompts, args, device)


def profile_run(engine, prompts, args, device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        engine.generate(prompts, args.n_new, temperature=args.temperature,
                        seed=args.seed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    os.makedirs(args.profile, exist_ok=True)
    tel.write_op_table(prof, os.path.join(args.profile, "ops.txt"),
                       device.type == "cuda")
    rep = decode_breakdown(prof, engine.steps_per_tick)
    rep.update(kernels=args.kernels, batch=args.batch,
               prompt_len=args.prompt_len, n_new=args.n_new,
               profiled_wall_s=wall)
    print(json.dumps({"profile": rep}))


if __name__ == "__main__":
    main()
