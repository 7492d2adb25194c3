"""Training CLI of the port, on one device:
``python -m repro_torch.launch.train --arch qwen3-0.6b --steps 20``

Runs on CUDA (``--device cuda``, the default) with the hand-written
kernels (``--kernels cuda``: RMSNorm forward/backward and flash-attention
forward/backward) or the plain PyTorch layers (``--kernels torch``);
``--device cpu`` runs on the host, where the kernel path uses each
kernel's plain version.  Without a card and without ``--device cpu`` it
raises.  Weights are random, from ``--seed``; the data is the seeded
synthetic corpus or a flat uint16 token file.  Prints a loss line per
logging step, then ``done: loss a -> b``.  Parallelism strategies,
topologies and checkpoints come with later slices (ROADMAP Queue 1).

``--profile DIR`` trains ``PROFILE_STEPS`` more steps (warm) under
``torch.profiler``, each ending in a device sync, writes the op table
``DIR/ops.txt`` and prints one JSON line: wall and device-busy time per
step, the host spans' time per step, and the kernels that fill the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch import telemetry as tel
from repro_torch.configs import get_config, reduced
from repro_torch.data import Batcher, BinTokenSource, SyntheticSource
from repro_torch.device import card_description, resolve_device
from repro_torch.models import Runtime, init_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train_loop

IMPLS = {"cuda": "kernel", "torch": "torch"}
PROFILE_STEPS = 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq_len", type=int, default=512)
    ap.add_argument("--global_batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad_accum", type=int, default=1)
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a path to a flat uint16 token file")
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kernels", default="cuda", choices=sorted(IMPLS),
                    help="cuda: RMSNorm and flash attention (forward and "
                         "backward) on the hand-written kernels; torch: "
                         "plain PyTorch layers")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace/Perfetto JSON of the run's "
                         "spans here")
    ap.add_argument("--metrics_jsonl", default="",
                    help="stream every telemetry event as JSONL here")
    ap.add_argument("--profile", default="",
                    help="train a few more steps under torch.profiler and "
                         "write ops.txt into this directory")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    impl = IMPLS[args.kernels]
    rt = Runtime(attn_impl=impl, norm_impl=impl,
                 attn_min_chunked_len=max(2048, args.seq_len + 1)
                 if args.seq_len <= 2048 else 2048)
    src = (SyntheticSource(cfg.vocab_size, seed=args.seed)
           if args.data == "synthetic" else BinTokenSource(args.data))
    batches = Batcher(src, args.seq_len, args.global_batch)
    tc = TrainConfig(steps=args.steps, warmup=max(args.steps // 20, 1),
                     log_every=args.log_every, grad_accum=args.grad_accum,
                     opt=AdamWConfig(lr=args.lr))
    params = init_params(cfg, args.seed, device)

    recorder = tel.NULL
    if args.trace or args.metrics_jsonl:
        recorder = tel.Recorder()
        if args.metrics_jsonl:
            recorder.add_sink(tel.JsonlSink(args.metrics_jsonl))
        if args.trace:
            recorder.add_sink(tel.ChromeTraceSink(
                args.trace, process_name=f"train {cfg.name}"))
    where = card_description(device) if device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} seq_len={args.seq_len} "
          f"global_batch={args.global_batch} grad_accum={args.grad_accum} "
          f"kernels={args.kernels} device={device} ({where})")
    params, opt_state, history = train_loop(cfg, rt, tc, batches, params,
                                            telemetry=recorder)
    recorder.close()
    if args.trace:
        print(f"[telemetry] trace written to {args.trace}")
    losses = [h["loss"] for h in history]
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"over {args.steps} steps")
    if args.profile:
        profile_steps(cfg, rt, tc, batches, params, opt_state, args, device)
    return history


def profile_steps(cfg, rt, tc, batches, params, opt_state, args, device,
                  top=12):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    ptc = dataclasses.replace(tc, steps=PROFILE_STEPS, log_every=1)
    with profile(activities=acts) as prof:
        train_loop(cfg, rt, ptc, batches, params, opt_state,
                   telemetry=tel.Recorder())
    os.makedirs(args.profile, exist_ok=True)
    tel.write_op_table(prof, os.path.join(args.profile, "ops.txt"),
                       device.type == "cuda")
    n, wall, busy, by_name, counts = tel.device_time_in_spans(prof,
                                                             "train/step")
    host = {name: tel.host_time_in_span(prof, name) / 1e3 / n
            for name in ("train/dispatch", "train/data", "train/wait")}
    rep = {"steps": n, "wall_ms_per_step": wall / 1e3 / n,
           "host_span_ms_per_step": host, "device_ms_per_step": None,
           "device_busy_share": None, "kernel_launches_per_step": None,
           "top_kernels": [], "kernels": args.kernels,
           "global_batch": args.global_batch, "seq_len": args.seq_len}
    if counts:
        rep.update(
            device_ms_per_step=busy / 1e3 / n, device_busy_share=busy / wall,
            kernel_launches_per_step=sum(counts.values()) / n,
            top_kernels=[{"name": k[:80], "ms_per_step": t / 1e3 / n,
                          "launches_per_step": counts[k] / n}
                         for k, t in by_name.most_common(top)])
    print(json.dumps({"profile": rep}))


if __name__ == "__main__":
    main()
