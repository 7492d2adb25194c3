"""Serving CLI of the port: batched generation through the paged engine or
the static dense-cache engine.

``python -m repro_torch.launch.serve --arch qwen3-0.6b --n_new 32``

``--strategy`` routes through the strategy API, as the JAX CLI's does:
'' (the default) serves on one device; 'auto' asks the planner for the
decode shape (``ShapeConfig("serve", prompt_len + n_new, batch,
"decode")``); anything else is a spec such as ``tp2``, ``fsdp_tp2`` or
``fsdp_cp2`` (the prompt's prefill split along the sequence over the model
axis, K/V gathered, the cache's slots split over it; decode merges over
the slots).
Under a strategy the process group comes up (``launch.mesh``: one rank
alone, or every rank of ``torchrun --standalone --nproc_per_node N -m
repro_torch.launch.serve ...``, gloo with ``--device cpu``), the plan's
parameters are placed by ``core.parallel.apply_plan`` and the engine
serves statically from caches placed by ``cache_shardings``; rank 0
prints.  ``--engine auto`` pages where it can (one device, an
attention-only stack), ``static`` forces the dense-cache loop, and
``paged`` refuses a plan or a recurrent stack (``rwkv6-1.6b`` and the
hybrid ``jamba-v0.1-52b`` serve statically).

Runs on CUDA (``--device cuda``, the default) with the hand-written
kernels (``--kernels cuda``) or the plain PyTorch layers
(``--kernels torch``); ``--device cpu`` runs on the host, where the kernel
path uses each kernel's plain version.  Without a card and without
``--device cpu`` it raises.  Weights are random, from ``--seed``.

``--profile DIR`` serves the same prompts a second time (warm) under
``torch.profiler``, writes the op table ``DIR/ops.txt`` (by device time
and by host time), and prints one JSON line: wall time per decode step,
the device's busy share inside decode segments, and the kernels that fill
it (paged engine).  Profiling slows the host several-fold, so the busy
share it prints is a lower bound; time the run without it.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import strategy as strategy_lib
from repro_torch import telemetry as tel
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import parallel as par
from repro_torch.device import card_description, resolve_device
from repro_torch.launch.mesh import init_distributed, local_rank, shutdown
from repro_torch.models import Runtime, init_params
from repro_torch.serve import ServeEngine
from repro_torch.strategy.topology import mesh_shape

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
    ap.add_argument("--strategy", default="",
                    help="'' = single-device; 'auto' = planner (decode "
                         "shape); else a spec string like tp2 / fsdp_tp2")
    ap.add_argument("--topology", default="host",
                    help="host | pod | multipod[<k>] (a pod mesh needs as "
                         "many ranks)")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "paged", "static"],
                    help="auto pages where it can (one device, an "
                         "attention-only stack); static forces the "
                         "dense-cache loop")
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

    device = resolve_device(args.device, local_rank() if args.strategy
                            else None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if not args.strategy:
        return _serve(args, cfg, device)
    init_distributed(device)
    try:
        return _serve(args, cfg, device)
    finally:
        shutdown()


def make_engine(cfg, device, *, strategy: str = "", topology: str = "host",
                batch: int = 4, max_len: int = 64, kernels: str = "cuda",
                seed: int = 0, n_slots: int = 8, telemetry=tel.NULL,
                verbose: bool = False):
    """The engine the CLI serves with -> (engine, plan or None).  With a
    ``strategy`` ('auto': the planner for the decode shape (``batch``
    rows of ``max_len`` positions); else a spec) on this process group's
    ranks: ``resolve`` -> ``to_plan`` -> ``make_runtime`` -> ``apply_plan``
    on weights from ``seed``; without one, the weights on ``device``."""
    impl = IMPLS[kernels]
    plan = None
    if strategy:
        topo = strategy_lib.get_topology(topology)
        shape = ShapeConfig("serve", max_len, batch, "decode")
        strat, _ = strategy_lib.resolve(strategy, cfg, topo, shape)
        plan = strat.to_plan(cfg, topo, shape)
        if verbose:
            print(f"[strategy] {strat.format()} on {topo.name} (mesh "
                  f"{mesh_shape(plan.mesh)}, attn={plan.attn}, cache axes "
                  f"{plan.decode_cache_axes})")
        # dtypes from the strategy's precision policy; no remat, WKV-6
        # chunk 16 and selective-scan chunk 32, as the JAX serve CLI sets
        # them
        rt = par.make_runtime(cfg, plan, shape, attn_impl=impl,
                              norm_impl=impl, remat=False, rwkv_chunk=16,
                              mamba_chunk=32)
        params = par.apply_plan(init_params(cfg, seed, device), plan, cfg)
    else:
        rt = Runtime(attn_impl=impl, norm_impl=impl, rwkv_chunk=16,
                     mamba_chunk=32)
        params = init_params(cfg, seed, device)
    return ServeEngine(cfg, params, rt, max_len=max_len, plan=plan,
                       seed=seed, n_slots=n_slots, telemetry=telemetry,
                       device=device), plan


def _serve(args, cfg, device):
    max_len = args.prompt_len + args.n_new
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    recorder = tel.Recorder()
    if args.metrics_jsonl and main_rank:
        recorder.add_sink(tel.JsonlSink(args.metrics_jsonl))
    if args.trace and main_rank:
        recorder.add_sink(tel.ChromeTraceSink(
            args.trace, process_name=f"serve {cfg.name}"))
    engine, plan = make_engine(
        cfg, device, strategy=args.strategy, topology=args.topology,
        batch=args.batch, max_len=max_len, kernels=args.kernels,
        seed=args.seed, n_slots=args.n_slots, telemetry=recorder,
        verbose=main_rank)
    if args.engine == "paged" and not engine.paged_ok:
        raise SystemExit("--engine paged needs a single-device plan and an "
                         "attention-only stack")
    use_paged = engine.paged_ok and args.engine != "static"
    generate = engine.generate if use_paged else engine.generate_static

    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    # warm-up: one short request runs the prefill and decode shapes once,
    # so the timed run excludes kernel builds and first-use library loads
    generate(prompts[:1, :min(args.prompt_len, engine.prefill_chunk)],
             1 + min(args.n_new, 1))
    recorder.metrics = tel.MetricsRegistry()   # report the timed run only
    t0 = time.perf_counter()
    out = generate(prompts, args.n_new, temperature=args.temperature,
                   seed=args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    where = card_description(device) if device.type == "cuda" else "cpu"
    if main_rank:
        print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
              f"new={args.n_new} kernels={args.kernels} "
              f"engine={'paged' if use_paged else 'static'} device={device}"
              + (f" ranks={dist.get_world_size()}" if plan else ""))
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
    if args.trace and main_rank:
        print(f"[telemetry] trace written to {args.trace}")
    if out.shape != (args.batch, args.prompt_len + args.n_new):
        raise RuntimeError(f"unexpected output shape {out.shape}")
    if args.profile and use_paged:
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
