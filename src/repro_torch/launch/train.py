"""Training CLI of the port:
``python -m repro_torch.launch.train --arch qwen3-0.6b --steps 20``

Strategy selection goes through ``repro_torch.strategy``, as the JAX
CLI's does:

  --strategy auto        the planner picks the best strategy the port can
                         run for (arch, topology, batch) with the copied
                         cost model (``--objective``, throughput by default)
  --strategy fsdp_bf16   an explicit spec: dp mode ``ddp``/``fsdp``/``hsdp``,
                         ZeRO ``z0``/``z2``/``z3``, ``ovl``, ``ga<k>``,
                         precision ``f32``/``bf16``/``fp8``, tensor
                         parallelism ``tp<k>`` (head-TP with Megatron-SP;
                         ``nosp`` keeps the residual stream whole),
                         pipeline parallelism ``pp<k>_mb<m>`` with a
                         schedule ``gpipe``/``1f1b``/``1f1b_i<v>``/``zb``,
                         expert parallelism ``ep<k>`` (MoE archs: the
                         expert all-to-all over an expert axis factored
                         out of data), context parallelism ``cp<k>`` (the
                         sequence sharded over the model axis, K/V
                         gathered; also what a ``tp<k>`` whose heads do
                         not split, or ``_ctx``, resolves to), and tp or
                         pp on a MoE arch (its experts split over the
                         model axis; dbrx-132b's uniform stack pipelines)

``--topology host`` (the default) is every rank of this job as one island.
The strategy runs on the plan's ``DeviceMesh`` ([pipe x] data axes x model
axis): pipeline stages over the pipe axis, tensor parallelism over the
model axis, FSDP2 over the data axes; one rank on one card (a 1-rank NCCL
group), N ranks under ``torchrun --standalone --nproc_per_node N -m
repro_torch.launch.train ...`` (one card each, or gloo processes with
``--device cpu``; ``--strategy fsdp_tp2`` on 2 ranks is one model group
of 2, ``fsdp_cp2`` each rank half of every sequence,
``fsdp_pp2_mb4_1f1b`` two pipeline stages).  Every rank builds the
same global batch and trains the rows of its data-parallel coordinate;
rank 0 prints, and the ``[strategy]`` line shows the mesh, model and pipe
axes included.

Runs on CUDA (``--device cuda``, the default) with the hand-written
kernels (``--kernels cuda``: RMSNorm forward/backward and flash-attention
forward/backward for attention stacks such as ``qwen3-0.6b``, in f32 or
bf16 as the policy computes; the WKV-6 forward for ``rwkv6-1.6b``, whose
backward replays the plain chunked form) or the plain PyTorch layers
(``--kernels torch``); ``--device cpu`` runs on the host, where the
kernel path uses each kernel's plain version.  Without a card and without
``--device cpu`` it raises.  Weights are random, from ``--seed``; the data
is the seeded synthetic corpus or a flat uint16 token file.  Prints a loss
line per logging step, then ``done: loss a -> b``.

Checkpoints and resilience, as the JAX CLI's: ``--ckpt_every N`` saves the
training state every N steps to ``--ckpt_dir`` (default
``results/ckpt/<arch>``) in the JAX package's layout (rank 0 writes;
``--async_ckpt`` writes in a background thread, ``--ckpt_keep K`` keeps
the newest K), ``--resume`` restores the newest CRC-valid one,
``--fault_plan`` injects faults (``crash@<step>[,..]`` or a ``FaultPlan``
JSON file) and ``--max_restarts N`` (> 0) supervises the run
(``resilience.supervise_training``: restore and retry up to N times, a
crash that loses devices re-plans onto the survivors), printing
``[supervisor] recovered from N failure(s)`` and writing
``--event_log``.  Under torchrun every rank runs the same plan and
supervisor.

``--drift_report PATH`` writes the cost model's predicted step-time
decomposition for the resolved strategy beside each logging window's
measured one (``telemetry.DriftMonitor``: ``step``, ``dispatch``,
``wait``, ``data`` seconds per step) and sets the ``train/mfu`` gauge;
under torchrun rank 0 writes it.

``--profile DIR`` trains ``PROFILE_STEPS`` more steps (warm) under
``torch.profiler``, each ending in a device sync, writes the op table
``DIR/ops.txt`` and prints one JSON line (rank 0): wall and device-busy
time per step, the host spans' time per step, and the kernels that fill
the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch
import torch.distributed as dist

from repro_torch import strategy as strategy_lib
from repro_torch import telemetry as tel
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import parallel as par
from repro_torch.data import Batcher, BinTokenSource, SyntheticSource
from repro_torch.device import card_description, resolve_device
from repro_torch.launch.mesh import init_distributed, local_rank, shutdown
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.resilience import (SupervisorConfig, load_fault_plan,
                                    supervise_training)
from repro_torch.strategy.topology import mesh_shape
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
    ap.add_argument("--grad_accum", type=int, default=0,
                    help="0 -> take it from the strategy spec (ga<k>)")
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a path to a flat uint16 token file")
    ap.add_argument("--ckpt_dir", default="")
    ap.add_argument("--ckpt_every", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--topology", default="host",
                    help="host | pod | multipod[<k>] (pod meshes need as "
                         "many ranks)")
    ap.add_argument("--strategy", default="auto",
                    help="'auto' (planner) or a spec string like fsdp / "
                         "hsdp_z2_ovl / ddp_ga2 / fsdp_bf16 / fsdp_tp2 / "
                         "fsdp_pp2_mb4_1f1b")
    ap.add_argument("--objective", default="wps",
                    choices=sorted(strategy_lib.OBJECTIVES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kernels", default="cuda", choices=sorted(IMPLS),
                    help="cuda: the hand-written kernels (RMSNorm and "
                         "flash attention forward and backward; the WKV-6 "
                         "forward of RWKV-6 stacks); torch: plain PyTorch "
                         "layers")
    # resilience: supervised restarts, fault injection, async checkpointing
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid checkpoint in ckpt_dir")
    ap.add_argument("--async_ckpt", action="store_true",
                    help="snapshot on-thread, write checkpoints in background")
    ap.add_argument("--ckpt_keep", type=int, default=0,
                    help="gc all but the newest N checkpoints (0 = keep all)")
    ap.add_argument("--max_restarts", type=int, default=0,
                    help="supervise the run: restart up to N times on "
                         "failure, restoring from the latest valid ckpt")
    ap.add_argument("--fault_plan", default="",
                    help="inject faults: 'crash@<step>[,..]' or a FaultPlan "
                         "JSON path")
    ap.add_argument("--event_log", default="",
                    help="write the supervisor's structured event log here")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace/Perfetto JSON of the run's "
                         "spans here")
    ap.add_argument("--metrics_jsonl", default="",
                    help="stream every telemetry event as JSONL here")
    ap.add_argument("--drift_report", default="",
                    help="write per-window predicted-vs-measured step-time "
                         "drift (cost model vs telemetry spans) here")
    ap.add_argument("--profile", default="",
                    help="train a few more steps under torch.profiler and "
                         "write ops.txt into this directory")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, local_rank())
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    init_distributed(device)
    try:
        return _train(args, cfg, device)
    finally:
        shutdown()


def _train(args, cfg, device):
    main_rank = dist.get_rank() == 0
    topo = strategy_lib.get_topology(args.topology)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    strat, planned = strategy_lib.resolve(args.strategy, cfg, topo, shape,
                                          objective=args.objective)
    plan = strat.to_plan(cfg, topo, shape)
    if main_rank and planned is not None:
        r = planned.report
        print(f"[planner] chose {strat.format()} on {topo.name} "
              f"({topo.n_devices}x {topo.hardware}): predicted "
              f"{r.wps:,.0f} tok/s, mfu {r.mfu:.3f}, "
              f"{r.memory_per_device / 2**30:.2f} GiB/dev")
    elif main_rank:
        print(f"[strategy] {strat.format()} on {topo.name} "
              f"(mesh {mesh_shape(plan.mesh)})")
    impl = IMPLS[args.kernels]
    # dtypes from the strategy's precision policy; no remat, WKV-6 chunk
    # 32 and selective-scan chunk 64, as the JAX train CLI sets them
    rt_overrides = dict(attn_impl=impl, norm_impl=impl, remat=False,
                        rwkv_chunk=32, mamba_chunk=64,
                        attn_min_chunked_len=max(2048, args.seq_len + 1)
                        if args.seq_len <= 2048 else 2048)
    rt = par.make_runtime(cfg, plan, shape, **rt_overrides)

    def make_batches():
        # fresh per attempt: sources are stateful; a resumed attempt
        # replays the stream and skips to the restored position
        src = (SyntheticSource(cfg.vocab_size, seed=args.seed)
               if args.data == "synthetic" else BinTokenSource(args.data))
        return Batcher(src, args.seq_len, args.global_batch)

    grad_accum = args.grad_accum or strat.grad_accum
    tc = TrainConfig(steps=args.steps, warmup=max(args.steps // 20, 1),
                     log_every=args.log_every, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir or os.path.join("results", "ckpt",
                                                            cfg.name),
                     grad_accum=grad_accum, opt=AdamWConfig(lr=args.lr),
                     ckpt_async=args.async_ckpt, ckpt_keep=args.ckpt_keep,
                     resume=args.resume)
    fault_plan = load_fault_plan(args.fault_plan) if args.fault_plan else None

    recorder = tel.NULL
    if main_rank and (args.trace or args.metrics_jsonl or args.drift_report):
        recorder = tel.Recorder()
        if args.metrics_jsonl:
            recorder.add_sink(tel.JsonlSink(args.metrics_jsonl))
        if args.trace:
            recorder.add_sink(tel.ChromeTraceSink(
                args.trace, process_name=f"train {cfg.name}"))
    drift = None
    if main_rank and args.drift_report:
        drift = drift_monitor(cfg, strat, planned, topo, shape, recorder)
    where = card_description(device) if device.type == "cuda" else "cpu"
    if main_rank:
        print(f"arch={cfg.name} seq_len={args.seq_len} "
              f"global_batch={args.global_batch} grad_accum={grad_accum} "
              f"kernels={args.kernels} ranks={dist.get_world_size()} "
              f"device={device} ({where})")
    if args.max_restarts > 0:
        params, opt_state, history, sup = supervise_training(
            cfg, strat, topo, shape, tc, make_batches,
            rt_overrides=rt_overrides, seed=args.seed, device=device,
            fault_plan=fault_plan,
            sup_cfg=SupervisorConfig(max_restarts=args.max_restarts,
                                     event_log_path=args.event_log),
            telemetry=recorder, drift=drift)
        n_failures = sum(e["kind"] == "failure" for e in sup.events)
        if main_rank and n_failures:
            print(f"[supervisor] recovered from {n_failures} failure(s)"
                  + (f"; event log: {args.event_log}" if args.event_log
                     else ""))
    else:
        params = par.apply_plan(init_params(cfg, args.seed, device), plan,
                                cfg)
        params, opt_state, history = train_loop(
            cfg, rt, tc, make_batches(), params, telemetry=recorder,
            plan=plan, drift=drift, fault_plan=fault_plan, seed=args.seed)
    recorder.close()
    if params is None:        # outside the mesh of a degraded re-plan
        return history
    if main_rank and args.trace:
        print(f"[telemetry] trace written to {args.trace}")
    if drift is not None:
        drift.write(args.drift_report)
        mean = drift.summary()["mean_predicted_over_measured"]
        terms = ", ".join(f"{t}={r:.3g}" for t, r in mean.items())
        print(f"[telemetry] drift report -> {args.drift_report}"
              + (f" (predicted/measured: {terms})" if terms else ""))
    losses = [h["loss"] for h in history]
    if main_rank:
        print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"over {args.steps} steps")
    if args.profile:
        profile_steps(cfg, rt, tc, make_batches(), params, opt_state, args,
                      device, plan, main_rank)
    return history


def drift_monitor(cfg, strat, planned, topo, shape,
                  recorder=tel.NULL) -> tel.DriftMonitor:
    """The drift monitor of ``--drift_report``: the predicted side is the
    cost model's decomposition of the resolved strategy (the planner's
    report, or ``strategy.evaluate``); ``meta`` carries the model flops a
    step and the cluster's peak, inverted from the report's MFU, so the
    trainer can gauge the measured ``train/mfu``."""
    report = planned.report if planned is not None else \
        strategy_lib.evaluate(cfg, strat, topo, shape)
    hw = topo.hw
    return tel.DriftMonitor(
        report.decomposition(), telemetry=recorder,
        meta={"spec": strat.format(), "topology": topo.name,
              "hardware": topo.hardware, "arch": cfg.name,
              "seq_len": shape.seq_len, "global_batch": shape.global_batch,
              "model_flops_per_step":
                  report.mfu * report.t_step * topo.n_devices
                  * hw.flops_bf16,
              "cluster_peak_flops": topo.n_devices * hw.flops_bf16})


def profile_steps(cfg, rt, tc, batches, params, opt_state, args, device,
                  plan, main_rank, top=12):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    ptc = dataclasses.replace(tc, steps=PROFILE_STEPS, log_every=1,
                              ckpt_every=0, resume=False)
    with profile(activities=acts) as prof:
        train_loop(cfg, rt, ptc, batches, params, opt_state,
                   telemetry=tel.Recorder(), plan=plan)
    if not main_rank:
        return
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
           "global_batch": args.global_batch, "seq_len": args.seq_len,
           "strategy": args.strategy, "ranks": dist.get_world_size(),
           "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                            if device.type == "cuda" else None)}
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
