"""Multi-pod dry run of the port: trace one step of every (architecture x
input shape) on the production meshes without hardware — a train step, a
prefill or a decode step — and record its memory, collective, FLOP and
resilience terms: the port of the JAX package's ``launch/dryrun.py``.

JAX lowers and compiles each point on 512 fake XLA devices.  Here the
devices are the ranks of a *fake process group*
(``torch.testing._internal.distributed.fake_pg``): the default group has
the topology's world size, this process plays one rank of it, and every
collective returns at once.  Parameters, moments and the batch are fake
tensors (``FakeTensorMode``: shapes, dtypes and devices, no memory).  The
plan goes through the path ``launch.train`` takes — ``to_plan`` ->
``apply_plan`` (FSDP2 and the tensor-parallel ``DTensor``s) — and one
step runs on it under :class:`~repro_torch.perf.memory.MemoryTracker` and
:class:`~repro_torch.perf.comms.CollectiveCensus`: for a train shape a
train step (forward, backward, AdamW, with the strategy's ``ga<k>``); for
a prefill shape ``serve.engine.make_prefill`` on the global prompts (this
rank's rows into fresh caches placed by ``core.parallel.cache_shardings``);
for a decode shape ``make_serve_step`` on this rank's tokens against
caches of ``seq_len`` positions placed the same way, as the JAX dry run
lowers them.  The serving points' memory gains a ``cache`` category, and
the record the cache's exact bytes per device (``cache_bytes_per_device``).
The fake tensors lie on ``--device`` (``cuda`` by default, which needs a
card: the FSDP2 mesh is then a CUDA mesh; ``--device cpu`` on a host
without one, where a CPU-only PyTorch cannot fake CUDA through FSDP2 and
the bytes are the same).  Without a card and without ``--device cpu`` the
dry run exits with an error: nothing falls back to the host.

The step takes the kernel path (``--kernels cuda``, the default): on fake
tensors each kernel wrapper takes its shape-only branch, which allocates
and saves what the kernel does (flash attention keeps o and lse, not the
plain path's S x S scores) and launches nothing.  ``--kernels torch``
traces the plain layers.

A pipeline's stages run different programs (the first stage embeds, the
last holds the head and the loss), so under pp > 1 pipe rank 0 and pipe
rank P-1 are both traced, each on a fake group of its own rank, and the
record keeps both peaks and the larger.  Each traced rank runs in a
fresh process (:func:`lower_fresh`).  ``--measure_bubble`` (pp > 1,
``--topology host`` under ``torchrun`` with a rank per device) then runs
``perf.pipeline_probe`` on the live group.

The record keeps JAX's keys where the meaning is the same.  ``memory`` is
the peak bytes per device, split into parameters, gradients, optimizer
state, activations and temporaries (``perf.memory``; what a backward
reruns under remat is a temporary); ``trace_s`` stands
where JAX has ``lower_s``; ``remat`` (the runtime's: true on a train
shape, as ``make_runtime`` sets it and the JAX dry run lowers it, each
block checkpointed) tells the roofline (``perf.roofline``) how to price
it, and ``flops_compiled_analytic`` counts the recompute.  A recompute
reruns a block as far as its backward needs (``torch.utils.checkpoint``
stops there, before a block's last collective): the kernels, collectives
and MoE dispatches it reruns are work done, which the census,
``collective_sites`` and ``moe_dispatch`` count (under ``ep<k>`` a MoE
layer dispatches twice a train step and exchanges six times).
``--remat_inner``, ``--attn_q_chunk`` and ``--attn_kv_chunk`` override
the runtime as in JAX; the two chunks size the plain blocked attention
(``--kernels torch`` at S > 2048) and are refused under ``--kernels
cuda``, whose flash kernels tile their own.  The XLA-only fields are left out:
``flops_hlo_per_device_raw``, ``bytes_accessed_per_device_raw``,
``generated_code_bytes`` and ``compile_s``.  A MoE arch's record also
counts its MoE layer calls by dispatch entry (``moe_dispatch``), and its
census the expert all-to-all.  An arch of ``repro_torch.configs.LATER``
(none is left) would need its own slice, and ``long_500k``
needs a sub-quadratic mixer (``configs.supports_shape``, the JAX
package's reason): those points are recorded as ``status: "skipped"``
with the reason.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --both_meshes
  python -m repro_torch.launch.dryrun ... --out results/dryrun_torch
  python -m repro_torch.launch.dryrun ... --device cpu    # no card
  torchrun --standalone --nproc_per_node 2 -m repro_torch.launch.dryrun \\
      --arch qwen3-0.6b --shape train_4k --topology host --reduced \\
      --strategy fsdp_pp2_mb4 --measure_bubble --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import strategy as strategy_lib
from repro_torch import telemetry as tel
from repro_torch.configs import (LATER, REGISTRY, SHAPES, get_config,
                                 reduced, supports_shape)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import parallel as par
from repro_torch.core import pipeline as pipe_lib
from repro_torch.device import resolve_device
from repro_torch.launch import specs as specs_lib
from repro_torch.models import init_params
from repro_torch.models import layers as layers_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import init_opt_state
from repro_torch.perf import flops as flops_lib
from repro_torch.perf.comms import CollectiveCensus, total_bytes
from repro_torch.perf.memory import MemoryTracker
from repro_torch.serve.engine import make_prefill, make_serve_step
from repro_torch.strategy.topology import mesh_shape
from repro_torch.train.trainer import TrainConfig, make_train_step

IMPLS = {"cuda": "kernel", "torch": "torch"}
SUBQUADRATIC = "requires sub-quadratic attention (the JAX package's reason)"
# the JAX sweep's archs (its ASSIGNED set), all ten ported (and any of
# LATER, which is empty)
ARCHS = sorted({"qwen3-0.6b", "rwkv6-1.6b", "qwen2-1.5b", "h2o-danube-1.8b",
                "granite-20b", "deepseek-moe-16b", "dbrx-132b",
                "musicgen-medium", "qwen2-vl-2b", "jamba-v0.1-52b", *LATER})


def resolve_strategy(cfg, shape, topo, strategy: str, dp_mode: str = "hsdp",
                     attn_override=None, seq_parallel: bool = True):
    """Map (--strategy, legacy flags) to a Strategy descriptor.

    '' (default) keeps the paper's pod layout — model axis 16 — with the
    legacy dp_mode/attn/sp flags folded in; 'auto' asks the planner;
    anything else is a spec string (legacy flags still apply on top unless
    the spec sets them itself)."""
    if strategy == "auto":
        s, _ = strategy_lib.resolve("auto", cfg, topo, shape)
    elif not strategy:
        s = strategy_lib.Strategy(
            dp_mode="fsdp" if dp_mode == "fsdp2d" else "hsdp", tp=16)
    else:
        s = strategy_lib.parse(strategy)
    if attn_override and s.attn is None:
        s = dataclasses.replace(s, attn=attn_override)
    if not seq_parallel:
        s = dataclasses.replace(s, seq_parallel=False)
    if dp_mode == "fsdp2d" and s.dp_mode == "hsdp":
        s = dataclasses.replace(s, dp_mode="fsdp")
    return s


def _topology(name: str, multi_pod: bool):
    """'' keeps the pod/multipod selection; 'host' is the ranks of this
    job (torchrun's WORLD_SIZE, else 1)."""
    if name == "host":
        return strategy_lib.host_topology(
            n_devices=int(os.environ.get("WORLD_SIZE", 1)))
    if name:
        return strategy_lib.get_topology(name)
    return strategy_lib.pod_topology(pods=2 if multi_pod else 1)


def skip_reason(arch: str, shape: ShapeConfig) -> Optional[str]:
    """Why this point is not traced: an arch the port has not ported yet
    (naming the slice that brings it), or a shape the arch does not
    support (``long_500k`` for full attention); None when it is."""
    if arch in LATER:
        return (f"arch {arch} arrives with the '{LATER[arch]}' slice of "
                "the PyTorch port")
    if arch in REGISTRY and not supports_shape(REGISTRY[arch], shape):
        return SUBQUADRATIC
    return None


@contextlib.contextmanager
def fake_group(world_size: int, rank: int):
    """The default process group as a fake group of ``world_size`` ranks,
    this process rank ``rank``; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run brings up its own fake process "
                           "group: destroy the live one first")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def traced_ranks(strat, topo) -> Dict[str, int]:
    """{label: global rank} of the ranks whose programs differ: rank 0,
    and under pp > 1 the first rank of the last pipe stage (the mesh is
    row-major, pipe outermost but for 'pod')."""
    if strat.pp <= 1:
        return {"rank0": 0}
    inner = topo.n_devices // (strat.n_pods(topo) * strat.pp)
    return {"pipe0": 0, f"pipe{strat.pp - 1}": (strat.pp - 1) * inner}


def lower_one(cfg: ModelConfig, shape: ShapeConfig, strat, topo,
              kernels: str = "cuda", grad_accum: int = 1, rank: int = 0,
              rt_overrides=None, device="cuda") -> Dict:
    """Trace one step of ``strat`` on ``topo`` for ``shape`` as global rank
    ``rank`` of a fake process group, the fake tensors on ``device`` ->
    {'plan', 'memory', 'collectives', 'trace_s', 'remat', 'moe_dispatch'},
    and for a serving shape 'cache_bytes_per_device'.  ``grad_accum`` > 1
    overrides the spec's ``ga<k>``.  ``moe_dispatch`` counts the MoE
    layer calls by the expert-parallel entry each took
    (``core.expert.DISPATCH_STATS``' deltas over the step)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import expert as expert_lib
    device = resolve_device(device)
    impl = IMPLS[kernels]
    extra = {}
    stats0 = expert_lib.dispatch_stats_snapshot()
    sites0 = dict(layers_lib.COLLECTIVE_SITES)
    with fake_group(topo.n_devices, rank):
        plan = strat.to_plan(cfg, topo, shape, device_type=device.type)
        rt = par.make_runtime(
            cfg, plan, shape, attn_impl=impl, norm_impl=impl,
            attn_min_chunked_len=max(2048, shape.seq_len + 1)
            if shape.seq_len <= 2048 else 2048, **(rt_overrides or {}))
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            params = init_params(cfg, 0, device)
        # the meshes' own index arithmetic runs on real tensors
        params = par.apply_plan(params, plan, cfg)
        mem, census = MemoryTracker(), CollectiveCensus()
        with fake:
            mem.register([p.to_local() for p in params.parameters()],
                         "parameters")
            if shape.mode == "train":
                took = _train_step(cfg, shape, strat, rt, plan, params,
                                   grad_accum, device, mem, census)
            else:
                with torch.no_grad():
                    took, cache = _serve_step(cfg, shape, rt, plan, params,
                                              device, mem, census)
                leaves = _leaves(cache)
                mem.relabel(leaves, "cache")
                extra["cache_bytes_per_device"] = sum(
                    t.numel() * t.element_size() for t in leaves)
                del cache, leaves
        plan_rec = {"attn": plan.attn, "kv_tp": plan.kv_tp,
                    "dp": list(plan.dp), "fsdp": list(plan.fsdp),
                    "expert": plan.expert, "mesh": mesh_shape(plan.mesh),
                    "decode_cache_axes": list(plan.decode_cache_axes)}
        del params
    stats1 = expert_lib.dispatch_stats_snapshot()
    return {"plan": plan_rec, "trace_s": round(took, 1), "remat": rt.remat,
            "moe_dispatch": {k: stats1[k] - stats0[k] for k in stats1},
            "collective_sites": {
                k: v - sites0[k]
                for k, v in layers_lib.COLLECTIVE_SITES.items()},
            "memory": {"peak_bytes_per_device": mem.peak,
                       **{f"{k}_bytes": v for k, v in
                          mem.breakdown().items()}},
            "collectives": census.stats, **extra}


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _train_step(cfg, shape, strat, rt, plan, params, grad_accum, device,
                mem, census) -> float:
    """One train step (AdamW, the spec's ``ga<k>`` unless ``grad_accum``)
    under the tracker and the census -> its trace seconds."""
    ga = grad_accum if grad_accum > 1 else strat.grad_accum
    opt_state = init_opt_state(params)
    batch = {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
             for k, s in specs_lib.train_batch_specs(cfg, shape).items()}
    step = make_train_step(cfg, rt, TrainConfig(
        steps=max(ga, 2), warmup=1, grad_accum=ga), plan)
    mem.register([t.to_local() for k in ("m", "v")
                  for t in opt_state[k].values()], "optimizer")
    mem.register(batch.values(), "activations")
    t0 = time.time()
    with census, mem:
        step(params, opt_state, batch)
    return time.time() - t0


def _serve_step(cfg, shape, rt, plan, params, device, mem, census):
    """A prefill of the global prompts (``make_prefill``: this rank's rows
    into fresh caches) or a decode step of this rank's rows
    (``make_serve_step``) against caches of ``seq_len`` positions, both
    placed by ``cache_shardings`` -> (trace seconds, the caches)."""
    if shape.mode == "prefill":
        batch = {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                 for k, s in specs_lib.prefill_batch_specs(
                     cfg, shape).items()}
        mem.register(batch.values(), "activations")
        fn = make_prefill(cfg, rt, shape.seq_len, plan)
        t0 = time.time()
        with census, mem:
            _, cache = fn(params, batch)
        return time.time() - t0, cache
    cache = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                           rt.compute_dtype, device, plan, params)
    mem.register(_leaves(cache), "cache")
    tok, pos = specs_lib.decode_token_specs(cfg, shape)
    lo, hi = par.serve_rows(plan, tok.shape[0])
    tokens = torch.zeros((hi - lo,) + tok.shape[1:], dtype=tok.dtype,
                         device=device)
    pos = torch.zeros(pos.shape, dtype=pos.dtype, device=device)
    mem.register([tokens, pos], "activations")
    step = make_serve_step(cfg, rt)
    t0 = time.time()
    with census, mem:
        _, cache = step(params, cache, tokens, pos)
    return time.time() - t0, cache


# what a traced rank runs through, imported once by the fork server; not
# this module, which a child of ``python -m repro_torch.launch.dryrun``
# runs again as its ``__mp_main__``
FORKSERVER_PRELOAD = ["torch._subclasses.fake_tensor",
                      "torch.testing._internal.distributed.fake_pg",
                      "repro_torch.core.expert", "repro_torch.launch.specs",
                      "repro_torch.perf.comms", "repro_torch.perf.memory",
                      "repro_torch.serve.engine", "repro_torch.train.trainer"]


def fresh_context():
    """The ``forkserver`` context of :func:`lower_fresh`: its server has
    imported torch and the port (``FORKSERVER_PRELOAD``) and done nothing
    else (no tensor op, no process group, no CUDA), so a process forked
    from it starts with DTensor's caches empty and imports neither again;
    a card is initialised in the child."""
    import multiprocessing
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(FORKSERVER_PRELOAD)
    return ctx


def lower_fresh(*args, **kwargs) -> Dict:
    """:func:`lower_one` in a fresh process of its own
    (:func:`fresh_context`).  DTensor caches what it propagates by mesh
    layout, not by process group, so a second fake world of the same
    layout in one process (pipe rank P-1 after pipe rank 0, or a dry run
    after a live group) would be handed meshes of the first world's
    groups."""
    import concurrent.futures
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=fresh_context()) as ex:
        return ex.submit(lower_one, *args, **kwargs).result()


def run_label(arch: str, shape_name: str, multi_pod: bool,
              strategy: str = "", tag: str = "", topology: str = ""):
    """(mesh_name, label) naming one sweep point — also its artifact path,
    so main()'s skip-if-existing check and run_one()'s writer must agree."""
    if topology:
        mesh_name = topology
    else:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if strategy:
        mesh_name += f"_{strategy}"
    label = f"{arch}_{shape_name}_{mesh_name}" + (f"_{tag}" if tag else "")
    return mesh_name, label


def resilience(cfg, strat, topo) -> Dict:
    """What the goodput model says failures cost this (strategy,
    topology) point: system MTBF, the strategy-aware checkpoint write
    time, the Young/Daly interval and the throughput fraction left."""
    cost_strat = strat.to_cost_strategy(cfg, topo)
    hw = topo.hw
    t_ck = cm.checkpoint_write_time(cfg, hw, cost_strat)
    mtbf_sys = cm.system_mtbf(hw, cost_strat.n_devices)
    g = cm.goodput(t_ck, mtbf_sys,
                   t_restart=cm.restart_time(cfg, hw, cost_strat))
    return {
        "mtbf_device_s": hw.mtbf,
        "mtbf_system_s": round(mtbf_sys, 1),
        "ckpt_bytes": cm.checkpoint_bytes(cfg),
        "distinct_writers": cm.distinct_writers(cost_strat),
        "t_ckpt_s": round(t_ck, 4),
        "young_daly_interval_s": round(
            cm.young_daly_interval(t_ck, mtbf_sys), 1),
        "goodput": round(g, 5),
    }


def pipeline_block(strat) -> Dict:
    """The analytic per-schedule bubble and in-flight microbatches, and
    the sub-tick census of the executed table."""
    return {
        "pp": strat.pp, "microbatches": strat.microbatches,
        "sched": strat.sched,
        "virtual_stages": pipe_lib.virtual_stages(strat.sched),
        "overlap": strat.overlap,
        "bubble_predicted": pipe_lib.bubble_fraction(
            strat.pp, strat.microbatches, strat.sched),
        "inflight_microbatches": pipe_lib.inflight_microbatches(
            strat.pp, strat.microbatches, strat.sched),
        "op_tick_counts": pipe_lib.op_tick_counts(
            strat.sched, strat.pp, strat.microbatches),
    }


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            dp_mode: str = "hsdp", attn_override=None, tag: str = "",
            seq_parallel: bool = True, grad_accum: int = 1,
            strategy: str = "", topology: str = "",
            use_reduced: bool = False, measure_bubble: bool = False,
            kernels: str = "cuda", rt_overrides=None,
            telemetry=None, device: str = "cuda") -> Dict:
    """Trace one point (each traced rank in a fresh process, the fake
    tensors on ``device``), write its record under ``out_dir`` and return
    it."""
    telemetry = telemetry if telemetry is not None else tel.NULL
    mesh_name, label = run_label(arch, shape_name, multi_pod, strategy, tag,
                                 topology)
    shape = SHAPES[shape_name]
    reason = skip_reason(arch, shape)
    if reason:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": reason}
        _write(out_dir, label, rec)
        print(f"[dryrun] {label}: SKIP ({reason})")
        return rec
    try:
        cfg = get_config(arch)
        if use_reduced:
            cfg = reduced(cfg)
        topo = _topology(topology, multi_pod)
        strat = resolve_strategy(cfg, shape, topo, strategy, dp_mode,
                                 attn_override, seq_parallel)
        traced = {}
        for name, rank in traced_ranks(strat, topo).items():
            with telemetry.span("dryrun/trace", label=label, rank=rank):
                traced[name] = lower_fresh(cfg, shape, strat, topo,
                                           kernels, grad_accum, rank,
                                           rt_overrides, device)
        first = next(iter(traced.values()))
        peaks = {n: t["memory"]["peak_bytes_per_device"]
                 for n, t in traced.items()}
        worst = max(peaks, key=peaks.get)
        coll = traced[worst]["collectives"]
        rec = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "ok", "strategy": strat.format(),
            "strategy_arg": strategy or "legacy-default",
            "precision": strat.precision, "plan": first["plan"],
            "kernels": kernels,
            "trace_s": round(sum(t["trace_s"] for t in traced.values()), 1),
            "n_devices": topo.n_devices,
            # the runtime's remat (make_runtime's: on for a train shape);
            # the roofline prices the FLOPs and bytes so
            "remat": first["remat"],
            "flops_compiled_analytic": flops_lib.compiled_flops(
                cfg, shape, remat=first["remat"]),
            "flops_forward_analytic": flops_lib.forward_flops(cfg, shape),
            "flops_model_6nd": flops_lib.model_flops(cfg, shape),
            "memory": traced[worst]["memory"],
            "collectives": coll,
            # the calls of the model's own sites among them: a context
            # plan's K/V all-gathers and their reduce-scatters, a MoE
            # FFN's combine over the model axis
            "collective_sites": traced[worst]["collective_sites"],
            "collective_bytes_total": total_bytes(coll),
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count(),
            "resilience": resilience(cfg, strat, topo),
        }
        if cfg.moe.n_experts:
            # which EP entry the step's MoE layer calls took: 'ep_calls'
            # the all-to-all on the rank's own tokens, 'ep_padded_calls'
            # small token counts padded to the expert group
            rec["moe_dispatch"] = traced[worst]["moe_dispatch"]
        if "cache_bytes_per_device" in traced[worst]:
            rec["cache_bytes_per_device"] = \
                traced[worst]["cache_bytes_per_device"]
        if strat.pp > 1:
            rec["memory_by_stage"] = {n: t["memory"]
                                      for n, t in traced.items()}
            rec["collectives_by_stage"] = {n: t["collectives"]
                                           for n, t in traced.items()}
            rec["pipeline"] = pipeline_block(strat)
            if measure_bubble and topology == "host" \
                    and "WORLD_SIZE" in os.environ:
                rec["pipeline"].update(_probe(arch, strat, topo, device))
        print(f"[dryrun] {label}: OK  trace {rec['trace_s']:.0f}s  "
              f"flops {rec['flops_compiled_analytic']:.3e}  "
              f"coll {rec['collective_bytes_total']:.3e}B  peak/dev "
              f"{rec['memory']['peak_bytes_per_device'] / 2**30:.2f}GiB")
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": repr(e),
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[dryrun] {label}: FAIL {e!r}")
    _write(out_dir, label, rec)
    return rec


def _probe(arch: str, strat, topo, device: str) -> Dict:
    """The bubble probe on the live group of this torchrun job (a rank per
    device of ``topo``, on ``device``), at the JAX dry run's reduced layer
    count."""
    from repro_torch.launch.mesh import init_distributed, local_rank, shutdown
    from repro_torch.perf.pipeline_probe import measure_bubble, probe_layers
    device = resolve_device(device, local_rank())
    init_distributed(device)
    try:
        probe_cfg = reduced(get_config(arch),
                            n_layers=probe_layers(strat.pp, strat.sched))
        return measure_bubble(probe_cfg, strat, topo, device)
    finally:
        shutdown()


def _write(out_dir, label, rec):
    if int(os.environ.get("RANK", 0)):
        return                      # under torchrun, rank 0 writes
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, label + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi_pod", action="store_true")
    ap.add_argument("--both_meshes", action="store_true")
    ap.add_argument("--topology", default="",
                    help="'' = pod/multipod (256/512 fake ranks); 'host' = "
                         "the ranks of this job (torchrun's WORLD_SIZE), "
                         "where --measure_bubble can execute the schedule")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of each arch")
    ap.add_argument("--measure_bubble", action="store_true",
                    help="for pp>1 strategies on --topology host under "
                         "torchrun, execute the schedule and record the "
                         "measured bubble fraction next to the prediction")
    ap.add_argument("--strategy", default="",
                    help="'' = legacy pod layout (model axis 16), 'auto' = "
                         "planner, else a spec string like hsdp_tp4 / "
                         "fsdp_pp2_mb4")
    ap.add_argument("--dp_mode", default="hsdp", choices=["hsdp", "fsdp2d"])
    ap.add_argument("--attn", default=None,
                    choices=[None, "head_tp", "context"],
                    help="force the attention mode of the legacy layout's "
                         "model axis (context: the sequence shards over "
                         "it, K/V gathered)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip_existing", action="store_true")
    # perf-iteration knobs: each maps to a Runtime override
    ap.add_argument("--remat_inner", action="store_true",
                    help="checkpoint each layer inside a block too")
    ap.add_argument("--rwkv_chunk", type=int, default=0)
    ap.add_argument("--mamba_chunk", type=int, default=0)
    ap.add_argument("--attn_kv_chunk", type=int, default=0,
                    help="kv chunk of the plain blocked attention (--kernels "
                         "torch, S > 2048); the flash kernels tile their own")
    ap.add_argument("--attn_q_chunk", type=int, default=0,
                    help="query chunk of the same, as --attn_kv_chunk")
    ap.add_argument("--no_sp", action="store_true",
                    help="disable sequence-parallel residual stream")
    ap.add_argument("--grad_accum", type=int, default=1)
    ap.add_argument("--kernels", default="cuda", choices=sorted(IMPLS),
                    help="cuda: the hand-written kernels' shape-only "
                         "branches; torch: the plain layers")
    ap.add_argument("--trace", default="",
                    help="write per-point trace spans as a "
                         "Chrome-trace/Perfetto JSON here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the fake tensors (and the bubble probe) "
                         "lie; cuda needs a card")
    args = ap.parse_args(argv)
    if args.kernels == "cuda" and (args.attn_q_chunk or args.attn_kv_chunk):
        # the flash kernels never read the chunks: refuse, not ignore
        ap.error("--attn_q_chunk/--attn_kv_chunk act only on the plain "
                 "attention (--kernels torch)")
    resolve_device(args.device)          # no card: fail here, not later
    rt_overrides = {k: getattr(args, k) for k in (
        "remat_inner", "rwkv_chunk", "mamba_chunk", "attn_kv_chunk",
        "attn_q_chunk") if getattr(args, k)}
    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.topology:
        meshes = [False]
    elif args.both_meshes:
        meshes = [False, True]
    else:
        meshes = [args.multi_pod]

    recorder = tel.NULL
    if args.trace:
        recorder = tel.Recorder()
        recorder.add_sink(tel.ChromeTraceSink(args.trace,
                                              process_name="dryrun"))
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                _, label = run_label(arch, shape, mp, args.strategy,
                                     args.tag, args.topology)
                path = os.path.join(args.out, label + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            print(f"[dryrun] {label}: cached")
                            continue
                rec = run_one(arch, shape, mp, args.out, args.dp_mode,
                              args.attn, args.tag, not args.no_sp,
                              args.grad_accum, args.strategy, args.topology,
                              args.reduced, args.measure_bubble,
                              args.kernels, rt_overrides,
                              telemetry=recorder, device=args.device)
                n_fail += rec["status"] == "error"
    recorder.close()
    if args.trace:
        print(f"[telemetry] trace written to {args.trace}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
