"""Analytical performance model — the paper's empirical study in closed form.

A copy of the JAX package's ``core/costmodel.py`` (the port never imports
that package); only the imports differ.

Models a distributed training step as computation + collective communication
with an explicit overlap model, over parameterized hardware generations
(V100 / A100 / H100 DGX clusters and TPU v5e pods), parallelization
strategies (FSDP/ZeRO sharded data parallel x tensor x pipeline x context
parallelism) and workloads (the paper's Llama-2 family and every assigned
architecture).

Key modeling choices, each traceable to a paper observation:

* Ring collectives are chunk-pipelined: t = (n-1) * max(B/(n*bw), alpha).
  For fixed per-layer message sizes this reproduces Fig 2b / Fig 4 — the
  effective bus bandwidth of AllGather/ReduceScatter *decays* with world
  size because per-rank chunks shrink below the latency floor.
* NCCL AllReduce has a tree algorithm whose bandwidth term does not grow
  with n (Fig 2a): t = 2B/bw + 2*log2(n)*alpha.  TPU ICI has no tree; the
  'ici' fabric uses ring reduce-scatter + all-gather (2x ring terms), but
  over a 2D torus ring bandwidth is multiplied by the number of
  independent rings (links per chip).
* Cross-island collectives (spanning >1 DGX node, or >1 pod) see the
  slower fabric: bw_eff = inter_bw / ranks_per_island, alpha_eff =
  alpha_inter (Fig 7: TP beyond a node is penalized).
* FSDP AllGather/ReduceScatter overlap with adjacent-layer compute up to
  one layer's compute time (explicit prefetch, Zhao et al.); tensor-
  parallel AllReduces are blocking (§2.1); pipeline adds the GPipe bubble.
* Power: P = idle + (peak - idle) * compute_utilization — per the paper's
  observation that GPU power draw is nearly flat (-5.9%) while utilization
  halves (§4.1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.pipeline import (bubble_fraction, inflight_microbatches,
                                 known_schedule, virtual_stages)
from repro_torch.perf import flops as flops_lib


# ---------------------------------------------------------------------------
# hardware generations (Table 1 + TPU v5e target)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    flops_bf16: float          # peak per chip, FLOP/s
    hbm_bw: float              # B/s
    intra_bw: float            # B/s per chip within the fast island
    inter_bw: float            # B/s per island across the slow fabric
    island: int                # chips per fast island (DGX node / pod)
    alpha_intra: float         # per-hop latency, s
    alpha_inter: float
    power_peak: float          # W per chip, fully utilized
    power_idle: float          # W per chip, stalled on comm
    rings: int = 1             # independent ring directions (torus links)
    kernel_eff: float = 0.72   # achievable fraction of peak in dense matmul
    fabric: str = "nccl"       # 'nccl' (tree AR available) | 'ici'
    # resilience: per-device MTBF, s.  Llama-3 405B saw 419 interruptions
    # in 54 days on 16k H100s -> system MTBF ~3h -> per-device ~1.8e8 s
    # (~5.7 device-years); at 10k+ devices failures are hours apart and
    # lost work + restart become a first-order throughput term (goodput()).
    mtbf: float = 1.8e8
    ckpt_bw: float = 2e9       # checkpoint write B/s per distinct writer
    #                            (per-host share of the parallel filesystem)


# kernel_eff calibration: V100 lacks FlashAttention/Hopper kernels (App. F);
# A100 reaches ~0.63 of peak on the paper's workload; H100's tripled FLOPs
# outpace its kernels' achievable efficiency on the same (small local batch)
# workload — the paper's "asymmetric improvement" (§4.4).
V100 = Hardware("V100", 125e12, 0.9e12, 300e9, 100e9, 8,
                3e-6, 14e-6, 300.0, 250.0, kernel_eff=0.35)
A100 = Hardware("A100", 312e12, 2.0e12, 600e9, 200e9, 8,
                2.5e-6, 12e-6, 400.0, 330.0, kernel_eff=0.63)
H100 = Hardware("H100", 990e12, 3.35e12, 900e9, 400e9, 8,
                2.5e-6, 12e-6, 660.0, 560.0, kernel_eff=0.48)
TPU_V5E = Hardware("TPUv5e", 197e12, 819e9, 4 * 50e9, 25e9, 256,
                   1e-6, 10e-6, 200.0, 110.0, rings=4, kernel_eff=0.70,
                   fabric="ici")

# how much adjacent-layer compute an FSDP prefetch can hide under
# (prefetch depth > 1 lets a collective span more than one layer)
PREFETCH_EFF = 1.5
GRAD_DTYPE_BYTES = 4          # fp32 gradient reduce-scatter (Megatron-style)

HARDWARE = {h.name: h for h in (V100, A100, H100, TPU_V5E)}


# ---------------------------------------------------------------------------
# precision policies (byte widths per tensor class + matmul throughput)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Precision:
    """Byte widths the analytic model charges per tensor class.

    ``param_bytes`` is the stored-parameter width (what the memory term and
    checkpoint size see), ``comm_bytes`` the width the ZeRO param gathers
    move on the wire (fp8 communicates a quantized copy of bf16-stored
    params — the FSDP2 fp8-all-gather extension point), ``act_bytes`` the
    activation width driving TP/CP/PP/MoE collective sizes, and
    ``grad_bytes`` the gradient reduce-scatter width (f32 everywhere:
    low-precision grad reduction is not modeled).  ``flops_scale``
    multiplies the hardware's bf16 matmul peak — f32 matmuls run at half
    rate on every generation modeled here.
    """
    name: str
    param_bytes: int
    comm_bytes: int
    act_bytes: int
    grad_bytes: int
    flops_scale: float


PRECISIONS = {
    "f32": Precision("f32", 4, 4, 4, 4, 0.5),
    "bf16": Precision("bf16", 2, 2, 2, 4, 1.0),
    # emulated fp8: bf16 storage/compute, fp8 on the gather wire only
    "fp8": Precision("fp8", 2, 1, 2, 4, 1.0),
}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _bw_alpha(hw: Hardware, n: int) -> Tuple[float, float]:
    """Effective per-rank ring bandwidth + per-hop latency for group size n."""
    if n <= hw.island:
        return hw.intra_bw * (hw.rings if hw.fabric == "ici" else 1), hw.alpha_intra
    ranks_per_island = hw.island
    return hw.inter_bw / ranks_per_island * (
        hw.rings if hw.fabric == "ici" else 1), hw.alpha_inter


def t_all_gather(hw: Hardware, bytes_total: float, n: int) -> float:
    """Ring all-gather of a tensor of bytes_total (global result size)."""
    if n <= 1:
        return 0.0
    bw, alpha = _bw_alpha(hw, n)
    return (n - 1) * max(bytes_total / (n * bw), alpha)


def t_reduce_scatter(hw: Hardware, bytes_total: float, n: int) -> float:
    return t_all_gather(hw, bytes_total, n)


def t_all_reduce(hw: Hardware, bytes_total: float, n: int) -> float:
    if n <= 1:
        return 0.0
    bw, alpha = _bw_alpha(hw, n)
    if hw.fabric == "nccl":      # tree: bandwidth term ~ independent of n
        return 2 * bytes_total / bw + 2 * math.log2(max(n, 2)) * alpha
    return 2 * (n - 1) * max(bytes_total / (n * bw), alpha)


def t_all_to_all(hw: Hardware, bytes_total: float, n: int) -> float:
    if n <= 1:
        return 0.0
    bw, alpha = _bw_alpha(hw, n)
    return (n - 1) * max(bytes_total / (n * bw), alpha)


def t_p2p(hw: Hardware, bytes_total: float, cross_island: bool) -> float:
    bw = hw.inter_bw / hw.island if cross_island else hw.intra_bw
    alpha = hw.alpha_inter if cross_island else hw.alpha_intra
    return bytes_total / bw + alpha


def bus_bandwidth_allgather(hw: Hardware, bytes_total: float, n: int) -> float:
    """NCCL-tests style busbw in B/s (for reproducing Fig 2)."""
    t = t_all_gather(hw, bytes_total, n)
    return bytes_total * (n - 1) / n / t if t else float("inf")


def bus_bandwidth_allreduce(hw: Hardware, bytes_total: float, n: int) -> float:
    t = t_all_reduce(hw, bytes_total, n)
    return 2 * bytes_total * (n - 1) / n / t if t else float("inf")


# ---------------------------------------------------------------------------
# parallelization strategy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Strategy:
    """Analytic strategy degrees.

    This is the cost model's internal view; the user-facing descriptor is
    ``repro_torch.strategy.Strategy``, whose ``to_cost_strategy`` produces
    one of these with group sizes matching its SPMD lowering (HSDP sets
    ``fsdp_group`` to the intra-island shard group).
    """
    n_devices: int
    tp: int = 1                 # tensor-parallel degree
    pp: int = 1                 # pipeline-parallel degree
    cp: int = 1                 # context-parallel degree
    ep: int = 1                 # expert-parallel degree (an 'expert' mesh
                                # axis factored out of the data axis: the
                                # batch shards over it, expert stacks shard
                                # their E dim over it)
    zero_stage: int = 3         # 0: DDP, 2/3: sharded (paper: FSDP ~ ZeRO-2/3)
    microbatches: int = 1       # pipeline microbatches per step
    sched: str = "gpipe"        # pipeline schedule: 'gpipe' | '1f1b' |
                                # '1f1b_i<v>' | 'zb'.  gpipe/1f1b share
                                # the idle-tick bubble (1F1B caps
                                # in-flight activations at min(M, pp) at
                                # the price of one forward recompute);
                                # interleaved shrinks it to
                                # (P-1)/(vM+P-1) for v x p2p volume, zb
                                # to 2(P-1)/(3M+2P-2) via deferred wgrads
    overlap: bool = False       # double-buffered ZeRO gather prefetch
                                # ('ovl' token): the gather for layer l+1
                                # is issued at the top of layer l's
                                # compute, so each gather hides under
                                # max(t_compute, t_gather) — modeled as
                                # one extra layer of prefetch window in
                                # the FSDP exposed-comm terms.  Needs a
                                # sharded-param plan (zero_stage >= 2)
    fsdp_group: int = 0         # param-shard group size; 0 -> full dp (FSDP).
                                # HSDP: the island-local group, with the
                                # cross-island grad AR charged separately.
    precision: str = "bf16"     # PRECISIONS key.  The analytic default is
                                # bf16 — the byte widths this model always
                                # silently assumed — so calibrated anchors
                                # are unchanged; the descriptor passes the
                                # executable policy (default f32) through
                                # to_cost_strategy.

    @property
    def dp(self) -> int:
        """Total data-parallel degree (includes the expert axis)."""
        return self.n_devices // (self.tp * self.pp * self.cp)

    @property
    def fsdp_n(self) -> int:
        return self.fsdp_group or self.dp

    @property
    def model_parallel(self) -> int:
        return self.tp * self.pp * self.cp

    def valid(self) -> bool:
        return (self.precision in PRECISIONS and
                known_schedule(self.sched) and
                # a schedule token without a pipeline is not a real point
                (self.pp > 1 or self.sched == "gpipe") and
                # interleaved chunk rotation assigns microbatches to
                # ranks in groups of pp
                (virtual_stages(self.sched) == 1 or
                 self.microbatches % self.pp == 0) and
                # gather/compute overlap is a property of the sharded-
                # param gather loop; DDP has nothing to prefetch
                (not self.overlap or self.zero_stage >= 2) and
                self.dp >= 1 and
                self.dp * self.tp * self.pp * self.cp == self.n_devices and
                self.dp % self.fsdp_n == 0 and
                # expert axis is factored out of the (island-local) data
                # group — both must split into whole ranks
                self.dp % self.ep == 0 and self.fsdp_n % self.ep == 0 and
                # a pipeline with fewer microbatches than stages cannot
                # fill; pricing it would diverge from what the lowering
                # runs (the descriptor rejects mb < pp at construction)
                (self.pp == 1 or self.microbatches >= self.pp))


# ---------------------------------------------------------------------------
# goodput: failures, checkpoints, and the Young/Daly interval
# ---------------------------------------------------------------------------
# At fleet scale the hardware-failure rate grows linearly with device
# count while per-checkpoint cost depends on the *sharding*: every rank
# that holds a distinct optimizer-state shard writes in parallel, so full
# FSDP checkpoints n-ways concurrently while HSDP's replicas sit idle and
# DDP funnels everything through the model-parallel ranks.  Folding both
# into the planner objective (effective_wps) bends the throughput-vs-n
# curve down — the failure-aware diminishing-returns regime.

RESTART_BASE_S = 120.0   # detect + reschedule + reinit before the restore


def checkpoint_bytes(cfg: ModelConfig, precision: str = "bf16") -> float:
    """Global checkpoint size: stored-dtype params + fp32 Adam m/v."""
    return cfg.param_count() * (PRECISIONS[precision].param_bytes + 8)


def distinct_writers(strat: Strategy) -> int:
    """Ranks holding distinct checkpoint shards (parallel writers).

    Mirrors the memory model's opt_shard: ZeRO>=2 shards optimizer state
    over the param-shard group, so fsdp writes with every data rank,
    HSDP only with the island-local group (replicas hold copies), and
    DDP/ZeRO-0 only with the tp*pp model ranks.
    """
    shard = strat.fsdp_n if strat.zero_stage >= 2 else 1
    return max(1, min(strat.n_devices, strat.tp * strat.pp * shard))


def checkpoint_write_time(cfg: ModelConfig, hw: Hardware,
                          strat: Strategy) -> float:
    return checkpoint_bytes(cfg, strat.precision) / (
        distinct_writers(strat) * hw.ckpt_bw)


def system_mtbf(hw: Hardware, n_devices: int) -> float:
    """Mean time between failures of the whole job (any device failing)."""
    return hw.mtbf / max(1, n_devices)


def young_daly_interval(t_ckpt: float, mtbf: float) -> float:
    """Young/Daly first-order optimal checkpoint interval
    tau* = sqrt(2 * t_ckpt * M): balances checkpoint overhead
    (t_ckpt / tau, falling in tau) against expected lost work per failure
    (tau / 2M, rising in tau)."""
    return math.sqrt(2.0 * max(t_ckpt, 1e-12) * max(mtbf, 1e-12))


def goodput(t_ckpt: float, mtbf: float, t_restart: float = RESTART_BASE_S,
            interval: float = 0.0) -> float:
    """Fraction of wall-clock that is forward training progress.

    wasted = t_ckpt/tau (checkpoint stalls — 0 for a fully-async writer,
    but the snapshot+write still bounds tau from below) + (tau/2 +
    t_restart)/M (expected lost work + restart per failure).  ``interval``
    overrides the Young/Daly optimum (floored at t_ckpt — the writer
    cannot checkpoint faster than it writes).
    """
    tau = interval if interval > 0 else young_daly_interval(t_ckpt, mtbf)
    tau = max(tau, t_ckpt)
    wasted = t_ckpt / tau + (tau / 2.0 + t_restart) / max(mtbf, 1e-12)
    return max(0.0, 1.0 - wasted)


def restart_time(cfg: ModelConfig, hw: Hardware, strat: Strategy) -> float:
    """Detect/reschedule plus reading the checkpoint back."""
    return RESTART_BASE_S + checkpoint_write_time(cfg, hw, strat)


# ---------------------------------------------------------------------------
# step-time model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepReport:
    strategy: Strategy
    hardware: str
    t_step: float
    t_compute: float
    t_comm_total: float
    t_comm_exposed: float
    comm_breakdown: Dict[str, float]
    tokens: int
    wps: float                   # words(tokens)/s global
    wps_per_device: float
    tflops_per_device: float     # achieved
    mfu: float
    power_per_device: float      # W
    tokens_per_joule: float
    memory_per_device: float     # bytes (params+opt+grads+activations)
    fits: bool
    # decode-mode latency percentiles (s/token); 0.0 for train/prefill
    # pricing, where a per-token latency distribution is not meaningful.
    # p50 is the steady-state decode step; p99 adds the worst-case
    # continuous-batching interference (a decode step that lands behind
    # one chunked-prefill tick waits that chunk out).
    latency_p50: float = 0.0
    latency_p99: float = 0.0
    # failure-aware throughput (train pricing; decode reports carry the
    # no-failure identity).  goodput_frac folds checkpoint overhead, lost
    # work, and restart time at the Young/Daly-optimal interval into a
    # usable fraction of wall-clock; effective_wps = wps * goodput_frac is
    # the planner objective that reproduces the failure-aware
    # diminishing-returns curve.
    t_ckpt: float = 0.0          # one checkpoint write, s (strategy-aware)
    ckpt_interval: float = 0.0   # Young/Daly-optimal interval, s
    goodput_frac: float = 1.0
    effective_wps: float = 0.0

    def row(self) -> Dict:
        d = dataclasses.asdict(self)
        d.pop("comm_breakdown")
        d.pop("strategy")
        s = self.strategy
        d.update(n=s.n_devices, tp=s.tp, pp=s.pp, cp=s.cp, ep=s.ep,
                 dp=s.dp, sched=s.sched, precision=s.precision)
        return d

    def decomposition(self) -> Dict[str, float]:
        """Per-term step-time decomposition (seconds per step).

        This is the predicted side of the telemetry DriftMonitor's
        predicted-vs-measured comparison: ``step`` is the modeled wall
        time, ``compute`` the math term, ``collective`` the *exposed*
        communication (what a measured step actually pays), ``bubble``
        the schedule residual, plus a ``comm/<kind>`` entry per nonzero
        collective in the breakdown.
        """
        bubble = max(0.0, self.t_step - self.t_compute
                     - self.t_comm_exposed)
        d = {
            "step": self.t_step,
            "compute": self.t_compute,
            "collective": self.t_comm_exposed,
            "comm_total": self.t_comm_total,
            "bubble": bubble,
        }
        for k, v in self.comm_breakdown.items():
            if v:
                d[f"comm/{k}"] = v
        return d


def _model_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    return cfg.param_count() * dtype_bytes


def step_time(cfg: ModelConfig, hw: Hardware, strat: Strategy,
              global_batch: int, seq_len: int,
              hbm_capacity: float = 80e9, train: bool = True,
              remat: bool = False) -> StepReport:
    """Analytic step time for one optimizer step (or forward, if not train)."""
    assert strat.valid(), strat
    shape = ShapeConfig("x", seq_len, global_batch,
                        "train" if train else "prefill")
    tokens = global_batch * seq_len
    L = cfg.n_layers
    d = cfg.d_model
    px = PRECISIONS[strat.precision]
    P_bytes = _model_bytes(cfg, px.param_bytes)

    # ---- compute -----------------------------------------------------------
    total_flops = flops_lib.compiled_flops(cfg, shape, remat=remat and train)
    flops_per_dev = total_flops / strat.n_devices
    t_compute = flops_per_dev / (hw.flops_bf16 * px.flops_scale *
                                 hw.kernel_eff)
    # forward is 1/4 of compute with remat (1/3 without); AG prefetch hides
    # under the *forward* layer, grad RS under the *backward* layer.
    fwd_frac = (1 / 4 if remat else 1 / 3) if train else 1.0
    t_layer_fwd = t_compute * fwd_frac / L
    t_layer_bwd = t_compute * (1 - fwd_frac) / L if train else 0.0
    if train and strat.pp > 1 and strat.sched != "gpipe":
        # every non-GPipe schedule (1f1b, interleaved, zb) bakes remat
        # into its backward: microbatch forwards are replayed just-in-
        # time through the pipe so only the warmup-depth boundary
        # activations are ever held.  Charge that one extra forward
        # pass — the memory win is not free, and the planner must see
        # the genuine bubble/memory/recompute tradeoff
        t_compute *= 1 + fwd_frac

    # per-device local batch (examples)
    local_batch = max(global_batch // (strat.dp * strat.cp), 1)
    act_bytes_layer = local_batch * seq_len * d * px.act_bytes / strat.cp

    comm: Dict[str, float] = {"fsdp_ag": 0.0, "fsdp_rs": 0.0, "ddp_ar": 0.0,
                              "hsdp_ar": 0.0, "tp_ar": 0.0, "pp_p2p": 0.0,
                              "cp": 0.0, "moe_a2a": 0.0}

    # ---- sharded data parallel collectives (per layer) ---------------------
    # MoE expert stacks are split out of the uniform per-layer bytes: with
    # ep > 1 their E dim shards over the 'expert' axis permanently, so the
    # ZeRO AllGather/ReduceScatter covers only the local 1/ep slice and
    # runs over the reduced (data-only) group n_fsdp/ep — the lever that
    # makes EP overtake pure FSDP once expert-param gathers cross islands.
    layer_param_bytes = P_bytes / L / (strat.tp * strat.pp)
    mult = 3 if cfg.glu else 2
    n_moe = sum(cfg.is_moe_layer(i) for i in range(L))
    expert_bytes = (n_moe * cfg.moe.n_experts * mult * d *
                    cfg.moe.expert_d_ff * px.param_bytes
                    ) if cfg.moe.n_experts else 0.0
    dense_layer_bytes = (P_bytes - expert_bytes) / L / (strat.tp * strat.pp)
    moe_layer_bytes = (expert_bytes / n_moe / (strat.tp * strat.pp)
                       if n_moe else 0.0)
    n_dp = strat.dp
    n_fsdp = strat.fsdp_n       # param-shard group (== dp unless HSDP)
    if strat.zero_stage >= 2 and n_fsdp > 1:
        # AllGather params fwd (+ bwd re-gather for ZeRO-3) at the *wire*
        # width (fp8 gathers a quantized copy), ReduceScatter grads at the
        # reduce width (f32)
        n_fsdp_e = max(n_fsdp // strat.ep, 1)
        comm_scale = px.comm_bytes / px.param_bytes
        grad_scale = px.grad_bytes / px.param_bytes
        ag_dense = t_all_gather(hw, dense_layer_bytes * comm_scale, n_fsdp)
        ag_moe = t_all_gather(hw, moe_layer_bytes / strat.ep * comm_scale,
                              n_fsdp_e)
        n_ag = 2 if strat.zero_stage == 3 else 1
        rs_dense = t_reduce_scatter(
            hw, dense_layer_bytes * grad_scale, n_fsdp)
        rs_moe = t_reduce_scatter(
            hw, moe_layer_bytes / strat.ep * grad_scale, n_fsdp_e)
        comm["fsdp_ag"] = n_ag * (L * ag_dense + n_moe * ag_moe)
        comm["fsdp_rs"] = (L * rs_dense + n_moe * rs_moe) if train else 0.0
        # double-buffered gather prefetch ('ovl'): issuing layer l+1's
        # gather at the *top* of layer l's compute decouples the gather
        # deadline from its issue point by one full layer — each gather
        # costs max(t_compute, t_gather) instead of serializing, i.e.
        # the hiding window widens by t_layer on top of the baseline
        # prefetch depth
        prefetch = PREFETCH_EFF + (1.0 if strat.overlap else 0.0)
        win_fwd = prefetch * t_layer_fwd
        win_bwd = prefetch * t_layer_bwd
        n_dense_l = L - n_moe

        def _exposed_ag(win):
            return (n_dense_l * max(0.0, ag_dense - win) +
                    n_moe * max(0.0, ag_dense + ag_moe - win))

        exposed_fsdp = _exposed_ag(win_fwd)
        if strat.zero_stage == 3:
            exposed_fsdp += _exposed_ag(win_bwd)
        if train:
            exposed_fsdp += (
                n_dense_l * max(0.0, rs_dense - win_bwd) +
                n_moe * max(0.0, rs_dense + rs_moe - win_bwd))
        if train and n_fsdp < n_dp:
            # HSDP: gradient shards all-reduced across the dp//n_fsdp
            # replicas once per step, ring over the slow inter-island
            # fabric shared by the island's n_fsdp concurrent rings.
            replicas = n_dp // n_fsdp
            grad_shard = (layer_param_bytes * L * px.grad_bytes /
                          px.param_bytes / n_fsdp)
            # every chip in the island — n_fsdp data ranks x tp*cp model
            # ranks — holds a distinct shard and rings concurrently over
            # the shared cross-island fabric (same sharing as _bw_alpha)
            island_ranks = n_fsdp * strat.tp * strat.cp
            bw = hw.inter_bw / island_ranks * (
                hw.rings if hw.fabric == "ici" else 1)
            comm["hsdp_ar"] = 2 * (replicas - 1) * max(
                grad_shard / (replicas * bw), hw.alpha_inter)
            # overlaps the backward tail like DDP, but spans fewer layers
            exposed_fsdp += 0.5 * comm["hsdp_ar"]
    elif n_dp > 1 and train:
        comm["ddp_ar"] = t_all_reduce(
            hw, cfg.param_count() * px.grad_bytes, n_dp)
        # DDP grad all-reduce overlaps with backward (non-blocking, §2.1)
        exposed_fsdp = max(0.0, comm["ddp_ar"] - PREFETCH_EFF * t_compute * 2 / 3)
    else:
        exposed_fsdp = 0.0

    # ---- tensor parallel (blocking) ----------------------------------------
    if strat.tp > 1:
        # Megatron: 2 AllReduces fwd (+2 bwd) per layer over activations
        ars_per_layer = 2 * (3 if train else 1)
        t_ar = t_all_reduce(hw, act_bytes_layer, strat.tp)
        comm["tp_ar"] = L * ars_per_layer * t_ar
        exposed_tp = comm["tp_ar"]          # blocking / on critical path
    else:
        exposed_tp = 0.0

    # ---- context parallel ---------------------------------------------------
    if strat.cp > 1:
        # ring attention: pass KV around the cp ring each layer
        kv_bytes = local_batch * seq_len / strat.cp * cfg.kv_heads * \
            cfg.head_dim_ * px.act_bytes * 2
        t_ring = (strat.cp - 1) * t_p2p(hw, kv_bytes, strat.cp > hw.island)
        comm["cp"] = L * t_ring * (3 if train else 1)
        exposed_cp = 0.25 * comm["cp"]       # mostly overlapped with attn math
    else:
        exposed_cp = 0.0

    # ---- MoE all-to-all ------------------------------------------------------
    exposed_moe = 0.0
    if cfg.moe.n_experts:
        tok_bytes = (tokens / strat.dp / strat.cp) * cfg.moe.top_k * \
            cfg.moe.capacity_factor * d * px.act_bytes
        # the dispatch/combine exchange crosses the expert-sharding group:
        # the explicit 'expert' axis when ep > 1, else the model axis (the
        # GSPMD dropping path reshards the (E, C, d) buffer over the whole
        # 'model' axis — sized tp * cp, since context plans fold tp into
        # cp; with no expert and no model axis the capacity dim stays
        # data-local — no a2a)
        ep_group = (strat.ep if strat.ep > 1
                    else min(strat.tp * strat.cp, cfg.moe.n_experts))
        if ep_group > 1:
            # island crossing is set by the ranks the group spans on the
            # device grid — 'model' is innermost, so an expert group of
            # size ep spans ep * tp * cp consecutive ranks
            span = ep_group * strat.tp * strat.cp if strat.ep > 1 \
                else strat.tp * strat.cp
            bw, alpha = _bw_alpha(hw, span)
            t_a2a = 2 * (ep_group - 1) * max(
                tok_bytes / (ep_group * bw), alpha)  # dispatch + combine
            comm["moe_a2a"] = n_moe * t_a2a * (3 if train else 1)
            exposed_moe = 0.5 * comm["moe_a2a"]

    # ---- pipeline ------------------------------------------------------------
    bubble = 0.0
    if strat.pp > 1:
        m = strat.microbatches          # valid() guarantees m >= pp
        # per-schedule bubble: GPipe and 1F1B idle the same tick fraction
        # ((P-1)/(M+P-1)) at equal per-tick cost — 1F1B reorders the
        # bubble to cap in-flight activations, it does not shrink it.
        # Interleaved ((P-1)/(vM+P-1)) and zb (2(P-1)/(3M+2P-2))
        # genuinely shrink it — interleaved pays in p2p volume below
        bubble_frac = bubble_fraction(strat.pp, m, strat.sched)
        v = virtual_stages(strat.sched)
        act_boundary = local_batch * seq_len * d * px.act_bytes / m
        # v virtual stages per rank: every microbatch crosses the ring v
        # times — pp*v - 1 boundary hops instead of pp - 1
        comm["pp_p2p"] = (strat.pp * v - 1) * m * t_p2p(
            hw, act_boundary, strat.pp * strat.tp > hw.island) * (2 if train else 1)
        bubble = bubble_frac            # fraction of step, applied below
    exposed_pp = comm["pp_p2p"] * 0.5

    t_comm_total = sum(comm.values())
    t_exposed = exposed_fsdp + exposed_tp + exposed_cp + exposed_moe + exposed_pp
    t_step = (t_compute + t_exposed) / max(1e-9, (1 - bubble))

    # ---- memory ---------------------------------------------------------------
    # ZeRO shards over the param-shard group (n_fsdp == dp unless HSDP,
    # where replicas across islands each hold a full shard set).
    opt_shard = strat.tp * strat.pp * (n_fsdp if strat.zero_stage >= 2 else 1)
    mem = (P_bytes / (strat.tp * strat.pp)) / (n_fsdp if strat.zero_stage >= 3 else 1)
    mem += px.grad_bytes * cfg.param_count() / (strat.tp * strat.pp) / \
        (n_fsdp if strat.zero_stage >= 2 else 1)    # grads at reduce width
    mem += 8 * cfg.param_count() / opt_shard       # adam m+v fp32
    if train:
        # remat-boundary activations.  With a pipeline this is the
        # schedule's lever: each stage holds the boundary activations of
        # every microbatch awaiting backward — all M under GPipe, at most
        # P under 1F1B (warmup depth) — so the per-stage footprint scales
        # by inflight/M.  This is what flips ``fits`` between schedules.
        if strat.pp > 1:
            inflight = inflight_microbatches(strat.pp, strat.microbatches,
                                             strat.sched)
            # interleaved counts in-flight *chunk* activations, each a
            # 1/v slice of the rank's layers — the deeper warmup window
            # holds proportionally thinner residuals
            chunk_layers = L / (strat.pp * virtual_stages(strat.sched))
            mem += chunk_layers * act_bytes_layer * \
                inflight / strat.microbatches
            if strat.sched == "zb":
                # deferred-wgrad stash: the dgrad sub-tick parks one
                # microbatch's parameter gradient until its W sub-tick
                # drains it (backlog depth 1 under the B>W>F priority)
                mem += (P_bytes / (strat.tp * strat.pp)) * \
                    (px.grad_bytes / px.param_bytes)
        else:
            mem += L * act_bytes_layer
    mem += act_bytes_layer * 4                      # working set

    # ---- throughput / power -----------------------------------------------
    wps = tokens / t_step
    model_fl = flops_lib.model_flops(cfg, shape)
    mfu = model_fl / t_step / (strat.n_devices * hw.flops_bf16)
    util = t_compute / t_step
    power = hw.power_idle + (hw.power_peak - hw.power_idle) * util
    achieved = total_flops / t_step / strat.n_devices

    # ---- failure-aware goodput ---------------------------------------------
    t_ckpt = checkpoint_write_time(cfg, hw, strat)
    mtbf = system_mtbf(hw, strat.n_devices)
    tau = young_daly_interval(t_ckpt, mtbf)
    g = goodput(t_ckpt, mtbf, t_restart=restart_time(cfg, hw, strat))

    return StepReport(
        strategy=strat, hardware=hw.name, t_step=t_step, t_compute=t_compute,
        t_comm_total=t_comm_total, t_comm_exposed=t_exposed,
        comm_breakdown=comm, tokens=tokens, wps=wps,
        wps_per_device=wps / strat.n_devices,
        tflops_per_device=achieved / 1e12, mfu=mfu,
        power_per_device=power,
        tokens_per_joule=wps / (power * strat.n_devices),
        memory_per_device=mem, fits=mem < hbm_capacity,
        t_ckpt=t_ckpt, ckpt_interval=max(tau, t_ckpt), goodput_frac=g,
        effective_wps=wps * g)


# ---------------------------------------------------------------------------
# decode-step model (serving)
# ---------------------------------------------------------------------------

def decode_step_time(cfg: ModelConfig, hw: Hardware, strat: Strategy,
                     batch: int, context_len: int,
                     hbm_capacity: float = 80e9,
                     prefill_chunk: int = 32) -> StepReport:
    """Analytic latency of one decode step (one token per sequence).

    Decode is memory-bound, not FLOP-bound: each step streams the device's
    *active* parameter shard plus the batch's KV slice from HBM, so the
    roofline is max(flops, bytes) — the reason the training objective
    (wps) misranks serving strategies, and what the planner's decode-mode
    latency objectives price instead.  Model-parallel collectives sit on
    the critical path per token: TP all-reduces are latency-dominated at
    decode's tiny activation sizes (alpha terms, not bandwidth), and a
    pipeline adds its depth in p2p hops to every token.  Throughput-side
    fields (wps, mfu, ...) are filled for the same step so one report
    serves both rankings.
    """
    assert strat.valid(), strat
    shape = ShapeConfig("x", context_len, batch, "decode")
    L, d = cfg.n_layers, cfg.d_model
    px = PRECISIONS[strat.precision]
    P_bytes = _model_bytes(cfg, px.param_bytes)

    flops = flops_lib.forward_flops(cfg, shape)
    t_flops = flops / strat.n_devices / (hw.flops_bf16 * px.flops_scale *
                                         hw.kernel_eff)

    # HBM traffic: active params (MoE reads top_k experts' rows only) and
    # the local KV slice — batch shards over (dp, cp), heads over tp,
    # layers over pp
    local_batch = max(batch // (strat.dp * strat.cp), 1)
    active_bytes = (cfg.active_param_count() * px.param_bytes /
                    (strat.tp * strat.pp))
    kv_bytes = (local_batch * context_len * (L / strat.pp) *
                cfg.kv_heads * cfg.head_dim_ * px.act_bytes * 2 / strat.tp)
    t_mem = (active_bytes + kv_bytes) / hw.hbm_bw

    comm: Dict[str, float] = {"tp_ar": 0.0, "pp_p2p": 0.0, "moe_a2a": 0.0}
    act_bytes = local_batch * d * px.act_bytes
    if strat.tp > 1:
        comm["tp_ar"] = L * 2 * t_all_reduce(hw, act_bytes, strat.tp)
    if strat.pp > 1:
        comm["pp_p2p"] = (strat.pp - 1) * t_p2p(
            hw, act_bytes, strat.pp * strat.tp > hw.island)
    if cfg.moe.n_experts:
        n_moe = sum(cfg.is_moe_layer(i) for i in range(L))
        ep_group = (strat.ep if strat.ep > 1
                    else min(strat.tp * strat.cp, cfg.moe.n_experts))
        if ep_group > 1:
            tok_bytes = (local_batch * cfg.moe.top_k *
                         cfg.moe.capacity_factor * d * px.act_bytes)
            span = (ep_group * strat.tp * strat.cp if strat.ep > 1
                    else strat.tp * strat.cp)
            bw, alpha = _bw_alpha(hw, span)
            comm["moe_a2a"] = n_moe * 2 * (ep_group - 1) * max(
                tok_bytes / (ep_group * bw), alpha)

    t_exposed = sum(comm.values())       # all on the per-token critical path
    t_token = max(t_flops, t_mem) + t_exposed

    # p99: one chunked-prefill tick of interference (continuous batching
    # admits mid-stream; the colliding decode step waits the chunk out)
    chunk_shape = ShapeConfig("x", prefill_chunk, 1, "prefill")
    t_chunk = flops_lib.forward_flops(cfg, chunk_shape) / strat.n_devices \
        / (hw.flops_bf16 * hw.kernel_eff)
    p50 = t_token
    p99 = t_token + t_chunk

    # memory: full param shard resident + KV cache + working activations
    mem = P_bytes / (strat.tp * strat.pp) / \
        (strat.fsdp_n if strat.zero_stage >= 3 else 1)
    mem += kv_bytes + act_bytes * 4

    wps = batch / t_token
    model_fl = flops_lib.model_flops(cfg, shape)
    mfu = model_fl / t_token / (strat.n_devices * hw.flops_bf16)
    util = t_flops / t_token
    power = hw.power_idle + (hw.power_peak - hw.power_idle) * util

    return StepReport(
        strategy=strat, hardware=hw.name, t_step=t_token, t_compute=t_flops,
        t_comm_total=t_exposed, t_comm_exposed=t_exposed,
        comm_breakdown=comm, tokens=batch, wps=wps,
        wps_per_device=wps / strat.n_devices,
        tflops_per_device=flops / t_token / strat.n_devices / 1e12, mfu=mfu,
        power_per_device=power,
        tokens_per_joule=wps / (power * strat.n_devices),
        memory_per_device=mem, fits=mem < hbm_capacity,
        latency_p50=p50, latency_p99=p99,
        # serving restarts are a scheduler concern, not a goodput term
        goodput_frac=1.0, effective_wps=wps)


# The deprecated ``sweep_strategies`` / ``best_strategy`` shims are gone:
# use ``repro_torch.strategy.search`` / ``repro_torch.strategy.best`` (the
# planner sweeps dp_mode x tp x cp x pp x ep and prices with this module).
