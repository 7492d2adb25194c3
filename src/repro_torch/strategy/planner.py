"""Cost-model-driven strategy planner.

A copy of the JAX package's ``strategy/planner.py``; only the imports
differ.  The port's ``Strategy.check`` refuses cp and ep > 1 until
their slices land, and tp > 1 where it resolves to context attention, so
``search`` never returns such a strategy; head-TP and pipeline strategies
lower, and the planner ranks them with the data-parallel ones, as the JAX
one does.

``search(cfg, topology, shape)`` sweeps the executable-strategy space
(dp_mode x tp x cp x pp x ep x pipeline schedule x ZeRO stage), prices
every candidate with the
calibrated analytic model (``costmodel.step_time``), and returns ranked
``PlannedStrategy`` records whose descriptors lower to real plans via
``Strategy.to_plan``.  This replaced the old ``costmodel.sweep_strategies``
/ ``best_strategy`` pair (now deleted) and — unlike them — sweeps
context-parallel and expert-parallel degrees.

Objectives: 'wps' (tokens/s, the train/prefill default), 'mfu',
'tokens_per_joule', 'memory' (min bytes/device), and the decode-mode
latency percentiles 'p50_latency' / 'p99_latency' (min s/token; priced by
``costmodel.decode_step_time``, which ``evaluate`` routes decode shapes
through).  When no objective is named, ``search``/``resolve`` pick
'p50_latency' for ``shape.mode == "decode"`` and 'wps' otherwise — a
serving planner that ranks by training throughput would happily trade
per-token latency for batch efficiency the serving path cannot use.
``pareto_front`` keeps the strategies that are not dominated on a set of
objectives (e.g. throughput vs energy).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.pipeline import SCHEDULE_NAMES
from repro_torch.strategy.descriptor import Strategy, StrategyError, parse
from repro_torch.strategy.topology import Topology

OBJECTIVES: Dict[str, Callable[[cm.StepReport], float]] = {
    "wps": lambda r: r.wps,
    "throughput": lambda r: r.wps,
    # failure-aware throughput: wps * goodput (checkpoint overhead + lost
    # work + restarts at the Young/Daly interval, strategy-aware writer
    # parallelism).  Diverges from 'wps' at scale/low MTBF — a strategy
    # with few distinct checkpoint writers (HSDP replicas, DDP) pays more
    # per failure than one that writes n-ways (full FSDP).
    "effective_wps": lambda r: r.effective_wps,
    "goodput": lambda r: r.goodput_frac,
    "mfu": lambda r: r.mfu,
    "tokens_per_joule": lambda r: r.tokens_per_joule,
    "memory": lambda r: -r.memory_per_device,
    # latency percentiles only exist on decode-mode reports (0.0
    # elsewhere -> score -inf, so a latency objective never ranks a
    # train/prefill pricing)
    "p50_latency": lambda r: -(r.latency_p50 or float("inf")),
    "p99_latency": lambda r: -(r.latency_p99 or float("inf")),
}


def default_objective(shape: ShapeConfig) -> str:
    return "p50_latency" if shape.mode == "decode" else "wps"


@dataclasses.dataclass
class PlannedStrategy:
    """One ranked point: the descriptor, its spec string, and the price."""
    strategy: Strategy
    report: cm.StepReport
    score: float
    lowers: bool                     # Strategy.check passed on the topology

    @property
    def spec(self) -> str:
        return self.strategy.format()

    def row(self) -> Dict:
        d = self.report.row()
        d.update(spec=self.spec, score=self.score, lowers=self.lowers)
        return d


def evaluate(cfg: ModelConfig, strategy: Strategy, topology: Topology,
             shape: ShapeConfig, train: Optional[bool] = None,
             remat: bool = False) -> cm.StepReport:
    """Price one strategy on one topology with the analytic model.

    Decode shapes route to ``costmodel.decode_step_time`` (per-token
    latency roofline + latency percentiles); train/prefill shapes to
    ``costmodel.step_time``.  An explicit ``train=`` override forces the
    step-time model either way.
    """
    cost = strategy.to_cost_strategy(cfg, topology)
    if shape.mode == "decode" and train is None:
        return cm.decode_step_time(cfg, topology.hw, cost,
                                   shape.global_batch, shape.seq_len,
                                   hbm_capacity=topology.hbm)
    return cm.step_time(cfg, topology.hw, cost, shape.global_batch,
                        shape.seq_len, hbm_capacity=topology.hbm,
                        train=shape.mode == "train" if train is None
                        else train, remat=remat)


DEFAULT_PPS = (1, 2, 4, 8)
DEFAULT_EPS = (1, 2, 4, 8)
# sweep every base schedule family plus the canonical interleaved point
# (deeper interleavings are opt-in via scheds=)
DEFAULT_SCHEDS = SCHEDULE_NAMES + ("1f1b_i2",)
DEFAULT_OVERLAPS = (False, True)     # ZeRO gather/compute overlap ('ovl')
# precision is a swept degree: same mesh, dtype-scaled byte/flops terms.
# f32 is what the lowering has always run; bf16 halves params/acts on the
# wire and doubles matmul throughput, which moves every comm-driven
# crossover (EP/PP/FSDP).  fp8 (comm-only) is opt-in via precisions=.
DEFAULT_PRECISIONS = ("f32", "bf16")


def candidates(topology: Topology, global_batch: int,
               dp_modes: Sequence[str] = ("hsdp",),
               tps: Iterable[int] = (1, 2, 4, 8, 16),
               cps: Iterable[int] = (1, 2, 4, 8),
               pps: Iterable[int] = DEFAULT_PPS,
               eps: Iterable[int] = DEFAULT_EPS,
               scheds: Sequence[str] = DEFAULT_SCHEDS,
               zero_stages: Iterable[Optional[int]] = (None,),
               microbatches: int = 8,
               precisions: Sequence[str] = DEFAULT_PRECISIONS,
               overlaps: Sequence[bool] = DEFAULT_OVERLAPS
               ) -> List[Strategy]:
    """Enumerate distinct strategy descriptors viable on ``topology``.

    tp and cp share the model axis, so candidates use at most one of them
    (the tp x cp cross product would double-count the same mesh).  The
    batch filters mirror the original sweep: dp must divide the global
    batch (or be smaller than it).  ep > 1 candidates are only viable for
    MoE configs — ``search`` filters them via ``Strategy.check(cfg)``
    (``ep | n_experts``); ep stays inside the island-local data group so
    the reduced expert gathers are whole ranks.  pp > 1 candidates are
    emitted once per pipeline schedule in ``scheds`` — gpipe/1f1b share
    the bubble but differ in activation footprint (1F1B caps in-flight
    microbatches at pp), while interleaved/zb shrink the bubble itself —
    so the schedule sweep surfaces both memory-limited and bubble-limited
    crossovers.  Every sharded-param point is additionally emitted with
    the 'ovl' gather/compute-overlap variant (``overlaps``).
    """
    n = topology.n_devices
    out: List[Strategy] = []
    seen = set()
    for dp_mode in dp_modes:
        # below one island hsdp == fsdp: keep the canonical name
        mode = ("fsdp" if dp_mode == "hsdp" and n <= topology.island
                else dp_mode)
        for zero in zero_stages:
            for tp, cp in [(t, 1) for t in tps] + [(1, c) for c in cps
                                                   if c > 1]:
                for pp in pps:
                    for ep in eps:
                        model = tp * cp * pp
                        if model * ep > n or n % (model * ep):
                            continue
                        dp = n // model
                        if dp % ep:
                            continue
                        if dp > global_batch:
                            continue
                        if global_batch % dp and global_batch >= dp:
                            continue
                        mb = max(microbatches, pp) if pp > 1 else 1
                        if pp > 1 and global_batch % mb:
                            continue   # microbatch split must divide batch
                        if pp > 1 and ep > 1 and \
                                (global_batch // mb) % dp:
                            # the in-stage expert a2a needs the microbatch
                            # sharded over (data, expert) — to_plan rejects
                            continue
                        for sched in (scheds if pp > 1 else ("gpipe",)):
                            if "_i" in sched and mb % pp:
                                continue   # interleaved needs pp | mb
                            for ovl in overlaps:
                                if ovl and (mode == "ddp" or zero == 0):
                                    continue   # nothing to prefetch
                                for prec in precisions:
                                    s = Strategy(dp_mode=mode, tp=tp,
                                                 cp=cp, pp=pp, ep=ep,
                                                 zero_stage=zero,
                                                 microbatches=mb,
                                                 sched=sched, overlap=ovl,
                                                 precision=prec)
                                    if s.format() in seen:
                                        continue
                                    seen.add(s.format())
                                    out.append(s)
    return out


def search(cfg: ModelConfig, topology: Topology, shape: ShapeConfig,
           objective: Optional[str] = None, require_fits: bool = True,
           require_lowerable: bool = True,
           dp_modes: Sequence[str] = ("hsdp",),
           tps: Iterable[int] = (1, 2, 4, 8, 16),
           cps: Iterable[int] = (1, 2, 4, 8),
           pps: Iterable[int] = DEFAULT_PPS,
           eps: Iterable[int] = DEFAULT_EPS,
           scheds: Sequence[str] = DEFAULT_SCHEDS,
           zero_stages: Iterable[Optional[int]] = (None,),
           microbatches: int = 8,
           precisions: Sequence[str] = DEFAULT_PRECISIONS,
           overlaps: Sequence[bool] = DEFAULT_OVERLAPS,
           top: Optional[int] = None) -> List[PlannedStrategy]:
    """Rank executable strategies for (model, topology, shape).

    Returns PlannedStrategy records sorted by ``objective`` (best first;
    ``None`` -> mode default: 'p50_latency' for decode shapes, 'wps'
    otherwise).  ``require_lowerable`` keeps only descriptors whose
    ``to_plan`` succeeds on the topology; ``require_fits`` keeps only
    strategies whose predicted memory fits per-chip HBM — if none fit,
    the non-fitting ranking is returned anyway (callers can see *why* via
    .report.fits).
    """
    if objective is None:
        objective = default_objective(shape)
    if objective not in OBJECTIVES:
        raise StrategyError(
            f"objective {objective!r} not in {sorted(OBJECTIVES)}")
    score = OBJECTIVES[objective]
    if not cfg.moe.n_experts:
        eps = (1,)                 # ep is an MoE-only degree
    cands = candidates(topology, shape.global_batch, dp_modes=dp_modes,
                       tps=tps, cps=cps, pps=pps, eps=eps, scheds=scheds,
                       zero_stages=zero_stages, microbatches=microbatches,
                       precisions=precisions, overlaps=overlaps)
    out: List[PlannedStrategy] = []
    for s in cands:
        lowers = s.lowerable(topology, cfg)
        if require_lowerable and not lowers:
            continue
        try:
            r = evaluate(cfg, s, topology, shape)
        except StrategyError:     # unlowerable AND unpriceable (hsdp split)
            continue
        out.append(PlannedStrategy(s, r, float(score(r)), lowers))
    if require_fits and any(p.report.fits for p in out):
        out = [p for p in out if p.report.fits]
    out.sort(key=lambda p: -p.score)
    return out[:top] if top else out


def best(cfg: ModelConfig, topology: Topology, shape: ShapeConfig,
         **kw) -> Optional[PlannedStrategy]:
    ranked = search(cfg, topology, shape, **kw)
    return ranked[0] if ranked else None


def pareto_front(planned: Sequence[PlannedStrategy],
                 objectives: Sequence[str] = ("wps", "tokens_per_joule"),
                 ) -> List[PlannedStrategy]:
    """Strategies not dominated on all of ``objectives`` simultaneously."""
    fns = [OBJECTIVES[o] for o in objectives]
    pts = [(p, tuple(f(p.report) for f in fns)) for p in planned]
    front = []
    for p, v in pts:
        dominated = any(all(w[i] >= v[i] for i in range(len(v)))
                        and any(w[i] > v[i] for i in range(len(v)))
                        for q, w in pts if q is not p)
        if not dominated:
            front.append(p)
    return front


def resolve(spec: str, cfg: ModelConfig, topology: Topology,
            shape: ShapeConfig, objective: Optional[str] = None,
            **search_kw) -> Tuple[Strategy, Optional[PlannedStrategy]]:
    """CLI entry: '--strategy auto' plans, anything else parses.

    Returns (strategy, planned) — ``planned`` carries the cost report when
    the planner chose (spec == 'auto') or None for an explicit spec.
    """
    if spec == "auto":
        planned = best(cfg, topology, shape, objective=objective, **search_kw)
        if planned is None:
            raise StrategyError(
                f"planner found no viable strategy for {cfg.name} on "
                f"{topology.name} ({topology.n_devices} devices, "
                f"global_batch={shape.global_batch})")
        return planned.strategy, planned
    s = parse(spec)
    s.check(topology, cfg)
    return s, None
