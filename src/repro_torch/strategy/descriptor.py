"""The executable-strategy descriptor: one object that predicts AND runs.

A copy of the JAX package's ``strategy/descriptor.py``: the same fields,
spec grammar, checks and cost-model lowering.  Two things differ.
``Strategy.check`` also refuses a head-TP degree whose Megatron split of
the model does not divide (``_check_tensor``: the port splits heads, FFN
hidden units and the vocabulary evenly, where GSPMD would pad), so the
planner never picks a strategy the port cannot run; and ``to_plan``
builds the port's ``ParallelPlan`` over a ``torch.distributed``
``DeviceMesh``.  What follows is the JAX package's account of the design.

Historically the repo had two disconnected strategy representations:
``costmodel.Strategy`` (analytical tp/pp/cp degrees) and ``ParallelPlan``
(executable mesh + PartitionSpecs).  The cost model could rank strategies
the SPMD path cannot express and vice versa.  ``Strategy`` here is the
single source of truth:

  * ``to_plan(cfg, topology, shape)``  lowers to ``Mesh + ParallelPlan``;
  * ``to_cost_strategy(cfg, topology)`` feeds ``costmodel.step_time`` with
    collective group sizes derived from the *same* lowering rules;
  * ``parse`` / ``format`` round-trip compact spec strings
    (``"hsdp_tp4"``, ``"fsdp_cp8_ga2"``) for CLIs and sweep artifacts.

Semantics of the degrees (mirrors DESIGN.md §4 / core/parallel.py):

  * ``tp``  shards attention heads + FFN hidden on the mesh 'model' axis
            (Megatron).  Falls back to context mode when head counts do
            not divide — the spec still *lowers*, and the cost model is
            told the truth (it charges ring-KV, not TP all-reduces).
  * ``cp``  shards the sequence on the 'model' axis (ring/gathered-KV
            attention).  tp and cp share the single model axis, so at most
            one may exceed 1.
  * ``pp``  shards the layer stack over a 'pipe' mesh axis (contiguous
            stages) and lowers through a pipeline schedule in
            ``core/pipeline.py`` (in the port: the schedule's tick table
            over torch.distributed point-to-point).  Requires a
            uniform layer stack (no prefix / period-1 ``layer_plan``), a
            layer count divisible by pp, and ``mb >= pp`` microbatches
            (under-specified mb is a StrategyError, not a silent clamp).
            The stage body computes over the full inner mesh: head_tp
            plans Megatron-shard heads/hidden inside the stage, context
            plans shard the sequence, and MoE layers dispatch over the
            expert axis — pp composes with tp, cp AND ep.
  * ``sched``  pipeline schedule: 'gpipe' (default; M microbatch
            activations in flight per stage) or '1f1b' (PipeDream-flush;
            <= pp in flight — the smaller activation footprint the cost
            model's ``mem`` term credits).  Spec token ``_1f1b``
            (``fsdp_pp4_mb8_1f1b``); only meaningful with pp > 1.
  * ``ep``  expert parallelism: an 'expert' mesh axis factored out of
            the data axis (dp_effective = dp / ep).  MoE expert stacks
            shard their E dim over it and the dispatch/combine
            all-to-all runs along it (``core/expert.py``).  Requires an
            MoE config with ``n_experts % ep == 0``; ``ep == 1`` for
            dense configs.
  * ``dp_mode``  'hsdp' shards params inside an island and replicates
            across islands (adds a 'pod' axis when the topology spans
            more than one); 'fsdp' shards over the full data axis;
            'ddp' replicates (ZeRO-0).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import parallel as par
from repro_torch.core.pipeline import SCHEDULE_NAMES as SCHEDS
from repro_torch.core.pipeline import virtual_stages
from repro_torch.strategy.topology import Topology, build_mesh

DP_MODES = ("hsdp", "fsdp", "ddp")
_ATTN_TOKENS = {"headtp": "head_tp", "ctx": "context"}
_ATTN_FORMAT = {v: k for k, v in _ATTN_TOKENS.items()}
_INT_TOKEN = re.compile(r"^(tp|cp|pp|ep|z|mb|ga)(\d+)$")
# continuation of a '1f1b' token: specs split on '_', so the canonical
# interleaved name '1f1b_i<v>' arrives as the token pair ('1f1b', 'i<v>')
_IVS_TOKEN = re.compile(r"^i(\d+)$")
PRECISION_TOKENS = tuple(cm.PRECISIONS)   # 'f32' | 'bf16' | 'fp8'


class StrategyError(ValueError):
    """A spec that cannot be parsed, or a strategy that cannot lower."""



@dataclasses.dataclass(frozen=True)
class Strategy:
    """Backend-agnostic parallelization strategy descriptor."""
    dp_mode: str = "hsdp"            # 'hsdp' | 'fsdp' | 'ddp'
    tp: int = 1                      # tensor-parallel degree (model axis)
    cp: int = 1                      # context-parallel degree (model axis)
    pp: int = 1                      # pipeline degree ('pipe' mesh axis)
    sched: str = "gpipe"             # pipeline schedule: 'gpipe' | '1f1b'
                                     # | '1f1b_i<v>' (interleaved, v
                                     # virtual stages per rank) | 'zb'
                                     # (zero-bubble)
    ep: int = 1                      # expert-parallel degree ('expert' axis,
                                     # factored out of the data axis)
    zero_stage: Optional[int] = None  # None -> 0 for ddp, 3 otherwise
    microbatches: int = 1            # pipeline microbatches per step
    grad_accum: int = 1
    attn: Optional[str] = None       # None=auto | 'head_tp' | 'context'
    seq_parallel: bool = True        # Megatron-SP residual stream
    precision: str = "f32"           # mixed-precision policy: 'f32' (pure
                                     # f32 — what the lowering has always
                                     # run), 'bf16' (bf16 compute/params,
                                     # f32 master + grad reduce), or 'fp8'
                                     # (bf16 compute, fp8 on the ZeRO
                                     # all-gather wire).  Spec tokens
                                     # ``_bf16`` / ``_fp8``.
    overlap: bool = False            # double-buffered ZeRO gather
                                     # prefetch (spec token ``_ovl``):
                                     # the per-block gatherer for layer
                                     # l+1 is issued during layer l's
                                     # compute.  Needs sharded params
                                     # (zero_stage >= 2).

    def __post_init__(self):
        if self.precision not in PRECISION_TOKENS:
            raise StrategyError(
                f"precision {self.precision!r} not in {PRECISION_TOKENS}")
        if self.dp_mode not in DP_MODES:
            raise StrategyError(f"dp_mode {self.dp_mode!r} not in {DP_MODES}")
        for k in ("tp", "cp", "pp", "ep", "microbatches", "grad_accum"):
            if getattr(self, k) < 1:
                raise StrategyError(f"{k} must be >= 1, got {getattr(self, k)}")
        if self.attn not in (None, "head_tp", "context"):
            raise StrategyError(f"attn {self.attn!r} not in "
                                "(None, 'head_tp', 'context')")
        if self.zero_stage not in (None, 0, 2, 3):
            # ZeRO-1 (opt-state-only sharding) is expressible by neither the
            # SPMD lowering nor the cost model — rejecting it keeps the
            # predict-and-run contract honest
            raise StrategyError(
                f"zero_stage {self.zero_stage!r} not in (None, 0, 2, 3)")
        try:
            v = virtual_stages(self.sched)   # shared schedule grammar
        except ValueError as e:
            raise StrategyError(str(e)) from None
        if self.sched != "gpipe" and self.pp == 1:
            # a schedule token without a pipeline is meaningless, and
            # format() would drop it — reject to keep specs canonical
            raise StrategyError(
                f"sched={self.sched!r} needs pp > 1 (schedules pick the "
                "pipeline's tick order)")
        if self.pp > 1 and self.microbatches < self.pp:
            # fewer microbatches than stages cannot fill the pipeline; the
            # cost model used to clamp mb up to pp silently, letting the
            # analytic price and the lowering diverge — reject instead
            raise StrategyError(
                f"pp={self.pp} needs microbatches >= pp to fill the "
                f"pipeline (got mb={self.microbatches}); spec e.g. "
                f"'fsdp_pp{self.pp}_mb{2 * self.pp}'")
        if v > 1 and self.microbatches % self.pp:
            # the interleaved chunk rotation assigns microbatches to
            # ranks in groups of pp
            raise StrategyError(
                f"sched={self.sched!r} needs microbatches divisible by "
                f"pp={self.pp} (got mb={self.microbatches})")
        if self.overlap and self.zero < 2:
            raise StrategyError(
                "ovl (double-buffered ZeRO gather prefetch) needs "
                "sharded params (zero_stage >= 2); got "
                f"dp_mode={self.dp_mode!r}, zero_stage={self.zero_stage!r}")

    # ---- derived -----------------------------------------------------------

    @property
    def zero(self) -> int:
        if self.zero_stage is not None:
            return self.zero_stage
        return 0 if self.dp_mode == "ddp" else 3

    @property
    def model_axis(self) -> int:
        """Size of the SPMD 'model' mesh axis (tp and cp share it)."""
        return self.tp * self.cp

    @property
    def model_parallel(self) -> int:
        return self.tp * self.cp * self.pp

    def dp_degree(self, topology: Topology) -> int:
        """Total data-parallel degree (the 'expert' axis is part of it:
        batch and gradients shard over (data, expert) together)."""
        return topology.n_devices // self.model_parallel

    def dp_effective(self, topology: Topology) -> int:
        """Size of the 'data' mesh axis alone: dp / ep."""
        return self.dp_degree(topology) // self.ep

    def n_pods(self, topology: Topology) -> int:
        """Leading 'pod' axis size: HSDP across islands, else folded in."""
        if self.dp_mode != "hsdp" or topology.n_devices <= topology.island:
            return 1
        return topology.n_islands

    def resolved_attn(self, cfg: ModelConfig) -> str:
        """Attention mode the lowering will actually use."""
        if self.cp > 1:
            return "context"
        if self.attn is not None:
            return self.attn
        if self.tp == 1:
            return "head_tp"
        if cfg.mixer != "attn" and cfg.attn_every <= 1:
            return "head_tp"          # no attention layers at all
        return "head_tp" if cfg.n_heads % self.tp == 0 else "context"

    # ---- validation --------------------------------------------------------

    def check(self, topology: Topology,
              cfg: Optional[ModelConfig] = None) -> None:
        """Raise StrategyError if this strategy cannot lower on topology.

        Passing ``cfg`` additionally validates the model-dependent pipeline
        constraints (uniform layer stack, layer count divisible by pp);
        ``to_plan`` always does.  In the port, given ``cfg``, a head-TP
        degree that does not split the model evenly raises too.
        """
        n = topology.n_devices
        if self.tp > 1 and self.cp > 1:
            raise StrategyError(
                "tp and cp share the single 'model' mesh axis; at most one "
                f"may exceed 1 (got tp={self.tp}, cp={self.cp})")
        if n % (self.model_axis * self.pp * self.ep):
            raise StrategyError(
                f"model axis {self.model_axis} x pipe {self.pp} x expert "
                f"{self.ep} does not divide {n} devices")
        pods = self.n_pods(topology)
        if pods > 1 and n % (pods * self.model_axis * self.pp * self.ep):
            raise StrategyError(
                f"HSDP pods={pods} x pipe={self.pp} x expert={self.ep} x "
                f"model={self.model_axis} does not divide {n} devices")
        if self.dp_degree(topology) < 1:
            raise StrategyError(
                f"model_parallel={self.model_parallel} exceeds "
                f"{n} devices")
        if pods > 1 and (self.dp_degree(topology) // pods) % self.ep:
            # the expert axis must live inside the island-local FSDP
            # group, or the reduced expert-param gather group is not a
            # whole number of ranks
            raise StrategyError(
                f"ep={self.ep} does not divide the island-local data "
                f"group {self.dp_degree(topology) // pods}")
        if cfg is not None and self.model_axis > 1:
            self._check_tensor(cfg)
        if cfg is not None and self.ep > 1:
            self._check_expert(cfg)
        if cfg is not None and self.pp > 1:
            self._check_pipeline(cfg)

    def _check_tensor(self, cfg: ModelConfig) -> None:
        """The port's head-TP constraints: the heads, FFN hidden units,
        vocabulary and, on a stack with Mamba layers, ``d_inner`` split
        evenly over the model axis (the Megatron pairs of column- and
        row-parallel products shard together; the KV heads may
        replicate).  A model axis that resolves to context attention
        shards the sequence and keeps every weight whole but the
        recurrent mixers' (RWKV-6 heads, Mamba's d_inner), which split
        over it in every plan."""
        kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
        recurrent = {}
        if "rwkv6" in kinds:
            recurrent["heads"] = cfg.rwkv_heads
        if "mamba" in kinds:
            recurrent["d_inner"] = cfg.mamba.expand * cfg.d_model
        if self.resolved_attn(cfg) == "context":
            name, dims = f"model axis {self.model_axis}", recurrent
        else:
            name = f"tp={self.tp}"
            dims = {"heads": cfg.n_heads, "d_ff": cfg.dense_d_ff or cfg.d_ff,
                    "vocab_size": cfg.vocab_size, **recurrent}
        for what, size in dims.items():
            if size % self.model_axis:
                raise StrategyError(
                    f"{name} does not divide {what}={size} of "
                    f"{cfg.name}: the port's tensor parallelism splits it "
                    "evenly over the model axis")

    def _check_expert(self, cfg: ModelConfig) -> None:
        """Model-dependent ep constraints (expert-stack sharding)."""
        E = cfg.moe.n_experts
        if not E or not any(cfg.is_moe_layer(i) for i in range(cfg.n_layers)):
            raise StrategyError(
                f"ep={self.ep} needs an MoE config with routed experts; "
                f"{cfg.name} is dense (ep must be 1)")
        if E % self.ep:
            raise StrategyError(
                f"ep={self.ep} does not divide n_experts={E} "
                f"({cfg.name}); expert stacks cannot shard evenly")

    def _check_pipeline(self, cfg: ModelConfig) -> None:
        """Model-dependent pp constraints (stage assignment + the inner
        mesh the stage body must compose)."""
        from repro_torch.models.transformer import layer_plan
        prefix, _start, period, n_blocks = layer_plan(cfg)
        if prefix or period != 1 or not n_blocks:
            raise StrategyError(
                f"pp={self.pp} needs a uniform layer stack to form stages; "
                f"{cfg.name} has layer_plan(prefix={len(prefix)}, "
                f"period={period})")
        if cfg.n_layers % self.pp:
            raise StrategyError(
                f"{cfg.n_layers} layers do not split into {self.pp} "
                "contiguous pipeline stages")
        v = virtual_stages(self.sched)
        if cfg.n_layers % (self.pp * v):
            raise StrategyError(
                f"{cfg.n_layers} layers do not split into pp={self.pp} x "
                f"v={v} virtual-stage chunks (sched={self.sched!r})")
        if cfg.rope == "mrope":
            raise StrategyError(
                "mrope angles are batch-dependent and cannot broadcast "
                "across pipeline microbatches; pp > 1 unsupported")
        ma = self.model_axis
        if ma <= 1:
            return
        # pp x tp / pp x cp composed compute: the stage body runs the
        # model-axis collectives manually (Megatron psums / gathered-KV),
        # implemented for attention stacks only
        if cfg.layer_kind(0) != "attn":
            raise StrategyError(
                f"pp={self.pp} with a model axis of {ma} runs manual "
                f"tensor/context parallelism inside the stage, which is "
                f"implemented for attention stacks only ({cfg.name} is "
                f"{cfg.layer_kind(0)})")
        if self.resolved_attn(cfg) != "head_tp":
            return          # context mode: stage params stay replicated
        if cfg.n_heads % ma or cfg.kv_heads % ma:
            raise StrategyError(
                f"pp x tp composed stage needs n_heads={cfg.n_heads} and "
                f"kv_heads={cfg.kv_heads} divisible by the model axis {ma}")
        moe_stack = cfg.is_moe_layer(0)
        if moe_stack:
            if self.ep == 1:
                raise StrategyError(
                    f"MoE expert stacks cannot shard experts over the "
                    f"model axis inside a pipeline stage; compose with "
                    f"ep<k> instead (got tp={ma}, ep=1, pp={self.pp})")
            if cfg.moe.expert_d_ff % ma:
                raise StrategyError(
                    f"pp x tp composed MoE stage needs expert_d_ff="
                    f"{cfg.moe.expert_d_ff} divisible by the model axis {ma}")
            if cfg.moe.n_shared_experts and \
                    (cfg.moe.n_shared_experts * cfg.moe.expert_d_ff) % ma:
                raise StrategyError(
                    f"pp x tp composed MoE stage needs the shared-expert "
                    f"hidden dim divisible by the model axis {ma}")
        else:
            dff = cfg.dense_d_ff or cfg.d_ff
            if dff % ma:
                raise StrategyError(
                    f"pp x tp composed stage needs d_ff={dff} divisible "
                    f"by the model axis {ma}")

    def lowerable(self, topology: Topology,
                  cfg: Optional[ModelConfig] = None) -> bool:
        try:
            self.check(topology, cfg)
            return True
        except StrategyError:
            return False

    # ---- lowering: SPMD ----------------------------------------------------

    def to_plan(self, cfg: ModelConfig, topology: Topology, shape: ShapeConfig,
                abstract: bool = False,
                device_type: Optional[str] = None) -> par.ParallelPlan:
        """Lower to an executable ``ParallelPlan`` on this topology's mesh.

        ``abstract=True`` builds the ``{axis: size}`` mapping instead of a
        ``DeviceMesh`` (group-size analysis without a process group);
        ``device_type`` names the mesh's device type where the process
        group's backend does not (``build_mesh``).
        """
        self.check(topology, cfg)
        if self.pp > 1 and shape.mode == "train":
            per_step = self.grad_accum * self.microbatches
            if shape.global_batch % per_step:
                raise StrategyError(
                    f"global_batch={shape.global_batch} does not split "
                    f"into grad_accum={self.grad_accum} x "
                    f"microbatches={self.microbatches}")
            if self.ep > 1:
                # the expert all-to-all inside a stage needs the
                # microbatch rows actually sharded over the expert axis
                # (fit-or-drop keeps axes in (pod, data, expert) order)
                rows = shape.global_batch // per_step
                pods = self.n_pods(topology)
                size = rows
                for n in ((pods,) if pods > 1 else ()) + \
                        (self.dp_effective(topology) // max(pods, 1),):
                    if n > 1 and size % n == 0 and size >= n:
                        size //= n
                if self.ep > 1 and (size % self.ep or size < self.ep):
                    raise StrategyError(
                        f"pp x ep: microbatch rows={rows} do not shard "
                        f"over the expert axis (ep={self.ep}) after the "
                        "data axes — grow global_batch or lower "
                        "grad_accum x microbatches")
        if self.pp > 1 and self.model_axis > 1 and cfg is not None and \
                shape.mode != "decode" and \
                self.resolved_attn(cfg) == "context" and \
                shape.seq_len % self.model_axis:
            raise StrategyError(
                f"pp x cp composed stage shards the sequence: seq_len="
                f"{shape.seq_len} must divide by the model axis "
                f"{self.model_axis}")
        pods = self.n_pods(topology)
        mesh = build_mesh(topology, model=self.model_axis, pods=pods,
                          pipe=self.pp, expert=self.ep, abstract=abstract,
                          device_type=device_type)
        attn = self.resolved_attn(cfg)
        has_pod = pods > 1
        has_ep = self.ep > 1
        # the expert axis is factored out of data: batch (and the full
        # data-parallel gradient reduction) spans both
        dp: Tuple[str, ...] = (("pod",) if has_pod else ()) + ("data",) + \
            (("expert",) if has_ep else ())
        if self.dp_mode == "ddp" or self.zero == 0:
            fsdp: Tuple[str, ...] = ()
        elif has_pod:                 # hsdp: shard inside the island only
            fsdp = ("data",) + (("expert",) if has_ep else ())
        else:
            fsdp = dp
        kv_tp = attn == "head_tp" and cfg.kv_heads % self.model_axis == 0

        # decode cache: shard sequence over model, and over data too when
        # the batch cannot occupy the data axis (long-context, batch=1)
        data_size = topology.n_devices // (self.model_axis * self.pp)
        if shape.mode == "decode" and shape.global_batch < data_size:
            cache_axes = (("pod",) if has_pod else ()) + ("data",) + \
                (("expert",) if has_ep else ()) + ("model",)
        else:
            cache_axes = ("model",)

        return par.ParallelPlan(
            mesh=mesh, dp=dp, fsdp=fsdp, tp="model", attn=attn, kv_tp=kv_tp,
            shape_mode=shape.mode, decode_cache_axes=cache_axes,
            seq_parallel_residuals=self.seq_parallel,
            pipe="pipe" if self.pp > 1 else "",
            microbatches=self.microbatches if self.pp > 1 else 1,
            pipe_sched=self.sched,
            zero_overlap=self.overlap,
            expert="expert" if has_ep else "",
            precision=self.precision, zero=self.zero)

    # ---- lowering: cost model ----------------------------------------------

    def to_cost_strategy(self, cfg: ModelConfig,
                         topology: Topology) -> cm.Strategy:
        """The analytic view, with group sizes matching ``to_plan``.

        When the resolved attention mode is 'context', the whole model axis
        moves sequence, not heads — the cost model is charged ring-KV
        context parallelism of degree tp*cp, not TP all-reduces.  HSDP
        topologies additionally pin the FSDP collective group to the
        island ('data' axis), with the cross-island gradient all-reduce
        charged separately by ``step_time``.
        """
        attn = self.resolved_attn(cfg)
        if attn == "context":
            tp_c, cp_c = 1, self.model_axis
        else:
            tp_c, cp_c = self.model_axis, 1
        pods = self.n_pods(topology)
        dp = self.dp_degree(topology)
        if pods > 1 and dp % pods:
            raise StrategyError(
                f"HSDP dp={dp} does not split across {pods} islands; the "
                "descriptor cannot lower in this regime, so it has no "
                "coherent analytic price either")
        fsdp_group = dp // pods if pods > 1 else 0
        # mb >= pp is enforced at construction, so the microbatch count the
        # cost model's bubble term sees is exactly what the lowering runs
        return cm.Strategy(
            n_devices=topology.n_devices, tp=tp_c, pp=self.pp, cp=cp_c,
            ep=self.ep,
            zero_stage=self.zero,
            microbatches=self.microbatches, sched=self.sched,
            overlap=self.overlap,
            fsdp_group=fsdp_group, precision=self.precision)

    # ---- spec strings ------------------------------------------------------

    def format(self) -> str:
        """Canonical compact spec string; ``parse(format(s)) == s``."""
        parts = [self.dp_mode]
        for key, val in (("tp", self.tp), ("cp", self.cp), ("pp", self.pp),
                         ("ep", self.ep)):
            if val > 1:
                parts.append(f"{key}{val}")
        if self.zero_stage is not None:
            parts.append(f"z{self.zero_stage}")
        if self.microbatches > 1:
            parts.append(f"mb{self.microbatches}")
        if self.grad_accum > 1:
            parts.append(f"ga{self.grad_accum}")
        if self.sched != "gpipe":
            parts.append(self.sched)
        if self.overlap:
            parts.append("ovl")
        if self.precision != "f32":
            parts.append(self.precision)
        if self.attn is not None:
            parts.append(_ATTN_FORMAT[self.attn])
        if not self.seq_parallel:
            parts.append("nosp")
        return "_".join(parts)

    def __str__(self) -> str:
        return self.format()


def parse(spec: str) -> Strategy:
    """Parse a compact spec string into a ``Strategy``.

    Grammar: ``<dp_mode>[_tp<k>][_cp<k>][_pp<k>][_ep<k>][_z<stage>][_mb<m>]
    [_ga<g>][_gpipe|_1f1b[_i<v>]|_zb][_ovl][_f32|_bf16|_fp8][_headtp|_ctx]
    [_nosp]`` with dp_mode in {hsdp, fsdp, ddp}.  Examples: ``hsdp_tp4``,
    ``fsdp_cp8``, ``fsdp_ep8``, ``hsdp_tp2_ep4``, ``fsdp_pp4_mb8_1f1b``,
    ``fsdp_pp4_mb8_1f1b_i2``, ``fsdp_pp4_mb8_zb_ovl``, ``ddp``,
    ``fsdp_bf16``, ``hsdp_tp4_ga2_nosp``.
    """
    tokens = spec.strip().lower().split("_")
    if not tokens or tokens[0] not in DP_MODES:
        raise StrategyError(
            f"spec {spec!r} must start with one of {DP_MODES}")
    kw = {"dp_mode": tokens[0]}
    names = {"tp": "tp", "cp": "cp", "pp": "pp", "ep": "ep",
             "z": "zero_stage", "mb": "microbatches", "ga": "grad_accum"}
    for tok in tokens[1:]:
        if tok == "nosp":
            kw["seq_parallel"] = False
            continue
        if tok in SCHEDS:
            if "sched" in kw:
                raise StrategyError(
                    f"duplicate token {tok!r} in spec {spec!r}")
            kw["sched"] = tok
            continue
        m_i = _IVS_TOKEN.match(tok)
        if m_i and kw.get("sched") == "1f1b":
            # '1f1b_i<v>' split into ('1f1b', 'i<v>') — rejoin; the
            # Strategy constructor validates v >= 2 via the shared grammar
            kw["sched"] = f"1f1b_i{m_i.group(1)}"
            continue
        if tok == "ovl":
            if kw.get("overlap"):
                raise StrategyError(
                    f"duplicate token {tok!r} in spec {spec!r}")
            kw["overlap"] = True
            continue
        if tok in _ATTN_TOKENS:
            kw["attn"] = _ATTN_TOKENS[tok]
            continue
        if tok in PRECISION_TOKENS:
            if "precision" in kw:
                raise StrategyError(
                    f"duplicate token {tok!r} in spec {spec!r}")
            kw["precision"] = tok
            continue
        m = _INT_TOKEN.match(tok)
        if not m:
            raise StrategyError(
                f"bad token {tok!r} in spec {spec!r} (expected "
                "tp<k>/cp<k>/pp<k>/ep<k>/z<s>/mb<m>/ga<g>/gpipe/1f1b/"
                "1f1b_i<v>/zb/ovl/f32/bf16/fp8/headtp/ctx/nosp)")
        field = names[m.group(1)]
        if field in kw:
            raise StrategyError(f"duplicate token {tok!r} in spec {spec!r}")
        kw[field] = int(m.group(2))
    return Strategy(**kw)


def format_spec(strategy: Strategy) -> str:
    return strategy.format()
