"""Parallelization plan of the port: the precision policies, the
parameter and activation specs and the lowering of the JAX package's
``core/parallel.py`` onto FSDP2 and tensor parallelism over a
``DeviceMesh``.

``PrecisionPolicy``, ``PRECISION_POLICIES`` and ``ParallelPlan`` are
copies (the plan sits over a ``torch.distributed`` ``DeviceMesh``, and
carries its ZeRO stage, which FSDP2 needs and the JAX lowering leaves to
XLA); so are ``_fit_spec``/``fitted``, ``_mixer_kind``, ``_param_spec``
and ``activation_specs``, whose specs are tuples of mesh-axis entries in
place of ``PartitionSpec``s (a parameter's path is its dotted
``named_parameters`` name).  ``make_runtime`` derives a ``Runtime``'s
dtypes from the plan's policy as the JAX one does, and gives it the
model axis: its process group, size and rank, and whether the residual
stream is sequence-parallel (``activation_specs``' ``act_btd``).

``apply_plan`` takes the place of ``param_shardings`` and
``place_train_state``, in FSDP2's documented TP composition: every
parameter first becomes a ``DTensor`` over the model axis with the
placement ``param_placements`` reads off ``_param_spec`` (``Shard(d)`` or
``Replicate()``), then every layer, and the whole model, is wrapped in
``fully_shard`` over the data axes of the same root mesh, so each layer's
parameters are gathered over the data axes in its forward and its
gradients reduce-scattered over them in its backward.  The model
computes on the gathered parameters' local (model-axis) shards, with
Megatron's collectives between (``models.layers``).  Every plan takes
this one lowering; on a model axis of size 1 the model runs no
collective.  The data axes:

  * ``fsdp`` shards over the ``data`` axis (ZeRO-3 reshards each layer
    after its forward, ZeRO-2 keeps it gathered until its backward);
  * ``hsdp`` across islands shards over ``data`` and replicates over
    ``pod`` (FSDP2 on a 2-D mesh);
  * ``ddp`` (ZeRO-0) replicates over the data axes and shards over a
    size-1 ``zero`` axis of a root mesh of its own, (dp, zero, model) —
    every rank holds whole layers of its model shard.

Gathers run at the parameter dtype (f32), as the JAX package gathers
(``comm_dtype ''``); the bf16 cast stays where the model casts (the
embedding, the LM head, each product).  Under a policy with a
``comm_dtype`` (fp8) on a plan that shards parameters, each stacked
layer's floating parameters (``transformer.wired_layers``: not a prefix
layer's) go on FSDP2's all-gather in that dtype: their local
shards are :class:`Fp8Wire` tensors, whose ``fsdp_pre_all_gather`` casts
f32 straight to float8_e4m3fn (no scale) and ``fsdp_post_all_gather``
back to ``compute_dtype``, as ``make_param_gatherer`` quantizes, gathers
and dequantizes.  The embedding, the LM head and the final norm gather at
f32 in the root unit, as the JAX gatherer runs only inside the scan over
the layers.  Gradients reduce-scatter at ``grad_dtype``.  ``_ovl`` becomes
FSDP2's explicit prefetch of layer i + 1 while layer i computes.

Serving under a plan keeps the dense caches where ``cache_shardings``
places them (the JAX package's layout): the KV cache (B, Sc, Kv, D) is
sharded along Sc over ``decode_cache_axes`` (the model axis, or data x
model when the batch is smaller than the data axis, its rows then
replicated), the WKV state by heads and a Mamba layer's conv and SSM
states by channels over the model axis, ``x_prev`` by
rows over the data axes, ``kpos`` and ``idx`` replicated.  A rank serves
the rows ``serve_rows`` gives it; ``make_runtime`` gives a serving shape's
runtime this rank's shard of the KV slots and the groups over which a
decode step merges its attention (``models.attention``).

A context plan (``attn`` 'context': ``cp<k>``, or a tp whose heads do not
split) keeps every weight whole on the model axis but the MoE expert
stacks (their E dim on it, as ``_param_spec`` places them in every plan
without an expert axis) and the recurrent mixers' (RWKV-6 time mix,
Mamba), which ``_param_spec`` splits over it in every plan: those run on
their shards over the gathered sequence (``models.transformer.Layer``);
its runtime takes the axis as its sequence axis (``Runtime.context``),
and the train step sums every replicated leaf's gradient over it.  Under an expert axis a MoE FFN's leaves lie on the
(expert, model) submesh: the stacks' E dim on the expert axis and, where
the model axis has more than one rank, their hidden dim on it
(:func:`expert_placements`).

A plan with a ``pipe`` axis (``core.pipeline``) keeps on each pipe rank
only the layers of its stages; they are lowered as above over the (data,
model) submesh of its pipe coordinate, and the embedding, final norm and
LM head stay replicated over the pipe axis.  Its stage layers take no fp8
wire: the JAX stage body gathers them at f32 (``gather_params=None``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.strategy.topology import mesh_shape

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Execution-side mixed-precision policy (dtype names, not torch
    dtypes, so the plan stays hashable and equal to the JAX package's).

    ``param_dtype`` is the stored-parameter dtype the runtime computes
    from; master parameters always stay f32 (``init_params`` initializes
    f32 and the optimizer updates in f32 — torchtitan's
    ``MixedPrecisionPolicy`` split).  ``compute_dtype`` is the activation/
    matmul dtype, ``grad_dtype`` the grad-accumulation/reduce dtype, and
    ``comm_dtype`` (when set) the wire dtype of the per-layer ZeRO param
    all-gathers — the emulated-fp8-comms path: quantize, gather, and
    dequantize back to ``compute_dtype`` (FSDP2's fp8 all-gather
    extension point).
    """
    name: str
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    grad_dtype: str = "float32"
    comm_dtype: str = ""                 # '' = gather at param_dtype


PRECISION_POLICIES = {
    "f32": PrecisionPolicy("f32"),
    "bf16": PrecisionPolicy("bf16", param_dtype="float32",
                            compute_dtype="bfloat16"),
    "fp8": PrecisionPolicy("fp8", param_dtype="float32",
                           compute_dtype="bfloat16",
                           comm_dtype="float8_e4m3fn"),
}


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    mesh: Any                            # DeviceMesh, or {axis: size}
    dp: Tuple[str, ...]                  # batch-dim axes ('pod','data') or ('data',)
    fsdp: Tuple[str, ...]                # param-shard axes (HSDP: ('data',))
    tp: str                              # model axis name
    attn: str                            # 'head_tp' | 'context'
    kv_tp: bool                          # shard KV heads on model axis
    shape_mode: str = "train"            # train | prefill | decode
    decode_cache_axes: Tuple[str, ...] = ("model",)
    seq_parallel_residuals: bool = True  # Megatron-SP residual stream
    pipe: str = ""                       # pipeline mesh axis ('' = no PP)
    microbatches: int = 1                # pipeline microbatches per minibatch
    pipe_sched: str = "gpipe"            # pipeline schedule: 'gpipe' |
                                         # '1f1b' | '1f1b_i<v>' | 'zb'
    zero_overlap: bool = False           # prefetch layer l+1's gather
                                         # during layer l's compute
    expert: str = ""                     # expert mesh axis ('' = no EP)
    precision: str = "f32"               # PRECISION_POLICIES key
    zero: int = 3                        # ZeRO stage: 3 reshards a layer
                                         # after its forward, 2 keeps it
                                         # gathered through its backward,
                                         # 0 replicates (fsdp == ())

    @property
    def policy(self) -> PrecisionPolicy:
        return PRECISION_POLICIES[self.precision]

    @property
    def tp_size(self) -> int:
        return mesh_shape(self.mesh)[self.tp]

    @property
    def pipe_size(self) -> int:
        return mesh_shape(self.mesh)[self.pipe] if self.pipe else 1

    @property
    def ep_size(self) -> int:
        return mesh_shape(self.mesh)[self.expert] if self.expert else 1

    @property
    def fsdp_no_expert(self) -> Tuple[str, ...]:
        """Param-shard axes for tensors already sharded over 'expert'
        (the non-E dims of expert stacks must not reuse the axis)."""
        return tuple(a for a in self.fsdp if a != self.expert)

    def axis_size(self, axes) -> int:
        shape = mesh_shape(self.mesh)
        n = 1
        for a in axes:
            n *= shape[a]
        return n


# ---------------------------------------------------------------------------
# spec fitting: drop axes that do not divide the dimension
# ---------------------------------------------------------------------------

def _fit_spec(spec: Tuple, shape, mesh) -> Tuple:
    shape_of = mesh_shape(mesh)
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        keep = []
        size = shape[dim]
        for a in axes:
            n = shape_of[a]
            if size % n == 0 and size >= n:
                keep.append(a)
                size //= n
            # else: drop axis (dim not divisible)
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return tuple(out)


def fitted(plan: ParallelPlan, spec: Tuple, x_or_shape) -> Tuple:
    """``spec`` padded to the rank of ``x_or_shape`` and fitted to its
    shape on the plan's mesh (the JAX ``fitted``, as a spec tuple)."""
    shape = tuple(getattr(x_or_shape, "shape", x_or_shape))
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return _fit_spec(spec, shape, plan.mesh)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _mixer_kind(cfg: ModelConfig, path: Tuple[str, ...]) -> str:
    """Mixer kind ('attn' | 'rwkv6' | 'mamba') of the layer owning a leaf.

    Attention and rwkv time-mix share leaf names (wk/wv/wo/wr), so specs
    must discriminate on the layer's kind, not the leaf name.  A port
    leaf's path names its layer (``layers.<i>...``)."""
    if cfg.mixer == "attn" or cfg.attn_every <= 1:
        return cfg.mixer
    if path[0] == "layers":
        return cfg.layer_kind(int(path[1]))
    return cfg.mixer


def _param_spec(cfg: ModelConfig, plan: ParallelPlan, path: Tuple[str, ...],
                ndim: int) -> Tuple:
    """Spec for one parameter leaf, identified by its path (the dotted
    ``named_parameters`` name, split).  The port's layers are not
    stacked, so no leaf carries the JAX package's leading stack dim."""
    f, m = plan.fsdp, plan.tp
    names = list(path)
    leaf = names[-1]

    def spec(*entries):
        return entries + (None,) * (ndim - len(entries))

    in_attention = "mixer" in names
    vocab_tp = plan.attn == "head_tp"   # context plans keep vocab unsharded

    if leaf == "tok":
        return spec(m if vocab_tp else None, f)
    if leaf == "lm_head":
        return spec(f, m if vocab_tp else None)
    if leaf in ("scale", "bias") or ndim == 0:
        return spec()
    if leaf == "router":
        return spec(f, None)
    # MoE expert stacks (E, d, f) / (E, f, d)
    if ndim == 3 and leaf in ("w_up", "w_gate", "w_down"):
        if plan.expert:
            # EP: the E dim shards over the 'expert' axis for good (no
            # gather over it); the d dim ZeRO-shards over the other data
            # axes and the hidden dim takes the model axis
            f_ne = plan.fsdp_no_expert or None
            return spec(plan.expert,
                        f_ne if leaf != "w_down" else m,
                        m if leaf != "w_down" else f_ne)
        return spec(m, f if leaf != "w_down" else None,
                    f if leaf == "w_down" else None)
    if in_attention:
        kind = _mixer_kind(cfg, path)
        if kind == "attn":
            head_m = m if plan.attn == "head_tp" else None
            kv_m = m if plan.kv_tp else None
            if leaf == "wq":
                return spec(f, head_m)
            if leaf in ("wk", "wv"):
                return spec(f, kv_m)
            if leaf == "wo":
                return spec(head_m, f)
            if leaf == "bq":
                return spec(head_m)
            if leaf in ("bk", "bv"):
                return spec(kv_m)
        elif kind == "rwkv6":
            if leaf in ("wr", "wk", "wv", "wg"):
                return spec(f, m)
            if leaf == "wo":
                return spec(m, f)
            if leaf == "u":
                return spec(m, None)
            if leaf in ("tm_w1", "td_w1"):
                return spec(f, None)
            if leaf == "td_w2":
                return spec(None, f)
            if leaf == "tm_w2":
                return spec(None, None, f)
            if leaf == "maa_x":
                return spec()
            if leaf == "maa_rkvwg":
                return spec(None, None)
            if leaf == "w0":
                return spec()
        elif kind == "mamba":
            if leaf in ("w_x_in", "w_z_in"):
                return spec(f, m)
            if leaf == "conv_w":
                return spec(None, m)
            if leaf in ("conv_b", "b_dt", "D"):
                return spec(m)
            if leaf == "w_x":
                return spec(m, None)
            if leaf == "w_dt":
                return spec(None, m)
            if leaf == "A_log":
                return spec(m, None)
            if leaf == "w_out":
                return spec(m, f)
    # dense / rwkv channel-mix FFN (2D)
    ffn_m = m if plan.attn == "head_tp" else None
    if leaf in ("w_up", "w_gate"):
        return spec(f, ffn_m)
    if leaf == "w_down":
        return spec(ffn_m, f)
    if leaf == "wk":            # rwkv channel-mix key (d, dff)
        return spec(f, ffn_m)
    if leaf == "wv":            # rwkv channel-mix value (dff, d)
        return spec(ffn_m, f)
    if leaf == "wr":
        return spec(f, None)
    if leaf in ("maa_k", "maa_r"):
        return spec()
    return spec()


def param_placements(cfg: ModelConfig, plan: ParallelPlan, params):
    """{name: placement on the model axis} for every parameter of
    ``params`` (a module, or (name, tensor) pairs): ``Shard(d)`` where the
    fitted ``_param_spec`` puts the model axis on dim d, else
    ``Replicate()``.  The data axes' placements are FSDP2's: on dim 0,
    but a MoE expert stack's on the dim where the fitted ``_param_spec``
    puts them (:func:`data_shard_dim`).  Under an expert axis a MoE FFN's
    leaves are placed on that axis instead (:func:`on_expert_axis`): the
    expert stacks ``Shard(0)``
    (``_param_spec``'s E dim), the router and shared experts
    ``Replicate()``; their model-axis placement is
    :func:`model_placement`'s, on the (expert, model) mesh
    (:func:`expert_placements`)."""
    from torch.distributed.tensor import Replicate, Shard
    named = (params.named_parameters() if hasattr(params, "named_parameters")
             else params)
    out = {}
    for name, p in named:
        if on_expert_axis(name, cfg, plan):
            # only a stack's E dim: the data axes of a router's or shared
            # expert's spec are ZeRO's, which FSDP2 owns
            out[name] = Shard(0) if p.ndim == 3 else Replicate()
            continue
        out[name] = model_placement(cfg, plan, name, p)
    return out


def model_placement(cfg: ModelConfig, plan: ParallelPlan, name: str, p):
    """``Shard(d)`` where the fitted ``_param_spec`` of parameter ``name``
    (shaped as ``p``) puts the model axis on dim d, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    spec = fitted(plan, _param_spec(cfg, plan, tuple(name.split(".")),
                                    p.ndim), p.shape)
    dims = [d for d, e in enumerate(spec)
            if plan.tp in (e if isinstance(e, tuple) else (e,))]
    return Shard(dims[0]) if dims else Replicate()


def data_shard_dim(cfg: ModelConfig, plan: ParallelPlan, name: str, p):
    """The dim FSDP2 shards parameter ``name`` (shaped as ``p``, whole)
    over the data axes: a MoE expert stack's (E, d, f) / (E, f, d) where
    the fitted ``_param_spec`` puts them (their d: dim 1 of ``w_up`` and
    ``w_gate``, dim 2 of ``w_down``; under an expert axis the data axes
    without it), else None, FSDP2's default (dim 0): every other leaf, or
    a stack whose fit drops the axes.  On dim 0 a stack of fewer experts
    than data ranks would be padded to a whole expert a rank."""
    parts = name.split(".")
    if p.ndim != 3 or parts[-1] not in ("w_up", "w_gate", "w_down"):
        return None
    data = set(plan.fsdp_no_expert if plan.expert else plan.fsdp)
    spec = fitted(plan, _param_spec(cfg, plan, tuple(parts), p.ndim),
                  p.shape)
    dims = [d for d, e in enumerate(spec)
            if data & set(e if isinstance(e, tuple) else (e,))]
    return dims[0] if dims else None


def expert_placements(cfg: ModelConfig, plan: ParallelPlan, name: str, p):
    """A MoE FFN leaf's placements under an expert axis: on the expert
    axis (:func:`param_placements`), then, where the model axis has more
    than one rank, on it (the expert stacks' hidden dim, the shared
    experts' as a dense FFN's, the router whole)."""
    out = [param_placements(cfg, plan, [(name, p)])[name]]
    if plan.tp_size > 1:
        out.append(model_placement(cfg, plan, name, p))
    return out


def on_expert_axis(name: str, cfg: ModelConfig, plan: ParallelPlan) -> bool:
    """Whether a parameter lives on the expert axis under ``plan``: every
    leaf of a MoE layer's FFN (its expert stacks sharded over the axis,
    the router and shared experts replicated on it), in the unit of its
    own that :func:`apply_plan` makes of that FFN."""
    parts = name.split(".")
    return bool(plan.expert) and parts[0] == "layers" and \
        parts[2] == "ffn" and cfg.is_moe_layer(int(parts[1]))


def grad_sums_over_model(name: str, placement, seq_parallel: bool) -> bool:
    """Whether a parameter's gradient on one model-axis rank is a part of
    its gradient, to be summed over the model group after the backward
    (Megatron's all-reduce of the sequence-parallel norms' gradients).
    A sharded leaf's gradient is its shard's, whole.  A replicated leaf
    inside a mixer or an FFN (qk-norm scales, KV projections that do not
    shard, rwkv6's mixes, decay, group norm and channel-mix receptance)
    takes part in each rank's share of heads or hidden units, between the
    sublayer's entry and its exit collective.  A norm on the residual
    stream sees each rank's S-shard under sequence parallelism, and the
    whole sequence (the same on every rank) without it."""
    if not placement.is_replicate():
        return False
    parts = name.split(".")
    if "mixer" in parts or "ffn" in parts:
        return True
    return seq_parallel


# ---------------------------------------------------------------------------
# activation specs
# ---------------------------------------------------------------------------

def activation_specs(cfg: ModelConfig, plan: ParallelPlan) -> Dict[str, Tuple]:
    """The JAX package's named activation specs, for the names the port's
    forward and its dense caches use."""
    dp, m = plan.dp, plan.tp
    cache_seq = plan.decode_cache_axes
    cp = plan.attn == "context"
    decode = plan.shape_mode == "decode"
    seq = m if (cp and not decode) else None
    # Megatron-style sequence parallelism for the residual stream: pure
    # attention architectures keep (B, S, d) activations seq-sharded on the
    # model axis between layers (all-gather at matmul entry, reduce-scatter
    # after wo/w_down).  Recurrent mixers (rwkv/mamba/hybrid) scan along the
    # sequence and keep residuals seq-unsharded.
    res_seq = m if (not decode and cfg.mixer == "attn"
                    and plan.seq_parallel_residuals) else seq
    return {
        # (B, S, d): sequence sharded for context-parallel plans + SP
        "act_btd": (dp, res_seq, None),
        # (B, S, f): FFN hidden — TP for head plans, seq-sharded for CP
        "act_btf": (dp, seq, None if cp else m),
        # (B, S, V)
        "logits": (dp, seq, None if cp else m),
        # (B, S, H, hd)
        "heads_q": (dp, seq, None if cp else m, None),
        "heads_kv": (dp, seq, (m if plan.kv_tp else None) if not cp else None,
                     None),
        # decode KV cache (B, Sc, Kv, hd): sequence-sharded flash-decode
        "kv_cache": (dp if not decode or len(cache_seq) == 1 else None,
                     cache_seq if decode else None, None, None),
        # rwkv
        "rwkv_heads": (dp, None, m, None),
        "rwkv_state": (dp, m, None, None),
        # mamba
        "mamba_inner": (dp, seq, m),
        "mamba_state": (dp, m, None),
    }


# ---------------------------------------------------------------------------
# dense serving caches
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def cache_specs(cfg: ModelConfig, plan: ParallelPlan, cache):
    """The fitted spec of every leaf of a dense cache (``transformer.
    init_cache``'s per-layer tree, or any tree of the same keys whose
    leaves have a ``shape``), by leaf name as the JAX package's
    ``cache_shardings`` reads it: k/v ``kv_cache``, wkv ``rwkv_state``,
    ssm ``mamba_state``, conv (B, K-1, di) its di over the model axis,
    x_prev rows over the data axes, kpos and idx replicated."""
    specs = activation_specs(cfg, plan)

    def one(name, leaf):
        nd = len(leaf.shape)
        if name in ("k", "v"):
            spec = specs["kv_cache"]
        elif name == "wkv":
            spec = specs["rwkv_state"] if nd == 4 else (plan.dp, plan.tp)
        elif name == "ssm":
            spec = specs["mamba_state"]
        elif name == "conv":
            spec = (plan.dp, None, plan.tp)
        elif name == "x_prev":
            spec = (plan.dp, None)
        else:                       # kpos, idx
            spec = ()
        return fitted(plan, spec, leaf.shape)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return one(name, tree)

    return walk(cache)


def spec_placements(plan: ParallelPlan, spec: Tuple) -> list:
    """A fitted spec -> one DTensor placement per mesh dim: ``Shard(d)``
    where the spec puts that axis on dim d (axes sharing a dim nest in
    mesh order, as a JAX tuple entry does), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_shape(plan.mesh):
        dims = [d for d, e in enumerate(spec) if axis in _axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def cache_shardings(cfg: ModelConfig, plan: ParallelPlan, cache):
    """Placements (one per mesh dim, :func:`spec_placements`) for every
    leaf of a dense cache, from :func:`cache_specs`."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return spec_placements(plan, tree)

    return walk(cache_specs(cfg, plan, cache))


def local_shape(plan: ParallelPlan, shape, placements) -> Tuple[int, ...]:
    """This rank's shard shape of a tensor of ``shape`` placed by
    ``placements`` (fitted: every sharded dim divides)."""
    out = list(shape)
    for place, n in zip(placements, mesh_shape(plan.mesh).values()):
        if place.is_shard():
            out[place.dim] //= n
    return tuple(out)


def _shard_index(plan: ParallelPlan, axes: Tuple[str, ...]) -> int:
    """This rank's index among the shards of a dim split over ``axes``,
    row-major in mesh order."""
    idx = 0
    for a in axes:
        idx = idx * mesh_shape(plan.mesh)[a] + plan.mesh.get_local_rank(a)
    return idx


def row_axes(plan: ParallelPlan, batch: int) -> Tuple[str, ...]:
    """The data axes that split ``batch`` served rows: those that divide
    it (the cache's rows, ``kv_cache`` and ``x_prev``); none where a
    decode plan spreads the cache over data x model (rows replicated)."""
    if len(plan.decode_cache_axes) > 1 and plan.shape_mode == "decode":
        return ()
    return _axes(fitted(plan, (plan.dp,), (batch,))[0])


def serve_rows(plan: ParallelPlan, batch: int) -> Tuple[int, int]:
    """[lo, hi) of the ``batch`` rows this rank serves
    (:func:`row_axes`)."""
    axes = row_axes(plan, batch)
    n = plan.axis_size(axes)
    i = _shard_index(plan, axes)
    return i * batch // n, (i + 1) * batch // n


def wires(plan: ParallelPlan) -> bool:
    """Whether the plan's layer parameters go on the all-gather in its
    policy's ``comm_dtype``: a comm dtype, parameters sharded, and no
    pipeline (the JAX package's stage body gathers at f32)."""
    return bool(plan.policy.comm_dtype and plan.fsdp and not plan.pipe)


def _moe_model_axis(cfg: ModelConfig, plan: ParallelPlan) -> Dict:
    """{'moe_experts_split', 'moe_shared_split'}: whether the plan's
    placements put a MoE layer's expert stacks (E dim) and shared experts
    (hidden dim) on the model axis."""
    m = cfg.moe
    i = next(i for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
    d, f = cfg.d_model, m.expert_d_ff

    def split(leaf, *shape):
        return model_placement(cfg, plan, f"layers.{i}.ffn.{leaf}",
                               torch.empty(shape, device="meta")).is_shard()

    return dict(moe_experts_split=not plan.expert
                and split("w_up", m.n_experts, d, f),
                moe_shared_split=bool(m.n_shared_experts)
                and split("shared.w_up", d, m.n_shared_experts * f))


def make_runtime(cfg: ModelConfig, plan: ParallelPlan, shape: ShapeConfig,
                 **overrides):
    """Runtime with this plan's dtypes: ``param_dtype``, ``compute_dtype``
    and ``grad_dtype`` from its precision policy, and the fp8 policy's wire
    dtype where :func:`wires` (the JAX package turns its per-layer
    gatherer on under the same condition; on a ``DeviceMesh`` the wire is
    FSDP2's all-gather).  Its model axis: the size, and on a
    ``DeviceMesh`` the process group and this rank's coordinate
    (``tp_*``), and whether it shards the sequence (``context``, a
    context plan: every weight but the MoE experts whole); under head-TP
    the residual stream is sequence-parallel where ``activation_specs``
    shards ``act_btd`` along S.  A MoE model's ``moe_experts_split`` and
    ``moe_shared_split`` say whether the plan puts the expert stacks' E
    dim and the shared experts' hidden dim on the model axis
    (:func:`model_placement`; under an expert axis the stacks' E dim is
    on that axis instead).  Its pipe axis: the
    size, the microbatches and schedule, and on a ``DeviceMesh`` the
    process group and this rank's
    coordinate (a serving plan runs its stages in order,
    ``transformer.Params._through_pipe``).  A serving shape's runtime
    also gets its shard of the KV cache's slots (``cache_shard``,
    ``cache_groups``).  A train shape's runtime checkpoints each block
    (``remat``, as the JAX one); ``overrides`` win over everything."""
    from repro_torch.models.layers import Runtime
    pol = plan.policy
    mesh = not isinstance(plan.mesh, dict)
    context = plan.attn == "context"
    kw = dict(param_dtype=_DTYPES[pol.param_dtype],
              compute_dtype=_DTYPES[pol.compute_dtype],
              grad_dtype=_DTYPES[pol.grad_dtype],
              remat=shape.mode == "train",
              tp_size=plan.tp_size, context=context,
              seq_parallel=not context and activation_specs(
                  cfg, plan)["act_btd"][1] == plan.tp)
    if cfg.moe.n_experts and plan.tp_size > 1:
        kw.update(_moe_model_axis(cfg, plan))
    if wires(plan):
        kw.update(gather_dtype=_DTYPES[pol.comm_dtype], fsdp_wire=mesh)
    if plan.tp_size > 1 and mesh:
        kw.update(tp_group=plan.mesh.get_group(plan.tp),
                  tp_rank=plan.mesh.get_local_rank(plan.tp))
    if plan.pipe:
        kw.update(pipe_size=plan.pipe_size,
                  pipe_microbatches=plan.microbatches,
                  pipe_schedule=plan.pipe_sched)
        if mesh:
            kw.update(pipe_group=plan.mesh.get_group(plan.pipe),
                      pipe_rank=plan.mesh.get_local_rank(plan.pipe))
    if shape.mode != "train" and mesh:
        kw.update(_cache_coords(cfg, plan, shape))
    if cfg.moe.n_experts:
        kw.update(_moe_coords(plan, shape, mesh))
    kw.update(overrides)
    return Runtime(**kw)


def _moe_coords(plan: ParallelPlan, shape: ShapeConfig, mesh: bool):
    """A MoE model's dispatch under ``plan``: 'ep' with an expert axis,
    else 'dropping' in the reference's ``moe_groups`` = data degree groups
    over the global batch.  A rank holds the rows of its coordinate on the
    axes that split the batch (all data axes for a train step, the
    serving shape's :func:`row_axes` otherwise): its share of the groups
    is the data degree over theirs, and the router averages its load
    statistics over their groups.  The expert axis' group and size go to
    the all-to-all."""
    dp = plan.axis_size(plan.dp)
    kw = dict(moe_impl="ep" if plan.expert else "dropping", moe_groups=dp)
    if not mesh:
        return kw
    axes = plan.dp if shape.mode == "train" else row_axes(
        plan, shape.global_batch)
    axes = tuple(a for a in axes if mesh_shape(plan.mesh)[a] > 1)
    kw.update(moe_groups=dp // plan.axis_size(axes),
              moe_stat_groups=tuple(plan.mesh.get_group(a) for a in axes))
    if plan.expert:
        kw.update(expert_group=plan.mesh.get_group(plan.expert),
                  expert_size=plan.ep_size)
    return kw


def _cache_coords(cfg: ModelConfig, plan: ParallelPlan, shape: ShapeConfig):
    """A serving runtime's shard of the KV slots: the index of this rank
    among the shards of the cache's Sc (``global_batch`` rows of
    ``seq_len`` positions, fitted as ``cache_specs`` fits them) and the
    groups of the axes that split it."""
    from repro_torch.models.attention import cache_slots
    kv = (shape.global_batch, cache_slots(cfg, shape.seq_len), cfg.kv_heads,
          cfg.head_dim_)
    axes = tuple(a for a in _axes(fitted(
        plan, activation_specs(cfg, plan)["kv_cache"], kv)[1])
        if mesh_shape(plan.mesh)[a] > 1)
    return dict(cache_shard=_shard_index(plan, axes),
                cache_groups=tuple(plan.mesh.get_group(a) for a in axes))


class Fp8Wire(torch.Tensor):
    """A layer parameter's local shard whose FSDP2 all-gather moves
    ``WIRE`` (float8_e4m3fn): FSDP2's all-gather extension, on a wrapper
    of the f32 shard.  The views, chunks, padding and copies FSDP2 and the
    optimizer make of a shard keep the wrapper (``_KEEP``); every other op
    runs on the shard and gives a plain tensor.

    ``fsdp_pre_all_gather`` casts the f32 shard straight to the wire dtype,
    with no scale, padded to the rows FSDP2 gathers (a shard on dim 0; a
    MoE expert stack's, on d, splits evenly); ``fsdp_post_all_gather``
    casts the gathered bytes to the dtype FSDP2 asks for (the policy's
    ``compute_dtype``, the unit's ``MixedPrecisionPolicy.param_dtype``) —
    the values of ``models.layers.wire_round``.  NCCL gathers the wire
    dtype itself; gloo has no float8 type, so on a gloo group the same
    bytes travel as ``uint8`` (one byte an element either way)."""

    WIRE = torch.float8_e4m3fn
    _KEEP = frozenset((torch.ops.aten.detach.default,
                       torch.ops.aten.empty_like.default,
                       torch.ops.aten.new_zeros.default,
                       torch.ops.aten.slice.Tensor,
                       torch.ops.aten.copy_.default,
                       torch.ops.aten.view.default,
                       torch.ops.aten.as_strided.default,
                       torch.ops.aten.split.Tensor,
                       torch.ops.aten.clone.default,
                       torch.ops.aten._to_copy.default))

    @staticmethod
    def __new__(cls, tensor: torch.Tensor):
        return torch.Tensor._make_wrapper_subclass(
            cls, tensor.size(), strides=tensor.stride(),
            storage_offset=tensor.storage_offset(), dtype=tensor.dtype,
            layout=tensor.layout, device=tensor.device,
            requires_grad=tensor.requires_grad)

    def __init__(self, tensor: torch.Tensor):
        self._tensor = tensor

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_map_only
        if func is torch.ops.aten.detach.default:
            return cls(args[0]._tensor)
        args, kwargs = tree_map_only(cls, lambda t: t._tensor,
                                     (args, kwargs or {}))
        out = func(*args, **kwargs)
        if func not in cls._KEEP:
            return out
        return tree_map_only(torch.Tensor, cls, out)

    def __tensor_flatten__(self):
        return ["_tensor"], None

    @staticmethod
    def __tensor_unflatten__(inner, meta, outer_size, outer_stride):
        return Fp8Wire(inner["_tensor"])

    def fsdp_pre_all_gather(self, mesh, outer_size, outer_stride, module,
                            mp_policy):
        x = self._tensor.to(self.WIRE)
        rows = -(-outer_size[0] // mesh.size())
        # a shard on dim 0 is padded to the rows FSDP2 gathers; one on
        # another dim (a MoE expert stack's) splits evenly
        if tuple(x.shape[1:]) == tuple(outer_size[1:]) and \
                x.shape[0] != rows:
            pad = x.new_zeros((rows,) + tuple(x.shape[1:]))
            pad[:x.shape[0]] = x
            x = pad
        if dist.get_backend(mesh.get_group()) == "gloo":
            x = x.view(torch.uint8)
        return (x,), None

    def fsdp_post_all_gather(self, outputs, metadata, param_dtype, *,
                             out=None):
        gathered = outputs[0].view(self.WIRE)
        if out is not None:
            # the re-gather of a resharded unit: its buffer (allocated
            # again by FSDP2) takes the new values
            self._unsharded.copy_(gathered)
            return None
        self._unsharded = gathered.to(param_dtype)
        return self._unsharded, (self._unsharded,)


def all_gather_buffers(module) -> Dict[torch.dtype, int]:
    """{dtype: bytes} of the buffers FSDP2's all-gather of ``module``'s own
    unit fills (its parameters' gathered shards, padding included), after
    its first gather: what the unit moves on the wire per gather."""
    state = module._get_fsdp_state()
    # torch 2.13 keeps a list of parameter groups, 2.11 one group
    groups = getattr(state, "_fsdp_param_groups", None)
    if groups is None:
        groups = [state._fsdp_param_group]
    out: Dict[torch.dtype, int] = {}
    for group in groups:
        for fp in group.fsdp_params:
            for t in fp.all_gather_outputs:
                out[t.dtype] = out.get(t.dtype, 0) + t.numel() * \
                    t.element_size()
    return out


def _flat(mesh, axes: Tuple[str, ...]) -> str:
    """The name of ``mesh``'s dims ``axes`` as one (flattened, registered
    on the root mesh) dim; an axis alone keeps its name."""
    if len(axes) == 1:
        return axes[0]
    return mesh[axes]._flatten().mesh_dim_names[0]


def _meshes(plan: ParallelPlan):
    """(root mesh, the submesh of it FSDP2 runs over, the submesh a MoE
    FFN's unit runs over under an expert axis, else None).  The root is
    the plan's mesh (under a pipeline, the submesh of this rank's pipe
    coordinate: every axis but ``pipe``) when the plan shards over
    ``data`` (FSDP2 1-D over it, or 2-D (replicate ``pod``, shard
    ``data``)); under ZeRO-0 it is a mesh of its own, ([pipe,] dp, zero,
    model) with a size-1 ``zero`` axis (dp split into data and expert
    under an expert axis), sliced the same way, and FSDP2 replicates over
    ``dp`` and shards over ``zero``.  Ranks lie in the same order on both
    (row-major, model innermost).  An expert axis shards the batch
    together with ``data``: FSDP2 runs over the two as one flattened dim,
    and a MoE FFN's unit over the data axes without it (its expert stacks
    are already split over it)."""
    if plan.fsdp:
        replicate = tuple(a for a in plan.dp if a not in plan.fsdp)
        if len(replicate) > 1 or len(plan.fsdp) - bool(plan.expert) != 1:
            raise ValueError(f"FSDP2 shards over one mesh axis (with the "
                             f"expert axis) and replicates over at most "
                             f"one; plan shards over {plan.fsdp} of "
                             f"{plan.dp}")
        mesh = plan.mesh
        if plan.pipe:
            mesh = mesh[tuple(a for a in mesh.mesh_dim_names
                              if a != plan.pipe)]
        no_expert = mesh[replicate + plan.fsdp_no_expert] \
            if plan.expert else None
        if not replicate and len(plan.fsdp) > 1:
            # the flattened mesh itself (slicing a flattened dim from the
            # root is deprecated; with a replicate axis there is no other
            # way to the 2-D mesh)
            return mesh, mesh[plan.fsdp]._flatten(), no_expert
        return mesh, mesh[replicate + (_flat(mesh, plan.fsdp),)], no_expert
    from torch.distributed.device_mesh import init_device_mesh
    pipe = (plan.pipe_size,) if plan.pipe else ()
    dp = ((plan.axis_size(plan.dp) // plan.ep_size, plan.ep_size)
          if plan.expert else (plan.axis_size(plan.dp),))
    dp_names = ("data", plan.expert) if plan.expert else ("dp",)
    root = init_device_mesh(
        plan.mesh.device_type, pipe + dp + (1, plan.tp_size),
        mesh_dim_names=(("pipe",) if plan.pipe else ())
        + dp_names + ("zero", plan.tp))
    if plan.pipe:
        root = root[dp_names + ("zero", plan.tp)]
    return (root, root[(_flat(root, dp_names), "zero")],
            root[("data", "zero")] if plan.expert else None)


def apply_plan(params, plan: ParallelPlan, cfg: ModelConfig):
    """Shard ``params`` (a ``Params`` module of ``cfg`` on this rank's
    device) in place under ``plan`` -> the same module, now an FSDP2
    module whose parameters are ``DTensor``s on the root mesh: over the
    model axis with ``param_placements``' placements, over the data axes
    FSDP2's.  Every rank must hold the same weights first (a seeded
    ``init_params``): each keeps its model-axis shard of them.  The
    embedding, the LM head and the final norm stay in the root unit: tied
    embeddings use one table at both ends.  Where :func:`wires`, each
    stacked layer's floating parameters (``transformer.wired_layers``)
    are :class:`Fp8Wire` shards, gathered into ``compute_dtype``.  Under
    a ``pipe`` axis a rank keeps only its stages' layers
    (``core.pipeline.keep_stage_layers``) and shards them over the (data,
    model) submesh of its pipe coordinate.  FSDP2 shards each parameter
    on dim 0 over the data axes, a MoE expert stack on the dim
    :func:`data_shard_dim` gives."""
    from torch import nn
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import DTensor, Shard
    pol = plan.policy
    if plan.pipe:
        from repro_torch.core.pipeline import keep_stage_layers
        keep_stage_layers(params, cfg, plan)
    root, dp_mesh, expert_dp_mesh = _meshes(plan)
    tp_mesh = root[plan.tp]
    ep_mesh = None
    if plan.expert:
        ep_mesh = root[(plan.expert, plan.tp)] if plan.tp_size > 1 \
            else root[plan.expert]
    from repro_torch.models.transformer import wired_layers
    wired = wired_layers(cfg) if wires(plan) else ()
    data_dims = {}
    for name, place in param_placements(cfg, plan, params).items():
        owner, leaf = name.rsplit(".", 1)
        sub = params.get_submodule(owner)
        full = sub[leaf].detach()
        mesh, places = tp_mesh, [place]
        if on_expert_axis(name, cfg, plan):
            mesh, places = ep_mesh, expert_placements(cfg, plan, name, full)
        local = full
        for d, pl in enumerate(places):
            if pl.is_shard():
                local = local.chunk(mesh.size(d), pl.dim)[
                    mesh.get_local_rank(d)]
        local = local.contiguous()
        if (name.startswith("layers.") and local.is_floating_point()
                and int(name.split(".")[1]) in wired):
            local = Fp8Wire(local)
        sub[leaf] = nn.Parameter(DTensor.from_local(
            local, mesh, places, run_check=False))
        dim = data_shard_dim(cfg, plan, name, full)
        if dim is not None:
            data_dims[id(sub[leaf])] = Shard(dim)

    def placement(p):
        return data_dims.get(id(p))
    # inputs keep their dtype: the model casts where the JAX package casts
    mp = MixedPrecisionPolicy(param_dtype=_DTYPES[pol.param_dtype],
                              reduce_dtype=_DTYPES[pol.grad_dtype],
                              cast_forward_inputs=False)
    # the wired layers gather into compute_dtype; their gradients are cast
    # to grad_dtype before the reduce-scatter
    wire_mp = MixedPrecisionPolicy(param_dtype=_DTYPES[pol.compute_dtype],
                                   reduce_dtype=_DTYPES[pol.grad_dtype],
                                   cast_forward_inputs=False)
    reshard = bool(plan.fsdp) and plan.zero >= 3
    # a pipe rank's layers of other stages are empty placeholders
    layers = {i: layer for i, layer in enumerate(params.layers)
              if len(layer._modules)}
    for i, layer in layers.items():
        layer_mp = wire_mp if i in wired else mp
        if plan.expert and cfg.is_moe_layer(i):
            # the MoE FFN's own unit over the data axes without the expert
            # axis; its gradients are summed over dp / ep ranks there and
            # (router, shared experts) over the expert group by the train
            # step, so they divide by the whole data degree
            ffn = layer["ffn"]
            fully_shard(ffn, mesh=expert_dp_mesh,
                        reshard_after_forward=reshard,
                        shard_placement_fn=placement, mp_policy=layer_mp)
            _set_divide_factor(ffn, plan.axis_size(plan.dp),
                               expert_dp_mesh.shape[-1])
        fully_shard(layer, mesh=dp_mesh, reshard_after_forward=reshard,
                    shard_placement_fn=placement, mp_policy=layer_mp)
    fully_shard(params, mesh=dp_mesh, reshard_after_forward=reshard,
                mp_policy=mp)
    if plan.zero_overlap:
        # (a MoE FFN's unit gathers in its own pre-forward hook)
        for i, cur in layers.items():
            if i + 1 in layers:
                cur.set_modules_to_forward_prefetch([layers[i + 1]])
                layers[i + 1].set_modules_to_backward_prefetch([cur])
    return params


def _set_divide_factor(unit, factor: int, ranks: int) -> None:
    """FSDP2's divisor of ``unit``'s reduced gradients, where it shards
    over ``ranks`` (the last dim of its mesh; torch 2.13 names the setter
    ``set_gradient_divide_factor``, torch 2.11 may have only
    ``set_reduce_scatter_divide_factor``).  Over more than one rank the
    reduce-scatter (and an HSDP all-reduce after it) sums and divides
    after it: a divisor other than the group's size would take NCCL's
    pre-multiplied sum, which gloo lacks.  Over one rank FSDP2 divides
    the copy it makes in place of the reduce-scatter, and an HSDP
    all-reduce then sums: forcing the sum there would divide twice."""
    setter = getattr(unit, "set_gradient_divide_factor", None) or \
        unit.set_reduce_scatter_divide_factor
    setter(float(factor))
    force_sum = getattr(unit, "set_force_sum_reduction_for_comms", None)
    if force_sum is not None and ranks > 1:
        force_sum(True)
