"""Shared building blocks: norms, rotary embeddings, the gated MLP,
embeddings — the port of the JAX package's ``models/layers.py``.

Functions take parameter dicts (or ``nn.ParameterDict``s) of tensors, in
the JAX package's layouts: projection weights are (in, out) and applied as
``x @ W``.  Initialisers draw from an explicit ``torch.Generator`` on an
explicit device, with the JAX package's distributions.

Tensor parallelism (a ``Runtime`` whose model axis has ``tp_size`` > 1)
computes on each rank's local shards of the parameters, between
Megatron's conjugate collectives over the model group: a sublayer enters
through :func:`tp_enter` (all-gather along S under sequence parallelism,
else identity with an all-reduce backward) and leaves through
:func:`tp_exit` (reduce-scatter along S, else all-reduce).  Each
collective call adds one to ``COLLECTIVES`` (forward and backward alike),
as a kernel wrapper counts its launches.  On a model axis of size 1 no
collective runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Numerics and implementation choice (orthogonal to ModelConfig).

    ``"kernel"`` routes RMSNorm, training attention, paged decode
    attention and the cache-less WKV-6 through the hand-written kernels
    (their plain versions on CPU tensors); ``"torch"`` keeps the plain
    PyTorch layer code
    everywhere.  The chunk sizes shape the plain cache-less attention:
    sequences up to ``attn_min_chunked_len`` attend densely, longer ones
    in (q, kv) chunks with an online softmax.  ``rwkv_chunk`` is the
    chunk length of the WKV-6 recurrence, on the kernel and the plain path
    alike (it is part of the result: it sets the order of rounding).
    ``mamba_chunk`` is the chunk length of the selective scan, each chunk
    recomputed in the backward (the JAX package's default, 256).

    The dtypes are a precision policy's (``core.parallel.make_runtime``):
    parameters are stored in ``param_dtype`` (the master copy, f32 in
    every policy), activations and products run in ``compute_dtype``,
    gradients accumulate in ``grad_dtype``.  ``gather_dtype``, when set
    (the fp8 policy on a plan that shards parameters), is the wire dtype
    of each stacked layer's gathered parameters (``transformer.
    wired_layers``; a prefix layer gathers at f32): every floating leaf
    reaches the layer rounded through it to ``compute_dtype``.  With ``fsdp_wire``
    FSDP2's all-gather does the rounding (``core.parallel.Fp8Wire``);
    without it (one device, no gather) the layer rounds its leaves itself
    (:func:`wire_round`).  Either way each gradient of a layer parameter is
    rounded back through it once it is reduced (:func:`wire_round_grad`).

    The model axis (``core.parallel.make_runtime``): ``tp_size`` ranks in
    ``tp_group``, this one at ``tp_rank``.  Under head-TP it splits the
    heads and weights (:func:`head_parallel`); with ``seq_parallel`` the
    residual stream between sublayers holds this rank's 1/tp of the
    sequence (Megatron-SP) wherever S splits evenly
    (:func:`sequence_parallel`).  Under a context plan (``context``) it
    shards the sequence instead: every weight but the MoE experts is
    whole on each rank, a forward over S positions holds this rank's
    contiguous S / tp of them wherever S splits evenly
    (:func:`context_parallel`), and attention gathers K and V over the
    group.  ``moe_experts_split``: the plan puts the expert stacks' E dim
    on the model axis (each rank holds E / tp experts);
    ``moe_shared_split``: it puts the shared experts' hidden dim there.
    The pipe axis: ``pipe_size`` stages in ``pipe_group``, this rank at
    ``pipe_rank``, running ``pipe_microbatches`` microbatches under ``pipe_schedule``
    (``core.pipeline``); with ``pipe_via_host`` what crosses the pipe
    group goes through host memory (a gloo pipe group between ranks on
    cards).  A serving plan that shards the dense KV cache along its slots
    gives this rank's shard index (``cache_shard``, row-major over the
    cache axes) and the process groups of those axes (``cache_groups``),
    over which a decode step merges its attention.

    ``remat`` and ``remat_inner`` are the JAX package's block remat
    (``transformer.Params.forward``): a cache-less forward checkpoints
    each block of ``transformer.layer_plan``'s period (not the prefix
    layers), and with ``remat_inner`` each layer of a block too; a
    pipeline stage checkpoints each of its layers under ``remat``.  Their
    backward reruns what they checkpointed (:func:`recomputing`).
    """
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    grad_dtype: torch.dtype = torch.float32
    gather_dtype: Optional[torch.dtype] = None
    remat: bool = False                 # checkpoint each layer-block
    remat_inner: bool = False           # also each layer inside a block
    attn_impl: str = "kernel"           # 'kernel' | 'torch'
    norm_impl: str = "kernel"           # 'kernel' | 'torch'
    attn_q_chunk: int = 1024            # query chunk for blocked attention
    attn_kv_chunk: int = 1024           # kv chunk for blocked attention
    attn_min_chunked_len: int = 2048    # below this, plain masked attention
    rwkv_chunk: int = 64                # WKV-6 chunk length
    mamba_chunk: int = 256              # selective-scan chunk length
    tp_size: int = 1                    # ranks on the model axis
    tp_rank: int = 0                    # this rank's model coordinate
    tp_group: Any = None                # the model axis' process group
    seq_parallel: bool = False          # Megatron-SP residual stream
    context: bool = False               # the model axis shards the sequence
    moe_experts_split: bool = False     # the E dim on the model axis
    moe_shared_split: bool = False      # shared experts' hidden dim on it
    fsdp_wire: bool = False             # gather_dtype is FSDP2's wire
    pipe_size: int = 1                  # pipeline stages (core.pipeline)
    pipe_rank: int = 0                  # this rank's pipe coordinate
    pipe_group: Any = None              # the pipe axis' process group
    pipe_microbatches: int = 1          # pipeline microbatches
    pipe_schedule: str = "gpipe"        # 'gpipe' | '1f1b' | '1f1b_i<v>'
                                        # | 'zb'
    pipe_via_host: bool = False         # stage p2p through host memory
    cache_shard: int = 0                # this rank's shard of the KV slots
    cache_groups: Tuple[Any, ...] = ()  # groups of the axes sharding them
    moe_impl: str = "auto"              # 'auto' | 'dense' | 'dropping' | 'ep'
    moe_groups: int = 1                 # dispatch groups of this rank's tokens
    moe_stat_groups: Tuple[Any, ...] = ()  # groups sharding the tokens
    expert_group: Any = None            # the expert axis' process group
    expert_size: int = 1                # ranks on the expert axis


class CacheLeaf(NamedTuple):
    """A dense serving cache leaf's shape and type, unallocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


class _WireRound(torch.autograd.Function):
    """y = x -> wire dtype -> out dtype; the cotangent passes straight
    through in x's dtype.  (The JAX package's transposes of the two casts
    round the cotangent back through the same dtypes; that rounding is
    elementwise, so it is applied to the gradient once it is summed over
    the batch and the data-parallel ranks: :func:`wire_round_grad`.)"""

    @staticmethod
    def forward(ctx, x, wire, out):
        ctx.dtype = x.dtype
        return x.to(wire).to(out)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


def wire_round(tree, wire: torch.dtype, out: torch.dtype):
    """A (nested) dict of parameters -> the same dict with each floating
    leaf rounded through ``wire`` to ``out``: the values a layer computes
    from after an all-gather in ``wire`` (the JAX package's
    ``make_param_gatherer`` with a ``comm_dtype``)."""
    return {k: wire_round(v, wire, out) if isinstance(v, (dict, nn.Module))
            else (_WireRound.apply(v, wire, out) if v.is_floating_point()
                  else v)
            for k, v in tree.items()}


def wire_round_grad(g: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The gradient of a parameter that went through :func:`wire_round`,
    summed over a microbatch, as the JAX package's transposes leave it:
    rounded through ``compute_dtype`` and ``gather_dtype`` back to its own
    dtype."""
    return g.to(rt.compute_dtype).to(rt.gather_dtype).to(g.dtype)


# ---------------------------------------------------------------------------
# tensor parallelism: local shards and Megatron's conjugate collectives
# ---------------------------------------------------------------------------

COLLECTIVES: Dict[str, int] = {"all_gather": 0, "reduce_scatter": 0,
                               "all_reduce": 0, "all_to_all": 0}
# some of the same calls at the sites the dry run's record names: a
# context rank's K/V all-gathers, a recurrent layer's gathers of the
# sequence under a context plan (its mixer's input, and an RWKV-6 channel
# mix's) and a MoE FFN's combine over the model axis (its exit
# collective), forward
COLLECTIVE_SITES: Dict[str, int] = {"context_kv_gather": 0,
                                    "context_seq_gather": 0,
                                    "moe_combine": 0}


# how many checkpointed regions are being rerun (:func:`recompute_context`)
_RECOMPUTES = [0]


@contextlib.contextmanager
def recompute_context():
    """The context a checkpointed region's rerun runs in
    (``transformer._run_block`` passes it to ``torch.utils.checkpoint`` as
    the recompute half of its ``context_fn``)."""
    _RECOMPUTES[0] += 1
    try:
        yield
    finally:
        _RECOMPUTES[0] -= 1


def recomputing() -> bool:
    """Whether this forward is a checkpointed region's rerun in a backward
    (``Runtime.remat``).  Its kernels and collectives are work done and
    counted as such; what it adds to a step's results (a MoE layer's aux
    loss) it adds once, in the first forward."""
    return _RECOMPUTES[0] > 0


def reset_collective_counts() -> None:
    for counts in (COLLECTIVES, COLLECTIVE_SITES):
        for k in counts:
            counts[k] = 0


def local_params(tree) -> Dict[str, Any]:
    """A (nested) ``ParameterDict`` or dict -> a dict of the same keys
    holding each parameter's local shard (a differentiable ``to_local``
    view of a ``DTensor``, else the tensor): the tensors a layer computes
    from, on a model axis of any size."""
    return {k: local_params(v) if isinstance(v, (dict, nn.Module))
            else (v.to_local() if isinstance(v, DTensor) else v)
            for k, v in tree.items()}


def sequence_parallel(rt: "Runtime", S: int) -> bool:
    """Whether a forward over S positions keeps its residual stream
    sharded along S over the model axis: under a sequence-parallel plan,
    where S splits evenly (the JAX package's fitted ``act_btd``)."""
    return rt.tp_size > 1 and rt.seq_parallel and S % rt.tp_size == 0


def context_parallel(rt: "Runtime", S: int) -> bool:
    """Whether a forward over S positions runs this rank's contiguous
    S / tp of them under a context plan (S > 1 splitting evenly: a decode
    step's one position runs whole on every rank)."""
    return rt.context and rt.tp_size > 1 and S > 1 and S % rt.tp_size == 0


def head_parallel(rt: "Runtime") -> bool:
    """Whether the model axis splits the heads and the weights (head-TP):
    more than one rank, and not a context plan's."""
    return rt.tp_size > 1 and not rt.context


def all_reduce(x: torch.Tensor, rt: "Runtime", op=dist.ReduceOp.SUM,
               group=None):
    """Counted in-place all-reduce of ``x`` over the model group (or
    ``group``)."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(x, op=op, group=rt.tp_group if group is None else group)
    return x


def gather_heads(x, rt: "Runtime"):
    """(B, S, h, D) of this rank's heads -> (B, S, h * tp, D) of every
    model rank's, in rank order (rank r holds heads [r h, (r + 1) h))."""
    COLLECTIVES["all_gather"] += 1
    xs = x.movedim(2, 0).contiguous()
    out = xs.new_empty((xs.shape[0] * rt.tp_size,) + xs.shape[1:])
    dist.all_gather_into_tensor(out, xs, group=rt.tp_group)
    return out.movedim(0, 2)


def _gather_seq(x, rt):
    """(B, S/tp, ...) shards -> (B, S, ...), rank order along S."""
    COLLECTIVES["all_gather"] += 1
    xs = x.movedim(1, 0).contiguous()
    out = xs.new_empty((xs.shape[0] * rt.tp_size,) + xs.shape[1:])
    dist.all_gather_into_tensor(out, xs, group=rt.tp_group)
    return out.movedim(0, 1)


def _scatter_seq(x, rt):
    """(B, S, ...) partial sums -> this rank's (B, S/tp, ...) of their
    sum over the model group."""
    COLLECTIVES["reduce_scatter"] += 1
    xs = x.movedim(1, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // rt.tp_size,) + xs.shape[1:])
    dist.reduce_scatter_tensor(out, xs, group=rt.tp_group)
    return out.movedim(0, 1)


class _Copy(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, rt):
        ctx.rt = rt
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.rt), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, rt):
        return all_reduce(x.contiguous(), rt)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """Megatron-SP's entry: all-gather along S forward, reduce-scatter
    backward."""

    @staticmethod
    def forward(ctx, x, rt):
        ctx.rt = rt
        return _gather_seq(x, rt)

    @staticmethod
    def backward(ctx, g):
        return _scatter_seq(g, ctx.rt), None


class _ScatterSeq(torch.autograd.Function):
    """Megatron-SP's exit: reduce-scatter along S forward, all-gather
    backward."""

    @staticmethod
    def forward(ctx, x, rt):
        ctx.rt = rt
        return _scatter_seq(x, rt)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.rt), None


def cp_gather(x, rt: "Runtime", site: Optional[str] = "context_kv_gather"):
    """(B, S / cp, ...) of this context rank -> (B, S, ...) of every
    rank's, in rank order; the backward sums the cotangents over the
    group and keeps this rank's rows (the JAX ``_cp_attend``'s tiled
    all-gather and its transpose).  Counted at ``site`` of
    ``COLLECTIVE_SITES`` (K or V of an attention layer by default), or
    nowhere (None)."""
    if site is not None:
        COLLECTIVE_SITES[site] += 1
    return _GatherSeq.apply(x, rt)


class _SumOverModel(torch.autograd.Function):
    """All-reduce over the group forward, identity backward (Megatron's
    g), for a context plan's loss terms: every rank holds the sum, and
    each rank's gradient is that of its own part."""

    @staticmethod
    def forward(ctx, x, group):
        COLLECTIVES["all_reduce"] += 1
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverGroups(torch.autograd.Function):
    """All-reduce (sum) over each group in turn; the backward all-reduces
    the cotangent the same way (the adjoint of a sum every rank holds)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        x = x.clone()
        for g in groups:
            COLLECTIVES["all_reduce"] += 1
            dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for grp in ctx.groups:
            COLLECTIVES["all_reduce"] += 1
            dist.all_reduce(g, group=grp)
        return g, None


def sum_over_groups(x, groups):
    """``x`` summed over each process group of ``groups`` in turn, with
    the same sums in the backward: every rank holds the sum and uses it
    in a part of its own, so each rank's cotangent is a part too."""
    return _SumOverGroups.apply(x, tuple(groups))


def cp_sum(x, rt: "Runtime"):
    """``x`` summed over the context group, with an identity backward."""
    return _SumOverModel.apply(x, rt.tp_group)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x, scale: float):
    return _ScaleGrad.apply(x, scale)


def model_enter(x, rt: "Runtime", seq: bool):
    """A sublayer's input on every model rank: the whole sequence,
    gathered from the S-shards where x holds this rank's (``seq``)."""
    if rt.tp_size == 1:
        return x
    return _GatherSeq.apply(x, rt) if seq else _Copy.apply(x, rt)


def model_exit(y, rt: "Runtime", seq: bool):
    """A sublayer's partial outputs summed over the model ranks: this
    rank's S-shard of the sum where the stream is sharded (``seq``)."""
    if rt.tp_size == 1:
        return y
    return _ScatterSeq.apply(y, rt) if seq else _Reduce.apply(y, rt)


def tp_enter(x, rt: "Runtime", sp: bool):
    """:func:`model_enter` of a sublayer whose weights the model axis
    splits (head-TP; ``sp``: Megatron-SP); under a context plan every
    such weight is whole, and x passes as it is."""
    return x if rt.context else model_enter(x, rt, sp)


def tp_exit(y, rt: "Runtime", sp: bool):
    """:func:`model_exit` of a sublayer whose weights the model axis
    splits; under a context plan y is whole, and passes as it is."""
    return y if rt.context else model_exit(y, rt, sp)


def _randn(gen, shape, scale, device):
    return torch.randn(shape, generator=gen, device=device) * scale


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg, device, d=None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.ones(d, device=device)}


def apply_norm(p, x, eps, rt: Runtime = None):
    if rt is not None and rt.norm_impl == "kernel" and "bias" not in p:
        # RMSNorm kernel; layernorm stays on the plain path.  Any width d
        # works: the kernel masks the ragged edge itself.
        return kernel_ops.rmsnorm(x, p["scale"], eps=eps)
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:            # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_norm_headwise(scale, x, eps):
    """Per-head q/k RMSNorm (Qwen3). x: (..., head_dim); f32 inside, cast
    back at the end."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (half-split llama layout)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions, head_dim, theta):
    """positions: (..., S) int -> angles (..., S, head_dim//2) f32."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions.float()[..., None] * inv


def mrope_angles(position_ids, head_dim, theta, sections):
    """Qwen2-VL's M-RoPE: position_ids (3, B, S) of the (t, h, w) streams
    -> angles (B, S, head_dim//2) f32, the frequency slots split into
    three contiguous ``sections``, each slot rotated by the position of
    the stream its section names."""
    d2 = head_dim // 2
    if sum(sections) != d2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {d2}")
    dev = position_ids.device
    stream = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=dev)      # (d2,)
    pos = position_ids.float().index_select(0, stream)          # (d2, B, S)
    return pos.permute(1, 2, 0) * rope_freqs(head_dim, theta, dev)


def apply_rope(x, angles):
    """x: (B, S, H, D); angles: (B, S, D//2).  Rotates (x[i], x[i + D/2])
    pairs laid out as two halves; cos/sin are cast to x's type first."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def init_embed(cfg, gen, device):
    p = {"tok": _randn(gen, (cfg.vocab_size, cfg.d_model), 0.02, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _randn(gen, (cfg.d_model, cfg.vocab_size),
                              cfg.d_model ** -0.5, device)
    return p


def embed_tokens(p, tokens, rt: Runtime, sp: bool = False):
    """tokens (B, S) -> (B, S, d) in ``compute_dtype``; ``p`` holds local
    shards.  Vocab-parallel on a model axis: each rank looks up the
    tokens of its rows of the table (zero elsewhere), and the sum over
    the ranks is all-reduced, or reduce-scattered to this rank's S-shard
    under sequence parallelism (``sp``)."""
    tok = p["tok"]
    if not head_parallel(rt):
        # gather, then cast: the same values as casting the table first
        return F.embedding(tokens, tok).to(rt.compute_dtype)
    rows = tok.shape[0]
    ids = tokens - rt.tp_rank * rows
    mine = (ids >= 0) & (ids < rows)
    e = F.embedding(torch.where(mine, ids, 0), tok)
    e = (e * mine[..., None].to(e.dtype)).to(rt.compute_dtype)
    return tp_exit(e, rt, sp)


def lm_logits(p, h, rt: Runtime, sp: bool = False):
    """h (B, S, d), or its S-shard under sequence parallelism (``sp``)
    -> logits (B, S, V / tp): this rank's columns of the vocabulary (the
    tied table's rows stay sharded)."""
    if "lm_head" in p:
        w = p["lm_head"].to(rt.compute_dtype)
    else:
        w = p["tok"].to(rt.compute_dtype).t()
    h = tp_enter(h, rt, sp)
    # mixed types promote, as jnp.einsum does (an RWKV-6 stack's residual
    # stream leaves its layers in f32)
    ct = torch.promote_types(h.dtype, w.dtype)
    return h.to(ct) @ w.to(ct)


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU / GELU / relu^2)
# ---------------------------------------------------------------------------

def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu
            "relu2": lambda x: torch.square(F.relu(x))}[name]


def init_mlp(cfg, gen, device, d_ff=None):
    d, dff = cfg.d_model, d_ff or (cfg.dense_d_ff or cfg.d_ff)
    p = {"w_up": _randn(gen, (d, dff), d ** -0.5, device),
         "w_down": _randn(gen, (dff, d), dff ** -0.5, device)}
    if cfg.glu:
        p["w_gate"] = _randn(gen, (d, dff), d ** -0.5, device)
    return p


def apply_mlp(cfg, p, x, rt: Runtime, sp: bool = False):
    """Column-parallel ``w_up``/``w_gate`` and row-parallel ``w_down`` on
    a model axis: x and the result are the residual stream's (its S-shard
    under sequence parallelism, ``sp``)."""
    act = _act(cfg.act)
    x = tp_enter(x, rt, sp)
    up = x @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        h = act(x @ p["w_gate"].to(x.dtype)) * up
    else:
        h = act(up)
    return tp_exit(h @ p["w_down"].to(x.dtype), rt, sp)
