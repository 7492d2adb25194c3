"""Decoder-only model, cache-less (training), over dense caches (static
serving: a KV cache per attention layer, the recurrent state per RWKV-6
or Mamba layer) or over a paged KV cache (continuous batching of
attention-only stacks): the JAX package's ``models/transformer.py``, on
its three input modes (tokens; frame ``embeds`` in place of tokens;
tokens with ``vision_embeds`` over the first positions and M-RoPE over
3-D ``position_ids``).

A model is a stack of layers; each layer = (norm -> mixer -> residual,
norm -> FFN -> residual): attention or Mamba (``models.mamba``; a hybrid
interleaves them, as jamba-v0.1-52b does) and an MLP or a mixture of
experts (``models.moe``, whose load-balance losses the forward collects
in an :class:`AuxLoss`), or RWKV-6 time mix and channel mix.  Under a
context plan a recurrent layer (RWKV-6, Mamba) scans the whole sequence:
its mixer, whose weights the model axis splits in every plan, gathers
the sequence at its entry and reduce-scatters its output at its exit, and
an RWKV-6 channel mix, whose token shift crosses the shard boundary, runs
on the gathered sequence and keeps its rows.  Parameters live
in an :class:`Params` module whose ``layers`` is an ``nn.ModuleList`` of
:class:`Layer` modules, one per layer; a Python loop calls them in
turn, in place of the JAX package's ``lax.scan`` over stacked blocks
(``layer_plan`` is kept: the bridge uses it to map the JAX stack onto
layers).  Every layer and the whole model
are called as modules, so FSDP2's hooks on them fire on the training and
the serving path alike.  Caches are per-layer lists (``{'layers':
[...]}``), updated in place by the forward; ``bridge.cache_from_jax`` and
``cache_to_jax`` convert the JAX package's stacked caches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.layers import (COLLECTIVE_SITES, CacheLeaf,
                                       Runtime, all_reduce,
                                       apply_mlp, apply_norm,
                                       context_parallel, cp_gather, cp_sum,
                                       embed_tokens, head_parallel,
                                       init_embed, init_mlp,
                                       init_norm, lm_logits, local_params,
                                       mrope_angles, recompute_context,
                                       recomputing, rope_angles,
                                       sequence_parallel, tp_exit,
                                       wire_round)


# ---------------------------------------------------------------------------
# layer planning
# ---------------------------------------------------------------------------

def _sig(cfg: ModelConfig, i: int):
    return (cfg.layer_kind(i), cfg.is_moe_layer(i))


def layer_plan(cfg: ModelConfig):
    """-> (prefix_layer_ids, start, period, n_blocks) of the JAX package's
    scanned layout: layers [start:] repeat a signature of length period."""
    L = cfg.n_layers
    sigs = [_sig(cfg, i) for i in range(L)]
    for total in range(1, L + 1):
        for start in range(total):
            period = total - start
            if (L - start) % period:
                continue
            if all(sigs[start + j] == sigs[start + (j % period)]
                   for j in range(L - start)):
                return list(range(start)), start, period, (L - start) // period
    return list(range(L)), L, 1, 0


def wired_layers(cfg: ModelConfig) -> range:
    """The layers whose parameters a wire dtype (``Runtime.gather_dtype``,
    the fp8 policy) rounds: the JAX package's per-layer gatherer runs only
    in its scan over the stacked blocks of :func:`layer_plan`, so the
    prefix layers (deepseek-moe-16b's dense first layer) gather at f32."""
    return range(layer_plan(cfg)[1], cfg.n_layers)


# mixers that scan the sequence, carrying a state
RECURRENT = ("rwkv6", "mamba")


def _all_attention(cfg: ModelConfig) -> bool:
    """Every layer mixes by attention (its FFN dense or MoE)."""
    return all(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


INPUT_MODES = ("tokens", "embeddings", "tokens+vision")


def check_supported(cfg: ModelConfig) -> None:
    """The port's model covers stacks that are attention-only (each FFN
    dense or MoE) with RoPE or M-RoPE, with sinusoidal positions added to
    the embedding (and no RoPE), or with no positions; uniform RWKV-6
    with layernorm and no positions; or Mamba layers among attention
    layers (each FFN dense or MoE) with no positions, on tokens; on any
    of the JAX package's input modes (``INPUT_MODES``)."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    rwkv = (all(_sig(cfg, i) == ("rwkv6", False)
                for i in range(cfg.n_layers))
            and cfg.rope == "none" and cfg.norm == "layernorm"
            and cfg.pos_embed == "none")
    attn = _all_attention(cfg) and (
        (cfg.rope in ("rope", "mrope", "none") and cfg.pos_embed == "none")
        or (cfg.rope == "none" and cfg.pos_embed == "sinusoidal"))
    mamba = ("mamba" in kinds and kinds <= {"mamba", "attn"}
             and cfg.rope == "none" and cfg.pos_embed == "none"
             and cfg.input_mode == "tokens")
    if not (rwkv or attn or mamba) or cfg.input_mode not in INPUT_MODES:
        raise NotImplementedError(
            f"{cfg.name}: the port runs stacks that are attention-only "
            "(dense or MoE FFNs) with RoPE, M-RoPE or sinusoidal "
            "positions, uniform RWKV-6, or Mamba among attention layers "
            "with no positions on tokens")


def sinusoidal_from_positions(positions, d_model: int, dtype):
    """positions (B, S) -> (B, S, d_model): sin of ``d_model // 2``
    frequencies, then their cos (concatenated, not interleaved), in f32
    and cast to ``dtype`` (the JAX package's ``_sinusoidal_from_positions``,
    the table its forward adds to the embedding)."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _lead(batch) -> torch.Tensor:
    """The leaf that gives a model batch its (B, S): the frame ``embeds``
    (B, S, d) where it has them (they stand in for the tokens, as in the
    JAX forward), else the ``tokens`` (B, S), else the ``labels``."""
    for k in ("embeds", "tokens", "labels"):
        if k in batch:
            return batch[k]
    raise KeyError("a model batch holds 'embeds', 'tokens' or 'labels'")


def batch_dims(batch) -> Tuple[int, int]:
    """(B, S) of a model batch (:func:`_lead`)."""
    return tuple(_lead(batch).shape[:2])


def batch_rows(batch, lo: int, hi: int):
    """Rows [lo, hi) of every leaf of a model batch, each along its own
    batch dim: dim 1 of the M-RoPE ``position_ids`` (3, B, S), dim 0 of
    every other leaf; a scalar (a decode step's ``pos``) stays whole.
    (The JAX trainer's gradient accumulation slices ``position_ids``
    along dim 0; its batch shardings put the rows on dim 1, as here.)"""
    return {k: v if not torch.is_tensor(v) or v.dim() == 0
            else v[:, lo:hi] if k == "position_ids" else v[lo:hi]
            for k, v in batch.items()}


def _merge_vision(h, vision, off: int, S: int):
    """Vision patches over the first min(V, S) positions of the stream,
    as the JAX package's fixed layout: ``h`` holds the stream's rows from
    ``off`` (a sequence or context shard's), and its rows below min(V, S)
    take the patches of the same index, cast to its type."""
    hi = min(off + h.shape[1], vision.shape[1], S)
    if hi <= off:
        return h
    return torch.cat([vision[:, off:hi].to(h.dtype), h[:, hi - off:]],
                     dim=1)


def _embed(cfg: ModelConfig, embed, batch, positions, rt: Runtime,
           sp: bool, cp: bool):
    """The residual stream's start (the JAX package's ``_embed_inputs``):
    the frame ``embeds`` cast to the compute dtype, or the token
    embedding with, for a ``tokens+vision`` model, the ``vision_embeds``
    over its first positions; plus the sinusoidal table at the positions
    for a model with ``pos_embed == 'sinusoidal'``.  Under sequence
    parallelism (``sp``) or a context plan (``cp``) it is this rank's
    S-shard: the frame embeds and the table are sliced to it, and the
    patches overwrite only its rows below V.  ``positions`` are the
    whole sequence's (the context shard's under ``cp``)."""
    S = batch_dims(batch)[1]
    n = S // rt.tp_size if sp or cp else S
    off = rt.tp_rank * n if sp or cp else 0
    if "embeds" in batch:
        h = batch["embeds"][:, off:off + n].to(rt.compute_dtype)
    else:
        tokens = batch["tokens"]
        h = embed_tokens(embed, _cp_shard(tokens, rt) if cp else tokens, rt,
                         sp)
        if cfg.input_mode == "tokens+vision" and "vision_embeds" in batch:
            h = _merge_vision(h, batch["vision_embeds"], off, S)
    if cfg.pos_embed != "sinusoidal":
        return h
    if sp:
        positions = positions[:, off:off + n]
    return h + sinusoidal_from_positions(positions, cfg.d_model, h.dtype)


def _rope_for(cfg: ModelConfig, batch, positions, rt: Runtime, cp: bool):
    """The rotary angles of the positions (the JAX package's
    ``_rope_for``): RoPE; M-RoPE from the batch's ``position_ids`` (3, B,
    S) (their context shard under ``cp``), or where it has none from the
    positions on all three streams (t = h = w); None without rotary
    positions."""
    if cfg.rope == "rope":
        return rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
    if cfg.rope != "mrope":
        return None
    ids = batch.get("position_ids")
    if ids is None:
        ids = positions[None].expand(3, *positions.shape)
    elif cp:
        ids = _cp_shard(ids, rt, dim=2)
    return mrope_angles(ids, cfg.head_dim_, cfg.rope_theta,
                        cfg.mrope_sections)


def _inputs(cfg: ModelConfig, embed, batch, rt: Runtime, offset=None,
            stream: bool = True):
    """-> (the residual stream's start, or None without ``stream``; the
    rotary angles; sp; cp) of a forward over the batch's positions
    (``offset`` + 0..S-1, or 0..S-1 without one), whether it runs
    sequence-parallel (``sp``) or as a context rank (``cp``)."""
    lead = _lead(batch)
    B, S = lead.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=lead.device)[None]
    if offset is not None:
        positions = offset + positions
    positions = positions.expand(B, S)
    sp = sequence_parallel(rt, S)
    cp = context_parallel(rt, S)
    if cp:
        positions = _cp_shard(positions, rt)
    h = _embed(cfg, embed, batch, positions, rt, sp, cp) if stream else None
    return h, _rope_for(cfg, batch, positions, rt, cp), sp, cp


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _pdict(tree: Dict[str, Any]) -> nn.ParameterDict:
    """Tensors become parameters; a nested dict becomes a nested
    ParameterDict (a submodule), so ``named_parameters`` gives
    ``mixer.ln_x.scale``.  A MoE FFN's dict (it holds a ``router``)
    becomes a :class:`models.moe.MoEFFN`, a module called by its layer."""
    cls = moe_lib.MoEFFN if "router" in tree else nn.ParameterDict
    return cls({k: _pdict(v) if isinstance(v, dict) else nn.Parameter(v)
                for k, v in tree.items()})


class AuxLoss:
    """The MoE layers' load-balance losses of one forward, collected as
    they run (an object, not a container, so FSDP2's input handling
    passes it through untouched)."""

    def __init__(self):
        self.terms: List[torch.Tensor] = []

    def total(self, device) -> torch.Tensor:
        """Their sum in f32 (0 for a dense stack)."""
        out = torch.zeros((), dtype=torch.float32, device=device)
        for t in self.terms:
            out = out + t
        return out


class Layer(nn.Module):
    """One layer: its ParameterDicts {'norm1', 'norm2', 'mixer', 'ffn'}
    (submodules, read as ``layer["mixer"]``) and its forward.  The model
    calls each layer as a module, so hooks on it fire: FSDP2 gathers a
    layer's parameters in its forward pre-hook and frees them after it
    (``core.parallel.apply_plan``).  A plain ``nn.Module``, not a
    ``ModuleDict``: FSDP2 refuses to wrap container types."""

    def __init__(self, parts: Dict[str, nn.ParameterDict]):
        super().__init__()
        for name, sub in parts.items():
            self.add_module(name, sub)

    def __getitem__(self, name: str) -> nn.ParameterDict:
        return self._modules[name]

    def items(self):
        return self._modules.items()

    def forward(self, cfg: ModelConfig, kind: str, h, rope_ang,
                rt: Runtime, cache=None, paged=None, sp: bool = False,
                aux: Optional[AuxLoss] = None, cp: bool = False):
        """h: the residual stream, (B, S, d), or this rank's S-shard of it
        under sequence parallelism (``sp``) or a context plan (``cp``).  The layer computes from its
        parameters' local shards (``to_local`` views of the ``DTensor``s
        FSDP2 has gathered).  ``cache``: the layer's paged pools (with
        ``paged``) or its dense cache ({'kv'}, an RWKV-6 layer's {'att',
        'ffn'} state or a Mamba layer's {'conv', 'ssm'}), updated in
        place.  A MoE FFN is called as its own module; its load-balance
        loss goes to ``aux``.  Under a context plan (``cp``) a recurrent
        layer scans the whole sequence (see the module's docstring), its
        gathers counted at ``COLLECTIVE_SITES['context_seq_gather']``."""
        moe = isinstance(self._modules["ffn"], moe_lib.MoEFFN)
        lp = local_params({k: v for k, v in self.items()
                           if not (moe and k == "ffn")})
        if rt.gather_dtype is not None and not rt.fsdp_wire:
            lp = wire_round(lp, rt.gather_dtype, rt.compute_dtype)
        x = apply_norm(lp["norm1"], h, cfg.norm_eps, rt)
        if kind in RECURRENT:
            # a recurrent mixer's weights lie on the model axis in every
            # plan; under a context plan it scans the whole sequence,
            # gathered at its entry and reduce-scattered at its exit
            mrt = dataclasses.replace(rt, context=False) if rt.context \
                else rt
            COLLECTIVE_SITES["context_seq_gather"] += int(cp)
        if kind == "rwkv6":
            att = None if cache is None else cache["att"]
            mix, new_att = rwkv_lib.rwkv_time_mix(cfg, lp["mixer"], x, mrt,
                                                  state=att, sp=cp)
            h = h + mix
            x = apply_norm(lp["norm2"], h, cfg.norm_eps, rt)
            if cp:   # the token shift crosses the shard boundary
                x = cp_gather(x, rt, "context_seq_gather")
            ffn, new_ffn = rwkv_lib.rwkv_channel_mix(
                cfg, lp["ffn"], x, rt,
                state=None if cache is None else cache["ffn"])
            if cache is not None:
                _carry(cache["att"], new_att)
                _carry(cache["ffn"], new_ffn)
            return h + (_cp_shard(ffn, rt) if cp else ffn)
        if kind == "mamba":
            mix, new_state = mamba_lib.mamba_block(cfg, lp["mixer"], x, mrt,
                                                   state=cache, sp=cp)
            if cache is not None:
                _carry(cache, new_state)
        else:
            if cache is not None and paged is None:
                cache = cache["kv"]
            mix = attn_lib.attention_block(cfg, lp["mixer"], x, rope_ang, rt,
                                           cache=cache, paged=paged, sp=sp,
                                           cp=cp)
        h = h + mix
        x = apply_norm(lp["norm2"], h, cfg.norm_eps, rt)
        if moe:
            y, a = self._modules["ffn"](cfg, x, rt, sp or cp)
            if aux is not None and not recomputing():
                aux.terms.append(a)
            return h + y
        return h + apply_mlp(cfg, lp["ffn"], x, rt, sp)


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline F op's part of the model (``core.pipeline``): the
    layers of a chunk; whether its virtual stage is the first (it embeds
    the inputs) and the last (it computes the final norm, the head and the
    masked nll sum over ``denom``).  Its F returns the residual stream, or
    on the last stage the nll, beside the sum of its MoE layers' aux
    losses."""
    layers: Tuple[int, ...]
    first: bool
    last: bool
    denom: Optional[torch.Tensor] = None


class Params(nn.Module):
    """Model parameters: ``embed`` {'tok', ['lm_head']}, ``final_norm``
    {'scale'[, 'bias']}, and ``layers[i]`` {'norm1', 'norm2', 'mixer',
    'ffn'}, each a ParameterDict (nested where the JAX tree nests, as the
    RWKV-6 mixer's ``ln_x``) in the JAX package's names and (in, out)
    layouts.  Calling it runs the model (:func:`forward`)."""

    def __init__(self, embed, final_norm, layers: List[Dict[str, Dict]]):
        super().__init__()
        self.embed = _pdict(embed)
        self.final_norm = _pdict(final_norm)
        self.layers = nn.ModuleList(
            Layer({name: _pdict(sub) for name, sub in lp.items()})
            for lp in layers)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def forward(self, cfg: ModelConfig, batch, rt: Runtime, cache=None,
                h=None, stage: Optional[Stage] = None,
                aux: Optional[AuxLoss] = None):
        """-> logits (B, S, vocab), on a model axis this rank's columns of
        the vocabulary; see :func:`forward`.  Under sequence parallelism
        (:func:`sequence_parallel`) the residual stream holds this rank's
        S-shard from the embedding to the final norm.  Under a context plan
        (:func:`layers.context_parallel`) this rank runs its contiguous
        S / cp of the tokens and positions from the embedding to the
        logits, which are its positions' (a cached forward, a prefill,
        gathers the final residual stream over the group first: every
        rank gets the whole prompt's logits).

        With a ``stage`` (a pipeline F op, ``core.pipeline``) it runs only
        that part: from the tokens (first virtual stage) or the residual
        stream ``h``, through the stage's layers, to the residual stream,
        or on the last virtual stage to the masked nll sum over
        ``stage.denom`` (:func:`masked_nll`), beside the sum of the
        stage's MoE layers' load-balance losses (0 for a dense stack).
        The whole model module is called for each op, so FSDP2's root
        hooks fire on every stage.  Otherwise the MoE layers'
        load-balance losses go to ``aux``."""
        if stage is not None:
            return self._stage(cfg, batch, rt, h, stage)
        embed = local_params(self.embed)
        h, rope_ang, sp, cp = _inputs(
            cfg, embed, batch, rt,
            None if cache is None else batch.get("pos", 0))
        paged = cache.get("paged") if cache is not None else None
        layer_caches = (cache["layers"] if cache is not None
                        else [None] * len(self.layers))
        if rt.pipe_size > 1 and cache is not None:
            h = self._through_pipe(cfg, h, rope_ang, rt, layer_caches, cp)
        else:
            wired, plain = range(cfg.n_layers), rt
            if rt.gather_dtype is not None:
                wired = wired_layers(cfg)
                plain = dataclasses.replace(rt, gather_dtype=None,
                                            fsdp_wire=False)
            if len(layer_caches) != len(self.layers):
                raise ValueError(f"{len(layer_caches)} layer caches for "
                                 f"{len(self.layers)} layers")

            def layer(i, h):
                return self.layers[i](cfg, cfg.layer_kind(i), h, rope_ang,
                                      rt if i in wired else plain,
                                      layer_caches[i], paged, sp, aux, cp)

            for ids, block in _blocks(cfg, cache is None):
                h = _run_block(layer, ids, h, block and rt.remat,
                               block and rt.remat_inner)
        h = apply_norm(local_params(self.final_norm), h, cfg.norm_eps, rt)
        if cp and cache is not None:
            h = cp_gather(h, rt, None)
        return lm_logits(embed, h, rt, sp)

    def _through_pipe(self, cfg, h, rope_ang, rt, layer_caches, cp=False):
        """The layers in order across the pipe ranks, as the JAX package
        runs a serving plan's pipe-sharded stack (a plain scan, with no
        schedule): each rank runs its stages' chunks of layers, the
        residual stream goes to the rank of the next chunk, and from the
        last one to every pipe rank (each computes the head)."""
        from repro_torch.core.pipeline import (_Transport, boundary_dtype,
                                               virtual_stages)
        P = rt.pipe_size
        n = cfg.n_layers // (P * virtual_stages(rt.pipe_schedule))
        chunks = [range(c * n, (c + 1) * n) for c in range(cfg.n_layers // n)]
        link = _Transport(rt, h.device)
        shape, dt = tuple(h.shape[:-1]) + (cfg.d_model,), boundary_dtype(
            cfg, rt)
        for c, ids in enumerate(chunks):
            if c % P != rt.pipe_rank:
                continue
            if c and (c - 1) % P != rt.pipe_rank:
                h, = link.exchange([], [(shape, dt, -1)])
            for i in ids:
                h = self.layers[i](cfg, cfg.layer_kind(i), h, rope_ang, rt,
                                   layer_caches[i], None, False, None, cp)
            if c + 1 < len(chunks) and (c + 1) % P != rt.pipe_rank:
                link.exchange([(h.to(dt), 1)], [])
        last = (len(chunks) - 1) % P
        if rt.pipe_rank != last:
            h = torch.empty(shape, dtype=dt, device=h.device)
        buf = h.to(dt).cpu() if rt.pipe_via_host else h.to(dt).contiguous()
        dist.broadcast(buf, dist.get_global_rank(rt.pipe_group, last),
                       group=rt.pipe_group)
        return buf.to(h.device)

    def _stage(self, cfg, batch, rt, h, stage: Stage):
        embed = local_params(self.embed)
        h0, rope_ang, sp, cp = _inputs(cfg, embed, batch, rt,
                                       stream=stage.first)
        if stage.first:
            h = h0
        aux = AuxLoss()

        def layer(i, h):
            return self.layers[i](cfg, cfg.layer_kind(i), h, rope_ang, rt,
                                  None, None, sp, aux, cp)

        # under remat each layer of the stage is checkpointed (the JAX
        # package's make_pipelined_block_fn; its stacks are uniform)
        for i in stage.layers:
            h = _run_block(layer, (i,), h, rt.remat, False)
        aux = aux.total(h.device)
        if not stage.last:
            return h, aux
        h = apply_norm(local_params(self.final_norm), h, cfg.norm_eps, rt)
        return masked_nll(lm_logits(embed, h, rt, sp), batch["labels"], rt,
                          stage.denom)[0], aux


def _blocks(cfg: ModelConfig, train: bool):
    """-> [(layer ids, whether remat may checkpoint them)] in order:
    :func:`layer_plan`'s prefix layers one at a time, never checkpointed
    (the JAX package scans only the blocks), then each block of ``period``
    layers, which ``Runtime.remat`` and ``remat_inner`` checkpoint on a
    cache-less forward (``train``); a cached forward (prefill, decode)
    checkpoints nothing."""
    _, start, period, _ = layer_plan(cfg)
    return ([((i,), False) for i in range(start)]
            + [(tuple(range(b, b + period)), train)
               for b in range(start, cfg.n_layers, period)])


def _run_block(layer, ids, h, remat: bool, inner: bool):
    """The layers ``ids`` in turn (``layer(i, h)`` -> h), the whole block in
    one ``torch.utils.checkpoint`` where ``remat`` (its backward reruns
    the block from its input, which alone it keeps) and each layer in one
    of its own where ``inner``: the JAX package's ``jax.checkpoint`` of a
    scanned block and, under ``remat_inner``, of each layer in it.  The
    rerun stops once it has made what the backward saved.  A block that
    spans several FSDP2 units is rerun as one: the units whose backward
    has not begun gather their parameters again in their pre-forward
    hooks."""
    from torch.utils.checkpoint import checkpoint

    def contexts():
        return contextlib.nullcontext(), recompute_context()

    def one(i, x):
        if inner:
            return checkpoint(layer, i, x, use_reentrant=False,
                              preserve_rng_state=False, context_fn=contexts)
        return layer(i, x)

    def block(x):
        for i in ids:
            x = one(i, x)
        return x

    if not remat:
        return block(h)
    return checkpoint(block, h, use_reentrant=False,
                      preserve_rng_state=False, context_fn=contexts)


def _cp_shard(x, rt: Runtime, dim: int = 1):
    """(B, S, ...) -> this context rank's contiguous (B, S / cp, ...): its
    positions along ``dim`` (2 for ``position_ids`` (3, B, S))."""
    n = x.shape[dim] // rt.tp_size
    return x.narrow(dim, rt.tp_rank * n, n)


def _init_layer(cfg: ModelConfig, i: int, gen, device):
    p = {"norm1": init_norm(cfg, device), "norm2": init_norm(cfg, device)}
    if cfg.layer_kind(i) == "rwkv6":
        p["mixer"] = rwkv_lib.init_rwkv_time_mix(cfg, gen, device)
        p["ffn"] = rwkv_lib.init_rwkv_channel_mix(cfg, gen, device)
    else:
        p["mixer"] = (mamba_lib.init_mamba(cfg, gen, device)
                      if cfg.layer_kind(i) == "mamba"
                      else attn_lib.init_attention(cfg, gen, device))
        p["ffn"] = (moe_lib.init_moe(cfg, gen, device) if cfg.is_moe_layer(i)
                    else init_mlp(cfg, gen, device))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (the same seed gives the same weights on the same device
    type), with the JAX package's distributions."""
    check_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    layers = [_init_layer(cfg, i, gen, device) for i in range(cfg.n_layers)]
    return Params(init_embed(cfg, gen, device), init_norm(cfg, device),
                  layers)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Params, batch, rt: Runtime,
            cache=None, aux: Optional[AuxLoss] = None):
    """-> logits (B, S, vocab).

    Without a cache (training): batch {'tokens' (B, S)} at positions
    0..S-1, every layer mixes causally over the sequence.  In place of
    the tokens a batch may hold frame ``embeds`` (B, S, d); a
    ``tokens+vision`` model's batch may hold ``vision_embeds`` (B, V, d),
    which take the first min(V, S) positions, and an M-RoPE model's
    ``position_ids`` (3, B, S) (else t = h = w = the positions).

    With a dense cache (static serving, :func:`init_cache`): batch may
    hold pos, the absolute position of the first token (a scalar: 0 for a
    prefill, the decode step's position); the caches are updated in place.

    With a paged cache (continuous batching): batch also holds pos, (1, 1)
    for a prefill chunk, (B, 1) for a decode step (broadcast over S).
    cache: {'layers': [{'k_pool', 'v_pool'}] per layer, updated in place,
    'paged': {'tbl' (B, max_blocks) int32, 'ctx' (B,) int32}}.

    ``aux`` (an :class:`AuxLoss`) collects the MoE layers' load-balance
    losses.
    """
    if cache is not None and "paged" in cache and not _all_attention(cfg):
        raise NotImplementedError(
            f"{cfg.name}: only attention-only stacks serve from a paged "
            "cache; a recurrent stack serves from dense caches "
            "(ServeEngine.generate_static)")
    return params(cfg, batch, rt, cache, aux=aux)


# ---------------------------------------------------------------------------
# dense caches (static serving)
# ---------------------------------------------------------------------------

def _carry(state: Dict[str, Any], new: Dict[str, Any]) -> None:
    """Take a recurrent layer's new state into its cache: in place where
    the buffer has the new value's shape and type, else by replacing it
    (``x_prev`` follows the residual stream, which an RWKV-6 layer
    promotes to f32)."""
    for k, v in new.items():
        old = state[k]
        if old.shape == v.shape and old.dtype == v.dtype:
            old.copy_(v)
        else:
            state[k] = v


def _layer_cache_shapes(cfg: ModelConfig, i: int, batch: int, max_len: int,
                        dtype):
    kind = cfg.layer_kind(i)
    d = cfg.d_model
    if kind == "attn":
        return {"kv": attn_lib.kv_cache_leaves(cfg, batch, max_len, dtype)}
    if kind == "rwkv6":
        H, N = cfg.rwkv_heads, cfg.rwkv_head_dim
        return {"att": {"x_prev": CacheLeaf((batch, d), dtype),
                        "wkv": CacheLeaf((batch, H, N, N), torch.float32)},
                "ffn": {"x_prev": CacheLeaf((batch, d), dtype)}}
    mc = cfg.mamba
    di = mamba_lib.d_inner(cfg)
    return {"conv": CacheLeaf((batch, mc.d_conv - 1, di), dtype),
            "ssm": CacheLeaf((batch, di, mc.d_state), torch.float32)}


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int, dtype):
    """Every leaf of the dense caches (:func:`init_cache`) as a
    :class:`CacheLeaf`, whole: what ``core.parallel.cache_shardings``
    places."""
    return {"layers": [_layer_cache_shapes(cfg, i, batch, max_len, dtype)
                       for i in range(cfg.n_layers)]}


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device="cuda", plan=None, params=None):
    """Empty dense caches for ``batch`` rows of up to ``max_len``
    positions: {'layers': [one per layer]}, an attention layer's {'kv':
    {'k', 'v' (B, Sc, Kv, D), 'kpos' (Sc,) all -1, 'idx' 0-d}} (a
    sliding-window model's Sc is its ring, ``attention.cache_slots``), an
    RWKV-6 layer's {'att': {'x_prev' (B, d), 'wkv' (B, H, N, N) f32},
    'ffn': {'x_prev'}}, a Mamba layer's {'conv' (B, K-1, di), 'ssm' (B,
    di, d_state) f32}.  Under a ``plan`` each leaf is this rank's shard
    of it (``core.parallel.cache_shardings``); a pipe rank holds the
    caches of the layers ``params`` keeps (an empty dict for the
    others)."""
    shapes = cache_shapes(cfg, batch, max_len, dtype)
    if plan is not None:
        from repro_torch.core import parallel as par
        places = par.cache_shardings(cfg, plan, shapes)
        out = _tree_map(lambda leaf, place: torch.zeros(
            par.local_shape(plan, leaf.shape, place), dtype=leaf.dtype,
            device=device), shapes, places)
    else:
        out = _tree_map(lambda leaf: torch.zeros(
            leaf.shape, dtype=leaf.dtype, device=device), shapes)
    for lc in out["layers"]:
        if "kv" in lc:
            lc["kv"]["kpos"].fill_(-1)           # every slot empty
    if params is not None:
        out["layers"] = [lc if len(layer._modules) else {}
                         for lc, layer in zip(out["layers"], params.layers)]
    return out


def prefill(cfg: ModelConfig, params: Params, batch, rt: Runtime,
            max_len: int, plan=None):
    """Run the prompts (tokens, or frame ``embeds``, with their other
    inputs: :func:`forward`) through the model, building dense caches for
    ``max_len`` positions -> (logits, cache).  Under a ``plan`` the batch
    holds every row and this rank runs its rows of every leaf
    (``core.parallel.serve_rows``, :func:`batch_rows`): the logits are
    theirs (this rank's vocabulary columns on a model axis) and the cache
    its shards."""
    lead = _lead(batch)
    B = lead.shape[0]
    if plan is not None:
        from repro_torch.core import parallel as par
        batch = batch_rows(batch, *par.serve_rows(plan, B))
    cache = init_cache(cfg, B, max_len, rt.compute_dtype, lead.device,
                       plan, params)
    return forward(cfg, params, batch, rt, cache), cache


def decode_step(cfg: ModelConfig, params: Params, cache, tokens, pos,
                rt: Runtime, extra: Optional[dict] = None):
    """tokens (B, 1) (this rank's rows under a plan); pos: the scalar
    absolute position; ``extra``: more inputs of the step (frame
    ``embeds`` (B, 1, d), which stand in for the tokens, or M-RoPE
    ``position_ids`` (3, B, 1)), as the JAX package's ``decode_step``
    takes them. -> (logits (B, 1, vocab), cache), the cache updated in
    place."""
    batch = {"tokens": tokens, "pos": pos, **(extra or {})}
    return forward(cfg, params, batch, rt, cache), cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _vocab_parallel_terms(lf, labels, rt: Runtime):
    """f32 logits (B, S, V / tp) of this rank's vocabulary columns ->
    (logsumexp, the label's logit), each (B, S) and the same on every
    model rank.  The max is a shift with no gradient; each sum is
    all-reduced with an identity backward (Megatron's g, ``tp_exit``), so
    every rank's logits take their own part of the gradient."""
    with torch.no_grad():
        m = all_reduce(lf.amax(-1), rt, dist.ReduceOp.MAX)
    sumexp = tp_exit(torch.exp(lf - m[..., None]).sum(-1), rt, False)
    cols = lf.shape[-1]
    ids = labels.long() - rt.tp_rank * cols
    mine = (ids >= 0) & (ids < cols)
    ll = torch.gather(lf, -1, torch.where(mine, ids, 0)[..., None])[..., 0]
    return m + torch.log(sumexp), tp_exit(ll * mine.to(ll.dtype), rt, False)


def loss_fn(cfg: ModelConfig, params: Params, batch, rt: Runtime,
            denom=None):
    """Next-token cross entropy in f32; labels < 0 are masked.
    -> (loss, {'nll', 'aux', 'ntok'}), all 0-d tensors on the batch's
    device (``aux``, the sum of the MoE layers' load-balance losses, is 0
    for a dense stack).  Under a data-parallel plan each rank's aux is the
    global one (the routers average their statistics over the ranks), so
    the mean of the ranks' gradients is its gradient.

    ``nll`` is the masked sum over ``denom``: by default this batch's
    count of unmasked labels (``ntok``); a data-parallel step passes its
    share of the global count, so that every rank's labels weigh alike.
    On a model axis the cross entropy is vocab-parallel: every rank holds
    its columns of the logits, and the max, the sum of exponentials and
    the label's logit are each reduced over the model group, so the whole
    (B, S, V) logits are never gathered.  Under a context plan each rank
    holds its shard of the sequence's logits and labels: the nll sum and
    the label count are summed over the group (the sum's backward is the
    identity: each rank's gradient is its positions')."""
    terms = AuxLoss()
    nll, ntok = masked_nll(forward(cfg, params, batch, rt, aux=terms),
                           batch["labels"], rt, denom)
    aux = terms.total(nll.device)
    return nll + aux, {"nll": nll, "aux": aux, "ntok": ntok}


def masked_nll(logits, labels, rt: Runtime, denom=None):
    """-> (the masked sum of the next-token nll over ``denom``, by default
    the count of unmasked labels; that count), in f32 (vocab-parallel on a
    model axis, summed over the sequence shards of a context plan, see
    :func:`loss_fn`)."""
    cp = context_parallel(rt, labels.shape[1])
    if cp:
        labels = _cp_shard(labels, rt)
    lf = logits.float()
    if head_parallel(rt):
        lse, ll = _vocab_parallel_terms(lf, labels, rt)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1,
                          labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll, count = ((lse - ll) * mask).sum(), mask.sum()
    if cp:
        nll, count = cp_sum(nll, rt), cp_sum(count, rt)
    if denom is None:
        denom = count.clamp_min(1.0)
    return nll / denom, count
