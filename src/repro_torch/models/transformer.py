"""Decoder-only model, cache-less (training) or over a paged KV cache
(serving): the dense, attention-only part of the JAX package's
``models/transformer.py``.

A model is a stack of layers; each layer = (RMSNorm -> attention ->
residual, RMSNorm -> MLP -> residual).  Parameters live in an
:class:`Params` module whose ``layers`` is an ``nn.ModuleList`` with one
entry per layer; a Python loop over it replaces the JAX package's
``lax.scan`` over stacked blocks (``layer_plan`` is kept: the bridge uses
it to map the JAX stack onto layers).
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (Runtime, apply_mlp, apply_norm,
                                       embed_tokens, init_embed, init_mlp,
                                       init_norm, lm_logits, rope_angles)


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


def check_supported(cfg: ModelConfig) -> None:
    """The port's model covers dense attention-only stacks with token
    inputs and RoPE (or no positions)."""
    bad = [i for i in range(cfg.n_layers) if _sig(cfg, i) != ("attn", False)]
    if bad or cfg.input_mode != "tokens" or cfg.rope not in ("rope", "none") \
            or cfg.pos_embed != "none":
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention-only stacks with "
            "token inputs and RoPE; other layers come with later slices "
            "(ROADMAP Queue 1)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _pdict(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


class Params(nn.Module):
    """Model parameters: ``embed`` {'tok', ['lm_head']}, ``final_norm``
    {'scale'}, and ``layers[i]`` {'norm1', 'norm2', 'mixer', 'ffn'}, each a
    ParameterDict in the JAX package's names and (in, out) layouts."""

    def __init__(self, embed, final_norm, layers: List[Dict[str, Dict]]):
        super().__init__()
        self.embed = _pdict(embed)
        self.final_norm = _pdict(final_norm)
        self.layers = nn.ModuleList(
            nn.ModuleDict({name: _pdict(sub) for name, sub in lp.items()})
            for lp in layers)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device


def _init_layer(cfg: ModelConfig, gen, device):
    return {"norm1": init_norm(cfg, device), "norm2": init_norm(cfg, device),
            "mixer": attn_lib.init_attention(cfg, gen, device),
            "ffn": init_mlp(cfg, gen, device)}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (the same seed gives the same weights on the same device
    type), with the JAX package's distributions."""
    check_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    layers = [_init_layer(cfg, gen, device) for _ in range(cfg.n_layers)]
    return Params(init_embed(cfg, gen, device), init_norm(cfg, device),
                  layers)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_layer(cfg, lp, h, rope_ang, rt: Runtime, cache, paged):
    x = apply_norm(lp["norm1"], h, cfg.norm_eps, rt)
    h = h + attn_lib.attention_block(cfg, lp["mixer"], x, rope_ang, rt,
                                     cache=cache, paged=paged)
    x = apply_norm(lp["norm2"], h, cfg.norm_eps, rt)
    return h + apply_mlp(cfg, lp["ffn"], x, rt)


def forward(cfg: ModelConfig, params: Params, batch, rt: Runtime,
            cache=None):
    """-> logits (B, S, vocab).

    Without a cache (training): batch {'tokens' (B, S)} at positions
    0..S-1, every layer attends causally over the sequence.

    With a paged cache (serving): batch also holds pos, the absolute
    position of the first token: (1, 1) for a prefill chunk, (B, 1) for a
    decode step (broadcast over S).  cache: {'layers': [{'k_pool',
    'v_pool'}] per layer, updated in place, 'paged': {'tbl' (B,
    max_blocks) int32, 'ctx' (B,) int32}}.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None]
    if cache is not None:
        positions = batch["pos"] + positions
    positions = positions.expand(B, S)

    h = embed_tokens(params.embed, tokens, rt)
    rope_ang = (rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
                if cfg.rope == "rope" else None)
    paged = cache["paged"] if cache is not None else None
    layer_caches = (cache["layers"] if cache is not None
                    else [None] * len(params.layers))
    for lp, lc in zip(params.layers, layer_caches, strict=True):
        h = _apply_layer(cfg, lp, h, rope_ang, rt, lc, paged)
    h = apply_norm(params.final_norm, h, cfg.norm_eps, rt)
    return lm_logits(params.embed, h, rt)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def loss_fn(cfg: ModelConfig, params: Params, batch, rt: Runtime):
    """Next-token cross entropy in f32; labels < 0 are masked.
    -> (loss, {'nll', 'aux', 'ntok'}), all 0-d tensors on the batch's
    device (``aux``, the MoE load-balance loss, is 0 for a dense stack)."""
    logits = forward(cfg, params, batch, rt)
    labels = batch["labels"]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)
    aux = torch.zeros((), dtype=torch.float32, device=nll.device)
    return nll + aux, {"nll": nll, "aux": aux, "ntok": mask.sum()}
