"""Analytic FLOP accounting per (architecture, input shape, mode).

A copy of the JAX package's ``perf/flops.py``; only the imports differ.

``compiled.cost_analysis()`` counts while-loop (lax.scan) bodies once, so
HLO FLOPs structurally undercount scanned models.  Since every einsum in
this codebase is known, we account FLOPs in closed form instead:
``compiled_flops`` models what the compiled step actually executes
(including causal-attention triangularity, MoE capacity slop, remat
recompute), while ``model_flops`` is the textbook 6·N·D (or 2·N per token)
the paper's MFU definition uses.  Their ratio exposes remat / routing /
attention overheads — exactly what §Roofline asks for.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.rwkv6 import TD_RANK, TM_RANK


def _attn_layer(cfg: ModelConfig, T: int, s_eff: float) -> float:
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim_
    proj = 2 * T * d * (H * hd + 2 * Kv * hd) + 2 * T * H * hd * d
    scores = 2 * T * s_eff * H * hd * 2          # QK^T and PV
    return proj + scores


def _rwkv_layer(cfg: ModelConfig, T: int, chunk: int, decode: bool) -> float:
    d = cfg.d_model
    H, N = cfg.rwkv_heads, cfg.rwkv_head_dim
    proj = 5 * 2 * T * d * d
    lora = 2 * T * d * (5 * TM_RANK) * 2 + 2 * T * d * TD_RANK * 2
    if decode:
        wkv = T * H * (4 * N * N)
    else:
        # per chunk/head: qp kp^T (2C^2 N) + A v (2C^2 N) + qp S (2C N^2)
        # + tail update (2C N^2)
        wkv = T * H * (4 * chunk * N + 4 * N * N)
    return proj + lora + wkv


def _mamba_layer(cfg: ModelConfig, T: int) -> float:
    d = cfg.d_model
    mc = cfg.mamba
    di = mc.expand * d
    dtr = mc.dt_rank or -(-d // 16)
    proj = 2 * T * d * 2 * di + 2 * T * di * (dtr + 2 * mc.d_state) \
        + 2 * T * dtr * di + 2 * T * di * d
    conv = 2 * mc.d_conv * T * di
    scan = 6 * T * di * mc.d_state
    return proj + conv + scan


def _ffn_layer(cfg: ModelConfig, i: int, T: int) -> float:
    d = cfg.d_model
    mult = 3 if cfg.glu else 2
    if cfg.layer_kind(i) == "rwkv6":
        return 2 * T * d * cfg.d_ff * 2 + 2 * T * d * d   # k/v + receptance
    if cfg.is_moe_layer(i):
        m = cfg.moe
        routed_tokens = T * m.top_k * m.capacity_factor   # capacity slop incl.
        routed = 2 * routed_tokens * d * m.expert_d_ff * mult
        shared = 2 * T * d * (m.n_shared_experts * m.expert_d_ff) * mult
        router = 2 * T * d * m.n_experts
        return routed + shared + router
    dff = cfg.dense_d_ff or cfg.d_ff
    return 2 * T * d * dff * mult


def forward_flops(cfg: ModelConfig, shape: ShapeConfig,
                  rwkv_chunk: int = 64) -> float:
    """One forward pass over the global batch."""
    decode = shape.mode == "decode"
    B, S = shape.global_batch, shape.seq_len
    T = B * (1 if decode else S)
    if decode:
        ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S
        s_eff = ctx
    else:
        s_eff = (S + 1) / 2
        if cfg.sliding_window:
            s_eff = min(s_eff, cfg.sliding_window)

    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            total += _attn_layer(cfg, T, s_eff)
        elif kind == "rwkv6":
            total += _rwkv_layer(cfg, T, rwkv_chunk, decode)
        else:
            total += _mamba_layer(cfg, T)
        total += _ffn_layer(cfg, i, T)
    total += 2 * T * cfg.d_model * cfg.vocab_size        # lm head
    return total


def compiled_flops(cfg: ModelConfig, shape: ShapeConfig, remat: bool = True
                   ) -> float:
    """FLOPs the compiled step executes: fwd(+bwd)(+remat recompute)."""
    fwd = forward_flops(cfg, shape)
    if shape.mode != "train":
        return fwd
    factor = 3.0 + (1.0 if remat else 0.0)               # fwd + 2x bwd + remat
    return fwd * factor


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Paper/MFU convention: 6·N_active·tokens (train), 2·N_active (infer)."""
    n = cfg.active_param_count()
    decode = shape.mode == "decode"
    tokens = shape.global_batch * (1 if decode else shape.seq_len)
    return (2.0 if shape.mode != "train" else 6.0) * n * tokens
