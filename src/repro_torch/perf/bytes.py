"""Analytic per-device HBM traffic for the roofline memory term (a copy
of the JAX package's ``perf/bytes.py``).

Like FLOPs (perf/flops.py), HBM traffic is modeled in closed form (an
eager step has no program to read bytes off, and XLA's bytes-accessed
undercounts scan bodies), with the JAX package's numbers exactly.
Accounting convention (per optimizer step / serve step, per device):

  * weights: each device reads the full (all-gathered) weight set once per
    forward, once per backward, and once more under remat; MoE reads only
    its local experts' slice plus the dispatched activations.
  * activations: each layer streams its (B_loc, S, d)-scale tensors a small
    constant number of times (read + write around each matmul);
  * optimizer: params + grads + both Adam moments read & written (fp32);
  * decode: the KV cache (or recurrent state) shard is read once per token
    and written at one slot — this dominates decode, which is why decode
    is memory-bound on every architecture.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

BF16 = 2
FP32 = 4
ACT_STREAMS = 8          # reads+writes of layer-scale activations per layer


def _cache_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                            n_devices: int) -> float:
    """Total KV/state cache bytes, already divided by devices (cache is
    sharded over the full mesh by the decode plan)."""
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            s_eff = min(S, cfg.sliding_window) if cfg.sliding_window else S
            total += B * s_eff * cfg.kv_heads * cfg.head_dim_ * 2 * BF16
        elif kind == "rwkv6":
            total += B * cfg.rwkv_heads * cfg.rwkv_head_dim ** 2 * FP32
        else:  # mamba
            di = cfg.mamba.expand * cfg.d_model
            total += B * di * cfg.mamba.d_state * FP32 \
                + B * (cfg.mamba.d_conv - 1) * di * BF16
    return total / n_devices


def hbm_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                         n_devices: int, remat: bool = True) -> float:
    B, S = shape.global_batch, shape.seq_len
    decode = shape.mode == "decode"
    train = shape.mode == "train"
    tokens_local = B * (1 if decode else S) / min(n_devices, B * (1 if decode else S))
    # activations are sharded over the whole mesh (data x model axes)
    tokens_per_dev = B * (1 if decode else S) / n_devices

    P = cfg.param_count() * BF16
    P_active = cfg.active_param_count() * BF16

    # ---- weights ----
    if decode:
        # every device reads its weight shard once per token step
        w_traffic = (P_active if cfg.moe.n_experts else P) / n_devices \
            * max(B / min(B, n_devices), 1.0)
        # (batched decode re-reads the shard once per local example group)
        w_traffic = max(w_traffic, P / n_devices)
    else:
        passes = (3 if not remat else 4) if train else 1
        w_traffic = P_active * passes if cfg.moe.n_experts else P * passes

    # ---- activations ----
    d = cfg.d_model
    act = cfg.n_layers * tokens_per_dev * d * BF16 * ACT_STREAMS
    if train:
        act *= 2.2          # backward re-streams + gradient tensors
    # logits
    act += tokens_per_dev * cfg.vocab_size * BF16 * (2 if train else 1)

    # ---- optimizer ----
    opt = 0.0
    if train:
        # read+write m, v (fp32), params (bf16), grads: all sharded
        opt = (2 * 2 * cfg.param_count() * FP32
               + 2 * cfg.param_count() * BF16
               + 2 * cfg.param_count() * FP32) / n_devices

    # ---- caches ----
    cache = 0.0
    if decode:
        cache = _cache_bytes_per_device(cfg, shape, n_devices) * 2  # read + update
    elif shape.mode == "prefill":
        cache = _cache_bytes_per_device(cfg, shape, n_devices)      # write once

    per_dev_weights = w_traffic if decode else w_traffic / 1  # full set read
    # In SPMD each device reads the gathered weights (full set) per pass:
    if not decode:
        per_dev = per_dev_weights + act + opt + cache
    else:
        per_dev = per_dev_weights + act + cache
    return per_dev
