"""Qwen3-0.6B — dense with per-head q/k RMSNorm (qk_norm) and GQA.

[hf:Qwen/Qwen3-8B family] 28L d_model=1024 16H kv=8 d_ff=3072 vocab=151936,
head_dim=128 (decoupled from d_model/n_heads, as in Qwen3).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="Qwen3 [hf:Qwen/Qwen3-8B]",
)
