"""RWKV-6 "Finch" 1.6B — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536, head_dim 64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # 2048 / 64 WKV heads
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    mixer="rwkv6",
    rope="none",
    glu=False,             # RWKV channel-mix is relu^2, not GLU
    act="relu2",
    rwkv_head_dim=64,
    norm="layernorm",
    source="Finch: RWKV-6 [arXiv:2404.05892]",
)
