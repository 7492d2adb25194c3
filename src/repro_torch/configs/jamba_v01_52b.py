"""Jamba v0.1 52B — hybrid Mamba + attention (1:7) with MoE every other layer.

[arXiv:2403.19887] 32L d_model=4096 32H kv=8 d_ff=14336 vocab=65536,
MoE 16 experts top-2 on every other layer; attention on layers 8,16,24,32
(1 attention : 7 mamba).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    mixer="mamba",
    attn_every=8,
    rope="none",               # Jamba uses no positional encoding in attn layers
    moe=MoEConfig(
        n_experts=16, top_k=2, expert_d_ff=14336,
        moe_start_layer=1, moe_every=2, aux_loss_coef=0.01),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    source="Jamba [arXiv:2403.19887]",
)
