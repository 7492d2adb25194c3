"""DBRX 132B — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base] 40L d_model=6144 48H kv=8 expert_d_ff=10752
vocab=100352, every layer MoE.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, expert_d_ff=10752, aux_loss_coef=0.01),
    source="DBRX [hf:databricks/dbrx-base]",
)
