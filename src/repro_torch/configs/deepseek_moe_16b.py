"""DeepSeek-MoE 16B — fine-grained experts, 2 shared + 64 routed top-6.

[arXiv:2401.06066] 28L d_model=2048 16H (kv=16) expert_d_ff=1408 vocab=102400.
Layer 0 keeps a dense FFN (d_ff=10944) as in the released model.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    dense_d_ff=10944,
    vocab_size=102400,
    moe=MoEConfig(
        n_experts=64, top_k=6, n_shared_experts=2, expert_d_ff=1408,
        moe_start_layer=1, moe_every=1, aux_loss_coef=0.001),
    source="DeepSeekMoE [arXiv:2401.06066]",
)
