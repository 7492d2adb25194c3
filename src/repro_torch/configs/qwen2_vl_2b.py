"""Qwen2-VL-2B — VLM with M-RoPE and dynamic resolution.

[arXiv:2409.12191] 28L d_model=1536 12H kv=2 d_ff=8960 vocab=151936.
The ViT vision tower + projector are STUBBED per the brief: ``input_specs``
provides precomputed patch embeddings merged into the token stream
(input_mode=tokens+vision); the decoder applies 3-section M-RoPE over
(temporal, height, width) position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    input_mode="tokens+vision",
    vision_tokens=256,
    source="Qwen2-VL [arXiv:2409.12191]",
)
