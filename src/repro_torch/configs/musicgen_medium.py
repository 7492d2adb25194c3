"""MusicGen-medium — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284] 48L d_model=1536 24H (MHA) d_ff=6144 vocab=2048.
The EnCodec tokenizer / mel frontend is STUBBED per the brief:
``input_specs`` provides precomputed frame embeddings (input_mode=embeddings).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    rope="none",
    pos_embed="sinusoidal",
    glu=False,
    act="gelu",
    norm="layernorm",
    input_mode="embeddings",
    source="MusicGen [arXiv:2306.05284]",
)
