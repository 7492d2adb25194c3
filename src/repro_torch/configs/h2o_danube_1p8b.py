"""H2O-Danube 1.8B — llama/mistral mix with sliding-window attention.

[arXiv:2401.16818] 24L d_model=2560 32H kv=8 d_ff=6912 vocab=32000,
sliding window 4096 (mistral-style) -> sub-quadratic, runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    source="H2O-Danube [arXiv:2401.16818]",
)
