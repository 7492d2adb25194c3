"""IBM Granite-20B (code) — llama-arch with MQA (kv=1).

[arXiv:2405.04324] 52L d_model=6144 48H kv=1 d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    glu=False,
    act="gelu",
    norm="layernorm",
    qkv_bias=True,
    rope="none",               # granite-20b-code uses learned absolute positions
    pos_embed="sinusoidal",    # modeled as fixed sinusoidal table here
    source="Granite Code Models [arXiv:2405.04324]",
)
