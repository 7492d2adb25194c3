"""Llama-2 family — the paper's own experimental models (Touvron et al. 2023).

The paper trains Llama-2 {1B, 7B, 13B, 70B} at context 4096, vocab 32K
(Section 3, 4.5).
"""
from repro_torch.configs.base import ModelConfig


def _llama(name, n_layers, d_model, n_heads, n_kv, d_ff):
    return ModelConfig(
        name=name, family="dense", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv, d_ff=d_ff, vocab_size=32000,
        source="Llama 2 [arXiv:2307.09288]")


LLAMA2_1B = _llama("llama2-1b", 16, 2048, 16, 16, 5504)
LLAMA2_7B = _llama("llama2-7b", 32, 4096, 32, 32, 11008)
LLAMA2_13B = _llama("llama2-13b", 40, 5120, 40, 40, 13824)
LLAMA2_70B = _llama("llama2-70b", 80, 8192, 64, 8, 28672)

CONFIGS = {c.name: c for c in (LLAMA2_1B, LLAMA2_7B, LLAMA2_13B, LLAMA2_70B)}
