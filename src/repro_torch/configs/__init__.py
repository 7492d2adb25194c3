"""Architecture registry of the port: ``get_config(arch_id)``.

The port runs dense attention-only stacks: with RoPE, RMSNorm and a SwiGLU
MLP (``qwen3-0.6b``, the Llama-2 family, ``qwen2-1.5b`` with its qkv bias
and ``h2o-danube-1.8b`` with its sliding window), or with sinusoidal
positions, layernorm and a GELU MLP (``granite-20b``, multi-query); the
mixture-of-experts stacks of ``deepseek-moe-16b`` (64 routed experts top
6, 2 shared, a dense first layer) and ``dbrx-132b`` (16 experts top 4);
the uniform RWKV-6 stack of ``rwkv6-1.6b`` (trained, and served from
its recurrent state by the static engine); and two stacks on non-token
inputs: ``musicgen-medium`` (frame embeddings in place of tokens,
sinusoidal positions, layernorm, GELU) and ``qwen2-vl-2b`` (vision
embeddings over the first positions, M-RoPE); and the hybrid
``jamba-v0.1-52b`` (Mamba layers with one attention layer in eight, MoE
on every second layer; served from its conv and SSM state by the static
engine).  Every architecture of the JAX package is ported: ``LATER``,
which named the slice bringing each one still to come, is empty.
"""
from repro_torch.configs.base import (SHAPES, MambaConfig, ModelConfig,
                                      MoEConfig, ShapeConfig, reduced)
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.granite_20b import CONFIG as _granite
from repro_torch.configs.h2o_danube_1p8b import CONFIG as _danube
from repro_torch.configs.jamba_v01_52b import CONFIG as _jamba
from repro_torch.configs.llama2 import CONFIGS as _llama2
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.qwen2_1p5b import CONFIG as _qwen2
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl
from repro_torch.configs.qwen3_0p6b import CONFIG as _qwen3
from repro_torch.configs.rwkv6_1p6b import CONFIG as _rwkv6

REGISTRY = {c.name: c for c in (_qwen3, _rwkv6, _qwen2, _danube, _granite,
                                 _deepseek, _dbrx, _musicgen, _qwen2vl,
                                 _jamba)}
REGISTRY.update(_llama2)

# arch -> the later slice of the port (ROADMAP Queue 1) that brings it;
# empty since jamba-v0.1-52b, the last of them, was ported
LATER: dict = {}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k requires sub-quadratic sequence mixing (the JAX package's
    ``configs.supports_shape``)."""
    if shape.name != "long_500k":
        return True
    if cfg.mixer in ("rwkv6", "mamba"):   # ssm / hybrid: O(1)-state decode
        return True
    return cfg.sliding_window > 0          # SWA dense: window-bounded cache


def get_config(name: str) -> ModelConfig:
    if name in REGISTRY:
        return REGISTRY[name]
    if name in LATER:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; it arrives with the "
            f"'{LATER[name]}' slice of the PyTorch port (ROADMAP Queue 1). "
            f"Ported: {sorted(REGISTRY)}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")


__all__ = [
    "ModelConfig", "MoEConfig", "MambaConfig", "ShapeConfig", "SHAPES",
    "reduced", "REGISTRY", "LATER", "get_config", "supports_shape",
]
