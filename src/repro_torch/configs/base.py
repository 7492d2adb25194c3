"""Model / shape configuration dataclasses.

A copy of the JAX package's ``configs/base.py`` (the port never imports that
package): every architecture is a ``ModelConfig``; the decoder in
``repro_torch.models.transformer`` consumes it.  The four assigned input
shapes are ``ShapeConfig`` instances in ``SHAPES``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    top_k: int = 1
    n_shared_experts: int = 0       # always-on shared experts (DeepSeek-MoE)
    expert_d_ff: int = 0            # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_jitter: float = 0.0
    # which layers are MoE: layer i is MoE iff i >= start and (i - start) % every == 0
    moe_start_layer: int = 0
    moe_every: int = 1


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: int = 0             # 0 -> = n_heads (MHA)
    head_dim: int = 0               # 0 -> d_model // n_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0         # 0 -> full causal attention
    attn_logit_softcap: float = 0.0

    # mixer layout: 'attn' | 'rwkv6' | 'mamba'; hybrids interleave.
    mixer: str = "attn"
    attn_every: int = 1             # hybrid: layer i is attention iff (i+1) % attn_every == 0
                                    # (Jamba: attn_every=8 -> layers 7,15,23,31)

    # position information
    rope: str = "rope"              # 'rope' | 'mrope' | 'none'
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    pos_embed: str = "none"         # 'none' | 'sinusoidal' (musicgen)

    # FFN
    act: str = "silu"
    glu: bool = True                # SwiGLU-style gated FFN
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    dense_d_ff: int = 0             # d_ff for the dense (non-MoE) layers, 0 -> d_ff

    # norm / embeddings
    norm: str = "rmsnorm"           # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # SSM blocks
    mamba: MambaConfig = dataclasses.field(default_factory=MambaConfig)
    rwkv_head_dim: int = 64

    # modality frontend: 'tokens' | 'embeddings' (audio: precomputed frame
    # embeddings) | 'tokens+vision' (VLM: token ids + precomputed patch embeds)
    input_mode: str = "tokens"
    vision_tokens: int = 0          # VLM: number of patch embeddings per example

    source: str = ""                # provenance citation

    # ---- derived ----
    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def layer_kind(self, i: int) -> str:
        """Mixer kind for layer i."""
        if self.mixer == "attn":
            return "attn"
        if self.mixer in ("rwkv6", "mamba") and self.attn_every <= 1:
            return self.mixer
        # hybrid: every `attn_every`-th layer (1-indexed) is attention
        return "attn" if (i + 1) % self.attn_every == 0 else self.mixer

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        if m.n_experts == 0 or i < m.moe_start_layer:
            return False
        return (i - m.moe_start_layer) % m.moe_every == 0

    def param_count(self) -> int:
        """Exact parameter count (embeddings included once if tied)."""
        d, hd = self.d_model, self.head_dim_
        total = self.vocab_size * d            # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d       # lm head
        total += d                             # final norm
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            total += d                          # pre-mixer norm
            if kind == "attn":
                q = d * self.n_heads * hd
                kv = 2 * d * self.kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.kv_heads) * hd
                if self.qk_norm:
                    total += 2 * hd
            elif kind == "rwkv6":
                # r,k,v,g,o projections + decay/mix params (approx faithful)
                total += 5 * d * d + 8 * d + 2 * (d // 16) * d + self.rwkv_heads * self.rwkv_head_dim
            elif kind == "mamba":
                di = self.mamba.expand * d
                dtr = self.mamba.dt_rank or -(-d // 16)
                total += d * 2 * di                      # in_proj
                total += di * self.mamba.d_conv + di     # conv
                total += di * (dtr + 2 * self.mamba.d_state)  # x_proj
                total += dtr * di + di                   # dt_proj
                total += di * self.mamba.d_state + di    # A_log, D
                total += di * d                          # out_proj
            # FFN
            total += d                          # pre-ffn norm
            mult = 3 if self.glu else 2
            if self.is_moe_layer(i):
                m = self.moe
                total += m.n_experts * mult * d * m.expert_d_ff
                total += m.n_shared_experts * mult * d * m.expert_d_ff
                total += d * m.n_experts        # router
            else:
                dff = self.dense_d_ff or self.d_ff
                if kind == "rwkv6":
                    total += 2 * d * dff + 2 * d  # rwkv channel-mix (r, k, v=dff)
                else:
                    total += mult * d * dff
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE: only top-k + shared experts)."""
        if self.moe.n_experts == 0:
            return self.param_count()
        m = self.moe
        mult = 3 if self.glu else 2
        inactive_experts = m.n_experts - m.top_k
        n_moe_layers = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        return self.param_count() - n_moe_layers * inactive_experts * mult * self.d_model * m.expert_d_ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 256,
            max_experts: int = 4) -> ModelConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    n_heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.kv_heads, n_heads))
    while n_heads % kv:
        kv -= 1
    head_dim = d_model // n_heads
    moe = cfg.moe
    if moe.n_experts:
        moe = dataclasses.replace(
            moe, n_experts=min(moe.n_experts, max_experts),
            top_k=min(moe.top_k, 2), expert_d_ff=d_model * 2,
            moe_start_layer=min(moe.moe_start_layer, 1), moe_every=1)
    attn_every = cfg.attn_every
    if attn_every > 1:
        attn_every = 2      # hybrid smoke keeps >=1 of each mixer kind
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=kv,
        head_dim=head_dim, d_ff=d_model * 3, dense_d_ff=0,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        attn_every=attn_every,
        moe=moe,
        mrope_sections=(head_dim // 2 - 2 * (head_dim // 6), head_dim // 6, head_dim // 6)
        if cfg.rope == "mrope" else cfg.mrope_sections,
        rwkv_head_dim=min(cfg.rwkv_head_dim, d_model // 2),
        vision_tokens=min(cfg.vision_tokens, 16),
    )
