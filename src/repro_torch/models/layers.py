"""Shared building blocks: norms, rotary embeddings, the gated MLP,
embeddings — the port of the JAX package's ``models/layers.py``.

Functions take parameter dicts (or ``nn.ParameterDict``s) of tensors, in
the JAX package's layouts: projection weights are (in, out) and applied as
``x @ W``.  Initialisers draw from an explicit ``torch.Generator`` on an
explicit device, with the JAX package's distributions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Numerics and implementation choice (orthogonal to ModelConfig).

    ``"kernel"`` routes RMSNorm, training attention, paged decode
    attention and the cache-less WKV-6 through the hand-written kernels
    (their plain versions on CPU tensors); ``"torch"`` keeps the plain
    PyTorch layer code
    everywhere.  The chunk sizes shape the plain cache-less attention:
    sequences up to ``attn_min_chunked_len`` attend densely, longer ones
    in (q, kv) chunks with an online softmax.  ``rwkv_chunk`` is the
    chunk length of the WKV-6 recurrence, on the kernel and the plain path
    alike (it is part of the result: it sets the order of rounding).

    The dtypes are a precision policy's (``core.parallel.make_runtime``):
    parameters are stored in ``param_dtype`` (the master copy, f32 in
    every policy), activations and products run in ``compute_dtype``,
    gradients accumulate in ``grad_dtype``.  ``gather_dtype``, when set
    (the fp8 policy on a plan that shards parameters), is the wire dtype
    of each layer's gathered parameters: every floating leaf is rounded
    through it to ``compute_dtype`` before the layer computes
    (:func:`wire_round`).
    """
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    grad_dtype: torch.dtype = torch.float32
    gather_dtype: Optional[torch.dtype] = None
    attn_impl: str = "kernel"           # 'kernel' | 'torch'
    norm_impl: str = "kernel"           # 'kernel' | 'torch'
    attn_q_chunk: int = 1024            # query chunk for blocked attention
    attn_kv_chunk: int = 1024           # kv chunk for blocked attention
    attn_min_chunked_len: int = 2048    # below this, plain masked attention
    rwkv_chunk: int = 64                # WKV-6 chunk length


class _WireRound(torch.autograd.Function):
    """y = x -> wire dtype -> out dtype; the cotangent passes straight
    through in x's dtype.  (The JAX package's transposes of the two casts
    round the cotangent back through the same dtypes; that rounding is
    elementwise, so it is applied to the gradient once it is summed over
    the batch and the data-parallel ranks: :func:`wire_round_grad`.)"""

    @staticmethod
    def forward(ctx, x, wire, out):
        ctx.dtype = x.dtype
        return x.to(wire).to(out)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


def wire_round(tree, wire: torch.dtype, out: torch.dtype):
    """A (nested) dict of parameters -> the same dict with each floating
    leaf rounded through ``wire`` to ``out``: the values a layer computes
    from after an all-gather in ``wire`` (the JAX package's
    ``make_param_gatherer`` with a ``comm_dtype``)."""
    return {k: wire_round(v, wire, out) if isinstance(v, (dict, nn.Module))
            else (_WireRound.apply(v, wire, out) if v.is_floating_point()
                  else v)
            for k, v in tree.items()}


def wire_round_grad(g: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The gradient of a parameter that went through :func:`wire_round`,
    summed over a microbatch, as the JAX package's transposes leave it:
    rounded through ``compute_dtype`` and ``gather_dtype`` back to its own
    dtype."""
    return g.to(rt.compute_dtype).to(rt.gather_dtype).to(g.dtype)


def _randn(gen, shape, scale, device):
    return torch.randn(shape, generator=gen, device=device) * scale


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg, device, d=None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.ones(d, device=device)}


def apply_norm(p, x, eps, rt: Runtime = None):
    if rt is not None and rt.norm_impl == "kernel" and "bias" not in p:
        # RMSNorm kernel; layernorm stays on the plain path.  Any width d
        # works: the kernel masks the ragged edge itself.
        return kernel_ops.rmsnorm(x, p["scale"], eps=eps)
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:            # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_norm_headwise(scale, x, eps):
    """Per-head q/k RMSNorm (Qwen3). x: (..., head_dim); f32 inside, cast
    back at the end."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (half-split llama layout)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions, head_dim, theta):
    """positions: (..., S) int -> angles (..., S, head_dim//2) f32."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions.float()[..., None] * inv


def apply_rope(x, angles):
    """x: (B, S, H, D); angles: (B, S, D//2).  Rotates (x[i], x[i + D/2])
    pairs laid out as two halves; cos/sin are cast to x's type first."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def init_embed(cfg, gen, device):
    p = {"tok": _randn(gen, (cfg.vocab_size, cfg.d_model), 0.02, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _randn(gen, (cfg.d_model, cfg.vocab_size),
                              cfg.d_model ** -0.5, device)
    return p


def embed_tokens(p, tokens, rt: Runtime):
    # gather, then cast: the same values as casting the table first
    return F.embedding(tokens, p["tok"]).to(rt.compute_dtype)


def lm_logits(p, h, rt: Runtime):
    if "lm_head" in p:
        w = p["lm_head"].to(rt.compute_dtype)
    else:
        w = p["tok"].to(rt.compute_dtype).t()
    # mixed types promote, as jnp.einsum does (an RWKV-6 stack's residual
    # stream leaves its layers in f32)
    ct = torch.promote_types(h.dtype, w.dtype)
    return h.to(ct) @ w.to(ct)


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU / GELU / relu^2)
# ---------------------------------------------------------------------------

def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu
            "relu2": lambda x: torch.square(F.relu(x))}[name]


def init_mlp(cfg, gen, device, d_ff=None):
    d, dff = cfg.d_model, d_ff or (cfg.dense_d_ff or cfg.d_ff)
    p = {"w_up": _randn(gen, (d, dff), d ** -0.5, device),
         "w_down": _randn(gen, (dff, d), dff ** -0.5, device)}
    if cfg.glu:
        p["w_gate"] = _randn(gen, (d, dff), d ** -0.5, device)
    return p


def apply_mlp(cfg, p, x, rt: Runtime):
    act = _act(cfg.act)
    up = x @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        h = act(x @ p["w_gate"].to(x.dtype)) * up
    else:
        h = act(up)
    return h @ p["w_down"].to(x.dtype)
