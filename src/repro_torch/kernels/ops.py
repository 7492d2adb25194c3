"""Public wrappers for the port's kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version (that is how
the tests run here).  A tensor on a CUDA device launches the kernel, or the
launch raises: there is no fallback from the card to the plain version.  A
fake tensor (the dry run's ``FakeTensorMode``) takes each kernel's
shape-only branch: its outputs, allocated as the launch allocates them,
and no launch (``build.is_fake``).
Model code reaches these through ``Runtime.norm_impl == "kernel"`` /
``Runtime.attn_impl == "kernel"``.  ``rmsnorm`` and ``attention`` are
differentiable on both devices: their backward is a kernel too.  ``wkv6``
is differentiable as well; its backward replays the plain chunked version
through autograd, as the JAX package's does.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import wkv6 as _wkv
from repro_torch.kernels.build import is_fake as _is_fake
from repro_torch.kernels.build import on_cpu as _on_cpu

_COUNTERS = (_rms.LAUNCHES, _fd.LAUNCHES, _fa.LAUNCHES, _wkv.LAUNCHES)


def rmsnorm_forward(x, scale, *, eps=1e-6):
    """x (..., d), scale (d,) -> (rmsnorm(x) * scale, rstd (n,) f32)."""
    return _rms.RMSNormFn.apply(x, scale, eps)


def rmsnorm(x, scale, *, eps=1e-6):
    return rmsnorm_forward(x, scale, eps=eps)[0]


def attention(q, k, v, *, causal=True, window=0, q0=0):
    """Attention of q (B, Sq, H, D) at positions q0..q0+Sq-1 over k/v
    (B, Sk, Kv, D) at positions 0..Sk-1, with Kv | H -> (B, Sq, H, D) in
    q's type (self-attention: q0 = 0, Sq = Sk).  The CUDA kernels take
    head dims ``flash_attention.HEAD_DIMS`` and raise for any other."""
    return _fa.FlashAttentionFn.apply(q, k, v, causal, window, q0)


def paged_decode_attention(q, k_pool, v_pool, tbl, ctx, *, n_splits=4):
    """Flash-decode over a paged KV cache.  q (B, 1, H, D); pools
    (P, bs, Kv, D); tbl (B, max_blocks) int32; ctx (B,) int32 valid
    positions per request -> (B, 1, H, D) in q's type."""
    if _is_fake(q):
        return torch.empty_like(q)
    decode = _fd.decode_plain if _on_cpu(q) else _fd.decode_cuda
    return decode(q, k_pool, v_pool, tbl, ctx, n_splits)


def wkv6(r, k, v, w, u, *, chunk=64):
    """Chunked WKV-6 from a zero state: r/k/v (B, T, H, N), w (B, T, H, N)
    f32, u (H, N) -> (y (B, T, H, N) in r's type, final state (B, H, N, N)
    f32).  The CUDA kernel takes N in ``wkv6.HEAD_DIMS`` and chunk in
    ``wkv6.CHUNKS`` and raises for any other."""
    return _wkv.WKV6Fn.apply(r, k, v, w, u, chunk)


def launch_counts(dtype=None) -> Dict[str, int]:
    """Kernel launches so far, by kernel: all of them, or (``dtype``
    ``torch.bfloat16``) those on bf16 tensors."""
    counts = {k: v for c in _COUNTERS for k, v in c.items()}
    if dtype is None:
        return counts
    if dtype != torch.bfloat16:
        raise ValueError(f"launches are kept by dtype for bf16 only, not "
                         f"{dtype}")
    return {k: _build.BF16_LAUNCHES.get(k, 0) for k in counts}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0
    _build.BF16_LAUNCHES.clear()
