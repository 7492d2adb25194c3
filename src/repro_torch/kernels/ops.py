"""Public wrappers for the port's kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version (that is how
the tests run here).  A tensor on a CUDA device launches the kernel, or the
launch raises: there is no fallback from the card to the plain version.
Model code reaches these through ``Runtime.norm_impl == "kernel"`` /
``Runtime.attn_impl == "kernel"``.  ``rmsnorm`` and ``attention`` are
differentiable on both devices: their backward is a kernel too.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels.build import on_cpu as _on_cpu

_COUNTERS = (_rms.LAUNCHES, _fd.LAUNCHES, _fa.LAUNCHES)


def rmsnorm_forward(x, scale, *, eps=1e-6):
    """x (..., d), scale (d,) -> (rmsnorm(x) * scale, rstd (n,) f32)."""
    return _rms.RMSNormFn.apply(x, scale, eps)


def rmsnorm(x, scale, *, eps=1e-6):
    return rmsnorm_forward(x, scale, eps=eps)[0]


def attention(q, k, v, *, causal=True, window=0):
    """Self-attention over positions 0..S-1: q (B, S, H, D), k/v
    (B, S, Kv, D) with Kv | H -> (B, S, H, D) in q's type.  The CUDA
    kernels take head dims ``flash_attention.HEAD_DIMS`` and raise for
    any other."""
    return _fa.FlashAttentionFn.apply(q, k, v, causal, window)


def paged_decode_attention(q, k_pool, v_pool, tbl, ctx, *, n_splits=4):
    """Flash-decode over a paged KV cache.  q (B, 1, H, D); pools
    (P, bs, Kv, D); tbl (B, max_blocks) int32; ctx (B,) int32 valid
    positions per request -> (B, 1, H, D) in q's type."""
    if _on_cpu(q):
        acc, m, l = _fd.split_plain(q, k_pool, v_pool, tbl, ctx, n_splits)
        out = _fd.combine_plain(acc, m, l).to(q.dtype)
    else:
        acc, m, l = _fd.split_cuda(q, k_pool, v_pool, tbl, ctx, n_splits)
        out = _fd.combine_cuda(acc, m, l, q.dtype)
    return out.reshape(q.shape)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0
