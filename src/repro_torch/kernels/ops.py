"""Public wrappers for the port's kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version (that is how
the tests run here).  A tensor on a CUDA device launches the kernel, or the
launch raises: there is no fallback from the card to the plain version.
Model code reaches these through ``Runtime.norm_impl == "kernel"`` /
``Runtime.attn_impl == "kernel"``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import rmsnorm as _rms


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def rmsnorm_forward(x, scale, *, eps=1e-6):
    """x (..., d), scale (d,) -> (rmsnorm(x) * scale, rstd (n,) f32)."""
    x2 = x.reshape(-1, x.shape[-1])
    fn = _rms.rmsnorm_plain if _on_cpu(x) else _rms.rmsnorm_cuda
    y, rstd = fn(x2, scale, eps)
    return y.reshape(x.shape), rstd


def rmsnorm(x, scale, *, eps=1e-6):
    return rmsnorm_forward(x, scale, eps=eps)[0]


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
    return {**_rms.LAUNCHES, **_fd.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_rms.LAUNCHES, _fd.LAUNCHES):
        for k in counts:
            counts[k] = 0
