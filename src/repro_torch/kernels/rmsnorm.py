"""RMSNorm forward: the hand-written CUDA kernel, its plain PyTorch version,
and the kernel's launch counter.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py::_rmsnorm_kernel``
(reached from ``_rmsnorm_forward``).  What bounds it on the H100: bytes —
one read of x and one write of y per element, a few f32 operations each.
The kernel (``csrc/rmsnorm.cu``) runs one CTA per row, reads the row once
from device memory (the scale pass re-reads it from cache), accumulates in
f32 and masks the ragged edge of any width, so the TPU's ``d % 128`` lane
rule does not carry over.  Like the TPU kernel it also writes the per-row
``rstd`` for the backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel (plain-version calls do not count)
LAUNCHES = {"rmsnorm": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {fn: [_P, _P, _P, _P, _I, _I, _F, _P]
               for fn in ("rmsnorm_fwd_f32", "rmsnorm_fwd_bf16")}
_ENTRY = {torch.float32: "rmsnorm_fwd_f32", torch.bfloat16: "rmsnorm_fwd_bf16"}


def rmsnorm_plain(x2, scale, eps):
    """x2 (n, d) -> (y (n, d) in x2.dtype, rstd (n,) f32), f32 inside."""
    xf = x2.float()
    rstd = torch.rsqrt((xf * xf).mean(-1) + eps)
    return (xf * rstd[:, None] * scale.float()).to(x2.dtype), rstd


def rmsnorm_cuda(x2, scale, eps):
    """Launch the kernel on x2 (n, d) contiguous f32/bf16 on a CUDA device
    and scale (d,); -> (y, rstd).  Raises on anything it does not take."""
    if x2.device.type != "cuda":
        raise ValueError(f"rmsnorm_cuda needs a CUDA tensor, got {x2.device}")
    if x2.dtype not in _ENTRY:
        raise TypeError(f"rmsnorm kernel takes f32/bf16, got {x2.dtype}")
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"rmsnorm kernel needs a contiguous (n, d) input, "
                         f"got shape {tuple(x2.shape)}")
    n, d = x2.shape
    if scale.shape != (d,) or scale.device != x2.device:
        raise ValueError(f"scale must be ({d},) on {x2.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    s32 = scale.to(torch.float32).contiguous()
    y = torch.empty_like(x2)
    rstd = torch.empty((n,), dtype=torch.float32, device=x2.device)
    lib = build.load("rmsnorm", _SIGNATURES)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    code = getattr(lib, _ENTRY[x2.dtype])(
        x2.data_ptr(), s32.data_ptr(), y.data_ptr(), rstd.data_ptr(),
        n, d, float(eps), stream)
    build.check(lib, "rmsnorm", code, "rmsnorm kernel launch")
    LAUNCHES["rmsnorm"] += 1
    return y, rstd
