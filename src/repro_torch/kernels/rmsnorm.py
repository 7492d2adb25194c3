"""RMSNorm forward and backward: the hand-written CUDA kernels, their plain
PyTorch versions, the kernels' launch counters, and ``RMSNormFn``, the
autograd function that joins them.

Forward: replaces the TPU kernel ``src/repro/kernels/rmsnorm.py::
_rmsnorm_kernel`` (reached from ``_rmsnorm_forward``).  What bounds it on
the H100: bytes — one read of x and one write of y per element, a few f32
operations each.  The kernel (``csrc/rmsnorm.cu``) holds a row in the
registers of one warp (a team of up to 16 warps for rows wider than 1024),
loaded once as 16-byte vectors, sums its squares in f32 with warp shuffles
and writes y from the same registers; several rows per CTA keep many rows
in flight on each SM.  Any width runs: a ragged d (or an unaligned
pointer) takes scalar loads over the same columns, so the TPU's ``d % 128``
lane rule does not carry over, and rows wider than a 16-warp team holds are
walked in slices and read a second time for the scale pass.  Like the TPU
kernel it also writes the per-row ``rstd`` for the backward.

Backward: replaces ``_rmsnorm_bwd_kernel`` (reached from
``_rmsnorm_backward``).  Bound: bytes again (x and g read, dx written).
One warp holds a row of up to 1024 columns in registers (a group of up to
16 warps holds a wider one), reads x and g once as 16-byte vectors, and
sums the row with warp shuffles; each CTA of ``BWD_ROWS`` rows writes one
dscale partial, and a second kernel sums the partials in a fixed order
(warp slot ``p % BWD_REDUCE_WARPS``, then the slots), so dscale has the
same bits on every launch — no atomics.  The TPU kernel instead sums
``dscale`` in an output block its sequential grid revisits.

``RMSNormFn`` saves (x, scale, rstd) from the forward, as the JAX
``custom_vjp`` does, and runs the backward kernel: on a CUDA tensor both
directions are kernels; on a CPU tensor both are the plain versions.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# launches of the CUDA kernels (plain-version calls do not count); one
# backward launch is its row kernel followed by the partials' reduce
LAUNCHES = {"rmsnorm": 0, "rmsnorm_bwd": 0}

BWD_ROWS = 16             # rows per CTA of the backward: one dscale partial
BWD_REDUCE_WARPS = 32     # warp slots of the partials' reduce
BWD_MAX_D = 16 * 32 * 32  # 16 warps of 32 lanes hold a row, 32 values a lane

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    **{fn: [_P, _P, _P, _P, _I, _I, _F, _P]
       for fn in ("rmsnorm_fwd_f32", "rmsnorm_fwd_bf16")},
    **{fn: [_P] * 7 + [_I, _I, _P]
       for fn in ("rmsnorm_bwd_f32", "rmsnorm_bwd_bf16")},
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def rmsnorm_plain(x2, scale, eps):
    """x2 (n, d) -> (y (n, d) in x2.dtype, rstd (n,) f32), f32 inside."""
    xf = x2.float()
    rstd = torch.rsqrt((xf * xf).mean(-1) + eps)
    return (xf * rstd[:, None] * scale.float()).to(x2.dtype), rstd


def rmsnorm_bwd_plain(x2, scale, rstd, g2):
    """x2, g2 (n, d), scale (d,), rstd (n,) f32 -> (dx (n, d) in x2.dtype,
    dscale (d,) f32), in the kernel's order: per-row c = mean(g·s·x), and
    dscale as partial sums over ``BWD_ROWS`` rows, then partial p added into
    slot ``p % BWD_REDUCE_WARPS``, then the slots in order."""
    n, d = x2.shape
    xf, gf = x2.float(), g2.float()
    r = rstd[:, None]
    gs = gf * scale.float()
    c = (gs * xf).sum(-1, keepdim=True) / d
    dx = r * (gs - xf * (r * r) * c)
    parts = F.pad(gf * xf * r, (0, 0, 0, (-n) % BWD_ROWS))
    parts = parts.reshape(-1, BWD_ROWS, d).sum(1)
    parts = F.pad(parts, (0, 0, 0, (-parts.shape[0]) % BWD_REDUCE_WARPS))
    dscale = parts.reshape(-1, BWD_REDUCE_WARPS, d).sum(0).sum(0)
    return dx.to(x2.dtype), dscale


def _check(x2, scale, what):
    if x2.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x2.device}")
    if x2.dtype not in _SUFFIX:
        raise TypeError(f"{what} takes f32/bf16, got {x2.dtype}")
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"{what} needs a contiguous (n, d) input, "
                         f"got shape {tuple(x2.shape)}")
    d = x2.shape[1]
    if scale.shape != (d,) or scale.device != x2.device:
        raise ValueError(f"scale must be ({d},) on {x2.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    return scale.to(torch.float32).contiguous()


def rmsnorm_cuda(x2, scale, eps):
    """Launch the kernel on x2 (n, d) contiguous f32/bf16 on a CUDA device
    and scale (d,); -> (y, rstd).  Raises on anything it does not take."""
    s32 = _check(x2, scale, "rmsnorm kernel")
    n, d = x2.shape
    y = torch.empty_like(x2)
    rstd = torch.empty((n,), dtype=torch.float32, device=x2.device)
    lib = build.load("rmsnorm", _SIGNATURES)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    code = getattr(lib, f"rmsnorm_fwd_{_SUFFIX[x2.dtype]}")(
        x2.data_ptr(), s32.data_ptr(), y.data_ptr(), rstd.data_ptr(),
        n, d, float(eps), stream)
    build.check(lib, "rmsnorm", code, "rmsnorm kernel launch")
    build.count_launch(LAUNCHES, "rmsnorm", x2.dtype)
    return y, rstd


def rmsnorm_bwd_cuda(x2, scale, rstd, g2):
    """Launch the backward on CUDA tensors; same contract as
    :func:`rmsnorm_bwd_plain`.  Raises on anything it does not take."""
    s32 = _check(x2, scale, "rmsnorm backward kernel")
    n, d = x2.shape
    if g2.shape != x2.shape or g2.dtype != x2.dtype or g2.device != x2.device \
            or not g2.is_contiguous():
        raise ValueError(f"g must be contiguous {tuple(x2.shape)} "
                         f"{x2.dtype} on {x2.device}")
    if rstd.shape != (n,) or rstd.dtype != torch.float32 \
            or rstd.device != x2.device:
        raise ValueError(f"rstd must be ({n},) f32 on {x2.device}")
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm backward holds a row in the registers of "
                         f"at most 16 warps: d {d} > BWD_MAX_D {BWD_MAX_D}")
    dx = torch.empty_like(x2)
    partial = torch.empty((-(-n // BWD_ROWS), d), dtype=torch.float32,
                          device=x2.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x2.device)
    rstd = rstd.contiguous()
    lib = build.load("rmsnorm", _SIGNATURES)
    code = getattr(lib, f"rmsnorm_bwd_{_SUFFIX[x2.dtype]}")(
        x2.data_ptr(), s32.data_ptr(), rstd.data_ptr(), g2.data_ptr(),
        dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(), n, d,
        torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(lib, "rmsnorm", code, "rmsnorm backward launch")
    build.count_launch(LAUNCHES, "rmsnorm_bwd", x2.dtype)
    return dx, dscale


def rmsnorm_fake(x2, scale, eps):
    """The forward's shape-only branch on fake tensors: the launch's
    outputs, empty (``build.is_fake``)."""
    return (torch.empty_like(x2),
            torch.empty((x2.shape[0],), dtype=torch.float32,
                        device=x2.device))


def rmsnorm_bwd_fake(x2, scale, rstd, g2):
    """The backward's shape-only branch on fake tensors: dx, the 16-row
    partials the launch allocates, and dscale, empty."""
    n, d = x2.shape
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm backward holds a row in the registers of "
                         f"at most 16 warps: d {d} > BWD_MAX_D {BWD_MAX_D}")
    dx = torch.empty_like(x2)
    partial = torch.empty((-(-n // BWD_ROWS), d), dtype=torch.float32,
                          device=x2.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x2.device)
    del partial                   # held until the launch returns, as there
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """y, rstd = RMSNormFn.apply(x, scale, eps); x (..., d), scale (d,).

    rstd (n,) f32 is returned for the tests and is not differentiable.
    The kernel or the plain version is chosen by x's device."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        fwd = (rmsnorm_fake if build.is_fake(x) else
               rmsnorm_plain if build.on_cpu(x) else rmsnorm_cuda)
        y, rstd = fwd(x2, scale, eps)
        ctx.save_for_backward(x2, scale, rstd)
        ctx.mark_non_differentiable(rstd)
        return y.reshape(x.shape), rstd

    @staticmethod
    def backward(ctx, gy, _grstd):
        x2, scale, rstd = ctx.saved_tensors
        g2 = gy.reshape(x2.shape).to(x2.dtype).contiguous()
        bwd = (rmsnorm_bwd_fake if build.is_fake(x2) else
               rmsnorm_bwd_plain if build.on_cpu(x2) else rmsnorm_bwd_cuda)
        dx, dscale = bwd(x2, scale, rstd, g2)
        return dx.reshape(gy.shape), dscale.to(scale.dtype), None
