"""Chunked WKV-6 (the RWKV-6 data-dependent-decay recurrence): the
hand-written CUDA forward, its plain PyTorch version, its launch counter,
and ``WKV6Fn``, the autograd function around it.

Per head, with the (N, N) state S mapping key channels to value channels:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,    y_t = r_t (S_{t-1} + (u * k_t)^T v_t)

evaluated in the chunked-parallel form of ``repro.models.rwkv6.
wkv_chunked``: inside a chunk of C tokens, with lc the inclusive cumsum of
log w, qp = r·e^{lc - log w}, kp = k·e^{-lc}, y = (qp kpᵀ ∘ strict lower)·v
+ (r·u·k) v + qp·S, and the state moves on by S ← e^{lc_C} ∘ S +
(k·e^{lc_C - lc})ᵀ v.

Replaces the TPU kernel ``src/repro/kernels/rwkv6.py::_wkv_kernel``
(reached from ``_wkv6_forward``).  What bounds it on the H100: bytes at the
training shape — about 2·C·N + 4·N² f32 operations per token and head, for
4·N input values and N output values, so ~11 operations per byte at C 32
against the card's ~20 f32 operations per byte.  The kernel
(``csrc/wkv6.cu``) runs one CTA per (batch, head) with the chunk loop
inside it, the TPU's sequential minor grid axis, and keeps the (N, N) f32
state on chip from chunk to chunk: half its threads hold it in registers
and update it while the other half compute qp·S from a copy in shared
memory.  Every product runs on register tiles, and the next chunk's tiles
are copied in (``cp.async``) while the current one computes.  Each output
is summed in the same order as in the kernel's first version, so the
outputs are the same bits.  It reads r/k/v/w in their (B, T, H, N) layout
(stride H·N per token), so the TPU wrapper's transpose to (B·H, T, N) and
its padding of T are not needed: rows past T act as identity steps (w = 1,
k = 0) and write nothing.  Its 16-byte copies need r, k, v and w to start
on a 16-byte boundary (fresh allocations do).

The backward is not a kernel, as in the JAX package (``_wkv6_bwd_rule``):
``WKV6Fn`` replays :func:`wkv6_plain` from a zero state through autograd.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

HEAD_DIMS = (64,)           # head dims N the CUDA kernel is compiled for
CHUNKS = (16, 32, 64)       # chunk lengths C it is compiled for

# launches of the CUDA kernel (plain-version calls do not count)
LAUNCHES = {"wkv6": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {fn: [_P] * 7 + [_I] * 5 + [_P]
               for fn in ("wkv6_fwd_f32", "wkv6_fwd_bf16")}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def wkv6_plain(r, k, v, w, u, state=None, chunk=64):
    """r/k/v (B, T, H, N), w (B, T, H, N) (f32 in the model), u (H, N),
    state (B, H, N, N) or None (zeros) -> (y (B, T, H, N) in r's type, the
    final state (B, H, N, N) f32).  f32 inside, in the kernel's order: log,
    cumsum, then exp; T is padded to a chunk multiple with identity steps.

    The intra-chunk terms are computed for all chunks at once; only the
    state carry runs chunk by chunk.  Differentiable (the kernel's
    backward replays it)."""
    B, T, H, N = r.shape
    chunk = min(chunk, T)
    nc = -(-T // chunk)
    pad = nc * chunk - T

    def chunks(a, fill=0.0):           # -> (B, H, nc, C, N) f32
        a = a.float().transpose(1, 2)
        if pad:
            a = F.pad(a, (0, 0, 0, pad), value=fill)
        return a.reshape(B, H, nc, chunk, N)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    wc = chunks(w, 1.0)
    lw = torch.log(torch.clamp_min(wc, 1e-12))
    lc = torch.cumsum(lw, dim=3)                        # inclusive
    qp = rc * torch.exp(lc - lw)
    kp = kc * torch.exp(-lc)
    tri = torch.ones(chunk, chunk, device=r.device).tril(-1)
    A = (qp @ kp.transpose(-1, -2)) * tri               # strictly lower
    diag = (rc * u.float()[None, :, None, None, :] * kc).sum(-1, keepdim=True)
    y_in = A @ vc + diag * vc
    lc_tot = lc[..., -1:, :]                            # (B, H, nc, 1, N)
    kv = (kc * torch.exp(lc_tot - lc)).transpose(-1, -2) @ vc
    decay = torch.exp(lc_tot).transpose(-1, -2)         # (B, H, nc, N, 1)
    S = (torch.zeros(B, H, N, N, device=r.device) if state is None
         else state.float())
    starts = []
    for c in range(nc):
        starts.append(S)
        S = decay[:, :, c] * S + kv[:, :, c]
    y = y_in + qp @ torch.stack(starts, dim=2)
    y = y.reshape(B, H, nc * chunk, N)[:, :, :T].transpose(1, 2)
    return y.to(r.dtype), S


def _check(r, k, v, w, u, chunk):
    what = "wkv6 kernel"
    if r.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {r.device}")
    if r.dim() != 4:
        raise ValueError(f"{what}: r must be (B, T, H, N), got "
                         f"{tuple(r.shape)}")
    B, T, H, N = r.shape
    if N not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {N} has no kernel (compiled for "
                         f"{HEAD_DIMS})")
    if chunk not in CHUNKS:
        raise ValueError(f"{what}: chunk {chunk} has no kernel (compiled for "
                         f"{CHUNKS})")
    if r.dtype not in _SUFFIX or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"{what} takes f32/bf16 r, k, v of one type, got "
                        f"{r.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if tuple(t.shape) != (B, T, H, N) or t.device != r.device:
            raise ValueError(f"{what}: {name} must be {(B, T, H, N)} on "
                             f"{r.device}, got {tuple(t.shape)} on {t.device}")
    if tuple(u.shape) != (H, N) or u.device != r.device:
        raise ValueError(f"{what}: u must be ({H}, {N}) on {r.device}")
    return B, T, H, N


def wkv6_cuda(r, k, v, w, u, chunk=64):
    """Launch the kernel from a zero state; same contract as
    :func:`wkv6_plain` with ``state=None``.  w and u are read as f32.
    Raises on anything it does not take."""
    B, T, H, N = _check(r, k, v, w, u, chunk)
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    w32 = w.to(torch.float32).contiguous()
    u32 = u.to(torch.float32).contiguous()
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w32)):
        if t.data_ptr() % 16:
            raise ValueError(f"wkv6 kernel: {name} must start on a 16-byte "
                             f"boundary (the kernel copies 16 bytes at a "
                             f"time)")
    y = torch.empty_like(r)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    lib = build.load("wkv6", _SIGNATURES)
    code = getattr(lib, f"wkv6_fwd_{_SUFFIX[r.dtype]}")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w32.data_ptr(),
        u32.data_ptr(), y.data_ptr(), state.data_ptr(), B, T, H, N, chunk,
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, "wkv6", code, "wkv6 kernel launch")
    build.count_launch(LAUNCHES, "wkv6", r.dtype)
    return y, state


def wkv6_fake(r, k, v, w, u, chunk=64):
    """The kernel's shape-only branch on fake tensors (``build.is_fake``):
    y and the final state, empty, as the launch allocates them, beside
    the f32 copies of w and u it reads."""
    B, T, H, N = r.shape
    if N not in HEAD_DIMS or chunk not in CHUNKS:
        raise ValueError(f"wkv6 kernel: head dim {N}, chunk {chunk} has no "
                         f"kernel (compiled for {HEAD_DIMS}, {CHUNKS})")
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    w32 = w.to(torch.float32).contiguous()
    u32 = u.to(torch.float32).contiguous()
    y = torch.empty_like(r)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    del w32, u32                  # held until the launch returns, as there
    return y, state


class WKV6Fn(torch.autograd.Function):
    """y, state = WKV6Fn.apply(r, k, v, w, u, chunk), from a zero state.

    The kernel on a CUDA tensor, :func:`wkv6_plain` on a CPU one,
    :func:`wkv6_fake` on a fake one.  The
    backward re-runs :func:`wkv6_plain` on the saved inputs under autograd
    (the JAX ``_wkv6_bwd_rule``); either cotangent may be None."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        if build.is_fake(r):
            y, state = wkv6_fake(r, k, v, w, u, chunk)
        elif build.on_cpu(r):
            y, state = wkv6_plain(r, k, v, w, u, None, chunk)
        else:
            y, state = wkv6_cuda(r, k, v, w, u, chunk)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        pairs = [(i, g) for i, g in enumerate((dy, dstate)) if g is not None]
        if not pairs:
            return (None,) * 6
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = wkv6_plain(*leaves, None, ctx.chunk)
            grads = torch.autograd.grad([outs[i] for i, _ in pairs], leaves,
                                        [g for _, g in pairs])
        return (*grads, None)
