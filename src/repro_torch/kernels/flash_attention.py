"""Flash attention for training: the hand-written CUDA forward and its two
backward kernels, their plain PyTorch versions, their launch counters, and
``FlashAttentionFn``, the autograd function that joins them.

Replaces the TPU kernels of ``src/repro/kernels/flash_attention.py``:
``_flash_kernel`` (reached from ``_flash_forward``; emits o and the
logsumexp residual) and the FlashAttention-2 backward of
``_flash_backward``, ``_flash_bwd_dq_kernel`` (q-block-major) and
``_flash_bwd_dkv_kernel`` (kv-block-major, the G query heads of a kv head
folded into its loop).  What bounds them on the H100: operations — at the
training shape each query row does ~S/2·D·4 f32 operations per ~D·4 bytes
it reads.  All three (``csrc/flash_attention.cu``) multiply on the tensor
cores (``mma.sync`` m16n8k8 TF32; f32 operands split into two TF32 parts,
"3xTF32", which keeps f32 accuracy), keep p (and ds) in registers between
their two products, and stream the next kv tile (forward, dq) or q/do
tile (dk/dv) into shared memory with ``cp.async`` while they compute.
All three skip the kv or q blocks that the causal and window bounds leave
invisible and mask the ragged edge of S themselves, so the TPU's padding
of S to a block multiple (``_dims``) does not carry over.  dk/dv
accumulate in registers across the G query heads: no atomics, the same
bits from run to run.

Layouts are the JAX package's: q (B, Sq, H, D), k/v (B, Sk, Kv, D), query
head h reads kv head h // G; ``lse`` and ``delta`` are (B, H, Sq) f32 — the
JAX kernel's grouped (B·Kv·G, Sp) with its padded columns dropped.  Query
row i sits at position ``q0`` + i and key row j at position j: self-
attention is q0 = 0 with Sq = Sk; a context-parallel rank attends its
Sq = Sk / n rows at q0 = rank · Sq against the gathered keys (the JAX
package's ``_cp_attend``), and the causal bound, the window and every
kernel's tile-skip bounds read positions.  The
kernels read rows with 16-byte copies, so their tensors must start on a
16-byte boundary (fresh allocations do).  They are compiled for the head
dims ``HEAD_DIMS``: 128; h2o-danube-1.8b's 80, whose shared tiles are
padded to 96 columns; and musicgen-medium's 64 (that of every reduced
config too); any other head dim raises on the card.

The plain versions walk blocks of positions in a Python loop with the
kernels' update: the forward ``FWD_BLOCK`` kv positions per online-softmax
step, as the kernel streams them, so both rescale at the same points; the
backward ``BLOCK`` (its kernels group the same f32 terms in tiles of 32
streamed rows).  So the card compares like with like.  They visit every
block, the kernels only the visible ones: a fully masked block is an
exact no-op of the update, so both give the same numbers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
BLOCK = 64                  # rows per block of the plain backward
FWD_BLOCK = 32              # kv rows per step of the plain forward (the
#                             kernel's streamed tile, kFwdStream)
HEAD_DIMS = (64, 80, 128)   # head dims the CUDA kernels are compiled for

# launches of the CUDA kernels (plain-version calls do not count); a
# launch at head dim 64 counts under its kernel's ``_d64`` name, and one
# with a query offset or fewer query rows than keys (a context rank's)
# under its ``_q0`` name (``counter_name``)
KERNELS = ("flash_attention", "flash_attention_dq", "flash_attention_dkv")
LAUNCHES = {f"{k}{d}{q}": 0 for d in ("", "_d64") for q in ("", "_q0")
            for k in KERNELS}


def counter_name(name, D, S=1, Sk=1, q0=0):
    """The launch counter of kernel ``name`` (one of ``KERNELS``) at head
    dim D, Sq = S query rows at offset q0 against Sk keys."""
    return (name + ("_d64" if D == 64 else "")
            + ("_q0" if q0 or S != Sk else ""))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # (B, Sq, Sk, H, Kv, D, q0, causal, window)
    **{f"flash_attn_fwd_{s}": [_P] * 5 + [_I] * 9 + [_F, _P]
       for s in ("f32", "bf16")},
    **{f"flash_attn_dq_{s}": [_P] * 7 + [_I] * 9 + [_F, _P]
       for s in ("f32", "bf16")},
    **{f"flash_attn_dkv_{s}": [_P] * 8 + [_I] * 9 + [_F, _P]
       for s in ("f32", "bf16")},
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _visible(q_pos, k_pos, causal, window):
    """(len(q_pos), len(k_pos)) mask of positions, as the kernels'
    ``visible`` (every row given here is a real one)."""
    m = torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def _grouped(q, Kv):
    B, S, H, D = q.shape
    return q.float().reshape(B, S, Kv, H // Kv, D)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def forward_plain(q, k, v, causal=True, window=0, q0=0):
    """-> (o (B, Sq, H, D) in q's type, lse (B, H, Sq) f32): an online
    softmax over the FWD_BLOCK-row kv blocks in order."""
    B, S, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = D ** -0.5
    qg = _grouped(q, Kv)
    kf, vf = k.float(), v.float()
    dev = q.device
    q_pos = q0 + torch.arange(S, device=dev)
    m = torch.full((B, Kv, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Kv, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Kv, G, S, D), dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, FWD_BLOCK):
        kb, vb = kf[:, k0:k0 + FWD_BLOCK], vf[:, k0:k0 + FWD_BLOCK]
        mask = _visible(q_pos, torch.arange(k0, k0 + kb.shape[1], device=dev),
                        causal, window)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kb) * scale
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        m = m_new
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vb)
    denom = l.clamp_min(1e-30)
    o = (acc / denom[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return o.to(q.dtype), (m + torch.log(denom)).reshape(B, H, S)


def dq_plain(q, k, v, do, lse, delta, causal=True, window=0, q0=0):
    """-> dq (B, Sq, H, D) in q's type, summed over the kv blocks in
    order."""
    B, S, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = D ** -0.5
    qg, dog = _grouped(q, Kv), _grouped(do, Kv)
    kf, vf = k.float(), v.float()
    lse_g = lse.reshape(B, Kv, G, S, 1)
    delta_g = delta.reshape(B, Kv, G, S, 1)
    dev = q.device
    q_pos = q0 + torch.arange(S, device=dev)
    dq = torch.zeros((B, Kv, G, S, D), dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, BLOCK):
        kb, vb = kf[:, k0:k0 + BLOCK], vf[:, k0:k0 + BLOCK]
        mask = _visible(q_pos, torch.arange(k0, k0 + kb.shape[1], device=dev),
                        causal, window)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kb)
        p = torch.where(mask, torch.exp(s * scale - lse_g), 0.0)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vb)
        ds = p * (dp - delta_g) * scale
        dq = dq + torch.einsum("bkgqs,bskd->bkgqd", ds, kb)
    return dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def dkv_plain(q, k, v, do, lse, delta, causal=True, window=0, q0=0):
    """-> (dk, dv) (B, Sk, Kv, D) in k's type, summed over the G query
    heads of each kv head and their q blocks in order, as the kernel
    loops."""
    B, S, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = D ** -0.5
    qg, dog = _grouped(q, Kv), _grouped(do, Kv)
    kf, vf = k.float(), v.float()
    lse_g = lse.reshape(B, Kv, G, S)
    delta_g = delta.reshape(B, Kv, G, S)
    dev = q.device
    k_pos = torch.arange(Sk, device=dev)
    dk = torch.zeros((B, Sk, Kv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for g in range(G):
        for r0 in range(0, S, BLOCK):
            qb, dob = qg[:, r0:r0 + BLOCK, :, g], dog[:, r0:r0 + BLOCK, :, g]
            n = qb.shape[1]
            mask = _visible(q0 + torch.arange(r0, r0 + n, device=dev), k_pos,
                            causal, window).t()                   # (Sk, n)
            st = torch.einsum("bskd,bqkd->bksq", kf, qb)
            p = torch.where(mask, torch.exp(
                st * scale - lse_g[:, :, g, None, r0:r0 + n]), 0.0)
            dpt = torch.einsum("bskd,bqkd->bksq", vf, dob)
            ds = p * (dpt - delta_g[:, :, g, None, r0:r0 + n]) * scale
            dv = dv + torch.einsum("bksq,bqkd->bskd", p, dob)
            dk = dk + torch.einsum("bksq,bqkd->bskd", ds, qb)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _check(q, k, v, what, q0=0):
    """Validate the kernels' inputs; -> (B, Sq, Sk, H, Kv, D)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: q (B, Sq, H, D) and k, v (B, Sk, Kv, D), "
                         f"got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, Kv, D) or H % Kv:
        raise ValueError(f"{what}: k, v must be (B={B}, Sk, Kv, D={D}) "
                         f"with Kv dividing H={H}, got {tuple(k.shape)}")
    if q0 < 0 or q0 + S > Sk:
        raise ValueError(f"{what}: query rows at q0={q0} + [0, {S}) must "
                         f"lie within the {Sk} key positions")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} has no kernel "
                         f"(compiled for {HEAD_DIMS})")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes f32/bf16 q, k, v of one type, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {dev}")
    return B, S, Sk, H, Kv, D


def _check_residuals(q, tensors, what):
    for name, t, shape, dtype in tensors:
        want = tuple(q.shape) if shape is None else shape
        if (tuple(t.shape) != want or t.dtype != (dtype or q.dtype)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous {want} "
                             f"{dtype or q.dtype} on {q.device}")


def _check_aligned(tensors, what):
    for name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte "
                             f"boundary (the kernel copies 16 bytes at a "
                             f"time)")


def _lib():
    return build.load("flash_attention", _SIGNATURES)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_cuda(q, k, v, causal=True, window=0, q0=0):
    """Launch the forward kernel; same contract as :func:`forward_plain`."""
    B, S, Sk, H, Kv, D = _check(q, k, v, "flash-attention forward", q0)
    _check_aligned((("q", q), ("k", k), ("v", v)), "flash-attention forward")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    code = getattr(lib, f"flash_attn_fwd_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, S, Sk, H, Kv, D, int(q0), int(bool(causal)),
        int(window), float(D ** -0.5), _stream(q))
    build.check(lib, "flash_attention", code, "flash-attention forward launch")
    build.count_launch(LAUNCHES, counter_name("flash_attention", D, S, Sk,
                                              q0), q.dtype)
    return o, lse


def dq_cuda(q, k, v, do, lse, delta, causal=True, window=0, q0=0):
    """Launch the dq kernel; same contract as :func:`dq_plain`."""
    B, S, Sk, H, Kv, D = _check(q, k, v, "flash-attention dq", q0)
    _check_residuals(q, (("do", do, None, None),
                         ("lse", lse, (B, H, S), torch.float32),
                         ("delta", delta, (B, H, S), torch.float32)),
                     "flash-attention dq")
    _check_aligned((("q", q), ("k", k), ("v", v), ("do", do)),
                   "flash-attention dq")
    dq = torch.empty_like(q)
    lib = _lib()
    code = getattr(lib, f"flash_attn_dq_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, Sk, H, Kv, D,
        int(q0), int(bool(causal)), int(window), float(D ** -0.5),
        _stream(q))
    build.check(lib, "flash_attention", code, "flash-attention dq launch")
    build.count_launch(LAUNCHES, counter_name("flash_attention_dq", D, S,
                                              Sk, q0), q.dtype)
    return dq


def dkv_cuda(q, k, v, do, lse, delta, causal=True, window=0, q0=0):
    """Launch the dk/dv kernel; same contract as :func:`dkv_plain`."""
    B, S, Sk, H, Kv, D = _check(q, k, v, "flash-attention dk/dv", q0)
    _check_residuals(q, (("do", do, None, None),
                         ("lse", lse, (B, H, S), torch.float32),
                         ("delta", delta, (B, H, S), torch.float32)),
                     "flash-attention dk/dv")
    _check_aligned((("q", q), ("k", k), ("v", v), ("do", do)),
                   "flash-attention dk/dv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    code = getattr(lib, f"flash_attn_dkv_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, S, Sk, H, Kv, D, int(q0), int(bool(causal)), int(window),
        float(D ** -0.5), _stream(q))
    build.check(lib, "flash_attention", code, "flash-attention dk/dv launch")
    build.count_launch(LAUNCHES, counter_name("flash_attention_dkv", D, S,
                                              Sk, q0), q.dtype)
    return dk, dv


def _fake_head_dim(q, what):
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {q.shape[-1]} has no kernel "
                         f"(compiled for {HEAD_DIMS})")


def forward_fake(q, k, v, causal=True, window=0, q0=0):
    """The forward's shape-only branch on fake tensors
    (``build.is_fake``): o and lse, empty, as the launch allocates them."""
    _fake_head_dim(q, "flash-attention forward")
    B, S, H, _ = q.shape
    return torch.empty_like(q), torch.empty((B, H, S), dtype=torch.float32,
                                            device=q.device)


def dq_fake(q, k, v, do, lse, delta, causal=True, window=0, q0=0):
    """The dq kernel's shape-only branch on fake tensors."""
    _fake_head_dim(q, "flash-attention dq")
    return torch.empty_like(q)


def dkv_fake(q, k, v, do, lse, delta, causal=True, window=0, q0=0):
    """The dk/dv kernel's shape-only branch on fake tensors."""
    _fake_head_dim(q, "flash-attention dk/dv")
    return torch.empty_like(k), torch.empty_like(v)


def attention_delta(o, do):
    """delta = rowsum(do · o) in f32 -> (B, H, S): the rowwise term of the
    softmax backward (plain PyTorch, as the JAX package leaves it to XLA)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttentionFn(torch.autograd.Function):
    """o = FlashAttentionFn.apply(q, k, v, causal, window, q0): the
    forward kernel, with the dq and dk/dv kernels as its backward (the JAX
    ``_flash`` custom_vjp).  Kernels or plain versions by q's device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q0=0):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        fwd = (forward_fake if build.is_fake(q) else
               forward_plain if build.on_cpu(q) else forward_cuda)
        o, lse = fwd(q, k, v, causal, window, q0)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.q0 = causal, window, q0
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = attention_delta(o, do)
        if build.is_fake(q):
            dq_fn, dkv_fn = dq_fake, dkv_fake
        elif build.on_cpu(q):
            dq_fn, dkv_fn = dq_plain, dkv_plain
        else:
            dq_fn, dkv_fn = dq_cuda, dkv_cuda
        dq = dq_fn(q, k, v, do, lse, delta, ctx.causal, ctx.window, ctx.q0)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, ctx.causal, ctx.window,
                        ctx.q0)
        return dq, dk, dv, None, None, None
