"""Flash-decode over a paged KV cache: the hand-written CUDA split and
combine kernels, their plain PyTorch versions, and their launch counters.

Replaces the TPU kernel ``src/repro/kernels/flash_decode.py::_decode_kernel``
(reached from ``flash_decode``) and the jnp logsumexp merge after it
(``flash_decode.py:147-153``).  What bounds it on the H100: bytes — decode
reads each cached K/V element once for one query token, 2·G operations per
element.  The split kernel (``csrc/flash_decode.cu``) runs one CTA per
(request·kv head, K-split): it reads its block ids from the table itself
(the TPU's scalar-prefetch index map), loads each pool block once for all
G query heads of its kv head, stops at the request's last valid block,
and writes an f32 partial (acc, m, l); the combine kernel merges the splits
and writes (B, 1, H, D) in q's type.  Shared memory bounds the shapes it
takes — (2·G·D + 2·bs·D + G·bs + 3·G)·4 bytes per CTA — not the TPU's
``head_dim % 8`` rule.

The plain versions repeat the kernel's arithmetic in its order: the same
split plan, the same per-block online-softmax update, the same merge.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

NEG_INF = -1e30

# launches of the CUDA kernels (plain-version calls do not count)
LAUNCHES = {"flash_decode": 0, "flash_decode_combine": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    **{fn: [_P] * 8 + [_I] * 9 + [_F, _P]
       for fn in ("flash_decode_split_f32", "flash_decode_split_bf16")},
    **{fn: [_P] * 4 + [_I] * 4 + [_P]
       for fn in ("flash_decode_combine_f32", "flash_decode_combine_bf16")},
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def plan_splits(nb: int, n_splits: int):
    """-> (splits, blocks per split), as the TPU kernel plans them."""
    splits = max(1, min(n_splits, nb))
    return splits, -(-nb // splits)


def split_smem_bytes(G: int, D: int, bs: int) -> int:
    return (2 * G * D + 2 * bs * D + G * bs + 3 * G) * 4


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def split_plain(q, k_pool, v_pool, tbl, ctx, n_splits):
    """-> partials acc (B*Kv, splits, G, D), m and l (B*Kv, splits, G), f32,
    walking each split's blocks in order with the kernel's update."""
    B, _, H, D = q.shape
    P, bs, Kv, _ = k_pool.shape
    G = H // Kv
    nb = tbl.shape[1]
    splits, bps = plan_splits(nb, n_splits)
    safe = tbl.clamp(0, P - 1).long()
    if splits * bps != nb:                  # padded tail entries read block 0
        safe = F.pad(safe, (0, splits * bps - nb))
    blk = safe.reshape(B, splits, bps)
    qg = q.reshape(B, Kv, G, D).float()
    dev = q.device
    m = torch.full((B, Kv, splits, G), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Kv, splits, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Kv, splits, G, D), dtype=torch.float32, device=dev)
    first = torch.arange(splits, device=dev)[:, None] * bps * bs \
        + torch.arange(bs, device=dev)[None]                    # (splits, bs)
    for j in range(bps):
        k = k_pool[blk[:, :, j]].float()             # (B, splits, bs, Kv, D)
        v = v_pool[blk[:, :, j]].float()
        sc = torch.einsum("bkgd,bstkd->bksgt", qg, k) * (D ** -0.5)
        k_pos = first + j * bs
        mask = (k_pos[None] < ctx[:, None, None])[:, None, :, None, :]
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        m = m_new
        acc = acc * alpha[..., None] + torch.einsum("bksgt,bstkd->bksgd", p, v)
    return (acc.reshape(B * Kv, splits, G, D), m.reshape(B * Kv, splits, G),
            l.reshape(B * Kv, splits, G))


def combine_plain(acc, m, l):
    """Logsumexp merge of the splits' partials -> (B*Kv, G, D) f32."""
    m_max = m.amax(1, keepdim=True)
    alpha = torch.exp(m - m_max)
    l_tot = (l * alpha).sum(1)
    out = (acc * alpha[..., None]).sum(1)
    return out / l_tot.clamp_min(1e-30)[..., None]


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _lib():
    return build.load("flash_decode", _SIGNATURES)


def split_cuda(q, k_pool, v_pool, tbl, ctx, n_splits):
    """Launch the split kernel; same contract as :func:`split_plain`."""
    B, Sq, H, D = q.shape
    P, bs, Kv, Dk = k_pool.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash-decode kernel needs CUDA tensors, got {dev}")
    if Sq != 1 or H % Kv or Dk != D or v_pool.shape != k_pool.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if q.dtype not in _SUFFIX or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"flash-decode takes f32/bf16 q and pools of one "
                        f"type, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if tbl.dtype != torch.int32 or ctx.dtype != torch.int32 \
            or tbl.dim() != 2 or tbl.shape[0] != B or ctx.shape != (B,):
        raise TypeError(f"tbl (B, nb) and ctx (B,) must be int32, got "
                        f"{tbl.dtype}{tuple(tbl.shape)} "
                        f"{ctx.dtype}{tuple(ctx.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tbl", tbl), ("ctx", ctx)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    G = H // Kv
    nb = tbl.shape[1]
    if split_smem_bytes(G, D, bs) > build.SMEM_LIMIT:
        raise ValueError(f"G={G}, D={D}, bs={bs} needs "
                         f"{split_smem_bytes(G, D, bs)} B of shared memory "
                         f"per CTA (limit {build.SMEM_LIMIT})")
    splits, bps = plan_splits(nb, n_splits)
    acc = torch.empty((B * Kv, splits, G, D), dtype=torch.float32, device=dev)
    m = torch.empty((B * Kv, splits, G), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    lib = _lib()
    code = getattr(lib, f"flash_decode_split_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(),
        ctx.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, Kv, G, D, P, bs, nb, splits, bps, float(D ** -0.5),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "flash_decode", code, "flash-decode split launch")
    LAUNCHES["flash_decode"] += 1
    return acc, m, l


def combine_cuda(acc, m, l, out_dtype):
    """Launch the combine kernel -> (B*Kv, G, D) in ``out_dtype``."""
    BKv, splits, G, D = acc.shape
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"combine kernel needs CUDA tensors, got {dev}")
    if out_dtype not in _SUFFIX:
        raise TypeError(f"combine writes f32/bf16, got {out_dtype}")
    for name, t, shape in (("acc", acc, (BKv, splits, G, D)),
                           ("m", m, (BKv, splits, G)),
                           ("l", l, (BKv, splits, G))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 {shape} on {dev}")
    out = torch.empty((BKv, G, D), dtype=out_dtype, device=dev)
    lib = _lib()
    code = getattr(lib, f"flash_decode_combine_{_SUFFIX[out_dtype]}")(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
        BKv, splits, G, D, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "flash_decode", code, "flash-decode combine launch")
    LAUNCHES["flash_decode_combine"] += 1
    return out
