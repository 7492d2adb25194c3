"""Flash-decode over a paged KV cache: the hand-written CUDA split and
combine kernels, their plain PyTorch versions, and their launch counters.

Replaces the TPU kernel ``src/repro/kernels/flash_decode.py::_decode_kernel``
(reached from ``flash_decode``) and the jnp logsumexp merge after it
(``flash_decode.py:147-153``).  What bounds it on the H100: bytes — decode
reads each cached K/V element once for one query token, 2·G operations per
element.  The split kernel (``csrc/flash_decode.cu``) runs one CTA of
``DECODE_WARPS`` warps per (request·kv head, K-split) and stops at the
request's last valid position.  Each warp takes its own chunks of
``DECODE_CHUNK`` positions (chunk c of the split goes to warp c %
``DECODE_WARPS``), reads each K and V row once as one coalesced warp load
for all G query heads of its kv head, and keeps its own online softmax
(m, l, acc) in registers, updated once per chunk; the warps' states are
merged in warp order into the split's f32 partial (acc, m, l).  The
combine kernel merges the splits and writes (B, 1, H, D) in q's type.
Registers bound the shapes the split takes — G ≤ ``MAX_G``, D ≤ ``MAX_D``
— and shared memory the merge, ``split_smem_bytes``; not the TPU's
``head_dim % 8`` rule.

The plain versions repeat the kernel's arithmetic in its order: the same
split plan, the same chunks per warp and online-softmax update per chunk,
the same merge across warps, then across splits.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

NEG_INF = -1e30
DECODE_WARPS = 8          # warps per split CTA, each with its own softmax
DECODE_CHUNK = 8          # positions a warp takes per step
MAX_G = 16                # query heads per kv head the kernel holds
MAX_D = 256               # head dim the kernel holds (8 values a lane)

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


def split_smem_bytes(G: int, D: int) -> int:
    """Shared memory of one split CTA: q, then every warp's (acc, m, l)."""
    return (G * D + DECODE_WARPS * G * (D + 2)) * 4


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def split_plain(q, k_pool, v_pool, tbl, ctx, n_splits):
    """-> partials acc (B*Kv, splits, G, D), m and l (B*Kv, splits, G), f32,
    in the kernel's order: split s covers positions s·bps·bs .. + bps·bs
    - 1; its chunk c of ``DECODE_CHUNK`` positions belongs to warp c %
    ``DECODE_WARPS``, which updates its own (m, l, acc) once per chunk; then
    the warps are merged in order."""
    B, _, H, D = q.shape
    P, bs, Kv, _ = k_pool.shape
    G = H // Kv
    nb = tbl.shape[1]
    splits, bps = plan_splits(nb, n_splits)
    W, U = DECODE_WARPS, DECODE_CHUNK
    span = bps * bs                          # positions per split
    rounds = -(-span // (W * U))
    dev = q.device
    s_i = torch.arange(splits, device=dev)[:, None, None]
    w_i = torch.arange(W, device=dev)[None, :, None]
    u_i = torch.arange(U, device=dev)[None, None, :]
    # entries < 0 clamp to block 0; positions past the table read block 0
    reach = ((splits - 1) * span + rounds * W * U - 1) // bs + 1
    safe = F.pad(tbl.clamp(0, P - 1).long(), (0, max(reach - nb, 0)))
    qg = q.reshape(B, Kv, G, D).float()
    m = torch.full((B, Kv, splits, W, G), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Kv, splits, W, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Kv, splits, W, G, D), dtype=torch.float32,
                      device=dev)
    for r in range(rounds):
        off = (r * W + w_i) * U + u_i                       # (1, W, U)
        pos = s_i * span + off                              # (splits, W, U)
        live = (off < span) & (pos[None] < ctx[:, None, None, None])
        blk = safe[:, pos // bs]                            # (B, splits, W, U)
        k = k_pool[blk, pos % bs].float()           # (B, splits, W, U, Kv, D)
        v = v_pool[blk, pos % bs].float()
        mask = live[:, None, :, :, None, :]         # (B, 1, splits, W, 1, U)
        sc = torch.einsum("bkgd,bswukd->bkswgu", qg, k) * (D ** -0.5)
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        m = m_new
        acc = acc * alpha[..., None] + torch.einsum("bkswgu,bswukd->bkswgd",
                                                    p, v)
    m_cta = m.amax(3)                               # merge the warps in order
    e = torch.exp(m - m_cta[:, :, :, None])
    acc = (acc * e[..., None]).sum(3)
    l = (l * e).sum(3)
    return (acc.reshape(B * Kv, splits, G, D),
            m_cta.reshape(B * Kv, splits, G), l.reshape(B * Kv, splits, G))


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
    if G > MAX_G or D > MAX_D:
        raise ValueError(f"flash-decode split holds G <= MAX_G {MAX_G} query "
                         f"heads per kv head and head dim D <= MAX_D {MAX_D} "
                         f"in registers, got G={G}, D={D}")
    if split_smem_bytes(G, D) > build.SMEM_LIMIT:
        raise ValueError(f"G={G}, D={D} needs {split_smem_bytes(G, D)} B of "
                         f"shared memory per CTA (limit {build.SMEM_LIMIT})")
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
