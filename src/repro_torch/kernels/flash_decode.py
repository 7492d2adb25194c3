"""Flash-decode over a paged KV cache: the hand-written CUDA kernel, its
plain PyTorch version, and its launch counter.

Replaces the TPU kernel ``src/repro/kernels/flash_decode.py::_decode_kernel``
(reached from ``flash_decode``) and the jnp logsumexp merge after it
(``flash_decode.py:147-153``), in one launch.  What bounds it on the H100:
bytes — decode reads each cached K/V element once for one query token,
2·G operations per element.  The kernel (``csrc/flash_decode.cu``) runs one
thread-block cluster of C = min(splits, ``MAX_CLUSTER``) CTAs of
``DECODE_WARPS`` warps per (request, kv head, head tile): the G query heads
of a kv head are cut into ``ceil(G / MAX_G)`` tiles of at most ``MAX_G``
(:func:`head_tile`; granite-20b's G 48 is three tiles of 16, each
re-reading the kv head's rows); the CTA of rank r takes the
K-splits r, r + C, ... and stops at the request's last valid position.
Within a split each warp takes its own chunks of ``DECODE_CHUNK``
positions (chunk c of the split goes to warp c % ``DECODE_WARPS``), reads
each K and V row once as one coalesced warp load for all G query heads of
its kv head, and keeps its own online softmax (m, l, acc) in registers,
updated once per chunk; the warps' states are merged in warp order into
the split's state, which stays in the CTA's shared memory.  Rank 0 of the
cluster then reads every split's state through distributed shared memory,
merges them in split order and writes (B, 1, H, D) in q's type: the
partials never reach device memory.  Registers bound a CTA's tile —
at most ``MAX_G`` heads, D ≤ ``MAX_D`` — and shared memory the splits a CTA
holds, ``decode_smem_bytes``; not the TPU's ``head_dim % 8`` rule.  Any G
that divides the heads goes, as in the JAX kernel.

The plain versions repeat the kernel's arithmetic in its order: the same
split plan, the same chunks per warp and online-softmax update per chunk,
the same merge across warps, then across splits.  Heads never meet in it,
so the head tiles need no counterpart there.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

NEG_INF = -1e30
DECODE_WARPS = 8          # warps per CTA, each with its own softmax
DECODE_CHUNK = 8          # positions a warp takes per step
MAX_G = 16                # query heads a CTA holds (a head tile)
MAX_D = 256               # head dim the kernel holds (8 values a lane)
MAX_CLUSTER = 4           # CTAs per cluster, at most
NO_CLUSTER_FITS = -1      # the launch's code when no cluster fits the card

# launches of the CUDA kernel (plain-version calls do not count)
LAUNCHES = {"flash_decode": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {fn: [_P] * 6 + [_I] * 9 + [_F, _P]
               for fn in ("flash_decode_f32", "flash_decode_bf16")}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def plan_splits(nb: int, n_splits: int):
    """-> (splits, blocks per split), as the TPU kernel plans them."""
    splits = max(1, min(n_splits, nb))
    return splits, -(-nb // splits)


def head_tile(G: int) -> int:
    """Query heads per CTA for G per kv head: G cut into ceil(G / MAX_G)
    tiles as even as they come (the kernel's ``head_tile``)."""
    n = -(-G // MAX_G)
    return -(-G // n)


def decode_smem_bytes(G: int, D: int, splits: int) -> int:
    """Shared memory of one CTA for G query heads per kv head: its head
    tile's q, every warp's (acc, m, l), then the (acc, m, l) of each of the
    ceil(splits / C) splits the CTA holds."""
    C = min(splits, MAX_CLUSTER)
    Gt = head_tile(G)
    return (Gt * D + (DECODE_WARPS + -(-splits // C)) * Gt * (D + 2)) * 4


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


def decode_plain(q, k_pool, v_pool, tbl, ctx, n_splits):
    """The kernel's function: -> (B, 1, H, D) in q's type."""
    out = combine_plain(*split_plain(q, k_pool, v_pool, tbl, ctx, n_splits))
    return out.to(q.dtype).reshape(q.shape)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def decode_cuda(q, k_pool, v_pool, tbl, ctx, n_splits):
    """Launch the kernel; same contract as :func:`decode_plain`.  Raises on
    anything it does not take."""
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
    if D > MAX_D:
        raise ValueError(f"flash-decode holds head dim D <= MAX_D {MAX_D} "
                         f"in registers, got D={D}")
    splits, bps = plan_splits(nb, n_splits)
    smem = decode_smem_bytes(G, D, splits)
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"flash-decode G={G}, D={D}, {splits} splits needs "
                         f"{smem} B of shared memory per CTA (SMEM_LIMIT "
                         f"{build.SMEM_LIMIT})")
    out = torch.empty_like(q)
    lib = build.load("flash_decode", _SIGNATURES)
    code = getattr(lib, f"flash_decode_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(),
        ctx.data_ptr(), out.data_ptr(), B, Kv, G, D, P, bs, nb, splits, bps,
        float(D ** -0.5), torch.cuda.current_stream(dev).cuda_stream)
    if code == NO_CLUSTER_FITS:
        raise ValueError(f"flash-decode: no cluster of "
                         f"{min(splits, MAX_CLUSTER)} CTAs with {smem} B of "
                         f"shared memory each fits on "
                         f"{torch.cuda.get_device_name(dev)} (G={G}, D={D}, "
                         f"{splits} splits)")
    build.check(lib, "flash_decode", code, "flash-decode launch")
    build.count_launch(LAUNCHES, "flash_decode", q.dtype)
    return out
