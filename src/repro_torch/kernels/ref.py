"""Plain PyTorch oracles, in the layouts of the JAX package's
``kernels/ref.py``: attention is (B, S, H, D) with GQA via
n_kv_heads | n_heads; paged pools are (P, bs, Kv, D); the WKV-6 state is
(B, H, N, N), key channel by value channel.

These are the correctness ground truth the kernels' plain versions (beside
each kernel, in the kernel's own order of arithmetic) are held against.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=0):
    """q (B, Sq, H, D), k/v (B, Skv, Kv, D) -> (B, Sq, H, D); f32 softmax."""
    B, Sq, H, D = q.shape
    Kv = k.shape[2]
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * (D ** -0.5)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, tbl, ctx, *, window=0):
    """Decode attention over a paged KV cache (f32 softmax oracle).

    q (B, 1, H, D) one query token per request; k_pool/v_pool
    (P, bs, Kv, D) shared block pools; tbl (B, max_blocks) int32 block
    table (-1 = unallocated); ctx (B,) int32 valid KV positions per
    request (the query sits at position ctx[b] - 1).  Position p of
    request b lives at pool slot (tbl[b, p // bs], p % bs).
    """
    B, Sq, H, D = q.shape
    P, bs, Kv, _ = k_pool.shape
    G = H // Kv
    nb = tbl.shape[1]
    safe = tbl.clamp(0, P - 1).long()
    k = k_pool[safe].reshape(B, nb * bs, Kv, D)          # (B, Skv, Kv, D)
    v = v_pool[safe].reshape(B, nb * bs, Kv, D)
    k_pos = torch.arange(nb * bs, device=q.device)
    valid = (k_pos[None] < ctx[:, None]) & \
        (tbl >= 0).repeat_interleave(bs, dim=1)          # (B, Skv)
    if window:
        valid &= k_pos[None] > (ctx[:, None] - 1 - window)
    qg = q.reshape(B, Sq, Kv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * (D ** -0.5)
    s = torch.where(valid[:, None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def rmsnorm_ref(x, scale, eps=1e-6):
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def wkv6_ref(r, k, v, w, u, state):
    """Sequential RWKV-6 recurrence (f32), one token at a time.

    r/k/v/w (B, T, H, N); u (H, N); state (B, H, N, N) mapping key channel
    -> value channel.  -> (y (B, T, H, N) f32, final state f32)."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    S = state.float()
    uk = u.float()[None]
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = torch.einsum("bhn,bhm->bhnm", k_t, v_t)
        ys.append(torch.einsum("bhn,bhnm->bhm", r_t, S)
                  + torch.einsum("bhn,bhn,bhm->bhm", r_t, uk * k_t, v_t))
        S = w_t[..., None] * S + kv
    return torch.stack(ys, dim=1), S
