"""Plain PyTorch oracles, in the layouts of the JAX package's
``kernels/ref.py``: attention is (B, S, H, D) with GQA via
n_kv_heads | n_heads; paged pools are (P, bs, Kv, D).

These are the correctness ground truth the kernels' plain versions (beside
each kernel, in the kernel's own order of arithmetic) are held against.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


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
