"""Attention over a paged KV cache: GQA with RoPE, qk-norm and qkv-bias —
the paged branch of the JAX package's ``models/attention.py``.

All functions are batch-first: q (B, Sq, H, D), k/v (B, Skv, Kv, D).  Pools
are (P + 1, bs, Kv, D): block P is a *sink* that no table entry points to.
Writes that the JAX package drops (``mode="drop"``: unallocated blocks,
positions past the table, the 1 << 30 position of an inactive decode slot)
land there instead, which keeps them on the device with no mask-and-sync.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import Runtime, apply_rope, rms_norm_headwise

NEG_INF = -1e30


def init_attention(cfg, gen, device):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim_
    s = d ** -0.5

    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    p = {
        "wq": randn((d, h * hd), s),
        "wk": randn((d, kv * hd), s),
        "wv": randn((d, kv * hd), s),
        "wo": randn((h * hd, d), (h * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, device=device)
        p["bk"] = torch.zeros(kv * hd, device=device)
        p["bv"] = torch.zeros(kv * hd, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, device=device)
        p["k_norm"] = torch.ones(hd, device=device)
    return p


# ---------------------------------------------------------------------------
# paged KV cache path (serving: shared block pools + per-request tables)
# ---------------------------------------------------------------------------

def _paged_write(pool, vals, tbl, pos):
    """Scatter vals (B, S, Kv, D) into pool (P + 1, bs, Kv, D) at absolute
    positions pos (B, S) via the block table tbl (B, max_blocks), in place
    (the pool is the largest tensor of the step; a copy per layer would
    double its traffic).

    Position p of request b lands at (tbl[b, p // bs], p % bs).  Writes
    to unallocated blocks (tbl -1) or past the table go to the sink block
    P — this is what makes inactive slots in a fixed-shape decode batch
    harmless: their sentinel positions fall outside any allocated block.
    """
    sink, bs = pool.shape[0] - 1, pool.shape[1]
    nb = tbl.shape[1]
    blk_log = pos // bs
    blk = torch.gather(tbl, 1, blk_log.clamp(0, nb - 1).long())
    blk = torch.where((blk < 0) | (blk_log >= nb), sink, blk)
    off = pos % bs
    B, S = pos.shape
    pool.index_put_((blk.reshape(-1).long(), off.reshape(-1).long()),
                    vals.reshape((B * S,) + vals.shape[2:]).to(pool.dtype))
    return pool


def _paged_attend(q, k_pool, v_pool, tbl, q_pos, n_valid, window=0):
    """Attention over pool-gathered KV with per-request positions (the plain
    path; the flash-decode kernel replaces it for decode).

    q (B, Sq, H, D) at absolute positions q_pos (B, Sq); n_valid (B,)
    counts KV entries present per request (the just-written chunk
    included), so both chunked prefill (Sq > 1) and decode (Sq == 1) are
    the same computation.  Scores and softmax are f32; the weights are cast
    to v's type before the PV product.
    """
    P, bs, Kv, D = k_pool.shape
    B, Sq = q_pos.shape
    nb = tbl.shape[1]
    safe = tbl.clamp(0, P - 1).long()
    k = k_pool[safe].reshape(B, nb * bs, Kv, D)
    v = v_pool[safe].reshape(B, nb * bs, Kv, D)
    k_pos = torch.arange(nb * bs, device=q.device)[None].expand(B, nb * bs)
    valid = (k_pos < n_valid[:, None]) & \
        (tbl >= 0).repeat_interleave(bs, dim=1)
    mask = valid[:, None, :] & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        mask &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    G = q.shape[2] // Kv
    qg = q.reshape(B, Sq, Kv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * (D ** -0.5)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, Kv * G, D)


def _paged_attention_block(cfg, q, k, v, cache, paged, rt: Runtime):
    """Write the new chunk into the layer's pools and attend against the
    request's full paged context.  cache: {'k_pool', 'v_pool'} (updated in
    place); paged: {'tbl' (B, max_blocks), 'ctx' (B,)} shared across layers
    (the engine advances ctx between steps — layers only read it)."""
    S = q.shape[1]
    tbl, ctx = paged["tbl"], paged["ctx"]
    pos = ctx[:, None] + torch.arange(S, dtype=torch.int32,
                                      device=ctx.device)[None]   # (B, S)
    k_pool = _paged_write(cache["k_pool"], k, tbl, pos)
    v_pool = _paged_write(cache["v_pool"], v, tbl, pos)
    n_valid = ctx + S
    if S == 1 and rt.attn_impl == "kernel" and not cfg.sliding_window:
        # flash-decode kernel: its shared memory, not head_dim, bounds the
        # shapes it takes (kernels/flash_decode.py)
        return kernel_ops.paged_decode_attention(q, k_pool, v_pool, tbl,
                                                 n_valid)
    return _paged_attend(q, k_pool, v_pool, tbl, pos, n_valid,
                         cfg.sliding_window)


# ---------------------------------------------------------------------------
# full attention block (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------

def _project_qkv(cfg, p, x, rt: Runtime):
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim_
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm_headwise(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def attention_block(cfg, p, x, rope_ang, rt: Runtime, cache=None,
                    paged=None):
    """Paged attention sublayer: x (B, S, d); cache {'k_pool','v_pool'} +
    paged {'tbl','ctx'} — chunked prefill (S > 1) and decode (S == 1) both
    append at the request's ctx and attend over its block chain."""
    if paged is None or cache is None:
        raise NotImplementedError(
            "the port's attention runs over a paged cache only; the "
            "cache-less and dense-cache paths come with the static-engine "
            "slice (ROADMAP Queue 1)")
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, rt)
    if rope_ang is not None:
        q = apply_rope(q, rope_ang)
        k = apply_rope(k, rope_ang)
    out = _paged_attention_block(cfg, q, k, v, cache, paged, rt)
    return out.reshape(B, S, -1) @ p["wo"].to(out.dtype)
