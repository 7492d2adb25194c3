"""Attention: GQA with RoPE, qk-norm and qkv-bias, over a paged KV cache or
over the whole sequence with no cache — the paged and cache-less branches
of the JAX package's ``models/attention.py``.

All functions are batch-first: q (B, Sq, H, D), k/v (B, Skv, Kv, D).  Pools
are (P + 1, bs, Kv, D): block P is a *sink* that no table entry points to.
Writes that the JAX package drops (``mode="drop"``: unallocated blocks,
positions past the table, the 1 << 30 position of an inactive decode slot)
land there instead, which keeps them on the device with no mask-and-sync.

Without a cache (training), ``sdpa_causal`` runs the flash-attention
kernels for ``Runtime.attn_impl == "kernel"`` (any S; a head dim they are
not compiled for raises on the card), else dense masked attention up to
``attn_min_chunked_len`` positions and an online softmax over (q, kv)
chunks beyond.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
# cache-less path (training: q/k/v cover positions 0..S-1)
# ---------------------------------------------------------------------------

def _mask(q_pos, k_pos, window):
    """(..., Sq, Skv) boolean: causal (+ sliding window) visibility."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def _attend_dense(q, k, v, q_pos, k_pos, window, scale):
    """q (B,Sq,H,D), k/v (B,Skv,Kv,D); q_pos (Sq,), k_pos (Skv,)."""
    B, Sq, H, D = q.shape
    Kv = k.shape[2]
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    logits = torch.where(_mask(q_pos, k_pos, window), logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, D)


def _blocked_q_chunk(qblk, k, v, q0, window, scale, kv_chunk):
    """One q chunk (B, qc, Kv, G, D) against every kv chunk with a running
    (max, denom, acc) -> (B, qc, Kv * G, D) in q's type."""
    B, qc, Kv, G, D = qblk.shape
    dev = qblk.device
    q_pos = q0 + torch.arange(qc, device=dev)
    m = torch.full((B, Kv, G, qc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Kv, G, qc), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Kv, G, qc, D), dtype=torch.float32, device=dev)
    for k0 in range(0, k.shape[1], kv_chunk):
        kblk, vblk = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
        k_pos = k0 + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk).float() * scale
        s = torch.where(_mask(q_pos, k_pos, window), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(vblk.dtype), vblk).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(qblk.dtype).permute(0, 3, 1, 2, 4).reshape(B, qc, Kv * G, D)


def _attend_blocked(q, k, v, window, scale, q_chunk, kv_chunk):
    """Causal self-attention, q_pos == k_pos == arange(S), in (q, kv)
    chunks with an online softmax; each q chunk is recomputed in the
    backward (``jax.checkpoint`` in the JAX package).  Sequence lengths
    that are not a multiple of the chunks are padded to the next common
    multiple: the causal mask hides padded kv positions from every real
    row, and padded rows are sliced off."""
    B, S, H, D = q.shape
    Kv = k.shape[2]
    G = H // Kv
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, S)
    mult = math.lcm(q_chunk, kv_chunk)
    Sp = -(-S // mult) * mult
    if Sp != S:
        pad = (0, 0, 0, 0, 0, Sp - S)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    outs = []
    for q0 in range(0, Sp, q_chunk):
        qblk = q[:, q0:q0 + q_chunk].reshape(B, q_chunk, Kv, G, D)
        outs.append(checkpoint(_blocked_q_chunk, qblk, k, v, q0, window,
                               scale, kv_chunk, use_reentrant=False))
    return torch.cat(outs, dim=1)[:, :S]


def sdpa_causal(q, k, v, window=0, rt: Runtime = None):
    """Self-attention where q/k/v cover the same positions 0..S-1."""
    rt = rt or Runtime()
    S, D = q.shape[1], q.shape[-1]
    scale = D ** -0.5
    if rt.attn_impl == "kernel":
        # flash-attention kernels (forward + backward), for any S: the
        # TPU's gate S >= 128 and D % 64 == 0 is a tiling rule of its own
        return kernel_ops.attention(q, k, v, window=window)
    if S <= rt.attn_min_chunked_len:
        pos = torch.arange(S, device=q.device)
        return _attend_dense(q, k, v, pos, pos, window, scale)
    return _attend_blocked(q, k, v, window, scale, rt.attn_q_chunk,
                           rt.attn_kv_chunk)


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
                    want_cache: bool = False, paged=None):
    """Attention sublayer: x (B, S, d) -> (B, S, d).

    Train:         cache None -> causal self-attention over positions
                   0..S-1 (``sdpa_causal``).
    Paged serving: cache {'k_pool','v_pool'} + paged {'tbl','ctx'} —
                   chunked prefill (S > 1) and decode (S == 1) both append
                   at the request's ctx and attend over its block chain.
    """
    if want_cache or (cache is not None and paged is None):
        raise NotImplementedError(
            "the port has no dense KV cache yet: prefill into and decode "
            "from a static cache come with the static-engine slice "
            "(ROADMAP Queue 1)")
    if paged is not None and cache is None:
        raise ValueError("paged attention needs the layer's pools (cache)")
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, rt)
    if rope_ang is not None:
        q = apply_rope(q, rope_ang)
        k = apply_rope(k, rope_ang)
    if paged is not None:
        out = _paged_attention_block(cfg, q, k, v, cache, paged, rt)
    else:
        # context parallelism (the JAX _cp_attend) comes with its slice
        # (ROADMAP Queue 1, "other mixers and inputs")
        out = sdpa_causal(q, k, v, cfg.sliding_window, rt)
    return out.reshape(B, S, -1) @ p["wo"].to(out.dtype)
