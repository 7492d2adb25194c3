"""Attention: GQA with RoPE, qk-norm and qkv-bias, over a dense or a paged
KV cache or over the whole sequence with no cache — the port of the JAX
package's ``models/attention.py``.

All functions are batch-first: q (B, Sq, H, D), k/v (B, Skv, Kv, D).  Pools
are (P + 1, bs, Kv, D): block P is a *sink* that no table entry points to.
Writes that the JAX package drops (``mode="drop"``: unallocated blocks,
positions past the table, the 1 << 30 position of an inactive decode slot)
land there instead, which keeps them on the device with no mask-and-sync.

A dense cache (static serving) holds one slot per position, (B, Sc, Kv,
D) with the position in each slot (``kpos``, -1 for an empty one) and the
next position (``idx``, a 0-d tensor on the device: the slot a decode step
writes is found there, with no host sync).  A sliding-window model keeps a
ring of ``min(seq_len, window)`` slots, position p at slot p % Sc.  Under
a plan the cache is sharded along Sc (``core.parallel.cache_shardings``):
each rank holds every KV head of its own slots, a decode step writes the
new token on the rank that owns its slot, and each rank's partial softmax
over its slots is merged over the cache axes by log-sum-exp, as
flash-decode merges its splits.  The dense decode attention is plain
PyTorch, as the JAX package's is (``sdpa_decode``).

Without a cache (training), ``sdpa_causal`` runs the flash-attention
kernels for ``Runtime.attn_impl == "kernel"`` (any S; a head dim they are
not compiled for raises on the card), else dense masked attention up to
``attn_min_chunked_len`` positions and an online softmax over (q, kv)
chunks beyond.

Under a context plan (``layers.context_parallel``) a rank holds the
contiguous positions [r S_loc, (r + 1) S_loc) of the sequence: it
projects its own q, k and v (RoPE at those positions), gathers K and V
over the group (the backward reduce-scatters dK and dV) and attends its
queries at the offset q0 = r S_loc against every key (:func:`cp_attend`,
the JAX package's ``_cp_attend``): the flash kernels take the offset, the
plain path is ``_attend_dense`` at offset positions.  Prefilling a dense
cache does the same and writes the gathered K/V into this rank's slots.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import (CacheLeaf, Runtime, all_reduce,
                                       apply_rope, cp_gather, gather_heads,
                                       head_parallel, rms_norm_headwise,
                                       tp_enter, tp_exit)

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


def cp_attend(q, k, v, window, rt: Runtime):
    """A context rank's attention: q/k/v (B, S_loc, ., D) of its positions
    [r S_loc, (r + 1) S_loc); K and V gathered over ``rt.tp_group`` ->
    (out (B, S_loc, H, D), the gathered K, V)."""
    S_loc = q.shape[1]
    k_all, v_all = cp_gather(k, rt), cp_gather(v, rt)
    q0 = rt.tp_rank * S_loc
    if rt.attn_impl == "kernel":
        out = kernel_ops.attention(q, k_all, v_all, window=window, q0=q0)
    else:
        dev = q.device
        out = _attend_dense(q, k_all, v_all,
                            q0 + torch.arange(S_loc, device=dev),
                            torch.arange(k_all.shape[1], device=dev),
                            window, q.shape[-1] ** -0.5)
    return out, k_all, v_all


# ---------------------------------------------------------------------------
# dense KV cache path (static serving: one slot per position)
# ---------------------------------------------------------------------------

def cache_slots(cfg, seq_len: int) -> int:
    """Slots of a dense cache for ``seq_len`` positions: a sliding-window
    model keeps a ring of ``min(seq_len, window)``."""
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window \
        else seq_len


def kv_cache_leaves(cfg, batch, seq_len, dtype):
    """A dense cache's leaves, unallocated: {'k', 'v' (batch, Sc, Kv, D),
    'kpos' (Sc,) int32, 'idx' 0-d int32}."""
    size = cache_slots(cfg, seq_len)
    kv = CacheLeaf((batch, size, cfg.kv_heads, cfg.head_dim_), dtype)
    return {"k": kv, "v": kv, "kpos": CacheLeaf((size,), torch.int32),
            "idx": CacheLeaf((), torch.int32)}


def make_kv_cache(cfg, batch, seq_len, dtype, device):
    """Empty cache: :func:`kv_cache_leaves` as zeros, ``kpos`` all -1
    (every slot empty)."""
    cache = {k: torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
             for k, leaf in kv_cache_leaves(cfg, batch, seq_len,
                                            dtype).items()}
    cache["kpos"].fill_(-1)
    return cache


def prefill_kv_cache(cache, k, v, shard: int = 0):
    """Write a whole prefix k/v (B, S, Kv, D) into a fresh cache, in place.

    Slot j takes position j; when the prompt is at least as long as the
    ring (S >= Sc) the cache keeps the last Sc positions, position p at
    slot p % Sc (the JAX package rolls them into that layout).  A cache
    sharded along its slots holds slots [shard n, (shard + 1) n) of Sc
    (``kpos``' length), n its own ``k``'s; ``kpos`` and ``idx`` stay
    whole.  Every index is known on the host: no sync."""
    S = k.shape[1]
    Sc, n = cache["kpos"].shape[0], cache["k"].shape[1]
    lo, dev = shard * n, k.device
    slots = torch.arange(Sc, dtype=torch.int32, device=dev)
    if S >= Sc:
        kpos = S - Sc + torch.remainder(slots - (S - Sc), Sc)
        src = kpos[lo:lo + n].long()
        cache["k"].copy_(k.index_select(1, src))
        cache["v"].copy_(v.index_select(1, src))
    else:
        kpos = torch.where(slots < S, slots, -1)
        m = max(0, min(S, lo + n) - lo)
        cache["k"][:, :m] = k[:, lo:lo + m]
        cache["v"][:, :m] = v[:, lo:lo + m]
    cache["kpos"].copy_(kpos)
    cache["idx"].fill_(S)
    return cache


def _decode_write(cache, k, v, shard: int):
    """Write one token's k/v (B, 1, Kv, D) at slot ``idx % Sc``, in place.
    Of a sharded cache only the rank owning the slot writes it: every
    rank rewrites a slot of its own, with the new values where it owns the
    token's slot and its old ones elsewhere (no host sync)."""
    idx = cache["idx"]
    Sc, n = cache["kpos"].shape[0], cache["k"].shape[1]
    slot = (idx % Sc).view(1)
    cache["kpos"].index_copy_(0, slot.long(), idx.view(1))
    kc, vc = cache["k"], cache["v"]
    k, v = k.to(kc.dtype), v.to(vc.dtype)
    if n == Sc:
        kc.index_copy_(1, slot.long(), k)
        vc.index_copy_(1, slot.long(), v)
        return
    local = slot - shard * n
    owned = ((local >= 0) & (local < n)).view(1, 1, 1, 1)
    at = local.clamp(0, n - 1).long()
    kc.index_copy_(1, at, torch.where(owned, k, kc.index_select(1, at)))
    vc.index_copy_(1, at, torch.where(owned, v, vc.index_select(1, at)))


def _visible(k_pos, cur_pos, window):
    valid = (k_pos >= 0) & (k_pos <= cur_pos)
    if window:
        valid &= k_pos > (cur_pos - window)
    return valid


def sdpa_decode(q, k_cache, v_cache, k_pos, cur_pos, window=0):
    """One-token decode: q (B, 1, H, D) against cache (B, Sc, Kv, D).

    k_pos: (Sc,) absolute position held in each cache slot (-1 = empty);
    cur_pos: the query token's position (a 0-d tensor).  Scores and
    softmax are f32; the weights are cast to v's type before the PV
    product."""
    scale = q.shape[-1] ** -0.5
    B, Sq, H, D = q.shape
    Kv = k_cache.shape[2]
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    s = torch.where(_visible(k_pos, cur_pos, window), s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v_cache)
    return out.reshape(B, Sq, H, D)


def sdpa_decode_sharded(q, k_cache, v_cache, k_pos, cur_pos, window,
                        rt: Runtime):
    """:func:`sdpa_decode` over a cache sharded along its slots: each head's
    partial (max, sum, weighted V) over this rank's slots, merged across
    ``rt.cache_groups`` by log-sum-exp (the flash-decode combine, over the
    mesh).  A rank whose slots are all empty contributes nothing."""
    scale = q.shape[-1] ** -0.5
    B, Sq, H, D = q.shape
    Kv = k_cache.shape[2]
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    valid = _visible(k_pos, cur_pos, window)
    m = torch.where(valid, s, NEG_INF).amax(-1)                # (B,Kv,G,1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cache.dtype),
                       v_cache).float()
    mg = m.clone()
    for group in rt.cache_groups:
        all_reduce(mg, rt, torch.distributed.ReduceOp.MAX, group)
    a = torch.exp(m - mg)
    parts = torch.cat([(p.sum(-1) * a)[..., None], acc * a[..., None]], -1)
    for group in rt.cache_groups:
        all_reduce(parts, rt, group=group)
    out = (parts[..., 1:] / parts[..., :1]).to(v_cache.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


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

def _kv_heads_of_rank(cfg, rt: Runtime, h: int):
    """The KV heads this rank's ``h`` query heads attend with, when the KV
    projections are replicated over the model axis (``kv_heads`` does not
    split over it): query head i reads KV head i // G.  The local heads
    run in groups of g = gcd(h, G) consecutive heads, each within one KV
    head -> the KV head of each group (local GQA with groups of g)."""
    G = cfg.n_heads // cfg.kv_heads
    g = math.gcd(h, G)
    first = rt.tp_rank * h
    return [(first + c * g) // G for c in range(h // g)]


def _project_qkv(cfg, p, x, rt: Runtime, all_kv: bool = False):
    """Local heads on a model axis: the columns of wq (and of wk/wv when
    they shard) are this rank's heads.  Where the KV projections are
    replicated over the model axis, k/v hold the KV heads this rank's
    query heads read, or with ``all_kv`` (a dense cache holds every KV
    head) all of them."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    dt = x.dtype
    wk, wv = p["wk"], p["wv"]
    bk, bv = p.get("bk"), p.get("bv")
    h, kv = p["wq"].shape[1] // hd, wk.shape[1] // hd
    if _kv_replicated(cfg, rt, kv) and not all_kv:
        ids = _kv_heads_of_rank(cfg, rt, h)
        sel = torch.tensor(ids, device=x.device)
        kv = len(ids)

        def pick(w):
            return w.unflatten(-1, (-1, hd)).index_select(-2, sel).flatten(-2)

        wk, wv = pick(wk), pick(wv)
        if bk is not None:
            bk, bv = pick(bk), pick(bv)
    q = x @ p["wq"].to(dt)
    k = x @ wk.to(dt)
    v = x @ wv.to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + bk.to(dt)
        v = v + bv.to(dt)
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm_headwise(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _kv_replicated(cfg, rt: Runtime, kv: int) -> bool:
    """Whether this rank holds every KV projection on a model axis whose
    size does not divide the KV heads."""
    return head_parallel(rt) and kv == cfg.kv_heads and \
        cfg.kv_heads % rt.tp_size != 0


def _dense_cache_block(cfg, p, x, rope_ang, rt: Runtime, cache,
                       cp: bool = False):
    """Prefill (S > 1) into, or decode one token (S == 1) from, a dense
    cache on this rank's heads.  The cache holds every KV head: on a model
    axis the new k/v are gathered over it where they are head-sharded.
    Prefill attends causally over the prompt (``sdpa_causal``: the
    flash-attention kernel on the kernel path).  Decode attends with every
    query head (gathered over the model axis) over this rank's slots,
    merged over the cache axes where the slots are sharded, and keeps its
    own heads for the row-parallel ``wo``.  A context rank (``cp``)
    prefills its shard of the prompt, attending over the K/V gathered from
    every rank's shard, and writes the whole prompt's K/V into its
    slots."""
    S = x.shape[1]
    h = p["wq"].shape[1] // cfg.head_dim_
    q, k, v = _project_qkv(cfg, p, x, rt, all_kv=True)
    if rope_ang is not None:
        q = apply_rope(q, rope_ang)
        k = apply_rope(k, rope_ang)
    replicated = _kv_replicated(cfg, rt, k.shape[2])
    k_all, v_all = k, v
    if head_parallel(rt) and not replicated:
        k_all, v_all = gather_heads(k, rt), gather_heads(v, rt)
    if S > 1 and cp:
        out, k_all, v_all = cp_attend(q, k, v, cfg.sliding_window, rt)
        prefill_kv_cache(cache, k_all, v_all, rt.cache_shard)
        return out
    if S > 1:
        if replicated:
            sel = torch.tensor(_kv_heads_of_rank(cfg, rt, h),
                               device=x.device)
            k, v = k.index_select(2, sel), v.index_select(2, sel)
        out = sdpa_causal(q, k, v, cfg.sliding_window, rt)
        prefill_kv_cache(cache, k_all, v_all, rt.cache_shard)
        return out
    idx = cache["idx"]
    _decode_write(cache, k_all, v_all, rt.cache_shard)
    q_all = gather_heads(q, rt) if head_parallel(rt) else q
    n, Sc = cache["k"].shape[1], cache["kpos"].shape[0]
    if n == Sc:
        out = sdpa_decode(q_all, cache["k"], cache["v"], cache["kpos"], idx,
                          cfg.sliding_window)
    else:
        lo = rt.cache_shard * n
        out = sdpa_decode_sharded(q_all, cache["k"], cache["v"],
                                  cache["kpos"][lo:lo + n], idx,
                                  cfg.sliding_window, rt)
    cache["idx"].add_(1)
    if head_parallel(rt):
        out = out[:, :, rt.tp_rank * h:(rt.tp_rank + 1) * h]
    return out


def attention_block(cfg, p, x, rope_ang, rt: Runtime, cache=None,
                    want_cache: bool = False, paged=None, sp: bool = False,
                    cp: bool = False):
    """Attention sublayer: x (B, S, d) -> (B, S, d); on a model axis, x
    and the result are the residual stream's (its S-shard under sequence
    parallelism, ``sp``), the heads this rank's, and ``wo`` row-parallel.
    Under a context plan (``cp``) x is this rank's shard of the sequence
    and ``rope_ang`` its positions' angles (:func:`cp_attend`).

    Train:         cache None -> causal self-attention over positions
                   0..S-1 (``sdpa_causal``); with ``want_cache`` ->
                   (out, a fresh dense cache holding the k/v).
    Dense serving: cache {'k','v','kpos','idx'} (updated in place) —
                   prefill (S > 1) into it, or decode (S == 1) at slot
                   idx % Sc.
    Paged serving: cache {'k_pool','v_pool'} + paged {'tbl','ctx'} —
                   chunked prefill (S > 1) and decode (S == 1) both append
                   at the request's ctx and attend over its block chain.
    """
    if paged is not None and cache is None:
        raise ValueError("paged attention needs the layer's pools (cache)")
    x = tp_enter(x, rt, sp)
    B, S, _ = x.shape
    if cache is not None and paged is None:
        out = _dense_cache_block(cfg, p, x, rope_ang, rt, cache, cp)
        return tp_exit(out.reshape(B, S, -1) @ p["wo"].to(out.dtype), rt, sp)
    q, k, v = _project_qkv(cfg, p, x, rt)
    if rope_ang is not None:
        q = apply_rope(q, rope_ang)
        k = apply_rope(k, rope_ang)
    if paged is not None:
        out = _paged_attention_block(cfg, q, k, v, cache, paged, rt)
    elif cp:
        out = cp_attend(q, k, v, cfg.sliding_window, rt)[0]
    else:
        out = sdpa_causal(q, k, v, cfg.sliding_window, rt)
    out = tp_exit(out.reshape(B, S, -1) @ p["wo"].to(out.dtype), rt, sp)
    if want_cache:
        if head_parallel(rt) or cp:
            raise NotImplementedError(
                "want_cache builds a single-device cache; a sharded one "
                "comes from transformer.init_cache under the plan")
        new = make_kv_cache(cfg, B, S, k.dtype, k.device)
        return out, prefill_kv_cache(new, k, v)
    return out
