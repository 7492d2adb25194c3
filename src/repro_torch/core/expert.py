"""Expert parallelism: the dispatch and combine all-to-all over an expert
group — the port of the JAX package's ``core/expert.py``.

A plan with an ``expert`` axis (``Strategy(ep > 1)``, the axis factored
out of the data axis, so the batch splits over (data, expert) together)
holds each MoE expert stack as its E/ep slice on each expert rank
(``core.parallel.apply_plan``) and routes every MoE layer through
GShard's schedule:

    route (local argsort)  ->  all-to-all (dispatch)  ->  expert FFN
                           ->  all-to-all (combine)   ->  weighted sum

``expert_dispatch_local`` is that schedule on this rank's tokens: it
builds the local (E, C, d) send buffer with the scatter-free index maps
of ``models.moe`` (capacity ``C = ceil(T_loc k cf / E)`` of the source
rank, so dropping is the reference's with one dispatch group per token
shard), exchanges it for the (E/ep, ep C, d) buffer of this rank's
experts, runs them, and sends the rows back.  Both exchanges are
``all_to_all_single`` in an autograd function whose backward is the
reverse exchange.  The router averages its load statistics over the
groups that shard the tokens (``Runtime.moe_stat_groups``), so the aux
loss equals the dense oracle's on the whole batch.

Where the tokens are already sharded over the expert group (a training
step: every rank holds its own rows), each rank dispatches its own.
Where they are the same on every rank of the expert group (a served
batch smaller than the data axes), each rank takes its 1/ep of them —
zero-padded after the last real token up to a multiple of ep, so padding
can only ever drop padding (a stable sort keeps the real tokens ahead) —
and the outputs are all-gathered (``moe_expert_parallel_padded``); this
path is forward-only.  Every call adds one to its entry of
``DISPATCH_STATS``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.layers import COLLECTIVES

# which EP entry each MoE layer call took, counted per call (the dry run
# records the deltas around its step, as the JAX one does around its
# lowerings).  'ep_fallback_calls' is kept only so that the record has
# the reference's keys: nothing here sets it, since the port raises where
# the reference falls back (``moe_expert_parallel_any``)
DISPATCH_STATS = {"ep_calls": 0, "ep_padded_calls": 0,
                  "ep_fallback_calls": 0}


def dispatch_stats_snapshot() -> dict:
    return dict(DISPATCH_STATS)


def reset_dispatch_stats() -> None:
    for k in DISPATCH_STATS:
        DISPATCH_STATS[k] = 0


def tokens_sharded(rt) -> bool:
    """Whether this rank's tokens are its own shard over the expert group
    (the group is among those the router averages over)."""
    return any(g is rt.expert_group for g in rt.moe_stat_groups)


def token_shards(rt) -> int:
    """Shards the tokens of one call split into over the expert group:
    ``expert_size`` where every rank of it holds the same tokens, 1 where
    each already holds its own."""
    return 1 if tokens_sharded(rt) else rt.expert_size


def can_shard_tokens(cfg, rt, n_tokens: int) -> bool:
    """True when the EP path runs on ``n_tokens`` tokens unpadded: an
    expert group whose size divides the experts, and tokens that split
    evenly over ``token_shards`` with at least one each."""
    if rt.expert_group is None or cfg.moe.n_experts % rt.expert_size:
        return False
    shards = token_shards(rt)
    return n_tokens % shards == 0 and n_tokens >= shards


def can_pad_tokens(cfg, rt) -> bool:
    """True when padding the token count makes the EP path run: only the
    token count is fixable by padding."""
    return bool(rt.expert_group is not None
                and cfg.moe.n_experts % rt.expert_size == 0)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of dim 0's ep equal chunks over ``group``;
    the backward is the same exchange of the cotangent (chunk j goes back
    to rank j)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    COLLECTIVES["all_to_all"] += 1
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def expert_dispatch_local(cfg, router, stack, x_loc, rt, stat_groups=None):
    """This rank's tokens through route -> all-to-all -> expert FFN ->
    all-to-all -> combine.  x_loc (T_loc, d) -> (y (T_loc, d), aux);
    ``stack`` holds this rank's E/ep slice of the expert stacks; the
    router averages its statistics over ``stat_groups`` (by default
    ``rt.moe_stat_groups``)."""
    from repro_torch.models.moe import (_expert_ffn, _items, _route_capacity,
                                        _routed_take, _router, capacity)
    m = cfg.moe
    T_loc, d = x_loc.shape
    k, E, ep = m.top_k, m.n_experts, rt.expert_size
    if E % ep:
        raise ValueError(f"ep={ep} does not divide n_experts={E}")
    C = capacity(T_loc, cfg)
    _, weights, ids, aux = _router(cfg, {"router": router}, x_loc, rt,
                                   stat_groups)
    dest, inv = _route_capacity(ids.reshape(T_loc * k), E, C)
    buf = _routed_take(_items(x_loc, k), inv, dest)          # (E C, d)
    # dispatch: chunk j of the experts goes to rank j; rank r receives
    # (ep, E/ep, C, d) — its experts' rows from every source rank
    buf = _AllToAll.apply(buf.reshape(E, C, d), rt.expert_group)
    buf = buf.reshape(ep, E // ep, C, d).transpose(0, 1).reshape(
        E // ep, ep * C, d)
    out = _expert_ffn(cfg, stack, buf, rt)                   # (E/ep, ep C, d)
    # combine: the exact reverse exchange
    out = out.reshape(E // ep, ep, C, d).transpose(0, 1)
    out = _AllToAll.apply(out.reshape(E, C, d), rt.expert_group)
    rows = _routed_take(out.reshape(E * C, d), dest, inv)    # (T_loc k, d)
    y = (rows.reshape(T_loc, k, d) *
         weights[..., None].to(rows.dtype)).sum(1)
    return y, aux


def _stack(p):
    return {n: p[n] for n in ("w_up", "w_gate", "w_down") if n in p}


def moe_expert_parallel(cfg, p, xf, rt):
    """xf (T, d) -> (y (T, d), aux) through the expert all-to-all.  With
    tokens sharded over the expert group, this rank's own; else (the
    same tokens on every expert rank, T divisible by ep) each rank
    dispatches its 1/ep and the outputs are all-gathered.  Shared experts
    are the caller's (``models.moe.apply_moe``)."""
    if tokens_sharded(rt):
        return expert_dispatch_local(cfg, p["router"], _stack(p), xf, rt)
    if torch.is_grad_enabled() and xf.requires_grad:
        raise RuntimeError(
            "the expert all-to-all over tokens that every expert rank "
            "holds alike is forward-only (serving); a train step gives each "
            "rank its own rows")
    T, d = xf.shape
    ep, r = rt.expert_size, dist.get_rank(rt.expert_group)
    n = T // ep
    groups = tuple(rt.moe_stat_groups) + (rt.expert_group,)
    y, aux = expert_dispatch_local(cfg, p["router"], _stack(p),
                                   xf[r * n:(r + 1) * n], rt, groups)
    out = torch.empty((ep * n, d), dtype=y.dtype, device=y.device)
    dist.all_gather_into_tensor(out, y.contiguous(), group=rt.expert_group)
    return out, aux


def moe_expert_parallel_padded(cfg, p, xf, rt):
    """EP dispatch for a token count that does not split over the expert
    group (a decode batch): zero rows appended after every real token up
    to a multiple of ep, the normal dispatch, the padding sliced off.
    The router's statistics (the aux) see the pad rows, as the
    reference's do."""
    T, d = xf.shape
    shards = token_shards(rt)
    T_pad = max(-(-T // shards) * shards, shards)
    if T_pad == T:
        return moe_expert_parallel(cfg, p, xf, rt)
    xp = torch.cat([xf, xf.new_zeros((T_pad - T, d))])
    y, aux = moe_expert_parallel(cfg, p, xp, rt)
    return y[:T], aux


def moe_expert_parallel_any(cfg, p, xf, rt):
    """``apply_moe``'s 'ep' entry: the unpadded path where the tokens
    split, the padded one where only their count is at fault; else (an
    expert group whose size does not divide the experts) it raises, where
    the reference falls back to the plain dropping dispatch."""
    if can_shard_tokens(cfg, rt, xf.shape[0]):
        DISPATCH_STATS["ep_calls"] += 1
        return moe_expert_parallel(cfg, p, xf, rt)
    if can_pad_tokens(cfg, rt):
        DISPATCH_STATS["ep_padded_calls"] += 1
        return moe_expert_parallel_padded(cfg, p, xf, rt)
    raise ValueError(
        f"EP dispatch unavailable: {cfg.moe.n_experts} experts do not "
        f"shard over an expert group of {rt.expert_size}")
