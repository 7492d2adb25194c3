"""Mixture-of-experts FFN: shared and routed top-k experts — the port of the
JAX package's ``models/moe.py``.

Two dispatches, as the reference has them:

  * ``dense``    — every expert computes every token, combined by the
                   router's weights: exact (nothing dropped), E/k times the
                   FLOPs; the oracle, and what ``auto`` picks for small
                   token counts (decode, short batches);
  * ``dropping`` — GShard's fixed-capacity dispatch built from a stable
                   argsort over expert ids (no (T, E, C) one-hot): the
                   tokens split into ``moe_groups`` dispatch groups, each
                   expert takes at most C items of a group, the rest are
                   dropped.  Items move into the (E, C, d) expert buffer
                   and back with gathers both ways (:class:`_RoutedTake`).

``ep`` (a plan with an expert axis) routes through ``core.expert``: the
same capacity routing on this rank's tokens, then the dispatch and
combine all-to-all over the expert group.  Leaves keep the JAX names and
layouts: ``router`` (d, E), ``w_up``/``w_gate`` (E, d, f), ``w_down`` (E,
f, d) and ``shared.{w_up, w_gate, w_down}`` ((d, n_shared f) and back).

On a model axis (a plan's tp, or the sequence axis of a context plan)
every model rank routes the same tokens — the whole sequence, gathered
along S where the residual stream is sharded along it — with the router
whole, and computes only its part of the experts, as the reference's
``_param_spec`` places them: with no expert axis its E / m experts (the
stacks' E dim on the model axis; a dropping rank fills its own experts'
capacity buffers, capacity the global one), under an expert axis the
all-to-all's experts split on their hidden dim.  Shared experts split on
the hidden dim like a dense FFN.  The partial sums leave through the
dense FFN's exit collective (``models.layers.model_exit``: a reduce-scatter
along S, else an all-reduce), and every model rank holds the same aux,
whose gradient each takes 1/m of (their gradients are summed over the
model group).  Each such call adds one to
``models.layers.COLLECTIVE_SITES['moe_combine']``.

The switch-style balance loss comes from the router's statistics over the
tokens of the step.  A rank holds a shard of those tokens under a
data-parallel plan, so the statistics are averaged over the groups that
shard them (``Runtime.moe_stat_groups``) with an all-reduce whose
backward is the all-reduce of the cotangents: every rank then holds the
global aux, and its gradient reaches each rank's router through that
rank's own tokens.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.models.layers import (COLLECTIVE_SITES, COLLECTIVES,
                                       Runtime, _act, _randn, local_params,
                                       model_enter, model_exit, scale_grad,
                                       sum_over_groups, wire_round)


def init_moe(cfg, gen, device):
    """The MoE FFN's leaves (the JAX package's names, shapes and scales)
    drawn from ``gen`` on ``device``."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.expert_d_ff, m.n_experts
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {"router": _randn(gen, (d, E), s_in, device),
         "w_up": _randn(gen, (E, d, f), s_in, device),
         "w_down": _randn(gen, (E, f, d), s_out, device)}
    if cfg.glu:
        p["w_gate"] = _randn(gen, (E, d, f), s_in, device)
    if m.n_shared_experts:
        fs = m.n_shared_experts * f
        p["shared"] = {"w_up": _randn(gen, (d, fs), s_in, device),
                       "w_down": _randn(gen, (fs, d), fs ** -0.5, device)}
        if cfg.glu:
            p["shared"]["w_gate"] = _randn(gen, (d, fs), s_in, device)
    return p


class MoEFFN(nn.ParameterDict):
    """A MoE layer's FFN parameters, called as a module (so that FSDP2's
    hooks fire on it when a plan with an expert axis makes it a unit of
    its own, ``core.parallel.apply_plan``): ``ffn(cfg, x, rt, seq)`` ->
    (y, aux).  ``seq``: x (and y) are this rank's shard of the sequence
    on the model axis (Megatron-SP, or a context plan's shard)."""

    # a ParameterDict refuses calls; this one runs like any module
    __call__ = nn.Module.__call__

    def forward(self, cfg, x, rt: Runtime, seq: bool = False):
        lp = local_params(self)
        if rt.gather_dtype is not None and not rt.fsdp_wire:
            lp = wire_round(lp, rt.gather_dtype, rt.compute_dtype)
        m = rt.tp_size
        if m == 1:
            return apply_moe(cfg, lp, x, rt)
        y, aux = apply_moe(cfg, lp, model_enter(x, rt, seq), rt)
        COLLECTIVE_SITES["moe_combine"] += 1
        return model_exit(y, rt, seq), scale_grad(aux, 1.0 / m)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def mean_over_groups(x: torch.Tensor, groups) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``groups`` (each rank holding a
    shard of the same token count), differentiable."""
    if not groups:
        return x
    n = 1
    for g in groups:
        n *= dist.get_world_size(g)
    return sum_over_groups(x, groups) / n


def _router(cfg, p, xf, rt: Runtime = None, stat_groups=None):
    """xf (T, d) -> probs (T, E) f32, weights and ids (T, k), aux loss.

    Top-k of the softmax (ties to the lower id), renormalised by
    max(sum, 1e-9); the balance loss
    E * sum(frac_tokens * frac_probs) * coef, its fractions averaged over
    ``stat_groups`` (by default ``rt.moe_stat_groups``): every shard holds
    the same token count, so the mean of the local fractions is the
    global one."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # the top k, ties to the lower expert id as jax.lax.top_k breaks them
    # (torch.topk does not; a stable descending sort does)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = vals[:, :k], order[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    flat = ids.reshape(-1)
    occupancy = torch.zeros(E, dtype=torch.float32, device=xf.device
                            ).index_add_(0, flat, torch.ones(
                                flat.shape, dtype=torch.float32,
                                device=xf.device))
    frac_tokens = occupancy / (xf.shape[0] * k)
    frac_probs = probs.mean(0)
    groups = (rt.moe_stat_groups if rt is not None else ()) \
        if stat_groups is None else stat_groups
    if groups:
        both = mean_over_groups(torch.stack([frac_tokens, frac_probs]),
                                groups)
        frac_tokens, frac_probs = both[0], both[1]
    aux = E * torch.sum(frac_tokens * frac_probs) * m.aux_loss_coef
    return probs, weights, ids, aux


# ---------------------------------------------------------------------------
# experts
# ---------------------------------------------------------------------------

def _expert_ffn(cfg, p, buf, rt: Runtime = None):
    """buf (E, C, d) -> (E, C, d) through each expert's FFN (``p`` holds
    the stacks of the experts in ``buf``'s dim 0)."""
    act = _act(cfg.act)
    dt = buf.dtype
    up = torch.bmm(buf, p["w_up"].to(dt))
    if "w_gate" in p:
        h = act(torch.bmm(buf, p["w_gate"].to(dt))) * up
    else:
        h = act(up)
    return torch.bmm(h, p["w_down"].to(dt))


def _local_experts(cfg, p, rt):
    """(first, count) of the experts whose stacks ``p`` holds: all of
    them, or on a model axis that splits the E dim (``moe_experts_split``)
    this rank's E / m."""
    n = p["w_up"].shape[0]
    if rt is None or not rt.moe_experts_split:
        return 0, n
    return rt.tp_rank * n, n


def _share(y, cfg, p, rt):
    """A routed output as this rank's part of the sum over the model
    axis: where the stacks are whole on every model rank (the plan does
    not split E over it) each rank's is 1/m of the whole."""
    if rt is not None and rt.tp_size > 1 and not rt.moe_experts_split:
        return y / rt.tp_size
    return y


def _moe_dense(cfg, p, xf, rt: Runtime = None):
    """The oracle: every expert on every token, (E, T, f) and (E, T, d)
    intermediates (on a model axis that splits E, this rank's experts
    only)."""
    m = cfg.moe
    _, weights, ids, aux = _router(cfg, p, xf, rt)
    act = _act(cfg.act)
    dt = xf.dtype
    up = torch.matmul(xf, p["w_up"].to(dt))                  # (E, T, f)
    if "w_gate" in p:
        h = act(torch.matmul(xf, p["w_gate"].to(dt))) * up
    else:
        h = act(up)
    y_e = torch.matmul(h, p["w_down"].to(dt))                # (E, T, d)
    w_full = torch.zeros((xf.shape[0], m.n_experts), dtype=torch.float32,
                         device=xf.device).scatter_add(1, ids, weights)
    e0, n = _local_experts(cfg, p, rt)
    y = torch.einsum("etd,te->td", y_e, w_full[:, e0:e0 + n].to(dt))
    return _share(y, cfg, p, rt), aux


def _take(x, idx):
    """y[i] = x[idx[i]], a zero row where idx[i] < 0."""
    mask = (idx >= 0).to(x.dtype)[:, None]
    return x.index_select(0, idx.clamp_min(0)) * mask


class _RoutedTake(torch.autograd.Function):
    """y[i] = x[idx[i]] (idx < 0 -> a zero row).  ``idx`` is an injective
    partial map and ``inv_idx`` its inverse, so the backward is a gather
    too (dx[j] = dy[inv_idx[j]]), as the reference's custom VJP: no
    d-wide scatter either way."""

    @staticmethod
    def forward(ctx, x, idx, inv_idx):
        ctx.save_for_backward(inv_idx)
        return _take(x, idx)

    @staticmethod
    def backward(ctx, dy):
        inv_idx, = ctx.saved_tensors
        return _take(dy, inv_idx), None, None


def _routed_take(x, idx, inv_idx):
    return _RoutedTake.apply(x, idx, inv_idx)


def _route_capacity(fids, n_experts: int, capacity: int):
    """Index plumbing only: fids (n,) expert ids -> (dest (n,), inv (E C,)):
    ``dest[i]`` is item i's slot in the (E, C) buffer (-1: dropped),
    ``inv[s]`` the item in slot s (-1: empty).  Items keep their order
    within an expert (a stable sort), so the first C of each expert stay.
    Dropped items are written to one slot past the buffer, cut off."""
    n = fids.shape[0]
    E, C = n_experts, capacity
    dev = fids.device
    fids = fids.long()
    order = torch.argsort(fids, stable=True)
    sorted_ids = fids[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, fids, torch.ones_like(fids))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=dev) - starts[sorted_ids]
    keep = pos_sorted < C
    slot_sorted = sorted_ids * C + torch.clamp(pos_sorted, max=C - 1)
    dest = torch.full((n,), -1, dtype=torch.long, device=dev).scatter(
        0, order, torch.where(keep, slot_sorted, -1))
    inv = torch.full((E * C + 1,), -1, dtype=torch.long, device=dev).scatter(
        0, torch.where(keep, slot_sorted, E * C), order)[:E * C]
    return dest, inv


def capacity(tokens: int, cfg) -> int:
    """Slots per expert for one dispatch group of ``tokens`` tokens:
    ceil(tokens k cf / E), padded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(math.ceil(tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, -(-c // 8) * 8)


def _items(xf, k):
    """(T, d) -> (T k, d): each token once per routed choice, token-major
    (the reference's broadcast, whose backward sums over the choices)."""
    T, d = xf.shape
    return xf[:, None].expand(T, k, d).reshape(T * k, d)


def _moe_dropping(cfg, p, xf, rt: Runtime):
    """Fixed-capacity dispatch in G = ``rt.moe_groups`` groups of
    contiguous tokens (halved until G divides T), each with its own
    capacity; the G groups' routing runs as one: group g's ids become
    g E + id, so one stable sort routes every group into its own (E, C)
    block."""
    m = cfg.moe
    T, d = xf.shape
    k, E = m.top_k, m.n_experts
    _, weights, ids, aux = _router(cfg, p, xf, rt)
    G = max(1, min(rt.moe_groups, T))
    while T % G:
        G //= 2
    Tg = T // G
    Cg = capacity(Tg, cfg)
    gid = torch.arange(G, device=xf.device).repeat_interleave(Tg * k)
    dest, inv = _route_capacity(gid * E + ids.reshape(T * k), G * E, Cg)
    e0, n = _local_experts(cfg, p, rt)
    if n < E:
        dest, inv = _own_slots(dest, inv, G, E, Cg, e0, n)
    buf = _routed_take(_items(xf, k), inv, dest)             # (G n Cg, d)
    buf = buf.reshape(G, n, Cg, d).transpose(0, 1).reshape(n, G * Cg, d)
    out = _expert_ffn(cfg, p, buf, rt)                       # (n, G Cg, d)
    out = out.reshape(n, G, Cg, d).transpose(0, 1).reshape(G * n * Cg, d)
    rows = _routed_take(out, dest, inv)                      # (T k, d)
    y = (rows.reshape(T, k, d) * weights[..., None].to(rows.dtype)).sum(1)
    return _share(y, cfg, p, rt), aux


def _own_slots(dest, inv, G, E, C, e0, n):
    """The routing maps of G groups' (E, C) buffers cut to the n experts
    from e0 that this rank holds: ``dest`` (an item's slot, -1 dropped)
    to their (G, n, C) buffer, -1 for an item routed elsewhere; ``inv``
    to its slots.  Still an injective map and its inverse."""
    slot = dest.clamp_min(0)
    g, e, c = slot // (E * C), (slot // C) % E, slot % C
    mine = (dest >= 0) & (e >= e0) & (e < e0 + n)
    dest = torch.where(mine, (g * n + e - e0) * C + c, -1)
    inv = inv.reshape(G, E, C)[:, e0:e0 + n].reshape(-1)
    return dest, inv


def apply_moe(cfg, p, x, rt: Runtime):
    """x (B, S, d) -> (out (B, S, d), aux 0-d f32).

    ``rt.moe_impl``: 'dense', 'dropping', 'ep' (``core.expert``), or
    'auto' — dense while B S E <= 2**22, else dropping (the reference's
    rule)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    impl = rt.moe_impl
    if impl == "auto":
        impl = ("dense" if B * S * cfg.moe.n_experts <= (1 << 22)
                else "dropping")
    if impl == "ep":
        from repro_torch.core import expert as expert_lib
        y, aux = expert_lib.moe_expert_parallel_any(cfg, p, xf, rt)
    elif impl == "dense":
        y, aux = _moe_dense(cfg, p, xf, rt)
    elif impl == "dropping":
        y, aux = _moe_dropping(cfg, p, xf, rt)
    else:
        raise ValueError(f"moe_impl {rt.moe_impl!r} not in auto | dense | "
                         "dropping | ep")
    y = y.reshape(B, S, d)
    if "shared" in p:
        sp = p["shared"]
        act = _act(cfg.act)
        dt = x.dtype
        up = x @ sp["w_up"].to(dt)
        if "w_gate" in sp:
            h = act(x @ sp["w_gate"].to(dt)) * up
        else:
            h = act(up)
        ys = h @ sp["w_down"].to(dt)
        if rt.tp_size > 1 and not rt.moe_shared_split:
            # whole on every model rank (a context plan keeps them so)
            ys = ys / rt.tp_size
        y = y + ys
    return y, aux
