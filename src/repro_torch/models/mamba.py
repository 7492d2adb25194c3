"""Mamba-1 selective SSM block (Jamba's mixer, arXiv:2403.19887) — the port
of the JAX package's ``models/mamba.py``:

  x, z = in_proj(h)                        # (B,T,di) each, di = expand*d
  x    = silu(causal_conv1d(x))            # depthwise, width d_conv
  dt   = softplus(dt_proj(x_proj_dt(x)))   # (B,T,di)
  B_t, C_t = x_proj(x)                     # (B,T,ds) each
  h_t  = exp(dt_t * A) . h_{t-1} + (dt_t * x_t) outer B_t
  y_t  = C_t . h_t + D * x_t
  out  = out_proj(y * silu(z))

The scan runs chunked in f32, as the JAX package's does: a loop over
sequence chunks carries the (B, di, ds) state, and each chunk is recomputed
in the backward (``_ScanChunk``, the JAX ``jax.checkpoint`` of the chunk),
so a training step never holds (B, T, di, ds).  Within a chunk the decays
and inputs of every step are formed at once and the recurrence runs step
by step, one multiply-add a step (its adjoint likewise in the backward;
on the dry run's fake tensors, shapes only).  The JAX package has no kernel for the scan: it is plain PyTorch
on every device.

On a model axis (tensor parallelism) each rank takes its di channels:
``w_x_in``, ``w_z_in``, ``conv_*``, ``w_dt``, ``b_dt``, ``A_log`` and
``D`` are column shards over di, ``w_out`` a row shard whose partial
output leaves through the sublayer's exit all-reduce, and ``w_x`` a row
shard: ``x @ w_x`` is a partial sum, all-reduced before it is split into
``dt_lr``, ``B_t`` and ``C_t``.  Every rank consumes those with its own
channels, so their cotangents are partial too and the all-reduce sums
them in the backward as well (``layers.sum_over_groups``).  Weights are
(in, out) and applied as ``x @ W``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import is_fake
from repro_torch.models.layers import (Runtime, _randn, sum_over_groups,
                                       tp_enter, tp_exit)


def dt_rank(cfg) -> int:
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


def d_inner(cfg) -> int:
    return cfg.mamba.expand * cfg.d_model


def init_mamba(cfg, gen, device):
    """The JAX ``init_mamba``'s leaves, by name, shape and distribution."""
    d, mc = cfg.d_model, cfg.mamba
    di, dtr = d_inner(cfg), dt_rank(cfg)
    s = d ** -0.5
    A = torch.arange(1, mc.d_state + 1, dtype=torch.float32,
                     device=device)[None].repeat(di, 1)
    # softplus^-1 of dt in [1e-3, 1e-1]
    dt0 = 10 ** (torch.rand((di,), generator=gen, device=device) * 2.0 - 3.0)
    return {
        # x/z projections kept separate so each shards cleanly on the
        # model axis (a fused (d, 2*di) matrix would straddle the split)
        "w_x_in": _randn(gen, (d, di), s, device),
        "w_z_in": _randn(gen, (d, di), s, device),
        "conv_w": _randn(gen, (mc.d_conv, di), mc.d_conv ** -0.5, device),
        "conv_b": torch.zeros(di, device=device),
        "w_x": _randn(gen, (di, dtr + 2 * mc.d_state), di ** -0.5, device),
        "w_dt": _randn(gen, (dtr, di), dtr ** -0.5, device),
        "b_dt": torch.log(torch.expm1(dt0)),
        "A_log": torch.log(A),
        "D": torch.ones(di, device=device),
        "w_out": _randn(gen, (di, d), di ** -0.5, device),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv. x (B, T, di), w (K, di) -> (y, new_state):
    ``conv_state`` (B, K-1, di) holds the last K-1 inputs (pre-SiLU) of
    the previous segment (zeros without one), in x's dtype; the new state
    is the last K-1 inputs of this one."""
    B, T, di = x.shape
    K = w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros((B, K - 1, di))
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)      # (B, T+K-1, di)
    w = w.to(x.dtype)
    y = xp[:, :T] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + T] * w[i]
    return y + b.to(x.dtype), xp[:, T:]


def _recurrence(a, b, h0, reverse=False):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h0 (from the last step
    back to the first with ``reverse``: h_t = a_t h_{t+1} + b_t), one
    multiply-add a step -> every h_t stacked, in the order of t.  On fake
    tensors (the dry run) its shape-only branch: the same allocations (the
    steps, then their stack), no steps."""
    if is_fake(b):
        steps = torch.empty_like(b)
        del steps
        return torch.empty_like(b)
    h, hs = h0, []
    pairs = list(zip(a.unbind(1), b.unbind(1)))
    for a_t, b_t in (reversed(pairs) if reverse else pairs):
        h = torch.addcmul(b_t, a_t, h)
        hs.append(h)
    return torch.stack(hs[::-1] if reverse else hs, dim=1)


def _chunk_states(dt, Bt, Ct, x, A, h0):
    """The states of one chunk, in f32: the decays da = exp(dt A) and the
    inputs dbx = (dt x) outer B_t of every step (B, C, di, ds), and
    h_1..h_C stacked (B, C, di, ds), h_t = da_t h_{t-1} + dbx_t."""
    dt, Bt, x = (a.float() for a in (dt, Bt, x))
    da = torch.exp(dt[..., None] * A)
    dbx = (dt * x)[..., None] * Bt[:, :, None, :]
    return da, dbx, _recurrence(da, dbx, h0)


def _selective_scan_chunk(dt, Bt, Ct, x, A, h0):
    """Sequential scan over one chunk, in f32.  dt/x (B, C, di), Bt/Ct
    (B, C, ds), A (di, ds), h0 (B, di, ds) -> (y (B, C, di) f32, hC)."""
    H = _chunk_states(dt, Bt, Ct, x, A, h0)[2]
    return torch.einsum("btds,bts->btd", H, Ct.float()), H[:, -1]


class _ScanChunk(torch.autograd.Function):
    """:func:`_selective_scan_chunk` under autograd, its states recomputed
    in the backward (the JAX package's ``jax.checkpoint`` of the chunk):
    the forward keeps only the chunk's inputs.  The backward runs the
    recurrence's adjoint, G_t = dL/dh_t = gy_t C_t + da_{t+1} G_{t+1}
    (G_C also takes the final state's cotangent), one step at a time, and
    the rest at once: dL/dda_t = G_t h_{t-1}, dL/ddbx_t = G_t.  Written
    by hand, so that the dry run's shape-only recurrence (fake tensors)
    still allocates the backward's states and gives every input its
    gradient: autograd through ``torch.empty_like`` would give none."""

    @staticmethod
    def forward(ctx, dt, Bt, Ct, x, A, h0):
        ctx.save_for_backward(dt, Bt, Ct, x, A, h0)
        return _selective_scan_chunk(dt, Bt, Ct, x, A, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        dt, Bt, Ct, x, A, h0 = ctx.saved_tensors
        da, dbx, H = _chunk_states(dt, Bt, Ct, x, A, h0)
        Cf, gy = Ct.float(), gy.float()
        gC = torch.einsum("btd,btds->bts", gy, H)
        direct = gy[..., None] * Cf[:, :, None, :]            # dy/dh_t
        # G_t = direct_t + da_{t+1} G_{t+1}, from G_{C+1} = the final
        # state's cotangent (zero without one) through da_{C+1} = 1
        nxt = torch.cat([da[:, 1:], torch.ones_like(da[:, :1])], dim=1)
        G = _recurrence(nxt, direct, torch.zeros_like(H[:, 0])
                        if gh is None else gh.float(), reverse=True)
        gh0 = da[:, 0] * G[:, 0]
        gda = G * torch.cat([h0[:, None], H[:, :-1]], dim=1) * da
        dtf, xf, Bf = dt.float(), x.float(), Bt.float()
        gdtx = torch.einsum("btds,bts->btd", G, Bf)           # d/d(dt x)
        gB = torch.einsum("btds,btd->bts", G, dtf * xf)
        gdt = torch.einsum("btds,ds->btd", gda, A) + gdtx * xf
        gA = torch.einsum("btds,btd->ds", gda, dtf)
        return (gdt.to(dt.dtype), gB.to(Bt.dtype), gC.to(Ct.dtype),
                (gdtx * dtf).to(x.dtype), gA.to(A.dtype), gh0.to(h0.dtype))


def selective_scan(dt, Bt, Ct, x, A, h0, chunk: int):
    """Chunked selective scan (shapes as :func:`_selective_scan_chunk`,
    any T).  T is padded to a multiple of the chunk with identity steps
    (dt 0: the decay is 1 and the input 0), so the final state is that of
    step T.  Under autograd each chunk is recomputed in the backward."""
    T = x.shape[1]
    chunk = min(chunk, T)
    Tp = -(-T // chunk) * chunk
    if Tp != T:
        dt, Bt, Ct, x = (F.pad(a, (0, 0, 0, Tp - T)) for a in (dt, Bt, Ct, x))
    h, ys = h0, []
    for c0 in range(0, Tp, chunk):
        y, h = _ScanChunk.apply(*(a[:, c0:c0 + chunk]
                                  for a in (dt, Bt, Ct, x)), A, h)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T], h


def mamba_block(cfg, p, h, rt: Runtime, state=None, sp: bool = False):
    """-> (out (B, T, d), new state or None).  ``state``: None (training)
    or {'conv' (B, K-1, di), 'ssm' (B, di, ds) f32} (this rank's di on a
    model axis), the carry of a prefill or a decode step; T == 1 with a
    state takes the one-chunk path.  ``sp``: h and out are this rank's
    shard of the sequence on the model axis, gathered at the entry and
    reduce-scattered at the exit (a context plan's recurrent layer)."""
    mc = cfg.mamba
    dtr = dt_rank(cfg)
    dt_ = h.dtype
    h = tp_enter(h, rt, sp)
    B, T, _ = h.shape
    x = h @ p["w_x_in"].to(dt_)
    z = h @ p["w_z_in"].to(dt_)
    x, new_conv = _causal_conv(x, p["conv_w"], p["conv_b"],
                               None if state is None else state["conv"])
    x = F.silu(x)
    proj = x @ p["w_x"].to(dt_)
    if x.shape[-1] != d_inner(cfg):     # this rank's channels: a part
        proj = sum_over_groups(proj, (rt.tp_group,))
    dt_lr, B_t, C_t = proj.split([dtr, mc.d_state, mc.d_state], dim=-1)
    dt = F.softplus(dt_lr @ p["w_dt"].to(dt_) + p["b_dt"].to(dt_))
    A = -torch.exp(p["A_log"].float())                       # (di, ds)
    h0 = (state["ssm"] if state is not None else
          torch.zeros((B, x.shape[-1], mc.d_state), dtype=torch.float32,
                      device=x.device))
    if T == 1 and state is not None:
        y, hN = _selective_scan_chunk(dt, B_t, C_t, x, A, h0)
    else:
        y, hN = selective_scan(dt, B_t, C_t, x, A, h0, rt.mamba_chunk)
    y = y.to(dt_) + p["D"].to(dt_) * x
    y = y * F.silu(z)
    out = tp_exit(y @ p["w_out"].to(dt_), rt, sp)
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "ssm": hN}
    return out, new_state

