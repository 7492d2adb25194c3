"""RWKV-6 "Finch" (arXiv:2404.05892) blocks — the port of the JAX package's
``models/rwkv6.py``: attention-free token mixing with data-dependent decay.

Time mix: a data-dependent token-shift lerp (ddlerp, low-rank mixes) feeds
the r/k/v/g/w projections; the per-channel decay is w = exp(-exp(w0 +
lora(x))); the WKV recurrence per head of N channels is

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,    y_t = r_t (S_{t-1} + (u * k_t)^T v_t)

then a headwise group norm, a silu(g) gate and the output projection.
Channel mix: token shift, relu² key, sigmoid receptance.

On a model axis (tensor parallelism, no sequence parallelism: the JAX
package keeps recurrent mixers' residual stream whole along S) each rank
takes its heads: ``wr``/``wk``/``wv``/``wg`` are column-parallel and
``wo`` row-parallel, the WKV runs on the local heads with their rows of
``u``, and the replicated decay (``w0`` and the LoRA's output) and group
norm are sliced to the local channels.  The channel mix's ``wk`` is
column-parallel, ``wv`` row-parallel and ``wr`` replicated.  Each block
enters through Megatron's f (all-reduce backward) and leaves through its
g (all-reduce forward).  Under a context plan the time mix enters and
leaves along S instead (``sp``): it scans the whole gathered sequence on
its heads, and each rank keeps its rows of the sum.

WKV routes: with no carried state and ``Runtime.attn_impl == "kernel"``,
the WKV-6 kernel (``kernels.ops.wkv6``; its plain version on CPU tensors)
for every T — the JAX gate ``T >= 64`` is a tiling rule of the TPU kernel,
below which JAX computes the same chunked formula in jnp.  Otherwise the
plain chunked form (``wkv_chunked``), or ``wkv_step`` for one token with a
state.  Weights are (in, out) and applied as ``x @ W``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.wkv6 import wkv6_plain as wkv_chunked
from repro_torch.models.layers import (Runtime, head_parallel, tp_enter,
                                       tp_exit)

TM_RANK = 32   # low-rank dim of the token-shift ddlerp
TD_RANK = 64   # low-rank dim of the decay lora


def _randn(gen, shape, scale, device):
    return torch.randn(shape, generator=gen, device=device) * scale


def init_rwkv_time_mix(cfg, gen, device):
    d = cfg.d_model
    H, N = cfg.rwkv_heads, cfg.rwkv_head_dim
    s = d ** -0.5
    # decay bias uniform on [-6, -4): w ~ exp(-exp(-6..-4)), close to 1
    w0 = -6.0 + 2.0 * torch.rand((d,), generator=gen, device=device)
    return {
        "maa_x": torch.zeros(d, device=device),
        "maa_rkvwg": torch.zeros(5, d, device=device),
        "tm_w1": _randn(gen, (d, 5 * TM_RANK), 1e-2, device),
        "tm_w2": _randn(gen, (5, TM_RANK, d), 1e-2, device),
        "w0": w0,
        "td_w1": _randn(gen, (d, TD_RANK), 1e-2, device),
        "td_w2": _randn(gen, (TD_RANK, d), 1e-2, device),
        "u": _randn(gen, (H, N), 1e-1, device),
        "wr": _randn(gen, (d, d), s, device),
        "wk": _randn(gen, (d, d), s, device),
        "wv": _randn(gen, (d, d), s, device),
        "wg": _randn(gen, (d, d), s, device),
        "wo": _randn(gen, (d, d), s, device),
        "ln_x": {"scale": torch.ones(d, device=device),
                 "bias": torch.zeros(d, device=device)},
    }


def init_rwkv_channel_mix(cfg, gen, device):
    d, dff = cfg.d_model, cfg.d_ff
    return {
        "maa_k": torch.zeros(d, device=device),
        "maa_r": torch.zeros(d, device=device),
        "wk": _randn(gen, (d, dff), d ** -0.5, device),
        "wv": _randn(gen, (dff, d), dff ** -0.5, device),
        "wr": _randn(gen, (d, d), d ** -0.5, device),
    }


def _mm(a, w, dt):
    """a @ w.astype(dt) with JAX's type promotion (bf16 with f32 -> f32)."""
    w = w.to(dt)
    ct = torch.promote_types(a.dtype, w.dtype)
    return a.to(ct) @ w.to(ct)


# ---------------------------------------------------------------------------
# WKV core
# ---------------------------------------------------------------------------

def wkv_recurrent(r, k, v, w, u, state):
    """Sequential oracle. r/k/v/w (B, T, H, N); u (H, N); state
    (B, H, N, N) -> (y (B, T, H, N), final state)."""
    S, ys = state, []
    for t in range(r.shape[1]):
        y, S = wkv_step(r[:, t], k[:, t], v[:, t], w[:, t], u, S)
        ys.append(y)
    return torch.stack(ys, dim=1), S


def wkv_step(r, k, v, w, u, state):
    """One decode step. r/k/v/w (B, H, N); state (B, H, N, N)."""
    ct = torch.promote_types(r.dtype, state.dtype)
    r, k, v, w, u = (a.to(ct) for a in (r, k, v, w, u))
    y = torch.einsum("bhn,bhnm->bhm", r, state) \
        + torch.einsum("bhn,bhn,bhm->bhm", r, u[None] * k, v)
    state = w[..., None] * state + torch.einsum("bhn,bhm->bhnm", k, v)
    return y, state


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift lerp -> [xr, xk, xv, xw, xg], each
    (B, T, d)."""
    xx = x_prev - x
    xxx = x + xx * p["maa_x"]
    B, T, d = x.shape
    lora = torch.tanh(_mm(xxx, p["tm_w1"], x.dtype)).reshape(B, T, 5, TM_RANK)
    w2 = p["tm_w2"].to(x.dtype)
    ct = torch.promote_types(lora.dtype, w2.dtype)
    mix = torch.einsum("btfr,frd->fbtd", lora.to(ct), w2.to(ct))
    return [x + xx * (p["maa_rkvwg"][i].to(x.dtype) + mix[i])
            for i in range(5)]


def _shift(x, last):
    """x_{t-1} stream: (B, T, d) shifted right, first slot = ``last``
    (B, d)."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def rwkv_time_mix(cfg, p, x, rt: Runtime, state=None, sp: bool = False):
    """-> (out (B, T, d), new state).  state: None (training: zeros, returns
    None) or {'x_prev' (B, d), 'wkv' (B, H, N, N)} for decode/prefill
    carry.  ``sp``: x and out are this rank's shard of the sequence on the
    model axis, gathered at the entry and reduce-scattered at the exit (a
    context plan's recurrent layer: the recurrence runs on the whole
    sequence)."""
    x = tp_enter(x, rt, sp)
    B, T, d = x.shape
    N = cfg.rwkv_head_dim
    last = (state["x_prev"] if state is not None
            else torch.zeros(B, d, dtype=x.dtype, device=x.device))

    xr, xk, xv, xw, xg = _ddlerp(p, x, _shift(x, last))
    dt = x.dtype
    # this rank's channels: heads [c0 / N, (c0 + dl) / N) of H
    dl = p["wr"].shape[1]
    H, c0 = dl // N, (rt.tp_rank * dl if head_parallel(rt) else 0)
    r = _mm(xr, p["wr"], dt).reshape(B, T, H, N)
    k = _mm(xk, p["wk"], dt).reshape(B, T, H, N)
    v = _mm(xv, p["wv"], dt).reshape(B, T, H, N)
    g = F.silu(_mm(xg, p["wg"], dt))
    dlora = _mm(torch.tanh(_mm(xw, p["td_w1"], dt)),
                p["td_w2"][:, c0:c0 + dl], dt)
    w = torch.exp(-torch.exp(p["w0"][c0:c0 + dl].float() + dlora.float())
                  ).reshape(B, T, H, N)

    if T == 1 and state is not None:
        y, S = wkv_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], p["u"].float(),
                        state["wkv"])
        y = y[:, None]
    elif rt.attn_impl == "kernel" and state is None:
        y, S = kernel_ops.wkv6(r, k, v, w, p["u"], chunk=rt.rwkv_chunk)
    else:
        y, S = wkv_chunked(r, k, v, w, p["u"],
                           None if state is None else state["wkv"],
                           rt.rwkv_chunk)

    # headwise group norm
    yf = y.reshape(B, T, H, N).float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + 64e-5)
    yf = (yf.reshape(B, T, dl) * p["ln_x"]["scale"][c0:c0 + dl]
          + p["ln_x"]["bias"][c0:c0 + dl])
    out = tp_exit(_mm(yf.to(dt) * g, p["wo"], dt), rt, sp)

    new_state = None
    if state is not None:
        new_state = {"x_prev": x[:, -1], "wkv": S.float()}
    return out, new_state


def rwkv_channel_mix(cfg, p, x, rt: Runtime, state=None):
    """-> (out (B, T, d), new state {'x_prev'} or None)."""
    B, T, d = x.shape
    last = (state["x_prev"] if state is not None
            else torch.zeros(B, d, dtype=x.dtype, device=x.device))
    x = tp_enter(x, rt, False)
    xx = _shift(x, last) - x
    xk = x + xx * p["maa_k"].to(x.dtype)
    xr = x + xx * p["maa_r"].to(x.dtype)
    dt = x.dtype
    k = torch.square(F.relu(_mm(xk, p["wk"], dt)))
    kv = _mm(k, p["wv"], dt)
    r = torch.sigmoid(_mm(xr, p["wr"], dt))
    new_state = {"x_prev": x[:, -1]} if state is not None else None
    return tp_exit(r * kv, rt, False), new_state
