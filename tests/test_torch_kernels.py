"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper in ``repro_torch.kernels.ops`` runs its kernel's
plain PyTorch version; the JAX side runs the Pallas kernel in interpret
mode.  Inputs come from numpy with a fixed seed and go to both.  The CUDA
kernels themselves are held against the plain versions on a card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_attention import _flash_forward as jax_flash_forward
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.rmsnorm import _rmsnorm_backward as jax_rmsnorm_backward
from repro.kernels.rmsnorm import _rmsnorm_forward as jax_rmsnorm_forward
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.rwkv6 import wkv6 as jax_wkv6
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels import wkv6 as twkv
from test_torch_fsdp import _few_threads  # noqa: F401

TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _rel(a, b):
    """max |a - b| over the scale of b (max |b|)."""
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# port vs Pallas (interpret mode), relative to the tensor's scale.  f32:
# the same arithmetic in another summation order (the Pallas blocks are
# 128/256, the port's 64): 1e-5 for outputs and gradients alike (observed
# <= 5.3e-7).  bf16: both round the same f32 value to bf16, which may land
# one bf16 ulp (2^-8 relative) apart, so 1e-2 (observed <= 7.6e-4);
# gradients are rounded once, at the end.  dscale and lse are f32 in both
# dtypes: 1e-5.
REL_TOL = {"f32": 1e-5, "bf16": 1e-2}


# ---------------------------------------------------------------------------
# RMSNorm forward
# ---------------------------------------------------------------------------

# d 20480: wider than the CUDA forward's 16-warp team holds (16384 f32),
# so the kernel walks the row in slices; the plain version has no limit
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 1024, 20480])
@pytest.mark.parametrize("lead", [(37,), (3, 13)])   # rows: no block multiple
def test_rmsnorm_matches_pallas(lead, d, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(lead + (d,), dtype=np.float32) * 3
    scale = 1 + 0.1 * rng.standard_normal(d, dtype=np.float32)
    eps = 1e-5
    xt = torch.tensor(x).to(TDT[dtype])
    xj = jnp.asarray(x, JDT[dtype])
    y, rstd = ops.rmsnorm_forward(xt, torch.tensor(scale), eps=eps)
    assert y.shape == xt.shape and y.dtype == xt.dtype
    y_pallas = jax_rmsnorm(xj, jnp.asarray(scale), eps=eps, block_rows=16,
                           interpret=True)
    y_ref = jref.rmsnorm_ref(xj, jnp.asarray(scale), eps)
    for other in (y_pallas, y_ref):
        assert np.max(np.abs(_np(y) - _np(other))) < TOL[dtype]
    # the residual the backward reuses: per-row rstd in f32
    _, (_, _, rstd_j) = jax_rmsnorm_forward(xj, jnp.asarray(scale), eps, 16,
                                            True)
    n = int(np.prod(lead))
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_j)[:n],
                               rtol=1e-5)
    # the port's oracle agrees with the JAX oracle too
    assert np.max(np.abs(_np(tref.rmsnorm_ref(xt, torch.tensor(scale), eps))
                         - _np(y_ref))) < TOL[dtype]


# ---------------------------------------------------------------------------
# RMSNorm backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lead,d", [((37,), 256), ((3, 13), 1024)])
def test_rmsnorm_backward_matches_pallas(lead, d, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(lead + (d,), dtype=np.float32) * 3
    g = rng.standard_normal(lead + (d,), dtype=np.float32)
    scale = 1 + 0.1 * rng.standard_normal(d, dtype=np.float32)
    eps = 1e-5
    xj, gj = jnp.asarray(x, JDT[dtype]), jnp.asarray(g, JDT[dtype])
    _, res = jax_rmsnorm_forward(xj, jnp.asarray(scale), eps, 16, True)
    dx_j, ds_j = jax_rmsnorm_backward(eps, 16, True, res, gj)

    xt, gt = torch.tensor(x).to(TDT[dtype]), torch.tensor(g).to(TDT[dtype])
    st = torch.tensor(scale)
    x2 = xt.reshape(-1, d)
    _, rstd = trms.rmsnorm_plain(x2, st, eps)
    dx, ds = trms.rmsnorm_bwd_plain(x2, st, rstd, gt.reshape(-1, d))
    assert dx.dtype == xt.dtype and ds.dtype == torch.float32
    assert _rel(dx.reshape(xt.shape), dx_j) < REL_TOL[dtype]
    assert _rel(ds, ds_j) < 1e-5
    # RMSNormFn: autograd through ops.rmsnorm runs the same backward
    xl, sl = xt.clone().requires_grad_(), st.clone().requires_grad_()
    y = ops.rmsnorm(xl, sl, eps=eps)
    assert y.grad_fn is not None
    y.backward(gt)
    assert _rel(xl.grad, dx_j) < REL_TOL[dtype]
    assert _rel(sl.grad, ds_j) < 1e-5


# the CUDA backward's edges: one row, rows below and just past its 16-row
# CTA, a ragged row count; widths of one warp (ragged, not a multiple of a
# 16-byte vector), of 4 and of 8 warps per row
RMS_BWD_EDGES = [(1, 1000), (15, 1001), (17, 4096), (4099, 1024), (33, 8192)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,d", RMS_BWD_EDGES)
def test_rmsnorm_backward_edges_match_pallas(n, d, dtype):
    """``rmsnorm_bwd_plain`` (the kernel's order: 16-row partials, then
    the reduce's warp slots) against the Pallas backward at the CUDA
    kernel's edges; dscale sums up to 4099 rows and stays within 1e-5."""
    rng = np.random.default_rng(n * 7 + d)
    x = rng.standard_normal((n, d), dtype=np.float32) * 3
    g = rng.standard_normal((n, d), dtype=np.float32)
    scale = 1 + 0.1 * rng.standard_normal(d, dtype=np.float32)
    eps = 1e-5
    rows = 16 if n < 1024 else 1024        # Pallas grid steps, interpreted
    xj, gj = jnp.asarray(x, JDT[dtype]), jnp.asarray(g, JDT[dtype])
    _, res = jax_rmsnorm_forward(xj, jnp.asarray(scale), eps, rows, True)
    dx_j, ds_j = jax_rmsnorm_backward(eps, rows, True, res, gj)
    xt, gt = torch.tensor(x).to(TDT[dtype]), torch.tensor(g).to(TDT[dtype])
    st = torch.tensor(scale)
    _, rstd = trms.rmsnorm_plain(xt, st, eps)
    dx, ds = trms.rmsnorm_bwd_plain(xt, st, rstd, gt)
    assert dx.shape == (n, d) and ds.shape == (d,)
    assert _rel(dx, np.asarray(jnp.asarray(dx_j, jnp.float32))[:n]) \
        < REL_TOL[dtype]
    assert _rel(ds, ds_j) < 1e-5


# ---------------------------------------------------------------------------
# flash attention (training): forward, and backward through the custom VJP
# ---------------------------------------------------------------------------

FLASH_CASES = [  # B, S, H, Kv, D, window
    (2, 128, 4, 2, 32, 0),      # GQA causal
    (1, 192, 4, 2, 32, 64),     # sliding window 64
    (1, 160, 4, 2, 32, 0),      # ragged S
    (1, 200, 2, 2, 16, 0),      # ragged S
    (1, 128, 4, 1, 32, 0),      # MQA
]


def _flash_inputs(case, seed=0):
    B, S, H, Kv, D, _ = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32) * 0.5
               for shape in ((B, S, H, D), (B, S, Kv, D), (B, S, Kv, D)))
    do = rng.standard_normal((B, S, H, D), dtype=np.float32)
    return q, k, v, do


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_pallas(case, dtype):
    """Forward (o, lse) against ``_flash_forward``; the gradients of
    ``FlashAttentionFn`` and of the plain backward (fed the Pallas
    forward's lse) against ``jax.grad`` through the Pallas custom VJP."""
    B, S, H, _, _, window = case
    q, k, v, do = _flash_inputs(case)
    jin = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    out_j, res = jax_flash_forward(*jin, True, window, 128, 256, True)
    lse_j = np.asarray(res[-1]).reshape(B, H, -1)[:, :, :S]   # drop pad
    tin = [torch.tensor(a).to(TDT[dtype]) for a in (q, k, v)]
    o, lse = tfa.forward_plain(*tin, True, window)
    assert o.dtype == TDT[dtype] and lse.shape == (B, H, S)
    assert _rel(o, out_j) < REL_TOL[dtype]
    assert np.max(np.abs(lse.numpy() - lse_j)) < 1e-5
    # and the port's oracle agrees with the JAX oracle
    assert _rel(tref.attention_ref(*tin, window=window),
                jref.attention_ref(*jin, window=window)) < REL_TOL[dtype]

    cot = jnp.asarray(do, JDT[dtype]).astype(jnp.float32)
    grads_j = jax.grad(lambda q, k, v: jnp.sum(jax_flash(
        q, k, v, window=window, interpret=True).astype(jnp.float32) * cot),
        (0, 1, 2))(*jin)
    leaves = [t.clone().requires_grad_() for t in tin]
    tdo = torch.tensor(do).to(TDT[dtype])
    out = ops.attention(*leaves, window=window)
    assert out.grad_fn is not None
    out.backward(tdo)
    for leaf, g_j in zip(leaves, grads_j):
        assert leaf.grad.dtype == TDT[dtype]
        assert _rel(leaf.grad, g_j) < REL_TOL[dtype]
    # the plain backward on the Pallas forward's lse (layout (B, H, S))
    delta = tfa.attention_delta(o, tdo)
    args = (*tin, tdo, torch.tensor(lse_j), delta, True, window)
    for t, g_j in zip((tfa.dq_plain(*args), *tfa.dkv_plain(*args)),
                      grads_j):
        assert _rel(t, g_j) < REL_TOL[dtype]


def test_flash_plain_skips_no_visible_block():
    """The CUDA kernels visit only blocks the causal/window bounds leave
    visible; the plain versions visit all.  A fully masked block must be
    an exact no-op of the online update, so the window's result equals
    the one computed with invisible blocks cut out of k/v."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((1, 256, 2, 16),
                                                dtype=np.float32))
               for _ in range(3))
    o, lse = tfa.forward_plain(q, k, v, True, 64)
    # rows 192..255 see keys 129..255 only: the blocks of keys 0..127 are
    # invisible to them, and the cut keeps the later blocks whole
    o_cut, lse_cut = tfa.forward_plain(q[:, 128:], k[:, 128:], v[:, 128:],
                                       True, 64)
    assert torch.equal(o[:, 192:], o_cut[:, 64:])
    assert torch.equal(lse[:, :, 192:], lse_cut[:, :, 64:])


# ---------------------------------------------------------------------------
# the backward kernels' arithmetic: f32 products as 3xTF32 on tensor cores
# ---------------------------------------------------------------------------

def _tf32(x):
    """x (f32) rounded to TF32, 10 mantissa bits, to nearest with ties away
    from zero, on the int32 view of its bits: the backward kernels'
    ``to_tf32`` (cvt.rna.tf32.f32's rounding)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a, b):
    """a @ b as the kernels multiply f32 operands: each split into hi + lo,
    a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 sums (the products of two
    11-bit significands are exact in f32), a_lo b_lo dropped."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _flash_bwd_np(q, k, v, do, lse, delta, mm):
    """dq, dk, dv of the plain backward (``dq_plain``, ``dkv_plain``), causal,
    whole-sequence, with every product taken by ``mm``."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    scale = D ** -0.5
    mask = np.tril(np.ones((S, S), bool))
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for b in range(B):
        for h in range(H):
            kh, vh = k[b, :, h // G], v[b, :, h // G]
            s = mm(q[b, :, h], kh.T)
            p = np.where(mask, np.exp(s * scale - lse[b, h, :, None]), 0)
            dp = mm(do[b, :, h], vh.T)
            ds = p * (dp - delta[b, h, :, None]) * scale
            dq[b, :, h] = mm(ds, kh)
            dk[b, :, h // G] += mm(ds.T, q[b, :, h])
            dv[b, :, h // G] += mm(p.T, do[b, :, h])
    return dq, dk, dv


def test_tf32_rounding_is_round_to_nearest_away():
    """The integer form of the split's rounding equals rounding to 11
    significant bits, ties away from zero, on random values, exact ties
    and values near powers of two; hi + lo holds x to 2^-21 of |x|."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000),
        (1 + (2 * np.arange(1, 200) - 1) * 2.0 ** -11) * 3.0,   # ties
        -(1 + (2 * np.arange(1, 200) - 1) * 2.0 ** -11),
        np.nextafter(np.float32(2.0) ** np.arange(-20, 20), np.float32(0)),
    ]).astype(np.float32)
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    want = np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5),
                    e - 11).astype(np.float32)
    assert np.array_equal(_tf32(x), want)
    hi, lo = _split(x)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - x)
                  <= 2.0 ** -21 * np.abs(x))


def test_flash_backward_3xtf32_keeps_f32_accuracy():
    """dq/dk/dv with every product split as the backward kernels split it
    (3xTF32) stay within 1e-5 of scale of the f64 result, like plain f32
    products; one TF32 product (hi * hi) would not."""
    B, S, H, Kv, D = 1, 130, 4, 2, 128
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((B, S, h, D)).astype(np.float32)
                   for h in (H, Kv, Kv, H))
    q64, k64, v64, do64 = (t.astype(np.float64) for t in (q, k, v, do))
    # lse and delta from the f64 forward, handed to every version in f32
    G, scale = H // Kv, D ** -0.5
    s = np.einsum("bqhd,bkhd->bhqk", q64, np.repeat(k64, G, axis=2)) * scale
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    o = np.einsum("bhqk,bkhd->bqhd", np.exp(s - lse[..., None]),
                  np.repeat(v64, G, axis=2))
    delta = (do64 * o).sum(-1).transpose(0, 2, 1)
    ref = _flash_bwd_np(q64, k64, v64, do64, lse, delta, np.matmul)
    lse32, delta32 = lse.astype(np.float32), delta.astype(np.float32)
    args = (q, k, v, do, lse32, delta32)
    for got, want in zip(_flash_bwd_np(*args, _mm3), ref):
        assert _rel(got, want) < 1e-5
    # the plain f32 versions of the port meet the same bar
    plain = (tfa.dq_plain(*(torch.tensor(a) for a in args), True, 0),
             *tfa.dkv_plain(*(torch.tensor(a) for a in args), True, 0))
    for got, want in zip(plain, ref):
        assert _rel(got, want) < 1e-5
    one = _flash_bwd_np(*args, lambda a, b: _tf32(a) @ _tf32(b))
    assert max(_rel(got, want) for got, want in zip(one, ref)) > 1e-4


def _flash_fwd_np(q, k, v, mm, block):
    """(o, lse) of the causal forward as the kernel computes it: the kv
    positions in tiles of ``block``, the online softmax per tile, and
    acc = acc * alpha + (p v of the tile); every product taken by ``mm``."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    scale = D ** -0.5
    neg = q.dtype.type(-1e30)
    o, lse = np.zeros_like(q), np.zeros((B, H, S), q.dtype)
    pos = np.arange(S)
    for b in range(B):
        for h in range(H):
            kh, vh = k[b, :, h // G], v[b, :, h // G]
            m = np.full(S, neg, q.dtype)
            l, acc = np.zeros(S, q.dtype), np.zeros((S, D), q.dtype)
            for k0 in range(0, S, block):
                vis = pos[k0:k0 + block][None, :] <= pos[:, None]
                s = np.where(vis, mm(q[b, :, h], kh[k0:k0 + block].T) * scale,
                             neg)
                m_new = np.maximum(m, s.max(-1))
                alpha = np.exp(m - m_new)
                p = np.where(vis, np.exp(s - m_new[:, None]), 0).astype(q.dtype)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + mm(p, vh[k0:k0 + block])
                m = m_new
            denom = np.maximum(l, 1e-30)
            o[b, :, h] = acc / denom[:, None]
            lse[b, h] = m + np.log(denom)
    return o, lse


def test_flash_forward_3xtf32_keeps_f32_accuracy():
    """o and lse with every product split as the forward kernel splits it
    (3xTF32), in its tile order and update, stay within 1e-5 of scale of
    the f64 result, like the plain f32 forward; one TF32 product
    (hi * hi) would not."""
    B, S, H, Kv, D = 1, 130, 4, 2, 128
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (H, Kv, Kv))
    ref = _flash_fwd_np(*(t.astype(np.float64) for t in (q, k, v)),
                        np.matmul, tfa.FWD_BLOCK)
    got = _flash_fwd_np(q, k, v, _mm3, tfa.FWD_BLOCK)
    for a, b in zip(got, ref):
        assert _rel(a, b) < 1e-5
    plain = tfa.forward_plain(*(torch.tensor(t) for t in (q, k, v)), True, 0)
    for a, b in zip(plain, ref):
        assert _rel(a, b) < 1e-5
    one = _flash_fwd_np(q, k, v, lambda a, b: _tf32(a) @ _tf32(b),
                        tfa.FWD_BLOCK)
    assert _rel(one[0], ref[0]) > 1e-4


@pytest.mark.parametrize("S,window", [(31, 0), (33, 0), (129, 0),
                                      (97, 40)])
def test_flash_forward_tile_edges_match_pallas(S, window):
    """The plain forward walks the kernel's FWD_BLOCK-row kv tiles, not the
    backward's 64: at S just below and above a tile, past several tiles,
    and with a window narrower than two tiles, it still equals the Pallas
    forward (interpret mode) and the oracle."""
    case = (2, S, 4, 2, 32, window)
    q, k, v, _ = _flash_inputs(case, seed=4)
    jin = [jnp.asarray(a) for a in (q, k, v)]
    out_j, res = jax_flash_forward(*jin, True, window, 128, 256, True)
    lse_j = np.asarray(res[-1]).reshape(2, 4, -1)[:, :, :S]
    tin = [torch.tensor(a) for a in (q, k, v)]
    o, lse = tfa.forward_plain(*tin, True, window)
    assert _rel(o, out_j) < REL_TOL["f32"]
    assert np.max(np.abs(lse.numpy() - lse_j)) < 1e-5
    assert _rel(o, tref.attention_ref(*tin, window=window)) < REL_TOL["f32"]


# ---------------------------------------------------------------------------
# flash-decode over a paged cache
# ---------------------------------------------------------------------------

def _paged_case(heads, kv_heads, seed=0):
    """Ragged contexts (incl. 1 and a full table), permuted pool blocks,
    unallocated (-1) table tails."""
    rng = np.random.default_rng(seed)
    B, D, bs, P, nb = 4, 16, 8, 40, 6
    q = rng.standard_normal((B, 1, heads, D), dtype=np.float32)
    k_pool = rng.standard_normal((P, bs, kv_heads, D), dtype=np.float32)
    v_pool = rng.standard_normal((P, bs, kv_heads, D), dtype=np.float32)
    ctx = np.array([1, 13, bs * 3, bs * nb], np.int32)
    perm = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    nalloc = -(-ctx // bs)
    tbl = np.where(np.arange(nb)[None] < nalloc[:, None], perm, -1)
    return q, k_pool, v_pool, tbl.astype(np.int32), ctx


@pytest.mark.parametrize("n_splits", [1, 2, 4])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (8, 1)])
def test_flash_decode_matches_pallas(heads, kv_heads, n_splits):
    case = _paged_case(heads, kv_heads)
    out = ops.paged_decode_attention(*map(torch.tensor, case),
                                     n_splits=n_splits)
    jcase = tuple(map(jnp.asarray, case))
    pallas = jax_flash_decode(*jcase, n_splits=n_splits, interpret=True)
    assert out.shape == case[0].shape
    assert np.max(np.abs(out.numpy() - np.asarray(pallas))) < 1e-5
    # and both agree with the JAX and the port oracles
    oracle = np.asarray(jref.paged_attention_ref(*jcase))
    assert np.max(np.abs(out.numpy() - oracle)) < 1e-5
    port_oracle = tref.paged_attention_ref(*map(torch.tensor, case))
    assert np.max(np.abs(port_oracle.numpy() - oracle)) < 1e-5


@pytest.mark.parametrize("n_splits", [12, 16])
@pytest.mark.parametrize("nb", [16, 20])
def test_flash_decode_many_splits_match_pallas(nb, n_splits):
    """More splits than the CUDA kernel's cluster of 4 CTAs holds (a CTA
    then takes splits r, r + 4, ...), on tables of 16 and 20 blocks: the
    split plan (``plan_splits``: min(n_splits, nb) splits of ceil(nb /
    splits) blocks, padded tail blocks masked) and the split-order merge
    against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(nb + n_splits)
    B, Kv, G, D, bs = 3, 2, 2, 32, 8
    P = B * nb + 2
    ctx = np.array([1, bs * nb, bs * nb // 2 + 3], np.int32)
    perm = rng.permutation(P)[:B * nb].reshape(B, nb)
    tbl = np.where(np.arange(nb)[None] < -(-ctx // bs)[:, None], perm, -1)
    case = [rng.standard_normal((B, 1, G * Kv, D), dtype=np.float32),
            *(rng.standard_normal((P, bs, Kv, D), dtype=np.float32)
              for _ in range(2)), tbl.astype(np.int32), ctx]
    assert tfd.plan_splits(nb, n_splits)[0] == min(n_splits, nb)
    assert _decode_vs_pallas(case, "f32", n_splits) < 1e-5
    # the merge of the splits' partials equals the merge of one split
    tin = [torch.tensor(a) for a in case]
    one = ops.paged_decode_attention(*tin, n_splits=1)
    assert _rel(ops.paged_decode_attention(*tin, n_splits=n_splits),
                one) < 1e-5


def _decode_edges(G, D, dtype, seed=0):
    """Kv 2, bs 16, a table of 8 blocks: contexts of one position, exactly
    at a block edge, a full table and a ragged one; permuted pool blocks,
    unallocated (-1) tails."""
    rng = np.random.default_rng(seed)
    B, Kv, bs, nb = 4, 2, 16, 8
    P = B * nb + 3
    q = rng.standard_normal((B, 1, G * Kv, D), dtype=np.float32)
    pools = [rng.standard_normal((P, bs, Kv, D), dtype=np.float32)
             for _ in range(2)]
    ctx = np.array([1, 2 * bs, bs * nb, 37], np.int32)
    perm = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    tbl = np.where(np.arange(nb)[None] < -(-ctx // bs)[:, None], perm, -1)
    return [q, *pools, tbl.astype(np.int32), ctx]


def _decode_vs_pallas(case, dtype, n_splits):
    tin = [torch.tensor(a) for a in case]
    tin[:3] = [t.to(TDT[dtype]) for t in tin[:3]]
    out = ops.paged_decode_attention(*tin, n_splits=n_splits)
    jin = [jnp.asarray(a) for a in case]
    jin[:3] = [a.astype(JDT[dtype]) for a in jin[:3]]
    pallas = jax_flash_decode(*jin, n_splits=n_splits, interpret=True)
    assert out.shape == case[0].shape and out.dtype == TDT[dtype]
    return _rel(out, pallas)


@pytest.mark.parametrize("n_splits", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_flash_decode_edges_match_pallas(G, D, n_splits):
    """``split_plain`` in the CUDA kernel's order (chunks of 8 positions
    per warp, 8 warps, merged in order) against the Pallas kernel at the
    kernel's edges: G, D, splits, ctx 1, ctx at a block edge."""
    assert _decode_vs_pallas(_decode_edges(G, D, "f32"), "f32",
                             n_splits) < 1e-5


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_decode_long_context_matches_pallas(dtype):
    """One request of 1024 positions over 64 blocks (16 rounds of the
    kernel's 8 warps x 8 positions per split), and bf16 pools."""
    rng = np.random.default_rng(4)
    bs, nb, Kv, G, D = 16, 64, 1, 2, 64
    case = [rng.standard_normal(s, dtype=np.float32) for s in
            ((1, 1, G * Kv, D), (nb, bs, Kv, D), (nb, bs, Kv, D))]
    case += [rng.permutation(nb)[None].astype(np.int32),
             np.array([bs * nb], np.int32)]
    assert _decode_vs_pallas(case, dtype, 4) < REL_TOL[dtype]


def test_flash_decode_empty_splits_vanish():
    """A split whose blocks all lie past ctx carries m = NEG_INF, l = 0,
    acc = 0 and contributes nothing to the merge."""
    q, k_pool, v_pool, tbl, ctx = map(torch.tensor, _paged_case(4, 2))
    acc, m, l = tfd.split_plain(q, k_pool, v_pool, tbl, ctx, 4)
    # splits = min(4, nb=6) = 4 of 2 blocks each: the table pads to 8
    assert acc.shape == (4 * 2, 4, 2, 16)
    # request 0 has ctx 1: only its first split sees a valid position
    assert torch.all(m[:2, 1:] == tfd.NEG_INF)
    assert torch.all(l[:2, 1:] == 0) and torch.all(acc[:2, 1:] == 0)
    one_split = tfd.combine_plain(*tfd.split_plain(q, k_pool, v_pool, tbl,
                                                   ctx, 1))
    assert torch.max(torch.abs(tfd.combine_plain(acc, m, l)
                               - one_split)) < 1e-5


def test_wrappers_refuse_other_devices():
    """No silent fallback: the CUDA launchers refuse host tensors, and the
    public wrappers refuse devices that have no kernel."""
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        trms.rmsnorm_cuda(x, torch.ones(8), 1e-6)
    with pytest.raises(ValueError):
        trms.rmsnorm_bwd_cuda(x, torch.ones(8), torch.ones(4), x)
    qkv = [torch.zeros(1, 64, 2, 32) for _ in range(3)]
    with pytest.raises(ValueError):
        tfa.forward_cuda(*qkv)
    q, k_pool, v_pool, tbl, ctx = map(torch.tensor, _paged_case(4, 2))
    with pytest.raises(ValueError):
        tfd.decode_cuda(q, k_pool, v_pool, tbl, ctx, 2)
    with pytest.raises(ValueError):
        ops.rmsnorm(x.to("meta"), torch.ones(8, device="meta"))
    rkvw = [torch.zeros(1, 16, 2, 64) for _ in range(4)]
    with pytest.raises(ValueError):
        twkv.wkv6_cuda(*rkvw, torch.zeros(2, 64), 32)


def test_flash_decode_has_one_launch_path():
    """The splits and their merge are one kernel: no separate split or
    combine launcher, no combine counter, and the C library's entry points
    are the one-launch kernel's."""
    for gone in ("split_cuda", "combine_cuda"):
        assert not hasattr(tfd, gone)
    assert set(tfd.LAUNCHES) == {"flash_decode"}
    assert set(tfd._SIGNATURES) == {"flash_decode_f32", "flash_decode_bf16"}


# ---------------------------------------------------------------------------
# WKV-6
# ---------------------------------------------------------------------------

def _wkv_case(B, T, H, N, seed=0, dtype=np.float32):
    """The JAX kernel tests' distribution: r/k/v ~ N(0, 0.5²), decay
    w = exp(-exp(N(0, 0.5²) - 2.5)) (per-step log w from -0.03 to -0.4),
    u ~ N(0, 0.3²)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N), dtype=np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(0.5 * rng.standard_normal((B, T, H, N),
                                                 dtype=np.float32) - 2.5))
    u = 0.3 * rng.standard_normal((H, N), dtype=np.float32)
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


def _bf16_ulp(x):
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


WKV_CASES = [(2, 64, 2, 32, 16), (1, 100, 3, 64, 32),    # ragged T
             (2, 33, 2, 16, 8), (1, 128, 1, 64, 64)]


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_matches_pallas(case):
    """y and the final state from a zero state: the plain version (what
    ``ops.wkv6`` runs on the CPU) against the Pallas kernel in interpret
    mode (the same chunked formula: 1e-4, observed <= 4e-6 at output scales
    of 5-12) and against both sequential oracles (1e-3, the JAX test's
    bar)."""
    B, T, H, N, chunk = case
    arrays = _wkv_case(B, T, H, N)
    y, s = ops.wkv6(*map(torch.tensor, arrays), chunk=chunk)
    assert y.shape == (B, T, H, N) and s.shape == (B, H, N, N)
    yj, sj = jax_wkv6(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    s0 = np.zeros((B, H, N, N), np.float32)
    yr, sr = jref.wkv6_ref(*map(jnp.asarray, arrays), jnp.asarray(s0))
    yt, st = tref.wkv6_ref(*map(torch.tensor, arrays), torch.tensor(s0))
    for (a, b), bar in (((y, yj), 1e-4), ((s, sj), 1e-4), ((y, yr), 1e-3),
                        ((s, sr), 1e-3), ((yt, yr), 1e-4), ((st, sr), 1e-4)):
        assert np.max(np.abs(_np(a) - _np(b))) < bar


def test_wkv6_bf16_matches_pallas():
    """bf16 r/k/v, f32 w and u: both compute in f32 and round y to bf16
    once, so they agree within one bf16 ulp; the state is f32 in both."""
    B, T, H, N, chunk = 2, 64, 2, 64, 32
    r, k, v, w, u = _wkv_case(B, T, H, N, seed=4)
    bt = [torch.tensor(a).to(torch.bfloat16) for a in (r, k, v)]
    y, s = ops.wkv6(*bt, torch.tensor(w), torch.tensor(u), chunk=chunk)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    yj, sj = jax_wkv6(*(jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)),
                      jnp.asarray(w), jnp.asarray(u), chunk=chunk,
                      interpret=True)
    assert yj.dtype == jnp.bfloat16
    assert _rel(y, yj) < REL_TOL["bf16"]
    a, b = _np(y), _np(yj)
    assert np.all(np.abs(a - b) <= _bf16_ulp(np.maximum(np.abs(a),
                                                         np.abs(b))))
    assert _rel(s, sj) < REL_TOL["f32"]


def test_wkv6_plain_carries_state():
    """The state orientation (decay scales rows, the key channel) and its
    carry: two calls joined by the state equal one call, and a non-zero
    initial state matches the sequential oracle and the JAX chunked form.
    A transposed decay would pass a one-chunk y test from a zero state."""
    B, T, H, N, chunk = 2, 96, 2, 32, 16
    r, k, v, w, u = map(torch.tensor, _wkv_case(B, T, H, N, seed=5))
    s0 = torch.tensor(0.3 * np.random.default_rng(6).standard_normal(
        (B, H, N, N)).astype(np.float32))
    y, s = twkv.wkv6_plain(r, k, v, w, u, s0, chunk)
    cut = 40                                   # not a chunk multiple
    y1, s1 = twkv.wkv6_plain(r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut],
                             u, s0, chunk)
    y2, s2 = twkv.wkv6_plain(r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:],
                             u, s1, chunk)
    assert _rel(torch.cat([y1, y2], 1), y) < 1e-5 and _rel(s2, s) < 1e-5
    yr, sr = tref.wkv6_ref(r, k, v, w, u, s0)
    assert _rel(y, yr) < 1e-5 and _rel(s, sr) < 1e-5
    yj, sj = jax_wkv_chunked(*(jnp.asarray(a.numpy()) for a in
                               (r, k, v, w, u, s0)), chunk)
    assert _rel(y, yj) < 1e-5 and _rel(s, sj) < 1e-5
    # the decay scales the rows of S (the key channel n): one step with
    # k = 0 leaves S_1 = w[n] * S_0[n, m]
    _, s_one = twkv.wkv6_plain(r[:, :1], 0 * k[:, :1], v[:, :1], w[:, :1],
                               u, s0, chunk)
    assert _rel(s_one, w[:, 0, :, :, None] * s0) < 1e-6


@pytest.mark.parametrize("with_state_grad", [True, False])
def test_wkv6_grads_match_jax_vjp(with_state_grad):
    """``WKV6Fn``'s backward (autograd through the plain chunked form)
    against ``jax.vjp`` of the Pallas ``wkv6`` (whose backward replays the
    jnp chunked form): r, k, v, w and u within 1e-3 of each gradient's
    scale (the JAX kernel tests' bar; observed ~1e-6)."""
    B, T, H, N, chunk = 2, 80, 2, 32, 16       # ragged last chunk
    arrays = _wkv_case(B, T, H, N, seed=7)
    rng = np.random.default_rng(8)
    gy = rng.standard_normal((B, T, H, N)).astype(np.float32)
    gs = (rng.standard_normal((B, H, N, N)).astype(np.float32)
          if with_state_grad else np.zeros((B, H, N, N), np.float32))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    y, s = ops.wkv6(*leaves, chunk=chunk)
    assert y.grad_fn is not None
    loss = (y * torch.tensor(gy)).sum()
    if with_state_grad:
        loss = loss + (s * torch.tensor(gs)).sum()
    loss.backward()
    _, pullback = jax.vjp(
        lambda *a: jax_wkv6(*a, chunk=chunk, interpret=True),
        *map(jnp.asarray, arrays))
    jgrads = pullback((jnp.asarray(gy), jnp.asarray(gs)))
    for t, g in zip(leaves, jgrads):
        assert t.grad.shape == g.shape
        assert _rel(t.grad, g) < 1e-3
