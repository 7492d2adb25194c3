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
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms

TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 1024])
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
    # rows 192..255 see keys 129..255 only: blocks 0 and 1 are invisible
    # to them, blocks 2 and 3 hold every key they see
    o_cut, lse_cut = tfa.forward_plain(q[:, 128:], k[:, 128:], v[:, 128:],
                                       True, 64)
    assert torch.equal(o[:, 192:], o_cut[:, 64:])
    assert torch.equal(lse[:, :, 192:], lse_cut[:, :, 64:])


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
        tfd.split_cuda(q, k_pool, v_pool, tbl, ctx, 2)
    with pytest.raises(ValueError):
        ops.rmsnorm(x.to("meta"), torch.ones(8, device="meta"))
