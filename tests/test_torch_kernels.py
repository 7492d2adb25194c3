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

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.rmsnorm import _rmsnorm_forward as jax_rmsnorm_forward
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
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
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


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
    q, k_pool, v_pool, tbl, ctx = map(torch.tensor, _paged_case(4, 2))
    with pytest.raises(ValueError):
        tfd.split_cuda(q, k_pool, v_pool, tbl, ctx, 2)
    with pytest.raises(ValueError):
        ops.rmsnorm(x.to("meta"), torch.ones(8, device="meta"))
