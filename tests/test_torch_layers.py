"""The port's layers against their JAX counterparts, f32, atol 1e-5.

The same numpy inputs (fixed seed) go through ``repro.models`` and
``repro_torch.models``; parameter dicts are the same numpy arrays.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as ja
from repro.models import layers as jl
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl

ATOL = 1e-5
JRT = jl.Runtime()
TRT = {"torch": tl.Runtime(attn_impl="torch", norm_impl="torch"),
       "kernel": tl.Runtime()}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="qwen3-0.6b", **over):
    """(JAX cfg, port cfg) with the same reduced shape."""
    jc = dataclasses.replace(jax_reduced(jax_get_config(arch)), **over)
    tc = dataclasses.replace(reduced(get_config(arch)), **over)
    return jc, tc


def _close(t, j, atol=ATOL):
    a = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    b = np.asarray(jnp.asarray(j, jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err < atol, err


def _both(tree):
    """numpy dict -> (jnp dict, torch dict)."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.tensor(v) for k, v in tree.items()})


RNG = np.random.default_rng(0)


def _randn(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# norms, rope, mlp, embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind, impl):
    d = 96                                   # not a multiple of 128
    p = {"scale": 1 + _randn(d, scale=0.1)}
    if kind == "layernorm":
        p["bias"] = _randn(d, scale=0.1)
    x = _randn(2, 5, d, scale=2.0)
    jp, tp = _both(p)
    _close(tl.apply_norm(tp, torch.tensor(x), 1e-5, TRT[impl]),
           jl.apply_norm(jp, jnp.asarray(x), 1e-5, JRT))


def test_rms_norm_headwise():
    x = _randn(2, 3, 4, 32, scale=3.0)
    s = 1 + _randn(32, scale=0.1)
    _close(tl.rms_norm_headwise(torch.tensor(s), torch.tensor(x), 1e-6),
           jl.rms_norm_headwise(jnp.asarray(s), jnp.asarray(x), 1e-6))


def test_rope():
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(tl.rope_angles(torch.tensor(pos), 64, theta),
               jl.rope_angles(jnp.asarray(pos), 64, theta))
    ang = _randn(2, 5, 32, scale=3.0)
    x = _randn(2, 5, 4, 64)
    _close(tl.apply_rope(torch.tensor(x), torch.tensor(ang)),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(ang)))


@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu"),
                                     (False, "relu2")])
def test_apply_mlp(glu, act):
    jc, tc = _cfgs(glu=glu, act=act)
    d, f = tc.d_model, tc.d_ff
    p = {"w_up": _randn(d, f, scale=d ** -0.5),
         "w_down": _randn(f, d, scale=f ** -0.5)}
    if glu:
        p["w_gate"] = _randn(d, f, scale=d ** -0.5)
    x = _randn(2, 3, d)
    jp, tp = _both(p)
    _close(tl.apply_mlp(tc, tp, torch.tensor(x), TRT["torch"]),
           jl.apply_mlp(jc, jp, jnp.asarray(x), JRT))


@pytest.mark.parametrize("tied", [True, False])
def test_embed_and_logits(tied):
    V, d = 64, 32
    p = {"tok": _randn(V, d, scale=0.02)}
    if not tied:
        p["lm_head"] = _randn(d, V, scale=d ** -0.5)
    tokens = RNG.integers(0, V, (2, 7)).astype(np.int32)
    jp, tp = _both(p)
    h_t = tl.embed_tokens(tp, torch.tensor(tokens), TRT["torch"])
    h_j = jl.embed_tokens(jp, jnp.asarray(tokens), JRT)
    _close(h_t, h_j)
    h = _randn(2, 7, d)
    _close(tl.lm_logits(tp, torch.tensor(h), TRT["torch"]),
           jl.lm_logits(jp, jnp.asarray(h), JRT))


# ---------------------------------------------------------------------------
# attention pieces
# ---------------------------------------------------------------------------

def _attn_params(cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim_
    p = {"wq": _randn(d, h * hd, scale=d ** -0.5),
         "wk": _randn(d, kv * hd, scale=d ** -0.5),
         "wv": _randn(d, kv * hd, scale=d ** -0.5),
         "wo": _randn(h * hd, d, scale=(h * hd) ** -0.5)}
    if cfg.qkv_bias:
        p.update(bq=_randn(h * hd, scale=0.1), bk=_randn(kv * hd, scale=0.1),
                 bv=_randn(kv * hd, scale=0.1))
    if cfg.qk_norm:
        p.update(q_norm=1 + _randn(hd, scale=0.1),
                 k_norm=1 + _randn(hd, scale=0.1))
    return p


@pytest.mark.parametrize("over", [dict(qk_norm=True),
                                  dict(qk_norm=False, qkv_bias=True)])
def test_project_qkv(over):
    jc, tc = _cfgs(n_kv_heads=2, **over)
    jp, tp = _both(_attn_params(tc))
    x = _randn(2, 5, tc.d_model)
    for t, j in zip(ta._project_qkv(tc, tp, torch.tensor(x), TRT["torch"]),
                    ja._project_qkv(jc, jp, jnp.asarray(x), JRT)):
        _close(t, j)


def _pool_case(P=10, bs=4, Kv=2, D=8, B=3, nb=4):
    pool = _randn(P, bs, Kv, D)
    tbl = np.full((B, nb), -1, np.int32)
    tbl[0, :3] = [7, 2, 5]
    tbl[1, :1] = [0]
    tbl[2, :4] = [1, 3, 4, 9]
    return pool, tbl


def _with_sink(pool):
    return torch.cat([torch.tensor(pool),
                      torch.zeros((1,) + pool.shape[1:])])


def test_paged_write_drops_out_of_range():
    """Writes into unallocated blocks, past the table, or at the inactive
    sentinel position vanish from the real blocks (they land in the sink
    block; JAX drops them)."""
    pool, tbl = _pool_case()
    B, S, bs, nb = 3, 5, pool.shape[1], tbl.shape[1]
    pos = np.array([[0, 1, 2, 3, 4],           # all inside allocated blocks
                    [2, 3, 4, 5, 6],           # runs into a -1 block
                    [1 << 30] * 5], np.int32)  # inactive slot
    pos[2, :2] = [nb * bs, nb * bs + 3]        # past the table
    vals = _randn(B, S, pool.shape[2], pool.shape[3])
    jout = ja._paged_write(jnp.asarray(pool), jnp.asarray(vals),
                           jnp.asarray(tbl), jnp.asarray(pos))
    tpool = _with_sink(pool)
    out = ta._paged_write(tpool, torch.tensor(vals), torch.tensor(tbl),
                          torch.tensor(pos))
    assert out is tpool                        # updated in place
    np.testing.assert_array_equal(out[:-1].numpy(), np.asarray(jout))
    assert not np.array_equal(np.asarray(jout), pool)   # something landed


@pytest.mark.parametrize("Sq", [5, 1])         # prefill chunk, decode
def test_paged_attend(Sq):
    pool_k, tbl = _pool_case()
    pool_v = _randn(*pool_k.shape)
    B, H = tbl.shape[0], 4
    q = _randn(B, Sq, H, pool_k.shape[3])
    ctx0 = np.array([6, 1, 9], np.int32)
    q_pos = (ctx0[:, None] + np.arange(Sq)[None]).astype(np.int32)
    n_valid = ctx0 + Sq
    j = ja._paged_attend(jnp.asarray(q), jnp.asarray(pool_k),
                         jnp.asarray(pool_v), jnp.asarray(tbl),
                         jnp.asarray(q_pos), jnp.asarray(n_valid))
    t = ta._paged_attend(torch.tensor(q), _with_sink(pool_k),
                         _with_sink(pool_v), torch.tensor(tbl),
                         torch.tensor(q_pos), torch.tensor(n_valid))
    _close(t, j)


# ---------------------------------------------------------------------------
# cache-less attention (training): dense and chunked plain paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,window,min_chunked", [
    (40, 0, 2048),        # dense
    (40, 0, 16),          # chunked, 16/8 chunks, S padded to 48
    (37, 12, 16),         # chunked with a sliding window, ragged S
])
def test_sdpa_causal_plain_paths(S, window, min_chunked):
    q = _randn(2, S, 4, 16)
    k, v = _randn(2, S, 2, 16), _randn(2, S, 2, 16)
    chunks = dict(attn_q_chunk=16, attn_kv_chunk=8,
                  attn_min_chunked_len=min_chunked)
    trt = dataclasses.replace(TRT["torch"], **chunks)
    jrt = dataclasses.replace(JRT, **chunks)
    _close(ta.sdpa_causal(*map(torch.tensor, (q, k, v)), window, trt),
           ja.sdpa_causal(*map(jnp.asarray, (q, k, v)), window, jrt))
