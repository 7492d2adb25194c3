"""The port's CUDA kernels: their C bindings, and (on a card) each kernel
against its plain PyTorch version.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest -q tests/test_torch_cuda.py

The ``cuda``-marked tests skip where ``torch.cuda.is_available()`` is
false; the binding test runs everywhere (it reads the sources, no nvcc).
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as trms
from repro_torch.kernels import wkv6 as twkv

CTYPE = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
         "float": ctypes.c_float}


@pytest.mark.parametrize("name,module", [("rmsnorm", trms),
                                         ("flash_decode", tfd),
                                         ("flash_attention", tfa),
                                         ("wkv6", twkv)])
def test_c_entry_points_match_bindings(name, module):
    """Every entry point the Python side declares exists in the source with
    the same argument types, in order (ctypes would silently cut a pointer
    passed where the C side takes an int)."""
    src = (build.CSRC / f"{name}.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(module._SIGNATURES) <= set(decls)
    for fn, argtypes in module._SIGNATURES.items():
        params = [" ".join(p.replace("const ", "").split()[:-1])
                  .replace(" *", "*") for p in decls[fn].split(",")]
        assert [CTYPE[p] for p in params] == list(argtypes), fn
    assert f'extern "C" const char* {name}_error_string(int code)' in src


def _paged_case(dev, dtype, heads=8, kv_heads=2, seed=0):
    rng = np.random.default_rng(seed)
    B, D, bs, P, nb = 4, 128, 16, 40, 6
    ctx = np.array([1, 13, bs * 3, bs * nb], np.int32)
    perm = rng.permutation(P)[:B * nb].reshape(B, nb)
    tbl = np.where(np.arange(nb)[None] < -(-ctx // bs)[:, None], perm, -1)
    arrays = [rng.standard_normal(s, dtype=np.float32) for s in
              ((B, 1, heads, D), (P, bs, kv_heads, D), (P, bs, kv_heads, D))]
    return ([torch.tensor(a, device=dev).to(dtype) for a in arrays]
            + [torch.tensor(tbl.astype(np.int32), device=dev),
               torch.tensor(ctx, device=dev)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for n, d in ((8, 1024), (37, 1000)):
        x = (3 * torch.randn(n, d, generator=g, device=dev)).to(dtype)
        s = torch.rand(d, generator=g, device=dev) + 0.5
        y, rstd = trms.rmsnorm_cuda(x, s, 1e-6)
        y0, rstd0 = trms.rmsnorm_plain(x, s, 1e-6)
        torch.cuda.synchronize()
        assert ((y.float() - y0.float()).abs()
                <= tol + tol * y0.float().abs()).all()
        assert (rstd - rstd0).abs().max().item() < 1e-5
    case = _paged_case(dev, dtype)
    for n_splits in (1, 2, 4):
        parts = tfd.split_cuda(*case, n_splits)
        out = tfd.combine_cuda(*parts, dtype)
        ref = tfd.combine_plain(*tfd.split_plain(*case, n_splits))
        torch.cuda.synchronize()
        assert (tfd.combine_plain(*parts) - ref).abs().max().item() < 1e-5
        assert ((out.float() - ref).abs() <= tol + tol * ref.abs()).all()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rel_err(a, b):
    """max |a - b| over the scale of b (max |b|)."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


# kernel vs plain on the card, relative to the tensor's scale: f32 differs
# only by summation order (1e-5 for outputs that average, 1e-4 for grads
# summed over up to S * G terms); bf16 outputs round an f32 value that may
# differ in its last bits, so they may differ by one bf16 ulp (2^-8)
CARD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_backward_matches_plain(dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    for n, d in ((64, 1024), (37, 1000)):
        x = (3 * torch.randn(n, d, generator=g, device=dev)).to(dtype)
        gy = torch.randn(n, d, generator=g, device=dev).to(dtype)
        s = torch.rand(d, generator=g, device=dev) + 0.5
        _, rstd = trms.rmsnorm_plain(x, s, 1e-6)
        dx, ds = trms.rmsnorm_bwd_cuda(x, s, rstd, gy)
        dx0, ds0 = trms.rmsnorm_bwd_plain(x, s, rstd, gy)
        torch.cuda.synchronize()
        assert _rel_err(dx, dx0) < CARD_TOL[dtype][1]
        assert _rel_err(ds, ds0) < 1e-5          # f32 partials either way


@pytest.mark.cuda
def test_cuda_rmsnorm_output_carries_grad():
    """On a card the kernel path is differentiable: y has a grad_fn and
    x.grad, scale.grad match the plain path's (the kernel output used to be
    a bare tensor that cut the graph at every norm)."""
    dev = _card()
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal((2, 7, 256)).astype(np.float32)
    s0 = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    gy = torch.tensor(rng.standard_normal((2, 7, 256)).astype(np.float32))
    grads = {}
    for where in ("cuda", "cpu"):
        x = torch.tensor(x0, device=where, requires_grad=True)
        s = torch.tensor(s0, device=where, requires_grad=True)
        y = ops.rmsnorm(x, s)
        assert y.grad_fn is not None
        (y * gy.to(where)).sum().backward()
        assert s.grad is not None
        grads[where] = (x.grad.cpu(), s.grad.cpu())
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _rel_err(a, b) < 1e-5


def _attn_case(dev, dtype, B, S, H, Kv, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, h, D, generator=g, device=dev).to(dtype)
                   for h in (H, Kv, Kv, H))
    return q, k, v, do


ATTN_CASES = [  # B, S, H, Kv, D, causal, window
    (2, 256, 8, 4, 128, True, 0),     # GQA, whole blocks
    (1, 300, 4, 2, 128, True, 0),     # ragged S
    (1, 300, 4, 2, 128, True, 128),   # sliding window
    (2, 200, 4, 1, 128, True, 0),     # MQA
    (1, 130, 2, 2, 128, False, 0),    # not causal
    # edges of the backward's tiles (64 own rows, 32 streamed rows)
    (2, 1, 4, 2, 128, True, 0),       # S = 1
    (1, 77, 4, 2, 128, True, 0),      # S not a multiple of any tile
    (1, 1000, 4, 2, 128, True, 0),    # long, ragged
    (1, 200, 16, 2, 128, True, 0),    # G = 8 query heads per kv head
    (1, 300, 4, 2, 128, True, 48),    # a window narrower than a tile
    (1, 300, 4, 2, 128, False, 0),    # not causal, ragged
    # edges of the forward's tiles (64 own rows, 32 streamed rows)
    (2, 31, 4, 2, 128, True, 0),      # one streamed tile, not full
    (2, 33, 4, 2, 128, True, 0),      # one row into the second tile
    (1, 129, 4, 2, 128, True, 0),     # one row into the third q block
    (1, 129, 4, 2, 128, True, 32),    # a window of one streamed tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_cuda_flash_attention_matches_plain(case, dtype):
    dev = _card()
    B, S, H, Kv, D, causal, window = case
    q, k, v, do = _attn_case(dev, dtype, B, S, H, Kv, D)
    o, lse = tfa.forward_cuda(q, k, v, causal, window)
    o0, lse0 = tfa.forward_plain(q, k, v, causal, window)
    delta = tfa.attention_delta(o0, do)
    dq = tfa.dq_cuda(q, k, v, do, lse0, delta, causal, window)
    dk, dv = tfa.dkv_cuda(q, k, v, do, lse0, delta, causal, window)
    dq0 = tfa.dq_plain(q, k, v, do, lse0, delta, causal, window)
    dk0, dv0 = tfa.dkv_plain(q, k, v, do, lse0, delta, causal, window)
    torch.cuda.synchronize()
    fwd_tol, grad_tol = CARD_TOL[dtype]
    assert _rel_err(o, o0) < fwd_tol
    assert (lse - lse0).abs().max().item() < 1e-5
    if S == 1:
        # one key: the softmax has no gradient, so dq and dk are zero but
        # for the rounding of dp - delta; hold them to the scale of the
        # terms they sum, that of dv (= do here)
        scale = dv0.float().abs().max().item()
        for a in (dq, dk):
            assert a.float().abs().max().item() < grad_tol * scale
        assert _rel_err(dv, dv0) < grad_tol
    else:
        for a, b in ((dq, dq0), (dk, dk0), (dv, dv0)):
            assert _rel_err(a, b) < grad_tol
    # the same inputs give the same bits again: no atomics
    dk2, dv2 = tfa.dkv_cuda(q, k, v, do, lse0, delta, causal, window)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, tfa.dq_cuda(q, k, v, do, lse0, delta, causal,
                                       window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_forward_is_deterministic(dtype):
    """The forward kernel at a training shape (every CTA on the card busy)
    gives the same o and lse bits on every launch."""
    dev = _card()
    q, k, v, _ = _attn_case(dev, dtype, 4, 512, 16, 8, 128, seed=5)
    o, lse = tfa.forward_cuda(q, k, v, True, 0)
    for _ in range(3):
        o2, lse2 = tfa.forward_cuda(q, k, v, True, 0)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_cuda_attention_autograd_matches_reference():
    """ops.attention on the card (forward kernel, dq and dk/dv kernels via
    FlashAttentionFn) against autograd through the f32 oracle."""
    from repro_torch.kernels import ref
    dev = _card()
    q, k, v, do = _attn_case(dev, torch.float32, 2, 192, 8, 2, 128, seed=3)
    grads = []
    for fn in (ops.attention, ref.attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=True, window=0)
        out.backward(do)
        grads.append([out] + [t.grad for t in leaves])
    for a, b in zip(*grads):
        assert _rel_err(a, b) < 1e-4


@pytest.mark.cuda
def test_cuda_attention_refuses_uncompiled_head_dim():
    """A head dim with no compiled kernel raises on the card; the model's
    kernel route never falls back to the plain attention there."""
    from repro_torch.models.attention import sdpa_causal
    from repro_torch.models.layers import Runtime
    dev = _card()
    q, k, v, _ = _attn_case(dev, torch.float32, 1, 64, 4, 2, 64)
    with pytest.raises(ValueError, match="head dim 64"):
        sdpa_causal(q, k, v, 0, Runtime())


def _wkv_case(dev, dtype, B, T, H, N=64, seed=0):
    """The JAX kernel tests' distribution: r/k/v ~ N(0, 0.5²) in ``dtype``,
    w = exp(-exp(N(0, 0.5²) - 2.5)) and u ~ N(0, 0.3²) in f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (0.5 * torch.randn(B, T, H, N, generator=g, device=dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * torch.randn(B, T, H, N, generator=g,
                                               device=dev) - 2.5))
    u = 0.3 * torch.randn(H, N, generator=g, device=dev)
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u


def _bf16_ulp(x):
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


# (B, T, H, chunk): whole chunks, ragged T, T shorter than the chunk;
# then edges of the prefetch and of the CTAs: one token, one token past a
# chunk, T a multiple of the chunk, and B * H far below the SM count
WKV_CASES = [(2, 128, 4, 16), (2, 128, 4, 32), (1, 200, 3, 64),
             (2, 100, 2, 32), (1, 20, 2, 64),
             (2, 1, 3, 32), (2, 33, 3, 32), (1, 65, 2, 64), (1, 64, 2, 16),
             (1, 96, 1, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WKV_CASES)
def test_cuda_wkv6_matches_plain(case, dtype):
    """The WKV-6 kernel against its plain version on the card, y and the
    final state.  f32: within 1e-4 of scale (the chunked form multiplies
    e^{lc} by e^{-lc} factors whose f32 rounding the kernel's sequential
    sums and the plain version's matmuls expose differently).  bf16: the
    same f32 arithmetic rounded once, so within 2 bf16 ulps, or 1e-5 of
    scale where an output is so small that 2 ulps fall below the f32
    rounding; the state is f32 in both."""
    dev = _card()
    B, T, H, chunk = case
    args = _wkv_case(dev, dtype, B, T, H)
    y, s = twkv.wkv6_cuda(*args, chunk)
    y0, s0 = twkv.wkv6_plain(*args, None, chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and s.dtype == torch.float32
    assert _rel_err(s, s0) < 1e-4
    if dtype == torch.float32:
        assert _rel_err(y, y0) < 1e-4
    else:
        a, b = y.float(), y0.float()
        bound = torch.maximum(2 * _bf16_ulp(torch.maximum(a.abs(), b.abs())),
                              1e-5 * b.abs().max())
        assert bool(((a - b).abs() <= bound).all())
    # the same inputs give the same bits again
    y2, s2 = twkv.wkv6_cuda(*args, chunk)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wkv6_is_deterministic(dtype):
    """The WKV-6 kernel at a training shape gives the same y and state bits
    on every launch."""
    dev = _card()
    args = _wkv_case(dev, dtype, 4, 512, 32, seed=6)
    y, s = twkv.wkv6_cuda(*args, 32)
    for _ in range(3):
        y2, s2 = twkv.wkv6_cuda(*args, 32)
        assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.cuda
def test_cuda_wkv6_autograd_matches_plain():
    """ops.wkv6 on the card launches the kernel, carries a grad_fn, and its
    gradients (the plain chunked form replayed through autograd) equal
    autograd through the plain version, for cotangents on y and state."""
    dev = _card()
    args = _wkv_case(dev, torch.float32, 2, 96, 2, seed=1)
    g = torch.Generator(device=dev).manual_seed(2)
    gy = torch.randn(args[0].shape, generator=g, device=dev)
    gs = torch.randn(2, 2, 64, 64, generator=g, device=dev)
    grads, launches = [], []
    for fn in (lambda *a: ops.wkv6(*a, chunk=32),
               lambda *a: twkv.wkv6_plain(*a, None, 32)):
        leaves = [t.clone().requires_grad_() for t in args]
        before = twkv.LAUNCHES["wkv6"]
        y, s = fn(*leaves)
        assert y.grad_fn is not None
        ((y * gy).sum() + (s * gs).sum()).backward()
        grads.append([y, s] + [t.grad for t in leaves])
        launches.append(twkv.LAUNCHES["wkv6"] - before)
    assert launches == [1, 0]      # one forward kernel; the backward is plain
    for a, b in zip(*grads):
        assert _rel_err(a, b) < 1e-4


@pytest.mark.cuda
def test_cuda_wkv6_refuses_uncompiled_cases():
    """A head dim or chunk without a compiled kernel raises on the card;
    the model's kernel route never falls back to the plain version."""
    dev = _card()
    with pytest.raises(ValueError, match="head dim 32"):
        twkv.wkv6_cuda(*_wkv_case(dev, torch.float32, 1, 16, 2, N=32), 16)
    with pytest.raises(ValueError, match="chunk 8"):
        twkv.wkv6_cuda(*_wkv_case(dev, torch.float32, 1, 16, 2), 8)
