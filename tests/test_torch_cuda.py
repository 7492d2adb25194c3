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

CTYPE = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
         "float": ctypes.c_float}


@pytest.mark.parametrize("name,module", [("rmsnorm", trms),
                                         ("flash_decode", tfd),
                                         ("flash_attention", tfa)])
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
    for a, b in ((dq, dq0), (dk, dk0), (dv, dv0)):
        assert _rel_err(a, b) < grad_tol
    # the same inputs give the same bits again: no atomics
    assert torch.equal(dk, tfa.dkv_cuda(q, k, v, do, lse0, delta, causal,
                                        window)[0])


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
