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
from test_torch_fsdp import _few_threads  # noqa: F401

CTYPE = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
         "float": ctypes.c_float}


@pytest.mark.parametrize("name,module", [("rmsnorm", trms),
                                         ("flash_decode", tfd),
                                         ("flash_attention", tfa),
                                         ("wkv6", twkv),
                                         ("flash_attention_bf16", tfa)])
def test_c_entry_points_match_bindings(name, module):
    """Every entry point the Python side declares exists in the source with
    the same argument types, in order (ctypes would silently cut a pointer
    passed where the C side takes an int).  A module with a library per
    dtype names each library's entry points in ``_SIGNATURES_OF``."""
    src = (build.CSRC / f"{name}.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    signatures = getattr(module, "_SIGNATURES_OF", {}).get(
        name, module._SIGNATURES)
    assert set(signatures) <= set(decls)
    for fn, argtypes in signatures.items():
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
        out = tfd.decode_cuda(*case, n_splits)
        again = tfd.decode_cuda(*case, n_splits)
        ref = tfd.combine_plain(*tfd.split_plain(*case, n_splits))
        torch.cuda.synchronize()
        ref = ref.reshape(out.shape)
        assert out.dtype == dtype
        assert ((out.float() - ref).abs() <= tol + tol * ref.abs()).all()
        assert torch.equal(out, again)


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


# |kernel - plain| <= atol + rtol * |plain|, element by element: f32 differs
# by summation order only; bf16 outputs may land one bf16 ulp apart
ELEM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


def _close(a, b, dtype):
    atol, rtol = ELEM_TOL[dtype]
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def _rms_bwd_case(dev, dtype, n, d, seed=0, offset=0):
    """x, g (n, d) in ``dtype`` (starting ``offset`` elements into their
    buffers), scale (d,), rstd (n,) from the plain forward."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x, gy = ((3 * torch.randn(n * d + offset, generator=g, device=dev))
             .to(dtype)[offset:].view(n, d) for _ in range(2))
    s = torch.rand(d, generator=g, device=dev) + 0.5
    _, rstd = trms.rmsnorm_plain(x, s, 1e-6)
    return x, s, rstd, gy


def _check_rms_bwd(case, dtype):
    dx, ds = trms.rmsnorm_bwd_cuda(*case)
    dx0, ds0 = trms.rmsnorm_bwd_plain(*case)
    dx2, ds2 = trms.rmsnorm_bwd_cuda(*case)
    torch.cuda.synchronize()
    assert _close(dx, dx0, dtype)
    assert _rel_err(ds, ds0) < 1e-5          # f32 partials either way
    # the same inputs give the same bits again: fixed-order dscale
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


# the backward's edges: one row, rows below and just past its 16-row CTA,
# a ragged count; widths of one warp per row (1001: no 16-byte vectors),
# of 4 and of 8 warps per row
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1000, 1001, 4096, 8192])
@pytest.mark.parametrize("n", [1, 15, 17, 4099])
def test_cuda_rmsnorm_backward_edges(n, d, dtype):
    dev = _card()
    _check_rms_bwd(_rms_bwd_case(dev, dtype, n, d, seed=n + d), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(4096, 1024), (37, 256), (20, 16384),
                                 (3, 100)])
def test_cuda_rmsnorm_backward_shapes(n, d, dtype):
    """The training shape, the narrowest and widest row tiles, and inputs
    off a 16-byte boundary (scalar loads)."""
    dev = _card()
    _check_rms_bwd(_rms_bwd_case(dev, dtype, n, d, seed=d), dtype)
    _check_rms_bwd(_rms_bwd_case(dev, dtype, n, d, seed=d, offset=1), dtype)


@pytest.mark.cuda
def test_cuda_rmsnorm_backward_refuses_wide_rows():
    dev = _card()
    case = _rms_bwd_case(dev, torch.float32, 2, trms.BWD_MAX_D + 1)
    with pytest.raises(ValueError, match="BWD_MAX_D"):
        trms.rmsnorm_bwd_cuda(*case)


# the forward's edges: a ragged row count past the training rows; a width
# wider than a 16-warp team holds (walked in slices); ragged widths; inputs
# off a 16-byte boundary (scalar loads); few rows (a team of 2-16 warps a
# row, 8 values a lane) and just more than the card's CTAs (rows share
# CTAs, a warp a row)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,offset", [(4099, 1024, 0), (4099, 1024, 1),
                                        (8, 1024, 1), (5, 20000, 0),
                                        (5, 20000, 1), (33, 16385, 0),
                                        (17, 1001, 0), (3, 100, 1),
                                        (64, 4096, 0), (100, 2000, 1),
                                        (256, 512, 0), (257, 1024, 0),
                                        (600, 3000, 1)])
def test_cuda_rmsnorm_forward_edges(n, d, offset, dtype):
    dev = _card()
    x, s, _, _ = _rms_bwd_case(dev, dtype, n, d, seed=n + d, offset=offset)
    y, rstd = trms.rmsnorm_cuda(x, s, 1e-6)
    y0, rstd0 = trms.rmsnorm_plain(x, s, 1e-6)
    y2, rstd2 = trms.rmsnorm_cuda(x, s, 1e-6)
    torch.cuda.synchronize()
    assert y.dtype == dtype and rstd.dtype == torch.float32
    assert _close(y, y0, dtype)
    assert (rstd - rstd0).abs().max().item() < 1e-5
    # the same inputs give the same bits again
    assert torch.equal(y, y2) and torch.equal(rstd, rstd2)


def _decode_case(dev, dtype, G, D, ctx, Kv=2, bs=16, nb=64, seed=0,
                 offset=0):
    """Permuted pool blocks, -1 table tails; the pools start ``offset``
    elements into their buffers."""
    rng = np.random.default_rng(seed)
    B = len(ctx)
    P = B * nb + 3
    ctx = np.array(ctx, np.int32)
    perm = rng.permutation(P)[:B * nb].reshape(B, nb)
    tbl = np.where(np.arange(nb)[None] < -(-ctx // bs)[:, None], perm, -1)
    q = torch.tensor(rng.standard_normal((B, 1, G * Kv, D),
                                         dtype=np.float32), device=dev)
    pools = [torch.tensor(rng.standard_normal(P * bs * Kv * D + offset,
                                              dtype=np.float32), device=dev)
             .to(dtype)[offset:].view(P, bs, Kv, D) for _ in range(2)]
    return [q.to(dtype), *pools, torch.tensor(tbl.astype(np.int32),
                                              device=dev),
            torch.tensor(ctx, device=dev)]


def _check_decode(case, dtype, n_splits):
    """The one-launch output (the splits merged inside their cluster: no
    partial reaches device memory) against the plain splits merged by the
    plain combine, and its bits on a second launch."""
    out = tfd.decode_cuda(*case, n_splits)
    again = tfd.decode_cuda(*case, n_splits)
    ref = tfd.combine_plain(*tfd.split_plain(*case, n_splits))
    torch.cuda.synchronize()
    assert out.shape == case[0].shape and out.dtype == dtype
    assert _close(out, ref.reshape(out.shape), dtype)
    assert torch.equal(out, again)


# ctx of one position, exactly at a block edge, a full table of 1024
# positions and a ragged one
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_splits", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_cuda_flash_decode_split_edges(G, D, n_splits, dtype):
    dev = _card()
    case = _decode_case(dev, dtype, G, D, (1, 32, 1024, 37), seed=G * D)
    _check_decode(case, dtype, n_splits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_long_context(dtype):
    """B 8 at ctx 4096 (256 blocks), Kv 8, G 2, D 128, 4 splits."""
    dev = _card()
    case = _decode_case(dev, dtype, 2, 128, (4096,) * 8, Kv=8, nb=256,
                        seed=7)
    _check_decode(case, dtype, 4)


# G, D, bs, nb, splits: head counts and widths between the compiled
# tiles, a head dim off the 16-byte vectors, a block size that does not
# divide the 8-position chunks, the widest tile
ODD_DECODE = [(3, 99, 5, 7, 3), (5, 40, 8, 9, 2), (16, 256, 16, 6, 4),
              (2, 128, 16, 5, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", ODD_DECODE)
def test_cuda_flash_decode_odd_shapes(case, offset):
    dev = _card()
    G, D, bs, nb, n_splits = case
    args = _decode_case(dev, torch.float32, G, D, (1, bs * 2, bs * nb - 1),
                        bs=bs, nb=nb, seed=D, offset=offset)
    _check_decode(args, torch.float32, n_splits)


# more splits than a cluster holds (a CTA takes splits r, r + 4, ...), on
# tables of 16 and more blocks
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_splits,nb", [(12, 16), (12, 40), (16, 16),
                                         (16, 64)])
def test_cuda_flash_decode_many_splits(n_splits, nb, dtype):
    dev = _card()
    case = _decode_case(dev, dtype, 2, 128, (1, 16 * nb, 37, 16 * nb - 5),
                        nb=nb, seed=n_splits + nb)
    _check_decode(case, dtype, n_splits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_empty_splits(dtype):
    """ctx 1 with 4 splits: three CTAs of each cluster have no position to
    read; they still meet the cluster's barriers and contribute nothing."""
    dev = _card()
    case = _decode_case(dev, dtype, 2, 128, (1, 1, 2, 1), nb=8, seed=3)
    _check_decode(case, dtype, 4)


# G past one head tile (MAX_G 16): MQA granite-20b (G 48: three tiles of
# 16), qwen2-1.5b's G 6, and tiles that do not divide G evenly (17: 9 + 8;
# 40: 14 + 14 + 12); ctx of one position, a block edge, 320 and 4096
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Kv,n_splits", [(48, 1, 4), (48, 1, 1),
                                           (6, 2, 4), (17, 1, 2),
                                           (40, 2, 12)])
def test_cuda_flash_decode_head_tiles(G, Kv, n_splits, dtype):
    dev = _card()
    case = _decode_case(dev, dtype, G, 128, (1, 32, 320, 4096), Kv=Kv,
                        nb=256, seed=G + n_splits)
    _check_decode(case, dtype, n_splits)


@pytest.mark.cuda
def test_cuda_flash_decode_refuses_wide_tiles():
    dev = _card()
    case = _decode_case(dev, torch.float32, 2, tfd.MAX_D + 1, (16,), nb=2)
    with pytest.raises(ValueError, match="MAX_D"):
        tfd.decode_cuda(*case, 2)
    # G 16, D 256 with 64 splits: 8 split states per CTA overflow its
    # shared memory
    case = _decode_case(dev, torch.float32, 16, 256, (16,), nb=64)
    assert tfd.decode_smem_bytes(16, 256, 64) > build.SMEM_LIMIT
    with pytest.raises(ValueError, match="SMEM_LIMIT"):
        tfd.decode_cuda(*case, 64)


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
    # head dim 80 (h2o-danube-1.8b: tiles padded to 96 columns)
    (2, 256, 8, 2, 80, True, 0),      # GQA, whole blocks
    (1, 300, 4, 1, 80, True, 128),    # ragged S, window
    (2, 33, 4, 2, 80, True, 0),       # one row into the second tile
    (1, 130, 2, 2, 80, False, 0),     # not causal
    (2, 1, 4, 2, 80, True, 0),        # S = 1
    # head dim 64 (musicgen-medium's MHA, the reduced qwen2-vl's G 2)
    (2, 512, 24, 24, 64, True, 0),    # musicgen-medium's heads
    (2, 256, 4, 2, 64, True, 0),      # GQA, G 2
    (1, 300, 4, 2, 64, True, 128),    # ragged S, window
    (2, 33, 4, 4, 64, True, 0),       # one row into the second tile
    (1, 130, 2, 2, 64, False, 0),     # not causal
    (2, 1, 4, 2, 64, True, 0),        # S = 1
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


# edges of the bf16 kernels' tiles (flash_attention_bf16.cu: 64 own rows,
# 64 streamed rows): B, Sq, Sk, H, Kv, D, causal, window, q0 — one row
# short of a tile and one row past it, at each head dim (D 80: rows of 11
# 16-byte chunks, a k loop of 5 steps of 16), with a window and at an
# offset
BF16_TILE_CASES = [
    (2, 63, 63, 4, 2, 128, True, 0, 0),
    (2, 65, 65, 4, 2, 128, True, 0, 0),
    (1, 127, 127, 8, 2, 128, True, 64, 0),
    (1, 129, 129, 4, 1, 128, False, 0, 0),
    (2, 63, 63, 4, 2, 80, True, 0, 0),
    (2, 65, 65, 8, 2, 80, True, 0, 0),
    (1, 129, 129, 4, 1, 80, True, 64, 0),
    (1, 127, 127, 2, 2, 80, False, 0, 0),
    (2, 65, 65, 4, 4, 64, True, 0, 0),
    (1, 127, 127, 4, 2, 64, True, 63, 0),
    (1, 65, 193, 4, 2, 128, True, 0, 128),
    (1, 63, 190, 4, 2, 80, True, 65, 127),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_TILE_CASES)
def test_cuda_flash_bf16_tile_edges(case):
    """The bf16 forward, dq and dk/dv at the edges of their tiles against
    the plain versions at ``CARD_TOL``, and the same bits from a second
    launch of each."""
    dev = _card()
    B, S, Sk, H, Kv, D, causal, window, q0 = case
    g = torch.Generator(device=dev).manual_seed(S + Sk + D)
    q, do = (torch.randn(B, S, H, D, generator=g, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, Sk, Kv, D, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    o, lse = tfa.forward_cuda(q, k, v, causal, window, q0)
    o0, lse0 = tfa.forward_plain(q, k, v, causal, window, q0)
    delta = tfa.attention_delta(o0, do)
    args = (q, k, v, do, lse0, delta, causal, window, q0)
    dq, (dk, dv) = tfa.dq_cuda(*args), tfa.dkv_cuda(*args)
    dq0, (dk0, dv0) = tfa.dq_plain(*args), tfa.dkv_plain(*args)
    torch.cuda.synchronize()
    fwd_tol, grad_tol = CARD_TOL[torch.bfloat16]
    assert _rel_err(o, o0) < fwd_tol
    assert (lse - lse0).abs().max().item() < 1e-5
    for a, b in ((dq, dq0), (dk, dk0), (dv, dv0)):
        assert _rel_err(a, b) < grad_tol
    o2, lse2 = tfa.forward_cuda(q, k, v, causal, window, q0)
    dq2, (dk2, dv2) = tfa.dq_cuda(*args), tfa.dkv_cuda(*args)
    for a, b in ((o, o2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


# B, S (query rows), Sk (keys), H, Kv, D, q0 (the rows' first position),
# window: a context rank's shard of the queries against every key
ATTN_Q0_CASES = [
    (2, 128, 256, 8, 4, 128, 128, 0),   # rank 1 of 2: rows 128..255
    (2, 128, 256, 8, 4, 128, 0, 0),     # rank 0 of 2: fewer rows than keys
    (1, 100, 400, 4, 2, 128, 300, 0),   # rank 3 of 4, ragged tiles
    (1, 100, 400, 4, 2, 128, 200, 64),  # a window over the offset rows
    (2, 75, 300, 4, 1, 80, 150, 0),     # head dim 80, MQA
    (2, 128, 256, 8, 8, 64, 128, 0),    # head dim 64, MHA
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_Q0_CASES)
def test_cuda_flash_attention_with_query_offset_matches_plain(case, dtype):
    """The forward, dq and dk/dv kernels with a query offset q0 (rows at
    positions q0 + i against keys 0..Sk-1) against their plain versions
    at the same offset, counted under their ``_q0`` names."""
    dev = _card()
    B, S, Sk, H, Kv, D, q0, window = case
    g = torch.Generator(device=dev).manual_seed(q0 + S)
    q, do = (torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, Kv, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    ops.reset_launch_counts()
    o, lse = tfa.forward_cuda(q, k, v, True, window, q0)
    o0, lse0 = tfa.forward_plain(q, k, v, True, window, q0)
    delta = tfa.attention_delta(o0, do)
    args = (q, k, v, do, lse0, delta, True, window, q0)
    dq, (dk, dv) = tfa.dq_cuda(*args), tfa.dkv_cuda(*args)
    dq0, (dk0, dv0) = tfa.dq_plain(*args), tfa.dkv_plain(*args)
    torch.cuda.synchronize()
    fwd_tol, grad_tol = CARD_TOL[dtype]
    assert _rel_err(o, o0) < fwd_tol
    assert (lse - lse0).abs().max().item() < 1e-5
    for a, b in ((dq, dq0), (dk, dk0), (dv, dv0)):
        assert _rel_err(a, b) < grad_tol
    want = {tfa.counter_name(name, D, S, Sk, q0): 1 for name in tfa.KERNELS}
    assert all(name.endswith("_q0") for name in want)
    assert {k: v for k, v in ops.launch_counts().items() if v} == want


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
    """A head dim with no compiled kernel (32: every config's is 64, 80 or
    128) raises on the card; the model's kernel route never falls back to
    the plain attention there."""
    from repro_torch.models.attention import sdpa_causal
    from repro_torch.models.layers import Runtime
    dev = _card()
    q, k, v, _ = _attn_case(dev, torch.float32, 1, 64, 4, 2, 32)
    with pytest.raises(ValueError, match="head dim 32"):
        sdpa_causal(q, k, v, 0, Runtime())


@pytest.mark.cuda
def test_cuda_flash_at_head_dim_64_counts_its_own_launches():
    """At head dim 64 the forward, dq and dk/dv launches count under their
    ``_d64`` names, and the autograd route through the model's attention
    gives the plain path's output and gradients (f32, within 1e-4 of
    scale)."""
    from repro_torch.models.attention import sdpa_causal
    from repro_torch.models.layers import Runtime
    dev = _card()
    q, k, v, do = _attn_case(dev, torch.float32, 2, 512, 24, 24, 64, seed=3)
    outs = []
    for rt in (Runtime(), Runtime(attn_impl="torch")):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        ops.reset_launch_counts()
        out = sdpa_causal(*leaves, 0, rt)
        out.backward(do)
        torch.cuda.synchronize()
        outs.append(([out] + [t.grad for t in leaves],
                     ops.launch_counts()))
    (kern, counts), (plain, plain_counts) = outs
    assert {k: v for k, v in counts.items() if v} == {
        "flash_attention_d64": 1, "flash_attention_dq_d64": 1,
        "flash_attention_dkv_d64": 1}
    assert not any(plain_counts.values())
    for a, b in zip(kern, plain):
        assert _rel_err(a, b) < 1e-4


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


# ---------------------------------------------------------------------------
# data-parallel training on the card (FSDP2 over NCCL)
# ---------------------------------------------------------------------------

def _fsdp_cfg():
    """qwen3 at 2 layers of d 512: 4 heads of the kernels' head dim 128,
    2 kv heads."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config("qwen3-0.6b"),
                                       d_model=512), n_kv_heads=2)


@pytest.mark.cuda
def test_cuda_fsdp_on_one_rank_matches_the_unsharded_step():
    """``fsdp`` in f32 on a 1-rank NCCL mesh (what a strategy run on one
    card brings up: the tensor-parallel lowering, every parameter a
    ``DTensor`` on the (data, model) mesh) gives the unsharded kernel
    path's loss and gradients within 1e-6 of their scale; the test prints
    whether they match bit for bit."""
    from repro_torch import strategy
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as par
    from repro_torch.launch.mesh import init_distributed, shutdown
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import Runtime
    from torch.distributed.tensor import DTensor

    dev = _card()
    cfg = _fsdp_cfg()
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (4, 65), generator=g, device=dev)
    labels = toks[:, 1:].clone()
    labels[1, 40:] = -1
    batch = {"tokens": toks[:, :-1].int(), "labels": labels.int()}

    def loss_and_grads(params, rt):
        loss, _ = tfm.loss_fn(cfg, params, batch, rt)
        loss.backward()
        return loss.detach(), {
            n: (p.grad.full_tensor() if isinstance(p.grad, DTensor)
                else p.grad) for n, p in params.named_parameters()}

    loss0, grads0 = loss_and_grads(tfm.init_params(cfg, 0, dev), Runtime())
    init_distributed(dev)
    try:
        shape = ShapeConfig("card", 64, 4, "train")
        plan = strategy.parse("fsdp").to_plan(cfg, strategy.host_topology(),
                                              shape)
        params = par.apply_plan(tfm.init_params(cfg, 0, dev), plan, cfg)
        assert all(isinstance(p, DTensor) and p.device_mesh.mesh_dim_names
                   == ("data", "model") for p in params.parameters())
        loss1, grads1 = loss_and_grads(params,
                                       par.make_runtime(cfg, plan, shape,
                                                        remat=False))
    finally:
        shutdown()
    assert abs(loss1.item() - loss0.item()) <= 1e-6 * abs(loss0.item())
    rels = {n: _rel_err(grads1[n], grads0[n]) for n in grads0}
    assert max(rels.values()) <= 1e-6, rels
    same = torch.equal(loss1, loss0) and all(
        torch.equal(grads1[n], grads0[n]) for n in grads0)
    print(f"fsdp on a 1-rank NCCL mesh vs unsharded: loss |d| "
          f"{abs(loss1.item() - loss0.item()):.3g}, worst gradient "
          f"{max(rels.values()):.3g} of scale; bit for bit: {same}")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["fsdp", "fsdp_tp2", "fsdp_pp2_mb4_1f1b"])
def test_cuda_fsdp_two_cards_train_the_losses_of_one(spec):
    """``torchrun --nproc_per_node 2`` over two cards (NCCL) trains the
    losses of one unsharded rank, data-parallel (``fsdp``),
    tensor-parallel (``fsdp_tp2``: the heads, FFN and vocabulary split
    over the two cards) or pipelined (``fsdp_pp2_mb4_1f1b``: one stage a
    card, activations and cotangents over NCCL point-to-point); the plain
    layers, as the smoke config's head dim has no compiled kernel."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    train = ["-m", "repro_torch.launch.train", "--reduced", "--kernels",
             "torch", "--steps", "2", "--log_every", "1", "--seq_len", "32",
             "--global_batch", "4"]
    runs = [subprocess.run([sys.executable, *pre, *train, "--strategy",
                            strat], cwd=root, env=env, capture_output=True,
                           text=True, timeout=600)
            for pre, strat in ((["-m", "torch.distributed.run",
                                 "--standalone", "--nproc_per_node", "2"],
                                spec), ([], "fsdp"))]
    losses = []
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
        losses.append([float(ln.split()[3]) for ln in r.stdout.splitlines()
                       if ln.startswith("step ")])
    assert "ranks=2" in runs[0].stdout and len(losses[0]) == 2
    for a, b in zip(*losses, strict=True):
        assert abs(a - b) <= 1e-5 * abs(b)


@pytest.mark.cuda
def test_cuda_checkpoint_of_a_dtensor_state_restores_bit_equal(tmp_path):
    """A training state under ``fsdp`` on a 1-rank NCCL mesh (every
    parameter and moment a ``DTensor``) saved after one step restores
    into fresh parameters bit for bit, parameters and moments alike."""
    from repro_torch import bridge, strategy
    from repro_torch import checkpointing as ckpt_lib
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as par
    from repro_torch.data import Batcher, SyntheticSource
    from repro_torch.launch.mesh import init_distributed, shutdown
    from repro_torch.models import transformer as tfm
    from repro_torch.train import TrainConfig, train_loop

    dev = _card()
    cfg = _fsdp_cfg()
    shape = ShapeConfig("card", 64, 4, "train")
    tc = TrainConfig(steps=1, warmup=1, log_every=1, ckpt_every=1,
                     ckpt_dir=str(tmp_path))
    init_distributed(dev)
    try:
        plan = strategy.parse("fsdp").to_plan(cfg, strategy.host_topology(),
                                              shape)
        rt = par.make_runtime(cfg, plan, shape, remat=False)

        def run(seed, tc):
            params = par.apply_plan(tfm.init_params(cfg, seed, dev), plan,
                                    cfg)
            params, opt, _ = train_loop(
                cfg, rt, tc, Batcher(SyntheticSource(cfg.vocab_size), 64, 4),
                params, plan=plan)
            return bridge.train_state_to_tree(params, opt, cfg)

        saved = run(0, tc)
        restored = run(1, TrainConfig(steps=1, ckpt_dir=str(tmp_path),
                                      resume=True))
    finally:
        shutdown()
    assert ckpt_lib.validate_checkpoint(str(tmp_path), 1) == []

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k],
                                                            path + (k,))]
        if isinstance(tree, list):
            return [x for i, v in enumerate(tree)
                    for x in leaves(v, path + (i,))]
        return [(path, np.asarray(tree))]

    for (path, a), (_, b) in zip(leaves(saved), leaves(restored),
                                 strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


# the dense extensions at full width, cut in depth: qwen2-1.5b (qkv bias,
# G 6), h2o-danube-1.8b (head dim 80, window 4096) and granite-20b (MQA,
# layernorm, GELU, sinusoidal positions), f32
DENSE_FORWARDS = [("qwen2-1.5b", 2), ("h2o-danube-1.8b", 2),
                  ("granite-20b", 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n_layers", DENSE_FORWARDS)
def test_cuda_dense_forward_matches_plain(arch, n_layers):
    """A training forward (the flash forward at the model's heads) and a
    paged decode step (flash-decode at G 6 and G 48; the window's plain
    path for danube) of the kernel path against the plain path on the
    same weights: logits within 1e-4 of their scale, every kernel the
    path takes launched once a layer."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import Runtime
    from repro_torch.serve import init_paged_pools

    dev = _card()
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    params = tfm.init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 130), generator=g,
                         device=dev, dtype=torch.int32)
    rts = {"kernel": Runtime(),
           "plain": Runtime(attn_impl="torch", norm_impl="torch")}
    out = {}
    with torch.no_grad():
        for name, rt in rts.items():
            ops.reset_launch_counts()
            train = tfm.forward(cfg, params, {"tokens": toks}, rt)
            cache = init_paged_pools(cfg, 20, 16, torch.float32, dev)
            tbl = torch.arange(18, dtype=torch.int32, device=dev).view(2, 9)
            cache["paged"] = {"tbl": tbl, "ctx": torch.zeros(
                2, dtype=torch.int32, device=dev)}
            tfm.forward(cfg, params, {"tokens": toks, "pos": torch.zeros(
                2, 1, dtype=torch.int32, device=dev)}, rt, cache)
            ctx = torch.full((2,), 130, dtype=torch.int32, device=dev)
            cache["paged"]["ctx"] = ctx
            step = tfm.forward(cfg, params, {"tokens": toks[:, :1],
                                             "pos": ctx[:, None]}, rt, cache)
            out[name] = (train, step, ops.launch_counts())
    assert _rel_err(out["kernel"][0], out["plain"][0]) < 1e-4
    assert _rel_err(out["kernel"][1], out["plain"][1]) < 1e-4
    counts = out["kernel"][2]
    assert counts["flash_attention"] == n_layers
    assert counts["flash_decode"] == (0 if cfg.sliding_window else n_layers)
    assert counts["rmsnorm"] == (0 if cfg.norm == "layernorm"
                                 else 3 * (2 * n_layers + 1))
    assert not any(out["plain"][2].values())
