"""The port's CUDA kernels: their C bindings, and (on a card) each kernel
against its plain PyTorch version.

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest -q tests/test_torch_cuda.py

The ``cuda``-marked test skips where ``torch.cuda.is_available()`` is
false; the binding test runs everywhere (it reads the sources, no nvcc).
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import rmsnorm as trms

CTYPE = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
         "float": ctypes.c_float}


@pytest.mark.parametrize("name,module", [("rmsnorm", trms),
                                         ("flash_decode", tfd)])
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
