"""The rounding of the bf16 flash-attention kernels, modelled on the CPU.

``src/repro_torch/kernels/csrc/flash_attention_bf16.cu`` multiplies bf16
operands on the tensor cores with f32 accumulators.  s, dp, the online
maximum and rescale, l, lse and delta stay f32.  The forward rounds p to
bf16 (to nearest even) for o += p v and rescales at the edges of its
``kFwdTile``-row kv tiles; the backward takes p and ds into dq += ds k,
dv += p^T do and dk += ds^T q as a hi/lo pair of bf16 (hi = bf16(x), lo =
bf16(x - hi)).  The model below does exactly that in plain PyTorch (it
lives here and nowhere on the main path) and is held, on numpy-seeded bf16
inputs, to the plain versions (``forward_plain``, ``dq_plain``,
``dkv_plain``) and to the JAX package's ``attention_ref`` with its
``jax.grad``, at ``chip_smoke.py``'s bf16 bars: o within ``TOL[bf16]`` of
the plain o, lse within 1e-5, gradients within ``GRAD_REL_TOL[bf16]`` of
each tensor's scale.  It also shows why the backward splits: rounding p
and ds to bf16 alone moves the gradients by ~2e-3 of scale before their
own rounding to bf16, whose one ulp may reach 7.8e-3 of scale, so the 1e-2
bar would have no margin.  The card holds the kernels themselves to the
plain versions (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa
from test_torch_fsdp import _few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (build.CSRC / "flash_attention_bf16.cu").read_text()
# the forward's kv tile: the model rescales where the kernel does
FWD_TILE = int(re.search(r"kFwdTile = (\d+)", SOURCE).group(1))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()
O_ATOL, O_RTOL = _CS.TOL[torch.bfloat16]
GRAD_REL = _CS.GRAD_REL_TOL[torch.bfloat16]
LSE_ATOL = 1e-5


def _bf16(x):
    """x rounded to bf16 and back: the forward's A operand p."""
    return x.to(torch.bfloat16).float()


def _split(x):
    """x as the backward's hi/lo pair of bf16 -> (hi, lo) as f32; a
    product with x is the sum of the two products."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _times(x, b):
    """x @ b with x split into hi and lo, each product summed in f32."""
    hi, lo = _split(x)
    return lo @ b + hi @ b


def _mask(S, Sk, causal, window, q0):
    qp = q0 + torch.arange(S)[:, None]
    kp = torch.arange(Sk)[None, :]
    m = torch.ones(S, Sk, dtype=torch.bool)
    if causal:
        m &= kp <= qp
    if window:
        m &= kp > qp - window
    return m


def _grouped(x, Kv):
    B, S, H, D = x.shape
    return x.float().reshape(B, S, Kv, H // Kv, D).permute(0, 2, 3, 1, 4)


def forward_model(q, k, v, causal=True, window=0, q0=0, tile=FWD_TILE):
    """The bf16 forward kernel's arithmetic -> (o bf16, lse f32)."""
    B, S, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    scale = D ** -0.5
    qg = _grouped(q, Kv)                                # (B, Kv, G, S, D)
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    mask = _mask(S, Sk, causal, window, q0)
    m = torch.full(qg.shape[:-1], -1e30)
    l = torch.zeros(qg.shape[:-1])
    acc = torch.zeros(qg.shape)
    for k0 in range(0, Sk, tile):
        s = (qg @ kf[..., k0:k0 + tile, :].transpose(-1, -2)) * scale
        s = torch.where(mask[:, k0:k0 + tile], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])             # f32; 0 where masked
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _bf16(p) @ vf[..., k0:k0 + tile, :]
        m = m_new
    div = l.clamp_min(1e-30)
    o = (acc / div[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return o.to(torch.bfloat16), (m + torch.log(div)).reshape(B, H, S)


def _p_ds(q, k, v, do, lse, delta, causal, window, q0):
    """f32 p and ds (B, Kv, G, S, Sk) as the backward kernels form them."""
    B, S, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = D ** -0.5
    qg, dog = _grouped(q, Kv), _grouped(do, Kv)
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    mask = _mask(S, Sk, causal, window, q0)
    s = qg @ kf.transpose(-1, -2)
    p = torch.where(mask, torch.exp(s * scale
                                    - lse.reshape(B, Kv, G, S, 1)), 0.0)
    dp = dog @ vf.transpose(-1, -2)
    ds = p * (dp - delta.reshape(B, Kv, G, S, 1)) * scale
    return p, ds, qg, dog, kf


def dq_model(q, k, v, do, lse, delta, causal=True, window=0, q0=0,
             times=_times):
    """dq = ds k, ds split into hi and lo, summed in f32 -> bf16 (B, S,
    H, D)."""
    B, S, H, D = q.shape
    _, ds, _, _, kf = _p_ds(q, k, v, do, lse, delta, causal, window, q0)
    dq = times(ds, kf)
    return dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(torch.bfloat16)


def dkv_model(q, k, v, do, lse, delta, causal=True, window=0, q0=0,
              times=_times):
    """dv = p^T do and dk = ds^T q, p and ds split into hi and lo, summed
    in f32 over the G query heads -> bf16 (B, Sk, Kv, D) each."""
    p, ds, qg, dog, _ = _p_ds(q, k, v, do, lse, delta, causal, window, q0)
    dv = times(p.transpose(-1, -2), dog).sum(2)         # (B, Kv, Sk, D)
    dk = times(ds.transpose(-1, -2), qg).sum(2)
    return (dk.permute(0, 2, 1, 3).to(torch.bfloat16),
            dv.permute(0, 2, 1, 3).to(torch.bfloat16))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _o_within(o, ref):
    o, ref = np.asarray(o, np.float32), np.asarray(ref, np.float32)
    return bool((np.abs(o - ref) <= O_ATOL + O_RTOL * np.abs(ref)).all())


def _np(t):
    return t.float().numpy()


# B, S (query rows), Sk (keys), H, Kv, D, causal, window, q0: small versions
# of tests/test_torch_cuda.py's ATTN_CASES — GQA, ragged S across the
# kernels' 64-row tiles, a window, MQA, not causal, S = 1, G = 8, head dims
# 80 and 64, and a context rank's rows at an offset
CASES = [
    (2, 96, 96, 4, 2, 128, True, 0, 0),
    (1, 77, 77, 4, 2, 128, True, 0, 0),
    (1, 130, 130, 4, 2, 128, True, 48, 0),
    (2, 65, 65, 4, 1, 128, True, 0, 0),
    (1, 70, 70, 2, 2, 128, False, 0, 0),
    (2, 1, 1, 4, 2, 128, True, 0, 0),
    (1, 64, 64, 16, 2, 64, True, 0, 0),
    (2, 96, 96, 8, 2, 80, True, 0, 0),
    (1, 100, 100, 4, 1, 80, True, 32, 0),
    (1, 63, 63, 4, 4, 64, False, 0, 0),
    (1, 40, 120, 4, 2, 128, True, 0, 80),
    (1, 50, 150, 4, 1, 80, True, 64, 100),
]


def _inputs(B, S, Sk, H, Kv, D, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, S, H, D), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, Kv, D), np.float32)
            for _ in range(2))
    return [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v, do)]


@pytest.mark.parametrize("case", CASES)
def test_bf16_rounding_model_matches_plain_versions(case):
    """Each kernel's model alone against its plain version on the same
    inputs (the backward from the plain forward's lse and delta, as
    ``chip_smoke.flash_case`` holds the kernels)."""
    B, S, Sk, H, Kv, D, causal, window, q0 = case
    q, k, v, do = _inputs(B, S, Sk, H, Kv, D, seed=S + Sk + D)
    o, lse = forward_model(q, k, v, causal, window, q0)
    o0, lse0 = tfa.forward_plain(q, k, v, causal, window, q0)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _o_within(_np(o), _np(o0))
    assert (lse - lse0).abs().max().item() <= LSE_ATOL
    delta = tfa.attention_delta(o0, do)
    args = (q, k, v, do, lse0, delta, causal, window, q0)
    dq, (dk, dv) = dq_model(*args), dkv_model(*args)
    dq0, (dk0, dv0) = tfa.dq_plain(*args), tfa.dkv_plain(*args)
    if S == 1 and Sk == 1:
        # one key: dq and dk are zero but for the rounding of dp - delta;
        # hold them to the scale of dv (= do), as the card's test does
        scale = dv0.float().abs().max().item()
        for a in (dq, dk):
            assert a.float().abs().max().item() <= GRAD_REL * scale
        assert _rel(_np(dv), _np(dv0)) <= GRAD_REL
    else:
        for a, b in ((dq, dq0), (dk, dk0), (dv, dv0)):
            assert _rel(_np(a), _np(b)) <= GRAD_REL


# the JAX reference's cases: one per head dim, with GQA, a window, MQA and
# not causal among them (each traces its own jax.grad)
JAX_CASES = [CASES[i] for i in (0, 2, 3, 6, 8, 9)]


@pytest.mark.parametrize("case", JAX_CASES)
def test_bf16_rounding_model_matches_jax_reference(case):
    """The modelled forward and backward as one slice (delta from the
    model's own o) against the JAX package's ``attention_ref`` and its
    ``jax.grad``, in f32 from the same bf16 values."""
    B, S, Sk, H, Kv, D, causal, window, q0 = case
    q, k, v, do = _inputs(B, S, Sk, H, Kv, D, seed=S + Sk + D + 1)
    o, lse = forward_model(q, k, v, causal, window)
    delta = tfa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, window)
    dq, (dk, dv) = dq_model(*args), dkv_model(*args)
    qj, kj, vj, doj = (jnp.asarray(_np(t)) for t in (q, k, v, do))

    def loss(q_, k_, v_):
        out = jref.attention_ref(q_, k_, v_, causal=causal, window=window)
        return jnp.sum(out * doj)

    o_ref = jref.attention_ref(qj, kj, vj, causal=causal, window=window)
    grads = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    assert _o_within(_np(o), np.asarray(o_ref))
    for a, b in zip((dq, dk, dv), grads):
        assert _rel(_np(a), np.asarray(b)) <= GRAD_REL


def test_unsplit_backward_leaves_no_margin():
    """Why the backward splits p and ds: at S 512 rounding them to bf16
    alone moves dq, dk and dv by over 1e-3 of scale before their final
    rounding (the hi/lo pair: under 1e-4), against a 1e-2 bar that one
    bf16 ulp of the output may already take 7.8e-3 of."""
    B, S, H, Kv, D = 1, 512, 4, 2, 128
    q, k, v, do = _inputs(B, S, S, H, Kv, D, seed=1)
    o0, lse0 = tfa.forward_plain(q, k, v, True, 0)
    delta = tfa.attention_delta(o0, do)
    exact = tfa.dq_plain(q.float(), k.float(), v.float(), do.float(), lse0,
                         delta, True, 0)
    args = (q, k, v, do, lse0, delta, True, 0)

    def unrounded(times):
        _, ds, _, _, kf = _p_ds(*args, 0)
        return times(ds, kf).permute(0, 3, 1, 2, 4).reshape(B, S, H, D)

    one = unrounded(lambda x, b: _bf16(x) @ b)
    pair = unrounded(_times)
    assert _rel(_np(one), _np(exact)) > 1e-3
    assert _rel(_np(pair), _np(exact)) < 1e-4


def test_source_states_the_modelled_rounding():
    """The kernel's source note states the rounding this file models: the
    forward's p v takes p rounded to bf16, every backward product with p
    or ds the hi/lo pair (``reduce_rows``' ``kSplit``)."""
    note = " ".join(SOURCE.split("#include")[0].replace("//", " ").split())
    assert "In the forward p is rounded to bf16" in note
    assert "as a hi/lo pair of bf16" in note
    assert "l is summed from the f32 p before any rounding" in note
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in SOURCE
    assert re.findall(r"reduce_rows<D, B[KQ], (\w+)>\(", SOURCE) == [
        "false", "true", "true", "true"]
