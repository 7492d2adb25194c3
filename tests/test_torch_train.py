"""The port's training path against the JAX package's, on the CPU.

The same numpy weights (``bridge.params_from_jax``) and the same batches go
through ``repro`` and ``repro_torch``: the optimizer and schedule, the data
pipeline, ``loss_fn`` and its gradients (JAX ``value_and_grad`` under the
``pallas`` Runtime in interpret mode and the ``jnp`` Runtime, against the
port's kernel path — plain versions here — and plain path), and a 3-step
trajectory of the JAX ``make_train_step``.  All f32.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import Batcher as JBatcher
from repro.data import BinTokenSource as JBinTokenSource
from repro.data import SyntheticSource as JSyntheticSource
from repro.models import transformer as jtfm
from repro.models.layers import Runtime as JRuntime
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim.schedule import linear_warmup_cosine as jax_schedule
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.bridge import (grads_to_jax, opt_state_from_jax,
                                opt_state_to_jax, params_from_jax,
                                params_to_jax)
from repro_torch.configs import get_config, reduced
from repro_torch.data import Batcher, BinTokenSource, SyntheticSource
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import Runtime
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.train import TrainConfig, make_train_step
from test_torch_fsdp import _few_threads  # noqa: F401
from test_torch_fsdp import cli_env

ROOT = Path(__file__).resolve().parents[1]
# port runtime -> the JAX runtime it is held against
RUNTIMES = {"kernel": (Runtime(), JRuntime(attn_impl="pallas",
                                           norm_impl="pallas")),
            "torch": (Runtime(attn_impl="torch", norm_impl="torch"),
                      JRuntime())}
# f32 throughout.  Loss: the same sums in another order, 1e-5.  Gradients,
# each leaf relative to its own scale (max |g|): 1e-4, ten times inside the
# 1e-3 bar of the JAX kernel tests (tests/test_kernels.py); two layers of
# f32 products summed in another order stay near 1e-6.
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
# Reference caveat (ROADMAP Queue 3): the JAX tree stacks the scanned
# layers, so per-layer 1-d leaves not on its no-decay list (qk-norm's
# q_norm and k_norm) are 2-d there and take weight decay
# (optim/adamw.py:64).  The port keeps per-layer leaves and, as the mask
# intends, does not decay them.
STACKED_1D = ("q_norm", "k_norm")


def _cfgs(arch, **over):
    jc = dataclasses.replace(jax_reduced(jax_get_config(arch)), **over)
    tc = dataclasses.replace(reduced(get_config(arch)), **over)
    return jc, tc


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jtfm.init_params(cfg,
                                                     jax.random.PRNGKey(seed)))


def _batch(vocab, B, S, seed=0, masked=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[:, -masked:] = -1                  # e.g. padding at the end
    return {"tokens": toks[:, :-1], "labels": labels}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_close(port_tree, jax_tree, rel):
    pa, pb = _leaves(port_tree), _leaves(jax_tree)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, a), (_, b) in zip(pa, pb):
        assert a.shape == b.shape, path
        assert _rel(a, b) < rel, (jax.tree_util.keystr(path), _rel(a, b))


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------

def test_schedule_matches_jax():
    for step in range(0, 40):
        for warmup, total in ((5, 30), (1, 3), (0, 10)):
            want = float(jax_schedule(jnp.asarray(step, jnp.int32), warmup,
                                      total))
            assert abs(linear_warmup_cosine(step, warmup, total)
                       - want) < 1e-7


def test_adamw_matches_jax_and_decays_the_same_leaves():
    jc, tc = _cfgs("qwen3-0.6b", n_kv_heads=2, qkv_bias=True)
    tree = _jax_params(jc, seed=2)
    params = params_from_jax(tree)
    rng = np.random.default_rng(0)
    named = dict(params.named_parameters())
    cfg = AdamWConfig(lr=1e-2)
    jcfg = JAdamWConfig(lr=1e-2)
    state, jstate = init_opt_state(params), jax_init_opt_state(tree)
    jupdate = jax.jit(jax_adamw_update, static_argnums=0)
    for lr_scale in (0.5, 1.0):
        grads = {n: torch.tensor(rng.standard_normal(p.shape)
                                 .astype(np.float32)) for n, p in named.items()}
        jgrads = jax.tree.map(jnp.asarray, grads_to_jax(grads, tc))
        _, state, m = adamw_update(cfg, params, grads, state, lr_scale)
        tree, jstate, jm = jupdate(jcfg, tree, jgrads, jstate, lr_scale)
        assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) < 1e-6
        assert abs(m["lr"] - float(jm["lr"])) < 1e-10
    # the moments through the bridge, both ways
    _assert_trees_close(opt_state_to_jax(state, tc)["m"],
                        jax.tree.map(np.asarray, jstate["m"]), 1e-6)
    back = opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert back["step"] == state["step"] == 2
    assert all(_rel(back["v"][n], state["v"][n]) < 1e-6 for n in named)
    # parameters move by at most lr per step: compare in units of lr
    pa = _leaves(params_to_jax(params, tc))
    for (path, a), (_, b) in zip(pa, _leaves(jax.tree.map(np.asarray,
                                                          tree))):
        if path[-1].key not in STACKED_1D:
            assert np.max(np.abs(a - b)) < 1e-4 * cfg.lr, path

    # which leaves decay: with zero gradients the moments stay 0 and only
    # the decay term moves a parameter
    tree0 = _jax_params(jc, seed=3)
    params0 = params_from_jax(tree0)
    zeros = {n: torch.zeros_like(p) for n, p in params0.named_parameters()}
    adamw_update(cfg, params0, zeros, init_opt_state(params0))
    jtree, _, _ = jupdate(
        jcfg, tree0, jax.tree.map(jnp.zeros_like, tree0),
        jax_init_opt_state(tree0))
    moved = jax.tree.map(lambda a, b: not np.array_equal(a, b),
                         params_to_jax(params0, tc), tree0)
    jmoved = jax.tree.map(lambda a, b: not np.array_equal(np.asarray(a), b),
                          jtree, tree0)
    for key in STACKED_1D:                   # the caveat above, and only it
        assert jmoved["blocks"][0]["mixer"][key]
        jmoved["blocks"][0]["mixer"][key] = False
    assert moved == jmoved
    layer = moved["blocks"][0]
    assert moved["embed"]["tok"] and layer["mixer"]["wq"]
    assert not (layer["norm1"]["scale"] or layer["mixer"]["bq"]
                or layer["mixer"]["q_norm"] or moved["final_norm"]["scale"])


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_batcher_matches_jax(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 3000).astype(
        np.uint16).tofile(path)
    pairs = [(Batcher(SyntheticSource(512, seed=7), 24, 3),
              JBatcher(JSyntheticSource(512, seed=7), 24, 3)),
             (Batcher(BinTokenSource(str(path), chunk=100), 40, 2).at(2),
              JBatcher(JBinTokenSource(str(path), chunk=100), 40, 2).at(2))]
    for port, ref in pairs:
        got = [x for _, x in zip(range(4), port)]
        want = [x for _, x in zip(range(4), ref)]
        for a, b in zip(got, want, strict=True):
            for k in ("tokens", "labels"):
                assert a[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_synthetic_source_draws_equal_rng_choice_at_full_vocab():
    """The port draws each Zipfian piece from a CDF built once; the JAX
    package's ``rng.choice(p=...)`` builds the same CDF on every call.
    2,000 pieces at qwen3's vocab of 151,936, the same arrays."""
    V = 151_936
    port = SyntheticSource(V, seed=3).stream()
    ref = JSyntheticSource(V, seed=3).stream()
    for _ in range(2000):
        a, b = next(port), next(ref)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_loss_fn_masks_labels():
    jc, tc = _cfgs("qwen3-0.6b", n_kv_heads=2)
    tree = _jax_params(jc, seed=4)
    params = params_from_jax(tree)
    jloss_fn = jax.jit(lambda p, b: jtfm.loss_fn(jc, p, b, JRuntime()))
    for masked in (0, 5, 16):                  # 16: every label masked
        b = _batch(jc.vocab_size, 2, 16, seed=masked, masked=masked)
        with torch.no_grad():
            loss, m = ttfm.loss_fn(tc, params,
                                   {k: torch.tensor(v) for k, v in b.items()},
                                   RUNTIMES["torch"][0])
        jloss, jm = jloss_fn(tree, {k: jnp.asarray(v) for k, v in b.items()})
        assert float(m["ntok"]) == float(jm["ntok"]) == 2 * (16 - masked)
        assert abs(float(loss) - float(jloss)) < LOSS_ATOL
        assert abs(float(m["nll"]) - float(jm["nll"])) < LOSS_ATOL
        assert float(m["aux"]) == 0.0
    assert float(loss) == 0.0                   # nothing left to predict


@pytest.mark.parametrize("S", [128, 64])
@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("arch,over", [("qwen3-0.6b", dict(n_kv_heads=2)),
                                       ("llama2-1b", {})])
def test_loss_and_grads_match_jax(arch, over, impl, S):
    """At S 128 the JAX pallas Runtime runs its flash kernels; at S 64 it
    takes its dense path (its TPU gate is S >= 128), while the port's
    kernel path runs the flash kernels' plain versions at both."""
    jc, tc = _cfgs(arch, **over)
    tree = _jax_params(jc, seed=5)
    params = params_from_jax(tree)
    trt, jrt = RUNTIMES[impl]
    b = _batch(jc.vocab_size, 2, S, seed=S, masked=3)
    loss, m = ttfm.loss_fn(tc, params, {k: torch.tensor(v)
                                        for k, v in b.items()}, trt)
    loss.backward()
    grads = {n: p.grad for n, p in params.named_parameters()}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jtfm.loss_fn(jc, p, bb, jrt), has_aux=True))(
        tree, {k: jnp.asarray(v) for k, v in b.items()})
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    assert float(m["ntok"]) == float(jm["ntok"])
    _assert_trees_close(grads_to_jax(grads, tc),
                        jax.tree.map(np.asarray, jgrads), GRAD_REL)


# ---------------------------------------------------------------------------
# a short trajectory of the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over,wd,ga", [
    ("llama2-1b", {}, 0.1, 1),
    ("llama2-1b", {}, 0.1, 2),
    ("qwen3-0.6b", dict(n_kv_heads=2), 0.0, 2),   # see STACKED_1D
])
def test_train_step_trajectory_matches_jax(arch, over, wd, ga):
    """Three AdamW steps (warmup 1, cosine over 3) on the same batches,
    port kernel path (plain versions here) against the JAX ``jnp`` path.
    Losses, gradient norms and moments agree to f32 order; parameters are
    compared in units of lr: Adam's m / (sqrt(v) + eps) turns tiny
    gradient differences on near-zero gradients into update differences
    of up to lr per step, so a tight absolute bar on the weights would
    measure that noise."""
    jc, tc = _cfgs(arch, **over)
    tree = _jax_params(jc, seed=6)
    params = params_from_jax(tree)
    rt, jrt = RUNTIMES["kernel"][0], JRuntime()
    opt = AdamWConfig(lr=1e-3, weight_decay=wd)
    step = make_train_step(tc, rt, TrainConfig(steps=3, warmup=1,
                                               grad_accum=ga, opt=opt))
    jstep = jax.jit(jax_make_train_step(
        jc, jrt, JTrainConfig(steps=3, warmup=1, grad_accum=ga,
                              opt=JAdamWConfig(lr=1e-3, weight_decay=wd))))
    state, jstate = init_opt_state(params), jax_init_opt_state(tree)
    for i in range(3):
        b = _batch(jc.vocab_size, 4, 32, seed=10 + i, masked=2 * i)
        _, state, m = step(params, state, {k: torch.tensor(v)
                                           for k, v in b.items()})
        tree, jstate, jm = jstep(tree, jstate, {k: jnp.asarray(v)
                                                for k, v in b.items()})
        for k in ("loss", "nll", "ntok", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) < 1e-5 * max(
                1.0, abs(float(jm[k]))), (i, k, float(m[k]), float(jm[k]))
        assert abs(m["lr"] - float(jm["lr"])) < 1e-10
    jstate = jax.tree.map(np.asarray, jstate)
    _assert_trees_close(opt_state_to_jax(state, tc)["m"], jstate["m"], 1e-4)
    assert state["step"] == int(jstate["step"]) == 3
    for (path, a), (_, b) in zip(_leaves(params_to_jax(params, tc)),
                                 _leaves(jax.tree.map(np.asarray, tree))):
        d = np.abs(a - b) / opt.lr
        # a few near-zero-gradient entries may move differently (observed
        # <= 0.15 lr); a wrong update would move them all (observed mean
        # <= 2e-5 lr)
        assert d.max() < 0.5 and d.mean() < 1e-3, \
            (jax.tree_util.keystr(path), d.max(), d.mean())


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _run(args):
    env = cli_env()
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_trains_on_cpu():
    r = _run(["-m", "repro_torch.launch.train", "--device", "cpu",
              "--reduced", "--steps", "2", "--log_every", "1", "--seq_len",
              "32", "--global_batch", "2"])
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2
    assert "done: loss" in r.stdout


def test_profile_reading_counts_kernels_not_annotations():
    """The profile reader behind ``--profile``: a kernel belongs to the span
    its start falls in; the GPU-timeline copies of the host spans are not
    kernels; host span time counts the host events only."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from repro_torch import telemetry as tel

    def ev(name, dev, t0, t1, annotation=False):
        return SimpleNamespace(name=name, device_type=dev,
                               is_user_annotation=annotation,
                               time_range=SimpleNamespace(start=t0, end=t1))

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    evs = [ev("train/step", cpu, 0, 100, True),
           ev("train/dispatch", cpu, 0, 60, True),
           ev("train/step", gpu, 5, 90, True),
           ev("train/dispatch", gpu, 5, 70, True),
           ev("gemm", gpu, 5, 25), ev("gemm", gpu, 30, 50),
           ev("flash_fwd", gpu, 95, 110),        # runs past the span's end
           ev("late", gpu, 120, 130),            # after every span
           ev("train/step", cpu, 200, 300, True),
           ev("gemm", gpu, 210, 220)]
    prof = SimpleNamespace(events=lambda: evs)
    n, wall, busy, by_name, counts = tel.device_time_in_spans(prof,
                                                              "train/step")
    assert (n, wall, busy) == (2, 200, 20 + 20 + 5 + 10)
    assert by_name == {"gemm": 50, "flash_fwd": 5}
    assert counts == {"gemm": 3, "flash_fwd": 1}
    assert tel.host_time_in_span(prof, "train/dispatch") == 60


def test_train_cli_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["-m", "repro_torch.launch.train", "--reduced", "--steps", "1"])
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
