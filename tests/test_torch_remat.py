"""Block remat of the port (``Runtime.remat`` / ``remat_inner``,
``models.transformer._run_block``) against the JAX package's, on the CPU.

``make_runtime`` turns remat on for a train shape in both packages.  The
port's step under its runtime is held to JAX's step under JAX's runtime
(its GSPMD constraints dropped: this jax refuses them on one device, and
they place values without changing them) from the same numpy weights and
batch: the loss within 1e-5, every gradient within 1e-4 of its leaf's
scale (the f32 bars of ``tests/test_torch_train.py``).  The cases: a
reduced qwen3 (blocks of one layer) on the kernel path and the plain one,
and a reduced jamba of 8 layers (two prefix layers, which are never
checkpointed, then three blocks of a Mamba and an attention + MoE layer,
each block one checkpoint), with and without ``remat_inner``.  The port's
remat step equals its own step without remat bit for bit (the same ops
on the same values, the recompute's MoE aux counted once).  ``launch.
train`` keeps remat off, as the JAX train CLIs do, and a traced step
with remat keeps fewer activations at its peak than one without.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import parallel as jpar
from repro.models import transformer as jtfm
from repro.models.layers import Runtime as JRuntime
from repro_torch import bridge, strategy
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import parallel as par
from repro_torch.models import transformer as ttfm
from test_torch_fsdp import _few_threads  # noqa: F401

LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
B, S = 2, 32
# (arch, layers, config overrides)
QWEN = ("qwen3-0.6b", 2, dict(n_kv_heads=2))
JAMBA = ("jamba-v0.1-52b", 8, dict(n_kv_heads=2))


def _cfgs(arch, n_layers, over):
    jc = dataclasses.replace(jax_reduced(jax_get_config(arch),
                                         n_layers=n_layers), **over)
    tc = dataclasses.replace(reduced(get_config(arch), n_layers=n_layers),
                             **over)
    return jc, tc


def _runtimes(jc, tc, **over):
    """(port runtime, JAX runtime) of ``fsdp`` on one device for a train
    shape, each from its package's ``make_runtime`` with ``over``."""
    shape = ShapeConfig("remat", S, B, "train")
    plan = strategy.parse("fsdp").to_plan(
        tc, strategy.host_topology(n_devices=1), shape, abstract=True)
    trt = par.make_runtime(tc, plan, shape, **over)
    jshape = JShapeConfig("remat", S, B, "train")
    jplan = jstrategy.parse("fsdp").to_plan(
        jc, jstrategy.host_topology(n_devices=1), jshape)
    jrt = dataclasses.replace(jpar.make_runtime(jc, jplan, jshape, **over),
                              constrain=None)
    return trt, jrt


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -3:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _port_step(tc, tree, b, rt):
    """(loss, aux, {name: gradient}) of the port's loss on ``b``."""
    params = bridge.params_from_jax(tree)
    loss, m = ttfm.loss_fn(tc, params, {k: torch.tensor(v)
                                        for k, v in b.items()}, rt)
    loss.backward()
    return (loss.detach(), m["aux"].detach(),
            {n: p.grad for n, p in params.named_parameters()})


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _check_against_jax(case, impl, **over):
    arch, n_layers, cfg_over = case
    jc, tc = _cfgs(arch, n_layers, cfg_over)
    trt, jrt = _runtimes(jc, tc, **over)
    assert trt.remat and jrt.remat
    assert trt.remat_inner == jrt.remat_inner == bool(over)
    if impl == "torch":
        trt = dataclasses.replace(trt, attn_impl="torch", norm_impl="torch")
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(3)))
    b = _batch(jc.vocab_size, seed=n_layers)
    loss, aux, grads = _port_step(tc, tree, b, trt)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jtfm.loss_fn(jc, p, bb, jrt), has_aux=True))(
        tree, {k: jnp.asarray(v) for k, v in b.items()})
    assert abs(float(loss) - float(jloss)) < LOSS_ATOL
    assert abs(float(aux) - float(jm["aux"])) < 1e-7
    got = _leaves(bridge.grads_to_jax(grads, tc))
    want = _leaves(jax.tree.map(np.asarray, jgrads))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, w) in zip(got, want):
        assert a.shape == w.shape, path
        assert _rel(a, w) < GRAD_REL, (jax.tree_util.keystr(path),
                                       _rel(a, w))


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_qwen3_remat_step_matches_jax(impl):
    _check_against_jax(QWEN, impl)


@pytest.mark.parametrize("over", [{}, dict(remat_inner=True)],
                         ids=["remat", "remat_inner"])
def test_hybrid_blocks_of_two_match_jax(over):
    """jamba at 8 layers: ``layer_plan`` gives two prefix layers and three
    blocks of period 2, each spanning a Mamba and an attention + MoE
    layer."""
    arch, n_layers, cfg_over = JAMBA
    tc = _cfgs(arch, n_layers, cfg_over)[1]
    assert ttfm.layer_plan(tc) == ([0, 1], 2, 2, 3)
    assert ttfm._blocks(tc, True) == [
        ((0,), False), ((1,), False), ((2, 3), True), ((4, 5), True),
        ((6, 7), True)]
    _check_against_jax(JAMBA, "kernel", **over)


@pytest.mark.parametrize("case", [QWEN, JAMBA], ids=["qwen3", "jamba"])
def test_remat_step_equals_the_step_without_remat(case):
    """Bit for bit: the recompute runs the same ops on the same values,
    and a MoE layer's aux enters the loss once."""
    arch, n_layers, cfg_over = case
    jc, tc = _cfgs(arch, n_layers, cfg_over)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(4)))
    b = _batch(jc.vocab_size, seed=1)
    base = ttfm.Runtime(moe_impl="dropping")
    ref = _port_step(tc, tree, b, base)
    for rt in (dataclasses.replace(base, remat=True),
               dataclasses.replace(base, remat=True, remat_inner=True),
               dataclasses.replace(base, remat_inner=True)):
        loss, aux, grads = _port_step(tc, tree, b, rt)
        assert torch.equal(loss, ref[0]) and torch.equal(aux, ref[1])
        assert grads.keys() == ref[2].keys()
        for n, g in grads.items():
            assert torch.equal(g, ref[2][n]), n


def test_recompute_adds_no_aux_term():
    """The backward's rerun of a block does not append its MoE layers'
    aux losses again: after the backward the forward's ``AuxLoss`` holds
    one term a MoE layer (a term added in the backward would keep the
    rerun's router graph alive past it)."""
    tc = _cfgs(*JAMBA)[1]
    params = ttfm.init_params(tc, 0, "cpu")
    aux = ttfm.AuxLoss()
    tok = torch.randint(0, tc.vocab_size, (B, S))
    logits = ttfm.forward(tc, params, {"tokens": tok},
                          ttfm.Runtime(remat=True, remat_inner=True), aux=aux)
    n_moe = sum(tc.is_moe_layer(i) for i in range(tc.n_layers))
    assert len(aux.terms) == n_moe
    (logits.float().square().mean() + aux.total("cpu")).backward()
    assert len(aux.terms) == n_moe


def test_a_forward_inside_a_backward_adds_its_aux_terms():
    """Only a checkpoint's rerun skips the aux append
    (``layers.recompute_context``): a plain forward that runs inside a
    backward graph task (from a gradient hook here) appends one term a
    MoE layer."""
    from repro_torch.models.layers import recompute_context, recomputing
    tc = _cfgs(*JAMBA)[1]
    params = ttfm.init_params(tc, 0, "cpu")
    tok = torch.randint(0, tc.vocab_size, (B, S))
    aux = ttfm.AuxLoss()

    def hook(g):
        with torch.no_grad():
            ttfm.forward(tc, params, {"tokens": tok}, ttfm.Runtime(),
                         aux=aux)
        return g

    x = torch.ones(2, requires_grad=True)
    y = x * 2
    y.register_hook(hook)
    y.sum().backward()
    assert len(aux.terms) == sum(tc.is_moe_layer(i)
                                 for i in range(tc.n_layers))
    assert not recomputing()
    with recompute_context():
        with recompute_context():
            assert recomputing()
        assert recomputing()
    assert not recomputing()


def test_a_cached_forward_checkpoints_nothing():
    """Prefill and decode (a cache) never checkpoint: ``_blocks`` gives
    every block unchecked without ``train``."""
    tc = _cfgs(*JAMBA)[1]
    assert not any(r for _, r in ttfm._blocks(tc, False))
    assert [ids for ids, _ in ttfm._blocks(tc, False)] == \
        [ids for ids, _ in ttfm._blocks(tc, True)]


def test_train_cli_keeps_remat_off(monkeypatch, capsys):
    """``launch.train`` builds its runtime with ``remat=False`` over
    ``make_runtime``'s train default, as the JAX train CLIs pass it."""
    from repro_torch.launch import train as train_cli
    seen = []
    make_runtime = par.make_runtime

    def spy(*a, **kw):
        rt = make_runtime(*a, **kw)
        seen.append(rt)
        return rt

    monkeypatch.setattr(train_cli.par, "make_runtime", spy)
    train_cli.main(["--device", "cpu", "--reduced", "--strategy", "fsdp",
                    "--steps", "1", "--log_every", "1", "--seq_len", "16",
                    "--global_batch", "2"])
    assert seen and not any(rt.remat or rt.remat_inner for rt in seen)
    assert "step" in capsys.readouterr().out


def test_traced_remat_step_keeps_fewer_activations():
    """One fake-tensor train step of a reduced qwen3 under the memory
    tracker (``dryrun.lower_one``): with remat (the runtime's default on a
    train shape) the activations live at the peak are fewer than
    without, and the record says which it traced."""
    from repro_torch.launch import dryrun
    cfg = reduced(get_config("qwen3-0.6b"), n_layers=4)
    shape = ShapeConfig("t", 256, 4, "train")
    s = strategy.parse("fsdp")
    topo = strategy.host_topology(n_devices=1)
    on = dryrun.lower_one(cfg, shape, s, topo, kernels="torch",
                          device="cpu")
    off = dryrun.lower_one(cfg, shape, s, topo, kernels="torch",
                           rt_overrides={"remat": False}, device="cpu")
    assert on["remat"] is True and off["remat"] is False
    assert on["memory"]["activations_bytes"] < \
        off["memory"]["activations_bytes"]
    assert on["memory"]["peak_bytes_per_device"] < \
        off["memory"]["peak_bytes_per_device"]
    assert on["memory"]["parameters_bytes"] == \
        off["memory"]["parameters_bytes"]
