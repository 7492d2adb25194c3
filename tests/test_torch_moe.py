"""The port's mixture of experts against the JAX package, on the CPU:
the configs and the strategy checks of deepseek-moe-16b and dbrx-132b,
the router, the capacity routing, the gathers both ways, the dense and
dropping dispatches and the shared experts (``models.moe``), and the
planner's ranking of the MoE strategies.  The whole reduced models run in
``tests/test_torch_moe_model.py``.

Weights come from the JAX initialiser, inputs from numpy with a fixed
seed.  Tolerances: routing indices exactly; f32 values and gradients of a
layer within 1e-5 of their scale, its aux within 1e-7.  The
expert-parallel all-to-all runs on gloo worlds in
``tests/test_torch_ep.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import strategy as jstrategy
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import moe as jmoe
from repro.models.layers import Runtime as JRuntime
from repro_torch import strategy
from repro_torch.configs import LATER, ShapeConfig, get_config, reduced
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import Runtime
from test_torch_fsdp import _few_threads  # noqa: F401

ARCHS = ["deepseek-moe-16b", "dbrx-132b"]
N_LAYERS = 3                # deepseek: dense layer 0, two MoE layers
LAYER_REL = 1e-5
LOGIT_REL = 1e-4
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
RUNTIMES = {"kernel": Runtime(),
            "torch": Runtime(attn_impl="torch", norm_impl="torch")}
S0, N_NEW = 11, 9
ENGINE_KW = dict(max_len=32, n_slots=2, block_size=4, prefill_chunk=8,
                 steps_per_tick=3)


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_reduced(jax_get_config(arch),
                                            n_layers=N_LAYERS), **over),
            dataclasses.replace(reduced(get_config(arch),
                                        n_layers=N_LAYERS), **over))


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


def _batch(vocab, B, S, seed=0, masked=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[:, -masked:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


# ---------------------------------------------------------------------------
# configs and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert get_config(arch).source == jax_get_config(arch).source
    assert arch not in LATER
    ttfm.check_supported(get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_strategy_admits_ep_and_refuses_tp_and_pp_on_moe(arch):
    """``fsdp_ep2``/``fsdp_ep4`` lower on a MoE config; so do tp > 1
    (with and without an expert axis) and, on dbrx's uniform stack,
    pp > 1, while deepseek's dense prefix layer is refused a pipeline
    with the JAX package's message."""
    cfg = get_config(arch)
    topo = strategy.host_topology(n_devices=8)
    shape = ShapeConfig("t", 512, 64, "train")
    for spec, mesh in (("fsdp_ep2", {"data": 4, "expert": 2, "model": 1}),
                       ("fsdp_ep4", {"data": 2, "expert": 4, "model": 1})):
        s = strategy.parse(spec)
        s.check(topo, cfg)
        plan = s.to_plan(cfg, topo, shape, abstract=True)
        assert plan.mesh == mesh and plan.expert == "expert"
        assert plan.dp == plan.fsdp == ("data", "expert")
    for spec, mesh in (("hsdp_tp2", {"data": 4, "model": 2}),
                       ("fsdp_tp2_ep2", {"data": 2, "expert": 2,
                                         "model": 2})):
        plan = strategy.parse(spec).to_plan(cfg, topo, shape, abstract=True)
        assert plan.mesh == mesh and plan.attn == "head_tp"
    s = strategy.parse("fsdp_pp2_mb4")
    if arch == "deepseek-moe-16b":
        with pytest.raises(strategy.StrategyError,
                           match="needs a uniform layer stack"):
            s.check(topo, cfg)
    else:
        plan = s.to_plan(cfg, topo, shape, abstract=True)
        assert plan.mesh == {"pipe": 2, "data": 4, "model": 1}


# ---------------------------------------------------------------------------
# the layer's parts
# ---------------------------------------------------------------------------

def _layer(arch="deepseek-moe-16b", T=48, seed=0, **moe_over):
    jc, tc = _cfgs(arch)
    if moe_over:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                             **moe_over))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                             **moe_over))
    p = jax.tree.map(np.asarray, jmoe.init_moe(jc, jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).standard_normal(
        (T, jc.d_model)).astype(np.float32)
    return jc, tc, p, x


def _tp(tree):
    return {k: _tp(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def test_router_matches_jax():
    jc, tc, p, x = _layer()
    probs, w, ids, aux = tmoe._router(tc, _tp(p), torch.tensor(x))
    jprobs, jw, jids, jaux = jmoe._router(jc, p, jnp.asarray(x))
    assert _rel(probs.numpy(), jprobs) < LAYER_REL
    assert _rel(w.numpy(), jw) < LAYER_REL
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert abs(float(aux) - float(jaux)) < 1e-7


@pytest.mark.parametrize("E,C", [(4, 8), (4, 3), (8, 1), (3, 50)])
def test_route_capacity_matches_jax(E, C):
    """dest and inv exactly, with items dropped (C 1, 3) and none (50)."""
    fids = np.random.default_rng(E * C).integers(0, E, 40).astype(np.int32)
    dest, inv = tmoe._route_capacity(torch.tensor(fids), E, C)
    jdest, jinv = jmoe._route_capacity(jnp.asarray(fids), E, C)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def test_routed_take_forward_and_gradient():
    """y[i] = x[idx[i]] (zero rows where idx < 0) and its gradient, itself
    a gather through the inverse map, against the JAX custom VJP."""
    rng = np.random.default_rng(1)
    fids = rng.integers(0, 4, 30).astype(np.int32)
    dest, inv = jmoe._route_capacity(jnp.asarray(fids), 4, 5)
    x = rng.standard_normal((30, 6)).astype(np.float32)
    dy = rng.standard_normal((20, 6)).astype(np.float32)
    jy, vjp = jax.vjp(lambda a: jmoe._routed_take(a, inv, dest),
                      jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    y = tmoe._routed_take(tx, torch.tensor(np.asarray(inv)).long(),
                          torch.tensor(np.asarray(dest)).long())
    y.backward(torch.tensor(dy))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(dy))[0]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl,groups,cf", [
    ("dense", 1, 1.25), ("dropping", 1, 4.0), ("dropping", 4, 4.0),
    ("dropping", 1, 0.5), ("dropping", 4, 0.5)])
def test_dispatch_matches_jax(arch, impl, groups, cf):
    """``_moe_dense`` and ``_moe_dropping`` at groups 1 and 4, a capacity
    factor that drops nothing (4.0) and a tight one (0.5; capacity 8 of
    up to 24 items an expert): output, aux and the gradients of x and of
    every leaf, within 1e-5 of scale."""
    jc, tc, p, x = _layer(arch, T=96, capacity_factor=cf)
    fn = {"dense": (tmoe._moe_dense, jmoe._moe_dense),
          "dropping": (tmoe._moe_dropping, jmoe._moe_dropping)}[impl]
    dy = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    tp = {k: v.requires_grad_() for k, v in _tp(p).items()
          if not isinstance(v, dict)}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = fn[0](tc, tp, tx, Runtime(moe_groups=groups))
    ((y * torch.tensor(dy)).sum() + aux).backward()

    def jloss(pp, xx):
        yy, a = fn[1](jc, pp, xx, JRuntime(moe_groups=groups))
        return jnp.sum(yy * jnp.asarray(dy)) + a, (yy, a)
    jp = {k: v for k, v in p.items() if not isinstance(v, dict)}
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, (0, 1), has_aux=True)(jp, jnp.asarray(x))
    assert _rel(y.detach().numpy(), jy) < LAYER_REL
    assert abs(float(aux) - float(jaux)) < 1e-7
    assert _rel(tx.grad.numpy(), jgx) < LAYER_REL
    for k, v in tp.items():
        assert _rel(v.grad.numpy(), jgp[k]) < LAYER_REL, k


def test_apply_moe_with_shared_experts():
    """``apply_moe`` on (B, S, d) with deepseek's shared experts, under
    'auto' (dense at this B S E) and 'dropping'."""
    jc, tc, p, _ = _layer()
    x = np.random.default_rng(3).standard_normal(
        (2, 24, jc.d_model)).astype(np.float32)
    assert "shared" in p
    for impl in ("auto", "dropping"):
        y, aux = tmoe.apply_moe(tc, _tp(p), torch.tensor(x),
                                Runtime(moe_impl=impl))
        jy, jaux = jmoe.apply_moe(jc, p, jnp.asarray(x),
                                  JRuntime(moe_impl=impl))
        assert _rel(y.numpy(), jy) < LAYER_REL, impl
        assert abs(float(aux) - float(jaux)) < 1e-7


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

# a node-bandwidth-constrained cluster: 8 nodes of 8 H100s, islands of 8
NODES = (strategy.Topology("nodes", 64, island=8, hardware="H100",
                           hbm=80e9),
         jstrategy.Topology("nodes", 64, island=8, hardware="H100",
                            hbm=80e9))


@pytest.mark.parametrize("topo", ["nodes", "pod"])
@pytest.mark.parametrize("arch", ARCHS + ["jamba-v0.1-52b"])
def test_planner_ranks_moe_strategies_as_jax(arch, topo):
    """The port's ranking equals the JAX package's over every candidate:
    it keeps the ep strategies and those of tp, pp and cp on a MoE
    config, and ``--strategy auto`` picks JAX's best."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mine_t, ref_t = NODES if topo == "nodes" else (
        strategy.pod_topology(), jstrategy.pod_topology())
    shape = ShapeConfig("x", 4096, 256, "train")
    ranked = strategy.search(cfg, mine_t, shape)
    ref = jstrategy.search(jcfg, ref_t, JShapeConfig("x", 4096, 256,
                                                     "train"))
    assert [p.spec for p in ranked] == [p.spec for p in ref]
    assert [p.report.row() for p in ranked] == [p.report.row() for p in ref]
    assert any(p.strategy.ep > 1 for p in ranked)
    assert strategy.resolve("auto", cfg, mine_t, shape)[0].format() == \
        ref[0].spec
