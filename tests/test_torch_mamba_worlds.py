"""jamba-v0.1-52b under a plan, against the JAX package, on the CPU (the
single-process tests: ``tests/test_torch_mamba.py``):

- one AdamW step of the reduced jamba (4 layers over Kv 2: Mamba,
  attention + MoE, Mamba + MoE, attention + MoE) on gloo worlds of 2
  processes under ``fsdp_tp2`` (each Mamba layer on its half of d_inner,
  the x-projection's partial sums all-reduced both ways; attention on its
  heads; the experts split over the model axis), ``fsdp_ep2`` (the expert
  all-to-all) and ``fsdp_cp2`` (each rank its half of the sequence; every
  Mamba layer scans the whole sequence, gathered at its entry and
  reduce-scattered at its exit), against JAX's single-device step
  (``tests/test_torch_moe_tp.py``'s worlds and bars: metrics within 1e-5,
  first moments within 1e-4 of each leaf's scale).  The JAX package's own
  sharded jamba tests are red on this jax
  (``tests/test_spmd.py::test_sharded_train_equivalence[jamba-v0.1-52b-
  None]``);
- static serving under ``fsdp_tp2`` and ``fsdp_cp2``, token for token
  JAX's single-device ``generate_static`` with the plan's MoE dispatch
  (dropping);
- the parameter and activation specs of the full-size jamba against
  JAX's, and ``Strategy.check``'s refusal of a pipeline on the
  non-uniform stack, word for word JAX's (the planner's ranking:
  ``tests/test_torch_moe.py``; the cache specs:
  ``tests/test_torch_static.py``).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
from test_torch_cp import N_NEW, S0, _case_inputs, gathers
from test_torch_moe_tp import _cfg, _jax_step, check_step, spawn_worlds
from test_torch_tp import _jax_leaves, _norm_entry
from test_torch_fsdp import _few_threads  # noqa: F401

ARCH = "jamba-v0.1-52b"
JAMBA = (ARCH, dict(n_layers=4, n_kv_heads=2))
SPECS = ["fsdp_tp2", "fsdp_ep2", "fsdp_cp2"]
WORLDS = {2: [(s, *JAMBA) for s in SPECS]
          + [("serve-fsdp_tp2", *JAMBA), ("serve-fsdp_cp2", *JAMBA),
             ("ckpt-fsdp_tp2", *JAMBA)]}
CKPT_S, CKPT_B = 16, 4


def _ckpt_case(case, rank):
    """One AdamW step under the case's plan from JAX's weights, saved at
    step 1 in the JAX package's layout, then restored into fresh weights
    of the same plan (``train_loop``'s resume) -> (the saved state, the
    restored state), gathered."""
    from repro_torch import bridge, strategy
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as par
    from repro_torch.data import Batcher, SyntheticSource
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, train_loop
    spec, arch, over = case["case"]
    cfg = _cfg(arch, over)
    shape = ShapeConfig("test", CKPT_S, CKPT_B, "train")
    plan = strategy.parse(spec.split("-", 1)[1]).to_plan(
        cfg, strategy.host_topology(), shape)
    rt = par.make_runtime(cfg, plan, shape, remat=False)
    tc = TrainConfig(steps=1, warmup=1, log_every=100, ckpt_every=1,
                     ckpt_dir=case["dir"],
                     opt=AdamWConfig(weight_decay=0.0))

    def batches():
        return Batcher(SyntheticSource(cfg.vocab_size, seed=7), CKPT_S,
                       CKPT_B)

    params = par.apply_plan(bridge.params_from_jax(case["tree"]), plan, cfg)
    params, opt, _ = train_loop(cfg, rt, tc, batches(), params, plan=plan)
    saved = bridge.train_state_to_tree(params, opt, cfg)
    fresh = par.apply_plan(init_params(cfg, 1, "cpu"), plan, cfg)
    fresh, fopt, _ = train_loop(
        cfg, rt, dataclasses.replace(tc, ckpt_every=0, resume=True),
        batches(), fresh, plan=plan)
    restored = bridge.train_state_to_tree(fresh, fopt, cfg)
    return (saved, restored) if rank == 0 else None


def _reference(case, n, tree, prompts=None, batches=None, run=None):
    """JAX's single-device step, or its ``generate_static`` with the
    serving plan's dispatch: dropping in one group (the serving runtime's
    ``moe_groups`` on a data axis of 1)."""
    if batches is not None:
        return _jax_step(case, n, tree, batches)
    import jax.numpy as jnp

    from repro.models.layers import Runtime as JRuntime
    from repro.serve import ServeEngine as JServeEngine
    from test_torch_fsdp import _jax_tree
    jc, _ = _jax_tree(case[1], case[2])
    rt = JRuntime(moe_impl="dropping", moe_groups=1)
    return np.asarray(JServeEngine(jc, tree, rt, max_len=S0 + N_NEW)
                      .generate_static(jnp.asarray(prompts), N_NEW))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))

    def inputs(case, n):
        if not case[0].startswith("ckpt-"):
            return _case_inputs(case, n)
        from test_torch_fsdp import _jax_tree
        return dict(tree=_jax_tree(case[1], case[2])[1], dir=ckpt_dir,
                    run=_ckpt_case)

    def reference(case, n, tree, dir=None, **kw):
        return dir if dir is not None else _reference(case, n, tree, **kw)

    return spawn_worlds(WORLDS, tmp_path_factory, "mamba", inputs,
                        reference)


@pytest.mark.parametrize("i", range(len(SPECS)), ids=SPECS)
def test_jamba_steps_under_a_plan_match_the_jax_step(worlds, i):
    """The step against JAX's; every rank holds its parameters where
    ``_param_spec`` puts them (the Mamba leaves on the model axis under
    tp and cp alike), every MoE layer combined over the model axis once,
    and under fsdp_cp2 every attention layer gathered K and V and every
    Mamba layer the sequence."""
    case, got, ref = worlds[2][i]
    spec = case[0]
    check_step((2,) + case, got, ref)
    cfg = _cfg(case[1], case[2])
    kv, seq = gathers(cfg)
    n_moe = sum(cfg.is_moe_layer(j) for j in range(cfg.n_layers))
    for r in got["ranks"]:
        assert r["bad"] == [], r["bad"]
        sites = r["calls"]["sites"]
        assert sites["context_kv_gather"] == (kv if spec == "fsdp_cp2"
                                              else 0)
        assert sites["context_seq_gather"] == (seq if spec == "fsdp_cp2"
                                               else 0)
        assert sites["moe_combine"] == (0 if spec == "fsdp_ep2" else n_moe)
        assert r["calls"]["dispatch"]["ep_calls"] == \
            (n_moe if spec == "fsdp_ep2" else 0)
    assert got["attn"] == ("context" if spec == "fsdp_cp2" else "head_tp")
    assert got["tp"] == (1 if spec == "fsdp_ep2" else 2)


@pytest.mark.parametrize("spec", ["fsdp_tp2", "fsdp_cp2"])
def test_static_serving_under_a_plan_matches_jax(worlds, spec):
    """Both ranks' greedy tokens equal JAX's single-device
    ``generate_static``: the Mamba layers' conv and SSM states split by
    channels over the model axis beside the attention KV (a fsdp_cp2
    prefill gathers the sequence in every Mamba layer)."""
    i = [c[0] for c in WORLDS[2]].index(f"serve-{spec}")
    case, parts, toks = worlds[2][i]
    _, seq = gathers(_cfg(case[1], case[2]))
    for p in parts:
        np.testing.assert_array_equal(p["tokens"], toks)
        assert p["tp"] == 2 and p["context"] == (spec == "fsdp_cp2")
        assert p["sites"]["context_seq_gather"] == (seq if p["context"]
                                                    else 0)


def test_a_tp_checkpoint_restores_across_meshes_and_packages(worlds):
    """The checkpoint written under fsdp_tp2 (each Mamba leaf split over
    the model axis, FSDP2's shards on the data axis) restores bit for bit
    into fresh weights of the same plan, into one process with no plan
    (``load_train_state``), and into the JAX package's tree
    (``restore_checkpoint`` against its own ``init_params``'s shapes)."""
    import jax

    from repro.checkpointing import restore_checkpoint as jax_restore
    from repro.optim import init_opt_state as jax_init_opt_state
    from repro_torch import bridge
    from repro_torch import checkpointing as ckpt_lib
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state
    from test_torch_fsdp import _jax_tree
    i = [c[0] for c in WORLDS[2]].index("ckpt-fsdp_tp2")
    case, (saved, restored), d = worlds[2][i]

    def equal(a, b):
        la = jax.tree_util.tree_flatten_with_path(a)[0]
        lb = jax.tree_util.tree_flatten_with_path(b)[0]
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, x), (_, y) in zip(la, lb):
            assert np.array_equal(np.asarray(x), np.asarray(y)), path

    equal(restored, saved)
    assert "w_x" in saved["params"]["blocks"][0]["mixer"]
    cfg = _cfg(case[1], case[2])
    params = init_params(cfg, 2, "cpu")
    opt = init_opt_state(params)
    tree = ckpt_lib.restore_checkpoint(d, 1, bridge.train_state_target(
        params, cfg), verify=True)
    bridge.load_train_state(tree, params, opt)
    equal(bridge.train_state_to_tree(params, opt, cfg), saved)
    _, jtree = _jax_tree(case[1], case[2])
    target = {"params": jtree, "opt": jax_init_opt_state(jtree)}
    equal(jax.tree.map(np.asarray, jax_restore(d, 1, target, verify=True)),
          saved)


# ---------------------------------------------------------------------------
# specs, the planner and the strategy checks (no process group)
# ---------------------------------------------------------------------------

def _plans(spec):
    """(port config, port plan, JAX plan) of ``spec`` on 8 devices,
    abstract."""
    from repro.core import parallel as jpar
    from repro_torch import strategy
    from repro_torch.configs import ShapeConfig, get_config
    cfg = get_config(ARCH)
    plan = strategy.parse(spec).to_plan(
        cfg, strategy.host_topology(n_devices=8),
        ShapeConfig("x", 512, 8, "train"), abstract=True)
    jplan = jpar.ParallelPlan(
        mesh=SimpleNamespace(shape=dict(plan.mesh)), dp=plan.dp,
        fsdp=plan.fsdp, tp=plan.tp, attn=plan.attn, kv_tp=plan.kv_tp,
        seq_parallel_residuals=plan.seq_parallel_residuals)
    return cfg, plan, jplan


@pytest.mark.parametrize("spec", ["fsdp", "fsdp_tp2", "fsdp_tp8",
                                  "fsdp_cp2"])
def test_param_and_activation_specs_match_jax(spec):
    """Every leaf of the full-size model: the port's fitted
    ``_param_spec`` is JAX's (JAX's stacked layer dim dropped) and
    ``param_placements`` puts the model axis on its dim; the activation
    specs the port reads are JAX's, whose residual stream a hybrid keeps
    whole along S (no sequence parallelism)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro.configs import get_config as jax_get_config
    from repro.core import parallel as jpar
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as par
    jcfg, leaves = _jax_leaves(ARCH)
    cfg, plan, jplan = _plans(spec)
    metas = [(n, torch.empty(shape[1:] if stacked else shape,
                             device="meta"))
             for n, (_, shape, stacked) in leaves.items()]
    got = par.param_placements(cfg, plan, metas)
    for name, (path, shape, stacked) in leaves.items():
        jspec = jpar._fit_spec(jpar._param_spec(jcfg, jplan, path,
                                                len(shape)), shape,
                               jplan.mesh)
        jspec = tuple(_norm_entry(e) for e in jspec)[int(stacked):]
        mine = par.fitted(plan, par._param_spec(
            cfg, plan, tuple(name.split(".")), len(jspec)),
            shape[int(stacked):])
        assert tuple(_norm_entry(e) for e in mine) == jspec, (spec, name)
        dims = [d for d, e in enumerate(jspec)
                if "model" in (e if isinstance(e, tuple) else (e,))]
        assert got[name] == (Shard(dims[0]) if dims else Replicate()), \
            (spec, name, got[name])
    if plan.tp_size > 1:
        assert got["layers.0.mixer.w_x"] == Shard(0)
        assert got["layers.0.mixer.w_x_in"] == Shard(1)
    want = jpar.activation_specs(jax_get_config(ARCH), jplan)
    for name, mine in par.activation_specs(cfg, plan).items():
        assert tuple(_norm_entry(e) for e in mine) == \
            tuple(_norm_entry(e) for e in want[name]), (spec, name)
    rt = par.make_runtime(cfg, plan, ShapeConfig("x", 512, 8, "train"))
    assert not rt.seq_parallel
    assert rt.context == (spec == "fsdp_cp2")


def test_strategy_checks_are_jaxs():
    """``Strategy.check`` refuses a pipeline on the non-uniform stack with
    JAX's words, and accepts the tp, cp and ep specs JAX accepts; a model
    axis that does not split d_inner is the port's own refusal."""
    from repro import strategy as jstrategy
    from repro.configs import get_config as jax_get_config
    from repro_torch import strategy
    from repro_torch.configs import get_config
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    topo, jtopo = (strategy.host_topology(n_devices=8),
                   jstrategy.host_topology(n_devices=8))
    for spec in ("fsdp_pp2_mb4", "fsdp_pp4_mb4_1f1b"):
        with pytest.raises(jstrategy.StrategyError) as want:
            jstrategy.parse(spec).check(jtopo, jcfg)
        with pytest.raises(strategy.StrategyError) as got:
            strategy.parse(spec).check(topo, cfg)
        assert str(got.value) == str(want.value)
    for spec in ("fsdp", "fsdp_tp2", "fsdp_tp8", "fsdp_cp2", "fsdp_cp8",
                 "fsdp_ep8", "fsdp_tp2_ep2", "hsdp_tp2"):
        strategy.parse(spec).check(topo, cfg)
        jstrategy.parse(spec).check(jtopo, jcfg)
    odd = dataclasses.replace(cfg, d_model=4097, n_heads=2, n_kv_heads=2,
                              mamba=dataclasses.replace(cfg.mamba,
                                                        expand=1))
    with pytest.raises(strategy.StrategyError, match="d_inner=4097"):
        strategy.parse("fsdp_tp2").check(topo, odd)
    with pytest.raises(strategy.StrategyError, match="d_inner=4097"):
        strategy.parse("fsdp_cp2").check(topo, odd)


# ---------------------------------------------------------------------------
# the dry run at full depth (fake process group of the pod, 256 ranks)
# ---------------------------------------------------------------------------

DRY_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


@pytest.fixture(scope="module")
def dry_records(tmp_path_factory):
    """The four points below, traced at once."""
    from test_torch_dryrun import trace_points
    return trace_points(
        {shape: (ARCH, shape, dict(strategy="auto" if shape == "train_4k"
                                   else "")) for shape in DRY_SHAPES},
        tmp_path_factory.mktemp("dry"))


@pytest.mark.parametrize("shape", DRY_SHAPES)
def test_dry_run_points_trace_at_full_depth(shape, dry_records):
    """Every point of the 32-layer jamba traces on the pod (train_4k under
    what ``--strategy auto`` ranks first, the serving points on the pod
    layout); its analytic FLOP fields, parameter counts and resilience
    block are JAX's for the same point, and a serving point's caches are
    tracked."""
    from repro import strategy as jstrategy
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from test_torch_dryrun import _analytic_equal, _jax_resilience
    rec = dry_records[shape]
    assert rec["status"] == "ok", rec.get("traceback")
    jcfg = jax_get_config(ARCH)
    _analytic_equal(rec, jcfg, JSHAPES[shape])
    assert rec["resilience"] == _jax_resilience(
        jcfg, jstrategy.parse(rec["strategy"]), jstrategy.get_topology("pod"))
    assert rec["n_devices"] == 256
    cfg = get_config(ARCH)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    if rec["plan"]["expert"]:
        # a train point's recompute dispatches every MoE layer again
        assert rec["moe_dispatch"]["ep_calls"] + \
            rec["moe_dispatch"]["ep_padded_calls"] == \
            n_moe * (2 if rec["remat"] else 1)
    if shape != "train_4k":
        assert rec["memory"]["cache_bytes"] >= \
            rec["cache_bytes_per_device"] > 0
