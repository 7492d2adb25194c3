"""MoE under tensor parallelism (``fsdp_tp2``, and ``fsdp_tp2_ep2``: the
expert all-to-all on the expert axis with each expert's FFN split on its
hidden dim over the model axis) against the JAX package's single-device
step, on gloo worlds of 2 and 4 processes on the CPU.

The JAX package's own sharded MoE tests are red on this jax
(``tests/test_spmd.py::test_sharded_train_equivalence[deepseek-moe-16b-
None]``, ``tests/test_expert_parallel.py``), so the reference is its
single-device ``make_train_step`` at the same weights (``bridge``) and
batch, with the plan's dispatch: dropping in dp groups (``moe_groups``,
one a data-parallel rank, as ``tests/test_torch_ep.py`` holds the
all-to-all).  One AdamW step: loss, nll, aux and grad_norm within 1e-5
relative, the first moments (a tenth of each clipped gradient) within
1e-4 of each leaf's scale (``tests/test_torch_fsdp.py``'s f32 bars).  Every rank also reports its
parameters' placements, which must be those ``core.parallel`` reads off
``_param_spec`` (the full-size specs are held to JAX's in
``tests/test_torch_tp.py``), and the MoE FFN's combine over the model axis
once a MoE layer (``DISPATCH_STATS``, ``COLLECTIVE_SITES``).

The worlds' machinery here is shared by ``tests/test_torch_moe_pp.py``
and ``tests/test_torch_cp.py`` (each spawns its own worlds once per
module).  Spawned workers import only torch and the port; JAX runs in the
test process.
"""
import dataclasses
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_fsdp import (F32_BARS, LR, STEPS, S, _batches, _compare,
                             _jax_config, _jax_tree, _join, _stop, jax_run,
                             jax_train_step, start_ranks)
from test_torch_fsdp import _few_threads  # noqa: F401

DEEPSEEK = ("deepseek-moe-16b", {})
DBRX = ("dbrx-132b", {})
AUX_REL = 1e-6
# (spec, arch, config overrides) per world size
WORLDS = {2: [("fsdp_tp2", *DEEPSEEK), ("fsdp_tp2", *DBRX),
              ("fsdp_tp2_nosp", *DEEPSEEK)],
          # data 1 x expert 2 x model 2: the all-to-all between the two
          # expert ranks of each model coordinate
          4: [("fsdp_tp2_ep2", *DEEPSEEK), ("fsdp_tp2_ep2", *DBRX),
              ("fsdp_tp2", *DBRX)]}
SPAWN_TIMEOUT = 300


def _cfg(arch, over):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **over)


def _degrees(spec, n):
    """(data-parallel degree, pipeline microbatches) of ``spec`` on n
    ranks."""
    from repro_torch import strategy
    s = strategy.parse(spec)
    return n // (s.tp * s.cp * s.pp), s.microbatches if s.pp > 1 else 1


# ---------------------------------------------------------------------------
# the spawned worlds (torch and the port only)
# ---------------------------------------------------------------------------

def _placements_ok(cfg, plan, params):
    """Whether every parameter's model-axis (and, on a MoE FFN under an
    expert axis, expert-axis) placement is the one ``core.parallel`` reads
    off ``_param_spec``."""
    from repro_torch.core import parallel as par
    bad = []
    for name, p in params.named_parameters():
        names = p.device_mesh.mesh_dim_names
        if par.on_expert_axis(name, cfg, plan):
            want = dict(zip((plan.expert, plan.tp)[:1 + (plan.tp_size > 1)],
                            par.expert_placements(cfg, plan, name, p)))
        else:
            want = {plan.tp: par.model_placement(cfg, plan, name, p)}
        for axis, place in want.items():
            if p.placements[names.index(axis)] != place:
                bad.append((name, axis, p.placements, place))
    return bad


def _train_case(case, rank):
    """One AdamW step of the case's spec -> metrics, final params and
    first moments, and what the rank checked of its layout and calls."""
    from repro_torch import bridge, strategy
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import expert as expert_lib
    from repro_torch.core import parallel as par
    from repro_torch.models import layers
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import make_train_step

    spec, arch, over = case["case"]
    cfg = _cfg(arch, over)
    s = strategy.parse(spec)
    B = case["batches"][0]["labels"].shape[0]
    shape = ShapeConfig("test", S, B, "train")
    plan = s.to_plan(cfg, strategy.host_topology(), shape)
    rt = par.make_runtime(cfg, plan, shape, remat=False)
    params = par.apply_plan(bridge.params_from_jax(case["tree"]), plan, cfg)
    state = init_opt_state(params)
    step = make_train_step(cfg, rt, TrainConfig(
        steps=STEPS, warmup=1, grad_accum=s.grad_accum,
        opt=AdamWConfig(lr=LR, weight_decay=0.0)), plan)
    expert_lib.reset_dispatch_stats()
    layers.reset_collective_counts()
    metrics = []
    for b in case["batches"]:
        _, state, m = step(params, state, {k: torch.tensor(v)
                                           for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    calls = dict(dispatch=expert_lib.dispatch_stats_snapshot(),
                 sites=dict(layers.COLLECTIVE_SITES))
    pipe_group = rt.pipe_group if rt.pipe_size > 1 else None
    tree = bridge.train_state_to_tree(params, state, cfg, pipe_group)
    out = dict(metrics=metrics, params=tree["params"], m=tree["opt"]["m"],
               bad=_placements_ok(cfg, plan, params), calls=calls,
               mesh=dict(zip(plan.mesh.mesh_dim_names, plan.mesh.shape)),
               attn=plan.attn, tp=rt.tp_size, context=rt.context)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, {k: out[k] for k in ("bad", "calls")})
    out["ranks"] = parts
    return out if rank == 0 else None


def _world(rank, n, payload, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}.store",
                            rank=rank, world_size=n)
    try:
        with open(payload, "rb") as f:
            cases = pickle.load(f)
        results = []
        for c in cases:
            run = c.pop("run", None)
            results.append(run(c, rank) if run else _train_case(c, rank))
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# inputs and the JAX single-device reference (test process)
# ---------------------------------------------------------------------------

def _inputs(case, n):
    """The case's initial weights (JAX's init, as numpy) and one batch: 2
    rows a data-parallel rank a pipeline microbatch, 3/4 of the labels of
    half a rank's rows masked (each microbatch alike)."""
    spec, arch, over = case
    jc, tree = _jax_tree(arch, over)
    dp, M = _degrees(spec, n)
    return dict(tree=tree, batches=_batches(
        jc.vocab_size, 2 * dp * M, max(dp, 2), M, seed=n)[:1])


def _jax_step(case, n, tree, batches):
    """JAX's single-device step with the plan's dispatch (dropping in dp
    groups a microbatch) and, for a pipeline, its M microbatches as
    gradient accumulation (the same per-microbatch aux and, with every
    microbatch masked alike, the same loss)."""
    from repro.models.layers import Runtime as JRuntime
    spec, arch, over = case
    jc = _jax_config(arch, over)
    dp, M = _degrees(spec, n)
    kw = dict(moe_impl="dropping", moe_groups=dp) if jc.moe.n_experts \
        else {}
    return jax_run(jax_train_step(jc, JRuntime(**kw), M, 0.0), tree,
                   batches)


def spawn_worlds(worlds, tmp_path_factory, tag, inputs=_inputs,
                 reference=_jax_step):
    """{n: [(case, rank 0's result, JAX reference)]}: every world spawned
    at once, each running all its cases (a case's payload may name the
    worker function that runs it, ``run``), while this process computes
    the references."""
    started, refs = {}, {}
    try:
        for n, cases in worlds.items():
            d = tmp_path_factory.mktemp(f"{tag}{n}")
            payload = [dict(case=c, **inputs(c, n)) for c in cases]
            with open(d / "payload.pkl", "wb") as f:
                pickle.dump(payload, f)
            started[n] = (d / "out.pkl", start_ranks(
                _world, (n, str(d / "payload.pkl"), str(d / "out.pkl")), n))
        for n, cases in worlds.items():
            refs[n] = [reference(c, n, **inputs(c, n)) for c in cases]
        out = {}
        deadline = time.time() + SPAWN_TIMEOUT
        for n, (path, ctx) in started.items():
            _join(n, ctx, deadline)
            with open(path, "rb") as f:
                got = pickle.load(f)
            out[n] = list(zip(worlds[n], got, refs[n], strict=True))
        return out
    finally:
        for _, ctx in started.values():
            _stop(ctx)


def check_step(case, got, ref):
    """The first step's loss, nll, ntok and grad_norm within 1e-5 relative
    and its gradients within 1e-4 of each leaf's scale (the f32 bars of
    metrics and moments: after one step a first moment is a tenth of the
    clipped gradient), and the aux within AUX_REL.  The parameters after
    the step are not held: Adam's first step moves a leaf by about lr
    wherever its gradient is rounding noise in both (an expert that no
    token reached), whatever its sign."""
    _compare(got, ref, {k: F32_BARS[k] for k in ("metric", "moment")}, case)
    for a, b in zip(got["metrics"], ref["metrics"], strict=True):
        assert abs(a["aux"] - b["aux"]) <= AUX_REL * max(abs(b["aux"]),
                                                         1e-30), (case, a, b)
    assert np.isfinite(got["metrics"][-1]["loss"])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return spawn_worlds(WORLDS, tmp_path_factory, "moetp")


CASES = [(n, i) for n, cases in WORLDS.items() for i in range(len(cases))]


def _ids_of(worlds):
    def ids(c):
        n, i = c
        spec, arch, _ = worlds[n][i][:3]
        return f"{n}-{spec}-{arch}"
    return ids


_ids = _ids_of(WORLDS)


@pytest.mark.parametrize("world_case", CASES, ids=_ids)
def test_moe_steps_under_tp_match_the_jax_step(worlds, world_case):
    n, i = world_case
    case, got, ref = worlds[n][i]
    check_step((n,) + case, got, ref)
    assert got["tp"] == 2 and got["attn"] == "head_tp" \
        and not got["context"]


@pytest.mark.parametrize("world_case", CASES, ids=_ids)
def test_moe_layers_combine_over_the_model_axis(worlds, world_case):
    """Each rank holds its parameters as ``_param_spec`` places them (the
    expert stacks' E dim on the model axis, or under an expert axis their
    hidden dim), and every MoE layer's FFN combined its partial sums over
    the model axis once a forward."""
    n, i = world_case
    case, got, _ = worlds[n][i]
    cfg = _cfg(case[1], case[2])
    n_moe = sum(cfg.is_moe_layer(j) for j in range(cfg.n_layers))
    for r in got["ranks"]:
        assert r["bad"] == [], (case, r["bad"])
        assert r["calls"]["sites"]["moe_combine"] == n_moe
        assert r["calls"]["dispatch"]["ep_calls"] == \
            (n_moe if "ep" in case[0] else 0)
    assert got["mesh"]["model"] == 2
    if "ep" in case[0]:
        assert got["mesh"]["expert"] == 2
