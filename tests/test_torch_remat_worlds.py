"""Block remat and the expert stacks' data-axis shards on gloo worlds of
2 and 4 processes on the CPU, against the JAX package's single-device
step (``tests/test_torch_fsdp.py``'s harness and f32 bars: three AdamW
steps from the same numpy weights and batches, metrics within 1e-5,
moments within 1e-4 of scale, parameters in units of lr).

Every case runs under ``make_runtime``'s train runtime, remat on, and JAX
under ``Runtime(remat=True)``:

- ``fsdp`` at ZeRO-3 on a reduced jamba of 2 layers: one block of period
  2 (a Mamba layer, then an attention + MoE layer), one checkpoint over
  two FSDP2 units, the first of which the backward's rerun gathers again
  before its own backward; and the same with ``remat_inner``;
- ``fsdp_pp2_mb2`` under gpipe, 1f1b and zb on a reduced qwen3 of 4
  layers: each stage checkpoints each of its layers;
- a reduced dbrx-132b of 2 experts on 4 ranks, under ``fsdp`` (data 4)
  and ``fsdp_ep2`` (data 2 x expert 2, one expert a rank): the data
  degree is above E (or E / ep), and each rank holds 1 / data of every
  expert stack's d (``core.parallel.data_shard_dim``: dim 1 of ``w_up``
  and ``w_gate``, dim 2 of ``w_down``), not a padded row of E.

Spawned workers import only torch and the port; JAX runs in the test
process.
"""
import dataclasses
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_fsdp import F32_BARS, LR, S, STEPS, _batches, _errors, \
    _join, _stop, jax_run, jax_train_step, start_ranks
from test_torch_fsdp import _few_threads  # noqa: F401

JAMBA = ("jamba-v0.1-52b", 2, {})
QWEN = ("qwen3-0.6b", 4, dict(n_kv_heads=2))
DBRX = ("dbrx-132b", 2, dict(n_experts=2, top_k=1))
# (spec, model, runtime overrides)
WORLDS = {
    2: [("fsdp", JAMBA, {}), ("fsdp", JAMBA, dict(remat_inner=True)),
        ("fsdp_pp2_mb2", QWEN, {}), ("fsdp_pp2_mb2_1f1b", QWEN, {}),
        ("fsdp_pp2_mb2_zb", QWEN, {})],
    4: [("fsdp", DBRX, {}), ("fsdp_ep2", DBRX, {})],
}
# the fp8 wire over stacks sharded on d (4 ranks, data 4): each MoE
# layer's gathered stacks against their whole values rounded through it
WIRE = ("fsdp_fp8", DBRX)
SPAWN_TIMEOUT = 300
STACKS = ("w_up", "w_gate", "w_down")


def _cfg(model, get_config, reduced):
    arch, n_layers, over = model
    cfg = reduced(get_config(arch), n_layers=n_layers)
    moe = {k: over[k] for k in ("n_experts", "top_k") if k in over}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return dataclasses.replace(cfg, **{k: v for k, v in over.items()
                                       if k not in moe})


# ---------------------------------------------------------------------------
# the spawned worlds (torch and the port only)
# ---------------------------------------------------------------------------

def _run_case(case, rank):
    from repro_torch import strategy
    from repro_torch.bridge import (opt_state_to_jax, params_from_jax,
                                    params_to_jax)
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.core import parallel as par
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.strategy.topology import mesh_shape
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import make_train_step

    spec, model, over = case["case"]
    cfg = _cfg(model, get_config, reduced)
    s = strategy.parse(spec)
    B = case["batches"][0]["labels"].shape[0]
    shape = ShapeConfig("test", S, B, "train")
    plan = s.to_plan(cfg, strategy.host_topology(), shape)
    rt = par.make_runtime(cfg, plan, shape, **over)
    params = par.apply_plan(params_from_jax(case["tree"]), plan, cfg)
    stacks = {n: (tuple(p.to_local().shape), tuple(p.shape))
              for n, p in params.named_parameters()
              if n.split(".")[-1] in STACKS and p.ndim == 3}
    state = init_opt_state(params)
    step = make_train_step(cfg, rt, TrainConfig(
        steps=STEPS, warmup=1, grad_accum=s.grad_accum,
        opt=AdamWConfig(lr=LR, weight_decay=0.0)), plan)
    metrics = []
    for b in case["batches"]:
        _, state, m = step(params, state, {k: torch.tensor(v)
                                           for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    out = dict(metrics=metrics,
               params=params_to_jax(params, cfg, rt.pipe_group),
               m=opt_state_to_jax(state, cfg, rt.pipe_group)["m"],
               stacks=stacks,
               remat=(rt.remat, rt.remat_inner), mesh=mesh_shape(plan.mesh))
    return out if rank == 0 else None


def _wire_case(case, rank):
    """Under ``fsdp_fp8``: every MoE layer unit's gathered expert stacks
    (its ``unshard``) against the whole stacks rounded through the wire
    (``layers.wire_round``), and the dtypes of its gather buffers."""
    from repro_torch import strategy
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.core import parallel as par
    from repro_torch.models.layers import wire_round
    from torch.distributed.tensor import DTensor

    spec, model = case["case"]
    cfg = _cfg(model, get_config, reduced)
    shape = ShapeConfig("test", S, 2 * dist.get_world_size(), "train")
    plan = strategy.parse(spec).to_plan(cfg, strategy.host_topology(), shape)
    rt = par.make_runtime(cfg, plan, shape)
    whole = params_from_jax(case["tree"])
    want = {n: wire_round({"w": p.detach().clone()}, rt.gather_dtype,
                          rt.compute_dtype)["w"]
            for n, p in whole.named_parameters()
            if n.split(".")[-1] in STACKS and p.ndim == 3}
    params = par.apply_plan(whole, plan, cfg)
    out = {}
    for i, layer in enumerate(params.layers):
        if not cfg.is_moe_layer(i):
            continue
        layer.unshard()
        for leaf in STACKS:
            p = layer["ffn"][leaf]
            got = p.to_local() if isinstance(p, DTensor) else p
            name = f"layers.{i}.ffn.{leaf}"
            out[name] = (str(got.dtype), tuple(got.shape),
                         bool(torch.equal(got, want[name])))
        out[f"layers.{i}.buffers"] = sorted(
            str(k) for k in par.all_gather_buffers(layer))
        layer.reshard()
    return out if rank == 0 else None


def _world(rank, n, payload, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}.store",
                            rank=rank, world_size=n)
    try:
        with open(payload, "rb") as f:
            cases = pickle.load(f)
        results = [_wire_case(c, rank) if c.get("wire") else
                   _run_case(c, rank) for c in cases]
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX single-device references (test process)
# ---------------------------------------------------------------------------

def _inputs(model, n):
    import jax

    from repro.configs import get_config, reduced
    from repro.models import transformer as jtfm
    jc = _cfg(model, get_config, reduced)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(9)))
    return jc, dict(tree=tree, batches=_batches(jc.vocab_size, 2 * n, n, 1,
                                                seed=n))


def _jax_trajectory(jc, inp, n, over):
    """JAX's single-device trajectory under remat, a MoE model's dropping
    dispatch in the ``n`` groups of the plan's data ranks."""
    from repro.models.layers import Runtime as JRuntime
    kw = dict(moe_impl="dropping", moe_groups=n) if jc.moe.n_experts else {}
    rt = JRuntime(remat=True, **kw, **over)
    return jax_run(jax_train_step(jc, rt, 1, 0.0), inp["tree"],
                   inp["batches"])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: [(case, port result, JAX reference)]}: every world spawned at
    once, each running all its cases, while this process computes the
    references (cases of one model and runtime share theirs)."""
    started, refs = {}, {}
    try:
        for n, cases in WORLDS.items():
            d = tmp_path_factory.mktemp(f"world{n}")
            payload, jcs = [], []
            for spec, model, over in cases:
                jc, inp = _inputs(model, n)
                jcs.append(jc)
                payload.append(dict(case=(spec, model, over), **inp))
            if n == 4:
                payload.append(dict(case=WIRE, wire=True,
                                    tree=_inputs(WIRE[1], n)[1]["tree"]))
            with open(d / "payload.pkl", "wb") as f:
                pickle.dump(payload, f)
            started[n] = (d / "out.pkl", start_ranks(
                _world, (n, str(d / "payload.pkl"), str(d / "out.pkl")), n))
            shared = {}
            refs[n] = []
            for (spec, model, over), p, jc in zip(cases, payload, jcs):
                key = (model[0], model[1], tuple(sorted(model[2].items())),
                       tuple(sorted(over.items())))
                if key not in shared:
                    shared[key] = _jax_trajectory(jc, p, n, over)
                refs[n].append(shared[key])
        deadline = time.time() + SPAWN_TIMEOUT
        out = {}
        for n, (path, ctx) in started.items():
            _join(n, ctx, deadline)
            with open(path, "rb") as f:
                got = pickle.load(f)
            if n == 4:
                out["wire"] = got.pop()
            out[n] = list(zip(WORLDS[n], got, refs[n], strict=True))
        return out
    finally:
        for _, ctx in started.values():
            _stop(ctx)


def _cases():
    return [(n, i) for n in WORLDS for i in range(len(WORLDS[n]))]


def _id(n, i):
    spec, model, over = WORLDS[n][i]
    return f"{n}-{spec}-{model[0]}" + ("-inner" if over else "")


@pytest.mark.parametrize("n,i", _cases(), ids=[_id(*c) for c in _cases()])
def test_remat_steps_match_jax_remat(worlds, n, i):
    case, got, ref = worlds[n][i]
    assert got["remat"] == (True, bool(case[2]))
    err = _errors(got, ref)
    assert all(err[k] < F32_BARS[k] for k in F32_BARS), (case, err)


@pytest.mark.parametrize("i", range(len(WORLDS[4])),
                         ids=[WORLDS[4][i][0] for i in range(len(WORLDS[4]))])
def test_expert_stacks_shard_on_d_over_more_data_ranks_than_experts(
        worlds, i):
    (spec, model, _), got, _ = worlds[4][i]
    mesh = got["mesh"]
    ep = mesh.get("expert", 1)
    data = mesh["data"]
    E = model[2]["n_experts"]
    assert data > E // ep
    assert got["stacks"]
    for name, (local, whole) in got["stacks"].items():
        dim = 2 if name.endswith("w_down") else 1
        want = list(whole)
        want[0] //= ep
        want[dim] //= data
        assert list(local) == want, (spec, name, local, whole)


def test_fp8_wire_gathers_stacks_sharded_on_d(worlds):
    """Each MoE layer unit's gathered stacks equal the whole stacks
    rounded through float8_e4m3fn into bf16, bit for bit, though each
    rank's shard lies on d (``Fp8Wire`` pads only a shard on dim 0); its
    gather buffers travel as uint8 on gloo (the fp8 bytes)."""
    got = worlds["wire"]
    assert got
    for name, v in got.items():
        if name.endswith("buffers"):
            assert v == ["torch.uint8"], (name, v)
            continue
        dtype, shape, equal = v
        assert dtype == "torch.bfloat16" and equal, (name, v)
