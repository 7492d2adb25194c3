"""Tensor parallelism of the port (head-TP, vocab-parallel embedding and
loss, Megatron-SP, on a (data, model) mesh under FSDP2) against the JAX
package, on gloo process groups on the CPU.

Each world (2 and 4 processes) is spawned once and runs all its cases:
three AdamW steps of a 2-layer model under a strategy spec, from the same
numpy weights (``bridge``) and batches as a JAX ``make_train_step``
trajectory on one device, held to the bars of
``tests/test_torch_fsdp.py``.  A rank also reports the shares it holds
and, for one layer, the collectives it calls.  The specs of parameters
and activations are held against the JAX package's at full size on
abstract meshes, with no process group.  Spawned workers import only
torch, the port and ``test_torch_fsdp``'s helpers; JAX runs in the test
process.
"""
import dataclasses
import pickle
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_fsdp import (F32_BARS, LOW_BARS, LR, STEPS, S, _batches,
                             _compare, _errors, _jax_trajectory, _jax_tree,
                             _join, _port_trajectory, _stop, _wire_bytes,
                             start_ranks)
from test_torch_fsdp import _few_threads  # noqa: F401

QWEN = ("qwen3-0.6b", dict(n_kv_heads=2), 0.0)   # kv_tp at tp 2, not at 4
RWKV = ("rwkv6-1.6b", {}, 0.1)
LLAMA = ("llama2-1b", {}, 0.1)
# qwen2-1.5b: qkv bias, Kv 2 split at tp 2; granite-20b: Kv 1 replicated
# (its bk/bv too), layernorm, GELU and sinusoidal positions, whose rows
# under sequence parallelism are each rank's S-shard
QWEN2 = ("qwen2-1.5b", {}, 0.1)
GRANITE = ("granite-20b", {}, 0.1)
# (spec, arch, config overrides, weight decay)
WORLDS = {
    2: [("fsdp_tp2", *QWEN), ("fsdp_tp2_nosp", *QWEN),
        ("fsdp_tp2_bf16", *QWEN), ("fsdp_tp2_fp8", *QWEN),
        ("fsdp_tp2", *RWKV), ("fsdp_tp2", *LLAMA), ("fsdp_tp2", *QWEN2),
        ("fsdp_tp2", *GRANITE)],
    # data 2 x model 2; model 4 with the 2 KV heads replicated (one query
    # head a rank); ZeRO-0 on its size-1 shard axis; two microbatches;
    # granite's one KV head on four model ranks
    4: [("fsdp_tp2", *QWEN), ("fsdp_tp4", *QWEN), ("ddp_tp2", *QWEN),
        ("fsdp_tp2_ga2", *QWEN), ("fsdp_tp2_fp8", *QWEN),
        ("fsdp_tp4", *GRANITE)],
}
# the collectives of one attention layer, forward and backward (counted
# per call by models.layers.COLLECTIVES): Megatron-SP enters each sublayer
# with an all-gather along S and leaves it with a reduce-scatter, whose
# backwards are each other; without SP the exits all-reduce forward and
# the entries backward
LAYER_COLLECTIVES = {
    "fsdp_tp2": ({"all_gather": 2, "reduce_scatter": 2, "all_reduce": 0,
                  "all_to_all": 0},
                 {"all_gather": 2, "reduce_scatter": 2, "all_reduce": 0,
                  "all_to_all": 0}),
    "fsdp_tp2_nosp": ({"all_gather": 0, "reduce_scatter": 0,
                       "all_reduce": 2, "all_to_all": 0},
                      {"all_gather": 0, "reduce_scatter": 0,
                       "all_reduce": 2, "all_to_all": 0}),
}
# Against a reference, a trajectory may differ by the bars of
# tests/test_torch_fsdp.py or by FLOOR times what the port's single-device
# step and JAX's differ by on the same case, whichever is larger.  Two
# cases need the floor (2 ranks, 2 layers, 3 steps; worst of the four
# numbers in brackets, as (metric, moment, lr_max, lr_mean)):
# - rwkv6 in f32: its gradients at init are badly conditioned (ROADMAP
#   Queue 3), and the unsharded port already differs from JAX by
#   (2.7e-5, 1.3e-4, 0.076, 1.9e-5), beyond the f32 bars; TP differs from
#   JAX by (2.2e-5, 1.3e-4, 0.13, 2.3e-5) and from the unsharded port by
#   (4.4e-6, 4.6e-5, 0.058, 1.5e-5), within them.
# - bf16 against the port: a row-parallel product's partial sums are
#   each rounded to bf16 before the sum over the model ranks, one more
#   rounding than on one device; TP differs from the unsharded port by
#   (5.7e-4, 0.025, 3.96, 0.033), as far as the unsharded port is from JAX
#   (1.7e-3, 0.028, 4.74, 0.033), and from JAX by (1.4e-3, 0.027, 4.57,
#   0.050), within the JAX bars.
FLOOR = 2
SPAWN_TIMEOUT = 300


def _case_cfg(arch, over):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **over)


# ---------------------------------------------------------------------------
# the spawned worlds (torch and the port only)
# ---------------------------------------------------------------------------

def _layer_collectives(cfg, params, rt):
    """(forward, backward) collective counts of one attention layer on
    this rank's share of a batch of 2 x S."""
    from repro_torch.models import layers
    from repro_torch.models.layers import rope_angles, sequence_parallel
    sp = sequence_parallel(rt, S)
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(2, S // rt.tp_size if sp else S, cfg.d_model,
                    generator=gen, requires_grad=True)
    pos = torch.arange(S)[None].expand(2, S)
    ang = rope_angles(pos, cfg.head_dim_, cfg.rope_theta)
    layers.reset_collective_counts()
    out = params.layers[0](cfg, "attn", h, ang, rt, None, None, sp)
    fwd = dict(layers.COLLECTIVES)
    layers.reset_collective_counts()
    out.square().sum().backward()
    bwd = dict(layers.COLLECTIVES)
    for p in params.parameters():
        p.grad = None
    return fwd, bwd


def _run_case(case, rank):
    from repro_torch import strategy
    from repro_torch.bridge import (opt_state_to_jax, params_from_jax,
                                    params_to_jax)
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as par
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import make_train_step

    spec, arch, over, wd = case["case"]
    n = dist.get_world_size()
    cfg = _case_cfg(arch, over)
    s = strategy.parse(spec)
    B = case["batches"][0]["labels"].shape[0]
    shape = ShapeConfig("test", S, B, "train")
    plan = s.to_plan(cfg, strategy.host_topology(), shape)
    rt = par.make_runtime(cfg, plan, shape, remat=False)
    params = par.apply_plan(params_from_jax(case["tree"]), plan, cfg)
    want = par.param_placements(cfg, plan, params)
    state = init_opt_state(params)
    step = make_train_step(cfg, rt, TrainConfig(
        steps=STEPS, warmup=1, grad_accum=s.grad_accum,
        opt=AdamWConfig(lr=LR, weight_decay=wd)), plan)
    metrics = []
    for b in case["batches"]:
        _, state, m = step(params, state, {k: torch.tensor(v)
                                           for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    local = {}
    for name, p in params.named_parameters():
        mesh = p.device_mesh
        local[name] = dict(
            numel=p.to_local().numel(), shape=tuple(p.shape),
            m_numel=state["m"][name].to_local().numel(),
            v_numel=state["v"][name].to_local().numel(),
            model=p.placements[mesh.mesh_dim_names.index("model")],
            want=want[name], dims=mesh.mesh_dim_names)
    shares = [None] * n
    dist.all_gather_object(shares, local)
    out = dict(metrics=metrics, params=params_to_jax(params, cfg),
               m=opt_state_to_jax(state, cfg)["m"], local=shares,
               dp_shards=plan.axis_size(plan.fsdp), tp=plan.tp_size,
               seq_parallel=rt.seq_parallel,
               gathered=[par.all_gather_buffers(m) for m in
                         (*params.layers, params)])
    if spec in LAYER_COLLECTIVES and arch == QWEN[0]:
        out["layer_collectives"] = _layer_collectives(cfg, params, rt)
    return out if rank == 0 else None


def _world(rank, n, payload, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}.store",
                            rank=rank, world_size=n)
    try:
        with open(payload, "rb") as f:
            cases = pickle.load(f)
        results = [_run_case(c, rank) for c in cases]
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX single-device oracle (test process)
# ---------------------------------------------------------------------------

def _inputs(case, n):
    """A case's initial weights (JAX's init, as numpy) and batches: 2
    rows a data-parallel rank a microbatch, most labels of some rows
    masked."""
    from repro_torch import strategy
    spec, arch, over, _ = case
    jc, tree = _jax_tree(arch, over)
    s = strategy.parse(spec)
    dp = n // s.tp
    B = 2 * dp * s.grad_accum
    return dict(tree=tree, batches=_batches(jc.vocab_size, B, 2,
                                            s.grad_accum, seed=n))


def _references(case, n):
    """(JAX trajectory, the port's single-device trajectory) at the
    case's precision."""
    from repro_torch import strategy
    spec, arch, over, wd = case
    s = strategy.parse(spec)
    fcase = (spec, None, arch, over, wd)     # test_torch_fsdp's case form
    inp = _inputs(case, n)
    return (_jax_trajectory(fcase, s, **inp),
            _port_trajectory(fcase, s, **inp))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: [(case, port result, (JAX, port single-device reference))]}.
    Every world is spawned at once, each running all its cases, while
    this process computes the references."""
    started, refs = {}, {}
    try:
        for n, cases in WORLDS.items():
            d = tmp_path_factory.mktemp(f"tpworld{n}")
            payload = [dict(case=c, **_inputs(c, n)) for c in cases]
            with open(d / "payload.pkl", "wb") as f:
                pickle.dump(payload, f)
            started[n] = (d / "out.pkl", start_ranks(
                _world, (n, str(d / "payload.pkl"), str(d / "out.pkl")), n))
        for n, cases in WORLDS.items():
            refs[n] = [_references(c, n) for c in cases]
        out = {}
        deadline = time.time() + SPAWN_TIMEOUT
        for n, (path, ctx) in started.items():
            _join(n, ctx, deadline)
            with open(path, "rb") as f:
                got = pickle.load(f)
            out[n] = list(zip(WORLDS[n], got, refs[n], strict=True))
        return out
    finally:
        for _, ctx in started.values():
            _stop(ctx)


def _floored(bars, floor):
    """Each bar, or FLOOR times the single-device implementations' own
    difference on the case, whichever is larger."""
    return {k: max(v, FLOOR * float(floor[k])) for k, v in bars.items()}


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_tensor_parallel_steps_match_the_jax_trajectory(worlds, n):
    """Against JAX and against the port's own single-device step: f32 at
    the f32 bars, bf16 at the bars measured for it, each bar floored at
    FLOOR times what the port's single-device step and JAX's differ by on
    the case (the floor decides for rwkv6 in f32 and for bf16 against the
    port; see FLOOR)."""
    for case, got, (jax_ref, port_ref) in worlds[n]:
        what = (n, case[0], case[1])
        floor = _errors(port_ref, jax_ref)
        precision = case[0].rsplit("_", 1)[-1]
        for ref, side in ((jax_ref, "jax"), (port_ref, "port")):
            bars = (F32_BARS if precision not in ("bf16", "fp8")
                    else LOW_BARS[precision, side])
            _compare(got, ref, _floored(bars, floor), what + (side,))
        assert np.isfinite(got["metrics"][-1]["loss"])


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_ranks_hold_their_share_of_parameters_and_moments(worlds, n):
    """Every parameter is a ``DTensor`` on the (data, model) root mesh
    (ZeRO-0: (dp, zero, model)) whose model-axis placement is
    ``param_placements``'; a rank holds about 1/k of its model shard over
    a data shard group of k, the moments as the parameter; over the ranks
    the shards add up to the leaf once per replica."""
    for case, got, _ in worlds[n]:
        k, tp = got["dp_shards"], got["tp"]
        for name in got["local"][0]:
            per_rank = [r[name] for r in got["local"]]
            first = per_rank[0]
            assert first["dims"][-1] == "model" and len(first["dims"]) >= 2
            total = int(np.prod(first["shape"]))
            split = tp if first["want"].is_shard() else 1
            share = -(-total // split // k)
            for r in per_rank:
                assert r["model"] == r["want"], (case, name, r)
                assert r["m_numel"] == r["v_numel"] == r["numel"], (case,
                                                                    name)
                assert r["numel"] <= share, (case, name, r["numel"], share)
            assert sum(r["numel"] for r in per_rank) == \
                total * n // (split * max(k, 1)), (case, name)


def test_tensor_parallel_plans_shard_the_model_axis(worlds):
    """The plans run as specified: every case on the 2-rank world is
    model-parallel 2, SP follows ``nosp`` and the mixer kind (recurrent
    residuals stay whole along S)."""
    got = {(c[0], c[1]): r for c, r, _ in worlds[2]}
    assert all(r["tp"] == 2 for r in got.values())
    assert got["fsdp_tp2", QWEN[0]]["seq_parallel"]
    assert not got["fsdp_tp2_nosp", QWEN[0]]["seq_parallel"]
    assert not got["fsdp_tp2", RWKV[0]]["seq_parallel"]
    assert got["fsdp_tp2", LLAMA[0]]["seq_parallel"]


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_fp8_wire_gathers_a_quarter_of_the_f32_bytes(worlds, n):
    """On the (data, model) mesh each layer's FSDP2 all-gather of its
    model shard moves one byte an element under ``fsdp_tp2_fp8``, a
    quarter of ``fsdp_tp2``'s f32 bytes; the root unit gathers f32."""
    by_spec = {c[0]: got for c, got, _ in worlds[n] if c[1] == QWEN[0]}
    f32, root32 = _wire_bytes(by_spec["fsdp_tp2"]["gathered"], "fsdp_tp2")
    fp8, root8 = _wire_bytes(by_spec["fsdp_tp2_fp8"]["gathered"],
                             "fsdp_tp2_fp8")
    assert [4 * b for b in fp8] == f32 and root8 == root32


@pytest.mark.parametrize("spec", sorted(LAYER_COLLECTIVES))
def test_layer_collectives_are_megatrons(worlds, spec):
    """One attention layer calls the Megatron collectives over the model
    group, forward and backward; with SP 2 all-gathers and 2
    reduce-scatters each way, without it 2 all-reduces each way."""
    got = {c[0]: r for c, r, _ in worlds[2] if c[1] == QWEN[0]}
    fwd, bwd = got[spec]["layer_collectives"]
    assert (fwd, bwd) == LAYER_COLLECTIVES[spec]


# ---------------------------------------------------------------------------
# specs against the JAX package's, at full size, with no process group
# ---------------------------------------------------------------------------

ARCHS = ["qwen3-0.6b", "llama2-1b", "rwkv6-1.6b", "qwen2-1.5b",
         "h2o-danube-1.8b", "granite-20b", "deepseek-moe-16b", "dbrx-132b"]


def _norm_entry(e):
    """A spec entry with one-axis tuples unwrapped and empty ones None."""
    if isinstance(e, tuple):
        e = tuple(a for a in e if a)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _plans(arch, tp):
    """(port plan, JAX plan) of ``fsdp_tp<tp>`` on 8 devices, abstract."""
    from repro.core import parallel as jpar
    from repro_torch import strategy
    from repro_torch.configs import ShapeConfig, get_config
    cfg = get_config(arch)
    spec = f"fsdp_tp{tp}" if tp > 1 else "fsdp"
    plan = strategy.parse(spec).to_plan(
        cfg, strategy.host_topology(n_devices=8),
        ShapeConfig("x", 512, 8, "train"), abstract=True)
    jplan = jpar.ParallelPlan(
        mesh=SimpleNamespace(shape=dict(plan.mesh)), dp=plan.dp,
        fsdp=plan.fsdp, tp=plan.tp, attn=plan.attn, kv_tp=plan.kv_tp,
        seq_parallel_residuals=plan.seq_parallel_residuals)
    return cfg, plan, jplan


def _jax_leaves(arch):
    """{port parameter name: (JAX tree path, JAX leaf shape, stacked)} of
    the full-size JAX parameter tree (shapes only)."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jtfm
    jcfg = jax_get_config(arch)
    tree = jax.eval_shape(lambda: jtfm.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    _, start, period, _ = jtfm.layer_plan(jcfg)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if names[0] == "blocks":
            pos, rest = names[1], names[2:]
            for b in range(leaf.shape[0]):
                layer = start + b * period + pos
                out[".".join(map(str, ["layers", layer, *rest]))] = (
                    path, leaf.shape, True)
        elif names[0] == "prefix":
            out[".".join(map(str, ["layers", *names[1:]]))] = (
                path, leaf.shape, False)
        else:
            out[".".join(names)] = (path, leaf.shape, False)
    return jcfg, out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_match_jax_param_specs(arch):
    """``param_placements`` (and the copied ``_param_spec`` it reads) equal
    JAX's fitted ``_param_spec`` for every leaf of the full-size model,
    at tp 1, 2, 4 and 8: the model axis on the same dim or on none."""
    from torch.distributed.tensor import Replicate, Shard

    from repro.core import parallel as jpar
    from repro_torch.core import parallel as par
    from repro_torch.models import transformer as tfm
    jcfg, leaves = _jax_leaves(arch)
    # the port's names are the JAX tree's, unstacked (checked at 2 layers)
    small = tfm.init_params(_case_cfg(arch, {}), 0, "cpu")
    assert {n for n, _ in small.named_parameters()} == \
        {n for n in leaves if not n.startswith("layers.")
         or int(n.split(".")[1]) < 2}
    # qwen2-1.5b's 12 heads do not split 8 ways: tp 8 resolves to context
    # attention, whose weights stay whole on the model axis (the MoE
    # expert stacks aside)
    for tp in (1, 2, 4, 8):
        cfg, plan, jplan = _plans(arch, tp)
        metas = [(n, torch.empty(shape[1:] if stacked else shape,
                                 device="meta"))
                 for n, (_, shape, stacked) in leaves.items()]
        got = par.param_placements(cfg, plan, metas)
        for name, (path, shape, stacked) in leaves.items():
            jspec = jpar._fit_spec(
                jpar._param_spec(jcfg, jplan, path, len(shape)), shape,
                jplan.mesh)
            jspec = tuple(_norm_entry(e) for e in jspec)[int(stacked):]
            mine = par.fitted(plan, par._param_spec(
                cfg, plan, tuple(name.split(".")), len(jspec)),
                shape[int(stacked):])
            assert tuple(_norm_entry(e) for e in mine) == jspec, \
                (arch, tp, name)
            dims = [d for d, e in enumerate(jspec)
                    if "model" in (e if isinstance(e, tuple) else (e,))]
            want = Shard(dims[0]) if dims else Replicate()
            assert got[name] == want, (arch, tp, name, got[name])


@pytest.mark.parametrize("spec", ["fsdp_tp2", "fsdp_tp4_nosp", "hsdp_tp2",
                                  "fsdp_tp8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_specs_match_jax(arch, spec):
    """``activation_specs`` equal the JAX package's for the names the
    port uses; ``make_runtime`` reads sequence parallelism off
    ``act_btd``, and gives a plan whose heads do not split over the
    model axis (context attention) that axis as its sequence axis."""
    from repro.configs import get_config as jax_get_config
    from repro.core import parallel as jpar
    from repro_torch import strategy
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import parallel as par
    cfg = get_config(arch)
    shape = ShapeConfig("x", 512, 8, "train")
    context = bool(cfg.n_heads % strategy.parse(spec).tp)
    plan = strategy.parse(spec).to_plan(
        cfg, strategy.host_topology(n_devices=8), shape, abstract=True)
    jplan = jpar.ParallelPlan(
        mesh=SimpleNamespace(shape=dict(plan.mesh)), dp=plan.dp,
        fsdp=plan.fsdp, tp=plan.tp, attn=plan.attn, kv_tp=plan.kv_tp,
        seq_parallel_residuals=plan.seq_parallel_residuals)
    want = jpar.activation_specs(jax_get_config(arch), jplan)
    for name, mine in par.activation_specs(cfg, plan).items():
        assert tuple(_norm_entry(e) for e in mine) == \
            tuple(_norm_entry(e) for e in want[name]), (arch, spec, name)
    rt = par.make_runtime(cfg, plan, shape)
    assert plan.attn == ("context" if context else "head_tp")
    if context:
        assert rt.context and rt.tp_size == plan.tp_size
        assert not rt.seq_parallel
        return
    assert rt.tp_size == plan.tp_size
    assert rt.seq_parallel == (arch != "rwkv6-1.6b" and "nosp" not in spec)
