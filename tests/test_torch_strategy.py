"""The port's strategy layer against the JAX package's, on the CPU.

``repro_torch.strategy`` and ``repro_torch.core.costmodel`` are copies:
spec strings parse and format to the same ``Strategy`` fields, the cost
model prices every strategy with the same floats, and the planner ranks
the data-, tensor- and pipeline-parallel strategies in the same order.
The one rule the port adds — cp and ep above 1, and a tp that resolves to
context attention, raise a ``StrategyError`` naming the slice that brings
them — is held here too, with the train CLI's ``--strategy`` surface.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import strategy as jstrategy
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_config as jax_get_config
from repro.core import parallel as jpar
from repro_torch import strategy
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import parallel as par
from test_torch_fsdp import _few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

SPECS = ["ddp", "fsdp", "hsdp", "fsdp_z2", "fsdp_ovl", "fsdp_ga2",
         "hsdp_bf16", "fsdp_fp8", "hsdp_tp4", "fsdp_cp2",
         "fsdp_pp2_mb4_1f1b", "ddp_z0", "hsdp_z3_ovl_ga4_fp8_nosp",
         "fsdp_pp4_mb8_1f1b_i2", "fsdp_ep2_headtp"]
MALFORMED = ["", "xdp", "fsdp_tp0", "fsdp_z1", "fsdp_bf16_fp8",
             "fsdp_tp2_tp2", "fsdp_ovl_ovl", "ddp_ovl", "fsdp_1f1b",
             "fsdp_pp2", "fsdp_foo", "fsdp_pp2_mb4_1f1b_i1",
             "fsdp_pp2_mb3_1f1b_i2", "fsdp_ga0"]
ARCHS = ["qwen3-0.6b", "llama2-1b", "rwkv6-1.6b", "qwen2-1.5b",
         "h2o-danube-1.8b", "granite-20b", "musicgen-medium", "qwen2-vl-2b"]
# (name, port topology, JAX topology)
TOPOLOGIES = {
    "host1": (strategy.host_topology(n_devices=1),
              jstrategy.host_topology(n_devices=1)),
    "host8": (strategy.host_topology(n_devices=8),
              jstrategy.host_topology(n_devices=8)),
    "pod": (strategy.pod_topology(), jstrategy.pod_topology()),
}
SHAPES = [("train", 512, 8), ("train", 4096, 256), ("prefill", 2048, 16),
          ("decode", 2048, 8)]


def _fields(s):
    return dataclasses.asdict(s)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_format_match_jax(spec):
    mine, ref = strategy.parse(spec), jstrategy.parse(spec)
    assert _fields(mine) == _fields(ref)
    assert mine.format() == ref.format() == strategy.format_spec(mine)
    assert strategy.parse(mine.format()) == mine
    assert mine.zero == ref.zero


@pytest.mark.parametrize("spec", MALFORMED)
def test_malformed_specs_raise_in_both(spec):
    with pytest.raises(jstrategy.StrategyError):
        jstrategy.parse(spec)
    with pytest.raises(strategy.StrategyError):
        strategy.parse(spec)


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_reports_equal_jax(arch, topo):
    """Every candidate the planner enumerates (tp, cp, pp and ep above 1
    included: pricing needs no lowering) gets the same report, float for
    float, in train, prefill and decode shapes."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mine_t, ref_t = TOPOLOGIES[topo]
    n = 0
    for mode, S, B in SHAPES:
        shape, jshape = ShapeConfig("x", S, B, mode), JShapeConfig("x", S,
                                                                    B, mode)
        cands = jstrategy.candidates(ref_t, B, dp_modes=("hsdp", "ddp"),
                                     zero_stages=(None, 2))
        for js in cands:
            s = strategy.parse(js.format())
            try:
                want = jstrategy.evaluate(jcfg, js, ref_t, jshape).row()
            except jstrategy.StrategyError:
                with pytest.raises(strategy.StrategyError):
                    strategy.evaluate(cfg, s, mine_t, shape)
                continue
            got = strategy.evaluate(cfg, s, mine_t, shape).row()
            assert got == want, (arch, topo, mode, js.format())
            n += 1
    assert n > 0


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_planner_ranks_dp_strategies_as_jax(arch, topo):
    """The port's ranking equals the JAX package's over every candidate,
    those of cp above 1 and of a tp that resolves to context attention
    included, and every strategy it ranks lowers (MoE configs:
    ``tests/test_torch_moe.py``); M-RoPE ranks no pipeline, whose
    microbatches its batch-dependent angles cannot broadcast over."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mine_t, ref_t = TOPOLOGIES[topo]
    ranked_tp = ranked_pp = False
    for mode, S, B in SHAPES[:2]:
        for kw in ({}, dict(dp_modes=("hsdp", "fsdp", "ddp"),
                            zero_stages=(None, 0, 2, 3),
                            precisions=("f32", "bf16", "fp8"))):
            ranked = strategy.search(cfg, mine_t, ShapeConfig("x", S, B, mode),
                                     **kw)
            ref = jstrategy.search(jcfg, ref_t, JShapeConfig("x", S, B, mode),
                                   **kw)
            assert [p.spec for p in ranked] == [p.spec for p in ref]
            assert [p.report.row() for p in ranked] == \
                [p.report.row() for p in ref]
            assert all(p.lowers for p in ranked)
            ranked_tp |= any(p.strategy.tp > 1 for p in ranked)
            ranked_pp |= any(p.strategy.pp > 1 for p in ranked)
    assert ranked_tp == (topo != "host1")
    assert ranked_pp == (topo != "host1" and cfg.rope != "mrope")


def test_precision_policies_equal_jax():
    assert sorted(par.PRECISION_POLICIES) == sorted(jpar.PRECISION_POLICIES)
    for name, pol in par.PRECISION_POLICIES.items():
        assert dataclasses.asdict(pol) == dataclasses.asdict(
            jpar.PRECISION_POLICIES[name])


def _dtype_name(dt):
    return str(dt).split(".")[-1]


@pytest.mark.parametrize("spec", ["fsdp", "fsdp_bf16", "fsdp_fp8", "ddp",
                                  "ddp_fp8", "hsdp_z2_bf16", "fsdp_z0_fp8"])
def test_make_runtime_takes_the_policy_dtypes(spec):
    """The port of ``test_precision_policy_reaches_runtime``: a Runtime's
    dtypes are its plan's policy's, and the fp8 wire rounding is on
    exactly where the JAX package turns its per-layer gatherer on (a comm
    dtype and a plan that shards parameters)."""
    cfg = reduced(get_config("qwen3-0.6b"))
    shape = ShapeConfig("prec", 16, 4, "train")
    s = strategy.parse(spec)
    plan = s.to_plan(cfg, strategy.host_topology(n_devices=1), shape,
                     abstract=True)
    rt = par.make_runtime(cfg, plan, shape)
    pol = jpar.PRECISION_POLICIES[s.precision]
    assert _dtype_name(rt.param_dtype) == pol.param_dtype
    assert _dtype_name(rt.compute_dtype) == pol.compute_dtype
    assert _dtype_name(rt.grad_dtype) == pol.grad_dtype
    gathers = bool(pol.comm_dtype) and s.zero > 0
    assert (rt.gather_dtype is not None) == gathers, spec
    if gathers:
        assert rt.gather_dtype == torch.float8_e4m3fn
    assert plan.zero == s.zero
    assert plan.fsdp == (() if s.zero == 0 else ("data",))


def test_plans_lower_with_the_jax_axis_rules():
    """``to_plan``'s dp/fsdp axes and the mesh it describes, abstractly:
    hsdp across islands replicates over 'pod' and shards over 'data'."""
    cfg = reduced(get_config("qwen3-0.6b"))
    shape = ShapeConfig("t", 16, 8, "train")
    topo = strategy.Topology("t", 8, island=4)
    want = {"fsdp": ({"data": 8, "model": 1}, ("data",), ("data",)),
            "hsdp": ({"pod": 2, "data": 4, "model": 1}, ("pod", "data"),
                     ("data",)),
            "hsdp_z0": ({"pod": 2, "data": 4, "model": 1}, ("pod", "data"),
                        ()),
            "ddp": ({"data": 8, "model": 1}, ("data",), ())}
    for spec, (mesh, dp, fsdp) in want.items():
        plan = strategy.parse(spec).to_plan(cfg, topo, shape, abstract=True)
        assert (plan.mesh, plan.dp, plan.fsdp) == (mesh, dp, fsdp), spec
        assert plan.axis_size(plan.dp) == 8


# the meshes the strategies the port runs lower to, on 8 devices, and the
# attention each resolves to
LOWERED_MESHES = {
    "hsdp_tp4": ({"data": 2, "model": 4}, "head_tp"),
    "fsdp_cp2": ({"data": 4, "model": 2}, "context"),
    "fsdp_pp2_mb4_1f1b": ({"pipe": 2, "data": 4, "model": 1}, "head_tp"),
    "fsdp_ep2": ({"data": 4, "expert": 2, "model": 1}, "head_tp"),
    "hsdp_tp2_ep4": ({"data": 1, "expert": 4, "model": 2}, "head_tp"),
    "fsdp_pp2_mb4": ({"pipe": 2, "data": 4, "model": 1}, "head_tp"),
    "fsdp_tp8_ctx": ({"data": 1, "model": 8}, "context")}


@pytest.mark.parametrize("spec,arch,degree", [
    ("hsdp_tp4", "qwen3-0.6b", None), ("fsdp_cp2", "qwen3-0.6b", "cp"),
    ("fsdp_pp2_mb4_1f1b", "qwen3-0.6b", None),
    ("fsdp_ep2", "deepseek-moe-16b", None),
    ("hsdp_tp2_ep4", "deepseek-moe-16b", "moe"),
    ("fsdp_pp2_mb4", "dbrx-132b", "moe"),
    ("fsdp_tp8_ctx", "qwen3-0.6b", "cp")])
def test_model_parallel_degrees_name_their_slice(spec, arch, degree):
    """Every model-parallel degree lowers: head-TP, context parallelism
    (``cp<k>``, and a tp forced to context attention), pipeline stages,
    expert parallelism and tp or pp on a MoE config (``degree``: the
    degree a slice of the port once refused), on the model, pipe and
    expert axes."""
    cfg = get_config(arch)
    shape = ShapeConfig("t", 512, 64, "train")
    topo = strategy.host_topology(n_devices=8)
    s = strategy.parse(spec)
    s.check(topo, cfg)
    assert s.lowerable(topo, cfg)
    plan = s.to_plan(cfg, topo, shape, abstract=True)
    assert (plan.mesh, plan.attn) == LOWERED_MESHES[spec], degree
    assert strategy.resolve(spec, cfg, topo, shape)[0] == s


def test_meshes_on_a_one_rank_group(tmp_path):
    """``launch.mesh`` on a 1-rank gloo group: the host topology counts its
    ranks, ``make_host_mesh`` keeps the JAX helper's axes, a plan's mesh is
    the ``DeviceMesh`` its abstract form describes, and a mesh over more
    devices than ranks is refused."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.strategy.topology import mesh_shape

    assert strategy.host_topology().n_devices == 1      # no group: 1
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        launch_mesh.init_distributed(torch.device("cpu"))   # already up
        assert strategy.host_topology().n_devices == 1
        assert mesh_shape(launch_mesh.make_host_mesh()) == {"data": 1,
                                                            "model": 1}
        assert mesh_shape(launch_mesh.make_host_mesh(pod=1)) == {
            "pod": 1, "data": 1, "model": 1}
        cfg = reduced(get_config("qwen3-0.6b"))
        shape = ShapeConfig("t", 16, 2, "train")
        s = strategy.parse("hsdp_z2")
        plan = s.to_plan(cfg, strategy.host_topology(), shape)
        assert mesh_shape(plan.mesh) == s.to_plan(
            cfg, strategy.host_topology(), shape, abstract=True).mesh
        assert plan.mesh.device_type == "cpu" and plan.zero == 2
        with pytest.raises(ValueError, match="process group of 8 ranks"):
            strategy.build_mesh(strategy.host_topology(n_devices=8))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the train CLI's strategy surface
# ---------------------------------------------------------------------------

def _run(args, timeout=300):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


TRAIN = ["-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--steps", "2", "--log_every", "1", "--seq_len", "32",
         "--global_batch", "4"]


def _losses(stdout):
    return [float(ln.split()[3]) for ln in stdout.splitlines()
            if ln.startswith("step ")]


def test_cli_fsdp_on_two_gloo_ranks_matches_one_rank():
    """``torchrun --standalone --nproc_per_node 2`` trains the same losses
    as one rank; rank 0 alone prints."""
    two = _run(["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", *TRAIN, "--strategy", "fsdp"])
    assert two.returncode == 0, two.stderr[-3000:]
    one = _run([*TRAIN, "--strategy", "fsdp"])
    assert one.returncode == 0, one.stderr[-3000:]
    assert two.stdout.count("[strategy] fsdp on host") == 1
    assert "{'data': 2, 'model': 1}" in two.stdout
    assert "ranks=2" in two.stdout
    got, want = _losses(two.stdout), _losses(one.stdout)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (got, want)


def test_cli_auto_prints_the_planner_choice():
    r = _run([*TRAIN, "--strategy", "auto"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[planner] chose fsdp_bf16 on host (1x H100)" in r.stdout
    assert len(_losses(r.stdout)) == 2


def test_cli_fsdp_tp2_on_two_gloo_ranks_matches_one_rank():
    """The tensor-parallel counterpart: ``--strategy fsdp_tp2`` on two
    gloo ranks (one model group of 2, the heads, FFN hidden units and
    vocabulary split over it) trains the losses of one unsharded rank."""
    two = _run(["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", *TRAIN, "--strategy", "fsdp_tp2"])
    assert two.returncode == 0, two.stderr[-3000:]
    one = _run([*TRAIN, "--strategy", "fsdp"])
    assert one.returncode == 0, one.stderr[-3000:]
    assert two.stdout.count("[strategy] fsdp_tp2 on host") == 1
    assert "{'data': 1, 'model': 2}" in two.stdout
    got, want = _losses(two.stdout), _losses(one.stdout)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (got, want)


def test_cli_refuses_tensor_parallelism_by_name():
    """Context parallelism trains: ``--strategy fsdp_cp2`` on two gloo
    ranks (each its half of the sequence, K and V gathered) trains the
    losses of one unsharded rank; on one rank it is refused, as its model
    axis needs two."""
    one_rank = _run([*TRAIN, "--strategy", "fsdp_cp2"])
    assert one_rank.returncode != 0 and "StrategyError" in one_rank.stderr
    two = _run(["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", *TRAIN, "--strategy", "fsdp_cp2"])
    assert two.returncode == 0, two.stderr[-3000:]
    one = _run([*TRAIN, "--strategy", "fsdp"])
    assert one.returncode == 0, one.stderr[-3000:]
    assert "{'data': 1, 'model': 2}" in two.stdout
    got, want = _losses(two.stdout), _losses(one.stdout)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (got, want)
