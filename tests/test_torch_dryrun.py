"""The port's dry run (``launch/dryrun.py``: one train step, prefill or
decode step traced on a fake process group under ``FakeTensorMode``)
against the JAX package's, on the CPU (``--device cpu``: the dry run
refuses to run without a card otherwise): the CLI's records on the pod,
the full-depth granite point and the pipelined points.  The serving
points of the other archs are in ``tests/test_torch_dryrun_serving.py``;
the memory tracker, the census and the kernels' fake branches in
``tests/test_torch_dryrun_memory.py``; the MoE and non-token points and
the skips in ``tests/test_torch_dryrun_points.py`` (four files, so that
``--dist loadfile`` spreads them over workers).

Its analytic fields and its ``resilience`` and ``pipeline`` blocks equal
what the JAX package's functions give for the same point; its tracked
memory peak equals, within 2 %, the same tracker's peak over the same
step run for real on a 1-rank gloo group; its collective census counts
what the plan issues (an all-gather per FSDP2 unit for each forward and
each backward, a reduce-scatter per unit and backward, the
tensor-parallel collectives of ``models.layers.COLLECTIVES``, a send per
pipelined microbatch), and the fp8 wire moves a quarter of f32's bytes.
The serving points' caches take, per device, exactly the bytes of the
shards JAX's ``cache_shardings`` gives them.  Points the port cannot run
yet are recorded as skipped, naming the slice that lifts them (or, for
``long_500k`` on full attention, the JAX package's reason), and a kernel
wrapper takes its shape-only branch on fake tensors alone.  ``lower_one``
runs in this process (each call brings its fake group up and tears it
down; only rank 0 is traced, so no two worlds of one layout differ in
their groups); ``run_one`` traces each rank in a fresh process.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import strategy
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun
from test_torch_fsdp import _few_threads  # noqa: F401
from test_torch_fsdp import cli_env

ROOT = Path(__file__).resolve().parents[1]
QWEN = "qwen3-0.6b"
# a reduced qwen3 on 8 fake ranks: 16 rows of 32 tokens, 2 layers
SMALL = ShapeConfig("t", 32, 16, "train")
# run_one points a module traces at once (:func:`trace_points`): each is
# one Python thread of tracing, and ``--dist loadfile`` hands out these
# files, which hold few tests, last, when most workers are done
POINT_WORKERS = 4


def trace_points(points, out):
    """{key: ``run_one``'s record} of ``points`` ({key: (arch, shape,
    run_one's keyword arguments)}) on the CPU, POINT_WORKERS at once (each
    traced rank a process of its own), each record written under
    ``out / key``."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(POINT_WORKERS) as ex:
        futs = {k: ex.submit(dryrun.run_one, arch, shape, False,
                             str(out / str(k)), device="cpu", **kw)
                for k, (arch, shape, kw) in points.items()}
        return {k: f.result() for k, f in futs.items()}


def _cli(args, out, timeout=600):
    env = cli_env()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args, "--out", str(out), "--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return {json.loads(p.read_text())["shape"]: json.loads(p.read_text())
            for p in Path(out).glob("*.json")}


@pytest.fixture(scope="module")
def pod_records(tmp_path_factory):
    """``--arch qwen3-0.6b --shape all`` on the pod topology (256 fake
    ranks, full width and depth, the legacy pod layout, the kernel
    path), through the CLI."""
    return _cli(["--arch", QWEN, "--shape", "all"],
                tmp_path_factory.mktemp("dry"))


def test_cli_traces_qwen3_train_4k_on_a_pod(pod_records):
    """train_4k traces on 256 fake ranks with a per-device memory peak, a
    census and the resilience block; the XLA-only fields are absent."""
    rec = pod_records["train_4k"]
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["strategy"] == "hsdp_tp16" and rec["kernels"] == "cuda"
    assert rec["plan"]["mesh"] == {"data": 16, "model": 16}
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] > 0
    assert sum(v for k, v in mem.items()
               if k != "peak_bytes_per_device") == \
        mem["peak_bytes_per_device"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= \
        set(rec["collectives"])
    assert rec["collective_bytes_total"] == sum(
        v["bytes"] for v in rec["collectives"].values())
    assert set(rec["resilience"]) == {
        "mtbf_device_s", "mtbf_system_s", "ckpt_bytes", "distinct_writers",
        "t_ckpt_s", "young_daly_interval_s", "goodput"}
    for key in ("flops_hlo_per_device_raw", "bytes_accessed_per_device_raw",
                "compile_s", "lower_s"):
        assert key not in rec
    assert rec["trace_s"] >= 0


def _jax_cache_bytes(arch, shape_name, plan):
    """Bytes per device of the shards JAX's ``cache_shardings`` gives the
    dense caches of ``shape_name`` under the port's ``plan`` (its fields,
    on an abstract mesh of the same axes): ``eval_shape`` and each
    sharding's ``shard_shape``."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jax_get_config
    from repro.core import parallel as jpar
    from repro.models import transformer as jtfm
    from repro.models.layers import Runtime as JRuntime
    jcfg, shape = jax_get_config(arch), JSHAPES[shape_name]
    sizes = plan["mesh"]
    jplan = jpar.ParallelPlan(
        mesh=AbstractMesh(tuple(sizes.values()), tuple(sizes)),
        dp=tuple(plan["dp"]), fsdp=tuple(plan["fsdp"]), tp="model",
        attn=plan["attn"], kv_tp=plan["kv_tp"], shape_mode=shape.mode,
        decode_cache_axes=tuple(plan["decode_cache_axes"]))
    shapes = jax.eval_shape(lambda: jtfm.init_cache(
        jcfg, shape.global_batch, shape.seq_len, np.float32, JRuntime()))
    shard = jpar.cache_shardings(jcfg, jplan, shapes)
    return sum(int(np.prod(sh.shard_shape(leaf.shape))) * leaf.dtype.itemsize
               for leaf, sh in zip(jax.tree.leaves(shapes),
                                   jax.tree.leaves(shard)))


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k",
                                   "long_500k"])
def test_cli_records_serving_shapes_as_skipped(pod_records, shape):
    """The serving points on the pod: prefill_32k and decode_32k trace,
    their caches per device the exact bytes of JAX's shards on the same
    plan (a ``cache`` category of the memory, which the tracker counts as
    the allocator rounds); long_500k is skipped for full attention, for
    the JAX package's reason."""
    rec = pod_records[shape]
    if shape == "long_500k":
        assert rec["status"] == "skipped"
        assert rec["reason"] == dryrun.SUBQUADRATIC
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["strategy"] == "hsdp_tp16"
    assert rec["cache_bytes_per_device"] == _jax_cache_bytes(
        QWEN, shape, rec["plan"])
    mem = rec["memory"]
    assert mem["cache_bytes"] >= rec["cache_bytes_per_device"]
    assert mem["cache_bytes"] <= rec["cache_bytes_per_device"] + \
        512 * 4 * 2 * get_config(QWEN).n_layers
    assert sum(v for k, v in mem.items()
               if k != "peak_bytes_per_device") == \
        mem["peak_bytes_per_device"]
    assert not mem["gradients_bytes"] and not mem["optimizer_bytes"]
    want = {"prefill_32k": (["model"], {"all-gather", "reduce-scatter"}),
            "decode_32k": (["model"], {"all-gather", "all-reduce"})}[shape]
    assert rec["plan"]["decode_cache_axes"] == want[0]
    assert want[1] <= set(rec["collectives"])

PP_SPECS = ["fsdp_pp2_mb4", "fsdp_pp2_mb4_zb"]


@pytest.fixture(scope="module")
def points(tmp_path_factory):
    """The granite point and the pipelined points, traced at once."""
    return trace_points(
        {"granite": ("granite-20b", "train_4k", {}),
         **{spec: (QWEN, "train_4k", dict(strategy=spec, use_reduced=True,
                                           kernels="torch"))
            for spec in PP_SPECS}}, tmp_path_factory.mktemp("points"))


def test_granite_20b_trains_at_full_depth_on_a_pod(points):
    """granite-20b x train_4k at full size (52 layers, 20.3 B parameters,
    more than one card holds in f32) traces on 256 fake ranks, with the
    kernel path's head dim 128 and the census of its plan."""
    rec = points["granite"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 256 and rec["kernels"] == "cuda"
    assert get_config("granite-20b").n_layers == 52
    assert rec["memory"]["peak_bytes_per_device"] > 0
    assert {"all-gather", "reduce-scatter"} <= set(rec["collectives"])
    assert rec["resilience"]["ckpt_bytes"] > 4 * 20e9    # f32 weights alone


def test_cli_without_a_card_exits_naming_the_device_flag(tmp_path):
    """No card and no ``--device cpu``: the dry run exits non-zero and
    names the flag, with no record written (nothing falls back to the
    host)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = cli_env()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", QWEN, "--shape", "train_4k", "--reduced",
                        "--kernels", "torch", "--out", str(tmp_path)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
    assert not list(tmp_path.glob("*.json"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.lower_one(reduced(get_config(QWEN)), SMALL,
                         strategy.parse("fsdp"),
                         strategy.host_topology(n_devices=1),
                         kernels="torch")


def test_attention_chunks_reach_the_plain_blocked_attention():
    """``--attn_q_chunk`` / ``--attn_kv_chunk`` are the runtime's chunks
    of the plain blocked attention (``--kernels torch`` at S > 2048): at
    512 x 512 the traced step's temporaries (the score blocks its
    backward reruns) are fewer than at the default 1024 x 1024, and the
    rest of the record is the same."""
    cfg = reduced(get_config(QWEN), n_layers=1)
    shape = ShapeConfig("t", 4096, 1, "train")
    args = (cfg, shape, strategy.parse("fsdp"),
            strategy.host_topology(n_devices=1))
    base = dryrun.lower_one(*args, kernels="torch", device="cpu")
    small = dryrun.lower_one(*args, kernels="torch", device="cpu",
                             rt_overrides={"attn_q_chunk": 512,
                                           "attn_kv_chunk": 512})
    assert base["remat"] and small["remat"]
    assert small["memory"]["temporaries_bytes"] < \
        base["memory"]["temporaries_bytes"]
    for k in ("parameters_bytes", "optimizer_bytes", "activations_bytes"):
        assert small["memory"][k] == base["memory"][k], k


def test_fresh_traces_keep_their_isolation():
    """``lower_fresh`` traces each rank in a process of its own, forked
    from a server that holds no state of an earlier trace: after pipe
    rank 0 of a pp point is traced here (this process's DTensor caches
    now hold its layout), each pipe rank traced afresh gives the plan,
    memory and collectives it gave before, and rank 0 those of the trace
    made here."""
    s = strategy.parse("fsdp_pp2_mb4")
    topo = strategy.host_topology(n_devices=8)
    args = (reduced(get_config(QWEN)), SMALL, s, topo, "torch")
    last = dryrun.traced_ranks(s, topo)["pipe1"]

    def trace(lower, rank):
        rec = lower(*args, rank=rank, device="cpu")
        return {k: rec[k] for k in ("plan", "memory", "collectives")}

    alone = trace(dryrun.lower_fresh, last)
    here = trace(dryrun.lower_one, 0)
    assert trace(dryrun.lower_fresh, 0) == here
    assert trace(dryrun.lower_fresh, last) == alone
    assert alone["memory"] != here["memory"]


def test_cli_knobs_reach_the_runtime(monkeypatch, tmp_path):
    """``--remat_inner``, ``--attn_q_chunk`` and ``--attn_kv_chunk`` go to
    the traced rank as ``Runtime`` overrides (``lower_one`` hands them to
    ``make_runtime``, where they win), and the train point's record says
    it traced with remat, as JAX lowers it."""
    seen = []
    lower_fresh = dryrun.lower_fresh

    def spy(*a, **kw):
        seen.append(a[7])
        return lower_fresh(*a, **kw)

    monkeypatch.setattr(dryrun, "lower_fresh", spy)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", QWEN, "--shape", "train_4k", "--reduced",
                     "--kernels", "torch", "--remat_inner", "--attn_q_chunk",
                     "512", "--attn_kv_chunk", "256", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    assert seen == [{"remat_inner": True, "attn_q_chunk": 512,
                     "attn_kv_chunk": 256}]
    cfg = reduced(get_config(QWEN))
    shape = ShapeConfig("t", 4096, 1, "train")
    plan = strategy.parse("fsdp").to_plan(
        cfg, strategy.host_topology(n_devices=1), shape, abstract=True)
    rt = dryrun.par.make_runtime(cfg, plan, shape, **seen[0])
    assert (rt.remat, rt.remat_inner, rt.attn_q_chunk, rt.attn_kv_chunk) \
        == (True, True, 512, 256)
    rec, = [json.loads(f.read_text()) for f in tmp_path.glob("*.json")]
    assert rec["status"] == "ok" and rec["remat"] is True


@pytest.mark.parametrize("flag", ["--attn_q_chunk", "--attn_kv_chunk"])
def test_cli_refuses_attention_chunks_under_the_kernels(flag, tmp_path,
                                                        capsys):
    """Under ``--kernels cuda`` the flash kernels never read the chunks:
    the dry run refuses the flags before it traces, and writes nothing."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", QWEN, "--shape", "train_4k", "--reduced",
                     flag, "512", "--device", "cpu", "--out",
                     str(tmp_path)])
    assert e.value.code == 2
    assert "--kernels torch" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.json"))


def _jax_point(arch, spec, topo_name, shape_name, use_reduced=False):
    from repro import strategy as jstrategy
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    jcfg = jax_get_config(arch)
    if use_reduced:
        jcfg = jax_reduced(jcfg)
    topo = jstrategy.get_topology(topo_name)
    s = jstrategy.parse(spec)
    return jcfg, JSHAPES[shape_name], s, topo


def _jax_resilience(jcfg, s, topo):
    from repro.core import costmodel as jcm
    cost = s.to_cost_strategy(jcfg, topo)
    hw = topo.hw
    t_ck = jcm.checkpoint_write_time(jcfg, hw, cost)
    mtbf = jcm.system_mtbf(hw, cost.n_devices)
    return {"mtbf_device_s": hw.mtbf, "mtbf_system_s": round(mtbf, 1),
            "ckpt_bytes": jcm.checkpoint_bytes(jcfg),
            "distinct_writers": jcm.distinct_writers(cost),
            "t_ckpt_s": round(t_ck, 4),
            "young_daly_interval_s": round(
                jcm.young_daly_interval(t_ck, mtbf), 1),
            "goodput": round(jcm.goodput(
                t_ck, mtbf, t_restart=jcm.restart_time(jcfg, hw, cost)),
                5)}


def _analytic_equal(rec, jcfg, shape):
    """The record's analytic fields are JAX's: a train point is traced
    with remat, as the JAX dry run lowers it (``make_runtime``'s rule),
    and its compiled FLOPs are JAX's ``remat=True``."""
    from repro.perf import flops as jflops
    train = shape.mode == "train"
    assert rec["remat"] is train
    assert rec["flops_compiled_analytic"] == jflops.compiled_flops(
        jcfg, shape, remat=train)
    assert rec["flops_forward_analytic"] == jflops.forward_flops(jcfg,
                                                                 shape)
    assert rec["flops_model_6nd"] == jflops.model_flops(jcfg, shape)
    assert rec["params_total"] == jcfg.param_count()
    assert rec["params_active"] == jcfg.active_param_count()


def test_record_matches_the_jax_functions(pod_records):
    """The analytic FLOP fields, parameter counts and resilience block of
    the pod record are JAX's for the same point (a train point runs with
    remat, so the compiled FLOPs are JAX's ``remat=True``)."""
    rec = pod_records["train_4k"]
    jcfg, shape, s, topo = _jax_point(QWEN, "hsdp_tp16", "pod", "train_4k")
    _analytic_equal(rec, jcfg, shape)
    assert rec["resilience"] == _jax_resilience(jcfg, s, topo)


@pytest.mark.parametrize("spec", PP_SPECS)
def test_pipeline_records_match_the_jax_functions(spec, points):
    """A pipelined point traces pipe rank 0 and the last pipe rank (whose
    programs differ): the record keeps both peaks and the larger, and its
    pipeline block, analytic fields and resilience block are JAX's."""
    from repro.core import pipeline as jpipe
    rec = points[spec]
    assert rec["status"] == "ok", rec.get("traceback")
    jcfg, shape, s, topo = _jax_point(QWEN, spec, "pod", "train_4k",
                                      use_reduced=True)
    _analytic_equal(rec, jcfg, shape)
    assert rec["resilience"] == _jax_resilience(jcfg, s, topo)
    assert rec["pipeline"] == {
        "pp": s.pp, "microbatches": s.microbatches, "sched": s.sched,
        "virtual_stages": jpipe.virtual_stages(s.sched),
        "overlap": s.overlap,
        "bubble_predicted": jpipe.bubble_fraction(s.pp, s.microbatches,
                                                  s.sched),
        "inflight_microbatches": jpipe.inflight_microbatches(
            s.pp, s.microbatches, s.sched),
        "op_tick_counts": jpipe.op_tick_counts(s.sched, s.pp,
                                               s.microbatches)}
    peaks = {k: m["peak_bytes_per_device"]
             for k, m in rec["memory_by_stage"].items()}
    assert set(peaks) == {"pipe0", "pipe1"}
    assert rec["memory"]["peak_bytes_per_device"] == max(peaks.values())
    # the stages run different programs (the lookup on the first, the
    # head and loss on the last; under 1f1b and zb the first holds more
    # microbatch graphs)
    assert peaks["pipe1"] != peaks["pipe0"]
