"""The port's dry run (``launch/dryrun.py``: one train step, prefill or
decode step traced on a fake process group under ``FakeTensorMode``)
against the JAX package's, on the CPU (``--device cpu``: the dry run
refuses to run without a card otherwise).

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
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import strategy
from repro_torch.configs import LATER, SHAPES, ShapeConfig, get_config, \
    reduced
from repro_torch.launch import dryrun
from repro_torch.models import layers

ROOT = Path(__file__).resolve().parents[1]
QWEN = "qwen3-0.6b"
# a reduced qwen3 on 8 fake ranks: 16 rows of 32 tokens, 2 layers
SMALL = ShapeConfig("t", 32, 16, "train")


def _cli(args, out, timeout=600):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
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


# the serving points of the other archs the port serves, on the pod:
# RWKV-6's three (long_500k too: a recurrent state, batch 1 < data 16
# spreads the caches over data x model), the Llama-2 family's decode
# (70B's 8 KV heads do not split over the model axis of 16; 13B's 40
# query heads do not either, which resolves tp 16 to context attention,
# so it runs hsdp_tp8) and two prefills
SERVING = [("rwkv6-1.6b", "prefill_32k", ""),
           ("rwkv6-1.6b", "decode_32k", ""),
           ("rwkv6-1.6b", "long_500k", "")] + \
    [(f"llama2-{n}", "decode_32k", "") for n in ("1b", "7b", "70b")] + \
    [("llama2-13b", "decode_32k", "hsdp_tp8"),
     ("llama2-1b", "prefill_32k", ""), ("llama2-70b", "prefill_32k", "")] + \
    [("granite-20b", "decode_32k", ""),       # one KV head, 48 query heads
     ("h2o-danube-1.8b", "decode_32k", ""),   # a ring of 4096 slots
     ("h2o-danube-1.8b", "long_500k", ""),    # the window: sub-quadratic
     ("qwen2-1.5b", "decode_32k", "hsdp_tp4")]   # 12 heads: tp 16 is cp


@pytest.mark.parametrize("arch,shape,spec", SERVING)
def test_serving_points_trace_with_jax_cache_shards(arch, shape, spec,
                                                    tmp_path):
    """Each point traces on 256 fake ranks (the legacy pod layout unless a
    spec is given); its caches take exactly the bytes per device of JAX's
    shards on the same plan, and the decode cache axes are JAX's
    choice."""
    rec = dryrun.run_one(arch, shape, False, str(tmp_path), strategy=spec,
                         device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["cache_bytes_per_device"] == _jax_cache_bytes(
        arch, shape, rec["plan"])
    assert rec["memory"]["cache_bytes"] >= rec["cache_bytes_per_device"]
    axes = ["data", "model"] if shape == "long_500k" else ["model"]
    assert rec["plan"]["decode_cache_axes"] == axes


def test_granite_20b_trains_at_full_depth_on_a_pod(tmp_path):
    """granite-20b x train_4k at full size (52 layers, 20.3 B parameters,
    more than one card holds in f32) traces on 256 fake ranks, with the
    kernel path's head dim 128 and the census of its plan."""
    rec = dryrun.run_one("granite-20b", "train_4k", False, str(tmp_path),
                         device="cpu")
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
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
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
    from repro.perf import flops as jflops
    assert rec["flops_compiled_analytic"] == jflops.compiled_flops(
        jcfg, shape, remat=False)
    assert rec["flops_forward_analytic"] == jflops.forward_flops(jcfg,
                                                                 shape)
    assert rec["flops_model_6nd"] == jflops.model_flops(jcfg, shape)
    assert rec["params_total"] == jcfg.param_count()
    assert rec["params_active"] == jcfg.active_param_count()


def test_record_matches_the_jax_functions(pod_records):
    """The analytic FLOP fields, parameter counts and resilience block of
    the pod record are JAX's for the same point (the port runs no
    rematerialisation, so the compiled FLOPs are JAX's ``remat=False``)."""
    rec = pod_records["train_4k"]
    jcfg, shape, s, topo = _jax_point(QWEN, "hsdp_tp16", "pod", "train_4k")
    _analytic_equal(rec, jcfg, shape)
    assert rec["resilience"] == _jax_resilience(jcfg, s, topo)


@pytest.mark.parametrize("spec", ["fsdp_pp2_mb4", "fsdp_pp2_mb4_zb"])
def test_pipeline_records_match_the_jax_functions(spec, tmp_path):
    """A pipelined point traces pipe rank 0 and the last pipe rank (whose
    programs differ): the record keeps both peaks and the larger, and its
    pipeline block, analytic fields and resilience block are JAX's."""
    from repro.core import pipeline as jpipe
    rec = dryrun.run_one(QWEN, "train_4k", False, str(tmp_path),
                         strategy=spec, use_reduced=True, kernels="torch",
                         device="cpu")
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


# ---------------------------------------------------------------------------
# memory: fake mode against a real step on the CPU
# ---------------------------------------------------------------------------

def _real_peak(cfg, shape, s):
    """The tracker's peak over the step ``dryrun.lower_one`` traces, run
    for real on a 1-rank gloo group: the same functions on real
    tensors."""
    from repro_torch.core import parallel as par
    from repro_torch.launch.specs import train_batch_specs
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.perf.memory import MemoryTracker
    from repro_torch.train.trainer import TrainConfig, make_train_step
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        topo = strategy.host_topology()
        plan = s.to_plan(cfg, topo, shape)
        rt = par.make_runtime(cfg, plan, shape, attn_impl="torch",
                              norm_impl="torch",
                              attn_min_chunked_len=shape.seq_len + 1)
        params = par.apply_plan(init_params(cfg, 0, "cpu"), plan, cfg)
        opt_state = init_opt_state(params)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in train_batch_specs(cfg, shape).items()}
        step = make_train_step(cfg, rt, TrainConfig(
            steps=max(s.grad_accum, 2), warmup=1,
            grad_accum=s.grad_accum), plan)
        mem = MemoryTracker()
        mem.register([p.to_local() for p in params.parameters()],
                     "parameters")
        mem.register([t.to_local() for k in ("m", "v")
                      for t in opt_state[k].values()], "optimizer")
        mem.register(batch.values(), "activations")
        with mem:
            step(params, opt_state, batch)
        return mem.peak, mem.breakdown()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spec", ["fsdp", "fsdp_bf16", "ddp_ga2"])
def test_fake_peak_matches_a_real_step(spec):
    cfg = reduced(get_config(QWEN))
    shape = ShapeConfig("t", 64, 8, "train")
    s = strategy.parse(spec)
    fake = dryrun.lower_one(cfg, shape, s, strategy.host_topology(
        n_devices=1), kernels="torch", device="cpu")["memory"]
    real, split = _real_peak(cfg, shape, s)
    assert abs(fake["peak_bytes_per_device"] - real) <= 0.02 * real, \
        (fake, real, split)
    assert fake["parameters_bytes"] == split["parameters"]
    assert fake["optimizer_bytes"] == split["optimizer"]


# ---------------------------------------------------------------------------
# the collective census against the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["fsdp", "fsdp_z2", "fsdp_ga2", "hsdp",
                                  "fsdp_tp2", "fsdp_tp2_nosp",
                                  "fsdp_pp2_mb4"])
def test_census_counts_what_the_plan_issues(spec):
    """On 8 fake ranks, per FSDP2 unit on the rank (its layers and the
    root) and per backward pass: an all-gather for the forward and, under
    ZeRO-3, one for the backward, and one reduce-scatter; plus the
    tensor-parallel collectives the layers counted; under a pipeline one
    send per microbatch on pipe rank 0."""
    cfg = reduced(get_config(QWEN))
    s = strategy.parse(spec)
    layers.reset_collective_counts()
    rec = dryrun.lower_one(cfg, SMALL, s, strategy.host_topology(
        n_devices=8), kernels="torch", device="cpu")
    tp = dict(layers.COLLECTIVES)
    coll = rec["collectives"]
    units = cfg.n_layers // s.pp + 1
    passes = s.grad_accum * s.microbatches
    gathers = 2 if s.zero >= 3 else 1
    assert coll["all-gather"]["count"] == \
        units * passes * gathers + tp["all_gather"]
    assert coll["reduce-scatter"]["count"] == \
        units * passes + tp["reduce_scatter"]
    assert coll["all-reduce"]["count"] >= tp["all_reduce"] + 1
    if s.tp == 1:
        assert not any(tp.values())
    if s.pp > 1:
        dp = 8 // (s.pp * s.tp)
        assert coll["collective-permute"] == {
            "count": passes,
            "bytes": SMALL.global_batch // dp * SMALL.seq_len
            * cfg.d_model * 4}
    else:
        assert "collective-permute" not in coll


def test_census_fp8_wire_moves_a_quarter_of_the_layer_bytes():
    """Under ``fsdp_fp8`` each layer unit gathers float8_e4m3fn, a quarter
    of f32's bytes; the root unit (embedding, final norm) gathers f32."""
    cfg = reduced(get_config(QWEN))
    topo = strategy.host_topology(n_devices=8)
    got = {spec: dryrun.lower_one(cfg, SMALL, strategy.parse(spec), topo,
                                  kernels="torch", device="cpu")[
                                      "collectives"]
           ["all-gather"] for spec in ("fsdp", "fsdp_fp8")}
    root = 4 * (cfg.vocab_size * cfg.d_model + cfg.d_model)
    f32_layers = got["fsdp"]["bytes"] - 2 * root
    assert got["fsdp_fp8"]["count"] == got["fsdp"]["count"]
    assert got["fsdp_fp8"]["bytes"] == 2 * root + f32_layers // 4


# ---------------------------------------------------------------------------
# skips, refusals and the kernels' fake branches
# ---------------------------------------------------------------------------

# long_500k on full attention, for the JAX package's reason
SKIPS = [(arch, "long_500k") for arch in (QWEN, "llama2-1b", "llama2-7b",
                                          "qwen2-1.5b", "granite-20b")] \
    + [(arch, "train_4k") for arch in sorted(LATER)]


@pytest.mark.parametrize("arch,shape", SKIPS)
def test_unported_points_are_skipped_naming_their_slice(arch, shape,
                                                         tmp_path):
    rec = dryrun.run_one(arch, shape, False, str(tmp_path), device="cpu")
    assert json.loads(next(tmp_path.glob("*.json")).read_text()) == rec
    assert rec["status"] == "skipped"
    want = (f"'{LATER[arch]}' slice" if arch in LATER
            else dryrun.SUBQUADRATIC)
    assert want in rec["reason"]


def test_context_attention_is_refused_as_cp(tmp_path):
    """``--attn context`` on the pod layout resolves tp 16 to context
    attention, which ``Strategy.check`` refuses, naming the cp slice."""
    rec = dryrun.run_one(QWEN, "train_4k", False, str(tmp_path),
                         attn_override="context", device="cpu")
    assert rec["status"] == "error"
    assert "context parallelism" in rec["error"]


def _kernel_calls():
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    tbl = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    return {
        "rmsnorm": (lambda x, s: ops.rmsnorm_forward(x, s),
                    (rnd(6, 128), rnd(128))),
        "attention": (lambda q, k, v: ops.attention(q, k, v),
                      (rnd(2, 16, 4, 128), rnd(2, 16, 2, 128),
                       rnd(2, 16, 2, 128))),
        "wkv6": (lambda r, k, v, w, u: ops.wkv6(r, k, v, w, u, chunk=16),
                 (rnd(1, 32, 2, 64), rnd(1, 32, 2, 64), rnd(1, 32, 2, 64),
                  torch.rand(1, 32, 2, 64, generator=g) * 0.5 + 0.4,
                  rnd(2, 64))),
        "decode": (lambda q, kp, vp: ops.paged_decode_attention(
            q, kp, vp, tbl, torch.tensor([20, 9], dtype=torch.int32)),
                   (rnd(2, 1, 4, 128), rnd(4, 16, 2, 128),
                    rnd(4, 16, 2, 128))),
    }


@pytest.mark.parametrize("name", ["rmsnorm", "attention", "wkv6",
                                  "decode"])
def test_kernel_fake_branch_only_on_fake_tensors(name):
    """A real CPU tensor takes the plain version (its values, bit for bit
    a second call's); a fake tensor takes the shape-only branch: outputs
    of the kernel's shapes and dtypes, backward included, and no launch
    counted."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.kernels import ops
    fn, args = _kernel_calls()[name]
    ops.reset_launch_counts()
    real = fn(*args)
    again = fn(*args)
    flat = real if isinstance(real, tuple) else (real,)
    for a, b in zip(flat, again if isinstance(again, tuple) else (again,)):
        assert not isinstance(a, FakeTensor) and torch.equal(a, b)
        assert np.isfinite(a.numpy()).all()
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a).requires_grad_(name != "decode")
                 for a in args]
        fake = fn(*fargs)
        fflat = fake if isinstance(fake, tuple) else (fake,)
        for a, b in zip(fflat, flat):
            assert isinstance(a, FakeTensor)
            assert (a.shape, a.dtype) == (b.shape, b.dtype)
        if name != "decode":
            fflat[0].sum().backward()
            assert all(isinstance(a.grad, FakeTensor)
                       and a.grad.shape == a.shape for a in fargs
                       if a.grad is not None)
    assert not any(ops.launch_counts().values())


def test_fake_branch_refuses_what_the_card_refuses():
    """The shape-only branch keeps the kernels' compiled head dims: a
    reduced config (head dim 64) on the kernel path fails as on the card,
    and traces with the plain layers."""
    cfg = reduced(get_config(QWEN))
    s = strategy.parse("fsdp")
    topo = strategy.host_topology(n_devices=1)
    with pytest.raises(ValueError, match="head dim 64 has no kernel"):
        dryrun.lower_one(cfg, SMALL, s, topo, kernels="cuda", device="cpu")
    assert not dist.is_initialized()
    assert dryrun.lower_one(cfg, SMALL, s, topo, kernels="torch",
                            device="cpu")[
        "memory"]["peak_bytes_per_device"] > 0


def test_train_batch_specs():
    from repro_torch.launch.specs import train_batch_specs
    cfg = get_config(QWEN)
    specs = train_batch_specs(cfg, SHAPES["train_4k"])
    assert {k: (tuple(v.shape), v.dtype) for k, v in specs.items()} == {
        "tokens": ((256, 4096), torch.int32),
        "labels": ((256, 4096), torch.int32)}
    with pytest.raises(NotImplementedError, match="other mixers"):
        train_batch_specs(dataclasses.replace(cfg, input_mode="embeddings"),
                          SHAPES["train_4k"])
