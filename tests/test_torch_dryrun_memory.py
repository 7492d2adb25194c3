"""The dry run's memory tracker against a real step on the CPU, its
collective census against the plan, and the kernels' shape-only branches
on fake tensors (the rest of the dry run's tests:
``tests/test_torch_dryrun.py``; the full-size MoE and non-token points,
the points it skips and those it refuses as another layout:
``tests/test_torch_dryrun_points.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import strategy
from repro_torch.configs import SHAPES, ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.models import layers
from test_torch_dryrun import QWEN, SMALL
from test_torch_fsdp import _few_threads  # noqa: F401

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
# the kernels' fake branches
# ---------------------------------------------------------------------------

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
    config of head dim 32 (d 128 over 4 heads) on the kernel path fails as
    on the card, and traces with the plain layers."""
    cfg = reduced(get_config(QWEN), d_model=128)
    assert cfg.head_dim_ == 32
    s = strategy.parse("fsdp")
    topo = strategy.host_topology(n_devices=1)
    with pytest.raises(ValueError, match="head dim 32 has no kernel"):
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
    specs = train_batch_specs(dataclasses.replace(
        cfg, input_mode="embeddings"), SHAPES["train_4k"])
    assert {k: (tuple(v.shape), v.dtype) for k, v in specs.items()} == {
        "embeds": ((256, 4096, cfg.d_model), torch.bfloat16),
        "labels": ((256, 4096), torch.int32)}
