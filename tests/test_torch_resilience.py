"""Checkpointing and resilience of the port against the JAX package's, on
the CPU: every test of ``tests/test_resilience.py`` has its counterpart
here (fault plans, atomic and CRC-checked checkpoints, the async
checkpointer, the kill/resume bit-match, transient I/O retries, the
supervisor's backoff, budget and degraded re-plan), plus what only a
second package brings: checkpoints cross between the packages both ways,
key for key and bit for bit, and across meshes (gloo worlds of 2 and 4
processes, spawned once per module while this process runs the JAX side).

Small sizes: qwen3-0.6b and rwkv6-1.6b at 2 layers of d_model 64, batches
of 4 x 16 tokens, f32.  The JAX package's ``train_loop`` needs a mesh,
which this jax refuses (its failing tests in ``tests/test_resilience.py``),
so its checkpoints are made as that loop makes them: its jitted
``make_train_step`` on one device, then ``save_checkpoint`` of the tree
and meta its ``save`` writes.  Spawned workers import only torch and the
port; JAX is imported inside the tests.
"""
import dataclasses
import errno
import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch import checkpointing as ckpt_lib
from repro_torch import strategy
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import parallel as par
from repro_torch.data import Batcher, SyntheticSource
from repro_torch.models import init_params
from repro_torch.models.layers import Runtime
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.resilience import (FaultEvent, FaultPlan,
                                    RestartBudgetExceeded, SimulatedFailure,
                                    Supervisor, SupervisorConfig,
                                    load_fault_plan, supervise_training)
from repro_torch.train import TrainConfig, train_loop
from repro_torch.train.trainer import prng_key_data

ROOT = Path(__file__).resolve().parents[1]
S, B = 16, 4
ARCHS = ("qwen3-0.6b", "rwkv6-1.6b")
# weight decay off in the runs held against JAX: the JAX tree stacks
# qk-norm's 1-d scales, which then take decay there and not in the port
# (the STACKED_1D caveat of tests/test_torch_train.py)
OPT = AdamWConfig(weight_decay=0.0)
# the bars of tests/test_torch_train.py::test_train_step_trajectory_matches_jax
# and tests/test_torch_fsdp.py's F32_BARS: metrics within 1e-5 relative,
# first moments 1e-4 of each leaf's scale, parameters in units of lr (max
# < 0.5, mean < 1e-3)
F32_BARS = dict(metric=1e-5, moment=1e-4, lr_max=0.5, lr_mean=1e-3)
SPAWN_TIMEOUT = 240


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(arch="qwen3-0.6b"):
    return reduced(get_config(arch), n_layers=2, d_model=64)


def _batches(cfg):
    return Batcher(SyntheticSource(cfg.vocab_size, seed=7), S, B)


def _setup(cfg, spec="fsdp", topo=None):
    shape = ShapeConfig("res", S, B, "train")
    strat = strategy.parse(spec)
    topo = topo or strategy.host_topology()
    plan = strat.to_plan(cfg, topo, shape)
    return shape, strat, topo, plan, par.make_runtime(cfg, plan, shape)


def _plain_rt():
    """The unsharded runtime (kernel path: its plain versions here)."""
    return Runtime()


def _leaves(tree, path=()):
    """[(path, leaf)] of a nested dict/list, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _assert_equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(x, y), path


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return np.array(tree, copy=True)


def _errors(got, want, lr):
    """Worst differences of a final state from a reference: first moments
    relative to each leaf's scale, parameters in units of ``lr``."""
    err = dict(moment=0.0, lr_max=0.0, lr_mean=0.0)
    for (path, a), (_, b) in zip(_leaves(got["opt"]["m"]),
                                 _leaves(want["opt"]["m"]), strict=True):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        err["moment"] = max(err["moment"], np.max(np.abs(a - b))
                            / max(np.max(np.abs(b)), 1e-30))
    for (path, a), (_, b) in zip(_leaves(got["params"]),
                                 _leaves(want["params"]), strict=True):
        d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)) / lr
        err["lr_max"] = max(err["lr_max"], d.max())
        err["lr_mean"] = max(err["lr_mean"], d.mean())
    return err


def _metric_err(got, want):
    return max(abs(got[k] - want[k]) / max(1.0, abs(want[k]))
               for k in ("loss", "nll", "ntok", "grad_norm"))


@pytest.fixture(scope="module")
def group():
    """A 1-rank gloo process group in this process (a strategy's mesh
    needs one), torn down with the module."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the spawned worlds (torch and the port only), started with the module
# ---------------------------------------------------------------------------

def _meshes_task(rank, tmp, specs=("fsdp_tp2", "fsdp_pp2_mb4")):
    """Under each of ``specs``, train 2 steps saving at step 2, then
    restore into fresh parameters of the same plan -> {spec: (the saved
    state, the restored state, directory)}."""
    cfg = _cfg()
    out = {}
    for spec in specs:
        d = os.path.join(tmp, spec)
        shape, strat, topo, plan, rt = _setup(cfg, spec)
        pipe = rt.pipe_group if rt.pipe_size > 1 else None
        tc = TrainConfig(steps=2, warmup=1, log_every=100, ckpt_every=2,
                         ckpt_dir=d, opt=OPT)
        params = par.apply_plan(init_params(cfg, 0, "cpu"), plan, cfg)
        params, opt, _ = train_loop(cfg, rt, tc, _batches(cfg), params,
                                    plan=plan)
        saved = bridge.train_state_to_tree(params, opt, cfg, pipe)
        fresh = par.apply_plan(init_params(cfg, 1, "cpu"), plan, cfg)
        fresh, fopt, _ = train_loop(
            cfg, rt, dataclasses.replace(tc, ckpt_every=0, resume=True),
            _batches(cfg), fresh, plan=plan)
        out[spec] = (saved, bridge.train_state_to_tree(fresh, fopt, cfg,
                                                       pipe), d)
    return out


# rank 0's failing write in the world of two: (the step it fails at, the
# error it raises, whether saves are async) -> (every rank's outcome, the
# steps on disk).  A transient CheckpointIOError surfacing at the next
# save is retried there on every rank; any other error, a full disk's
# OSError too, raises on every rank, at that save or at the loop's end.
WRITE_FAILURES = {
    (2, "io", True): ("completed", [1, 3, 4]),
    (4, "io", True): ("raised", [1, 2, 3]),
    (2, "os", True): ("raised", [1]),
    (4, "os", True): ("raised", [1, 2, 3]),
    (2, "os", False): ("raised", [1])}


def _background_failure_task(rank, tmp):
    """2 ranks under ``fsdp``, saves every step, rank 0's write of one
    step failing, for each case of ``WRITE_FAILURES`` -> {case: (each
    rank's outcome, the steps on disk)}."""
    from repro_torch.checkpointing import checkpoint as ckpt_mod
    cfg = _cfg()
    shape, strat, topo, plan, rt = _setup(cfg)
    real, out = ckpt_mod.write_snapshot, {}
    for fail, kind, async_ in WRITE_FAILURES:
        d = os.path.join(tmp, f"fail{fail}{kind}{int(async_)}")

        def flaky(directory, step, snap, meta=None, fail=fail, kind=kind):
            if step == fail and kind == "io":
                raise ckpt_lib.CheckpointIOError(f"injected at step {step}")
            if step == fail:
                raise OSError(errno.ENOSPC, "No space left on device")
            return real(directory, step, snap, meta)

        ckpt_mod.write_snapshot = flaky
        try:
            train_loop(cfg, rt, TrainConfig(
                steps=4, warmup=1, log_every=100, ckpt_every=1, ckpt_dir=d,
                ckpt_async=async_, opt=OPT), _batches(cfg),
                par.apply_plan(init_params(cfg, 0, "cpu"), plan, cfg),
                plan=plan)
            outcome = "completed"
        except (ckpt_lib.CheckpointError, OSError):
            outcome = "raised"
        finally:
            ckpt_mod.write_snapshot = real
        outcomes = [None] * dist.get_world_size()
        dist.all_gather_object(outcomes, outcome)
        out[fail, kind, async_] = (outcomes, ckpt_lib.list_steps(d))
    return out


def _two_task(rank, tmp):
    return dict(meshes=_meshes_task(rank, tmp),
                failures=_background_failure_task(rank, tmp))


def _four_task(rank, tmp):
    """4 ranks: ``fsdp_tp2`` saved and restored (data 2 x model 2: FSDP2
    shards the model axis' shards again), then under ``fsdp`` a crash at
    step 2 loses 2 devices; the supervisor re-plans onto the first 2
    ranks, which restore the 4-rank checkpoint, crash again at step 3
    (ranks 2-3, outside the mesh, join that restore too) and finish 4
    steps."""
    meshes = _meshes_task(rank, tmp, ("fsdp_tp2",))
    cfg = _cfg()
    shape = ShapeConfig("res", S, B, "train")
    log = os.path.join(tmp, "events.json")
    tc = TrainConfig(steps=4, warmup=1, log_every=1, ckpt_every=1,
                     ckpt_dir=os.path.join(tmp, "ckpt"), opt=OPT)
    params, opt, history, sup = supervise_training(
        cfg, strategy.parse("fsdp"), strategy.host_topology(), shape, tc,
        lambda: _batches(cfg), seed=0, device="cpu",
        fault_plan=FaultPlan(events=[
            FaultEvent(2, "crash", lost_devices=2), FaultEvent(3, "crash")]),
        sup_cfg=SupervisorConfig(backoff_base_s=0.0, event_log_path=log))
    tree = (bridge.train_state_to_tree(params, opt, cfg)
            if params is not None else None)
    left_out = [None] * dist.get_world_size()
    dist.all_gather_object(left_out, params is None)
    # the single-device reference, at this world's one thread: the port's
    # bits move with the thread count (ROADMAP Queue 3)
    ref = train_loop(cfg, _plain_rt(), dataclasses.replace(tc, ckpt_every=0),
                     _batches(cfg), init_params(cfg, 0, "cpu")) \
        if rank == 0 else None
    return dict(tree=tree, history=history, left_out=left_out, log=log,
                meshes=meshes, ref=ref and (bridge.train_state_to_tree(
                    ref[0], ref[1], cfg), ref[2]))


TASKS = {"two": (2, _two_task), "four": (4, _four_task)}


def _world(rank, n, task, tmp, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}.store",
                            rank=rank, world_size=n)
    try:
        result = TASKS[task][1](rank, tmp)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(autouse=True, scope="module")
def _started(tmp_path_factory):
    """Spawn every world as the module starts; the tests that read them
    join (``worlds``), the others run meanwhile."""
    started = {}
    try:
        for task, (n, _) in TASKS.items():
            d = tmp_path_factory.mktemp(task)
            started[task] = (d / "out.pkl", mp.start_processes(
                _world, args=(n, task, str(d), str(d / "out.pkl")),
                nprocs=n, join=False, start_method="spawn"))
        yield started
    finally:
        for _, ctx in started.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)


@pytest.fixture(scope="module")
def worlds(_started):
    out, deadline = {}, time.time() + SPAWN_TIMEOUT
    for task, (path, ctx) in _started.items():
        while not ctx.join(timeout=1):
            if time.time() > deadline:
                raise TimeoutError(f"world {task!r} still running after "
                                   f"{SPAWN_TIMEOUT} s")
        with open(path, "rb") as f:
            out[task] = pickle.load(f)
    return out


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rates", [
    (7, dict(crash_rate=0.02, straggler_rate=0.05, ckpt_io_rate=0.03)),
    (3, dict(crash_rate=0.1, straggler_slowdown=3.0, ckpt_io_rate=0.2))])
def test_fault_plan_deterministic_round_trips_and_matches_jax(seed, rates):
    from repro.resilience import FaultPlan as JFaultPlan
    a = FaultPlan.generate(seed, 200, **rates)
    assert a.events == FaultPlan.generate(seed, 200, **rates).events
    assert a.events
    assert a.events != FaultPlan.generate(seed + 1, 200, **rates).events
    # per-kind substreams: changing one rate must not reshuffle the others
    d = FaultPlan.generate(seed, 200, **{**rates, "straggler_rate": 0.5})
    assert a.crash_steps() == d.crash_steps()
    back = FaultPlan.from_json(a.to_json())
    assert back.events == a.events and back.seed == a.seed
    # the JAX package draws the same schedule, and reads the port's JSON
    j = JFaultPlan.generate(seed, 200, **rates)
    assert [dataclasses.astuple(e) for e in a.events] == \
        [dataclasses.astuple(e) for e in j.events]
    assert JFaultPlan.from_json(a.to_json()).events == j.events


def test_fault_plan_injection_semantics(tmp_path):
    plan = load_fault_plan("crash@3,5")
    assert plan.crash_steps() == [3, 5]
    plan.check_crash(2)                           # nothing scheduled
    with pytest.raises(SimulatedFailure) as ei:
        plan.check_crash(3)
    assert ei.value.step == 3
    plan.check_crash(3)                           # fires once: resume passes
    plan2 = FaultPlan(events=[FaultEvent(1, "straggler", magnitude=3.0),
                              FaultEvent(2, "ckpt_io", magnitude=1.0)])
    assert plan2.delay_multiplier(1) == 3.0 and plan2.delay_multiplier(0) == 1.0
    with pytest.raises(ckpt_lib.CheckpointIOError):
        plan2.ckpt_io_check(2)
    plan2.ckpt_io_check(2)                        # budget spent: retry works
    plan2.reset()
    with pytest.raises(ckpt_lib.CheckpointIOError):
        plan2.ckpt_io_check(2)                    # a reset replays it
    p = tmp_path / "plan.json"
    p.write_text(plan.to_json())
    assert load_fault_plan(str(p)).crash_steps() == [3, 5]


# ---------------------------------------------------------------------------
# checkpoint integrity
# ---------------------------------------------------------------------------

def _tree(seed=0, shape=(4, 3)):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(shape, generator=g),
                       "b": torch.zeros((shape[1],), dtype=torch.bfloat16)},
            "opt": {"step": torch.zeros((), dtype=torch.int32)}}


def test_save_is_atomic_and_latest_skips_partial(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save_checkpoint(d, 2, _tree())
    ckpt_lib.save_checkpoint(d, 4, _tree(1))
    # a partial save (dir present, no manifest) is invisible to discovery
    os.makedirs(os.path.join(d, "step_6"))
    np.save(os.path.join(d, "step_6", "orphan.npy"), np.zeros(3))
    # an interrupted tmp dir is invisible too, and gc'd
    os.makedirs(os.path.join(d, "step_8.tmp-dead"))
    assert ckpt_lib.list_steps(d) == [2, 4]
    assert ckpt_lib.latest_step(d) == 4
    assert ckpt_lib.validate_checkpoint(d, 4) == []
    ckpt_lib.gc_checkpoints(d, keep=1)
    assert ckpt_lib.list_steps(d) == [4]
    assert not os.path.exists(os.path.join(d, "step_8.tmp-dead"))


def test_restore_reports_all_problems_in_one_error(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    ckpt_lib.save_checkpoint(d, 1, tree)
    target = {"params": {"w": tree["params"]["w"],
                         "b": torch.zeros((5,), dtype=torch.bfloat16),
                         "extra": torch.zeros((2,))},
              "opt": {"step": tree["opt"]["step"]}}
    with pytest.raises(ckpt_lib.CheckpointError) as ei:
        ckpt_lib.restore_checkpoint(d, 1, target)
    msg = str(ei.value)
    assert "params/extra" in msg
    assert "params/b" in msg and "(3,)" in msg and "(5,)" in msg
    # a leaf the target lacks is named too
    del target["params"]["extra"], target["params"]["w"]
    target["params"]["b"] = tree["params"]["b"]
    with pytest.raises(ckpt_lib.CheckpointError, match="params/w"):
        ckpt_lib.restore_checkpoint(d, 1, target)


def test_corrupt_checkpoint_detected_and_skipped(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save_checkpoint(d, 1, _tree(0))
    ckpt_lib.save_checkpoint(d, 2, _tree(1))
    step_dir = os.path.join(d, "step_00000002")
    man = json.load(open(os.path.join(step_dir, "manifest.json")))
    wkey = [k for k in man["leaves"] if k.endswith("w")][0]
    leaf = os.path.join(step_dir, man["leaves"][wkey]["file"])
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0xFF
    open(leaf, "wb").write(bytes(raw))
    problems = ckpt_lib.validate_checkpoint(d, 2)
    assert problems and any("crc" in p.lower() for p in problems)
    assert ckpt_lib.latest_valid_step(d, verify=False) == 2
    assert ckpt_lib.latest_valid_step(d, verify=True) == 1
    with pytest.raises(ckpt_lib.CheckpointError):
        ckpt_lib.restore_checkpoint(d, 2, _tree(1), verify=True)
    sup = Supervisor(SupervisorConfig(), ckpt_dir=d)
    assert sup.restore_step() == 1


def test_async_checkpointer_bit_equal_bounded_and_fast(tmp_path):
    tree = _tree(3, shape=(64, 64))
    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    t0 = time.perf_counter()
    ckpt_lib.save_checkpoint(sync_dir, 1, tree)
    t_sync = time.perf_counter() - t0

    in_flight, seen = [], []
    gate = threading.Event()

    def hook(step):
        in_flight.append(step)
        seen.append(len(in_flight))
        gate.wait(5.0)
        in_flight.remove(step)

    with ckpt_lib.AsyncCheckpointer(async_dir, max_in_flight=2,
                                    io_error_hook=hook) as ck:
        stall = ck.save(1, tree)
        ck.save(2, tree)
        gate.set()                    # 3rd save blocks until a slot frees
        ck.save(3, tree)
        ck.wait()
    assert max(seen) <= 2
    assert stall < t_sync * 0.9
    assert [s["step"] for s in ck.stats] == [1, 2, 3]
    a = ckpt_lib.restore_checkpoint(sync_dir, 1, _tree(99, (64, 64)))
    b = ckpt_lib.restore_checkpoint(async_dir, 1, _tree(98, (64, 64)))
    for (_, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_async_checkpointer_surfaces_background_errors(tmp_path):
    def hook(step):
        raise ckpt_lib.CheckpointIOError(f"disk on fire at {step}")

    ck = ckpt_lib.AsyncCheckpointer(str(tmp_path), io_error_hook=hook)
    ck.save(1, _tree())
    with pytest.raises(ckpt_lib.CheckpointIOError):
        ck.wait()
    ck.save(2, _tree())
    with pytest.raises(ckpt_lib.CheckpointIOError):
        ck.close()                        # and at close
    assert ckpt_lib.list_steps(str(tmp_path)) == []


def test_async_save_is_not_aliased(tmp_path):
    """The port updates parameters and moments in place (JAX makes new
    arrays): a background write must save the values of the step it was
    handed, not later ones."""
    cfg = _cfg()
    params = init_params(cfg, 0, "cpu")
    opt = init_opt_state(params)
    before = _copy_tree(bridge.train_state_to_tree(params, opt, cfg))
    gate = threading.Event()
    ck = ckpt_lib.AsyncCheckpointer(str(tmp_path),
                                    io_error_hook=lambda s: gate.wait(5.0))
    ck.save(1, bridge.train_state_to_tree(params, opt, cfg))
    with torch.no_grad():
        for p in params.parameters():
            p.add_(1.0)
        for m in opt["m"].values():
            m.add_(1.0)
    gate.set()
    ck.close()
    got = ckpt_lib.restore_checkpoint(
        str(tmp_path), 1, bridge.train_state_target(params, cfg))
    _assert_equal_trees(got, before)


def test_bf16_and_fp8_leaves_cross_both_ways(tmp_path):
    """Leaves of dtypes numpy lacks, as bits under their logical name:
    the port's read as those dtypes by JAX (through ml_dtypes), JAX's as
    tensors of them by the port."""
    import jax.numpy as jnp

    from repro import checkpointing as jckpt
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    port = {"bf16": torch.tensor(x).bfloat16(),
            "fp8": torch.tensor(x).to(torch.float8_e4m3fn),
            "step": torch.tensor(3, dtype=torch.int32)}
    ckpt_lib.save_checkpoint(str(tmp_path / "p"), 1, port)
    target = {"bf16": jnp.zeros((5, 7), jnp.bfloat16),
              "fp8": jnp.zeros((5, 7), jnp.float8_e4m3fn),
              "step": jnp.zeros((), jnp.int32)}
    got = jckpt.restore_checkpoint(str(tmp_path / "p"), 1, target)
    for k, bits in (("bf16", torch.int16), ("fp8", torch.uint8)):
        assert got[k].dtype == target[k].dtype
        assert np.array_equal(np.asarray(got[k]).view(np.dtype(
            str(bits).split(".")[-1])), port[k].view(bits).numpy())
    jax_tree = {"bf16": jnp.asarray(x, jnp.bfloat16),
                "fp8": jnp.asarray(x, jnp.float8_e4m3fn),
                "step": jnp.asarray(3, jnp.int32)}
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jax_tree)
    back = ckpt_lib.restore_checkpoint(str(tmp_path / "j"), 1, port)
    for k in ("bf16", "fp8"):
        assert back[k].dtype == port[k].dtype
        assert torch.equal(back[k].view(torch.uint8),
                           port[k].view(torch.uint8))
    assert back["step"].dtype == np.int32 and int(back["step"]) == 3


def test_prng_meta_is_jax_key_data():
    import jax
    for seed in (0, 7, 123456789, 2**31 - 1):
        assert prng_key_data(seed) == np.asarray(
            jax.random.key_data(jax.random.PRNGKey(seed))).tolist()


# ---------------------------------------------------------------------------
# kill / resume / supervisor
# ---------------------------------------------------------------------------

def test_batcher_position_restores_stream():
    cfg = _cfg()
    it = iter(_batches(cfg))
    skipped = [next(it) for _ in range(5)][3:]
    resumed = iter(_batches(cfg).at(3))
    for want in skipped:
        got = next(resumed)
        assert np.array_equal(want["tokens"], got["tokens"])
        assert np.array_equal(want["labels"], got["labels"])


@pytest.mark.parametrize("arch,crashes,every,async_,keep", [
    ("qwen3-0.6b", (4,), 2, False, 0),
    ("qwen3-0.6b", (2, 4), 1, True, 2),      # repeated crashes, async saves
    ("rwkv6-1.6b", (4,), 2, True, 1)])
def test_killed_and_resumed_run_bitmatches_uninterrupted(
        group, tmp_path, arch, crashes, every, async_, keep):
    """Run A trains 6 steps uninterrupted under ``fsdp``.  Run B saves
    every ``every`` steps, crashes at each of ``crashes`` and is resumed
    by the supervisor from the newest valid checkpoint: its parameters
    and moments are bit-identical, and the event log shows each failure
    recovered from the checkpoint before it."""
    cfg = _cfg(arch)
    shape, strat, topo, plan, rt = _setup(cfg)
    tc_a = TrainConfig(steps=6, warmup=1, log_every=100)
    p_a = par.apply_plan(init_params(cfg, 0, "cpu"), plan, cfg)
    p_a, o_a, _ = train_loop(cfg, rt, tc_a, _batches(cfg), p_a, plan=plan)
    want = bridge.train_state_to_tree(p_a, o_a, cfg)

    log = str(tmp_path / "events.json")
    tc_b = dataclasses.replace(tc_a, ckpt_every=every,
                               ckpt_dir=str(tmp_path / "ckpt"),
                               ckpt_async=async_, ckpt_keep=keep)
    p_b, o_b, _, sup = supervise_training(
        cfg, strat, topo, shape, tc_b, lambda: _batches(cfg), seed=0,
        device="cpu", fault_plan=FaultPlan.crashes_at(*crashes),
        sup_cfg=SupervisorConfig(backoff_base_s=0.0, event_log_path=log))
    _assert_equal_trees(bridge.train_state_to_tree(p_b, o_b, cfg), want)
    events = json.load(open(log))
    assert events["n_failures"] == len(crashes)
    fails = [e for e in events["events"] if e["kind"] == "failure"]
    assert [e["step_failed"] for e in fails] == list(crashes)
    assert all(e["simulated"] and e["restore_step"] == e["step_failed"]
               // every * every for e in fails)
    assert os.path.exists(os.path.splitext(log)[0] + ".jsonl")
    if keep:
        assert len(ckpt_lib.list_steps(tc_b.ckpt_dir)) <= keep


@pytest.mark.parametrize("async_", [False, True])
def test_trainer_retries_transient_ckpt_io_faults(tmp_path, async_):
    cfg = _cfg()
    plan_f = FaultPlan(events=[FaultEvent(2, "ckpt_io", magnitude=1.0)])
    tc = TrainConfig(steps=4, warmup=1, log_every=100, ckpt_every=2,
                     ckpt_dir=str(tmp_path), ckpt_async=async_)
    train_loop(cfg, _plain_rt(), tc, _batches(cfg),
               init_params(cfg, 0, "cpu"), fault_plan=plan_f)
    # both saves landed despite the injected transient failure at step 2
    assert ckpt_lib.list_steps(str(tmp_path)) == [2, 4]


def test_supervisor_backoff_and_budget_exhaustion(tmp_path):
    log = str(tmp_path / "events.json")
    sup = Supervisor(SupervisorConfig(max_restarts=2, backoff_base_s=0.01,
                                      backoff_factor=2.0, backoff_max_s=0.02,
                                      event_log_path=log))
    assert [sup.backoff_s(i) for i in range(3)] == [0.01, 0.02, 0.02]
    calls = []

    def attempt(n, strat, topo):
        calls.append(n)
        raise SimulatedFailure(step=5 + n)

    with pytest.raises(RestartBudgetExceeded) as ei:
        sup.run(attempt)
    assert calls == [0, 1, 2]            # initial try + 2 restarts
    assert isinstance(ei.value.__cause__, SimulatedFailure)
    events = json.load(open(log))
    assert events["n_failures"] == 3
    assert events["events"][-1]["budget_exhausted"]


def test_supervisor_replans_for_degraded_devices():
    """A crash reporting lost devices shrinks the topology; the planner
    re-picks a strategy that still lowers on the survivors."""
    cfg = _cfg()
    shape = ShapeConfig("res", S, B, "train")
    topo = strategy.Topology("test", 8, 8, hardware="H100", hbm=80e9)
    sup = Supervisor(SupervisorConfig(max_restarts=2, backoff_base_s=0.0))
    seen = []

    def attempt(n, s, t):
        seen.append((n, t.n_devices, s.format()))
        if n == 0:
            raise SimulatedFailure(step=1, lost_devices=4)
        return "ok"

    out = sup.run(attempt, strategy=strategy.parse("fsdp"), topology=topo,
                  cfg=cfg, shape=shape)
    assert out == "ok"
    assert seen[0][1] == 8 and seen[1][1] == 4   # replanned onto survivors
    replans = [e for e in sup.events if e["kind"] == "replan"]
    assert replans and replans[0]["n_devices"] == 4
    assert replans[0]["new_spec"] == strategy.best(
        cfg, dataclasses.replace(topo, n_devices=4, island=4), shape).spec


def test_supervisor_keeps_the_plan_when_replanning_is_off():
    """``replan_on_degrade=False``: a crash that loses devices is retried
    on the same strategy and topology, and no re-plan is recorded."""
    cfg = _cfg()
    shape = ShapeConfig("res", S, B, "train")
    topo = strategy.Topology("test", 8, 8, hardware="H100", hbm=80e9)
    sup = Supervisor(SupervisorConfig(max_restarts=2, backoff_base_s=0.0,
                                      replan_on_degrade=False))
    seen = []

    def attempt(n, s, t):
        seen.append((t.n_devices, s.format()))
        if n == 0:
            raise SimulatedFailure(step=1, lost_devices=4)
        return "ok"

    assert sup.run(attempt, strategy=strategy.parse("fsdp"), topology=topo,
                   cfg=cfg, shape=shape) == "ok"
    assert seen == [(8, "fsdp"), (8, "fsdp")]
    assert not [e for e in sup.events if e["kind"] == "replan"]


def test_train_loop_calls_hooks_on_logging_steps():
    """``hooks(step, params, metrics)`` runs on each logging step (the
    first and every ``log_every``) with the live parameters and the
    metrics ``history`` records."""
    cfg = _cfg()
    calls = []
    params = init_params(cfg, 0, "cpu")
    params, _, history = train_loop(
        cfg, _plain_rt(), TrainConfig(steps=4, warmup=1, log_every=2),
        _batches(cfg), params,
        hooks=lambda step, p, m: calls.append((step, p, dict(m))))
    assert [c[0] for c in calls] == [1, 2, 4]
    assert all(c[1] is params for c in calls)
    assert [{"step": c[0], **c[2]} for c in calls] == history


@pytest.mark.parametrize("max_in_flight,keep", [(1, 1), (3, 2)])
def test_ckpt_max_in_flight_and_keep_reach_the_checkpointer(
        tmp_path, monkeypatch, max_in_flight, keep):
    """``TrainConfig.ckpt_max_in_flight`` and ``ckpt_keep`` reach the
    trainer's ``AsyncCheckpointer`` (whose bound
    ``test_async_checkpointer_bit_equal_bounded_and_fast`` holds), and
    the newest ``keep`` steps stay on disk."""
    built = []
    real_init = ckpt_lib.AsyncCheckpointer.__init__

    def init(self, directory, max_in_flight=2, keep=0, io_error_hook=None):
        built.append((max_in_flight, keep))
        real_init(self, directory, max_in_flight, keep, io_error_hook)

    monkeypatch.setattr(ckpt_lib.AsyncCheckpointer, "__init__", init)
    cfg = _cfg()
    train_loop(cfg, _plain_rt(), TrainConfig(
        steps=4, warmup=1, log_every=100, ckpt_every=1,
        ckpt_dir=str(tmp_path), ckpt_async=True,
        ckpt_max_in_flight=max_in_flight, ckpt_keep=keep), _batches(cfg),
        init_params(cfg, 0, "cpu"))
    assert built == [(max_in_flight, keep)]
    assert ckpt_lib.list_steps(str(tmp_path)) == list(range(5 - keep, 5))


# ---------------------------------------------------------------------------
# across packages: the layout, and checkpoints both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{arch: JAX's run of 4 steps: its checkpoint at step 2 (the tree and
    meta its ``train_loop``'s ``save`` writes), the state there and at
    step 4, and the metrics of steps 3 and 4}."""
    import jax
    import jax.numpy as jnp

    from repro import checkpointing as jckpt
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.data import Batcher as JBatcher
    from repro.data import SyntheticSource as JSyntheticSource
    from repro.models import transformer as jtfm
    from repro.models.layers import Runtime as JRuntime
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.optim import init_opt_state as jinit_opt_state
    from repro.train.trainer import TrainConfig as JTrainConfig
    from repro.train.trainer import make_train_step

    out = {}
    for arch in ARCHS:
        jc = jreduced(jget_config(arch), n_layers=2, d_model=64)
        key = jax.random.PRNGKey(0)
        params = jtfm.init_params(jc, key)
        state = jinit_opt_state(params)
        jstep = jax.jit(make_train_step(jc, JRuntime(), JTrainConfig(
            steps=4, warmup=1, opt=JAdamWConfig(weight_decay=0.0))))
        it = iter(JBatcher(JSyntheticSource(jc.vocab_size, seed=7), S, B))
        d = str(tmp_path_factory.mktemp(f"jax-{arch}"))
        metrics = []
        for step in range(4):
            b = next(it)
            params, state, m = jstep(params, state, {
                k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            if step == 1:
                tree = {"params": params, "opt": state}
                jckpt.save_checkpoint(d, 2, tree, meta={
                    "step": 2, "batches_consumed": 2,
                    "prng": np.asarray(jax.random.key_data(key)).tolist()})
                at2 = jax.tree.map(np.asarray, tree)
        out[arch] = dict(dir=d, at2=at2, metrics=metrics[2:],
                         at4=jax.tree.map(np.asarray, {"params": params,
                                                       "opt": state}))
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """{arch: the port's checkpoint at step 2 of the same run (unsharded)
    and its state there}."""
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        d = str(tmp_path_factory.mktemp(f"port-{arch}"))
        tc = TrainConfig(steps=2, warmup=1, log_every=100, ckpt_every=2,
                         ckpt_dir=d, opt=OPT)
        params, opt, _ = train_loop(cfg, _plain_rt(), tc, _batches(cfg),
                                    init_params(cfg, 0, "cpu"))
        out[arch] = dict(dir=d, at2=bridge.train_state_to_tree(params, opt,
                                                               cfg))
    return out


def _manifest(d, step=2):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_layouts_match_across_packages(jax_runs, port_runs, arch):
    """The port's manifest names the leaves, files, shapes and dtypes the
    JAX package's does for the same config, in the same order, and its
    meta holds the same keys and key data."""
    j, p = _manifest(jax_runs[arch]["dir"]), _manifest(port_runs[arch]["dir"])
    assert list(p["leaves"]) == list(j["leaves"])
    for key, entry in j["leaves"].items():
        assert {k: p["leaves"][key][k] for k in ("file", "shape", "dtype")} \
            == {k: entry[k] for k in ("file", "shape", "dtype")}, key
    assert p["leaves"]["opt/step"]["dtype"] == "int32"
    assert p["meta"] == j["meta"]
    assert (p["step"], p["version"]) == (j["step"], j["version"])


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_jax(port_runs, arch):
    """JAX's ``restore_checkpoint`` with the ``shard_train_state`` target
    (its resume's, on the 8 host devices under ``fsdp``) loads the port's
    checkpoint bit-equal to ``bridge.train_state_to_tree``; the meta's key
    data is what JAX's resume rebuilds ``PRNGKey(seed)`` from."""
    import jax
    import jax.numpy as jnp

    from repro import checkpointing as jckpt
    from repro import strategy as jstrategy
    from repro.configs import ShapeConfig as JShapeConfig
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.core import parallel as jpar
    from repro.train.trainer import shard_train_state

    jc = jreduced(jget_config(arch), n_layers=2, d_model=64)
    shape = JShapeConfig("res", S, B, "train")
    plan = jstrategy.parse("fsdp").to_plan(jc, jstrategy.host_topology(),
                                           shape)
    rt = jpar.make_runtime(jc, plan, shape, param_dtype=jnp.float32,
                           compute_dtype=jnp.float32)
    d = port_runs[arch]["dir"]
    with jpar.use_mesh(plan.mesh):
        params, opt, pshard, oshard = shard_train_state(
            jc, plan, jax.random.PRNGKey(1), rt)
        tree = jckpt.restore_checkpoint(
            d, 2, {"params": params, "opt": opt},
            shardings={"params": pshard, "opt": oshard}, verify=True)
    _assert_equal_trees(jax.tree.map(np.asarray, tree), port_runs[arch]["at2"])
    meta = jckpt.load_meta(d, 2)
    assert meta["step"] == meta["batches_consumed"] == 2
    assert np.array_equal(np.asarray(meta["prng"], np.uint32),
                          np.asarray(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_in_port(jax_runs, arch, tmp_path):
    """The port resumes from JAX's step-2 checkpoint: its parameters and
    moments are JAX's bit for bit; both then train steps 3 and 4 and stay
    within the trajectory test's bars (F32_BARS)."""
    run, cfg = jax_runs[arch], _cfg(arch)
    tc = TrainConfig(steps=2, warmup=1, log_every=1, ckpt_dir=run["dir"],
                     resume=True, opt=OPT)
    params, opt, history = train_loop(cfg, _plain_rt(), tc, _batches(cfg),
                                      init_params(cfg, 1, "cpu"))
    assert history == []
    _assert_equal_trees(bridge.train_state_to_tree(params, opt, cfg),
                        run["at2"])
    params, opt, history = train_loop(
        cfg, _plain_rt(), dataclasses.replace(tc, steps=4), _batches(cfg),
        init_params(cfg, 1, "cpu"))
    assert [h["step"] for h in history] == [3, 4]
    err = _errors(bridge.train_state_to_tree(params, opt, cfg), run["at4"],
                  OPT.lr)
    err["metric"] = max(_metric_err(h, m)
                        for h, m in zip(history, run["metrics"]))
    assert all(err[k] < F32_BARS[k] for k in F32_BARS), (err, F32_BARS)


# ---------------------------------------------------------------------------
# across meshes (the spawned worlds)
# ---------------------------------------------------------------------------

def _mesh_runs(worlds):
    """{(ranks, spec): (saved, restored, directory)} of both worlds."""
    return {**{(2, k): v for k, v in worlds["two"]["meshes"].items()},
            **{(4, k): v for k, v in worlds["four"]["meshes"].items()}}


@pytest.mark.parametrize("ranks,spec", [(2, "fsdp_tp2"), (2, "fsdp_pp2_mb4"),
                                        (4, "fsdp_tp2")])
def test_checkpoints_round_trip_under_tp_and_pp(worlds, ranks, spec):
    saved, restored, _ = _mesh_runs(worlds)[ranks, spec]
    _assert_equal_trees(restored, saved)
    assert int(saved["opt"]["step"]) == 2


@pytest.mark.parametrize("fail,kind,async_", list(WRITE_FAILURES))
def test_a_background_write_failure_reaches_every_rank(worlds, fail, kind,
                                                       async_):
    """Rank 0 alone writes; its failed write (a transient
    ``CheckpointIOError`` or a full disk's ``OSError``, in the background
    or not) surfaces on every rank at the same save, retried there or
    raised there, or at the loop's end, so no rank is left waiting in a
    collective."""
    outcome, steps = WRITE_FAILURES[fail, kind, async_]
    outcomes, on_disk = worlds["two"]["failures"][fail, kind, async_]
    assert outcomes == [outcome, outcome] and on_disk == steps


@pytest.mark.parametrize("ranks", [2, 4])
def test_tp_checkpoint_restores_under_one_process_fsdp(worlds, group, ranks):
    """An ``fsdp_tp2`` checkpoint of 2 or 4 ranks restores bit-equal under
    ``fsdp`` in this process, and into unsharded parameters."""
    saved, _, d = _mesh_runs(worlds)[ranks, "fsdp_tp2"]
    cfg = _cfg()
    tc = TrainConfig(steps=2, warmup=1, log_every=100, ckpt_dir=d,
                     resume=True, opt=OPT)
    shape, strat, topo, plan, rt = _setup(cfg)
    params = par.apply_plan(init_params(cfg, 1, "cpu"), plan, cfg)
    params, opt, _ = train_loop(cfg, rt, tc, _batches(cfg), params,
                                plan=plan)
    _assert_equal_trees(bridge.train_state_to_tree(params, opt, cfg), saved)
    params, opt, _ = train_loop(cfg, _plain_rt(), tc, _batches(cfg),
                                init_params(cfg, 1, "cpu"))
    _assert_equal_trees(bridge.train_state_to_tree(params, opt, cfg), saved)


def test_degraded_replan_trains_on_the_first_ranks(worlds):
    """4 ranks under ``fsdp`` lose 2 at step 2: the re-plan runs on ranks
    0-1 (ranks 2-3 return None), restores the 4-rank checkpoint, survives
    a second crash at step 3 (every rank of the world restores step 3)
    and ends within tests/test_torch_fsdp.py's f32 bars of the port's
    single-device run (computed in the world, at one thread)."""
    got = worlds["four"]
    assert got["left_out"] == [False, False, True, True]
    events = json.load(open(got["log"]))
    assert events["n_failures"] == 2
    fails = [e for e in events["events"] if e["kind"] == "failure"]
    assert [(e["step_failed"], e["restore_step"], e["lost_devices"])
            for e in fails] == [(2, 2, 2), (3, 3, 0)]
    replan = [e for e in events["events"] if e["kind"] == "replan"]
    assert len(replan) == 1 and replan[0]["n_devices"] == 2
    assert [h["step"] for h in got["history"]] == [4]

    ref, history = got["ref"]
    err = _errors(got["tree"], ref, OPT.lr)
    err["metric"] = max(_metric_err(h, m)
                        for h, m in zip(got["history"], history[3:]))
    assert all(err[k] < F32_BARS[k] for k in F32_BARS), (err, F32_BARS)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_recovers_from_an_injected_crash(tmp_path):
    log = tmp_path / "events.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "4", "--ckpt_every", "2", "--fault_plan",
         "crash@3", "--max_restarts", "1", "--event_log", str(log),
         "--ckpt_dir", str(tmp_path / "ckpt"), "--log_every", "1",
         "--seq_len", "32", "--global_batch", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[supervisor] recovered from 1 failure(s)" in r.stdout
    assert "[resume] restored step 2" in r.stdout
    assert json.load(open(log))["n_failures"] == 1
    shutil.rmtree(tmp_path / "ckpt")
