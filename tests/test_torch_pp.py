"""Pipeline parallelism of the port (``core.pipeline``: the JAX package's
tick tables run on torch.distributed point-to-point over a ``pipe`` mesh
axis, composed with FSDP2 and tensor parallelism) against the JAX
package, on gloo process groups on the CPU.

The tables (``tick_table``, ``op_tick_counts``, ``simulate``) are held to
JAX's, which are pure Python.  Each world (2 and 4 processes) is spawned
once and runs all its cases: a probe step at lr 0 (its first moments are
the clipped gradients, its grad_norm the global one), then three AdamW
steps, from the same numpy weights and batches as JAX's single-device
``make_train_step`` trajectory, held to the bars of
``tests/test_torch_fsdp.py`` (against JAX floored as in
``tests/test_torch_tp.py``: at 4 layers the port's own single-device
qwen3 step differs from JAX's first moments by 1.6e-4 of scale, and
rwkv6's as there) and against the port's own single-device step at those
bars as they are.  Every rank reports the ops it ran and the
most microbatch graphs it held, held to the reference's table.  The
pipeline refusals copied from ``_check_pipeline`` raise JAX's messages.
Spawned workers import only torch, the port and ``test_torch_fsdp``'s
helpers; JAX runs in the test process.
"""
import dataclasses
import datetime
import functools
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_fsdp import (F32_BARS, LOW_BARS, LR, STEPS, S, _batches,
                             _compare, _errors, _jax_trajectory, _jax_tree,
                             _join, _leaves, _port_trajectory, _scales,
                             _stop, start_ranks)
from test_torch_tp import _floored
from test_torch_fsdp import _few_threads  # noqa: F401

QWEN = ("qwen3-0.6b", dict(n_kv_heads=2, n_layers=4), 0.0)
LLAMA = ("llama2-1b", {}, 0.1)
RWKV = ("rwkv6-1.6b", {}, 0.1)
# sinusoidal positions, added on the first stage only; layernorm, GELU,
# MQA with qkv bias
GRANITE = ("granite-20b", {}, 0.1)
# (spec, arch, config overrides, weight decay)
WORLDS = {
    2: [("fsdp_pp2_mb4", *QWEN), ("fsdp_pp2_mb4_1f1b", *QWEN),
        ("fsdp_pp2_mb4_1f1b_i2", *QWEN), ("fsdp_pp2_mb4_zb", *QWEN),
        ("fsdp_pp2_mb4_bf16", *QWEN), ("fsdp_pp2_mb4_fp8", *QWEN),
        ("fsdp_pp2_mb4", *LLAMA), ("fsdp_pp2_mb4", *RWKV),
        ("fsdp_pp2_mb4_1f1b", *RWKV), ("fsdp_pp2_mb4_1f1b", *GRANITE)],
    # pipe 2 x data 2; pipe 2 x model 2; four stages of one layer; two
    # grad-accumulation microbatches, each split into four
    4: [("fsdp_pp2_mb4", *QWEN), ("fsdp_tp2_pp2_mb4", *QWEN),
        ("fsdp_tp2_pp2_mb4_1f1b", *QWEN), ("fsdp_pp4_mb8_zb", *QWEN),
        ("fsdp_pp2_mb4_ga2", *QWEN)],
}
CASES = [(n, i) for n, cases in WORLDS.items() for i in range(len(cases))]
# the probe step's first moments (0.1 x the clipped gradient) against the
# unsharded port's, relative to each leaf's scale: the f32 gradient bar of
# chip_smoke.py and tests/test_torch_cuda.py; bf16 at its bar there
GRAD_REL = {"f32": 1e-4, "bf16": 0.15}
SPAWN_TIMEOUT = 300
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
# every spawned process (the ranks of a world, and the process that
# computes the port's single-device references) runs torch on one thread
WORLD_THREADS = 1
# the 2-process world runs this case once more after its cases: the port's
# pipelined step must give the same bits again (a rank carrying state
# from case to case, or a message matched to the wrong receive, would not)
REPEAT = 0


def _precision(spec):
    tail = spec.rsplit("_", 1)[-1]
    return tail if tail in ("bf16", "fp8") else "f32"


# ---------------------------------------------------------------------------
# the tick tables against the JAX package's
# ---------------------------------------------------------------------------

SCHEDS = ["gpipe", "1f1b", "1f1b_i2", "1f1b_i3", "zb"]
SIZES = [(2, 2), (2, 4), (4, 8), (4, 13), (8, 16)]


@pytest.mark.parametrize("P,M", SIZES)
@pytest.mark.parametrize("sched", SCHEDS)
def test_tick_tables_match_jax(sched, P, M):
    """``tick_table``, ``op_tick_counts`` and ``simulate`` equal JAX's, and
    a schedule that cannot run (M) raises in both; the executor's
    (op, chunk, microbatch) table has JAX's per-tick ops, and the copied
    forward-only table and per-stage depths equal JAX's on it."""
    from repro.core import pipeline as jpipe
    from repro_torch.core import pipeline as pipe
    try:
        want = jpipe.get_schedule(sched).tick_table(P, M)
    except ValueError:
        with pytest.raises(ValueError):
            pipe.get_schedule(sched).tick_table(P, M)
        return
    mine = pipe.get_schedule(sched)
    assert mine.tick_table(P, M) == want
    assert pipe.op_tick_counts(sched, P, M) == \
        jpipe.op_tick_counts(sched, P, M)
    assert mine.simulate(P, M) == jpipe.get_schedule(sched).simulate(P, M)
    assert [[op for op, _, _ in row] for row in pipe.full_table(sched, P, M)] \
        == [[op for op, _ in row] for row in want]
    assert max(pipe.peak_held(sched, P, M, r) for r in range(P)) == \
        jpipe.inflight_microbatches(P, M, sched)
    v, full = pipe.virtual_stages(sched), pipe.full_table(sched, P, M)
    assert pipe._ring_depths(full, P, M, v) == \
        jpipe._ring_depths(full, P, M, v)
    assert pipe._fwd_only_table(P, M, v) == jpipe._fwd_only_table(P, M, v)


# ---------------------------------------------------------------------------
# refusals copied from the JAX package's _check_pipeline and to_plan
# ---------------------------------------------------------------------------

# (spec, arch, config overrides, devices, global batch)
REFUSALS = {
    "uneven_stages": ("fsdp_pp3_mb3", "qwen3-0.6b", {}, 6, 6),
    "uneven_chunks": ("fsdp_pp2_mb4_1f1b_i3", "qwen3-0.6b", {}, 8, 8),
    "non_uniform": ("fsdp_pp2_mb4", "qwen3-0.6b",
                    dict(mixer="rwkv6", attn_every=2), 8, 8),
    "mrope": ("fsdp_pp2_mb4", "qwen3-0.6b", dict(rope="mrope"), 8, 8),
    "tp_on_rwkv6": ("fsdp_tp2_pp2_mb4", "rwkv6-1.6b", {}, 8, 8),
    "tp_heads": ("fsdp_tp4_pp2_mb4", "qwen3-0.6b", dict(n_kv_heads=2), 8,
                 8),
    "batch": ("fsdp_pp2_mb4_ga2", "qwen3-0.6b", {}, 8, 12),
}
MALFORMED = ["fsdp_pp4_mb2", "fsdp_pp2_mb3_1f1b_i2", "fsdp_1f1b"]


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_pipeline_refusals_raise_jax_messages(name):
    from repro import strategy as jstrategy
    from repro.configs import ShapeConfig as JShapeConfig
    from repro.configs import get_config as jax_get_config
    from repro_torch import strategy
    from repro_torch.configs import ShapeConfig, get_config
    spec, arch, over, n, B = REFUSALS[name]
    cfg = dataclasses.replace(get_config(arch), **over)
    jcfg = dataclasses.replace(jax_get_config(arch), **over)
    with pytest.raises(jstrategy.StrategyError) as want:
        jstrategy.parse(spec).to_plan(
            jcfg, jstrategy.host_topology(n_devices=n),
            JShapeConfig("t", 512, B, "train"), abstract=True)
    with pytest.raises(strategy.StrategyError) as got:
        strategy.parse(spec).to_plan(
            cfg, strategy.host_topology(n_devices=n),
            ShapeConfig("t", 512, B, "train"), abstract=True)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", MALFORMED)
def test_pipeline_specs_refused_at_parse_as_in_jax(spec):
    from repro import strategy as jstrategy
    from repro_torch import strategy
    with pytest.raises(jstrategy.StrategyError) as want:
        jstrategy.parse(spec)
    with pytest.raises(strategy.StrategyError) as got:
        strategy.parse(spec)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the spawned worlds (torch and the port only)
# ---------------------------------------------------------------------------

def _case_cfg(arch, over):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **over)


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
    cfg = _case_cfg(arch, over)
    s = strategy.parse(spec)
    B = case["batches"][0]["labels"].shape[0]
    shape = ShapeConfig("test", S, B, "train")
    plan = s.to_plan(cfg, strategy.host_topology(), shape)
    rt = par.make_runtime(cfg, plan, shape, remat=False)
    params = par.apply_plan(params_from_jax(case["tree"]), plan, cfg)
    wired = [n for n, p in params.named_parameters()
             if type(p.to_local()) is par.Fp8Wire]

    def steps(lr, batches):
        state = init_opt_state(params)
        step = make_train_step(cfg, rt, TrainConfig(
            steps=STEPS, warmup=1, grad_accum=s.grad_accum,
            opt=AdamWConfig(lr=lr, weight_decay=wd)), plan)
        metrics, runs = [], []
        for b in batches:
            _, state, m = step(params, state, {k: torch.tensor(v)
                                               for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            runs.append((step.last_run.ops, step.last_run.peak_held))
        return state, metrics, runs

    # lr 0 leaves the weights as they are: m = 0.1 x the clipped gradient
    probe_state, probe, _ = steps(0.0, case["batches"][:1])
    probe_m = opt_state_to_jax(probe_state, cfg, rt.pipe_group)["m"]
    state, metrics, runs = steps(LR, case["batches"])
    out = dict(metrics=metrics, params=params_to_jax(params, cfg,
                                                     rt.pipe_group),
               m=opt_state_to_jax(state, cfg, rt.pipe_group)["m"],
               probe=probe[0], probe_m=probe_m, runs=runs,
               pipe_rank=rt.pipe_rank, pipe=rt.pipe_size,
               layers=sorted({int(n.split(".")[1]) for n, _ in
                              params.named_parameters()
                              if n.startswith("layers.")}),
               gather_dtype=rt.gather_dtype, wired=wired)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, out)
    return everyone if rank == 0 else None


def _world(rank, n, payload, out):
    torch.set_num_threads(WORLD_THREADS)
    dist.init_process_group("gloo", init_method=f"file://{out}.store",
                            rank=rank, world_size=n, timeout=GROUP_TIMEOUT)
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
# the references (test process)
# ---------------------------------------------------------------------------

def _inputs(case, n):
    """A case's initial weights (JAX's init, as numpy) and batches: 2 rows
    a data-parallel rank a pipeline microbatch."""
    from repro_torch import strategy
    spec, arch, over, _ = case
    jc, tree = _jax_tree(arch, over)
    s = strategy.parse(spec)
    dp = n // (s.tp * s.pp)
    B = 2 * dp * s.microbatches * s.grad_accum
    return dict(tree=tree, batches=_batches(jc.vocab_size, B, 2,
                                            s.grad_accum, seed=n))


def _reference_spec(spec):
    """The single-device strategy whose numerics the pipelined run must
    give: the same precision, except that fp8's stage layers gather at f32
    in the reference (no wire), which leaves bf16's numerics."""
    from repro_torch import strategy
    s = strategy.parse(spec)
    if s.precision == "fp8":
        s = dataclasses.replace(s, precision="bf16")
    return s


def _jax_reference(item):
    """JAX's single-device trajectory of a payload item (test process)."""
    spec, arch, over, wd = item["case"]
    return _jax_trajectory((spec, None, arch, over, wd),
                           _reference_spec(spec), tree=item["tree"],
                           batches=item["batches"])


def _port_reference(item):
    """(the port's single-device trajectory, its probe step) of a payload
    item, from the same numpy weights and batches as the world's."""
    spec, arch, over, wd = item["case"]
    s = _reference_spec(spec)
    inp = dict(tree=item["tree"], batches=item["batches"])
    return (_port_trajectory((spec, None, arch, over, wd), s, **inp),
            _port_probe(item["case"], s, inp))


def _port_references(_index, payload, out):
    """Spawned: the port's single-device references of every payload item,
    at the worlds' thread count.  They are the bar the pipelined ranks are
    held to at the f32 bars, and Adam turns a rounding change of them into
    lr-sized steps (a near-zero gradient's sign), so they are computed
    where nothing else sets their rounding: not in the test process,
    whose thread pool and history (the JAX oracle, other test files) it
    does not control."""
    torch.set_num_threads(WORLD_THREADS)
    with open(payload, "rb") as f:
        items = pickle.load(f)
    refs = [_port_reference(item) for item in items]
    with open(out, "wb") as f:
        pickle.dump(refs, f)


def _port_probe(case, s, inp):
    """The unsharded port's step at lr 0 on the first batch: its metrics
    and first moments."""
    from repro_torch.bridge import opt_state_to_jax, params_from_jax
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    _, arch, over, wd = case
    cfg = _case_cfg(arch, over)
    rt = Runtime(compute_dtype=torch.float32 if s.precision == "f32"
                 else torch.bfloat16)
    params = params_from_jax(inp["tree"])
    state = init_opt_state(params)
    step = make_train_step(cfg, rt, TrainConfig(
        steps=STEPS, warmup=1, grad_accum=s.grad_accum,
        opt=AdamWConfig(lr=0.0, weight_decay=wd)))
    _, state, m = step(params, state, {k: torch.tensor(v) for k, v in
                                       inp["batches"][0].items()})
    return dict(metrics={k: float(v) for k, v in m.items()},
                m=opt_state_to_jax(state, cfg)["m"])


def _jax_rows(spec):
    """Each pipe rank's ops under JAX's table, idle ticks left out, as
    (op, chunk, microbatch)."""
    from repro.core import pipeline as jpipe
    from repro_torch import strategy
    s = strategy.parse(spec)
    sched = jpipe.get_schedule(s.sched)
    if hasattr(sched, "_full_table"):
        table = sched._full_table(s.pp, s.microbatches)
    else:
        table = [[(op, 0, j) for op, j in row]
                 for row in sched.tick_table(s.pp, s.microbatches)]
    return [[row[r] for row in table if row[r][0] != "idle"]
            for r in range(s.pp)]


def _start_port_references(d):
    return start_ranks(_port_references, (str(d / "payload.pkl"),
                                          str(d / "port_refs.pkl")), 1)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: [(case, every rank's result, references)], 'repeat': the
    2-process world's results of case REPEAT, run first and last,
    'payload': its payload file}.  Every world is spawned at once, each
    running all its cases, beside a process per world computing the
    port's single-device references from the same payload, while this
    process computes JAX's."""
    started, refs, out = {}, {}, {}
    try:
        for n, cases in WORLDS.items():
            d = tmp_path_factory.mktemp(f"ppworld{n}")
            payload = [dict(case=c, **_inputs(c, n)) for c in cases]
            with open(d / "payload.pkl", "wb") as f:
                pickle.dump(payload, f)
            runs = payload + ([payload[REPEAT]] if n == 2 else [])
            with open(d / "runs.pkl", "wb") as f:
                pickle.dump(runs, f)
            started[n] = (d, start_ranks(
                _world, (n, str(d / "runs.pkl"), str(d / "out.pkl")), n),
                _start_port_references(d))
            refs[n] = [_jax_reference(item) for item in payload]
        deadline = time.time() + SPAWN_TIMEOUT
        for n, (d, ctx, port_ctx) in started.items():
            _join(n, ctx, deadline)
            _join(n, port_ctx, deadline)
            with open(d / "out.pkl", "rb") as f:
                got = pickle.load(f)
            with open(d / "port_refs.pkl", "rb") as f:
                ports = pickle.load(f)
            if n == 2:
                out["repeat"] = (got[REPEAT], got.pop())
                out["payload"] = d / "payload.pkl"
            out[n] = list(zip(WORLDS[n], got, [
                (j, port, probe) for j, (port, probe) in zip(
                    refs[n], ports, strict=True)], strict=True))
        return out
    finally:
        for _, ctx, port_ctx in started.values():
            _stop(ctx)
            _stop(port_ctx)


def test_a_case_run_twice_in_a_world_gives_the_same_bits(worlds):
    """Case REPEAT of the 2-process world, run first and again after the
    world's other cases: every rank's metrics, parameters, first moments,
    ops and held graphs are the same bits both times."""
    first, again = worlds["repeat"]
    for a, b in zip(first, again, strict=True):
        assert a["metrics"] == b["metrics"] and a["probe"] == b["probe"]
        assert a["runs"] == b["runs"]
        for key in ("params", "m", "probe_m"):
            for (path, x), (_, y) in zip(_leaves(a[key]), _leaves(b[key]),
                                         strict=True):
                assert np.array_equal(x, y), (key, path)


def test_port_references_do_not_depend_on_the_test_process(worlds,
                                                          tmp_path):
    """The port's single-device references are the same bits when they
    are computed again in a fresh process while this one runs torch at
    another thread count: whatever this process's state, the bar the
    pipelined ranks are held to stays put."""
    n = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        with open(worlds["payload"], "rb") as f:
            items = pickle.load(f)
        with open(tmp_path / "payload.pkl", "wb") as f:
            pickle.dump(items[REPEAT:REPEAT + 1], f)
        ctx = _start_port_references(tmp_path)
        try:
            _join(1, ctx, time.time() + SPAWN_TIMEOUT)
        finally:
            _stop(ctx)
    finally:
        torch.set_num_threads(n)
    with open(tmp_path / "port_refs.pkl", "rb") as f:
        (port, probe), = pickle.load(f)
    _, want_port, want_probe = worlds[2][REPEAT][2]
    assert port["metrics"] == want_port["metrics"]
    assert probe["metrics"] == want_probe["metrics"]
    for got, want in ((port, want_port), (probe, want_probe)):
        for key in set(got) - {"metrics"}:
            for (path, x), (_, y) in zip(_leaves(got[key]),
                                         _leaves(want[key]), strict=True):
                assert np.array_equal(x, y), (key, path)


def _ids(case):
    n, i = case
    return f"{n}-{WORLDS[n][i][0]}-{WORLDS[n][i][1]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_pipelined_steps_match_the_jax_trajectory(worlds, case):
    """Three AdamW steps on every rank against JAX's single-device
    trajectory and the port's own: f32 at the f32 bars, bf16 (and fp8,
    whose stage layers take no wire) at the bars measured for bf16; the
    bars against JAX floored at ``test_torch_tp.FLOOR`` times what the
    port's single-device step and JAX's differ by on the case.  The loss
    is the same on every rank."""
    n, i = case
    spec, ranks, (jax_ref, port_ref, _) = worlds[n][i][0][0], \
        worlds[n][i][1], worlds[n][i][2]
    precision = _precision(spec)
    floor = _errors(port_ref, jax_ref)
    for ref, side in ((jax_ref, "jax"), (port_ref, "port")):
        bars = (F32_BARS if precision == "f32"
                else LOW_BARS["bf16", side])
        if side == "jax":
            bars = _floored(bars, floor)
        for got in ranks:
            _compare(got, ref, bars, (n, spec, side, got["pipe_rank"]))
    for got in ranks[1:]:
        assert got["metrics"] == ranks[0]["metrics"], (n, spec)
    assert np.isfinite(ranks[0]["metrics"][-1]["loss"])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_ranks_run_their_table_column(worlds, case):
    """Every step, each rank ran exactly its column of JAX's table (idle
    ticks left out; ``zb``'s W included), held at most as many
    microbatch graphs as that column does, and the most over the ranks is
    ``inflight_microbatches``; it kept only its stages' layers."""
    from repro.core import pipeline as jpipe
    from repro_torch import strategy
    from repro_torch.core import pipeline as pipe
    n, i = case
    (spec, arch, over, _), ranks, _ = worlds[n][i]
    s = strategy.parse(spec)
    rows = _jax_rows(spec)
    cfg = _case_cfg(arch, over)
    peaks = set()
    for got in ranks:
        r = got["pipe_rank"]
        assert got["pipe"] == s.pp
        for ops, peak in got["runs"]:
            assert [tuple(op) for op in ops] == rows[r], (spec, r)
            assert peak == pipe.peak_held(s.sched, s.pp, s.microbatches, r)
            peaks.add(peak)
        assert got["layers"] == sorted(sum(pipe.stage_layers(
            cfg.n_layers, s.pp, pipe.virtual_stages(s.sched), r), []))
    assert max(peaks) == jpipe.inflight_microbatches(s.pp, s.microbatches,
                                                     s.sched)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gradients_and_their_norm_match_one_device(worlds, case):
    """The probe step (lr 0): the gradient norm equals the unsharded one
    (the layers' squares summed over the pipe group, every replicated leaf
    counted once), and every first moment (0.1 x the clipped gradient)
    equals the unsharded port's — ``embed.tok`` of tied qwen3 included,
    whose lookup (first stage) and head (last stage) parts are summed over
    the pipe group once."""
    n, i = case
    spec, ranks, (_, _, probe) = worlds[n][i][0][0], worlds[n][i][1], \
        worlds[n][i][2]
    precision = _precision(spec)
    rel = GRAD_REL["f32" if precision == "f32" else "bf16"]
    want = probe["metrics"]["grad_norm"]
    for got in ranks:
        norm = got["probe"]["grad_norm"]
        assert abs(norm - want) <= (1e-5 if precision == "f32" else 2e-2) \
            * want, (spec, norm, want)
        scales = _scales(probe["m"])
        for (path, a), (_, b) in zip(_leaves(got["probe_m"]),
                                     _leaves(probe["m"]), strict=True):
            assert np.max(np.abs(a - b)) <= rel * scales[path], (spec, path)


def test_fp8_leaves_pipelined_stage_layers_unrounded(worlds):
    """Under a pipeline the fp8 policy neither wires nor rounds the stage
    layers (the JAX stage body gathers them at f32): no ``Fp8Wire``
    shard, no ``gather_dtype``, and the run gives the bf16 policy's
    numbers bit for bit."""
    by_spec = {c[0]: ranks for c, ranks, _ in worlds[2]
               if c[1] == QWEN[0]}
    fp8, bf16 = by_spec["fsdp_pp2_mb4_fp8"], by_spec["fsdp_pp2_mb4_bf16"]
    for a, b in zip(fp8, bf16, strict=True):
        assert a["gather_dtype"] is None and not a["wired"]
        assert a["metrics"] == b["metrics"]
        for (path, x), (_, y) in zip(_leaves(a["params"]),
                                     _leaves(b["params"]), strict=True):
            assert np.array_equal(x, y), path


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _one_rank_losses():
    from test_torch_strategy import TRAIN, _losses, _run
    one = _run([*TRAIN, "--strategy", "fsdp"])
    assert one.returncode == 0, one.stderr[-3000:]
    return _losses(one.stdout)


# (spec, ranks, the mesh the [strategy] line prints)
CLI = [("fsdp_pp2_mb4", 2, {"pipe": 2, "data": 1, "model": 1}),
       ("fsdp_pp2_mb4_1f1b", 2, {"pipe": 2, "data": 1, "model": 1}),
       ("fsdp_pp2_mb4_zb", 2, {"pipe": 2, "data": 1, "model": 1}),
       ("fsdp_tp2_pp2_mb4", 4, {"pipe": 2, "data": 1, "model": 2})]


@pytest.mark.parametrize("spec,ranks,mesh", CLI)
def test_cli_pp_on_gloo_ranks_matches_one_rank(spec, ranks, mesh):
    """``torchrun --nproc_per_node <ranks> ... --strategy <spec>`` trains
    pipeline stages (with tensor parallelism inside them on 4 ranks) with
    the losses of one unsharded rank.  The CLI's reduced configs have 2
    layers, too few for ``1f1b_i2``'s 4 chunks: the worlds above run it
    at 4 layers through the same functions."""
    from test_torch_strategy import TRAIN, _losses, _run
    got = _run(["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(ranks), *TRAIN, "--strategy", spec])
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.count(f"[strategy] {spec} on host") == 1
    assert str(mesh) in got.stdout
    got, want = _losses(got.stdout), _one_rank_losses()
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (got, want)


def test_a_batch_that_does_not_split_into_microbatches_is_refused():
    """As the JAX train step refuses it (``train/trainer.py``): the batch
    over grad_accum must split into the pipeline microbatches, checked
    before any op runs."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    cfg = _case_cfg(*QWEN[:2])
    rt = Runtime(pipe_size=2, pipe_microbatches=4, pipe_schedule="1f1b")
    params = tfm.init_params(cfg, 0, "cpu")
    step = make_train_step(cfg, rt, TrainConfig(steps=1, grad_accum=2))
    toks = torch.zeros((12, S), dtype=torch.int32)
    with pytest.raises(ValueError, match="batch 12 / grad_accum 2 does not "
                       "split into 4 pipeline microbatches"):
        step(params, init_opt_state(params), {"tokens": toks,
                                              "labels": toks})
