"""Data-parallel training of the port (FSDP2 over a ``DeviceMesh``) against
the JAX package's single-device trajectory, on gloo process groups on the
CPU.

Each world (2, 3 and 4 processes) is spawned once and runs all its cases:
three AdamW steps of a 2-layer model under a strategy spec, from the same
numpy weights (``bridge``) and batches as a JAX ``make_train_step``
trajectory on one device.  Every batch masks most labels of the rows one
rank takes, so a rank-local mean, or a rank taking the wrong rows of a
microbatch, would move the loss.  The JAX package's own sharded-vs-single
test (``tests/test_spmd.py``) is red for some archs on this jax, so the
single-device step is the oracle: the port's shards answer to the same
math.  Spawned workers import only torch and the port; JAX runs in the
test process (imports inside the oracle).
"""
import ast
import dataclasses
import functools
import os
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

STEPS, S, LR = 3, 32, 1e-3
# f32: loss, nll, ntok and grad_norm within 1e-5 relative, moments 1e-4 of
# each leaf's scale, parameters in units of lr (max < 0.5, mean < 1e-3):
# the bars of tests/test_torch_train.py::test_train_step_trajectory_matches_jax
F32_BARS = dict(metric=1e-5, moment=1e-4, lr_max=0.5, lr_mean=1e-3)
# bf16 and fp8, against JAX (XLA-CPU and torch-CPU round bf16 ops in
# other orders, see test_torch_precision.py) and against the port's own
# single-device step (the same rounding but for the order of the
# cross-rank sums): measured on 2 ranks at 2 layers, the observed worst
# over three steps in brackets.  Adam turns a rounding difference in a
# near-zero gradient into a full +-lr step, so lr_max stays loose and
# lr_mean carries the check; fp8 rounds every layer gradient to 3
# mantissa bits, one flip of which moves a moment by 1/8 of its value.
LOW_BARS = {
    ("bf16", "jax"): dict(metric=5e-3, moment=0.1, lr_max=8.0,
                          lr_mean=0.1),        # (1.1e-3, 0.038, 4.1, 0.035)
    ("bf16", "port"): dict(metric=2e-3, moment=0.05, lr_max=4.0,
                           lr_mean=0.03),      # (5.0e-4, 0.018, 2.0, 0.010)
    ("fp8", "jax"): dict(metric=3e-3, moment=0.6, lr_max=8.0,
                         lr_mean=0.2),         # (6.9e-4, 0.28, 3.8, 0.064)
    ("fp8", "port"): dict(metric=2e-3, moment=0.5, lr_max=6.0,
                          lr_mean=0.1),        # (4.4e-4, 0.24, 3.0, 0.032)
}
# (spec, (n_devices, island) of a test-built Topology or None for the
# host topology, arch, config overrides, weight decay)
QWEN = ("qwen3-0.6b", dict(n_kv_heads=2), 0.0)   # see STACKED_1D there
LLAMA = ("llama2-1b", {}, 0.1)
WORLDS = {
    2: [("fsdp", None, *QWEN), ("ddp", None, *QWEN), ("fsdp_z2", None, *QWEN),
        ("fsdp_ovl", None, *QWEN), ("fsdp_ga2", None, *QWEN),
        ("fsdp_bf16", None, *QWEN), ("fsdp_fp8", None, *QWEN),
        # microbatches of one row: computed whole on both ranks
        ("fsdp_z2_ga4", None, *QWEN)],
    # d_model 256 and vocab 512 do not divide by 3
    3: [("fsdp", None, *LLAMA), ("ddp", None, *LLAMA),
        ("hsdp_z2_ga2", None, *QWEN)],
    4: [("hsdp", (4, 2), *QWEN), ("hsdp_z0", (4, 2), *QWEN)],
}
SPAWN_TIMEOUT = 240
# torch's intra-op threads in every test process that runs the port (the
# gloo ranks run at 1).  Six xdist workers, the ranks they start and
# XLA's pools share the host's cores; torch's default, a thread a core,
# multiplied their contention.  2, not 1: the whole suite ran faster at 2
# on an 8-CPU host, and the bars of the modules that pinned 2 before were
# measured there (at 1, test_torch_moe_model's deepseek gradients miss
# their 1e-4 by 7 %).  CPU threads only: a card's kernels do not use them.
TEST_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Every ``tests/test_torch_*.py`` module imports this fixture
    (``test_every_port_test_module_pins_the_threads``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(n)


def cli_env():
    """The environment of a port CLI that a test runs as a subprocess:
    the port on the path, torch at ``TEST_THREADS`` (``OMP_NUM_THREADS``,
    which torchrun hands each rank)."""
    return {**os.environ, "OMP_NUM_THREADS": str(TEST_THREADS),
            "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")}


def start_ranks(fn, args, n):
    """``mp.start_processes`` of ``n`` ranks running ``fn(rank, *args)``,
    not joined: each a fresh process forked from the dry run's preloaded
    server (``launch.dryrun.fresh_context``), so no rank imports torch and
    the port again."""
    from repro_torch.launch import dryrun
    dryrun.fresh_context()
    return mp.start_processes(fn, args=args, nprocs=n, join=False,
                              start_method="forkserver")


def _batches(vocab, B, n, ga, seed):
    """Three global batches; in each microbatch, 3/4 of the labels of the
    rows rank 1 takes are masked."""
    rng = np.random.default_rng(seed)
    out = []
    mb = B // ga
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        labels = toks[:, 1:].copy()
        for i in range(ga):
            r0 = i * mb + mb // n
            labels[r0:r0 + mb // n, S // 4:] = -1
        out.append({"tokens": toks[:, :-1], "labels": labels})
    return out


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
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import make_train_step

    spec, topo_kw, arch, over, wd = case["case"]
    n = dist.get_world_size()
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    topo = (strategy.Topology("test", *topo_kw) if topo_kw
            else strategy.host_topology())
    s = strategy.parse(spec)
    B = case["batches"][0]["labels"].shape[0]
    shape = ShapeConfig("test", S, B, "train")
    plan = s.to_plan(cfg, topo, shape)
    rt = par.make_runtime(cfg, plan, shape, remat=False)
    params = par.apply_plan(params_from_jax(case["tree"]), plan, cfg)
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
        local[name] = (p.to_local().numel(), tuple(p.shape),
                       state["m"][name].to_local().numel(),
                       p.dtype, state["m"][name].dtype)
    shares = [None] * n
    dist.all_gather_object(shares, local)
    out = dict(metrics=metrics, params=params_to_jax(params, cfg),
               m=opt_state_to_jax(state, cfg)["m"], local=shares,
               fsdp_ranks=plan.axis_size(plan.fsdp),
               gathered=[par.all_gather_buffers(m) for m in
                         (*params.layers, params)])
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


def _start(n, payload, out):
    return start_ranks(_world, (n, str(payload), str(out)), n)


def _join(n, ctx, deadline):
    while not ctx.join(timeout=1):
        if time.time() > deadline:
            raise TimeoutError(f"world of {n} ranks still running after "
                               f"{SPAWN_TIMEOUT} s")


def _stop(ctx):
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
            p.join(10)


# ---------------------------------------------------------------------------
# the JAX single-device oracle (test process)
# ---------------------------------------------------------------------------

def _jax_config(arch, over):
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    return dataclasses.replace(jax_reduced(jax_get_config(arch)), **over)


def _jax_tree(arch, over):
    import jax

    from repro.models import transformer as jtfm
    jc = _jax_config(arch, over)
    return jc, jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(7)))


def _inputs(case, n):
    """A case's initial weights (JAX's init, as numpy) and batches."""
    from repro_torch import strategy
    _, _, arch, over, _ = case
    jc, tree = _jax_tree(arch, over)
    ga = strategy.parse(case[0]).grad_accum
    return dict(tree=tree, batches=_batches(jc.vocab_size, 2 * n, n, ga,
                                            seed=n))


def fp8_gather(lp):
    """The JAX package's per-layer gatherer (core/parallel.py
    make_param_gatherer) on one device: the fp8 wire's rounding."""
    import jax
    import jax.numpy as jnp
    return jax.tree.map(
        lambda x: x.astype(jnp.float8_e4m3fn).astype(jnp.bfloat16)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, lp)


def _make_jax_step(jc, jrt, grad_accum=1, wd=0.0):
    """JAX's ``make_train_step`` of a config and a runtime, jitted."""
    import jax

    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.train.trainer import TrainConfig as JTrainConfig
    from repro.train.trainer import make_train_step as jax_make_train_step
    return jax.jit(jax_make_train_step(jc, jrt, JTrainConfig(
        steps=STEPS, warmup=1, grad_accum=grad_accum,
        opt=JAdamWConfig(lr=LR, weight_decay=wd))))


# one jitted step for each (config, runtime, grad_accum, weight decay) a
# process: every reference of that key reuses its compiled programs
jax_train_step = functools.cache(_make_jax_step)


def jax_run(jstep, tree, batches):
    """Per-step metrics, final parameters and first moments of ``jstep``
    from ``tree`` over ``batches``."""
    import jax
    import jax.numpy as jnp

    from repro.optim import init_opt_state as jax_init_opt_state
    jtree, jstate, metrics = tree, jax_init_opt_state(tree), []
    for b in batches:
        jtree, jstate, m = jstep(jtree, jstate, {k: jnp.asarray(v)
                                                 for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, params=jax.tree.map(np.asarray, jtree),
                m=jax.tree.map(np.asarray, jstate["m"]))


def _jax_step_args(case, s):
    """A case's (JAX config, JAX runtime, grad_accum, weight decay)."""
    import jax.numpy as jnp

    from repro.models.layers import Runtime as JRuntime
    _, _, arch, over, wd = case
    kw = {}
    if s.precision != "f32":
        kw["compute_dtype"] = jnp.bfloat16
    if s.precision == "fp8" and s.zero:
        kw["gather_params"] = fp8_gather
    return _jax_config(arch, over), JRuntime(**kw), s.grad_accum, wd


def _jax_trajectory(case, s, tree, batches):
    """The JAX single-device trajectory: per-step metrics, final
    parameters and first moments."""
    return jax_run(jax_train_step(*_jax_step_args(case, s)), tree, batches)


def _port_trajectory(case, s, tree, batches):
    """The same trajectory through the port on one device, unsharded."""
    from repro_torch.bridge import (opt_state_to_jax, params_from_jax,
                                    params_to_jax)
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    _, _, arch, over, wd = case
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    rt = Runtime(compute_dtype=torch.float32 if s.precision == "f32"
                 else torch.bfloat16,
                 gather_dtype=torch.float8_e4m3fn
                 if s.precision == "fp8" and s.zero else None)
    params = params_from_jax(tree)
    state = init_opt_state(params)
    step = make_train_step(cfg, rt, TrainConfig(
        steps=STEPS, warmup=1, grad_accum=s.grad_accum,
        opt=AdamWConfig(lr=LR, weight_decay=wd)))
    metrics = []
    for b in batches:
        _, state, m = step(params, state, {k: torch.tensor(v)
                                           for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, params=params_to_jax(params, cfg),
                m=opt_state_to_jax(state, cfg)["m"])


def _references(case, n, s, cache={}):
    """(JAX trajectory, port single-device trajectory or None for f32);
    cases that share weights, batches and numerics share them."""
    spec, _, arch, over, wd = case
    key = (arch, tuple(sorted(over.items())), wd, s.grad_accum, s.precision,
           s.precision == "fp8" and s.zero > 0, n)
    if key not in cache:
        inp = _inputs(case, n)
        cache[key] = (_jax_trajectory(case, s, **inp),
                      _port_trajectory(case, s, **inp)
                      if s.precision != "f32" else None)
    return cache[key]


def _leaves(tree):
    import jax
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float32)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _scales(tree):
    """{leaf path: the scale (max |x|) a leaf's error is measured against}:
    its own; but a key bias's (``bk``) gradient and moments are zero but
    for rounding — adding bk adds q·bk to every score of a query, which
    its softmax ignores — so it takes the query bias's scale beside it."""
    own = {p: max(float(np.max(np.abs(x))), 1e-30) for p, x in _leaves(tree)}
    return {p: own[p[:-len("['bk']")] + "['bq']"]
            if p.endswith("['bk']") else v for p, v in own.items()}


def _errors(got, want):
    """The worst differences of a trajectory from a reference: metrics
    (relative beyond 1), first moments (relative to each leaf's scale,
    :func:`_scales`), and parameters in units of lr (max and mean per
    leaf; a key bias, moved by Adam from a gradient of rounding noise in
    every entry, by its max only)."""
    err = dict(metric=0.0, moment=0.0, lr_max=0.0, lr_mean=0.0)
    for m, ref in zip(got["metrics"], want["metrics"], strict=True):
        assert abs(m["lr"] - ref["lr"]) < 1e-10
        for k in ("loss", "nll", "ntok", "grad_norm"):
            err["metric"] = max(err["metric"], abs(m[k] - ref[k])
                                / max(1.0, abs(ref[k])))
    scales = _scales(want["m"])
    for (path, a), (_, b) in zip(_leaves(got["m"]), _leaves(want["m"]),
                                 strict=True):
        err["moment"] = max(err["moment"],
                            np.max(np.abs(a - b)) / scales[path])
    for (path, a), (_, b) in zip(_leaves(got["params"]),
                                 _leaves(want["params"]), strict=True):
        d = np.abs(a - b) / LR
        err["lr_max"] = max(err["lr_max"], d.max())
        if not path.endswith("['bk']"):
            err["lr_mean"] = max(err["lr_mean"], d.mean())
    return err


def _compare(got, want, bars, what):
    err = _errors(got, want)
    assert all(err[k] < bars[k] for k in bars), (what, err, bars)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: [(case, port result, (JAX, port single-device reference))]}.
    Every world is spawned at once, each running all its cases, while
    this process computes the references."""
    from repro_torch import strategy
    started, refs = {}, {}
    try:
        for n, cases in WORLDS.items():
            d = tmp_path_factory.mktemp(f"world{n}")
            payload = [dict(case=c, **_inputs(c, n)) for c in cases]
            with open(d / "payload.pkl", "wb") as f:
                pickle.dump(payload, f)
            started[n] = (d / "out.pkl", _start(n, d / "payload.pkl",
                                                 d / "out.pkl"))
        for n, cases in WORLDS.items():
            refs[n] = [_references(c, n, strategy.parse(c[0]))
                       for c in cases]
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


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_sharded_steps_match_the_jax_trajectory(worlds, n):
    """f32 at the f32 bars; bf16 and fp8 at the bars measured for them,
    against JAX and against the port's own single-device step."""
    for case, got, (jax_ref, port_ref) in worlds[n]:
        precision = case[0].rsplit("_", 1)[-1]
        if port_ref is None:
            _compare(got, jax_ref, F32_BARS, (n, case[0], "jax"))
        else:
            _compare(got, jax_ref, LOW_BARS[precision, "jax"],
                     (n, case[0], "jax"))
            _compare(got, port_ref, LOW_BARS[precision, "port"],
                     (n, case[0], "port"))
        assert np.isfinite(got["metrics"][-1]["loss"])


def _wire_bytes(gathered, spec):
    """The layers' and the root unit's all-gather buffers ({dtype:
    bytes} each) of one run, checked for their dtypes: under fp8 each
    layer's in one byte an element (float8_e4m3fn on NCCL; gloo, which has
    no float8 type, carries the same bytes as uint8), else f32; the root
    unit's in f32 -> (bytes per layer, root bytes)."""
    *per_layer, root = gathered
    wire = {torch.float8_e4m3fn, torch.uint8} if "fp8" in spec \
        else {torch.float32}
    for g in per_layer:
        assert len(g) == 1 and set(g) <= wire, (spec, g)
    assert set(root) == {torch.float32}, (spec, root)
    return [sum(g.values()) for g in per_layer], sum(root.values())


def test_fp8_wire_gathers_a_quarter_of_the_f32_bytes(worlds):
    """Under ``fsdp_fp8`` each layer's FSDP2 all-gather moves one byte an
    element, a quarter of what ``fsdp`` moves for the same layer in f32;
    the root unit (embedding, final norm) gathers f32 under both."""
    by_spec = {c[0]: got for c, got, _ in worlds[2]}
    f32, root32 = _wire_bytes(by_spec["fsdp"]["gathered"], "fsdp")
    fp8, root8 = _wire_bytes(by_spec["fsdp_fp8"]["gathered"], "fsdp_fp8")
    assert [4 * b for b in fp8] == f32 and root8 == root32


def test_overlap_prefetch_changes_no_bit(worlds):
    by_spec = {c[0]: got for c, got, _ in worlds[2]}
    a, b = by_spec["fsdp"], by_spec["fsdp_ovl"]
    assert a["metrics"] == b["metrics"]
    for (path, x), (_, y) in zip(_leaves(a["params"]), _leaves(b["params"])):
        assert np.array_equal(x, y), path


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_ranks_hold_their_share_of_parameters_and_moments(worlds, n):
    """ZeRO-2/3 ranks hold about 1/k of each leaf over a shard group of k
    (dim 0 split in k, the last chunks shorter or empty), the moments as
    their parameter, in f32; ddp ranks the whole.  Over the ranks the
    shards add up to the leaf once per replica."""
    for case, got, _ in worlds[n]:
        k = got["fsdp_ranks"]
        for name in got["local"][0]:
            per_rank = [r[name] for r in got["local"]]
            shape, dtype, mdtype = per_rank[0][1], *per_rank[0][3:]
            total = int(np.prod(shape))
            share = -(-shape[0] // k) * total // shape[0]
            assert dtype == mdtype == torch.float32, (case[0], name)
            for local, shp, m_local, _, _ in per_rank:
                assert m_local == local and shp == shape, (case[0], name)
                assert local == total if k == 1 else local <= share, \
                    (case[0], name, local, share)
            assert sum(r[0] for r in per_rank) == total * (n // k), \
                (case[0], name)


def _jax_modules(rank, out):
    """A rank's modules of JAX and of the JAX package, into ``out``."""
    import sys
    with open(f"{out}.{rank}", "w") as f:
        f.write(" ".join(m for m in sys.modules if m in ("jax", "repro")
                         or m.startswith(("jax.", "jaxlib", "repro."))))


def test_ranks_import_no_jax(tmp_path):
    """Ranks forked from the fork server (``start_ranks``) hold no module
    of JAX or of the JAX package, though this process has imported
    both."""
    import jax  # noqa: F401
    ctx = start_ranks(_jax_modules, (str(tmp_path / "mods"),), 2)
    try:
        _join(2, ctx, time.time() + SPAWN_TIMEOUT)
    finally:
        _stop(ctx)
    assert [(tmp_path / f"mods.{r}").read_text() for r in range(2)] == \
        ["", ""]


def test_a_cached_jax_step_gives_the_bits_of_a_fresh_one():
    """``jax_train_step`` compiles one JAX step a key in a process, which
    every reference of that key reuses: its trajectory is bit for bit
    that of the same step jitted afresh."""
    from repro_torch import strategy
    case = WORLDS[2][0]
    s = strategy.parse(case[0])
    inp = _inputs(case, 2)
    _jax_trajectory(case, s, **inp)
    hits = jax_train_step.cache_info().hits
    cached = _jax_trajectory(case, s, **inp)
    assert jax_train_step.cache_info().hits == hits + 1
    fresh = jax_run(_make_jax_step(*_jax_step_args(case, s)), **inp)
    assert cached["metrics"] == fresh["metrics"]
    for key in ("params", "m"):
        for (path, x), (_, y) in zip(_leaves(cached[key]),
                                     _leaves(fresh[key]), strict=True):
            assert np.array_equal(x, y), (key, path)


@pytest.mark.parametrize(
    "path", sorted(Path(__file__).parent.glob("test_torch_*.py")),
    ids=lambda p: p.stem)
def test_every_port_test_module_pins_the_threads(path):
    """Each ``tests/test_torch_*.py`` takes :func:`_few_threads` from this
    module (a module-level ``from test_torch_fsdp import _few_threads``)
    and defines no fixture of that name itself, so no test process runs
    the port at torch's default thread count."""
    body = ast.parse(path.read_text()).body
    defined = [n for n in body if isinstance(n, ast.FunctionDef)
               and n.name == "_few_threads"]
    imported = [n for n in body if isinstance(n, ast.ImportFrom)
                and n.module == "test_torch_fsdp"
                and any(a.name == "_few_threads" and a.asname is None
                        for a in n.names)]
    if path.name == Path(__file__).name:
        assert len(defined) == 1 and not imported
    else:
        assert imported and not defined, path.name
