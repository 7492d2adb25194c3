"""Expert parallelism of the port (``core.expert``: the dispatch and
combine all-to-all over an expert axis) on gloo worlds of 2 and 4
processes on the CPU, against the JAX package's single-device MoE.

The JAX package's own expert-parallel tests (``tests/test_expert_
parallel.py``) are red on this jax, so the reference is its single-device
``_moe_dropping`` with ``moe_groups`` = the token shards: each rank's
local capacity routing is one of its groups.  Each world is spawned once
and runs all its cases:

- ``layer``: one MoE layer's forward and backward, tokens sharded over the
  ranks, at a capacity factor that drops nothing (4.0) and a tight one
  (0.5): outputs and the gradients of the tokens and of every leaf within
  1e-5 of their scale, the aux on every rank within 1e-6 relative of the
  dense oracle's on all the tokens (the same router statistics, summed in
  another order).  Each rank backpropagates the train step's weighting,
  n times its share of ``sum(y dy)`` plus the global aux, and the mean of
  the ranks' gradients (FSDP2's) answers to JAX's gradient of
  ``sum(y dy) + aux``; the cases at an aux coefficient of 1.0 make the
  aux's gradient dominate the router's, so an aux gradient counted once
  per rank, or once over all of them, fails;
- ``padded``: the same 3 tokens on every rank (a decode batch that does
  not split over the expert group): zero rows appended after them, the
  outputs within 1e-5 of JAX's dropping on the padded tokens;
- ``train``: three AdamW steps of a reduced deepseek-moe-16b under an
  ``ep`` spec against JAX's single-device dropping trajectory, at the f32
  bars of ``tests/test_torch_fsdp.py``, the aux of every step within 1e-6
  relative; the first step's gradients (before AdamW) within 1e-5 of the
  port's unsharded dropping step's; the final state
  restored under plain ``fsdp`` (a cross-mesh checkpoint) equal bit for
  bit.  ``fsdp_ga4`` (no expert axis) takes microbatches of one row,
  which do not split over 2 ranks: each rank computes them whole, its
  dropping dispatch in the plan's 2 groups and its router's statistics
  its own, as JAX's GSPMD step does.

The other data-parallel compositions run the same cases in files of
their own, so that they spread over test workers: ZeRO-2, bf16 and fp8
in ``tests/test_torch_ep_dp.py``, HSDP and ZeRO-0 in
``tests/test_torch_ep_hsdp.py``.

Spawned workers import only torch and the port; JAX runs in the test
process.
"""
import dataclasses
import os
import pickle
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from test_torch_fsdp import (F32_BARS, LOW_BARS, LR, STEPS, _errors,
                             _join, _stop, fp8_gather, jax_run,
                             jax_train_step, start_ranks)
from test_torch_fsdp import _few_threads  # noqa: F401

S = 16
ARCH = "deepseek-moe-16b"
N_LAYERS = 3
LAYER_REL = 1e-5
GRAD_REL = 1e-5
AUX_REL = 1e-6
T_LAYER = 48                # tokens of the layer cases, over all ranks
T_PADDED = 3
# bf16 and fp8 gradients of the first step against the port's own
# single-device step at the same precision: each rank's weight gradient
# over its own rows is rounded to bf16 (2**-8 relative) before the
# cross-rank sum, the single device's over all rows (measured worst on 2
# ranks: 4.8e-3 bf16, 7.8e-3 fp8, of each leaf's scale)
LOW_GRAD_REL = 2e-2
# the aux coefficient at which its gradient dominates the router's
STRONG_AUX = 1.0
# A bf16 or fp8 trajectory of a MoE model is chaotic at this size: a
# routing choice near a tie or at an expert's capacity flips on a rounding
# difference, so the port's own single-device trajectory from weights
# perturbed by a relative CHAOS_EPS moves by more than the dense model's
# bars (measured on 2 ranks, bf16: moment 0.21, metric up to 8.3e-3).  A
# low-precision case's trajectory bar is the larger of
# ``tests/test_torch_fsdp.py``'s bars and CHAOS times that move (the
# worst of CHAOS_SEEDS perturbations); its first step, before any
# update, holds to LOW_GRAD_REL.
CHAOS, CHAOS_EPS, CHAOS_SEEDS = 2.0, 1e-6, 2
# torch's threads for those references (the port's single-device
# trajectory and its chaos), whose bits depend on the count: at 1 or 2
# (bit-identical) the 2-rank fsdp_bf16 world is 0.0885 lr (mean) from the
# reference against a bar of 0.0836, at 8 0.032 against 0.149.  8 is the
# count they were computed at on the 8-CPU hosts that held these bars;
# they are computed in a process of their own (:func:`_low_references`)
# beside this one's JAX references.
CHAOS_THREADS = 8


def _case(kind, arg, coef=None, topo=None):
    """(kind, capacity factor or spec, aux coefficient (None: the
    config's), (n_devices, island) of a test-built Topology or None for
    the host topology)."""
    return (kind, arg, coef, topo)


WORLDS = {2: [_case("layer", 4.0), _case("layer", 0.5),
              _case("padded", 1.25), _case("train", "fsdp_ep2"),
              _case("train", "fsdp_ga4"),
              _case("layer", 0.5, STRONG_AUX),
              _case("train", "fsdp_ep2", STRONG_AUX)],
          4: [_case("layer", 0.5), _case("padded", 1.25),
              _case("train", "fsdp_ep4"), _case("train", "fsdp_ep2"),
              _case("layer", 4.0, STRONG_AUX)]}
SPAWN_TIMEOUT = 300


def _with_moe(cfg, cf, coef):
    moe = dataclasses.replace(cfg.moe, capacity_factor=cf)
    if coef is not None:
        moe = dataclasses.replace(moe, aux_loss_coef=coef)
    return dataclasses.replace(cfg, moe=moe)


def _cfg(cf=1.25, coef=None):
    from repro_torch.configs import get_config, reduced
    return _with_moe(reduced(get_config(ARCH), n_layers=N_LAYERS), cf, coef)


def _precision(spec):
    from repro_torch import strategy
    return strategy.parse(spec).precision


# ---------------------------------------------------------------------------
# the spawned worlds (torch and the port only)
# ---------------------------------------------------------------------------

def _layer_case(case, rank, n):
    """One MoE layer on this rank's tokens (sharded) or on all of them
    (``padded``) -> every rank's outputs and gradients, on rank 0."""
    from repro_torch.core import expert as expert_lib
    from repro_torch.models import moe as tmoe
    from repro_torch.models import layers
    from repro_torch.models.layers import Runtime
    kind, cf, coef, _ = case["case"]
    cfg = _cfg(cf, coef)
    world = dist.group.WORLD
    sharded = kind == "layer"
    rt = Runtime(moe_impl="ep", expert_group=world, expert_size=n,
                 moe_stat_groups=(world,) if sharded else ())
    p = case["p"]
    E = cfg.moe.n_experts
    mine = {k: torch.tensor(v) for k, v in p.items() if k != "shared"}
    for k in ("w_up", "w_gate", "w_down"):
        mine[k] = mine[k][rank * E // n:(rank + 1) * E // n].contiguous()
    for v in mine.values():
        v.requires_grad_()
    x = case["x"]
    if sharded:
        x = x[rank * len(x) // n:(rank + 1) * len(x) // n]
    x = torch.tensor(x, requires_grad=sharded)
    expert_lib.reset_dispatch_stats()
    layers.reset_collective_counts()
    with torch.set_grad_enabled(sharded):       # serving runs no_grad
        y, aux = tmoe.apply_moe(cfg, mine, x[None], rt)
    out = dict(y=y[0].detach().numpy(), aux=float(aux.detach()),
               stats=expert_lib.dispatch_stats_snapshot())
    if sharded:
        dy = case["dy"][rank * len(case["dy"]) // n:
                        (rank + 1) * len(case["dy"]) // n]
        # the train step's weighting: n times this rank's share, plus the
        # global aux (FSDP2 then takes the mean of the ranks' gradients)
        (n * (y[0] * torch.tensor(dy)).sum() + aux).backward()
        out.update(gx=x.grad.numpy(),
                   grads={k: v.grad.numpy() for k, v in mine.items()})
    out["a2a"] = layers.COLLECTIVES["all_to_all"]
    parts = [None] * n
    dist.all_gather_object(parts, out)
    return parts


def _train_case(case, rank, n):
    """Three AdamW steps under the spec -> metrics, final state, the
    first step's gradients, and the state restored under ``fsdp``."""
    from repro_torch import bridge, strategy
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import expert as expert_lib
    from repro_torch.core import parallel as par
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.strategy.topology import mesh_shape
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import _DataParallel, make_train_step

    _, spec, coef, topo_kw = case["case"]
    cfg = _cfg(coef=coef)
    topo = (strategy.Topology("test", *topo_kw) if topo_kw
            else strategy.host_topology())
    B = case["batches"][0]["labels"].shape[0]
    shape = ShapeConfig("test", S, B, "train")
    plan = strategy.parse(spec).to_plan(cfg, topo, shape)
    rt = par.make_runtime(cfg, plan, shape, remat=False)
    params = par.apply_plan(bridge.params_from_jax(case["tree"]), plan, cfg)
    # the first batch's gradients, before any update
    dp = _DataParallel(plan)
    micro = {k: torch.tensor(v) for k, v in case["batches"][0].items()}
    micro, denom = dp.rows(micro, (micro["labels"] >= 0).sum().float())
    expert_lib.reset_dispatch_stats()
    loss, m0 = tfm.loss_fn(cfg, params, micro, rt, denom)
    loss.backward()
    named = dict(params.named_parameters())
    dp.sum_over_experts(named, rt)
    grads0 = bridge.grads_to_jax({k: p.grad for k, p in named.items()}, cfg)
    stats = expert_lib.dispatch_stats_snapshot()
    aux0 = float(m0["aux"])
    for p in named.values():
        p.grad = None
    state = init_opt_state(params)
    step = make_train_step(cfg, rt, TrainConfig(
        steps=STEPS, warmup=1, grad_accum=strategy.parse(spec).grad_accum,
        opt=AdamWConfig(lr=LR, weight_decay=0.0)), plan)
    metrics = []
    for b in case["batches"]:
        _, state, m = step(params, state, {k: torch.tensor(v)
                                           for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    tree = bridge.train_state_to_tree(params, state, cfg)
    # cross-mesh: the ep state into a plain fsdp plan's shards
    fplan = strategy.parse("fsdp").to_plan(cfg, topo, shape)
    fparams = par.apply_plan(tfm.init_params(cfg, 1, "cpu"), fplan, cfg)
    fstate = init_opt_state(fparams)
    bridge.load_train_state(tree, fparams, fstate)
    back = bridge.train_state_to_tree(fparams, fstate, cfg)
    local = {name: (tuple(p.to_local().shape), tuple(p.shape))
             for name, p in params.named_parameters()}
    out = dict(metrics=metrics, params=tree["params"], m=tree["opt"]["m"],
               back=back, tree=tree, grads0=grads0, aux0=aux0, stats=stats,
               local=local,
               plan=(mesh_shape(plan.mesh), plan.dp, plan.fsdp, plan.expert,
                     plan.zero))
    return out if rank == 0 else None


def _world(rank, n, payload, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}.store",
                            rank=rank, world_size=n)
    try:
        with open(payload, "rb") as f:
            cases = pickle.load(f)
        results = [(_train_case if c["case"][0] == "train" else
                    _layer_case)(c, rank, n) for c in cases]
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _start(n, payload, out):
    return start_ranks(_world, (n, str(payload), str(out)), n)


# ---------------------------------------------------------------------------
# inputs and the JAX single-device references (test process)
# ---------------------------------------------------------------------------

def _jax_cfg(cf=1.25, coef=None):
    from repro.configs import get_config, reduced
    return _with_moe(reduced(get_config(ARCH), n_layers=N_LAYERS), cf, coef)


def _inputs(case, n):
    import jax

    from repro.models import moe as jmoe
    from repro.models import transformer as jtfm
    kind, arg, coef, _ = case
    if kind == "train":
        jc = _jax_cfg(coef=coef)
        tree = jax.tree.map(np.asarray, jtfm.init_params(
            jc, jax.random.PRNGKey(5)))
        rng = np.random.default_rng(n)
        batches = []
        for _ in range(STEPS):
            toks = rng.integers(0, jc.vocab_size,
                                (2 * n, S + 1)).astype(np.int32)
            labels = toks[:, 1:].copy()
            labels[2:4, S // 4:] = -1        # rows of rank 1
            batches.append({"tokens": toks[:, :-1], "labels": labels})
        return dict(tree=tree, batches=batches)
    jc = _jax_cfg(arg, coef)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jc, jax.random.PRNGKey(n)))
    rng = np.random.default_rng(10 + n)
    T = T_LAYER if kind == "layer" else T_PADDED
    return dict(p=p, x=rng.standard_normal((T, jc.d_model)).astype(
        np.float32), dy=rng.standard_normal((T, jc.d_model)).astype(
        np.float32))


def _jax_layer(case, inp, n):
    """JAX's dropping with one group per token shard: y, aux and (for
    sharded tokens) the gradients of x and of every leaf but the shared
    experts (which the caller of the dispatch runs)."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    from repro.models.layers import Runtime as JRuntime
    kind, cf, coef, _ = case
    jc = _jax_cfg(cf, coef)
    p = {k: v for k, v in inp["p"].items() if k != "shared"}
    x = inp["x"]
    T = len(x)
    if kind == "padded":
        x = np.concatenate([x, np.zeros((n - T % n, x.shape[1]),
                                        np.float32)])
    y, aux = jmoe._moe_dropping(jc, p, jnp.asarray(x),
                                JRuntime(moe_groups=n))
    out = dict(y=np.asarray(y)[:T], aux=float(aux),
               dense_aux=float(jmoe._moe_dense(jc, p, jnp.asarray(x),
                                                     JRuntime())[1]))
    if kind == "layer":
        def loss(pp, xx):
            yy, a = jmoe._moe_dropping(jc, pp, xx, JRuntime(moe_groups=n))
            return jnp.sum(yy * jnp.asarray(inp["dy"])) + a
        gp, gx = jax.grad(loss, (0, 1))(p, jnp.asarray(x))
        out.update(gx=np.asarray(gx),
                   grads=jax.tree.map(np.asarray, gp))
    return out


def _jax_train(inp, n, s, coef):
    """JAX's single-device trajectory with the plan's dispatch (dropping
    in n groups), its ``ga`` and its precision (bf16 compute; under fp8
    with sharded parameters, the per-layer gatherer's fp8 rounding, as in
    ``tests/test_torch_fsdp.py``)."""
    import jax.numpy as jnp

    from repro.models.layers import Runtime as JRuntime
    kw = {}
    if s.precision != "f32":
        kw["compute_dtype"] = jnp.bfloat16
    if s.precision == "fp8" and s.zero:
        kw["gather_params"] = fp8_gather
    rt = JRuntime(moe_impl="dropping", moe_groups=n, **kw)
    return jax_run(jax_train_step(_jax_cfg(coef=coef), rt, s.grad_accum,
                                  0.0), inp["tree"], inp["batches"])


def _port_runtime(n, s):
    """The port's single-device runtime of spec ``s``'s numerics: dropping
    in n groups, bf16 compute under bf16 and fp8, fp8's wire rounding
    where its parameters are sharded."""
    from repro_torch.models.layers import Runtime
    low = s.precision != "f32"
    return Runtime(moe_impl="dropping", moe_groups=n,
                   compute_dtype=torch.bfloat16 if low else torch.float32,
                   gather_dtype=torch.float8_e4m3fn
                   if s.precision == "fp8" and s.zero else None)


def _port_grads0(inp, n, s, coef):
    """The port's unsharded step on the first batch at the spec's
    numerics: its gradients before any update and its aux."""
    from repro_torch import bridge
    from repro_torch.models import transformer as tfm
    cfg = _cfg(coef=coef)
    params = bridge.params_from_jax(inp["tree"])
    loss, m = tfm.loss_fn(cfg, params, {
        k: torch.tensor(v) for k, v in inp["batches"][0].items()},
        _port_runtime(n, s))
    loss.backward()
    return dict(grads=bridge.grads_to_jax(
        {k: p.grad for k, p in params.named_parameters()}, cfg),
        aux=float(m["aux"].detach()))


def _chaos(inp, n, s, coef, base):
    """How far the port's single-device trajectory moves from ``base``
    when every f32 weight is perturbed by a relative CHAOS_EPS: the worst
    of ``_errors`` over CHAOS_SEEDS draws, and of the per-step aux's
    relative move."""
    import jax
    worst = {}
    for seed in range(CHAOS_SEEDS):
        rng = np.random.default_rng(seed)
        tree = jax.tree.map(
            lambda a: (a * (1 + CHAOS_EPS * rng.standard_normal(a.shape))
                       ).astype(a.dtype) if a.dtype == np.float32 else a,
            inp["tree"])
        got = _port_train(dict(inp, tree=tree), n, s, coef)
        err = _errors(got, base)
        err["aux"] = max(abs(m["aux"] - r["aux"]) / r["aux"] for m, r in
                         zip(got["metrics"], base["metrics"]))
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in err.items()}
    return worst


def _port_train(inp, n, s, coef):
    """The same trajectory through the port on one device, unsharded (the
    second reference of a bf16 or fp8 case)."""
    from repro_torch import bridge
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    cfg = _cfg(coef=coef)
    params = bridge.params_from_jax(inp["tree"])
    state = init_opt_state(params)
    step = make_train_step(cfg, _port_runtime(n, s), TrainConfig(
        steps=STEPS, warmup=1, grad_accum=s.grad_accum,
        opt=AdamWConfig(lr=LR, weight_decay=0.0)))
    metrics = []
    for b in inp["batches"]:
        _, state, m = step(params, state, {k: torch.tensor(v)
                                           for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, params=bridge.params_to_jax(params, cfg),
                m=bridge.opt_state_to_jax(state, cfg)["m"])


def _numerics(case, n):
    """The key of a train case's numerics: cases of one key share their
    references."""
    from repro_torch import strategy
    s = strategy.parse(case[1])
    return (n, case[2], s.grad_accum, s.precision,
            s.precision == "fp8" and s.zero > 0)


def _low_references(_index, payload, out):
    """In a process of its own, at CHAOS_THREADS: {numerics key: (the
    port's single-device trajectory, its chaos)} of every low-precision
    train item of the payload ({key: (case, n, inputs)})."""
    from repro_torch import strategy
    torch.set_num_threads(CHAOS_THREADS)
    with open(payload, "rb") as f:
        items = pickle.load(f)
    refs = {}
    for key, (c, n, inp) in items.items():
        s = strategy.parse(c[1])
        train = _port_train(inp, n, s, c[2])
        refs[key] = (train, _chaos(inp, n, s, c[2], train))
    with open(out, "wb") as f:
        pickle.dump(refs, f)


def spawn_worlds(spec, tmp_path_factory):
    """{n: [(case, port result, references)]} of the worlds ``spec`` ({n:
    cases}): every world started at once, each running all its cases,
    beside a process computing the low-precision cases' port references
    (:func:`_low_references`), while this process computes the rest."""
    from repro_torch import strategy
    started, refs, inputs, low = {}, {}, {}, {}
    try:
        for n, cases in spec.items():
            d = tmp_path_factory.mktemp(f"world{n}")
            inputs[n] = [_inputs(c, n) for c in cases]
            with open(d / "payload.pkl", "wb") as f:
                pickle.dump([dict(case=c, **i) for c, i in
                             zip(cases, inputs[n])], f)
            started[n] = (d / "out.pkl", _start(n, d / "payload.pkl",
                                                d / "out.pkl"))
            for c, inp in zip(cases, inputs[n]):
                if c[0] == "train" and _precision(c[1]) != "f32":
                    low.setdefault(_numerics(c, n), (c, n, inp))
        d = tmp_path_factory.mktemp("low")
        with open(d / "payload.pkl", "wb") as f:
            pickle.dump(low, f)
        # a fresh interpreter whose OpenMP threads sleep while they wait:
        # CHAOS_THREADS spinning threads would take the cores the other
        # test processes need (the policy does not change how work splits)
        with mock.patch.dict(os.environ, OMP_WAIT_POLICY="PASSIVE"):
            started["low"] = (d / "out.pkl", mp.start_processes(
                _low_references,
                args=(str(d / "payload.pkl"), str(d / "out.pkl")),
                nprocs=1, join=False, start_method="spawn"))
        shared = {}         # cases of the same numerics share references
        for n, cases in spec.items():
            refs[n] = []
            for c, inp in zip(cases, inputs[n]):
                if c[0] == "train":
                    s = strategy.parse(c[1])
                    key = _numerics(c, n)
                    if key not in shared:
                        shared[key] = dict(jax=_jax_train(inp, n, s, c[2]),
                                           port=_port_grads0(inp, n, s,
                                                             c[2]))
                    refs[n].append(shared[key])
                else:
                    refs[n].append(_jax_layer(c, inp, n))
        import time
        deadline = time.time() + SPAWN_TIMEOUT
        out = {}
        for n, (path, ctx) in started.items():
            _join(n, ctx, deadline)
            with open(path, "rb") as f:
                got = pickle.load(f)
            if n == "low":
                for key, (train, chaos) in got.items():
                    shared[key].update(port_train=train, chaos=chaos)
            else:
                out[n] = list(zip(spec[n], got, refs[n]))
        return out
    finally:
        for _, ctx in started.values():
            _stop(ctx)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return spawn_worlds(WORLDS, tmp_path_factory)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def cases_of(spec, kind):
    return [(n, i) for n, cases in spec.items()
            for i, c in enumerate(cases) if c[0] == kind]


def _cases(kind):
    return cases_of(WORLDS, kind)


@pytest.mark.parametrize("n,i", _cases("layer"))
def test_dispatch_matches_jax_dropping_per_shard(worlds, n, i):
    """Sharded tokens through the all-to-all: every rank's outputs, and
    the mean over the ranks (FSDP2's) of the gradients of their tokens,
    of the router and of each rank's slice of the expert stacks, against
    JAX's dropping with n groups and its gradient of sum(y dy) + aux; the
    aux on every rank the dense oracle's."""
    case, parts, ref = worlds[n][i]
    T = T_LAYER // n
    assert all(p["stats"]["ep_calls"] == 1 for p in parts)
    assert all(p["a2a"] == 4 for p in parts)     # dispatch, combine, x2
    assert _rel(np.concatenate([p["y"] for p in parts]), ref["y"]) < \
        LAYER_REL
    assert _rel(np.concatenate([p["gx"] for p in parts]) / n, ref["gx"]) < \
        LAYER_REL
    for p in parts:
        assert abs(p["aux"] - ref["dense_aux"]) <= AUX_REL * ref["dense_aux"]
    router = sum(p["grads"]["router"] for p in parts) / n
    assert _rel(router, ref["grads"]["router"]) < LAYER_REL
    for k in ("w_up", "w_gate", "w_down"):
        assert _rel(np.concatenate([p["grads"][k] for p in parts]) / n,
                    ref["grads"][k]) < LAYER_REL, k
    assert T * n == T_LAYER


@pytest.mark.parametrize("n,i", _cases("padded"))
def test_padded_decode_path(worlds, n, i):
    """3 tokens on every rank of an expert group of n: padded to a
    multiple of n (padding can only drop padding), each rank dispatches
    its share, the outputs are all-gathered, equal to JAX's dropping on
    the padded tokens on every rank."""
    case, parts, ref = worlds[n][i]
    for p in parts:
        assert p["stats"] == {"ep_calls": 0, "ep_padded_calls": 1,
                              "ep_fallback_calls": 0}
        assert p["y"].shape == (T_PADDED, ref["y"].shape[1])
        assert _rel(p["y"], ref["y"]) < LAYER_REL
        assert abs(p["aux"] - ref["aux"]) <= AUX_REL * ref["aux"]


def check_training(case, got, ref):
    """Three steps under the spec against JAX's single-device dropping
    trajectory in n groups: f32 at the f32 bars, bf16 and fp8 at
    ``tests/test_torch_fsdp.py``'s bars or CHAOS times the port's own
    move under a tiny perturbation, whichever is larger, against JAX and
    against the port's own single-device step; under an ep spec the MoE
    layers took the all-to-all and each rank holds its E/ep slice of the
    expert stacks, of which FSDP2 keeps 1/data where it shards them."""
    _, spec, _, _ = case
    precision = _precision(spec)
    if precision == "f32":
        err = _errors(got, ref["jax"])
        assert all(err[k] < F32_BARS[k] for k in F32_BARS), (spec, err)
        aux_bar = AUX_REL
    else:
        chaos = ref["chaos"]
        for name, want in (("jax", ref["jax"]), ("port", ref["port_train"])):
            bars = {k: max(v, CHAOS * chaos[k])
                    for k, v in LOW_BARS[precision, name].items()}
            err = _errors(got, want)
            assert all(err[k] < bars[k] for k in bars), (spec, name, err,
                                                         bars)
        aux_bar = max(LOW_BARS[precision, "jax"]["metric"],
                      CHAOS * chaos["aux"])
    for m, r in zip(got["metrics"], ref["jax"]["metrics"]):
        assert abs(m["aux"] - r["aux"]) <= aux_bar * r["aux"]
    mesh, dp, fsdp, expert, zero = got["plan"]
    if "ep" not in spec:
        assert got["stats"]["ep_calls"] == 0 and not expert
        return
    ep = mesh["expert"]
    assert expert == "expert" and dp[-2:] == ("data", "expert")
    assert fsdp == (("data", "expert") if zero else ())
    assert got["stats"]["ep_calls"] == N_LAYERS - 1
    E = _cfg().moe.n_experts
    shards = mesh["data"] if zero else 1
    for name, (local, whole) in got["local"].items():
        if name.endswith("ffn.w_up") and len(whole) == 3:
            # E/ep experts, FSDP2's 1/data of their d (where JAX's spec
            # puts the data axes: core.parallel.data_shard_dim)
            assert whole[0] == E, name
            assert local[0] == E // ep, name
            assert local[1] * shards == whole[1] and local[2] == whole[2], \
                name


def check_first_step_gradients(case, got, ref):
    """The first step's gradients under the spec (FSDP2's reduction of
    the expert units over the data axes, divided by the whole data
    degree, and the router's and shared experts' sum over the expert
    group) equal the port's unsharded dropping step's at the same
    numerics, and so does the aux."""
    import jax
    _, spec, _, _ = case
    low = _precision(spec) != "f32"
    bar = LOW_GRAD_REL if low else GRAD_REL
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got["grads0"])[0],
            jax.tree_util.tree_flatten_with_path(ref["port"]["grads"])[0]):
        assert _rel(a, b) < bar, (spec, jax.tree_util.keystr(path),
                                  _rel(a, b))
    aux = ref["port"]["aux"]
    assert abs(got["aux0"] - aux) <= (LOW_GRAD_REL if low else AUX_REL) * aux


def check_restore(got):
    """The run's training state (the JAX layout) loaded into a plain
    fsdp plan's shards and gathered again, bit for bit."""
    import jax
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got["back"])[0],
            jax.tree_util.tree_flatten_with_path(got["tree"])[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(
            path))


@pytest.mark.parametrize("n,i", _cases("train"))
def test_ep_training_matches_jax_dropping(worlds, n, i):
    """Three steps under the spec against JAX's single-device dropping
    trajectory (:func:`check_training`)."""
    check_training(*worlds[n][i])


@pytest.mark.parametrize("n,i", _cases("train"))
def test_ep_step_gradients_equal_the_unsharded_step(worlds, n, i):
    """The first step's gradients and aux equal the port's unsharded
    dropping step's (:func:`check_first_step_gradients`)."""
    check_first_step_gradients(*worlds[n][i])


@pytest.mark.parametrize("n,i", _cases("train"))
def test_ep_state_restores_under_fsdp(worlds, n, i):
    """The ep run's training state restores under plain fsdp bit for bit
    (:func:`check_restore`)."""
    check_restore(worlds[n][i][1])
