"""Sharded static serving of the port (``generate_static`` under a plan:
the dense caches placed by ``cache_shardings``, the cross-rank log-sum-exp
merge of a decode step) on gloo worlds of 2 and 4 processes on the CPU,
against the JAX package's single-device ``generate_static``, ``prefill``
and ``decode_step`` (``tests/test_torch_static.py``'s weights, prompts,
bars and helpers).  The JAX package's own sharded-decode test
(``tests/test_spmd.py::test_sharded_decode_equivalence``) is red on this
jax.  Each world is spawned once and runs all its cases; spawned workers
import only torch and the port, JAX runs in the test process.
"""
import dataclasses
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_static import (GRANITE, LOGIT_ATOL, N_NEW, QWEN, QWEN2,
                               QWEN_KV1, RWKV, S0, _cfgs, _jax_run, _jax_tree,
                               _prompts, _rts)
from test_torch_fsdp import _few_threads  # noqa: F401
from test_torch_fsdp import start_ranks
# the reference's few threads in this process, as in test_torch_static

# (spec, arch, config overrides, global batch) per world size
WORLDS = {
    2: [("fsdp_tp2", *QWEN, 2), ("fsdp_tp2", *QWEN_KV1, 2),
        ("fsdp", *QWEN, 2),
        # batch 1 < data 2: rows replicated, the cache over data x model
        ("fsdp", *QWEN, 1),
        ("fsdp_tp2", *RWKV, 2), ("fsdp_pp2_mb2", *QWEN, 2),
        ("fsdp_tp2", *QWEN2, 2), ("fsdp_tp2", *GRANITE, 2)],
    # data 2 x model 2: rows split over data, slots over model; then
    # batch 1, the slots over all four ranks
    4: [("fsdp_tp2", *QWEN, 4), ("fsdp_tp2", *QWEN, 1)],
}
SPAWN_TIMEOUT = 300


# ---------------------------------------------------------------------------
# sharded static serving on gloo worlds (spawned once per module)
# ---------------------------------------------------------------------------

def _whole(lg, plan, rt, B):
    """This rank's logits (rows, ..., V / tp) -> every row and column."""
    from repro_torch.core import parallel as par
    if rt.tp_size > 1:
        parts = lg.new_empty((rt.tp_size * lg.shape[0],) + lg.shape[1:])
        dist.all_gather_into_tensor(parts, lg.contiguous(),
                                    group=rt.tp_group)
        lg = torch.cat(parts.chunk(rt.tp_size), dim=-1)
    for axis in reversed(par.row_axes(plan, B)):
        group = plan.mesh.get_group(axis)
        n = dist.get_world_size(group)
        if n > 1:
            parts = lg.new_empty((n * lg.shape[0],) + lg.shape[1:])
            dist.all_gather_into_tensor(parts, lg.contiguous(), group=group)
            lg = parts
    return lg


def _param_groups(module):
    """FSDP2's parameter groups of a unit (torch 2.13 keeps a list, 2.11
    one group)."""
    state = module._get_fsdp_state()
    groups = getattr(state, "_fsdp_param_groups", None)
    return groups if groups is not None else [state._fsdp_param_group]


def _serve_case(case):
    from repro_torch import strategy
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.core import parallel as par
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeEngine
    spec, arch, over, B = case["case"]
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    max_len = S0 + N_NEW
    shape = ShapeConfig("serve", max_len, B, "decode")
    plan = strategy.parse(spec).to_plan(cfg, strategy.host_topology(),
                                        shape)
    rt = par.make_runtime(cfg, plan, shape, attn_impl="torch",
                          norm_impl="torch", rwkv_chunk=16)
    params = par.apply_plan(params_from_jax(case["tree"]), plan, cfg)
    eng = ServeEngine(cfg, params, rt, max_len=max_len, plan=plan,
                      device="cpu")
    prompts = case["prompts"]
    tokens = eng.generate_static(prompts, N_NEW)
    lo, hi = par.serve_rows(plan, B)
    with torch.no_grad():
        lg, cache = tfm.prefill(cfg, params, {"tokens": torch.tensor(
            prompts)}, rt, max_len, plan)
        logits = [_whole(lg, plan, rt, B)]
        for t in range(N_NEW - 1):
            step = torch.tensor(tokens[lo:hi, S0 + t:S0 + t + 1])
            lg, cache = tfm.decode_step(cfg, params, cache, step, S0 + t, rt)
            logits.append(_whole(lg[:, 0], plan, rt, B))
    shapes = tfm.cache_shapes(cfg, B, max_len, torch.float32)
    want = par.cache_shardings(cfg, plan, shapes)
    layers = [(i, lc) for i, lc in enumerate(cache["layers"]) if lc]
    i, lc = layers[0]
    held = {k: tuple(v.shape) for part in lc.values()
            for k, v in part.items()}
    placed = {k: par.local_shape(plan, v.shape, want["layers"][i][p][k])
              for p, part in shapes["layers"][i].items()
              for k, v in part.items()}
    groups = [g for layer in params.layers if layer._modules
              for g in _param_groups(layer)]
    return dict(tokens=tokens, logits=[x.numpy() for x in logits],
                resharded=all(g.is_sharded for g in groups),
                held=held, placed=placed, rows=(lo, hi),
                layers=[i for i, _ in layers], cache_shard=rt.cache_shard,
                cache_axes=plan.decode_cache_axes, kv_tp=plan.kv_tp)


def _world(rank, n, payload, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}.store",
                            rank=rank, world_size=n)
    try:
        with open(payload, "rb") as f:
            cases = pickle.load(f)
        results = [_serve_case(c) for c in cases]
        every = [None] * n
        dist.all_gather_object(every, results)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump([[r[i] for r in every]
                             for i in range(len(cases))], f)
    finally:
        dist.destroy_process_group()


def _inputs(case):
    """A case's weights (JAX's init, as numpy) and prompts."""
    _, arch, over, B = case
    jc, _ = _cfgs(arch, over)
    return _jax_tree(jc, seed=7), _prompts(jc.vocab_size, B, seed=B)


def _reference(case, tree, prompts):
    """JAX single-device greedy tokens of the case's prompts, and the
    logits of its prefill and decode steps along them."""
    import jax.numpy as jnp

    from repro.serve import ServeEngine as JServeEngine
    _, arch, over, _ = case
    jc, _ = _cfgs(arch, over)
    jrt = _rts("torch")[0]
    toks = np.asarray(JServeEngine(jc, tree, jrt, max_len=S0 + N_NEW)
                      .generate_static(jnp.asarray(prompts), N_NEW))
    logits, _ = _jax_run(jc, tree, jrt, prompts, toks[:, S0:-1])
    return tree, prompts, toks, [logits[0]] + [x[:, 0] for x in logits[1:]]


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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: [(case, [each rank's result], JAX reference)]}; each world is
    spawned once and runs all its cases, while this process computes the
    references."""
    started, payloads = {}, {}
    try:
        for n, cases in WORLDS.items():
            d = tmp_path_factory.mktemp(f"serveworld{n}")
            payloads[n] = [dict(case=c, tree=t, prompts=p)
                           for c, (t, p) in zip(cases, map(_inputs, cases))]
            with open(d / "payload.pkl", "wb") as f:
                pickle.dump(payloads[n], f)
            started[n] = (d / "out.pkl", start_ranks(
                _world, (n, str(d / "payload.pkl"), str(d / "out.pkl")), n))
        deadline = time.time() + SPAWN_TIMEOUT
        refs = {n: [_reference(c["case"], c["tree"], c["prompts"])
                    for c in payload] for n, payload in payloads.items()}
        out = {}
        for n, (path, ctx) in started.items():
            _join(n, ctx, deadline)
            with open(path, "rb") as f:
                got = pickle.load(f)
            out[n] = list(zip(WORLDS[n], got, refs[n], strict=True))
        return out
    finally:
        for _, ctx in started.values():
            _stop(ctx)


CASES = [(n, i) for n, cases in WORLDS.items() for i in range(len(cases))]


def _ids(c):
    n, i = c
    spec, arch, over, B = WORLDS[n][i]
    kv = f"-kv{over['n_kv_heads']}" if "n_kv_heads" in over else ""
    return f"{n}-{spec}-{arch}{kv}-B{B}"


@pytest.mark.parametrize("world_case", CASES, ids=_ids)
def test_sharded_static_serving_matches_jax(worlds, world_case):
    """Every rank's greedy tokens equal JAX single-device ``generate_static``
    exactly, and the prefill's and each decode step's logits (every row
    and column gathered) are within 1e-4 of JAX's."""
    n, i = world_case
    _, got, (_, _, toks, logits) = worlds[n][i]
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["tokens"], toks, err_msg=f"rank {r}")
        for t, (a, b) in enumerate(zip(res["logits"], logits, strict=True)):
            assert a.shape == b.shape, (r, t)
            assert np.max(np.abs(a - b)) < LOGIT_ATOL, (r, t)


@pytest.mark.parametrize("world_case", CASES, ids=_ids)
def test_each_rank_holds_its_cache_shard(worlds, world_case):
    """A rank's caches have the shapes ``cache_shardings`` places: the KV
    slots split over ``decode_cache_axes`` (sequence-sharded: each rank a
    different shard), rows over data where the batch divides it, the WKV
    state by heads; a pipe rank holds only its stage's layers; and its
    layers' parameters are sharded again once the serving is done."""
    n, i = world_case
    spec, arch, over, B = WORLDS[n][i]
    _, got, _ = worlds[n][i]
    for res in got:
        assert res["held"] == res["placed"]
        # ZeRO-3 under no_grad: every layer resharded after its forward,
        # none left gathered across decode steps
        assert res["resharded"]
    first = got[0]
    if "pp2" in spec:
        assert sorted(r["layers"] for r in got) == [[0], [1]]
        return
    if "k" in first["held"]:
        Sc = S0 + N_NEW
        shards = {r["cache_shard"] for r in got}
        split = Sc // first["held"]["k"][1]
        assert len(shards) == split
        assert split == (n if first["cache_axes"] != ("model",)
                         else (2 if "tp2" in spec else 1))
        assert first["held"]["kpos"] == (Sc,)
        # every KV head of its slots (qwen3 and Llama-2 reduced: 4)
        assert first["held"]["k"][2] == _cfgs(arch, over)[1].kv_heads
    else:
        assert first["held"]["wkv"][1] == 4 // 2
