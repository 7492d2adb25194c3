"""The port's static serving slice against the JAX package, on the CPU:
dense KV caches and the RWKV-6 recurrent cache (``prefill`` and
``decode_step``), the cache bridge, the static engine
(``generate_static``) and cache placement under a plan
(``cache_shardings``).  Sharded static serving on gloo worlds of 2 and 4
processes is ``tests/test_torch_static_worlds.py``, the serve CLI's
``--strategy``/``--engine`` ``tests/test_torch_static_cli.py``: three
files, so that ``--dist loadfile`` spreads them over workers.

Weights come from the JAX initialiser through ``repro_torch.bridge``;
prompts and tokens from numpy with a fixed seed.  JAX's Pallas path runs
its kernels in interpret mode; the port's kernel path runs each kernel's
plain version on these CPU tensors.  Logits are held to 1e-4 (the paged
tests' bar: f32 sums in another order over 2 layers), greedy tokens
exactly.  The JAX package's own sharded-decode test
(``tests/test_spmd.py::test_sharded_decode_equivalence``) is red on this
jax, so the sharded port answers to JAX's single-device ``prefill`` and
``decode_step``.  Spawned workers import only torch and the port; JAX runs
in the test process.
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_fsdp import _few_threads  # noqa: F401

LOGIT_ATOL = 1e-4
S0, N_NEW = 11, 9       # prompt length, new tokens: 20 slots split 4 ways
QWEN = ("qwen3-0.6b", dict(n_kv_heads=2))
QWEN_KV1 = ("qwen3-0.6b", dict(n_kv_heads=1))     # kv_tp false at tp 2
QWEN_SWA = ("qwen3-0.6b", dict(n_kv_heads=2, sliding_window=8))
LLAMA = ("llama2-1b", {})
RWKV = ("rwkv6-1.6b", {})
QWEN2 = ("qwen2-1.5b", {})              # qkv bias, Kv 2 split at tp 2
GRANITE = ("granite-20b", {})           # Kv 1 replicated; sinusoidal
SINGLE = {"qwen3-gqa": QWEN, "llama2-1b": LLAMA, "rwkv6": RWKV,
          "qwen3-swa-ring": QWEN_SWA}


def _cfgs(arch, over):
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro_torch.configs import get_config, reduced
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


def _jax_tree(jc, seed=1):
    import jax

    from repro.models import transformer as jtfm
    return jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(seed)))


def _rts(impl):
    from repro.models.layers import Runtime as JRuntime
    from repro_torch.models.layers import Runtime
    if impl == "kernel":
        return (JRuntime(attn_impl="pallas", norm_impl="pallas",
                         rwkv_chunk=16), Runtime(rwkv_chunk=16))
    return (JRuntime(rwkv_chunk=16),
            Runtime(attn_impl="torch", norm_impl="torch", rwkv_chunk=16))


def _prompts(vocab, B, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S0)).astype(np.int32)


# ---------------------------------------------------------------------------
# prefill + decode_step against JAX, one device
# ---------------------------------------------------------------------------

def _jax_run(jc, tree, jrt, prompts, steps):
    """JAX ``prefill`` then ``decode_step`` along ``steps`` (B, n) tokens
    -> ([prefill logits, each step's logits], final cache)."""
    import jax.numpy as jnp

    from repro.models import transformer as jtfm
    lg, cache = jtfm.prefill(jc, tree, {"tokens": jnp.asarray(prompts)}, jrt,
                             S0 + N_NEW)
    out = [np.asarray(lg)]
    for t in range(steps.shape[1]):
        lg, cache = jtfm.decode_step(jc, tree, cache,
                                     jnp.asarray(steps[:, t:t + 1]),
                                     jnp.asarray(S0 + t, jnp.int32), jrt)
        out.append(np.asarray(lg))
    return out, cache


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("case", sorted(SINGLE))
def test_prefill_and_decode_match_jax(case, impl):
    """Logits of a prefill of 11 tokens and 9 decode steps within 1e-4 of
    JAX's; the caches after them equal JAX's (the SWA case's ring of 8
    slots wraps in the prefill and again while decoding), through
    ``cache_to_jax``."""
    import jax

    from repro_torch.bridge import cache_to_jax, params_from_jax
    from repro_torch.models import transformer as tfm
    jc, tc = _cfgs(*SINGLE[case])
    tree = _jax_tree(jc)
    params = params_from_jax(tree)
    jrt, trt = _rts(impl)
    prompts = _prompts(jc.vocab_size, 2)
    steps = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, N_NEW)).astype(np.int32)
    want, jcache = _jax_run(jc, tree, jrt, prompts, steps)
    with torch.no_grad():
        lg, cache = tfm.prefill(tc, params, {"tokens": torch.tensor(prompts)},
                                trt, S0 + N_NEW)
        got = [lg.numpy()]
        for t in range(N_NEW):
            lg, cache = tfm.decode_step(tc, params, cache,
                                        torch.tensor(steps[:, t:t + 1]),
                                        S0 + t, trt)
            got.append(lg.numpy())
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) < LOGIT_ATOL
    back = cache_to_jax(cache, tc)
    assert jax.tree.structure(back) == jax.tree.structure(jcache)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b)      # kpos and idx
        else:
            assert np.max(np.abs(a - b)) < LOGIT_ATOL
    if case == "qwen3-swa-ring":
        kpos = back["blocks"][0]["kv"]["kpos"][0]
        assert sorted(kpos) == list(range(S0 + N_NEW - 8, S0 + N_NEW))
        assert all(p % 8 == i for i, p in enumerate(kpos))


def test_recurrent_state_carries_through_a_chunked_prefill():
    """RWKV-6: a second prompt chunk of 9 tokens onto the state a prefill
    left (the plain chunked form from a carried state, the WKV-6 kernel's
    route being for a zero state only) and a decode step after it, from
    a JAX cache brought over by ``cache_from_jax``; both packages' logits
    and states agree, and the bridge round-trips exactly."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtfm
    from repro_torch.bridge import cache_from_jax, cache_to_jax, \
        params_from_jax
    from repro_torch.models import transformer as tfm
    jc, tc = _cfgs(*RWKV)
    tree = _jax_tree(jc)
    params = params_from_jax(tree)
    jrt, trt = _rts("kernel")
    prompts = _prompts(jc.vocab_size, 2)
    _, jcache = jtfm.prefill(jc, tree, {"tokens": jnp.asarray(prompts)}, jrt,
                             64)
    jcache = jax.tree.map(np.asarray, jcache)
    cache = cache_from_jax(jcache)
    again = cache_to_jax(cache, tc)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(a, b)
    chunk = np.random.default_rng(2).integers(
        0, jc.vocab_size, (2, 9)).astype(np.int32)
    jl, jcache, _ = jtfm.forward(jc, tree, {"tokens": jnp.asarray(chunk),
                                            "pos": jnp.asarray(S0)}, jrt,
                                 cache=jcache)
    with torch.no_grad():
        tl = tfm.forward(tc, params, {"tokens": torch.tensor(chunk),
                                      "pos": S0}, trt, cache)
        assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < LOGIT_ATOL
        nxt = chunk[:, -1:]
        jl, jcache = jtfm.decode_step(jc, tree, jcache, jnp.asarray(nxt),
                                      jnp.asarray(S0 + 9, jnp.int32), jrt)
        tl, cache = tfm.decode_step(tc, params, cache, torch.tensor(nxt),
                                    S0 + 9, trt)
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < LOGIT_ATOL
    wkv = cache_to_jax(cache, tc)["blocks"][0]["att"]["wkv"]
    want = np.asarray(jcache["blocks"][0]["att"]["wkv"])
    assert np.max(np.abs(wkv - want)) < LOGIT_ATOL * max(1.0, np.abs(
        want).max())


def test_want_cache_builds_the_prefill_cache():
    """``attention_block(want_cache=True)`` on a cache-less forward returns
    the output and a fresh cache equal to a prefill into a preallocated
    one."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import Runtime, rope_angles
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")),
                              n_kv_heads=2)
    gen = torch.Generator().manual_seed(0)
    p = attn.init_attention(cfg, gen, "cpu")
    x = torch.randn(2, 5, cfg.d_model, generator=gen)
    ang = rope_angles(torch.arange(5)[None].expand(2, 5), cfg.head_dim_,
                      cfg.rope_theta)
    rt = Runtime(attn_impl="torch", norm_impl="torch")
    out, cache = attn.attention_block(cfg, p, x, ang, rt, want_cache=True)
    pre = attn.make_kv_cache(cfg, 2, 5, torch.float32, "cpu")
    out2 = attn.attention_block(cfg, p, x, ang, rt, cache=pre)
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    for k in cache:
        assert torch.equal(cache[k], pre[k]), k
    assert int(cache["idx"]) == 5 and cache["kpos"].tolist() == list(range(5))


# ---------------------------------------------------------------------------
# the static engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_len=32, n_slots=4, block_size=8, prefill_chunk=8,
                 steps_per_tick=3)


@pytest.mark.parametrize("case", ["qwen3-gqa", "llama2-1b", "rwkv6"])
def test_generate_static_matches_jax_and_the_paged_engine(case):
    """Greedy ``generate_static`` tokens equal the JAX engine's
    ``generate_static``; for an attention stack they equal the port's
    paged engine bit for bit (``tests/test_serving.py::
    test_paged_greedy_bitmatches_dense``), and ``generate`` pages; a
    recurrent stack's ``generate`` serves statically."""
    import jax.numpy as jnp

    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.bridge import params_from_jax
    from repro_torch.serve import ServeEngine
    jc, tc = _cfgs(*SINGLE[case])
    tree = _jax_tree(jc)
    jrt, trt = _rts("kernel")
    jeng = JServeEngine(jc, tree, jrt, **ENGINE_KW)
    eng = ServeEngine(tc, params_from_jax(tree), trt, device="cpu",
                      **ENGINE_KW)
    prompts = _prompts(jc.vocab_size, 3)
    got = eng.generate_static(prompts, N_NEW)
    np.testing.assert_array_equal(got, np.asarray(jeng.generate_static(
        jnp.asarray(prompts), N_NEW)))
    assert eng.stats == {"forward_calls": N_NEW, "decode_steps": N_NEW - 1}
    assert eng.paged_ok == (case != "rwkv6")
    np.testing.assert_array_equal(eng.generate(prompts, N_NEW), got)
    if eng.paged_ok:
        assert eng.stats["forward_calls"] > N_NEW    # the queue ran


def test_static_sampling_is_reproducible_and_fresh():
    """A fixed seed reproduces the sampled tokens; successive calls
    without one draw fresh ones; a row's tokens follow the paged path's
    contract (stream = row, absolute position), so the paged engine
    samples the same tokens from the same logits."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.serve import ServeEngine
    jc, tc = _cfgs(*QWEN)
    eng = ServeEngine(tc, params_from_jax(_jax_tree(jc)), _rts("torch")[1],
                      device="cpu", **ENGINE_KW)
    prompts = _prompts(jc.vocab_size, 3)
    a = eng.generate_static(prompts, N_NEW, temperature=0.9, seed=5)
    np.testing.assert_array_equal(
        a, eng.generate_static(prompts, N_NEW, temperature=0.9, seed=5))
    b = eng.generate_static(prompts, N_NEW, temperature=0.9)
    c = eng.generate_static(prompts, N_NEW, temperature=0.9)
    assert not np.array_equal(b, c)
    assert not np.array_equal(a, eng.generate_static(prompts, N_NEW))
    np.testing.assert_array_equal(
        a, eng.generate(prompts, N_NEW, temperature=0.9, seed=5))


def test_paged_forward_keeps_refusing_a_recurrent_stack():
    from repro_torch.bridge import params_from_jax
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeEngine
    jc, tc = _cfgs(*RWKV)
    params = params_from_jax(_jax_tree(jc))
    with pytest.raises(NotImplementedError, match="dense caches"):
        tfm.forward(tc, params, {"tokens": torch.zeros(1, 4,
                                                       dtype=torch.int32),
                                 "pos": torch.zeros(1, 1, dtype=torch.int32)},
                    _rts("torch")[1], cache={"layers": [], "paged": {}})
    eng = ServeEngine(tc, params, _rts("torch")[1], device="cpu",
                      **ENGINE_KW)
    with pytest.raises(RuntimeError, match="paged cache path"):
        eng.submit(np.arange(4), 2)


# ---------------------------------------------------------------------------
# cache placement against the JAX package's cache_shardings
# ---------------------------------------------------------------------------

# (spec, mode, global batch, seq_len) on 8 devices
PLACEMENTS = [("fsdp_tp2", "decode", 8, 4096), ("fsdp_tp4", "decode", 2, 4096),
              ("fsdp", "prefill", 8, 1024), ("ddp_tp2", "decode", 1, 8192)]


@pytest.mark.parametrize("spec,mode,B,S", PLACEMENTS)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama2-1b", "rwkv6-1.6b",
                                  "qwen3-0.6b-swa", "qwen2-1.5b",
                                  "h2o-danube-1.8b", "granite-20b",
                                  "jamba-v0.1-52b"])
def test_cache_shardings_match_jax(arch, spec, mode, B, S):
    """Every leaf of the full-size dense cache: the port's fitted spec is
    the JAX ``cache_shardings`` spec (JAX's stacked layer dim dropped),
    and its shard shape the JAX sharding's ``shard_shape``, on abstract
    meshes of 8 devices (qwen3 with a window of 2048 keeps a ring of
    slots; h2o-danube-1.8b's window of 4096 keeps one at S 8192; qwen2's
    Kv 2 and granite's Kv 1 are sequence-sharded, never split by
    heads)."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jax_get_config
    from repro.core import parallel as jpar
    from repro.models import transformer as jtfm
    from repro.models.layers import Runtime as JRuntime
    from repro_torch import strategy
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import parallel as par
    from repro_torch.models import transformer as tfm
    name, _, swa = arch.partition("-swa")
    over = dict(sliding_window=2048) if arch.endswith("-swa") else {}
    jcfg = dataclasses.replace(jax_get_config(name), **over)
    cfg = dataclasses.replace(get_config(name), **over)
    if name == "rwkv6-1.6b" and "tp4" in spec:
        spec = spec.replace("tp4", "tp2")
    shape = ShapeConfig("x", S, B, mode)
    plan = strategy.parse(spec).to_plan(
        cfg, strategy.host_topology(n_devices=8), shape, abstract=True)
    sizes = dict(plan.mesh)
    jplan = jpar.ParallelPlan(
        mesh=AbstractMesh(tuple(sizes.values()), tuple(sizes)), dp=plan.dp,
        fsdp=plan.fsdp, tp=plan.tp, attn=plan.attn, kv_tp=plan.kv_tp,
        shape_mode=plan.shape_mode,
        decode_cache_axes=plan.decode_cache_axes,
        seq_parallel_residuals=plan.seq_parallel_residuals)
    jshapes = jax.eval_shape(lambda: jtfm.init_cache(
        jcfg, B, S, np.float32, JRuntime()))
    jleaves = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    jshard = jax.tree.leaves(jpar.cache_shardings(jcfg, jplan, jshapes))
    cache = tfm.cache_shapes(cfg, B, S, torch.float32)
    specs = par.cache_specs(cfg, plan, cache)
    places = par.cache_shardings(cfg, plan, cache)
    _, start, period, _ = jtfm.layer_plan(jcfg)
    assert len(jleaves) == len(jshard) > 0
    for (path, leaf), sh in zip(jleaves, jshard):
        names = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        stacked = names[0] == "blocks"
        layer = start + names[1] if stacked else names[1]
        node, spec_node, place = cache["layers"][layer], \
            specs["layers"][layer], places["layers"][layer]
        for k in names[2:]:
            node, spec_node, place = node[k], spec_node[k], place[k]
        jspec = tuple(_norm(e) for e in tuple(sh.spec) + (None,) * (
            leaf.ndim - len(sh.spec)))[int(stacked):]
        assert tuple(_norm(e) for e in spec_node) == jspec, (names, spec)
        jlocal = sh.shard_shape(leaf.shape)[int(stacked):]
        assert par.local_shape(plan, node.shape, place) == jlocal, names


def _norm(e):
    if isinstance(e, tuple):
        e = tuple(a for a in e if a)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e
