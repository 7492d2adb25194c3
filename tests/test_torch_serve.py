"""The port's serving slice against the JAX package: params bridge, paged
forward, the continuous-batching engine, the CLI, and import hygiene.

JAX-initialised weights reach the port through ``repro_torch.bridge``;
prompts come from numpy with a fixed seed.  JAX's Pallas path runs its
kernels in interpret mode; the port's kernel path runs each kernel's plain
version on these CPU tensors.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import transformer as jtfm
from repro.models.layers import Runtime as JRuntime
from repro.serve import ServeEngine as JServeEngine
from repro.serve.paged_cache import init_paged_pools as jax_init_pools
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import Runtime
from repro_torch.serve import ServeEngine, init_paged_pools

ROOT = Path(__file__).resolve().parents[1]
PORT_RT = {"torch": Runtime(attn_impl="torch", norm_impl="torch"),
           "kernel": Runtime()}
JAX_RT = {"torch": JRuntime(),
          "kernel": JRuntime(attn_impl="pallas", norm_impl="pallas")}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    jc = dataclasses.replace(jax_reduced(jax_get_config(arch)), **over)
    tc = dataclasses.replace(reduced(get_config(arch)), **over)
    return jc, tc


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jtfm.init_params(cfg,
                                                     jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def qwen_gqa():
    """Reduced qwen3-0.6b with 2 kv heads (reduced qwen3 is MHA)."""
    jc, tc = _cfgs("qwen3-0.6b", n_kv_heads=2)
    tree = _jax_params(jc)
    return jc, tc, tree, params_from_jax(tree)


# ---------------------------------------------------------------------------
# params bridge
# ---------------------------------------------------------------------------

def test_params_bridge_round_trips_exactly(qwen_gqa):
    jc, tc, tree, params = qwen_gqa
    assert len(params.layers) == tc.n_layers
    back = params_to_jax(params, tc)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # layer i of the port is slice i of the stacked JAX blocks
    np.testing.assert_array_equal(
        params.layers[1]["mixer"]["wq"].detach().numpy(),
        tree["blocks"][0]["mixer"]["wq"][1])


def test_init_params_shapes_match_jax(qwen_gqa):
    jc, tc, tree, _ = qwen_gqa
    own = params_to_jax(ttfm.init_params(tc, seed=0, device="cpu"), tc)
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype), tree)
    assert jax.tree.map(lambda a: (a.shape, a.dtype), own) == shapes


# ---------------------------------------------------------------------------
# paged forward: one prefill chunk per request, then three decode steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("arch,over", [("qwen3-0.6b", dict(n_kv_heads=2)),
                                       ("llama2-1b", {})])
def test_paged_forward_matches_jax(arch, over, impl):
    jc, tc = _cfgs(arch, **over)
    tree = _jax_params(jc, seed=1)
    params = params_from_jax(tree)
    jrt, trt = JAX_RT[impl], PORT_RT[impl]
    rng = np.random.default_rng(0)
    B, C, bs, nb, P = 2, 8, 4, 5, 12
    tbl = np.full((B, nb), -1, np.int32)
    tbl[0, :4] = [9, 2, 6, 0]
    tbl[1, :4] = [3, 11, 5, 8]
    lens = [8, 5]                              # request 1: a padded chunk
    jpools = jax_init_pools(jc, P, bs, jnp.float32)
    tcache = init_paged_pools(tc, P, bs, torch.float32, "cpu")
    with torch.no_grad():
        for b in range(B):
            chunk = rng.integers(0, jc.vocab_size, (1, C)).astype(np.int32)
            jl, jc_out, _ = jtfm.forward(
                jc, tree, {"tokens": jnp.asarray(chunk),
                           "pos": jnp.zeros((1, 1), jnp.int32)}, jrt,
                cache={**jpools, "paged": {"tbl": jnp.asarray(tbl[b:b + 1]),
                                           "ctx": jnp.zeros(1, jnp.int32)}})
            jpools = {"prefix": jc_out["prefix"], "blocks": jc_out["blocks"]}
            tcache["paged"] = {"tbl": torch.tensor(tbl[b:b + 1]),
                               "ctx": torch.zeros(1, dtype=torch.int32)}
            tl = ttfm.forward(tc, params, {"tokens": torch.tensor(chunk),
                                           "pos": torch.zeros(
                                               (1, 1), dtype=torch.int32)},
                              trt, tcache)
            assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < 1e-4
        ctx = np.array(lens, np.int32)
        for _ in range(3):
            toks = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
            jl, jc_out, _ = jtfm.forward(
                jc, tree, {"tokens": jnp.asarray(toks),
                           "pos": jnp.asarray(ctx[:, None])}, jrt,
                cache={**jpools, "paged": {"tbl": jnp.asarray(tbl),
                                           "ctx": jnp.asarray(ctx)}})
            jpools = {"prefix": jc_out["prefix"], "blocks": jc_out["blocks"]}
            tcache["paged"] = {"tbl": torch.tensor(tbl),
                               "ctx": torch.tensor(ctx)}
            tl = ttfm.forward(tc, params, {"tokens": torch.tensor(toks),
                                           "pos": torch.tensor(ctx[:, None])},
                              trt, tcache)
            assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < 1e-4
            ctx = ctx + 1
    # the pools agree too (the port's carry one extra sink block)
    jk = np.asarray(jpools["blocks"][0]["kv"]["k_pool"])    # (L, P, ...)
    for i, lc in enumerate(tcache["layers"]):
        assert np.max(np.abs(lc["k_pool"][:-1].numpy() - jk[i])) < 1e-4


# ---------------------------------------------------------------------------
# engine: greedy token ids equal to the JAX paged engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_len=48, n_slots=2, block_size=8, prefill_chunk=8,
                 steps_per_tick=4, n_blocks=14)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_engine_greedy_matches_jax(qwen_gqa, impl):
    """More requests than slots, ragged prompts: per-request greedy tokens
    equal the JAX engine's, through generate() and submit()."""
    jc, tc, tree, params = qwen_gqa
    jeng = JServeEngine(jc, tree, JAX_RT[impl], **ENGINE_KW)
    teng = ServeEngine(tc, params, PORT_RT[impl], device="cpu", **ENGINE_KW)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, tc.vocab_size, (3, 11)).astype(np.int32)
    out_t = teng.generate(prompts, 7)
    out_j = np.asarray(jeng.generate(jnp.asarray(prompts), 7))
    np.testing.assert_array_equal(out_t, out_j)
    n_new = 6
    lens = [3, 17, 9, 25, 1]
    reqs = [rng.integers(0, tc.vocab_size, L).astype(np.int32) for L in lens]
    rid_t = [teng.submit(p, n_new) for p in reqs]
    rid_j = [jeng.submit(p, n_new) for p in reqs]
    done_t = teng.run_until_drained()
    done_j = jeng.run_until_drained(key=jax.random.PRNGKey(0))
    for rt_, rj in zip(rid_t, rid_j):
        np.testing.assert_array_equal(done_t[rt_], done_j[rj])
    assert teng._sched.alloc.n_free == ENGINE_KW["n_blocks"]
    assert teng.stats["decode_steps"] > 0


def test_engine_sampled_reproducible_and_batch_invariant(qwen_gqa):
    _, tc, _, params = qwen_gqa
    eng = ServeEngine(tc, params, Runtime(), device="cpu", max_len=48,
                      n_slots=4, block_size=8, prefill_chunk=8,
                      steps_per_tick=4)
    prompts = np.random.default_rng(4).integers(
        0, tc.vocab_size, (3, 9)).astype(np.int32)
    a = eng.generate(prompts, 8, temperature=0.9, seed=11)
    b = eng.generate(prompts, 8, temperature=0.9, seed=11)
    np.testing.assert_array_equal(a, b)
    greedy = eng.generate(prompts, 8)
    assert not np.array_equal(a, greedy)       # sampling did something
    rid = eng.submit(prompts[0], 8, temperature=0.9, stream=0)
    solo = eng.run_until_drained(seed=11)[rid]
    np.testing.assert_array_equal(solo, a[0, 9:])


def test_engine_telemetry_accounts_every_token(qwen_gqa, tmp_path):
    """TTFT once per request, per-token latency once per decoded token,
    lifecycle counters, and a JSONL stream that validates."""
    import json

    from repro_torch import telemetry as tel
    _, tc, _, params = qwen_gqa
    rec = tel.Recorder()
    sink = rec.add_sink(tel.JsonlSink(str(tmp_path / "ev.jsonl")))
    eng = ServeEngine(tc, params, Runtime(), device="cpu", telemetry=rec,
                      **ENGINE_KW)
    eng.generate(np.zeros((3, 5), np.int32), 7)
    sink.close()
    snap = rec.metrics.snapshot()
    assert snap["serve/ttft_s"]["count"] == 3
    assert snap["serve/token_latency_s"]["count"] == 3 * 6   # 1st: prefill
    assert snap["serve/submitted"]["value"] == 3
    assert snap["serve/completed"]["value"] == 3
    events = [json.loads(x) for x in (tmp_path / "ev.jsonl").open()]
    assert events and not [e for e in events if tel.validate_event(e)]
    assert {"serve/tick", "serve/prefill_chunk", "serve/decode_segment"} <= {
        e["name"] for e in events if e["kind"] == "span"}


def test_engine_reports_a_stalled_queue(qwen_gqa):
    """A queue head that no pool could hold stops the engine with a clear
    error instead of spinning."""
    _, tc, _, params = qwen_gqa
    eng = ServeEngine(tc, params, Runtime(), device="cpu", max_len=64,
                      n_slots=2, block_size=8, prefill_chunk=8, n_blocks=2)
    eng.submit(np.arange(30), 8)
    with pytest.raises(RuntimeError, match="stalled"):
        eng.run_until_drained()


def test_engine_needs_params_on_its_device(qwen_gqa):
    _, tc, _, params = qwen_gqa
    with pytest.raises(ValueError):
        ServeEngine(tc, params.to("meta"), Runtime(), max_len=16,
                    device="cpu")


# ---------------------------------------------------------------------------
# CLI, configs and import hygiene
# ---------------------------------------------------------------------------

def _run(args, **kw):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_cli_serves_on_cpu():
    r = _run(["-m", "repro_torch.launch.serve", "--device", "cpu",
              "--reduced", "--n_new", "4"])
    assert r.returncode == 0, r.stderr
    assert "tok/s" in r.stdout and "token latency p50" in r.stdout


def test_cli_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["-m", "repro_torch.launch.serve", "--reduced", "--n_new", "4"])
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_unported_archs_name_their_slice():
    with pytest.raises(NotImplementedError, match="MoE"):
        get_config("deepseek-moe-16b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_port_imports_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import repro_torch, repro_torch.serve.engine, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.train.trainer, repro_torch.optim, "
            "repro_torch.data, repro_torch.strategy, "
            "repro_torch.core.parallel, repro_torch.core.costmodel, "
            "repro_torch.core.pipeline, "
            "repro_torch.perf.flops, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.perf.pipeline_probe, "
            "repro_torch.perf.comms, repro_torch.perf.memory, "
            "repro_torch.launch.specs, repro_torch.models.attention, "
            "repro_torch.models.transformer, repro_torch.models.layers, "
            "repro_torch.bridge, repro_torch.configs, "
            "repro_torch.strategy.topology, "
            "repro_torch.strategy.descriptor, repro_torch.checkpointing, "
            "repro_torch.resilience, repro_torch.resilience.supervisor, "
            "chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro(\.|\s|$)"
                     r"|from\s+repro(\.|\s))", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, (f, hits)
