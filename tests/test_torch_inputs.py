"""Non-token inputs of the port against the JAX package, on the CPU:
musicgen-medium's frame ``embeds`` in place of tokens, and qwen2-vl-2b's
``vision_embeds`` over the first positions with M-RoPE over 3-D
``position_ids``, at the reduced sizes (2 layers, d 256, 4 heads of 64;
qwen2-vl over Kv 2, V 16, sections (12, 10, 10)).

Weights come from the JAX initialiser through ``repro_torch.bridge``,
inputs from numpy with a fixed seed; the position ids are those of a 4 x 4
patch grid at t 0 and text after it, so t, h and w differ (with t = h = w
M-RoPE is RoPE, and a wrong split would not show).  JAX runs its
single-device ``jnp`` path; the port's kernel path runs each kernel's
plain version on these CPU tensors.  The bars are those of
``tests/test_torch_dense.py``: logits within 1e-4 of their scale, the loss
within 1e-5, gradients and moments within 1e-4 of each leaf's scale
(``GRAD_REL``), metrics within 1e-5 relative, parameters in units of lr;
M-RoPE's angles and the embedding within 1e-6 of their scale.  The gloo
worlds are in ``tests/test_torch_inputs_worlds.py``.
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import strategy as jstrategy
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import specs as jspecs
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.layers import Runtime as JRuntime
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch import strategy
from repro_torch.bridge import (grads_to_jax, opt_state_to_jax,
                                params_from_jax, params_to_jax)
from repro_torch.configs import SHAPES, ShapeConfig, get_config, reduced
from repro_torch.launch import specs
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import Runtime
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import TrainConfig, make_train_step
from test_torch_fsdp import _few_threads  # noqa: F401
from test_torch_fsdp import cli_env

MUSICGEN, QWEN2VL = "musicgen-medium", "qwen2-vl-2b"
ARCHS = [MUSICGEN, QWEN2VL]
RUNTIMES = {"kernel": Runtime(),
            "torch": Runtime(attn_impl="torch", norm_impl="torch")}
LOGIT_REL, LOSS_ATOL, GRAD_REL, EXACT_REL = 1e-4, 1e-5, 1e-4, 1e-6
GRID = (4, 4)                   # the reduced V 16 as a patch grid
B, S = 2, 24                    # S > V: text after the patches
LR, WD = 1e-3, 0.1


def _cfgs(arch):
    return jax_reduced(jax_get_config(arch)), reduced(get_config(arch))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc, tc = _cfgs(request.param)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(3)))
    return request.param, jc, tc, tree


def _grid_ids(n_rows, n_pos):
    return specs.grid_position_ids(n_rows, n_pos, *GRID).numpy()


def _batch(cfg, rows, n_pos, seed=0, masked=0, vision=True, ids=True):
    """numpy inputs of ``cfg``'s input mode: frame embeds ~ N(0, 0.1²) or
    tokens; labels (the last ``masked`` masked); patch embeds ~ N(0,
    0.02²) and the grid's position ids for a ``tokens+vision`` model."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "embeddings":
        out["embeds"] = (0.1 * rng.standard_normal(
            (rows, n_pos, cfg.d_model))).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (rows, n_pos)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (rows, n_pos)).astype(np.int32)
    if masked:
        labels[:, -masked:] = -1
    out["labels"] = labels
    if cfg.input_mode == "tokens+vision":
        if vision:
            out["vision_embeds"] = (0.02 * rng.standard_normal(
                (rows, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
        if ids:
            out["position_ids"] = _grid_ids(rows, n_pos)
    return out


def _torch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def _jnp(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_close(port_tree, jax_tree, rel):
    """Each leaf within ``rel`` of its own scale; the key bias's (zero but
    for rounding: softmax ignores q·bk) within ``rel`` of the query
    bias's beside it; a leaf that is zero in JAX (the unused token table's
    gradient and moments under frame embeddings) exactly zero."""
    pa, pb = _leaves(port_tree), _leaves(jax_tree)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    scales = {jax.tree_util.keystr(path[:-1]): np.max(np.abs(b))
              for path, b in pb if path[-1].key == "bq"}
    for (path, a), (_, b) in zip(pa, pb):
        assert a.shape == b.shape, path
        if not np.any(b):
            assert not np.any(a), jax.tree_util.keystr(path)
            continue
        err = _rel(a, b)
        if path[-1].key == "bk":
            err = float(np.max(np.abs(a - b))) / scales[
                jax.tree_util.keystr(path[:-1])]
        assert err < rel, (jax.tree_util.keystr(path), err)


def _port_grads(params):
    """Name-keyed gradients, a leaf the inputs leave unused (no gradient
    in the port) as zeros, as JAX differentiates it."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.named_parameters()}


# ---------------------------------------------------------------------------
# configs, specs, M-RoPE, the embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(reduced(get_config(arch))) == \
        dataclasses.asdict(jax_reduced(jax_get_config(arch)))
    ttfm.check_supported(get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_are_the_jax_packages(arch):
    """The dry run's train and prefill inputs: JAX's names, shapes and
    dtypes (embeddings bf16, ids int32), and so the same input bytes; the
    concrete batch has the same structure."""
    cfg, jc = get_config(arch), jax_get_config(arch)
    for fn, jfn in ((specs.train_batch_specs, jspecs.train_batch_specs),
                    (specs.prefill_batch_specs,
                     jspecs.prefill_batch_specs)):
        for name in ("train_4k", "prefill_32k"):
            mine = fn(cfg, SHAPES[name])
            ref = jfn(jc, JShapeConfig(**dataclasses.asdict(SHAPES[name])))
            assert {k: (tuple(s.shape), str(s.dtype).split(".")[-1])
                    for k, s in mine.items()} == {
                k: (tuple(s.shape), str(s.dtype)) for k, s in ref.items()}
    small = specs.concrete_train_batch(reduced(cfg), 2, 20, seed=1)
    jsmall = jspecs.concrete_train_batch(jax_reduced(jc), 2, 20,
                                         jax.random.PRNGKey(1))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in small.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jsmall.items()}


def test_grid_position_ids_tell_t_h_and_w_apart():
    ids = specs.grid_position_ids(2, 24, *GRID)
    assert ids.shape == (3, 2, 24) and ids.dtype == torch.int32
    t, h, w = ids[:, 0, :16]
    assert not torch.any(t) and torch.equal(h, torch.arange(16) // 4) \
        and torch.equal(w, torch.arange(16) % 4)
    text = ids[:, 0, 16:]
    assert torch.equal(text[0], text[1]) and torch.equal(text[1], text[2])
    assert torch.equal(text[0], torch.arange(8, dtype=torch.int32) + 4)


@pytest.mark.parametrize("head_dim,sections", [(64, (12, 10, 10)),
                                               (128, (16, 24, 24))])
def test_mrope_angles_match_jax(head_dim, sections):
    """At the reduced sections and qwen2-vl-2b's, on ids whose t, h and w
    differ; with t = h = w they are RoPE's angles."""
    ids = _grid_ids(2, 24)
    got = tlayers.mrope_angles(torch.tensor(ids), head_dim, 1e6,
                               sections).numpy()
    want = np.asarray(jlayers.mrope_angles(jnp.asarray(ids), head_dim, 1e6,
                                           sections))
    assert got.shape == want.shape == (2, 24, head_dim // 2)
    assert _rel(got, want) < EXACT_REL
    pos = torch.arange(24, dtype=torch.int32)[None].expand(2, 24)
    same = tlayers.mrope_angles(pos[None].expand(3, 2, 24), head_dim, 1e6,
                                sections)
    assert torch.equal(same, tlayers.rope_angles(pos, head_dim, 1e6))
    with pytest.raises(ValueError, match="sum to"):
        tlayers.mrope_angles(torch.tensor(ids), head_dim, 1e6,
                             (1,) + tuple(sections[1:]))


@pytest.mark.parametrize("arch,n_pos", [(MUSICGEN, 24), (QWEN2VL, 12),
                                        (QWEN2VL, 24)])
def test_embedding_matches_jax(arch, n_pos):
    """The residual stream's start: frame embeds cast to the compute type
    plus the sinusoidal table (musicgen); the token embedding with the
    patches over the first min(V, S) positions (qwen2-vl: S 12 < V 16
    and S 24 > V)."""
    jc, tc = _cfgs(arch)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(3)))
    b = _batch(jc, B, n_pos, seed=4)
    pos = np.broadcast_to(np.arange(n_pos, dtype=np.int32)[None],
                          (B, n_pos))
    want = np.asarray(jtfm._embed_inputs(jc, tree, _jnp(b), JRuntime(),
                                         jnp.asarray(pos)))
    params = params_from_jax(tree)
    with torch.no_grad():
        got = ttfm._embed(tc, tlayers.local_params(params.embed), _torch(b),
                          torch.tensor(pos), Runtime(), False, False)
    assert _rel(got.numpy(), want) < EXACT_REL
    if "vision_embeds" in b:
        n = min(jc.vision_tokens, n_pos)
        np.testing.assert_array_equal(got.numpy()[:, :n],
                                      b["vision_embeds"][:, :n])


# ---------------------------------------------------------------------------
# the whole model: logits, loss, gradients, AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("inputs", ["full", "tokens"])
def test_forward_and_loss_match_jax(model, impl, inputs):
    """With every input of the arch's mode ('full'), and with tokens
    alone ('tokens': musicgen's codec tokens through its table, qwen2-vl's
    text with M-RoPE's t = h = w fallback)."""
    _, jc, tc, tree = model
    params = params_from_jax(tree)
    b = _batch(jc, B, S, seed=1, masked=3)
    if inputs == "tokens":
        rng = np.random.default_rng(9)
        b = {"tokens": rng.integers(0, jc.vocab_size, (B, S)).astype(
            np.int32), "labels": b["labels"]}
    fwd = {k: v for k, v in b.items() if k != "labels"}
    with torch.no_grad():
        lg = ttfm.forward(tc, params, _torch(fwd), RUNTIMES[impl])
        loss, m = ttfm.loss_fn(tc, params, _torch(b), RUNTIMES[impl])
    jlg, _, _ = jtfm.forward(jc, tree, _jnp(fwd), JRuntime())
    jloss, jm = jtfm.loss_fn(jc, tree, _jnp(b), JRuntime())
    assert _rel(lg.numpy(), jlg) < LOGIT_REL
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    assert float(m["ntok"]) == float(jm["ntok"])


def _jax_step_fn(jc, grad_accum=1):
    return jax.jit(jax_make_train_step(jc, JRuntime(), JTrainConfig(
        steps=3, warmup=1, grad_accum=grad_accum,
        opt=JAdamWConfig(lr=LR, weight_decay=WD))))


def test_grads_and_adamw_steps_match_jax(model):
    """Gradients of one batch within GRAD_REL of each leaf's scale (the
    unused token table's zero in both under frame embeddings), then three
    AdamW steps with weight decay 0.1 of the kernel path (plain versions
    here) against JAX's ``make_train_step``: metrics within 1e-5, moments
    within GRAD_REL of scale, parameters in units of lr; under frame
    embeddings the token table, whose gradient is zero, only decays, by
    the same factor in both."""
    arch, jc, tc, tree = model
    params = params_from_jax(tree)
    b = _batch(jc, B, S, seed=2, masked=2)
    loss, _ = ttfm.loss_fn(tc, params, _torch(b), Runtime())
    loss.backward()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jtfm.loss_fn(jc, p, bb, JRuntime()), has_aux=True))(
        tree, _jnp(b))
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    assert (params.embed["tok"].grad is None) == (arch == MUSICGEN)
    _assert_trees_close(grads_to_jax(_port_grads(params), tc),
                        jax.tree.map(np.asarray, jgrads), GRAD_REL)

    params = params_from_jax(tree)
    step = make_train_step(tc, Runtime(), TrainConfig(
        steps=3, warmup=1, opt=AdamWConfig(lr=LR, weight_decay=WD)))
    jstep = _jax_step_fn(jc)
    state, jstate, jtree = init_opt_state(params), jax_init_opt_state(tree), \
        tree
    for i in range(3):
        b = _batch(jc, B, S, seed=10 + i, masked=i)
        _, state, m = step(params, state, _torch(b))
        jtree, jstate, jm = jstep(jtree, jstate, _jnp(b))
        for k in ("loss", "nll", "ntok", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) < 1e-5 * max(
                1.0, abs(float(jm[k]))), (i, k, float(m[k]), float(jm[k]))
    jstate = jax.tree.map(np.asarray, jstate)
    _assert_trees_close(opt_state_to_jax(state, tc)["m"], jstate["m"],
                        GRAD_REL)
    mine, ref = params_to_jax(params, tc), jax.tree.map(np.asarray, jtree)
    for (path, a), (_, b) in zip(_leaves(mine), _leaves(ref)):
        d = np.abs(a - b) / LR
        assert d.max() < 0.5, (jax.tree_util.keystr(path), d.max())
        assert path[-1].key == "bk" or d.mean() < 1e-3, \
            (jax.tree_util.keystr(path), d.mean())
    if arch == MUSICGEN:
        tok0 = tree["embed"]["tok"]
        for got in (mine["embed"]["tok"], ref["embed"]["tok"]):
            factor = float(np.sum(got * tok0) / np.sum(tok0 * tok0))
            assert 0.999 < factor < 1.0
            assert _rel(got, factor * tok0) < EXACT_REL
        assert not np.any(opt_state_to_jax(state, tc)["m"]["embed"]["tok"])


def test_grad_accum_2_matches_jax_grad_accum_1():
    """The port's ``grad_accum=2`` step on qwen2-vl's batch (vision
    embeds, 3-D position ids) against JAX's ``grad_accum=1`` on the same
    batch (no label masked, so the two microbatches' means average to the
    batch's): metrics within 1e-5, moments within GRAD_REL.  The port
    slices each leaf on its own batch dim: dim 1 of ``position_ids`` (3,
    B, S), as JAX's batch shardings place it.  JAX's own gradient
    accumulation slices every leaf on dim 0
    (``src/repro/train/trainer.py:65-71``), so its ``grad_accum=2`` on
    this batch raises ("mul got incompatible shapes for broadcasting"):
    that step is no reference."""
    jc, tc = _cfgs(QWEN2VL)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(5)))
    b = _batch(jc, 4, S, seed=6)
    params = params_from_jax(tree)
    step = make_train_step(tc, Runtime(), TrainConfig(
        steps=3, warmup=1, grad_accum=2,
        opt=AdamWConfig(lr=LR, weight_decay=WD)))
    _, state, m = step(params, init_opt_state(params), _torch(b))
    _, jstate, jm = _jax_step_fn(jc)(tree, jax_init_opt_state(tree),
                                     _jnp(b))
    for k in ("loss", "nll", "ntok", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) < 1e-5 * max(
            1.0, abs(float(jm[k]))), (k, float(m[k]), float(jm[k]))
    _assert_trees_close(opt_state_to_jax(state, tc)["m"],
                        jax.tree.map(np.asarray, jstate["m"]), GRAD_REL)
    rows = ttfm.batch_rows(_torch(b), 1, 3)
    assert rows["position_ids"].shape == (3, 2, S)
    assert rows["vision_embeds"].shape == (2, jc.vision_tokens, jc.d_model)


# ---------------------------------------------------------------------------
# serving: prefill, then decode steps with extra inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_prefill_and_decode_with_extra_match_jax(model, impl):
    """A prefill of 20 positions (musicgen's frame embeds; qwen2-vl's
    tokens with the 16 patches and the grid's ids) into dense caches, then
    4 decode steps, each with its frame embedding or its position ids
    through ``extra``: every logit within LOGIT_REL of JAX's ``prefill``
    and ``decode_step`` on the same inputs, and of the forward over the
    whole stream."""
    arch, jc, tc, tree = model
    params = params_from_jax(tree)
    n_pre, n_dec = 20, 4
    b = _batch(jc, B, n_pre + n_dec, seed=7)
    b.pop("labels")
    pre = {k: v if k == "vision_embeds" else
           v[:, :, :n_pre] if k == "position_ids" else v[:, :n_pre]
           for k, v in b.items()}
    rt = RUNTIMES[impl]
    with torch.no_grad():
        full = ttfm.forward(tc, params, _torch(b), rt).numpy()
        lg, cache = ttfm.prefill(tc, params, _torch(pre), rt, n_pre + n_dec)
    jlg, jcache = jtfm.prefill(jc, tree, _jnp(pre), JRuntime(),
                               n_pre + n_dec)
    assert _rel(lg.numpy(), jlg) < LOGIT_REL
    assert _rel(lg.numpy(), full[:, :n_pre]) < LOGIT_REL
    tokens = np.zeros((B, 1), np.int32)
    for t in range(n_pre, n_pre + n_dec):
        if arch == MUSICGEN:
            extra = {"embeds": b["embeds"][:, t:t + 1]}
        else:
            tokens = b["tokens"][:, t:t + 1]
            extra = {"position_ids": b["position_ids"][:, :, t:t + 1]}
        with torch.no_grad():
            lg, cache = ttfm.decode_step(tc, params, cache,
                                         torch.tensor(tokens), t, rt,
                                         extra=_torch(extra))
        jlg, jcache = jtfm.decode_step(jc, tree, jcache, jnp.asarray(tokens),
                                       jnp.asarray(t, jnp.int32), JRuntime(),
                                       extra=_jnp(extra))
        assert _rel(lg.numpy(), jlg) < LOGIT_REL, t
        assert _rel(lg.numpy()[:, 0], full[:, t]) < LOGIT_REL, t


def test_static_engine_serves_token_prompts_as_jax(model):
    """Both archs serve token prompts from dense caches (the paged engine
    refuses them, as the JAX package's gate does): greedy tokens equal the
    JAX engine's ``generate_static``."""
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.serve import ServeEngine
    _, jc, tc, tree = model
    prompts = np.random.default_rng(3).integers(
        0, jc.vocab_size, (2, 9)).astype(np.int32)
    eng = ServeEngine(tc, params_from_jax(tree), Runtime(), max_len=16,
                      device="cpu")
    jeng = JServeEngine(jc, tree, JRuntime(), max_len=16)
    assert not eng.paged_ok and not jeng.paged_ok
    with pytest.raises(RuntimeError, match="paged cache path"):
        eng.submit(prompts[0], 4)
    np.testing.assert_array_equal(
        eng.generate(prompts, 7),
        np.asarray(jeng.generate_static(jnp.asarray(prompts), 7)))


# ---------------------------------------------------------------------------
# the strategy layer and the CLIs
# ---------------------------------------------------------------------------

# 8 nodes of 8 H100s, islands of 8 (tests/test_torch_moe.py's NODES)
NODES = (strategy.Topology("nodes", 64, island=8, hardware="H100",
                           hbm=80e9),
         jstrategy.Topology("nodes", 64, island=8, hardware="H100",
                            hbm=80e9))


@pytest.mark.parametrize("arch", ARCHS)
def test_planner_ranks_on_nodes_as_jax(arch):
    """On 8 nodes of 8 H100s (host and pod: ``tests/test_torch_strategy.
    py``) the ranking equals JAX's, every candidate lowers, and ``auto``
    picks JAX's best; tp 16 on the pod resolves to context attention (24
    and 12 heads do not split over 16), and M-RoPE refuses a pipeline."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shape, jshape = ShapeConfig("x", 4096, 256, "train"), JShapeConfig(
        "x", 4096, 256, "train")
    ranked = strategy.search(cfg, NODES[0], shape)
    ref = jstrategy.search(jcfg, NODES[1], jshape)
    assert [p.spec for p in ranked] == [p.spec for p in ref]
    assert [p.report.row() for p in ranked] == [p.report.row() for p in ref]
    assert all(p.lowers for p in ranked)
    assert strategy.resolve("auto", cfg, NODES[0], shape)[0].format() == \
        jstrategy.resolve("auto", jcfg, NODES[1], jshape)[0].format()
    assert strategy.parse("fsdp_tp16").resolved_attn(cfg) == \
        jstrategy.parse("fsdp_tp16").resolved_attn(jcfg) == "context"
    if cfg.rope == "mrope":
        with pytest.raises(strategy.StrategyError, match="mrope"):
            strategy.parse("fsdp_pp2_mb4").check(
                strategy.host_topology(n_devices=2), cfg)


def _cli(*args):
    env = cli_env()
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, env=env, timeout=300)


def test_serve_cli_serves_musicgen_statically_and_refuses_paged():
    """``launch.serve --arch musicgen-medium`` serves on the static engine;
    ``--engine paged`` exits as the JAX CLI does."""
    base = ("repro_torch.launch.serve", "--device", "cpu", "--reduced",
            "--arch", MUSICGEN, "--n_new", "4", "--batch", "2",
            "--prompt_len", "8")
    ok = _cli(*base)
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert "engine=static" in ok.stdout
    paged = _cli(*base, "--engine", "paged")
    assert paged.returncode != 0
    assert "--engine paged needs a single-device plan" in paged.stderr


def test_train_cli_trains_qwen2_vl_on_token_batches():
    """``launch.train --arch qwen2-vl-2b`` trains on the token ``Batcher``
    (the M-RoPE fallback), as the JAX CLI does."""
    out = _cli("repro_torch.launch.train", "--device", "cpu", "--reduced",
               "--arch", QWEN2VL, "--steps", "2", "--log_every", "1",
               "--seq_len", "32", "--global_batch", "4", "--strategy",
               "fsdp")
    assert out.returncode == 0, out.stderr[-2000:]
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.stdout.splitlines()
              if line.startswith("step") and "loss" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
