"""The dense extensions of the port against the JAX package, on the CPU:
qwen2-1.5b (qkv bias, GQA with Kv 2), h2o-danube-1.8b (sliding window,
head dim 80) and granite-20b (multi-query attention, layernorm, a GELU
MLP, sinusoidal positions), each narrowed to a few layers but keeping the
shape its extension is about:

- qwen2: 12 heads of 16 over Kv 2 (G 6), qkv bias;
- danube: d 320, 4 heads of 80 over Kv 1, window 8 (prompts run past it);
- granite: 48 heads of 16 over Kv 1 (G 48), layernorm, GELU, sinusoidal;

and, on token inputs at their reduced sizes, the two archs of non-token
inputs (``tests/test_torch_inputs.py`` holds their embeddings, vision
patches and M-RoPE ids): musicgen-medium's codec tokens through its
table (untied head, layernorm, GELU, sinusoidal) and qwen2-vl-2b's text
(M-RoPE's t = h = w fallback, qkv bias, tied), both serving from dense
caches only.

Weights come from the JAX initialiser through ``repro_torch.bridge``,
tokens from numpy with a fixed seed.  JAX runs its single-device ``jnp``
path; the port's kernel path runs each kernel's plain version on these
CPU tensors.  Tolerances: logits within 1e-4 of their scale and the loss
within 1e-5 (f32 sums in another order over 2 layers); gradients within
1e-4 of each leaf's scale and three AdamW steps as
``tests/test_torch_train.py`` holds them; greedy tokens exactly; the plain
flash versions at head dim 80 and the plain flash-decode at G 48 and G 6
within 1e-5 of the JAX oracles (``repro/kernels/ref.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels import ref as jref
from repro.models import transformer as jtfm
from repro.models.layers import Runtime as JRuntime
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.serve import ServeEngine as JServeEngine
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.bridge import (cache_from_jax, cache_to_jax, grads_to_jax,
                                opt_state_to_jax, params_from_jax,
                                params_to_jax)
from repro_torch.configs import LATER, get_config, reduced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import Runtime
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainConfig, make_train_step
from test_torch_fsdp import _few_threads  # noqa: F401

# arch -> the overrides of its narrow variant (on top of ``reduced``)
NARROW = {
    "qwen2-1.5b": dict(d_model=192, n_heads=12, n_kv_heads=2, head_dim=16,
                       d_ff=384),
    "h2o-danube-1.8b": dict(d_model=320, n_heads=4, n_kv_heads=1,
                            head_dim=80, d_ff=512, sliding_window=8),
    "granite-20b": dict(d_model=768, n_heads=48, n_kv_heads=1, head_dim=16,
                        d_ff=512),
    "musicgen-medium": {},
    "qwen2-vl-2b": {},
}
ARCHS = sorted(NARROW)
RUNTIMES = {"kernel": Runtime(),
            "torch": Runtime(attn_impl="torch", norm_impl="torch")}
LOGIT_REL = 1e-4
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
REF_ATOL = 1e-5
S0, N_NEW = 11, 9           # prompts past danube's window of 8
ENGINE_KW = dict(max_len=32, n_slots=2, block_size=4, prefill_chunk=8,
                 steps_per_tick=3)


def _cfgs(arch):
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                **NARROW[arch]),
            dataclasses.replace(reduced(get_config(arch)), **NARROW[arch]))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc, tc = _cfgs(request.param)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(3)))
    return request.param, jc, tc, tree


def _batch(vocab, B, S, seed=0, masked=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[:, -masked:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_close(port_tree, jax_tree, rel):
    """Each leaf within ``rel`` of its own scale; but the key bias's
    gradient (and moments), which is zero but for rounding — adding bk
    adds q·bk to every score of a query, which its softmax ignores — is
    held to the scale of the query bias's beside it."""
    pa, pb = _leaves(port_tree), _leaves(jax_tree)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    scales = {jax.tree_util.keystr(path[:-1]): np.max(np.abs(b))
              for path, b in pb if path[-1].key == "bq"}
    for (path, a), (_, b) in zip(pa, pb):
        assert a.shape == b.shape, path
        err = _rel(a, b)
        if path[-1].key == "bk":
            err = float(np.max(np.abs(a - b))) / scales[
                jax.tree_util.keystr(path[:-1])]
        assert err < rel, (jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    """The registry returns each config with the JAX package's fields and
    its source line; no arch is still to come (``LATER`` is empty since
    jamba-v0.1-52b was ported: ``tests/test_torch_mamba.py``)."""
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert get_config(arch).source
    assert arch not in LATER
    assert LATER == {}


def test_other_stacks_stay_refused():
    """Mamba layers on a stack with positions (granite-20b's sinusoidal
    table with jamba's mixer layout) are refused by the model, and so is
    an input mode the JAX package does not have."""
    jamba = jax_get_config("jamba-v0.1-52b")
    port_cfg = dataclasses.replace(get_config("granite-20b"),
                                   mixer=jamba.mixer,
                                   attn_every=jamba.attn_every)
    with pytest.raises(NotImplementedError, match="attention-only"):
        ttfm.check_supported(port_cfg)
    with pytest.raises(NotImplementedError, match="attention-only"):
        ttfm.check_supported(dataclasses.replace(get_config("granite-20b"),
                                                 input_mode="audio"))


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d_model", [768, 320, 6144])
def test_sinusoidal_table_at_offsets_is_jaxs(d_model):
    """The concatenated [sin | cos] table at the positions of a training
    row, a static decode step (pos + arange) and paged requests (ctx +
    arange per row), in f32 and bf16.  The frequencies come from ``exp``,
    whose last bit may differ between XLA and PyTorch, so at position p
    the angle may move by p times 2 ulp of f32: 2e-6 + 2.4e-7 p."""
    pos = np.stack([np.arange(7), 4090 + np.arange(7),
                    np.array([0, 5, 17, 300, 4095, 4096, 9000])]
                   ).astype(np.int32)
    tol = 2e-6 + 2 * 2.0 ** -23 * pos[..., None]
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = ttfm.sinusoidal_from_positions(torch.tensor(pos), d_model, tdt)
        want = jtfm._sinusoidal_from_positions(jnp.asarray(pos), d_model,
                                               jdt)
        assert got.dtype == tdt and got.shape == (3, 7, d_model)
        err = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        assert (err <= (tol if tdt == torch.float32 else 1e-2 + tol)).all()
        # concatenated halves: column j and j + d/2 share a frequency
        half = d_model // 2
        np.testing.assert_allclose(
            got[..., :half].float().numpy() ** 2
            + got[..., half:].float().numpy() ** 2, 1.0,
            atol=1e-5 if tdt == torch.float32 else 2e-2)


# ---------------------------------------------------------------------------
# forward, loss, gradients, AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_forward_and_loss_match_jax(model, impl):
    _, jc, tc, tree = model
    params = params_from_jax(tree)
    b = _batch(jc.vocab_size, 2, 24, seed=1, masked=3)
    with torch.no_grad():
        lg = ttfm.forward(tc, params, {"tokens": torch.tensor(b["tokens"])},
                          RUNTIMES[impl])
        loss, m = ttfm.loss_fn(tc, params, {k: torch.tensor(v)
                                            for k, v in b.items()},
                               RUNTIMES[impl])
    jlg, _, _ = jtfm.forward(jc, tree, {"tokens": jnp.asarray(b["tokens"])},
                             JRuntime())
    jloss, jm = jtfm.loss_fn(jc, tree, {k: jnp.asarray(v)
                                        for k, v in b.items()}, JRuntime())
    assert _rel(lg.numpy(), jlg) < LOGIT_REL
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    assert float(m["ntok"]) == float(jm["ntok"])


def test_grads_and_adamw_steps_match_jax(model):
    """Gradients of one batch within 1e-4 of each leaf's scale, then three
    AdamW steps of the kernel path (plain versions here) against JAX's
    ``make_train_step``: losses and gradient norms to f32 order, moments
    within 1e-4 of scale, parameters in units of lr as
    ``tests/test_torch_train.py`` holds them."""
    _, jc, tc, tree = model
    params = params_from_jax(tree)
    b = _batch(jc.vocab_size, 2, 24, seed=2, masked=2)
    loss, _ = ttfm.loss_fn(tc, params, {k: torch.tensor(v)
                                        for k, v in b.items()}, Runtime())
    loss.backward()
    grads = {n: p.grad for n, p in params.named_parameters()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jtfm.loss_fn(jc, p, bb, JRuntime()), has_aux=True))(
        tree, {k: jnp.asarray(v) for k, v in b.items()})
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    _assert_trees_close(grads_to_jax(grads, tc),
                        jax.tree.map(np.asarray, jgrads), GRAD_REL)

    params = params_from_jax(tree)
    opt = AdamWConfig(lr=1e-3, weight_decay=0.1)
    step = make_train_step(tc, Runtime(), TrainConfig(steps=3, warmup=1,
                                                      opt=opt))
    jstep = jax.jit(jax_make_train_step(
        jc, JRuntime(), JTrainConfig(steps=3, warmup=1,
                                     opt=JAdamWConfig(lr=1e-3,
                                                      weight_decay=0.1))))
    state, jstate = init_opt_state(params), jax_init_opt_state(tree)
    jtree = tree
    for i in range(3):
        b = _batch(jc.vocab_size, 2, 24, seed=10 + i, masked=i)
        _, state, m = step(params, state, {k: torch.tensor(v)
                                           for k, v in b.items()})
        jtree, jstate, jm = jstep(jtree, jstate, {k: jnp.asarray(v)
                                                  for k, v in b.items()})
        for k in ("loss", "nll", "ntok", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) < 1e-5 * max(
                1.0, abs(float(jm[k]))), (i, k, float(m[k]), float(jm[k]))
    jstate = jax.tree.map(np.asarray, jstate)
    _assert_trees_close(opt_state_to_jax(state, tc)["m"], jstate["m"],
                        GRAD_REL)
    for (path, a), (_, b) in zip(_leaves(params_to_jax(params, tc)),
                                 _leaves(jax.tree.map(np.asarray, jtree))):
        d = np.abs(a - b) / opt.lr
        # a few near-zero-gradient entries may move differently; bk's
        # gradient is rounding noise in every entry (see
        # _assert_trees_close), so Adam may move all of its entries
        # differently, each within the same bar
        assert d.max() < 0.5, (jax.tree_util.keystr(path), d.max())
        assert path[-1].key == "bk" or d.mean() < 1e-3, \
            (jax.tree_util.keystr(path), d.mean())


def test_bridge_round_trips_the_new_leaves(model):
    """qkv biases, layernorm biases and an untied ``lm_head`` go to the port
    and back bit for bit, and the port's own initialiser gives the JAX
    tree's shapes."""
    arch, jc, tc, tree = model
    params = params_from_jax(tree)
    names = dict(params.named_parameters())
    assert ("layers.0.mixer.bq" in names) == jc.qkv_bias
    assert ("layers.1.mixer.bv" in names) == jc.qkv_bias
    assert ("embed.lm_head" in names) == (not jc.tie_embeddings)
    assert ("layers.0.norm1.bias" in names) == (jc.norm == "layernorm")
    assert ("final_norm.bias" in names) == (jc.norm == "layernorm")
    back = params_to_jax(params, tc)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    own = params_to_jax(ttfm.init_params(tc, seed=0, device="cpu"), tc)
    assert jax.tree.map(lambda a: (a.shape, a.dtype), own) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), tree)


# ---------------------------------------------------------------------------
# serving: dense caches, the cache bridge, both engines
# ---------------------------------------------------------------------------

def test_static_caches_match_jax_and_round_trip(model):
    """Prefill 11 tokens and decode 9 (danube's ring of 8 slots wraps in
    the prefill and again while decoding; granite's positions run on from
    the cache's ``pos``): logits within 1e-4 of scale of JAX's, the caches
    equal JAX's through ``cache_to_jax``, and a JAX cache brought in with
    ``cache_from_jax`` decodes the same next logits."""
    _, jc, tc, tree = model
    params = params_from_jax(tree)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, jc.vocab_size, (2, S0)).astype(np.int32)
    steps = rng.integers(0, jc.vocab_size, (2, N_NEW)).astype(np.int32)
    jlg, jcache = jtfm.prefill(jc, tree, {"tokens": jnp.asarray(prompts)},
                               JRuntime(), S0 + N_NEW + 1)
    jdecode = jax.jit(lambda p, c, tok, pos: jtfm.decode_step(
        jc, p, c, tok, pos, JRuntime()))
    with torch.no_grad():
        lg, cache = ttfm.prefill(tc, params,
                                 {"tokens": torch.tensor(prompts)},
                                 Runtime(), S0 + N_NEW + 1)
        assert _rel(lg.numpy(), jlg) < LOGIT_REL
        for t in range(N_NEW):
            tok, pos = steps[:, t:t + 1], S0 + t
            jlg, jcache = jdecode(tree, jcache, jnp.asarray(tok),
                                  jnp.asarray(pos, jnp.int32))
            lg, cache = ttfm.decode_step(tc, params, cache,
                                         torch.tensor(tok),
                                         torch.tensor(pos, dtype=torch.int32),
                                         Runtime())
            assert _rel(lg.numpy(), jlg) < LOGIT_REL, t
        jnp_cache = jax.tree.map(np.asarray, jcache)
        got = cache_to_jax(cache, tc)
        for (path, a), (_, b) in zip(_leaves(got), _leaves(jnp_cache)):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
        mine = cache_from_jax(jnp_cache)
        lg_a, _ = ttfm.decode_step(tc, params, mine, torch.tensor(tok),
                                   torch.tensor(S0 + N_NEW,
                                                dtype=torch.int32),
                                   Runtime())
    lg_b, _, _ = jtfm.forward(
        jc, tree, {"tokens": jnp.asarray(tok),
                   "pos": jnp.asarray(S0 + N_NEW, jnp.int32)},
        JRuntime(), cache=jcache)
    assert _rel(lg_a.numpy(), lg_b) < LOGIT_REL


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_engines_greedy_match_jax(model, impl):
    """Greedy tokens of the paged engine (``generate``: chunked prefill,
    flash-decode's plain version at G 6 and G 48, danube's window mask)
    and of the static engine (``generate_static``: dense caches, danube's
    ring) equal the JAX engine's, on prompts past danube's window.  The
    paged engine refuses non-token archs, as the JAX package's gate does:
    their ``generate`` is the static one."""
    _, jc, tc, tree = model
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jc.vocab_size, (3, S0)).astype(np.int32)
    jeng = JServeEngine(jc, tree, JRuntime(), **ENGINE_KW)
    want = np.asarray(jeng.generate_static(jnp.asarray(prompts), N_NEW))
    np.testing.assert_array_equal(
        np.asarray(jeng.generate(jnp.asarray(prompts), N_NEW)), want)
    eng = ServeEngine(tc, params_from_jax(tree), RUNTIMES[impl],
                      device="cpu", **ENGINE_KW)
    assert eng.paged_ok == jeng.paged_ok == (tc.input_mode == "tokens")
    np.testing.assert_array_equal(eng.generate(prompts, N_NEW), want)
    if eng.paged_ok:
        assert eng.stats["forward_calls"] > N_NEW      # the queue ran
    np.testing.assert_array_equal(eng.generate_static(prompts, N_NEW), want)


# ---------------------------------------------------------------------------
# the kernels' plain versions at the new shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 8, 40])
@pytest.mark.parametrize("B,S,H,Kv", [(2, 70, 4, 1), (1, 33, 8, 2)])
def test_plain_flash_at_head_dim_80_matches_ref(B, S, H, Kv, window):
    """forward_plain, dq_plain and dkv_plain at danube's head dim 80 against
    the JAX oracle ``attention_ref`` and its ``jax.grad``, within 1e-5 of
    scale; and ``FlashAttentionFn`` (their autograd) on the CPU."""
    rng = np.random.default_rng(S + window)
    q, do = (rng.standard_normal((B, S, H, 80), dtype=np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, Kv, 80), dtype=np.float32)
            for _ in range(2))
    assert 80 in tfa.HEAD_DIMS
    jin = [jnp.asarray(a) for a in (q, k, v)]
    want = jref.attention_ref(*jin, window=window)
    jgrads = jax.grad(lambda *a: jnp.sum(
        jref.attention_ref(*a, window=window) * jnp.asarray(do)),
        (0, 1, 2))(*jin)
    tin = [torch.tensor(a) for a in (q, k, v)]
    tdo = torch.tensor(do)
    o, lse = tfa.forward_plain(*tin, True, window)
    assert _rel(o.numpy(), want) < REF_ATOL
    delta = tfa.attention_delta(o, tdo)
    args = (*tin, tdo, lse, delta, True, window)
    for t, g in zip((tfa.dq_plain(*args), *tfa.dkv_plain(*args)), jgrads):
        assert _rel(t.numpy(), g) < REF_ATOL
    leaves = [t.clone().requires_grad_() for t in tin]
    ops.attention(*leaves, window=window).backward(tdo)
    for leaf, g in zip(leaves, jgrads):
        assert _rel(leaf.grad.numpy(), g) < REF_ATOL


@pytest.mark.parametrize("n_splits", [1, 4])
@pytest.mark.parametrize("G,Kv", [(48, 1), (6, 2), (17, 1)])
def test_plain_flash_decode_past_one_head_tile_matches_ref(G, Kv, n_splits):
    """The plain flash-decode at granite's G 48 (three head tiles on the
    card), qwen2's G 6 and an uneven G 17, against ``paged_attention_ref``
    within 1e-5; the shared memory a CTA needs follows its head tile."""
    rng = np.random.default_rng(G + n_splits)
    B, D, bs, P, nb = 3, 32, 8, 20, 6
    ctx = np.array([1, 19, bs * nb], np.int32)
    perm = rng.permutation(P)[:B * nb].reshape(B, nb)
    tbl = np.where(np.arange(nb)[None] < -(-ctx // bs)[:, None], perm,
                   -1).astype(np.int32)
    q = rng.standard_normal((B, 1, G * Kv, D), dtype=np.float32)
    kp, vp = (rng.standard_normal((P, bs, Kv, D), dtype=np.float32)
              for _ in range(2))
    out = ops.paged_decode_attention(*map(torch.tensor, (q, kp, vp, tbl,
                                                         ctx)),
                                     n_splits=n_splits)
    want = jref.paged_attention_ref(*map(jnp.asarray, (q, kp, vp, tbl,
                                                       ctx)))
    assert np.max(np.abs(out.numpy() - np.asarray(want))) < REF_ATOL
    tile = tfd.head_tile(G)
    assert tile <= tfd.MAX_G and -(-G // tile) == -(-G // tfd.MAX_G)
    assert tfd.decode_smem_bytes(G, 128, 4) == \
        tfd.decode_smem_bytes(tile, 128, 4)


def test_head_tiles_keep_shared_memory_in_bounds():
    """G 48 at D 128 needs one CTA's shared memory for a tile of 16 heads
    (83,072 B at 4 splits), not the 249,216 B of all 48, which would
    exceed what a Hopper CTA may hold."""
    from repro_torch.kernels import build
    assert tfd.head_tile(48) == 16 and tfd.head_tile(17) == 9
    assert tfd.head_tile(40) == 14 and tfd.head_tile(6) == 6
    assert tfd.decode_smem_bytes(48, 128, 4) == 83_072
    assert (6_144 + 9 * 48 * 130) * 4 == 249_216 > build.SMEM_LIMIT


def test_chip_smoke_runs_only_on_a_card(tmp_path):
    """``chip_smoke.py`` without a card, in the checkout or alone in a
    directory, exits non-zero with no result line."""
    import shutil
    import subprocess
    import sys
    from pathlib import Path
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = Path(__file__).resolve().parents[1]
    shutil.copy(root / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
            for cwd in (root, tmp_path)]
    for r in runs:
        assert r.returncode != 0 and '"ok"' not in r.stdout
    assert "no CUDA device" in runs[0].stderr
