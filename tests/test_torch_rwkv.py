"""The port's RWKV-6 path against the JAX package's, on the CPU.

The same numpy weights and inputs go through ``repro`` and
``repro_torch``: the WKV cores, the time mix and channel mix with and
without a carried state, the whole ``reduced(rwkv6-1.6b)`` model's loss
and gradients (JAX ``value_and_grad`` under the ``pallas`` Runtime, whose
WKV-6 kernel runs in interpret mode, and under ``jnp``), the bridge, the
weight-decay mask, and the CLIs.  All f32.
"""
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
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jtfm
from repro.models.layers import Runtime as JRuntime
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.bridge import (grads_to_jax, opt_state_from_jax,
                                opt_state_to_jax, params_from_jax,
                                params_to_jax)
from repro_torch.configs import get_config, reduced
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import Runtime
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from test_torch_fsdp import _few_threads  # noqa: F401
from test_torch_fsdp import cli_env

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-1.6b"
CHUNK = 16
# port runtime -> the JAX runtime it is held against, same WKV chunk
RUNTIMES = {"kernel": (Runtime(rwkv_chunk=CHUNK),
                       JRuntime(attn_impl="pallas", norm_impl="pallas",
                                rwkv_chunk=CHUNK)),
            "torch": (Runtime(attn_impl="torch", norm_impl="torch",
                              rwkv_chunk=CHUNK),
                      JRuntime(rwkv_chunk=CHUNK))}
# f32 throughout.  Block outputs and states: the same formula summed in
# another order, 1e-5 of their scale.  Loss 1e-5; gradients 1e-4 of each
# leaf's scale (ten times inside the JAX kernel tests' 1e-3 bar).
OUT_REL = 1e-5
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4


def _cfgs():
    return jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jtfm.init_params(cfg,
                                                     jax.random.PRNGKey(seed)))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _batch(vocab, B, S, seed=0, masked=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[:, -masked:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _mixer_params(jc, seed):
    """Trained-looking time-mix weights: JAX init plus noise on the
    zero-initialised mixes, the group norm and the channel-mix lerps, so
    every term of the blocks contributes."""
    kt, kc = jax.random.split(jax.random.PRNGKey(seed))
    tm = jax.tree.map(np.asarray, jrwkv.init_rwkv_time_mix(jc, kt))
    cm = jax.tree.map(np.asarray, jrwkv.init_rwkv_channel_mix(jc, kc))
    rng = np.random.default_rng(seed)

    def jitter(a, scale):
        return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)

    for name in ("maa_x", "maa_rkvwg"):
        tm[name] = jitter(tm[name], 0.3)
    tm["ln_x"] = {k: jitter(v, 0.1) for k, v in tm["ln_x"].items()}
    cm["maa_k"], cm["maa_r"] = jitter(cm["maa_k"], 0.3), jitter(cm["maa_r"],
                                                                0.3)
    return tm, cm


def _state(jc, B, seed):
    rng = np.random.default_rng(seed)
    d, H, N = jc.d_model, jc.rwkv_heads, jc.rwkv_head_dim
    return {"x_prev": rng.standard_normal((B, d)).astype(np.float32),
            "wkv": (0.3 * rng.standard_normal((B, H, N, N))
                    ).astype(np.float32)}


# ---------------------------------------------------------------------------
# WKV cores
# ---------------------------------------------------------------------------

def test_wkv_recurrent_and_step_match_jax():
    """The sequential oracle and the one-token step from a non-zero state,
    against the JAX functions of the same names, and the chunked form
    against the oracle."""
    B, T, H, N = 2, 21, 2, 16
    rng = np.random.default_rng(0)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, N)) - 2.0)
               ).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, N))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((B, H, N, N))).astype(np.float32)
    args = (r, k, v, w, u, s0)
    y, s = trwkv.wkv_recurrent(*map(torch.tensor, args))
    yj, sj = jrwkv.wkv_recurrent(*map(jnp.asarray, args))
    assert _rel(y, yj) < OUT_REL and _rel(s, sj) < OUT_REL
    y1, s1 = trwkv.wkv_step(*(torch.tensor(a[:, 5]) for a in args[:4]),
                            torch.tensor(u), torch.tensor(s0))
    yj1, sj1 = jrwkv.wkv_step(*(jnp.asarray(a[:, 5]) for a in args[:4]),
                              jnp.asarray(u), jnp.asarray(s0))
    assert _rel(y1, yj1) < OUT_REL and _rel(s1, sj1) < OUT_REL
    yc, sc = trwkv.wkv_chunked(*map(torch.tensor, args), 8)
    assert _rel(yc, yj) < 1e-4 and _rel(sc, sj) < 1e-4


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,T,stateful", [
    ("kernel", 40, False),    # WKV kernel route (its plain version here)
    ("torch", 40, False),     # plain chunked form from a zero state
    ("kernel", 40, True),     # a carried state takes the chunked form
    ("kernel", 1, True),      # one token with a state: wkv_step
])
def test_time_mix_matches_jax(impl, T, stateful):
    jc, tc = _cfgs()
    tm, _ = _mixer_params(jc, seed=1)
    B = 2
    x = np.random.default_rng(2).standard_normal(
        (B, T, jc.d_model)).astype(np.float32)
    st = _state(jc, B, seed=3) if stateful else None
    trt, jrt = RUNTIMES[impl]
    out, new = trwkv.rwkv_time_mix(tc, _torch_tree(tm), torch.tensor(x), trt,
                                   state=None if st is None
                                   else _torch_tree(st))
    jout, jnew = jrwkv.rwkv_time_mix(jc, jax.tree.map(jnp.asarray, tm),
                                     jnp.asarray(x), jrt,
                                     state=None if st is None
                                     else jax.tree.map(jnp.asarray, st))
    assert out.shape == (B, T, jc.d_model)
    assert _rel(out, jout) < OUT_REL
    if stateful:
        assert _rel(new["x_prev"], jnew["x_prev"]) == 0.0
        assert _rel(new["wkv"], jnew["wkv"]) < OUT_REL
    else:
        assert new is None and jnew is None


@pytest.mark.parametrize("stateful", [False, True])
def test_channel_mix_matches_jax(stateful):
    jc, tc = _cfgs()
    _, cm = _mixer_params(jc, seed=4)
    B, T = 2, 9
    x = np.random.default_rng(5).standard_normal(
        (B, T, jc.d_model)).astype(np.float32)
    st = _state(jc, B, seed=6) if stateful else None
    out, new = trwkv.rwkv_channel_mix(
        tc, _torch_tree(cm), torch.tensor(x), RUNTIMES["kernel"][0],
        state=None if st is None else {"x_prev": torch.tensor(st["x_prev"])})
    jout, jnew = jrwkv.rwkv_channel_mix(
        jc, jax.tree.map(jnp.asarray, cm), jnp.asarray(x), JRuntime(),
        state=None if st is None else {"x_prev": jnp.asarray(st["x_prev"])})
    assert _rel(out, jout) < OUT_REL
    if stateful:
        assert _rel(new["x_prev"], jnew["x_prev"]) == 0.0
    else:
        assert new is None and jnew is None


# ---------------------------------------------------------------------------
# whole model: loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,S", [("kernel", 128), ("torch", 128),
                                    ("kernel", 48), ("torch", 48)])
def test_loss_and_grads_match_jax(impl, S):
    """At S 128 the JAX pallas Runtime runs its WKV-6 kernel (interpret
    mode); at S 48, below its TPU gate (T >= 64), it computes the chunked
    form in jnp, while the port's kernel route takes ``WKV6Fn`` (the plain
    version here) at both.  The same WKV chunk on both sides."""
    jc, tc = _cfgs()
    tree = _jax_params(jc, seed=7)
    params = params_from_jax(tree)
    trt, jrt = RUNTIMES[impl]
    b = _batch(jc.vocab_size, 2, S, seed=S, masked=3)
    loss, m = ttfm.loss_fn(tc, params, {k: torch.tensor(v)
                                        for k, v in b.items()}, trt)
    loss.backward()
    grads = {n: p.grad for n, p in params.named_parameters()}
    assert all(g is not None for g in grads.values())
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jtfm.loss_fn(jc, p, bb, jrt), has_aux=True))(
        tree, {k: jnp.asarray(v) for k, v in b.items()})
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    assert float(m["ntok"]) == float(jm["ntok"])
    pa = _leaves(grads_to_jax(grads, tc))
    pb = _leaves(jax.tree.map(np.asarray, jgrads))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, a), (_, g) in zip(pa, pb):
        assert a.shape == g.shape, path
        assert _rel(a, g) < GRAD_REL, (jax.tree_util.keystr(path),
                                       _rel(a, g))


# ---------------------------------------------------------------------------
# parameters: bridge, decay mask, serving guard
# ---------------------------------------------------------------------------

def test_bridge_round_trips_rwkv_trees():
    """Params, gradients and AdamW moments of the nested RWKV-6 tree
    (``mixer.ln_x``) go to the port and back bit for bit."""
    jc, tc = _cfgs()
    tree = _jax_params(jc, seed=8)
    params = params_from_jax(tree)
    names = dict(params.named_parameters())
    assert "layers.1.mixer.ln_x.scale" in names
    assert names["layers.1.mixer.tm_w2"].shape == (5, trwkv.TM_RANK,
                                                   jc.d_model)
    assert sum(p.numel() for p in names.values()) == sum(
        np.size(a) for a in jax.tree.leaves(tree))
    for (pa, a), (pb, b) in zip(_leaves(params_to_jax(params, tc)),
                                _leaves(tree)):
        assert pa == pb and np.array_equal(a, b), pa
    grads = {n: torch.full_like(p, i) for i, (n, p) in
             enumerate(names.items())}
    back = params_from_jax(grads_to_jax(grads, tc))
    for n, p in back.named_parameters():
        assert torch.equal(p, grads[n]), n
    state = init_opt_state(params)
    state["m"] = {n: g + 0.5 for n, g in grads.items()}
    state["step"] = 3
    rt = opt_state_from_jax(opt_state_to_jax(state, tc))
    assert rt["step"] == 3
    assert all(torch.equal(rt["m"][n], state["m"][n]) for n in names)


def test_adamw_decays_the_same_rwkv_leaves_as_jax():
    """Every 1-d RWKV-6 leaf is on the no-decay list, so the stacked-leaf
    caveat of the JAX tree (ROADMAP Queue 3) does not arise: with zero
    gradients exactly the same leaves move in both packages."""
    jc, tc = _cfgs()
    tree = _jax_params(jc, seed=9)
    params = params_from_jax(tree)
    zeros = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    adamw_update(AdamWConfig(lr=1e-2), params, zeros, init_opt_state(params))
    jtree, _, _ = jax.jit(jax_adamw_update, static_argnums=0)(
        JAdamWConfig(lr=1e-2), tree, jax.tree.map(jnp.zeros_like, tree),
        jax_init_opt_state(tree))
    moved = jax.tree.map(lambda a, b: not np.array_equal(a, b),
                         params_to_jax(params, tc), tree)
    jmoved = jax.tree.map(lambda a, b: not np.array_equal(np.asarray(a), b),
                          jtree, tree)
    assert moved == jmoved
    mixer, ffn = moved["blocks"][0]["mixer"], moved["blocks"][0]["ffn"]
    assert mixer["wr"] and mixer["u"] and mixer["tm_w2"] and ffn["wk"]
    assert not (mixer["w0"] or mixer["maa_x"] or mixer["ln_x"]["scale"]
                or ffn["maa_k"] or moved["final_norm"]["bias"])


def test_paged_forward_refuses_a_recurrent_stack():
    _, tc = _cfgs()
    params = ttfm.init_params(tc, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="serves from dense caches"):
        ttfm.forward(tc, params, {"tokens": torch.zeros(1, 4, dtype=torch.int32),
                                  "pos": torch.zeros(1, 1, dtype=torch.int32)},
                     Runtime(), cache={"layers": [], "paged": {}})


def test_init_matches_jax_shapes_and_distributions():
    """The port's initialiser draws every leaf in the JAX shapes, with the
    JAX distributions (w0 uniform on [-6, -4), zeros and ones where JAX
    has them)."""
    jc, tc = _cfgs()
    jtree = params_to_jax(params_from_jax(_jax_params(jc)), tc)
    tree = params_to_jax(ttfm.init_params(tc, seed=0, device="cpu"), tc)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, jtree)
    mixer = tree["blocks"][0]["mixer"]
    assert mixer["w0"].min() >= -6.0 and mixer["w0"].max() < -4.0
    assert np.ptp(mixer["w0"]) > 1.5
    assert not mixer["maa_rkvwg"].any() and (mixer["ln_x"]["scale"] == 1).all()
    assert 0.05 < mixer["u"].std() < 0.15


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

def _run(args):
    env = cli_env()
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_cli_trains_rwkv_on_cpu():
    r = _run(["-m", "repro_torch.launch.train", "--device", "cpu",
              "--reduced", "--arch", ARCH, "--steps", "3", "--log_every",
              "1", "--seq_len", "48", "--global_batch", "2"])
    assert r.returncode == 0, r.stderr
    losses = [float(ln.split()[3]) for ln in r.stdout.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "arch=rwkv6-1.6b-smoke" in r.stdout and "done: loss" in r.stdout


def test_serve_cli_names_the_static_engine_slice():
    """The serve CLI serves RWKV-6 through the static engine (a recurrent
    stack cannot page), and says so."""
    r = _run(["-m", "repro_torch.launch.serve", "--device", "cpu",
              "--reduced", "--arch", ARCH, "--n_new", "2"])
    assert r.returncode == 0, r.stderr
    assert f"arch={ARCH}-smoke" in r.stdout and "engine=static" in r.stdout
    assert "tok/s" in r.stdout


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ga", [1, 2])
def test_train_steps_match_jax(ga):
    """Three AdamW steps (weight decay 0.1, warmup 1, cosine over 3) of the
    port's kernel route against the JAX ``make_train_step``, each step
    started from the JAX state (params and moments through the bridge).

    Each step starts afresh because the reduced model's gradient is badly
    conditioned at the first positions once the weights have moved: there
    a head's WKV output holds one or two terms, so the group norm's
    1/sqrt(var + 64e-5) amplifies up to 40x, and the first layernorm over
    embeddings of scale 0.02 another 50x.  One f32 rounding of difference
    in the upstream gradient grows to ~3e-3 of the scale of the first
    layer's gradients (JAX's own layer backward fed the port's upstream
    gradient reproduces the port's result within 5e-6), and Adam's
    near-sign updates carry that into the next step's weights.  So: loss,
    nll and ntok within 1e-5; the gradient norm within 1e-4 (observed
    <= 2.8e-5); moments within 1e-2 of their scale (observed <= 4.7e-3, in
    the first layer's mixer); parameters in units of lr, max < 2.5 (a
    near-zero gradient entry may change sign: an update of up to ~2 lr;
    observed <= 0.68) and mean < 1e-3 (observed <= 2.9e-4; a wrong update
    moves them all by ~lr)."""
    from repro.train.trainer import TrainConfig as JTrainConfig
    from repro.train.trainer import make_train_step as jax_make_train_step
    from repro_torch.train import TrainConfig, make_train_step
    jc, tc = _cfgs()
    tree = _jax_params(jc, seed=6)
    opt = AdamWConfig(lr=1e-3, weight_decay=0.1)
    rt, jrt = RUNTIMES["kernel"][0], JRuntime(rwkv_chunk=CHUNK)
    step = make_train_step(tc, rt, TrainConfig(steps=3, warmup=1,
                                               grad_accum=ga, opt=opt))
    jstep = jax.jit(jax_make_train_step(
        jc, jrt, JTrainConfig(steps=3, warmup=1, grad_accum=ga,
                              opt=JAdamWConfig(lr=1e-3, weight_decay=0.1))))
    jstate = jax.tree.map(np.asarray, jax_init_opt_state(tree))
    for i in range(3):
        params, state = params_from_jax(tree), opt_state_from_jax(jstate)
        b = _batch(jc.vocab_size, 4, 32, seed=10 + i, masked=2 * i)
        _, state, m = step(params, state, {k: torch.tensor(v)
                                           for k, v in b.items()})
        tree, jstate, jm = jstep(tree, jstate, {k: jnp.asarray(v)
                                                for k, v in b.items()})
        tree, jstate = (jax.tree.map(np.asarray, t) for t in (tree, jstate))
        for k, bar in (("loss", 1e-5), ("nll", 1e-5), ("ntok", 1e-5),
                       ("grad_norm", 1e-4)):
            assert abs(float(m[k]) - float(jm[k])) < bar * max(
                1.0, abs(float(jm[k]))), (i, k, float(m[k]), float(jm[k]))
        assert abs(m["lr"] - float(jm["lr"])) < 1e-10
        assert state["step"] == int(jstate["step"]) == i + 1
        for (path, a), (_, b_) in zip(
                _leaves(opt_state_to_jax(state, tc)["m"]),
                _leaves(jstate["m"])):
            assert _rel(a, b_) < 1e-2, (i, jax.tree_util.keystr(path))
        for (path, a), (_, b_) in zip(_leaves(params_to_jax(params, tc)),
                                      _leaves(tree)):
            d = np.abs(a - b_) / opt.lr
            assert d.max() < 2.5 and d.mean() < 1e-3, \
                (i, jax.tree_util.keystr(path), d.max(), d.mean())
