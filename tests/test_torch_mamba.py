"""The port's Mamba layers and jamba-v0.1-52b against the JAX package, on the
CPU.

The same numpy weights (the JAX initialiser's, through
``repro_torch.bridge``) and inputs (numpy, fixed seeds) go through
``repro`` and ``repro_torch``: the chunked selective scan (T a multiple of
the chunk and not, a zero and a nonzero initial state), the causal conv
with and without its state, ``mamba_block`` and its gradients, and the
reduced jamba at 4 layers over Kv 2 (d 256, di 512, dt_rank 16, d_state
16; Mamba, attention + MoE, Mamba + MoE, attention + MoE): its logits,
gradients and three AdamW steps, prefill-then-decode and the static
engine's tokens, the bridge and the CLIs.  The scan chunk is 8 (the JAX
package's ``Runtime.mamba_chunk`` is set alike).  f32 throughout: outputs
within 1e-5 of their scale (logits 1e-4, as ``tests/test_torch_dense.py``
holds them), the loss within 1e-5, gradients and moments within 1e-4 of
each leaf's scale, metrics within 1e-5 relative.  Weight decay is off in
the training steps: the JAX tree stacks Mamba's 1-d ``D``, which then
takes decay there and not in the port (the stacked-1-d caveat, ROADMAP
Queue 3).  The gloo worlds are in ``tests/test_torch_mamba_worlds.py``.
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import mamba as jmamba
from repro.models import transformer as jtfm
from repro.models.layers import Runtime as JRuntime
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import LATER, get_config, reduced
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import Runtime
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import TrainConfig, make_train_step
from test_torch_fsdp import _few_threads  # noqa: F401
from test_torch_fsdp import cli_env

ARCH = "jamba-v0.1-52b"
CHUNK = 8
OUT_REL, LOGIT_REL, LOSS_ATOL, GRAD_REL = 1e-5, 1e-4, 1e-5, 1e-4
RUNTIMES = {"kernel": Runtime(mamba_chunk=CHUNK),
            "torch": Runtime(attn_impl="torch", norm_impl="torch",
                             mamba_chunk=CHUNK)}
JRT = JRuntime(mamba_chunk=CHUNK)
B, S, LR = 2, 24, 1e-3


def _cfgs(n_layers=4):
    jc = dataclasses.replace(jax_reduced(jax_get_config(ARCH),
                                         n_layers=n_layers), n_kv_heads=2)
    tc = dataclasses.replace(reduced(get_config(ARCH), n_layers=n_layers),
                             n_kv_heads=2)
    return jc, tc


@pytest.fixture(scope="module")
def model():
    jc, tc = _cfgs()
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(11)))
    return jc, tc, tree


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_close(port_tree, jax_tree, rel):
    pa, pb = _leaves(port_tree), _leaves(jax_tree)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, a), (_, b) in zip(pa, pb):
        assert a.shape == b.shape, path
        assert _rel(a, b) < rel, (jax.tree_util.keystr(path), _rel(a, b))


def _batch(cfg, rows, n_pos, seed, masked=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, n_pos + 1)).astype(
        np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[:, -masked:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _torch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def _jnp(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_config_is_the_jax_packages_and_later_is_empty():
    """The full and reduced configs equal JAX's field for field, the
    registry holds jamba and ``LATER`` nothing; the reduced stack is the
    hybrid this file tests."""
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    jc, tc = _cfgs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert get_config(ARCH).source == jax_get_config(ARCH).source
    assert LATER == {}
    ttfm.check_supported(get_config(ARCH))
    assert [(tc.layer_kind(i), tc.is_moe_layer(i)) for i in range(4)] == [
        ("mamba", False), ("attn", True), ("mamba", True), ("attn", True)]
    full = get_config(ARCH)
    assert [i for i in range(32) if full.layer_kind(i) == "attn"] == \
        [7, 15, 23, 31]
    assert ttfm.layer_plan(full) == jtfm.layer_plan(full) == ([], 0, 8, 4)
    with pytest.raises(NotImplementedError, match="Mamba among attention"):
        ttfm.check_supported(dataclasses.replace(full, rope="rope"))


# ---------------------------------------------------------------------------
# the scan and the conv
# ---------------------------------------------------------------------------

def _scan_inputs(T, seed, h0=True):
    rng = np.random.default_rng(seed)
    Bn, di, ds = 2, 12, 5
    dt = np.log1p(np.exp(rng.standard_normal((Bn, T, di)) - 2.0))
    x = rng.standard_normal((Bn, T, di))
    Bt, Ct = (rng.standard_normal((Bn, T, ds)) for _ in range(2))
    A = -np.exp(rng.standard_normal((di, ds)) * 0.5)
    h = (rng.standard_normal((Bn, di, ds)) if h0
         else np.zeros((Bn, di, ds)))
    return [a.astype(np.float32) for a in (dt, Bt, Ct, x, A, h)]


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("T", [32, 29, 5])
def test_selective_scan_matches_jax(T, h0):
    """T 32 is 4 chunks of 8, T 29 pads 3 identity steps, T 5 is one
    short chunk; y and the final state within 1e-5 of their scale, and
    the chunked scan equals the one-chunk scan."""
    args = _scan_inputs(T, seed=T + 100 * h0, h0=h0)
    jy, jh = jmamba.selective_scan(*map(jnp.asarray, args), chunk=CHUNK)
    y, h = tmamba.selective_scan(*map(torch.tensor, args), chunk=CHUNK)
    assert _rel(y.numpy(), jy) < OUT_REL and _rel(h.numpy(), jh) < OUT_REL
    y1, h1 = tmamba._selective_scan_chunk(*map(torch.tensor, args))
    assert _rel(y.numpy(), y1.numpy()) < OUT_REL
    assert _rel(h.numpy(), h1.numpy()) < OUT_REL


def test_selective_scan_grads_match_jax_and_recompute_chunks():
    """Gradients of every input (and of h0) through 3 chunks with a pad
    within 1e-4 of their scale; under autograd the chunks are recomputed
    in the backward (``torch.utils.checkpoint``), so the forward keeps no
    (B, T, di, ds) tensor."""
    args = _scan_inputs(21, seed=3)
    rng = np.random.default_rng(4)
    gy = rng.standard_normal((2, 21, 12)).astype(np.float32)
    gh = rng.standard_normal((2, 12, 5)).astype(np.float32)

    def loss(*a):
        y, h = jmamba.selective_scan(*a, chunk=CHUNK)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    jgrads = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    big = []

    def pack(t):
        if t.dim() == 4 and t.shape[1] > 1:
            big.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, h = tmamba.selective_scan(*leaves, chunk=CHUNK)
    assert big == []
    ((y * torch.tensor(gy)).sum() + (h * torch.tensor(gh)).sum()).backward()
    for t, g in zip(leaves, jgrads):
        assert _rel(t.grad.numpy(), g) < GRAD_REL


@pytest.mark.parametrize("stateful", [False, True])
def test_causal_conv_matches_jax(stateful):
    """Output and new state (the last K-1 inputs), from zeros or from a
    carried state; T 2 < K-1 keeps part of the old state."""
    rng = np.random.default_rng(5 + stateful)
    for T in (9, 2):
        x = rng.standard_normal((2, T, 10)).astype(np.float32)
        w = rng.standard_normal((4, 10)).astype(np.float32)
        b = rng.standard_normal(10).astype(np.float32)
        st = (rng.standard_normal((2, 3, 10)).astype(np.float32)
              if stateful else None)
        jy, jst = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), None if st is None
                                      else jnp.asarray(st))
        y, nst = tmamba._causal_conv(torch.tensor(x), torch.tensor(w),
                                     torch.tensor(b), None if st is None
                                     else torch.tensor(st))
        assert _rel(y.numpy(), jy) < OUT_REL
        np.testing.assert_array_equal(nst.numpy(), np.asarray(jst))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [24, 21])
def test_mamba_block_and_grads_match_jax(model, T):
    """Layer 0's mixer of the reduced jamba on (2, T, 256): output within
    1e-5 of its scale, the gradients of every leaf and of the input within
    1e-4 (3 chunks of 8; T 21 pads)."""
    jc, tc, tree = model
    p = {k: v[0] for k, v in tree["blocks"][0]["mixer"].items()}
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, jc.d_model)).astype(np.float32)
    g = rng.standard_normal((2, T, jc.d_model)).astype(np.float32)

    def out(p, x):
        return jmamba.mamba_block(jc, p, x, JRT)[0]

    want = np.asarray(out(p, x))
    jgp, jgx = jax.grad(lambda p, x: jnp.sum(out(p, x) * g),
                        argnums=(0, 1))(p, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, st = tmamba.mamba_block(tc, tp, tx, RUNTIMES["kernel"])
    assert st is None
    assert _rel(y.detach().numpy(), want) < OUT_REL
    (y * torch.tensor(g)).sum().backward()
    assert _rel(tx.grad.numpy(), jgx) < GRAD_REL
    for k, v in tp.items():
        assert _rel(v.grad.numpy(), jgp[k]) < GRAD_REL, k


def test_init_matches_jax_shapes_and_distributions():
    """The port's initialiser draws the JAX leaves, shapes and
    distributions: A_log = log(1..d_state) on every channel, dt bias the
    softplus inverse of [1e-3, 1e-1], D ones, conv bias zeros."""
    jc, tc = _cfgs(n_layers=2)
    jtree = jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(0)))
    tree = bridge.params_to_jax(ttfm.init_params(tc, 0, "cpu"), tc)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, jtree)
    m = tree["blocks"][0]["mixer"]
    np.testing.assert_allclose(np.exp(m["A_log"][0, 0]),
                               np.arange(1, 17), rtol=1e-6)
    dt = np.log1p(np.exp(m["b_dt"]))
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001
    assert (m["D"] == 1).all() and not m["conv_b"].any()
    assert 0.4 < m["w_x_in"].std() * np.sqrt(jc.d_model) < 1.6


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_forward_and_loss_match_jax(model, impl):
    jc, tc, tree = model
    params = bridge.params_from_jax(tree)
    b = _batch(jc, B, S, seed=1, masked=3)
    with torch.no_grad():
        lg = ttfm.forward(tc, params, {"tokens": torch.tensor(b["tokens"])},
                          RUNTIMES[impl])
        loss, m = ttfm.loss_fn(tc, params, _torch(b), RUNTIMES[impl])
    jlg, _, _ = jtfm.forward(jc, tree, {"tokens": jnp.asarray(b["tokens"])},
                             JRT)
    jloss, jm = jtfm.loss_fn(jc, tree, _jnp(b), JRT)
    assert _rel(lg.numpy(), jlg) < LOGIT_REL
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    assert abs(float(m["aux"]) - float(jm["aux"])) < 1e-7


def test_grads_and_adamw_steps_match_jax(model):
    """Gradients of one batch within 1e-4 of each leaf's scale, then three
    AdamW steps, each held to JAX's ``make_train_step`` from the same
    state (the port's before the step, through the bridge): metrics
    within 1e-5, moments within 1e-4 of scale, parameters in units of lr.
    (Left to run on its own, JAX's trajectory drifts from the port's by
    up to 1.2e-4 of a moment's scale by step 3: Adam's first step moves
    an element by a full lr wherever its gradient is near zero, whatever
    its rounding, and the next gradients see that.)"""
    jc, tc, tree = model
    params = bridge.params_from_jax(tree)
    b = _batch(jc, B, S, seed=2, masked=2)
    loss, _ = ttfm.loss_fn(tc, params, _torch(b), RUNTIMES["kernel"])
    loss.backward()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jtfm.loss_fn(jc, p, bb, JRT), has_aux=True))(
        tree, _jnp(b))
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    _assert_trees_close(bridge.grads_to_jax(
        {n: p.grad for n, p in params.named_parameters()}, tc),
        jax.tree.map(np.asarray, jgrads), GRAD_REL)

    params = bridge.params_from_jax(tree)
    step = make_train_step(tc, RUNTIMES["kernel"], TrainConfig(
        steps=3, warmup=1, opt=AdamWConfig(lr=LR, weight_decay=0.0)))
    jstep = jax.jit(jax_make_train_step(jc, JRT, JTrainConfig(
        steps=3, warmup=1, opt=JAdamWConfig(lr=LR, weight_decay=0.0))))
    state = init_opt_state(params)
    for i in range(3):
        b = _batch(jc, B, S, seed=10 + i, masked=i)
        before = bridge.train_state_to_tree(params, state, tc)
        _, state, m = step(params, state, _torch(b))
        jtree, jstate, jm = jstep(before["params"], before["opt"], _jnp(b))
        for k in ("loss", "nll", "aux", "ntok", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) < 1e-5 * max(
                1.0, abs(float(jm[k]))), (i, k, float(m[k]), float(jm[k]))
        _assert_trees_close(bridge.opt_state_to_jax(state, tc)["m"],
                            jax.tree.map(np.asarray, jstate["m"]), GRAD_REL)
        mine = bridge.params_to_jax(params, tc)
        for (path, a), (_, c) in zip(
                _leaves(mine), _leaves(jax.tree.map(np.asarray, jtree))):
            d = np.abs(a - c) / LR
            assert d.max() < 0.5 and d.mean() < 1e-3, \
                (i, jax.tree_util.keystr(path), d.max(), d.mean())


# ---------------------------------------------------------------------------
# serving: conv and SSM state beside the attention KV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_prefill_then_decode_matches_jax_and_the_forward(model, impl):
    """A prefill of 19 positions (3 chunks of 8, padded) into dense
    caches, then 5 decode steps: every logit within 1e-4 of JAX's
    ``prefill``/``decode_step`` and of the teacher-forced forward over
    the whole sequence; after the prefill the caches (KV, conv state, SSM
    state) are JAX's."""
    jc, tc, tree = model
    params = bridge.params_from_jax(tree)
    n_pre, n_dec = 19, 5
    toks = _batch(jc, B, n_pre + n_dec, seed=7)["tokens"]
    rt = dataclasses.replace(RUNTIMES[impl], mamba_chunk=CHUNK)
    with torch.no_grad():
        full = ttfm.forward(tc, params, {"tokens": torch.tensor(toks)},
                            rt).numpy()
        lg, cache = ttfm.prefill(tc, params,
                                 {"tokens": torch.tensor(toks[:, :n_pre])},
                                 rt, n_pre + n_dec)
    jlg, jcache = jtfm.prefill(jc, tree, {"tokens": jnp.asarray(
        toks[:, :n_pre])}, JRT, n_pre + n_dec)
    assert _rel(lg.numpy(), jlg) < LOGIT_REL
    assert _rel(lg.numpy(), full[:, :n_pre]) < LOGIT_REL
    mine = bridge.cache_to_jax(cache, tc)
    for (path, a), (_, b) in zip(_leaves(mine),
                                 _leaves(jax.tree.map(np.asarray, jcache))):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert _rel(a, b) < OUT_REL, (jax.tree_util.keystr(path), _rel(a, b))
    assert cache["layers"][0]["ssm"].dtype == torch.float32
    for t in range(n_pre, n_pre + n_dec):
        with torch.no_grad():
            lg, cache = ttfm.decode_step(tc, params, cache,
                                         torch.tensor(toks[:, t:t + 1]), t,
                                         rt)
        jlg, jcache = jtfm.decode_step(jc, tree, jcache,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       jnp.asarray(t, jnp.int32), JRT)
        assert _rel(lg.numpy(), jlg) < LOGIT_REL, t
        assert _rel(lg.numpy()[:, 0], full[:, t]) < LOGIT_REL, t


def test_static_engine_serves_as_jax(model):
    """The static engine's greedy tokens equal the JAX engine's
    ``generate_static``; the paged engine refuses the hybrid, as JAX's
    gate does, and ``generate`` serves it statically."""
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.serve import ServeEngine
    jc, tc, tree = model
    prompts = np.random.default_rng(3).integers(
        0, jc.vocab_size, (2, 11)).astype(np.int32)
    eng = ServeEngine(tc, bridge.params_from_jax(tree), RUNTIMES["kernel"],
                      max_len=20, device="cpu")
    jeng = JServeEngine(jc, tree, JRT, max_len=20)
    assert not eng.paged_ok and not jeng.paged_ok
    with pytest.raises(RuntimeError, match="paged cache path"):
        eng.submit(prompts[0], 4)
    np.testing.assert_array_equal(
        eng.generate(prompts, 8),
        np.asarray(jeng.generate_static(jnp.asarray(prompts), 8)))


def test_paged_forward_refuses_the_hybrid(model):
    _, tc, _ = model
    params = ttfm.init_params(tc, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="serves from dense caches"):
        ttfm.forward(tc, params, {"tokens": torch.zeros(1, 4,
                                                        dtype=torch.int32),
                                  "pos": torch.zeros(1, 1,
                                                     dtype=torch.int32)},
                     Runtime(), cache={"layers": [], "paged": {}})


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

def test_bridge_round_trips_the_period_8_stack():
    """The full-depth jamba's JAX tree (layer_plan period 8: ``blocks``
    of 8 positions stacked 4 deep) maps onto 32 port layers and back bit
    for bit, at d 64 with the full config's layer pattern (attention
    every 8th layer, MoE every 2nd), and its Mamba leaves land on the
    Mamba layers."""
    jc = jax_reduced(jax_get_config(ARCH), n_layers=32, d_model=64)
    jc = dataclasses.replace(jc, attn_every=8, moe=dataclasses.replace(
        jc.moe, moe_every=2))
    tc = reduced(get_config(ARCH), n_layers=32, d_model=64)
    tc = dataclasses.replace(tc, attn_every=8, moe=dataclasses.replace(
        tc.moe, moe_every=2))
    assert jtfm.layer_plan(jc) == ttfm.layer_plan(tc) == ([], 0, 8, 4)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(2)))
    params = bridge.params_from_jax(tree)
    names = dict(params.named_parameters())
    assert "layers.30.mixer.A_log" in names and \
        "layers.31.mixer.wq" in names and "layers.31.ffn.router" in names
    np.testing.assert_array_equal(names["layers.9.mixer.conv_w"].detach(),
                                  tree["blocks"][1]["mixer"]["conv_w"][1])
    for (pa, a), (pb, b) in zip(_leaves(bridge.params_to_jax(params, tc)),
                                _leaves(tree)):
        assert pa == pb and np.array_equal(a, b), pa
    grads = {n: torch.full_like(p, i) for i, (n, p) in
             enumerate(names.items())}
    back = bridge.params_from_jax(bridge.grads_to_jax(grads, tc))
    for n, p in back.named_parameters():
        assert torch.equal(p, grads[n]), n


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _cli(*args):
    env = cli_env()
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, env=env, timeout=300)


def test_clis_serve_jamba_statically_and_train_it():
    """``launch.serve --arch jamba-v0.1-52b`` serves on the static engine
    (``--engine paged`` exits, as the JAX CLI does); ``launch.train``
    takes two finite steps under ``fsdp``."""
    base = ("repro_torch.launch.serve", "--device", "cpu", "--reduced",
            "--arch", ARCH, "--n_new", "3", "--batch", "2", "--prompt_len",
            "8")
    ok = _cli(*base)
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert "engine=static" in ok.stdout
    paged = _cli(*base, "--engine", "paged")
    assert paged.returncode != 0
    assert "--engine paged needs a single-device plan" in paged.stderr
    out = _cli("repro_torch.launch.train", "--device", "cpu", "--reduced",
               "--arch", ARCH, "--steps", "2", "--log_every", "1",
               "--seq_len", "32", "--global_batch", "4", "--strategy",
               "fsdp")
    assert out.returncode == 0, out.stderr[-2000:]
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.stdout.splitlines()
              if line.startswith("step") and "loss" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
