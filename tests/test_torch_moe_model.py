"""The reduced deepseek-moe-16b (a dense first layer, then MoE layers of 4
experts top 2 with 2 shared experts) and dbrx-132b (every layer MoE, 4
experts top 2) of the port as whole models against the JAX package, on
the CPU: forward, the loss with its aux, gradients, AdamW steps under
``ga2``, both serving engines, the bridge and a JAX-written checkpoint.

Weights come from the JAX initialiser through ``repro_torch.bridge``,
inputs from numpy with a fixed seed.  Tolerances: logits and gradients
within 1e-4 of their scale, the loss within 1e-5 and the aux within 1e-7
(f32 sums in another order over 3 layers), greedy tokens and checkpoint
leaves exactly; three AdamW steps as ``tests/test_torch_train.py`` holds
them.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpointing import save_checkpoint as jax_save_checkpoint
from repro.models import transformer as jtfm
from repro.models.layers import Runtime as JRuntime
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.serve import ServeEngine as JServeEngine
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch import checkpointing as ckpt_lib
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import Runtime
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.serve import ServeEngine
from repro_torch.train import TrainConfig, make_train_step
from test_torch_moe import (ARCHS, ENGINE_KW, GRAD_REL, LOGIT_REL, LOSS_ATOL,
                            N_NEW, RUNTIMES, S0, _assert_trees_close, _batch,
                            _cfgs, _leaves, _rel)
from test_torch_fsdp import _few_threads  # noqa: F401



@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc, tc = _cfgs(request.param)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jc, jax.random.PRNGKey(3)))
    return request.param, jc, tc, tree


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_forward_and_loss_match_jax(model, impl):
    """Logits, and the loss with its aux (the summed balance losses of the
    MoE layers), under 'auto' (dense at this size) and 'dropping'."""
    _, jc, tc, tree = model
    params = bridge.params_from_jax(tree)
    b = _batch(jc.vocab_size, 2, 24, seed=1, masked=3)
    for moe_impl in ("auto", "dropping"):
        rt = dataclasses.replace(RUNTIMES[impl], moe_impl=moe_impl)
        with torch.no_grad():
            lg = ttfm.forward(tc, params,
                              {"tokens": torch.tensor(b["tokens"])}, rt)
            loss, m = ttfm.loss_fn(tc, params, {k: torch.tensor(v)
                                                for k, v in b.items()}, rt)
        jrt = JRuntime(moe_impl=moe_impl)
        jlg, _, _ = jtfm.forward(jc, tree,
                                 {"tokens": jnp.asarray(b["tokens"])}, jrt)
        jloss, jm = jtfm.loss_fn(jc, tree, {k: jnp.asarray(v)
                                            for k, v in b.items()}, jrt)
        assert _rel(lg.numpy(), jlg) < LOGIT_REL
        assert abs(loss.item() - float(jloss)) < LOSS_ATOL
        assert float(m["aux"]) > 0
        assert abs(float(m["aux"]) - float(jm["aux"])) < 1e-7


def test_fp8_wire_rounds_the_stacked_layers_only(model):
    """The fp8 wire (``Runtime.gather_dtype``) rounds the layers of the
    JAX package's scanned blocks and not its prefix (deepseek's dense
    first layer), as JAX's per-layer gatherer does: with f32 compute, the
    loss against JAX's with ``gather_params`` rounding through
    float8_e4m3fn, and the gradients of the leaves it leaves unrounded
    (the prefix, the embedding, the final norm), at the f32 tolerances.
    (JAX's transposed casts also round the stacked layers' gradients
    through fp8, which the port's train step does once they are summed:
    ``models.layers.wire_round_grad``.)"""
    _, jc, tc, tree = model
    start = jtfm.layer_plan(jc)[1]
    assert ttfm.wired_layers(tc) == range(start, tc.n_layers)
    params = bridge.params_from_jax(tree)
    b = _batch(jc.vocab_size, 2, 24, seed=4, masked=2)
    loss, _ = ttfm.loss_fn(tc, params, {k: torch.tensor(v)
                                        for k, v in b.items()},
                           Runtime(gather_dtype=torch.float8_e4m3fn))
    loss.backward()
    grads = bridge.grads_to_jax({n: p.grad for n, p in
                                 params.named_parameters()}, tc)

    def gather(lp):
        return jax.tree.map(
            lambda x: x.astype(jnp.float8_e4m3fn).astype(jnp.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, lp)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jtfm.loss_fn(jc, p, bb, JRuntime(
            gather_params=gather)), has_aux=True))(
        tree, {k: jnp.asarray(v) for k, v in b.items()})
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    blocks = "blocks"
    _assert_trees_close({k: v for k, v in grads.items() if k != blocks},
                        {k: v for k, v in jgrads.items() if k != blocks},
                        GRAD_REL)


def test_grads_and_adamw_steps_match_jax(model):
    """Gradients of one batch (aux included) within 1e-4 of each leaf's
    scale, then three AdamW steps against JAX's ``make_train_step``:
    metrics to f32 order, moments within 1e-4 of scale, parameters in
    units of lr as ``tests/test_torch_train.py`` holds them."""
    _, jc, tc, tree = model
    params = bridge.params_from_jax(tree)
    b = _batch(jc.vocab_size, 2, 24, seed=2, masked=2)
    loss, _ = ttfm.loss_fn(tc, params, {k: torch.tensor(v)
                                        for k, v in b.items()}, Runtime())
    loss.backward()
    grads = {n: p.grad for n, p in params.named_parameters()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jtfm.loss_fn(jc, p, bb, JRuntime()), has_aux=True))(
        tree, {k: jnp.asarray(v) for k, v in b.items()})
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    _assert_trees_close(bridge.grads_to_jax(grads, tc),
                        jax.tree.map(np.asarray, jgrads), GRAD_REL)

    params = bridge.params_from_jax(tree)
    opt = AdamWConfig(lr=1e-3, weight_decay=0.1)
    step = make_train_step(tc, Runtime(), TrainConfig(steps=3, warmup=1,
                                                      opt=opt, grad_accum=2))
    jstep = jax.jit(jax_make_train_step(
        jc, JRuntime(), JTrainConfig(steps=3, warmup=1, grad_accum=2,
                                     opt=JAdamWConfig(lr=1e-3,
                                                      weight_decay=0.1))))
    state, jstate = init_opt_state(params), jax_init_opt_state(tree)
    jtree = tree
    for i in range(3):
        b = _batch(jc.vocab_size, 4, 24, seed=10 + i, masked=i)
        _, state, m = step(params, state, {k: torch.tensor(v)
                                           for k, v in b.items()})
        jtree, jstate, jm = jstep(jtree, jstate, {k: jnp.asarray(v)
                                                  for k, v in b.items()})
        for k in ("loss", "nll", "aux", "ntok", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) < 1e-5 * max(
                1.0, abs(float(jm[k]))), (i, k, float(m[k]), float(jm[k]))
    jstate = jax.tree.map(np.asarray, jstate)
    _assert_trees_close(bridge.opt_state_to_jax(state, tc)["m"],
                        jstate["m"], GRAD_REL)
    for (path, a), (_, b) in zip(
            _leaves(bridge.params_to_jax(params, tc)),
            _leaves(jax.tree.map(np.asarray, jtree))):
        d = np.abs(a - b) / opt.lr
        assert d.max() < 0.5, (jax.tree_util.keystr(path), d.max())
        assert d.mean() < 1e-3, (jax.tree_util.keystr(path), d.mean())


def test_bridge_round_trips_the_moe_leaves(model):
    """The MoE leaves in the JAX stacked layout (deepseek: layer 0 a
    prefix, the MoE layers stacked) go to the port and back bit for bit,
    the port's initialiser gives the JAX tree's shapes, and its MoE FFNs
    are ``MoEFFN`` modules."""
    arch, jc, tc, tree = model
    params = bridge.params_from_jax(tree)
    names = dict(params.named_parameters())
    first_moe = jc.moe.moe_start_layer
    assert f"layers.{first_moe}.ffn.router" in names
    assert (f"layers.{first_moe}.ffn.shared.w_up" in names) == \
        bool(jc.moe.n_shared_experts)
    assert ("layers.0.ffn.router" in names) == jc.is_moe_layer(0)
    for i in range(jc.n_layers):
        assert isinstance(params.layers[i]["ffn"], tmoe.MoEFFN) == \
            jc.is_moe_layer(i)
    back = bridge.params_to_jax(params, tc)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    own = bridge.params_to_jax(ttfm.init_params(tc, seed=0, device="cpu"),
                               tc)
    assert jax.tree.map(lambda a: (a.shape, a.dtype), own) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), tree)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_engines_greedy_match_jax(model, impl):
    """Greedy tokens of the paged engine and of the static engine equal
    the JAX engine's (decode runs 'auto': dense at decode's T)."""
    _, jc, tc, tree = model
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jc.vocab_size, (3, S0)).astype(np.int32)
    jeng = JServeEngine(jc, tree, JRuntime(), **ENGINE_KW)
    want = np.asarray(jeng.generate_static(jnp.asarray(prompts), N_NEW))
    np.testing.assert_array_equal(
        np.asarray(jeng.generate(jnp.asarray(prompts), N_NEW)), want)
    eng = ServeEngine(tc, bridge.params_from_jax(tree), RUNTIMES[impl],
                      device="cpu", **ENGINE_KW)
    assert eng.paged_ok
    np.testing.assert_array_equal(eng.generate(prompts, N_NEW), want)
    np.testing.assert_array_equal(eng.generate_static(prompts, N_NEW), want)


def test_jax_checkpoint_restores_in_the_port(model, tmp_path):
    """A checkpoint the JAX package writes after a train step (params and
    AdamW moments, MoE leaves stacked) restores into the port's live state
    in place, equal to the JAX tree."""
    _, jc, tc, tree = model
    jstep = jax.jit(jax_make_train_step(jc, JRuntime(), JTrainConfig(
        steps=2, warmup=1)))
    b = _batch(jc.vocab_size, 2, 16, seed=6)
    jtree, jstate, _ = jstep(tree, jax_init_opt_state(tree),
                             {k: jnp.asarray(v) for k, v in b.items()})
    saved = {"params": jtree, "opt": jstate}
    jax_save_checkpoint(str(tmp_path), 1, saved)
    params = ttfm.init_params(tc, seed=1, device="cpu")
    state = init_opt_state(params)
    loaded = ckpt_lib.restore_checkpoint(
        str(tmp_path), 1, bridge.train_state_target(params, tc))
    bridge.load_train_state(loaded, params, state)
    got = bridge.train_state_to_tree(params, state, tc)
    want = jax.tree.map(np.asarray, saved)
    for (path, a), (_, w) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a, w, err_msg=jax.tree_util.keystr(
            path))
