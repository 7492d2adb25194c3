"""The port's precision policies against the JAX package's, on the CPU.

bf16 (f32 master parameters, bf16 activations and products) and fp8 (bf16
compute from layer parameters rounded through float8_e4m3fn, the emulated
ZeRO-gather wire) at 2 layers: the port's kernel path (the kernels' plain
versions here) against JAX ``Runtime(compute_dtype=bf16)`` from the same
numpy weights and batch.

XLA on the CPU fuses bf16 elementwise chains and rounds once per fusion;
PyTorch rounds after every op.  So bf16 results differ by rounding, not by
a bug, and the tolerances below were set from measurement (observed
values beside each).  Since bf16 rounding noise is nearly as large as the
difference between a bf16 and an f32 computation, each bf16 comparison
also holds the port's bf16 result closer to JAX's bf16 than the port's
f32 result is.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import transformer as jtfm
from repro.models.layers import Runtime as JRuntime
from repro.models.layers import apply_norm as jax_apply_norm
from repro.models.layers import embed_tokens as jax_embed_tokens
from repro.models.layers import lm_logits as jax_lm_logits
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch import strategy
from repro_torch.bridge import (grads_to_jax, opt_state_to_jax,
                                params_from_jax, params_to_jax)
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import parallel as par
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import Runtime
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import TrainConfig, make_train_step
from test_torch_fsdp import _few_threads  # noqa: F401

BF16 = Runtime(compute_dtype=torch.bfloat16, rwkv_chunk=16)
F32 = Runtime(rwkv_chunk=16)
JBF16 = JRuntime(compute_dtype=jnp.bfloat16, rwkv_chunk=16)
# port bf16 vs JAX bf16, 2 layers, B 2 x S 64 (observed: qwen3 kv 2,
# llama2-1b, rwkv6-1.6b)
BF16_LOSS_ATOL = 5e-3      # (1.2e-3, 1.3e-4, 5.7e-5)
BF16_GRAD_REL = 5e-2       # each leaf's max error over its scale
#                            (2.0e-2, 1.6e-2, 8.6e-3)
# the JAX package's own bar for a bf16 step's loss against f32
# (tests/test_precision.py::test_bf16_train_step_numerics_match_f32)
BF16_VS_F32_REL = 2e-2


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


def _tree(cfg, seed=5):
    return jax.tree.map(np.asarray, jtfm.init_params(cfg,
                                                     jax.random.PRNGKey(seed)))


def _batch(vocab, B=2, S=64, seed=64, masked=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -masked:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _unrolled_loss(cfg, params, batch, rt):
    """JAX's loss_fn with the layer stack in a Python loop of its own
    ``_apply_layer``: the JAX package's scanned forward refuses a bf16
    RWKV-6 stack (its layers return f32 from a bf16 carry; a reference
    caveat), and the port, like this loop, lets the residual promote."""
    h = jax_embed_tokens(params["embed"], batch["tokens"], rt)
    prefix, _, period, n_blocks = jtfm.layer_plan(cfg)
    layers = list(params["prefix"]) + [
        jax.tree.map(lambda a: a[b], params["blocks"][pos])
        for b in range(n_blocks) for pos in range(period)]
    for i, lp in enumerate(layers):
        h, _, _ = jtfm._apply_layer(cfg, jtfm._sig(cfg, i), lp, h, None, rt)
    h = jax_apply_norm(params["final_norm"], h, cfg.norm_eps, rt)
    lf = jax_lm_logits(params["embed"], h, rt).astype(jnp.float32)
    labels = batch["labels"]
    lse = jax.nn.logsumexp(lf, axis=-1)
    ll = jnp.take_along_axis(lf, jnp.maximum(labels, 0)[..., None],
                             axis=-1)[..., 0]
    mask = (labels >= 0).astype(jnp.float32)
    return ((lse - ll) * mask).sum() / jnp.maximum(mask.sum(), 1.0)


def _rels(port_tree, jax_tree):
    out = {}
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(port_tree)[0],
            jax.tree_util.tree_flatten_with_path(jax_tree)[0], strict=True):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        out[jax.tree_util.keystr(path)] = float(
            np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))
    return out


def _port_loss_grads(tc, tree, b, rt):
    params = params_from_jax(tree)
    logits = ttfm.forward(tc, params, {"tokens": torch.tensor(b["tokens"])},
                          rt)
    loss, _ = ttfm.loss_fn(tc, params, {k: torch.tensor(v)
                                        for k, v in b.items()}, rt)
    loss.backward()
    grads = {n: p.grad for n, p in params.named_parameters()}
    return loss.item(), grads_to_jax(grads, tc), logits.dtype


@pytest.mark.parametrize("arch,over", [("qwen3-0.6b", dict(n_kv_heads=2)),
                                       ("llama2-1b", {}),
                                       ("rwkv6-1.6b", {})])
def test_bf16_loss_and_grads_match_jax(arch, over):
    jc, tc = _cfgs(arch, **over)
    tree = _tree(jc)
    b = _batch(jc.vocab_size)
    rwkv = arch.startswith("rwkv")
    jloss = _unrolled_loss if rwkv else (
        lambda c, p, bb, rt: jtfm.loss_fn(c, p, bb, rt)[0])
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jloss(jc, p, bb, JBF16)))(
        tree, {k: jnp.asarray(v) for k, v in b.items()})
    jgrads = jax.tree.map(np.asarray, jgrads)
    loss, grads, dtype = _port_loss_grads(tc, tree, b, BF16)
    _, grads32, _ = _port_loss_grads(tc, tree, b, F32)
    # an RWKV-6 stack's residual stream leaves its layers in f32, as JAX's
    assert dtype == (torch.float32 if rwkv else torch.bfloat16)
    assert abs(loss - float(want)) < BF16_LOSS_ATOL
    rels, rels32 = _rels(grads, jgrads), _rels(grads32, jgrads)
    worst = max(rels, key=rels.get)
    assert rels[worst] < BF16_GRAD_REL, (worst, rels[worst])
    # the bf16 path is the closer one: it rounds where JAX's does
    assert np.median(list(rels.values())) < np.median(list(rels32.values()))


@pytest.mark.parametrize("arch,over", [("qwen3-0.6b", dict(n_kv_heads=2)),
                                       ("llama2-1b", {})])
def test_bf16_step_tracks_f32_and_keeps_f32_masters(arch, over):
    """One AdamW step under the bf16 policy: the loss within 2e-2 of the
    f32 step's, and the parameters and both moments stay f32."""
    jc, tc = _cfgs(arch, **over)
    tree = _tree(jc, seed=8)
    b = {k: torch.tensor(v) for k, v in _batch(jc.vocab_size, B=4,
                                               S=32).items()}
    shape = ShapeConfig("prec", 32, 4, "train")
    topo = strategy.host_topology(n_devices=1)
    out = {}
    for spec in ("fsdp", "fsdp_bf16"):
        plan = strategy.parse(spec).to_plan(tc, topo, shape, abstract=True)
        rt = par.make_runtime(tc, plan, shape, remat=False)
        params = params_from_jax(tree)
        state = init_opt_state(params)
        step = make_train_step(tc, rt, TrainConfig(steps=1, warmup=1))
        _, state, m = step(params, state, b)
        out[spec] = (params, state, m)
    params, state, m = out["fsdp_bf16"]
    m32 = out["fsdp"][2]
    assert abs(float(m["loss"]) - float(m32["loss"])) <= \
        BF16_VS_F32_REL * abs(float(m32["loss"]))
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    for name, p in params.named_parameters():
        assert p.dtype == torch.float32, name
        assert state["m"][name].dtype == state["v"][name].dtype \
            == torch.float32, name
        assert torch.isfinite(p).all(), name


def _jax_fp8_steps(jc, tree, batches, wd):
    def gather_params(lp):            # make_param_gatherer's rounding
        return jax.tree.map(
            lambda x: x.astype(jnp.float8_e4m3fn).astype(jnp.bfloat16)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, lp)
    rt = JRuntime(compute_dtype=jnp.bfloat16, gather_params=gather_params)
    jstep = jax.jit(jax_make_train_step(jc, rt, JTrainConfig(
        steps=2, warmup=1, opt=JAdamWConfig(lr=1e-3, weight_decay=wd))))
    jtree, jstate, ms = tree, jax_init_opt_state(tree), []
    for b in batches:
        jtree, jstate, m = jstep(jtree, jstate, {k: jnp.asarray(v)
                                                 for k, v in b.items()})
        ms.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, jtree), jax.tree.map(np.asarray,
                                                         jstate), ms


# fp8 step (two AdamW steps at lr 1e-3) against JAX's, observed in
# brackets: loss, nll and grad norm relative (3.5e-4); each first moment
# over its scale (0.39: a layer gradient rounded to fp8's 3 mantissa bits
# may land one step away, 1/8 of its value); the parameters in units of lr
# (mean 0.037; max 3.6, where Adam turns a near-zero gradient's rounding
# into a full step)
FP8_METRIC_REL = 3e-3
FP8_MOMENT_REL = 0.75
FP8_LR_MEAN = 0.1
FP8_LR_MAX = 6.0


def test_fp8_step_on_a_one_rank_group_matches_jax(tmp_path):
    """``fsdp_fp8`` through the train CLI's functions (``to_plan``,
    ``apply_plan``) on a 1-rank gloo group: the layers compute from
    parameters rounded through float8_e4m3fn, and their gradients are
    rounded back through it, as the JAX package's gatherer does."""
    jc, tc = _cfgs("qwen3-0.6b", n_kv_heads=2)
    tree = _tree(jc, seed=9)
    batches = [_batch(jc.vocab_size, B=4, S=32, seed=s) for s in (1, 2)]
    jtree, jstate, jms = _jax_fp8_steps(jc, tree, batches, 0.0)

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        shape = ShapeConfig("fp8", 32, 4, "train")
        plan = strategy.parse("fsdp_fp8").to_plan(
            tc, strategy.host_topology(), shape)
        rt = par.make_runtime(tc, plan, shape, remat=False)
        assert rt.gather_dtype == torch.float8_e4m3fn
        params = par.apply_plan(params_from_jax(tree), plan, tc)
        state = init_opt_state(params)
        step = make_train_step(tc, rt, TrainConfig(
            steps=2, warmup=1, opt=AdamWConfig(lr=1e-3, weight_decay=0.0)),
            plan)
        ms = []
        for b in batches:
            _, state, m = step(params, state, {k: torch.tensor(v)
                                               for k, v in b.items()})
            ms.append({k: float(v) for k, v in m.items()})
        got_params = params_to_jax(params, tc)
        got_m = opt_state_to_jax(state, tc)["m"]
    finally:
        dist.destroy_process_group()
    for m, jm in zip(ms, jms, strict=True):
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        assert m["ntok"] == jm["ntok"]
        for k in ("loss", "nll", "grad_norm"):
            assert abs(m[k] - jm[k]) <= FP8_METRIC_REL * abs(jm[k]), \
                (k, m[k], jm[k])
    rels = _rels(got_m, jstate["m"])
    assert max(rels.values()) < FP8_MOMENT_REL, rels
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got_params)[0],
            jax.tree_util.tree_flatten_with_path(jtree)[0], strict=True):
        d = np.abs(np.asarray(a) - b) / 1e-3
        assert d.max() < FP8_LR_MAX and d.mean() < FP8_LR_MEAN, \
            (jax.tree_util.keystr(path), d.max(), d.mean())
