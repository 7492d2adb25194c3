"""Context parallelism of the port against the JAX package, on the CPU.

- The flash kernels' plain versions with a query offset q0 (rows at
  positions q0 + i against keys 0..Sk-1, what a context rank attends)
  against the JAX package's ``models/attention.py::_attend_dense`` at the
  same offset positions (its ``_cp_attend``'s attention): outputs within
  1e-5 of their scale, the gradients of q, k and v (``FlashAttentionFn``'s
  backward: the dq and dk/dv plain versions) within 1e-4 of theirs.
- Training steps on gloo worlds of 2 and 4 processes: ``fsdp_cp2`` (each
  rank its half of the sequence, K/V gathered over the model axis),
  ``fsdp_tp2_ctx`` (a tp forced to context attention), deepseek-moe-16b
  under ``fsdp_cp2`` (its experts split over the model axis, the tokens
  gathered along S), data 2 x model 2, and ``fsdp_pp2_cp2`` (context
  attention inside each pipeline stage), each one AdamW step against the
  JAX package's single-device step (``tests/test_torch_moe_tp.py``'s bars
  and worlds).  The JAX package's own context-parallel test
  (``tests/test_spmd.py::test_sharded_train_equivalence[qwen2-1.5b-
  context]``) is red on this jax.
- Static serving under ``fsdp_cp2``: the prompt's prefill split over the
  two ranks (K/V gathered, the cache's slots split over them), greedy
  decode over the sharded cache, token for token JAX's single-device
  ``generate_static``.
"""
import numpy as np
import pytest
import torch
from test_torch_moe_tp import (DEEPSEEK, _cfg, _ids_of, _inputs, _jax_step,
                               check_step, spawn_worlds)
from test_torch_fsdp import _few_threads  # noqa: F401

QWEN = ("qwen3-0.6b", dict(n_kv_heads=2))
RWKV = ("rwkv6-1.6b", {})
S0, N_NEW, SERVE_B = 12, 6, 2           # the prompt splits over 2 ranks
WORLDS = {2: [("fsdp_cp2", *QWEN), ("fsdp_tp2_ctx", *QWEN),
              ("fsdp_cp2", *DEEPSEEK), ("serve-fsdp_cp2", *QWEN),
              ("fsdp_cp2", *RWKV), ("serve-fsdp_cp2", *RWKV)],
          4: [("fsdp_cp2", *QWEN), ("fsdp_pp2_cp2_mb2", *QWEN)]}
OUT_REL, GRAD_REL = 1e-5, 1e-4


# ---------------------------------------------------------------------------
# the plain flash versions at a query offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("shard", [0, 1, 3])
def test_offset_flash_matches_jax_attend_dense(shard, window):
    """Rank ``shard`` of 4 over Sk 64 keys: its 16 rows at q0 = 16 shard,
    H 4 over Kv 2, D 32."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as jattn
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as tfa
    B, Sk, S_loc, H, Kv, D = 2, 64, 16, 4, 2, 32
    q0 = shard * S_loc
    rng = np.random.default_rng(shard + 10 * window)
    q = rng.standard_normal((B, S_loc, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, Kv, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, S_loc, H, D)).astype(np.float32)
    q_pos, k_pos = q0 + jnp.arange(S_loc), jnp.arange(Sk)

    def ref(q, k, v):
        return jattn._attend_dense(q, k, v, q_pos, k_pos, window, D ** -0.5)

    want = np.asarray(ref(q, k, v))
    grads = jax.grad(lambda *a: jnp.sum(ref(*a) * do), (0, 1, 2))(q, k, v)
    o, lse = tfa.forward_plain(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), True, window, q0)
    assert lse.shape == (B, H, S_loc)
    assert np.max(np.abs(o.numpy() - want)) <= OUT_REL * np.max(
        np.abs(want))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    ops.attention(*leaves, window=window, q0=q0).backward(torch.tensor(do))
    for t, g in zip(leaves, grads):
        g = np.asarray(g)
        assert np.max(np.abs(t.grad.numpy() - g)) <= GRAD_REL * np.max(
            np.abs(g))


def test_offset_flash_at_zero_is_self_attention():
    """q0 = 0 with Sq = Sk is the self-attention the kernels ran before
    the offset: the plain versions give the same bits."""
    from repro_torch.kernels import flash_attention as tfa
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 40, 4, 16, generator=g) for _ in range(4))
    k, v = k[:, :, :2], v[:, :, :2]
    o, lse = tfa.forward_plain(q, k, v, True, 0)
    o0, lse0 = tfa.forward_plain(q, k, v, True, 0, 0)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    delta = tfa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, True, 0)
    assert torch.equal(tfa.dq_plain(*args), tfa.dq_plain(*args, 0))
    for a, b in zip(tfa.dkv_plain(*args), tfa.dkv_plain(*args, 0)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# static serving under fsdp_cp2 (a worker of the shared worlds)
# ---------------------------------------------------------------------------

def _serve_case(case, rank):
    """``generate_static`` under the case's plan -> this rank's tokens and
    the K/V gathers its prefill took, gathered on rank 0."""
    import torch.distributed as dist

    from repro_torch import bridge, strategy
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as par
    from repro_torch.models import layers
    from repro_torch.serve import ServeEngine
    spec, arch, over = case["case"]
    cfg = _cfg(arch, over)
    max_len = S0 + N_NEW
    shape = ShapeConfig("serve", max_len, SERVE_B, "decode")
    plan = strategy.parse(spec.split("-", 1)[1]).to_plan(
        cfg, strategy.host_topology(), shape)
    rt = par.make_runtime(cfg, plan, shape)
    params = par.apply_plan(bridge.params_from_jax(case["tree"]), plan, cfg)
    eng = ServeEngine(cfg, params, rt, max_len=max_len, plan=plan,
                      device="cpu")
    layers.reset_collective_counts()
    tokens = eng.generate_static(case["prompts"], N_NEW)
    out = dict(tokens=tokens, sites=dict(layers.COLLECTIVE_SITES),
               context=rt.context, tp=rt.tp_size, shard=rt.cache_shard)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, out)
    return parts if rank == 0 else None


def _case_inputs(case, n):
    if not case[0].startswith("serve-"):
        return _inputs(case, n)
    from test_torch_fsdp import _jax_tree
    jc, tree = _jax_tree(case[1], case[2])
    prompts = np.random.default_rng(n).integers(
        0, jc.vocab_size, (SERVE_B, S0)).astype(np.int32)
    return dict(tree=tree, prompts=prompts, run=_serve_case)


def _reference(case, n, tree, prompts=None, batches=None, run=None):
    if batches is not None:
        return _jax_step(case, n, tree, batches)
    import jax.numpy as jnp

    from repro.models.layers import Runtime as JRuntime
    from repro.serve import ServeEngine as JServeEngine
    from test_torch_fsdp import _jax_tree
    jc, _ = _jax_tree(case[1], case[2])
    return np.asarray(JServeEngine(jc, tree, JRuntime(), max_len=S0 + N_NEW)
                      .generate_static(jnp.asarray(prompts), N_NEW))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return spawn_worlds(WORLDS, tmp_path_factory, "cp", _case_inputs,
                        _reference)


CASES = [(n, i) for n, cases in WORLDS.items()
         for i, c in enumerate(cases) if not c[0].startswith("serve-")]


def gathers(cfg):
    """(K/V gathers, sequence gathers) of one forward over the context
    split: K and V in each attention layer; the mixer's input in each
    recurrent layer, and an RWKV-6 layer's channel-mix input besides."""
    kinds = [cfg.layer_kind(j) for j in range(cfg.n_layers)]
    return 2 * kinds.count("attn"), 2 * kinds.count("rwkv6") + \
        kinds.count("mamba")


@pytest.mark.parametrize("world_case", CASES, ids=_ids_of(WORLDS))
def test_context_parallel_steps_match_the_jax_step(worlds, world_case):
    """One step's loss, nll, grad_norm and gradients at the f32 bars
    (and a MoE model's aux within 1e-6); the model axis runs as the
    sequence axis (``context``, 2 ranks, no head split), every attention
    layer gathering K and V over it, every recurrent layer the sequence
    (rwkv6-1.6b: its time mix scans the whole sequence on its heads and
    its channel mix shifts across the shard boundary; before that repair
    each rank started both from zero at its first row, and this case's
    first loss was off by 4e-2 relative)."""
    n, i = world_case
    case, got, ref = worlds[n][i]
    check_step((n,) + case, got, ref)
    assert (got["attn"], got["context"], got["tp"]) == ("context", True, 2)
    cfg = _cfg(case[1], case[2])
    kv, seq = gathers(cfg)
    # K and V of each of the rank's layers, once a pipeline microbatch
    per_rank = kv // 2 * 2 if "pp2" in case[0] else kv
    for r in got["ranks"]:
        assert r["calls"]["sites"]["context_kv_gather"] == per_rank
        assert r["calls"]["sites"]["context_seq_gather"] == seq
        n_moe = sum(cfg.is_moe_layer(j) for j in range(cfg.n_layers))
        assert r["calls"]["sites"]["moe_combine"] == n_moe
        assert r["bad"] == []


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
def test_static_serving_under_fsdp_cp2_matches_jax(worlds, arch):
    """Every rank's greedy tokens equal JAX's single-device
    ``generate_static``; each prefilled its half of the prompt (K and V
    gathered in every attention layer, the sequence in every recurrent
    one) into its own half of the cache's slots, or its heads of the
    recurrent state."""
    i = [c[:2] for c in WORLDS[2]].index(("serve-fsdp_cp2", arch))
    case, parts, toks = worlds[2][i]
    cfg = _cfg(case[1], case[2])
    kv, seq = gathers(cfg)
    assert {p["shard"] for p in parts} == {0, 1}
    for p in parts:
        np.testing.assert_array_equal(p["tokens"], toks)
        assert p["context"] and p["tp"] == 2
        assert p["sites"]["context_kv_gather"] == kv
        assert p["sites"]["context_seq_gather"] == seq
