"""Non-token inputs under a plan, on gloo worlds of 2 processes on the CPU
(the single-process tests: ``tests/test_torch_inputs.py``):

- ``fsdp`` at dp 2 on qwen2-vl-2b: each rank its rows of every leaf, the
  3-D ``position_ids`` (3, B, S) cut on dim 1;
- ``fsdp_tp2`` (sequence parallel) on musicgen-medium's frame embeddings
  (each rank embeds its S-shard, the token table unused) and on
  qwen2-vl-2b's vision patches, which straddle the shard boundary (S 24,
  V 16: rank 1's rows 12-23 take patches 12-15);
- ``fsdp_cp2`` on both, the patches straddling the context split the same
  way, the position ids cut on dim 2;
- ``fsdp_pp2_mb2`` on musicgen-medium: the first stage embeds the frames
  of each pipeline microbatch (M-RoPE refuses a pipeline, as in the JAX
  package).

Each case runs one AdamW step from the JAX initialiser's weights and is
held to the port's single-process step and to the JAX package's
single-device step at the f32 bars of ``tests/test_torch_moe_tp.py``
(``check_step``: metrics within 1e-5, first moments within 1e-4 of each
leaf's scale).  The world is spawned once for the module; its workers
import only torch and the port.
"""
import numpy as np
import pytest
import torch
from test_torch_moe_tp import _cfg, _jax_step, check_step, spawn_worlds
from test_torch_fsdp import _few_threads  # noqa: F401

MUSICGEN, QWEN2VL = ("musicgen-medium", {}), ("qwen2-vl-2b", {})
S, GRID = 24, (4, 4)            # rank 1 of 2 holds patches 12..15 of 16
WORLDS = {2: [("fsdp", *QWEN2VL), ("fsdp_tp2", *MUSICGEN),
              ("fsdp_tp2", *QWEN2VL), ("fsdp_cp2", *MUSICGEN),
              ("fsdp_cp2", *QWEN2VL), ("fsdp_pp2_mb2", *MUSICGEN)]}


def _step_case(case, rank):
    """One AdamW step of the case's plan on its batch -> metrics, final
    parameters and first moments (rank 0), and each rank's residual
    stream rows and collectives."""
    import torch.distributed as dist

    from repro_torch import bridge, strategy
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import parallel as par
    from repro_torch.models import layers
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    spec, arch, over = case["case"]
    cfg = _cfg(arch, over)
    batch = {k: torch.tensor(v) for k, v in case["batches"][0].items()}
    B = batch["labels"].shape[0]
    shape = ShapeConfig("test", S, B, "train")
    plan = strategy.parse(spec).to_plan(cfg, strategy.host_topology(), shape)
    rt = par.make_runtime(cfg, plan, shape, remat=False)
    params = par.apply_plan(bridge.params_from_jax(case["tree"]), plan, cfg)
    state = init_opt_state(params)
    step = make_train_step(cfg, rt, TrainConfig(
        steps=3, warmup=1, opt=AdamWConfig(lr=1e-3, weight_decay=0.0)),
        plan)
    layers.reset_collective_counts()
    _, state, m = step(params, state, batch)
    tree = bridge.train_state_to_tree(
        params, state, cfg, rt.pipe_group if rt.pipe_size > 1 else None)
    mine = dict(sp=layers.sequence_parallel(rt, S),
                cp=layers.context_parallel(rt, S),
                sites=dict(layers.COLLECTIVE_SITES))
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, mine)
    out = dict(metrics=[{k: float(v) for k, v in m.items()}],
               params=tree["params"], m=tree["opt"]["m"], ranks=parts,
               attn=plan.attn)
    return out if rank == 0 else None


def _batch(jc, rows, seed):
    rng = np.random.default_rng(seed)
    b = {}
    if jc.input_mode == "embeddings":
        b["embeds"] = (0.1 * rng.standard_normal(
            (rows, S, jc.d_model))).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, jc.vocab_size, (rows, S)).astype(
            np.int32)
        b["vision_embeds"] = (0.02 * rng.standard_normal(
            (rows, jc.vision_tokens, jc.d_model))).astype(np.float32)
        from repro_torch.launch.specs import grid_position_ids
        b["position_ids"] = grid_position_ids(rows, S, *GRID).numpy()
    labels = rng.integers(0, jc.vocab_size, (rows, S)).astype(np.int32)
    # every pair of rows (a data-parallel rank's, a pipeline microbatch's)
    # masked alike
    labels[1::2, S // 2:] = -1
    b["labels"] = labels
    return b


def _inputs(case, n):
    from test_torch_fsdp import _jax_tree
    spec, arch, over = case
    jc, tree = _jax_tree(arch, over)
    return dict(tree=tree, batches=[_batch(jc, 4, seed=n)], run=_step_case)


def _port_step(case, tree, batch):
    """The port's single-process step on the same weights and batch."""
    from repro_torch import bridge
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    cfg = _cfg(case[1], case[2])
    params = bridge.params_from_jax(tree)
    step = make_train_step(cfg, Runtime(), TrainConfig(
        steps=3, warmup=1, opt=AdamWConfig(lr=1e-3, weight_decay=0.0)))
    _, state, m = step(params, init_opt_state(params),
                       {k: torch.tensor(v) for k, v in batch.items()})
    tree = bridge.train_state_to_tree(params, state, cfg)
    return dict(metrics=[{k: float(v) for k, v in m.items()}],
                params=tree["params"], m=tree["opt"]["m"])


def _reference(case, n, tree, batches, run=None):
    return dict(jax=_jax_step(case, n, tree, batches),
                port=_port_step(case, tree, batches[0]))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return spawn_worlds(WORLDS, tmp_path_factory, "inputs", _inputs,
                        _reference)


def _id(i):
    spec, arch, _ = WORLDS[2][i]
    return f"{spec}-{arch}"


@pytest.mark.parametrize("i", range(len(WORLDS[2])), ids=_id)
def test_input_steps_under_a_plan_match_one_process_and_jax(worlds, i):
    """The step's metrics and first moments against the port's
    single-process step and JAX's single-device step; every rank ran the
    plan's layout of the stream (its S-shard under fsdp_tp2's sequence
    parallelism and fsdp_cp2's context split, K/V gathered in every layer
    under the latter)."""
    case, got, ref = worlds[2][i]
    for name in ("port", "jax"):
        check_step((2,) + case, got, ref[name])
    spec, arch, over = case
    n_layers = _cfg(arch, over).n_layers
    for r in got["ranks"]:
        assert (r["sp"], r["cp"]) == (spec == "fsdp_tp2", spec == "fsdp_cp2")
        assert r["sites"]["context_kv_gather"] == (
            2 * n_layers if spec == "fsdp_cp2" else 0)
    assert got["attn"] == ("context" if spec == "fsdp_cp2" else "head_tp")
