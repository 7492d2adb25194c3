"""MoE under pipeline parallelism: dbrx-132b (a uniform MoE stack) under
``fsdp_pp2`` with the gpipe and 1f1b schedules, and ``fsdp_pp2_ep2``
(the expert all-to-all inside each stage), against the JAX package's
single-device step, on gloo worlds of 2 and 4 processes on the CPU; and
the JAX package's three refusals of MoE pipelines, with its messages.

Each pipeline stage returns its MoE layers' aux beside its activation and
the step's aux is the mean over the M microbatches (the JAX package's
``_pipeline_blocks``).  The reference is JAX's single-device step with
the M microbatches as gradient accumulation: every microbatch is masked
alike, so its loss and gradients are the pipeline's, its aux the same
microbatch average.  One AdamW step at ``tests/test_torch_fsdp.py``'s f32
bars, the aux within 1e-6 relative (``tests/test_torch_moe_tp.py``,
whose worlds' machinery this file shares).
"""
import pytest
from test_torch_moe_tp import DBRX, _ids_of, check_step, spawn_worlds
from test_torch_fsdp import _few_threads  # noqa: F401

WORLDS = {2: [("fsdp_pp2_mb2", *DBRX), ("fsdp_pp2_mb2_1f1b", *DBRX)],
          # pipe 2 x expert 2: each stage's experts split over the expert
          # axis, its microbatch rows too
          4: [("fsdp_pp2_ep2_mb2", *DBRX)]}
CASES = [(n, i) for n, cases in WORLDS.items() for i in range(len(cases))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return spawn_worlds(WORLDS, tmp_path_factory, "moepp")


@pytest.mark.parametrize("world_case", CASES, ids=_ids_of(WORLDS))
def test_moe_pipeline_steps_match_the_jax_step(worlds, world_case):
    """Loss, nll, grad_norm and moments at the f32 bars; the aux, the
    mean over the microbatches of each one's aux summed over the stages,
    within 1e-6 of JAX's; every MoE layer took the all-to-all under an
    expert axis."""
    n, i = world_case
    case, got, ref = worlds[n][i]
    check_step((n,) + case, got, ref)
    assert got["metrics"][0]["aux"] > 0
    assert got["mesh"]["pipe"] == 2
    # each pipe rank runs its one MoE layer once a microbatch
    for r in got["ranks"]:
        assert r["calls"]["dispatch"]["ep_calls"] == \
            (2 if "ep" in case[0] else 0)
        assert r["calls"]["sites"]["moe_combine"] == 0


# ---------------------------------------------------------------------------
# the JAX package's refusals, word for word
# ---------------------------------------------------------------------------

REFUSALS = [
    # deepseek-moe-16b's dense first layer: no uniform stack to stage
    ("deepseek-moe-16b", "fsdp_pp2_mb4", 64),
    # pp x tp on a MoE stack needs an expert axis
    ("dbrx-132b", "fsdp_pp2_tp2_mb4", 64),
    # 4 rows a step over 4 microbatches: one row a microbatch does not
    # shard over the expert axis after the data axis
    ("dbrx-132b", "fsdp_pp2_ep2_mb4", 4),
]


@pytest.mark.parametrize("arch,spec,batch", REFUSALS)
def test_moe_pipelines_are_refused_as_jax_refuses_them(arch, spec, batch):
    from repro import strategy as jstrategy
    from repro.configs import ShapeConfig as JShapeConfig
    from repro.configs import get_config as jax_get_config
    from repro_torch import strategy
    from repro_torch.configs import ShapeConfig, get_config
    topo = strategy.host_topology(n_devices=8)
    jtopo = jstrategy.Topology("host", 8, 8)
    with pytest.raises(jstrategy.StrategyError) as want:
        jstrategy.parse(spec).to_plan(
            jax_get_config(arch), jtopo,
            JShapeConfig("t", 512, batch, "train"), abstract=True)
    with pytest.raises(strategy.StrategyError) as got:
        strategy.parse(spec).to_plan(get_config(arch), topo,
                                     ShapeConfig("t", 512, batch, "train"),
                                     abstract=True)
    assert str(got.value) == str(want.value)
