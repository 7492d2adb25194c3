"""A MoE model under the data-parallel compositions beside the expert
axis, on gloo worlds of 2 processes on the CPU, against the JAX
package's single-device dropping step: the cases and checks of
``tests/test_torch_ep.py`` (three AdamW steps of a reduced
deepseek-moe-16b, the first step's gradients against the port's
unsharded step, the state restored under plain ``fsdp``) under

- ``fsdp_z2_ep2``: ZeRO-2 (each unit stays gathered until its backward);
- ``fsdp_bf16`` (no expert axis) and ``fsdp_ep2_fp8`` (the expert units'
  parameters on an fp8 wire).

HSDP and ZeRO-0 on worlds of 4 are in ``tests/test_torch_ep_hsdp.py``
(split so that ``--dist loadfile`` spreads the two).
"""
import pytest

from test_torch_ep import (_case, cases_of,
                           check_first_step_gradients, check_restore,
                           check_training, spawn_worlds)
from test_torch_fsdp import _few_threads  # noqa: F401

WORLDS = {2: [_case("train", "fsdp_z2_ep2"), _case("train", "fsdp_bf16"),
              _case("train", "fsdp_ep2_fp8")]}


def _ids():
    return [f"{n}-{WORLDS[n][i][1]}" for n, i in cases_of(WORLDS, "train")]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return spawn_worlds(WORLDS, tmp_path_factory)


@pytest.mark.parametrize("n,i", cases_of(WORLDS, "train"), ids=_ids())
def test_moe_training_matches_jax_dropping(worlds, n, i):
    check_training(*worlds[n][i])


@pytest.mark.parametrize("n,i", cases_of(WORLDS, "train"), ids=_ids())
def test_moe_step_gradients_equal_the_unsharded_step(worlds, n, i):
    check_first_step_gradients(*worlds[n][i])


@pytest.mark.parametrize("n,i", cases_of(WORLDS, "train"), ids=_ids())
def test_moe_state_restores_under_fsdp(worlds, n, i):
    check_restore(worlds[n][i][1])
