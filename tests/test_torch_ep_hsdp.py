"""A MoE model under HSDP and ZeRO-0, beside the expert axis and
without it, on gloo worlds of 4 processes on the CPU, against the JAX
package's single-device dropping step: the cases and checks of
``tests/test_torch_ep.py`` (split from ``tests/test_torch_ep_dp.py``,
which runs ZeRO-2, bf16 and fp8 on 2 ranks) under

- ``hsdp_ep2`` on a topology of two islands of 2 (pod 2 x data 1 x
  expert 2): HSDP's replicate axis beside the flattened (data, expert)
  dim, the MoE units over (pod, data), at an aux coefficient whose
  gradient dominates the router's;
- ``ddp_ep2`` on 4 ranks (data 2 x expert 2): ZeRO-0 under an expert
  axis;
- ``hsdp`` (pod 2 x data 2) and ``ddp`` on 4 ranks without an expert
  axis: the dropping dispatch, one group a rank, the router's statistics
  averaged over two axes' groups or one.

Under the last two a MoE unit shards over one rank and replicates over
two, where FSDP2 divides before its all-reduce.
"""
import pytest

from test_torch_ep import (STRONG_AUX, _case, cases_of,
                           check_first_step_gradients, check_restore,
                           check_training, spawn_worlds)
from test_torch_fsdp import _few_threads  # noqa: F401

WORLDS = {4: [_case("train", "hsdp_ep2", STRONG_AUX, (4, 2)),
              _case("train", "ddp_ep2"), _case("train", "hsdp", None, (4, 2)),
              _case("train", "ddp")]}


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
