"""Where FSDP2 shards a MoE expert stack over the data axes, seen in the
pod dry run: under ``fsdp_bf16`` on ``pod`` (256 fake ranks, data 256)
dbrx-132b's and jamba-v0.1-52b's 16 experts are fewer than the data
ranks, and the stacks lie on d, where the JAX package's spec puts the
data axis (``core.parallel.data_shard_dim``).  On E, FSDP2 would pad
every stack to a whole expert a rank (29.60 / 10.60 GiB of parameters a
device where an even share is 1.92 / 0.75 GiB).  Each point's parameter
bytes are within 2 % of an even 1/256 of the f32 parameters, its AdamW
moments' within 2 % of twice that.  (The gloo world with a data degree
above E is in ``tests/test_torch_remat_worlds.py``.)
"""
import pytest

from repro_torch.configs import get_config
from test_torch_dryrun import trace_points
from test_torch_fsdp import _few_threads  # noqa: F401

EVEN_REL = 0.02
RANKS = 256


ARCHS = ["dbrx-132b", "jamba-v0.1-52b"]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return trace_points({arch: (arch, "train_4k", dict(strategy="fsdp_bf16"))
                         for arch in ARCHS}, tmp_path_factory.mktemp("pod"))


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_expert_stacks_shard_evenly(arch, records):
    rec = records[arch]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["plan"]["mesh"] == {"data": RANKS, "model": 1}
    n = get_config(arch).param_count()
    assert rec["params_total"] == n
    mem = rec["memory"]
    assert abs(mem["parameters_bytes"] - 4 * n / RANKS) <= \
        EVEN_REL * 4 * n / RANKS, mem
    assert abs(mem["optimizer_bytes"] - 8 * n / RANKS) <= \
        EVEN_REL * 8 * n / RANKS, mem
