"""The serve CLI's ``--strategy``/``--engine`` on the CPU: static serving
under a plan on one rank and on 2 gloo ranks prints the single-device
static run's tokens; the paged engine refuses a plan."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
from test_torch_fsdp import _few_threads  # noqa: F401
from test_torch_fsdp import cli_env

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def _run(args, nproc=0):
    env = cli_env()
    pre = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc)] if nproc else [sys.executable])
    return subprocess.run([*pre, "-m", "repro_torch.launch.serve",
                           "--device", "cpu", "--reduced", "--n_new", "5",
                           "--kernels", "torch", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def _tail(out):
    return re.search(r"first sequence tail: (\[.*\])", out).group(1)


@pytest.fixture(scope="module")
def single_run():
    r = _run(["--engine", "static"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "engine=static" in r.stdout
    return _tail(r.stdout)


@pytest.mark.parametrize("nproc,strategy", [(0, "auto"), (0, "fsdp"),
                                            (2, "fsdp_tp2"), (2, "fsdp")])
def test_cli_serves_under_a_strategy(single_run, nproc, strategy):
    """``--strategy`` on one rank and on 2 gloo ranks serves statically
    and rank 0 prints; an f32 plan prints the single-device static run's
    tokens ('auto' picks ``fsdp_bf16`` here, whose tokens may differ)."""
    r = _run(["--strategy", strategy, "--engine", "static"], nproc)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("[strategy]") == 1
    assert "engine=static" in r.stdout
    if strategy == "auto":
        assert "[strategy] fsdp_bf16" in r.stdout
    else:
        assert _tail(r.stdout) == single_run


def test_cli_paged_engine_refuses_a_plan():
    r = _run(["--strategy", "fsdp", "--engine", "paged"])
    assert r.returncode != 0
    assert "--engine paged needs a single-device plan" in r.stderr
