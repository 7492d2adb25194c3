"""The port's examples (``examples/torch_*.py``) on the CPU: the explorer
ranks what the JAX package's ``examples/parallelism_explorer.py`` ranks,
number for number; the quickstart and the 100M example train to finite
losses (the 100M example's checkpoint restores bit-equal) and the batched
server returns the tokens it asked for.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np

from repro_torch import checkpointing as ckpt_lib
from test_torch_fsdp import _few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
REPORT_KEYS = ("wps", "mfu", "t_comm_exposed", "t_step", "power_per_device",
               "tokens_per_joule", "memory_per_device")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b))


def test_explorer_ranks_as_jax(monkeypatch, capsys):
    jax_ex = _example("parallelism_explorer")
    seen = {}
    search = jax_ex.strategy_lib.search

    def recording(*a, **kw):
        seen["ranked"] = search(*a, **kw)
        return seen["ranked"]

    monkeypatch.setattr(jax_ex.strategy_lib, "search", recording)
    monkeypatch.setattr(sys, "argv", ["parallelism_explorer.py"])
    jax_ex.main()
    jax_lines = capsys.readouterr().out.splitlines()
    got = _example("torch_parallelism_explorer").main([])
    lines = capsys.readouterr().out.splitlines()
    want = seen["ranked"]
    assert [p.spec for p in got["ranked"]] == [p.spec for p in want]
    for p, q in zip(got["ranked"], want):
        assert p.lowers == q.lowers and p.report.fits == q.report.fits
        for k in REPORT_KEYS:
            assert _close(getattr(p.report, k), getattr(q.report, k)), \
                (p.spec, k)
    # the printed table is JAX's line for line; the recommendation names
    # each package's own CLIs
    assert lines[:-1] == jax_lines[:-1]
    assert "repro_torch.launch.train" in lines[-1]


def test_quickstart_trains_and_serves():
    res = _example("torch_quickstart").main(["--device", "cpu",
                                             "--steps", "8"])
    losses = res["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert res["tokens"].shape == (2, 64 + 16)
    assert res["serve_stats"]["decode_steps"] > 0


def test_train_100m_checkpoint_restores_bit_equal(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = _example("torch_train_100m").main([
        "--steps", "2", "--device", "cpu", "--ckpt_every", "2",
        "--global_batch", "2", "--seq_len", "32"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    ckpt_dir = "results/ckpt/llama-100m"
    assert ckpt_lib.latest_valid_step(ckpt_dir) == 2
    state = res["state"]
    restored = ckpt_lib.restore_checkpoint(ckpt_dir, 2, state)
    flat = dict(ckpt_lib.checkpoint._walk(restored))
    want = dict(ckpt_lib.checkpoint._walk(state))
    assert flat.keys() == want.keys() and len(want) > 10
    for k, v in want.items():
        got = np.asarray(flat[k])
        v = np.asarray(v)
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k


def test_serve_batched_returns_its_tokens():
    res = _example("torch_serve_batched").main(["--device", "cpu"])
    assert res["tokens"] == 8 * 24
    assert res["greedy"].shape == res["sampled"].shape == (8, 48 + 24)
