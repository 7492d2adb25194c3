"""The port's telemetry schema check against the JAX package's, on the CPU.

``repro_torch.telemetry``'s ``validate_jsonl``, ``validate_chrome_trace``
and ``check_paths`` give the verdicts and error lists of
``repro/telemetry/events.py`` on the same files — good ones and one of
each fault — and ``python -m repro_torch.telemetry`` (``main``) passes
what the port's own sinks write over a short training run.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.telemetry import events as jevents
from repro.telemetry.__main__ import main as jax_main
from repro_torch import telemetry as tel
from repro_torch.configs import get_config, reduced
from repro_torch.data import Batcher, SyntheticSource
from repro_torch.models import Runtime, init_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train_loop
from test_torch_fsdp import _few_threads  # noqa: F401

GOOD_EVENTS = [
    tel.make_event("span", "train/step", 1.0, dur=0.5, tid=1, depth=0,
                   attrs={"step": 0}),
    tel.make_event("counter", "c", 1.5, value=2.0, delta=1.0),
    tel.make_event("gauge", "g", 2.0, value=0.25),
    tel.make_event("histogram", "h", 2.5, value=3.0, n=2),
    tel.make_event("event", "e", 3.0, attrs={"kind": "failure"}),
]
# name -> the lines of a JSONL file with one fault
JSONL_FAULTS = {
    "not_json": ["{\"ts\": 1.0, \"kind\": \"gauge\"", ],
    "missing_ts": [{"kind": "gauge", "name": "g", "value": 1.0}],
    "unknown_kind": [{"ts": 1.0, "kind": "meter", "name": "g"}],
    "negative_dur": [{"ts": 1.0, "kind": "span", "name": "s", "dur": -1.0}],
    "attrs_not_dict": [{"ts": 1.0, "kind": "event", "name": "e",
                        "attrs": [1, 2]}],
}
TRACE_FAULTS = {
    "no_trace_events": {"events": []},
    "x_without_pid": {"traceEvents": [
        {"ph": "X", "name": "s", "ts": 1.0, "dur": 2.0, "tid": 0}]},
}


def _write_jsonl(path, lines):
    with open(path, "w") as f:
        for line in lines:
            f.write((line if isinstance(line, str) else json.dumps(line))
                    + "\n")


def _good_files(d):
    """A JSONL stream and a Chrome trace written by the port's sinks."""
    jsonl = tel.JsonlSink(os.path.join(d, "events.jsonl"))
    trace = tel.ChromeTraceSink(os.path.join(d, "run_trace.json"))
    for ev in GOOD_EVENTS:
        jsonl.emit(ev)
        trace.emit(ev)
    jsonl.close()
    trace.close()
    return [os.path.join(d, "events.jsonl"), os.path.join(d, "run_trace.json")]


def test_good_files_validate_clean(tmp_path):
    jsonl, trace = _good_files(str(tmp_path))
    assert tel.validate_jsonl(jsonl) == jevents.validate_jsonl(jsonl) \
        == (len(GOOD_EVENTS), [])
    n, errs = tel.validate_chrome_trace(trace)
    assert (n, errs) == jevents.validate_chrome_trace(trace)
    assert n > len(GOOD_EVENTS) and errs == []


@pytest.mark.parametrize("fault", sorted(JSONL_FAULTS))
def test_jsonl_fault_matches_jax(tmp_path, fault):
    path = str(tmp_path / f"{fault}.jsonl")
    _write_jsonl(path, [GOOD_EVENTS[0], *JSONL_FAULTS[fault]])
    got = tel.validate_jsonl(path)
    assert got == jevents.validate_jsonl(path)
    assert got[0] == 2 and len(got[1]) >= 1
    assert all(e.startswith(f"{path}:2: ") for e in got[1])


@pytest.mark.parametrize("fault", sorted(TRACE_FAULTS))
def test_trace_fault_matches_jax(tmp_path, fault):
    path = str(tmp_path / f"{fault}_trace.json")
    with open(path, "w") as f:
        json.dump(TRACE_FAULTS[fault], f)
    got = tel.validate_chrome_trace(path)
    assert got == jevents.validate_chrome_trace(path)
    assert len(got[1]) == 1


def test_check_paths_and_cli_match_jax(tmp_path, capsys):
    _good_files(str(tmp_path))
    bad = tmp_path / "sub"
    bad.mkdir()
    for fault, lines in JSONL_FAULTS.items():
        _write_jsonl(str(bad / f"{fault}.jsonl"), lines)
    for fault, doc in TRACE_FAULTS.items():
        (bad / f"{fault}_trace.json").write_text(json.dumps(doc))
    got = tel.check_paths([str(tmp_path)])
    assert got == jevents.check_paths([str(tmp_path)])
    n_files, _, errs = got
    assert n_files == 2 + len(JSONL_FAULTS) + len(TRACE_FAULTS)
    assert len(errs) == len(JSONL_FAULTS) + len(TRACE_FAULTS)
    assert tel.main([str(tmp_path)]) == jax_main([str(tmp_path)]) == 1
    out = capsys.readouterr()
    assert out.out.count("telemetry schema check:") == 2
    assert tel.main([str(tmp_path / "events.jsonl")]) == 0


def test_training_run_artifacts_validate(tmp_path, capsys):
    """The sinks of a 2-step CPU ``train_loop`` (reduced qwen3) pass
    ``main([dir])``; an empty directory gives 1."""
    d = tmp_path / "telemetry_torch"
    rec = tel.Recorder(sinks=[tel.JsonlSink(str(d / "train.jsonl")),
                              tel.ChromeTraceSink(str(d / "train_trace.json"))])
    cfg = reduced(get_config("qwen3-0.6b"))
    torch.manual_seed(0)
    params = init_params(cfg, 0, "cpu")
    batches = Batcher(SyntheticSource(cfg.vocab_size, seed=0), 16, 2)
    _, _, history = train_loop(
        cfg, Runtime(), TrainConfig(steps=2, warmup=1, log_every=1,
                                    opt=AdamWConfig(lr=1e-3)),
        batches, params, telemetry=rec)
    rec.close()
    assert np.isfinite([h["loss"] for h in history]).all()
    n_files, n_events, errs = tel.check_paths([str(d)])
    assert (n_files, errs) == (2, []) and n_events > 10
    assert tel.main([str(d)]) == 0
    assert "2 files" in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tel.main([str(empty)]) == 1
    assert "no telemetry artifacts found" in capsys.readouterr().err
