"""The port's drift monitor and bubble probe against the JAX package's, on
the CPU.

``repro_torch.telemetry.DriftMonitor`` is a copy of
``repro/telemetry/drift.py``: the same windows give the same report and
the same gauges, and the predicted side, ``StepReport.decomposition()``,
is the same float for float.  ``train_loop`` feeds it one window a log
and sets ``train/mfu``; the train CLI's ``--drift_report`` writes it (rank
0 under torchrun).  ``core.pipeline.measure_bubble_fraction`` is held to
the JAX package's own probe tests' callables, and the probe
(``perf.pipeline_probe``) runs the port's pipelined step on a gloo world
of 2 through the dry run's ``--measure_bubble``.
"""
import json
import time

import numpy as np
import pytest
import torch

from repro import strategy as jstrategy
from repro import telemetry as jtel
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_config as jax_get_config
from repro.core import pipeline as jpipe
from repro_torch import strategy
from repro_torch import telemetry as tel
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import pipeline as pipe
from test_torch_strategy import _run
from test_torch_fsdp import _few_threads  # noqa: F401


class _Events(tel.Sink):
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)


def _gauges(events):
    return {e["name"]: e["value"] for e in events if e["kind"] == "gauge"}


# ---------------------------------------------------------------------------
# the monitor: JAX's three synthetic cases (tests/test_telemetry.py)
# ---------------------------------------------------------------------------

# (predicted, meta, [(measured, n_steps)])
MONITOR_CASES = {
    "ratios": ({"step": 1.0, "compute": 0.6, "collective": 0.3,
                "bubble": 0.1}, None,
               [({"step": 2.0, "compute": 0.6, "collective": 0.15,
                  "data": 0.01}, 10)]),
    "zero_measured": ({"collective": 0.3}, None,
                      [({"collective": 0.0}, 1)]),
    "windows": ({"step": 1.0}, {"spec": "fsdp"},
                [({"step": 2.0}, 5), ({"step": 1.0}, 5)]),
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_drift_monitor_matches_jax(case, tmp_path):
    """The same windows give the same windows, summary, report, written
    file and ``drift/predicted_over_measured/<term>`` gauges."""
    predicted, meta, windows = MONITOR_CASES[case]
    jmem = jtel.InMemorySink()
    jmon = jtel.DriftMonitor(predicted, telemetry=jtel.Recorder(
        sinks=[jmem], annotate_jax=False), meta=meta)
    mem = _Events()
    mon = tel.DriftMonitor(predicted, telemetry=tel.Recorder(
        sinks=[mem], annotate=False), meta=meta)
    for measured, n in windows:
        assert mon.observe(measured, n_steps=n) == \
            jmon.observe(measured, n_steps=n)
    assert mon.summary() == jmon.summary()
    assert mon.report() == jmon.report()
    assert _gauges(mem.events) == _gauges(jmem.events)
    got = mon.write(str(tmp_path / "port.json"))
    want = jmon.write(str(tmp_path / "jax.json"))
    assert got == want
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()


# ---------------------------------------------------------------------------
# the predicted side: StepReport.decomposition()
# ---------------------------------------------------------------------------

DECOMP_ARCHS = ["qwen3-0.6b", "llama2-7b", "rwkv6-1.6b"]
DECOMP_SPECS = ["fsdp", "fsdp_bf16", "hsdp_tp2", "fsdp_pp2_mb4"]
DECOMP_TOPOS = {
    "host1": (strategy.host_topology(n_devices=1),
              jstrategy.host_topology(n_devices=1)),
    "host8": (strategy.host_topology(n_devices=8),
              jstrategy.host_topology(n_devices=8)),
    "pod": (strategy.pod_topology(), jstrategy.pod_topology()),
    "multipod": (strategy.get_topology("multipod"),
                 jstrategy.get_topology("multipod")),
}


@pytest.mark.parametrize("topo", sorted(DECOMP_TOPOS))
@pytest.mark.parametrize("spec", DECOMP_SPECS)
@pytest.mark.parametrize("arch", DECOMP_ARCHS)
def test_decomposition_matches_jax(arch, spec, topo):
    """``evaluate(...).decomposition()`` — what ``--drift_report``
    predicts — equals JAX's, float for float, at the train CLI's shape
    (B 8 x S 512) and at train_4k's; a spec that cannot run on the
    topology is refused by both."""
    mine_t, ref_t = DECOMP_TOPOS[topo]
    js, s = jstrategy.parse(spec), strategy.parse(spec)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    try:
        js.check(ref_t, jcfg)
    except jstrategy.StrategyError:
        with pytest.raises(strategy.StrategyError):
            s.check(mine_t, cfg)
        return
    for S, B in ((512, 8), (4096, 256)):
        want = jstrategy.evaluate(jcfg, js, ref_t,
                                  JShapeConfig("x", S, B, "train"))
        got = strategy.evaluate(cfg, s, mine_t,
                                ShapeConfig("x", S, B, "train"))
        assert got.decomposition() == want.decomposition(), (S, B)
        assert (got.mfu, got.t_step) == (want.mfu, want.t_step)


# ---------------------------------------------------------------------------
# the trainer's windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps,log_every,windows", [(4, 2, 3), (3, 1, 3)])
def test_train_loop_feeds_one_window_a_log(steps, log_every, windows):
    """One window per logging step (the first step logs too), with the
    measured terms step, dispatch, wait and data in seconds per step; the
    ``train/mfu`` gauge is the meta's flops over the window's step time
    over the peak, as the JAX trainer sets it."""
    from repro_torch.data import Batcher, SyntheticSource
    from repro_torch.models import init_params
    from repro_torch.models.layers import Runtime
    from repro_torch.train import TrainConfig, train_loop
    cfg = reduced(get_config("qwen3-0.6b"), n_layers=2, d_model=64)
    mem = _Events()
    rec = tel.Recorder(sinks=[mem], annotate=False)
    meta = {"model_flops_per_step": 3.0e9, "cluster_peak_flops": 1.0e12}
    drift = tel.DriftMonitor({"step": 1e-3, "compute": 5e-4},
                             telemetry=rec, meta=meta)
    _, _, history = train_loop(
        cfg, Runtime(), TrainConfig(steps=steps, warmup=1,
                                    log_every=log_every),
        Batcher(SyntheticSource(cfg.vocab_size, seed=7), 16, 4),
        init_params(cfg, 0, "cpu"), telemetry=rec, drift=drift)
    assert len(history) == len(drift.windows) == windows
    assert sum(w["n_steps"] for w in drift.windows) == steps
    for w in drift.windows:
        assert set(w["measured"]) == {"step", "dispatch", "wait", "data"}
        m = w["measured"]
        assert m["step"] > 0 and m["dispatch"] > 0
        assert m["dispatch"] + m["wait"] + m["data"] <= m["step"] * 1.01
        assert w["predicted_over_measured"]["step"] == pytest.approx(
            1e-3 / m["step"])
    mfu = [e["value"] for e in mem.events if e["name"] == "train/mfu"]
    assert mfu == pytest.approx(
        [3.0e9 / w["measured"]["step"] / 1.0e12 for w in drift.windows],
        rel=1e-6)
    assert len(drift.windows) == len(
        [e for e in mem.events if e["name"] == "drift/predicted_over_"
         "measured/step"])


DRIFT_CLI = ["-m", "repro_torch.launch.train", "--device", "cpu",
             "--reduced", "--strategy", "auto", "--steps", "4",
             "--log_every", "1", "--seq_len", "32", "--global_batch", "4"]


@pytest.mark.parametrize("ranks", [1, 2])
def test_cli_drift_report(ranks, tmp_path):
    """``--drift_report`` writes one report (rank 0 alone under torchrun):
    a window per logging step with a finite ``step`` ratio, the planner's
    decomposition as the predicted side, and the meta the JAX CLI
    writes."""
    path = tmp_path / "d.json"
    launch = ([] if ranks == 1 else
              ["-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(ranks)])
    r = _run([*launch, *DRIFT_CLI, "--drift_report", str(path)])
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("[telemetry] drift report -> ") == 1
    doc = json.loads(path.read_text())
    assert doc["n_windows"] == 4
    assert np.isfinite(doc["mean_predicted_over_measured"]["step"])
    assert doc["predicted"]["compute"] > 0
    topo = strategy.host_topology(n_devices=ranks)
    cfg = reduced(get_config("qwen3-0.6b"))
    s, planned = strategy.resolve("auto", cfg, topo,
                                  ShapeConfig("cli", 32, 4, "train"))
    assert doc["predicted"] == pytest.approx(planned.report.decomposition())
    assert doc["meta"]["spec"] == s.format()
    assert doc["meta"]["cluster_peak_flops"] == \
        ranks * topo.hw.flops_bf16
    assert set(doc["meta"]) == {
        "spec", "topology", "hardware", "arch", "seq_len", "global_batch",
        "model_flops_per_step", "cluster_peak_flops"}


# ---------------------------------------------------------------------------
# the measured bubble
# ---------------------------------------------------------------------------

def _sleeper(delay):
    def run():
        time.sleep(delay)
        return torch.zeros(())
    return run


def test_measure_bubble_flags_unreliable_fit():
    """JAX's callables (``tests/test_pipeline_schedules.py``): a
    non-increasing fit is flagged, not reported as a zero bubble, and an
    increasing one is not; the JAX function gives the same flags."""
    def noisy(m):
        return _sleeper(0.03 if m == 4 else 0.01)

    def ok(m):
        return _sleeper(0.01 * (m + 1))

    for fn, sched, flag in ((noisy, "gpipe", True), (ok, "1f1b", False)):
        got = pipe.measure_bubble_fraction(fn, n_stages=2, microbatches=4,
                                           n_iter=1, sched=sched)
        want = jpipe.measure_bubble_fraction(fn, n_stages=2,
                                             microbatches=4, n_iter=1,
                                             sched=sched)
        assert got["fit_unreliable"] is want["fit_unreliable"] is flag
        assert set(got) == set(want)
        assert got["sched"] == sched
        assert (got["bubble_measured"] == 0.0) == flag


def test_measure_bubble_interleaved_matches_formula():
    """A step of exactly t_tick * (v M + P - 1): the interleaved fit
    recovers (P-1)/(vM+P-1) within the probe's 20 %, as JAX's does."""
    P_, M, v, c = 2, 4, 2, 0.006

    def step_for_m(m):
        return _sleeper(c * (v * m + (P_ - 1)))

    rec = pipe.measure_bubble_fraction(step_for_m, n_stages=P_,
                                       microbatches=M, n_iter=2,
                                       sched=f"1f1b_i{v}")
    assert rec["virtual_stages"] == v
    assert rec["bubble_predicted"] == jpipe.bubble_fraction(P_, M,
                                                            f"1f1b_i{v}")
    assert rec["fit_unreliable"] is False
    assert rec["bubble_measured"] == pytest.approx(rec["bubble_predicted"],
                                                   rel=0.2)


@pytest.mark.parametrize("spec", ["fsdp_pp2_mb4", "fsdp_pp2_mb4_zb"])
def test_probe_on_a_gloo_world_of_two(spec, tmp_path):
    """``torchrun --nproc_per_node 2 -m repro_torch.launch.dryrun
    --topology host --measure_bubble``: the record's pipeline block
    carries the probe's record with JAX's keys (its
    ``measure_bubble_fraction`` record and the probe's three), the
    predicted bubble JAX's, and the probe's reduced layer count."""
    r = _run(["-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "2", "-m", "repro_torch.launch.dryrun",
              "--arch", "qwen3-0.6b", "--shape", "train_4k",
              "--topology", "host", "--reduced", "--kernels", "torch",
              "--strategy", spec, "--measure_bubble", "--device", "cpu",
              "--out", str(tmp_path)], timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    got = rec["pipeline"]
    s = strategy.parse(spec)
    want_keys = set(jpipe.measure_bubble_fraction(
        lambda m: _sleeper(0.001 * m), 2, 4, n_iter=1)) | {
        "probe_cfg", "probe_seq_len", "probe_mb_rows"}
    assert want_keys <= set(got)
    assert got["bubble_predicted"] == jpipe.bubble_fraction(
        s.pp, s.microbatches, s.sched)
    assert got["virtual_stages"] == jpipe.virtual_stages(s.sched)
    assert got["t_step_s"] > 0 and isinstance(got["fit_unreliable"], bool)
    assert got["probe_cfg"] == reduced(get_config("qwen3-0.6b")).name
    assert rec["n_devices"] == 2
