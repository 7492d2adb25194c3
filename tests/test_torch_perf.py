"""The port's measurement and reporting modules against the JAX package's,
on the CPU: the closed-form HBM bytes (``perf/bytes.py``), the three-term
roofline (``perf/roofline.py``) and its record selection, the repo-root
paths (``perf/paths.py``) and the report (``perf/report.py``) with its
paper-claims values from the cost model.

Pure Python: records are built from a numpy seed; nothing is traced.
"""
import json
import os

import numpy as np
import pytest

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.core import costmodel as jcm
from repro.perf import bytes as jbytes
from repro.perf import flops as jflops
from repro.perf import paths as jpaths
from repro.perf import roofline as jroofline
from repro_torch.configs import REGISTRY, SHAPES, get_config
from repro_torch.core import costmodel as cm
from repro_torch.perf import bytes as tbytes
from repro_torch.perf import paths
from repro_torch.perf import report
from repro_torch.perf import roofline
from repro_torch.perf.memory import CATEGORIES
from test_torch_fsdp import _few_threads  # noqa: F401

ARCHS = sorted(set(REGISTRY) | set(JAX_REGISTRY))
HARDWARE = ("H100", "A100", "TPUv5e")
ROW_KEYS = ("t_compute_s", "t_memory_s", "t_collective_s", "roofline_step_s",
            "roofline_mfu", "useful_ratio", "model_flops", "compiled_flops")
REL = 1e-12


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_hbm_bytes_match_jax(arch):
    """Every registered arch of both packages x the four shapes x 1, 8,
    256 and 512 devices x remat on and off."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        for n in (1, 8, 256, 512):
            for remat in (True, False):
                got = tbytes.hbm_bytes_per_device(cfg, SHAPES[name], n,
                                                  remat=remat)
                want = jbytes.hbm_bytes_per_device(jcfg, JSHAPES[name], n,
                                                   remat=remat)
                assert _close(got, want), (name, n, remat, got, want)


def _record(rng, arch, shape, mesh="pod16x16", **extra):
    """A dry-run record of the shape both packages' rows read: JAX's
    memory keys (XLA's argument and temp bytes) beside the port's (the
    traced peak and its categories)."""
    n = int(rng.choice([1, 8, 256, 512]))
    mem = {"argument_bytes_per_device": int(rng.integers(1, 2**34)),
           "temp_bytes_per_device": int(rng.integers(1, 2**34)),
           "peak_bytes_per_device": int(rng.integers(1, 2**36)),
           **{f"{c}_bytes": int(rng.integers(0, 2**34)) for c in CATEGORIES}}
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
           "n_devices": n, "plan": {"attn": str(rng.choice(
               ["head_tp", "context"]))},
           "collective_bytes_total": float(rng.uniform(0, 1e12)),
           "trace_s": float(rng.uniform(1, 100)), "memory": mem}
    if rng.random() < 0.5:      # else both fall back to compiled_flops
        rec["flops_compiled_analytic"] = float(
            rng.uniform(0.5, 2.0) * jflops.compiled_flops(
                jax_get_config(arch), JSHAPES[shape], remat=False))
    if rng.random() < 0.5:      # else both fall back to model_flops
        rec["flops_model_6nd"] = float(jflops.model_flops(
            jax_get_config(arch), JSHAPES[shape]))
    rec.update(extra)
    return rec


def _records(seed, **extra):
    rng = np.random.default_rng(seed)
    return [_record(rng, arch, shape, **extra)
            for arch in ARCHS for shape in SHAPES]


@pytest.mark.parametrize("hw", HARDWARE)
def test_roofline_row_matches_jax(hw):
    for rec in _records(0):
        got = roofline.roofline_row(rec, hw=cm.HARDWARE[hw])
        want = jroofline.roofline_row(rec, hw=jcm.HARDWARE[hw])
        for k in ROW_KEYS:
            assert _close(got[k], want[k]), (rec["arch"], rec["shape"], k)
        for k in ("dominant", "lever", "arch", "shape", "mesh", "plan",
                  "hardware"):
            assert got[k] == want[k], (rec["arch"], rec["shape"], k)
        mem = rec["memory"]
        assert got["peak_gib"] == mem["peak_bytes_per_device"] / 2**30
        for c in CATEGORIES:
            assert got[f"{c}_gib"] == mem[f"{c}_bytes"] / 2**30


def _priced_as(hw, remat):
    """Every record carrying ``"remat": remat`` is priced by JAX's bytes
    and FLOP fallback at that remat, whatever its shape."""
    jhw = jcm.HARDWARE[hw]
    for rec in _records(1, remat=remat):
        got = roofline.roofline_row(rec, hw=cm.HARDWARE[hw])
        jcfg, jshape = jax_get_config(rec["arch"]), JSHAPES[rec["shape"]]
        n = rec["n_devices"]
        hbm = jbytes.hbm_bytes_per_device(jcfg, jshape, n, remat=remat)
        assert _close(got["t_memory_s"], hbm / jhw.hbm_bw)
        flops = rec.get("flops_compiled_analytic") or \
            jflops.compiled_flops(jcfg, jshape, remat=remat)
        assert _close(got["t_compute_s"], flops / (n * jhw.flops_bf16))


@pytest.mark.parametrize("hw", HARDWARE)
def test_roofline_row_prices_a_record_without_remat(hw):
    """``"remat": false`` (what a measured step's trace writes, run as the
    train CLIs run it) reaches the bytes and the FLOP fallback: JAX's
    functions at remat=False."""
    _priced_as(hw, False)


@pytest.mark.parametrize("hw", HARDWARE)
def test_roofline_row_prices_a_record_with_remat(hw):
    """``"remat": true`` (what the port's dry run writes for a train
    shape) reaches them too: JAX's functions at remat=True, on a serving
    shape as well."""
    _priced_as(hw, True)


def test_roofline_terms_scale_with_precision():
    cfg, shape = get_config("qwen3-0.6b"), SHAPES["train_4k"]
    bf16 = roofline.roofline_terms(cfg, shape, 8, 1e9, remat=False)
    f32 = roofline.roofline_terms(cfg, shape, 8, 1e9, remat=False,
                                  precision="f32")
    assert f32["t_compute_s"] == 2 * bf16["t_compute_s"]
    assert f32["t_memory_s"] == bf16["t_memory_s"]
    assert bf16["peak_flops"] == cm.H100.flops_bf16
    assert roofline.DEFAULT_HW is cm.HARDWARE["H100"]


def _write(d, name, rec):
    with open(os.path.join(d, name + ".json"), "w") as f:
        json.dump(rec, f)


@pytest.fixture
def record_dir(tmp_path):
    """Tagged and untagged files, two meshes, a failed and a skipped
    point and a record whose mesh names ``_opt``."""
    rng = np.random.default_rng(2)
    d = tmp_path / "dryrun"
    d.mkdir()
    for arch in ("qwen3-0.6b", "granite-20b", "rwkv6-1.6b"):
        for shape in ("train_4k", "decode_32k"):
            _write(d, f"{arch}_{shape}_pod16x16",
                   _record(rng, arch, shape))
            _write(d, f"{arch}_{shape}_pod2x16x16",
                   _record(rng, arch, shape, mesh="pod2x16x16"))
        _write(d, f"{arch}_train_4k_pod16x16_opt",
               _record(rng, arch, "train_4k", tag="opt"))
    _write(d, "qwen3-0.6b_prefill_32k_pod16x16_opt",
           _record(rng, "qwen3-0.6b", "prefill_32k", tag="other"))
    _write(d, "dbrx-132b_train_4k_pod16x16",
           _record(rng, "dbrx-132b", "train_4k", mesh="pod16x16_opt"))
    _write(d, "qwen3-0.6b_long_500k_pod16x16",
           {"arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "pod16x16",
            "status": "skipped", "reason": "sub-quadratic"})
    _write(d, "granite-20b_prefill_32k_pod16x16",
           {"arch": "granite-20b", "shape": "prefill_32k",
            "mesh": "pod16x16", "status": "error", "error": "boom"})
    return str(d)


@pytest.mark.parametrize("mesh,tag", [("pod16x16", ""), ("pod16x16", "opt"),
                                      ("pod2x16x16", ""), ("pod16x16", "x")])
def test_record_selection_matches_jax(record_dir, mesh, tag):
    got = roofline.load_records(record_dir, mesh, tag)
    assert got == jroofline.load_records(record_dir, mesh, tag)
    rows = roofline.table(record_dir, mesh, tag, hw=cm.H100)
    want = jroofline.table(record_dir, mesh, tag, hw=jcm.H100)
    assert [(r["arch"], r["shape"]) for r in rows] == \
        [(r["arch"], r["shape"]) for r in want]
    for a, b in zip(rows, want):
        assert all(_close(a[k], b[k]) for k in ROW_KEYS)
    if rows:
        assert roofline.markdown(rows).count("\n") == len(rows) + 2


def test_roofline_cli(record_dir, capsys):
    roofline.main(["--out", record_dir])      # H100 by default
    out = capsys.readouterr().out
    assert "| qwen3-0.6b | train_4k |" in out and "peak GiB" in out
    with pytest.raises(SystemExit) as e:
        roofline.main(["--out", record_dir, "--mesh", "nowhere"])
    assert e.value.code == 1
    assert "repro_torch.launch.dryrun" in capsys.readouterr().err


def test_from_root_is_the_same_from_another_cwd(tmp_path, monkeypatch):
    here = paths.from_root("results", "dryrun_torch")
    monkeypatch.chdir(tmp_path)
    assert paths.from_root("results", "dryrun_torch") == here
    assert paths.REPO_ROOT == jpaths.REPO_ROOT
    assert paths.results_path("x") == jpaths.results_path("x")
    assert paths.from_root(str(tmp_path)) == str(tmp_path)
    assert os.path.isdir(os.path.join(paths.REPO_ROOT, "src",
                                      "repro_torch"))


def _jax_claims():
    """The calls of ``tests/test_costmodel.py::test_claim_*`` on the JAX
    package's cost model."""
    from repro.configs.base import ShapeConfig
    from repro.configs.llama2 import LLAMA2_7B
    from repro.strategy import Topology, search

    def run(n, batch, seq=4096, **kw):
        return jcm.step_time(LLAMA2_7B, jcm.H100,
                             jcm.Strategy(n, zero_stage=2, **kw), batch, seq)

    def best(hw):
        topo = Topology(hw.name, 256, island=hw.island, hardware=hw.name,
                        hbm=80e9, hw_obj=hw)
        return search(LLAMA2_7B, topo, ShapeConfig("s", 4096, 512, "train"),
                      dp_modes=("fsdp",), zero_stages=(2,),
                      pps=(1, 2, 4, 8, 16), cps=(1,), require_fits=False,
                      require_lowerable=False)[0].report

    r128, r2048 = run(128, 256), run(2048, 4096)
    gains = {tp: run(2048, 4096, tp=tp).wps / r2048.wps - 1 for tp in (2, 4)}
    short, long = run(512, 1024, 2048), run(512, 1024, 8192)
    out = {"weak_scaling_drop": 1 - r2048.tflops_per_device
           / r128.tflops_per_device,
           "power_drop": 1 - r2048.power_per_device / r128.power_per_device,
           "tp_gain_2048": max(gains.values()),
           "tp_gain_2048_tp": max(gains, key=gains.get),
           "best_mfu_h100_256": best(jcm.H100).mfu,
           "best_mfu_a100_256": best(jcm.A100).mfu,
           "exposed_share_short": short.t_comm_exposed / short.t_step,
           "exposed_share_long": long.t_comm_exposed / long.t_step,
           "mfu_short": short.mfu, "mfu_long": long.mfu}
    for n in (8, 128, 1024, 2048):
        out[f"exposed_s_{n}"] = run(n, 2 * n).t_comm_exposed
    return out


def test_report_claims_equal_jax_cost_model():
    got, want = report.paper_claims(), _jax_claims()
    assert set(got) == set(want)
    for k in want:
        assert _close(got[k], want[k]), (k, got[k], want[k])


def test_report_builds_and_refuses_zero_records(record_dir, tmp_path,
                                                monkeypatch, capsys):
    root = tmp_path / "root"
    (root / "results").mkdir(parents=True)
    os.rename(record_dir, root / "results" / "dryrun_torch")
    rng = np.random.default_rng(3)
    _write(root / "results" / "dryrun_torch",
           "qwen3-0.6b_train_4k_pod16x16_fsdp_pp2_mb4_1f1b",
           _record(rng, "qwen3-0.6b", "train_4k",
                   mesh="pod16x16_fsdp_pp2_mb4_1f1b",
                   strategy="fsdp_pp2_mb4_1f1b",
                   pipeline={"sched": "1f1b", "virtual_stages": 1,
                             "overlap": False, "bubble_predicted": 0.2,
                             "bubble_measured": 0.25}))
    monkeypatch.setattr(paths, "REPO_ROOT", str(root))
    monkeypatch.setattr(report, "paper_claims", lambda: dict.fromkeys(
        _CLAIM_KEYS, 0.5))
    report.main()
    out = capsys.readouterr().out
    for section in ("§Paper-claims", "§Dry-run", "§Roofline",
                    "§Benchmarks", "§Schedule-frontier", "§Telemetry"):
        assert section in out
    assert "TPU" not in out.split("## §Paper-claims")[0]
    assert "| qwen3-0.6b | train_4k | fsdp_pp2_mb4_1f1b | 1f1b |" in out
    assert "skipped: sub-quadratic" in out and "**ERROR** boom" in out
    assert "| qwen3-0.6b | decode_32k |" in out.split("§Roofline")[1]
    assert "results/benchmarks_torch" in out

    for p in (root / "results" / "dryrun_torch").iterdir():
        rec = json.loads(p.read_text())
        rec["status"] = "error"
        rec.setdefault("error", "x")
        p.write_text(json.dumps(rec))
    with pytest.raises(SystemExit) as e:
        report.main()
    assert e.value.code == 1
    assert "repro_torch.launch.dryrun" in capsys.readouterr().err


_CLAIM_KEYS = ("weak_scaling_drop", "power_drop", "tp_gain_2048",
               "tp_gain_2048_tp", "best_mfu_h100_256", "best_mfu_a100_256",
               "exposed_share_short", "exposed_share_long", "mfu_short",
               "mfu_long", "exposed_s_8", "exposed_s_128", "exposed_s_1024",
               "exposed_s_2048")
