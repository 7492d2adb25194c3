#!/usr/bin/env python3
"""Cell T5 (qwen3-0.6b, ``launch.train --strategy auto``: ``fsdp_bf16`` on
one H100) on this tree and on another checkout, in turns.

    python3 t5_flash_profile.py --parent DIR [--steps 8] [--out FILE]

Runs ``python -m repro_torch.launch.train --strategy auto --steps N
--log_every 1 --profile D --metrics_jsonl F`` from the other checkout, this
tree, this tree and the other checkout, one process each, and reads from
each run: the p50 of its ``train/step`` spans (the JSONL, nearest rank,
the first step dropped as warm-up), and from its ``--profile`` line the
device busy share and ms per step of the profiled steps, with the device
ms per step of the kernels whose name holds ``flash`` (the flash forward,
dq and dk/dv), read from the profile's op table (``ops.txt``, sorted by
device time).  Each run's files go to ``chiprun_out/t5_flash_profile``.
Prints the card's name and power limit first and one JSON line per run.
Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def p50(values):
    s = sorted(values)
    return s[(len(s) + 1) // 2 - 1]


UNITS = {"us": 1e-3, "ms": 1.0, "s": 1e3}


def device_ms_by_name(ops_txt: Path, match: str):
    """{name: self device ms} of the rows holding ``match`` in the first
    table of a ``key_averages().table`` dump: its dashed rule gives the
    columns' spans, its header the column whose title starts ``Self CUDA``
    or ``Self Device`` (by torch version)."""
    lines = ops_txt.read_text().splitlines()
    rule = next(i for i, line in enumerate(lines)
                if line.startswith("---"))
    spans = [m.span() for m in re.finditer(r"-+", lines[rule])]
    header = [lines[rule + 1][a:b].strip() for a, b in spans]
    col = next(i for i, h in enumerate(header)
               if h in ("Self CUDA", "Self Device"))
    out = {}
    for line in lines[rule + 3:]:
        if line.startswith("---"):
            break
        name = line[slice(*spans[0])].strip()
        if match in name:
            val = re.fullmatch(r"([\d.]+)(us|ms|s)",
                               line[slice(*spans[col])].strip())
            out[name] = (out.get(name, 0.0)
                         + float(val.group(1)) * UNITS[val.group(2)])
    return out


def run(tree: Path, tag: str, steps: int, out_dir: Path):
    prof, jsonl = out_dir / f"{tag}_profile", out_dir / f"{tag}.jsonl"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--strategy",
           "auto", "--steps", str(steps), "--log_every", "1", "--profile",
           str(prof), "--metrics_jsonl", str(jsonl)]
    env = {**os.environ, "PYTHONPATH": str(tree / "src")}
    res = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                         text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"{tag}: train CLI exit {res.returncode}:\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    rep = next(json.loads(line)["profile"] for line in res.stdout.splitlines()
               if line.startswith('{"profile"'))
    steps_s = [e["dur"] for e in map(json.loads, jsonl.read_text()
                                     .splitlines())
               if e.get("kind") == "span" and e.get("name") == "train/step"]
    flash = {k: ms / rep["steps"] for k, ms in
             device_ms_by_name(prof / "ops.txt", "flash").items()}
    return dict(
        run=tag, step_p50_ms=p50(steps_s[1:]) * 1e3,
        steps_timed=len(steps_s) - 1,
        profiled_wall_ms_per_step=rep["wall_ms_per_step"],
        device_ms_per_step=rep["device_ms_per_step"],
        device_busy_share=rep["device_busy_share"],
        flash_device_ms_per_step=sum(flash.values()),
        flash_kernels=flash, peak_mem_gib=rep["peak_mem_gib"],
        strategy=rep["strategy"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("t5_flash_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    out_dir = ROOT / "chiprun_out" / "t5_flash_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for i, side in enumerate(("other", "this", "this", "other")):
        tree = args.parent.resolve() if side == "other" else ROOT
        rows.append(run(tree, f"{i}_{side}", args.steps, out_dir))
        print(json.dumps(rows[-1]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, runs=rows),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
