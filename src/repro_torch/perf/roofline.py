"""Three-term roofline analysis per (architecture x input shape x mesh) —
the port of the JAX package's ``perf/roofline.py``.

Reads the port's dry-run records (``results/dryrun_torch/*.json``,
written by ``python -m repro_torch.launch.dryrun``) and derives:

  compute term    = FLOPs / (chips * hw.flops_bf16)     [analytic, perf/flops]
  memory term     = HBM bytes / hw.hbm_bw               [analytic, perf/bytes]
  collective term = collective bytes / (chips * hw.intra_bw / hw.rings)
                    [the dispatch census of the traced step, perf/comms]

and reports, per pair: the three terms in seconds, the dominant bottleneck,
MODEL_FLOPS = 6·N_active·D (2·N_active per token at inference), the
MODEL/COMPILED flop ratio (remat / routing / attention overhead), and the
one-line lever that would move the dominant term.

The peaks come from a ``costmodel.Hardware`` profile — the ``H100`` one
by default, the port's card (the JAX package defaults to ``TPUv5e``) —
so the roofline cannot drift from the model the planner prices with.
:func:`roofline_terms` is the arithmetic on its own, for a step that is
no dry-run record (a measured step at its own shape); :func:`roofline_row`
prices a record with it.

Remat: the port's dry run traces a train shape with remat, as the JAX
one lowers it, and writes the runtime's ``"remat"`` into its record (a
measured step, run as the train CLIs run it, without); a record without
the key takes the JAX package's rule (remat on train shapes), for its
FLOP fallback and its bytes alike.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import costmodel as cm
from repro_torch.perf import bytes as bytes_lib
from repro_torch.perf import flops as flops_lib
from repro_torch.perf.memory import CATEGORIES
from repro_torch.perf.paths import from_root

DEFAULT_HW = cm.HARDWARE["H100"]
DRYRUN_OUT = "results/dryrun_torch"


def _peaks(hw: Optional[cm.Hardware]):
    """(flops/s, HBM B/s, per-link B/s) for one chip of ``hw``."""
    hw = hw or DEFAULT_HW
    return hw.flops_bf16, hw.hbm_bw, hw.intra_bw / hw.rings


LEVERS = {
    "compute": "raise achieved matmul efficiency (Pallas flash/WKV kernels, "
               "larger per-chip tiles) or cut remat recompute",
    "memory": "cut HBM traffic: fuse elementwise chains, keep weights "
              "resident across microbatches, shrink optimizer/cache dtypes",
    "collective": "shrink the FSDP group (model parallelism, per the paper) "
                  "or overlap: the term is ICI-bound, not compute-bound",
}


def load_records(out_dir: str = DRYRUN_OUT, mesh: str = "pod16x16",
                 tag: str = "") -> List[Dict]:
    """The records ``<arch>_<shape>_<mesh>[_<tag>].json`` under
    ``out_dir`` (relative paths anchor at the repo root, not the cwd:
    running from elsewhere must not silently find zero records)."""
    recs = []
    suffix = f"_{mesh}" + (f"_{tag}" if tag else "") + ".json"
    for path in sorted(glob.glob(os.path.join(from_root(out_dir),
                                              "*" + suffix))):
        with open(path) as f:
            rec = json.load(f)
        if tag and rec.get("tag", tag) != tag:
            continue
        recs.append(rec)
    # drop tagged files when untagged requested
    if not tag:
        recs = [r for r in recs if "_opt" not in json.dumps(r.get("mesh", ""))]
    return recs


def roofline_terms(cfg: ModelConfig, shape: ShapeConfig, n_devices: int,
                   collective_bytes: float, flops: Optional[float] = None,
                   remat: Optional[bool] = None,
                   hw: Optional[cm.Hardware] = None,
                   precision: str = "bf16") -> Dict:
    """The three terms of one step of ``cfg`` at ``shape`` on ``n_devices``
    chips of ``hw`` -> {'t_compute_s', 't_memory_s', 't_collective_s',
    'dominant', 'compiled_flops', 'hbm_bytes_per_device',
    'roofline_step_s', 'peak_flops'}.  ``flops`` (the step's compiled
    FLOPs) defaults to ``perf.flops.compiled_flops``; ``remat`` None is
    the JAX package's rule (remat on train shapes); ``precision`` scales
    the bf16 peak by the cost model's ``flops_scale`` (f32: half)."""
    if remat is None:
        remat = shape.mode == "train"
    peak_flops, hbm_bw, link_bw = _peaks(hw)
    peak_flops *= cm.PRECISIONS[precision].flops_scale
    flops = flops or flops_lib.compiled_flops(cfg, shape, remat=remat)
    hbm = bytes_lib.hbm_bytes_per_device(cfg, shape, n_devices, remat=remat)
    terms = {"compute": flops / (n_devices * peak_flops),
             "memory": hbm / hbm_bw,
             "collective": collective_bytes / (n_devices * link_bw)}
    dominant = max(terms, key=terms.get)
    return {"t_compute_s": terms["compute"], "t_memory_s": terms["memory"],
            "t_collective_s": terms["collective"], "dominant": dominant,
            "compiled_flops": flops, "hbm_bytes_per_device": hbm,
            "roofline_step_s": terms[dominant], "peak_flops": peak_flops}


def roofline_row(rec: Dict,
                 hw: Optional[cm.Hardware] = None) -> Optional[Dict]:
    """One ok dry-run record -> its roofline row (None otherwise): the JAX
    package's keys, but for the memory columns: JAX reads XLA's
    ``temp``/``argument`` bytes, the port's record has the traced peak
    per device and its categories (``perf.memory.breakdown``), reported
    as ``peak_gib`` and ``<category>_gib``."""
    if rec.get("status") != "ok":
        return None
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    chips = rec["n_devices"]
    peak_flops = _peaks(hw)[0]
    t = roofline_terms(cfg, shape, chips, rec.get("collective_bytes_total", 0),
                       flops=rec.get("flops_compiled_analytic"),
                       remat=rec.get("remat", shape.mode == "train"), hw=hw)
    model_fl = rec.get("flops_model_6nd") or flops_lib.model_flops(cfg, shape)
    flops, bound = t["compiled_flops"], t["roofline_step_s"]
    mem = rec["memory"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "plan": rec.get("plan", {}).get("attn", "?"),
        "t_compute_s": t["t_compute_s"], "t_memory_s": t["t_memory_s"],
        "t_collective_s": t["t_collective_s"], "dominant": t["dominant"],
        "model_flops": model_fl, "compiled_flops": flops,
        "useful_ratio": model_fl / flops if flops else 0.0,
        "roofline_step_s": bound,
        "roofline_mfu": model_fl / bound / (chips * peak_flops) if bound else 0,
        "hardware": (hw or DEFAULT_HW).name,
        "peak_gib": mem["peak_bytes_per_device"] / 2**30,
        **{f"{c}_gib": mem.get(f"{c}_bytes", 0) / 2**30 for c in CATEGORIES},
        "lever": LEVERS[t["dominant"]],
    }


def table(out_dir: str = DRYRUN_OUT, mesh: str = "pod16x16",
          tag: str = "", hw: Optional[cm.Hardware] = None) -> List[Dict]:
    rows = []
    for rec in load_records(out_dir, mesh, tag):
        row = roofline_row(rec, hw=hw)
        if row:
            rows.append(row)
    return rows


def markdown(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | plan | compute s | memory s | collective s | "
           "dominant | 6ND/compiled | roofline MFU | peak GiB |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['plan']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_mfu']:.2f} "
            f"| {r['peak_gib']:.1f} |\n")
    return "".join(out)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DRYRUN_OUT)
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--tag", default="")
    ap.add_argument("--hardware", default=DEFAULT_HW.name,
                    choices=sorted(cm.HARDWARE))
    args = ap.parse_args(argv)
    rows = table(args.out, args.mesh, args.tag,
                 hw=cm.HARDWARE[args.hardware])
    if not rows:
        import sys
        print(f"ERROR: no ok dryrun records under {from_root(args.out)} "
              f"for mesh {args.mesh!r}"
              + (f" tag {args.tag!r}" if args.tag else "")
              + " — run `python -m repro_torch.launch.dryrun` first",
              file=sys.stderr)
        raise SystemExit(1)
    print(markdown(rows))
    for r in rows:
        if r["dominant"] != "compute":
            print(f"  -> {r['arch']}/{r['shape']}: {r['dominant']}-bound; "
                  f"{r['lever']}")


if __name__ == "__main__":
    main()
