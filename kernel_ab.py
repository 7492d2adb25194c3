#!/usr/bin/env python3
"""A/B of the port's flash-attention forward and WKV-6 kernels on one GPU:
this tree's CUDA sources against those of another checkout (the parent
commit, say, unpacked with ``git archive``).

    python3 kernel_ab.py --parent DIR [--out results.json]

Builds ``flash_attention.cu`` and ``wkv6.cu`` from ``DIR/src/repro_torch/
kernels/csrc`` with the same ``nvcc`` flags as this tree's (into
``DIR/build/kernels``), then, on ``chip_smoke.py``'s cases:

- holds each side's flash forward (o, lse) against ``forward_plain``;
- holds this tree's WKV-6 outputs (y and the final state) against the
  other side's with ``torch.equal``, and both against ``wkv6_plain``;
- times both sides at the training shapes (f32 and bf16; L2 flushed
  before every launch) in the order other, this, this, other, and prints
  the medians of each side's two readings.

Needs CUDA; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import wkv6 as wkv  # noqa: E402

MODULES = {"flash_attention": fa, "wkv6": wkv}


def build_other(root: Path):
    """The other checkout's two sources, built with this tree's flags ->
    {name: loaded library}."""
    out = root / "build" / "kernels"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in MODULES:
        so = out / f"lib{name}.so"
        src = root / "src/repro_torch/kernels/csrc" / f"{name}.cu"
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        print(f"[build other] {name}.cu:\n{log.rstrip()}")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the other {name}.cu")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in MODULES[name]._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs[name] = lib
    return libs


@contextlib.contextmanager
def using(name, lib):
    """Within the block the module's wrapper launches ``lib``'s kernel."""
    build.load(name, MODULES[name]._SIGNATURES)
    mine = build._LOADED[name]
    build._LOADED[name] = lib
    try:
        yield
    finally:
        build._LOADED[name] = mine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(build.build_all(list(MODULES), verbose=True))
    other = build_other(args.parent)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    res = {"card": card, "flash": [], "wkv6": []}

    def ab(name, fn):
        """(other ms, this ms): medians of the readings taken in the order
        other, this, this, other."""
        t = []
        for side in ("other", "this", "this", "other"):
            ctx = (using(name, other[name]) if side == "other"
                   else contextlib.nullcontext())
            with ctx:
                t.append(cs.time_ms(fn, flush, 20))
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t

    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[-1]
            for ci, (B, S, H, Kv, D, window) in enumerate(cs.FLASH_CASES):
                q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev
                                       ).to(dtype) for h in (H, Kv, Kv))
                o0, lse0 = fa.forward_plain(q, k, v, True, window)
                row = dict(dtype=dt, shape=f"B{B} S{S} H{H} Kv{Kv} D{D} "
                                           f"window{window}")
                for side in ("this", "other"):
                    ctx = (using("flash_attention", other["flash_attention"])
                           if side == "other" else contextlib.nullcontext())
                    with ctx:
                        o, lse = fa.forward_cuda(q, k, v, True, window)
                        o2, lse2 = fa.forward_cuda(q, k, v, True, window)
                    torch.cuda.synchronize()
                    row[f"{side}_o_rel_err"] = cs.rel_err(o, o0)
                    row[f"{side}_o_err_max_abs"] = cs.max_err(o, o0, dtype)[0]
                    row[f"{side}_o_within_tol"] = cs.max_err(o, o0, dtype)[1]
                    row[f"{side}_lse_err"] = (lse - lse0).abs().max().item()
                    row[f"{side}_repeat_equal"] = bool(
                        torch.equal(o, o2) and torch.equal(lse, lse2))
                if ci == 0:
                    row["other_ms"], row["this_ms"], row["readings_ms"] = ab(
                        "flash_attention",
                        lambda: fa.forward_cuda(q, k, v, True, window))
                res["flash"].append(row)
                print(f"[flash fwd] {json.dumps(row)}")
            for ci, (B, T, H, chunk) in enumerate(cs.WKV_CASES):
                N = 64
                r, k, v = ((0.5 * torch.randn(B, T, H, N, generator=gen,
                                              device=dev)).to(dtype)
                           for _ in range(3))
                w = torch.exp(-torch.exp(0.5 * torch.randn(
                    B, T, H, N, generator=gen, device=dev) - 2.5))
                u = 0.3 * torch.randn(H, N, generator=gen, device=dev)
                y, st = wkv.wkv6_cuda(r, k, v, w, u, chunk)
                with using("wkv6", other["wkv6"]):
                    y1, st1 = wkv.wkv6_cuda(r, k, v, w, u, chunk)
                y0, st0 = wkv.wkv6_plain(r, k, v, w, u, None, chunk)
                torch.cuda.synchronize()
                row = dict(dtype=dt, shape=f"B{B} T{T} H{H} N{N} "
                                           f"chunk{chunk}",
                           y_equal=bool(torch.equal(y, y1)),
                           state_equal=bool(torch.equal(st, st1)),
                           y_max_abs_diff=(y.float() - y1.float()).abs()
                           .max().item(),
                           state_max_abs_diff=(st - st1).abs().max().item(),
                           this_y_rel_err=cs.rel_err(y, y0),
                           this_state_rel_err=cs.rel_err(st, st0))
                if ci == 0:
                    row["other_ms"], row["this_ms"], row["readings_ms"] = ab(
                        "wkv6", lambda: wkv.wkv6_cuda(r, k, v, w, u, chunk))
                res["wkv6"].append(row)
                print(f"[wkv6] {json.dumps(row)}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    ok = all(r["this_o_within_tol"] and r["this_lse_err"] <= 1e-5
             and r["this_repeat_equal"] for r in res["flash"])
    same = all(r["y_equal"] and r["state_equal"] for r in res["wkv6"])
    print(f"[ab] flash forward within tolerance and repeatable: {ok}; "
          f"wkv6 bits equal to the other side's: {same}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
