#!/usr/bin/env python3
"""Tile sizes of the bf16 flash-attention kernels, timed on one GPU.

    python3 flash_bf16_tiles.py [--out results.json]

Builds one variant of ``src/repro_torch/kernels/csrc/flash_attention_bf16.cu``
per tuple of ``VARIANTS`` (the ``kFwd*``, ``kDq*`` and ``kDkv*`` constants
rewritten: warps per CTA, rows per streamed tile, ring stages), all at once,
into ``build/kernels/tiles``; then, at ``SHAPES`` (the T5 training shape
first), holds every variant's forward, dq and dk/dv against the plain
versions (o within ``chip_smoke.TOL``, lse within 1e-5, gradients within
``chip_smoke.GRAD_REL_TOL``) and times each (L2 flushed before every
launch, ``chip_smoke.time_ms``), the source's own constants as variant 0.
Then times ways of writing the backward's delta = rowsum(do * o) in plain
PyTorch (``DELTA_FORMS``) at the first shape, each against
``attention_delta``'s value.  Prints the card's name and power limit first
and one JSON line per variant and shape.  Needs CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

NAME = "flash_attention_bf16"
# (warps, tile rows, stages) of the forward, dq and dk/dv; None keeps the
# source's own; dk/dv needs 2 x tile rows <= 32 x warps
VARIANTS = [
    (None, None, None),
    ((4, 64, 3), (4, 64, 3), (4, 64, 3)),
    ((4, 128, 2), (4, 32, 2), (4, 32, 2)),
    ((8, 64, 2), (8, 64, 2), (8, 64, 2)),
    ((8, 64, 3), (8, 32, 2), (8, 32, 2)),
    ((8, 128, 2), (4, 32, 3), (4, 32, 3)),
    ((4, 32, 2), (2, 64, 2), (2, 32, 2)),
]
# B, S, H, Kv, D, window: T5's attention, then D 80 and D 64
SHAPES = [(8, 512, 16, 8, 128, 0), (8, 512, 32, 8, 80, 0),
          (8, 512, 24, 24, 64, 0)]
CONST = {"fwd": "kFwd", "dq": "kDq", "dkv": "kDkv"}
# delta (B, H, S) f32 from o and do (B, S, H, D)
DELTA_FORMS = {
    "attention_delta": fa.attention_delta,
    "one_widened": lambda o, do: (do.float() * o).sum(-1).transpose(
        1, 2).contiguous(),
    "vecdot": lambda o, do: torch.linalg.vecdot(
        do.float(), o.float()).transpose(1, 2).contiguous(),
    "bmm": lambda o, do: torch.bmm(
        do.reshape(-1, 1, do.shape[-1]).float(),
        o.reshape(-1, o.shape[-1], 1).float()).reshape(
        do.shape[:-1]).transpose(1, 2).contiguous(),
}


def variant_source(src, tiles):
    for kern, t in zip(CONST, tiles):
        if t is None:
            continue
        p = CONST[kern]
        line = (f"constexpr int {p}Warps = {t[0]}, {p}Tile = {t[1]}, "
                f"{p}Stages = {t[2]};")
        src, n = re.subn(rf"constexpr int {p}Warps = \d+, {p}Tile = \d+, "
                         rf"{p}Stages = \d+;", line, src)
        assert n == 1, kern
    return src


def source_tiles(src):
    return tuple(tuple(int(x) for x in re.search(
        rf"constexpr int {p}Warps = (\d+), {p}Tile = (\d+), "
        rf"{p}Stages = (\d+);", src).groups()) for p in CONST.values())


def build_variants():
    out = build.BUILD_DIR / "tiles"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / f"{NAME}.cu").read_text()
    procs = []
    for i, tiles in enumerate(VARIANTS):
        cu = out / f"v{i}.cu"
        cu.write_text(variant_source(src, tiles))
        so = out / f"lib_v{i}.so"
        procs.append((i, so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for i, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"[tiles] variant {i} failed to build:\n{log}")
            continue
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        regs = re.findall(r"Used (\d+) registers", log)
        tiles = source_tiles(variant_source(src, VARIANTS[i]))
        print(f"[tiles] variant {i} {tiles}"
              f": registers {regs}, spill stores {spills}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in fa._BF16_SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, f"{NAME}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs[i] = lib
    return src, libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bf16_tiles: no CUDA device is available",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    src, libs = build_variants()
    dev = torch.device("cuda")
    dtype = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    build.load(NAME, fa._BF16_SIGNATURES)
    mine = build._LOADED[NAME]
    rows = []
    with torch.no_grad():
        for B, S, H, Kv, D, window in SHAPES:
            q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device=dev)
                           .to(dtype) for h in (H, Kv, Kv, H))
            o0, lse0 = fa.forward_plain(q, k, v, True, window)
            delta = fa.attention_delta(o0, do)
            args_b = (q, k, v, do, lse0, delta, True, window)
            dq0, (dk0, dv0) = fa.dq_plain(*args_b), fa.dkv_plain(*args_b)
            for i, lib in libs.items():
                build._LOADED[NAME] = lib
                try:
                    o, lse = fa.forward_cuda(q, k, v, True, window)
                    dq, (dk, dv) = fa.dq_cuda(*args_b), fa.dkv_cuda(*args_b)
                    torch.cuda.synchronize()
                    rels = {"dq": cs.rel_err(dq, dq0),
                            "dk": cs.rel_err(dk, dk0),
                            "dv": cs.rel_err(dv, dv0)}
                    e_o, o_ok = cs.max_err(o, o0, dtype)
                    e_lse = (lse - lse0).abs().max().item()
                    row = dict(
                        variant=i, tiles=source_tiles(
                            variant_source(src, VARIANTS[i])),
                        shape=f"B{B} S{S} H{H} Kv{Kv} D{D} window{window}",
                        o_err=e_o, lse_err=e_lse, grad_rel=rels,
                        ok=bool(o_ok and e_lse <= 1e-5 and max(
                            rels.values()) <= cs.GRAD_REL_TOL[dtype]),
                        fwd_ms=cs.time_ms(lambda: fa.forward_cuda(
                            q, k, v, True, window), flush, 20),
                        dq_ms=cs.time_ms(lambda: fa.dq_cuda(*args_b),
                                         flush, 20),
                        dkv_ms=cs.time_ms(lambda: fa.dkv_cuda(*args_b),
                                          flush, 20))
                finally:
                    build._LOADED[NAME] = mine
                rows.append(row)
                print(f"[tiles] {json.dumps(row)}")
        B, S, H, Kv, D, _ = SHAPES[0]
        for dt in (torch.bfloat16, torch.float32):
            o, do = (torch.randn(B, S, H, D, generator=gen, device=dev)
                     .to(dt) for _ in range(2))
            want = fa.attention_delta(o, do)
            for name, form in DELTA_FORMS.items():
                got = form(o, do)
                row = dict(delta=name, dtype=str(dt), shape=f"B{B} S{S} H{H}"
                           f" D{D}", max_abs_diff=(got - want).abs().max()
                           .item(), ms=cs.time_ms(lambda: form(o, do),
                                                  flush, 20))
                rows.append(row)
                print(f"[tiles] {json.dumps(row)}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, rows=rows),
                                             indent=1))
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
