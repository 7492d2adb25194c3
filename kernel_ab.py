#!/usr/bin/env python3
"""A/B of the port's redesigned kernels on one GPU: this tree's CUDA
sources against those of another checkout (the parent commit, say,
unpacked with ``git archive``).

    python3 kernel_ab.py --parent DIR [--out results.json]

Builds ``flash_attention.cu``, ``wkv6.cu``, ``rmsnorm.cu`` and
``flash_decode.cu`` from ``DIR/src/repro_torch/kernels/csrc`` with the
same ``nvcc`` flags as this tree's (into ``DIR/build/kernels``), then, on
``chip_smoke.py``'s cases:

- holds each side's flash forward (o, lse) against ``forward_plain``,
  and this tree's flash forward, dq and dk/dv to the other side's bits
  (``torch.equal``: self-attention is q0 = 0 with as many rows as keys,
  whatever either side's entry points take; a side whose entry points
  predate the query offset runs through :class:`_NoOffset`);
- holds this tree's WKV-6 outputs (y and the final state) against the
  other side's with ``torch.equal``, and both against ``wkv6_plain``;
- holds each side's RMSNorm forward (y, rstd) against ``rmsnorm_plain`` at
  ``RMS_FWD_CASES``, and its backward (dx, dscale) against
  ``rmsnorm_bwd_plain`` at ``RMS_BWD_CASES`` (each timed), and reads
  each side's launches' device times (torch.profiler);
- holds each side's flash-decode output against ``combine_plain(
  split_plain(...))`` at ``DECODE_CASES`` (the serving shape and B 8 at
  ctx 4096).  A side whose library has the split and combine kernels of
  the two-launch design (before the merge moved into a cluster) runs them
  back to back as one call;
- requires a second launch of this tree's kernels to give the same bits;
- times both sides at the main paths' shapes (f32 and bf16; L2 flushed
  before every launch, as ``chip_smoke.time_ms`` does) in the order
  other, this, this, other, and prints the medians of each side's two
  readings, beside the timing's own floor (a one-element fill).

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
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import wkv6 as wkv  # noqa: E402

MODULES = {"flash_attention": fa, "wkv6": wkv, "rmsnorm": rms,
           "flash_decode": fd}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the two-launch flash-decode's entry points: the split kernel writes each
# split's f32 partial (acc, m, l), the combine kernel merges them
TWO_LAUNCH_DECODE = {
    **{f"flash_decode_split_{t}": [_P] * 8 + [_I] * 9 + [_F, _P]
       for t in ("f32", "bf16")},
    **{f"flash_decode_combine_{t}": [_P] * 4 + [_I] * 4 + [_P]
       for t in ("f32", "bf16")}}
# (n, d) of the RMSNorm forward's A/B: decode rows, a prefill chunk's,
# the training rows; then wider rows (a team of 2 and 4 warps a row)
RMS_FWD_CASES = [(8, 1024), (256, 1024), (4096, 1024), (4096, 2048),
                 (4096, 4096)]


# the flash entry points before the query offset: (B, S, H, Kv, D, causal,
# window), S both the query rows and the keys
NO_OFFSET = {
    **{f"flash_attn_fwd_{s}": [_P] * 5 + [_I] * 7 + [_F, _P]
       for s in ("f32", "bf16")},
    **{f"flash_attn_dq_{s}": [_P] * 7 + [_I] * 7 + [_F, _P]
       for s in ("f32", "bf16")},
    **{f"flash_attn_dkv_{s}": [_P] * 8 + [_I] * 7 + [_F, _P]
       for s in ("f32", "bf16")}}


class _NoOffset:
    """A flash library whose entry points predate the query offset, called
    with this tree's arguments: (B, Sq, Sk, H, Kv, D, q0, causal, window)
    pass as (B, S, H, Kv, D, causal, window), which only self-attention
    (q0 0, Sq == Sk) can."""

    def __init__(self, lib):
        self.lib = lib
        self.flash_attention_error_string = lib.flash_attention_error_string
        for name, argtypes in NO_OFFSET.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            setattr(self, name, self._call(fn, len(argtypes) - 9))

    @staticmethod
    def _call(fn, n_ptr):
        def call(*a):
            B, Sq, Sk, H, Kv, D, q0, causal, window = a[n_ptr:n_ptr + 9]
            if q0 or Sq != Sk:
                raise ValueError("the other side's flash kernels predate "
                                 "the query offset")
            return fn(*a[:n_ptr], B, Sq, H, Kv, D, causal, window,
                      *a[n_ptr + 9:])
        return call


def build_other(root: Path):
    """The other checkout's sources, built with this tree's flags ->
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
        for fn, argtypes in {**MODULES[name]._SIGNATURES,
                             **TWO_LAUNCH_DECODE}.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        if name == "flash_attention" and "int q0" not in src.read_text():
            lib = _NoOffset(lib)
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
    res = {"card": card, "flash": [], "wkv6": [], "rmsnorm": [],
           "rmsnorm_bwd": [], "flash_decode": []}
    # what the timing itself costs: a one-element fill, timed the same way
    tiny = torch.empty(1, device=dev)
    res["event_floor_ms"] = cs.time_ms(lambda: tiny.zero_(), flush)
    print(f"[ab] event floor (a one-element fill) "
          f"{res['event_floor_ms']:.4f} ms")

    def ab(name, fn, other_fn=None):
        """(other ms, this ms): means of the readings taken in the order
        other, this, this, other.  The other side runs ``other_fn`` if
        given, else ``fn`` on the other library."""
        t = []
        for side in ("other", "this", "this", "other"):
            if side == "other" and other_fn is not None:
                t.append(cs.time_ms(other_fn, flush, 20))
                continue
            ctx = (using(name, other[name]) if side == "other"
                   else contextlib.nullcontext())
            with ctx:
                t.append(cs.time_ms(fn, flush, 20))
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t

    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[-1]
            # the head-dim-128 cases: a parent before the head-dim-80
            # instantiation has no kernel for the others
            cases = [c[:6] for c in cs.FLASH_CASES if c[4] == 128]
            for ci, (B, S, H, Kv, D, window) in enumerate(cases):
                q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev
                                       ).to(dtype) for h in (H, Kv, Kv))
                o0, lse0 = fa.forward_plain(q, k, v, True, window)
                row = dict(dtype=dt, shape=f"B{B} S{S} H{H} Kv{Kv} D{D} "
                                           f"window{window}")
                for side in ("this", "other"):
                    def ctx():
                        return (using("flash_attention",
                                      other["flash_attention"])
                                if side == "other"
                                else contextlib.nullcontext())
                    with ctx():
                        o, lse = fa.forward_cuda(q, k, v, True, window)
                        o2, lse2 = fa.forward_cuda(q, k, v, True, window)
                    torch.cuda.synchronize()
                    row[f"{side}_o_rel_err"] = cs.rel_err(o, o0)
                    row[f"{side}_o_err_max_abs"] = cs.max_err(o, o0, dtype)[0]
                    row[f"{side}_o_within_tol"] = cs.max_err(o, o0, dtype)[1]
                    row[f"{side}_lse_err"] = (lse - lse0).abs().max().item()
                    row[f"{side}_repeat_equal"] = bool(
                        torch.equal(o, o2) and torch.equal(lse, lse2))
                    do = torch.randn(q.shape, generator=torch.Generator(
                        device=dev).manual_seed(ci), device=dev).to(dtype)
                    bwd = (q, k, v, do, lse0, fa.attention_delta(o0, do),
                           True, window)
                    with ctx():
                        outs = (o, lse, fa.dq_cuda(*bwd),
                                *fa.dkv_cuda(*bwd))
                    torch.cuda.synchronize()
                    if side == "this":
                        mine = outs
                    else:
                        row["bits_equal_other"] = [
                            bool(torch.equal(a, b))
                            for a, b in zip(mine, outs)]
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
        for dtype in (torch.float32, torch.bfloat16):
            res["rmsnorm"] += rmsnorm_fwd_ab(dev, dtype, gen, flush, ab,
                                             other)
            res["rmsnorm_bwd"] += rmsnorm_bwd_ab(dev, dtype, gen, flush, ab,
                                                 other)
            res["flash_decode"] += flash_decode_ab(dev, dtype, gen, flush,
                                                   ab, other)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    ok = all(r["this_o_within_tol"] and r["this_lse_err"] <= 1e-5
             and r["this_repeat_equal"] for r in res["flash"])
    same = all(r["y_equal"] and r["state_equal"] for r in res["wkv6"])
    flash_same = all(all(r["bits_equal_other"]) for r in res["flash"])
    ok_new = all(r["this_ok"] and r["other_ok"] and r["this_repeat_equal"]
                 for r in res["rmsnorm"] + res["rmsnorm_bwd"]
                 + res["flash_decode"])
    print(f"[ab] flash forward within tolerance and repeatable: {ok}; "
          f"flash o, lse, dq, dk, dv bits equal to the other side's: "
          f"{flash_same}; "
          f"wkv6 bits equal to the other side's: {same}; RMSNorm forward "
          f"and backward and flash-decode within tolerance on both sides "
          f"and repeatable here: {ok_new}")
    return 0 if ok and ok_new else 1


def rmsnorm_bwd_ab(dev, dtype, gen, flush, ab, other):
    rows = []
    # every case is timed; the per-launch device split only where
    # chip_smoke.py times the case
    for (n, d), timed in cs.RMS_BWD_CASES:
        x, gy = (torch.randn(n, d, generator=gen, device=dev).to(dtype)
                 for _ in range(2))
        s = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
        _, rstd = rms.rmsnorm_plain(x, s, 1e-6)
        args = (x, s, rstd, gy)
        dx0, ds0 = rms.rmsnorm_bwd_plain(*args)
        row = dict(dtype=str(dtype).split(".")[-1], shape=f"({n},{d})")
        for side in ("this", "other"):
            with (using("rmsnorm", other["rmsnorm"]) if side == "other"
                  else contextlib.nullcontext()):
                dx, ds = rms.rmsnorm_bwd_cuda(*args)
                dx2, ds2 = rms.rmsnorm_bwd_cuda(*args)
                if timed:
                    row[f"{side}_launch_split_ms"] = cs.kernel_split_ms(
                        lambda: rms.rmsnorm_bwd_cuda(*args), flush,
                        "rmsnorm")
            torch.cuda.synchronize()
            err, within = cs.max_err(dx, dx0, dtype)
            ds_rel = cs.rel_err(ds, ds0)
            row.update({f"{side}_dx_err": err, f"{side}_dscale_rel": ds_rel,
                        f"{side}_ok": within and ds_rel <= 1e-4,
                        f"{side}_repeat_equal": bool(
                            torch.equal(dx, dx2) and torch.equal(ds, ds2))})
        row["other_ms"], row["this_ms"], row["readings_ms"] = ab(
            "rmsnorm", lambda: rms.rmsnorm_bwd_cuda(*args))
        rows.append(row)
        print(f"[rmsnorm_bwd] {json.dumps(row)}")
    return rows


def rmsnorm_fwd_ab(dev, dtype, gen, flush, ab, other):
    rows = []
    for n, d in RMS_FWD_CASES:
        x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
        s = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
        y0, rstd0 = rms.rmsnorm_plain(x, s, 1e-6)
        row = dict(dtype=str(dtype).split(".")[-1], shape=f"({n},{d})")
        for side in ("this", "other"):
            with (using("rmsnorm", other["rmsnorm"]) if side == "other"
                  else contextlib.nullcontext()):
                y, rstd = rms.rmsnorm_cuda(x, s, 1e-6)
                y2, rstd2 = rms.rmsnorm_cuda(x, s, 1e-6)
                row[f"{side}_device_ms"] = sum(cs.kernel_split_ms(
                    lambda: rms.rmsnorm_cuda(x, s, 1e-6), flush,
                    "rmsnorm_fwd").values())
            torch.cuda.synchronize()
            err, within = cs.max_err(y, y0, dtype)
            rstd_err = (rstd - rstd0).abs().max().item()
            row.update({f"{side}_y_err": err, f"{side}_rstd_err": rstd_err,
                        f"{side}_ok": within and rstd_err <= 1e-5,
                        f"{side}_repeat_equal": bool(
                            torch.equal(y, y2) and torch.equal(rstd, rstd2))})
        row["other_ms"], row["this_ms"], row["readings_ms"] = ab(
            "rmsnorm", lambda: rms.rmsnorm_cuda(x, s, 1e-6))
        rows.append(row)
        print(f"[rmsnorm] {json.dumps(row)}")
    return rows


def two_launch_decode(lib, q, k_pool, v_pool, tbl, ctx, n_splits):
    """The two-launch design on ``lib``: split kernel, then combine kernel,
    back to back -> (B, 1, H, D) in q's type."""
    B, _, H, D = q.shape
    P, bs, Kv, _ = k_pool.shape
    G, nb = H // Kv, tbl.shape[1]
    splits, bps = fd.plan_splits(nb, n_splits)
    acc = torch.empty((B * Kv, splits, G, D), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((B * Kv, splits, G), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    out = torch.empty_like(q)
    sfx = fd._SUFFIX[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = getattr(lib, f"flash_decode_split_{sfx}")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(),
        ctx.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, Kv, G,
        D, P, bs, nb, splits, bps, float(D ** -0.5), stream)
    build.check(lib, "flash_decode", code, "two-launch decode: split")
    code = getattr(lib, f"flash_decode_combine_{sfx}")(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), B * Kv,
        splits, G, D, stream)
    build.check(lib, "flash_decode", code, "two-launch decode: combine")
    return out


def flash_decode_ab(dev, dtype, gen, flush, ab, other):
    rows = []
    lib = other["flash_decode"]
    two_launch = not hasattr(lib, f"flash_decode_{fd._SUFFIX[dtype]}")
    # qwen3's shapes: a parent before the head tiles has no G past 16
    for model, splits_list, long_ctx, kw in cs.DECODE_CASES:
        if model != "qwen3":
            continue
        case = cs.decode_case(dev, dtype, gen, **kw)
        for n_splits in splits_list:
            ref = fd.decode_plain(*case, n_splits)
            row = dict(dtype=str(dtype).split(".")[-1], long_ctx=long_ctx,
                       n_splits=n_splits, ctx_max=int(case[4].max()),
                       other_two_launch=two_launch)
            this = lambda: fd.decode_cuda(*case, n_splits)  # noqa: E731
            theirs = ((lambda: two_launch_decode(lib, *case, n_splits))
                      if two_launch else None)
            for side in ("this", "other"):
                fn = theirs if side == "other" and two_launch else this
                with (using("flash_decode", lib)
                      if side == "other" and not two_launch
                      else contextlib.nullcontext()):
                    out, again = fn(), fn()
                    row[f"{side}_device_ms"] = sum(cs.kernel_split_ms(
                        fn, flush, "flash_decode").values())
                torch.cuda.synchronize()
                err, within = cs.max_err(out, ref, dtype)
                row.update({f"{side}_err": err, f"{side}_ok": within,
                            f"{side}_repeat_equal": bool(
                                torch.equal(out, again))})
            row["other_ms"], row["this_ms"], row["readings_ms"] = ab(
                "flash_decode", this, theirs)
            rows.append(row)
            print(f"[flash_decode] {json.dumps(row)}")
        del case
    return rows


if __name__ == "__main__":
    sys.exit(main())
