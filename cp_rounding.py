#!/usr/bin/env python3
"""How far rwkv6-1.6b's gradients under ``fsdp_cp2`` lie from one
process's, and why: two gloo processes on the CPU.

    PYTHONPATH=src python cp_rounding.py          # f32
    PYTHONPATH=src python cp_rounding.py --f64    # every f32 in f64

rwkv6-1.6b at full width (d 2048, d_ff 7168, 32 heads of 64) cut to 4
layers, vocabulary 512, B 4 x S 128, random weights from seed 0.  Each
rank computes one process's loss and gradients, then one
``make_train_step`` under ``fsdp_cp2`` (AdamW without clipping: the
gradient is the first moment over 1 - b1), and rank 0 prints the
largest and the median error over the leaves, each relative to the
leaf's scale.  Beside them, how far one process's gradients move when
its WKV outputs, or every product of its RWKV-6 layers
(``models.rwkv6._mm``), are multiplied by (1 + 1e-7 N(0, 1)): the
rounding a context plan changes where it splits those products over the
model axis.  ``--f64`` runs it all in f64 (the plan's f32 policy and
every ``.float()`` cast read as f64), where a right context plan matches
one process to rounding.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

NOISE = 1e-7
B, S, CHUNK = 4, 128, 32


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _grads(cfg, params, batch, rt):
    from repro_torch.models import transformer as tfm
    for p in params.parameters():
        p.grad = None
    loss, _ = tfm.loss_fn(cfg, params, batch, rt)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in params.named_parameters()}


def _noisy(fn, gen):
    """``fn`` with its first output multiplied by (1 + NOISE N(0, 1))."""
    def run(*args):
        out = fn(*args)
        y = out[0] if isinstance(out, tuple) else out
        y = y * (1 + NOISE * torch.randn(y.shape, generator=gen,
                                         dtype=y.dtype))
        return (y,) + out[1:] if isinstance(out, tuple) else y
    return run


def _rank(rank, store, f64):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    from repro_torch import strategy
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.core import parallel as par
    from repro_torch.models import rwkv6 as rwkv_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    dt = torch.float64 if f64 else torch.float32
    if f64:
        torch.set_default_dtype(torch.float64)
        torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
        par._DTYPES["float32"] = torch.float64
    cfg = dataclasses.replace(reduced(get_config("rwkv6-1.6b"), n_layers=4,
                                      d_model=2048), d_ff=7168)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.tensor(toks[:, :-1], dtype=torch.int32),
             "labels": torch.tensor(toks[:, 1:], dtype=torch.int32)}
    rt = Runtime(rwkv_chunk=CHUNK, param_dtype=dt, compute_dtype=dt,
                 grad_dtype=dt)
    params = tfm.init_params(cfg, 0, "cpu")
    loss, ref = _grads(cfg, params, batch, rt)
    moved = {}
    for what, owner, name in (("WKV outputs", rwkv_lib, "wkv_chunked"),
                              ("products", rwkv_lib, "_mm")):
        exact = getattr(owner, name)
        setattr(owner, name, _noisy(exact, torch.Generator().manual_seed(1)))
        try:
            plain = dataclasses.replace(rt, attn_impl="torch")
            _, noisy = _grads(cfg, params, batch, plain)
        finally:
            setattr(owner, name, exact)
        _, clean = _grads(cfg, params, batch, plain)
        moved[what] = [_rel(noisy[n], clean[n]) for n in clean]
    shape = ShapeConfig("cp_rounding", S, B, "train")
    plan = strategy.parse("fsdp_cp2").to_plan(cfg, strategy.host_topology(),
                                              shape)
    prt = par.make_runtime(cfg, plan, shape, rwkv_chunk=CHUNK)
    planned = par.apply_plan(tfm.init_params(cfg, 0, "cpu"), plan, cfg)
    step = make_train_step(cfg, prt, TrainConfig(
        steps=1, warmup=1, opt=AdamWConfig(grad_clip=0.0)), plan)
    b1 = AdamWConfig().b1
    _, state, metrics = step(planned, init_opt_state(planned), batch)
    errs = {n: _rel(m.full_tensor() / (1 - b1), ref[n])
            for n, m in state["m"].items()}
    if rank == 0:
        worst = max(errs, key=errs.get)
        print(f"rwkv6-1.6b, 4 layers at full width, B{B} x S{S}, "
              f"{'f64' if f64 else 'f32'}: loss {float(metrics['loss']):.9f}"
              f" under fsdp_cp2, {loss:.9f} in one process")
        print(f"fsdp_cp2 vs one process: gradients max {errs[worst]:.3g} "
              f"({worst}), median {statistics.median(errs.values()):.3g}")
        for what, m in moved.items():
            print(f"one process, its {what} perturbed by {NOISE}: gradients "
                  f"move max {max(m):.3g}, median {statistics.median(m):.3g}")
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(str(Path(d, "store")), args.f64), nprocs=2)


if __name__ == "__main__":
    main()
