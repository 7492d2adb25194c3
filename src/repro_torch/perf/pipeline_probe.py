"""Execute a pipeline schedule and *measure* its bubble fraction — the
port of the JAX package's ``perf/pipeline_probe.py``.

The cost model charges each pipeline schedule its analytic bubble
(``costmodel.step_time`` / ``pipeline.bubble_fraction``): (P-1)/(M+P-1)
for gpipe and 1f1b, (P-1)/(vM+P-1) for interleaved '1f1b_i<v>',
2(P-1)/(3M+2P-2) for zero-bubble 'zb'.  This probe checks those terms
against execution: it runs the port's own pipelined step
(``core.pipeline.run_schedule``: forward and backward through real stage
parameters under the strategy's plan and schedule) at fixed microbatch
*size* for M and 2M microbatches and lets
``core.pipeline.measure_bubble_fraction`` fit t(M) = t_tick * (ticks_per_mb
* M + drain) + overhead.

The JAX probe runs in one process over a mesh of host devices.  The
port's pipe axis is a process group, so the probe runs on every rank of a
live one — P ranks under ``torchrun``, or a spawned gloo world — and each
rank times its own column of the table; the ranks move in lockstep
through the table's point-to-point exchanges.  Like the reference's, it
runs the plain layers (the JAX probe's runtime takes the jnp defaults),
in f32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import parallel as par
from repro_torch.core.pipeline import (measure_bubble_fraction,
                                       run_schedule, virtual_stages)
from repro_torch.models import init_params


def probe_layers(pp: int, sched: str) -> int:
    """Layers of the probe's reduced config: at least max(4, 2 pp),
    rounded up to split into pp x v virtual-stage chunks (the JAX dry
    run's rule, ``launch/dryrun.py``)."""
    chunk = pp * virtual_stages(sched)
    return -(-max(4, 2 * pp) // chunk) * chunk


def measure_bubble(cfg: ModelConfig, strat, topology, device,
                   seq_len: int = 128, mb_rows: int = 2, n_iter: int = 3,
                   **rt_overrides) -> dict:
    """Measured vs predicted bubble for ``strat`` (pp > 1) on the live
    process group, on every one of its ranks (each returns its own
    timing; ``bubble_predicted`` is the same everywhere).

    ``device`` is this rank's; ``rt_overrides`` go to ``make_runtime``
    (``pipe_via_host=True`` for a gloo pipe group between ranks on
    cards).  Each microbatch holds ``mb_rows`` rows on every data rank.
    The bubble is a property of the (P, M, schedule) tick table, not of
    model scale, so callers may pass a ``reduced()`` config (with
    :func:`probe_layers` layers) to keep the probe cheap — the per-tick
    time only needs to dominate dispatch overhead.
    """
    if strat.pp <= 1:
        raise ValueError("bubble probe needs a pipeline strategy")
    dp = topology.n_devices // (strat.model_axis * strat.pp)
    shape = ShapeConfig("pp-probe", seq_len,
                        mb_rows * dp * strat.microbatches * strat.grad_accum,
                        "train")
    plan = strat.to_plan(cfg, topology, shape)
    rt = par.make_runtime(cfg, plan, shape, param_dtype=torch.float32,
                          compute_dtype=torch.float32, remat=False,
                          attn_impl="torch", norm_impl="torch",
                          attn_min_chunked_len=max(2048, seq_len + 1),
                          **rt_overrides)
    params = par.apply_plan(init_params(cfg, 0, device), plan, cfg)
    gen = torch.Generator().manual_seed(1)

    def step_for_m(m: int):
        micros = []
        for _ in range(m):
            toks = torch.randint(0, cfg.vocab_size, (mb_rows, seq_len + 1),
                                 generator=gen)
            micros.append({"tokens": toks[:, :-1].to(device),
                           "labels": toks[:, 1:].to(device)})
        rt_m = dataclasses.replace(rt, pipe_microbatches=m)
        denom = torch.tensor(float(m * mb_rows * seq_len * dp),
                             device=device)

        def run():
            for p in params.parameters():
                p.grad = None
            return run_schedule(cfg, params, micros, rt_m, denom).nll

        return run

    rec = measure_bubble_fraction(step_for_m, strat.pp, strat.microbatches,
                                  n_iter=n_iter, sched=strat.sched)
    rec.update(probe_cfg=cfg.name, probe_seq_len=seq_len,
               probe_mb_rows=mb_rows)
    return rec
