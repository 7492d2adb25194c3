"""Elastic restart supervisor: retry, restore, re-plan, record — a copy
of the JAX package's ``resilience/supervisor.py`` whose
:func:`supervise_training` drives the port's ``train_loop`` on a
``torch.distributed`` mesh.

The supervisor owns the outermost loop of a fault-tolerant run.  One
*attempt* is a full ``train_loop`` invocation (with ``tc.resume=True`` so
each attempt restores from the newest CRC-valid checkpoint); the
supervisor catches :class:`~repro_torch.resilience.faults.SimulatedFailure`
(and real exceptions), applies exponential backoff under a max-restart
budget, optionally **re-plans the strategy for a degraded device count**
(a crash reporting lost devices shrinks the topology and asks the
planner for the best strategy that still lowers — the data/fsdp axis
absorbs the loss), and records a structured event log (failures,
restarts, lost steps, recovery wall time) that the dryrun/benchmark
artifacts fold in.

The supervisor is deliberately generic over the attempt body: ``run``
drives any ``attempt_fn(attempt, strategy, topology) -> result``, so
tests can exercise backoff/budget/fallback logic without a real model,
and :func:`supervise_training` provides the production wiring used by
``launch/train.py``.

Under a process group every rank runs the same supervisor and the same
fault plan, so every rank fails at the same step and restarts together:
rank 0 picks the restore point (``restore_step``, broadcast) and writes
the event log.  Each attempt ends with every rank's outcome gathered
over the whole world, so a failure on some ranks is a failure on all.
After a re-plan onto fewer devices the mesh spans the first ranks
(``strategy.topology.build_mesh``); a rank outside it sits the attempt
out but stays in the loop, and so takes its part in the next restore
and re-plan when the ranks of the mesh fail again.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch import telemetry as tel
from repro_torch.resilience.faults import SimulatedFailure


class RestartBudgetExceeded(RuntimeError):
    """More failures than ``max_restarts`` allows; the last cause chains."""


class PeerFailure(RuntimeError):
    """Another rank's failed attempt, as a rank that did not fail sees it
    (one outside a degraded mesh, say): the failing rank's error, step
    and lost devices."""

    def __init__(self, rank: int, error: str, simulated: bool,
                 step: Optional[int], lost_devices: int):
        super().__init__(f"rank {rank} failed: {error}")
        self.simulated = simulated
        self.step = step
        self.lost_devices = lost_devices


def _agree(err: Optional[BaseException]) -> Optional[BaseException]:
    """An attempt's outcome on every rank of the world: ``err`` where it
    was raised, else the first failing rank's as a :class:`PeerFailure`,
    else None.  Without a process group, ``err``."""
    if not dist.is_initialized():
        return err
    mine = None if err is None else (
        repr(err), isinstance(err, SimulatedFailure),
        getattr(err, "step", None), getattr(err, "lost_devices", 0))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if err is not None:
        return err
    return next((PeerFailure(rank, *info) for rank, info in enumerate(every)
                 if info is not None), None)


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 3
    backoff_base_s: float = 0.05      # first restart waits this long
    backoff_factor: float = 2.0       # then base * factor**n, capped
    backoff_max_s: float = 5.0
    replan_on_degrade: bool = True    # lost devices -> planner re-pick
    event_log_path: str = ""          # write the structured log here
    # keywords of the planner's ``search`` at a re-plan, e.g.
    # ``{"precisions": ("f32",)}`` to keep a run's numerics
    replan_search: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Supervisor:
    """Retry loop with backoff, checkpoint fallback, and elastic re-plan."""

    def __init__(self, config: SupervisorConfig, ckpt_dir: str = "",
                 telemetry: tel.Recorder = tel.NULL):
        self.config = config
        self.ckpt_dir = ckpt_dir
        self.telemetry = telemetry
        self.events: List[Dict[str, Any]] = []

    # ---- bookkeeping -------------------------------------------------------

    def _record(self, **kw) -> Dict[str, Any]:
        event = {"t": time.time(), **kw}
        self.events.append(event)
        self.telemetry.counter(f"supervisor/{kw.get('kind', 'event')}", 1)
        return event

    def backoff_s(self, n_restarts: int) -> float:
        c = self.config
        return min(c.backoff_base_s * c.backoff_factor ** n_restarts,
                   c.backoff_max_s)

    def restore_step(self) -> Optional[int]:
        """Newest CRC-valid checkpoint step (corrupt/partial skipped),
        chosen on rank 0 and broadcast to every rank."""
        if not self.ckpt_dir:
            return None
        from repro_torch import checkpointing as ckpt_lib
        if not dist.is_initialized():
            return ckpt_lib.latest_valid_step(self.ckpt_dir, verify=True)
        box = [ckpt_lib.latest_valid_step(self.ckpt_dir, verify=True)
               if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def write_event_log(self) -> Optional[str]:
        """Write the summary JSON at ``event_log_path`` (the pinned
        ``--event_log`` format) plus a sibling ``.jsonl`` carrying the
        same events in the shared telemetry schema, written by the
        telemetry JSONL sink — one serializer for every event stream in
        the repo.  Emission happens here, not in ``_record``, because
        the retry loop keeps mutating failure events (backoff_s,
        recovery_wall_s, budget_exhausted) after recording them."""
        path = self.config.event_log_path
        if not path or dist.is_initialized() and dist.get_rank() != 0:
            return None
        out_dir = os.path.dirname(path)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(tel.summarize_events(self.events), f, indent=1)
        sink = tel.JsonlSink(os.path.splitext(path)[0] + ".jsonl")
        try:
            for e in self.events:
                attrs = {k: v for k, v in e.items()
                         if k not in ("t", "kind") and v is not None}
                ev = tel.make_event(
                    "event", f"supervisor/{e.get('kind', 'event')}",
                    e["t"])
                if attrs:
                    ev["attrs"] = attrs
                sink.emit(ev)
        finally:
            sink.close()
        return path

    # ---- elastic re-plan ---------------------------------------------------

    def degrade(self, cfg, strategy, topology, shape, lost_devices: int):
        """Shrink the topology by the lost devices and re-plan.

        The surviving count is rounded down to a multiple of the current
        model-parallel footprint (the data/fsdp axis is what shrinks —
        the model axes must stay whole), then the planner picks the best
        strategy that still lowers there.  Returns (strategy, topology);
        falls back to the current pair when nothing viable survives.
        """
        from repro_torch.strategy import best
        n = topology.n_devices - lost_devices
        mp = strategy.model_parallel
        n -= n % mp
        if n < mp:
            return strategy, topology
        topo2 = dataclasses.replace(topology, name=topology.name + "-deg",
                                    n_devices=n,
                                    island=min(topology.island, n))
        planned = best(cfg, topo2, shape, **self.config.replan_search)
        if planned is None:
            return strategy, topology
        return planned.strategy, topo2

    # ---- the retry loop ----------------------------------------------------

    def run(self, attempt_fn: Callable[[int, Any, Any], Any],
            strategy: Any = None, topology: Any = None,
            cfg: Any = None, shape: Any = None) -> Any:
        """Drive ``attempt_fn`` to completion under the restart budget.

        ``attempt_fn(attempt, strategy, topology)`` runs one attempt; the
        strategy/topology pair evolves across attempts when a failure
        reports lost devices and re-planning is on.  Raises
        :class:`RestartBudgetExceeded` (chaining the last cause) once
        ``max_restarts`` restarts are spent.
        """
        n_restarts = 0
        while True:
            t_start = time.time()
            result = err = None
            try:
                with self.telemetry.span("supervisor/attempt",
                                         attempt=n_restarts):
                    result = attempt_fn(n_restarts, strategy, topology)
            except Exception as e:  # noqa: BLE001 - SimulatedFailure too
                err = e
            e = _agree(err)
            if e is None:
                self._record(kind="completed", attempt=n_restarts,
                             n_restarts=n_restarts)
                self.write_event_log()
                return result
            t_fail = time.time()
            step_failed = getattr(e, "step", None)
            lost = getattr(e, "lost_devices", 0)
            restore = self.restore_step()
            event = self._record(
                kind="failure", attempt=n_restarts,
                error=repr(e),
                simulated=getattr(e, "simulated",
                                  isinstance(e, SimulatedFailure)),
                step_failed=step_failed,
                restore_step=restore,
                lost_steps=(step_failed - (restore or 0)
                            if step_failed is not None else None),
                lost_devices=lost,
                run_wall_s=round(t_fail - t_start, 4))
            if n_restarts >= self.config.max_restarts:
                event["budget_exhausted"] = True
                self.write_event_log()
                raise RestartBudgetExceeded(
                    f"{n_restarts + 1} failures exceed "
                    f"max_restarts={self.config.max_restarts} "
                    f"(last: {e!r})") from e
            backoff = self.backoff_s(n_restarts)
            event["backoff_s"] = backoff
            if backoff:
                time.sleep(backoff)
            if lost and self.config.replan_on_degrade and \
                    cfg is not None and topology is not None:
                old_spec = strategy.format() if strategy is not None \
                    else None
                strategy, topology = self.degrade(
                    cfg, strategy, topology, shape, lost)
                self._record(kind="replan", attempt=n_restarts,
                             lost_devices=lost,
                             old_spec=old_spec,
                             new_spec=strategy.format(),
                             n_devices=topology.n_devices)
            n_restarts += 1
            event["recovery_wall_s"] = round(time.time() - t_fail, 4)


def supervise_training(cfg, strategy, topology, shape, tc, make_batches,
                       rt_overrides: Optional[Dict] = None, seed: int = 0,
                       device=None, fault_plan=None,
                       sup_cfg: Optional[SupervisorConfig] = None,
                       telemetry: tel.Recorder = tel.NULL, drift=None):
    """Production wiring: supervised ``train_loop`` attempts.

    Each attempt lowers the (possibly re-planned) strategy on its
    topology (``to_plan``; the plan, and so its mesh and process groups,
    is reused while the pair is unchanged), builds the runtime
    (``make_runtime`` with ``rt_overrides``) and the parameters from
    ``seed`` on ``device`` (``init_params`` + ``apply_plan``; the card
    unless ``device`` says otherwise), and runs with ``resume=True`` after
    the first, so a restart restores the newest valid checkpoint and
    replays the data stream from the restored position.
    ``make_batches()`` must return a *fresh* batch iterable per call
    (sources are stateful).  A rank outside a degraded mesh sits each
    attempt out (``(None, None, [])``) but follows the others' outcome:
    it restores, re-plans and tries again with them, and returns ``(None,
    None, [], supervisor)`` when they complete.  Returns ``(params,
    opt_state, history, supervisor)``.
    """
    from repro_torch.core import parallel as par
    from repro_torch.models import init_params
    from repro_torch.train.trainer import train_loop

    sup = Supervisor(sup_cfg or SupervisorConfig(), ckpt_dir=tc.ckpt_dir,
                     telemetry=telemetry)
    device = torch.device(device or "cuda")
    plans: Dict = {}

    def attempt(n_restarts, strat, topo):
        key = (strat.format(), topo)
        if key not in plans:
            plans.clear()
            plans[key] = strat.to_plan(cfg, topo, shape)
        plan = plans[key]
        if plan.mesh.get_coordinate() is None:
            return None, None, []
        rt = par.make_runtime(cfg, plan, shape, **(rt_overrides or {}))
        params = par.apply_plan(init_params(cfg, seed, device), plan, cfg)
        tc_run = dataclasses.replace(tc, resume=tc.resume or n_restarts > 0)
        return train_loop(cfg, rt, tc_run, make_batches(), params,
                          telemetry=telemetry, plan=plan, drift=drift,
                          fault_plan=fault_plan, seed=seed)

    params, opt_state, history = sup.run(
        attempt, strategy=strategy, topology=topology, cfg=cfg, shape=shape)
    return params, opt_state, history, sup
