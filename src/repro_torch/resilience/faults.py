"""Deterministic fault injection for the training loop — a copy of the
JAX package's ``resilience/faults.py`` (the same seed and rates give the
same schedule in both packages), raising the port's
:class:`~repro_torch.checkpointing.CheckpointIOError`.

At the scales the paper studies, failures stop being rare events: with a
per-device MTBF of weeks, a 10k-device job sees one every few hours, and
lost work + restart time become a first-order throughput term (the
``costmodel.goodput`` model prices exactly that).  This module makes the
*recovery machinery* testable on a CPU host: a :class:`FaultPlan` is a
seeded, step-indexed schedule of

  * **crashes** — raised as :class:`SimulatedFailure` at the top of the
    scheduled step, before any work for that step runs (so "steps
    completed" is exactly the failing step index), optionally carrying a
    lost-device count for elastic re-planning;
  * **stragglers** — per-step wall-clock delay multipliers, applied as a
    host-side sleep scaled by the measured step time (the
    thermal-throttling / power-capping slowdown mode);
  * **transient checkpoint-I/O errors** — a per-step failure budget
    consumed by ``ckpt_io_check``, raised as
    :class:`~repro_torch.checkpointing.CheckpointIOError` until the
    budget for that step is spent (a retry then succeeds — transient by
    construction).

Plans are value objects: ``generate(seed, ...)`` is deterministic (same
seed -> same schedule), and ``to_json``/``from_json`` round-trip so a CLI
run can pin its schedule in an artifact (``--fault_plan plan.json``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch.checkpointing import CheckpointIOError

FAULT_KINDS = ("crash", "straggler", "ckpt_io")


class SimulatedFailure(RuntimeError):
    """An injected device/host crash (the supervisor's retry trigger)."""

    def __init__(self, step: int, lost_devices: int = 0,
                 detail: str = ""):
        self.step = step
        self.lost_devices = lost_devices
        msg = f"simulated failure at step {step}"
        if lost_devices:
            msg += f" ({lost_devices} device(s) lost)"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault."""
    step: int
    kind: str                 # 'crash' | 'straggler' | 'ckpt_io'
    magnitude: float = 1.0    # straggler: slowdown multiplier (>= 1);
    #                           ckpt_io: number of failing attempts
    lost_devices: int = 0     # crash: devices lost (0 = process crash only)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind {self.kind!r} not in {FAULT_KINDS}")


@dataclasses.dataclass
class FaultPlan:
    """A step-indexed fault schedule, plus mutable retry bookkeeping."""
    events: List[FaultEvent] = dataclasses.field(default_factory=list)
    seed: Optional[int] = None
    # crash steps already raised once are not re-raised on the restarted
    # attempt (a real crashed host does not re-crash deterministically at
    # the same step after replacement) — the supervisor's resume path
    # would otherwise never make progress past a scheduled step
    _fired: set = dataclasses.field(default_factory=set, repr=False)
    _io_spent: Dict[int, int] = dataclasses.field(default_factory=dict,
                                                  repr=False)

    # ---- construction ------------------------------------------------------

    @classmethod
    def generate(cls, seed: int, n_steps: int,
                 crash_rate: float = 0.0,
                 straggler_rate: float = 0.0,
                 straggler_slowdown: float = 2.0,
                 ckpt_io_rate: float = 0.0) -> "FaultPlan":
        """Sample a schedule: each step independently draws each fault
        kind at its rate.  Deterministic in ``seed`` (one substream per
        fault kind, so changing one rate never reshuffles the others)."""
        events: List[FaultEvent] = []
        for kind, rate in (("crash", crash_rate),
                           ("straggler", straggler_rate),
                           ("ckpt_io", ckpt_io_rate)):
            rng = np.random.default_rng([seed, FAULT_KINDS.index(kind)])
            draws = rng.random(n_steps)
            for step in np.nonzero(draws < rate)[0]:
                if kind == "crash":
                    events.append(FaultEvent(int(step), "crash",
                                             lost_devices=0))
                elif kind == "straggler":
                    events.append(FaultEvent(int(step), "straggler",
                                             magnitude=straggler_slowdown))
                else:
                    events.append(FaultEvent(int(step), "ckpt_io",
                                             magnitude=1.0))
        events.sort(key=lambda e: (e.step, FAULT_KINDS.index(e.kind)))
        return cls(events=events, seed=seed)

    @classmethod
    def crashes_at(cls, *steps: int, lost_devices: int = 0) -> "FaultPlan":
        """Explicit crash schedule (the unit-test workhorse)."""
        return cls(events=[FaultEvent(s, "crash", lost_devices=lost_devices)
                           for s in sorted(steps)])

    # ---- serialization -----------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "events": [dataclasses.asdict(e) for e in self.events]},
            indent=1)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(events=[FaultEvent(**e) for e in d.get("events", [])],
                   seed=d.get("seed"))

    # ---- queries -----------------------------------------------------------

    def _at(self, step: int, kind: str) -> Optional[FaultEvent]:
        for e in self.events:
            if e.step == step and e.kind == kind:
                return e
        return None

    def crash_steps(self) -> List[int]:
        return sorted(e.step for e in self.events if e.kind == "crash")

    def delay_multiplier(self, step: int) -> float:
        """Straggler slowdown for this step (1.0 = no fault)."""
        e = self._at(step, "straggler")
        return max(e.magnitude, 1.0) if e else 1.0

    # ---- injection hooks (called by the training loop) ---------------------

    def check_crash(self, step: int) -> None:
        """Raise :class:`SimulatedFailure` if a crash is scheduled at
        ``step`` and has not fired yet (each crash fires once)."""
        e = self._at(step, "crash")
        if e is not None and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(step, lost_devices=e.lost_devices,
                                   detail="injected by FaultPlan")

    def ckpt_io_check(self, step: int) -> None:
        """Raise :class:`CheckpointIOError` while the scheduled failing-
        attempt budget for ``step`` is unspent; later attempts succeed
        (this is the *transient* I/O error mode — a retry recovers)."""
        e = self._at(step, "ckpt_io")
        if e is None:
            return
        spent = self._io_spent.get(step, 0)
        if spent < int(e.magnitude):
            self._io_spent[step] = spent + 1
            raise CheckpointIOError(
                f"injected transient checkpoint-I/O failure at step {step} "
                f"(attempt {spent + 1}/{int(e.magnitude)})")

    def reset(self) -> None:
        """Forget retry bookkeeping (a fresh supervisor run replays the
        full schedule)."""
        self._fired.clear()
        self._io_spent.clear()


def load_fault_plan(spec: str) -> FaultPlan:
    """CLI entry: a path to a ``to_json`` file, or an inline spec
    ``crash@<step>[,<step>...]`` for quick experiments."""
    if spec.startswith("crash@"):
        steps = [int(s) for s in spec[len("crash@"):].split(",") if s]
        return FaultPlan.crashes_at(*steps)
    with open(spec) as f:
        return FaultPlan.from_json(f.read())
