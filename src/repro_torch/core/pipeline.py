"""Pipeline schedules: the schedule grammar and the analytic terms — a
copy of the pure-Python part of the JAX package's ``core/pipeline.py``.

The cost model and the strategy descriptor need only these: the schedule
names a spec may carry (``gpipe``, ``1f1b``, ``1f1b_i<v>``, ``zb``), the
virtual stages per rank, the bubble fraction and the in-flight
microbatches of each schedule.  The executable schedules (tick tables and
the stage loop over ``torch.distributed`` point-to-point sends) come with
the pipeline slice of the port (ROADMAP Queue 1 item 6); until then a
strategy with pp > 1 raises ``StrategyError``.
"""
from __future__ import annotations

import re
from typing import Tuple

SCHEDULE_NAMES = ("gpipe", "1f1b", "zb")

_INTERLEAVED_RE = re.compile(r"^1f1b_i(\d+)$")


def parse_schedule(sched: str) -> Tuple[str, int]:
    """Split a schedule name into (family, virtual_stages).

    'gpipe' / '1f1b' / 'zb' -> (name, 1); '1f1b_i<v>' -> ('1f1b_i', v)
    with v >= 2 (v == 1 is plain 1f1b — rejected to keep names canonical).
    Raises ValueError for anything else, so every validation site shares
    one grammar."""
    m = _INTERLEAVED_RE.match(sched)
    if m:
        v = int(m.group(1))
        if v < 2:
            raise ValueError(
                f"interleaved schedule {sched!r} needs v >= 2 virtual "
                "stages per rank (v == 1 is plain '1f1b')")
        return "1f1b_i", v
    if sched in SCHEDULE_NAMES:
        return sched, 1
    raise ValueError(f"unknown pipeline schedule {sched!r}; expected one "
                     f"of {SCHEDULE_NAMES} or '1f1b_i<v>' (v >= 2)")


def known_schedule(sched: str) -> bool:
    try:
        parse_schedule(sched)
        return True
    except ValueError:
        return False


def virtual_stages(sched: str) -> int:
    """Virtual stages (param chunks) per pipe rank: v for '1f1b_i<v>',
    1 for every flat schedule."""
    return parse_schedule(sched)[1]


# ---------------------------------------------------------------------------
# analytic terms (pure python — importable by the cost model without tracing)
# ---------------------------------------------------------------------------

def bubble_fraction(n_stages: int, n_microbatches: int,
                    sched: str = "gpipe") -> float:
    """Idle-tick fraction of the schedule.

      * gpipe / 1f1b — (P-1)/(M+P-1): identical at equal per-tick cost
        (1F1B *reorders* the bubble to cap in-flight activations, it does
        not shrink it);
      * 1f1b_i<v>  — (P-1)/(vM+P-1): v virtual stages per rank slice each
        tick v ways, so the same warmup/drain idles amortize over vM work
        ticks (Megatron interleaved);
      * zb         — 2(P-1)/(3M+2P-2): each backward splits into dgrad and
        wgrad sub-ticks (F/B/W all one sub-tick) and the deferred wgrads
        fill the drain; only the 2(P-1) warmup+drain sub-ticks idle, out
        of 3M work sub-ticks per rank (ZB-H1 with a bounded wgrad
        backlog).  Strictly below 1f1b's bubble for every M >= 1.
    """
    family, v = parse_schedule(sched)
    if n_stages <= 1:
        return 0.0
    P_, M = n_stages, n_microbatches
    if family == "1f1b_i":
        return (P_ - 1) / (v * M + P_ - 1)
    if family == "zb":
        return 2 * (P_ - 1) / (3 * M + 2 * P_ - 2)
    return (P_ - 1) / (M + P_ - 1)


def inflight_microbatches(n_stages: int, n_microbatches: int,
                          sched: str = "gpipe") -> int:
    """Peak number of in-flight activations a rank holds awaiting
    backward — the schedule-dependent factor in pipeline activation
    memory.

      * gpipe      — M whole-stage activations;
      * 1f1b / zb  — min(M, P) whole-stage activations (zb's dgrad
        sub-tick frees the activation exactly where 1f1b's combined
        backward does; the deferred wgrad keeps only a param-shaped
        gradient stash, charged separately by the cost model);
      * 1f1b_i<v>  — min(2(P-1) + (v-1)P + 1, vM) *chunk* activations,
        each covering 1/v of the rank's layer slice (the rank-0 warmup
        depth of the interleaved schedule) — divide by v before comparing
        against whole-stage units.
    """
    family, v = parse_schedule(sched)
    P_, M = n_stages, n_microbatches
    if n_stages <= 1:
        return M
    if family == "1f1b_i":
        return min(2 * (P_ - 1) + (v - 1) * P_ + 1, v * M)
    if family in ("1f1b", "zb"):
        return min(M, P_)
    return M


# ---------------------------------------------------------------------------
# batch-axis fitting
# ---------------------------------------------------------------------------

_warned_dropped: set = set()
