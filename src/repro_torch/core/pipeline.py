"""Pipeline schedules: the schedule grammar, the analytic terms and the
tick tables of the JAX package's ``core/pipeline.py`` (copied as pure
Python), and the executor that runs any table on ``torch.distributed``
point-to-point over a plan's ``pipe`` axis.

Each pipe rank owns a *stage*: the contiguous layers [r L/P, (r+1) L/P),
or under ``1f1b_i<v>`` the v chunks of virtual stages ``c P + r``
(:func:`stage_layers`; ``core.parallel.apply_plan`` keeps only those on
the rank, under FSDP2 over its (data, model) submesh).  The embedding,
final norm and LM head stay replicated over the pipe axis: virtual stage 0
embeds, the last computes the final norm, the head and its microbatch's
share of the global masked loss.  A minibatch splits into M microbatches;
the schedule's table (``get_schedule(name).tick_table``, or
:func:`full_table` with chunks) gives each rank one op a tick:

  * ``F(c, j)`` — receive the activation (or embed, on virtual stage 0),
    run chunk c's layers, send the output on (or compute the loss);
  * ``B(c, j)`` — receive the output's cotangent (or start from the loss),
    run backward through the graph F kept, send the input's cotangent;

A chunk's F also returns the sum of its MoE layers' aux losses (the
routers' statistics all-reduced over the groups that shard the
microbatch's tokens, ``Runtime.moe_stat_groups``).  The step's aux is the
mean over the M microbatches of each one's aux summed over the stages
(the JAX package threads it through its schedule beside the activation
and divides by M); here each chunk's B runs backward from its output's
cotangent and from its own aux over M together, so the aux's gradient
reaches the routers and, through the residual stream, the earlier
stages, and the pipe ranks' aux sums add up to the step's.
  * ``W`` (``zb``) — see below.

:func:`run_schedule` runs one rank's row of any table.  At each tick a
rank posts, in one ``batch_isend_irecv``, the send of its own op's output
and the receives of what its neighbours' ops of the same tick produce for
it (both ends read the same table), then waits for them: no two ranks wait
on each other.  ``torch.distributed.pipelining`` is not used: its
schedules order ops their own way, and the executed order here is held to
the reference's table.

What the port does differently from the reference, and why:

  * *No replay in 1F1B.*  The reference's 1F1B and table schedules are a
    ``custom_vjp`` whose primal runs every forward storing only its inputs
    and whose backward replays each forward just in time.  In eager
    PyTorch a replay buys nothing: each F runs once and its autograd graph
    is held until its B, so a rank holds at most
    ``inflight_microbatches(P, M, sched)`` microbatch graphs — the count
    the cost model charges — and the values are the same.
  * *zb's W drains a stash, as the reference's does.*  The reference
    computes the parameter gradients at the dgrad sub-tick and only adds
    them at W.  Here B runs backward into the parameters (which keeps
    FSDP2's post-backward hooks whole) and W records its tick and adds
    nothing new.  A true dgrad/wgrad split is new work.

:func:`measure_bubble_fraction` times any pipelined step at M and 2M
microbatches and fits the bubble from the two times;
``perf.pipeline_probe`` feeds it :func:`run_schedule` on a live pipe
group.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

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
# schedules: tick tables (pure python, copied from the JAX package)
# ---------------------------------------------------------------------------

class PipelineSchedule:
    """One pipeline schedule: its per-tick op table and analytic terms."""

    name: str = "?"

    def bubble_fraction(self, n_stages: int, n_microbatches: int) -> float:
        return bubble_fraction(n_stages, n_microbatches, self.name)

    def inflight_microbatches(self, n_stages: int,
                              n_microbatches: int) -> int:
        return inflight_microbatches(n_stages, n_microbatches, self.name)

    def tick_table(self, n_stages: int, n_microbatches: int
                   ) -> List[List[Tuple[str, int]]]:
        """[tick][stage] -> ('F', j) | ('B', j) | ('idle', -1) covering the
        full fwd+bwd execution."""
        raise NotImplementedError

    def full_table(self, n_stages: int, n_microbatches: int
                   ) -> List[List[Tuple[str, int, int]]]:
        """[tick][rank] -> (op, chunk, microbatch); idle is ('idle', 0,
        0).  What :func:`run_schedule` executes."""
        return [[(op, 0, j) if op != "idle" else ("idle", 0, 0)
                 for op, j in row]
                for row in self.tick_table(n_stages, n_microbatches)]

    def simulate(self, n_stages: int, n_microbatches: int) -> Dict:
        """Counted-from-the-table bubble fraction and peak in-flight
        activations — what the analytic formulas must reproduce."""
        table = self.tick_table(n_stages, n_microbatches)
        idle = sum(op == "idle" for row in table for op, _ in row)
        total = len(table) * n_stages
        peak = 0
        inflight = [set() for _ in range(n_stages)]
        for row in table:
            for s, (op, j) in enumerate(row):
                if op == "F":
                    inflight[s].add(j)
                elif op == "B":
                    inflight[s].discard(j)
            peak = max(peak, max(len(f) for f in inflight))
        return {"ticks": len(table), "bubble": idle / total,
                "peak_inflight": peak}


class GPipeSchedule(PipelineSchedule):
    """All forwards, then all backwards; M microbatch activations in
    flight per stage."""

    name = "gpipe"

    def tick_table(self, n_stages, n_microbatches):
        P_, M = n_stages, n_microbatches
        table = []
        for t in range(M + P_ - 1):                       # forward pass
            table.append([("F", t - s) if 0 <= t - s < M else ("idle", -1)
                          for s in range(P_)])
        for u in range(M + P_ - 1):                       # transposed scan
            t = M + P_ - 2 - u
            table.append([("B", t - s) if 0 <= t - s < M else ("idle", -1)
                          for s in range(P_)])
        return table


class OneFOneBSchedule(PipelineSchedule):
    """1F1B (PipeDream-flush): stage s runs P - s warmup forwards, then
    alternates one-forward-one-backward, then drains.  Stage s forwards
    microbatch j at tick ``s + j`` during warmup (j < P - s) and ``2j + s``
    in steady state, and backwards j at ``2j + 2P - 1 - s``."""

    name = "1f1b"

    @staticmethod
    def _fwd_tick(P_, M, s, j):
        return s + j if j < P_ - s else 2 * j + s

    @staticmethod
    def _bwd_tick(P_, M, s, j):
        return 2 * j + 2 * P_ - 1 - s

    def tick_table(self, n_stages, n_microbatches):
        P_, M = n_stages, n_microbatches
        if M < P_:
            raise ValueError(f"1f1b needs microbatches >= stages "
                             f"(got M={M} < P={P_})")
        total = 2 * (M + P_ - 1)
        table = [[("idle", -1)] * P_ for _ in range(total)]
        for s in range(P_):
            for j in range(M):
                table[self._fwd_tick(P_, M, s, j)][s] = ("F", j)
                table[self._bwd_tick(P_, M, s, j)][s] = ("B", j)
        return table


def _interleaved_full_table(P_, M, v):
    """Greedy Megatron-order interleaved 1F1B.

    Virtual stage ``sv = c*P + r`` (chunk c of rank r); per-rank op order
    is the Megatron one — forwards in groups of P microbatches,
    chunk-major within the group; backwards the same with chunks
    reversed — after a ``min(2(P-1-r) + (v-1)P + 1, vM)`` warmup.  The
    result achieves exactly T = 2(vM+P-1) ticks and bubble
    (P-1)/(vM+P-1) with peak in-flight chunk activations equal to the
    rank-0 warmup depth."""
    if M % P_:
        raise ValueError(
            f"interleaved 1f1b needs microbatches divisible by stages "
            f"(got M={M}, P={P_}: the chunk rotation assigns microbatches "
            "to ranks in groups of P)")
    S = v * P_
    order_f = [(c, g * P_ + o) for g in range(M // P_)
               for c in range(v) for o in range(P_)]
    order_b = [(c, g * P_ + o) for g in range(M // P_)
               for c in range(v - 1, -1, -1) for o in range(P_)]
    warm = [min(2 * (P_ - r - 1) + (v - 1) * P_ + 1, v * M)
            for r in range(P_)]
    done_f, done_b = {}, {}
    fi = [0] * P_
    bi = [0] * P_
    table = []
    t = 0
    while any(fi[r] < v * M or bi[r] < v * M for r in range(P_)):
        row = []
        for r in range(P_):
            entry = ("idle", 0, 0)
            if fi[r] < warm[r] and bi[r] == 0:
                want = "F"                      # warmup forwards
            elif bi[r] < v * M and (fi[r] >= v * M
                                    or bi[r] <= fi[r] - warm[r]):
                want = "B"                      # steady 1B after warmup
            elif fi[r] < v * M:
                want = "F"
            else:
                want = "B"
            for cand in (want, "B" if want == "F" else "F"):
                if cand == "F" and fi[r] < v * M:
                    c, j = order_f[fi[r]]
                    sv = c * P_ + r
                    if sv == 0 or done_f.get((sv - 1, j), t) < t:
                        entry = ("F", c, j)
                        done_f[(sv, j)] = t
                        fi[r] += 1
                        break
                elif cand == "B" and bi[r] < v * M:
                    c, j = order_b[bi[r]]
                    sv = c * P_ + r
                    ok = (done_b.get((sv + 1, j), t) < t if sv < S - 1
                          else done_f.get((sv, j), t) < t)
                    if ok:
                        entry = ("B", c, j)
                        done_b[(sv, j)] = t
                        bi[r] += 1
                        break
            row.append(entry)
        table.append(row)
        t += 1
        if t > 6 * (v * M + P_):
            raise RuntimeError("interleaved schedule made no progress")
    return table


def _zb_full_table(P_, M):
    """Greedy zero-bubble (ZB-H1-style) table: each backward splits into a
    dgrad sub-tick ('B': activation cotangent, frees the stored input) and
    a deferred wgrad sub-tick ('W': parameter gradient) that fills what
    would otherwise be drain idle time.

    Priority B > W > F keeps the wgrad backlog at <= 1 pending microbatch
    per rank while still reaching T = 3M + 2(P-1) sub-ticks — bubble
    2(P-1)/(3M+2P-2), strictly below 1f1b's (P-1)/(M+P-1) for all M."""
    if M < P_:
        raise ValueError(f"zb needs microbatches >= stages "
                         f"(got M={M} < P={P_})")
    done_f, done_b = {}, {}
    fi = [0] * P_
    bi = [0] * P_
    wi = [0] * P_
    table = []
    t = 0
    while any(fi[r] < M or bi[r] < M or wi[r] < M for r in range(P_)):
        row = []
        for r in range(P_):
            entry = ("idle", 0, 0)
            if bi[r] < M and (done_b.get((r + 1, bi[r]), t) < t
                              if r < P_ - 1
                              else done_f.get((r, bi[r]), t) < t):
                entry = ("B", 0, bi[r])
                done_b[(r, bi[r])] = t
                bi[r] += 1
            elif wi[r] < bi[r]:
                entry = ("W", 0, wi[r])
                wi[r] += 1
            elif fi[r] < M and fi[r] - bi[r] < P_ - r and \
                    (r == 0 or done_f.get((r - 1, fi[r]), t) < t):
                entry = ("F", 0, fi[r])
                done_f[(r, fi[r])] = t
                fi[r] += 1
            row.append(entry)
        table.append(row)
        t += 1
        if t > 6 * (3 * M + 2 * P_):
            raise RuntimeError("zb schedule made no progress")
    return table


def _fwd_only_table(P_, M, v):
    """Forward-only table: each rank runs its Megatron-order forwards as
    soon as the upstream virtual stage has produced the input."""
    S = v * P_
    order_f = [(c, g * P_ + o) for g in range(M // P_)
               for c in range(v) for o in range(P_)] if v > 1 else \
        [(0, j) for j in range(M)]
    done_f = {}
    fi = [0] * P_
    table = []
    t = 0
    while any(fi[r] < v * M for r in range(P_)):
        row = []
        for r in range(P_):
            entry = ("idle", 0, 0)
            if fi[r] < v * M:
                c, j = order_f[fi[r]]
                sv = c * P_ + r
                if sv == 0 or done_f.get((sv - 1, j), t) < t:
                    entry = ("F", c, j)
                    done_f[(sv, j)] = t
                    fi[r] += 1
            row.append(entry)
        table.append(row)
        t += 1
        if t > 6 * (v * M + P_):
            raise RuntimeError("forward table made no progress")
    return table


def _max_overlap(intervals):
    """Peak count of integer-time intervals [a, b] simultaneously alive."""
    events = []
    for a, b in intervals:
        if b >= a:
            events.append((a, 1))
            events.append((b + 1, -1))
    events.sort()
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    return peak


def _ring_depths(table, P_, M, v):
    """Per-(rank, chunk) peak counts for this exact table: (act, pend_f,
    pend_b, wgrad-stash) — stored stage inputs (F..B), inbound activations
    (upstream F..own F), inbound cotangents (downstream B..own B) and
    pending wgrads (B..W)."""
    S = v * P_
    tf, tb, tw = {}, {}, {}
    for t, row in enumerate(table):
        for r, (op, c, j) in enumerate(row):
            sv = c * P_ + r
            if op == "F":
                tf[(sv, j)] = t
            elif op == "B":
                tb[(sv, j)] = t
            elif op == "W":
                tw[(sv, j)] = t
    da = df = db = dw = 1
    for sv in range(S):
        if tb:
            da = max(da, _max_overlap(
                [(tf[(sv, j)], tb[(sv, j)] - 1) for j in range(M)]))
        if sv > 0:
            df = max(df, _max_overlap(
                [(tf[(sv - 1, j)], tf[(sv, j)] - 1) for j in range(M)]))
        if tb and sv < S - 1:
            db = max(db, _max_overlap(
                [(tb[(sv + 1, j)], tb[(sv, j)] - 1) for j in range(M)]))
        if tw:
            dw = max(dw, _max_overlap(
                [(tb[(sv, j)], tw[(sv, j)] - 1) for j in range(M)]))
    return da, df, db, dw


class _TableSchedule(PipelineSchedule):
    """The table-driven schedules (interleaved 1F1B, zero-bubble):
    subclasses give the full (op, chunk, mb) table."""

    def _full_table(self, n_stages, n_microbatches):
        raise NotImplementedError

    def full_table(self, n_stages, n_microbatches):
        return self._full_table(n_stages, n_microbatches)

    def tick_table(self, n_stages, n_microbatches):
        # (op, chunk*M + mb): unique work-item ids so ``simulate`` counts
        # chunk activations (F adds, B frees — W keeps only a param-shaped
        # stash, not an activation)
        M = n_microbatches
        return [[(op, c * M + j) if op != "idle" else ("idle", -1)
                 for (op, c, j) in row]
                for row in self._full_table(n_stages, n_microbatches)]


class InterleavedOneFOneBSchedule(_TableSchedule):
    """Interleaved 1F1B (Megatron virtual stages): each pipe rank holds
    ``v`` non-contiguous chunks of the layer stack (virtual stage
    ``c*P + r`` on rank r) — bubble (P-1)/(vM+P-1) at v times the p2p
    volume and a deeper warmup window of chunk activations."""

    def __init__(self, v: int):
        if v < 2:
            raise ValueError("interleaved 1f1b needs v >= 2 virtual "
                             f"stages per rank (got {v})")
        self.v = v
        self.name = f"1f1b_i{v}"

    def _full_table(self, n_stages, n_microbatches):
        return _interleaved_full_table(n_stages, n_microbatches, self.v)


class ZeroBubbleSchedule(_TableSchedule):
    """Zero-bubble 1F1B (ZB-H1 with a bounded wgrad backlog): dgrad ('B')
    and wgrad ('W') sub-ticks; deferred wgrads fill the drain for a
    2(P-1)/(3M+2P-2) bubble at 1f1b's min(M, P) activation footprint."""

    name = "zb"

    def _full_table(self, n_stages, n_microbatches):
        return _zb_full_table(n_stages, n_microbatches)


SCHEDULES: Dict[str, PipelineSchedule] = {
    "gpipe": GPipeSchedule(),
    "1f1b": OneFOneBSchedule(),
    "1f1b_i2": InterleavedOneFOneBSchedule(2),
    "zb": ZeroBubbleSchedule(),
}


def get_schedule(name: str) -> PipelineSchedule:
    try:
        return SCHEDULES[name]
    except KeyError:
        pass
    family, v = parse_schedule(name)       # raises for unknown names
    assert family == "1f1b_i", name        # base names are all registered
    return InterleavedOneFOneBSchedule(v)


def op_tick_counts(sched: str, n_stages: int,
                   n_microbatches: int) -> Dict[str, int]:
    """Sub-tick census of the schedule's table, summed over ranks:
    forward / dgrad ('B') / wgrad ('W') / idle op counts plus the total
    tick count."""
    table = get_schedule(sched).tick_table(n_stages, n_microbatches)
    out = {"F": 0, "B": 0, "W": 0, "idle": 0}
    for row in table:
        for op, _ in row:
            out[op] += 1
    out["ticks"] = len(table)
    return out


def full_table(sched: str, n_stages: int, n_microbatches: int):
    """[tick][rank] -> (op, chunk, microbatch) of the named schedule."""
    return get_schedule(sched).full_table(n_stages, n_microbatches)


def rank_ops(sched: str, n_stages: int, n_microbatches: int,
             rank: int) -> List[Tuple[str, int, int]]:
    """The ops rank ``rank`` runs, in order (its table column, idle ticks
    left out)."""
    return [row[rank] for row in full_table(sched, n_stages, n_microbatches)
            if row[rank][0] != "idle"]


def peak_held(sched: str, n_stages: int, n_microbatches: int,
              rank: int) -> int:
    """Most microbatch graphs (F done, B not yet) rank ``rank`` holds at
    once under the named table."""
    held = peak = 0
    for op, _, _ in rank_ops(sched, n_stages, n_microbatches, rank):
        held += {"F": 1, "B": -1}.get(op, 0)
        peak = max(peak, held)
    return peak


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def stage_layers(n_layers: int, n_stages: int, v: int,
                 rank: int) -> List[List[int]]:
    """The layer ids of each of rank ``rank``'s v chunks: chunk c holds
    virtual stage ``c P + rank``, the contiguous layers [sv n, (sv+1) n)
    with n = L / (P v) (under v = 1, rank r's [r L/P, (r+1) L/P))."""
    if n_layers % (n_stages * v):
        raise ValueError(f"{n_layers} layers do not split into pipe="
                         f"{n_stages} x v={v} virtual-stage chunks")
    n = n_layers // (n_stages * v)
    return [list(range((c * n_stages + rank) * n,
                       (c * n_stages + rank + 1) * n)) for c in range(v)]


def keep_stage_layers(params, cfg, plan) -> None:
    """Drop from ``params`` (a ``Params`` module) every layer this rank's
    pipe coordinate does not own: each becomes an empty ``Layer``, so the
    kept layers keep their names (``layers.<i>``).  The embedding, final
    norm and LM head stay on every rank."""
    from repro_torch.models.transformer import Layer
    rank = plan.mesh.get_local_rank(plan.pipe)
    mine = {i for chunk in stage_layers(cfg.n_layers, plan.pipe_size,
                                        virtual_stages(plan.pipe_sched),
                                        rank) for i in chunk}
    for i in range(len(params.layers)):
        if i not in mine:
            params.layers[i] = Layer({})


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScheduleRun:
    """What one rank's run of a table did: the ops in the order run,
    the most microbatch graphs held at once, the summed loss shares
    of the microbatches whose last virtual stage it ran (0 elsewhere), and
    its chunks' aux losses summed over the microbatches over M."""
    ops: List[Tuple[str, int, int]]
    peak_held: int
    nll: torch.Tensor
    aux: torch.Tensor


def boundary_dtype(cfg, rt) -> torch.dtype:
    """The residual stream's dtype between stages: ``compute_dtype``; an
    RWKV-6 stack's promotes to f32 (its time mix multiplies by f32
    mixes, as the JAX package's does)."""
    if cfg.mixer == "rwkv6":
        return torch.promote_types(rt.compute_dtype, torch.float32)
    return rt.compute_dtype


class _Transport:
    """Point-to-point over the pipe group, one exchange per tick.  With
    ``via_host`` tensors cross through host memory (a gloo pipe group
    between ranks on cards); otherwise they go as they are."""

    def __init__(self, rt, device):
        self.group, self.rank, self.P = rt.pipe_group, rt.pipe_rank, \
            rt.pipe_size
        self.via_host, self.device = rt.pipe_via_host, device

    def peer(self, offset: int) -> int:
        return dist.get_global_rank(self.group, (self.rank + offset) % self.P)

    def exchange(self, sends, recvs):
        """sends: [(tensor, offset)]; recvs: [(shape, dtype, offset)] ->
        the received tensors, on the device."""
        if not sends and not recvs:
            return []
        where = "cpu" if self.via_host else self.device
        bufs = [torch.empty(shape, dtype=dtype, device=where)
                for shape, dtype, _ in recvs]
        ops = [dist.P2POp(dist.isend, (t.cpu() if self.via_host
                                       else t.contiguous()),
                          self.peer(off), self.group) for t, off in sends]
        ops += [dist.P2POp(dist.irecv, b, self.peer(off), self.group)
                for b, (_, _, off) in zip(bufs, recvs)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [b.to(self.device) for b in bufs]


def pipe_all_reduce(x: torch.Tensor, rt) -> torch.Tensor:
    """Sum ``x`` over the pipe group in place (through host memory under
    ``rt.pipe_via_host``)."""
    if rt.pipe_via_host:
        host = x.cpu()
        dist.all_reduce(host, group=rt.pipe_group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=rt.pipe_group)
    return x


def run_schedule(cfg, params, micros, rt, denom) -> ScheduleRun:
    """Run this pipe rank's row of ``rt.pipe_schedule``'s table over the
    microbatches ``micros`` (this rank's rows of each: {'tokens' or
    'embeds', 'labels'}), forward and backward: gradients land in ``params``
    (FSDP2 reduces them over the data axes after each backward).  Every
    last-stage microbatch adds its masked nll sum over ``denom`` (the
    global count of labels over the data ranks) -> a ``ScheduleRun``."""
    from repro_torch.models.layers import context_parallel, sequence_parallel
    from repro_torch.models.transformer import Stage
    P, r, M = rt.pipe_size, rt.pipe_rank, len(micros)
    v = virtual_stages(rt.pipe_schedule)
    S_v = P * v
    table = full_table(rt.pipe_schedule, P, M)
    chunks = stage_layers(cfg.n_layers, P, v, r)
    device = params.device
    net = _Transport(rt, device)
    B, S = micros[0]["labels"].shape
    S_loc = (S // rt.tp_size if sequence_parallel(rt, S)
             or context_parallel(rt, S) else S)
    act = ((B, S_loc, cfg.d_model), boundary_dtype(cfg, rt))
    inbox: Dict[Tuple[str, int, int], torch.Tensor] = {}
    held: Dict[Tuple[int, int], Tuple] = {}
    ops, peak = [], 0
    nll = torch.zeros((), dtype=torch.float32, device=device)
    aux_sum = torch.zeros((), dtype=torch.float32, device=device)
    for row in table:
        op, c, j = row[r]
        sends = []
        if op == "F":
            sv = c * P + r
            h = None
            if sv > 0:
                h = inbox.pop(("F", sv, j)).requires_grad_()
            out, aux = params(cfg, micros[j], rt, h=h, stage=Stage(
                tuple(chunks[c]), sv == 0, sv == S_v - 1, denom))
            aux = aux / M
            held[c, j] = (h, out, aux)
            peak = max(peak, len(held))
            aux_sum = aux_sum + aux.detach()
            if sv == S_v - 1:
                nll = nll + out.detach()
            else:
                sends.append((out.detach(), 1))
        elif op == "B":
            sv = c * P + r
            h, out, aux = held.pop((c, j))
            roots = [out]
            cots = [None] if sv == S_v - 1 else [inbox.pop(("B", sv, j))]
            if aux.requires_grad:
                roots.append(aux)
                cots.append(None)
            torch.autograd.backward(roots, cots)
            if sv > 0:
                sends.append((h.grad, -1))
        if op != "idle":
            ops.append((op, c, j))
        # what the neighbours' ops of this tick send here
        recvs, keys = [], []
        lop, lc, lj = row[(r - 1) % P]
        if lop == "F" and lc * P + (r - 1) % P < S_v - 1:
            recvs.append((*act, -1))
            keys.append(("F", lc * P + (r - 1) % P + 1, lj))
        rop, rc, rj = row[(r + 1) % P]
        if rop == "B" and rc * P + (r + 1) % P > 0:
            recvs.append((*act, 1))
            keys.append(("B", rc * P + (r + 1) % P - 1, rj))
        for key, got in zip(keys, net.exchange(sends, recvs), strict=True):
            inbox[key] = got
    if held or inbox:
        raise RuntimeError(f"pipeline rank {r} ended {rt.pipe_schedule} "
                           f"with {len(held)} graphs and {len(inbox)} "
                           "messages left")
    return ScheduleRun(ops, peak, nll, aux_sum)


# ---------------------------------------------------------------------------
# the measured bubble (copied from the JAX package's measure_bubble_fraction)
# ---------------------------------------------------------------------------

def _wait(out) -> None:
    """Wait for the device work behind ``out`` (the counterpart of
    ``jax.block_until_ready``): a sync of each card a tensor of it lies
    on; host tensors are ready when returned."""
    from torch.utils._pytree import tree_flatten
    for dev in {t.device for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def measure_bubble_fraction(step_for_m: Callable[[int], Callable[[], object]],
                            n_stages: int, microbatches: int,
                            m2: Optional[int] = None,
                            n_iter: int = 3, sched: str = "gpipe") -> dict:
    """Empirically estimate the pipeline bubble from wall time.

    ``step_for_m(M)`` returns a zero-arg callable running the pipelined
    step with M microbatches at *fixed microbatch size* (total batch grows
    with M), so t(M) = t_tick * (M + P - 1) + overhead is linear in M.  A
    two-point fit recovers t_tick, and

        bubble_measured = (P - 1) * t_tick / t(M)

    which equals (P-1)/(M+P-1) up to the constant overhead term — the
    executable counterpart of :func:`bubble_fraction` / the cost model's
    per-schedule bubble charge.

    Schedule generalization: d(total ticks)/dM is v for interleaved
    (t(M) = t_tick*(vM + P - 1)) and 3 for zb (t(M) = t_tick*(3M+2P-2)),
    so the fitted slope is divided by that coefficient before applying
    the schedule's drain numerator ((P-1), or 2(P-1) for zb).  The record
    carries ``virtual_stages`` so downstream artifacts can validate the
    interleaved probe against (P-1)/(vM+P-1).

    On a noisy host the two-point fit can come out non-increasing
    (t(2M) <= t(M)); that is *not* a zero bubble, it is a failed fit —
    the record flags it as ``fit_unreliable`` instead of trusting a
    fabricated 0.0.  A callable whose outputs lie on a card is timed to
    the end of its device work.
    """
    m1 = microbatches
    m2 = m2 or 2 * m1

    def timed(fn):
        _wait(fn())                            # build / warm up
        best = float("inf")
        for _ in range(n_iter):
            t0 = time.perf_counter()
            _wait(fn())
            best = min(best, time.perf_counter() - t0)
        return best

    t1 = timed(step_for_m(m1))
    t2 = timed(step_for_m(m2))
    unreliable = t2 <= t1 or t1 <= 0
    family, v = parse_schedule(sched)
    ticks_per_m = 3 if family == "zb" else v
    drain = 2 * (n_stages - 1) if family == "zb" else n_stages - 1
    t_tick = max((t2 - t1) / (m2 - m1), 0.0) / ticks_per_m
    measured = drain * t_tick / t1 if t1 > 0 else 0.0
    return {
        "pp": n_stages, "microbatches": m1, "sched": sched,
        "virtual_stages": v,
        "t_step_s": t1, "t_step_2m_s": t2, "t_tick_s": t_tick,
        "bubble_predicted": bubble_fraction(n_stages, m1, sched),
        "bubble_measured": measured,
        "fit_unreliable": bool(unreliable),
    }
