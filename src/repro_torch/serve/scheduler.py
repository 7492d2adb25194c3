"""Continuous-batching scheduler: admission, chunked prefill, completion.

A copy of the JAX package's ``serve/scheduler.py`` (host-side numpy; the
port never imports that package).

The engine runs in *ticks*.  Each tick the scheduler:

  1. **admits** waiting requests FIFO into free batch slots, reserving
     their full block footprint (padded prompt + new tokens + one step of
     headroom) up front — all-or-nothing reservation means a running
     request can never fail an allocation mid-flight, and strict FIFO
     admission (the head of the queue blocks the tail) means no request
     starves behind later, smaller ones;
  2. advances every admitted request with prompt tokens left by one
     **prefill chunk** (oldest first), so long prompts never monopolize
     a tick yet same-age requests enter decode together instead of
     trickling in one tick apart behind full-cost decode segments; and
  3. reports the set of **decode-active** slots for the engine's
     on-device decode segment.

Completion (token budget exhausted) returns the request's blocks to the
:class:`~repro_torch.serve.paged_cache.BlockAllocator` and frees its slot, so
the next waiting request joins the running batch on the following tick.

Requests can also leave early: a per-request **TTL** (``submit(...,
ttl_s=...)``) expires the request once its deadline passes — whether it
is still waiting or mid-generation — and ``cancel(rid)`` removes one
explicitly.  Both paths free blocks+slot exactly like completion and
record why in ``Request.finish_reason`` ('length' | 'timeout' |
'cancelled'), so a client that stops listening cannot pin KV blocks
forever and a stuck head-of-queue request cannot starve the tail
indefinitely.  Time comes from an injectable ``clock`` (tests pass a
fake; production defaults to ``time.monotonic``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import telemetry as tel
from repro_torch.serve.paged_cache import BlockAllocator


@dataclasses.dataclass
class Request:
    """One generation request and its in-flight state."""
    rid: int
    prompt: np.ndarray                  # (S0,) int32
    n_new: int
    temperature: float = 0.0
    # sampling-stream id: the PRNG key for the token at position p is
    # fold_in(fold_in(base_key, stream), p).  Defaults to rid (every
    # request draws an independent stream); callers wanting reproducible
    # batches across engine lifetimes pin it explicitly.
    stream: int = -1
    # scheduler-owned runtime state
    slot: int = -1                      # batch slot (-1 = not admitted)
    blocks: List[int] = dataclasses.field(default_factory=list)
    prefilled: int = 0                  # prompt tokens written so far
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    deadline: float = 0.0               # absolute clock time; 0 = no TTL
    finish_reason: str = ""             # 'length' | 'timeout' | 'cancelled'
    # lifecycle timestamps on the scheduler clock (0.0 = not reached):
    # queued -> admitted -> first token -> finished
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= self.prompt_len

    @property
    def remaining(self) -> int:
        return self.n_new - len(self.generated)


class Scheduler:
    def __init__(self, n_slots: int, allocator: BlockAllocator,
                 prefill_chunk: int = 32, steps_per_tick: int = 8,
                 clock: Callable[[], float] = time.monotonic,
                 telemetry: tel.Recorder = tel.NULL):
        self.n_slots = n_slots
        self.alloc = allocator
        self.prefill_chunk = prefill_chunk
        self.steps_per_tick = steps_per_tick
        self.clock = clock
        self.telemetry = telemetry
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}       # slot -> request
        self.finished: Dict[int, Request] = {}      # rid -> request
        self._next_rid = 0

    # finish_reason -> lifecycle counter name
    _FINISH_COUNTERS = {"length": "serve/completed",
                        "timeout": "serve/expired",
                        "cancelled": "serve/cancelled"}

    def _finish(self, req: Request, reason: str) -> None:
        """Shared finish bookkeeping: timestamps + lifecycle telemetry."""
        req.done = True
        req.finish_reason = reason
        req.t_finish = self.clock()
        self.finished[req.rid] = req
        self.telemetry.counter(
            self._FINISH_COUNTERS.get(reason, "serve/completed"), 1)
        if req.t_submit:
            self.telemetry.observe("serve/total_latency_s",
                                   req.t_finish - req.t_submit)

    # -- submission / bookkeeping -------------------------------------------

    def submit(self, prompt: np.ndarray, n_new: int,
               temperature: float = 0.0, stream: Optional[int] = None,
               ttl_s: float = 0.0) -> int:
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        self.waiting.append(Request(rid, np.asarray(prompt, np.int32),
                                    n_new, temperature,
                                    stream=rid if stream is None else stream,
                                    deadline=(now + ttl_s
                                              if ttl_s > 0 else 0.0),
                                    t_submit=now))
        self.telemetry.counter("serve/submitted", 1)
        self.telemetry.gauge("serve/queue_depth", len(self.waiting))
        return rid

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def _footprint(self, req: Request) -> int:
        """Blocks reserved at admission: the prompt padded to a whole
        number of prefill chunks (pad tokens of the last chunk write
        beyond the real prompt before being overwritten), the new tokens,
        and one decode step of headroom (an inactive slot in a running
        segment writes one sentinel position past its budget)."""
        chunks = -(-req.prompt_len // self.prefill_chunk)
        return self.alloc.blocks_for(
            chunks * self.prefill_chunk + req.n_new + 1)

    def admit(self) -> List[Request]:
        """FIFO admission into free slots; head-of-line blocking on
        purpose (skipping the head to admit a smaller later request is
        what starves big requests)."""
        admitted = []
        free = sorted(set(range(self.n_slots)) - set(self.running))
        while self.waiting and free:
            req = self.waiting[0]
            blocks = self.alloc.allocate(self._footprint(req))
            if blocks is None:
                break
            req.blocks = blocks
            req.slot = free.pop(0)
            self.running[req.slot] = req
            admitted.append(self.waiting.pop(0))
            req.t_admit = self.clock()
            self.telemetry.counter("serve/admitted", 1)
            self.telemetry.observe("serve/queue_wait_s",
                                   req.t_admit - req.t_submit)
        if admitted:
            self.telemetry.gauge("serve/queue_depth", len(self.waiting))
        return admitted

    # -- per-tick work selection --------------------------------------------

    def prefill_candidates(self) -> List[Request]:
        """Admitted requests with prompt tokens still to write, oldest
        first.  The engine feeds each one chunk per tick: a single long
        prompt still spreads over many ticks (bounded per-tick stall),
        but concurrent prompts prefill in the same tick rather than
        serializing one request per tick."""
        cands = [r for r in self.running.values() if not r.prefill_done]
        return sorted(cands, key=lambda r: r.rid)

    def next_prefill(self) -> Optional[Request]:
        """Oldest admitted request with prompt tokens still to write."""
        cands = self.prefill_candidates()
        return cands[0] if cands else None

    def decode_slots(self) -> List[Request]:
        return [r for r in self.running.values()
                if r.prefill_done and r.remaining > 0]

    def complete(self, req: Request, reason: str = "length") -> None:
        """Request leaving the running set: free blocks and slot."""
        assert req.slot in self.running and self.running[req.slot] is req
        del self.running[req.slot]
        self.alloc.free(req.blocks)
        req.blocks = []
        req.slot = -1
        self._finish(req, reason)

    # -- early exit: TTL expiry and explicit cancellation -------------------

    def _retire_waiting(self, req: Request, reason: str) -> None:
        self.waiting.remove(req)
        self._finish(req, reason)
        self.telemetry.gauge("serve/queue_depth", len(self.waiting))

    def expire(self, now: Optional[float] = None) -> List[Tuple[int, Request]]:
        """Retire every request whose deadline has passed.

        Covers both the running set (blocks + slot freed like completion)
        and the waiting queue — an expired head-of-queue request must not
        keep blocking admission of the tail forever.  Returns
        ``(slot, request)`` pairs — slot is the seat the request *held*
        (-1 if never admitted) so the engine can clear its block-table
        row; the request keeps whatever tokens it generated.
        """
        now = self.clock() if now is None else now
        expired: List[Tuple[int, Request]] = []
        for req in [r for r in self.running.values()
                    if r.deadline and now >= r.deadline]:
            slot = req.slot
            self.complete(req, reason="timeout")
            expired.append((slot, req))
        for req in [r for r in self.waiting
                    if r.deadline and now >= r.deadline]:
            self._retire_waiting(req, "timeout")
            expired.append((-1, req))
        return expired

    def cancel(self, rid: int) -> Optional[Tuple[int, Request]]:
        """Explicitly remove one request, waiting or running.

        Returns ``(slot, request)`` with the seat it held (-1 if it was
        still waiting), or None if the rid is unknown / already finished
        (cancelling a finished request is a no-op, not an error).
        """
        for req in self.running.values():
            if req.rid == rid:
                slot = req.slot
                self.complete(req, reason="cancelled")
                return slot, req
        for req in self.waiting:
            if req.rid == rid:
                self._retire_waiting(req, "cancelled")
                return -1, req
        return None
