"""Serving engine on the port's kernels — the JAX package's
``serve/engine.py``, with two execution paths:

  * **paged / continuous** (single-device attention stacks): requests
    enter through ``submit`` and are drained by ``run_until_drained``;
  * **static batch** (``generate_static``): the whole batch prefilled
    together into dense caches, then one forward per token; for sharded
    plans and recurrent stacks (RWKV-6, Mamba hybrids), which keep dense
    caches, and the numerical baseline the paged path's greedy tokens
    must equal.

``generate`` routes through the request queue where the paged path applies
and through ``generate_static`` otherwise.

Paged path: requests enter through ``submit`` and are drained by
``run_until_drained``.  Prefill is *chunked* (one chunk per prefilling
request per tick) into the shared per-layer block pools via per-request
block tables (``serve/paged_cache.py``).  Decode runs as a *segment* of
``steps_per_tick`` steps whose token selection (greedy, or sampled where
temperature > 0) stays on the device: the host queues the whole segment
and waits once, when it reads the segment's tokens.  The
``serve/scheduler.py`` tick model lets requests join and leave the running
batch at segment boundaries.

Sampling contract: the token sampled at absolute position ``p`` of a
request on sampling stream ``s`` (= its request id unless pinned at
``submit``; ``generate`` pins the batch row index) is
``argmax(logits / T + g)`` with Gumbel noise ``g`` drawn from a
``torch.Generator`` seeded from ``(base seed, s, p)`` — independent of batch
composition, tick boundaries and chunk sizes.  The base seed is the
explicit ``seed=`` argument when given, else derived from
``ServeEngine.seed`` and a per-call counter.  The JAX package keys the same
draw with ``fold_in(fold_in(key, s), p)``, whose bits torch cannot
reproduce: the two packages agree on greedy decoding, not on samples.
``generate_static`` samples by the same contract (stream = row index).

Static path: the chosen tokens stay on the device from step to step; the
host reads them once, at the end.  Under a ``plan`` (``core.parallel``)
every rank runs ``generate_static`` on the same prompts: it serves its
rows (``serve_rows``) from its shards of the caches, gathers the logits'
vocabulary columns over the model axis to choose each token, and the rows
over the data axes at the end.

``make_serve_step`` and ``make_prefill`` are the functions the dry run
traces for the decode and prefill shapes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import telemetry as tel
from repro_torch.configs.base import ModelConfig
from repro_torch.core import parallel as par
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Runtime, head_parallel
from repro_torch.serve.paged_cache import BlockAllocator, init_paged_pools
from repro_torch.serve.scheduler import Scheduler

# position of slots that must not write this step: the block lookup lands
# past every table and the write goes to the pools' sink block
_INACTIVE_POS = 1 << 30


def make_serve_step(cfg: ModelConfig, rt: Runtime):
    """(params, cache, tokens, pos) -> (logits, cache): one new token per
    row against its dense caches (``transformer.decode_step``)."""
    def serve_step(params, cache, tokens, pos):
        return tfm.decode_step(cfg, params, cache, tokens, pos, rt)
    return serve_step


def make_prefill(cfg: ModelConfig, rt: Runtime, max_len: int, plan=None):
    """(params, batch) -> (logits, cache): the prompts through the model
    into fresh dense caches for ``max_len`` positions
    (``transformer.prefill``; under ``plan``, this rank's rows and
    shards)."""
    def prefill_fn(params, batch):
        return tfm.prefill(cfg, params, batch, rt, max_len, plan)
    return prefill_fn


def token_seed(base_seed: int, stream: int, pos: int) -> int:
    """Generator seed of the token at position ``pos`` on ``stream``."""
    ss = np.random.SeedSequence([base_seed, stream, pos])
    return int(ss.generate_state(1, np.uint64)[0])


def sample_token(lg, temperature: float, seed: int):
    """lg (V,) f32 -> 0-d index tensor on lg's device:
    argmax(lg / T + Gumbel noise from a generator seeded with ``seed``)."""
    gen = torch.Generator(device=lg.device)
    gen.manual_seed(seed)
    u = torch.rand(lg.shape, generator=gen, device=lg.device)
    return torch.argmax(lg / max(temperature, 1e-6) - torch.log(-torch.log(u)))


@dataclasses.dataclass
class ServeEngine:
    """Batched generation over the port's model on ``device``.

    ``n_slots`` bounds the in-flight batch; ``block_size`` is the paged-
    cache granularity; ``n_blocks=0`` sizes the pool so every slot can
    hold ``max_len`` context.  ``prefill_chunk`` / ``steps_per_tick`` set
    the tick shape (one prefill chunk per prefilling request and one
    decode segment per tick).  ``plan``: a ``core.parallel.ParallelPlan``
    the params were placed by (``apply_plan``); it serves statically.
    ``stats`` counts forward calls and decode steps, so a caller can hold
    kernel launch counts against them.
    """
    cfg: ModelConfig
    params: Any
    rt: Runtime
    max_len: int
    plan: Any = None
    seed: int = 0
    n_slots: int = 8
    block_size: int = 16
    n_blocks: int = 0
    prefill_chunk: int = 32
    steps_per_tick: int = 8
    telemetry: tel.Recorder = tel.NULL
    clock: Callable[[], float] = time.monotonic
    device: Any = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if self.params.device != dev:
            raise ValueError(f"params live on {self.params.device}, the "
                             f"engine runs on {dev}")
        self.device = dev
        self._calls = 0
        self.stats = {"forward_calls": 0, "decode_steps": 0}
        cfg = self.cfg
        self.paged_ok = (
            self.plan is None and cfg.input_mode == "tokens" and
            all(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers)))
        self._prefill = make_prefill(cfg, self.rt, self.max_len, self.plan)
        self._step = make_serve_step(cfg, self.rt)
        self._pools = None
        if self.paged_ok:
            self._max_blocks = BlockAllocator(1, self.block_size).blocks_for(
                self.max_len + self.prefill_chunk + 1)
            if not self.n_blocks:
                self.n_blocks = self.n_slots * self._max_blocks
            self._reset_queue()

    # ------------------------------------------------------------------
    # request-queue API (paged continuous batching)
    # ------------------------------------------------------------------

    def _reset_queue(self):
        self._sched = Scheduler(
            self.n_slots, BlockAllocator(self.n_blocks, self.block_size),
            prefill_chunk=self.prefill_chunk,
            steps_per_tick=self.steps_per_tick,
            clock=self.clock, telemetry=self.telemetry)
        if self._pools is None:
            self._pools = init_paged_pools(
                self.cfg, self.n_blocks, self.block_size,
                self.rt.compute_dtype, self.device)
        self._tbl = np.full((self.n_slots, self._max_blocks), -1, np.int32)
        self._ctx = np.zeros((self.n_slots,), np.int32)
        self._last = np.zeros((self.n_slots,), np.int32)
        self._temps = np.zeros((self.n_slots,), np.float32)
        self._streams = np.zeros((self.n_slots,), np.int32)

    def submit(self, prompt, n_new: int, temperature: float = 0.0,
               stream: Optional[int] = None, ttl_s: float = 0.0) -> int:
        """Enqueue one request; returns its request id.  ``stream``
        selects the sampling stream (see module docstring); it defaults
        to the request id.  ``ttl_s`` > 0 sets a deadline after which the
        request is retired with finish_reason='timeout' (partial output
        kept, KV blocks freed) whether it is waiting or mid-generation."""
        if not self.paged_ok:
            raise RuntimeError(
                "request-queue serving needs the paged cache path "
                "(attention-only stack, token inputs)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] + n_new > self.max_len:
            raise ValueError(
                f"prompt({prompt.shape[0]}) + n_new({n_new}) exceeds "
                f"max_len({self.max_len})")
        return self._sched.submit(prompt, n_new, temperature, stream=stream,
                                  ttl_s=ttl_s)

    def cancel(self, rid: int) -> bool:
        """Cancel one request (waiting or running).  Frees its seat and
        KV blocks; partial output stays available under finish_reason
        'cancelled'.  Returns False for unknown/finished rids."""
        out = self._sched.cancel(rid)
        if out is None:
            return False
        slot, _ = out
        if slot >= 0:
            self._tbl[slot] = -1
        return True

    def _base_seed(self, seed=None) -> int:
        if seed is not None:
            return int(seed)
        ss = np.random.SeedSequence([self.seed, self._calls])
        self._calls += 1
        return int(ss.generate_state(1, np.uint32)[0])

    @torch.no_grad()
    def run_until_drained(self, seed=None) -> Dict[int, np.ndarray]:
        """Tick until every submitted request completed; returns
        {rid: generated tokens (n_new,)}."""
        base_seed = self._base_seed(seed)
        sched = self._sched
        while sched.has_work():
            self._tick(base_seed)
        out = {r.rid: np.asarray(r.generated, np.int32)
               for r in sched.finished.values()}
        sched.finished.clear()
        return out

    def _tick(self, base_seed):
        sched = self._sched
        with self.telemetry.span("serve/tick"):
            # expire first: a timed-out running request frees its seat
            # before admission, and a timed-out waiting request stops
            # blocking the queue head this same tick
            for slot, _ in sched.expire():
                if slot >= 0:
                    self._tbl[slot] = -1
            admitted = sched.admit()
            for req in admitted:
                # lay the reserved block chain into the slot's table row
                self._tbl[req.slot] = -1
                self._tbl[req.slot, :len(req.blocks)] = req.blocks
                self._ctx[req.slot] = 0
                self._temps[req.slot] = req.temperature
                self._streams[req.slot] = req.stream
            prefills = sched.prefill_candidates()
            for req in prefills:
                self._do_prefill_chunk(base_seed, req)
            active = sched.decode_slots()
            if active:
                self._do_decode_segment(base_seed, active)
            for req in list(sched.running.values()):
                if req.prefill_done and req.remaining <= 0:
                    self._tbl[req.slot] = -1
                    sched.complete(req)
            self.telemetry.gauge("serve/batch_occupancy",
                                 len(sched.running) / self.n_slots)
            self.telemetry.gauge(
                "serve/block_util",
                1.0 - sched.alloc.n_free / max(self.n_blocks, 1))
        if not (admitted or prefills or active) and sched.waiting \
                and not sched.running:
            raise RuntimeError(
                "scheduler stalled: waiting requests cannot be admitted "
                f"(pool of {self.n_blocks} blocks too small?)")

    def _cache(self, tbl, ctx):
        return {"layers": self._pools["layers"],
                "paged": {"tbl": tbl, "ctx": ctx}}

    def _do_prefill_chunk(self, base_seed, req):
        """One prompt chunk (1, C) of one slot through the model, writing
        its KV into the slot's block chain."""
        C = self.prefill_chunk
        start = req.prefilled
        chunk = req.prompt[start:start + C]
        real = int(chunk.shape[0])
        if real < C:
            chunk = np.pad(chunk, (0, C - real))
        t0 = self.clock()
        dev = self.device
        with self.telemetry.span("serve/prefill_chunk", rid=req.rid,
                                 start=start, n=real):
            ctx0 = torch.tensor([start], dtype=torch.int32, device=dev)
            tbl = torch.as_tensor(self._tbl[req.slot:req.slot + 1],
                                  device=dev)
            logits = tfm.forward(
                self.cfg, self.params,
                {"tokens": torch.as_tensor(chunk[None], device=dev),
                 "pos": ctx0[:, None]},
                self.rt, self._cache(tbl, ctx0))
            self.stats["forward_calls"] += 1
            req.prefilled = start + real
            self._ctx[req.slot] = req.prefilled
            if req.prefill_done and req.remaining > 0:
                # the last real prompt token's logits give the first
                # sampled token, at absolute position prompt_len
                lg = logits[0, real - 1].float()
                if req.temperature > 0:
                    tok = sample_token(lg, req.temperature, token_seed(
                        base_seed, req.stream, req.prompt_len))
                else:
                    tok = torch.argmax(lg)
                tok = int(tok)
                req.generated.append(tok)
                self._last[req.slot] = tok
                req.t_first_token = self.clock()
                if req.t_submit:
                    self.telemetry.observe(
                        "serve/ttft_s", req.t_first_token - req.t_submit)
        self.telemetry.observe("serve/prefill_chunk_s", self.clock() - t0)

    def _observe_token_latency(self, wall: float, n_tokens: int) -> None:
        """Per-token latency over a decode segment: the tick's wall time
        amortized across every token it delivered (each of the n tokens
        experienced the same segment wait)."""
        if n_tokens > 0 and wall >= 0:
            self.telemetry.observe("serve/token_latency_s",
                                   wall / n_tokens, n=n_tokens)

    def _do_decode_segment(self, base_seed, active):
        steps = self.steps_per_tick
        n, mb = self.n_slots, self._max_blocks
        remaining = np.zeros((n,), np.int32)
        for req in active:
            remaining[req.slot] = req.remaining
        # rows that sample, with what the host needs to seed each draw
        sampled = [(r.slot, r.stream, float(r.temperature),
                    int(self._ctx[r.slot]), int(remaining[r.slot]))
                   for r in active if r.temperature > 0]
        t0 = self.clock()
        with self.telemetry.span("serve/decode_segment", steps=steps,
                                 n_active=len(active)):
            # one host-to-device copy for the segment's whole state
            state = torch.from_numpy(np.concatenate(
                [self._tbl.reshape(-1), self._ctx, self._last, remaining])
            ).to(self.device)
            tbl = state[:n * mb].view(n, mb)
            ctx, last, rem = state[n * mb:].view(3, n).unbind(0)
            out = torch.zeros((n, steps), dtype=torch.int32,
                              device=self.device)
            for t in range(steps):
                act = rem > 0
                ctx_eff = torch.where(act, ctx, _INACTIVE_POS)
                logits = tfm.forward(
                    self.cfg, self.params,
                    {"tokens": last[:, None], "pos": ctx_eff[:, None]},
                    self.rt, self._cache(tbl, ctx_eff))
                lg = logits[:, 0].float()
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
                for slot, stream, temp, c0, r0 in sampled:
                    if t < r0:      # the host knows the slot is active
                        nxt[slot] = sample_token(lg[slot], temp, token_seed(
                            base_seed, stream, c0 + t + 1))
                nxt = torch.where(act, nxt, 0)
                out[:, t] = nxt
                last = torch.where(act, nxt, last)
                ctx = ctx + act.to(torch.int32)
                rem = rem - act.to(torch.int32)
            self.stats["forward_calls"] += steps
            self.stats["decode_steps"] += steps
            seg_out = out.cpu().numpy()   # the segment's one host sync
        delivered = 0
        for req in active:
            k = min(req.remaining, steps)
            toks = seg_out[req.slot, :k]
            req.generated.extend(int(t) for t in toks)
            self._ctx[req.slot] += k
            delivered += k
            if k:
                self._last[req.slot] = int(toks[-1])
        self._observe_token_latency(self.clock() - t0, delivered)

    # ------------------------------------------------------------------
    # batch entry point
    # ------------------------------------------------------------------

    def generate(self, prompts, n_new: int, temperature: float = 0.0,
                 seed: Optional[int] = None) -> np.ndarray:
        """prompts: (B, S0) int -> (B, S0 + n_new) int32 numpy, through the
        request queue (one request per row, stream = row index) where the
        paged path applies, else through :meth:`generate_static`."""
        prompts_np = np.asarray(prompts, np.int32)
        B, S0 = prompts_np.shape
        if S0 + n_new > self.max_len:
            raise ValueError(f"prompt({S0}) + n_new({n_new}) exceeds "
                             f"max_len({self.max_len})")
        if not self.paged_ok:
            return self.generate_static(prompts_np, n_new, temperature, seed)
        rids = [self.submit(prompts_np[i], n_new, temperature, stream=i)
                for i in range(B)]
        done = self.run_until_drained(seed=seed)
        new = np.stack([done[r] for r in rids]).reshape(B, n_new)
        return np.concatenate([prompts_np, new], axis=1)

    @torch.no_grad()
    def generate_static(self, prompts, n_new: int, temperature: float = 0.0,
                        seed: Optional[int] = None) -> np.ndarray:
        """prompts: (B, S0) int -> (B, S0 + n_new) int32 numpy: the whole
        batch prefilled together into dense caches, then one forward per
        new token but the last.  The token at absolute position p of row b
        is greedy, or sampled as the paged path samples it (stream b).
        Under a plan every rank calls it with the same prompts and gets
        every row back."""
        prompts_np = np.asarray(prompts, np.int32)
        B, S0 = prompts_np.shape
        if S0 + n_new > self.max_len:
            raise ValueError(f"prompt({S0}) + n_new({n_new}) exceeds "
                             f"max_len({self.max_len})")
        base_seed = self._base_seed(seed)
        lo, hi = (0, B) if self.plan is None else \
            par.serve_rows(self.plan, B)
        dev = self.device
        out = torch.zeros((hi - lo, n_new), dtype=torch.int32, device=dev)
        with self.telemetry.span("serve/static_prefill", rows=B, n=S0):
            logits, cache = self._prefill(
                self.params, {"tokens": torch.as_tensor(prompts_np,
                                                        device=dev)})
            self.stats["forward_calls"] += 1
            tok = self._choose(logits[:, -1], temperature, base_seed, lo,
                               S0)
        pos = torch.tensor(S0, dtype=torch.int32, device=dev)
        with self.telemetry.span("serve/static_decode", steps=n_new - 1):
            for t in range(n_new):
                out[:, t] = tok
                if t + 1 == n_new:
                    break
                logits, cache = self._step(self.params, cache, tok[:, None],
                                           pos)
                pos += 1
                tok = self._choose(logits[:, 0], temperature, base_seed, lo,
                                   S0 + t + 1)
            self.stats["forward_calls"] += n_new - 1
            self.stats["decode_steps"] += n_new - 1
        if self.plan is not None:
            out = self._gather_rows(out, B)
        return np.concatenate([prompts_np, out.cpu().numpy()], axis=1)

    def _whole_logits(self, lg):
        """(B, V / tp) logits of this rank's vocabulary columns -> (B, V)
        f32, gathered over the model axis."""
        lg = lg.float()
        if not head_parallel(self.rt):
            return lg
        parts = lg.new_empty((self.rt.tp_size * lg.shape[0], lg.shape[1]))
        dist.all_gather_into_tensor(parts, lg.contiguous(),
                                    group=self.rt.tp_group)
        return parts.view(self.rt.tp_size, *lg.shape).permute(1, 0, 2) \
            .reshape(lg.shape[0], -1)

    def _choose(self, lg, temperature, base_seed, row0, pos):
        """(B, V / tp) logits of the rows from ``row0`` -> their tokens at
        absolute position ``pos``, int32 on the device (the vocabulary
        gathered over the model axis first)."""
        lg = self._whole_logits(lg)
        if temperature <= 0:
            return torch.argmax(lg, dim=-1).to(torch.int32)
        return torch.stack([
            sample_token(lg[b], temperature,
                         token_seed(base_seed, row0 + b, pos))
            for b in range(lg.shape[0])]).to(torch.int32)

    def _gather_rows(self, out, B):
        """Every rank's rows (B / n, n_new) -> all B rows, gathered over the
        data axes that split them, innermost first (row order is the
        row-major order of those axes)."""
        for axis in reversed(par.row_axes(self.plan, B)):
            group = self.plan.mesh.get_group(axis)
            if dist.get_world_size(group) == 1:
                continue
            whole = out.new_empty((out.shape[0] * dist.get_world_size(group),)
                                  + tuple(out.shape[1:]))
            dist.all_gather_into_tensor(whole, out.contiguous(), group=group)
            out = whole
        return out
