"""Training: the train step with gradient accumulation and AdamW, on one
device or data-parallel under a plan, and the loop that logs it — the
port of the JAX package's ``train/trainer.py``.

``make_train_step`` maps (params, opt_state, batch) -> (params, opt_state,
metrics); it updates the parameters and moments in place.  Metrics stay
0-d tensors on the device: reading one waits for the device, so
``train_loop`` reads them only on logging steps.  ``train_loop`` also
checkpoints (sync or async, in the JAX package's layout), resumes from the
newest CRC-valid checkpoint, and takes a ``resilience.FaultPlan``'s
injected crashes, stragglers and checkpoint-I/O errors.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch import checkpointing as ckpt_lib
from repro_torch import telemetry as tel
from repro_torch.configs.base import ModelConfig
from repro_torch.core import parallel as par
from repro_torch.core import pipeline as pipe_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (Runtime, all_reduce,
                                       sequence_parallel, wire_round_grad)
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.strategy.topology import mesh_shape


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    warmup: int = 10
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_dir: str = ""
    grad_accum: int = 1
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    # resilience: async checkpointing + kill/resume (resilience subsystem)
    ckpt_async: bool = False        # snapshot on-thread, write in background
    ckpt_max_in_flight: int = 2     # bounded queued background writes
    ckpt_keep: int = 0              # gc all but the newest N (0 = keep all)
    resume: bool = False            # restore latest *valid* ckpt_dir state


class _DataParallel:
    """This rank's part of a step under ``plan``: which rows of a
    microbatch it takes (those of its coordinate on the data axes; the
    ranks of a model group take the same rows), the sums over the
    data-parallel ranks, and which gradients are summed over the model
    group (``core.parallel.grad_sums_over_model``)."""

    def __init__(self, plan):
        shape = mesh_shape(plan.mesh)
        coord = dict(zip(plan.mesh.mesh_dim_names,
                         plan.mesh.get_coordinate()))
        self.size, self.rank = 1, 0
        for axis in plan.dp:
            self.rank = self.rank * shape[axis] + coord[axis]
            self.size *= shape[axis]
        self.groups = [plan.mesh.get_group(axis) for axis in plan.dp
                       if shape[axis] > 1]
        self.tp = plan.tp

    def rows(self, micro, ntok):
        """-> (this rank's rows of ``micro``, the loss's divisor), given
        the microbatch's count of unmasked labels ``ntok``.

        The rows are the rank's 1/n of the microbatch, and each rank's
        masked nll sum is divided by the global count over n: FSDP2's
        mean of the n ranks' gradients is then the global masked mean's.
        A microbatch whose rows do not split over the ranks is computed
        whole on every rank (as the JAX package leaves a batch dim that
        does not divide unsharded), over the global count.
        """
        n, B = self.size, micro["labels"].shape[0]
        denom = ntok.clamp_min(1.0)
        if B % n:
            return micro, denom
        r, b = self.rank, B // n
        return {k: v[r * b:(r + 1) * b] for k, v in micro.items()}, denom / n

    def mean(self, values: torch.Tensor) -> torch.Tensor:
        """The mean over the data-parallel ranks of each rank's
        ``values`` (the ranks of a model group hold the same)."""
        for group in self.groups:
            dist.all_reduce(values, group=group)
        return values / self.size

    def sum_over_model(self, named, rt: Runtime, seq_parallel: bool):
        """Sum over the model group, in place and in one all-reduce, the
        local gradients of ``named`` ({name: parameter}) that are a part
        of their whole on each model rank."""
        if rt.tp_size == 1:
            return
        grads = [p.grad.to_local() for n, p in named.items()
                 if p.grad is not None and par.grad_sums_over_model(
                     n, p.placements[p.device_mesh.mesh_dim_names.index(
                         self.tp)], seq_parallel)]
        if not grads:
            return
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), rt)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def make_train_step(cfg: ModelConfig, rt: Runtime, tc: TrainConfig,
                    plan=None):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {'loss', 'nll', 'aux', 'ntok', 'grad_norm', 'lr'}).

    With ``grad_accum`` > 1 the batch splits into that many microbatches
    along dim 0; their gradients are summed in ``rt.grad_dtype`` and
    divided by the count, ``ntok`` is summed and every other metric
    averaged.  The lr scale is read from the step count before the update.

    Under a ``plan`` (``params`` wrapped by ``core.parallel.apply_plan``)
    every rank gets the same global batch; of each microbatch a rank takes
    its data-parallel 1/n of the rows (``_DataParallel.rows``), and FSDP2
    reduces the gradients over the data axes after every microbatch's
    backward; then the replicated parameters whose gradient is partial on
    each model rank are summed over the model group.  The metrics are the
    global ones: loss, nll and aux averaged over the data-parallel ranks,
    ntok counted over the global batch, grad_norm over every shard.  With a wire dtype
    (``rt.gather_dtype``, the fp8 policy) each microbatch's gradients of
    the layers' parameters are rounded through it once they are reduced
    (``wire_round_grad``), as the JAX package's casts round the summed
    cotangent.

    Under a plan with a ``pipe`` axis (``rt.pipe_size`` > 1) each
    grad-accumulation microbatch splits again into ``rt.pipe_microbatches``
    pipeline microbatches, of which a rank takes its data-parallel rows,
    and this pipe rank runs its row of the schedule's table over them
    (``core.pipeline.run_schedule``): each last-stage microbatch adds its
    masked nll sum over the grad-accumulation microbatch's global count of
    labels.  After the step the gradients of the leaves every pipe rank
    holds (embedding, final norm, LM head) are summed over the pipe group,
    which keeps their replicas and moments equal; the loss is summed over
    it too (only the last stage's is not 0), so every pipe rank reports
    it, and the gradient norm adds the layers' squares over it.  The last
    step's ``ScheduleRun`` is ``train_step.last_run``."""
    ga = max(tc.grad_accum, 1)
    dp = _DataParallel(plan) if plan is not None else None
    pipelined = rt.pipe_size > 1

    def train_step(params, opt_state, batch):
        B, S = batch["labels"].shape
        if B % ga:
            raise ValueError(f"batch {B} does not split into "
                             f"grad_accum={tc.grad_accum}")
        if pipelined and (B // ga) % rt.pipe_microbatches:
            raise ValueError(
                f"batch {B} / grad_accum {tc.grad_accum} does not split "
                f"into {rt.pipe_microbatches} pipeline microbatches")
        named = dict(params.named_parameters())
        # the layers' parameters, which a wire dtype rounds
        wired = ({f"layers.{n}" for n, _ in params.layers.named_parameters()}
                 if rt.gather_dtype is not None else ())
        for p in named.values():
            p.grad = None
        mb = B // ga
        loss_sum, msum = None, None
        grads: Dict[str, torch.Tensor] = {}
        for i in range(ga):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            denom, ntok = None, None
            if pipelined:
                loss, metrics = _pipelined(params, micro, dp)
            else:
                if dp is not None:
                    ntok = (micro["labels"] >= 0).sum().float()
                    micro, denom = dp.rows(micro, ntok)
                loss, metrics = tfm.loss_fn(cfg, params, micro, rt, denom)
                loss.backward()
            if dp is not None:
                dp.sum_over_model(named, rt, sequence_parallel(rt, S))
            loss, metrics = loss.detach(), {k: v.detach()
                                            for k, v in metrics.items()}
            if ntok is not None:
                metrics["ntok"] = ntok
            if loss_sum is None:
                loss_sum, msum = loss, metrics
            else:
                loss_sum = loss_sum + loss
                msum = {k: msum[k] + metrics[k] for k in msum}
            # accumulate in rt.grad_dtype, as the JAX step casts its first
            # microbatch's gradients
            for n, p in named.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if n in wired:
                    g = wire_round_grad(g, rt)
                g = g.to(rt.grad_dtype)
                grads[n] = g if i == 0 else grads[n].add_(g)
                p.grad = None
        if ga > 1:
            for g in grads.values():
                g.div_(ga)
        if pipelined:
            _sum_replicated_over_pipe(grads)
        lr_scale = linear_warmup_cosine(opt_state["step"], tc.warmup,
                                        tc.steps)
        params, opt_state, opt_metrics = adamw_update(
            tc.opt, params, grads, opt_state, lr_scale,
            pipe_rt=rt if pipelined else None)
        out = {"loss": loss_sum / ga,
               **{k: v if k == "ntok" else v / ga for k, v in msum.items()},
               **opt_metrics}
        keys = ("loss", "nll", "aux")
        if pipelined:
            sums = pipe_lib.pipe_all_reduce(
                torch.stack([out[k] for k in keys]), rt)
            out.update(zip(keys, sums.unbind()))
        if dp is not None:
            means = dp.mean(torch.stack([out[k] for k in keys]))
            out.update(zip(keys, means.unbind()))
        return params, opt_state, out

    def _pipelined(params, micro, dp):
        """One grad-accumulation microbatch through the pipeline ->
        (this rank's loss share, {'nll', 'aux', 'ntok'})."""
        ntok = (micro["labels"] >= 0).sum().float()
        n = micro["labels"].shape[0] // rt.pipe_microbatches
        micros, denom = [], ntok.clamp_min(1.0)
        for j in range(rt.pipe_microbatches):
            pm = {k: v[j * n:(j + 1) * n] for k, v in micro.items()}
            if dp is not None:
                pm, denom = dp.rows(pm, ntok)
            micros.append(pm)
        run = pipe_lib.run_schedule(cfg, params, micros, rt, denom)
        train_step.last_run = run
        aux = torch.zeros_like(run.nll)
        return run.nll + aux, {"nll": run.nll, "aux": aux, "ntok": ntok}

    def _sum_replicated_over_pipe(grads):
        """Sum over the pipe group, in one all-reduce, the local
        gradients of the leaves every pipe rank holds: each rank's is its
        stages' part (the lookup at the first, the head and final norm
        at the last, 0 elsewhere)."""
        mine = [g.to_local() for n, g in grads.items()
                if not n.startswith("layers.")]
        flat = pipe_lib.pipe_all_reduce(
            torch.cat([g.reshape(-1) for g in mine]), rt)
        for g, part in zip(mine, flat.split([g.numel() for g in mine])):
            g.copy_(part.view_as(g))

    train_step.last_run = None
    return train_step


def batch_to_device(batch, device: torch.device):
    """numpy batch -> tensors on ``device``.  To a card the copy goes from
    pinned memory without blocking, so the host does not wait for the
    device here."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = (t.pin_memory().to(device, non_blocking=True)
                  if device.type == "cuda" else t.to(device))
    return out


def prng_key_data(seed: int) -> list:
    """The key data of the JAX package's ``jax.random.PRNGKey(seed)``
    (threefry: the seed's high and low 32 bits), which a checkpoint's
    ``meta["prng"]`` holds so that a JAX run resumes from it."""
    return [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF]


def _from_first_rank(compute: Callable[[], Any], plan=None) -> Any:
    """``compute()`` on the rank at the origin of ``plan``'s mesh (global
    rank 0; the only one when there is no mesh), its value broadcast to
    every rank of the mesh along each mesh dimension in turn, so ranks
    outside a smaller mesh take no part.  What rank 0 decides about the
    shared checkpoint directory, every rank then acts on."""
    mesh = None if plan is None or not dist.is_initialized() else plan.mesh
    first = mesh is None or not any(mesh.get_coordinate())
    box = [compute() if first else None]
    for d in range(mesh.ndim if mesh is not None else 0):
        if mesh.size(d) > 1:
            group = mesh.get_group(d)
            dist.broadcast_object_list(
                box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def _agree_on_error(err: Optional[BaseException], plan) -> None:
    """Raise on every rank of the mesh what failed on the writer (rank 0):
    its own exception there (any: a full disk's ``OSError`` too), a
    ``CheckpointIOError`` (retried) or ``CheckpointError`` of the same
    message elsewhere.  A writer's failure raised on it alone would leave
    the other ranks in the next collective."""
    status = _from_first_rank(
        lambda: None if err is None else
        (isinstance(err, ckpt_lib.CheckpointIOError),
         str(err) if isinstance(err, ckpt_lib.CheckpointError)
         else f"rank 0's checkpoint write failed: {err!r}"), plan)
    if err is not None:
        raise err
    if status is not None:
        io, msg = status
        raise (ckpt_lib.CheckpointIOError if io
               else ckpt_lib.CheckpointError)(msg)


def _restore(tc: TrainConfig, cfg, params, opt_state, plan, pipe_group,
             prints: bool) -> Dict:
    """Resume support: load the newest checkpoint in ``tc.ckpt_dir`` that
    passes CRC validation (chosen on rank 0) into ``params`` and
    ``opt_state`` in place -> its meta ({} when there is none)."""
    step = _from_first_rank(
        lambda: ckpt_lib.latest_valid_step(tc.ckpt_dir, verify=True), plan)
    if step is None:
        return {}
    tree = ckpt_lib.restore_checkpoint(
        tc.ckpt_dir, step, bridge.train_state_target(params, cfg, pipe_group))
    bridge.load_train_state(tree, params, opt_state)
    meta = ckpt_lib.load_meta(tc.ckpt_dir, step)
    if prints:
        print(f"[resume] restored step {meta.get('step', step)} from "
              f"{tc.ckpt_dir}", flush=True)
    return meta


def train_loop(cfg: ModelConfig, rt: Runtime, tc: TrainConfig, batches,
               params, opt_state=None,
               telemetry: tel.Recorder = tel.NULL, plan=None,
               drift: Optional[tel.DriftMonitor] = None,
               hooks: Optional[Callable] = None, fault_plan=None,
               seed: int = 0):
    """Train ``params`` (on their device) for ``tc.steps`` steps on the
    numpy batches of ``batches``; -> (params, opt_state, history).

    Each step is a ``train/step`` span with ``train/dispatch`` (the step's
    host work, which enqueues the device's), ``train/data`` (the next
    batch), ``train/ckpt`` on checkpointing steps and, on logging steps,
    ``train/wait`` children.  The host waits for the device only on
    logging steps (every ``log_every`` and the first), where it prints a
    loss line, appends the metrics to ``history``, calls ``hooks(step,
    params, metrics)`` and sets the ``train/wps``, ``train/steps_per_s``
    and ``train/goodput_frac`` (1 - checkpoint time / window time) gauges
    over the window since the last log.  ``drift`` (a
    :class:`~repro_torch.telemetry.DriftMonitor` built from the resolved
    strategy's ``StepReport.decomposition()``) gets one measured window
    per logging window: the mean seconds per step of the window
    (``step``, ending in the device sync of the log) and of its
    ``dispatch``, ``wait`` and ``data`` spans; where its ``meta`` carries
    ``model_flops_per_step`` and ``cluster_peak_flops`` the ``train/mfu``
    gauge is set too, as in the JAX package.  Under a ``plan`` every rank
    trains (see :func:`make_train_step`) and rank 0 prints.

    Every ``tc.ckpt_every`` steps the state is saved to ``tc.ckpt_dir``
    (``bridge.train_state_to_tree``, gathered on every rank; rank 0
    writes, through an ``AsyncCheckpointer`` under ``tc.ckpt_async``,
    keeping the newest ``tc.ckpt_keep``), with one retry on a transient
    ``CheckpointIOError``; the meta holds the step, the batches consumed
    and the key data of ``PRNGKey(seed)`` (``seed``: the one the
    parameters were built from).  ``tc.resume`` first loads the newest
    CRC-valid checkpoint into ``params`` and ``opt_state`` in place and
    replays the data stream from its position, so a killed and resumed
    run is bit-identical to an uninterrupted one.  ``fault_plan``
    (:class:`repro_torch.resilience.FaultPlan`) injects crashes (raised as
    ``SimulatedFailure`` before the scheduled step runs), straggler sleeps
    (scaled by the measured step time: only a plan with stragglers syncs
    the device every step) and transient checkpoint-I/O errors.
    """
    device = params.device
    opt_state = opt_state if opt_state is not None else init_opt_state(params)
    step_fn = make_train_step(cfg, rt, tc, plan)
    prints = not dist.is_initialized() or dist.get_rank() == 0
    pipe_group = rt.pipe_group if rt.pipe_size > 1 else None
    start_step = 0
    if tc.resume and tc.ckpt_dir:
        meta = _restore(tc, cfg, params, opt_state, plan, pipe_group, prints)
        start_step = int(meta.get("step", 0))
    checkpointer = None
    if tc.ckpt_every and tc.ckpt_async and prints:
        checkpointer = ckpt_lib.AsyncCheckpointer(
            tc.ckpt_dir, max_in_flight=tc.ckpt_max_in_flight,
            keep=tc.ckpt_keep)

    def save(step):
        meta = {"step": step, "batches_consumed": step,
                "prng": prng_key_data(seed)}
        # one retry: the injected checkpoint-I/O faults are transient
        for attempt in range(2):
            try:
                if fault_plan is not None:
                    fault_plan.ckpt_io_check(step)
                tree = bridge.train_state_to_tree(params, opt_state, cfg,
                                                  pipe_group)
                err = None
                if prints:
                    try:
                        if checkpointer is not None:
                            checkpointer.save(step, tree, meta=meta)
                        else:
                            ckpt_lib.save_checkpoint(tc.ckpt_dir, step, tree,
                                                     meta=meta)
                            if tc.ckpt_keep:
                                ckpt_lib.gc_checkpoints(tc.ckpt_dir,
                                                        keep=tc.ckpt_keep)
                    except Exception as e:  # noqa: BLE001 - agreed below
                        err = e
                del tree
                _agree_on_error(err, plan)
                return
            except ckpt_lib.CheckpointIOError as e:
                if attempt:
                    raise
                if prints:
                    print(f"[ckpt] transient I/O error at step {step}, "
                          f"retrying: {e}", flush=True)

    # data-pipeline position: a resumed run must see exactly the batches
    # an uninterrupted run would have seen from this step
    if start_step and hasattr(batches, "at"):
        it = iter(batches.at(start_step))
    else:
        it = iter(batches)
        for _ in range(start_step):
            next(it)
    batch = batch_to_device(next(it), device)
    tokens_per_step = batch["labels"].numel()
    # straggler injection scales a measured step time, so only a plan
    # that schedules stragglers justifies a device sync every step
    sync_every_step = fault_plan is not None and any(
        e.kind == "straggler" for e in fault_plan.events)
    history = []
    t0 = win_t0 = time.time()
    t_step_ema = 0.0
    win_start = start_step
    win_dispatch = win_data = win_wait = win_ckpt = 0.0
    try:
        for step in range(start_step, tc.steps):
            with telemetry.span("train/step", step_num=step):
                if fault_plan is not None:
                    fault_plan.check_crash(step)
                    mult = fault_plan.delay_multiplier(step)
                    if mult > 1.0 and t_step_ema > 0.0:
                        time.sleep((mult - 1.0) * t_step_ema)
                t1 = time.time()
                with telemetry.span("train/dispatch"):
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         batch)
                t2 = time.time()
                win_dispatch += t2 - t1
                if step + 1 < tc.steps:
                    with telemetry.span("train/data"):
                        batch = batch_to_device(next(it), device)
                win_data += time.time() - t2
                if tc.ckpt_every and (step + 1) % tc.ckpt_every == 0:
                    t3 = time.time()
                    with telemetry.span("train/ckpt", step=step + 1):
                        save(step + 1)
                    win_ckpt += time.time() - t3
                log_now = (step + 1) % tc.log_every == 0 or \
                    step == start_step
                if not (log_now or sync_every_step):
                    continue
                t4 = time.time()
                with telemetry.span("train/wait"):
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    m = ({k: float(v) for k, v in metrics.items()}
                         if log_now else None)
                now = time.time()
                win_wait += now - t4
                t_step_ema = now - t1 if t_step_ema == 0.0 else \
                    0.7 * t_step_ema + 0.3 * (now - t1)
                if not log_now:
                    continue
                m["steps_per_s"] = (step + 1 - start_step) / (now - t0)
                history.append({"step": step + 1, **m})
                if prints:
                    print(f"step {step + 1:5d}  loss {m['loss']:.4f}"
                          f"  gnorm {m['grad_norm']:.3f}"
                          f"  {m['steps_per_s']:.2f} it/s", flush=True)
                n_win, dt_win = step + 1 - win_start, now - win_t0
                if n_win > 0 and dt_win > 0:
                    telemetry.gauge("train/wps",
                                    tokens_per_step * n_win / dt_win)
                    telemetry.gauge("train/steps_per_s", n_win / dt_win)
                    telemetry.gauge("train/goodput_frac",
                                    max(0.0, 1.0 - win_ckpt / dt_win))
                    if drift is not None:
                        fl = drift.meta.get("model_flops_per_step")
                        peak = drift.meta.get("cluster_peak_flops")
                        if fl and peak:
                            telemetry.gauge("train/mfu",
                                            fl / (dt_win / n_win) / peak)
                        drift.observe({"step": dt_win / n_win,
                                       "dispatch": win_dispatch / n_win,
                                       "wait": win_wait / n_win,
                                       "data": win_data / n_win},
                                      n_steps=n_win)
                win_t0, win_start = now, step + 1
                win_dispatch = win_data = win_wait = win_ckpt = 0.0
                if hooks:
                    hooks(step + 1, params, m)
        if tc.ckpt_every and tc.ckpt_async:
            # every queued write committed, and agreed on, before return
            err = None
            try:
                if checkpointer is not None:
                    checkpointer.close()
            except Exception as e:  # noqa: BLE001 - agreed below
                err = e
            checkpointer = None
            _agree_on_error(err, plan)
    finally:
        if checkpointer is not None:
            checkpointer.close()
    return params, opt_state, history
