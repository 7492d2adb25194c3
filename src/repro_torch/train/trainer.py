"""Training on one device: the train step with gradient accumulation and
AdamW, and the loop that logs it — the single-device part of the JAX
package's ``train/trainer.py``.

``make_train_step`` maps (params, opt_state, batch) -> (params, opt_state,
metrics); it updates the parameters and moments in place.  Metrics stay
0-d tensors on the device: reading one waits for the device, so
``train_loop`` reads them only on logging steps.  Checkpoints, resume and
fault injection come with the checkpointing slice; MFU and drift with the
cost model (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

from repro_torch import telemetry as tel
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Runtime
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.schedule import linear_warmup_cosine


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    warmup: int = 10
    log_every: int = 10
    grad_accum: int = 1
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def make_train_step(cfg: ModelConfig, rt: Runtime, tc: TrainConfig):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {'loss', 'nll', 'aux', 'ntok', 'grad_norm', 'lr'}).

    With ``grad_accum`` > 1 the batch splits into that many microbatches
    along dim 0; their gradients are summed (autograd accumulates into
    ``.grad``) and divided by the count, ``ntok`` is summed and every
    other metric averaged.  The lr scale is read from the step count
    before the update."""
    ga = max(tc.grad_accum, 1)

    def train_step(params, opt_state, batch):
        B = batch["labels"].shape[0]
        if B % ga:
            raise ValueError(f"batch {B} does not split into "
                             f"grad_accum={tc.grad_accum}")
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        mb = B // ga
        loss_sum, msum = None, None
        for i in range(ga):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics = tfm.loss_fn(cfg, params, micro, rt)
            loss.backward()
            loss, metrics = loss.detach(), {k: v.detach()
                                            for k, v in metrics.items()}
            if loss_sum is None:
                loss_sum, msum = loss, metrics
            else:
                loss_sum = loss_sum + loss
                msum = {k: msum[k] + metrics[k] for k in msum}
        grads: Dict[str, torch.Tensor] = {}
        for n, p in named.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[n] = g.div_(ga) if ga > 1 else g
        lr_scale = linear_warmup_cosine(opt_state["step"], tc.warmup,
                                        tc.steps)
        params, opt_state, opt_metrics = adamw_update(
            tc.opt, params, grads, opt_state, lr_scale)
        for p in named.values():
            p.grad = None
        out = {"loss": loss_sum / ga,
               **{k: v if k == "ntok" else v / ga for k, v in msum.items()},
               **opt_metrics}
        return params, opt_state, out

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


def train_loop(cfg: ModelConfig, rt: Runtime, tc: TrainConfig, batches,
               params, opt_state=None,
               telemetry: tel.Recorder = tel.NULL):
    """Train ``params`` (on their device) for ``tc.steps`` steps on the
    numpy batches of ``batches``; -> (params, opt_state, history).

    Each step is a ``train/step`` span with ``train/dispatch`` (the step's
    host work, which enqueues the device's), ``train/data`` (the next
    batch) and, on logging steps, ``train/wait`` children.  The host waits
    for the device only on logging steps (every ``log_every`` and the
    first), where it prints a loss line, appends the metrics to
    ``history`` and sets the ``train/wps`` and ``train/steps_per_s``
    gauges over the window since the last log.
    """
    device = params.device
    opt_state = opt_state if opt_state is not None else init_opt_state(params)
    step_fn = make_train_step(cfg, rt, tc)
    it = iter(batches)
    batch = batch_to_device(next(it), device)
    tokens_per_step = batch["labels"].numel()
    history = []
    t0 = win_t0 = time.time()
    win_start = 0
    for step in range(tc.steps):
        with telemetry.span("train/step", step_num=step):
            with telemetry.span("train/dispatch"):
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step + 1 < tc.steps:
                with telemetry.span("train/data"):
                    batch = batch_to_device(next(it), device)
            if (step + 1) % tc.log_every and step:
                continue
            with telemetry.span("train/wait"):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                m = {k: float(v) for k, v in metrics.items()}
            now = time.time()
            m["steps_per_s"] = (step + 1) / (now - t0)
            history.append({"step": step + 1, **m})
            print(f"step {step + 1:5d}  loss {m['loss']:.4f}"
                  f"  gnorm {m['grad_norm']:.3f}"
                  f"  {m['steps_per_s']:.2f} it/s", flush=True)
            n_win, dt_win = step + 1 - win_start, now - win_t0
            if n_win > 0 and dt_win > 0:
                telemetry.gauge("train/wps", tokens_per_step * n_win / dt_win)
                telemetry.gauge("train/steps_per_s", n_win / dt_win)
            win_t0, win_start = now, step + 1
    return params, opt_state, history
