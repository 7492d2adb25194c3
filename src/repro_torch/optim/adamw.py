"""AdamW with decoupled weight decay and global-norm gradient clipping — the
port of the JAX package's ``optim/adamw.py``.

Parameters are a module's ``nn.Parameter``s under the names
``named_parameters`` gives them; gradients and the f32 moments ``m`` and
``v`` are dicts under the same names, and ``step`` counts updates on the
host.  ``adamw_update`` updates parameters and moments in place under
``torch.no_grad()``: the JAX version returns new arrays, which here would
hold a second copy of the weights and of both moments.
``torch.optim.AdamW`` is not used: it would decay norm scales and biases
too, and it orders its arithmetic differently.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: nn.Module) -> Dict:
    """{'m': {name: zeros}, 'v': {name: zeros}, 'step': 0}; f32 moments
    on each parameter's device, whatever the parameter's type."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.named_parameters()}
    return {"m": zeros(), "v": zeros(), "step": 0}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


# leaves that take no weight decay: norms, biases and 1-d mixer params
_NO_DECAY = ("scale", "bias", "b_dt", "conv_b", "w0", "maa_x", "maa_k",
             "maa_r", "bq", "bk", "bv")


def _decay_mask(name: str) -> bool:
    """No weight decay for norms, biases, 1-d params (by leaf name)."""
    return name.rsplit(".", 1)[-1] not in _NO_DECAY


def adamw_update(cfg: AdamWConfig, params: nn.Module,
                 grads: Dict[str, torch.Tensor], state: Dict,
                 lr_scale: float = 1.0):
    """One step, in place -> (params, state, {'grad_norm', 'lr'}).

    grad_norm is a 0-d tensor on the device (reading it waits for the
    device); the bias corrections and lr are host floats computed in f32,
    as the JAX version computes them."""
    named = dict(params.named_parameters())
    gnorm = global_norm(grads[n] for n in named)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0)
    step = state["step"] + 1
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    with torch.no_grad():
        for n, p in named.items():
            m, v = state["m"][n], state["v"][n]
            gf = grads[n].float() * clip
            m.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).add_(gf * gf, alpha=1 - cfg.b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay and _decay_mask(n) and p.ndim >= 2:
                u = u + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
