"""AdamW with decoupled weight decay and global-norm gradient clipping — the
port of the JAX package's ``optim/adamw.py``.

Parameters are a module's ``nn.Parameter``s under the names
``named_parameters`` gives them; gradients and the f32 moments ``m`` and
``v`` are dicts under the same names, and ``step`` counts updates on the
host.  ``adamw_update`` updates parameters and moments in place under
``torch.no_grad()``: the JAX version returns new arrays, which here would
hold a second copy of the weights and of both moments.
``torch.optim.AdamW`` is not used: it would decay norm scales and biases
too, and it orders its arithmetic differently.  Parameters sharded by
FSDP2 (``DTensor``s) keep ``DTensor`` moments of their own placements;
the update runs on the local shards (``to_local`` views), with no
collective and no ``DTensor`` dispatch per op, and only the gradient norm
sums over the ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _local(t: torch.Tensor) -> torch.Tensor:
    """A sharded parameter's (``DTensor``'s) local shard, else the tensor:
    a view sharing its storage, so in-place updates reach the parameter."""
    return t.to_local() if isinstance(t, DTensor) else t


def init_opt_state(params: nn.Module) -> Dict:
    """{'m': {name: zeros}, 'v': {name: zeros}, 'step': 0}; f32 moments
    on each parameter's device, whatever the parameter's type.  A sharded
    parameter's moments are ``DTensor``s with its placements, so each
    rank allocates only its own shard."""
    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.named_parameters()}
    return {"m": zeros(), "v": zeros(), "step": 0}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of :func:`_square_sum`."""
    return torch.sqrt(_square_sum(tensors))


def _square_sum(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """The sum of squares over every tensor's elements.  Sharded
    tensors (``DTensor``s) add their local shards' squares, summed over
    the mesh dimensions they are sharded on and not over those they are
    replicated on (which hold the same values): tensors are summed in
    groups of the same mesh and sharded dimensions, and each group's sum
    is reduced over its own.  On a 2-D (data, model) mesh a leaf
    replicated over the model axis is thus counted once, not once per
    model rank."""
    totals, groups = {}, {}
    for x in tensors:
        sq = torch.sum(torch.square(_local(x).float()))
        key = ()
        if isinstance(x, DTensor):
            # FSDP2 over a sharded model axis places dim 0 as a
            # _StridedShard, which is no Shard: test for replicas instead.
            # Leaves of one model may lie on different meshes (a MoE FFN's
            # unit on (data, expert) beside the layers' on the flattened
            # data axes), so the mesh is part of the key
            dims = tuple(dim for dim, place in enumerate(x.placements)
                         if not place.is_replicate()
                         and x.device_mesh.size(dim) > 1)
            key = (x.device_mesh, dims) if dims else ()
            if dims:
                groups[key] = [x.device_mesh.get_group(d) for d in dims]
        totals[key] = sq if key not in totals else totals[key] + sq
    if not totals:
        return torch.zeros(())
    total = None
    for key, sq in totals.items():
        for group in groups.get(key, ()):
            dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    return total


# leaves that take no weight decay: norms, biases and 1-d mixer params
_NO_DECAY = ("scale", "bias", "b_dt", "conv_b", "w0", "maa_x", "maa_k",
             "maa_r", "bq", "bk", "bv")


def _decay_mask(name: str) -> bool:
    """No weight decay for norms, biases, 1-d params (by leaf name)."""
    return name.rsplit(".", 1)[-1] not in _NO_DECAY


def adamw_update(cfg: AdamWConfig, params: nn.Module,
                 grads: Dict[str, torch.Tensor], state: Dict,
                 lr_scale: float = 1.0, pipe_rt=None):
    """One step, in place -> (params, state, {'grad_norm', 'lr'}).

    grad_norm is a 0-d tensor on the device (reading it waits for the
    device); the bias corrections and lr are host floats computed in f32,
    as the JAX version computes them.  On a pipe rank (``pipe_rt``, the
    step's ``Runtime``) ``params`` holds its stages' layers and the
    leaves every pipe rank holds alike: the layers' squares are summed
    over the pipe group, the others counted once."""
    named = dict(params.named_parameters())
    if pipe_rt is None:
        gnorm = global_norm(grads[n] for n in named)
    else:
        from repro_torch.core.pipeline import pipe_all_reduce
        layers = _square_sum(grads[n] for n in named
                             if n.startswith("layers."))
        gnorm = torch.sqrt(pipe_all_reduce(layers, pipe_rt) + _square_sum(
            grads[n] for n in named if not n.startswith("layers.")))
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0)
    step = state["step"] + 1
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    with torch.no_grad():
        for n, param in named.items():
            # sharded leaves update their local shards in place
            p, m, v = (_local(x) for x in (param, state["m"][n],
                                           state["v"][n]))
            gf = _local(grads[n]).float() * clip
            m.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).add_(gf * gf, alpha=1 - cfg.b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay and _decay_mask(n) and param.ndim >= 2:
                u = u + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
