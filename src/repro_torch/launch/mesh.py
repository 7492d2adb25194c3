"""Process groups and meshes for the port's entry points.

``init_distributed`` starts the default process group: under ``torchrun``
(``WORLD_SIZE`` and ``LOCAL_RANK`` set) from its environment, one rank per
card (NCCL) or per host process (gloo on ``--device cpu``); otherwise a
1-rank group on an in-process store, so that a strategy always runs
through FSDP2 over a real mesh and never unwrapped.  Meshes come from
``repro_torch.strategy`` (``Strategy.to_plan`` builds the plan's
``DeviceMesh``); ``make_host_mesh`` is the JAX package's small-mesh helper.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.strategy.topology import build_mesh, host_topology


def local_rank() -> int:
    """This process's index on its host (``torchrun``'s LOCAL_RANK; 0 for
    a process started alone)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def init_distributed(device: torch.device) -> None:
    """Start the default process group for ranks on ``device``'s type
    (NCCL on ``cuda``, gloo on ``cpu``); a no-op when one is up.  Under
    ``torchrun`` the group spans its WORLD_SIZE ranks; otherwise it is one
    rank on an in-process ``HashStore`` (no socket, no network).  A card
    rank binds its device first, as NCCL needs."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    if "WORLD_SIZE" in os.environ and "LOCAL_RANK" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def shutdown() -> None:
    """Destroy the default process group if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   device_type=None):
    """Small mesh over the process group's ranks (tests): (data, model),
    with a leading 'pod' axis (even of size 1) for any ``pod >= 1`` — the
    JAX package's contract."""
    if pod:
        from torch.distributed.device_mesh import init_device_mesh
        device_type = device_type or (
            "cuda" if dist.get_backend() == "nccl" else "cpu")
        return init_device_mesh(device_type, (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return build_mesh(host_topology(n_devices=data * model), model=model,
                      device_type=device_type)
