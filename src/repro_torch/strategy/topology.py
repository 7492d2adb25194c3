"""Device topology: the hardware half of a (strategy, topology) pairing.

A copy of the JAX package's ``strategy/topology.py`` but for two
functions: ``host_topology`` counts the ranks of the process group, and
``build_mesh`` returns a ``torch.distributed`` ``DeviceMesh`` over the
first ``n_devices`` ranks (or, with ``abstract=True``, the ordered
``{axis: size}`` mapping that the group-size analysis needs, with no
process group at all).

The paper's core argument is that the right parallelization strategy is a
function of the *cluster*, not just the model: island size (NVLink node /
ICI pod), fabric bandwidths, and chip count all move the optimum.  A
``Topology`` names those facts once so that

  * ``Strategy.to_plan``  builds the SPMD mesh from it (no hard-coded
    ``(16, 16)`` shapes), and
  * ``Strategy.to_cost_strategy`` / ``planner.search`` charge collectives
    for exactly the group sizes that mesh will produce.

``build_mesh(..., abstract=True)`` needs no devices, so plans for a
512-chip pod can be *analyzed* on a laptop; only execution needs the real
chips.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core import costmodel as cm


@dataclasses.dataclass(frozen=True)
class Topology:
    """A cluster shape + the hardware generation that fills it."""
    name: str
    n_devices: int
    island: int                  # chips per fast island (DGX node / TPU pod)
    hardware: str = "TPUv5e"     # key into costmodel.HARDWARE
    hbm: float = 16e9            # per-chip HBM capacity, bytes
    hw_obj: Optional[cm.Hardware] = None  # explicit profile (e.g. calibrated
    #                              variant) overrides the HARDWARE lookup

    def __post_init__(self):
        assert self.n_devices >= 1 and self.island >= 1
        if self.hw_obj is None:
            assert self.hardware in cm.HARDWARE, (
                f"unknown hardware {self.hardware!r}; "
                f"known: {sorted(cm.HARDWARE)}")

    @property
    def hw(self) -> cm.Hardware:
        if self.hw_obj is not None:
            return self.hw_obj
        return cm.HARDWARE[self.hardware]

    @property
    def n_islands(self) -> int:
        return max(1, self.n_devices // self.island)


def host_topology(hardware: str = "H100", hbm: float = 80e9,
                  n_devices: Optional[int] = None) -> Topology:
    """Every rank of this job, as one fast island.

    The rank count is the world size of the process group when one is up
    (one rank per card under ``torchrun``), else 1.  ``hardware`` picks
    the cost-model profile the planner uses when asked to rank strategies
    for the host mesh (CPU smoke runs have no profile of their own —
    predictions are for the named generation, execution is local).
    """
    n = n_devices or world_size()
    return Topology("host", n, island=n, hardware=hardware, hbm=hbm)


def world_size() -> int:
    """Ranks in the default process group; 1 when none is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def pod_topology(pods: int = 1, chips_per_pod: int = 256,
                 hardware: str = "TPUv5e", hbm: float = 16e9) -> Topology:
    """The production target: TPU v5e pod(s), DCN-connected above 1 pod."""
    name = "pod" if pods == 1 else f"multipod{pods}"
    return Topology(name, pods * chips_per_pod, island=chips_per_pod,
                    hardware=hardware, hbm=hbm)


def get_topology(name: str, **kw) -> Topology:
    """CLI entry: 'host' | 'pod' | 'multipod' | 'multipod<k>'."""
    if name == "host":
        return host_topology(**kw)
    if name == "pod":
        return pod_topology(pods=1, **kw)
    if name.startswith("multipod"):
        pods = int(name[len("multipod"):] or 2)
        return pod_topology(pods=pods, **kw)
    raise ValueError(f"unknown topology {name!r} "
                     "(expected host | pod | multipod[<k>])")


def build_mesh(topology: Topology, model: int = 1, pods: int = 1,
               pipe: int = 1, expert: int = 1, abstract: bool = False,
               device_type: Optional[str] = None):
    """Mesh for ``topology`` with given model-, pipe- and expert-axis degrees.

    pods > 1 adds a leading 'pod' axis (HSDP: params sharded inside the
    island, replicated across pods).  pipe > 1 adds a 'pipe' axis for
    GPipe stages, placed outermost below 'pod' so stages span the slow
    fabric first (pipeline p2p is the cheapest cross-island traffic —
    the paper's argument for PP at scale).  expert > 1 adds an 'expert'
    axis *factored out of the data axis* (data = dp / expert): batch and
    gradients shard over (data, expert) together, while MoE expert stacks
    shard their E dim over 'expert' only — the dispatch/combine
    all-to-all runs along it.  It sits between 'data' and 'model' so the
    ep-group ranks are as mesh-adjacent as the model axis allows.
    ``abstract=True`` returns the ordered ``{axis: size}`` mapping —
    enough for group-size analysis without any process group.  Otherwise
    the mesh spans the first ``topology.n_devices`` ranks of the default
    process group (all of them, or fewer after a re-plan onto the devices
    that survive a failure, as ``jax.make_mesh`` takes the first n
    devices: every rank must call this, since the mesh's process groups
    are made collectively, and a rank outside the mesh has no coordinate
    on it) on ``device_type``: by default the type the process group's
    backend serves (``cuda`` where it has NCCL, else ``cpu``); the dry
    run's fake group serves no device of its own, so its caller names one.
    """
    n = topology.n_devices
    if n % (model * pods * pipe * expert):
        raise ValueError(
            f"mesh ({pods} pods x pipe {pipe} x expert {expert} x model "
            f"{model}) does not divide {n} devices")
    data = n // (model * pods * pipe * expert)
    shape = (pods, pipe, data, expert, model)
    axes = ("pod", "pipe", "data", "expert", "model")
    keep = [i for i, (a, s) in enumerate(zip(axes, shape))
            if a in ("data", "model") or s > 1]
    shape = tuple(shape[i] for i in keep)
    axes = tuple(axes[i] for i in keep)
    if abstract:
        return dict(zip(axes, shape))
    if not dist.is_initialized() or dist.get_world_size() < n:
        raise ValueError(
            f"a mesh over {n} devices needs a process group of {n} ranks "
            f"or more (have "
            f"{world_size() if dist.is_initialized() else 'none'}); start "
            "one with repro_torch.launch.mesh.init_distributed")
    if device_type is None:
        # NCCL alone, or NCCL for card tensors beside gloo for host ones
        backend = dist.get_backend()
        if backend == "fake":
            raise ValueError("a mesh over a fake process group needs its "
                             "device_type (the dry run's --device)")
        device_type = "cuda" if "nccl" in backend else "cpu"
    if n < dist.get_world_size():
        return DeviceMesh(device_type, torch.arange(n).view(shape),
                          mesh_dim_names=axes)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_shape(mesh) -> dict:
    """{axis: size} of a ``DeviceMesh`` or of an abstract mesh."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
