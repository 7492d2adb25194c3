"""The collectives a step issues, counted as they are dispatched — the
port's stand-in for the JAX package's ``perf/hlo.py::collective_stats``.

JAX reads the collectives off the compiled HLO text of a step, as
``{kind: {'bytes', 'count'}}`` with loop bodies scaled by their trip
counts.  An eager PyTorch step has no program to read: every collective
is a ``c10d`` op the dispatcher sees when it is issued, so
:class:`CollectiveCensus` counts them while the step runs, in the same
dict shape and under JAX's HLO kind names.  It sees what the step issues
on any process group — the dry run's fake one, gloo or NCCL — FSDP2's
all-gathers and reduce-scatters, the tensor-parallel collectives
(``models.layers.COLLECTIVES``), the norm's and metrics' all-reduces and
the pipeline's point-to-point sends.

``bytes`` is each op's result, as JAX counts it: the gathered tensor of
an all-gather, the scattered shard of a reduce-scatter, the reduced
tensor of an all-reduce, the sent tensor of a point-to-point message
(kind ``collective-permute``, JAX's for its pipeline transfers; each
message counted once, at its sender).

The census counts by kind; which of those calls the model's own sites
issued — a context plan's K/V all-gathers, a MoE FFN's combine over the
model axis — is ``models.layers.COLLECTIVE_SITES``, which the dry run
records beside it (``collective_sites``).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# c10d op -> JAX's HLO kind; the first argument of each is its result (or,
# for a send, the tensors sent)
KINDS = {
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
    "send": "collective-permute",
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class CollectiveCensus(TorchDispatchMode):
    """``with CollectiveCensus() as c: step(...)`` -> ``c.stats``:
    ``{kind: {'bytes': int, 'count': int}}`` of the collectives this rank
    issued inside the block."""

    def __init__(self):
        super().__init__()
        self.stats: Dict[str, Dict[str, int]] = {}

    def _add(self, kind: str, nbytes: int) -> None:
        entry = self.stats.setdefault(kind, {"bytes": 0, "count": 0})
        entry["bytes"] += nbytes
        entry["count"] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor issue its local ops
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if func.namespace == "c10d" and name in KINDS:
            self._add(KINDS[name], _nbytes(args[0]))
        return out


def total_bytes(stats: Dict[str, Dict[str, int]]) -> int:
    return int(sum(v["bytes"] for v in stats.values()))
