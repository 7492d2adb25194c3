"""Peak device memory of a step, traced op by op — the port's stand-in for
the JAX package's ``compiled.memory_analysis()`` in the dry run.

:class:`MemoryTracker` is a dispatch mode: every tensor an op returns is
tracked by its storage from the op that makes it to the moment the storage
dies (or FSDP2 resizes it to 0 bytes), and the largest sum of live bytes is
the peak.  It works the same on real tensors and on the fake tensors of a
``FakeTensorMode`` (which have sizes and no memory), so a dry run on a
fake process group gives the peak one device would reach.  Each storage
counts as the CUDA caching allocator counts it, rounded up to
``GRANULARITY`` bytes, so the peak is comparable with
``torch.cuda.max_memory_allocated``.

The peak is split by what the live storages were:

  * ``parameters``, ``optimizer``: registered before the step (the
    parameter shards each rank keeps; the AdamW moments and step);
  * ``gradients``: made during a backward pass and still alive after the
    last one (the gradients the optimizer reads);
  * ``activations``: made outside a backward pass before the optimizer
    starts — what forward passes keep for their backward, the batch, and
    the layers FSDP2 gathers for a forward;
  * ``temporaries``: everything else — what a backward pass frees again
    (cotangents, layers re-gathered for it) and what the optimizer makes;
  * ``cache``: a serving step's dense caches, registered before it (a
    decode step's) or relabelled after it (those a prefill makes).
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

GRANULARITY = 512      # bytes: the CUDA caching allocator's rounding
CATEGORIES = ("parameters", "gradients", "optimizer", "activations",
              "temporaries", "cache")


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


class _Life:
    """One stretch of a storage's life: its bytes, what it was when it
    started, and the tracker's clock (a count of events) when it started
    and ended."""
    __slots__ = ("nbytes", "origin", "born", "died")

    def __init__(self, nbytes: int, origin: str, born: int):
        self.nbytes, self.origin, self.born = nbytes, origin, born
        self.died: Optional[int] = None


class MemoryTracker(TorchDispatchMode):
    """``tracker.register(tensors, 'parameters')`` for what exists before
    the step, then ``with tracker: step(...)``; -> ``tracker.peak`` bytes
    and ``tracker.breakdown()``."""

    def __init__(self):
        super().__init__()
        self._open: Dict[int, _Life] = {}
        self._lives: List[_Life] = []
        self._clock = 0
        self._total = 0
        self._last_backward = -1
        self.peak = 0
        self._peak_at = 0
        self._resize = None

    # -- bookkeeping ---------------------------------------------------
    @staticmethod
    def _rounded(n: int) -> int:
        return -(-n // GRANULARITY) * GRANULARITY

    def _start(self, st, key: int, origin: str) -> None:
        n = self._rounded(st.nbytes())
        if n == 0:
            return
        self._clock += 1
        life = _Life(n, origin, self._clock)
        self._open[key] = life
        self._lives.append(life)
        self._total += n
        if self._total > self.peak:
            self.peak, self._peak_at = self._total, self._clock

    def _end(self, key: int) -> None:
        life = self._open.pop(key, None)
        if life is not None:
            self._clock += 1
            life.died = self._clock
            self._total -= life.nbytes

    def _track(self, t: torch.Tensor, origin: str) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._open:
            return
        self._start(st, key, origin)
        if key in self._open:
            weakref.finalize(st, self._end, key)

    def register(self, tensors: Iterable[torch.Tensor],
                 category: str) -> None:
        """Count ``tensors``' storages (alive before the step) as
        ``category``."""
        if category not in CATEGORIES:
            raise ValueError(f"category {category!r} not in {CATEGORIES}")
        for t in tensors:
            self._track(t, category)

    def relabel(self, tensors: Iterable[torch.Tensor],
                category: str) -> None:
        """Count the live storages of ``tensors`` (made during the step) as
        ``category`` from their start."""
        if category not in CATEGORIES:
            raise ValueError(f"category {category!r} not in {CATEGORIES}")
        for t in tensors:
            life = self._open.get(t.untyped_storage()._cdata)
            if life is not None:
                life.origin = category

    # -- the mode ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # track DTensor's local ops
        out = func(*args, **(kwargs or {}))
        backward = _in_backward()
        if backward:
            self._last_backward = self._clock
        origin = "backward" if backward else "forward"
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t, origin)
        return out

    def __enter__(self):
        # FSDP2 frees and re-allocates a gathered layer's storage in place
        # (``UntypedStorage.resize_``), which no op dispatch shows
        orig = torch.UntypedStorage.resize_
        tracker = self

        def resize_(st, size):
            out = orig(st, size)
            key = st._cdata
            tracker._end(key)
            if size:
                tracker._start(st, key, "backward" if _in_backward()
                               else "forward")
            return out

        self._resize = orig
        torch.UntypedStorage.resize_ = resize_
        return super().__enter__()

    def __exit__(self, *exc):
        torch.UntypedStorage.resize_ = self._resize
        return super().__exit__(*exc)

    # -- the result ----------------------------------------------------
    def breakdown(self) -> Dict[str, int]:
        """The bytes live at the peak, by :data:`CATEGORIES`."""
        out = dict.fromkeys(CATEGORIES, 0)
        at, last_bw = self._peak_at, self._last_backward
        for life in self._lives:
            if life.born > at or (life.died is not None and life.died <= at):
                continue
            if life.origin in CATEGORIES:
                cat = life.origin
            elif life.origin == "backward":
                cat = ("gradients" if life.died is None
                       or life.died > last_bw else "temporaries")
            else:
                cat = "activations" if life.born <= last_bw else \
                    "temporaries"
            out[cat] += life.nbytes
        return out
