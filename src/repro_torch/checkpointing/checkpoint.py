"""Checkpoints without external dependencies, in the JAX package's layout
(``repro.checkpointing``, manifest version 2) — its on-disk format and
its numpy parts copied, the JAX calls replaced.

Layout: ``<dir>/step_<N>/manifest.json`` + one ``.npy`` per leaf, keyed by
the flattened tree path (dict keys and list indices joined by ``/``, dict
keys in sorted order, as JAX's ``tree_map_with_path`` names and orders
them).  A training state is saved as ``bridge.train_state_to_tree`` builds
it, ``{"params": <JAX params tree>, "opt": {"m", "v", "step"}}``, so a
checkpoint of either package restores in the other.

  * **atomic commit** — leaves and manifest are written into
    ``step_<N>.tmp-<token>`` and ``os.replace``d into place, so a crash
    mid-save never leaves a ``step_<N>/`` that ``latest_step`` selects;
  * **per-leaf CRC32 checksums** in the manifest, recomputed by
    ``validate_checkpoint`` and (optionally) on restore;
  * a ``meta`` sidecar dict in the manifest (training step, PRNG key data,
    data-pipeline position) so a resumed run can bit-match an
    uninterrupted one;
  * typed :class:`CheckpointError`\\ s, missing/extra/mismatched leaves
    aggregated into one error;
  * :class:`AsyncCheckpointer` — copies the leaves to host memory on the
    calling thread (the only stall the training loop pays) and writes in
    a bounded background thread, committing atomically like the sync
    path.

Leaves are numpy arrays or tensors.  Extended floats (``bfloat16``,
``float8_*``), which numpy lacks, are stored as their uint16/uint8 bits
under their logical dtype name, and restored as CPU tensors of that dtype.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import threading
import time
import uuid
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_VERSION = 2
_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointError(RuntimeError):
    """A checkpoint that cannot be written, read, or trusted."""


class CheckpointIOError(CheckpointError):
    """A (possibly transient) I/O failure in the save/load path."""


def _walk(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) of a nested dict/list/tuple, dict keys sorted (JAX's
    flattening order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _map(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _path_key(path) -> str:
    return "/".join(str(p) for p in path)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _leaf_fname(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"


def _bits_dtype(itemsize: int) -> np.dtype:
    return np.dtype(np.uint16 if itemsize == 2 else np.uint8)


def _stored_view(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind == "V":        # bfloat16 etc. as numpy: its raw bits
        return arr.view(_bits_dtype(arr.dtype.itemsize))
    return arr


def _host_copy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf -> (it in host memory as stored on disk, its logical dtype
    name).  A tensor is copied (as its bits where numpy lacks its dtype):
    the training loop goes on updating it in place.  A numpy array is
    taken as it is, as the JAX package takes its immutable arrays: the
    caller hands over an array it no longer changes, such as those of
    ``bridge.train_state_to_tree``, which are copies already."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).split(".")[-1]
        if _numpy_dtype(name) is None:
            t = t.view(torch.int16 if t.element_size() == 2 else torch.uint8)
            arr = t.to("cpu", copy=True).numpy()
            return arr.view(_bits_dtype(arr.dtype.itemsize)), name
        return t.to("cpu", copy=True).numpy(), name
    arr = np.asarray(leaf)
    return _stored_view(arr), str(arr.dtype)


def _numpy_dtype(name: str) -> Optional[np.dtype]:
    """A numpy dtype of this name, or None (``bfloat16``, ``float8_*``)."""
    try:
        dtype = np.dtype(name)
    except TypeError:
        return None
    return None if dtype.kind == "V" else dtype


def _torch_dtype(name: str) -> Optional[torch.dtype]:
    """The torch dtype a manifest names where numpy has none."""
    dtype = getattr(torch, name, None)
    return dtype if isinstance(dtype, torch.dtype) else None


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).data)


# ---------------------------------------------------------------------------
# snapshot (device -> host) and write (host -> disk), split so the async
# checkpointer pays only the snapshot on the training thread
# ---------------------------------------------------------------------------

def snapshot(tree: Any) -> Dict[str, Tuple[np.ndarray, str]]:
    """Every leaf in host memory: {path_key: (stored_array, dtype)}, each
    tensor copied (see :func:`_host_copy`).

    ``stored_array`` is the bit-view written to disk (bf16 as uint16);
    ``dtype`` is the logical dtype recorded in the manifest.
    """
    return {_path_key(path): _host_copy(leaf) for path, leaf in _walk(tree)}


def write_snapshot(directory: str, step: int,
                   snap: Dict[str, Tuple[np.ndarray, str]],
                   meta: Optional[Dict] = None) -> str:
    """Write a host snapshot to ``step_<N>/`` with an atomic commit."""
    final = _step_dir(directory, step)
    tmp = final + ".tmp-" + uuid.uuid4().hex[:8]
    os.makedirs(tmp, exist_ok=False)
    try:
        leaves = {}
        for key, (arr, logical_dtype) in snap.items():
            fname = _leaf_fname(key)
            np.save(os.path.join(tmp, fname), arr)
            leaves[key] = {"file": fname, "shape": list(arr.shape),
                           "dtype": logical_dtype, "crc32": _crc(arr)}
        manifest = {"step": step, "version": MANIFEST_VERSION,
                    "leaves": leaves, "meta": meta or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):
            # a previous (necessarily partial or superseded) dir of the
            # same step: replace it wholesale
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def save_checkpoint(directory: str, step: int, tree: Any,
                    meta: Optional[Dict] = None) -> str:
    """Synchronous save: snapshot + atomically committed write."""
    return write_snapshot(directory, step, snapshot(tree), meta)


# ---------------------------------------------------------------------------
# discovery / validation / gc
# ---------------------------------------------------------------------------

def _read_manifest(directory: str, step: int) -> Dict:
    path = os.path.join(_step_dir(directory, step), "manifest.json")
    try:
        with open(path) as f:
            m = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"unreadable manifest {path}: {e!r}") from e
    if "leaves" not in m:
        raise CheckpointError(f"manifest {path} has no 'leaves' section")
    return m


def list_steps(directory: str) -> List[int]:
    """Steps with a readable manifest, ascending.  ``.tmp-*`` dirs from
    interrupted saves and manifest-less partial dirs are never listed."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if not m:
            continue
        step = int(m.group(1))
        try:
            _read_manifest(directory, step)
        except CheckpointError:
            continue
        steps.append(step)
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """Newest step whose manifest is readable (a crash mid-save leaves
    either a ``.tmp-*`` dir or nothing — neither is eligible)."""
    steps = list_steps(directory)
    return steps[-1] if steps else None


def validate_checkpoint(directory: str, step: int) -> List[str]:
    """Integrity check: manifest readable, every leaf file present, every
    CRC32 matching.  Returns a list of problems (empty == valid)."""
    try:
        manifest = _read_manifest(directory, step)
    except CheckpointError as e:
        return [str(e)]
    src = _step_dir(directory, step)
    problems = []
    for key, entry in manifest["leaves"].items():
        fpath = os.path.join(src, entry["file"])
        try:
            arr = np.load(fpath)
        except (OSError, ValueError) as e:
            problems.append(f"{key}: unreadable leaf {entry['file']}: {e!r}")
            continue
        if list(arr.shape) != list(entry["shape"]):
            problems.append(f"{key}: stored shape {list(arr.shape)} != "
                            f"manifest shape {entry['shape']}")
        crc = entry.get("crc32")
        if crc is not None and _crc(arr) != crc:
            problems.append(f"{key}: CRC32 mismatch in {entry['file']} "
                            "(corrupt leaf)")
    return problems


def latest_valid_step(directory: str, verify: bool = True) -> Optional[int]:
    """Newest step that passes validation; ``verify=True`` recomputes
    CRCs (what the supervisor uses to fall back past corruption),
    ``verify=False`` only requires a readable manifest."""
    for step in reversed(list_steps(directory)):
        if not verify or not validate_checkpoint(directory, step):
            return step
    return None


def gc_checkpoints(directory: str, keep: int = 3) -> List[int]:
    """Delete all but the newest ``keep`` valid checkpoints, plus any
    orphaned ``.tmp-*`` dirs from interrupted saves.  Returns the steps
    removed."""
    if not os.path.isdir(directory):
        return []
    for d in os.listdir(directory):
        if ".tmp-" in d and _STEP_RE.match(d.split(".tmp-")[0]):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    steps = list_steps(directory)
    drop = steps[:-keep] if keep > 0 else []
    for step in drop:
        shutil.rmtree(_step_dir(directory, step), ignore_errors=True)
    return drop


def load_meta(directory: str, step: int) -> Dict:
    """The ``meta`` sidecar recorded at save time ({} for v1 manifests)."""
    return _read_manifest(directory, step).get("meta", {})


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def _logical(key: str, arr: np.ndarray, name: str, problems: List[str]):
    """A loaded array -> the leaf of its manifest dtype ``name``: as is,
    or a bit-stored extended float viewed back as a CPU tensor of that
    dtype; None (with a problem noted) when the two cannot agree."""
    if str(arr.dtype) == name:
        return arr
    dtype = _torch_dtype(name)
    if _numpy_dtype(name) is None and dtype is None:
        problems.append(f"{key}: unknown manifest dtype {name!r}")
        return None
    if _numpy_dtype(name) is not None or \
            arr.dtype != _bits_dtype(dtype.itemsize):
        problems.append(f"{key}: stored dtype {arr.dtype} cannot hold "
                        f"manifest dtype {name}")
        return None
    bits = torch.from_numpy(arr.view(np.int16) if dtype.itemsize == 2 else arr)
    return bits.view(dtype)


def restore_checkpoint(directory: str, step: int, target: Any,
                       verify: bool = False) -> Any:
    """Load ``target``'s leaves from ``step_<N>/`` -> a tree shaped like
    ``target`` (nested dicts/lists whose leaves have a ``.shape``: arrays,
    tensors), its leaves numpy arrays (extended floats: CPU tensors).

    Raises one aggregated :class:`CheckpointError` naming every target
    leaf absent from the manifest, every manifest leaf absent from the
    target, every unreadable leaf and every shape mismatch (leaf path +
    stored and target shapes).  ``verify=True`` additionally checks each
    leaf's CRC32 before loading it (corruption raises rather than loads).
    """
    src = _step_dir(directory, step)
    manifest = _read_manifest(directory, step)["leaves"]
    target_leaves = {_path_key(p): leaf for p, leaf in _walk(target)}
    problems: List[str] = []
    missing = sorted(set(target_leaves) - set(manifest))
    extra = sorted(set(manifest) - set(target_leaves))
    if missing:
        problems.append("target leaves absent from manifest: "
                        + ", ".join(missing))
    if extra:
        problems.append("manifest leaves absent from target: "
                        + ", ".join(extra))
    loaded: Dict[str, Any] = {}
    for key in target_leaves:
        if key not in manifest:
            continue
        entry = manifest[key]
        try:
            arr = np.load(os.path.join(src, entry["file"]))
        except (OSError, ValueError) as e:
            problems.append(f"{key}: unreadable leaf {entry['file']}: {e!r}")
            continue
        if verify and entry.get("crc32") is not None and \
                _crc(arr) != entry["crc32"]:
            problems.append(f"{key}: CRC32 mismatch in {entry['file']} "
                            "(corrupt leaf)")
            continue
        leaf = _logical(key, arr, entry["dtype"], problems)
        if leaf is not None:
            loaded[key] = leaf
    for key, leaf in target_leaves.items():
        if key in loaded and tuple(loaded[key].shape) != tuple(leaf.shape):
            problems.append(
                f"{key}: checkpoint shape {tuple(loaded[key].shape)} != "
                f"target shape {tuple(leaf.shape)}")
    if problems:
        raise CheckpointError(
            f"cannot restore step {step} from {directory}:\n  "
            + "\n  ".join(problems))
    return _map(lambda p, _: loaded[_path_key(p)], target)


# ---------------------------------------------------------------------------
# async checkpointer
# ---------------------------------------------------------------------------

class AsyncCheckpointer:
    """Background-thread checkpoint writer with bounded in-flight saves.

    ``save`` copies the leaves to host memory on the calling thread — that
    snapshot (plus any back-pressure wait when ``max_in_flight`` writes
    are already queued) is the only stall the training loop pays; the
    ``.npy`` writes, manifest, and atomic commit happen on a single
    background thread, in submission order.  Write errors are re-raised
    on the *next* ``save``/``wait`` call (a background failure must not
    be silently swallowed).

    The JAX package's checkpointer can hand its immutable arrays to the
    thread; the port's parameters and moments are updated in place, so
    ``snapshot`` copies every tensor leaf before ``save`` returns, and a
    numpy leaf must be one the caller no longer changes (the training
    loop passes ``bridge.train_state_to_tree``'s copies: no second copy).

    ``io_error_hook(step)`` is called at the start of each background
    write — the fault-injection seam (``resilience.faults.FaultPlan``
    raises :class:`CheckpointIOError` from it on scheduled steps).
    """

    def __init__(self, directory: str, max_in_flight: int = 2,
                 keep: int = 0,
                 io_error_hook: Optional[Callable[[int], None]] = None):
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        self.directory = directory
        self.keep = keep
        self.io_error_hook = io_error_hook
        self._sem = threading.Semaphore(max_in_flight)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: List[concurrent.futures.Future] = []
        self._lock = threading.Lock()
        self.stats: List[Dict[str, float]] = []   # one row per save

    def _raise_failed(self) -> None:
        with self._lock:
            done = [f for f in self._pending if f.done()]
            self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            exc = f.exception()
            if exc is not None:
                raise exc

    def save(self, step: int, tree: Any,
             meta: Optional[Dict] = None) -> float:
        """Snapshot on-thread, write in the background; returns the stall
        (snapshot + back-pressure) in seconds."""
        self._raise_failed()
        t0 = time.perf_counter()
        snap = snapshot(tree)
        self._sem.acquire()           # bounds queued writes (back-pressure)
        stall = time.perf_counter() - t0
        fut = self._pool.submit(self._write, step, snap, meta, stall)
        with self._lock:
            self._pending.append(fut)
        return stall

    def _write(self, step, snap, meta, stall) -> str:
        t0 = time.perf_counter()
        try:
            if self.io_error_hook is not None:
                self.io_error_hook(step)
            out = write_snapshot(self.directory, step, snap, meta)
            if self.keep > 0:
                gc_checkpoints(self.directory, keep=self.keep)
        finally:
            self._sem.release()
        self.stats.append({"step": step, "stall_s": stall,
                           "write_s": time.perf_counter() - t0})
        return out

    def wait(self) -> None:
        """Block until every queued write committed; re-raise failures."""
        with self._lock:
            pending = list(self._pending)
        concurrent.futures.wait(pending)
        self._raise_failed()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
