"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` is one shared library with a plain C interface
(pointers and sizes in, ``cudaGetLastError()`` out), compiled for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

No PyTorch headers are included, so a build takes seconds.  Libraries land
in ``build/kernels/`` at the repository root, named by a hash of the source
and the flags: a later process reuses a library whose source has not
changed.  ``build_all`` starts one ``nvcc`` per source, all at once.  The
sources come from this package only; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("rmsnorm", "flash_decode", "flash_attention",
           "flash_attention_bf16", "wkv6")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SMEM_LIMIT = 232_448        # bytes of shared memory a Hopper CTA may use

# name -> loaded library; a process loads each library once
_LOADED: Dict[str, ctypes.CDLL] = {}
# launches on bf16 tensors by kernel, beside each module's LAUNCHES (which
# count every launch)
BF16_LAUNCHES: Dict[str, int] = {}


class KernelBuildError(RuntimeError):
    pass


def count_launch(launches: Dict[str, int], name: str,
                 dtype: torch.dtype) -> None:
    """Count one launch of kernel ``name`` on ``dtype`` tensors."""
    launches[name] += 1
    if dtype == torch.bfloat16:
        BF16_LAUNCHES[name] = BF16_LAUNCHES.get(name, 0) + 1


def is_fake(t) -> bool:
    """True for a ``FakeTensor`` (the dry run traces a step under
    ``FakeTensorMode``): a kernel wrapper then takes its shape-only branch,
    which allocates the kernel's outputs and temporaries as its launch
    does, launches nothing and counts nothing.  A real tensor never takes
    it: on a card it launches the kernel or raises, on the CPU it takes
    the plain version."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def on_cpu(t) -> bool:
    """True for a CPU tensor (it takes a kernel's plain version), False for
    a CUDA tensor (it takes the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit PyTorch itself found."""
    cands: List[Optional[str]] = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES, verbose: bool = False
              ) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  -> {name: seconds
    spent building (0.0 when reused)}.  With ``verbose`` the compiler's
    report (``-Xptxas -v``: registers, shared memory, spills) is printed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    took = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if verbose and log:
            print(f"[build] {name}.cu:\n{log.rstrip()}")
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)          # atomic: readers never see half a file
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return took


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; declare each listed
    entry point's argument types (``restype`` is the int error code)."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
