"""Repo-root-anchored result paths (a copy of the JAX package's
``perf/paths.py``).

The perf tools read ``results/...`` artifacts.  Globbing those relative
to the *current working directory* silently produces empty tables when
the tools run from anywhere but the repo root — so every consumer
resolves through here instead: relative paths anchor at the repository
root (three levels above this package: src/repro_torch/perf -> repo).
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def from_root(*parts: str) -> str:
    """Join ``parts`` under the repo root; absolute inputs pass through."""
    path = os.path.join(*parts)
    if os.path.isabs(path):
        return path
    return os.path.join(REPO_ROOT, path)


def results_path(*parts: str) -> str:
    """``results/<parts...>`` anchored at the repo root."""
    return from_root("results", *parts)
