#!/usr/bin/env python3
"""Where the test suite's time goes: a junit report's seconds per file,
and what a fresh process of the port's dry run costs to start.

    PYTHONPATH=src python suite_time.py junit RUN.xml [PARENT.xml]
    PYTHONPATH=src python suite_time.py children

``junit`` sums each test file's seconds (pytest's junit report counts a
test's setup, call and teardown, so a module fixture's seconds land on
its first test), splits the port's files (``test_torch_*``) from the JAX
package's, counts passes, and with a second report prints both side by
side, the port's ratio first.  Write the report with the suite's own
command (``--junitxml``).

``children`` times one ``ProcessPoolExecutor(1)`` child from submit to
result, running a function of ``repro_torch.launch.dryrun``, started by
``spawn`` (a fresh interpreter importing torch and the port) and forked
from the dry run's preloaded ``forkserver`` (``dryrun.fresh_context``),
three in a row, twice each, alternating: the first fork pays the
server's start.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import multiprocessing
import time
import xml.etree.ElementTree as ET


def load(path):
    """({file: seconds}, {outcome: count}) of a junit report."""
    seconds, outcomes = collections.Counter(), collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        name = case.get("classname", "").split(".")
        seconds[name[1] if name[0] == "tests" else ".".join(name)] += \
            float(case.get("time", 0))
        tags = {child.tag for child in case}
        outcomes["failed" if tags & {"failure", "error"} else
                 "skipped" if "skipped" in tags else "passed"] += 1
    return seconds, outcomes


def _split(seconds):
    port = sum(v for k, v in seconds.items() if k.startswith("test_torch_"))
    return port, sum(seconds.values()) - port


def junit(run, parent=None):
    runs = [load(run)] + ([load(parent)] if parent else [])
    for label, (seconds, outcomes) in zip(("run", "parent"), runs):
        port, jax = _split(seconds)
        print(f"{label}: port files {port:.1f} s, JAX files {jax:.1f} s, "
              f"{dict(outcomes)}")
    if parent:
        print(f"port ratio {_split(runs[0][0])[0] / _split(runs[1][0])[0]:.3f}")
    files = sorted(set().union(*(s for s, _ in runs)),
                   key=lambda f: (not f.startswith("test_torch_"),
                                  -runs[0][0][f]))
    for f in files:
        print(f"{f:34s}" + "".join(f" {s[f]:8.1f}" for s, _ in runs))


def children():
    from repro_torch.launch import dryrun
    shape = dryrun.SHAPES["train_4k"]
    took = collections.defaultdict(list)
    for method in ("spawn", "forkserver") * 2:
        ctx = (dryrun.fresh_context() if method == "forkserver"
               else multiprocessing.get_context(method))
        for _ in range(3):
            t0 = time.perf_counter()
            with concurrent.futures.ProcessPoolExecutor(
                    1, mp_context=ctx) as ex:
                ex.submit(dryrun.skip_reason, "qwen3-0.6b", shape).result()
            took[method].append(round(time.perf_counter() - t0, 3))
    for method, seconds in took.items():
        print(f"{method}: {seconds} s a child")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    j = sub.add_parser("junit")
    j.add_argument("run")
    j.add_argument("parent", nargs="?")
    sub.add_parser("children")
    args = ap.parse_args(argv)
    if args.cmd == "junit":
        junit(args.run, args.parent)
    else:
        children()


if __name__ == "__main__":
    main()
