"""Profiling / observability: phase timers, GCUPS counters, jax traces.

The reference had no tracing (SURVEY §5.1); the rebuild's north-star
metric is GCUPS/chip, so counters are first-class here.  ``Phase`` timers
aggregate into a process-wide registry; ``trace`` wraps
``jax.profiler.trace`` when a trace directory is wanted.

Timing caveat baked in: dispatch is asynchronous, so honest wall-clock
needs the device work to finish inside the timed block — ``Phase``
takes an optional ``result`` whose materialization is included.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import numpy as np

__all__ = ["Phase", "counters", "report", "gcups", "trace", "materialize"]

_REGISTRY = defaultdict(
    lambda: {"calls": 0, "seconds": 0.0, "cells": 0, "bytes": 0})


class Phase:
    """Timer context: ``with Phase('extend', cells=n) as ph: ...``.

    ``cells`` accumulates DP-cell counts so :func:`report` can derive
    GCUPS per phase; ``nbytes`` accumulates the bytes a phase moves.  For honest device timing, either materialize
    results to host inside the block yourself or hand them to the phase
    (``ph.result = out``): they are then materialized before the timer
    stops, so async dispatch cannot end the phase early.
    """

    def __init__(self, name: str, cells: int = 0, result=None,
                 nbytes: int = 0):
        self.name = name
        self.cells = int(cells)
        self.nbytes = int(nbytes)
        self.result = result

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if self.result is not None and exc[0] is None:
            materialize(self.result)
        dt = time.time() - self.t0
        entry = _REGISTRY[self.name]
        entry["calls"] += 1
        entry["seconds"] += dt
        entry["cells"] += self.cells
        entry["bytes"] += self.nbytes
        return False


def materialize(x):
    """Force device->host completion of a pytree (honest timing)."""
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a), x)


def gcups(cells: int, seconds: float) -> float:
    return cells / max(seconds, 1e-12) / 1e9


def counters() -> dict:
    return {k: dict(v) for k, v in _REGISTRY.items()}


def report(reset: bool = False) -> str:
    """One JSON line per phase with seconds/calls/GCUPS."""
    lines = []
    for name, v in sorted(_REGISTRY.items()):
        row = {
            "phase": name,
            "calls": v["calls"],
            "seconds": round(v["seconds"], 4),
        }
        if v["cells"]:
            row["gcups"] = round(gcups(v["cells"], v["seconds"]), 3)
        if v["bytes"]:
            row["bytes"] = v["bytes"]
        lines.append(json.dumps(row))
    if reset:
        _REGISTRY.clear()
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = None):
    """jax.profiler trace when a directory is given, no-op otherwise."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
