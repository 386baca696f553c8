"""Experiment utilities (analog of the reference's experiments/util.py).

Re-exports the result-caching decorator and provides plotting helpers that
degrade gracefully when matplotlib is absent.
"""

import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)  # repo root on path

from biseqt_jax.utils import with_dumpfile, ProgressIndicator, Timer  # noqa

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAVE_MPL = True
except Exception:  # pragma: no cover
    plt = None
    HAVE_MPL = False


def plot_with_sd(ax, xs, ys_runs, label=None, **kw):
    """Plot mean ± sd across runs (axis 0 of ys_runs)."""
    ys = np.asarray(ys_runs, float)
    mean = ys.mean(axis=0)
    sd = ys.std(axis=0)
    ax.plot(xs, mean, label=label, **kw)
    ax.fill_between(xs, mean - sd, mean + sd, alpha=0.2)


def savefig(fig, path):
    if HAVE_MPL:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        print("wrote", path)
