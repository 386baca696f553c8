"""Banded-DP test batches shared by the CPU oracle tests, the card-only
kernel tests and ``chip_smoke.py``.

Each case is one batch over a fixed array shape: per-pair lengths, band
placement (``dmin`` of a ``W``-lane band whose top ``w_eff`` diagonals
are live), codes, and scores.  The kinds cover the geometry the engines
have got wrong before: ragged batches, a band left of the main diagonal,
optima on row 0, empty origins and all-mismatch pairs.
"""

import numpy as np

from biseqt_jax.ops.banded_dp import ModeFlags

FLAGS = {
    "global": ModeFlags(),
    "local": ModeFlags(local_start=True, local_end=True),
    "overlap": ModeFlags(free_start_edges=True, free_end_edges=True),
    "start_anchored": ModeFlags(local_end=True),
    "end_anchored": ModeFlags(local_start=True),
    "start_anchored_overlap": ModeFlags(free_end_edges=True),
    "end_anchored_overlap": ModeFlags(free_start_edges=True),
}
KINDS = ("ragged", "left", "row0", "empty", "mismatch")
B = 6


def unit_subst(A=4):
    return np.where(np.eye(A, dtype=bool), 1.0, -1.0).astype(np.float32)


def make_case(kind, rng, *, L=48, W=128, A=4, subst=None, go=-2.0,
              ge=-1.0, w_max=None):
    """One batch of ``kind``; returns a dict of numpy arrays and scores.
    ``w_max`` caps the live band width (default: about L / 2, so band
    edges cut the matrix)."""
    if subst is None:
        subst = unit_subst(A)
    w_max = min(W, w_max or max(L // 2, 8))
    s = rng.integers(0, A, (B, L)).astype(np.int8)
    t = s.copy()
    flip = rng.random((B, L)) < 0.15
    t[flip] = (t[flip] + rng.integers(1, A, flip.sum())) % A
    sl = rng.integers(L * 2 // 3, L + 1, B).astype(np.int32)
    tl = rng.integers(L * 2 // 3, L + 1, B).astype(np.int32)
    w_eff = rng.integers(max(w_max // 2, 2), w_max + 1, B).astype(np.int32)
    dmax = rng.integers(-w_max // 4, w_max // 2 + 1, B).astype(np.int32)
    if kind == "left":
        # every live diagonal has i < j; the corner lies inside the band
        tl = np.minimum(sl + w_max // 4, L).astype(np.int32)
        dmax = np.full((B,), -1, np.int32)
    elif kind == "row0":
        # nothing matches, so overlap/local optima sit on row 0
        s[:] = 0
        t[:] = 1
        dmax = np.full((B,), 2, np.int32)
        w_eff = np.minimum(tl + 3, W).astype(np.int32)
    elif kind == "empty":
        sl[::2] = 0
        dmax = np.full((B,), 1, np.int32)
        w_eff = np.minimum(tl + 2, W).astype(np.int32)
    elif kind == "mismatch":
        t = (s + 1) % A
    dmin = (dmax - W + 1).astype(np.int32)
    return dict(s=s, t=t, sl=sl, tl=tl, dmin=dmin, w_eff=w_eff, W=W,
                subst=np.asarray(subst, np.float32), go=go, ge=ge)


def band(case, b):
    """Inclusive live diagonal range ``(dmin, dmax)`` of pair ``b``."""
    dmax = int(case["dmin"][b]) + case["W"] - 1
    return dmax - int(case["w_eff"][b]) + 1, dmax


def engine_args(case):
    return ((case["s"], case["t"], case["sl"], case["tl"], case["dmin"]),
            dict(W=case["W"], subst=case["subst"], go=case["go"],
                 ge=case["ge"], w_eff=case["w_eff"]))


def walk(res, case, flags):
    """Transcripts of a with_dirs result, walked by the C++ walker, for
    the pairs with a reachable optimum (``None`` for the others)."""
    from biseqt_jax import native

    live = np.flatnonzero(np.asarray(res.score) > -1e29)
    dmax = case["dmin"] + case["W"] - 1
    ops, si, sj = native.traceback_batch(
        np.asarray(res.dirs)[live], dmax[live], case["s"][live],
        case["t"][live], case["sl"][live], case["tl"][live],
        np.asarray(res.end_i)[live], np.asarray(res.end_j)[live], flags)
    out = [None] * B
    for n, b in enumerate(live):
        out[b] = (ops[n], int(si[n]), int(sj[n]))
    return out


def assert_engines_agree(run_a, run_b, case, flags):
    """Two engines give equal scores, end cells and transcripts."""
    args, kw = engine_args(case)
    a = run_a(*args, flags=flags, with_dirs=True, **kw)
    b = run_b(*args, flags=flags, with_dirs=True, **kw)
    np.testing.assert_array_equal(np.asarray(a.score), np.asarray(b.score))
    for name in ("end_i", "end_j"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    assert walk(a, case, flags) == walk(b, case, flags)
