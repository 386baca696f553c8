"""BASELINE config 7p: end-to-end two-tier protein search.

Workload: B query x ref banded local alignments of 2 kb-residue protein
pairs under BLOSUM62 (go=-11, ge=-1, band 100) — the reference served
this through the same ``pw.Aligner`` contract at full scalar speed
(``pwlib — alnscores`` takes any matrix).  The two-tier path
(biseqt_jax/protein.py) filters under a reduced alphabet and rescores
survivors under full BLOSUM62; both tiers and the single-pass run use
the engine the platform selects (``ops.engine``).

Planted truth: 10% of pairs are homologs (25% residue substitutions);
the rest are unrelated.  Reported: filter/full/two-tier GCUPS, the
two-tier speedup over full-only, survivor fraction, homolog recall, and
exact-score agreement of the rescore tier with a full-only run.  Each
leg runs on its own fresh batches and is timed to ``block_until_ready``.

Usage: python experiments/protein_search.py [--quick] [--murphy10]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from biseqt_jax.matrices import (BLOSUM62, DAYHOFF6_GROUPS,
                                 MURPHY4_GROUPS, MURPHY10_GROUPS,
                                 reduced_matrix, compression_map)
from biseqt_jax.ops.banded_dp import ModeFlags
from biseqt_jax.ops.engine import banded_dp_auto
from biseqt_jax.protein import (compress_codes, null_threshold,
                                two_tier_scores)
from biseqt_jax.utils import enable_compile_cache


def mk_batch(rng, B, L, hom_frac=0.1, sub_rate=0.25):
    ss = rng.integers(0, 20, (B, L), dtype=np.int8)
    ts = rng.integers(0, 20, (B, L), dtype=np.int8)
    n_hom = int(B * hom_frac)
    hom = rng.permutation(B)[:n_hom]
    ts[hom] = ss[hom]
    m = rng.random((n_hom, L)) < sub_rate
    ts[hom] = np.where(
        m, rng.integers(0, 20, (n_hom, L), dtype=np.int8), ts[hom])
    is_hom = np.zeros(B, bool)
    is_hom[hom] = True
    return ss, ts, is_hom


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--murphy10", action="store_true")
    ap.add_argument("--murphy4", action="store_true")
    ap.add_argument("--B", type=int, default=16384)
    ap.add_argument("--L", type=int, default=2048)
    args = ap.parse_args()
    enable_compile_cache()
    B, L = (1024, 512) if args.quick else (args.B, args.L)
    BW, W = 100, 128
    groups = (MURPHY4_GROUPS if args.murphy4
              else MURPHY10_GROUPS if args.murphy10
              else DAYHOFF6_GROUPS)
    go, ge = -11.0, -1.0
    flags = ModeFlags(local_start=True, local_end=True)
    lens = np.full((B,), L, np.int32)
    dmin = np.full((B,), BW // 2 - W + 1, np.int32)
    w_eff = np.full((B,), BW, np.int32)
    kw = dict(W=W, go=go, ge=ge, flags=flags)
    cells = B * L * BW
    rng = np.random.default_rng(11)
    cmap = compression_map(groups)
    red = reduced_matrix(BLOSUM62, groups)

    def run(a, b, mat):
        return banded_dp_auto(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(lens),
            jnp.asarray(lens), jnp.asarray(dmin), subst=mat,
            w_eff=jnp.asarray(w_eff), **kw).score.block_until_ready()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    # null calibration (shuffled pairs, reduced tier)
    ns, nt, _ = mk_batch(rng, B, L, hom_frac=0.0)
    null = run(compress_codes(ns, cmap), compress_codes(nt, cmap), red)
    thr = null_threshold(np.asarray(null), margin=5.0)
    out = {"config": "7p", "B": B, "L": L, "BW": BW,
           "groups": ("murphy4" if args.murphy4
                      else "murphy10" if args.murphy10 else "dayhoff6"),
           "threshold": round(thr, 1)}

    warm = mk_batch(rng, B, L)
    run(*warm[:2], BLOSUM62)                                  # compile
    two_tier_scores(warm[0], warm[1], lens, lens, dmin, w_eff=w_eff,
                    threshold=thr, groups=groups, **kw)
    ss, ts, _ = mk_batch(rng, B, L)
    _, dt_full = timed(lambda: run(ss, ts, BLOSUM62))
    ss, ts, _ = mk_batch(rng, B, L)
    _, dt_filt = timed(lambda: run(compress_codes(ss, cmap),
                                   compress_codes(ts, cmap), red))
    ss, ts, is_hom = mk_batch(rng, B, L)
    res, dt_tt = timed(lambda: two_tier_scores(
        ss, ts, lens, lens, dmin, w_eff=w_eff, threshold=thr,
        groups=groups, **kw))
    out["gcups_full_only"] = round(cells / dt_full / 1e9, 2)
    out["gcups_filter"] = round(cells / dt_filt / 1e9, 2)
    out["gcups_two_tier"] = round(cells / dt_tt / 1e9, 2)
    out["speedup_vs_full_only"] = round(dt_full / dt_tt, 2)

    # accuracy on the two-tier leg's batch (untimed)
    full = np.asarray(run(ss, ts, BLOSUM62))
    idx = res.survivor_idx
    out["homolog_recall"] = round(float(res.survivors[is_hom].mean()), 4)
    out["survivor_frac"] = round(float(res.survivors.mean()), 4)
    out["rescore_exact"] = bool(np.array_equal(res.full_scores[idx],
                                               full[idx]))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
