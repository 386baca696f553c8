"""All-vs-all overlap detection accuracy (BASELINE config 4).

Simulates noisy long reads (PacBio-like 10-15% error) tiled over a
genome, runs the mesh-sharded overlap pipeline, and reports
precision/recall of true overlaps plus diagonal estimation error.

Usage: python experiments/overlap_recall.py [--quick]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from biseqt_jax.sequence import Alphabet, pack_sequences
from biseqt_jax.stochastics import rand_seq, MutationProcess
from biseqt_jax.parallel.allvsall import overlap_matrix_sharded
from biseqt_jax.parallel import make_mesh
from biseqt_jax.utils import with_dumpfile

A4 = Alphabet("ACGT")


def simulate_reads(rng, genome_len=20000, read_len=3000, n_reads=24,
                   err=0.12):
    M = MutationProcess(A4, subst_probs=err * 0.6, go_prob=err * 0.2,
                        ge_prob=err * 0.5, rng=rng)
    genome = rand_seq(A4, genome_len, rng=rng)
    reads, starts = [], []
    for _ in range(n_reads):
        start = int(rng.integers(0, genome_len - read_len))
        r, _ = M.mutate(genome[start:start + read_len])
        reads.append(r)
        starts.append(start)
    return reads, starts


def true_overlap(starts, read_len, q, t, min_olap):
    o = read_len - abs(starts[q] - starts[t])
    return o >= min_olap


def ambiguous_overlap(starts, read_len, q, t, min_olap, wordlen):
    """True overlap exists but is below the labeling threshold —
    detecting it is correct behavior, not a false positive; such pairs
    are excluded from precision/recall accounting."""
    o = read_len - abs(starts[q] - starts[t])
    return 2 * wordlen < o < min_olap


@with_dumpfile
def run(genome_len=20000, read_len=3000, n_reads=24, err=0.12,
        wordlen=8, min_olap=500, min_score=60.0, min_p=0.4, seed=0,
        engine="mesh", min_window=5):
    rng = np.random.default_rng(seed)
    reads, starts = simulate_reads(rng, genome_len, read_len, n_reads, err)
    codes, lens = pack_sequences(reads)
    if engine == "sorted":
        # the at-scale sort-join engine (the one measured at 1000 x 1000
        # reads in BASELINE config 4); same stats contract
        from biseqt_jax.ops.allvsall_sorted import (
            overlap_stats_sorted_chunked,
        )
        import jax.numpy as jnp

        stats = overlap_stats_sorted_chunked(
            jnp.asarray(codes), jnp.asarray(lens), wordlen=wordlen,
            n_reads=n_reads, min_window=min_window,
        )
        stats = {k: np.asarray(v) for k, v in stats.items()}
    else:
        stats = overlap_matrix_sharded(
            codes, lens, wordlen=wordlen, mesh=make_mesh()
        )
    tp = fp = fn = 0
    d_errs = []
    for q in range(n_reads):
        for t in range(q + 1, n_reads):
            if ambiguous_overlap(starts, read_len, q, t, min_olap, wordlen):
                continue
            pred = (stats["s0"][q, t] >= min_score
                    and stats["p"][q, t] >= min_p
                    and stats["olap_len"][q, t] >= min_olap // 2)
            truth = true_overlap(starts, read_len, q, t, min_olap)
            if pred and truth:
                tp += 1
                d_errs.append(
                    abs(int(stats["diag"][q, t])
                        - (starts[t] - starts[q]))
                )
            elif pred:
                fp += 1
            elif truth:
                fn += 1
    return {
        "n_reads": n_reads, "err": err,
        # no predictions => precision is undefined (None), not 0.0 —
        # "made no calls" must not read as "every call wrong"
        "precision": tp / (tp + fp) if (tp + fp) else None,
        "recall": tp / max(tp + fn, 1),
        "n_predictions": tp + fp,
        "diag_mae": float(np.mean(d_errs)) if d_errs else None,
    }


def main():
    from biseqt_jax.utils import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="BASELINE config-4 error sweep: 10/12/15%% error "
                         "at 1000 reads through the sort-join engine")
    ap.add_argument("--n-reads", type=int, default=1000)
    ap.add_argument("--min-window", type=int, default=5)
    ap.add_argument("--dumpfile", default=None)
    ap.add_argument("--plot", nargs="?", const="overlap_pr.png",
                    default=None, metavar="PNG",
                    help="with --sweep: render precision/recall vs error "
                         "bars (per-rate dumpfiles cache the sweep: pass "
                         "--dumpfile PREFIX to skip recompute)")
    args = ap.parse_args()
    if args.sweep:
        import time
        rows = []
        for err in (0.10, 0.12, 0.15):
            t0 = time.time()
            dump = ("%s.err%d.pkl" % (args.dumpfile, int(err * 100))
                    if args.dumpfile else None)
            row = run(
                genome_len=100_000, read_len=3000, n_reads=args.n_reads,
                err=err, engine="sorted", min_window=args.min_window,
                seed=int(err * 1000), dumpfile=dump,
            )
            row["elapsed_s"] = round(time.time() - t0, 1)
            row["min_window"] = args.min_window
            rows.append(row)
            print(json.dumps(row))
        if args.plot:
            from figures import plot_overlap_pr

            plot_overlap_pr(rows, args.plot)
        return
    kw = {}
    if args.quick:
        kw = dict(genome_len=8000, read_len=1500, n_reads=12)
    print(json.dumps(run(dumpfile=args.dumpfile, **kw)))


if __name__ == "__main__":
    main()
