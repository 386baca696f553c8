"""N-way multiple-homology demo: 10 sequences x ~100 kbp (device tier).

VERDICT round-1 item #10: demonstrate WordBlotMultiple at real scale.
Ten sequences share two planted homologous blocks (low divergence, as in
conserved elements); the device N-way seed tier (one radix sort over all
10 sequences + scatter-min) replaces the host dict/cross-product loops
that only worked at toy sizes.

Usage: python experiments/multiple_homology.py [n_seqs] [block_len]
Prints one JSON line with timings + recall.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from biseqt_jax.sequence import Alphabet
from biseqt_jax.stochastics import rand_seq, MutationProcess
from biseqt_jax.blot import WordBlotMultiple

A4 = Alphabet("ACGT")


def main():
    from biseqt_jax.utils import enable_compile_cache

    enable_compile_cache()
    n_seqs = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    blk = int(sys.argv[2]) if len(sys.argv) > 2 else 20_000
    rng = np.random.default_rng(7)
    M = MutationProcess(A4, subst_probs=0.03, go_prob=0.005, ge_prob=0.02,
                        rng=rng)
    core1 = rand_seq(A4, blk, rng=rng)
    core2 = rand_seq(A4, blk, rng=rng)
    seqs = []
    pivot_blocks = []
    for n in range(n_seqs):
        flank = lambda: rand_seq(A4, int(rng.integers(15_000, 25_000)),
                                 rng=rng)
        f1, f2, f3 = flank(), flank(), flank()
        b1, _ = M.mutate(core1)
        b2, _ = M.mutate(core2)
        seqs.append(f1 + b1 + f2 + b2 + f3)
        if n == 0:
            pivot_blocks = [
                (len(f1), len(f1) + len(b1)),
                (len(f1) + len(b1) + len(f2),
                 len(f1) + len(b1) + len(f2) + len(b2)),
            ]
    total = sum(len(s) for s in seqs)

    t0 = time.time()
    wbm = WordBlotMultiple(*seqs, wordlen=12)
    t_index = time.time() - t0
    n_seeds = len(wbm.seed_index)

    t0 = time.time()
    segs = list(wbm.similar_segments(K_min=5000, p_min=0.75))
    t_disc = time.time() - t0

    # recall: each planted block must be covered by a segment whose
    # pivot-coordinate extent (i0 ~ a/2 near d-tuple 0... use the a-range
    # of the pivot: a = i0 + j1 ~ 2*i0 for near-equal positions) overlaps
    hits = [False, False]
    for seg in segs:
        a_lo, a_hi = seg["segment"][1]
        i_lo, i_hi = a_lo // 2, a_hi // 2  # pivot position range (approx)
        for bi, (lo, hi) in enumerate(pivot_blocks):
            if i_lo < hi and i_hi > lo:
                hits[bi] = True
    print(json.dumps({
        "n_seqs": n_seqs, "total_bp": total, "n_way_seeds": n_seeds,
        "index_s": round(t_index, 2), "discover_s": round(t_disc, 2),
        "n_segments": len(segs),
        "block_recall": sum(hits) / 2.0,
        "ps": [round(s["p"], 3) for s in segs[:6]],
    }))


if __name__ == "__main__":
    main()
