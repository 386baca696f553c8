"""Fixed-reference Word-Blot throughput (many queries vs one reference).

Measures the point of ``WordBlotLocalRef``/``WordBlotOverlapRef``
(reference ``biseqt/blot.py — WordBlotLocalRef``): the reference's k-mer
index is built ONCE (device radix sort at genome scale), then many
queries stream through host-side searchsorted serving with no per-query
device round-trip.  Default config: 100 x 10 kbp queries against a
5 Mbp reference — each query is a mutated copy of a random reference
locus, and recall = fraction of queries whose top reported segment's
diagonal band contains the true locus.

Usage: python experiments/fixed_ref_bench.py [--quick]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from biseqt_jax.sequence import Alphabet
from biseqt_jax.stochastics import rand_seq, MutationProcess
from biseqt_jax.blot import WordBlotLocalRef

A4 = Alphabet("ACGT")


def make_inputs(rng, ref_len, n_queries, query_len, err):
    ref = rand_seq(A4, ref_len, rng=rng)
    M = MutationProcess(A4, subst_probs=err * 0.6, go_prob=err * 0.2,
                        ge_prob=err * 0.5, rng=rng)
    queries, loci = [], []
    for _ in range(n_queries):
        r0 = int(rng.integers(0, ref_len - query_len))
        mut, _ = M.mutate(ref[r0:r0 + query_len])
        queries.append(mut)
        loci.append(r0)
    return ref, queries, loci


def run(ref_len=5_000_000, n_queries=100, query_len=10_000, err=0.10,
        wordlen=12, K_min=2000, p_min=0.5, seed=0):
    rng = np.random.default_rng(seed)
    ref, queries, loci = make_inputs(rng, ref_len, n_queries, query_len,
                                     err)
    t0 = time.time()
    wb = WordBlotLocalRef(ref, wordlen=wordlen, g_max=0.25)
    t_index = time.time() - t0

    # first query separately: it pays the per-shape compiles of
    # the grid scatter + stats launches; the rest reuse them
    def one(q):
        segs = sorted(
            wb.similar_segments(q, K_min=K_min, p_min=p_min),
            key=lambda s: -s["num_seeds"],
        )
        return segs[0] if segs else None

    t0 = time.time()
    tops = [one(queries[0])]
    t_first = time.time() - t0
    t0 = time.time()
    tops += [one(q) for q in queries[1:]]
    t_query = time.time() - t0

    # batch API: every query's candidate assembly is host work at this
    # ref scale; ONE shared stats dispatch replaces the per-query one
    t0 = time.time()
    batch = wb.similar_segments_batch(queries, K_min=K_min, p_min=p_min)
    t_batch = time.time() - t0
    tops_b = [
        max(segs, key=lambda s: s["num_seeds"]) if segs else None
        for segs in batch
    ]
    assert all(
        (a is None and b is None) or a["segment"] == b["segment"]
        for a, b in zip(tops, tops_b)
    ), "batch API diverged from the serial API"

    radius = 200  # generous d tolerance: band quantization is ~r(K_min)
    hit = 0
    for top, r0 in zip(tops, loci):
        if top is None:
            continue
        d_lo, d_hi = top["segment"][0]
        # query is S, reference is T: the planted locus lies on d ~= -r0
        if d_lo - radius <= -r0 <= d_hi + radius:
            hit += 1
    return {
        "ref_len": ref_len, "n_queries": n_queries,
        "query_len": query_len, "err": err, "wordlen": wordlen,
        "index_s": round(t_index, 2),
        "first_query_s": round(t_first, 2),
        "query_total_s": round(t_query, 2),
        "queries_per_s": round(
            (n_queries - 1) / max(t_query, 1e-9), 2),
        "batch_total_s": round(t_batch, 2),
        "batch_queries_per_s": round(n_queries / max(t_batch, 1e-9), 2),
        "locus_recall": hit / n_queries,
    }


def main():
    from biseqt_jax.utils import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    kw = {}
    if args.quick:
        kw = dict(ref_len=200_000, n_queries=10, query_len=5_000,
                  wordlen=10, K_min=1000)
    print(json.dumps(run(**kw)))


if __name__ == "__main__":
    main()
