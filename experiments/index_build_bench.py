"""Index build + seed enumeration throughput (BASELINE config 3).

1,000 x 10 kbp simulated reads: packs the batch, builds the radix-sorted
k-mer table (the KmerIndex equivalent — ONE device sort replaces all the
reference's SQLite inserts + B-tree build), then runs the all-vs-all
seed-enumeration statistics (the SeedIndex-equivalent join, as diagonal
histograms).  Reports wall-clock per phase and derived rates.

Honest-timing note: device results are materialized to host inside the
timed regions (dispatch is asynchronous).

Usage: python experiments/index_build_bench.py [--reads 1000] [--len 10000]
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

import jax
import jax.numpy as jnp

from biseqt_jax.ops.tables import build_kmer_table
from biseqt_jax.stochastics import rand_seq_batch


def main():
    from biseqt_jax.utils import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1000)
    ap.add_argument("--len", dest="rlen", type=int, default=10000)
    ap.add_argument("--wordlen", type=int, default=8)
    ap.add_argument("--block", type=int, default=64)
    args = ap.parse_args()

    N, L, w = args.reads, args.rlen, args.wordlen
    # FRESH inputs for every timed dispatch: the warmup inputs are
    # already resident, which would flatter the timed run
    codes_w = rand_seq_batch(jax.random.PRNGKey(0), N, L)
    codes = rand_seq_batch(jax.random.PRNGKey(1), N, L)
    lens = jnp.full((N,), L, jnp.int32)
    jax.block_until_ready((codes_w, codes))

    # --- k-mer table build (warm once for compile, then time fresh) ---
    r = build_kmer_table(codes_w, lens, w)
    _ = np.asarray(r[3])
    t0 = time.time()
    keys, seqs, poss, n_valid = build_kmer_table(codes, lens, w)
    n = int(np.asarray(n_valid))
    t_build = time.time() - t0

    # --- full all-vs-all via the sort-join engine ---
    from biseqt_jax.ops.allvsall_sorted import overlap_stats_sorted

    w_join = max(w, 12) if N * L > 2_000_000 else w  # scale-appropriate k
    stats = overlap_stats_sorted(
        codes_w, lens, wordlen=w_join, n_reads=N, bucket=64
    )
    _ = np.asarray(stats["s0"])
    t0 = time.time()
    stats = overlap_stats_sorted(
        codes, lens, wordlen=w_join, n_reads=N, bucket=64
    )
    _ = np.asarray(stats["s0"])
    t_all = time.time() - t0

    print(json.dumps({
        "reads": N, "read_len": L, "wordlen": w,
        "kmers_indexed": n,
        "t_table_build_s": round(t_build, 4),
        "kmers_per_s": round(n / t_build),
        "join_wordlen": w_join,
        "t_all_vs_all_s": round(t_all, 3),
        "pair_scores_per_s": round(N * N / t_all),
        "backend": jax.default_backend(),
    }))


if __name__ == "__main__":
    main()
