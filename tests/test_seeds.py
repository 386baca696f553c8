"""Seed index tests (ref strategy: tests/test_seeds.py)."""

import numpy as np
import pytest

from biseqt_jax.sequence import Alphabet, Sequence
from biseqt_jax.stochastics import rand_seq, MutationProcess
from biseqt_jax.seeds import SeedIndex, SeedIndexMultiple, Seed
from biseqt_jax.kmers import as_kmer_seq

A4 = Alphabet("ACGT")


def brute_force_seeds(S, T, w):
    out = set()
    ks = as_kmer_seq(S, w)
    kt = as_kmer_seq(T, w)
    for i, a in enumerate(ks):
        for j, b in enumerate(kt):
            if a == b:
                out.add((i, j))
    return out


def test_seed_enumeration_matches_bruteforce(rng):
    for trial in range(4):
        S = rand_seq(A4, 60 + 10 * trial, rng=rng)
        T = rand_seq(A4, 50 + 10 * trial, rng=rng)
        idx = SeedIndex(S, T, wordlen=3)
        got = set((s.i, s.j) for s in idx.seeds())
        assert got == brute_force_seeds(S, T, 3), trial
        assert len(idx) == len(got)


def test_identity_seeds_on_diagonal(rng):
    S = rand_seq(A4, 80, rng=rng)
    idx = SeedIndex(S, S, wordlen=8)
    # the main diagonal must contain all |S|-w+1 trivial self-seeds
    n_diag = idx.seed_count(d_band=(0, 0))
    assert n_diag == len(S) - 8 + 1
    # d_band query excludes off-diagonal seeds correctly
    total = idx.seed_count()
    off = idx.seed_count(d_band=(1, len(S)))
    neg = idx.seed_count(d_band=(-len(S), -1))
    assert n_diag + off + neg == total


def test_band_queries(rng):
    S = rand_seq(A4, 100, rng=rng)
    M = MutationProcess(A4, subst_probs=0.1, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    T, _ = M.mutate(S)
    idx = SeedIndex(S, T, wordlen=6)
    # seeds from the homology concentrate near d=0
    near = idx.seed_count(d_band=(-15, 15))
    assert near >= 5
    # a_band intersects d_band consistently
    n_both = idx.seed_count(d_band=(-15, 15), a_band=(0, 100))
    n_rest = idx.seed_count(d_band=(-15, 15), a_band=(101, 400))
    assert n_both + n_rest == near
    # seeds() respects bands
    for s in idx.seeds(d_band=(-15, 15)):
        assert -15 <= s.i - s.j <= 15


def test_seed_count_by_diagonal(rng):
    S = rand_seq(A4, 60, rng=rng)
    idx = SeedIndex(S, S, wordlen=5)
    counts = idx.seed_count_by_d_()
    lt = len(S)
    assert counts[lt] == len(S) - 4  # main diagonal at d_ = 0 + |T|
    assert counts.sum() == len(idx)


def test_seed_index_multiple(rng):
    core = rand_seq(A4, 30, rng=rng)
    M = MutationProcess(A4, subst_probs=0.05, go_prob=0.0, ge_prob=0.0,
                        rng=rng)
    seqs = []
    for _ in range(3):
        mut, _ = M.mutate(core)
        seqs.append(rand_seq(A4, 20, rng=rng) + mut + rand_seq(A4, 20, rng=rng))
    idx = SeedIndexMultiple(*seqs, wordlen=6)
    assert len(idx) > 0
    # every reported seed tuple is a real 3-way k-mer match
    for tup in idx.seeds()[:20]:
        kms = [
            as_kmer_seq(seqs[n], 6)[tup[n]] for n in range(3)
        ]
        assert len(set(kms)) == 1


def test_seed_namedtuple():
    s = Seed(3, 5)
    assert s.i == 3 and s.j == 5
    assert s == (3, 5)


def test_seed_index_multiple_device_tier_matches_host(rng):
    """Device N-way tier == host dict tier for max_hits in {1, 2, 4} on
    inputs where shared k-mers REPEAT (so cross products actually fan
    out) — both tiers implement capped cross products of the first h
    positions per sequence."""
    from biseqt_jax.seeds import SeedIndexMultiple
    from biseqt_jax.stochastics import MutationProcess

    M = MutationProcess(A4, subst_probs=0.05, go_prob=0.02, ge_prob=0.05,
                        rng=rng)
    core = rand_seq(A4, 400, rng=rng)
    # planting the (mutated) core TWICE per sequence makes many shared
    # k-mers multi-hit in every sequence, so h > 1 diverges from h = 1
    seqs = [rand_seq(A4, 100, rng=rng) + M.mutate(core)[0]
            + rand_seq(A4, 150, rng=rng) + M.mutate(core)[0]
            + rand_seq(A4, 80, rng=rng) for _ in range(4)]
    sizes = []
    for h in (1, 2, 4):
        dev = SeedIndexMultiple(*seqs, wordlen=8, max_hits_per_kmer=h,
                                device=True)
        host = SeedIndexMultiple(*seqs, wordlen=8, max_hits_per_kmer=h,
                                 device=False)
        assert dev.seeds() == host.seeds(), h
        sizes.append(len(dev))
    assert sizes[0] > 30  # the planted cores yield many shared k-mers
    # repeats must actually fan out, or this test is vacuous at h > 1
    assert sizes[0] < sizes[1] < sizes[2]


def test_seed_index_multiple_tuple_budget(rng):
    """One low-complexity k-mer saturating the per-sequence cap in every
    sequence would expand to h^N tuples (N=6, h=8 -> 262k; at the
    config-1b N=10 it is ~1e9 — a host OOM).  The per-k-mer tuple budget
    must bound the expansion, identically on both tiers."""

    N = 6
    polyA = Sequence(A4, [0] * 60)          # ~50 copies of the AAAA k-mer
    seqs = [rand_seq(A4, 120, rng=rng) + polyA + rand_seq(A4, 120, rng=rng)
            for _ in range(N)]
    kw = dict(wordlen=8, max_hits_per_kmer=8, max_tuples_per_kmer=500)
    dev = SeedIndexMultiple(*seqs, device=True, **kw)
    host = SeedIndexMultiple(*seqs, device=False, **kw)
    assert dev.seeds() == host.seeds()
    # every k-mer's cross product fits the budget: with h'=2 the poly-A
    # k-mer yields 2^6 = 64 <= 500 (h'=3 would be 729 > 500)
    assert 0 < len(dev) < 5000
    # and an UNBUDGETED run at these sizes would have been ~8^6 = 262k
    # for the poly-A k-mer alone
    big = SeedIndexMultiple(*seqs, device=True, wordlen=8,
                            max_hits_per_kmer=8,
                            max_tuples_per_kmer=1 << 30)
    assert len(big) > 200_000
