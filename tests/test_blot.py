"""Word-Blot tests: simulation oracles for segment discovery (ref: tests/test_blot.py)."""

import numpy as np
import pytest

from biseqt_jax.sequence import Alphabet
from biseqt_jax.stochastics import rand_seq, MutationProcess
from biseqt_jax.blot import (
    band_radius, band_radii, expected_overlap_len,
    WordBlot, WordBlotOverlap, WordBlotLocalRef, WordBlotMultiple,
)

A4 = Alphabet("ACGT")


def test_band_radius_scaling():
    # sqrt scaling in K and g; monotone in sensitivity
    r1 = band_radius(100, 0.1, 0.99)
    r2 = band_radius(400, 0.1, 0.99)
    assert 1.6 <= r2 / r1 <= 2.4  # ~2x for 4x K
    assert band_radius(100, 0.4, 0.99) > r1
    assert band_radius(100, 0.1, 0.999) > r1
    rs = band_radii(range(10, 100, 10), 0.1, 0.99)
    assert (np.diff(rs) >= 0).all()


def test_band_radius_contains_simulated_paths(rng):
    """Planted alignments' diagonal drift stays within the radius ~99%."""
    g = 0.15
    K = 200
    r = band_radius(K, g, sensitivity=0.99)
    M = MutationProcess(A4, subst_probs=0.1, go_prob=g, ge_prob=0.0, rng=rng)
    exceed = 0
    trials = 40
    for _ in range(trials):
        S = rand_seq(A4, K, rng=rng)
        T, tx = M.mutate(S)
        # diagonal drift along the transcript
        d = 0
        dmax = 0
        for op in tx:
            if op == "I":
                d -= 1
            elif op == "D":
                d += 1
            dmax = max(dmax, abs(d))
        if dmax > r:
            exceed += 1
    assert exceed <= max(2, trials * 0.1)


def test_expected_overlap_len():
    assert expected_overlap_len(100, 100, 0, 0.0) == 100
    assert expected_overlap_len(100, 100, 50, 0.0) == 50
    assert expected_overlap_len(100, 100, -30, 0.0) == 70
    assert expected_overlap_len(100, 100, 100, 0.0) == 0
    # gaps lengthen alignments
    assert expected_overlap_len(100, 100, 0, 0.2) > 100
    # vectorized
    out = expected_overlap_len(100, 80, np.array([0, 20, -20]), 0.1)
    assert out.shape == (3,)


def _planted_pair(rng, flank=400, core=400, sub=0.1, gap=0.05):
    """S and T share a mutated core; returns (S, T, core spans)."""
    M = MutationProcess(A4, subst_probs=sub, go_prob=gap, ge_prob=gap,
                        rng=rng)
    c = rand_seq(A4, core, rng=rng)
    c_mut, _ = M.mutate(c)
    S = rand_seq(A4, flank, rng=rng) + c + rand_seq(A4, flank, rng=rng)
    T = rand_seq(A4, flank, rng=rng) + c_mut + rand_seq(A4, flank, rng=rng)
    return S, T, (flank, flank + core), (flank, flank + len(c_mut))


def test_wordblot_finds_planted_segment(rng):
    S, T, (s0, s1), (t0, t1) = _planted_pair(rng)
    wb = WordBlot(S, T, wordlen=8, g_max=0.2)
    segs = list(wb.similar_segments(K_min=150, p_min=0.6))
    assert segs, "planted homology not found"
    # the best segment must overlap the planted core in antidiagonal range
    best = max(segs, key=lambda s: s["num_seeds"])
    (d_lo, d_hi), (a_lo, a_hi) = best["segment"]
    a_core = (s0 + t0, s1 + t1)
    assert a_lo < a_core[1] and a_hi > a_core[0], (best, a_core)
    # the core sits near diagonal s0 - t0 = 0
    assert d_lo <= 0 <= d_hi or abs(d_lo) < 60 or abs(d_hi) < 60
    # match probability estimate should be in a sane range (planted ~0.85)
    assert 0.6 <= best["p"] <= 1.0


def test_wordblot_no_false_positives_on_unrelated(rng):
    S = rand_seq(A4, 1000, rng=rng)
    T = rand_seq(A4, 1000, rng=rng)
    wb = WordBlot(S, T, wordlen=8, g_max=0.2)
    segs = list(wb.similar_segments(K_min=200, p_min=0.8))
    assert segs == []


def test_wordblot_p_estimate_tracks_identity(rng):
    """p̂ should decrease as substitution rate increases."""
    ps = []
    for sub in (0.05, 0.25):
        S, T, _, _ = _planted_pair(rng, flank=150, core=500, sub=sub,
                                   gap=0.02)
        wb = WordBlot(S, T, wordlen=7, g_max=0.15)
        segs = list(wb.similar_segments(K_min=100, p_min=0.3,
                                        at_least_one=True))
        best = max(segs, key=lambda s: s["num_seeds"])
        ps.append(best["p"])
    assert ps[0] > ps[1]


def test_score_num_seeds_discriminates(rng):
    wb = WordBlot(rand_seq(A4, 100, rng=rng), rand_seq(A4, 100, rng=rng),
                  wordlen=8)
    # many seeds in a small band: reject H0 (big S0), consistent with H1
    s0_dense, s1_dense = wb.score_num_seeds(
        num_seeds=50, area=2000, seglen=100, p_match=0.9
    )
    # few seeds: plausible under H0
    s0_sparse, _ = wb.score_num_seeds(
        num_seeds=0, area=2000, seglen=100, p_match=0.9
    )
    assert s0_dense > 20
    assert s0_sparse < 2
    assert s1_dense < 5


def test_overlap_detection(rng):
    """Suffix-prefix overlap between noisy reads is found at the right d."""
    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.04, ge_prob=0.2,
                        rng=rng)
    genome = rand_seq(A4, 1500, rng=rng)
    r1, _ = M.mutate(genome[0:900])
    r2, _ = M.mutate(genome[500:1400])
    wb = WordBlotOverlap(r1, r2, wordlen=8, g_max=0.2)
    res = wb.highest_scoring_overlap_band()
    assert res is not None
    d_lo, d_hi = res["d_band"]
    # true overlap diagonal ~ +500
    assert d_lo - 100 <= 500 <= d_hi + 100, res
    assert res["p"] > 0.4


def test_overlap_rejects_unrelated(rng):
    r1 = rand_seq(A4, 800, rng=rng)
    r2 = rand_seq(A4, 800, rng=rng)
    wb = WordBlotOverlap(r1, r2, wordlen=8, g_max=0.2)
    res = wb.highest_scoring_overlap_band()
    # background seed counts cannot reject H0 -> no significant overlap
    assert res is None


def test_local_ref_matches_pairwise(rng):
    S, T, _, _ = _planted_pair(rng, flank=200, core=300)
    ref = WordBlotLocalRef(T, wordlen=8, g_max=0.2)
    segs_ref = list(ref.similar_segments(S, K_min=100, p_min=0.5))
    wb = WordBlot(S, T, wordlen=8, g_max=0.2)
    segs_pair = list(wb.similar_segments(K_min=100, p_min=0.5))
    assert len(segs_ref) == len(segs_pair)
    if segs_pair:
        b_ref = max(segs_ref, key=lambda s: s["num_seeds"])
        b_pair = max(segs_pair, key=lambda s: s["num_seeds"])
        assert b_ref["num_seeds"] == b_pair["num_seeds"]


def test_local_ref_batch_matches_serial(rng):
    """similar_segments_batch == per-query similar_segments, exactly
    (same candidate assembly, one shared stats dispatch)."""
    _, T, _, _ = _planted_pair(rng, flank=200, core=300)
    ref = WordBlotLocalRef(T, wordlen=8, g_max=0.2)
    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.02, ge_prob=0.05,
                        rng=rng)
    queries = [
        rand_seq(A4, 150, rng=rng) + M.mutate(T[200:500])[0]
        + rand_seq(A4, 100, rng=rng),
        rand_seq(A4, 400, rng=rng),                 # unrelated
        M.mutate(T[100:600])[0],
    ]
    batch = ref.similar_segments_batch(queries, K_min=100, p_min=0.5)
    assert len(batch) == len(queries)
    for q, got in zip(queries, batch):
        want = list(ref.similar_segments(q, K_min=100, p_min=0.5))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a["segment"] == b["segment"]
            assert a["num_seeds"] == b["num_seeds"]
            assert a["p"] == pytest.approx(b["p"], abs=1e-6)
    assert batch[0] and not batch[1] and batch[2]


def test_wordblot_multiple(rng):
    core = rand_seq(A4, 300, rng=rng)
    M = MutationProcess(A4, subst_probs=0.05, go_prob=0.01, ge_prob=0.05,
                        rng=rng)
    seqs = []
    for _ in range(3):
        mut, _ = M.mutate(core)
        seqs.append(
            rand_seq(A4, 100, rng=rng) + mut + rand_seq(A4, 100, rng=rng)
        )
    wbm = WordBlotMultiple(*seqs, wordlen=8, g_max=0.15)
    segs = list(wbm.similar_segments(K_min=80, p_min=0.5))
    assert segs, "3-way homology not found"
    best = max(segs, key=lambda s: s["num_seeds"])
    d_bands, (a_lo, a_hi) = best["segment"]
    assert len(d_bands) == 2
    # core occupies i0 in [100, 400) -> antidiagonal range ~ [200, 800)
    assert a_lo < 800 and a_hi > 200
    # the N-way contract carries the H0/H1 significance pair like the
    # pairwise one; a true 3-way homology rejects H0 decisively
    s0, s1 = best["score"]
    assert s0 >= 25.0
    assert s1 < s0


def test_wordblot_multiple_significance_gate(rng):
    """Background k-mer soup clears p-hat at low p_min (the 1/((N-1)w)
    root compresses tiny densities toward ~0.5) but has no H0 evidence —
    the S0 gate must reject it, and must be the load-bearing filter."""
    seqs = [rand_seq(A4, 500, rng=rng) for _ in range(3)]
    wbm = WordBlotMultiple(*seqs, wordlen=4, g_max=0.15)
    gated = list(wbm.similar_segments(K_min=50, p_min=0.35))
    assert not gated, "unrelated sequences produced 'significant' N-way segments"
    # p-hat alone WOULD false-positive here: without the gate the same
    # sweep yields background runs, proving the gate is doing the work
    ungated = list(wbm.similar_segments(K_min=50, p_min=0.35,
                                        min_score=None))
    assert ungated, (
        "background produced no p-hat-passing runs; the gate test is "
        "vacuous — lower p_min or wordlen"
    )


def test_sparse_segments_match_dense(rng):
    """The sparse (genome-scale) assembler finds the same planted cores."""
    S, T, (s0, s1), (t0, t1) = _planted_pair(rng, flank=300, core=400)
    wb = WordBlot(S, T, wordlen=8, g_max=0.2)
    dense = sorted(wb.similar_segments(K_min=150, p_min=0.6),
                   key=lambda s: -s["num_seeds"])
    try:
        WordBlot.MAX_GRID_CELLS = 1  # force sparse path
        sparse = sorted(wb.similar_segments(K_min=150, p_min=0.6),
                        key=lambda s: -s["num_seeds"])
    finally:
        WordBlot.MAX_GRID_CELLS = 1 << 22
    assert dense and sparse
    bd, bs = dense[0], sparse[0]
    # both recover the same homology region
    (d_lo_d, d_hi_d), (a_lo_d, a_hi_d) = bd["segment"]
    (d_lo_s, d_hi_s), (a_lo_s, a_hi_s) = bs["segment"]
    assert max(a_lo_d, a_lo_s) < min(a_hi_d, a_hi_s)  # a-ranges overlap
    assert max(d_lo_d, d_lo_s) <= min(d_hi_d, d_hi_s) + 50
    assert abs(bd["p"] - bs["p"]) < 0.2


def test_seed_index_persistence(tmp_path, rng):
    from biseqt_jax.seeds import SeedIndex
    S = rand_seq(A4, 200, rng=rng)
    M = MutationProcess(A4, subst_probs=0.1, go_prob=0.03, ge_prob=0.1,
                        rng=rng)
    T, _ = M.mutate(S)
    p = str(tmp_path / "seeds.npz")
    i1 = SeedIndex(S, T, wordlen=6, path=p)
    n1 = len(i1)
    i2 = SeedIndex(S, T, wordlen=6, path=p)  # reloaded from snapshot
    assert len(i2) == n1
    assert i2.seed_count(d_band=(-10, 10)) == i1.seed_count(d_band=(-10, 10))


def test_overlap_ref_matches_pairwise(rng):
    from biseqt_jax.blot import WordBlotOverlapRef
    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.04, ge_prob=0.2,
                        rng=rng)
    genome = rand_seq(A4, 1500, rng=rng)
    r1, _ = M.mutate(genome[0:900])
    r2, _ = M.mutate(genome[500:1400])
    ref = WordBlotOverlapRef(r2, wordlen=8, g_max=0.2)
    res_ref = ref.highest_scoring_overlap_band(r1)
    res_pair = WordBlotOverlap(r1, r2, wordlen=8,
                               g_max=0.2).highest_scoring_overlap_band()
    assert res_ref is not None and res_pair is not None
    assert res_ref["d_band"] == res_pair["d_band"]
    assert res_ref["p"] == pytest.approx(res_pair["p"], abs=1e-6)


def test_score_seeds(rng):
    S, T, _, _ = _planted_pair(rng, flank=200, core=300)
    wb = WordBlot(S, T, wordlen=8, g_max=0.2)
    scored = wb.score_seeds(K=150)
    assert len(scored) == len(wb.seed_index)
    # seeds inside the planted core should score higher p than background
    core_p = [s["p"] for s in scored if 200 <= s["seed"][0] < 500]
    bg_p = [s["p"] for s in scored if s["seed"][0] < 150]
    assert core_p and np.mean(core_p) > (np.mean(bg_p) if bg_p else 0.3)


def test_wordblot_multiple_score_seeds(rng):
    """N-way per-seed scoring: seeds inside a planted 3-way block score
    high p-hat; background-soup seeds (unrelated flanks) score low."""
    core = rand_seq(A4, 300, rng=rng)
    M = MutationProcess(A4, subst_probs=0.03, go_prob=0.01, ge_prob=0.05,
                        rng=rng)
    seqs = []
    for _ in range(3):
        mut, _ = M.mutate(core)
        seqs.append(
            rand_seq(A4, 100, rng=rng) + mut + rand_seq(A4, 100, rng=rng)
        )
    wbm = WordBlotMultiple(*seqs, wordlen=6, g_max=0.15)
    scored = wbm.score_seeds(K=80)
    assert scored, "no N-way seeds scored"
    # every entry mirrors the pairwise contract shape
    for s in scored[:5]:
        assert len(s["seed"]) == 3
        assert s["neighs"] >= 1
        assert 0.0 <= s["p"] <= 1.0
    # seeds whose pivot position lies in the planted core [100, 400)
    # must out-score any background seed
    inside = [s["p"] for s in scored if 100 <= s["seed"][0] < 400]
    outside = [s["p"] for s in scored if not (100 <= s["seed"][0] < 400)]
    assert inside, "no seeds found inside the planted block"
    assert float(np.median(inside)) > 0.5
    if outside:
        assert float(np.median(inside)) > float(np.median(outside))
