"""Two-tier protein search (biseqt_jax/protein.py) + reduced alphabets.

The filter tier must be a faithful coarse proxy (homologs score far
above shuffled nulls) and the rescore tier must agree EXACTLY with a
full-matrix-only run on surviving pairs — same engine, same matrix, so
any disagreement is a compaction/padding bug.
"""

import numpy as np
import pytest

from biseqt_jax.matrices import (BLOSUM62, DAYHOFF6_GROUPS,
                                 MURPHY4_GROUPS, MURPHY10_GROUPS,
                                 PROTEIN_LETTERS, compression_map,
                                 protein_alphabet, reduced_alphabet,
                                 reduced_matrix)
from biseqt_jax.ops.banded_dp import ModeFlags, banded_dp
from biseqt_jax.protein import (compress_codes, null_threshold,
                                reduce_seq, two_tier_scores)
from biseqt_jax.sequence import Sequence

import jax.numpy as jnp


@pytest.mark.parametrize(
    "groups", [DAYHOFF6_GROUPS, MURPHY10_GROUPS, MURPHY4_GROUPS])
def test_compression_map_partition(groups):
    cmap = compression_map(groups)
    assert cmap.shape == (20,)
    # every group code hit exactly len(group) times
    for g, members in enumerate(groups):
        assert (cmap == g).sum() == len(members)
        for ch in members:
            assert cmap[PROTEIN_LETTERS.index(ch)] == g


def test_compression_map_rejects_non_partition():
    with pytest.raises(ValueError):
        compression_map(("AGPST", "C"))
    with pytest.raises(ValueError):
        compression_map(DAYHOFF6_GROUPS[:-1] + ("ILMVA",))  # A twice


@pytest.mark.parametrize(
    "groups", [DAYHOFF6_GROUPS, MURPHY10_GROUPS, MURPHY4_GROUPS])
def test_reduced_matrix_properties(groups):
    red = reduced_matrix(BLOSUM62, groups)
    G = len(groups)
    assert red.shape == (G, G)
    assert np.array_equal(red, red.T)
    assert np.array_equal(red, np.round(red))       # integer grid
    # within-group mean similarity must beat the cross-group mean —
    # the whole point of the clustering
    assert np.diagonal(red).mean() > red[~np.eye(G, dtype=bool)].mean()


def test_compress_codes_pads_pass_through():
    cmap = compression_map(DAYHOFF6_GROUPS)
    codes = np.asarray([0, 5, -1, 19, -2], np.int8)
    got = compress_codes(codes, cmap)
    assert got[2] == -1 and got[4] == -2
    assert got[0] == cmap[0] and got[3] == cmap[19]
    gotj = compress_codes(jnp.asarray(codes), cmap)
    np.testing.assert_array_equal(np.asarray(gotj), got)


def test_reduce_seq_roundtrip():
    alpha = protein_alphabet()
    seq = Sequence(alpha, np.asarray(
        [PROTEIN_LETTERS.index(c) for c in "ARNDAGPSTILMV"], np.int8))
    red = reduce_seq(seq)
    assert red.alphabet.letters == reduced_alphabet().letters
    cmap = compression_map()
    np.testing.assert_array_equal(
        red.to_array(), cmap[seq.to_array()])
    # non-protein alphabet refused
    from biseqt_jax.sequence import Alphabet
    with pytest.raises(ValueError):
        reduce_seq(Sequence(Alphabet("ACGT"), np.asarray([0, 1], np.int8)))


def _protein_batch(rng, B=12, L=96, homolog_frac=0.5):
    ss = rng.integers(0, 20, (B, L)).astype(np.int8)
    ts = np.empty_like(ss)
    n_hom = int(B * homolog_frac)
    for b in range(B):
        if b < n_hom:
            ts[b] = ss[b]
            m = rng.random(L) < 0.25
            ts[b, m] = rng.integers(0, 20, int(m.sum()))
        else:
            ts[b] = rng.integers(0, 20, L)
    lens = np.full((B,), L, np.int32)
    dmin = np.full((B,), -32, np.int32)
    w_eff = np.full((B,), 64, np.int32)
    return ss, ts, lens, dmin, w_eff, n_hom


def test_two_tier_matches_full_run(rng):
    """Survivor rescore scores == full-matrix-only scores, and planted
    homologs all survive a null-calibrated threshold."""
    ss, ts, lens, dmin, w_eff, n_hom = _protein_batch(rng)
    flags = ModeFlags(local_start=True, local_end=True)
    kw = dict(W=64, go=-11.0, ge=-1.0, flags=flags)

    # null calibration: shuffled targets through the reduced tier
    from biseqt_jax.matrices import reduced_matrix as rm
    perm = np.stack([rng.permutation(r) for r in ts])
    cmap = compression_map(DAYHOFF6_GROUPS)
    null = banded_dp(
        jnp.asarray(compress_codes(ss, cmap)),
        jnp.asarray(compress_codes(perm, cmap)),
        jnp.asarray(lens), jnp.asarray(lens), jnp.asarray(dmin),
        subst=jnp.asarray(rm(BLOSUM62, DAYHOFF6_GROUPS)),
        w_eff=jnp.asarray(w_eff), **kw)
    thr = null_threshold(np.asarray(null.score), margin=5.0)

    res = two_tier_scores(
        ss, ts, lens, lens, dmin, w_eff=w_eff, threshold=thr,
        engine="lax", **kw)
    # all planted homologs survive the filter
    assert res.survivors[:n_hom].all(), res.reduced_scores
    # exact agreement with the full-only run on survivors
    full = banded_dp(
        jnp.asarray(ss), jnp.asarray(ts), jnp.asarray(lens),
        jnp.asarray(lens), jnp.asarray(dmin),
        subst=jnp.asarray(BLOSUM62), w_eff=jnp.asarray(w_eff), **kw)
    full_np = np.asarray(full.score)
    np.testing.assert_allclose(
        res.full_scores[res.survivor_idx], full_np[res.survivor_idx],
        rtol=0, atol=0)
    # filtered pairs are reported -inf
    dropped = ~res.survivors
    assert np.isinf(res.full_scores[dropped]).all()


def test_two_tier_engine_opts_contract(rng):
    """engine_opts may not shadow arguments two_tier_scores derives
    itself (it used to die three frames down with 'multiple values for
    with_dirs'), and on the lax engine it is forwarded — not silently
    dropped."""
    ss, ts, lens, dmin, w_eff, _ = _protein_batch(
        rng, B=4, homolog_frac=0.0)
    flags = ModeFlags(local_start=True, local_end=True)
    kw = dict(W=64, go=-11.0, ge=-1.0, flags=flags, w_eff=w_eff,
              threshold=1e9)
    with pytest.raises(ValueError, match="with_dirs"):
        two_tier_scores(ss, ts, lens, lens, dmin, engine="lax",
                        engine_opts={"with_dirs": True}, **kw)
    with pytest.raises(TypeError):   # lax engine validates pass-through
        two_tier_scores(ss, ts, lens, lens, dmin, engine="lax",
                        engine_opts={"no_such_option": 1}, **kw)


def test_two_tier_no_survivors(rng):
    ss, ts, lens, dmin, w_eff, _ = _protein_batch(
        rng, B=4, homolog_frac=0.0)
    flags = ModeFlags(local_start=True, local_end=True)
    res = two_tier_scores(
        ss, ts, lens, lens, dmin, w_eff=w_eff, threshold=1e9,
        engine="lax", W=64, go=-11.0, ge=-1.0, flags=flags)
    assert not res.survivors.any() and res.full is None
    assert np.isinf(res.full_scores).all()


def test_two_tier_survivor_transcripts(rng):
    """with_dirs=True: survivors' direction planes walk to the SAME
    transcripts as a direct full-matrix run on those pairs (the
    reference's Aligner contract includes transcripts)."""
    from biseqt_jax import native

    if not native.available():
        pytest.skip("native library unavailable")
    ss, ts, lens, dmin, w_eff, n_hom = _protein_batch(rng, B=8, L=96)
    w_eff = np.full((8,), 100, np.int32)
    dmin = np.full((8,), -40, np.int32)
    flags = ModeFlags(local_start=True, local_end=True)
    kw = dict(W=128, go=-11.0, ge=-1.0, flags=flags)
    res = two_tier_scores(
        ss, ts, lens, lens, dmin, w_eff=w_eff, threshold=100.0,
        with_dirs=True, **kw)
    assert res.survivors[:n_hom].all() and not res.survivors[n_hom:].any()
    S, pad = res.survivor_idx.size, res.survivor_pad
    assert pad.shape[0] >= S and (pad[:S] == res.survivor_idx).all()
    dmax = dmin[pad] + 127
    got_ops, _, _ = native.traceback_batch(
        np.asarray(res.full.dirs), dmax, ss[pad], ts[pad],
        lens[pad], lens[pad], np.asarray(res.full.end_i),
        np.asarray(res.full.end_j), flags)
    # reference: direct full-matrix run on exactly the survivor pairs
    ref = banded_dp(
        jnp.asarray(ss[pad]), jnp.asarray(ts[pad]),
        jnp.asarray(lens[pad]), jnp.asarray(lens[pad]),
        jnp.asarray(dmin[pad]), subst=BLOSUM62,
        w_eff=jnp.asarray(w_eff[pad]), with_dirs=True, **kw)
    ref_ops, _, _ = native.traceback_batch(
        np.asarray(ref.dirs), dmax, ss[pad], ts[pad], lens[pad],
        lens[pad], np.asarray(ref.end_i), np.asarray(ref.end_j), flags)
    for k in range(S):
        assert got_ops[k] == ref_ops[k], k
        assert len(got_ops[k]) > 0


def test_protein_seed_and_extend_reduced_alphabet(rng):
    """Full protein seed-and-extend: Word-Blot DISCOVERS homology on
    Dayhoff-6 reduced codes (reduce_seq feeding the k-mer/seed layers,
    as docs/parity.md claims), then extend_segments rescores the
    candidates on the ORIGINAL 20-letter sequences with BLOSUM62 and
    emits transcripts — the reference's protein workflow end to end.
    Reduction is position-preserving, so discovered (d, a) coordinates
    carry over to the unreduced pair unchanged."""
    from biseqt_jax.blot import WordBlot
    from biseqt_jax.pipeline import extend_segments
    from biseqt_jax.pw import Alignment
    from biseqt_jax.stochastics import MutationProcess, rand_seq

    A20 = protein_alphabet()
    M = MutationProcess(A20, subst_probs=0.15, go_prob=0.02,
                        ge_prob=0.1, rng=rng)
    core = rand_seq(A20, 400, rng=rng)
    S = rand_seq(A20, 200, rng=rng) + core + rand_seq(A20, 200, rng=rng)
    T = (rand_seq(A20, 120, rng=rng) + M.mutate(core)[0]
         + rand_seq(A20, 280, rng=rng))
    redS, redT = reduce_seq(S), reduce_seq(T)
    assert len(redS.alphabet) == 6 and len(redS) == len(S)
    wb = WordBlot(redS, redT, wordlen=6, g_max=0.2)
    segments = list(wb.similar_segments(K_min=150, p_min=0.7))
    assert segments, "reduced-alphabet discovery found nothing"
    out = extend_segments(
        S, T, segments, subst=BLOSUM62, go_score=-11.0, ge_score=-1.0,
        with_transcripts=True)
    best = max(out, key=lambda seg: seg["score"])
    assert best["score"] > 200, best["score"]
    # the transcript rescores to exactly the reported BLOSUM62 score
    aln = Alignment(S, T, best["transcript"],
                    origin_start=best["origin_start"],
                    mutate_start=best["mutate_start"])
    assert aln.calculate_score(BLOSUM62, -11.0, -1.0) == pytest.approx(
        best["score"], abs=1e-2)
    # and it covers most of the planted core
    assert len(best["transcript"]) > 300
    # coordinates land inside the planted homology (core at S[200:600],
    # its mutation at T[120:...])
    assert 150 <= best["origin_start"] <= 650
    assert 70 <= best["mutate_start"] <= 600
