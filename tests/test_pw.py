"""Alignment engine tests: vectorized wavefront DP vs naive numpy oracle.

Mirrors the reference's simulation-oracle test strategy (SURVEY.md §4):
random pairs + planted mutations, scores checked against the O(nm) oracle,
transcripts checked by re-scoring (any optimal path is acceptable).
"""

import numpy as np
import pytest

from biseqt_jax.sequence import Alphabet, Sequence
from biseqt_jax.stochastics import MutationProcess, rand_seq
from biseqt_jax import pw
from biseqt_jax.pw import Aligner, Alignment

from oracle import dp_oracle

A4 = Alphabet("ACGT")

STD_CASES = [
    (pw.GLOBAL, dict()),
    (pw.LOCAL, dict(local_start=True, local_end=True)),
    (pw.OVERLAP, dict(free_start_edges=True, free_end_edges=True)),
    (pw.START_ANCHORED, dict(local_end=True)),
    (pw.END_ANCHORED, dict(local_start=True)),
    (pw.START_ANCHORED_OVERLAP, dict(free_end_edges=True)),
    (pw.END_ANCHORED_OVERLAP, dict(free_start_edges=True)),
]


def random_pair(rng, n=30, sub=0.15, go=0.08, ge=0.3):
    S = rand_seq(A4, n, rng=rng)
    M = MutationProcess(A4, subst_probs=sub, go_prob=go, ge_prob=ge, rng=rng)
    T, tx = M.mutate(S)
    return S, T, tx


@pytest.mark.parametrize("alntype,flags", STD_CASES)
def test_std_modes_match_oracle(rng, alntype, flags):
    for trial in range(8):
        S, T, _ = random_pair(rng, n=20 + trial * 7)
        go, ge = -2.5, -1.0
        with Aligner(S, T, alnmode=pw.STD_MODE, alntype=alntype,
                     go_score=go, ge_score=ge) as aln:
            score = aln.solve()
            subst = aln.subst_scores
            expect = dp_oracle(
                S.contents, T.contents, subst, go, ge, **flags
            )
            assert score == pytest.approx(expect, abs=1e-3), (
                alntype, trial, len(S), len(T)
            )


@pytest.mark.parametrize("alntype,flags", [
    (pw.B_GLOBAL, dict()),
    (pw.B_LOCAL, dict(local_start=True, local_end=True)),
    (pw.B_OVERLAP, dict(free_start_edges=True, free_end_edges=True)),
])
def test_banded_modes_match_oracle(rng, alntype, flags):
    for trial in range(8):
        S, T, _ = random_pair(rng, n=25 + trial * 5)
        go, ge = -2.5, -1.0
        d0 = len(S) - len(T)
        dmin, dmax = min(d0, 0) - 6, max(d0, 0) + 6
        with Aligner(S, T, alnmode=pw.BANDED_MODE, alntype=alntype,
                     diag_range=(dmin, dmax), go_score=go,
                     ge_score=ge) as aln:
            score = aln.solve()
            expect = dp_oracle(
                S.contents, T.contents, aln.subst_scores, go, ge,
                dmin=dmin, dmax=dmax, **flags
            )
            assert score == pytest.approx(expect, abs=1e-3), (alntype, trial)


def test_banded_equals_full_when_band_covers(rng):
    S, T, _ = random_pair(rng, n=40)
    go, ge = -3.0, -1.0
    with Aligner(S, T, alnmode=pw.STD_MODE, alntype=pw.GLOBAL,
                 go_score=go, ge_score=ge) as aln:
        full_score = aln.solve()
    with Aligner(S, T, alnmode=pw.BANDED_MODE, alntype=pw.B_GLOBAL,
                 diag_range=(-len(T), len(S)), go_score=go,
                 ge_score=ge) as aln:
        band_score = aln.solve()
    assert band_score == pytest.approx(full_score, abs=1e-3)


@pytest.mark.parametrize("alnmode,alntype", [
    (pw.STD_MODE, pw.GLOBAL),
    (pw.STD_MODE, pw.LOCAL),
    (pw.STD_MODE, pw.OVERLAP),
    (pw.STD_MODE, pw.START_ANCHORED),
    (pw.STD_MODE, pw.END_ANCHORED),
    (pw.BANDED_MODE, pw.B_GLOBAL),
    (pw.BANDED_MODE, pw.B_OVERLAP),
    (pw.BANDED_MODE, pw.B_LOCAL),
])
def test_traceback_rescores_to_optimum(rng, alnmode, alntype):
    """Any optimal path is fine — but its re-scored value must equal the DP
    optimum, and its coordinates must respect the mode's anchoring."""
    for trial in range(5):
        S, T, _ = random_pair(rng, n=30 + 4 * trial)
        go, ge = -2.0, -1.0
        kw = {}
        if alnmode == pw.BANDED_MODE:
            d0 = len(S) - len(T)
            kw["diag_range"] = (min(d0, 0) - 8, max(d0, 0) + 8)
        with Aligner(S, T, alnmode=alnmode, alntype=alntype,
                     go_score=go, ge_score=ge, **kw) as aln:
            score = aln.solve()
            alignment = aln.traceback()
            assert alignment is not None
            rescored = alignment.calculate_score(
                aln.subst_scores, go, ge
            )
            assert rescored == pytest.approx(score, abs=1e-3), (
                alntype, trial, str(alignment.transcript)
            )
            if alntype in (pw.GLOBAL, pw.B_GLOBAL):
                assert alignment.origin_start == 0
                assert alignment.mutate_start == 0
                assert alignment.origin_end == len(S)
                assert alignment.mutate_end == len(T)


def test_identity_alignment(rng):
    S = rand_seq(A4, 50, rng=rng)
    with Aligner(S, S, alntype=pw.GLOBAL, match_score=2.0,
                 go_score=-5, ge_score=-1) as aln:
        assert aln.solve() == pytest.approx(100.0)
        tx = aln.traceback().transcript
        assert str(tx) == "M" * 50


def test_local_alignment_finds_planted_homology(rng):
    left = rand_seq(A4, 40, rng=rng)
    right = rand_seq(A4, 40, rng=rng)
    core = rand_seq(A4, 30, rng=rng)
    S = left + core + right
    M = MutationProcess(A4, subst_probs=0.1, go_prob=0.02, ge_prob=0.1,
                        rng=rng)
    core_mut, _ = M.mutate(core)
    T = rand_seq(A4, 35, rng=rng) + core_mut + rand_seq(A4, 35, rng=rng)
    with Aligner(S, T, alntype=pw.LOCAL, match_score=1, mismatch_score=-2,
                 go_score=-3, ge_score=-2) as aln:
        score = aln.solve()
        alignment = aln.traceback()
    assert score > 15
    # recovered segment must overlap the planted core substantially
    assert alignment.origin_start < 70 and alignment.origin_end > 40


def test_overlap_mode_suffix_prefix(rng):
    """Overlap alignment of a suffix of S with a prefix of T."""
    common = rand_seq(A4, 30, rng=rng)
    S = rand_seq(A4, 25, rng=rng) + common
    T = common + rand_seq(A4, 25, rng=rng)
    with Aligner(S, T, alntype=pw.OVERLAP, match_score=1,
                 mismatch_score=-10, go_score=-10, ge_score=-5) as aln:
        score = aln.solve()
        alignment = aln.traceback()
    assert score == pytest.approx(30.0)
    assert alignment.origin_start == 25
    assert alignment.mutate_start == 0
    assert str(alignment.transcript) == "M" * 30


def test_infeasible_band_returns_none(rng):
    S = rand_seq(A4, 20, rng=rng)
    T = rand_seq(A4, 20, rng=rng)
    # band that excludes the corner diagonal d = 0 entirely
    with Aligner(S, T, alnmode=pw.BANDED_MODE, alntype=pw.B_GLOBAL,
                 diag_range=(5, 10), go_score=-1, ge_score=-1) as aln:
        assert aln.solve() is None


def test_solve_is_dirs_lazy(rng):
    """solve() must not materialize the [LS, LT] direction-byte array —
    and in full-matrix (STD) mode neither must traceback(): it walks via
    the checkpointed re-solve (O(block_rows * LT) peak dirs memory), so
    the result stays dirs-free throughout."""
    S = rand_seq(A4, 100, rng=rng)
    T = rand_seq(A4, 100, rng=rng)
    with Aligner(S, T, alntype=pw.LOCAL, go_score=-2, ge_score=-1) as aln:
        score = aln.solve()
        assert not aln._result_has_dirs
        assert aln._result.dirs.ndim == 0  # scalar placeholder, no bytes
        alignment = aln.traceback()
        assert not aln._result_has_dirs   # chunked walk, no full plane
        assert alignment.calculate_score(
            aln.subst_scores, -2.0, -1.0
        ) == pytest.approx(score, abs=1e-3)
        # repeated traceback agrees with itself (fresh chunked walk)
        assert str(aln.traceback().transcript) == \
            str(alignment.transcript)

    # banded mode still uses the cached dirs re-solve (the banded plane
    # is O(LS * W) — small)
    with Aligner(S, T, alnmode=pw.BANDED_MODE, alntype=pw.B_LOCAL,
                 diag_range=(-32, 32), go_score=-2, ge_score=-1) as aln:
        score = aln.solve()
        assert not aln._result_has_dirs
        alignment = aln.traceback()
        assert aln._result_has_dirs
        res_before = aln._result
        aln.traceback()
        assert aln._result is res_before
        assert alignment.calculate_score(
            aln.subst_scores, -2.0, -1.0
        ) == pytest.approx(score, abs=1e-3)


def test_row0_alignment_ends():
    """Row i=0 cells are legitimate alignment ends (found by review: the
    scan trackers previously started at i=1 with best=NEG).  Confirmed
    repros: free-end optimum at H[0][1]; local-end zero at H[0][0];
    empty-origin global pair = the all-gap alignment, not NEG."""
    from biseqt_jax.ops.banded_dp import banded_dp, full_dp, ModeFlags
    import jax.numpy as jnp

    subst = np.full((4, 4), -100.0, np.float32)
    s = jnp.asarray([[2, 2]], jnp.int8)
    t = jnp.asarray([[0, 0]], jnp.int8)
    sl = jnp.asarray([2], jnp.int32)
    tl = jnp.asarray([1], jnp.int32)
    kw = dict(subst=subst, go=-2.0, ge=-1.0)
    dmin = jnp.asarray([-4], jnp.int32)

    # free END (anchored start): optimum ends at H[0][1] = go + ge
    # (insert one char, delete nothing)
    r = full_dp(s, t, sl, tl, flags=ModeFlags(free_end_edges=True), **kw)
    assert float(r.score[0]) == pytest.approx(-3.0)
    rb = banded_dp(s, t, sl, tl, dmin, W=8,
                   flags=ModeFlags(free_end_edges=True), **kw)
    assert float(rb.score[0]) == pytest.approx(-3.0)
    # full overlap mode: the empty alignment on the edge rays scores 0
    r = full_dp(s, t, sl, tl,
                flags=ModeFlags(free_start_edges=True,
                                free_end_edges=True), **kw)
    assert float(r.score[0]) == pytest.approx(0.0)

    # local END (anchored start): H[0][0] = 0 is the best end
    r = full_dp(s, t, sl, tl, flags=ModeFlags(local_end=True), **kw)
    assert float(r.score[0]) == pytest.approx(0.0)

    # empty origin, global: the all-gap alignment scores go + ge*|T|
    sl0 = jnp.asarray([0], jnp.int32)
    r = full_dp(s, t, sl0, tl, flags=ModeFlags(), **kw)
    assert float(r.score[0]) == pytest.approx(-3.0)
    rb = banded_dp(s, t, sl0, tl, dmin, W=8, flags=ModeFlags(), **kw)
    assert float(rb.score[0]) == pytest.approx(-3.0)


def test_positive_gap_scores_rejected():
    """The closed-form E scan requires go <= 0, ge <= 0 — positive
    values used to return silently wrong scores."""
    from biseqt_jax.ops.banded_dp import banded_dp, ModeFlags
    import jax.numpy as jnp

    subst = np.where(np.eye(4, dtype=bool), 5.0, -1.0).astype(np.float32)
    s = jnp.asarray([[0]], jnp.int8)
    t = jnp.asarray([[0, 1, 2]], jnp.int8)
    with pytest.raises(ValueError, match="go <= 0"):
        banded_dp(s, t, jnp.asarray([1], jnp.int32),
                  jnp.asarray([3], jnp.int32), jnp.asarray([-4], jnp.int32),
                  W=8, subst=subst, go=1.0, ge=-1.0, flags=ModeFlags())


def test_full_dp_traceback_chunked_matches_materialized(rng):
    """The checkpointed re-solve traceback (O(block_rows * LT) dirs
    memory) must reproduce the materialized-plane walk exactly —
    multiple blocks forced via a small block_rows, across modes and
    ragged lengths."""
    import jax.numpy as jnp
    from biseqt_jax.ops.banded_dp import (
        full_dp, full_dp_traceback, traceback_path, ModeFlags,
    )

    B = 3
    ss = np.zeros((B, 70), np.int8)
    ts = np.zeros((B, 60), np.int8)
    s_lens = np.asarray([70, 55, 63], np.int32)
    t_lens = np.zeros(B, np.int32)
    for b in range(B):
        S = rand_seq(A4, int(s_lens[b]), rng=rng)
        M = MutationProcess(A4, subst_probs=0.15, go_prob=0.05,
                            ge_prob=0.2, rng=rng)
        T, _ = M.mutate(S)
        arr = T.to_array(np.int8)[:60]
        t_lens[b] = len(arr)           # mutation changes the length
        ss[b, :s_lens[b]] = S.to_array(np.int8)
        ts[b, :t_lens[b]] = arr
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    args = (jnp.asarray(ss), jnp.asarray(ts),
            jnp.asarray(s_lens), jnp.asarray(t_lens))
    for flags in (ModeFlags(),
                  ModeFlags(local_start=True, local_end=True),
                  ModeFlags(free_start_edges=True, free_end_edges=True)):
        res = full_dp(*args, subst=subst, go=-2.0, ge=-1.0, flags=flags,
                      with_dirs=True)
        got = full_dp_traceback(
            *args, subst=subst, go=-2.0, ge=-1.0, flags=flags,
            end_i=np.asarray(res.end_i), end_j=np.asarray(res.end_j),
            block_rows=16,
        )
        for b in range(B):
            ref = traceback_path(
                np.asarray(res.dirs[b]), ss[b], ts[b],
                int(res.end_i[b]), int(res.end_j[b]),
                banded=False, flags=flags,
            )
            assert got[b] == ref, (b, flags)
