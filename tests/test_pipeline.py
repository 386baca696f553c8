"""End-to-end discover+extend pipeline tests."""

import numpy as np
import pytest

from biseqt_jax.sequence import Alphabet
from biseqt_jax.stochastics import rand_seq, MutationProcess
from biseqt_jax.pipeline import discover_and_extend, extend_segments
from biseqt_jax.blot import WordBlot

A4 = Alphabet("ACGT")


def test_discover_and_extend_planted(rng):
    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.03, ge_prob=0.1,
                        rng=rng)
    core = rand_seq(A4, 500, rng=rng)
    core_mut, _ = M.mutate(core)
    S = rand_seq(A4, 400, rng=rng) + core + rand_seq(A4, 400, rng=rng)
    T = rand_seq(A4, 350, rng=rng) + core_mut + rand_seq(A4, 450, rng=rng)
    out = discover_and_extend(
        S, T, wordlen=8, K_min=200, p_min=0.6
    )
    assert out, "no extended segments"
    best = out[0]
    # extension score should reflect ~500 mostly-matching columns
    assert best["score"] > 200, best
    # and the segment covers the planted core antidiagonally
    (_, _), (a_lo, a_hi) = best["segment"]
    assert a_lo < 400 + 350 + 1000 and a_hi > 400 + 350


def test_discover_and_extend_unrelated_scores_low(rng):
    S = rand_seq(A4, 1200, rng=rng)
    T = rand_seq(A4, 1200, rng=rng)
    out = discover_and_extend(
        S, T, wordlen=8, K_min=300, p_min=0.75
    )
    assert out == []


def test_extend_segments_multiple_candidates(rng):
    """Two planted cores -> two extended segments, both scoring high."""
    M = MutationProcess(A4, subst_probs=0.05, go_prob=0.02, ge_prob=0.05,
                        rng=rng)
    c1 = rand_seq(A4, 400, rng=rng)
    c2 = rand_seq(A4, 400, rng=rng)
    c1m, _ = M.mutate(c1)
    c2m, _ = M.mutate(c2)
    gap1 = rand_seq(A4, 500, rng=rng)
    gap2 = rand_seq(A4, 500, rng=rng)
    S = c1 + gap1 + c2
    T = c1m + gap2 + c2m
    out = discover_and_extend(
        S, T, wordlen=8, K_min=150, p_min=0.6
    )
    assert len(out) >= 2
    assert out[0]["score"] > 150 and out[1]["score"] > 150


def test_extend_segments_with_transcripts(rng):
    """Batched extension returns MSID transcripts that rescore to exactly
    the DP score, walked by the native batched tracer (no per-pair
    Python loop over rows)."""
    from biseqt_jax.pw import Alignment

    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.03, ge_prob=0.1,
                        rng=rng)
    cores = [rand_seq(A4, 300, rng=rng) for _ in range(3)]
    muts = [M.mutate(c)[0] for c in cores]
    sp = lambda n: rand_seq(A4, n, rng=rng)
    # unequal spacers put each core on a well-separated diagonal so the
    # three homologies stay three segments
    S = sp(200) + cores[0] + sp(200) + cores[1] + sp(200) + cores[2]
    T = sp(100) + muts[0] + sp(500) + muts[1] + sp(900) + muts[2]
    wb = WordBlot(S, T, wordlen=8, g_max=0.2)
    segments = list(wb.similar_segments(K_min=120, p_min=0.6))
    assert len(segments) >= 3
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    out = extend_segments(
        S, T, segments, subst=subst, go_score=-3.0, ge_score=-1.0, with_transcripts=True,
    )
    for seg in out:
        assert set(seg["transcript"]) <= set("MSID")
        aln = Alignment(
            S, T, seg["transcript"],
            origin_start=seg["origin_start"],
            mutate_start=seg["mutate_start"],
        )
        rescored = aln.calculate_score(subst, -3.0, -1.0)
        assert rescored == pytest.approx(seg["score"], abs=1e-3), seg
        # transcripts cover most of a planted core
        assert len(seg["transcript"]) > 200


def test_extend_segments_window_split_contract(rng):
    """Transcript mode splits segments whose a-span exceeds the dirs
    budget into overlapping windows: the output then has MORE rows than
    the input, each tagged with source_index, and every window's
    transcript still rescores to its own score."""
    from biseqt_jax.pw import Alignment

    M = MutationProcess(A4, subst_probs=0.06, go_prob=0.02, ge_prob=0.05,
                        rng=rng)
    core = rand_seq(A4, 6000, rng=rng)
    S = core
    T, _ = M.mutate(core)
    wb = WordBlot(S, T, wordlen=8, g_max=0.15)
    segments = list(wb.similar_segments(K_min=1000, p_min=0.6))
    assert len(segments) >= 1
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    # a tiny budget forces the ~12k a-span into several windows (the
    # floor is 8 * pad_a = 4096 antidiagonals)
    out = extend_segments(
        S, T, segments, subst=subst, go_score=-3.0, ge_score=-1.0, with_transcripts=True, _dirs_budget=1,
    )
    assert len(out) > len(segments)
    assert {seg["source_index"] for seg in out} == set(
        range(len(segments)))
    cover = 0
    for seg in out:
        aln = Alignment(
            S, T, seg["transcript"],
            origin_start=seg["origin_start"],
            mutate_start=seg["mutate_start"],
        )
        rescored = aln.calculate_score(subst, -3.0, -1.0)
        assert rescored == pytest.approx(seg["score"], abs=1e-3), seg
        cover += len(seg["transcript"])
    # the windows jointly cover the whole homology (overlaps included)
    assert cover > 5500


def test_extend_segments_shape_grouped(rng):
    """Mixed segment sizes land in different shape buckets -> separate
    launches; per-segment scores must equal singleton-call scores
    (scatter-back correctness), for both score-only and transcripts."""
    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.03, ge_prob=0.1,
                        rng=rng)
    # one long and two short homologies, far apart
    longc = rand_seq(A4, 3000, rng=rng)
    shorts = [rand_seq(A4, 250, rng=rng) for _ in range(2)]
    sp = lambda n: rand_seq(A4, n, rng=rng)
    S = longc + sp(300) + shorts[0] + sp(300) + shorts[1]
    T = (M.mutate(longc)[0] + sp(700) + M.mutate(shorts[0])[0]
         + sp(700) + M.mutate(shorts[1])[0])
    wb = WordBlot(S, T, wordlen=8, g_max=0.2)
    segments = list(wb.similar_segments(K_min=120, p_min=0.6))
    assert len(segments) >= 3
    batched = extend_segments(S, T, segments,
                              with_transcripts=True)
    # the BUCKETED cutout shapes must differ (launch grouping keys),
    # i.e. the batch really split into multiple launches
    from biseqt_jax.pipeline import _bucket
    keys = set()
    for seg in segments:
        (d_lo, d_hi), (a_lo, a_hi) = seg["segment"]
        keys.add(_bucket((a_hi - a_lo) // 2 + 1024))  # coarse length proxy
    assert len(keys) > 1, "geometry no longer exercises multi-group launches"
    for k, seg in enumerate(segments):
        solo = extend_segments(S, T, [seg])[0]
        assert batched[k]["score"] == pytest.approx(solo["score"],
                                                    abs=1e-3)
        assert set(batched[k]["transcript"]) <= set("MSID")
        assert len(batched[k]["transcript"]) > 0


def test_extend_segments_transcripts_native_unavailable(rng, monkeypatch):
    """with_transcripts=True fails up front with a clear message when
    the native tier is missing (every transcript route compacts with
    C++) — not deep in _finish after launches are in flight."""
    from biseqt_jax import native

    monkeypatch.setattr(native, "available", lambda: False)
    S = rand_seq(A4, 100, rng=rng)
    seg = {"segment": ((-10, 10), (0, 200))}
    with pytest.raises(RuntimeError, match="native C\\+\\+ tier"):
        extend_segments(S, S, [seg],
                        with_transcripts=True)


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,expect", [
    ({"bytes_limit": 80 << 30}, 20 << 30),
    ({"bytes_limit": 60 << 30, "bytes_in_use": 1}, 15 << 30),
    ({}, 3 << 30),
    (None, 3 << 30),
])
def test_pipeline_bytes_from_device_limit(stats, expect):
    """The in-flight budget is a fixed share of what the device reports
    it may hold; a backend without memory stats (the CPU) gets the fixed
    default."""
    from biseqt_jax.pipeline import pipeline_bytes

    assert pipeline_bytes(_Dev(stats)) == expect
