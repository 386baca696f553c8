"""Word-Blot: statistical similar-segment discovery without full DP.

Accelerator rebuild of the flagship layer ``biseqt/blot.py — band_radius,
band_radii, expected_overlap_len, WordBlot, WordBlotOverlap,
WordBlotLocalRef, WordBlotMultiple``.

The algorithm (per the Word-Blot method): seeds (exact k-mer matches) are
viewed in (diagonal d = i - j, antidiagonal a = i + j) coordinates.  A true
local alignment of length K with gap probability g stays inside a diagonal
band of radius ~ sqrt(g K) (random-walk drift), so similar segments show up
as seed-dense (d, a) rectangles.  Each candidate band's seed count is scored
under two hypotheses — H0 unrelated (background rate |Σ|^-w per cell) vs H1
related at match probability p (rate ~ p^w per column) — and the match
probability is estimated as p̂ = (n/K)^(1/w).

Vectorized reformulation (SURVEY.md §7): the reference's per-seed KDTree radius
queries + SQL band counts become one scatter-add histogram over (d, a)
bucket cells plus a 3x3 shifted-window sum (:mod:`ops.blot_stats`), and
segment assembly is connected components over the occupied cells.  All the
scoring is vectorized; only the final component labeling (a few thousand
cells) runs on host.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import functools

import numpy as np
from scipy.special import erfcinv
from scipy import ndimage

import jax
import jax.numpy as jnp

from .sequence import Sequence
from .seeds import SeedIndex, SeedIndexMultiple
from .ops import blot_stats

__all__ = [
    "band_radius", "band_radii", "expected_overlap_len",
    "WordBlot", "WordBlotOverlap", "WordBlotOverlapRef",
    "WordBlotLocalRef", "WordBlotMultiple",
]


# ---------------------------------------------------------------------------
# band geometry math
# ---------------------------------------------------------------------------

# p-hat is computed in float32 on device (counts stay far below the
# 2^24 float32 integer limit at any realistic component size); the
# p_min threshold is applied with this margin so a component whose true
# p-hat equals p_min cannot flip on float32 rounding
P_MIN_EPS = 1e-5


@functools.partial(jax.jit, static_argnames=("wordlen", "alphabet_len"))
def _component_stats(ns, areas, seglens, *, wordlen: int,
                     alphabet_len: int):
    """p-hat + H0/H1 scores for a batch of candidate components in ONE
    dispatch (the eager chain is ~26 separate dispatches)."""
    p = blot_stats.estimate_match_probability(ns, seglens, wordlen)
    s0, s1 = blot_stats.h0_h1_scores(ns, areas, seglens, p, wordlen,
                                     alphabet_len)
    return p, s0, s1


def _batched_stats(ns, areas, seglens, wordlen: int, alphabet_len: int):
    """(p-hat, s0, s1) numpy arrays for raw per-component (n, area,
    seglen) columns in ONE shape-bucketed jit dispatch.

    Per-component scalar jnp calls each pay this environment's ~32 ms
    dispatch floor (a 2 x 100 kbp p_min=0.5 discovery spent 10+ minutes
    there), and eager chains recompile per input length — so the count
    is shape-bucketed (inert padding rows: n 0, area 1, seglen 1) and
    the whole chain runs as one jitted call.  Shared by the pairwise
    (:func:`_score_components`) and N-way paths so the padding/inert-row
    convention lives in exactly one place."""
    from .seeds import _shape_bucket

    m = len(ns)
    pad = _shape_bucket(m, mini=64)
    ns_p = np.zeros(pad, np.float32)
    ns_p[:m] = ns
    seg_p = np.ones(pad, np.float32)
    seg_p[:m] = seglens
    ar_p = np.ones(pad, np.float32)
    ar_p[:m] = areas
    p, s0, s1 = _component_stats(jnp.asarray(ns_p), jnp.asarray(ar_p),
                                 jnp.asarray(seg_p), wordlen=wordlen,
                                 alphabet_len=alphabet_len)
    return np.asarray(p)[:m], np.asarray(s0)[:m], np.asarray(s1)[:m]


def _score_components(cand, wordlen: int, alphabet_len: int):
    """(p-hat, s0, s1) numpy arrays for candidate boxes
    [(d_lo, d_hi, a_lo, a_hi, n, seglen)] in ONE bucketed jit dispatch
    (see :func:`_batched_stats`)."""
    arr = np.asarray(cand, np.float64)
    return _batched_stats(arr[:, 4], (arr[:, 1] - arr[:, 0] + 1) * arr[:, 5],
                          arr[:, 5], wordlen, alphabet_len)


def band_radius(K, gap_prob, sensitivity=0.99):
    """Diagonal band radius containing a length-K alignment w.p. sensitivity.

    Random-walk model (``biseqt/blot.py — band_radius``): after K alignment
    columns the path's diagonal position is a sum of ~ g*K centered ±1 indel
    steps, hence Normal with sd ~ sqrt(g*K); the two-sided (1-ε) quantile
    gives r = erfcinv(ε) * sqrt(2 g K).
    """
    eps = 1.0 - float(sensitivity)
    r = erfcinv(eps) * np.sqrt(2.0 * float(gap_prob) * np.asarray(K, float))
    return np.maximum(1, np.ceil(r)).astype(int)


def band_radii(Ks, gap_prob, sensitivity=0.99):
    """Vectorized :func:`band_radius` over segment lengths."""
    return band_radius(np.asarray(list(Ks)), gap_prob, sensitivity)


def expected_overlap_len(len0, len1, diag, gap_prob):
    """Expected alignment-column length of an overlap along a diagonal.

    (``biseqt/blot.py — expected_overlap_len``.)  Along diagonal d the
    gap-free overlap spans ``L(d) = min(len0 - d, len1 + d, len0, len1)``
    residues; indels (prob g per column) stretch columns by ~ 1/(1 - g/2).
    """
    d = np.asarray(diag)
    L = np.minimum(
        np.minimum(len0 - d, len1 + d), np.minimum(len0, len1)
    )
    L = np.maximum(L, 0)
    return np.ceil(L / (1.0 - float(gap_prob) / 2.0)).astype(int)


# ---------------------------------------------------------------------------
# WordBlot
# ---------------------------------------------------------------------------

class WordBlot:
    """Pairwise similar-segment discovery over a :class:`SeedIndex`.

    Equivalent of ``biseqt/blot.py — WordBlot``.

    Args:
        S, T: the two sequences.
        wordlen: k-mer length w.
        g_max: maximum gap probability the band model should tolerate.
        sensitivity: band-radius sensitivity (1 - ε).
    """

    def __init__(self, S: Sequence, T: Sequence, wordlen: int = 8,
                 g_max: float = 0.3, sensitivity: float = 0.99,
                 path: str = None):
        self.S, self.T = S, T
        self.wordlen = int(wordlen)
        self.g_max = float(g_max)
        self.sensitivity = float(sensitivity)
        self.seed_index = SeedIndex(S, T, wordlen, path=path)

    # -- thin re-exports ------------------------------------------------------
    def band_radius(self, K) -> int:
        return int(band_radius(K, self.g_max, self.sensitivity))

    def seed_count(self, d_band=None, a_band=None) -> int:
        return self.seed_index.seed_count(d_band=d_band, a_band=a_band)

    def score_num_seeds(self, num_seeds, area, seglen, p_match):
        """(S0, S1) neg-log p-values of a band's seed count; see
        :func:`ops.blot_stats.h0_h1_scores`."""
        s0, s1 = blot_stats.h0_h1_scores(
            num_seeds, area, seglen, p_match, self.wordlen,
            len(self.S.alphabet),
        )
        return float(s0), float(s1)

    def estimate_match_probability(self, num_seeds, seglen) -> float:
        return float(blot_stats.estimate_match_probability(
            num_seeds, seglen, self.wordlen
        ))

    # -- core machinery -------------------------------------------------------
    def _grids(self, K: int):
        """Bucket seeds into (d-cell, a-cell) histogram + 3x3 sums.

        Memoized per K: the seed set is immutable after the index build,
        and both similar_segments and _best_fallback need the same grid
        (each rebuild is a device scatter + a dispatch)."""
        cached = getattr(self, "_grids_cache", None)
        if cached is not None and cached[0] == K:
            return cached[1]
        out = self._grids_impl(K)
        self._grids_cache = (K, out)
        return out

    def _grids_impl(self, K: int):
        r = self.band_radius(K)
        d_, a = self.seed_index.seed_arrays()
        acell = max(2 * K, 2)
        dcell = max(r, 1)
        # bucket grid dims too (see below): they depend on |S|+|T|, which
        # varies query-to-query in the fixed-reference modes; extra rows
        # stay empty and never form components
        from .seeds import _shape_bucket

        n_d = _shape_bucket((len(self.S) + len(self.T)) // dcell + 2,
                            mini=64)
        n_a = _shape_bucket((len(self.S) + len(self.T)) // acell + 2,
                            mini=64)
        if len(d_) == 0:
            grid = np.zeros((n_d, n_a), np.int32)
            return grid, grid, dcell, acell, r
        # bucket the seed-count dim: every distinct length is a separate
        # jit shape (= a compile), and the
        # fixed-reference modes stream many queries with different seed
        # counts through this scatter — pad to the shape bucket and mask
        pad = _shape_bucket(len(d_))
        dc = np.zeros(pad, np.int32)
        ac = np.zeros(pad, np.int32)
        dc[:len(d_)] = d_ // dcell
        ac[:len(d_)] = a // acell
        valid = np.zeros(pad, bool)
        valid[:len(d_)] = True
        grid = np.asarray(blot_stats.grid_counts(
            jnp.asarray(dc), jnp.asarray(ac), jnp.asarray(valid), n_d, n_a,
        ))
        neigh = np.asarray(blot_stats.box_sum3(jnp.asarray(grid)))
        return grid, neigh, dcell, acell, r

    def score_seeds(self, K: int) -> List[Dict]:
        """Per-seed local match-probability estimates.

        For each seed, counts neighbors within its band neighborhood
        (±band_radius in d, ±K in a, up to bucket quantization) and
        converts to p̂.  Mirrors ``WordBlot.score_seeds``; fully
        vectorized (one grid lookup + one p̂ formula over all seeds).
        """
        grid, neigh, dcell, acell, r = self._grids(K)
        d_, a = self.seed_index.seed_arrays()
        lt = len(self.T)
        # the 3x3 grid neighborhood spans ~3 a-cells = 6K antidiagonals =
        # ~3K alignment columns; use the SAME window-column count as
        # similar_segments' calibration (3 * acell / 2) so per-seed p̂ is
        # not systematically underestimated by a factor ~2^(1/w)
        seg_cols = min(3 * acell / 2.0, float(min(len(self.S), len(self.T))))
        ns = neigh[d_ // dcell, a // acell]
        ps = np.asarray(blot_stats.estimate_match_probability(
            ns.astype(np.float32), seg_cols, self.wordlen
        ))
        ii = (a + d_ - lt) // 2
        jj = (a - (d_ - lt)) // 2
        return [
            {"seed": (int(i), int(j)), "neighs": int(n), "p": float(p)}
            for i, j, n, p in zip(ii, jj, ns, ps)
        ]

    # dense (d, a) grids beyond this many cells switch to the sparse
    # run-merging assembler (genome-scale pairs)
    MAX_GRID_CELLS = 1 << 22

    def similar_segments(self, K_min: int, p_min: float,
                         at_least_one: bool = False) -> Iterable[Dict]:
        """Discover maximal similar segments (the flagship entry point).

        Yields dicts ``{'segment': ((d_min, d_max), (a_min, a_max)),
        'p': p̂, 'score': (S0, S1)}`` — the same contract as
        ``biseqt/blot.py — WordBlot.similar_segments``; ``d`` values are in
        true (unshifted) diagonal coordinates.

        Two assembly strategies, same output contract: a dense bucket-grid
        + connected components for normal sizes, and a sparse sorted-run
        merge (O(#seeds log)) when the grid would not fit (the ~Mbp genome
        configs, where the (d, a) plane is huge but seeds are sparse).
        """
        from .profiling import Phase

        r = self.band_radius(K_min)
        acell = max(2 * K_min, 2)
        dcell = max(r, 1)
        n_d = (len(self.S) + len(self.T)) // dcell + 2
        n_a = (len(self.S) + len(self.T)) // acell + 2
        with Phase("blot.discover"):
            segs = list(self._similar_segments_inner(
                K_min, p_min, at_least_one, r, acell, dcell, n_d, n_a
            ))
        yield from segs

    def _similar_segments_inner(self, K_min, p_min, at_least_one, r,
                                acell, dcell, n_d, n_a):
        cand = self._collect_components(K_min, p_min, r, acell, dcell,
                                        n_d, n_a)
        found = 0
        for seg in self._emit_components(cand, p_min):
            found += 1
            yield seg
        if found == 0 and at_least_one:
            yield self._best_fallback(K_min, p_min)

    def _collect_components(self, K_min, p_min, r=None, acell=None,
                            dcell=None, n_d=None, n_a=None):
        """Candidate boxes [(d_lo, d_hi, a_lo, a_hi, n, seglen)] — the
        assembly half of similar_segments.  The sparse tier (genome-
        scale planes) is pure host work; the dense tier costs the
        memoized grid build (2 device dispatches per K_min)."""
        if r is None:
            r = self.band_radius(K_min)
            acell = max(2 * K_min, 2)
            dcell = max(r, 1)
            n_d = (len(self.S) + len(self.T)) // dcell + 2
            n_a = (len(self.S) + len(self.T)) // acell + 2
        if n_d * n_a > self.MAX_GRID_CELLS:
            return self._collect_sparse(K_min, dcell, acell)
        grid, neigh, dcell, acell, r = self._grids(K_min)
        lt = len(self.T)
        # a cell is "hot" if its 3x3 neighborhood (≈ a (3r, 6K) window in
        # (d, a), i.e. ~3K alignment columns per band) has enough seeds to
        # suggest match probability >= p_min over K_min columns
        win_cols = 3 * acell / 2.0  # 3 a-cells = 6K antidiags = 3K columns
        thresh = max(1.0, win_cols * (p_min ** self.wordlen) * 0.5)
        hot = neigh >= thresh
        if not hot.any():
            return []
        labels, n_comp = ndimage.label(hot, structure=np.ones((3, 3)))
        # bounding boxes in ONE pass: at spec scale (~100 kbp, low p_min)
        # the noise floor alone makes tens of thousands of hot
        # components, and a per-component `nonzero(labels == comp)` scan
        # is O(n_comp * grid_cells) — measured: a 2 x 100 kbp p_min=0.5
        # call ran 10+ minutes; find_objects makes it linear
        boxes = ndimage.find_objects(labels)
        cand = []
        for comp in range(1, n_comp + 1):
            sl_d, sl_a = boxes[comp - 1]
            d_lo = int(sl_d.start) * dcell
            d_hi = int(sl_d.stop) * dcell - 1
            a_lo = int(sl_a.start) * acell
            a_hi = int(sl_a.stop) * acell - 1
            n = self.seed_index.seed_count(
                d_band=(d_lo - lt, d_hi - lt), a_band=(a_lo, a_hi)
            )
            # clamp to the real maximum alignment length: the
            # cell-quantized a-range can exceed min(|S|, |T|),
            # deflating p-hat and rejecting true segments at high
            # p_min (score_seeds already clamps the same way)
            seglen = min((a_hi - a_lo + 1) / 2.0,
                         float(min(len(self.S), len(self.T))))
            if seglen < K_min:
                continue
            cand.append((d_lo, d_hi, a_lo, a_hi, n, seglen))
        return cand

    def _emit_components(self, cand, p_min):
        """Score candidate boxes and yield the surviving segment dicts
        (ONE bucketed stats dispatch via :func:`_score_components`)."""
        if not cand:
            return
        lt = len(self.T)
        p_hats, s0s, s1s = _score_components(
            cand, self.wordlen, len(self.S.alphabet))
        for k, (d_lo, d_hi, a_lo, a_hi, n, seglen) in enumerate(cand):
            # p-hat comes from float32 device math; the epsilon keeps
            # components that sit exactly AT p_min from flipping on
            # rounding (advisor round 3)
            if p_hats[k] < p_min - P_MIN_EPS:
                continue
            yield {
                "segment": ((int(d_lo) - lt, int(d_hi) - lt),
                            (int(a_lo), int(a_hi))),
                "p": float(p_hats[k]),
                "score": (float(s0s[k]), float(s1s[k])),
                "num_seeds": int(n),
            }

    def _collect_sparse(self, K_min, dcell, acell):
        """Sparse assembly: antidiagonal runs per diagonal cell, merged
        across adjacent cells — O(#seeds log #seeds), no dense grid,
        PURE HOST WORK (no device dispatch).  Returns candidate boxes.

        Vectorized run detection: seeds are already (d_, a)-sorted, so a
        run boundary is "d-cell changed or a-gap > 2 cells" and one cumsum
        labels every run; per-run aggregates come from reduceat.
        """
        d_, a = self.seed_index.seed_arrays()
        lt = len(self.T)
        if len(d_) == 0:
            return []
        dc = d_ // dcell
        # order by (cell, a): run detection needs each cell's seeds in
        # antidiagonal order regardless of which exact diagonal they're on
        order0 = np.lexsort((a, dc))
        dc, a_o = dc[order0], a[order0]
        new_run = np.empty(len(d_), bool)
        new_run[0] = True
        new_run[1:] = (dc[1:] != dc[:-1]) | (np.diff(a_o) > 2 * acell)
        starts = np.flatnonzero(new_run)
        ends = np.append(starts[1:], len(d_))
        run_d = dc[starts]
        run_alo = a_o[starts]
        run_ahi = a_o[ends - 1]
        run_n = ends - starts
        # drop background singleton runs before merging
        keep = run_n >= 3
        if not keep.any():
            return []
        run_d, run_alo, run_ahi, run_n = (
            run_d[keep], run_alo[keep], run_ahi[keep], run_n[keep]
        )
        # union adjacent-diagonal runs with overlapping (padded) a-ranges
        order = np.argsort(run_alo, kind="stable")
        parent = np.arange(len(run_d))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        last_in_cell: Dict[int, int] = {}
        for idx in order:
            c = int(run_d[idx])
            for cc in (c - 1, c, c + 1):
                other = last_in_cell.get(cc)
                if other is not None and (
                        run_ahi[other] + acell >= run_alo[idx] - acell):
                    ra, rb = find(idx), find(other)
                    if ra != rb:
                        parent[rb] = ra
            last_in_cell[c] = idx
        comps: Dict[int, list] = {}
        for idx in range(len(run_d)):
            comps.setdefault(find(idx), []).append(idx)

        cand = []
        for members in comps.values():
            ms = np.asarray(members)
            d_lo = int(run_d[ms].min()) * dcell
            d_hi = (int(run_d[ms].max()) + 1) * dcell - 1
            a_lo = int(run_alo[ms].min())
            a_hi = int(run_ahi[ms].max())
            # exact rectangle count (matches the dense path's statistics)
            n = self.seed_index.seed_count(
                d_band=(d_lo - lt, d_hi - lt), a_band=(a_lo, a_hi)
            )
            seglen = max(min((a_hi - a_lo + 1) / 2.0,
                             float(min(len(self.S), len(self.T)))),
                         1.0)
            if seglen < K_min:
                continue
            cand.append((d_lo, d_hi, a_lo, a_hi, n, seglen))
        return cand

    def _best_fallback(self, K_min, p_min) -> Dict:
        """Best-effort single segment around the densest band (used when
        thresholding yields nothing but a caller wants a ranking anyway)."""
        grid, neigh, dcell, acell, r = self._grids(K_min)
        lt = len(self.T)
        u, v = np.unravel_index(np.argmax(neigh), neigh.shape)
        d_lo, d_hi = (u - 1) * dcell, (u + 2) * dcell - 1
        a_lo, a_hi = (v - 1) * acell, (v + 2) * acell - 1
        n = self.seed_index.seed_count(
            d_band=(d_lo - lt, d_hi - lt), a_band=(a_lo, a_hi)
        )
        seglen = max(min((a_hi - a_lo + 1) / 2.0,
                         float(min(len(self.S), len(self.T)))), 1.0)
        p_hat = self.estimate_match_probability(n, seglen)
        s0, s1 = self.score_num_seeds(
            n, (d_hi - d_lo + 1) * seglen, seglen, max(p_hat, 1e-3)
        )
        return {
            "segment": ((d_lo - lt, d_hi - lt), (a_lo, a_hi)),
            "p": p_hat, "score": (s0, s1), "num_seeds": n,
        }


# ---------------------------------------------------------------------------
# Overlap mode
# ---------------------------------------------------------------------------

class WordBlotOverlap(WordBlot):
    """Read-overlap discovery: only bands crossing sequence ends matter.

    Equivalent of ``biseqt/blot.py — WordBlotOverlap``: instead of free
    (d, a) rectangles, candidates are full diagonal bands [d-r, d+r] scored
    over their whole antidiagonal extent — a suffix of one read aligning a
    prefix of the other.
    """

    def highest_scoring_overlap_band(self, p_min: float = 0.5,
                                     min_score: float = 25.0) -> Dict:
        """Score every diagonal band, return the best overlap candidate.

        A candidate must be *significant*: its seed count must reject H0
        (unrelatedness) with S0 >= ``min_score`` neg-log-p — p̂ alone cannot
        discriminate because the 1/w-th root compresses background counts
        toward ~0.5.  The default threshold includes a multiple-testing
        allowance (|S|+|T| bands are scanned, so the null max of S0 grows
        like log of that count).  Among significant bands the one with the
        most estimated matched columns (p̂ · K_d) wins.

        Returns ``{'d_band': (d_lo, d_hi), 'p': p̂, 'score': (S0, S1),
        'expected_len': K_d}`` or None if no significant overlap exists.
        """
        prof = self._band_profile()
        if prof is None:
            return None
        diags, K_d, r_d, r_max, sums, p_hat = prof
        seglen = np.maximum(K_d, 1).astype(float)
        area = (2.0 * r_max + 1) * seglen
        s0, s1 = blot_stats.h0_h1_scores(
            sums, area, seglen, np.maximum(p_hat, 1e-3), self.wordlen,
            len(self.S.alphabet),
        )
        s0, s1 = np.asarray(s0), np.asarray(s1)
        ok = (K_d >= 2 * self.wordlen) & (s0 >= min_score)
        if not ok.any():
            return None
        rank = np.where(ok, p_hat * seglen, -1.0)
        best = int(np.argmax(rank))
        return {
            "d_band": (int(diags[best] - r_d[best]),
                       int(diags[best] + r_d[best])),
            "p": float(p_hat[best]),
            "score": (float(s0[best]), float(s1[best])),
            "expected_len": int(K_d[best]),
        }

    def _band_profile(self):
        """Shared per-diagonal band statistics: (diags, K_d, r_d, r_max,
        sums, p̂), or None for a seedless pair — one implementation for
        both the winner selection and the inspection profile."""
        ls, lt = len(self.S), len(self.T)
        counts = self.seed_index.seed_count_by_d_()
        if counts.sum() == 0:
            return None
        diags = np.arange(counts.shape[0]) - lt  # true d per bin
        K_d = expected_overlap_len(ls, lt, diags, self.g_max)
        r_d = band_radius(np.maximum(K_d, 2), self.g_max, self.sensitivity)
        # sliding band sums with the max radius window; per-band scoring
        # then uses that window's own area so the statistics stay honest
        r_max = int(r_d.max())
        sums = np.asarray(blot_stats.sliding_band_sums(
            jnp.asarray(counts, jnp.int32), jnp.int32(r_max)
        )).astype(float)
        p_hat = np.asarray(blot_stats.estimate_match_probability(
            sums, np.maximum(K_d, 1).astype(float), self.wordlen
        ))
        return diags, K_d, r_d, r_max, sums, p_hat

    def overlap_profile(self):
        """(diags, p̂ per diagonal band) for inspection/benchmarks."""
        prof = self._band_profile()
        if prof is None:
            counts = self.seed_index.seed_count_by_d_()
            return (np.arange(counts.shape[0]) - len(self.T),
                    np.zeros(counts.shape[0]))
        diags, _, _, _, _, p_hat = prof
        return diags, p_hat


class _FixedRefBase:
    """Shared machinery for the fixed-reference modes: the reference's
    k-mer positions as ONE sorted table (keys ascending, positions
    ascending within a key) — the SeedIndex representation, not a dict —
    plus an adapter that dresses a per-query seed view up as a
    WordBlot-family object.  One implementation, so index policy changes
    cannot diverge between the overlap and local variants.

    Build tiers (same output): refs >= ``DEVICE_MIN_REF`` go through the
    device radix sort (``ops.tables.build_kmer_table`` — a 5 Mbp
    reference indexes in milliseconds of device time); smaller refs use
    a host numpy argsort (no device dispatch for toy sizes).
    Queries are served host-side: vectorized packing + searchsorted +
    cumsum-inversion expansion — O(|query| + hits) per query with no
    per-query device round-trip.
    """

    DEVICE_MIN_REF = 1 << 16

    def __init__(self, ref: Sequence, wordlen: int = 8, g_max: float = 0.3,
                 sensitivity: float = 0.99, device: bool = None):
        self.ref = ref
        self.wordlen = int(wordlen)
        self.g_max = float(g_max)
        self.sensitivity = float(sensitivity)
        if device is None:
            device = len(ref) >= self.DEVICE_MIN_REF
        A = len(ref.alphabet)
        if device:
            from .ops import tables
            from .seeds import _shape_bucket

            pad = _shape_bucket(len(ref))
            codes = np.full(pad, -1, np.int8)
            codes[:len(ref)] = ref.to_array(np.int8)
            keys, _, poss, n_valid = tables.build_kmer_table(
                jnp.asarray(codes)[None, :],
                jnp.asarray([len(ref)], jnp.int32), self.wordlen, A,
            )
            n = int(n_valid)
            self._ref_keys = np.asarray(keys[:n]).astype(np.int64)
            self._ref_pos = np.asarray(poss[:n]).astype(np.int64)
        else:
            from .kmers import as_kmer_keys_np

            keys = as_kmer_keys_np(ref.to_array(np.int64), self.wordlen, A)
            valid = keys >= 0
            keys = keys[valid]
            poss = np.flatnonzero(valid)
            order = np.lexsort((poss, keys))
            self._ref_keys = keys[order]
            self._ref_pos = poss[order]

    def _as_wordblot(self, cls, query: Sequence):
        wb = cls.__new__(cls)
        wb.S, wb.T = query, self.ref
        wb.wordlen = self.wordlen
        wb.g_max, wb.sensitivity = self.g_max, self.sensitivity
        wb.seed_index = _SeedsFromRefIndex(
            query, self.ref, self.wordlen, self._ref_keys, self._ref_pos
        )
        return wb


class WordBlotOverlapRef(_FixedRefBase):
    """Overlap detection of many queries against one fixed read.

    Equivalent of ``biseqt/blot.py — WordBlotOverlapRef``: the reference
    read's k-mer index is built once; each query's overlap band statistics
    stream through in O(|query| + hits).
    """

    def highest_scoring_overlap_band(self, query: Sequence, **kw):
        return self._as_wordblot(
            WordBlotOverlap, query
        ).highest_scoring_overlap_band(**kw)


# ---------------------------------------------------------------------------
# Fixed-reference mode
# ---------------------------------------------------------------------------

class WordBlotLocalRef(_FixedRefBase):
    """Many queries against one fixed reference, index built once.

    Equivalent of ``biseqt/blot.py — WordBlotLocalRef``: the reference's
    k-mer positions are indexed up front (dict of sorted position lists);
    each query streams through in O(|query| + hits).
    """

    def similar_segments(self, query: Sequence, K_min: int, p_min: float,
                         **kw):
        """Similar segments between ``query`` (as S) and the reference (T).

        Runs the same band statistics as :class:`WordBlot` but enumerates
        seeds from the prebuilt reference index.
        """
        return self._as_wordblot(WordBlot, query).similar_segments(
            K_min, p_min, **kw
        )

    def similar_segments_batch(self, queries, K_min: int, p_min: float):
        """Many queries in ONE stats dispatch; returns a list of
        per-query segment lists (same dicts as :meth:`similar_segments`,
        verified identical).

        Measured honestly (5 Mbp ref, 100 x 10 kbp queries): this is NOT
        faster than the serial loop on an idle chip — the serial path is
        host-assembly-bound (~70 ms/query of numpy seed building + run
        merging vs ~30 ms of stats dispatch).  What batching buys is a
        100x cut in device dispatches (one bucketed
        :func:`_score_components` call total), which matters when the
        device queue is contended by other work.
        """
        wbs = [self._as_wordblot(WordBlot, q) for q in queries]
        cands = [wb._collect_components(K_min, p_min) for wb in wbs]
        out = [[] for _ in queries]
        flat = [c for cc in cands for c in cc]
        if not flat:
            return out
        p, s0, s1 = _score_components(
            flat, self.wordlen, len(self.ref.alphabet))
        lt = len(self.ref)
        k = 0
        for qi, cc in enumerate(cands):
            for (d_lo, d_hi, a_lo, a_hi, n, seglen) in cc:
                if p[k] >= p_min - P_MIN_EPS:
                    out[qi].append({
                        "segment": ((int(d_lo) - lt, int(d_hi) - lt),
                                    (int(a_lo), int(a_hi))),
                        "p": float(p[k]),
                        "score": (float(s0[k]), float(s1[k])),
                        "num_seeds": int(n),
                    })
                k += 1
        return out


class _SeedsFromRefIndex(SeedIndex):
    """SeedIndex built against a prebuilt sorted reference k-mer table.

    Per query: vectorized packing of the query's k-mers, two
    searchsorted passes over the reference keys for per-window hit runs,
    and a cumsum-inversion expansion of the ragged runs into flat (i, j)
    arrays (the numpy mirror of ``ops.tables.expand_join``) — no Python
    loop over positions.
    """

    def __init__(self, S, T, wordlen, ref_keys, ref_pos):
        from .kmers import as_kmer_keys_np

        self.S, self.T = S, T
        self.wordlen = wordlen
        self.alphabet = S.alphabet
        self.path = None
        lt = len(T)
        qk = as_kmer_keys_np(S.to_array(np.int64), wordlen,
                             len(S.alphabet))
        starts = np.searchsorted(ref_keys, qk, side="left")
        ends = np.searchsorted(ref_keys, qk, side="right")
        counts = np.where(qk >= 0, ends - starts, 0)
        cum = np.cumsum(counts)
        total = int(cum[-1]) if counts.shape[0] else 0
        slot = np.arange(total)
        i = np.searchsorted(cum, slot, side="right")
        rank = slot - (cum[i] - counts[i])
        j = ref_pos[starts[i] + rank]
        d_ = i - j + lt
        a = i + j
        order = np.lexsort((a, d_))
        self._d_ = d_[order]
        self._a = a[order]
        self._acap = len(S) + lt + 1
        self._comp = self._d_ * self._acap + self._a


# ---------------------------------------------------------------------------
# Multiple sequences
# ---------------------------------------------------------------------------

class WordBlotMultiple:
    """N-way similar segments over :class:`SeedIndexMultiple`.

    Equivalent of ``biseqt/blot.py — WordBlotMultiple``: seeds are position
    tuples (one per sequence); a similar segment is a tuple of diagonal
    bands (one per non-pivot sequence) plus an antidiagonal range, dense in
    N-way seeds.
    """

    def __init__(self, *seqs: Sequence, wordlen: int = 8, g_max: float = 0.3,
                 sensitivity: float = 0.99, **seed_index_kw):
        assert len(seqs) >= 2
        self.seqs = seqs
        self.wordlen = int(wordlen)
        self.g_max = float(g_max)
        self.sensitivity = float(sensitivity)
        # seed_index_kw passes through (max_hits_per_kmer,
        # max_tuples_per_kmer, device) so the N-way expansion knobs are
        # reachable from the public wrapper
        self.seed_index = SeedIndexMultiple(*seqs, wordlen=wordlen,
                                            **seed_index_kw)

    def band_radius(self, K) -> int:
        return int(band_radius(K, self.g_max, self.sensitivity))

    def estimate_match_probability(self, num_seeds, seglen) -> float:
        # N-way seed survives in all N sequences: E[n] ≈ K p^((N-1) w)
        n_other = len(self.seqs) - 1
        n = max(float(num_seeds), 0.0)
        K = max(float(seglen), 1.0)
        return float(np.clip(
            (n / K) ** (1.0 / (self.wordlen * n_other)), 0.0, 1.0
        ))

    def score_seeds(self, K: int) -> List[Dict]:
        """Per-seed local match-probability estimates (N-way analog of
        the pairwise ``WordBlot.score_seeds``, ``biseqt/blot.py —
        WordBlotMultiple`` [med] per SURVEY §2).

        Each N-way seed (a position tuple) is bucketed by its diagonal
        tuple (cell size = band radius per axis) and antidiagonal cell;
        its neighborhood count is the number of seeds within ±1 cell
        along EVERY axis, and p̂ takes the ``1/((N-1) w)``-th root of
        the neighborhood density (an N-way seed must survive in all N
        sequences, so density ~ p^((N-1) w)).
        """
        seeds = self.seed_index.seeds()
        if not seeds:
            return []
        r = max(self.band_radius(K), 1)
        acell = max(2 * K, 2)
        # cell key per seed: (N-1 diagonal cells, antidiagonal cell)
        cells = []
        counts: Dict[tuple, int] = {}
        for tup in seeds:
            i0 = tup[0]
            key = tuple((i0 - p) // r for p in tup[1:]) + ((i0 + tup[1]) // acell,)
            cells.append(key)
            counts[key] = counts.get(key, 0) + 1
        # neighborhood = 3^N cells; N is small (3-5), seed counts modest
        import itertools

        n_axes = len(cells[0])
        offsets = list(itertools.product((-1, 0, 1), repeat=n_axes))
        neigh_cache: Dict[tuple, int] = {}

        def neighborhood(key):
            got = neigh_cache.get(key)
            if got is None:
                got = sum(
                    counts.get(tuple(k + o for k, o in zip(key, off)), 0)
                    for off in offsets
                )
                neigh_cache[key] = got
            return got

        # same window-column calibration as the pairwise score_seeds:
        # the 3-cell a-neighborhood spans ~3K alignment columns
        seg_cols = min(3 * acell / 2.0,
                       float(min(len(s) for s in self.seqs)))
        w_eff = self.wordlen * (len(self.seqs) - 1)
        out = []
        for tup, key in zip(seeds, cells):
            n = neighborhood(key)
            p = float(np.clip((n / seg_cols) ** (1.0 / w_eff), 0.0, 1.0))
            out.append({"seed": tuple(int(x) for x in tup),
                        "neighs": int(n), "p": p})
        return out

    def similar_segments(self, K_min: int, p_min: float,
                         min_score: float = 25.0) -> Iterable[Dict]:
        """Cluster N-way seeds by their diagonal tuple + antidiagonal cell.

        Yields ``{'segment': (((d_lo, d_hi),) * (N-1), (a_min, a_max)),
        'p': p̂, 'score': (S0, S1), 'num_seeds': n}``.

        Candidates are gated on H0 rejection (``S0 >= min_score``,
        mirroring the pairwise/overlap contract of ``biseqt/blot.py —
        WordBlotMultiple``) IN ADDITION to p̂ >= p_min: an N-way seed
        survives in all N sequences, so the p̂ estimator takes the
        ``1/((N-1) w)``-th root of the density — background k-mer soup
        at low ``p_min`` easily clears the p̂ threshold (a couple of
        chance tuples at K=500, w=4, N=3 give p̂ ~ 0.6) while its count
        is perfectly explained by the ``|Σ|^-((N-1) w)`` background
        rate.  Pass ``min_score=None`` to disable the gate.  The H0/H1
        statistics are the pairwise ones with effective word length
        ``(N-1) * w`` (tuple match probability p^((N-1)w), background
        |Σ|^-((N-1)w)) over the area = Π band widths × seglen.
        """
        seeds = self.seed_index.seeds()
        if not seeds:
            return
        r = self.band_radius(K_min)
        acell = max(2 * K_min, 2)
        buckets: Dict[tuple, list] = {}
        for tup in seeds:
            i0 = tup[0]
            ds = tuple((i0 - p) // max(r, 1) for p in tup[1:])
            a = i0 + tup[1]
            buckets.setdefault(ds, []).append((tup, a))
        # merge buckets whose diagonal tuples are axis-neighbors: an
        # alignment whose pivot diagonal drifts across a cell boundary
        # mid-segment (expected — the drift scale IS r by construction)
        # would otherwise split into sub-K_min fragments and be silently
        # missed (the pairwise paths merge neighbors via 3x3 labeling /
        # the sparse c±1 union; this is the N-way analog)
        parent = {ds: ds for ds in buckets}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for ds in list(buckets):
            for axis in range(len(ds)):
                nb = ds[:axis] + (ds[axis] + 1,) + ds[axis + 1:]
                if nb in buckets:
                    ra, rb = find(ds), find(nb)
                    if ra != rb:
                        parent[rb] = ra
        clusters: Dict[tuple, dict] = {}
        for ds, members in buckets.items():
            c = clusters.setdefault(find(ds), {"members": [], "cells": []})
            c["members"].extend(members)
            c["cells"].append(ds)

        max_cols = float(min(len(s) for s in self.seqs))
        rr = max(r, 1)
        # collect every candidate run first, then score them all in ONE
        # bucketed stats dispatch (the pairwise _score_components
        # machinery with effective word length (N-1) * w)
        pend = []
        for c in clusters.values():
            members = sorted(c["members"], key=lambda m: m[1])
            # split into antidiagonal runs with gaps > 2*acell
            run = [members[0]]
            runs = []
            for m in members[1:]:
                if m[1] - run[-1][1] > 2 * acell:
                    runs.append(run)
                    run = []
                run.append(m)
            runs.append(run)
            d_bands = tuple(
                (min(ds[ax] for ds in c["cells"]) * rr - r,
                 (max(ds[ax] for ds in c["cells"]) + 1) * rr + r)
                for ax in range(len(c["cells"][0]))
            )
            # tuple-position area: Π (non-pivot band widths) × seglen
            width_prod = 1.0
            for (dl, dh) in d_bands:
                width_prod *= float(dh - dl + 1)
            for run in runs:
                a_lo, a_hi = run[0][1], run[-1][1]
                seglen = max(min((a_hi - a_lo) / 2.0, max_cols),
                             float(self.wordlen))
                if seglen < K_min:
                    continue
                n = len(run)
                pend.append((d_bands, int(a_lo), int(a_hi), n, seglen,
                             width_prod * seglen))
        if not pend:
            return
        w_eff = self.wordlen * (len(self.seqs) - 1)
        cols = np.asarray([(n, area, seglen)
                           for (_, _, _, n, seglen, area) in pend],
                          np.float64)
        p_hats, s0s, s1s = _batched_stats(
            cols[:, 0], cols[:, 1], cols[:, 2], wordlen=w_eff,
            alphabet_len=len(self.seqs[0].alphabet))
        for k, (d_bands, a_lo, a_hi, n, seglen, _) in enumerate(pend):
            if p_hats[k] < p_min - P_MIN_EPS:
                continue
            if min_score is not None and s0s[k] < min_score:
                continue
            yield {
                "segment": (d_bands, (a_lo, a_hi)),
                "p": float(p_hats[k]),
                "score": (float(s0s[k]), float(s1s[k])),
                "num_seeds": n,
            }
