"""Seed indexing: exact k-mer matches in diagonal/antidiagonal coordinates.

Accelerator rebuild of ``biseqt/seeds.py — SeedIndex, SeedIndexMultiple``.
The reference materialized a per-pair SQLite table by a SQL self-join of
k-mer hit lists; here seed enumeration is a sorted-merge join on device
(:func:`biseqt_jax.ops.tables.seed_join`) producing flat (i, j) arrays,
which are then re-expressed in band coordinates

    d = i - j   (diagonal; stored shifted as d_ = d + |T| >= 0,
                 matching the reference's nonnegative convention)
    a = i + j   (antidiagonal)

and lexicographically sorted by (d_, a).  Band-windowed queries
(``seeds(d_band=..., a_band=...)``, ``seed_count``) are binary searches over
the sorted array — the role the SQL B-tree played, at memory bandwidth.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from .sequence import Sequence, pack_sequences
from .ops import tables

__all__ = ["Seed", "SeedIndex", "SeedIndexMultiple"]


class Seed(tuple):
    """A seed: exact k-mer match at origin position i, mutate position j."""

    def __new__(cls, i, j):
        return tuple.__new__(cls, (int(i), int(j)))

    @property
    def i(self):
        return self[0]

    @property
    def j(self):
        return self[1]

    def __repr__(self):
        return "Seed(i=%d, j=%d)" % (self[0], self[1])


class SeedIndex:
    """All exact k-mer matches between a pair of sequences, band-queryable.

    Equivalent of ``biseqt/seeds.py — SeedIndex``; construction runs the
    device-side join once, then keeps host-side sorted arrays for the
    O(log n) band queries the Word-Blot layer makes.

    Attributes:
        S, T: the two sequences.
        wordlen: seed k-mer length.
        d_min_possible / d_max_possible: the full diagonal range
            ``[-|T|, |S|]``.
    """

    def __init__(self, S: Sequence, T: Sequence, wordlen: int,
                 path: str = None, capacity_hint: int = None):
        assert S.alphabet == T.alphabet
        self.S, self.T = S, T
        self.wordlen = int(wordlen)
        self.alphabet = S.alphabet
        # np.savez appends '.npz' to suffixless names; normalize so the
        # cache-hit check, save, and load agree on the on-disk name
        if path is not None and not path.endswith(".npz"):
            path = path + ".npz"
        self.path = path
        if path is not None and os.path.exists(path):
            # reuse persisted seeds (the reference reused its SQLite
            # seed tables across runs the same way)
            self._load(path)
        else:
            self._build(capacity_hint)
            if path is not None:
                self._save(path)

    def _build(self, capacity_hint: Optional[int]):
        from .profiling import Phase

        with Phase("seeds.build"):
            self._build_timed(capacity_hint)

    def _build_timed(self, capacity_hint: Optional[int]):
        ls, lt = len(self.S), len(self.T)
        A = len(self.alphabet)
        # bucket the padded code shapes so repeated builds over different
        # sequences share compiled programs (compiles dominate cold
        # genome-scale builds otherwise); true lengths ride alongside
        lsp, ltp = _shape_bucket(ls), _shape_bucket(lt)
        s_arr = np.full(lsp, -1, np.int8)
        s_arr[:ls] = self.S.to_array(np.int8)
        t_arr = np.full(ltp, -1, np.int8)
        t_arr[:lt] = self.T.to_array(np.int8)
        s = jnp.asarray(s_arr)
        t = jnp.asarray(t_arr)
        # exact count first (cheap pass) so the expansion compiles for the
        # right capacity bucket immediately — no doubling recompiles
        if capacity_hint is None:
            total_exact = int(tables.seed_total(
                s, jnp.int32(ls), t, jnp.int32(lt), self.wordlen, A
            ))
            cap = max(1 << 12, _next_pow2(total_exact + 1))
        else:
            cap = capacity_hint
        while True:
            # join + (d_, a) transform + lexsort all on device; one D2H
            out = tables.seed_join_sorted(
                s, jnp.int32(ls), t, jnp.int32(lt),
                self.wordlen, A, capacity=cap,
            )
            total = int(out["total"])
            if total < 0:
                # int32 cumsum wrapped: > 2^31 seeds (see
                # ops.tables.expand_join overflow contract) — that seed
                # set would not fit in memory; demand a longer wordlen
                raise OverflowError(
                    "seed count exceeds 2^31 for wordlen=%d — use a "
                    "longer wordlen or mask repetitive k-mers"
                    % self.wordlen
                )
            if total <= cap:
                break
            cap = _next_pow2(total)
        self._d_ = np.asarray(out["d_"][:total]).astype(np.int64)
        self._a = np.asarray(out["a"][:total]).astype(np.int64)
        # composite key for O(log n) 2-D band queries
        self._acap = ls + lt + 1
        self._comp = self._d_ * self._acap + self._a

    # -- persistence ----------------------------------------------------------
    def _save(self, path: str):
        np.savez_compressed(
            path, d_=self._d_, a=self._a, acap=self._acap,
            wordlen=self.wordlen,
            ids=np.asarray([self.S.content_id, self.T.content_id]),
        )

    def _load(self, path: str):
        z = np.load(path, allow_pickle=True)
        assert int(z["wordlen"]) == self.wordlen, "wordlen mismatch"
        ids = z["ids"].tolist()
        assert ids == [self.S.content_id, self.T.content_id], (
            "snapshot is for different sequences"
        )
        self._d_ = z["d_"]
        self._a = z["a"]
        self._acap = int(z["acap"])
        self._comp = self._d_ * self._acap + self._a

    # -- conventions ----------------------------------------------------------
    def d_(self, d: int) -> int:
        """Shifted diagonal: d_ = d + |T| (kept nonnegative like the ref)."""
        return int(d) + len(self.T)

    # -- queries --------------------------------------------------------------
    def __len__(self):
        return int(self._d_.shape[0])

    def seed_count(self, d_band: Tuple[int, int] = None,
                   a_band: Tuple[int, int] = None) -> int:
        """Number of seeds with d in d_band and a in a_band (inclusive)."""
        if a_band is None:
            lo, hi = self._range(d_band, None)
            return int(hi - lo)
        return self._count_2d(d_band, a_band)

    def seeds(self, d_band=None, a_band=None) -> List[Seed]:
        """Seeds (i, j), optionally band-restricted; sorted by (d, a)."""
        d_arr, a_arr = self._select(d_band, a_band)
        lt = len(self.T)
        i = (a_arr + d_arr - lt) // 2
        j = (a_arr - (d_arr - lt)) // 2
        return [Seed(ii, jj) for ii, jj in zip(i, j)]

    def seed_arrays(self, d_band=None, a_band=None):
        """Band-restricted (d_, a) numpy arrays (analysis tier)."""
        return self._select(d_band, a_band)

    def seed_count_by_d_(self) -> np.ndarray:
        """Per-diagonal seed counts, indexed by shifted diagonal d_.

        The input to overlap-band scoring (``biseqt/seeds.py —
        SeedIndex.seed_count`` per-diagonal variant).
        """
        n_d = len(self.S) + len(self.T) + 1
        return np.bincount(self._d_, minlength=n_d).astype(np.int64)

    # -- internals ------------------------------------------------------------
    def _range(self, d_band, a_band):
        if d_band is None:
            return 0, len(self)
        d_lo = self.d_(d_band[0])
        d_hi = self.d_(d_band[1])
        lo = np.searchsorted(self._d_, d_lo, side="left")
        hi = np.searchsorted(self._d_, d_hi, side="right")
        return int(lo), int(hi)

    def _count_2d(self, d_band, a_band) -> int:
        d_lo = self.d_(d_band[0]) if d_band else 0
        d_hi = self.d_(d_band[1]) if d_band else self._acap - 1
        a_lo, a_hi = (a_band if a_band else (0, self._acap - 1))
        # clamp to the composite key's stride so a-ranges never bleed into
        # the next diagonal's key space
        a_lo = max(int(a_lo), 0)
        a_hi = min(int(a_hi), self._acap - 1)
        if a_hi < a_lo:
            return 0
        # per-diagonal counts via composite-key searchsorted, vectorized
        ds = np.arange(d_lo, d_hi + 1, dtype=np.int64)
        lo = np.searchsorted(self._comp, ds * self._acap + a_lo, "left")
        hi = np.searchsorted(self._comp, ds * self._acap + a_hi, "right")
        return int((hi - lo).sum())

    def _select(self, d_band, a_band):
        lo, hi = self._range(d_band, None)
        d_arr = self._d_[lo:hi]
        a_arr = self._a[lo:hi]
        if a_band is not None:
            m = (a_arr >= a_band[0]) & (a_arr <= a_band[1])
            d_arr, a_arr = d_arr[m], a_arr[m]
        return d_arr, a_arr


class SeedIndexMultiple:
    """Seeds shared by N > 2 sequences (k-mers present in every sequence).

    Equivalent of ``biseqt/seeds.py — SeedIndexMultiple``: a seed is an
    N-tuple of positions, one per sequence, where the same k-mer occurs.
    Built by intersecting sorted k-mer tables and expanding the hit-list
    cross products (bounded per k-mer to keep combinatorics sane).
    """

    def __init__(self, *seqs: Sequence, wordlen: int = 8,
                 max_hits_per_kmer: int = 8, device: bool = None,
                 max_tuples_per_kmer: int = 4096):
        assert len(seqs) >= 2
        self.seqs = seqs
        self.wordlen = int(wordlen)
        self.alphabet = seqs[0].alphabet
        h = int(max_hits_per_kmer)
        assert h >= 1
        # the per-sequence cap alone is exponential in N: ONE
        # low-complexity k-mer (a poly-A run) with >= h occurrences in
        # every one of N=10 sequences would expand to h^N ~ 1e9 tuples.
        # Per k-mer, the effective per-sequence cap is lowered (same
        # deterministic rule on both tiers: largest h' <= h whose
        # capped-count product fits) until the tuple count fits the
        # budget.
        self._max_tuples = max(int(max_tuples_per_kmer), 1)
        if device is None:
            # both tiers have IDENTICAL semantics (capped cross products
            # of the first h positions per sequence per shared k-mer), so
            # the auto-switch is purely a performance choice: the host
            # dict loops are minutes at N=10 x 100 kbp, the device radix
            # sort milliseconds
            device = sum(len(s) for s in seqs) > 200_000
        if device:
            self._build_device(h)
        else:
            self._build_host(h)

    def _build_device(self, max_hits_per_kmer: int):
        """One global radix sort + vectorized host run expansion (no
        scatter — colliding XLA scatter updates serialize).

        Same output contract as :meth:`_build_host`: for every k-mer
        present in all N sequences, the cross product of its first
        ``max_hits_per_kmer`` positions per sequence.
        """
        from .ops.tables import nway_shared_seeds, KEY_SENTINEL

        # bucket the padded shape: exact-max padding would make every
        # distinct input set a distinct (minutes-long remote) compile
        pad = _shape_bucket(max(len(s) for s in self.seqs))
        codes, lengths = pack_sequences(list(self.seqs), pad_to=pad)
        kk, ss, pp = (np.asarray(x) for x in nway_shared_seeds(
            jnp.asarray(codes), jnp.asarray(lengths),
            self.wordlen, len(self.alphabet),
        ))
        valid = kk != KEY_SENTINEL
        kk, ss, pp = kk[valid], ss[valid], pp[valid]
        N = len(self.seqs)
        h = int(max_hits_per_kmer)
        self._seeds = []
        if kk.size == 0:
            return
        kk = kk.astype(np.int64)
        # cap every (key, seq) subgroup at its first h rows (the table is
        # (key, seq, pos)-sorted, so subgroup order IS position order)
        idx = np.arange(kk.shape[0])
        sub = np.empty(kk.shape, bool)
        sub[0] = True
        sub[1:] = (kk[1:] != kk[:-1]) | (ss[1:] != ss[:-1])
        first = np.maximum.accumulate(np.where(sub, idx, 0))
        keep = (idx - first) < h
        kk, ss, pp, sub = kk[keep], ss[keep], pp[keep], sub[keep]
        # key runs; a key whose run holds N subgroups touches every
        # sequence (seq ids are distinct and ascending within a key, so
        # subgroup s of a qualifying key belongs to sequence s)
        ks = np.empty(kk.shape, bool)
        ks[0] = True
        ks[1:] = kk[1:] != kk[:-1]
        key_id = np.cumsum(ks) - 1
        n_keys = int(key_id[-1]) + 1
        nsub = np.bincount(key_id[sub], minlength=n_keys)
        qual = np.flatnonzero(nsub == N)
        if qual.size == 0:
            return
        qmap = np.full(n_keys, -1, np.int64)
        qmap[qual] = np.arange(qual.size)
        g_row = qmap[key_id]
        rows = g_row >= 0
        idx2 = np.arange(kk.shape[0])
        first2 = np.maximum.accumulate(np.where(sub, idx2, 0))
        rank2 = idx2 - first2
        g_row, s_row, p_row, r_row = (
            g_row[rows], ss[rows], pp[rows], rank2[rows]
        )
        G = qual.size
        # per-(key, seq) capped hit counts and a [G, N, h] position table
        c = np.bincount(g_row * N + s_row, minlength=G * N).reshape(G, N)
        post = np.zeros((G, N, h), np.int64)
        post[g_row, s_row, r_row] = p_row
        c = _fit_tuple_budget(c, h, self._max_tuples)
        # cross-product expansion, host-tier ordering (last sequence
        # varies fastest): stride[:, s] = prod of counts of seqs > s
        rc = np.cumprod(c[:, ::-1], axis=1)[:, ::-1]  # rc[:, s] = prod c[:, s:]
        stride = np.concatenate(
            [rc[:, 1:], np.ones((G, 1), np.int64)], axis=1
        )
        totals = rc[:, 0]
        offsets = np.cumsum(totals)
        starts = offsets - totals
        m = np.arange(int(offsets[-1]))
        gq = np.searchsorted(offsets, m, side="right")
        t = m - starts[gq]
        cols = np.empty((m.shape[0], N), np.int64)
        for s in range(N):
            cols[:, s] = post[gq, s, (t // stride[gq, s]) % c[gq, s]]
        order = np.lexsort(tuple(cols[:, s] for s in reversed(range(N))))
        self._seeds = [tuple(int(x) for x in r) for r in cols[order]]

    def _build_host(self, max_hits_per_kmer: int):
        """Dict/cross-product tier: all position combinations per shared
        k-mer, capped at ``max_hits_per_kmer`` per sequence.  Host-side —
        fine to ~N x 10 kbp; use the device tier beyond."""
        from .kmers import as_kmer_seq

        maps = []
        for s in self.seqs:
            m = {}
            for pos, km in enumerate(as_kmer_seq(s, self.wordlen)):
                m.setdefault(km, []).append(pos)
            maps.append(m)
        shared = set(maps[0])
        for m in maps[1:]:
            shared &= set(m)
        seeds = []
        for km in shared:
            counts = np.asarray(
                [[min(len(m[km]), max_hits_per_kmer) for m in maps]],
                np.int64,
            )
            ce = _fit_tuple_budget(counts, max_hits_per_kmer,
                                   self._max_tuples)[0]
            lists = [m[km][:int(ce[s])] for s, m in enumerate(maps)]
            combos = [[]]
            for lst in lists:
                combos = [c + [p] for c in combos for p in lst]
            seeds.extend(tuple(c) for c in combos)
        self._seeds = sorted(seeds)

    def __len__(self):
        return len(self._seeds)

    def seeds(self):
        return list(self._seeds)

    def seed_count(self):
        return len(self._seeds)


def _fit_tuple_budget(c, h: int, max_tuples: int):
    """Lower per-sequence hit caps until each k-mer's cross-product size
    fits the budget.

    ``c``: [G, N] int64 per-(k-mer, sequence) capped hit counts
    (``c <= h``).  Returns adjusted counts: for every row whose product
    exceeds ``max_tuples``, counts are re-capped at the largest
    ``h' < h`` that fits (down to 1 — a product of 1**N always fits).
    Deterministic and tier-independent: the device and host builders
    must produce identical seed sets.
    """
    c = np.asarray(c, np.int64).copy()
    # float64 products: int64 overflows at large N (8^22 > 2^63)
    prod = c.astype(np.float64).prod(axis=1)
    for hp in range(h - 1, 0, -1):
        over = prod > max_tuples
        if not over.any():
            break
        c[over] = np.minimum(c[over], hp)
        prod[over] = c[over].astype(np.float64).prod(axis=1)
    return c


def _next_pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def _shape_bucket(n: int, mini: int = 256) -> int:
    """Round a sequence length up to a shape bucket (<= ~12.5% waste)."""
    n = max(int(n), 1)
    if n <= mini:
        return mini
    step = max(mini, 1 << (max(n.bit_length(), 4) - 4))
    return ((n + step - 1) // step) * step
