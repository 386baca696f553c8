"""K-mer packing and indexing: sorted on-device tables replace SQLite.

Accelerator rebuild of ``biseqt/kmers.py — kmer_as_int, as_kmer_seq,
KmerIndex, KmerCache``.  The reference's inverted index (a SQLite table
``kmers_{wordlen}(kmer, seq, pos)`` plus a B-tree) becomes one radix-sorted
triple of int32 arrays living on device (:func:`ops.tables.build_kmer_table`);
lookups are binary searches, aggregations are segmented reductions, and
persistence is a plain ``.npz`` of the sorted arrays.
"""

from __future__ import annotations

import os
from typing import Iterable, List

import numpy as np
import jax.numpy as jnp

from .sequence import Alphabet, Sequence, pack_sequences
from .ops import tables
from .ops.tables import KEY_SENTINEL
from .stochastics import binomial_to_normal, normal_neg_log_pvalue

__all__ = ["kmer_as_int", "as_kmer_seq", "KmerIndex", "KmerCache"]


def kmer_as_int(contents, alphabet: Alphabet) -> int:
    """Pack one k-mer (iterable of letter codes) into an integer.

    Base-|Σ| positional encoding, most significant first — identical
    contract to ``biseqt/kmers.py — kmer_as_int``.
    """
    k = 0
    n = len(alphabet)
    for c in contents:
        assert 0 <= c < n
        k = k * n + int(c)
    return k


def as_kmer_seq(seq: Sequence, wordlen: int) -> List[int]:
    """All overlapping k-mers of ``seq`` as packed integers (host tier).

    Contract parity with ``biseqt/kmers.py — as_kmer_seq``.  Vectorized
    on :func:`as_kmer_keys_np` (a genome-scale ``KmerCache`` fill was
    seconds-to-minutes with the per-letter loop; the numpy path is
    ~1000x); keys too wide for int64 (|Σ|**wordlen >= 2**63, e.g. DNA
    wordlen >= 32) fall back to the exact Python-int rolling loop.
    """
    n = len(seq.alphabet)
    if n ** wordlen < 2 ** 63:
        # Sequence codes are validated non-negative, so no -1 windows
        return as_kmer_keys_np(seq.to_array(), wordlen, n).tolist()
    out = []
    val = 0
    mod = n ** wordlen
    for i, c in enumerate(seq.contents):
        val = (val * n + c) % mod
        if i >= wordlen - 1:
            out.append(val)
    return out


def as_kmer_keys_np(codes: np.ndarray, wordlen: int,
                    alphabet_len: int) -> np.ndarray:
    """Vectorized host-tier k-mer packing over a code array.

    Same values as :func:`as_kmer_seq` / ``ops.tables.kmer_keys`` (base-|Σ|,
    most significant first), computed with ``wordlen`` numpy passes instead
    of a per-letter Python loop.  Windows containing a negative code
    (ambiguity/PAD) come back as -1.  Returns int64 of length
    ``len(codes) - wordlen + 1`` (empty if the sequence is shorter than
    ``wordlen``).
    """
    codes = np.asarray(codes)
    if codes.dtype.kind not in "iu":
        # float/object code arrays worked in the pre-vectorized tier;
        # the in-place += below needs an integer dtype
        codes = codes.astype(np.int64)
    m = codes.shape[0] - int(wordlen) + 1
    if m <= 0:
        return np.empty(0, np.int64)
    key = np.zeros(m, np.int64)
    has_neg = codes.size and int(codes.min()) < 0
    if not has_neg:
        # hot path (validated Sequence codes are never negative):
        # two in-place passes per position — the allocating
        # maximum/where version measured ~4x slower at genome scale
        for t in range(int(wordlen)):
            key *= alphabet_len
            key += codes[t:t + m]
        return key
    bad = np.zeros(m, bool)
    for t in range(int(wordlen)):
        cc = codes[t:t + m]
        key *= alphabet_len
        key += np.maximum(cc, 0)
        bad |= cc < 0
    key[bad] = -1
    return key


class KmerIndex:
    """An inverted k-mer index over a collection of sequences.

    Device-side equivalent of ``biseqt/kmers.py — KmerIndex``: holds the
    sorted ``(kmer, seq, pos)`` table on device.  ``path`` (optional) points
    at an ``.npz`` snapshot — the persistence role SQLite played in the
    reference; an existing snapshot is reloaded instead of rebuilt
    (mirroring the reference's idempotent indexing).
    """

    def __init__(self, wordlen: int, alphabet: Alphabet, path: str = None):
        assert len(alphabet) ** wordlen < 2 ** 31, (
            "alphabet**wordlen must fit int32"
        )
        self.wordlen = int(wordlen)
        self.alphabet = alphabet
        # np.savez appends '.npz' to suffixless names; normalize so the
        # cache-hit check, save, and load agree on the on-disk name
        if path and not path.endswith(".npz"):
            path = path + ".npz"
        self.path = path
        self._ids: List[str] = []       # content ids of indexed sequences
        self._lens: List[int] = []
        self._keys = None               # sorted int32 [N]
        self._seqs = None
        self._poss = None
        self._n = 0
        if path and os.path.exists(path):
            self.load(path)

    # -- building -------------------------------------------------------------
    def index_kmers(self, seqs: Iterable[Sequence], append: bool = False):
        """(Re)build the table over ``seqs`` (one shot, one radix sort).

        Unlike the reference's per-sequence INSERT loops, indexing is a
        single batched pack + sort.  With ``append=True`` the new batch is
        merged into the existing table (one stable sort of the
        concatenation — the incremental path :meth:`refresh` uses), with
        sequence ids continuing after the already-indexed sequences.
        """
        seqs = list(seqs)
        if not seqs:
            raise ValueError("no sequences to index")
        if not append:
            self._ids, self._lens = [], []
            self._keys = self._seqs = self._poss = None
            self._n = 0
        base = len(self._lens)
        self._ids += [getattr(s, "content_id", None) for s in seqs]
        self._lens += [len(s) for s in seqs]
        codes, lengths = pack_sequences(seqs)
        keys, sids, poss, n_valid = tables.build_kmer_table(
            jnp.asarray(codes), jnp.asarray(lengths),
            self.wordlen, len(self.alphabet),
        )
        n = int(n_valid)
        keys, sids, poss = keys[:n], sids[:n] + base, poss[:n]
        if self._n:
            keys = jnp.concatenate([self._keys, keys])
            sids = jnp.concatenate([self._seqs, sids])
            poss = jnp.concatenate([self._poss, poss])
            order = jnp.argsort(keys, stable=True)
            keys, sids, poss = keys[order], sids[order], poss[order]
        self._keys = keys
        self._seqs = sids
        self._poss = poss
        self._n = int(keys.shape[0])
        self._keys_np = None            # invalidate the hits() cache
        if self.path:
            self.save(self.path)
        return self

    @property
    def num_kmers(self) -> int:
        """Total number of indexed k-mer occurrences."""
        return self._n

    @property
    def num_seqs(self) -> int:
        return len(self._lens)

    # -- queries --------------------------------------------------------------
    def hits(self, kmer: int):
        """All (seq_id, pos) occurrences of a packed k-mer.

        ``searchsorted`` over the sorted key column — the B-tree lookup.
        Runs on HOST copies of the columns (cached on first use): a
        device searchsorted costs two dispatches per lookup, vs
        microseconds for numpy — this is the reference's point-query
        path, not a batch op.
        """
        if getattr(self, "_keys_np", None) is None or \
                len(self._keys_np) != self._n:
            self._keys_np = np.asarray(self._keys)
            self._seqs_np = np.asarray(self._seqs)
            self._poss_np = np.asarray(self._poss)
        lo = int(np.searchsorted(self._keys_np, np.int32(kmer), "left"))
        hi = int(np.searchsorted(self._keys_np, np.int32(kmer), "right"))
        return list(
            zip(
                self._seqs_np[lo:hi].tolist(),
                self._poss_np[lo:hi].tolist(),
            )
        )

    def kmers(self):
        """Distinct k-mers present in the index (host list of ints)."""
        if self._n == 0:
            return []
        is_start, _ = tables.run_boundaries(self._keys)
        return np.asarray(self._keys)[np.asarray(is_start)].tolist()

    def counts(self):
        """(distinct_kmers, occurrence_counts) as host arrays."""
        if self._n == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        keys = np.asarray(self._keys)
        uniq, cnt = np.unique(keys, return_counts=True)
        return uniq.astype(np.int32), cnt.astype(np.int32)

    def score_kmers(self):
        """Log p-value of each distinct k-mer's frequency under a uniform
        null — large values flag repetitive k-mers to mask before seeding.

        Mirrors ``biseqt/kmers.py — KmerIndex.score_kmers`` (normal
        approximation to the binomial occurrence count).
        """
        uniq, cnt = self.counts()
        total = int(sum(self._lens)) - len(self._lens) * (self.wordlen - 1)
        p_null = 1.0 / (len(self.alphabet) ** self.wordlen)
        mu, sd = binomial_to_normal(total, p_null)
        scores = normal_neg_log_pvalue(mu, sd, jnp.asarray(cnt, jnp.float32))
        return uniq, np.asarray(scores)

    def mask_repetitive(self, max_score: float = 10.0):
        """Drop occurrences of k-mers whose frequency-score exceeds the
        threshold; returns the number of occurrences removed."""
        uniq, scores = self.score_kmers()
        bad = uniq[scores > max_score]
        if bad.size == 0:
            return 0
        keys = np.asarray(self._keys)
        drop = np.isin(keys, bad)
        keep = ~drop
        self._keys = jnp.asarray(keys[keep])
        self._seqs = jnp.asarray(np.asarray(self._seqs)[keep])
        self._poss = jnp.asarray(np.asarray(self._poss)[keep])
        removed = int(drop.sum())
        self._n -= removed
        self._keys_np = None            # invalidate the hits() cache
        if self.path:
            # keep the snapshot in sync — index_kmers auto-saves, so a
            # stale unmasked snapshot would resurrect the masked k-mers
            # in the next process
            self.save(self.path)
        return removed

    # -- database integration -------------------------------------------------
    def attach_to(self, db):
        """Subscribe to a :class:`biseqt_jax.database.DB` so ingested
        sequences are collected for indexing (the reference's event-hook
        pattern: a KmerIndex subscribes to 'sequence-inserted').

        Sequences accumulate; call :meth:`refresh` (or query after inserts)
        to (re)build the table in one batched sort.
        """
        self._pending = getattr(self, "_pending", [])

        def on_insert(db_, rec, seq):
            self._pending.append(seq)

        db.add_event_listener("sequence-inserted", on_insert)
        return self

    def refresh(self):
        """Index sequences accumulated via :meth:`attach_to` since the
        last refresh, merging them into the existing table (incremental:
        each batch is sorted once and merged — repeated refreshes do NOT
        re-index earlier sequences, and sequences indexed directly via
        :meth:`index_kmers` are preserved)."""
        pending = getattr(self, "_pending", [])
        if pending:
            self._pending = []
            self.index_kmers(pending, append=self._n > 0)
        return self

    # -- table access for downstream ops (seeds) ------------------------------
    def table(self):
        """The raw sorted (keys, seqs, poss) device triple."""
        return self._keys, self._seqs, self._poss

    # -- persistence ----------------------------------------------------------
    def save(self, path: str):
        np.savez_compressed(
            path,
            keys=np.asarray(self._keys),
            seqs=np.asarray(self._seqs),
            poss=np.asarray(self._poss),
            lens=np.asarray(self._lens, np.int64),
            ids=np.asarray(self._ids, dtype=object),
            wordlen=self.wordlen,
            letters="\x00".join(self.alphabet.letters),
        )

    def load(self, path: str):
        z = np.load(path, allow_pickle=True)
        assert int(z["wordlen"]) == self.wordlen, "wordlen mismatch"
        saved_letters = str(z["letters"])
        want = "\x00".join(self.alphabet.letters)
        assert saved_letters == want, (
            "alphabet mismatch: snapshot %r vs index %r"
            % (saved_letters.split("\x00"), list(self.alphabet.letters))
        )
        self._keys = jnp.asarray(z["keys"])
        self._seqs = jnp.asarray(z["seqs"])
        self._poss = jnp.asarray(z["poss"])
        self._lens = z["lens"].tolist()
        self._ids = z["ids"].tolist()
        self._n = int(z["keys"].shape[0])
        self._keys_np = None            # invalidate the hits() cache
        return self


class KmerCache:
    """Cache of packed k-mer arrays keyed by sequence content id.

    Mirrors ``biseqt/kmers.py — KmerCache`` (the SQLite kmer-sequence cache)
    with a directory of ``.npy`` files.
    """

    def __init__(self, path: str, wordlen: int, alphabet: Alphabet):
        self.path = path
        self.wordlen = int(wordlen)
        self.alphabet = alphabet
        os.makedirs(path, exist_ok=True)

    def _file(self, seq: Sequence) -> str:
        return os.path.join(
            self.path, "%s.w%d.npy" % (seq.content_id, self.wordlen)
        )

    def as_kmer_seq(self, seq: Sequence) -> np.ndarray:
        f = self._file(seq)
        if os.path.exists(f):
            return np.load(f)
        if len(self.alphabet) ** self.wordlen < 2 ** 63:
            # straight to the vectorized array tier — the module-level
            # as_kmer_seq's list materialization costs more at genome
            # scale than the packing itself
            out = as_kmer_keys_np(
                seq.to_array(), self.wordlen, len(self.alphabet))
        else:
            out = np.asarray(as_kmer_seq(seq, self.wordlen), dtype=np.int64)
        np.save(f, out)
        return out
