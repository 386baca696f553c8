"""K-mer packing + index tests (ref strategy: tests/test_kmers.py)."""

import os
import numpy as np
import jax.numpy as jnp
import pytest

from biseqt_jax.sequence import Alphabet, Sequence, pack_sequences
from biseqt_jax.kmers import kmer_as_int, as_kmer_seq, KmerIndex, KmerCache
from biseqt_jax.ops.tables import kmer_keys, KEY_SENTINEL, build_kmer_table
from biseqt_jax.stochastics import rand_seq

A4 = Alphabet("ACGT")


def test_kmer_as_int_roundtrip():
    # base-4 positional packing, most significant first
    assert kmer_as_int((0, 0, 0), A4) == 0
    assert kmer_as_int((0, 1, 2), A4) == 0 * 16 + 1 * 4 + 2
    assert kmer_as_int((3, 3, 3), A4) == 63
    # distinct k-mers -> distinct ints (exhaustive for k=3)
    seen = set()
    for a in range(4):
        for b in range(4):
            for c in range(4):
                seen.add(kmer_as_int((a, b, c), A4))
    assert len(seen) == 64


def test_as_kmer_seq_matches_scalar():
    s = A4.parse("ACGTTGCA")
    ks = as_kmer_seq(s, 3)
    assert len(ks) == 6
    expect = [kmer_as_int(s.contents[i:i + 3], A4) for i in range(6)]
    assert ks == expect


def test_device_kmer_keys_match_host(rng):
    seqs = [rand_seq(A4, n, rng=rng) for n in (10, 7, 16)]
    codes, lengths = pack_sequences(seqs)
    keys = np.asarray(kmer_keys(jnp.asarray(codes), jnp.asarray(lengths), 4))
    for b, s in enumerate(seqs):
        host = as_kmer_seq(s, 4)
        n = len(host)
        assert keys[b, :n].tolist() == host
        assert (keys[b, n:] == KEY_SENTINEL).all()


def test_kmer_index_hits(rng):
    seqs = [rand_seq(A4, 60, rng=rng) for _ in range(5)]
    idx = KmerIndex(wordlen=5, alphabet=A4).index_kmers(seqs)
    assert idx.num_seqs == 5
    assert idx.num_kmers == sum(len(s) - 4 for s in seqs)
    # every hit must be a real occurrence; spot check all distinct kmers
    for km in idx.kmers()[:50]:
        for sid, pos in idx.hits(km):
            window = seqs[sid].contents[pos:pos + 5]
            assert kmer_as_int(window, A4) == km
    # a kmer that cannot occur (sentinel-1) has no hits
    assert idx.hits(4 ** 5 - 1) == idx.hits(4 ** 5 - 1)


def test_kmer_index_counts_and_scores(rng):
    # plant a heavily repeated kmer
    core = A4.parse("ACGTA")
    s = Sequence(A4, sum([core.contents] * 30, ()))
    other = rand_seq(A4, 150, rng=rng)
    idx = KmerIndex(wordlen=5, alphabet=A4).index_kmers([s, other])
    uniq, scores = idx.score_kmers()
    km = kmer_as_int(core.contents, A4)
    k_at = np.where(uniq == km)[0]
    assert k_at.size == 1
    # the planted repeat must be among the highest-scoring kmers
    assert scores[k_at[0]] >= np.percentile(scores, 95)
    removed = idx.mask_repetitive(max_score=20.0)
    assert removed >= 30 - 4


def test_kmer_index_persistence(tmp_path, rng):
    seqs = [rand_seq(A4, 40, rng=rng) for _ in range(3)]
    p = str(tmp_path / "idx.npz")
    idx = KmerIndex(wordlen=4, alphabet=A4, path=p).index_kmers(seqs)
    n = idx.num_kmers
    km = idx.kmers()[0]
    hits = idx.hits(km)
    # reload from snapshot (reference: SQLite files reused if present)
    idx2 = KmerIndex(wordlen=4, alphabet=A4, path=p)
    assert idx2.num_kmers == n
    assert idx2.hits(km) == hits


def test_kmer_cache(tmp_path, rng):
    s = rand_seq(A4, 50, rng=rng)
    cache = KmerCache(str(tmp_path / "kc"), wordlen=6, alphabet=A4)
    a = cache.as_kmer_seq(s)
    b = cache.as_kmer_seq(s)  # second call hits the disk cache
    assert a.tolist() == b.tolist() == as_kmer_seq(s, 6)


def test_build_kmer_table_sorted(rng):
    seqs = [rand_seq(A4, 30, rng=rng) for _ in range(4)]
    codes, lengths = pack_sequences(seqs)
    keys, sids, poss, n = build_kmer_table(
        jnp.asarray(codes), jnp.asarray(lengths), 3
    )
    keys = np.asarray(keys)
    n = int(n)
    assert (np.diff(keys[:n]) >= 0).all()
    assert (keys[n:] == KEY_SENTINEL).all()


def test_incremental_refresh_merges_batches():
    """insert -> refresh -> insert -> refresh: both batches queryable,
    earlier batches are not re-indexed or thrown away (regression: refresh
    used to rebuild from only the latest pending batch)."""
    import io
    from biseqt_jax.database import DB
    from biseqt_jax.kmers import KmerIndex

    db = DB(":memory:", A4)
    idx = KmerIndex(wordlen=4, alphabet=A4).attach_to(db)
    db.load_fasta(io.StringIO(">a\nACGTACGTAC\n"))
    idx.refresh()
    assert idx.num_seqs == 1 and idx.num_kmers == 7
    db.load_fasta(io.StringIO(">b\nTTACGTTT\n"))
    idx.refresh()
    assert idx.num_seqs == 2
    assert idx.num_kmers == 7 + 5
    # k-mer ACGT appears in both sequences with distinct seq ids
    from biseqt_jax.kmers import kmer_as_int
    km = kmer_as_int([A4.letters.index(c) for c in "ACGT"], A4)
    hits = idx.hits(km)
    seqs_seen = {s for s, _ in hits}
    assert seqs_seen == {0, 1}, hits
    # refresh with nothing pending is a no-op
    tbl = idx.table()
    idx.refresh()
    assert idx.table()[0] is tbl[0]
    # direct index + refresh: direct batch preserved
    idx2 = KmerIndex(wordlen=4, alphabet=A4)
    from biseqt_jax.sequence import Sequence
    idx2.index_kmers([A4.parse("ACGTACGTAC")])
    db2 = DB(":memory:", A4)
    idx2.attach_to(db2)
    db2.load_fasta(io.StringIO(">c\nTTACGTTT\n"))
    idx2.refresh()
    assert idx2.num_seqs == 2 and idx2.num_kmers == 12
    assert {s for s, _ in idx2.hits(km)} == {0, 1}


def test_snapshot_path_without_npz_suffix_is_reused(tmp_path):
    """np.savez appends '.npz' to suffixless paths; the index must still
    find its own snapshot on the next construction (it silently rebuilt
    every run before the path normalization)."""
    p = str(tmp_path / "idx_cache")     # no .npz suffix on purpose
    idx = KmerIndex(4, A4, path=p)
    idx.index_kmers([Sequence(A4, (0, 1, 2, 3, 0, 1, 2, 3))])
    assert os.path.exists(p + ".npz")
    idx2 = KmerIndex(4, A4, path=p)
    assert idx2.num_kmers == idx.num_kmers and idx2.num_kmers > 0


def test_snapshot_alphabet_mismatch_rejected(tmp_path):
    p = str(tmp_path / "idx.npz")
    KmerIndex(4, A4, path=p).index_kmers(
        [Sequence(A4, (0, 1, 2, 3, 0, 1, 2, 3))]
    )
    with pytest.raises(AssertionError, match="alphabet mismatch"):
        KmerIndex(4, Alphabet("TGCA"), path=p)


def test_mask_repetitive_persists_to_snapshot(tmp_path):
    rng = np.random.default_rng(5)
    p = str(tmp_path / "idx.npz")
    seqs = [Sequence(A4, tuple(rng.integers(0, 4, 500).tolist()))]
    # inject a heavy repeat so masking has something to drop
    rep = Sequence(A4, (0, 1, 0, 2) * 100)
    idx = KmerIndex(4, A4, path=p)
    idx.index_kmers(seqs + [rep])
    removed = idx.mask_repetitive(max_score=5.0)
    assert removed > 0
    idx2 = KmerIndex(4, A4, path=p)
    assert idx2.num_kmers == idx.num_kmers, "snapshot kept masked table"


def test_as_kmer_keys_np_negative_and_edge_windows():
    from biseqt_jax.kmers import as_kmer_keys_np
    # windows touching a negative (ambiguity/PAD) code come back -1
    c = np.array([0, 1, -1, 2, 3, 0, 1, 2], np.int64)
    got = as_kmer_keys_np(c, 3, 4).tolist()
    assert got == [-1, -1, -1, 2 * 16 + 3 * 4 + 0, 3 * 16 + 0 * 4 + 1,
                   0 * 16 + 1 * 4 + 2]
    # shorter than wordlen -> empty
    assert as_kmer_keys_np(np.array([1, 2], np.int8), 3, 4).size == 0
    # int8 input takes the in-place hot path; values match int64 input
    c8 = np.array([3, 0, 2, 1, 3, 3], np.int8)
    assert as_kmer_keys_np(c8, 4, 4).tolist() == \
        as_kmer_keys_np(c8.astype(np.int64), 4, 4).tolist()
    # float/object code arrays worked in the pre-vectorized tier —
    # the in-place += path must coerce, not UFuncTypeError
    assert as_kmer_keys_np(c8.astype(np.float64), 4, 4).tolist() == \
        as_kmer_keys_np(c8, 4, 4).tolist()
    cf = np.array([0.0, 1.0, -1.0, 2.0], np.float64)
    assert as_kmer_keys_np(cf, 2, 4).tolist() == [1, -1, -1]


def test_as_kmer_seq_wide_wordlen_fallback():
    # |alphabet|**wordlen >= 2**63 exercises the exact Python-int tier;
    # check it against kmer_as_int directly (2-letter alphabet, k=63)
    A2 = Alphabet("01")
    s = Sequence(A2, np.array([1] + [0] * 64, np.int8))
    ks = as_kmer_seq(s, 63)
    assert len(ks) == 3
    assert ks[0] == 2 ** 62
    assert ks[1] == 0 and ks[2] == 0
