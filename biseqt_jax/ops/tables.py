"""Sorted-array table ops: k-mer packing, radix tables, merge joins.

This module is the on-device replacement for the reference's SQLite-backed
``biseqt/kmers.py — KmerIndex`` and ``biseqt/seeds.py — SeedIndex`` storage
engines.  The design (per SURVEY.md §7):

  * k-mers pack to int32 keys by base-|Σ| positional encoding — a windowed
    dot product with the powers vector, fully vectorized.
  * the "index" is the triple of arrays ``(key, seq, pos)`` sorted
    lexicographically — ``jax.lax.sort`` with ``num_keys`` — instead of a
    B-tree; lookups are ``searchsorted`` and aggregations are segmented
    reductions over the sorted runs.
  * the seed "join" between two sequences' k-mer lists is a capacity-bounded
    sorted-merge expansion: per-query hit ranges come from two searchsorted
    calls, and the variable-size pair expansion is re-expressed as a static
    gather by inverting the cumulative hit-count function (searchsorted over
    the cumsum), so everything stays jit-compatible with static shapes.

Invalid/padded slots use ``KEY_SENTINEL`` (int32 max) so they sort to the end
and fall out of every searchsorted range naturally.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

KEY_SENTINEL = np.int32(np.iinfo(np.int32).max)

__all__ = [
    "KEY_SENTINEL",
    "kmer_keys",
    "build_kmer_table",
    "hit_ranges",
    "expand_join",
    "seed_join",
    "run_boundaries",
]


def kmer_keys(codes, lengths, wordlen: int, alphabet_len: int = 4):
    """Pack every k-window of each row into an int32 key.

    ``codes``: int8 ``[B, L]`` (PAD = -1 outside ``lengths``).  Window t of
    row b covers positions ``[t, t+wordlen)``; windows overrunning the row
    length (or containing PAD) get ``KEY_SENTINEL``.

    Returns int32 ``[B, L]`` (positions ``L-wordlen+1 .. L`` are sentinel).

    The pack is a sum of ``wordlen`` shifted scalings — elementwise, no
    gather.  |Σ|^wordlen must fit int32 (wordlen <= 15 for DNA).
    """
    if alphabet_len ** wordlen >= 2 ** 31:
        raise ValueError(
            "alphabet_len**wordlen must fit int32; got %d^%d"
            % (alphabet_len, wordlen)
        )
    B, L = codes.shape
    codes_i = codes.astype(jnp.int32)
    c = jnp.maximum(codes_i, 0)
    key = jnp.zeros((B, L), dtype=jnp.int32)
    # any negative code INSIDE the window (e.g. an ambiguous base coded
    # -1 mid-sequence) must sentinel the window too, not alias to base 0
    has_pad = jnp.zeros((B, L), dtype=bool)
    for t in range(wordlen):
        # codes shifted left by t; out-of-range becomes 0 (masked later)
        shifted = jnp.pad(c[:, t:], ((0, 0), (0, t)))
        key = key + shifted * (alphabet_len ** (wordlen - 1 - t))
        has_pad = has_pad | (
            jnp.pad(codes_i[:, t:], ((0, 0), (0, t))) < 0
        )
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    valid = (pos + wordlen <= lengths[:, None]) & ~has_pad
    return jnp.where(valid, key, KEY_SENTINEL)


@partial(jax.jit, static_argnames=("wordlen", "alphabet_len"))
def build_kmer_table(codes, lengths, wordlen: int, alphabet_len: int = 4):
    """Build the sorted (key, seq, pos) k-mer table for a packed batch.

    The device equivalent of ``biseqt/kmers.py — KmerIndex.index_kmers`` +
    ``create_sql_index``: one radix sort replaces all SQL inserts plus the
    B-tree build.

    Returns ``(keys, seqs, poss, n_valid)`` — int32 arrays of length
    ``B*L`` sorted lexicographically by (key, seq, pos); sentinel rows at the
    end; ``n_valid`` = number of real k-mer occurrences.
    """
    B, L = codes.shape
    keys = kmer_keys(codes, lengths, wordlen, alphabet_len).reshape(-1)
    seqs = jnp.repeat(jnp.arange(B, dtype=jnp.int32), L)
    poss = jnp.tile(jnp.arange(L, dtype=jnp.int32), B)
    keys, seqs, poss = jax.lax.sort((keys, seqs, poss), num_keys=3)
    n_valid = jnp.sum(keys != KEY_SENTINEL).astype(jnp.int32)
    return keys, seqs, poss, n_valid


def hit_ranges(table_keys, query_keys):
    """For each query key, the [start, end) run in a sorted key array.

    ``searchsorted`` left/right — the B-tree lookup replacement.
    """
    start = jnp.searchsorted(table_keys, query_keys, side="left")
    end = jnp.searchsorted(table_keys, query_keys, side="right")
    return start.astype(jnp.int32), end.astype(jnp.int32)


def expand_join(starts, counts, capacity: int):
    """Invert a ragged expansion into static-shape gathers.

    Given per-query hit-run starts and counts, produce for each output slot
    ``n < capacity`` the (query_index, table_index) pair it corresponds to,
    in query-major order.  Slots past ``total = sum(counts)`` are masked.

    This is the jit-safe replacement for the dynamic "emit all pairs" loop:
    ``query_of[n] = searchsorted(cumsum(counts), n, 'right')`` and
    ``table_of[n] = starts[q] + (n - offset[q])``.

    Returns ``(query_idx [capacity], table_idx [capacity], valid [capacity],
    total)``.

    Overflow contract: ``total`` is an int32 cumsum (x64 is disabled in
    this stack); past 2^31 expanded pairs it wraps NEGATIVE.  Callers of
    the total-vs-capacity re-call protocol MUST treat ``total < 0`` as
    overflow, never as "fits" (2^31 seeds would not fit in HBM anyway —
    the right response is an error or a coarser join).
    """
    counts = counts.astype(jnp.int32)
    ends = jnp.cumsum(counts)
    offsets = ends - counts
    total = ends[-1] if counts.shape[0] > 0 else jnp.int32(0)
    slot = jnp.arange(capacity, dtype=jnp.int32)
    q = jnp.searchsorted(ends, slot, side="right").astype(jnp.int32)
    q = jnp.minimum(q, counts.shape[0] - 1)
    rank = slot - offsets[q]
    t = starts[q] + rank
    valid = slot < total
    return q, t, valid, total.astype(jnp.int32)


@partial(jax.jit, static_argnames=("wordlen", "alphabet_len"))
def seed_total(codes0, len0, codes1, len1, wordlen: int,
               alphabet_len: int = 4):
    """Exact number of seeds between a pair, without materializing them.

    One searchsorted pass — lets callers size :func:`seed_join`'s static
    capacity right the first time instead of re-compiling through doubling.
    """
    k0 = kmer_keys(codes0[None, :], jnp.asarray([len0], jnp.int32),
                   wordlen, alphabet_len)[0]
    k1 = kmer_keys(codes1[None, :], jnp.asarray([len1], jnp.int32),
                   wordlen, alphabet_len)[0]
    sk1 = jax.lax.sort(k1)
    starts, ends = hit_ranges(sk1, k0)
    return jnp.sum(
        jnp.where(k0 != KEY_SENTINEL, ends - starts, 0)
    ).astype(jnp.int32)


@partial(jax.jit, static_argnames=("wordlen", "alphabet_len", "capacity"))
def seed_join(codes0, len0, codes1, len1, wordlen: int,
              alphabet_len: int = 4, capacity: int = 1 << 18):
    """Enumerate exact k-mer matches (seeds) between two sequences.

    The on-device ``biseqt/seeds.py — SeedIndex`` seed enumeration: instead
    of a SQL self-join of hit lists, sort T's k-mers once, then for every S
    window binary-search its run in T and expand pairs with
    :func:`expand_join`.

    Args:
        codes0/1: int8 ``[L]`` code rows (PAD tail ok).
        len0/1: scalars.
        capacity: static bound on emitted seeds (mask + total reported).

    Returns dict of int32 arrays of length ``capacity``:
        ``i`` (pos in S), ``j`` (pos in T), ``valid`` mask, and scalar
        ``total`` (true seed count — may exceed capacity; caller re-calls
        with a larger capacity bucket when ``total > capacity``).
    """
    L0 = codes0.shape[0]
    L1 = codes1.shape[0]
    k0 = kmer_keys(codes0[None, :], jnp.asarray([len0], jnp.int32),
                   wordlen, alphabet_len)[0]
    k1 = kmer_keys(codes1[None, :], jnp.asarray([len1], jnp.int32),
                   wordlen, alphabet_len)[0]
    # sort T k-mers by key, carrying positions
    pos1 = jnp.arange(L1, dtype=jnp.int32)
    sk1, sp1 = jax.lax.sort((k1, pos1), num_keys=1)
    starts, ends = hit_ranges(sk1, k0)
    counts = jnp.where(k0 != KEY_SENTINEL, ends - starts, 0)
    qi, ti, valid, total = expand_join(starts, counts, capacity)
    i = qi
    j = sp1[jnp.clip(ti, 0, L1 - 1)]
    i = jnp.where(valid, i, 0)
    j = jnp.where(valid, j, 0)
    return {"i": i, "j": j, "valid": valid, "total": total}


@partial(jax.jit, static_argnames=("wordlen", "alphabet_len", "capacity"))
def seed_join_sorted(codes0, len0, codes1, len1, wordlen: int,
                     alphabet_len: int = 4, capacity: int = 1 << 18):
    """:func:`seed_join` + band-coordinate transform + (d_, a) lexsort,
    all on device — the genome-scale SeedIndex build path (the host-side
    ``np.lexsort`` round-trip cost ~minutes at Mbp scale with remote
    compiles; here one jit produces the final sorted arrays).

    Returns dict: ``d_`` (= i - j + len1, int32, sorted ascending, sentinel
    tail = KEY_SENTINEL), ``a`` (= i + j, secondary sort key), ``total``.
    """
    out = seed_join(codes0, len0, codes1, len1, wordlen, alphabet_len,
                    capacity=capacity)
    valid = out["valid"]
    d_ = jnp.where(valid, out["i"] - out["j"] + len1, KEY_SENTINEL)
    a = jnp.where(valid, out["i"] + out["j"], 0)
    d_, a = jax.lax.sort((d_, a), num_keys=2)
    return {"d_": d_, "a": a, "total": out["total"]}


@partial(jax.jit, static_argnames=("wordlen", "alphabet_len"))
def nway_shared_seeds(codes, lengths, wordlen: int, alphabet_len: int = 4):
    """Lexicographically (key, seq, pos)-sorted k-mer table over N
    sequences — the device half of first-hit N-way seed discovery.

    The device tier of ``biseqt/seeds.py — SeedIndexMultiple``: one
    global radix sort over all N sequences' (key, seq, pos) triples.
    The consumer (``seeds.SeedIndexMultiple._build_device``) finishes
    with vectorized host grouping: within a key run, the first entry of
    each seq subgroup is that sequence's first occurrence, and runs
    touching all N sequences are the shared seeds.

    (A previous design scatter-minned positions into a [runs, N] device
    matrix — colliding XLA scatter updates serialize, and the ~N*L-update
    scatter dwarfed the sort at 10 x 100 kbp.)

    Returns ``(keys, seqs, poss)`` int32 arrays, sentinel keys sorted to
    the tail.
    """
    keys, seqs, poss, _ = build_kmer_table(
        codes, lengths, wordlen, alphabet_len
    )
    return jax.lax.sort((keys, seqs, poss), num_keys=3)


def run_boundaries(sorted_keys):
    """Start flags + run ids over a sorted key array (segmented-reduce prep).

    Returns ``(is_start bool[N], run_id int32[N])`` where ``run_id`` is the
    0-based index of each distinct run (sentinel runs included).
    """
    prev = jnp.concatenate(
        [jnp.full((1,), -1, sorted_keys.dtype), sorted_keys[:-1]]
    )
    is_start = sorted_keys != prev
    run_id = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    return is_start, run_id
