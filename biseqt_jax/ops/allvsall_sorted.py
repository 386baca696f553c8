"""Sort-join all-vs-all overlap statistics (the at-scale path).

The per-pair binary-search formulation (:mod:`..parallel.allvsall`) is
gather-bound — fine for a few hundred reads, hopeless at 1000+.
This module is the sort-native redesign, the direct all-vs-all analog of
the reference's SQL self-join (``biseqt/seeds.py — SeedIndex``) done
with sorts:

  1. ONE global radix-sorted k-mer table over all reads
     (:func:`..ops.tables.build_kmer_table`);
  2. seeds materialize as a *capped run expansion*: every table entry
     pairs with the next ``max_run`` entries of its k-mer run (repetitive
     k-mers beyond the cap are dropped — the role ``score_kmers`` masking
     plays in the reference);
  3. each seed becomes one int32 composite ``(query, target, d-bucket)``
     key; one more sort + run-length count gives every pair's diagonal
     histogram *sparsely*;
  4. sliding 3-bucket windows come from neighboring composites, and a
     segmented max per pair yields the best overlap band.

Everything is sorts, cumsums and segment ops — no per-pair loops, no
gathers over big tables.  Cost: O(total_kmers * max_run) expansion + two
device sorts.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .tables import build_kmer_table, KEY_SENTINEL

__all__ = ["overlap_stats_sorted", "overlap_stats_sorted_chunked"]


def auto_max_run(n_reads: int, L: int, wordlen: int,
                 alphabet_len: int = 4) -> int:
    """Partner cap sized to the expected k-mer run length.

    In all-vs-all the mean run length is mu = N*L / |Sigma|^w (coverage
    co-occurrences + uniform collisions).  A cap far below mu samples a
    biased sliver of each run — entries are (key, read, pos)-sorted, so
    far-apart read indices almost never land within the cap, and true
    pairs' seed counts collapse (measured: config 4 at a 100 kbp genome
    with the old fixed cap of 4 had recall 0.26; at 2.5x mu it is ~1).
    Cost is linear in the cap (O(2 * cap * total_kmers) int32 expansion
    plus a same-size sort), so the cap is also bounded by an element
    budget: 2 * cap * total_kmers <= 256M (~1 GB of composites — the
    un-budgeted 96-cap expansion at 1000 x 10 kbp crashed the device worker
    with the sort workspace on top).  Runs past the budgeted cap lose
    only their tail partners (~90% of co-occurrences survive at the
    1000-read config, vs ~9% with the old fixed cap of 4).
    """
    mu = n_reads * max(L, 1) / float(alphabet_len ** wordlen)
    cap = int(np.clip(np.ceil(2.5 * mu), 8, 96))
    budget = (256 << 20) // max(2 * n_reads * L, 1)
    # the budget WINS below the statistical floor: a floor of 8 at
    # n_reads*L > 16M would re-create the very expansion blow-up the
    # budget exists to prevent.  But a budget-starved cap degrades seed
    # counts the same way the old fixed cap did (the recall-0.26
    # failure) — be LOUD about it: the caller should raise wordlen (mu
    # shrinks as |Sigma|^-w) or pass max_run explicitly.
    out = max(1, min(cap, budget))
    if out < min(cap, 8):
        import warnings

        warnings.warn(
            "auto_max_run: the expansion budget caps the k-mer partner "
            "window at %d while the expected run length is ~%.0f — "
            "overlap seed counts WILL be undercounted; raise wordlen "
            "(fewer collisions per key) or pass max_run explicitly"
            % (out, mu), RuntimeWarning, stacklevel=2)
    return out


def overlap_stats_sorted_chunked(codes, lengths, *, wordlen: int,
                                 n_reads: int, alphabet_len: int = 4,
                                 bucket: int = 64, max_run: int = None,
                                 max_chunk: int = None,
                                 min_window: int = 5):
    """:func:`overlap_stats_sorted` for any N: when the int32 composite
    key (q_local * N * nbins) would overflow, query rows are processed in
    equal-size windows via the existing ``n_local``/``q_lo`` machinery.

    All chunks share one compiled program (q_lo is traced, shapes are
    identical; the last window is shifted to overlap rather than
    shrunk).  This removes the single-device read-count ceiling — at
    L=10 kbp / bucket=64 the unchunked path caps at ~2.6k reads; chunked,
    N is bounded only by memory for the [N, N] outputs.
    """
    N, L = codes.shape
    assert N == n_reads
    nbins = (2 * L) // bucket + 2
    limit = max(int((2 ** 31 - 1) // (nbins * N)), 1)
    if max_chunk is not None:
        limit = min(limit, int(max_chunk))
    kw = dict(wordlen=wordlen, n_reads=n_reads, alphabet_len=alphabet_len,
              bucket=bucket, max_run=max_run, min_window=min_window)
    if limit >= N:
        return overlap_stats_sorted(codes, lengths, **kw)
    out = None
    q_lo = 0
    while q_lo < N:
        if q_lo + limit > N:
            q_lo = N - limit          # shifted last window (same shape)
        part = overlap_stats_sorted(
            codes, lengths, n_local=limit, q_lo=q_lo, **kw
        )
        if out is None:
            out = {
                k: np.zeros((N,) + v.shape[1:], np.asarray(v).dtype)
                for k, v in part.items()
            }
        for k, v in part.items():
            out[k][q_lo:q_lo + limit] = np.asarray(v)
        q_lo += limit
    return out


def overlap_stats_sorted(codes, lengths, *, wordlen: int,
                         n_reads: int, alphabet_len: int = 4,
                         bucket: int = 64, max_run: int = None,
                         n_local: int = None, q_lo=None,
                         min_window: int = 5):
    """Best-overlap-band statistics for every ordered read pair.

    Args:
        codes: int8 [N, L]; lengths: int32 [N]; ``n_reads`` == N (static).
        bucket: diagonal bucket width (band resolution).
        max_run: per-entry partner cap within a k-mer run (repeat
            guard); None (default) sizes it to the expected run length
            via :func:`auto_max_run` — a fixed small cap silently
            collapses seed counts once coverage or collision density
            pushes runs past it.
        n_local / q_lo: optionally restrict query rows to the window
            ``[q_lo, q_lo + n_local)`` — the mesh-sharded mode, where each
            device owns a row block of the pair matrix (q_lo may be a
            traced value, e.g. ``axis_index * n_local``).

    Returns dict of [n_local or N, N] arrays: ``window`` (best 3-bucket
    band seed count), ``diag`` (band center diagonal, d = pos_q - pos_t),
    ``p`` (match-prob estimate), ``s0`` (H0 score), ``olap_len``.
    """
    # resolve the cap (and emit auto_max_run's budget-starved warning)
    # EAGERLY: resolving inside the jitted body made the diagnostic fire
    # only on the first trace of a shape — cache-hit calls in the same
    # process, and every call in a fresh process reusing the persistent
    # compile cache, stayed silent (advisor round 3).  max_run is pure
    # host math, so this also runs fine at trace time under shard_map.
    if max_run is None:
        max_run = auto_max_run(n_reads, codes.shape[1], wordlen,
                               alphabet_len)
    return _overlap_stats_sorted_impl(
        codes, lengths, wordlen=wordlen, n_reads=n_reads,
        alphabet_len=alphabet_len, bucket=bucket, max_run=int(max_run),
        n_local=n_local, q_lo=q_lo, min_window=min_window,
    )


@functools.partial(
    jax.jit,
    static_argnames=("wordlen", "alphabet_len", "bucket", "max_run",
                     "n_reads", "n_local", "min_window"),
)
def _overlap_stats_sorted_impl(codes, lengths, *, wordlen: int,
                               n_reads: int, alphabet_len: int,
                               bucket: int, max_run: int,
                               n_local: int = None, q_lo=None,
                               min_window: int = 5):
    from . import blot_stats

    N, L = codes.shape
    assert N == n_reads
    if n_local is None:
        n_local = N
        q_lo = 0
    q_lo = jnp.int32(q_lo)
    nbins = (2 * L) // bucket + 2
    n_pairs = n_local * N
    assert n_pairs * nbins < 2 ** 31, (
        "composite key overflows int32; raise bucket or shard reads"
    )

    keys, seqs, poss, _ = build_kmer_table(
        codes, lengths, wordlen, alphabet_len
    )
    M = keys.shape[0]

    # run membership: entry i pairs with entries i+1 .. i+max_run while the
    # key matches (and is not the sentinel)
    slots = []
    for h in range(1, max_run + 1):
        k2 = jnp.concatenate(
            [keys[h:], jnp.full((h,), KEY_SENTINEL - 1, keys.dtype)]
        )
        s2 = jnp.concatenate([seqs[h:], jnp.zeros((h,), seqs.dtype)])
        p2 = jnp.concatenate([poss[h:], jnp.zeros((h,), poss.dtype)])
        valid = (keys == k2) & (keys != KEY_SENTINEL)
        valid &= seqs != s2  # seeds across distinct reads only
        # composite (q_local, t, dbucket); both directions emitted, each
        # masked by query ownership of this row window
        d_ab = jnp.clip((poss - p2) + L, 0, 2 * L)
        d_ba = jnp.clip((p2 - poss) + L, 0, 2 * L)
        la = seqs - q_lo
        lb = s2 - q_lo
        own_a = (la >= 0) & (la < n_local)
        own_b = (lb >= 0) & (lb < n_local)
        comp_ab = (la * N + s2) * nbins + d_ab // bucket
        comp_ba = (lb * N + seqs) * nbins + d_ba // bucket
        big = jnp.int32(2 ** 31 - 1)
        slots.append(jnp.where(valid & own_a, comp_ab, big))
        slots.append(jnp.where(valid & own_b, comp_ba, big))
    comp = jnp.concatenate(slots)                     # [2*max_run*M]
    comp = jax.lax.sort(comp)

    # run-length count of identical composites
    first = jnp.concatenate([
        jnp.ones((1,), bool), comp[1:] != comp[:-1]
    ])
    rid = jnp.cumsum(first.astype(jnp.int32)) - 1
    counts = jnp.zeros((comp.shape[0],), jnp.int32).at[rid].add(
        jnp.where(comp < 2 ** 31 - 1, 1, 0)
    )
    # compact: one row per distinct composite (padded tail has comp=big)
    uniq_comp = jnp.where(first, comp, 2 ** 31 - 1)
    uniq_cnt = jnp.where(first, counts[rid], 0)
    order = jnp.argsort(uniq_comp)
    uniq_comp = uniq_comp[order]
    uniq_cnt = uniq_cnt[order]

    # 3-bucket sliding window: neighbors are adjacent rows at composite
    # +-1 — but only within the same pair (bucket 0's composite-1 would be
    # the previous pair's last bucket)
    dbin_all = uniq_comp % jnp.int32(nbins)
    left = jnp.concatenate([jnp.full((1,), -2, jnp.int32), uniq_comp[:-1]])
    lcnt = jnp.concatenate([jnp.zeros((1,), jnp.int32), uniq_cnt[:-1]])
    right = jnp.concatenate([uniq_comp[1:], jnp.full((1,), -2, jnp.int32)])
    rcnt = jnp.concatenate([uniq_cnt[1:], jnp.zeros((1,), jnp.int32)])
    window = (
        uniq_cnt
        + jnp.where((left == uniq_comp - 1) & (dbin_all > 0), lcnt, 0)
        + jnp.where(
            (right == uniq_comp + 1) & (dbin_all < nbins - 1), rcnt, 0
        )
    )

    # per-pair best window via segment_max over pair ids
    pair_id = jnp.clip(uniq_comp // nbins, 0, n_pairs - 1)
    dbin = uniq_comp % nbins
    valid_row = uniq_comp < 2 ** 31 - 1
    window = jnp.where(valid_row, window, 0)
    # sparse long-K noise guard: windows below the count floor never win.
    # Exposed (``min_window``) because at high error rates seed density
    # thins as ~p_match^w — 15%-error reads with short overlaps may need
    # a lower floor (traded against background noise; see
    # experiments/overlap_recall.py --sweep)
    window = jnp.where(window >= min_window, window, 0)
    # rank rows by background-corrected excess (a gather-free significance
    # proxy: raw counts favor long bands whose larger background explains
    # their seeds): excess = n - E[bg] - 3*sqrt(E[bg])
    # REAL per-pair lengths, not the padded L: with mixed-length reads
    # the padded geometry over-subtracts background unevenly across
    # diagonals and can crown the wrong band for short reads
    lens_f = lengths.astype(jnp.float32)
    qlen_r = jnp.take(lens_f, q_lo + pair_id // N)
    tlen_r = jnp.take(lens_f, pair_id % N)
    d_r = (dbin * bucket + bucket // 2 - L).astype(jnp.float32)
    seglen_row = jnp.maximum(
        jnp.minimum(jnp.minimum(qlen_r - d_r, tlen_r + d_r),
                    jnp.minimum(qlen_r, tlen_r)),
        1.0,
    )
    bg = 3.0 * bucket * seglen_row * (
        jnp.float32(alphabet_len) ** jnp.float32(-wordlen)
    )
    excess = window.astype(jnp.float32) - bg - 3.0 * jnp.sqrt(bg + 1.0)
    # the encoded (rank, dbin) pair must fit int32: cap the rank so
    # rank_cap * nbins + nbins < 2^31 (a 2^22 cap overflowed for
    # nbins >= 512 — near-duplicate long reads returned garbage bands)
    rank_cap = min(2 ** 22, (2 ** 31 - 1) // max(int(nbins), 1) - 1)
    rank_q = jnp.clip((excess * 16.0), 0, rank_cap).astype(jnp.int32)
    # winning bucket: segment_max over encoded (rank, dbin); the winner's
    # window count is reconstructed from its rank + that bucket's
    # background (1/16-count quantization — immaterial downstream)
    enc = rank_q * jnp.int32(nbins) + dbin
    best_enc = jax.ops.segment_max(
        jnp.where(valid_row, enc, -1), pair_id, num_segments=n_pairs,
        indices_are_sorted=True,
    )
    best_enc = jnp.maximum(best_enc, 0)
    best_bin = best_enc % nbins
    best_rank = (best_enc // nbins).astype(jnp.float32) / 16.0
    pid_all = jnp.arange(n_pairs, dtype=jnp.int32)
    qlen_b = jnp.take(lens_f, q_lo + pid_all // N)
    tlen_b = jnp.take(lens_f, pid_all % N)
    d_b = (best_bin * bucket + bucket // 2 - L).astype(jnp.float32)
    seglen_best = jnp.maximum(
        jnp.minimum(jnp.minimum(qlen_b - d_b, tlen_b + d_b),
                    jnp.minimum(qlen_b, tlen_b)),
        1.0,
    )
    bg_best = 3.0 * bucket * seglen_best * (
        jnp.float32(alphabet_len) ** jnp.float32(-wordlen)
    )
    best_w = jnp.where(
        best_rank > 0,
        best_rank + bg_best + 3.0 * jnp.sqrt(bg_best + 1.0),
        0.0,
    ).astype(jnp.int32)

    # geometry + statistics per pair
    qlen = jax.lax.dynamic_slice(
        lengths.astype(jnp.float32), (q_lo,), (n_local,)
    )[:, None]
    tlen = lengths[None, :].astype(jnp.float32)
    centers = (best_bin.reshape(n_local, N) * bucket + bucket // 2) - L
    d = centers.astype(jnp.float32)
    olap = jnp.maximum(
        jnp.minimum(jnp.minimum(qlen - d, tlen + d),
                    jnp.minimum(qlen, tlen)),
        0.0,
    )
    seglen = jnp.maximum(olap, 1.0)
    w = best_w.reshape(n_local, N).astype(jnp.float32)
    p_hat = blot_stats.estimate_match_probability(w, seglen, wordlen)
    area = (3.0 * bucket) * seglen
    s0, _ = blot_stats.h0_h1_scores(
        w, area, seglen, jnp.maximum(p_hat, 1e-3), wordlen, alphabet_len
    )
    plausible = olap >= 2.0 * wordlen
    return {
        "window": best_w.reshape(n_local, N),
        "diag": centers.astype(jnp.int32),
        "p": jnp.where(plausible, p_hat, 0.0),
        "s0": jnp.where(plausible, s0, 0.0),
        "olap_len": olap.astype(jnp.int32),
    }
