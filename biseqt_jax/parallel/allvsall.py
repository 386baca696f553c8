"""Sharded all-vs-all overlap discovery (the noisy-long-read config).

The reference ran Word-Blot overlap detection pair-by-pair from Python
(``biseqt/blot.py — WordBlotOverlap`` over every read pair); at N reads
that is N^2 SQLite joins.  The device pipeline:

  1. every read's k-mers are packed and per-read *sorted* once
     (``jnp.sort`` along the read axis — the per-read mini-index);
  2. reads shard across the mesh's ``data`` axis (shard_map);
  3. each device all-gathers the target shards' sorted tables and
     scores its query block against **all** reads: for each query k-mer a
     binary search finds its hit run in the target's sorted table, and a
     capped hit expansion scatter-adds into a per-pair *diagonal-bucket
     histogram* — the banded seed-count statistic, no seed list ever
     materialized;
  4. sliding-window sums over diagonal buckets + the H0/H1 normal scores
     give each pair's best overlap band, p̂ and significance — a dense
     [Nq, N] result matrix, psum-free and perfectly balanced.

Everything is static-shape jit; scaling with chips is linear in rows of
the N x N matrix.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.tables import kmer_keys, KEY_SENTINEL
from .mesh import DATA_AXIS, make_mesh

__all__ = ["all_vs_all_overlaps", "overlap_matrix_sharded"]


def _pair_diag_histogram(q_keys, t_sorted_keys, t_sorted_pos,
                         nbins: int, bucket: int, lt_off: int,
                         max_hits: int):
    """Diagonal-bucket seed histogram for one (query, target) pair.

    q_keys: [L] int32 (sentinel for invalid windows);
    t_sorted_keys/t_sorted_pos: [L] the target's sorted k-mer mini-index.
    Returns [nbins] int32: count of seeds whose diagonal d = i - j falls in
    each bucket of width ``bucket`` (diagonals shifted by ``lt_off``).
    """
    L = q_keys.shape[0]
    lo = jnp.searchsorted(t_sorted_keys, q_keys, side="left")
    hi = jnp.searchsorted(t_sorted_keys, q_keys, side="right")
    ii = jnp.arange(L, dtype=jnp.int32)
    counts = jnp.zeros((nbins,), jnp.int32)
    for h in range(max_hits):
        idx = lo + h
        valid = (idx < hi) & (q_keys != KEY_SENTINEL)
        j = t_sorted_pos[jnp.clip(idx, 0, L - 1)]
        d = ii - j + lt_off
        b = jnp.clip(d // bucket, 0, nbins - 1)
        counts = counts.at[b].add(valid.astype(jnp.int32))
    return counts


@functools.partial(
    jax.jit,
    static_argnames=("wordlen", "alphabet_len", "bucket", "max_hits",
                     "target_chunk"),
)
def overlap_stats_block(q_codes, q_lens, t_codes, t_lens, *,
                        wordlen: int, alphabet_len: int = 4,
                        bucket: int = 32, max_hits: int = 4,
                        target_chunk: int = 32):
    """Best-overlap statistics for every (query, target) pair of a block.

    Args:
        q_codes: int8 [Nq, L]; t_codes: int8 [Nt, L] (same padded L).

    Returns dict of [Nq, Nt] arrays: ``num_seeds`` (best band seed count),
    ``diag`` (best band center diagonal), ``p`` (match-prob estimate),
    ``s0`` (H0 rejection score), ``olap_len`` (expected overlap columns).
    """
    from ..ops import blot_stats

    Nq, L = q_codes.shape
    Nt = t_codes.shape[0]
    nbins = (2 * L) // bucket + 1

    qk = kmer_keys(q_codes, q_lens, wordlen, alphabet_len)
    tk = kmer_keys(t_codes, t_lens, wordlen, alphabet_len)
    t_sorted_keys, t_sorted_pos = jax.lax.sort(
        (tk, jnp.broadcast_to(
            jnp.arange(L, dtype=jnp.int32)[None, :], tk.shape
        )),
        dimension=1, num_keys=1,
    )

    hist_fn = functools.partial(
        _pair_diag_histogram, nbins=nbins, bucket=bucket, lt_off=L,
        max_hits=max_hits,
    )
    # queries x targets histograms.  The naive double-vmap would
    # materialize [Nq, Nt, L] searchsorted intermediates (gigabytes at
    # N ~ 1000); instead targets stream in chunks via lax.map so peak
    # temporaries stay [Nq, target_chunk, L].
    C = min(target_chunk, Nt)
    Ntp = ((Nt + C - 1) // C) * C
    pad_t = Ntp - Nt
    tsk = jnp.pad(t_sorted_keys, ((0, pad_t), (0, 0)),
                  constant_values=KEY_SENTINEL)
    tsp = jnp.pad(t_sorted_pos, ((0, pad_t), (0, 0)))
    tsk = tsk.reshape(Ntp // C, C, L)
    tsp = tsp.reshape(Ntp // C, C, L)

    def chunk_hists(chunk):
        csk, csp = chunk
        return jax.vmap(
            lambda qrow: jax.vmap(
                lambda k, p: hist_fn(qrow, k, p)
            )(csk, csp)
        )(qk)

    hists = jax.lax.map(chunk_hists, (tsk, tsp))        # [nc, Nq, C, nbins]
    hists = jnp.moveaxis(hists, 0, 1).reshape(Nq, Ntp, nbins)[:, :Nt]

    # 3-bucket sliding window over diagonals = band of width ~3*bucket
    padded = jnp.pad(hists, ((0, 0), (0, 0), (1, 1)))
    window = padded[:, :, :-2] + padded[:, :, 1:-1] + padded[:, :, 2:]

    # per-bucket expected overlap length (columns) from band center diagonal
    centers = (jnp.arange(nbins) * bucket + bucket // 2) - L  # true d
    ls = q_lens[:, None, None].astype(jnp.float32)
    lt = t_lens[None, :, None].astype(jnp.float32)
    d = centers[None, None, :].astype(jnp.float32)
    olap = jnp.maximum(
        jnp.minimum(jnp.minimum(ls - d, lt + d), jnp.minimum(ls, lt)), 0.0
    )
    seglen = jnp.maximum(olap, 1.0)

    w = window.astype(jnp.float32)
    p_hat = blot_stats.estimate_match_probability(w, seglen, wordlen)
    area = (3.0 * bucket) * seglen
    s0, _ = blot_stats.h0_h1_scores(
        w, area, seglen, jnp.maximum(p_hat, 1e-3), wordlen, alphabet_len
    )
    # rank bands by H0 significance: p̂·K structurally favors long sparse
    # bands (p̂ decays only as the 1/w-th root), stealing the argmax from
    # short true overlaps; -log p-value normalizes for band area
    ok = (olap >= 2.0 * wordlen) & (window >= 5)
    rank = jnp.where(ok, s0, -1.0)
    best = jnp.argmax(rank, axis=2)

    take = lambda arr: jnp.take_along_axis(
        arr, best[:, :, None], axis=2
    )[:, :, 0]
    return {
        "num_seeds": take(window),
        "diag": jnp.take(centers, best).astype(jnp.int32),
        "p": take(p_hat),
        "s0": take(s0),
        "olap_len": take(olap).astype(jnp.int32),
    }


def overlap_matrix_sharded(codes, lengths, *, wordlen: int = 8,
                           alphabet_len: int = 4, bucket: int = 32,
                           max_hits: int = 4, mesh=None):
    """All-vs-all overlap statistics, reads sharded over the mesh.

    Each device scores its query row-block against the full read set
    (target tables arrive via all-gather — the "index-shard
    all-gather" of the north star).  Returns dict of [N, N] host arrays.
    """
    if mesh is None:
        mesh = make_mesh()
    n_data = mesh.shape[DATA_AXIS]
    N, L = codes.shape
    Np = ((N + n_data - 1) // n_data) * n_data
    codes_p = np.full((Np, L), -1, np.int8)
    codes_p[:N] = np.asarray(codes, np.int8)
    lens_p = np.zeros((Np,), np.int32)
    lens_p[:N] = np.asarray(lengths, np.int32)

    stats_fn = functools.partial(
        overlap_stats_block, wordlen=wordlen, alphabet_len=alphabet_len,
        bucket=bucket, max_hits=max_hits,
    )

    def shard_fn(q_codes, q_lens):
        # q_*: this device's query shard; gather the full target set
        t_codes = jax.lax.all_gather(
            q_codes, DATA_AXIS, axis=0, tiled=True
        )
        t_lens = jax.lax.all_gather(
            q_lens, DATA_AXIS, axis=0, tiled=True
        )
        return stats_fn(q_codes, q_lens, t_codes, t_lens)

    from jax import shard_map

    spec_in = P(DATA_AXIS, None)
    spec_vec = P(DATA_AXIS)
    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(spec_in, spec_vec),
        out_specs={k: P(DATA_AXIS, None) for k in
                   ("num_seeds", "diag", "p", "s0", "olap_len")},
        check_vma=False,
    )
    out = jax.jit(fn)(jnp.asarray(codes_p), jnp.asarray(lens_p))
    return {k: np.asarray(v)[:N, :N] for k, v in out.items()}


def overlap_matrix_sorted_sharded(codes, lengths, *, wordlen: int = 8,
                                  alphabet_len: int = 4, bucket: int = 64,
                                  max_run: int = None, mesh=None):
    """Mesh-sharded sort-join all-vs-all: each device owns a row block.

    ``max_run=None`` sizes the partner cap to the expected (global,
    coverage-scaled) k-mer run length — see
    :func:`biseqt_jax.ops.allvsall_sorted.auto_max_run`.  (The
    per-pair blockwise engine's ``max_hits`` is different: it caps
    repeats WITHIN one target read, which does not grow with coverage.)

    Reads replicate via all-gather (they are small — the k-mer
    *table* is rebuilt per device, which is one cheap radix sort); the
    quadratic part — pair composites, the big sort, segment stats — is
    sharded by query rows, so throughput scales with chips.
    """
    from ..ops.allvsall_sorted import overlap_stats_sorted
    from jax import shard_map

    if mesh is None:
        mesh = make_mesh()
    n_data = mesh.shape[DATA_AXIS]
    N, L = np.asarray(codes).shape
    Np = ((N + n_data - 1) // n_data) * n_data
    codes_p = np.full((Np, L), -1, np.int8)
    codes_p[:N] = np.asarray(codes, np.int8)
    lens_p = np.zeros((Np,), np.int32)
    lens_p[:N] = np.asarray(lengths, np.int32)
    n_local = Np // n_data

    def shard_fn(q_codes, q_lens):
        codes_all = jax.lax.all_gather(
            q_codes, DATA_AXIS, axis=0, tiled=True
        )
        lens_all = jax.lax.all_gather(
            q_lens, DATA_AXIS, axis=0, tiled=True
        )
        me = jax.lax.axis_index(DATA_AXIS)
        return overlap_stats_sorted(
            codes_all, lens_all, wordlen=wordlen, n_reads=Np,
            alphabet_len=alphabet_len, bucket=bucket, max_run=max_run,
            n_local=n_local, q_lo=me * n_local,
        )

    keys = ("window", "diag", "p", "s0", "olap_len")
    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS)),
        out_specs={k: P(DATA_AXIS, None) for k in keys},
        check_vma=False,
    )
    out = jax.jit(fn)(jnp.asarray(codes_p), jnp.asarray(lens_p))
    return {k: np.asarray(v)[:N, :N] for k, v in out.items()}


def all_vs_all_overlaps(codes, lengths, *, wordlen: int = 8,
                        min_score: float = 25.0, min_p: float = 0.5,
                        min_olap_len: int = 0,
                        method: str = "auto", **kw):
    """Significant overlap pairs from the all-vs-all matrix.

    ``method``: 'sorted' (single-device sort-join engine — the fast
    path), 'blockwise' (mesh-sharded per-pair
    search), or 'auto' (sorted unless a mesh is passed — the chunked sort-join has no read-count ceiling).

    Returns a list of ``(q, t, diag, p, s0)`` with q < t, filtered by H0
    rejection and match-probability thresholds (mirrors what the reference
    pipeline extracted from per-pair WordBlotOverlap runs).
    """
    N, L = np.asarray(codes).shape
    if method == "auto":
        # the chunked sorted engine has no N ceiling; prefer it whenever
        # no mesh was requested
        method = "blockwise" if kw.get("mesh") is not None else "sorted"
    if method == "sorted":
        from ..ops.allvsall_sorted import overlap_stats_sorted_chunked

        stats = {
            k: np.asarray(v) for k, v in overlap_stats_sorted_chunked(
                jnp.asarray(np.asarray(codes, np.int8)),
                jnp.asarray(np.asarray(lengths, np.int32)),
                wordlen=wordlen, n_reads=int(N),
                alphabet_len=kw.get("alphabet_len", 4),
                bucket=kw.get("bucket", 32),
                # None = auto_max_run: the global-table join's run
                # length scales with COVERAGE, and a fixed small cap
                # collapses far-index pairs' counts (recall 0.26 repro
                # in experiments/overlap_recall.py)
                max_run=kw.get("max_hits", None),
            ).items()
        }
    else:
        stats = overlap_matrix_sharded(
            codes, lengths, wordlen=wordlen, **kw
        )
    # vectorized upper-triangle extraction (an N^2 Python loop is a
    # 1M-iteration host loop at N = 1000)
    N = stats["p"].shape[0]
    mask = (
        (np.asarray(stats["s0"]) >= min_score)
        & (np.asarray(stats["p"]) >= min_p)
        & (np.asarray(stats["olap_len"]) >= min_olap_len)
        & np.triu(np.ones((N, N), bool), k=1)
    )
    qq, tt = np.nonzero(mask)
    diag = np.asarray(stats["diag"])[qq, tt]
    pp = np.asarray(stats["p"])[qq, tt]
    s0 = np.asarray(stats["s0"])[qq, tt]
    return [
        (int(q), int(t), int(d), float(p), float(s))
        for q, t, d, p, s in zip(qq, tt, diag, pp, s0)
    ]
