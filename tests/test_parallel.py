"""Mesh-parallel tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from biseqt_jax.sequence import Alphabet, pack_sequences
from biseqt_jax.stochastics import rand_seq, MutationProcess
from biseqt_jax.parallel import make_mesh, all_vs_all_overlaps
from biseqt_jax.parallel.allvsall import overlap_matrix_sharded, overlap_stats_block
from biseqt_jax.parallel.sharded_dp import banded_dp_band_sharded
from biseqt_jax.ops.banded_dp import banded_dp, ModeFlags

A4 = Alphabet("ACGT")


def test_mesh_shapes():
    m = make_mesh()
    assert m.shape["data"] == 8 and m.shape["band"] == 1
    m2 = make_mesh(n_data=2, n_band=4)
    assert m2.shape["data"] == 2 and m2.shape["band"] == 4


def _reads_with_overlaps(rng, n_reads=8, glen=2000, rlen=600, err=0.1):
    """Reads tiled over a genome with ~50% overlap between neighbors."""
    M = MutationProcess(A4, subst_probs=err, go_prob=err / 3,
                        ge_prob=err, rng=rng)
    genome = rand_seq(A4, glen, rng=rng)
    reads, starts = [], []
    step = (glen - rlen) // (n_reads - 1)
    for k in range(n_reads):
        start = k * step
        r, _ = M.mutate(genome[start:start + rlen])
        reads.append(r)
        starts.append(start)
    return reads, starts


def test_overlap_stats_block_finds_true_overlaps(rng):
    reads, starts = _reads_with_overlaps(rng)
    codes, lens = pack_sequences(reads, pad_to=768)
    stats = overlap_stats_block(
        jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(codes), jnp.asarray(lens), wordlen=8,
    )
    s0 = np.asarray(stats["s0"])
    diag = np.asarray(stats["diag"])
    n = len(reads)
    for q in range(n - 1):
        t = q + 1  # neighbors overlap by ~rlen - step
        assert s0[q, t] > 25, (q, t, s0[q, t])
        true_d = starts[t] - starts[q]  # q's suffix matches t's prefix
        assert abs(diag[q, t] - true_d) <= 64, (q, t, diag[q, t], true_d)
    # far-apart reads don't overlap
    assert s0[0, n - 1] < 25


def test_overlap_matrix_sharded_matches_block(rng):
    reads, _ = _reads_with_overlaps(rng)
    codes, lens = pack_sequences(reads, pad_to=768)
    mesh = make_mesh()
    sharded = overlap_matrix_sharded(
        codes, lens, wordlen=8, mesh=mesh
    )
    local = overlap_stats_block(
        jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(codes), jnp.asarray(lens), wordlen=8,
    )
    np.testing.assert_allclose(
        sharded["s0"], np.asarray(local["s0"]), rtol=1e-5, atol=1e-4
    )
    np.testing.assert_array_equal(
        sharded["diag"], np.asarray(local["diag"])
    )


def test_all_vs_all_overlaps_pairs(rng):
    reads, starts = _reads_with_overlaps(rng)
    codes, lens = pack_sequences(reads, pad_to=768)
    pairs = all_vs_all_overlaps(codes, lens, wordlen=8, min_p=0.4)
    got = set((q, t) for q, t, *_ in pairs)
    # all adjacent pairs must be found
    for q in range(len(reads) - 1):
        assert (q, q + 1) in got
    # distant pairs must not
    assert (0, len(reads) - 1) not in got


def test_band_sharded_dp_matches_unsharded(rng):
    B = 2
    M = MutationProcess(A4, subst_probs=0.15, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    ss, ts = [], []
    for _ in range(B):
        S = rand_seq(A4, 120, rng=rng)
        T, _ = M.mutate(S)
        ss.append(S), ts.append(T)
    s_codes, s_lens = pack_sequences(ss, pad_to=128)
    t_codes, t_lens = pack_sequences(ts, pad_to=160)
    W = 256
    dmin = jnp.asarray([-128, -120], jnp.int32)
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    mesh = make_mesh(n_data=2, n_band=4)
    for flags in (ModeFlags(),
                  ModeFlags(local_start=True, local_end=True),
                  ModeFlags(free_start_edges=True, free_end_edges=True)):
        ref = banded_dp(
            jnp.asarray(s_codes), jnp.asarray(t_codes),
            jnp.asarray(s_lens), jnp.asarray(t_lens), dmin,
            W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags,
        )
        with mesh:
            got = banded_dp_band_sharded(
                jnp.asarray(s_codes), jnp.asarray(t_codes),
                jnp.asarray(s_lens), jnp.asarray(t_lens), dmin,
                W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags,
                mesh=mesh,
            )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref.score), atol=1e-3,
            err_msg=str(flags),
        )


def test_band_sharded_dp_edge_lanes_valid(rng):
    """Parity case whose global band edges fall INSIDE the valid cell
    region (W < sequence length) with an all-mismatch pair, so edge cells
    carry very negative values: catches the ppermute zero-fill halo bug
    (phantom H=0 predecessors at the outermost band shards) that the
    W=256 / 120-length test above cannot see."""
    B, L, W = 2, 96, 64
    s_codes = np.zeros((B, L), np.int8)          # all 'A'
    t_codes = np.full((B, L), 1, np.int8)        # all 'C' -> all-mismatch
    t_codes[1, :48] = 0                          # second pair: half match
    lens = jnp.asarray(np.full((B,), L, np.int32))
    dmin = jnp.asarray([-32, -32], jnp.int32)    # dmax=31 << L: edges live
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    mesh = make_mesh(n_data=2, n_band=4)
    for flags in (ModeFlags(),
                  ModeFlags(local_start=True, local_end=True),
                  ModeFlags(free_start_edges=True, free_end_edges=True)):
        ref = banded_dp(
            jnp.asarray(s_codes), jnp.asarray(t_codes), lens, lens, dmin,
            W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags,
        )
        with mesh:
            got = banded_dp_band_sharded(
                jnp.asarray(s_codes), jnp.asarray(t_codes), lens, lens,
                dmin, W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags,
                mesh=mesh,
            )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref.score), atol=1e-3,
            err_msg=str(flags),
        )


def test_checkpointed_sweep_resumes(tmp_path, rng):
    from biseqt_jax.parallel.sweep import checkpointed_overlap_sweep
    from biseqt_jax.parallel.allvsall import overlap_stats_block
    import jax.numpy as jnp
    import os

    reads, _ = _reads_with_overlaps(rng, n_reads=6, glen=1200, rlen=400)
    codes, lens = pack_sequences(reads, pad_to=512)
    out_dir = str(tmp_path / "sweep")
    full = checkpointed_overlap_sweep(
        codes, lens, out_dir, wordlen=6, block=2
    )
    # blocks persisted
    blocks = [f for f in os.listdir(out_dir) if f.startswith("block_")]
    assert len(blocks) == 3
    # simulate a partial sweep: delete one block, rerun -> identical result
    os.remove(os.path.join(out_dir, sorted(blocks)[1]))
    again = checkpointed_overlap_sweep(
        codes, lens, out_dir, wordlen=6, block=2
    )
    np.testing.assert_array_equal(full["s0"], again["s0"])
    # matches the direct one-shot computation
    direct = overlap_stats_block(
        jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(codes), jnp.asarray(lens), wordlen=6,
    )
    np.testing.assert_allclose(full["s0"], np.asarray(direct["s0"]),
                               rtol=1e-5, atol=1e-4)


def test_kmer_index_db_events(tmp_path, rng):
    import io
    from biseqt_jax.database import DB
    from biseqt_jax.kmers import KmerIndex
    from biseqt_jax.sequence import Alphabet

    db = DB(":memory:", A4)
    idx = KmerIndex(wordlen=4, alphabet=A4).attach_to(db)
    db.load_fasta(io.StringIO(">a\nACGTACGTAC\n>b\nTTACGTTT\n"))
    idx.refresh()
    assert idx.num_seqs == 2
    assert idx.num_kmers == 7 + 5


def test_sorted_allvsall_matches_blockwise(rng):
    """Sort-join all-vs-all agrees with the per-pair search formulation."""
    from biseqt_jax.ops.allvsall_sorted import overlap_stats_sorted

    reads, starts = _reads_with_overlaps(rng, n_reads=8, glen=2000,
                                         rlen=600)
    codes, lens = pack_sequences(reads, pad_to=768)
    sorted_stats = overlap_stats_sorted(
        jnp.asarray(codes), jnp.asarray(lens), wordlen=8,
        n_reads=len(reads), bucket=32, max_run=8,
    )
    s0 = np.asarray(sorted_stats["s0"])
    diag = np.asarray(sorted_stats["diag"])
    n = len(reads)
    # same qualitative structure as the blockwise test: neighbors overlap
    for q in range(n - 1):
        t = q + 1
        assert s0[q, t] > 25, (q, t, s0[q, t])
        true_d = starts[t] - starts[q]
        assert abs(diag[q, t] - true_d) <= 64, (q, t, diag[q, t], true_d)
    assert s0[0, n - 1] < 25
    # symmetric pairs: the reverse direction sees the mirrored diagonal
    for q in range(n - 1):
        assert abs(diag[q + 1, q] + diag[q, q + 1]) <= 2 * 32


def test_sorted_sharded_matches_single_device(rng):
    from biseqt_jax.parallel.allvsall import overlap_matrix_sorted_sharded
    from biseqt_jax.ops.allvsall_sorted import overlap_stats_sorted

    reads, _ = _reads_with_overlaps(rng, n_reads=8, glen=2000, rlen=600)
    codes, lens = pack_sequences(reads, pad_to=768)
    sharded = overlap_matrix_sorted_sharded(
        codes, lens, wordlen=8, bucket=32, mesh=make_mesh()
    )
    single = overlap_stats_sorted(
        jnp.asarray(codes), jnp.asarray(lens), wordlen=8,
        n_reads=len(reads), bucket=32,
    )
    np.testing.assert_allclose(
        sharded["s0"], np.asarray(single["s0"]), rtol=1e-5, atol=1e-4
    )
    np.testing.assert_array_equal(
        sharded["diag"], np.asarray(single["diag"])
    )


def test_band_sharded_ad_matches_unsharded(rng):
    """The antidiagonal band-sharded engine (halo exchange every C steps,
    no per-row all_gather) matches the unsharded row engine across modes,
    ragged lengths, mixed dmin, and small halo (many exchanges)."""
    from biseqt_jax.parallel.sharded_dp_ad import banded_dp_band_sharded_ad

    B = 2
    M = MutationProcess(A4, subst_probs=0.15, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    ss, ts = [], []
    for _ in range(B):
        S = rand_seq(A4, 120, rng=rng)
        T, _ = M.mutate(S)
        ss.append(S), ts.append(T)
    s_codes, s_lens = pack_sequences(ss, pad_to=128)
    t_codes, t_lens = pack_sequences(ts, pad_to=160)
    W = 256
    dmin = jnp.asarray([-128, -121], jnp.int32)   # mixed dmin parity
    w_eff = jnp.asarray([W - 1, 200], jnp.int32)
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    mesh = make_mesh(n_data=2, n_band=4)
    for flags in (ModeFlags(),
                  ModeFlags(local_start=True, local_end=True),
                  ModeFlags(free_start_edges=True, free_end_edges=True)):
        ref = banded_dp(
            jnp.asarray(s_codes), jnp.asarray(t_codes),
            jnp.asarray(s_lens), jnp.asarray(t_lens), dmin,
            W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags, w_eff=w_eff,
        )
        with mesh:
            got = banded_dp_band_sharded_ad(
                jnp.asarray(s_codes), jnp.asarray(t_codes),
                jnp.asarray(s_lens), jnp.asarray(t_lens), dmin,
                W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags,
                mesh=mesh, w_eff=w_eff, halo=16,
            )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref.score), atol=1e-3,
            err_msg=str(flags),
        )


def test_band_sharded_ad_edge_lanes_valid(rng):
    """Band edges inside the valid cell region + an all-mismatch pair
    (the halo-bug detector geometry): shard boundaries and mesh-edge
    halos must not leak phantom predecessors."""
    from biseqt_jax.parallel.sharded_dp_ad import banded_dp_band_sharded_ad

    B, L, W = 2, 96, 64
    s_codes = np.zeros((B, L), np.int8)          # all 'A'
    t_codes = np.full((B, L), 1, np.int8)        # all 'C' -> all-mismatch
    t_codes[1, :48] = 0                          # second pair: half match
    lens = jnp.asarray(np.full((B,), L, np.int32))
    dmin = jnp.asarray([-32, -32], jnp.int32)
    w_eff = jnp.asarray([W - 1, W - 1], jnp.int32)
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    mesh = make_mesh(n_data=2, n_band=4)
    for flags in (ModeFlags(),
                  ModeFlags(local_start=True, local_end=True),
                  ModeFlags(free_start_edges=True, free_end_edges=True)):
        ref = banded_dp(
            jnp.asarray(s_codes), jnp.asarray(t_codes), lens, lens, dmin,
            W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags, w_eff=w_eff,
        )
        with mesh:
            got = banded_dp_band_sharded_ad(
                jnp.asarray(s_codes), jnp.asarray(t_codes), lens, lens,
                dmin, W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags,
                mesh=mesh, w_eff=w_eff, halo=8,
            )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref.score), atol=1e-3,
            err_msg=str(flags),
        )


def test_sorted_allvsall_chunked_matches_unchunked(rng):
    """The chunked wrapper (the past-the-int32-composite-key-ceiling
    path) reproduces the single-launch engine exactly, including the
    shifted last window."""
    from biseqt_jax.ops.allvsall_sorted import (
        overlap_stats_sorted, overlap_stats_sorted_chunked,
    )

    reads, _ = _reads_with_overlaps(rng, n_reads=11, glen=2400, rlen=500)
    codes, lens = pack_sequences(reads, pad_to=640)
    kw = dict(wordlen=8, n_reads=len(reads), bucket=32, max_run=8)
    ref = {
        k: np.asarray(v) for k, v in overlap_stats_sorted(
            jnp.asarray(codes), jnp.asarray(lens), **kw
        ).items()
    }
    # max_chunk=4 forces 3 windows over 11 query rows, the last shifted
    got = overlap_stats_sorted_chunked(
        jnp.asarray(codes), jnp.asarray(lens), max_chunk=4, **kw
    )
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=k)


def test_sorted_allvsall_auto_max_run_coverage_regime(rng):
    """A fixed partner cap far below the k-mer run length collapses
    seed counts for far-apart read indices (entries are (key, read,
    pos)-sorted): at 100 kbp / 30x coverage config-4 recall measured
    0.26.  The auto cap must recover the window counts a small cap
    loses."""
    from biseqt_jax.ops.allvsall_sorted import (
        overlap_stats_sorted, auto_max_run,
    )

    glen, rlen, n = 2048, 256, 24
    genome = rng.integers(0, 4, glen, dtype=np.int8)
    reads = np.zeros((n, 256), np.int8)
    # wordlen 4 -> 256 keys, mean run length ~ n*rlen/256 = 24: the
    # coverage regime where a cap of 4 samples a sliver of each run
    for k in range(n):
        s = (k * 83) % (glen - rlen)
        reads[k] = genome[s:s + rlen]
    lens = np.full((n,), rlen, np.int32)
    assert auto_max_run(n, 256, 4) >= 24
    kw = dict(wordlen=4, n_reads=n, bucket=32)
    full = overlap_stats_sorted(jnp.asarray(reads), jnp.asarray(lens),
                                **kw)
    capped = overlap_stats_sorted(jnp.asarray(reads), jnp.asarray(lens),
                                  max_run=4, **kw)
    # reads 0 and 22 overlap by rlen - 34 exact columns (22 * 83 wraps
    # to genome offset 34) but have FAR-APART indices: their entries in
    # every shared k-mer's (key, read, pos)-sorted run are separated by
    # all the intervening covering reads' entries, so a cap of 4 almost
    # never reaches across — the regime that collapsed config-4 recall
    w_full = int(np.asarray(full["window"])[0, 22])
    w_capped = int(np.asarray(capped["window"])[0, 22])
    assert w_full >= (rlen - 34) // 2, (w_full, w_capped)
    assert w_full >= 2 * max(w_capped, 1), (w_full, w_capped)


def test_band_sharded_row0_ends(rng):
    """Degenerate geometry across the sharded row engine: free-end
    optimum on row 0 and an empty-origin global pair must match the
    (row-0-aware) unsharded engine."""
    B, L, W = 2, 8, 64
    s_codes = np.full((B, L), 2, np.int8)
    t_codes = np.zeros((B, L), np.int8)
    s_lens = jnp.asarray([2, 0], jnp.int32)
    t_lens = jnp.asarray([1, 1], jnp.int32)
    dmin = jnp.asarray([-32, -32], jnp.int32)
    w_eff = jnp.asarray([W - 1, W - 1], jnp.int32)
    subst = np.full((4, 4), -100.0, np.float32)
    mesh = make_mesh(n_data=2, n_band=4)
    for flags in (ModeFlags(free_end_edges=True), ModeFlags()):
        ref = banded_dp(
            jnp.asarray(s_codes), jnp.asarray(t_codes), s_lens, t_lens,
            dmin, W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags,
            w_eff=w_eff,
        )
        with mesh:
            got = banded_dp_band_sharded(
                jnp.asarray(s_codes), jnp.asarray(t_codes), s_lens,
                t_lens, dmin, W=W, subst=subst, go=-2.0, ge=-1.0,
                flags=flags, mesh=mesh, w_eff=w_eff,
            )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref.score), atol=1e-3,
            err_msg=str(flags),
        )


def test_band_sharded_ad_skewed_lengths(rng):
    """Sharded AD engine at skewed lengths / large positive dmin (the
    char-stream ring wrap repro) and with the full-W default w_eff."""
    from biseqt_jax.parallel.sharded_dp_ad import banded_dp_band_sharded_ad

    S = rng.integers(0, 4, 600).astype(np.int8)
    T = np.pad(S[481:581], (0, 28), constant_values=0)[None, :]
    S = S[None, :]
    sl = jnp.asarray([600], jnp.int32)
    tl = jnp.asarray([100], jnp.int32)
    dmin = jnp.asarray([480], jnp.int32)
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    mesh = make_mesh(n_data=2, n_band=4)
    flags = ModeFlags(local_start=True, local_end=True)
    kw = dict(W=128, subst=subst, go=-2.0, ge=-1.0, flags=flags)
    ref = banded_dp(jnp.asarray(S), jnp.asarray(T), sl, tl, dmin,
                    w_eff=jnp.asarray([127], jnp.int32), **kw)
    with mesh:
        got = banded_dp_band_sharded_ad(
            jnp.asarray(S), jnp.asarray(T), sl, tl, dmin, mesh=mesh,
            w_eff=jnp.asarray([127], jnp.int32), halo=16, **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref.score),
                               atol=1e-3)
    assert float(np.asarray(ref.score)[0]) > 90

    # dual-pair contract (matches the single-chip kernel): w_eff is
    # clamped to W - 1, so the global corner must sit ABOVE the bottom
    # diagonal; with dmin = -1 the main diagonal is in-band and the
    # identity pair aligns perfectly
    L2 = 64
    eq = np.zeros((1, L2), np.int8)
    lens2 = jnp.asarray([L2], jnp.int32)
    dmin0 = jnp.asarray([-1], jnp.int32)
    ref2 = banded_dp(jnp.asarray(eq), jnp.asarray(eq), lens2, lens2,
                     dmin0, W=128, subst=subst, go=-2.0, ge=-1.0,
                     flags=ModeFlags(),
                     w_eff=jnp.asarray([127], jnp.int32))
    with mesh:
        got2 = banded_dp_band_sharded_ad(
            jnp.asarray(eq), jnp.asarray(eq), lens2, lens2, dmin0,
            W=128, subst=subst, go=-2.0, ge=-1.0, flags=ModeFlags(),
            mesh=mesh, halo=16)
    assert float(np.asarray(got2)[0]) == pytest.approx(
        float(np.asarray(ref2.score)[0])) == pytest.approx(64.0)


def test_band_sharded_ad_dual_pair_batch(rng):
    """Doubled-pairs coverage for the dual-pair sharded engine: an ODD
    batch (exercises the inert pad pair), mixed dmin parities, ragged
    lengths — every pair's score must match the unsharded engine, across
    modes.  (Round-3 packing: pairs (2b2, 2b2+1) share one lane plane.)"""
    from biseqt_jax.parallel.sharded_dp_ad import banded_dp_band_sharded_ad

    B = 5
    M = MutationProcess(A4, subst_probs=0.15, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    ss, ts = [], []
    for _ in range(B):
        S = rand_seq(A4, 150, rng=rng)
        T, _ = M.mutate(S)
        ss.append(S), ts.append(T)
    s_codes, s_lens = pack_sequences(ss, pad_to=160)
    t_codes, t_lens = pack_sequences(ts, pad_to=192)
    W = 128
    dmin = jnp.asarray([-64, -63, -30, -80, -64], jnp.int32)
    w_eff = jnp.asarray([100, 127, 64, 120, 127], jnp.int32)
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    mesh = make_mesh(n_data=2, n_band=4)
    for flags in (ModeFlags(),
                  ModeFlags(local_start=True, local_end=True),
                  ModeFlags(free_start_edges=True, free_end_edges=True)):
        ref = banded_dp(
            jnp.asarray(s_codes), jnp.asarray(t_codes),
            jnp.asarray(s_lens), jnp.asarray(t_lens), dmin,
            W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags, w_eff=w_eff,
        )
        with mesh:
            got = banded_dp_band_sharded_ad(
                jnp.asarray(s_codes), jnp.asarray(t_codes),
                jnp.asarray(s_lens), jnp.asarray(t_lens), dmin,
                W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags,
                mesh=mesh, w_eff=w_eff, halo=16,
            )
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref.score), atol=1e-3,
            err_msg=str(flags),
        )


def test_sorted_allvsall_large_nbins_no_overflow(rng):
    """Near-duplicate long reads with a small diagonal bucket push the
    (rank, dbin) encoding past int32 without the rank cap (historical
    repro: garbage diag/p for identical reads at nbins >= 512)."""
    from biseqt_jax.ops.allvsall_sorted import overlap_stats_sorted

    L = 4096
    reads = np.tile(rng.integers(0, 4, L, dtype=np.int8), (4, 1))
    lens = jnp.asarray(np.full((4,), L, np.int32))
    st = overlap_stats_sorted(
        jnp.asarray(reads), lens, wordlen=10, n_reads=4, bucket=8,
        max_run=4,
    )
    diag = np.asarray(st["diag"])
    p = np.asarray(st["p"])
    for q in range(4):
        for t in range(4):
            if q == t:
                continue
            assert abs(int(diag[q, t])) <= 16, (q, t, diag[q, t])
            assert p[q, t] > 0.8, (q, t, p[q, t])


def test_band_sharded_ad_traceback_rescores(rng):
    """Checkpointed re-solve traceback through the band-sharded AD
    engine: forward pass checkpoints every ckpt_chunks halo chunks,
    windows re-solve newest-first, the native window walker resumes
    across window boundaries.  Small halo + tiny windows maximize the
    number of cross-window resumes; transcripts must rescore to exactly
    the unsharded engine's score across modes."""
    from oracle import rescore as _rescore
    from biseqt_jax.parallel.sharded_dp_ad import band_sharded_ad_traceback

    B = 3                                # odd batch: inert pad pair
    M = MutationProcess(A4, subst_probs=0.15, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    ss, ts = [], []
    for _ in range(B):
        S = rand_seq(A4, 120, rng=rng)
        T, _ = M.mutate(S)
        ss.append(S), ts.append(T)
    s_codes, s_lens = pack_sequences(ss, pad_to=128)
    t_codes, t_lens = pack_sequences(ts, pad_to=160)
    W = 256
    dmin = jnp.asarray([-128, -121, -60], jnp.int32)  # mixed parity
    w_eff = jnp.asarray([W - 1, 200, 100], jnp.int32)
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    go, ge = -2.0, -1.0
    mesh = make_mesh(n_data=2, n_band=4)
    for flags in (ModeFlags(),
                  ModeFlags(local_start=True, local_end=True),
                  ModeFlags(free_start_edges=True, free_end_edges=True)):
        ref = banded_dp(
            jnp.asarray(s_codes), jnp.asarray(t_codes),
            jnp.asarray(s_lens), jnp.asarray(t_lens), dmin,
            W=W, subst=subst, go=go, ge=ge, flags=flags, w_eff=w_eff,
        )
        with mesh:
            scores, tx = band_sharded_ad_traceback(
                jnp.asarray(s_codes), jnp.asarray(t_codes),
                jnp.asarray(s_lens), jnp.asarray(t_lens), dmin,
                W=W, subst=subst, go=go, ge=ge, flags=flags,
                mesh=mesh, w_eff=w_eff, halo=16, ckpt_chunks=2,
            )
        np.testing.assert_allclose(
            scores, np.asarray(ref.score), atol=1e-3, err_msg=str(flags)
        )
        anchored_start = not (flags.local_start or flags.free_start_edges)
        anchored_end = not (flags.local_end or flags.free_end_edges)
        for b in range(B):
            if scores[b] < -1e29:
                assert tx[b][0] == ""
                continue
            ops, si, sj = tx[b]
            assert set(ops) <= set("MSID"), (b, ops[:40])
            got, ei, ej = _rescore(
                ops, s_codes[b], t_codes[b], si, sj, subst, go, ge
            )
            assert got == pytest.approx(float(scores[b]), abs=1e-2), (
                b, flags)
            if anchored_start:
                assert (si, sj) == (0, 0)
            if anchored_end:
                assert (ei, ej) == (int(s_lens[b]), int(t_lens[b])), (
                    b, flags)


def test_band_sharded_ad_traceback_skewed(rng):
    """Sharded traceback at skewed lengths / large positive dmin (the
    char-stream ring-wrap repro geometry) — the window re-solver shares
    the forward's streams, so a wrap bug would corrupt re-solved dirs
    even with a correct forward score."""
    from oracle import rescore as _rescore
    from biseqt_jax.parallel.sharded_dp_ad import band_sharded_ad_traceback

    S = rng.integers(0, 4, 600).astype(np.int8)
    T = np.pad(S[481:581], (0, 28), constant_values=0)[None, :]
    S = S[None, :]
    sl = jnp.asarray([600], jnp.int32)
    tl = jnp.asarray([100], jnp.int32)
    dmin = jnp.asarray([480], jnp.int32)
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    go, ge = -2.0, -1.0
    mesh = make_mesh(n_data=2, n_band=4)
    flags = ModeFlags(local_start=True, local_end=True)
    with mesh:
        scores, tx = band_sharded_ad_traceback(
            jnp.asarray(S), jnp.asarray(T), sl, tl, dmin, W=128,
            subst=subst, go=go, ge=ge, flags=flags, mesh=mesh,
            w_eff=jnp.asarray([127], jnp.int32), halo=16, ckpt_chunks=2,
        )
    assert float(scores[0]) > 90
    ops, si, sj = tx[0]
    got, _, _ = _rescore(ops, S[0], T[0], si, sj, subst, go, ge)
    assert got == pytest.approx(float(scores[0]), abs=1e-2)
    assert ops.count("M") >= 90           # the planted 100-mer
