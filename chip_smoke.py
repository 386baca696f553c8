"""Smoke run of the system's main path on one NVIDIA GPU.

Phases, in one process on one card, each checked against the repo's own
references (the lax engine ``banded_dp``, the C++ engine ``native``):

  a. the device: a GPU, never the CPU; the card's name and power limit;
  b. score-only banded DP, 4096 pairs x 10 kbp, band 100, through
     ``extend_segments`` on the selected engine and on ``banded_dp``;
  c. transcripts for 2048 homologous 10 kbp pairs through
     ``extend_segments(with_transcripts=True)``;
  d. BLOSUM62, 16384 x 2048 residues, two-tier and single-pass;
  e. genome homology, 2 x 5 Mbp rearranged genomes with transcripts,
     through ``discover_and_extend``, cold and warm.

``--four`` runs only the four-card phase (the ``parallel/`` engines on a
4x1 data mesh and a 1x4 band mesh against one card).  The last line of
standard output is one JSON object; a failing phase raises, so the
script exits non-zero without it.

Usage: python chip_smoke.py [--four]      (one process; it takes the card)
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GO, GE = -2.0, -1.0
DNA = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)


def log(*parts):
    print(*parts, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, *a, **k):
    t0 = time.perf_counter()
    out = fn(*a, **k)
    return out, time.perf_counter() - t0


def homologs(rng, n, L, sub=0.1, indel=0.0):
    """n pairs (origin, mutate) of length ~L: substitutions, and indels
    at ``indel`` per position (half insertions, half deletions)."""
    s = rng.integers(0, 4, (n, L), dtype=np.int8)
    pairs = []
    for row in s:
        t = row.copy()
        flip = rng.random(L) < sub
        t[flip] = (t[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
        if indel:
            keep = rng.random(L) >= indel / 2
            ins = rng.random(L) < indel / 2
            reps = keep.astype(np.int64) + ins
            t = np.repeat(t, reps)
            extra = np.cumsum(reps) - 1
            t[extra[ins & keep]] = rng.integers(0, 4, int((ins & keep).sum()))
        pairs.append((row, t.astype(np.int8)))
    return pairs


def concat_segments(pairs, radius=34):
    """Two long sequences holding the pairs end to end, and one Word-Blot
    style segment per pair: its diagonal band and antidiagonal span."""
    from biseqt_jax.sequence import Alphabet, Sequence

    A4 = Alphabet("ACGT")
    segs, oi, oj = [], 0, 0
    for s, t in pairs:
        d = oi - oj
        segs.append({"segment": ((d - radius, d + radius),
                                 (oi + oj + 512, oi + oj + len(s)
                                  + len(t) - 512))})
        oi += len(s)
        oj += len(t)
    S = Sequence(A4, np.concatenate([p[0] for p in pairs]))
    T = Sequence(A4, np.concatenate([p[1] for p in pairs]))
    return S, T, segs


def rescore(ops, s, t, si, sj, subst, go, ge):
    """Score of an MSID transcript (vectorized; the oracle of a walk)."""
    o = np.frombuffer(ops.encode(), np.uint8)
    if o.size == 0:
        return 0.0
    diag = (o == ord("M")) | (o == ord("S"))
    di = diag | (o == ord("D"))
    dj = diag | (o == ord("I"))
    i = si + np.cumsum(di) - di
    j = sj + np.cumsum(dj) - dj
    score = subst[s[i[diag]], t[j[diag]]].sum()
    gap = ~diag
    opens = gap & np.concatenate([[True], o[1:] != o[:-1]])
    return float(score + ge * gap.sum() + go * opens.sum())


def native_alignment(S, T, seg, subst, go, ge, flags, with_tx):
    """The C++ engine on the exact DP problem extend_segments solves."""
    from biseqt_jax import native
    from biseqt_jax.pipeline import segment_cut

    i_lo, i_hi, j_lo, j_hi, dl, dh = segment_cut(seg, len(S), len(T))
    s = S.to_array()[i_lo:i_hi]
    t = T.to_array()[j_lo:j_hi]
    score, ei, ej, dirs = native.align(s, t, subst, go, ge, dl, dh, flags,
                                       with_dirs=with_tx)
    if not with_tx:
        return score, None
    ops, si, sj = native.traceback(dirs, dh, s, t, ei, ej, flags)
    return score, (ops, i_lo + si, j_lo + sj)


def phase_device(want):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU; JAX found %r"
                         % devs[0].platform)
    if len(devs) < want:
        raise SystemExit("need %d GPUs, JAX found %d" % (want, len(devs)))
    log("device", devs[0].device_kind, "count", len(devs))
    log("card", card_line())
    return devs


def phase_score(rng, B=4096, L=10_000):
    import jax.numpy as jnp
    from biseqt_jax import native
    from biseqt_jax.ops.banded_dp import ModeFlags, banded_dp
    from biseqt_jax.ops.engine import banded_dp_auto, select_engine
    from biseqt_jax.pipeline import extend_segments

    BW, W = 100, 128
    flags = ModeFlags(local_start=True, local_end=True)
    engine = select_engine(DNA, GO, GE, W, L, L)
    log("b: engine", engine)
    # the engines on one padded batch: scores and end cells, exactly
    pairs = homologs(rng, B, L)
    s = np.stack([p[0] for p in pairs])
    t = np.stack([p[1] for p in pairs])
    lens = np.full((B,), L, np.int32)
    dmin = np.full((B,), BW // 2 - W + 1, np.int32)
    args = [jnp.asarray(x) for x in (s, t, lens, lens, dmin)]
    kw = dict(W=W, subst=DNA, go=GO, ge=GE, flags=flags,
              w_eff=jnp.full((B,), BW, jnp.int32))
    got = banded_dp_auto(*args, **kw)
    ref = banded_dp(*args, **kw)
    for name in ("score", "end_i", "end_j"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(ref, name))
        assert np.array_equal(a, b), "b: %s differs on %d pairs" % (
            name, int((a != b).sum()))
    for b in range(min(16, B)):
        sc, ei, ej, _ = native.align(s[b], t[b], DNA, GO, GE,
                                     BW // 2 - BW + 1, BW // 2, flags)
        assert (sc, ei, ej) == (float(got.score[b]), int(got.end_i[b]),
                                int(got.end_j[b])), ("b: native", b)
    # end to end through extend_segments, both engines
    S, T, segs = concat_segments(pairs)
    times = {}
    for name in (engine, "lax"):
        extend_segments(S, T, segs, engine=name)      # compile
        out, times[name] = timed(extend_segments, S, T, segs, engine=name)
        scores = np.asarray([o["score"] for o in out])
        if name == engine:
            first, cells = scores, sum(o["band_cells"] for o in out)
    assert np.array_equal(first, scores), "b: extend_segments differs"
    for name, sec in times.items():
        log("b: extend_segments %s %.4f s %.2f GCUPS (%d pairs, %d cells)"
            % (name, sec, cells / sec / 1e9, B, cells))
    return times


def phase_transcripts(rng, B=2048, L=10_000):
    from biseqt_jax import profiling
    from biseqt_jax.ops.banded_dp import ModeFlags
    from biseqt_jax.ops.engine import select_engine
    from biseqt_jax.pipeline import extend_segments

    flags = ModeFlags(local_start=True, local_end=True)
    engine = select_engine(DNA, -3.0, GE, 128, L, L)
    S, T, segs = concat_segments(homologs(rng, B, L, sub=0.08,
                                          indel=0.02))
    extend_segments(S, T, segs, with_transcripts=True)   # compile
    profiling.report(reset=True)
    out, sec = timed(extend_segments, S, T, segs, with_transcripts=True)
    c = profiling.counters()
    d2h, walk = c["pipeline.dirs_d2h"], c["pipeline.walk"]
    log("c: extend_segments transcripts %s %.4f s; plane %d bytes, "
        "D2H %.4f s, walk %.4f s" % (engine, sec, d2h["bytes"],
                                     d2h["seconds"], walk["seconds"]))
    extend_segments(S, T, segs, with_transcripts=True, engine="lax")
    _, sec_lax = timed(extend_segments, S, T, segs, with_transcripts=True,
                       engine="lax")
    log("c: extend_segments transcripts lax %.4f s" % sec_lax)
    s_arr, t_arr = S.to_array(), T.to_array()
    for o in out:
        got = rescore(o["transcript"], s_arr, t_arr, o["origin_start"],
                      o["mutate_start"], DNA, -3.0, GE)
        assert got == o["score"], ("c: rescore", got, o["score"])
        assert o["transcript"].count("M") > L // 2, "c: short transcript"
    for k in rng.choice(len(out), min(16, len(out)), replace=False):
        o = out[k]
        score, tx = native_alignment(S, T, segs[o["source_index"]], DNA,
                                     -3.0, GE, flags, True)
        assert score == o["score"], ("c: native score", k)
        assert tx == (o["transcript"], o["origin_start"],
                      o["mutate_start"]), ("c: native transcript", k)
    return {"engine": sec, "lax": sec_lax, "plane_bytes": d2h["bytes"],
            "d2h": d2h["seconds"], "walk": walk["seconds"]}


def phase_protein(rng, B=16384, L=2048):
    import jax.numpy as jnp
    from biseqt_jax.matrices import (BLOSUM62, DAYHOFF6_GROUPS,
                                     compression_map, reduced_matrix)
    from biseqt_jax.ops.banded_dp import ModeFlags, banded_dp
    from biseqt_jax.ops.engine import banded_dp_auto
    from biseqt_jax.protein import (compress_codes, null_threshold,
                                    two_tier_scores)

    BW, W = 100, 128
    flags = ModeFlags(local_start=True, local_end=True)
    go, ge = -11.0, -1.0
    ss = rng.integers(0, 20, (B, L), dtype=np.int8)
    ts = rng.integers(0, 20, (B, L), dtype=np.int8)
    hom = np.arange(B) < B // 8
    keep = rng.random((B, L)) >= 0.3
    ts[hom] = np.where(keep[hom], ss[hom], ts[hom])
    lens = np.full((B,), L, np.int32)
    dmin = np.full((B,), BW // 2 - W + 1, np.int32)
    w_eff = np.full((B,), BW, np.int32)
    kw = dict(W=W, go=go, ge=ge, flags=flags)
    dev = [jnp.asarray(x) for x in (ss, ts, lens, lens, dmin)]
    # null calibration: shuffled targets through the reduced tier
    cmap = compression_map(DAYHOFF6_GROUPS)
    perm = rng.permuted(ts[~hom][:1024], axis=1)
    n0 = perm.shape[0]
    null = banded_dp_auto(
        jnp.asarray(compress_codes(ss[~hom][:n0], cmap)),
        jnp.asarray(compress_codes(perm, cmap)), jnp.asarray(lens[:n0]),
        jnp.asarray(lens[:n0]), jnp.asarray(dmin[:n0]),
        subst=reduced_matrix(BLOSUM62), w_eff=jnp.asarray(w_eff[:n0]),
        **kw)
    thr = null_threshold(np.asarray(null.score), margin=5.0)
    two_tier_scores(ss[:256], ts[:256], lens[:256], lens[:256],
                    dmin[:256], w_eff=w_eff[:256], threshold=thr, **kw)
    tt, sec_tt = timed(two_tier_scores, ss, ts, lens, lens, dmin,
                       w_eff=w_eff, threshold=thr, **kw)
    single = banded_dp_auto(*dev, subst=BLOSUM62,
                            w_eff=jnp.asarray(w_eff), **kw)
    single.score.block_until_ready()
    single, sec_single = timed(
        lambda: banded_dp_auto(*dev, subst=BLOSUM62,
                               w_eff=jnp.asarray(w_eff), **kw).score
        .block_until_ready())
    ref = banded_dp(*dev, subst=BLOSUM62, w_eff=jnp.asarray(w_eff), **kw)
    ref_score = np.asarray(ref.score)
    _, sec_lax = timed(lambda: banded_dp(
        *dev, subst=BLOSUM62, w_eff=jnp.asarray(w_eff), **kw)
        .score.block_until_ready())
    assert np.array_equal(np.asarray(single), ref_score), "d: single-pass"
    idx = tt.survivor_idx
    assert tt.survivors[hom].all(), "d: a planted homolog was filtered"
    assert np.array_equal(tt.full_scores[idx], ref_score[idx]), \
        "d: survivor scores"
    log("d: BLOSUM62 %d x %d: two-tier %.4f s (%d survivors), single-pass "
        "%.4f s, banded_dp %.4f s" % (B, L, sec_tt, idx.size, sec_single,
                                      sec_lax))
    return {"two_tier": sec_tt, "single": sec_single, "lax": sec_lax}


def phase_genome(size=5_000_000):
    sys.path.insert(0, os.path.join(HERE, "experiments"))
    from genome_homology import rearranged_pair
    from biseqt_jax import profiling
    from biseqt_jax.pipeline import discover_and_extend

    n_blocks = 8
    out = {}
    for label, seed in (("cold", 1), ("warm", 2)):
        rng = np.random.default_rng(seed)
        A, Bs, truth = rearranged_pair(rng, size, n_blocks=n_blocks)
        profiling.report(reset=True)
        ext, sec = timed(discover_and_extend, A, Bs, wordlen=12,
                         K_min=size // n_blocks // 8, p_min=0.6,
                         g_max=0.1, with_transcripts=True)
        found = sum(any(
            s["segment"][0][0] - 64 <= a - b <= s["segment"][0][1] + 64
            and s["segment"][1][0] < a + b + 2 * n
            and s["segment"][1][1] > a + b for s in ext)
            for a, b, n in truth)
        recall = found / len(truth)
        a_arr, b_arr = A.to_array(), Bs.to_array()
        for s in ext:
            assert rescore(s["transcript"], a_arr, b_arr,
                           s["origin_start"], s["mutate_start"], DNA,
                           -3.0, GE) == s["score"], "e: rescore"
        c = profiling.counters()
        t = {k: c[p]["seconds"] for k, p in (
            ("index", "seeds.build"), ("discover", "blot.discover"),
            ("extend", "pipeline.extend"))}
        log("e: genome %s: recall %.3f, %d segments, index %.3f s, "
            "discover %.3f s, extend %.3f s, total %.3f s"
            % (label, recall, len(ext), t["index"], t["discover"],
               t["extend"], sec))
        assert recall == 1.0, "e: block recall %.3f" % recall
        out[label] = t
    return out


def phase_four(rng, N=1024, L=3000, Lp=1_000_000, W=1024, halo=128):
    import jax
    import jax.numpy as jnp
    from biseqt_jax import native
    from biseqt_jax.ops.allvsall_sorted import overlap_stats_sorted
    from biseqt_jax.ops.banded_dp import ModeFlags
    from biseqt_jax.ops.engine import banded_dp_auto
    from biseqt_jax.parallel import make_mesh
    from biseqt_jax.parallel.allvsall import overlap_matrix_sorted_sharded
    from biseqt_jax.parallel.sharded_dp_ad import (
        band_sharded_ad_traceback, banded_dp_band_sharded_ad)

    devs = jax.devices()[:4]
    # data axis: the sort-join all-vs-all, sharded by query rows
    mesh = make_mesh(n_data=4, n_band=1, devices=devs)
    assert len(set(mesh.devices.ravel().tolist())) == 4, "f: mesh"
    genome = rng.integers(0, 4, 200 * N, dtype=np.int8)
    starts = rng.integers(0, genome.size - L, N)
    codes = np.stack([genome[a:a + L] for a in starts])
    noise = rng.random(codes.shape) < 0.05
    codes[noise] = rng.integers(0, 4, int(noise.sum()))
    lens = np.full((N,), L, np.int32)
    t0 = time.perf_counter()
    sharded = overlap_matrix_sorted_sharded(codes, lens, wordlen=12,
                                            bucket=64, mesh=mesh)
    sec_sh = time.perf_counter() - t0
    with jax.default_device(devs[0]):
        t0 = time.perf_counter()
        single = overlap_stats_sorted(jnp.asarray(codes), jnp.asarray(lens),
                                      wordlen=12, n_reads=N, bucket=64)
        single = {k: np.asarray(v) for k, v in single.items()}
        sec_one = time.perf_counter() - t0
    np.testing.assert_allclose(sharded["s0"], single["s0"], rtol=1e-5,
                               atol=1e-4, err_msg="f: all-vs-all s0")
    assert np.array_equal(sharded["diag"], single["diag"]), "f: diag"
    log("f: sort-join all-vs-all %d x %d bp: 4 cards %.3f s, 1 card %.3f s"
        % (N, L, sec_sh, sec_one))
    # band axis: two 1 Mbp pairs, W = 1024, against one card and C++
    B = 2
    pairs = homologs(rng, B, Lp, sub=0.05, indel=0.002)
    LT = max(len(p[1]) for p in pairs)
    s = np.stack([p[0] for p in pairs])
    t = np.stack([np.pad(p[1], (0, LT - len(p[1]))) for p in pairs])
    sl = np.full((B,), Lp, np.int32)
    tl = np.asarray([len(p[1]) for p in pairs], np.int32)
    dmin = np.full((B,), -(W // 2), np.int32)
    w_eff = np.full((B,), W - 1, np.int32)
    flags = ModeFlags(local_start=True, local_end=True)
    kw = dict(W=W, subst=DNA, go=GO, ge=GE, flags=flags)
    band = make_mesh(n_data=1, n_band=4, devices=devs)
    assert len(set(band.devices.ravel().tolist())) == 4, "f: band mesh"
    args = [jnp.asarray(x) for x in (s, t, sl, tl, dmin)]
    with jax.default_device(devs[0]):
        one = banded_dp_auto(*args, w_eff=jnp.asarray(w_eff), **kw)
        one_score = np.asarray(one.score)
    t0 = time.perf_counter()
    with band:
        sc = banded_dp_band_sharded_ad(*args, w_eff=jnp.asarray(w_eff),
                                       mesh=band, halo=halo, **kw)
        sc = np.asarray(sc)
    sec_sc = time.perf_counter() - t0
    assert np.array_equal(sc, one_score), ("f: band-sharded", sc, one_score)
    t0 = time.perf_counter()
    with band:
        sc_tx, tx = band_sharded_ad_traceback(
            *args, w_eff=jnp.asarray(w_eff), mesh=band, halo=halo,
            ckpt_chunks=64, **kw)
    sec_tx = time.perf_counter() - t0
    assert np.array_equal(np.asarray(sc_tx), one_score), "f: traceback"
    for b in range(B):
        hi = int(dmin[b]) + W - 1
        score, ei, ej, dirs = native.align(
            s[b], t[b, :tl[b]], DNA, GO, GE, hi - int(w_eff[b]) + 1, hi,
            flags, with_dirs=True)
        assert score == one_score[b], ("f: native score", b)
        want = native.traceback(dirs, hi, s[b], t[b, :tl[b]], ei, ej,
                                flags)
        del dirs
        assert tuple(tx[b]) == want, ("f: transcript", b)
    log("f: band-sharded 2 x %d bp, W %d on 4 cards: score %.3f s, "
        "traceback %.3f s" % (Lp, W, sec_sc, sec_tx))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    opts = ap.parse_args()
    from biseqt_jax.utils import enable_compile_cache

    enable_compile_cache()
    devs = phase_device(4 if opts.four else 1)
    rng = np.random.default_rng(20261016)
    if opts.four:
        phase_four(rng)
    else:
        phase_score(rng)
        phase_transcripts(rng)
        phase_protein(rng)
        phase_genome()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
