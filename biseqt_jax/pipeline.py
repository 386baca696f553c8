"""End-to-end discover-then-extend pipeline (the framework's "model").

The full seed-and-extend flow the reference composes by hand
(``KmerIndex`` -> ``SeedIndex`` -> ``WordBlot.similar_segments`` ->
``pw.Aligner`` banded extension), packaged as one call with a batched
execution plan:

  1. Word-Blot discovers candidate similar segments (device seed join +
     band statistics; sparse assembly at genome scale).
  2. Every candidate band becomes one row of a *batched* banded-DP
     problem: the (d, a) rectangle is cut out of both sequences, the band
     geometry is normalized per pair, and a single launch of the engine
     :mod:`.ops.engine` selects for the platform extends all candidates.

This is the "flagship model" of the framework: discovery O(#seeds),
extension O(band x length), everything batched.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import jax
import jax.numpy as jnp

from .sequence import Sequence
from .blot import WordBlot, band_radius
from .ops.banded_dp import ModeFlags
from .ops.engine import banded_dp_auto

__all__ = ["discover_and_extend", "extend_segments", "segment_cut",
           "pipeline_bytes"]


def _bucket(n, mini=128):
    """Round up to a half-power-of-two grid (1M, 1.5M, 2M, 3M, ...).

    Coarse on purpose: every distinct bucketed shape is a separate XLA
    compile, while the wasted band cells cost a fraction of the launch —
    two variants per octave keeps a warm run from recompiling when a
    second genome's segments fall in adjacent finer buckets.
    """
    n = max(int(n), 1)
    if n <= mini:
        return mini
    step = max(mini, 1 << (max(n.bit_length(), 2) - 2))
    return ((n + step - 1) // step) * step


#: share of the device's memory limit that in-flight launches may hold
PIPELINE_FRACTION = 0.25
#: in-flight budget where the backend reports no memory limit (the CPU)
PIPELINE_BYTES_DEFAULT = 3 << 30


def pipeline_bytes(device=None) -> int:
    """In-flight device-memory budget of :func:`extend_segments`:
    ``PIPELINE_FRACTION`` of the device's ``bytes_limit``, or
    ``PIPELINE_BYTES_DEFAULT`` where the backend reports none."""
    if device is None:
        device = jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return PIPELINE_BYTES_DEFAULT
    return int(limit * PIPELINE_FRACTION)


def segment_cut(seg, ls: int, lt: int, pad_radius: int = 16,
                pad_a: int = 512):
    """The DP problem :func:`extend_segments` solves for one segment:
    ``(i_lo, i_hi, j_lo, j_hi, d_lo, d_hi)`` — the cutouts
    ``S[i_lo:i_hi]``, ``T[j_lo:j_hi]`` and the inclusive diagonal band
    relative to them."""
    (d_lo, d_hi), (a_lo, a_hi) = seg["segment"]
    # grow the rectangle: discovery quantizes to coarse cells and the
    # true alignment should be free to extend past the seed-dense core
    d_lo -= pad_radius
    d_hi += pad_radius
    a_lo -= pad_a
    a_hi += pad_a
    # rectangle corners in (i, j)
    i_lo = max((a_lo + d_lo) // 2, 0)
    i_hi = min((a_hi + d_hi + 1) // 2 + 1, ls)
    j_lo = max((a_lo - d_hi) // 2, 0)
    j_hi = min((a_hi - d_lo + 1) // 2 + 1, lt)
    i_hi = max(i_hi, i_lo + 1)
    j_hi = max(j_hi, j_lo + 1)
    # band relative to the cutouts: d' = d - (i_lo - j_lo)
    off = i_lo - j_lo
    return (i_lo, i_hi, j_lo, j_hi, d_lo - off, d_hi - off)


def extend_segments(S: Sequence, T: Sequence, segments: List[Dict], *,
                    subst=None, go_score=-3.0, ge_score=-1.0,
                    engine: str = None, pad_radius: int = 16,
                    pad_a: int = 512, with_transcripts: bool = False,
                    _dirs_budget: int = 512 << 20):
    """Batched banded extension of Word-Blot candidate segments.

    Each segment's (d, a) rectangle maps to subsequences
    ``S[i_lo:i_hi], T[j_lo:j_hi]`` and a diagonal band (relative to the
    cutouts); all segments align in batched banded-DP launches (local
    mode: the alignment starts/ends wherever the homology does).  Returns
    the segments with the banded-DP ``score`` attached.  ``engine``
    names the DP engine (``"lax"`` or ``"cuda"``); by default
    :func:`~biseqt_jax.ops.engine.select_engine` picks it per launch.

    With ``with_transcripts=True`` the launch also emits direction bytes,
    which are copied to the host and walked by the C++ tracer
    (``native.traceback_batch``); every segment gains ``transcript``
    (MSID string) + ``origin_start`` / ``mutate_start`` (coordinates in
    the FULL S/T).  NOTE: in transcript mode the output may
    hold MORE rows than ``segments``: a segment whose antidiagonal span
    exceeds the direction-plane budget is split into overlapping
    a-windows, each aligned independently.  Every output row carries
    ``source_index`` (its position in the input list) — join on that,
    not on row order.  Score-only mode is always 1:1.
    """
    if not segments:
        return []
    A = len(S.alphabet)
    if subst is None:
        subst = np.where(np.eye(A, dtype=bool), 1.0, -1.0).astype(np.float32)
    s_arr = S.to_array()
    t_arr = T.to_array()

    if with_transcripts:
        # transcripts are walked by the C++ tier — fail HERE with a
        # clear message instead of deep in _finish after device launches
        # are already in flight
        from . import native

        if not native.available():
            raise RuntimeError(
                "extend_segments(with_transcripts=True) walks direction "
                "bytes with the native C++ tier, which is unavailable "
                "(no prebuilt libpwnative.so and the build failed — is "
                "a C++ toolchain installed?); run score-only "
                "(with_transcripts=False) or build biseqt_jax/native")

        # transcript launches allocate a dirs plane of ~(a-range / 2) * W
        # bytes per pair-row on device.  Discovery merges consecutive
        # in-order blocks into multi-Mbp segments (a 4 Mbp segment at
        # W = 1536 is a 3.2 GB plane — OOMed the 5 Mbp genome run), so
        # oversized segments are split into overlapping a-windows sized
        # to a plane budget; each window is extended and aligned
        # independently and yields its own transcripted output row.
        DIRS_BUDGET = int(_dirs_budget)
        split = []
        src_idx = []
        for k, seg in enumerate(segments):
            (d_lo, d_hi), (a_lo, a_hi) = seg["segment"]
            # size the estimate with the SAME bucketing the launch uses
            # for W, so the budget is an actual upper bound on the plane
            # (the raw width underestimates by the bucket margin)
            W_est = _bucket(d_hi - d_lo + 1 + 2 * pad_radius, mini=128)
            max_a = max(2 * DIRS_BUDGET // W_est, 8 * pad_a)
            span = a_hi - a_lo + 1
            if span <= max_a:
                split.append(seg)
                src_idx.append(k)
                continue
            n_win = -(-span // max_a)
            step = -(-span // n_win)
            for w in range(n_win):
                lo = a_lo + w * step
                hi = min(lo + step + 2 * pad_a, a_hi)
                sub = dict(seg)
                sub["segment"] = ((d_lo, d_hi), (lo, hi))
                split.append(sub)
                src_idx.append(k)
        segments = split
    else:
        src_idx = list(range(len(segments)))

    cut = [segment_cut(seg, len(S), len(T), pad_radius, pad_a)
           for seg in segments]

    B = len(cut)
    # local mode: the optimal alignment starts/ends wherever the homology
    # does, independent of the (padded) rectangle rim
    flags = ModeFlags(local_start=True, local_end=True)

    # Group segments by bucketed cutout shape and launch per group:
    # genome-scale candidate lists mix ~megabase block homologies with
    # short spurious hits, so padding every segment to the global max is
    # O(max/typical) wasted memory and compute (a 5 Mbp run OOMed exactly
    # there), while per-shape launches still amortize compiles over 1-2
    # variants.  Within a group, batches are additionally capped so the
    # kernel's char streams stay ~< 1 GB per launch.
    groups: Dict[tuple, List[int]] = {}
    for idx, c in enumerate(cut):
        key = (_bucket(c[1] - c[0]), _bucket(c[3] - c[2]),
               _bucket(c[5] - c[4] + 1, mini=128))
        groups.setdefault(key, []).append(idx)

    from .profiling import Phase

    scores = np.zeros((B,), np.float32)
    ops = [""] * B
    si_all = np.zeros((B,), np.int32)
    sj_all = np.zeros((B,), np.int32)
    subst = np.asarray(subst, np.float32)
    STREAM_CHAR_BUDGET = 400_000_000   # per-launch char budget (~0.8 GB)

    # Launches are PIPELINED: DP work is dispatched for as many launch
    # groups as an in-flight device-memory budget allows before the
    # oldest launch's results are materialized — host-side D2H and the
    # C++ walk then overlap later groups' compute.  The budget counts
    # the dominant allocation (the direction plane per launch).
    budget = pipeline_bytes()
    pending = []
    inflight = [0]

    def _finish(rec):
        inflight[0] -= rec["bytes"]
        idxs, n = rec["idxs"], rec["n"]
        res = rec["res"]
        scores[idxs] = np.asarray(res.score)[:n]
        if not with_transcripts:
            return
        from . import native

        with Phase("pipeline.dirs_d2h", nbytes=int(res.dirs.nbytes)):
            dirs = np.asarray(res.dirs)
            end_i = np.asarray(res.end_i)[:n]
            end_j = np.asarray(res.end_j)[:n]
        with Phase("pipeline.walk"):
            g_ops, g_si, g_sj = native.traceback_batch(
                dirs[:n], rec["dmin"][:n] + (rec["W"] - 1),
                rec["s_codes"][:n], rec["t_codes"][:n],
                rec["s_lens"][:n], rec["t_lens"][:n], end_i, end_j, flags,
            )
        for b, idx in enumerate(idxs):
            ops[idx] = g_ops[b]
            si_all[idx] = g_si[b]
            sj_all[idx] = g_sj[b]

    def _launch(idxs, LS, LT, W):
        # bucket the batch dim too (pad with inert length-1 rows):
        # distinct n would otherwise be distinct jit shapes.  Transcript
        # launches bucket at mini=2: every padded pair-row allocates a
        # FULL direction plane (LS * W bytes — 640 MB per row for a
        # 625 kbp segment at W=1024)
        n = len(idxs)
        n_pad = _bucket(n, mini=2 if with_transcripts else 8)
        est = n_pad * (LS + LT)
        if with_transcripts:
            # the plane, plus the lax engine's transposed copy of it
            est += 2 * n_pad * LS * W
        # drain BEFORE dispatching: this launch's planes must fit
        # alongside whatever is still in flight (a genome-segment
        # launch can be most of the budget by itself)
        while pending and inflight[0] + est > budget:
            _finish(pending.pop(0))
        s_codes = np.zeros((n_pad, LS), np.int8)
        t_codes = np.zeros((n_pad, LT), np.int8)
        s_lens = np.ones((n_pad,), np.int32)
        t_lens = np.ones((n_pad,), np.int32)
        dmin = np.zeros((n_pad,), np.int32)
        w_eff = np.ones((n_pad,), np.int32)
        for b, idx in enumerate(idxs):
            i_lo, i_hi, j_lo, j_hi, dl, dh = cut[idx]
            s_lens[b] = i_hi - i_lo
            t_lens[b] = j_hi - j_lo
            s_codes[b, : s_lens[b]] = s_arr[i_lo:i_hi]
            t_codes[b, : t_lens[b]] = t_arr[j_lo:j_hi]
            # pad on the dmin side to the shared W (lane mask trims it)
            dmin[b] = dh - W + 1
            w_eff[b] = min(dh - dl + 1, W)
        res = banded_dp_auto(
            jnp.asarray(s_codes), jnp.asarray(t_codes),
            jnp.asarray(s_lens), jnp.asarray(t_lens),
            jnp.asarray(dmin), W=W, subst=subst,
            go=float(go_score), ge=float(ge_score), flags=flags,
            w_eff=jnp.asarray(w_eff), with_dirs=with_transcripts,
            engine=engine,
        )
        pending.append(dict(
            idxs=idxs, n=n, res=res, s_codes=s_codes, t_codes=t_codes,
            s_lens=s_lens, t_lens=t_lens, dmin=dmin, W=W, bytes=est,
        ))
        inflight[0] += est

    total_cells = sum(
        int(c[5] - c[4] + 1) * int(c[1] - c[0]) for c in cut
    )
    with Phase("pipeline.extend", cells=total_cells):
        for (LS, LT, W), idxs in sorted(groups.items()):
            per_pair = LS + LT + 2 * W
            if with_transcripts:
                # the dominant allocation is then the direction plane
                # (LS * W bytes per pair), not the char streams —
                # budget it or genome-scale transcript runs exhaust
                # device memory
                per_pair += LS * W
            cap = max(2, 2 * (STREAM_CHAR_BUDGET // max(per_pair, 1)))
            for k in range(0, len(idxs), cap):
                _launch(idxs[k:k + cap], LS, LT, W)
        while pending:
            _finish(pending.pop(0))

    out = []
    for b, seg in enumerate(segments):
        seg = dict(seg)
        seg["source_index"] = src_idx[b]
        seg["score"] = float(scores[b])
        seg["band_cells"] = int(
            (cut[b][5] - cut[b][4] + 1) * (cut[b][1] - cut[b][0])
        )
        if with_transcripts:
            seg["transcript"] = ops[b]
            seg["origin_start"] = int(cut[b][0] + si_all[b])
            seg["mutate_start"] = int(cut[b][2] + sj_all[b])
        out.append(seg)
    return out


def discover_and_extend(S: Sequence, T: Sequence, *, wordlen: int = 8,
                        K_min: int = 100, p_min: float = 0.6,
                        g_max: float = 0.2, subst=None,
                        go_score=-3.0, ge_score=-1.0,
                        engine: str = None,
                        with_transcripts: bool = False):
    """Word-Blot discovery + batched banded extension, one call.

    Returns the discovered segments with DP ``score`` attached (plus
    MSID ``transcript`` / start coordinates when ``with_transcripts``),
    sorted by score descending.
    """
    wb = WordBlot(S, T, wordlen=wordlen, g_max=g_max)
    segments = list(wb.similar_segments(K_min=K_min, p_min=p_min))
    extended = extend_segments(
        S, T, segments, subst=subst, go_score=go_score,
        ge_score=ge_score, engine=engine,
        with_transcripts=with_transcripts,
    )
    return sorted(extended, key=lambda s: -s["score"])
