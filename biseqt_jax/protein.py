"""Two-tier protein search: reduced-alphabet filter, full-matrix rescore.

The reference's C engine (``pwlib — alnscores``) serves ANY substitution
matrix at full scalar speed.  Reduced alphabets (Murphy et al. 2000) are
the standard search strategy for cutting the cost of a large candidate
set before full-matrix scoring:

  1. FILTER: score every candidate pair under a reduced alphabet
     (Dayhoff-6 / Murphy-10) — fast, slightly noisy scores.
  2. RESCORE: pairs whose filter score clears a threshold are re-aligned
     with the full matrix (exact scores, transcripts on request).

With filter rate F, full rate G and survivor fraction rho the effective
throughput is 1 / (1/F + rho/G); at typical search selectivity
(rho << 1) this approaches F, which is what the two-tier path buys over
running everything at G.  Thresholds come from a null calibration on
shuffled pairs (:func:`null_threshold`).

Sequence-level compression for the seeding/discovery layer is
:func:`reduce_seq` — the result is an ordinary :class:`~biseqt_jax.
sequence.Sequence` over the reduced alphabet, so ``KmerIndex`` /
``SeedIndex`` / ``WordBlot`` run on it unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from .matrices import (BLOSUM62, DAYHOFF6_GROUPS, compression_map,
                       protein_alphabet, reduced_alphabet, reduced_matrix)
from .ops.banded_dp import DPResult, ModeFlags
from .ops.engine import ENGINES, select_engine
from .sequence import Sequence

__all__ = ["TwoTierResult", "two_tier_scores", "null_threshold",
           "reduce_seq", "compress_codes"]


def compress_codes(codes, cmap):
    """Map full protein letter codes to group codes, passing negative
    PAD sentinels through.  Works on numpy and jax arrays."""
    xp = jnp if isinstance(codes, jnp.ndarray) else np
    cm = xp.asarray(cmap)
    safe = xp.where(codes < 0, 0, codes)
    return xp.where(codes < 0, codes, cm[safe]).astype(codes.dtype)


def reduce_seq(seq: Sequence, groups=DAYHOFF6_GROUPS) -> Sequence:
    """Compress a protein Sequence to the reduced alphabet so the k-mer
    / seed / Word-Blot discovery layers can run on denser group codes."""
    if seq.alphabet.letters != protein_alphabet().letters:
        raise ValueError(
            "reduce_seq expects a sequence over the 20-letter protein "
            "alphabet in matrix row order (matrices.protein_alphabet)")
    cmap = compression_map(groups)
    arr = compress_codes(seq.to_array(), cmap)
    return Sequence(reduced_alphabet(groups), arr)


def null_threshold(null_scores, margin: float = 5.0) -> float:
    """Filter threshold from a null calibration: the max reduced-tier
    score over non-homologous (e.g. shuffled) pairs plus a safety
    margin in score units."""
    return float(np.max(np.asarray(null_scores))) + float(margin)


class TwoTierResult(NamedTuple):
    reduced_scores: np.ndarray    # [B] float32, filter-tier scores
    survivors: np.ndarray         # [B] bool, reduced >= threshold
    survivor_idx: np.ndarray      # [S] int32 indices into the batch
    full: Optional[DPResult]      # DP result over the compacted
    #                               survivor batch (scores exact under
    #                               the full matrix; row k is pair
    #                               survivor_idx[k]), None if S == 0
    full_scores: np.ndarray       # [B] float32; -inf for filtered pairs
    survivor_pad: np.ndarray      # [Sp] int32 original-batch index of
    #                               every row of `full` (rows >= S are
    #                               bucket filler) — with
    #                               with_dirs=True this is what maps
    #                               `full.dirs` rows back to pairs for
    #                               the traceback walkers


def _bucket_up(n: int, mini: int) -> int:
    # doubling buckets: every distinct jit shape is a compile, and
    # survivor counts jitter run to run — fine half-pow2 steps would
    # straddle a boundary and recompile mid-stream
    b = mini
    while b < n:
        b *= 2
    return b


def two_tier_scores(ss, ts, s_lens, t_lens, dmin, *, W: int, go, ge,
                    flags: ModeFlags, w_eff, subst=None,
                    groups=DAYHOFF6_GROUPS, threshold: float,
                    engine: str = None, block_b: int = 128,
                    with_dirs: bool = False,
                    engine_opts: Optional[dict] = None) -> TwoTierResult:
    """Score a batch of banded protein alignments via the two-tier
    strategy.  Args mirror the DP engines (`ops/banded_dp.banded_dp`):
    int8 code arrays over :func:`~biseqt_jax.matrices.protein_alphabet`,
    per-pair lengths and band placement.  ``threshold`` is in
    reduced-tier score units (calibrate with :func:`null_threshold`).

    ``engine`` names the DP engine of both tiers (``"lax"`` or
    ``"cuda"``); by default :func:`~biseqt_jax.ops.engine.select_engine`
    picks it per tier.  The survivor batch is compacted and padded to a
    doubling size bucket of at least ``2 * block_b`` rows so repeated
    calls reuse compiled variants.

    ``engine_opts`` is forwarded to the DP engine (extra keyword
    arguments the engine itself validates); it may not override
    arguments this function derives (``W``, ``subst``, ``with_dirs``,
    ...).
    """
    engine_opts = dict(engine_opts or {})
    _reserved = {"s_codes", "t_codes", "s_lens", "t_lens", "dmin", "W",
                 "subst", "A", "go", "ge", "flags", "w_eff", "with_dirs"}
    bad = _reserved & set(engine_opts)
    if bad:
        raise ValueError(
            "engine_opts may not override arguments two_tier_scores "
            f"sets itself: {sorted(bad)} — pass them as named arguments")
    if subst is None:
        subst = BLOSUM62
    cmap = compression_map(groups)
    red = reduced_matrix(subst, groups)
    ss = np.asarray(ss, np.int8)
    ts = np.asarray(ts, np.int8)
    B = ss.shape[0]
    s_lens = np.asarray(s_lens, np.int32)
    t_lens = np.asarray(t_lens, np.int32)
    dmin = np.asarray(dmin, np.int32)
    w_eff = np.asarray(w_eff, np.int32)

    ssr = compress_codes(ss, cmap)
    tsr = compress_codes(ts, cmap)

    def run(a, b, sl, tl, dm, we, mat, dirs):
        name = engine or select_engine(mat, go, ge, W, a.shape[1],
                                       b.shape[1])
        return ENGINES[name](
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(sl),
            jnp.asarray(tl), jnp.asarray(dm), W=W, subst=mat, go=go,
            ge=ge, flags=flags, w_eff=jnp.asarray(we), with_dirs=dirs,
            **engine_opts)

    fres = run(ssr, tsr, s_lens, t_lens, dmin, w_eff, red, False)
    reduced_scores = np.asarray(fres.score, np.float32)
    survivors = reduced_scores >= float(threshold)
    idx = np.flatnonzero(survivors).astype(np.int32)

    full_scores = np.full((B,), -np.inf, np.float32)
    if idx.size == 0:
        return TwoTierResult(reduced_scores, survivors, idx, None,
                             full_scores,
                             np.zeros((0,), np.int32))

    # compact survivors, pad to a bucket (repeat row 0 as filler — its
    # results are discarded)
    Sp = _bucket_up(idx.size, mini=min(2 * block_b, max(B, 1)))
    pad = np.concatenate(
        [idx, np.full((Sp - idx.size,), idx[0], np.int32)])
    sres = run(ss[pad], ts[pad], s_lens[pad], t_lens[pad], dmin[pad],
               w_eff[pad], subst, with_dirs)
    sub_scores = np.asarray(sres.score, np.float32)[:idx.size]
    full_scores[idx] = sub_scores
    return TwoTierResult(reduced_scores, survivors, idx, sres,
                         full_scores, pad)
