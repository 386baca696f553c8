"""Affine-gap DP engine: row-wavefront recurrence shared by all backends.

Vectorized replacement for the reference's C DP engine
(``biseqt/pwlib — dptable_init/solve/traceback`` with modes
``STD_MODE``/``BANDED_MODE`` and the GLOBAL/LOCAL/OVERLAP family).

Design (not a port — a reformulation for vector hardware):

  * State is a per-row vector over **diagonals** (banded mode) or columns
    (full mode).  In banded mode lane ``k`` is the diagonal
    ``d = dmax - k``; at row ``i`` it holds cell ``(i, j = i - dmax + k)``.
    With this layout the three DP predecessors become pure vector ops:
      - diagonal (i-1, j-1): **same lane**, previous row
      - up       (i-1, j  ): lane ``k+1``, previous row (shift)
      - left     (i,   j-1): lane ``k-1``, **same row** — a scan (below)
  * The within-row affine-gap chain ``E[k] = max(H[k-1]+go+ge, E[k-1]+ge)``
    is an associative max-plus scan.  We solve it in closed form:
    ``E[k] = ge*k + cummax_m( H_pre[m-1] + go + ge*(1-m) )`` — one
    ``jax.lax.cummax`` per row instead of a sequential inner loop.  (Valid
    for ``go <= 0``, asserted.)
  * Per-pair band placement is normalized *before* the scan: the mutate
    sequence is re-indexed into the band frame (``T2[y] = T[y - dmax]``) so
    every pair in a batch reads its row window at the same offset — one
    dynamic slice per row for the whole batch, no per-pair gathers in the
    hot loop.
  * Alignment modes are four static booleans (free start/end on the edges,
    local start/end) — init values + running-max trackers, one kernel for
    the whole GLOBAL/LOCAL/OVERLAP/anchored family, mirroring pwlib's
    ``alnprob`` mode union.

Traceback: per-cell direction bytes (2 bits H-source, 1 bit E-extend, 1 bit
F-extend) are emitted row-by-row; the walk itself is a sequential O(L)
pointer chase done on the host (numpy here, C++ in ``native``), while the
O(L·W) fill is the part worth an accelerator.  The CUDA kernel
(:mod:`.cuda_dp`) keeps this contract and byte layout.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

NEG = -1e30  # finite -inf (python float: safe to close over in kernels)

__all__ = [
    "ModeFlags", "DPResult", "banded_dp", "full_dp", "traceback_path",
    "full_dp_traceback", "NEG",
]


class ModeFlags(NamedTuple):
    """Static alignment-mode switches (the alntype family as predicates)."""
    free_start_edges: bool = False  # start anywhere on row 0 / column 0
    local_start: bool = False       # start anywhere (Smith-Waterman origin)
    free_end_edges: bool = False    # end anywhere on last row / last column
    local_end: bool = False         # end anywhere (max over all cells)


class DPResult(NamedTuple):
    score: jnp.ndarray      # [B] best score per pair under the mode
    end_i: jnp.ndarray      # [B] row of the optimum (i index, 0..LS)
    end_j: jnp.ndarray      # [B] col of the optimum (j index, 0..LT)
    dirs: jnp.ndarray       # [B, LS, W] uint8 or () if with_dirs=False


# ---------------------------------------------------------------------------
# shared row update (pure jnp on [B, W] blocks — used by the banded and
# full-matrix scans and the checkpointed re-solve, so there is exactly one
# implementation of the recurrence to test)
# ---------------------------------------------------------------------------

def shift_lanes(x, by: int, fill):
    """Shift along the lane (last) axis; vacated lanes get ``fill``.

    ``by > 0`` moves values toward higher lanes (lane k reads k - by).
    Implemented as roll+mask.
    """
    if by == 0:
        return x
    W = x.shape[-1]
    lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    r = jnp.roll(x, by, axis=-1)
    mask = (lane >= by) if by > 0 else (lane < W + by)
    return jnp.where(mask, r, fill)


def prefix_max(x):
    """Inclusive prefix max along lanes via log-shifts."""
    W = x.shape[-1]
    s = 1
    while s < W:
        x = jnp.maximum(x, shift_lanes(x, s, NEG))
        s *= 2
    return x


def _shift_from_above(x, up_shift: int):
    """Value of lane k's 'up' predecessor from the previous row vector."""
    return shift_lanes(x, -up_shift, NEG) if up_shift else x


def _shift_diag(x, diag_shift: int):
    return shift_lanes(x, diag_shift, NEG) if diag_shift else x


def _row_update(H_prev, F_prev, sub_score, cell_valid, j_idx,
                go, ge, *, up_shift: int, diag_shift: int,
                local_start: bool, free_start_col: bool,
                want_dirs: bool):
    """One DP row.  All arrays [B, W]; returns (H, F, dirs_u8|None).

    ``sub_score``: substitution score of each cell's (origin, mutate) letter
    pair (garbage allowed where the diag predecessor is invalid — the
    predecessor's NEG swamps it).
    ``cell_valid``: mask of cells (i, j) with 0 <= j <= LT and row valid.
    """
    B, W = H_prev.shape
    karange = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1).astype(
        jnp.float32
    )

    diag_cand = _shift_diag(H_prev, diag_shift) + sub_score
    F_open = _shift_from_above(H_prev, up_shift) + (go + ge)
    F_ext = _shift_from_above(F_prev, up_shift) + ge
    F_new = jnp.maximum(F_open, F_ext)

    H_pre = jnp.maximum(diag_cand, F_new)
    if local_start:
        H_pre = jnp.maximum(H_pre, 0.0)
    if free_start_col:
        H_pre = jnp.where(j_idx == 0, jnp.maximum(H_pre, 0.0), H_pre)
    H_pre = jnp.where(cell_valid, H_pre, NEG)

    # E scan: E[k] = ge*k + cummax_m(A[m]), A[m] = H_pre[m-1] + go + ge*(1-m)
    A = shift_lanes(H_pre, 1, NEG) + (go + ge) - ge * karange
    P = prefix_max(A)
    E = P + ge * karange
    E = jnp.where(cell_valid, E, NEG)

    H = jnp.maximum(H_pre, E)
    H = jnp.where(cell_valid, H, NEG)

    dirs = None
    if want_dirs:
        # H source: 1=diag, 2=left(E), 3=up(F); 0=stop (fresh local start)
        d = jnp.where(H == diag_cand, 1, jnp.where(H == E, 2, 3)).astype(
            jnp.uint8
        )
        if local_start:
            d = jnp.where((H == 0.0) & (diag_cand < 0.0), jnp.uint8(0), d)
        if free_start_col:
            d = jnp.where(
                (j_idx == 0) & (H == 0.0) & (F_new < 0.0), jnp.uint8(0), d
            )
        e_ext = (P == shift_lanes(P, 1, NEG)).astype(jnp.uint8)
        f_ext = (F_new == F_ext).astype(jnp.uint8)
        dirs = d | (e_ext << 2) | (f_ext << 3)
        dirs = jnp.where(cell_valid, dirs, jnp.uint8(0))
    return H, F_new, dirs


def _subst_lookup(subst, s_codes, t_codes):
    """Per-cell substitution score via small-table select (no gather).

    subst: [A, A]; s_codes: [B, 1] int32; t_codes: [B, W] int32 (clipped).
    """
    A = subst.shape[0]
    s = jnp.clip(s_codes, 0, A - 1)
    t = jnp.clip(t_codes, 0, A - 1)
    # row select: [B, 1, A] -> pick by s -> then select by t
    out = jnp.zeros(t.shape, dtype=jnp.float32)
    for a in range(A):
        row = jnp.zeros(t.shape, dtype=jnp.float32)
        for b in range(A):
            row = jnp.where(t == b, jnp.float32(subst[a, b]), row)
        out = jnp.where(s == a, row, out)
    return out


def _init_row(j_idx, lt, go, ge, flags: ModeFlags):
    """H at conceptual row i=0 (alignment of empty origin prefix vs T[:j])."""
    valid = (j_idx >= 0) & (j_idx <= lt)
    jf = j_idx.astype(jnp.float32)
    gap = jnp.where(j_idx > 0, go + ge * jf, 0.0)
    if flags.local_start or flags.free_start_edges:
        h0 = jnp.zeros_like(jf)
    else:
        h0 = gap
    return jnp.where(valid, h0, NEG)


# ---------------------------------------------------------------------------
# banded scan (lax backend)
# ---------------------------------------------------------------------------

def _check_gap_scores(go, ge):
    """The closed-form affine E scan assumes extending a gap never
    loses to closing-and-reopening it, which requires go <= 0 and
    ge <= 0 — with a positive score the engines would be silently
    wrong, so the precondition is enforced where the values are still
    concrete (skipped when tracing under an outer jit)."""
    try:
        ok = float(go) <= 0 and float(ge) <= 0
    except TypeError:
        return
    if not ok:
        raise ValueError(
            "affine gap scores must satisfy go <= 0 and ge <= 0 "
            "(got go=%r, ge=%r)" % (go, ge)
        )


def banded_dp(s_codes, t_codes, s_lens, t_lens, dmin, *, W: int,
              subst, go, ge, flags: ModeFlags, with_dirs: bool = False,
              w_eff=None):
    _check_gap_scores(go, ge)
    return _banded_dp_jit(
        s_codes, t_codes, s_lens, t_lens, dmin, W=W, subst=subst, go=go,
        ge=ge, flags=flags, with_dirs=with_dirs, w_eff=w_eff,
    )


@partial(jax.jit, static_argnames=("W", "flags", "with_dirs"))
def _banded_dp_jit(s_codes, t_codes, s_lens, t_lens, dmin, *, W: int,
                   subst, go, ge, flags: ModeFlags,
                   with_dirs: bool = False, w_eff=None):
    """Batched banded affine-gap DP (lax.scan backend).

    Args:
        s_codes: int8/int32 [B, LS] origin rows (PAD tail ok).
        t_codes: int8/int32 [B, LT] mutate rows.
        s_lens, t_lens: int32 [B].
        dmin: int32 [B] per-pair band lower diagonal (d = i - j);
            band covers d in [dmin, dmin + W - 1].
        W: static band width.
        subst: [A, A] float substitution scores.
        go, ge: gap open/extend scores (go <= 0 required).
        flags: ModeFlags.
        with_dirs: also return per-cell direction bytes for traceback.

    Returns DPResult.  Cells are (i, j), i=1..LS rows scanned sequentially.
    """
    B, LS = s_codes.shape
    LT = t_codes.shape[1]
    s_codes = s_codes.astype(jnp.int32)
    t_codes = t_codes.astype(jnp.int32)
    dmin = dmin.astype(jnp.int32)
    dmax = dmin + (W - 1)
    # effective band width per pair: lanes k >= w_eff are outside the band
    # (lane k is diagonal d = dmax - k, so masking high k trims the dmin
    # side — used to bucket W to hardware-friendly sizes without changing
    # band semantics)
    if w_eff is None:
        w_eff = jnp.full((B,), W, jnp.int32)
    else:
        w_eff = w_eff.astype(jnp.int32)
    subst = jnp.asarray(subst, dtype=jnp.float32)
    go = jnp.float32(go)
    ge = jnp.float32(ge)

    # band frame: T2[b, y] = T[b, y - dmax_b], y in [0, LS + W)
    Y = LS + W
    yy = jnp.arange(Y, dtype=jnp.int32)[None, :]
    src = yy - dmax[:, None]
    t2 = jnp.where(
        (src >= 0) & (src < t_lens[:, None]),
        jnp.take_along_axis(
            t_codes, jnp.clip(src, 0, LT - 1), axis=1
        ),
        -1,
    )

    karange = jnp.arange(W, dtype=jnp.int32)[None, :]
    j0 = karange - dmax[:, None]          # j at row 0
    H0 = _init_row(j0, t_lens[:, None], go, ge, flags)
    H0 = jnp.where(karange < w_eff[:, None], H0, NEG)
    F0 = jnp.full((B, W), NEG)

    def step(carry, i):
        H_prev, F_prev, best, bi, bk, corner = carry
        row_valid = (i <= s_lens)[:, None]
        j_idx = karange + (i - dmax[:, None])
        cell_valid = (
            (j_idx >= 0) & (j_idx <= t_lens[:, None]) & row_valid
            & (karange < w_eff[:, None])
        )

        # window start = i - 1 (same for all pairs, thanks to band frame)
        t_win = jax.lax.dynamic_slice(
            t2, (jnp.int32(0), i - 1), (B, W)
        )
        s_char = jnp.take_along_axis(
            s_codes, jnp.clip(i - 1, 0, LS - 1)[None].repeat(B, 0)[:, None],
            axis=1,
        )
        sub = _subst_lookup(subst, s_char, t_win)

        H, F, dirs = _row_update(
            H_prev, F_prev, sub, cell_valid, j_idx, go, ge,
            up_shift=1, diag_shift=0,
            local_start=flags.local_start,
            free_start_col=flags.free_start_edges,
            want_dirs=with_dirs,
        )
        # freeze rows beyond the pair's length
        H = jnp.where(row_valid, H, H_prev)
        F = jnp.where(row_valid, F, F_prev)

        # --- trackers ---
        def upd(best, bi, bk, cand_val, cand_k, active):
            better = active & (cand_val > best)
            return (jnp.where(better, cand_val, best),
                    jnp.where(better, i, bi),
                    jnp.where(better, cand_k, bk))

        if flags.local_end:
            rowmax = jnp.max(jnp.where(cell_valid, H, NEG), axis=1)
            rowarg = jnp.argmax(jnp.where(cell_valid, H, NEG), axis=1)
            best, bi, bk = upd(
                best, bi, bk, rowmax, rowarg.astype(jnp.int32),
                row_valid[:, 0],
            )
        if flags.free_end_edges:
            # column j == LT (one lane per row): k = LT - i + dmax
            kcol = t_lens - i + dmax
            in_band = (kcol >= 0) & (kcol < W)
            colval = jnp.where(
                in_band,
                jnp.take_along_axis(
                    H, jnp.clip(kcol, 0, W - 1)[:, None], axis=1
                )[:, 0],
                NEG,
            )
            best, bi, bk = upd(best, bi, bk, colval, kcol, row_valid[:, 0])
            # last row: i == LS, any j
            is_last = (i == s_lens)
            rowmax = jnp.max(jnp.where(cell_valid, H, NEG), axis=1)
            rowarg = jnp.argmax(jnp.where(cell_valid, H, NEG), axis=1)
            best, bi, bk = upd(
                best, bi, bk,
                jnp.where(is_last, rowmax, NEG),
                rowarg.astype(jnp.int32), is_last,
            )
        # corner (i == LS, j == LT) for global/end-anchored
        is_last = (i == s_lens)
        kcorner = t_lens - i + dmax
        in_band = (kcorner >= 0) & (kcorner < W)
        cval = jnp.where(
            is_last & in_band,
            jnp.take_along_axis(
                H, jnp.clip(kcorner, 0, W - 1)[:, None], axis=1
            )[:, 0],
            NEG,
        )
        corner = jnp.where(is_last, cval, corner)

        out = dirs if with_dirs else jnp.zeros((0,), jnp.uint8)
        return (H, F, best, bi, bk, corner), out

    # row 0 (the init row) is part of the matrix: its cells can be
    # alignment ends — the j == LT ray at i = 0 in overlap mode, the
    # zero-score cells in local mode, and the corner itself when
    # s_lens == 0 — so the trackers are seeded from H0, not from NEG
    # (the scan only visits rows 1..LS)
    cell_valid0 = (
        (j0 >= 0) & (j0 <= t_lens[:, None]) & (karange < w_eff[:, None])
    )
    H0m = jnp.where(cell_valid0, H0, NEG)
    best0 = jnp.full((B,), NEG)
    bi0 = jnp.zeros((B,), jnp.int32)
    bk0 = jnp.zeros((B,), jnp.int32)
    if flags.local_end:
        best0 = jnp.max(H0m, axis=1)
        bk0 = jnp.argmax(H0m, axis=1).astype(jnp.int32)
    if flags.free_end_edges:
        kc0 = t_lens + dmax
        in_b0 = (kc0 >= 0) & (kc0 < W)
        colval0 = jnp.where(
            in_b0,
            jnp.take_along_axis(
                H0m, jnp.clip(kc0, 0, W - 1)[:, None], axis=1
            )[:, 0],
            NEG,
        )
        b2 = colval0 > best0
        best0 = jnp.where(b2, colval0, best0)
        bk0 = jnp.where(b2, jnp.clip(kc0, 0, W - 1), bk0)
        rm0 = jnp.max(H0m, axis=1)
        ra0 = jnp.argmax(H0m, axis=1).astype(jnp.int32)
        b3 = (s_lens == 0) & (rm0 > best0)
        best0 = jnp.where(b3, rm0, best0)
        bk0 = jnp.where(b3, ra0, bk0)
    kcorner0 = t_lens + dmax
    corner0 = jnp.where(
        (s_lens == 0) & (kcorner0 >= 0) & (kcorner0 < W),
        jnp.take_along_axis(
            H0m, jnp.clip(kcorner0, 0, W - 1)[:, None], axis=1
        )[:, 0],
        NEG,
    )
    init = (H0, F0, best0, bi0, bk0, corner0)
    (H, F, best, bi, bk, corner), dirs_rows = jax.lax.scan(
        step, init, jnp.arange(1, LS + 1, dtype=jnp.int32)
    )

    if flags.local_end or flags.free_end_edges:
        score, ei, ek = best, bi, bk
    else:
        score = corner
        ei = s_lens
        ek = t_lens - s_lens + dmax
    ej = ei - dmax + ek  # j = i - d = i - (dmax - k)

    if with_dirs:
        dirs = jnp.transpose(dirs_rows, (1, 0, 2))  # [B, LS, W]
    else:
        dirs = jnp.zeros((), jnp.uint8)
    return DPResult(score=score, end_i=ei, end_j=ej, dirs=dirs)


# ---------------------------------------------------------------------------
# full-matrix scan (STD_MODE)
# ---------------------------------------------------------------------------

def full_dp(s_codes, t_codes, s_lens, t_lens, *, subst, go, ge,
            flags: ModeFlags, with_dirs: bool = False):
    # NOT jitted: go/ge must still be concrete here for the guard (a
    # jitted wrapper would trace them, float() would raise, and the
    # guard's try/except would silently swallow the violation)
    _check_gap_scores(go, ge)
    return _full_dp_jit(
        s_codes, t_codes, s_lens, t_lens, subst=subst, go=go, ge=ge,
        flags=flags, with_dirs=with_dirs,
    )


@partial(jax.jit, static_argnames=("flags", "with_dirs"))
def _full_dp_jit(s_codes, t_codes, s_lens, t_lens, *, subst, go, ge,
                 flags: ModeFlags, with_dirs: bool = False):
    """Batched full-matrix affine-gap DP (lane k = column j).

    Same recurrence as :func:`banded_dp` with layout shifts
    (diag = shift-right, up = same lane).  Width = LT + 1 (column 0 is the
    j=0 boundary).
    """
    B, LS = s_codes.shape
    LT = t_codes.shape[1]
    W = LT + 1
    s_codes = s_codes.astype(jnp.int32)
    t_codes = t_codes.astype(jnp.int32)
    subst = jnp.asarray(subst, dtype=jnp.float32)
    go = jnp.float32(go)
    ge = jnp.float32(ge)

    j_idx = jnp.arange(W, dtype=jnp.int32)[None, :].repeat(B, 0)
    H0 = _init_row(j_idx, t_lens[:, None], go, ge, flags)
    F0 = jnp.full((B, W), NEG)
    # t character of column j is T[j-1]
    t_cols = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), t_codes], axis=1
    )

    def step(carry, i):
        H_prev, F_prev, best, bi, bk, corner = carry
        row_valid = (i <= s_lens)[:, None]
        cell_valid = (j_idx <= t_lens[:, None]) & row_valid
        s_char = jnp.take_along_axis(
            s_codes, jnp.clip(i - 1, 0, LS - 1)[None].repeat(B, 0)[:, None],
            axis=1,
        )
        sub = _subst_lookup(subst, s_char, t_cols)
        H, F, dirs = _row_update(
            H_prev, F_prev, sub, cell_valid, j_idx, go, ge,
            up_shift=0, diag_shift=1,
            local_start=flags.local_start,
            free_start_col=flags.free_start_edges,
            want_dirs=with_dirs,
        )
        H = jnp.where(row_valid, H, H_prev)
        F = jnp.where(row_valid, F, F_prev)

        def upd(best, bi, bk, cand_val, cand_k, active):
            better = active & (cand_val > best)
            return (jnp.where(better, cand_val, best),
                    jnp.where(better, i, bi),
                    jnp.where(better, cand_k, bk))

        if flags.local_end:
            rowmax = jnp.max(jnp.where(cell_valid, H, NEG), axis=1)
            rowarg = jnp.argmax(jnp.where(cell_valid, H, NEG), axis=1)
            best, bi, bk = upd(best, bi, bk, rowmax,
                               rowarg.astype(jnp.int32), row_valid[:, 0])
        if flags.free_end_edges:
            colval = jnp.take_along_axis(H, t_lens[:, None], axis=1)[:, 0]
            best, bi, bk = upd(best, bi, bk, colval, t_lens,
                               row_valid[:, 0])
            is_last = (i == s_lens)
            rowmax = jnp.max(jnp.where(cell_valid, H, NEG), axis=1)
            rowarg = jnp.argmax(jnp.where(cell_valid, H, NEG), axis=1)
            best, bi, bk = upd(best, bi, bk,
                               jnp.where(is_last, rowmax, NEG),
                               rowarg.astype(jnp.int32), is_last)
        is_last = (i == s_lens)
        cval = jnp.take_along_axis(H, t_lens[:, None], axis=1)[:, 0]
        corner = jnp.where(is_last, cval, corner)

        out = dirs if with_dirs else jnp.zeros((0,), jnp.uint8)
        return (H, F, best, bi, bk, corner), out

    # seed trackers from row 0 (same reasoning as in banded_dp: the
    # init row's cells can be alignment ends, and the scan starts at 1)
    cell_valid0 = j_idx <= t_lens[:, None]
    H0m = jnp.where(cell_valid0, H0, NEG)
    best0 = jnp.full((B,), NEG)
    bi0 = jnp.zeros((B,), jnp.int32)
    bk0 = jnp.zeros((B,), jnp.int32)
    if flags.local_end:
        best0 = jnp.max(H0m, axis=1)
        bk0 = jnp.argmax(H0m, axis=1).astype(jnp.int32)
    if flags.free_end_edges:
        colval0 = jnp.take_along_axis(H0m, t_lens[:, None], axis=1)[:, 0]
        b2 = colval0 > best0
        best0 = jnp.where(b2, colval0, best0)
        bk0 = jnp.where(b2, t_lens, bk0)
        rm0 = jnp.max(H0m, axis=1)
        ra0 = jnp.argmax(H0m, axis=1).astype(jnp.int32)
        b3 = (s_lens == 0) & (rm0 > best0)
        best0 = jnp.where(b3, rm0, best0)
        bk0 = jnp.where(b3, ra0, bk0)
    corner0 = jnp.where(
        s_lens == 0,
        jnp.take_along_axis(H0m, t_lens[:, None], axis=1)[:, 0],
        NEG,
    )
    init = (H0, F0, best0, bi0, bk0, corner0)
    (H, F, best, bi, bk, corner), dirs_rows = jax.lax.scan(
        step, init, jnp.arange(1, LS + 1, dtype=jnp.int32)
    )
    if flags.local_end or flags.free_end_edges:
        score, ei, ej = best, bi, bk
    else:
        score, ei, ej = corner, s_lens, t_lens
    if with_dirs:
        dirs = jnp.transpose(dirs_rows, (1, 0, 2))
    else:
        dirs = jnp.zeros((), jnp.uint8)
    return DPResult(score=score, end_i=ei, end_j=ej, dirs=dirs)


# ---------------------------------------------------------------------------
# checkpointed re-solve traceback (STD_MODE memory fallback)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("flags", "with_dirs", "n_rows"))
def _full_dp_block_jit(s_codes, t_codes, s_lens, t_lens, H_in, F_in, i0,
                       *, n_rows: int, subst, go, ge, flags: ModeFlags,
                       with_dirs: bool):
    """Rows ``i0+1 .. i0+n_rows`` of the full-matrix DP from a given
    (H, F) row state — the re-solve block of the checkpointed traceback.
    ``i0`` is traced, so every block shares one compiled program.
    No trackers: end cells come from the score-only full pass.
    """
    B, LS = s_codes.shape
    LT = t_codes.shape[1]
    W = LT + 1
    s_codes = s_codes.astype(jnp.int32)
    t_codes = t_codes.astype(jnp.int32)
    subst = jnp.asarray(subst, dtype=jnp.float32)
    go = jnp.float32(go)
    ge = jnp.float32(ge)
    j_idx = jnp.arange(W, dtype=jnp.int32)[None, :].repeat(B, 0)
    t_cols = jnp.concatenate(
        [jnp.full((B, 1), -1, jnp.int32), t_codes], axis=1
    )

    def step(carry, i):
        H_prev, F_prev = carry
        row_valid = (i <= s_lens)[:, None]
        cell_valid = (j_idx <= t_lens[:, None]) & row_valid
        s_char = jnp.take_along_axis(
            s_codes, jnp.clip(i - 1, 0, LS - 1)[None].repeat(B, 0)[:, None],
            axis=1,
        )
        sub = _subst_lookup(subst, s_char, t_cols)
        H, F, dirs = _row_update(
            H_prev, F_prev, sub, cell_valid, j_idx, go, ge,
            up_shift=0, diag_shift=1,
            local_start=flags.local_start,
            free_start_col=flags.free_start_edges,
            want_dirs=with_dirs,
        )
        H = jnp.where(row_valid, H, H_prev)
        F = jnp.where(row_valid, F, F_prev)
        out = dirs if with_dirs else jnp.zeros((0,), jnp.uint8)
        return (H, F), out

    (H, F), dirs_rows = jax.lax.scan(
        step, (H_in, F_in),
        i0 + jnp.arange(1, n_rows + 1, dtype=jnp.int32),
    )
    if with_dirs:
        dirs = jnp.transpose(dirs_rows, (1, 0, 2))   # [B, n_rows, W]
    else:
        dirs = jnp.zeros((), jnp.uint8)
    return H, F, dirs


def full_dp_traceback(s_codes, t_codes, s_lens, t_lens, *, subst, go, ge,
                      flags: ModeFlags, end_i, end_j,
                      block_rows: int = 512):
    """Transcripts for full-matrix (STD_MODE) alignments in
    O(block_rows · LT) direction memory instead of O(LS · LT).

    The reference's ``dptable_traceback`` walks a fully materialized
    table; a single 10 kbp pair's byte plane is ~100 MB here (SURVEY §7
    "hard parts").  This is the checkpointed re-solve fallback: one
    score-shaped forward pass storing the (H, F) row state every
    ``block_rows`` rows (~LS/K · LT · 8 bytes of f32 checkpoints), then
    the walk re-solves ONE block at a time with direction bytes
    ([B, block_rows, LT+1] peak) and chases pointers backwards through
    it.  Compute <= 2x the forward pass; every block shares one
    compiled program (``i0`` is traced).

    Args: device/np arrays as for :func:`full_dp`; ``end_i``/``end_j``
    from the score-only pass.  Returns a list of
    ``(transcript, origin_start, mutate_start)`` per pair.
    """
    _check_gap_scores(go, ge)
    B, LS = s_codes.shape
    LT = t_codes.shape[1]
    W = LT + 1
    K = int(block_rows)
    n_blocks = max((LS + K - 1) // K, 1)
    j_idx = np.arange(W, dtype=np.int32)[None, :].repeat(B, 0)
    tl_col = np.asarray(t_lens, np.int32)[:, None]
    H = jnp.asarray(np.asarray(
        _init_row(jnp.asarray(j_idx), jnp.asarray(tl_col),
                  jnp.float32(go), jnp.float32(ge), flags)
    ))
    F = jnp.full((B, W), NEG)
    ckpts = [(H, F)]
    for k in range(n_blocks - 1):
        H, F, _ = _full_dp_block_jit(
            s_codes, t_codes, s_lens, t_lens, H, F,
            jnp.int32(k * K), n_rows=K, subst=subst, go=go, ge=ge,
            flags=flags, with_dirs=False,
        )
        ckpts.append((H, F))

    s_np = np.asarray(s_codes)
    t_np = np.asarray(t_codes)
    end_i = np.asarray(end_i)
    end_j = np.asarray(end_j)

    # blocks OUTER, pairs inner: each block's re-solve computes dirs for
    # ALL B rows, so every block must be materialized at most once per
    # CALL, not once per pair (the previous pair-outer loop with a
    # one-block cache re-solved each block per pair — O(B^2) full-pass
    # work for a batch).  Walks pause at a block's lower edge and resume
    # when the loop reaches that block; E-runs never cross blocks (the
    # block index depends on i only, and E moves only j).
    cur_i = [int(x) for x in end_i]
    cur_j = [int(x) for x in end_j]
    states = ["H"] * B
    done = [False] * B
    opss = [[] for _ in range(B)]
    for k in range(n_blocks - 1, -1, -1):
        needs = [
            b for b in range(B)
            if not done[b] and cur_i[b] >= 1 and (cur_i[b] - 1) // K == k
        ]
        if not needs:
            continue
        H_in, F_in = ckpts[k]
        _, _, dirs = _full_dp_block_jit(
            s_codes, t_codes, s_lens, t_lens, H_in, F_in,
            jnp.int32(k * K), n_rows=K, subst=subst, go=go, ge=ge,
            flags=flags, with_dirs=True,
        )
        dirs_k = np.asarray(dirs)
        for b in needs:
            i, j, state = cur_i[b], cur_j[b], states[b]
            ops = opss[b]

            def byte_at(i, j):
                if j < 0 or j >= W or i < 1:
                    raise ValueError(
                        "traceback left the matrix at (i=%d, j=%d)"
                        % (i, j)
                    )
                return int(dirs_k[b, (i - 1) - k * K, j])

            while not done[b] and i >= 1 and (i - 1) // K == k:
                if state == "H":
                    if i == 0 or j == 0:
                        done[b] = True
                        break
                    bt = byte_at(i, j)
                    src = bt & 3
                    if src == 0:
                        done[b] = True
                        break
                    if src == 1:
                        ops.append(
                            "M" if s_np[b, i - 1] == t_np[b, j - 1]
                            else "S"
                        )
                        i -= 1
                        j -= 1
                    elif src == 2:
                        state = "E"
                    else:
                        state = "F"
                elif state == "E":
                    bt = byte_at(i, j)
                    ops.append("I")
                    j -= 1
                    if not (bt >> 2) & 1 or j == 0:
                        state = "H"
                else:
                    bt = byte_at(i, j)
                    ops.append("D")
                    i -= 1
                    if not (bt >> 3) & 1 or i == 0:
                        state = "H"
            cur_i[b], cur_j[b], states[b] = i, j, state

    out = []
    for b in range(B):
        i, j, ops = cur_i[b], cur_j[b], opss[b]
        if not (flags.local_start or flags.free_start_edges):
            ops.extend("I" * j)
            ops.extend("D" * i)
            i = 0
            j = 0
        out.append(("".join(reversed(ops)), i, j))
    return out


# ---------------------------------------------------------------------------
# host-side traceback (numpy pointer chase)
# ---------------------------------------------------------------------------

def traceback_path(dirs, s_codes, t_codes, end_i, end_j, *, banded: bool,
                   dmax: int = 0, flags: ModeFlags = ModeFlags()):
    """Walk direction bytes from (end_i, end_j) back to the origin.

    Mirrors ``pwlib — dptable_traceback``: returns
    ``(transcript_str, origin_start, mutate_start)`` with ops over MSID.
    ``dirs``: [LS, W] uint8 for one pair (row r holds DP row i = r + 1).
    """
    dirs = np.asarray(dirs)
    W = dirs.shape[1]
    s = np.asarray(s_codes)
    t = np.asarray(t_codes)
    i, j = int(end_i), int(end_j)

    def byte_at(i, j):
        k = (j - i + dmax) if banded else j
        if k < 0 or k >= W or i < 1:
            # a silent negative-index wraparound here would walk the
            # wrong lane and return a plausible-looking garbage
            # transcript; fail loudly instead
            raise ValueError(
                "traceback left the direction plane at (i=%d, j=%d) — "
                "end cell outside the band or wrong dmax" % (i, j)
            )
        return int(dirs[i - 1, k])

    ops = []
    state = "H"
    while True:
        if state == "H":
            if i == 0 or j == 0:
                break
            b = byte_at(i, j)
            src = b & 3
            if src == 0:  # fresh local/free start
                break
            if src == 1:
                ops.append("M" if s[i - 1] == t[j - 1] else "S")
                i -= 1
                j -= 1
            elif src == 2:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            b = byte_at(i, j)
            ops.append("I")
            j -= 1
            if not (b >> 2) & 1:
                state = "H"
            if j == 0:
                state = "H"
        else:  # F
            b = byte_at(i, j)
            ops.append("D")
            i -= 1
            if not (b >> 3) & 1:
                state = "H"
            if i == 0:
                state = "H"
    # boundary: for corner-anchored starts, consume remaining prefix
    if not (flags.local_start or flags.free_start_edges):
        ops.extend("I" * j)
        ops.extend("D" * i)
        i = 0
        j = 0
    return "".join(reversed(ops)), i, j
