"""Band-axis model parallelism for the DP wavefront (giant single pairs).

For the genome-scale config (~5 Mbp pairs) a single chip's band may be too
narrow or too slow; this module shards the **band width W across devices**
(the framework's model/sequence-parallel axis) with the two cross-shard
couplings the recurrence needs each row:

  * the 'up' predecessor of the shard's last lane lives on the *right*
    neighbor — one lane of H/F per row, exchanged with ``ppermute``
    (the halo exchange of SURVEY.md §5.7);
  * the within-row affine-gap prefix max crosses shards — solved by local
    prefix-max + an all-gather of per-shard maxima (nb scalars) combined
    into an exclusive scan, the classic two-level scan decomposition.

The math is identical to :mod:`biseqt_jax.ops.banded_dp` (same closed-form
E scan), so single-device and sharded runs agree to float tolerance; tests
verify against the unsharded engine on a virtual CPU mesh.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..ops.banded_dp import (
    NEG, ModeFlags, shift_lanes, prefix_max, _subst_lookup, _init_row,
    _check_gap_scores,
)
from .mesh import BAND_AXIS

__all__ = ["banded_dp_band_sharded"]


def _band_shard_fn(s_codes, t2, s_lens, t_lens, dmax, w_eff, subst,
                   *, Wl: int, go: float, ge: float, flags: ModeFlags):
    """Per-device body: owns lanes [me*Wl, (me+1)*Wl) of the band."""
    nb = jax.lax.axis_size(BAND_AXIS)
    me = jax.lax.axis_index(BAND_AXIS)
    B, LS = s_codes.shape
    g0 = me * Wl
    karange = (
        jax.lax.broadcasted_iota(jnp.int32, (B, Wl), 1) + g0
    )
    kf = karange.astype(jnp.float32)
    dmax_c = dmax[:, None]
    tlen_c = t_lens[:, None]
    weff_c = w_eff[:, None]

    right_perm = [(i, i - 1) for i in range(1, nb)]   # i sends to i-1
    left_perm = [(i, i + 1) for i in range(nb - 1)]   # i sends to i+1

    def from_right(x_first_lane):
        """Each device receives its right neighbor's first lane.

        ppermute fills non-addressed destinations with ZEROS — on the last
        band shard there is no right neighbor, so the received value must
        be masked back to NEG or a phantom H=0 predecessor enters at the
        global dmin band edge every row.
        """
        if nb == 1:
            return jnp.full_like(x_first_lane, NEG)
        got = jax.lax.ppermute(x_first_lane, BAND_AXIS, right_perm)
        return jnp.where(me == nb - 1, NEG, got)

    def from_left(x_last_lane):
        # device 0 has no left neighbor: mask ppermute's zero fill to NEG
        if nb == 1:
            return jnp.full_like(x_last_lane, NEG)
        got = jax.lax.ppermute(x_last_lane, BAND_AXIS, left_perm)
        return jnp.where(me == 0, NEG, got)

    j0 = karange - dmax_c
    H0 = _init_row(j0, tlen_c, go, ge, flags)
    H0 = jnp.where(karange < weff_c, H0, NEG)
    F0 = jnp.full((B, Wl), NEG)

    lane = jax.lax.broadcasted_iota(jnp.int32, (B, Wl), 1)

    def step(carry, i):
        H_prev, F_prev, best, corner = carry
        row_valid = (i <= s_lens)[:, None]
        j_idx = karange + (i - dmax_c)
        cell_valid = (
            (j_idx >= 0) & (j_idx <= tlen_c) & row_valid
            & (karange < weff_c)
        )

        # halo: right neighbor's lane 0 of previous row (H and F)
        rH = from_right(H_prev[:, :1])
        rF = from_right(F_prev[:, :1])
        H_up = shift_lanes(H_prev, -1, NEG)
        F_up = shift_lanes(F_prev, -1, NEG)
        is_last_lane = lane == (Wl - 1)
        H_up = jnp.where(is_last_lane, rH, H_up)
        F_up = jnp.where(is_last_lane, rF, F_up)

        t_win = jax.lax.dynamic_slice(
            t2, (jnp.int32(0), (i - 1) + g0), (B, Wl)
        )
        s_char = jnp.take_along_axis(
            s_codes, jnp.clip(i - 1, 0, LS - 1)[None].repeat(B, 0)[:, None],
            axis=1,
        )
        sub = _subst_lookup(subst, s_char, t_win)

        diag_cand = H_prev + sub
        F_new = jnp.maximum(H_up + (go + ge), F_up + ge)
        H_pre = jnp.maximum(diag_cand, F_new)
        if flags.local_start:
            H_pre = jnp.maximum(H_pre, 0.0)
        if flags.free_start_edges:
            H_pre = jnp.where(j_idx == 0, jnp.maximum(H_pre, 0.0), H_pre)
        H_pre = jnp.where(cell_valid, H_pre, NEG)

        # global E scan: local prefix max + cross-shard exclusive combine
        lHpre = from_left(H_pre[:, -1:])
        A = shift_lanes(H_pre, 1, NEG)
        A = jnp.where(lane == 0, lHpre, A)
        A = A + (go + ge) - ge * kf
        P_loc = prefix_max(A)
        P_end = P_loc[:, -1]                       # [B]
        gathered = jax.lax.all_gather(P_end, BAND_AXIS)  # [nb, B]
        dev = jax.lax.broadcasted_iota(jnp.int32, gathered.shape, 0)
        excl = jnp.max(
            jnp.where(dev < me, gathered, NEG), axis=0
        )[:, None]
        P_glob = jnp.maximum(P_loc, excl)
        E = P_glob + ge * kf
        E = jnp.where(cell_valid, E, NEG)

        H = jnp.maximum(H_pre, E)
        H = jnp.where(cell_valid, H, NEG)
        H = jnp.where(row_valid, H, H_prev)
        F_new = jnp.where(row_valid, F_new, F_prev)

        masked = jnp.where(cell_valid, H, NEG)
        if flags.local_end:
            best = jnp.maximum(best, jnp.max(masked, axis=1))
        if flags.free_end_edges:
            kcol = (t_lens - i + dmax)[:, None]
            colval = jnp.max(
                jnp.where(karange == kcol, masked, NEG), axis=1
            )
            best = jnp.maximum(best, colval)
            best = jnp.maximum(
                best,
                jnp.where(i == s_lens, jnp.max(masked, axis=1), NEG),
            )
        kcorner = (t_lens - i + dmax)[:, None]
        cval = jnp.max(jnp.where(karange == kcorner, masked, NEG), axis=1)
        corner = jnp.where(i == s_lens, cval, corner)
        return (H, F_new, best, corner), None

    # row 0 can hold alignment ends (same reasoning as the unsharded
    # engines: the scan starts at i=1, but H0's cells — the j == tlen
    # ray at i=0, local zero cells, the corner when s_lens == 0 — are
    # part of the matrix); pmax at the end combines the per-shard seeds
    cell_valid0 = (j0 >= 0) & (j0 <= tlen_c) & (karange < weff_c)
    H0m = jnp.where(cell_valid0, H0, NEG)
    best0 = jnp.full((B,), NEG)
    if flags.local_end:
        best0 = jnp.max(H0m, axis=1)
    if flags.free_end_edges:
        kray0 = (t_lens + dmax)[:, None]
        best0 = jnp.maximum(
            best0, jnp.max(jnp.where(karange == kray0, H0m, NEG), axis=1)
        )
        best0 = jnp.maximum(
            best0,
            jnp.where(s_lens == 0, jnp.max(H0m, axis=1), NEG),
        )
    corner0 = jnp.where(
        s_lens == 0,
        jnp.max(
            jnp.where(karange == (t_lens + dmax)[:, None], H0m, NEG),
            axis=1,
        ),
        NEG,
    )
    init = (H0, F0, best0, corner0)
    (H, F, best, corner), _ = jax.lax.scan(
        step, init, jnp.arange(1, LS + 1, dtype=jnp.int32)
    )
    if flags.local_end or flags.free_end_edges:
        score = best
    else:
        score = corner
    # each device holds a partial (its lanes'); combine across the band
    return jax.lax.pmax(score, BAND_AXIS)


@functools.partial(
    jax.jit,
    static_argnames=("W", "go", "ge", "flags", "mesh"),
)
def banded_dp_band_sharded(s_codes, t_codes, s_lens, t_lens, dmin, *,
                           W: int, subst, go: float, ge: float,
                           flags: ModeFlags, mesh, w_eff=None):
    """Banded DP with the band width sharded over the mesh's band axis.

    Same inputs as :func:`biseqt_jax.ops.banded_dp.banded_dp`; returns the
    per-pair score vector (score mode).  ``W`` must divide evenly by the
    band-axis size.  Inputs are REPLICATED over the data axis (this
    engine exists for giant single pairs; batch parallelism belongs to
    the data-axis engines).
    """
    _check_gap_scores(go, ge)
    nb = mesh.shape[BAND_AXIS]
    assert W % nb == 0, "W must divide by band-axis size"
    Wl = W // nb
    B, LS = s_codes.shape
    LT = t_codes.shape[1]
    s_codes = s_codes.astype(jnp.int32)
    dmin = dmin.astype(jnp.int32)
    dmax = dmin + (W - 1)
    if w_eff is None:
        w_eff = jnp.full((B,), W, jnp.int32)

    # replicated band-frame T2 (per-shard windows are slices of it)
    Y = LS + W
    yy = jnp.arange(Y, dtype=jnp.int32)[None, :]
    src = yy - dmax[:, None]
    t2 = jnp.where(
        (src >= 0) & (src < t_lens[:, None]),
        jnp.take_along_axis(
            t_codes.astype(jnp.int32), jnp.clip(src, 0, LT - 1), axis=1
        ),
        -1,
    )
    subst = jnp.asarray(subst, jnp.float32)

    fn = shard_map(
        functools.partial(
            _band_shard_fn, Wl=Wl, go=float(go), ge=float(ge), flags=flags
        ),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return fn(
        s_codes, t2, s_lens.astype(jnp.int32), t_lens.astype(jnp.int32),
        dmax, w_eff.astype(jnp.int32), subst,
    )
