"""Band-sharded antidiagonal DP: halo exchange every C steps, no gather.

Second-generation band-axis model parallelism (giant single pairs, the
~5 Mbp genome config).  The first engine (:mod:`.sharded_dp`) shards the
*row* recurrence, whose within-row affine E-chain couples every lane —
forcing a per-row ``all_gather`` + two-level scan (a latency wall: one
collective per DP row).  This engine iterates **antidiagonals**
(a = i + j): every DP predecessor then lives in a previous wavefront, so the only cross-shard coupling is the two
boundary lanes — and those are *chunked*:

  each device carries a halo of C extra lanes on each side of its Wl
  owned lanes; C antidiagonal steps run with NO communication (halo
  staleness creeps inward one lane per step, never reaching the
  interior); then one ``ppermute`` per direction refreshes the halos
  (2 sends of [4-state, B2, C] per C steps, nearest-neighbor).

Communication drops from O(rows) collectives to O((LS+LT)/C) pairwise
sends: with C = 128 a 5 Mbp pair needs ~80 k neighbor exchanges
instead of ~5 M all_gathers.

**Dual-pair parity packing**: a cell (i, j) exists on lane d = i - j
only when (a + d) is even, which would idle half the lanes.  Here the
odd sublattice hosts a *second pair*:
stream row b2 carries pairs (2 b2, 2 b2 + 1), pair p's band start is
parity-adjusted so dmin' ≡ p (mod 2), and interleaved char streams
SI[z] = S_{z mod 2}[(z + dmin')/2 - 1] feed both pairs from one sliding
window.  100% lane utilization — 2x multi-chip cells/step over the
round-2 masked-sublattice version.  Requires ``w_eff <= W - 1`` (one
lane of slack absorbs the parity adjustment).

The per-step math (corner-seed boundary injection, validity by
poisoning, per-pair parity lane masks) is verified against the unsharded
engine on a virtual CPU mesh.

**Traceback** (round 3): a giant pair scored across chips can also be
*aligned* across chips — :func:`band_sharded_ad_traceback` runs the
forward pass with interior-state checkpoints every ``ckpt_chunks`` halo
chunks, then re-solves one checkpoint window at a time (newest first)
emitting direction bytes only for that window, and walks them with a
resumable native (C++) window walker.  Direction memory is
O(B2 · C · m · W) per window instead of O((LS+LT) · W) for the whole
plane; compute <= 2x the score-only pass — the reference's
``dptable_traceback`` contract (every alignment gets a transcript) at
band-sharded scale.

Replaces (at scale) the reference's single-threaded banded
``dptable_solve`` (SURVEY.md §2 pwlib; §5.7 long-context analog).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..ops.banded_dp import NEG, ModeFlags, shift_lanes, \
    _check_gap_scores
from .mesh import BAND_AXIS

__all__ = ["banded_dp_band_sharded_ad", "band_sharded_ad_traceback",
           "parity_adjusted_dmin"]

PAD_S = -1        # s-stream pad code (never equals a t code)
PAD_T = -2


def parity_adjusted_dmin(dmin, pair_index):
    """Per-pair band start ``dmin'`` (``dmin`` adjusted upward so
    ``dmin' ≡ pair (mod 2)``) — the lane addressing of the dual-pair
    antidiagonal planes (`native.traceback_ad_window_batch`)."""
    return dmin + (pair_index - dmin) % 2


def _shift_stream(codes, shifts, valid_len, out_len, pad):
    """out[b, x] = codes[b, x + shifts[b]] if 0 <= x+shift < valid_len
    else pad — batched variable shift as a binary-decomposed roll chain.
    """
    B, L = codes.shape
    if out_len > L:
        codes = jnp.pad(codes, ((0, 0), (0, out_len - L)),
                        constant_values=pad)
    else:
        codes = codes[:, :out_len]
    rot = jnp.mod(shifts, out_len)        # roll left by `shifts`
    out = codes
    bit = 1
    while bit < out_len:
        out = jnp.where(
            (rot & bit)[:, None] != 0, jnp.roll(out, -bit, axis=1), out
        )
        bit <<= 1
    xx = jnp.arange(out_len, dtype=jnp.int32)[None, :]
    src = xx + shifts[:, None]
    return jnp.where((src >= 0) & (src < valid_len[:, None]), out, pad)


class _Geom:
    """Per-device lane geometry, masks, and helpers shared by the
    forward pass and the traceback window re-solver — everything that
    depends only on the pair scalars and mesh position, not DP state."""

    def __init__(self, dminq2, sl2, tl2, lo2, hi2, subst, *, W: int,
                 Wl: int, C: int, A: int, flags: ModeFlags):
        self.nb = nb = jax.lax.axis_size(BAND_AXIS)
        self.me = me = jax.lax.axis_index(BAND_AXIS)
        self.B2 = B2 = dminq2.shape[0]
        self.Wle = Wle = Wl + 2 * C
        self.Wl, self.C, self.A = Wl, C, A
        self.g0 = me * Wl                 # first owned global lane
        self.kg = kg = (
            jax.lax.broadcasted_iota(jnp.int32, (B2, Wle), 1)
            + self.g0 - C
        )                                  # global lane ids incl. halo
        lane = jax.lax.broadcasted_iota(jnp.int32, (B2, Wle), 1)
        self.interior = (lane >= C) & (lane < C + Wl)
        self.kg_even = kg_even = (kg % 2) == 0

        self.d0, self.d1 = d0, d1 = dminq2[:, 0:1], dminq2[:, 1:2]
        self.sl0, self.sl1 = sl0, sl1 = sl2[:, 0:1], sl2[:, 1:2]
        self.tl0, self.tl1 = tl0, tl1 = tl2[:, 0:1], tl2[:, 1:2]
        lo0, lo1 = lo2[:, 0:1], lo2[:, 1:2]
        hi0, hi1 = hi2[:, 0:1], hi2[:, 1:2]
        self.sltl0 = sl0 + tl0
        self.sltl1 = sl1 + tl1
        self.kc0 = sl0 - tl0 - d0          # global corner lane (sl, tl)
        self.kc1 = sl1 - tl1 - d1

        # pair p owns slots with (a + kg) ≡ p (mod 2) (dmin'_p ≡ p by
        # construction): at even a, even lanes are pair 0; at odd a they
        # swap.  Live lanes are each pair's top-w_eff diagonals
        # [lo, hi).  Additive float masks (0 live / NEG dead) — one add
        # per step.
        okf0 = jnp.where((kg >= lo0) & (kg < hi0), 0.0, NEG)
        okf1 = jnp.where((kg >= lo1) & (kg < hi1), 0.0, NEG)
        self.okf_a_even = jnp.where(kg_even, okf0, okf1)
        self.okf_a_odd = jnp.where(kg_even, okf1, okf0)

        self.subst = subst.astype(jnp.float32)

        # corner-seed boundary injection (kernel contract): sub at
        # (0, 0) reads PAD chars -> the poison constant -1.0, so seeding
        # H2[kc(0,0)] = +1.0 makes the a = 0 step produce H(0,0) = 0 and
        # the E/F chains grow the gap boundary rays from it.  One seed
        # lane per pair (they never collide: -d0 is even, -d1 odd).
        if not (flags.local_start or flags.free_start_edges):
            self.H2_0 = jnp.where(
                (kg == -d0) | (kg == -d1), jnp.float32(1.0), NEG
            )
        else:
            self.H2_0 = jnp.full((B2, Wle), NEG)

        self._right_perm = [(i, i - 1) for i in range(1, nb)]
        self._left_perm = [(i, i + 1) for i in range(nb - 1)]

    def sub_score(self, s_win, t_win):
        # small-table selects, not a gather: they fuse into the step's
        # elementwise work, and this runs every antidiagonal
        A, subst = self.A, self.subst
        s_c = jnp.clip(s_win, 0, A - 1)
        t_c = jnp.clip(t_win, 0, A - 1)
        val = jnp.zeros(t_win.shape, jnp.float32)
        for a in range(A):
            row = jnp.full(t_win.shape, subst[a, 0], jnp.float32)
            for bb in range(1, A):
                row = jnp.where(t_c == bb, subst[a, bb], row)
            val = jnp.where(s_c == a, row, val)
        # pads never match; poison so off-matrix cells only decay
        return jnp.where((s_win < 0) | (t_win < 0), jnp.float32(-1.0), val)

    def refresh_halos(self, X):
        """X: [4, B2, Wle] stacked (H2, H1, E, F).  Neighbors' interior
        edge lanes become this device's halos.  ppermute zero-fills
        non-addressed edges — mask back to NEG (mesh-edge halos are
        outside the global band)."""
        nb, me, C, Wl = self.nb, self.me, self.C, self.Wl
        if nb == 1:
            return X
        to_right = X[:, :, Wl:C + Wl]        # my interior rightmost C
        to_left = X[:, :, C:2 * C]           # my interior leftmost C
        got_l = jax.lax.ppermute(to_right, BAND_AXIS, self._left_perm)
        got_r = jax.lax.ppermute(to_left, BAND_AXIS, self._right_perm)
        got_l = jnp.where(me == 0, NEG, got_l)
        got_r = jnp.where(me == nb - 1, NEG, got_r)
        return jnp.concatenate(
            [got_l, X[:, :, C:C + Wl], got_r], axis=2
        )


def _ad_step(g: "_Geom", s_exp, t_flip, Apad: int, go, ge,
             flags: ModeFlags, H2, H1, E, F, a, want_dirs: bool = False):
    """One antidiagonal step of the sharded recurrence (shared by the
    forward pass and the traceback window re-solver — the evolutions
    must be bit-identical for checkpoints to replay exactly).

    Returns ``(H1, H_masked, E, F, byte)``: the next carry plus (when
    ``want_dirs``) the per-slot direction byte — same bit semantics as
    the AD kernel / lax engine (bits 0-1 H-source 0=stop/1=diag/2=E/
    3=F, bit 2 E-extend, bit 3 F-extend); comparisons use the pre-mask
    H so the additive lane masks cannot break the equality tests."""
    # windows (see builder): s_exp[x] = SI[x - C] with
    # SI[z] = S_{z%2}[(z + dmin'_{z%2})/2 - 1]; slot (kg, a) reads
    # SI[a + kg] = s_exp[a + g0 + lane].  t_flip[x] = TI[Apad+C-x]
    # with TI[u] = T_{u%2}[(u - dmin'_{u%2})/2 - 1]; slot reads
    # TI[a - kg] = t_flip[Apad + g0 - a + lane].
    s_win = jax.lax.dynamic_slice(
        s_exp, (jnp.int32(0), a + g.g0), (g.B2, g.Wle)
    ).astype(jnp.int32)
    t_win = jax.lax.dynamic_slice(
        t_flip, (jnp.int32(0), Apad + g.g0 - a), (g.B2, g.Wle)
    ).astype(jnp.int32)
    sub = g.sub_score(s_win, t_win)

    HpGo = H1 + go
    if want_dirs:
        # gap-extension flags BEFORE the chain update (dest cell (i, j)
        # reads its source's choice), shifted with the same lane shift
        # as the chain itself; ties prefer extension (the lax engine's
        # convention).  Pre-weighted 4.0/8.0: the byte pack is two adds.
        e4 = shift_lanes(jnp.where(E >= HpGo, 4.0, 0.0), -1, 0.0)
        f8 = shift_lanes(jnp.where(F >= HpGo, 8.0, 0.0), 1, 0.0)
    E = shift_lanes(jnp.maximum(HpGo, E), -1, NEG) + ge
    F = shift_lanes(jnp.maximum(HpGo, F), 1, NEG) + ge
    diag_cand = H2 + sub
    H_new = jnp.maximum(jnp.maximum(diag_cand, E), F)
    if flags.local_start:
        H_new = jnp.maximum(H_new, 0.0)
    if flags.free_start_edges:
        # boundary rays i == 0 / j == 0 per pair are free starts
        ray = (
            (g.kg == (-g.d0 - a)) | (g.kg == (a - g.d0))
            | (g.kg == (-g.d1 - a)) | (g.kg == (a - g.d1))
        )
        H_new = jnp.maximum(H_new, jnp.where(ray, 0.0, NEG))
    byte = None
    if want_dirs:
        d = jnp.where(
            H_new == diag_cand, 1.0,
            jnp.where(H_new == E, 2.0, 3.0),
        )
        if flags.local_start:
            # fresh local start: value == 0 and the diag source lost
            d = jnp.where((H_new == 0.0) & (diag_cand < 0.0), 0.0, d)
        byte = (d + e4 + f8).astype(jnp.int32).astype(jnp.uint8)
    a_even = (a % 2) == 0
    H_masked = H_new + jnp.where(a_even, g.okf_a_even, g.okf_a_odd)
    return H1, H_masked, E, F, byte


def _band_shard_ad_fn(s_exp, t_flip, dminq2, sl2, tl2, lo2, hi2, subst,
                      *, W: int, Wl: int, C: int, Apad: int,
                      go: float, ge: float, flags: ModeFlags, A: int,
                      ckpt_every: int = 0):
    """Per-device body: owns global lanes [me*Wl, (me+1)*Wl), carries a
    C-lane halo each side (state width Wle = Wl + 2C).  Batch rows are
    dual-pair planes: row b2 = pairs (2 b2, 2 b2 + 1); per-pair scalars
    arrive as [B2, 2] columns."""
    g = _Geom(dminq2, sl2, tl2, lo2, hi2, subst,
              W=W, Wl=Wl, C=C, A=A, flags=flags)
    B2, Wle, kg = g.B2, g.Wle, g.kg
    kg_even, interior = g.kg_even, g.interior
    H2_0 = g.H2_0
    refresh_halos = g.refresh_halos

    track_local = flags.local_end
    track_rays = flags.free_end_edges

    n_chunks = Apad // C

    def step(carry, a):
        if ckpt_every:
            H2, H1, E, F, Me, Mo, Ae, Ao = carry
        else:
            H2, H1, E, F, Me, Mo = carry
        H2n, H_new, E, F, _ = _ad_step(
            g, s_exp, t_flip, Apad, go, ge, flags, H2, H1, E, F, a
        )
        a_even = (a % 2) == 0

        if track_local:
            tracked = H_new
        elif track_rays:
            # overlap ends per pair: i == slen ray and j == tlen ray
            # (slots are pair-disjoint by parity, so one OR is safe)
            cond = (
                ((kg == (2 * g.sl0 - g.d0 - a)) & (a >= g.sl0)
                 & (a <= g.sltl0))
                | ((kg == (a - g.d0 - 2 * g.tl0)) & (a >= g.tl0)
                   & (a <= g.sltl0))
                | ((kg == (2 * g.sl1 - g.d1 - a)) & (a >= g.sl1)
                   & (a <= g.sltl1))
                | ((kg == (a - g.d1 - 2 * g.tl1)) & (a >= g.tl1)
                   & (a <= g.sltl1))
            )
            tracked = jnp.where(cond, H_new, NEG)
        else:
            cond = (
                ((a == g.sltl0) & (kg == g.kc0))
                | ((a == g.sltl1) & (kg == g.kc1))
            )
            tracked = jnp.where(cond, H_new, NEG)
        # per-step-parity accumulators (pair p's values sit on lanes
        # kg ≡ p at even a and kg ≢ p at odd a; the post-loop lane-parity
        # split recovers per-pair maxima exactly — kernel contract).
        # Ae/Ao: per-lane step-of-max (strict improvement records a) for
        # end-cell recovery in the traceback driver.
        if ckpt_every:
            Ae = jnp.where(a_even & (tracked > Me), a, Ae)
            Ao = jnp.where((~a_even) & (tracked > Mo), a, Ao)
        Me = jnp.where(a_even, jnp.maximum(Me, tracked), Me)
        Mo = jnp.where(a_even, Mo, jnp.maximum(Mo, tracked))
        if ckpt_every:
            return (H2n, H_new, E, F, Me, Mo, Ae, Ao), None
        return (H2n, H_new, E, F, Me, Mo), None

    def chunk(carry, c):
        rest = carry[4:]
        X = refresh_halos(jnp.stack(carry[:4]))
        (H2, H1, E, F, *rest), _ = jax.lax.scan(
            step, (X[0], X[1], X[2], X[3]) + tuple(rest),
            c * C + jnp.arange(C, dtype=jnp.int32),
        )
        return (H2, H1, E, F, *rest), None

    neg = jnp.full((B2, Wle), NEG)
    init = (H2_0, neg, neg, neg, neg, neg)
    if ckpt_every:
        zi = jnp.full((B2, Wle), -1, jnp.int32)
        init = init + (zi, zi)
        m = int(ckpt_every)
        n_outer = n_chunks // m

        def outer(carry, co):
            # checkpoint = the carry ENTERING this window (interior
            # lanes are exactly the unsharded state at step boundaries;
            # halos are the neighbors' business and are discarded)
            ck = jnp.stack(carry[:4])[:, :, C:C + Wl]
            carry, _ = jax.lax.scan(
                chunk, carry, co * m + jnp.arange(m, dtype=jnp.int32)
            )
            return carry, ck

        carry, cks = jax.lax.scan(
            outer, init, jnp.arange(n_outer, dtype=jnp.int32)
        )
        Me, Mo, Ae, Ao = carry[4], carry[5], carry[6], carry[7]
    else:
        (_, _, _, _, Me, Mo), _ = jax.lax.scan(
            chunk, init, jnp.arange(n_chunks, dtype=jnp.int32)
        )

    # per-pair separation by lane parity, interior lanes only (halo
    # trackers are the neighbors' business)
    v0 = jnp.where(kg_even, Me, Mo)
    v1 = jnp.where(kg_even, Mo, Me)
    s0 = jnp.max(jnp.where(interior, v0, NEG), axis=1)
    s1 = jnp.max(jnp.where(interior, v1, NEG), axis=1)
    out = jnp.stack([s0, s1], axis=1)          # [B2, 2]
    out = jax.lax.pmax(out, BAND_AXIS)
    if not ckpt_every:
        return out
    # assemble full-W per-lane trackers + checkpoints across the mesh:
    # every device contributes its interior [.., Wl] slice; the caller's
    # out_specs concatenate them along the lane axis into [.., W]
    iv = (slice(None), slice(C, C + Wl))
    return (out, Me[iv], Mo[iv], Ae[iv], Ao[iv], cks)


def banded_dp_band_sharded_ad(s_codes, t_codes, s_lens, t_lens, dmin, *,
                              W: int, subst, go: float, ge: float,
                              flags: ModeFlags, mesh, w_eff=None,
                              halo: int = 64, A: int = 4):
    """Banded DP, band axis sharded, antidiagonal iteration (score mode).

    Same contract as :func:`biseqt_jax.ops.banded_dp.banded_dp` (score
    only).  ``w_eff <= W - 1``: one lane of slack absorbs the per-pair
    parity adjustment of dmin — the dual-pair packing contract shared
    with the single-chip kernel (values above are clamped).  ``W`` must
    divide by the band-axis size.  Inputs are REPLICATED over the data
    axis: this engine exists for giant single pairs; batch parallelism
    belongs to the data-axis engines.  Pairs (2b2, 2b2+1) share one
    dual-pair lane plane (odd B is padded with an inert pair).
    ``halo`` = C, the steps between neighbor exchanges (communication =
    2 nearest-neighbor sends of [4, B2, C] floats per C antidiagonal
    steps).
    """
    return _run_band_sharded_ad(
        s_codes, t_codes, s_lens, t_lens, dmin, subst=subst, W=W, go=go,
        ge=ge, flags=flags, mesh=mesh, w_eff=w_eff, halo=halo, A=A,
        ckpt_every=0,
    )


def _pair_geometry(B: int, LS: int, LT: int, C: int,
                   ckpt_every: int = 0):
    """Static ints shared by _prep_streams and the traceback driver:
    (Bp, B2, Apad).  Apad = steps 0..LS+LT inclusive rounded up to whole
    halo chunks (and whole checkpoint windows when requested)."""
    Bp = ((B + 1) // 2) * 2
    gran = C * max(int(ckpt_every), 1)
    Aend = LS + LT + 1
    return Bp, Bp // 2, ((Aend + gran - 1) // gran) * gran


def _prep_streams(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, *,
                  W: int, C: int, ckpt_every: int = 0):
    """Dual-pair packing + interleaved char streams, shared by the
    sharded forward pass and the traceback window re-solver.  Returns a
    dict of arrays plus static geometry (B2, Apad, Mlen)."""
    B, LS = s_codes.shape
    LT = t_codes.shape[1]
    s_lens = s_lens.astype(jnp.int32)
    t_lens = t_lens.astype(jnp.int32)
    dmin = dmin.astype(jnp.int32)
    if w_eff is None:
        w_eff = jnp.full((B,), W - 1, jnp.int32)
    # <= W - 1 is load-bearing: the parity adjustment drops each pair's
    # bottom lane (dminq = dmin + up), exactly as in the single-chip
    # dual-pair kernel
    w_eff = jnp.minimum(w_eff.astype(jnp.int32), W - 1)

    # pair up: plane b2 holds pairs (2 b2, 2 b2 + 1); odd B pads one
    # inert length-1 pair
    Bp, B2, Apad = _pair_geometry(B, LS, LT, C, ckpt_every)

    def padb(x, fill):
        return jnp.pad(x, ((0, Bp - B),), constant_values=fill)

    s_codes = jnp.pad(s_codes.astype(jnp.int8), ((0, Bp - B), (0, 0)),
                      constant_values=PAD_S)
    t_codes = jnp.pad(t_codes.astype(jnp.int8), ((0, Bp - B), (0, 0)),
                      constant_values=PAD_T)
    s_lens_p = padb(s_lens, 1)
    t_lens_p = padb(t_lens, 1)
    dmin_p = padb(dmin, 0)
    weff_p = padb(w_eff, 1)

    pair_id = jnp.arange(Bp, dtype=jnp.int32) % 2
    dminq = parity_adjusted_dmin(dmin_p, pair_id)   # dmin' ≡ pair (mod 2)
    up = dminq - dmin_p                             # in {0, 1}

    # interleaved char streams (replicated; windows are per-device
    # dynamic slices).  Slot (global lane kg, step a) of pair p is cell
    # (i, j) = ((a + d)/2, (a - d)/2), d = dmin'_p + kg; its chars are
    # S_p[i-1], T_p[j-1].  With z = a + kg (parity z ≡ p):
    #   SI[z] = S_{z%2}[(z + dmin'_{z%2})/2 - 1]   (per-pair shift below)
    #   TI[u] = T_{u%2}[(u - dmin'_{u%2})/2 - 1],  u = a - kg
    # u is NEGATIVE for valid cells whenever dmin' < 0 (down to
    # dmin' + 2, the j = 1 column at i = 0-adjacent lanes), so — exactly
    # as in the single-chip kernel — the t stream is stored at the
    # shifted index x = u + W (ti[x] = TI[x - W], extra -W/2 half-slot
    # shift per pair; W is even so parity is preserved).  s_exp prepends
    # C pads so the per-step slice offset (a + g0) stays nonnegative; t
    # is served flipped (u decreases as the lane grows).
    # Ring rule (round-2 bug class): each half stream's ring must cover
    # its max valid source index (>= LS / LT), or the modular roll in
    # _shift_stream serves wrapped chars under a passing validity mask.
    Mlen = max((Apad + W + 2 * C) // 2 + 2, LS, LT + W // 2)
    Mlen = ((Mlen + 127) // 128) * 128
    s_shift = jnp.where(pair_id == 0, dminq // 2 - 1,
                        (dminq + 1) // 2 - 1)
    t_shift = jnp.where(pair_id == 0, -(dminq // 2) - 1,
                        (1 - dminq) // 2 - 1) - (W // 2)
    s_half = _shift_stream(s_codes, s_shift, s_lens_p, Mlen, PAD_S)
    t_half = _shift_stream(t_codes, t_shift, t_lens_p, Mlen, PAD_T)
    si = jnp.stack([s_half[0::2], s_half[1::2]], axis=2).reshape(
        B2, 2 * Mlen
    )
    ti = jnp.stack([t_half[0::2], t_half[1::2]], axis=2).reshape(
        B2, 2 * Mlen
    )
    s_exp = jnp.pad(si, ((0, 0), (C, 0)), constant_values=PAD_S)
    # t_flip[y] = ti[Apad + C + W - y] = TI[Apad + C - y]; tail pads
    # cover y up to Apad + W + 2C - 1 (top halo lanes of the last shard)
    t_flip = jnp.pad(
        jnp.flip(ti[:, :Apad + C + W + 1], axis=1),
        ((0, 0), (0, C)), constant_values=PAD_T,
    )

    def col(x):
        return x.reshape(B2, 2)

    return dict(
        s_exp=s_exp, t_flip=t_flip, dminq=dminq, dminq2=col(dminq),
        sl2=col(s_lens_p), tl2=col(t_lens_p),
        lo2=col(W - up - weff_p),           # live lanes [lo, hi) per pair
        hi2=col(W - up),
        B=B, Bp=Bp, B2=B2, Apad=Apad,
    )


@functools.partial(jax.jit, static_argnames=("W", "C", "ckpt_every"))
def _prep_streams_jit(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, *,
                      W: int, C: int, ckpt_every: int = 0):
    """_prep_streams under jit (array entries only — the static ints
    come from :func:`_pair_geometry`).  The eager version runs ~30
    separate dispatches over multi-MB streams."""
    p = _prep_streams(s_codes, t_codes, s_lens, t_lens, dmin, w_eff,
                      W=W, C=C, ckpt_every=ckpt_every)
    return {k: v for k, v in p.items()
            if not isinstance(v, (int, np.integer))}


@functools.partial(
    jax.jit,
    static_argnames=("W", "go", "ge", "flags", "mesh", "halo", "A",
                     "ckpt_every"),
)
def _run_band_sharded_ad(s_codes, t_codes, s_lens, t_lens, dmin, *,
                         W: int, subst, go: float, ge: float,
                         flags: ModeFlags, mesh, w_eff=None,
                         halo: int = 64, A: int = 4, ckpt_every: int = 0):
    _check_gap_scores(go, ge)
    nb = mesh.shape[BAND_AXIS]
    assert W % nb == 0, "W must divide by band-axis size"
    Wl = W // nb
    C = int(min(halo, Wl))
    p = _prep_streams(s_codes, t_codes, s_lens, t_lens, dmin, w_eff,
                      W=W, C=C, ckpt_every=ckpt_every)
    subst = jnp.asarray(subst, jnp.float32)
    if ckpt_every:
        out_specs = (P(), P(None, BAND_AXIS), P(None, BAND_AXIS),
                     P(None, BAND_AXIS), P(None, BAND_AXIS),
                     P(None, None, None, BAND_AXIS))
    else:
        out_specs = P()
    fn = shard_map(
        functools.partial(
            _band_shard_ad_fn, W=W, Wl=Wl, C=C, Apad=p["Apad"],
            go=float(go), ge=float(ge), flags=flags, A=A,
            ckpt_every=int(ckpt_every),
        ),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    out = fn(p["s_exp"], p["t_flip"], p["dminq2"], p["sl2"], p["tl2"],
             p["lo2"], p["hi2"], subst)
    if ckpt_every:
        scores, Me, Mo, Ae, Ao, cks = out
        return scores.reshape(p["Bp"])[:p["B"]], Me, Mo, Ae, Ao, cks
    return out.reshape(p["Bp"])[:p["B"]]


def _band_shard_ad_window_fn(init4, s_exp, t_flip, dminq2, sl2, tl2,
                             lo2, hi2, subst, a0, *, W: int, Wl: int,
                             C: int, Apad: int, m: int, go: float,
                             ge: float, flags: ModeFlags, A: int):
    """Re-solve ONE checkpoint window (steps [a0, a0 + m*C)) from its
    entering state, emitting UNPACKED direction bytes for the window
    walker.  ``init4``: [4, B2, Wl] this device's interior (H2, H1, E,
    F) entering the window; halos start NEG and are refreshed at each
    chunk head exactly as in the forward pass, so the window's state
    evolution replays bit-identically."""
    g = _Geom(dminq2, sl2, tl2, lo2, hi2, subst,
              W=W, Wl=Wl, C=C, A=A, flags=flags)
    halo_pad = jnp.full((4, g.B2, C), NEG)
    X = jnp.concatenate([halo_pad, init4, halo_pad], axis=2)

    def step(carry, a):
        H2, H1, E, F = carry
        H2n, H_new, E, F, byte = _ad_step(
            g, s_exp, t_flip, Apad, go, ge, flags, H2, H1, E, F, a,
            want_dirs=True,
        )
        return (H2n, H_new, E, F), byte

    def chunk(carry, c):
        X = g.refresh_halos(jnp.stack(carry))
        return jax.lax.scan(
            step, (X[0], X[1], X[2], X[3]),
            a0 + c * C + jnp.arange(C, dtype=jnp.int32),
        )

    _, by = jax.lax.scan(
        chunk, (X[0], X[1], X[2], X[3]),
        jnp.arange(m, dtype=jnp.int32),
    )                                       # [m, C, B2, Wle]
    return by.reshape(m * C, g.B2, g.Wle)[:, :, C:C + Wl]


@functools.partial(
    jax.jit,
    static_argnames=("W", "Apad", "go", "ge", "flags", "mesh", "halo",
                     "A", "ckpt_every"),
)
def _resolve_window(init4, s_exp, t_flip, dminq2, sl2, tl2, lo2, hi2,
                    subst, a0, *, W: int, Apad: int, go: float,
                    ge: float, flags: ModeFlags, mesh, halo: int,
                    A: int, ckpt_every: int):
    nb = mesh.shape[BAND_AXIS]
    Wl = W // nb
    C = int(min(halo, Wl))
    fn = shard_map(
        functools.partial(
            _band_shard_ad_window_fn, W=W, Wl=Wl, C=C, Apad=Apad,
            m=int(ckpt_every), go=float(go), ge=float(ge), flags=flags,
            A=A,
        ),
        mesh=mesh,
        in_specs=(P(None, None, BAND_AXIS), P(), P(), P(), P(), P(),
                  P(), P(), P(), P()),
        out_specs=P(None, None, BAND_AXIS),
        check_vma=False,
    )
    return fn(init4, s_exp, t_flip, dminq2, sl2, tl2, lo2, hi2, subst,
              a0)


def band_sharded_ad_traceback(s_codes, t_codes, s_lens, t_lens, dmin, *,
                              W: int, subst, go: float, ge: float,
                              flags: ModeFlags, mesh, w_eff=None,
                              halo: int = 64, A: int = 4,
                              ckpt_chunks: int = 8):
    """Transcripts through the band-sharded AD engine — the giant-pair
    regime's answer to the reference's ``dptable_traceback`` (SURVEY §2
    pwlib; §7 "hard parts": checkpoint + re-solve instead of an
    O((LS+LT)·W) direction plane).

    Three phases:
      1. sharded forward pass checkpointing the interior (H2, H1, E, F)
         state every ``ckpt_chunks`` halo chunks (O(W·(LS+LT)/(C·m))
         floats) plus per-lane end trackers;
      2. per window, newest first: a sharded re-solve from the entering
         checkpoint regenerates the window's direction bytes
         ([m·C, B2, W] peak — the only materialized plane);
      3. the native window walker (C++) chases each pair's path
         backward through the window and pauses at its lower edge;
         segments concatenate across windows.

    Compute <= 2x the score-only pass.  Returns ``(scores [B],
    [(transcript, start_i, start_j)] per pair)``.
    """
    from .. import native

    m = int(ckpt_chunks)
    scores, Me, Mo, Ae, Ao, cks = _run_band_sharded_ad(
        s_codes, t_codes, s_lens, t_lens, dmin, subst=subst, W=W, go=go,
        ge=ge, flags=flags, mesh=mesh, w_eff=w_eff, halo=halo, A=A,
        ckpt_every=m,
    )
    nb = mesh.shape[BAND_AXIS]
    Wl = W // nb
    C = int(min(halo, Wl))
    # the streams for the window re-solves — identical math to the
    # forward pass's in-jit prep (same function, same inputs), run
    # under jit: the eager version costs ~30 per-op dispatches on
    # every traceback call
    p = dict(_prep_streams_jit(
        jnp.asarray(s_codes), jnp.asarray(t_codes),
        jnp.asarray(s_lens), jnp.asarray(t_lens), jnp.asarray(dmin),
        None if w_eff is None else jnp.asarray(w_eff),
        W=W, C=C, ckpt_every=m,
    ))
    subst_j = jnp.asarray(subst, jnp.float32)
    B, LS = np.asarray(s_codes).shape
    _, _, Apad = _pair_geometry(B, LS, np.asarray(t_codes).shape[1],
                                C, m)
    n_outer = Apad // (C * m)
    dminq = np.asarray(p["dminq"])[:B]

    # end-cell recovery, mirroring the single-chip kernel: pair p's
    # per-lane maxima live on even lanes of the even-step accumulator
    # and odd lanes of the odd-step one (slot parity (a + kg) ≡ p); the
    # step-of-max arrays follow the same split.
    Me, Mo, Ae, Ao = map(np.asarray, (Me, Mo, Ae, Ao))
    scores_np = np.asarray(scores)
    sl_np = np.asarray(s_lens, np.int32)
    tl_np = np.asarray(t_lens, np.int32)
    if flags.local_end or flags.free_end_edges:
        lane_even = (np.arange(W, dtype=np.int32) % 2) == 0
        v = [np.where(lane_even, Me, Mo), np.where(lane_even, Mo, Me)]
        astep = [np.where(lane_even, Ae, Ao), np.where(lane_even, Ao, Ae)]
        end_i = np.zeros((B,), np.int32)
        end_j = np.zeros((B,), np.int32)
        for b in range(B):
            b2, q = divmod(b, 2)
            k = int(np.argmax(v[q][b2]))
            a = int(astep[q][b2][k])
            d = int(dminq[b]) + k
            end_i[b] = (a + d) // 2
            end_j[b] = (a - d) // 2
    else:
        end_i = sl_np.copy()
        end_j = tl_np.copy()

    io_i = np.ascontiguousarray(end_i, np.int32)
    io_j = np.ascontiguousarray(end_j, np.int32)
    io_state = np.zeros((B,), np.int32)
    io_done = np.zeros((B,), np.int32)
    # unreachable pairs (e.g. global corner outside the live band) have
    # no transcript by construction — do not walk them
    unreachable = scores_np < -1e29
    io_done[unreachable] = 1
    s_np = np.ascontiguousarray(s_codes, np.int8)
    t_np = np.ascontiguousarray(t_codes, np.int8)
    ops_stride = int(s_np.shape[1] + t_np.shape[1] + 2)
    segs = [[] for _ in range(B)]
    for co in range(n_outer - 1, -1, -1):
        a_base = co * C * m
        live = io_done == 0
        if not live.any():
            break
        if ((io_i + io_j)[live] < a_base).all():
            continue                     # every active walk is below
        dirs_win = _resolve_window(
            cks[co], p["s_exp"], p["t_flip"], p["dminq2"], p["sl2"],
            p["tl2"], p["lo2"], p["hi2"], subst_j, jnp.int32(a_base),
            W=W, Apad=Apad, go=float(go), ge=float(ge), flags=flags,
            mesh=mesh, halo=halo, A=A, ckpt_every=m,
        )
        dirs_np = np.asarray(dirs_win).transpose(1, 0, 2)
        seg = native.traceback_ad_window_batch(
            dirs_np, a_base, dminq, s_np, t_np,
            io_i, io_j, io_state, io_done, ops_stride,
        )
        for b in range(B):
            if seg[b]:
                segs[b].append(seg[b])
    assert io_done.all(), (
        "traceback did not terminate for pairs %s"
        % np.nonzero(io_done == 0)[0][:8].tolist()
    )

    anchored = not (flags.local_start or flags.free_start_edges)
    out = []
    for b in range(B):
        if unreachable[b]:
            out.append(("", -1, -1))
            continue
        back = "".join(segs[b])          # end -> start
        i, j = int(io_i[b]), int(io_j[b])
        if anchored:
            back += "I" * j + "D" * i
            i = j = 0
        out.append((back[::-1], i, j))
    return scores_np, out
