"""Pairwise alignment API: ``Aligner`` / ``Alignment`` over the DP engine.

The host-facing façade mirroring the reference's cffi binding layer
(``biseqt/pw.py — Aligner, Alignment`` over ``pwlib``'s
``dptable_init/solve/traceback``).  ``solve`` runs the batched DP engine the
platform selects (:mod:`biseqt_jax.ops.engine`: ``lax.scan`` on the CPU, the
CUDA kernel for banded problems on a GPU), or the C++ engine on request, and
``traceback`` walks the direction bytes host-side.

Alignment modes (mirroring pwlib's ``alnmode``/alntype enums):
    STD_MODE with GLOBAL, LOCAL, OVERLAP, START_ANCHORED, END_ANCHORED,
    START_ANCHORED_OVERLAP, END_ANCHORED_OVERLAP;
    BANDED_MODE with B_GLOBAL, B_LOCAL, B_OVERLAP (``diag_range`` = the
    inclusive diagonal band ``dmin <= i - j <= dmax``).

Gap scoring: a gap run of length g scores ``go_score + g * ge_score``
(affine; ``go_score <= 0``).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .sequence import Sequence, EditTranscript
from .ops.banded_dp import ModeFlags, full_dp, traceback_path
from .ops.engine import ENGINES, select_engine

__all__ = [
    "STD_MODE", "BANDED_MODE",
    "GLOBAL", "LOCAL", "OVERLAP",
    "START_ANCHORED", "END_ANCHORED",
    "START_ANCHORED_OVERLAP", "END_ANCHORED_OVERLAP",
    "B_GLOBAL", "B_LOCAL", "B_OVERLAP",
    "Aligner", "Alignment",
]

# alignment modes
STD_MODE = 0
BANDED_MODE = 1

# std alignment types
GLOBAL = "GLOBAL"
LOCAL = "LOCAL"
OVERLAP = "OVERLAP"
START_ANCHORED = "START_ANCHORED"
END_ANCHORED = "END_ANCHORED"
START_ANCHORED_OVERLAP = "START_ANCHORED_OVERLAP"
END_ANCHORED_OVERLAP = "END_ANCHORED_OVERLAP"

# banded alignment types
B_GLOBAL = "B_GLOBAL"
B_LOCAL = "B_LOCAL"
B_OVERLAP = "B_OVERLAP"

STD_TYPES = (
    GLOBAL, LOCAL, OVERLAP, START_ANCHORED, END_ANCHORED,
    START_ANCHORED_OVERLAP, END_ANCHORED_OVERLAP,
)
BANDED_TYPES = (B_GLOBAL, B_LOCAL, B_OVERLAP)

_FLAGS = {
    GLOBAL: ModeFlags(),
    LOCAL: ModeFlags(local_start=True, local_end=True),
    OVERLAP: ModeFlags(free_start_edges=True, free_end_edges=True),
    START_ANCHORED: ModeFlags(local_end=True),
    END_ANCHORED: ModeFlags(local_start=True),
    START_ANCHORED_OVERLAP: ModeFlags(free_end_edges=True),
    END_ANCHORED_OVERLAP: ModeFlags(free_start_edges=True),
    B_GLOBAL: ModeFlags(),
    B_LOCAL: ModeFlags(local_start=True, local_end=True),
    B_OVERLAP: ModeFlags(free_start_edges=True, free_end_edges=True),
}


def _bucket(n: int, mini: int = 32) -> int:
    """Round n up to a shape bucket (<= 25% waste) to limit jit recompiles."""
    n = max(int(n), 1)
    if n <= mini:
        return mini
    step = max(mini, 1 << (max(n.bit_length(), 3) - 3))
    return ((n + step - 1) // step) * step


class Alignment:
    """A pairwise alignment: transcript + score + start coordinates.

    Mirrors ``biseqt/pw.py — Alignment``.  ``origin_start``/``mutate_start``
    are the 0-based positions where the aligned region begins in each
    sequence; ``transcript`` is an :class:`EditTranscript` over MSID.
    """

    def __init__(self, origin, mutate, transcript, score=None,
                 origin_start=0, mutate_start=0):
        self.origin = origin
        self.mutate = mutate
        self.transcript = EditTranscript(transcript)
        self.score = score
        self.origin_start = int(origin_start)
        self.mutate_start = int(mutate_start)
        # sanity: transcript must fit within the sequences
        assert self.origin_start + self.transcript.origin_len <= len(origin)
        assert self.mutate_start + self.transcript.mutate_len <= len(mutate)

    @property
    def origin_end(self) -> int:
        return self.origin_start + self.transcript.origin_len

    @property
    def mutate_end(self) -> int:
        return self.mutate_start + self.transcript.mutate_len

    def calculate_score(self, subst_scores, go_score, ge_score) -> float:
        """Recompute the transcript's score under given scores (oracle)."""
        s, t = self.origin, self.mutate
        i, j = self.origin_start, self.mutate_start
        score = 0.0
        prev = None
        for op in self.transcript:
            if op in "MS":
                score += subst_scores[s[i]][t[j]]
                i += 1
                j += 1
            elif op == "I":
                score += ge_score + (go_score if prev != "I" else 0.0)
                j += 1
            else:  # D
                score += ge_score + (go_score if prev != "D" else 0.0)
                i += 1
            prev = op
        return score

    def render_term(self, term_width: int = 120, margin: int = 0) -> str:
        """Three-line text rendering of the alignment (origin / ops / mutate)."""
        s, t = self.origin, self.mutate
        i, j = self.origin_start, self.mutate_start
        top, mid, bot = [], [], []
        for op in self.transcript:
            if op in "MS":
                top.append(str(s[i:i + 1]))
                bot.append(str(t[j:j + 1]))
                mid.append("|" if op == "M" else ".")
                i += 1
                j += 1
            elif op == "I":
                top.append("-")
                bot.append(str(t[j:j + 1]))
                mid.append(" ")
                j += 1
            else:
                top.append(str(s[i:i + 1]))
                bot.append("-")
                mid.append(" ")
                i += 1
        lines = []
        for off in range(0, len(top), term_width):
            lines.append("".join(top[off:off + term_width]))
            lines.append("".join(mid[off:off + term_width]))
            lines.append("".join(bot[off:off + term_width]))
            lines.append("")
        return "\n".join(lines)

    def __str__(self):
        return self.render_term()

    def __repr__(self):
        return (
            "Alignment(score=%r, origin_start=%d, mutate_start=%d, "
            "transcript=%r)" % (
                self.score, self.origin_start, self.mutate_start,
                str(self.transcript),
            )
        )


class Aligner:
    """Affine-gap pairwise aligner (context manager, API parity with
    ``biseqt/pw.py — Aligner``).

    Usage::

        with Aligner(S, T, alnmode=BANDED_MODE, alntype=B_GLOBAL,
                     diag_range=(-10, 10), go_score=-3, ge_score=-1) as aln:
            score = aln.solve()
            alignment = aln.traceback()

    Where the reference allocated/free'd a C ``dptable`` in
    ``__enter__``/``__exit__``, here the table never exists — the DP runs as
    a row wavefront with O(W) live state; enter/exit only gate API misuse.
    """

    def __init__(self, origin, mutate, alnmode=STD_MODE, alntype=None,
                 subst_scores=None, match_score=1.0, mismatch_score=-1.0,
                 go_score=0.0, ge_score=-1.0, diag_range=None,
                 backend=None):
        assert isinstance(origin, Sequence) and isinstance(mutate, Sequence)
        assert origin.alphabet == mutate.alphabet
        self.origin = origin
        self.mutate = mutate
        self.alnmode = alnmode
        if alntype is None:
            alntype = GLOBAL if alnmode == STD_MODE else B_GLOBAL
        if alnmode == STD_MODE:
            assert alntype in STD_TYPES, "bad std alntype %r" % (alntype,)
            assert diag_range is None, "diag_range is for BANDED_MODE"
        else:
            assert alnmode == BANDED_MODE
            assert alntype in BANDED_TYPES, "bad banded alntype %r" % (alntype,)
            assert diag_range is not None, "BANDED_MODE needs diag_range"
            dmin, dmax = diag_range
            dmin, dmax = int(dmin), int(dmax)
            assert dmin <= dmax
            # clamp to meaningful diagonals
            dmin = max(dmin, -len(mutate))
            dmax = min(dmax, len(origin))
            assert dmin <= dmax, "band excludes the whole matrix"
            self.diag_range = (dmin, dmax)
        self.alntype = alntype
        A = len(origin.alphabet)
        if subst_scores is None:
            subst_scores = (
                np.full((A, A), float(mismatch_score))
                + np.eye(A) * (float(match_score) - float(mismatch_score))
            )
        self.subst_scores = np.asarray(subst_scores, dtype=np.float32)
        assert self.subst_scores.shape == (A, A)
        assert go_score <= 0, "gap open score must be <= 0"
        self.go_score = float(go_score)
        self.ge_score = float(ge_score)
        # None: the platform's engine (ops.engine.select_engine) for
        # banded problems, the lax full-matrix engine for STD_MODE
        assert backend in (None, "lax", "native", "cuda"), backend
        if backend == "cuda":
            assert alnmode == BANDED_MODE, "cuda backend is banded-only"
        self.backend = backend
        self._entered = False
        self._result = None

    # -- context manager (parity with the reference's alloc/free) ------------
    def __enter__(self):
        self._entered = True
        return self

    def __exit__(self, *exc):
        self._entered = False
        self._result = None
        return False

    # -- solve / traceback ----------------------------------------------------
    def solve(self):
        """Fill the DP wavefront; returns the optimal score (or None if the
        mode admits no alignment, e.g. a band missing the corner).

        Score-only: direction bytes are NOT materialized here (a STD_MODE
        solve of a 10 kbp pair would otherwise allocate a ~100 MB
        [LS, LT] byte array per call); :meth:`traceback` re-solves with
        direction bytes on demand and caches that result.
        """
        return self._solve(with_dirs=False)

    def _solve(self, with_dirs: bool):
        assert self._entered, "use Aligner as a context manager"
        if self.backend == "native":
            return self._solve_native()
        s, t, sl, tl = self._padded_codes()
        flags = _FLAGS[self.alntype]
        if self.alnmode == STD_MODE:
            res = full_dp(
                s, t, sl, tl, subst=self.subst_scores,
                go=self.go_score, ge=self.ge_score, flags=flags,
                with_dirs=with_dirs,
            )
            self._banded = False
            self._dmax = 0
        else:
            dmin, dmax = self.diag_range
            W = dmax - dmin + 1
            engine = self.backend
            if engine is None:
                engine = select_engine(
                    self.subst_scores, self.go_score, self.ge_score,
                    _bucket(W, mini=128), s.shape[1], t.shape[1])
            # the CUDA kernel takes whole 128-lane warps
            Wp = _bucket(W, mini=128 if engine == "cuda" else 16)
            res = ENGINES[engine](
                s, t, sl, tl,
                jnp.asarray([dmax - Wp + 1], jnp.int32), W=Wp,
                subst=self.subst_scores, go=self.go_score,
                ge=self.ge_score, flags=flags, with_dirs=with_dirs,
                w_eff=jnp.asarray([W], jnp.int32),
            )
            self._banded = True
            self._dmax = dmax
        self._result = res
        self._result_has_dirs = with_dirs
        score = float(res.score[0])
        if score <= -1e29:
            return None
        return score

    def _padded_codes(self):
        """[1, L]-shaped device code arrays + length vectors for the
        jitted engines, -1 (PAD) filled to bucketed shapes so repeated
        solves share compiled programs (every distinct (ls, lt) is
        otherwise a fresh compile); lengths ride alongside, so padding
        is semantically inert."""
        ls, lt = len(self.origin), len(self.mutate)
        ls_p, lt_p = _bucket(max(ls, 1)), _bucket(max(lt, 1))
        s = np.full((1, ls_p), -1, np.int8)
        s[0, :ls] = self.origin.to_array(np.int8)
        t = np.full((1, lt_p), -1, np.int8)
        t[0, :lt] = self.mutate.to_array(np.int8)
        return (jnp.asarray(s), jnp.asarray(t),
                jnp.asarray([ls], jnp.int32), jnp.asarray([lt], jnp.int32))

    def _solve_native(self):
        """Host-side solve via the C++ engine (same conventions/bytes)."""
        from . import native

        flags = _FLAGS[self.alntype]
        if self.alnmode == STD_MODE:
            dmin, dmax = -len(self.mutate), len(self.origin)
        else:
            dmin, dmax = self.diag_range
        score, ei, ej, dirs = native.align(
            self.origin.to_array(), self.mutate.to_array(),
            self.subst_scores, self.go_score, self.ge_score,
            dmin, dmax, flags, with_dirs=True,
        )
        self._banded = self.alnmode == BANDED_MODE
        self._dmax = dmax
        self._native_out = (score, ei, ej, dirs)
        self._result = "native"
        if score <= -1e29:
            return None
        return score

    def traceback(self):
        """Walk the stored direction bytes; returns an :class:`Alignment`."""
        assert self._result is not None, "call solve() first"
        if self.backend == "native":
            from . import native

            score, ei, ej, dirs = self._native_out
            if score <= -1e29:
                return None
            ops, si, sj = native.traceback(
                dirs, self._dmax, self.origin.to_array(),
                self.mutate.to_array(), ei, ej, _FLAGS[self.alntype],
            )
            return Alignment(
                self.origin, self.mutate, ops, score=score,
                origin_start=si, mutate_start=sj,
            )
        if float(self._result.score[0]) <= -1e29:
            return None
        if self.alnmode == STD_MODE and not self._result_has_dirs:
            # full-matrix mode: a materialized [LS, LT+1] byte plane is
            # ~100 MB at 10 kbp — use the checkpointed re-solve walk
            # (O(block_rows * LT) peak dirs memory, <= 2x compute)
            from .ops.banded_dp import full_dp_traceback

            res = self._result
            ls, lt = len(self.origin), len(self.mutate)
            ls_p, lt_p = _bucket(ls), _bucket(lt)
            s = np.full((1, ls_p), -1, np.int8)
            s[0, :ls] = self.origin.to_array(np.int8)
            t = np.full((1, lt_p), -1, np.int8)
            t[0, :lt] = self.mutate.to_array(np.int8)
            (tx, i0, j0), = full_dp_traceback(
                jnp.asarray(s), jnp.asarray(t),
                jnp.asarray([ls], jnp.int32), jnp.asarray([lt], jnp.int32),
                subst=self.subst_scores, go=self.go_score,
                ge=self.ge_score, flags=_FLAGS[self.alntype],
                end_i=np.asarray(res.end_i), end_j=np.asarray(res.end_j),
            )
            return Alignment(
                self.origin, self.mutate, tx, score=float(res.score[0]),
                origin_start=i0, mutate_start=j0,
            )
        if not self._result_has_dirs:
            # banded: re-solve with direction bytes (cached for repeated
            # traceback calls; the banded plane is O(LS * W) — small)
            self._solve(with_dirs=True)
        res = self._result
        flags = _FLAGS[self.alntype]
        tx, i0, j0 = traceback_path(
            np.asarray(res.dirs[0]),
            self.origin.to_array(), self.mutate.to_array(),
            int(res.end_i[0]), int(res.end_j[0]),
            banded=self._banded, dmax=self._dmax, flags=flags,
        )
        return Alignment(
            self.origin, self.mutate, tx, score=float(res.score[0]),
            origin_start=i0, mutate_start=j0,
        )
