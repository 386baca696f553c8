"""Standard protein substitution matrices + alphabet.

The reference derives substitution scores from a mutation model
(``biseqt/stochastics.py — MutationProcess.log_odds_scores``) and its C
engine (``pwlib — alnscores``) accepts ANY matrix over any alphabet.
This module ships the two classic published matrices so the protein
path is usable out of the box: pass ``subst_scores=BLOSUM62`` (with
sequences over :func:`protein_alphabet`) to :class:`biseqt_jax.pw.Aligner`.

Both matrices are integer-valued, so with integer gap scores the engine
selector sends them to the CUDA kernel on a GPU
(``ops/cuda_dp.supports``).

Values are the standard published matrices (Henikoff & Henikoff 1992
BLOSUM62; Dayhoff 1978 PAM250 log-odds at scale 10/3), transcribed in
the conventional ``ARNDCQEGHILKMFPSTWYV`` residue order.  Validation:
both are symmetric with the canonical diagonals (asserted at import
and pinned in ``tests/test_matrices.py``).
"""

from __future__ import annotations

import numpy as np

from .sequence import Alphabet

__all__ = ["PROTEIN_LETTERS", "protein_alphabet", "BLOSUM62", "PAM250",
           "DAYHOFF6_GROUPS", "MURPHY10_GROUPS", "MURPHY4_GROUPS",
           "compression_map",
           "reduced_alphabet", "reduced_matrix"]

#: Canonical residue order used by both matrices.
PROTEIN_LETTERS = "ARNDCQEGHILKMFPSTWYV"


def protein_alphabet() -> Alphabet:
    """The 20-letter amino-acid alphabet in matrix row order, so letter
    codes index :data:`BLOSUM62` / :data:`PAM250` directly."""
    return Alphabet(PROTEIN_LETTERS)


# BLOSUM62 (half-bit units), rows/cols in PROTEIN_LETTERS order.
BLOSUM62 = np.array([
    #  A   R   N   D   C   Q   E   G   H   I   L   K   M   F   P   S   T   W   Y   V
    [  4, -1, -2, -2,  0, -1, -1,  0, -2, -1, -1, -1, -1, -2, -1,  1,  0, -3, -2,  0],  # A
    [ -1,  5,  0, -2, -3,  1,  0, -2,  0, -3, -2,  2, -1, -3, -2, -1, -1, -3, -2, -3],  # R
    [ -2,  0,  6,  1, -3,  0,  0,  0,  1, -3, -3,  0, -2, -3, -2,  1,  0, -4, -2, -3],  # N
    [ -2, -2,  1,  6, -3,  0,  2, -1, -1, -3, -4, -1, -3, -3, -1,  0, -1, -4, -3, -3],  # D
    [  0, -3, -3, -3,  9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1],  # C
    [ -1,  1,  0,  0, -3,  5,  2, -2,  0, -3, -2,  1,  0, -3, -1,  0, -1, -2, -1, -2],  # Q
    [ -1,  0,  0,  2, -4,  2,  5, -2,  0, -3, -3,  1, -2, -3, -1,  0, -1, -3, -2, -2],  # E
    [  0, -2,  0, -1, -3, -2, -2,  6, -2, -4, -4, -2, -3, -3, -2,  0, -2, -2, -3, -3],  # G
    [ -2,  0,  1, -1, -3,  0,  0, -2,  8, -3, -3, -1, -2, -1, -2, -1, -2, -2,  2, -3],  # H
    [ -1, -3, -3, -3, -1, -3, -3, -4, -3,  4,  2, -3,  1,  0, -3, -2, -1, -3, -1,  3],  # I
    [ -1, -2, -3, -4, -1, -2, -3, -4, -3,  2,  4, -2,  2,  0, -3, -2, -1, -2, -1,  1],  # L
    [ -1,  2,  0, -1, -3,  1,  1, -2, -1, -3, -2,  5, -1, -3, -1,  0, -1, -3, -2, -2],  # K
    [ -1, -1, -2, -3, -1,  0, -2, -3, -2,  1,  2, -1,  5,  0, -2, -1, -1, -1, -1,  1],  # M
    [ -2, -3, -3, -3, -2, -3, -3, -3, -1,  0,  0, -3,  0,  6, -4, -2, -2,  1,  3, -1],  # F
    [ -1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4,  7, -1, -1, -4, -3, -2],  # P
    [  1, -1,  1,  0, -1,  0,  0,  0, -1, -2, -2,  0, -1, -2, -1,  4,  1, -3, -2, -2],  # S
    [  0, -1,  0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1,  1,  5, -2, -2,  0],  # T
    [ -3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1,  1, -4, -3, -2, 11,  2, -3],  # W
    [ -2, -2, -2, -3, -2, -1, -2, -3,  2, -1, -1, -2, -1,  3, -3, -2, -2,  2,  7, -1],  # Y
    [  0, -3, -3, -3, -1, -2, -2, -3, -3,  3,  1, -2,  1, -1, -2, -2,  0, -3, -1,  4],  # V
], dtype=np.float32)

# PAM250 (log-odds, scale 10/3), rows/cols in PROTEIN_LETTERS order.
PAM250 = np.array([
    #  A   R   N   D   C   Q   E   G   H   I   L   K   M   F   P   S   T   W   Y   V
    [  2, -2,  0,  0, -2,  0,  0,  1, -1, -1, -2, -1, -1, -3,  1,  1,  1, -6, -3,  0],  # A
    [ -2,  6,  0, -1, -4,  1, -1, -3,  2, -2, -3,  3,  0, -4,  0,  0, -1,  2, -4, -2],  # R
    [  0,  0,  2,  2, -4,  1,  1,  0,  2, -2, -3,  1, -2, -3,  0,  1,  0, -4, -2, -2],  # N
    [  0, -1,  2,  4, -5,  2,  3,  1,  1, -2, -4,  0, -3, -6, -1,  0,  0, -7, -4, -2],  # D
    [ -2, -4, -4, -5, 12, -5, -5, -3, -3, -2, -6, -5, -5, -4, -3,  0, -2, -8,  0, -2],  # C
    [  0,  1,  1,  2, -5,  4,  2, -1,  3, -2, -2,  1, -1, -5,  0, -1, -1, -5, -4, -2],  # Q
    [  0, -1,  1,  3, -5,  2,  4,  0,  1, -2, -3,  0, -2, -5, -1,  0,  0, -7, -4, -2],  # E
    [  1, -3,  0,  1, -3, -1,  0,  5, -2, -3, -4, -2, -3, -5,  0,  1,  0, -7, -5, -1],  # G
    [ -1,  2,  2,  1, -3,  3,  1, -2,  6, -2, -2,  0, -2, -2,  0, -1, -1, -3,  0, -2],  # H
    [ -1, -2, -2, -2, -2, -2, -2, -3, -2,  5,  2, -2,  2,  1, -2, -1,  0, -5, -1,  4],  # I
    [ -2, -3, -3, -4, -6, -2, -3, -4, -2,  2,  6, -3,  4,  2, -3, -3, -2, -2, -1,  2],  # L
    [ -1,  3,  1,  0, -5,  1,  0, -2,  0, -2, -3,  5,  0, -5, -1,  0,  0, -3, -4, -2],  # K
    [ -1,  0, -2, -3, -5, -1, -2, -3, -2,  2,  4,  0,  6,  0, -2, -2, -1, -4, -2,  2],  # M
    [ -3, -4, -3, -6, -4, -5, -5, -5, -2,  1,  2, -5,  0,  9, -5, -3, -3,  0,  7, -1],  # F
    [  1,  0,  0, -1, -3,  0, -1,  0,  0, -2, -3, -1, -2, -5,  6,  1,  0, -6, -5, -1],  # P
    [  1,  0,  1,  0,  0, -1,  0,  1, -1, -1, -3,  0, -2, -3,  1,  2,  1, -2, -3, -1],  # S
    [  1, -1,  0,  0, -2, -1,  0,  0, -1,  0, -2,  0, -1, -3,  0,  1,  3, -5, -3,  0],  # T
    [ -6,  2, -4, -7, -8, -5, -7, -7, -3, -5, -2, -3, -4,  0, -6, -2, -5, 17,  0, -6],  # W
    [ -3, -4, -2, -4,  0, -4, -4, -5,  0, -1, -1, -4, -2,  7, -5, -3, -3,  0, 10, -2],  # Y
    [  0, -2, -2, -2, -2, -2, -2, -1, -2,  4,  2, -2,  2, -1, -1, -1,  0, -6, -2,  4],  # V
], dtype=np.float32)


# ---------------------------------------------------------------------------
# Reduced alphabets: the filter tier of the two-tier protein search and
# the denser codes of reduced-alphabet discovery.  Compressing A=20 -> 6
# or 10 groups gives a cheap filter pass; survivors are rescored with the
# full matrix (see biseqt_jax/protein.py).  Reference contract:
# ``pwlib — alnscores`` serves any matrix.
# ---------------------------------------------------------------------------

#: Dayhoff (1978) six chemical groups: small, cysteine, acid/amide,
#: aromatic, basic, hydrophobic.
DAYHOFF6_GROUPS = ("AGPST", "C", "DENQ", "FWY", "HKR", "ILMV")

#: Murphy, Wang & Thirumalai (2000) ten-group BLOSUM-clustered reduction.
MURPHY10_GROUPS = ("LVIM", "C", "A", "G", "S", "T", "P", "FYW", "EDNQ",
                   "KRH")

#: Murphy et al. (2000) four-group reduction (hydrophobic, small,
#: aromatic, polar/charged).  A=4 rides the kernel's fastest general-
#: substitution path (the A^2 select chain, 45.8 GCUPS) — the speed
#: pick for the two-tier filter when its coarser selectivity suffices.
MURPHY4_GROUPS = ("LVIMC", "ASGTP", "FYW", "EDNQKRH")


def _check_partition(groups) -> None:
    joined = "".join(groups)
    if sorted(joined) != sorted(PROTEIN_LETTERS):
        raise ValueError(
            "groups must partition the 20 amino acids exactly; got %r"
            % (groups,))


def compression_map(groups=DAYHOFF6_GROUPS) -> np.ndarray:
    """int8 [20] table mapping a full protein letter code (row index of
    :data:`BLOSUM62`, i.e. :func:`protein_alphabet` codes) to its group
    code.  Apply with ``np.where(codes < 0, codes, cmap[codes])`` so PAD
    sentinels pass through."""
    _check_partition(groups)
    cmap = np.empty(len(PROTEIN_LETTERS), np.int8)
    for g, members in enumerate(groups):
        for ch in members:
            cmap[PROTEIN_LETTERS.index(ch)] = g
    return cmap


def reduced_alphabet(groups=DAYHOFF6_GROUPS) -> Alphabet:
    """Alphabet whose letter g is group g's first member (all standard
    groupings have distinct first letters)."""
    _check_partition(groups)
    firsts = [g[0] for g in groups]
    if len(set(firsts)) != len(firsts):
        raise ValueError("group first letters must be distinct: %r"
                         % (firsts,))
    return Alphabet("".join(firsts))


def reduced_matrix(subst=None, groups=DAYHOFF6_GROUPS) -> np.ndarray:
    """Group-level substitution matrix: entry (g, h) is the mean of
    ``subst`` over member pairs, rounded to the nearest integer so the
    kernel's integer-grid packed-planes detection still fires.  Default
    ``subst`` is :data:`BLOSUM62`."""
    if subst is None:
        subst = BLOSUM62
    _check_partition(groups)
    G = len(groups)
    idx = [[PROTEIN_LETTERS.index(ch) for ch in g] for g in groups]
    out = np.empty((G, G), np.float32)
    for g in range(G):
        for h in range(G):
            out[g, h] = np.mean(subst[np.ix_(idx[g], idx[h])])
    return np.round(out).astype(np.float32)


def _validate():
    for name, m, diag in (
            ("BLOSUM62", BLOSUM62,
             [4, 5, 6, 6, 9, 5, 5, 6, 8, 4, 4, 5, 5, 6, 7, 4, 5, 11, 7, 4]),
            ("PAM250", PAM250,
             [2, 6, 2, 4, 12, 4, 4, 5, 6, 5, 6, 5, 6, 9, 6, 2, 3, 17, 10, 4]),
    ):
        if m.shape != (20, 20) or not np.array_equal(m, m.T):
            raise AssertionError(f"{name} must be symmetric 20x20")
        if not np.array_equal(np.diagonal(m), np.asarray(diag, m.dtype)):
            raise AssertionError(f"{name} diagonal mismatch")


_validate()
