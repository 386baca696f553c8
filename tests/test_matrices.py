"""Protein substitution matrices + end-to-end protein alignment.

The reference's C engine accepts any matrix over any alphabet
(``pwlib — alnscores``); these tests pin the shipped BLOSUM62/PAM250
constants (symmetry/diagonals assert at import) and drive the full
protein path: matrices -> the engine selection rule (integer scores take
the CUDA kernel on a GPU) -> Aligner scores vs the numpy oracle ->
transcript re-scoring.
"""

import pytest

from biseqt_jax import pw
from biseqt_jax.matrices import (BLOSUM62, PAM250, PROTEIN_LETTERS,
                                 protein_alphabet)
from biseqt_jax.ops import cuda_dp, engine
from biseqt_jax.pw import Aligner
from biseqt_jax.stochastics import MutationProcess, rand_seq

from oracle import dp_oracle

IDX = {c: i for i, c in enumerate(PROTEIN_LETTERS)}


def test_matrix_landmarks():
    """Pin well-known off-diagonal entries of the published matrices
    (symmetry and the diagonals are asserted at module import)."""
    for m, pairs in (
            (BLOSUM62, {("A", "R"): -1, ("W", "F"): 1, ("Y", "F"): 3,
                        ("I", "V"): 3, ("H", "Y"): 2, ("E", "D"): 2,
                        ("K", "R"): 2, ("S", "T"): 1, ("W", "C"): -2}),
            (PAM250, {("W", "C"): -8, ("F", "Y"): 7, ("K", "R"): 3,
                      ("D", "E"): 3, ("W", "R"): 2, ("L", "M"): 4}),
    ):
        for (a, b), v in pairs.items():
            assert m[IDX[a], IDX[b]] == v, (a, b)
            assert m[IDX[b], IDX[a]] == v, (b, a)


def test_matrices_take_the_packed_kernel_route(monkeypatch):
    """Both shipped matrices are integer-valued, so with their classic
    gap scores the selector routes them to the CUDA kernel on a GPU."""
    monkeypatch.setattr(cuda_dp, "load", lambda: None)
    for subst, go, ge in ((BLOSUM62, -11.0, -1.0), (PAM250, -10.0, -2.0)):
        assert cuda_dp.supports(subst, go, ge, 256, 2048, 2048)
        assert engine.select_engine(subst, go, ge, 256, 2048, 2048,
                                    platform="gpu") == "cuda"


@pytest.mark.parametrize("subst,go,ge", [
    (BLOSUM62, -11.0, -1.0),   # classic BLAST-style gap penalties
    (PAM250, -10.0, -2.0),
])
def test_protein_alignment_matches_oracle(rng, subst, go, ge):
    P = protein_alphabet()
    S = rand_seq(P, 80, rng=rng)
    M = MutationProcess(P, subst_probs=0.08, go_prob=0.04, ge_prob=0.2,
                        rng=rng)
    T, _ = M.mutate(S)
    with Aligner(S, T, alnmode=pw.STD_MODE, alntype=pw.GLOBAL,
                 subst_scores=subst, go_score=go, ge_score=ge) as aln:
        score = aln.solve()
        expect = dp_oracle(S.contents, T.contents, subst, go, ge)
        assert score == pytest.approx(expect, abs=1e-3)
        alignment = aln.traceback()
        rescored = alignment.calculate_score(subst, go, ge)
        assert rescored == pytest.approx(score, abs=1e-3)


def test_protein_banded_default_backend_matches_native(rng):
    """BLOSUM62 banded through the Aligner's platform-selected engine
    agrees with the C++ engine, and its transcript rescores exactly."""
    from biseqt_jax import native

    if not native.available():
        pytest.skip("native library unavailable")
    P = protein_alphabet()
    S = rand_seq(P, 90, rng=rng)
    M = MutationProcess(P, subst_probs=0.1, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    T, _ = M.mutate(S)
    d0 = len(S) - len(T)
    kw = dict(alnmode=pw.BANDED_MODE, alntype=pw.B_GLOBAL,
              diag_range=(min(d0, 0) - 10, max(d0, 0) + 10),
              subst_scores=BLOSUM62, go_score=-11.0, ge_score=-1.0)
    with Aligner(S, T, backend="native", **kw) as aln:
        ref = aln.solve()
    with Aligner(S, T, **kw) as aln:
        got = aln.solve()
        tx = aln.traceback()
    assert got == ref
    assert tx.calculate_score(BLOSUM62, -11.0, -1.0) == got
