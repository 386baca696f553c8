"""Native C++ engine tests: cross-check against the JAX engine + oracle."""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from biseqt_jax.sequence import Alphabet, pack_sequences
from biseqt_jax.stochastics import rand_seq, MutationProcess
from biseqt_jax.ops.banded_dp import banded_dp, ModeFlags, traceback_path
from biseqt_jax import native

from oracle import dp_oracle

A4 = Alphabet("ACGT")

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native engine unavailable (no g++?)"
)

FLAG_CASES = [
    ModeFlags(),
    ModeFlags(local_start=True, local_end=True),
    ModeFlags(free_start_edges=True, free_end_edges=True),
    ModeFlags(local_end=True),
    ModeFlags(local_start=True),
]


@pytest.mark.parametrize("flags", FLAG_CASES)
def test_native_matches_oracle(rng, flags):
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    for trial in range(5):
        M = MutationProcess(A4, subst_probs=0.2, go_prob=0.06, ge_prob=0.2,
                            rng=rng)
        S = rand_seq(A4, 40 + trial * 10, rng=rng)
        T, _ = M.mutate(S)
        s, t = S.to_array(), T.to_array()
        dmin, dmax = -20, 20
        score, ei, ej, _ = native.align(
            s, t, subst, -2.0, -1.0, dmin, dmax, flags
        )
        expect = dp_oracle(
            S.contents, T.contents, subst, -2.0, -1.0,
            dmin=dmin, dmax=dmax,
            free_start_edges=flags.free_start_edges,
            local_start=flags.local_start,
            free_end_edges=flags.free_end_edges,
            local_end=flags.local_end,
        )
        assert score == pytest.approx(expect, abs=1e-3), (flags, trial)


@pytest.mark.parametrize("flags", FLAG_CASES[:3])
def test_native_traceback_rescores(rng, flags):
    subst = np.where(np.eye(4, dtype=bool), 2.0, -1.0).astype(np.float32)
    go, ge = -3.0, -1.0
    for trial in range(4):
        M = MutationProcess(A4, subst_probs=0.15, go_prob=0.05,
                            ge_prob=0.2, rng=rng)
        S = rand_seq(A4, 60, rng=rng)
        T, _ = M.mutate(S)
        s, t = S.to_array(), T.to_array()
        dmin, dmax = -25, 25
        score, ei, ej, dirs = native.align(
            s, t, subst, go, ge, dmin, dmax, flags, with_dirs=True
        )
        if score <= -1e29:
            continue
        ops, si, sj = native.traceback(dirs, dmax, s, t, ei, ej, flags)
        # re-score the transcript
        total, i, j, prev = 0.0, si, sj, None
        for op in ops:
            if op in "MS":
                total += subst[s[i], t[j]]
                i += 1
                j += 1
            else:
                total += ge + (go if prev != op else 0.0)
                if op == "I":
                    j += 1
                else:
                    i += 1
            prev = op
        assert (i, j) == (ei, ej)
        assert total == pytest.approx(score, abs=1e-3), (flags, trial, ops)


def test_native_dirs_compatible_with_lax_walker(rng):
    """Direction bytes from the native engine feed the python walker."""
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    S = rand_seq(A4, 50, rng=rng)
    M = MutationProcess(A4, subst_probs=0.1, go_prob=0.04, ge_prob=0.2,
                        rng=rng)
    T, _ = M.mutate(S)
    flags = ModeFlags()
    dmin, dmax = -20, 20
    score, ei, ej, dirs = native.align(
        S.to_array(), T.to_array(), subst, -2.0, -1.0, dmin, dmax, flags,
        with_dirs=True,
    )
    tx, i0, j0 = traceback_path(
        dirs, S.to_array(), T.to_array(), ei, ej,
        banded=True, dmax=dmax, flags=flags,
    )
    ops, si, sj = native.traceback(
        dirs, dmax, S.to_array(), T.to_array(), ei, ej, flags
    )
    assert (i0, j0) == (si, sj)
    assert tx == ops


def test_fasta_pack(tmp_path):
    p = str(tmp_path / "x.fa")
    with open(p, "w") as f:
        f.write(">read1 some description\nACGTacgt\nGG GG\n>read2\nTTTT\n")
    codes, offsets, lengths, names, header_pos = native.fasta_pack(p)
    assert names == ["read1", "read2"]
    assert lengths.tolist() == [12, 4]  # whitespace dropped, case folded
    assert header_pos.tolist() == [0, 39]  # byte offsets of the '>'s
    r1 = codes[offsets[0]:offsets[0] + lengths[0]]
    assert r1.tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 2, 2, 2, 2]
    r2 = codes[offsets[1]:offsets[1] + lengths[1]]
    assert r2.tolist() == [3, 3, 3, 3]


def test_fasta_pack_unknown_letter_raises(tmp_path):
    """An unmapped base must raise, never silently skip: a dropped
    letter shifts every downstream coordinate of the record."""
    import pytest

    p = str(tmp_path / "bad.fa")
    with open(p, "w") as f:
        f.write(">r\nACGTNACGT\n")
    with pytest.raises(ValueError, match="'N'"):
        native.fasta_pack(p)
    # mapping the ambiguity code explicitly is the opt-in
    cm = native.dna_code_map("ACGTN")
    codes, _, lengths, _, _ = native.fasta_pack(p, cm)
    assert lengths.tolist() == [9]
    assert codes.tolist() == [0, 1, 2, 3, 4, 0, 1, 2, 3]


def test_aligner_native_backend_matches_lax(rng):
    from biseqt_jax import pw
    from biseqt_jax.pw import Aligner

    M = MutationProcess(A4, subst_probs=0.12, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    for alnmode, alntype, kw in (
        (pw.STD_MODE, pw.GLOBAL, {}),
        (pw.STD_MODE, pw.LOCAL, {}),
        (pw.BANDED_MODE, pw.B_OVERLAP, {"diag_range": (-15, 15)}),
    ):
        S = rand_seq(A4, 45, rng=rng)
        T, _ = M.mutate(S)
        with Aligner(S, T, alnmode=alnmode, alntype=alntype,
                     go_score=-2.0, ge_score=-1.0, **kw) as a_lax:
            s_lax = a_lax.solve()
            tx_lax = a_lax.traceback()
        with Aligner(S, T, alnmode=alnmode, alntype=alntype,
                     go_score=-2.0, ge_score=-1.0, backend="native",
                     **kw) as a_nat:
            s_nat = a_nat.solve()
            tx_nat = a_nat.traceback()
        assert s_nat == pytest.approx(s_lax, abs=1e-3), (alnmode, alntype)
        if tx_lax is not None:
            assert tx_nat.calculate_score(
                a_nat.subst_scores, -2.0, -1.0
            ) == pytest.approx(s_lax, abs=1e-3)


def test_abi_version_gate():
    """The loader hard-fails on an ABI mismatch instead of warning.

    A stale .so called through newer ctypes argtypes shifts every
    pointer argument — silent memory corruption — so _load() must
    refuse, not warn (round-4 advisor finding).
    """
    import ctypes
    import biseqt_jax.native as native
    if not native.available():
        pytest.skip("native library unavailable")
    lib = ctypes.CDLL(native._SO)
    assert int(lib.bst_abi_version()) == native._ABI_VERSION
    # simulate a stale binary: expect a hard RuntimeError, not a warning
    old_lib, old_ver = native._lib, native._ABI_VERSION
    try:
        native._lib = None
        native._ABI_VERSION = old_ver + 1
        with pytest.raises(RuntimeError, match="ABI version"):
            native._load()
    finally:
        native._lib, native._ABI_VERSION = old_lib, old_ver
