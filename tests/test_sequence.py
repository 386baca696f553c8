"""Sequence/Alphabet/EditTranscript algebra tests (ref: tests/test_sequence.py)."""

import numpy as np
import pytest

from biseqt_jax.sequence import (
    Alphabet, Sequence, NamedSequence, EditTranscript, PAD,
    pack_sequences, unpack_sequence,
)

A4 = Alphabet("ACGT")


def test_alphabet_basics():
    assert len(A4) == 4
    assert A4[2] == "G"
    assert A4.letter_to_idx("ACG") == (0, 1, 2)
    assert A4 == Alphabet(["A", "C", "G", "T"])
    assert A4 != Alphabet("ACGN")
    with pytest.raises(ValueError):
        Alphabet([])
    with pytest.raises(ValueError):
        Alphabet(["A", "CC"])  # nonuniform letter length
    with pytest.raises(ValueError):
        Alphabet("AA")  # duplicate


def test_multicharacter_alphabet():
    A = Alphabet(["00", "01", "10", "11"])
    s = A.parse("000110")
    assert s.contents == (0, 1, 2)
    assert str(s) == "000110"
    with pytest.raises(ValueError):
        A.parse("000")  # not a multiple of letter length


def test_sequence_code_validation():
    """Out-of-range / non-integer codes raise ValueError BEFORE the int8
    narrowing (round-4 review finding: a cast-first check silently
    accepted 256 -> 'A' and 1.7 -> 'C')."""
    with pytest.raises(ValueError):
        Sequence(A4, np.array([256]))            # wraps to 0 if cast first
    with pytest.raises(ValueError):
        Sequence(A4, np.array([-1]))
    with pytest.raises(ValueError):
        Sequence(A4, np.array([1.7]))            # float truncation
    with pytest.raises(ValueError):
        Sequence(A4, (256,))                     # tuple path: ValueError,
    with pytest.raises(ValueError):              # not OverflowError
        Sequence(A4, (4,))
    with pytest.raises(ValueError):
        Sequence(A4, np.zeros((2, 2), np.int8))  # not 1-d
    assert str(Sequence(A4, np.array([0, 1, 2, 3], np.int64))) == "ACGT"
    # __add__ with a raw iterable validates BEFORE narrowing too
    # (round-4 review: a direct int8 asarray OverflowError'd/wrapped)
    with pytest.raises(ValueError):
        Sequence(A4, (0, 1)) + (256,)
    with pytest.raises(ValueError):
        Sequence(A4, (0, 1)) + (4,)
    assert str(Sequence(A4, (0, 1)) + (2, 3)) == "ACGT"


def test_sequence_algebra():
    s = A4.parse("ACGT")
    assert len(s) == 4
    assert s.contents == (0, 1, 2, 3)
    assert str(s) == "ACGT"
    assert s[1:3] == A4.parse("CG")
    assert s[0] == 0
    assert s + s == A4.parse("ACGTACGT")
    assert s.reverse() == A4.parse("TGCA")
    # complement via transform
    assert s.transform(["AT", "CG"]) == A4.parse("TGCA")
    # reverse complement
    assert s.reverse().transform(["AT", "CG"]) == A4.parse("ACGT").transform(
        ["AT", "CG"]
    ).reverse()


def test_content_id_stability():
    s1 = A4.parse("ACGTACGT")
    s2 = A4.parse("ACGTACGT")
    assert s1.content_id == s2.content_id
    assert s1.content_id != A4.parse("ACGTACGA").content_id
    # same text, different alphabet -> different id
    A = Alphabet("ACGTN")
    assert s1.content_id != A.parse("ACGTACGT").content_id


def test_named_sequence():
    s = NamedSequence(A4, (0, 1, 2), name="chr1")
    t = NamedSequence(A4, (0, 1, 2), name="chr2")
    assert s != t
    assert s.content_id != t.content_id
    assert s.reverse().name == "(reverse of chr1)"
    assert NamedSequence.wrap(A4.parse("ACG"), name="chr1") == s


def test_edit_transcript():
    tx = EditTranscript("MMSIDM")
    assert tx.origin_len == 5  # M,M,S,D,M
    assert tx.mutate_len == 5  # M,M,S,I,M
    assert tx[2] == "S"
    assert str(tx[:3]) == "MMS"
    assert str(tx + EditTranscript("MM")) == "MMSIDMMM"
    with pytest.raises(AssertionError):
        EditTranscript("MMX")


def test_pack_unpack_roundtrip(rng):
    seqs = [
        A4.parse("ACGT"),
        A4.parse("A"),
        A4.parse("GGTTGGTT"),
    ]
    codes, lengths = pack_sequences(seqs)
    assert codes.shape == (3, 8)
    assert lengths.tolist() == [4, 1, 8]
    assert codes[1, 1] == PAD
    for k, s in enumerate(seqs):
        assert unpack_sequence(A4, codes[k], lengths[k]) == s
        assert unpack_sequence(A4, codes[k]) == s  # infer length from PAD


def test_pack_pad_to_and_overflow():
    codes, lengths = pack_sequences([A4.parse("ACG")], pad_to=128)
    assert codes.shape == (1, 128)
    with pytest.raises(ValueError):
        pack_sequences([A4.parse("ACGT")], pad_to=2)
