"""DB tests against :memory: SQLite (ref strategy: tests/test_database.py)."""

import io

import pytest

from biseqt_jax.sequence import Alphabet, NamedSequence
from biseqt_jax.database import DB, Record, read_fasta, write_fasta
from biseqt_jax.stochastics import rand_seq

A4 = Alphabet("ACGT")

FASTA = """>chr1 description here
ACGTACGTAC
GTACGT
>chr2
TTTTGGGG
"""


def test_read_fasta():
    recs = list(read_fasta(io.StringIO(FASTA), A4))
    assert len(recs) == 2
    (s1, p1), (s2, p2) = recs
    assert s1.name == "chr1" and str(s1) == "ACGTACGTACGTACGT"
    assert s2.name == "chr2" and str(s2) == "TTTTGGGG"
    assert p1 == 0 and p2 > 0
    # num limit
    assert len(list(read_fasta(io.StringIO(FASTA), A4, num=1))) == 1


def test_write_read_roundtrip(tmp_path):
    seqs = [NamedSequence(A4, rand_seq(A4, 50, rng=7).contents, name="a"),
            NamedSequence(A4, rand_seq(A4, 33, rng=8).contents, name="b")]
    p = str(tmp_path / "out.fa")
    write_fasta(p, seqs, width=20)
    back = [s for s, _ in read_fasta(p, A4)]
    assert back == seqs


def test_insert_and_find():
    db = DB(":memory:", A4)
    s = NamedSequence(A4, A4.parse("ACGTACGT").contents, name="x")
    rec = db.insert(s, attrs={"k": 1})
    assert isinstance(rec, Record)
    assert rec.content_id == s.content_id
    # duplicate insert is a no-op
    assert db.insert(s) is None
    assert len(db) == 1
    found = list(db.find())
    assert found[0].content_id == s.content_id
    assert found[0].attrs["k"] == 1
    # contents round-trip through the packed pool
    assert db.load_from_record(found[0]) == s


def test_load_fasta_and_events():
    db = DB(":memory:", A4)
    seen = []
    db.add_event_listener(
        "sequence-inserted", lambda db_, rec, seq: seen.append(seq.name)
    )
    recs = db.load_fasta(io.StringIO(FASTA))
    assert len(recs) == 2
    assert seen == ["chr1", "chr2"]
    assert {r.attrs["name"] for r in recs} == {"chr1", "chr2"}


def test_load_fasta_rc():
    db = DB(":memory:", A4)
    recs = db.load_fasta(io.StringIO(">a\nAACG\n"), rc=True)
    assert len(recs) == 2
    fwd, rc = recs
    rc_seq = db.load_from_record(rc)
    assert str(rc_seq) == "CGTT"
    assert rc.attrs["rc_of"] == fwd.content_id


def test_on_disk_db(tmp_path):
    p = str(tmp_path / "db.sqlite")
    db = DB(p, A4)
    s = A4.parse("ACGTACGTAA")
    db.insert(s)
    db.close()
    db2 = DB(p, A4)
    recs = list(db2.find())
    assert len(recs) == 1
    assert db2.load_from_record(recs[0]).contents == s.contents


def test_packed_batch():
    db = DB(":memory:", A4)
    db.load_fasta(io.StringIO(FASTA))
    (codes, lengths), recs = db.packed_batch()
    assert codes.shape[0] == 2
    assert lengths.tolist() == [16, 8]


def test_fasta_ingest_native_matches_python(tmp_path):
    """The C++ packer tier and the Python reader produce IDENTICAL
    records: content ids, names, source byte offsets, sequences."""
    p = str(tmp_path / "g.fa")
    with open(p, "w") as f:
        # lowercase + internal whitespace exercise the letter semantics
        f.write(">a desc\nACGT\nacg t\n>b\nTT\nGG\n")
    db_native = DB(":memory:", A4)
    recs_n = db_native.load_fasta(p)          # str path + num<0 -> native
    db_py = DB(":memory:", A4)
    with open(p) as f:                        # file object -> Python reader
        recs_p = db_py.load_fasta(f, source_file=p)
    assert len(recs_n) == len(recs_p) == 2
    for rn, rp in zip(recs_n, recs_p):
        assert rn.content_id == rp.content_id
        assert rn.source_pos == rp.source_pos
        assert rn.attrs["name"] == rp.attrs["name"]
        assert db_native.load_from_record(rn) == db_py.load_from_record(rp)
    assert str(db_native.load_from_record(recs_n[0])) == "ACGTACGT"


def test_fasta_ingest_edge_semantics_parity(tmp_path):
    """Degenerate FASTA shapes parse IDENTICALLY in both tiers (round-4
    review findings: the native scanner treated '>' ANYWHERE as a record
    start, kept CRLF '\\r' in names, dropped '> name' tokens, and raised
    on pre-header junk the Python reader silently discards)."""
    cases = [
        # '>' inside a description is NOT a record start
        (b">read1 len>500\nACGT\n", [("read1", "ACGT", 0)]),
        # CRLF: '\r' never enters the name or the sequence
        (b">seq1\r\nACGT\r\nGGTT\r\n", [("seq1", "ACGTGGTT", 0)]),
        # leading blank after '>' is skipped, first token is the name
        (b"> chr1\nACGT\n", [("chr1", "ACGT", 0)]),
        # pre-header junk lines are discarded unparsed (never raise)
        (b"; comment\nrandom junk\n>r1\nACGT\n", [("r1", "ACGT", 22)]),
        # '>' inside the name token is part of the name
        (b">a>b desc\nAC\n", [("a>b", "AC", 0)]),
        # header indented by whitespace; source_pos is the LINE start
        (b"  >ind\nACGT\n", [("ind", "ACGT", 0)]),
        # empty record between two headers
        (b">e1\n>e2\nAC\n", [("e1", "", 0), ("e2", "AC", 4)]),
        # \v / \f are Python str whitespace: dropped in sequence data,
        # and a \f-indented '>' is still a header (round-4 review:
        # the native fasta_blank only covered \r, space, \t)
        (b">r1\nAC\x0bGT\n\x0c>r2\nGG\x0cTT\n",
         [("r1", "ACGT", 0), ("r2", "GGTT", 10)]),
    ]
    for k, (data, want) in enumerate(cases):
        p = str(tmp_path / ("edge%d.fa" % k))
        with open(p, "wb") as f:
            f.write(data)
        for tier in ("native", "python"):
            db = DB(":memory:", A4)
            if tier == "native":
                recs = db.load_fasta(p)
            else:
                with open(p) as f:
                    recs = db.load_fasta(f, source_file=p)
            got = [(r.attrs["name"], str(db.load_from_record(r)),
                    r.source_pos) for r in recs]
            assert got == want, (tier, k, got, want)


def test_fasta_ingest_unknown_letter_raises_both_paths(tmp_path):
    """Ambiguity codes raise in BOTH ingest tiers (never silent skip —
    a dropped base shifts every downstream coordinate)."""
    p = str(tmp_path / "bad.fa")
    with open(p, "w") as f:
        f.write(">r\nACGTNACGT\n")
    with pytest.raises(ValueError):
        DB(":memory:", A4).load_fasta(p)               # native tier
    with open(p) as f:
        with pytest.raises(ValueError):
            DB(":memory:", A4).load_fasta(f)           # Python reader
    # a mid-line '>' in sequence data is an unmapped LETTER, not a
    # record start — both tiers raise
    p2 = str(tmp_path / "bad2.fa")
    with open(p2, "w") as f:
        f.write(">r\nAC>GT\n")
    with pytest.raises(ValueError):
        DB(":memory:", A4).load_fasta(p2)
    with open(p2) as f:
        with pytest.raises(ValueError):
            DB(":memory:", A4).load_fasta(f)


def test_find_sql_condition():
    db = DB(":memory:", A4)
    db.load_fasta(io.StringIO(FASTA))
    out = list(db.find(sql_condition="length > 10"))
    assert len(out) == 1
    assert out[0].attrs["name"] == "chr1"


def test_load_fasta_rc_requires_complement_letters():
    # default ['AT','CG'] map on an alphabet missing T: descriptive
    # ValueError BEFORE any record is inserted (used to be a bare
    # KeyError three frames down, after forward inserts)
    db = DB(":memory:", Alphabet("ACGU"))
    with pytest.raises(ValueError, match="lacks letter"):
        db.load_fasta(io.StringIO(">a\nACGU\n"), rc=True)
    assert len(db) == 0
    # explicit complement_map unblocks non-DNA alphabets
    recs = db.load_fasta(io.StringIO(">a\nAACG\n"), rc=True,
                         complement_map=["AU", "CG"])
    assert len(recs) == 2
    assert str(db.load_from_record(recs[1])) == "CGUU"
    # invalid explicit map: ValueError naming the map, nothing inserted
    db2 = DB(":memory:", A4)
    with pytest.raises(ValueError, match="complement_map"):
        db2.load_fasta(io.StringIO(">a\nAACG\n"), rc=True,
                       complement_map=["AZ"])
    assert len(db2) == 0
    # integer-code maps: a negative code would silently wrap via list
    # indexing (remapping the LAST letter) and then blow up mid-ingest
    # with forward records already inserted; an out-of-range positive
    # used to escape as a bare IndexError — both must be the same
    # descriptive up-front ValueError with nothing inserted
    for bad_map in ({-1: 0}, {5: 0}):
        db3 = DB(":memory:", A4)
        with pytest.raises(ValueError, match="complement_map"):
            db3.load_fasta(io.StringIO(">a\nAACG\n"), rc=True,
                           complement_map=bad_map)
        assert len(db3) == 0


def test_load_fasta_rc_keeps_unmapped_letters_fixed():
    # ACGTN alphabet: default map is valid (N self-maps, coordinates
    # keep their meaning)
    db = DB(":memory:", Alphabet("ACGTN"))
    recs = db.load_fasta(io.StringIO(">a\nACGTN\n"), rc=True)
    assert str(db.load_from_record(recs[1])) == "NACGT"
