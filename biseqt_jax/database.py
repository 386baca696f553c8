"""Sequence database: SQLite-metadata + packed-array store, FASTA ingest.

Rebuild of ``biseqt/database.py — DB, Record`` with the same contract
(content-addressed records, JSON attrs, FASTA ingestion with optional
reverse-complement records, event hooks) but an accelerator-era storage split:

  * metadata (ids, names, source positions, attrs) lives in SQLite —
    stdlib, transactional, perfectly good for host-side bookkeeping;
  * sequence *contents* are stored as packed int8 code arrays in a sidecar
    ``.npz`` pool so the compute path can memory-map straight into
    device-ready buffers instead of re-parsing text (the reference stored
    letter text in SQLite rows and re-parsed on every load).
"""

from __future__ import annotations

import json
import os
import sqlite3
from collections import namedtuple
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from .sequence import Alphabet, NamedSequence, Sequence, _mapping_table

__all__ = ["DB", "Record", "read_fasta", "write_fasta"]


Record = namedtuple(
    "Record", ["id", "content_id", "source_file", "source_pos", "attrs"]
)
"""A stored sequence's metadata row (mirrors the reference's Record)."""


def read_fasta(path_or_file, alphabet: Alphabet, num: int = -1):
    """Lazily parse FASTA; yields ``(NamedSequence, pos)`` tuples.

    ``pos`` is the byte offset of the record's header line.  Letters not in
    the alphabet raise ValueError (parity with the reference's strictness).
    """
    own = False
    f = path_or_file
    if isinstance(path_or_file, str):
        # binary mode: source_pos is a BYTE offset, and universal-newline
        # text mode silently shrinks \r\n to \n (every offset after a
        # CRLF line would be short by the cumulative line count)
        f = open(path_or_file, "rb")
        own = True
    try:
        name, chunks, pos, count = None, [], 0, 0
        offset = 0
        line_start = 0
        for line in f:
            line_start = offset
            offset += len(line)
            if isinstance(line, bytes):
                # lenient decode: headers are metadata and may carry
                # non-ASCII description bytes; sequence letters are
                # validated downstream by the alphabet parse anyway
                line = line.decode("ascii", "replace")
            line_s = line.strip()
            if line_s.startswith(">"):
                if name is not None:
                    yield _mk_named(alphabet, name, chunks), pos
                    count += 1
                    if 0 <= num == count:
                        return
                name = line_s[1:].split()[0] if len(line_s) > 1 else ""
                chunks = []
                pos = line_start
            elif line_s:
                # drop ALL whitespace in sequence data (not just line
                # edges) — identical to the native packer's semantics,
                # so the two ingest paths agree byte-for-byte
                chunks.append("".join(line_s.split()))
        if name is not None:
            yield _mk_named(alphabet, name, chunks), pos
    finally:
        if own:
            f.close()


def _mk_named(alphabet, name, chunks):
    seq = alphabet.parse("".join(chunks).upper())
    return NamedSequence(alphabet, seq.to_array(np.int8), name=name)


def write_fasta(f, seqs: Iterable[Sequence], width: int = 80):
    """Write sequences as FASTA (names used when present)."""
    own = False
    if isinstance(f, str):
        f = open(f, "w")
        own = True
    try:
        for k, s in enumerate(seqs):
            name = getattr(s, "name", "") or ("seq%d" % k)
            f.write(">%s\n" % name)
            txt = str(s)
            for off in range(0, len(txt), width):
                f.write(txt[off:off + width] + "\n")
    finally:
        if own:
            f.close()


_SCHEMA = """
CREATE TABLE IF NOT EXISTS sequence (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  content_id VARCHAR UNIQUE,
  name VARCHAR,
  length INTEGER,
  source_file VARCHAR,
  source_pos INTEGER,
  attrs VARCHAR
);
"""


class DB:
    """A database of sequences (mirrors ``biseqt/database.py — DB``).

    Args:
        path: SQLite file path, or ``':memory:'`` for tests (the
            reference's universal fixture).  The packed-contents pool sits
            next to it at ``<path>.seqs/`` (skipped for in-memory DBs,
            where contents stay in a dict).
        alphabet: the alphabet all stored sequences must use.

    Event hooks: ``add_event_listener('db-initialized' | 'sequence-inserted',
    fn)`` — e.g. a :class:`biseqt_jax.kmers.KmerIndex` can subscribe so
    ingestion triggers indexing, as in the reference.
    """

    events = ("db-initialized", "sequence-inserted")

    def __init__(self, path: str, alphabet: Alphabet):
        assert isinstance(alphabet, Alphabet)
        self.path = path
        self.alphabet = alphabet
        self._listeners: Dict[str, List[Callable]] = {
        e: [] for e in self.events}
        self._memory = path == ":memory:"
        self._pool_dir = None if self._memory else path + ".seqs"
        self._mem_pool: Dict[str, np.ndarray] = {}
        self._conn = sqlite3.connect(path)
        self._conn.executescript(_SCHEMA)
        self._conn.commit()
        if not self._memory:
            os.makedirs(self._pool_dir, exist_ok=True)
        self._emit("db-initialized", self)

    # -- events ---------------------------------------------------------------
    def add_event_listener(self, event: str, fn: Callable):
        assert event in self.events, "unknown event %r" % event
        self._listeners[event].append(fn)

    def _emit(self, event, *args):
        for fn in self._listeners[event]:
            fn(*args)

    # -- inserts --------------------------------------------------------------
    def insert(self, seq: Sequence, source_file: str = None,
               source_pos: int = 0, attrs: dict = None) -> Optional[Record]:
        """Insert a sequence; returns its Record (None if already present).

        Identity is the content id — inserting the same content twice is a
        no-op, making ingestion idempotent/resumable (the role the
        reference's unique constraint played).
        """
        cid = seq.content_id
        attrs = dict(attrs or {})
        name = getattr(seq, "name", None)
        if name and "name" not in attrs:
            attrs["name"] = name
        cur = self._conn.cursor()
        try:
            cur.execute(
                "INSERT INTO sequence "
                "(content_id, name, length, source_file, source_pos, attrs) "
                "VALUES (?, ?, ?, ?, ?, ?)",
                (cid, name, len(seq), source_file, source_pos,
                 json.dumps(attrs)),
            )
        except sqlite3.IntegrityError:
            return None
        # store contents BEFORE committing the metadata row: committing
        # first leaves a permanent orphan record if the pool write fails
        # (the UNIQUE constraint then blocks idempotent re-ingestion from
        # ever repairing it)
        self._store_contents(cid, seq)
        self._conn.commit()
        rec = Record(
            id=cur.lastrowid, content_id=cid, source_file=source_file,
            source_pos=source_pos, attrs=attrs,
        )
        self._emit("sequence-inserted", self, rec, seq)
        return rec

    def load_fasta(self, path_or_file, num: int = -1, rc: bool = False,
                   source_file: str = None,
                   complement_map=None) -> List[Record]:
        """Ingest a FASTA file; optionally also insert reverse complements.

        ``rc=True`` mirrors the reference's option of storing each record's
        reverse complement (attrs carry ``rc_of`` pointing at the forward
        record's content id).  The complement defaults to the DNA mapping
        ``['AT', 'CG']``; alphabets without all of A/T/C/G (protein,
        DNA-with-ambiguity-codes) must pass ``complement_map=`` explicitly
        (same formats as :meth:`Alphabet.transform` mappings; letters not
        named map to themselves, so e.g. ``['AT', 'CG']`` on an ACGTN
        alphabet keeps N fixed).  A default map that references letters
        missing from the alphabet raises ValueError up front.

        Whole-file ingests of a path go through the C++ streaming packer
        (:func:`biseqt_jax.native.fasta_pack`) when the native library is
        available and the alphabet is single-char ASCII — a 5 Mbp genome
        packs in milliseconds where the per-letter Python reader takes
        minutes.  Both paths have IDENTICAL letter semantics: whitespace
        in sequence data is dropped, lowercase is accepted, and any
        other unmapped letter raises ValueError (silent skipping would
        shift every downstream coordinate; reference contract
        ``biseqt/database.py — DB.load_fasta``).
        """
        if source_file is None and isinstance(path_or_file, str):
            source_file = path_or_file
        if rc:
            complement_map = self._validated_complement_map(complement_map)
        if isinstance(path_or_file, str) and num < 0:
            # (num-limited loads keep the lazy Python reader so a bad
            # letter BEYOND the requested records does not raise — the
            # native scan validates the whole file up front)
            out = self._load_fasta_native(
                path_or_file, rc, source_file, complement_map)
            if out is not None:
                return out
        out = []
        for seq, pos in read_fasta(path_or_file, self.alphabet, num=num):
            rec = self.insert(seq, source_file=source_file, source_pos=pos)
            if rec is not None:
                out.append(rec)
            if rc:
                rcseq = seq.reverse().transform(
                    complement_map, name="(rc of %s)" % seq.name
                )
                rrec = self.insert(
                    rcseq, source_file=source_file, source_pos=pos,
                    attrs={"rc_of": seq.content_id},
                )
                if rrec is not None:
                    out.append(rrec)
        return out

    def _validated_complement_map(self, complement_map):
        """Resolve the rc complement mapping, failing loudly up front.

        A missing-letter default used to surface as a bare KeyError from
        ``_mapping_table`` three frames down, AFTER forward records were
        already inserted — validate before any insert instead.
        """
        if complement_map is None:
            missing = [
                ch for ch in "ATCG" if ch not in self.alphabet._index
            ]
            if missing:
                raise ValueError(
                    "rc=True uses the default DNA complement ['AT', 'CG'] "
                    "but alphabet %r lacks letter(s) %s — pass "
                    "complement_map= (e.g. a list of symmetric letter "
                    "pairs) for this alphabet"
                    % (self.alphabet, "/".join(missing)))
            return ["AT", "CG"]
        # user-provided maps are validated by materializing the table
        # once (errors here name the offending letter/code)
        try:
            _mapping_table(self.alphabet, complement_map)
        except (KeyError, AssertionError, ValueError) as e:
            raise ValueError(
                "complement_map %r is not valid for alphabet %r: %s"
                % (complement_map, self.alphabet, e))
        return complement_map

    def _load_fasta_native(self, path: str, rc: bool, source_file: str,
                           complement_map=None) -> Optional[List[Record]]:
        """C++-packer ingest tier; None = fall back to the Python reader
        (multi-char/non-ASCII alphabet, or the .so is unavailable)."""
        lut = self.alphabet._byte_lut()
        if lut is None:
            return None
        from . import native

        if not native.available():
            return None
        code_map = lut.astype(np.int8)
        # lowercase acceptance parity: the Python reader upper()s before
        # parsing (skip letters whose lowercase byte is already claimed)
        for i, ch in enumerate(self.alphabet.letters):
            lo = ord(ch.lower())
            if lo < 128 and code_map[lo] < 0:
                code_map[lo] = i
        codes, offsets, lengths, names, header_pos = native.fasta_pack(
            path, code_map
        )
        out = []
        for r in range(len(names)):
            arr = codes[offsets[r]:offsets[r] + lengths[r]]
            seq = NamedSequence(self.alphabet, arr, name=names[r])
            pos = int(header_pos[r])
            rec = self.insert(seq, source_file=source_file, source_pos=pos)
            if rec is not None:
                out.append(rec)
            if rc:
                rcseq = seq.reverse().transform(
                    complement_map, name="(rc of %s)" % seq.name
                )
                rrec = self.insert(
                    rcseq, source_file=source_file, source_pos=pos,
                    attrs={"rc_of": seq.content_id},
                )
                if rrec is not None:
                    out.append(rrec)
        return out

    # -- queries --------------------------------------------------------------
    def find(self, condition: Callable[[Record], bool] = None,
             sql_condition: str = None) -> Iterable[Record]:
        """Iterate records, optionally filtered by a predicate or SQL."""
        q = ("SELECT id, content_id, source_file, source_pos, attrs "
             "FROM sequence")
        if sql_condition:
            q += " WHERE " + sql_condition
        for row in self._conn.execute(q):
            rec = Record(
                id=row[0], content_id=row[1], source_file=row[2],
                source_pos=row[3], attrs=json.loads(row[4] or "{}"),
            )
            if condition is None or condition(rec):
                yield rec

    def ids(self):
        return [r.id for r in self.find()]

    def load_from_record(self, rec: Record) -> NamedSequence:
        """Materialize a Record's sequence from the packed pool."""
        codes = self._load_contents(rec.content_id)
        name = rec.attrs.get("name", "")
        return NamedSequence(
            self.alphabet, np.asarray(codes, np.int8), name=name or ""
        )

    def __len__(self):
        return self._conn.execute(
            "SELECT COUNT(*) FROM sequence"
        ).fetchone()[0]

    def close(self):
        self._conn.close()

    # -- packed-contents pool -------------------------------------------------
    def _store_contents(self, cid: str, seq: Sequence):
        arr = seq.to_array(np.int8)
        if self._memory:
            self._mem_pool[cid] = arr
        else:
            np.save(os.path.join(self._pool_dir, cid + ".npy"), arr)

    def _load_contents(self, cid: str) -> np.ndarray:
        if self._memory:
            return self._mem_pool[cid]
        return np.load(os.path.join(self._pool_dir, cid + ".npy"))

    # -- bulk device lowering -------------------------------------------------
    def packed_batch(self, records: Iterable[Record] = None,
                     pad_to: int = None):
        """All (or given) records as a packed (codes, lengths) batch —
        the direct input to :mod:`biseqt_jax.ops` pipelines."""
        from .sequence import pack_sequences

        recs = list(records) if records is not None else list(self.find())
        seqs = [self.load_from_record(r) for r in recs]
        return pack_sequences(seqs, pad_to=pad_to), recs
