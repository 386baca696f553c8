"""Core sequence datatypes: alphabets, immutable sequences, edit transcripts.

Accelerator rebuild of the reference's core sequence model
(``biseqt/sequence.py — Alphabet, Sequence, EditTranscript``).  The host-facing
API mirrors the reference contract (integer-coded immutable sequences,
content-addressed identity, transform/reverse algebra) while the compute path
is array-first: sequences lower to dense ``int8`` code arrays via
:func:`pack_sequences`, the form every downstream device op (k-mer packing,
seed join, banded DP) consumes.

Design notes (device-first, not a port):
  * Letter codes are small ints; device arrays are int8 (DNA fits in 2 bits,
    int8 keeps arrays small while allowing |alphabet| up to 127).
  * Variable lengths are carried out-of-band as an int32 ``lengths`` vector;
    padding uses ``PAD = -1`` so any k-mer window touching padding is
    detectable with a single comparison.
  * Content ids (SHA-1) stay host-side — hashing is not a device job.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Sequence as TypingSequence

import numpy as np

__all__ = [
    "Alphabet",
    "Sequence",
    "NamedSequence",
    "EditTranscript",
    "PAD",
    "pack_sequences",
    "unpack_sequence",
]

# Padding sentinel used in packed code arrays.  Any window containing PAD is
# invalid; -1 is convenient because valid codes are >= 0.
PAD = -1


class Alphabet:
    """An ordered collection of letters, all of the same string length.

    Mirrors ``biseqt/sequence.py — Alphabet``: letters map to their index
    (the integer "code"); sequences store codes, not characters.

    Attributes:
        letters: tuple of letter strings (uniform length).
    """

    def __init__(self, letters: Iterable[str]):
        letters = tuple(str(l) for l in letters)
        if not letters:
            raise ValueError("Alphabet requires at least one letter")
        lengths = set(len(l) for l in letters)
        if len(lengths) != 1:
            raise ValueError("All alphabet letters must have the same length")
        if len(set(letters)) != len(letters):
            raise ValueError("Alphabet letters must be distinct")
        self.letters = letters
        self._letlen = lengths.pop()
        self._index = {l: i for i, l in enumerate(letters)}

    # -- container protocol ---------------------------------------------------
    def __len__(self) -> int:
        return len(self.letters)

    def __getitem__(self, idx: int) -> str:
        return self.letters[idx]

    def __eq__(self, other) -> bool:
        return isinstance(other, Alphabet) and self.letters == other.letters

    def __ne__(self, other) -> bool:  # py2-style parity with reference
        return not self == other

    def __hash__(self):
        return hash(self.letters)

    def __repr__(self) -> str:
        return "Alphabet(%s)" % (list(self.letters),)

    @property
    def letter_length(self) -> int:
        """Uniform length of each letter string."""
        return self._letlen

    # -- text <-> codes -------------------------------------------------------
    def letter_to_idx(self, letters: Iterable[str]) -> tuple:
        """Translate letters to their integer codes."""
        return tuple(self._index[l] for l in letters)

    def parse(self, text: str) -> "Sequence":
        """Parse a string into a :class:`Sequence` over this alphabet."""
        ll = self._letlen
        if len(text) % ll:
            raise ValueError(
                "text length %d not a multiple of letter length %d"
                % (len(text), ll)
            )
        # vectorized path for 1-char ASCII alphabets (the DNA/protein
        # case): a 256-entry byte->code table replaces the per-letter
        # dict lookups — genome-scale parses drop from seconds to ms.
        # Unknown letters raise exactly like the dict path.
        if ll == 1:
            lut = self._byte_lut()
            if lut is not None:
                try:
                    raw = np.frombuffer(text.encode("ascii"), np.uint8)
                except UnicodeEncodeError:
                    raw = None
                if raw is not None:
                    codes = lut[raw]
                    bad = codes < 0
                    if bad.any():
                        raise ValueError(
                            "letter %r not in alphabet"
                            % (text[int(np.argmax(bad))],))
                    return Sequence(self, codes)
        try:
            contents = tuple(
                self._index[text[i : i + ll]] for i in range(0, len(text), ll)
            )
        except KeyError as e:
            raise ValueError("letter %r not in alphabet" % (e.args[0],))
        return Sequence(self, contents)

    def _byte_lut(self):
        """256-entry byte -> code int16 table (-1 = unknown), or None if
        the alphabet is not single-char ASCII.  Cached; shared by
        :meth:`parse` and the native FASTA packer's code map."""
        if self._letlen != 1:
            return None
        lut = getattr(self, "_byte_lut_cache", None)
        if lut is None:
            lut = np.full((256,), -1, np.int16)
            for i, ch in enumerate(self.letters):
                o = ord(ch)
                if o > 127:
                    return None
                lut[o] = i
            self._byte_lut_cache = lut
        return lut

    def transform(self, seq: "Sequence", mappings=()) -> "Sequence":
        """Apply letter mappings (e.g. complementing) producing a new Sequence.

        ``mappings`` may be a dict (letter or code -> letter or code) or a
        list of 2-tuples/strings; mappings are applied symmetrically (as the
        reference does for complements: ``['AT', 'CG']``).
        """
        table = _mapping_table(self, mappings)
        return Sequence(
            self, np.asarray(table, np.int8)[seq.to_array(np.int8)]
        )


def _mapping_table(alphabet: Alphabet, mappings) -> list:
    """Build a code -> code translation table from flexible mapping specs."""
    table = list(range(len(alphabet)))

    def as_code(x):
        if isinstance(x, str):
            return alphabet._index[x]
        c = int(x)
        # negative ints would silently wrap via list indexing (e.g. -1
        # remapping the LAST letter); out-of-range positives would raise
        # a bare IndexError at table[c] — fail loudly with the code named
        if not 0 <= c < len(alphabet):
            raise ValueError(
                "letter code %d out of range for alphabet of size %d"
                % (c, len(alphabet)))
        return c

    if isinstance(mappings, dict):
        pairs = list(mappings.items())
    else:
        pairs = []
        for m in mappings:
            if isinstance(m, str):
                # e.g. 'AT' means A<->T (uniform letter length 1)
                ll = alphabet.letter_length
                assert len(m) == 2 * ll, "string mapping must contain 2 letters"
                pairs.append((m[:ll], m[ll:]))
            else:
                pairs.append((m[0], m[1]))
    for a, b in pairs:
        ca, cb = as_code(a), as_code(b)
        table[ca] = cb
        table[cb] = ca
    return table


class Sequence:
    """An immutable sequence of letters from an :class:`Alphabet`.

    Contents are a tuple of integer codes.  Identity is content-addressed:
    :attr:`content_id` is the SHA-1 of the rendered text plus the alphabet
    (mirrors ``biseqt/sequence.py — Sequence.content_id``).
    """

    def __init__(self, alphabet: Alphabet, contents: TypingSequence[int] = ()):
        assert isinstance(alphabet, Alphabet)
        # array-first storage: genome-scale sequences arrive as packed
        # int8 code arrays (the native FASTA packer, the DB pool) and a
        # per-letter ``tuple(int(c) ...)`` pass costs seconds at 5 Mbp.
        # The public ``contents`` tuple is materialized lazily; every
        # container/algebra op below works off the array.
        # range-validate BEFORE the int8 narrowing: a cast-first check
        # would silently accept codes that wrap into range (256 -> 0)
        # or floats that truncate into range (1.7 -> 1)
        if isinstance(contents, np.ndarray):
            if not np.issubdtype(contents.dtype, np.integer):
                raise ValueError(
                    "sequence codes must be integers, got dtype %s"
                    % contents.dtype)
            if contents.ndim != 1:
                raise ValueError("sequence codes must be one-dimensional")
            if contents.size:
                if (int(contents.min()) < 0
                        or int(contents.max()) >= len(alphabet)):
                    raise ValueError("letter code out of range for alphabet")
            # astype copies: freezing a caller's buffer (or aliasing one
            # it later mutates) must not be observable
            arr = contents.astype(np.int8)
            self._contents = None
        else:
            tup = tuple(int(c) for c in contents)
            if any(c < 0 or c >= len(alphabet) for c in tup):
                raise ValueError("letter code out of range for alphabet")
            arr = np.asarray(tup, np.int8)
            self._contents = tup
        arr.flags.writeable = False
        self.alphabet = alphabet
        self._arr = arr

    @property
    def contents(self) -> tuple:
        """Integer-code tuple (reference parity).  Lazy: prefer
        :meth:`to_array` in compute paths — materializing the tuple of a
        genome costs a per-letter Python pass."""
        if self._contents is None:
            self._contents = tuple(self._arr.tolist())
        return self._contents

    # -- identity -------------------------------------------------------------
    @property
    def content_id(self) -> str:
        """SHA-1 hex digest of the sequence text + alphabet letters."""
        h = hashlib.sha1()
        h.update(str(self).encode("utf-8"))
        h.update(repr(self.alphabet.letters).encode("utf-8"))
        return h.hexdigest()

    # -- container protocol ---------------------------------------------------
    def __len__(self) -> int:
        return self._arr.shape[0]

    def __bool__(self) -> bool:
        return self._arr.shape[0] > 0

    __nonzero__ = __bool__

    def __getitem__(self, key):
        if isinstance(key, slice):
            return Sequence(self.alphabet, self._arr[key])
        return int(self._arr[key])

    def __iter__(self):
        return iter(self.contents)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Sequence)
            and self.alphabet == other.alphabet
            and np.array_equal(self._arr, other._arr)
        )

    def __ne__(self, other) -> bool:
        return not self == other

    def __hash__(self):
        return hash((self.alphabet.letters, self._arr.tobytes()))

    def __add__(self, other) -> "Sequence":
        if isinstance(other, Sequence):
            assert self.alphabet == other.alphabet
            return Sequence(
                self.alphabet, np.concatenate([self._arr, other._arr])
            )
        # allow raw iterables of codes: wide dtype here so __init__'s
        # ndarray path range-validates BEFORE any int8 narrowing (a
        # direct int8 asarray would overflow/wrap out-of-range codes)
        return Sequence(
            self.alphabet,
            np.concatenate([
                self._arr.astype(np.int64),
                np.asarray(tuple(other), np.int64),
            ]),
        )

    def __str__(self) -> str:
        # vectorized render for 1-char ASCII alphabets (content_id hashes
        # the text, so this is on the ingest path at genome scale)
        lut = self.alphabet._byte_lut()
        if lut is not None:
            txt_lut = np.zeros((len(self.alphabet),), np.uint8)
            for i, ch in enumerate(self.alphabet.letters):
                txt_lut[i] = ord(ch)
            return txt_lut[self._arr].tobytes().decode("ascii")
        return "".join(self.alphabet[c] for c in self._arr.tolist())

    def __repr__(self) -> str:
        if len(self) > 40:
            txt = str(self[:37]) + "..."
        else:
            txt = str(self)
        return "Sequence(%r)" % txt

    # -- algebra --------------------------------------------------------------
    def reverse(self, name: str = None) -> "Sequence":
        """The reversed sequence."""
        return Sequence(self.alphabet, self._arr[::-1])

    def transform(self, mappings=(), name: str = None) -> "Sequence":
        """Letter-mapped copy (e.g. ``transform(['AT','CG'])`` complements DNA)."""
        return self.alphabet.transform(self, mappings)

    # -- device lowering ------------------------------------------------------
    def to_array(self, dtype=np.int8) -> np.ndarray:
        """Dense integer-code array (the device-side representation)."""
        if np.dtype(dtype) == np.int8:
            return self._arr
        return self._arr.astype(dtype)


class NamedSequence(Sequence):
    """A sequence with a display name (FASTA record name).

    Mirrors ``biseqt/sequence.py — NamedSequence``: same content semantics,
    plus a name carried along; content_id covers the name too so database
    identity distinguishes identically-lettered records with distinct names.
    """

    def __init__(self, alphabet, contents=(), name: str = ""):
        super().__init__(alphabet, contents)
        self.name = name

    @classmethod
    def wrap(cls, seq: Sequence, name: str = "") -> "NamedSequence":
        return cls(seq.alphabet, seq._arr, name=name)

    @property
    def content_id(self) -> str:
        h = hashlib.sha1()
        h.update(str(self).encode("utf-8"))
        h.update(repr(self.alphabet.letters).encode("utf-8"))
        h.update(self.name.encode("utf-8"))
        return h.hexdigest()

    def reverse(self, name=None) -> "NamedSequence":
        if name is None:
            name = "(reverse of %s)" % self.name
        return NamedSequence(self.alphabet, self._arr[::-1], name=name)

    def transform(self, mappings=(), name=None) -> "NamedSequence":
        if name is None:
            name = "(transform of %s)" % self.name
        base = self.alphabet.transform(self, mappings)
        return NamedSequence(self.alphabet, base._arr, name=name)

    def __repr__(self):
        return "NamedSequence(%r, name=%r)" % (str(self)[:24], self.name)

    def __eq__(self, other):
        return (
            isinstance(other, NamedSequence)
            and super().__eq__(other)
            and self.name == other.name
        )

    def __hash__(self):
        return hash((self.alphabet.letters, self._arr.tobytes(), self.name))


class EditTranscript(str):
    """An edit transcript: a string over the op alphabet ``MSID``.

    M = match, S = substitution, I = insertion (into origin; i.e. a letter of
    the mutant consumed alone), D = deletion.  Mirrors
    ``biseqt/sequence.py — EditTranscript``; shared by the aligner output and
    the mutation simulator so tests can compare them directly.
    """

    OPS = "MSID"

    def __new__(cls, content):
        content = str(content).upper()
        assert all(c in cls.OPS for c in content), "ops must be in MSID"
        return str.__new__(cls, content)

    def __repr__(self):
        return "EditTranscript(%r)" % str(self)

    def __getitem__(self, key):
        out = str.__getitem__(self, key)
        if isinstance(key, slice):
            return EditTranscript(out)
        return out

    def __add__(self, other):
        return EditTranscript(str(self) + str(other))

    # -- projections ----------------------------------------------------------
    @property
    def origin_len(self) -> int:
        """Number of origin letters consumed (M, S, D ops)."""
        return sum(1 for c in self if c in "MSD")

    @property
    def mutate_len(self) -> int:
        """Number of mutant letters consumed (M, S, I ops)."""
        return sum(1 for c in self if c in "MSI")


# ---------------------------------------------------------------------------
# Device packing
# ---------------------------------------------------------------------------

def pack_sequences(seqs, pad_to: int = None, dtype=np.int8):
    """Pack sequences into a dense padded code matrix + length vector.

    This is the lowering from the host object model to the device
    representation used by every device op in the framework.

    Args:
        seqs: iterable of :class:`Sequence` (or raw code iterables).
        pad_to: pad row length; default = max sequence length.  Callers
            usually round up to a shape bucket to share compiles.
        dtype: output dtype of the code matrix (int8 default).

    Returns:
        ``(codes, lengths)``: ``codes`` is ``[N, pad_to]`` with ``PAD`` in the
        tail; ``lengths`` is int32 ``[N]``.
    """
    rows = []
    for s in seqs:
        if isinstance(s, Sequence):
            rows.append(s.to_array(np.int64))
        else:
            rows.append(np.asarray(tuple(s), dtype=np.int64))
    n = len(rows)
    maxlen = max((len(r) for r in rows), default=0)
    if pad_to is None:
        pad_to = max(maxlen, 1)
    if maxlen > pad_to:
        raise ValueError("pad_to=%d < longest sequence %d" % (pad_to, maxlen))
    codes = np.full((n, pad_to), PAD, dtype=dtype)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, r in enumerate(rows):
        codes[i, : len(r)] = r.astype(dtype)
        lengths[i] = len(r)
    return codes, lengths


def unpack_sequence(alphabet: Alphabet, codes, length=None) -> Sequence:
    """Inverse of :func:`pack_sequences` for a single row."""
    codes = np.asarray(codes)
    if length is not None:
        codes = codes[: int(length)]
    else:
        valid = codes != PAD
        if not valid.all():
            codes = codes[: int(np.argmin(valid))]
    return Sequence(alphabet, np.asarray(codes, np.int8))
