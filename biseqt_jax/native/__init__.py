"""ctypes binding to the native host engine (libpwnative.so).

The runtime-native tier of the framework: C++ banded affine DP +
traceback + FASTA streaming packer.  Built on demand with ``make`` (g++)
the first time it is imported; see ``pwnative.cpp`` for the ABI.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

__all__ = [
    "available", "align", "traceback", "traceback_batch",
    "traceback_ad_window_batch", "fasta_pack", "dna_code_map",
    "MODE_FREE_START_EDGES", "MODE_LOCAL_START",
    "MODE_FREE_END_EDGES", "MODE_LOCAL_END",
]

MODE_FREE_START_EDGES = 1
MODE_LOCAL_START = 2
MODE_FREE_END_EDGES = 4
MODE_LOCAL_END = 8

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libpwnative.so")
_lib = None

# Must match bst_abi_version() in pwnative.cpp.  The argtypes tables
# below describe THIS version's signatures; loading a .so built from an
# older source would shift pointer arguments (silent memory
# corruption), so _load() hard-fails on mismatch instead of warning.
_ABI_VERSION = 3


def _build():
    subprocess.run(
        ["make", "-s", "-C", _HERE], check=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )


def _stale():
    """The shipped .so predates the current pwnative.cpp (or is absent)."""
    try:
        so_m = os.path.getmtime(_SO)
    except OSError:
        return True
    try:
        src_m = os.path.getmtime(os.path.join(_HERE, "pwnative.cpp"))
    except OSError:
        return False  # source not shipped: trust the prebuilt .so
    return src_m > so_m


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # rebuild only when pwnative.cpp is newer than the .so: loading a
    # stale .so after an ABI change corrupts memory, but a deployment
    # with a prebuilt .so and no toolchain must keep its native tier
    # (an unconditional make would FileNotFoundError it away)
    if _stale():
        try:
            _build()
        except (OSError, subprocess.CalledProcessError):
            if not os.path.exists(_SO):
                raise
            # source mtime > .so mtime but no working toolchain: common
            # after archive extraction reorders mtimes of files built
            # together.  Keep the prebuilt .so (loudly — if the source
            # REALLY changed the ABI, a rebuild is required).
            warnings.warn(
                "pwnative.cpp is newer than libpwnative.so and rebuilding"
                " failed; loading the existing .so anyway", RuntimeWarning)
    lib = ctypes.CDLL(_SO)
    # ABI gate BEFORE any argtypes are trusted: a stale .so with an
    # older exported-signature set must never be called through the
    # current ctypes tables (shifted pointer args corrupt memory).
    try:
        so_abi = int(lib.bst_abi_version())
    except AttributeError:
        so_abi = 0  # pre-versioning binary
    if so_abi != _ABI_VERSION:
        raise RuntimeError(
            "libpwnative.so ABI version %d does not match the binding's"
            " expected %d — rebuild it (`make -C %s`)"
            % (so_abi, _ABI_VERSION, _HERE))
    lib.bst_align.restype = ctypes.c_int
    lib.bst_align.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_traceback.restype = ctypes.c_int
    lib.bst_traceback.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_traceback_batch.restype = ctypes.c_int
    lib.bst_traceback_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_traceback_ad_window_batch.restype = ctypes.c_int
    lib.bst_traceback_ad_window_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_fasta_scan.restype = ctypes.c_int
    lib.bst_fasta_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bst_fasta_pack.restype = ctypes.c_int64
    lib.bst_fasta_pack.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _flags_of(mode_flags) -> int:
    f = 0
    if getattr(mode_flags, "free_start_edges", False):
        f |= MODE_FREE_START_EDGES
    if getattr(mode_flags, "local_start", False):
        f |= MODE_LOCAL_START
    if getattr(mode_flags, "free_end_edges", False):
        f |= MODE_FREE_END_EDGES
    if getattr(mode_flags, "local_end", False):
        f |= MODE_LOCAL_END
    return f


def align(s, t, subst, go, ge, dmin, dmax, mode_flags, with_dirs=False):
    """Native banded affine DP; same conventions as the JAX engine.

    Returns ``(score, end_i, end_j, dirs_or_None)``.
    """
    lib = _load()
    s = np.ascontiguousarray(s, np.int8)
    t = np.ascontiguousarray(t, np.int8)
    subst = np.ascontiguousarray(subst, np.float32)
    A = subst.shape[0]
    W = int(dmax) - int(dmin) + 1
    dirs = (
        np.zeros((len(s), W), np.uint8) if with_dirs else None
    )
    score = ctypes.c_float()
    ei = ctypes.c_int()
    ej = ctypes.c_int()
    rc = lib.bst_align(
        s.ctypes.data, len(s), t.ctypes.data, len(t),
        subst.ctypes.data, A, float(go), float(ge),
        int(dmin), int(dmax), _flags_of(mode_flags),
        ctypes.byref(score), ctypes.byref(ei), ctypes.byref(ej),
        dirs.ctypes.data if dirs is not None else None,
    )
    assert rc == 0, "bst_align failed"
    return float(score.value), int(ei.value), int(ej.value), dirs


def traceback(dirs, dmax, s, t, end_i, end_j, mode_flags):
    """Native traceback walk; returns (ops_str, start_i, start_j)."""
    lib = _load()
    dirs = np.ascontiguousarray(dirs, np.uint8)
    W = dirs.shape[1]
    s = np.ascontiguousarray(s, np.int8)
    t = np.ascontiguousarray(t, np.int8)
    buf = ctypes.create_string_buffer(len(s) + len(t) + 2)
    si = ctypes.c_int()
    sj = ctypes.c_int()
    n = lib.bst_traceback(
        dirs.ctypes.data, W, int(dmax),
        s.ctypes.data, len(s), t.ctypes.data, len(t),
        int(end_i), int(end_j), _flags_of(mode_flags),
        buf, ctypes.byref(si), ctypes.byref(sj),
    )
    assert n >= 0, "bst_traceback failed"
    return buf.value.decode("ascii"), int(si.value), int(sj.value)


def traceback_batch(dirs, dmax, s_codes, t_codes, s_lens, t_lens,
                    end_i, end_j, mode_flags):
    """Batched traceback over [B, rows, W] direction bytes (one C call).

    ``dmax`` is per-pair (int32 [B]).  Returns
    ``(ops list[str], start_i int32[B], start_j int32[B])``.
    """
    lib = _load()
    dirs = np.ascontiguousarray(dirs, np.uint8)
    B, rows_cap, W = dirs.shape
    s_codes = np.ascontiguousarray(s_codes, np.int8)
    t_codes = np.ascontiguousarray(t_codes, np.int8)
    i32 = lambda x: np.ascontiguousarray(x, np.int32)
    dmax, s_lens, t_lens, end_i, end_j = map(
        i32, (dmax, s_lens, t_lens, end_i, end_j)
    )
    ops_stride = int(s_codes.shape[1] + t_codes.shape[1] + 2)
    ops_buf = np.zeros((B, ops_stride), np.uint8)
    start_i = np.zeros((B,), np.int32)
    start_j = np.zeros((B,), np.int32)
    ops_len = np.zeros((B,), np.int32)
    rc = lib.bst_traceback_batch(
        dirs.ctypes.data, rows_cap, W, dmax.ctypes.data,
        s_codes.ctypes.data, s_codes.shape[1],
        t_codes.ctypes.data, t_codes.shape[1],
        s_lens.ctypes.data, t_lens.ctypes.data,
        end_i.ctypes.data, end_j.ctypes.data,
        _flags_of(mode_flags), B, ops_stride,
        ops_buf.ctypes.data, start_i.ctypes.data, start_j.ctypes.data,
        ops_len.ctypes.data,
    )
    assert rc == 0, "bst_traceback_batch failed"
    bad = np.nonzero(ops_len < 0)[0]
    assert bad.size == 0, (
        "traceback walk left the direction plane for pairs %s — "
        "wrong dmax/end cell or corrupted dirs" % bad[:8].tolist()
    )
    ops = [
        ops_buf[b, : ops_len[b]].tobytes().decode("ascii")
        for b in range(B)
    ]
    return ops, start_i, start_j


def traceback_ad_window_batch(dirs_win, a_base, dminq, s_codes, t_codes,
                              io_i, io_j, io_state, io_done,
                              ops_stride: int):
    """One window of the band-sharded checkpointed traceback.

    ``dirs_win``: [B2, n_steps, W] UNPACKED direction bytes for
    antidiagonals ``a_base .. a_base + n_steps - 1`` (the window
    re-solver's output; pairs (2*b2, 2*b2+1) share plane b2 on
    complementary parities).  ``io_i``/``io_j``/``io_state``/``io_done``
    are int32 [B] walk cursors advanced IN PLACE.  Returns the list of
    per-pair BACKWARD op segments emitted inside this window (empty for
    inactive pairs); the caller concatenates segments across windows
    (descending) and reverses once.
    """
    lib = _load()
    dirs_win = np.ascontiguousarray(dirs_win, np.uint8)
    _, n_steps, W = dirs_win.shape
    s_codes = np.ascontiguousarray(s_codes, np.int8)
    t_codes = np.ascontiguousarray(t_codes, np.int8)
    dminq = np.ascontiguousarray(dminq, np.int32)
    B = int(s_codes.shape[0])
    for cur in (io_i, io_j, io_state, io_done):
        assert cur.dtype == np.int32 and cur.flags["C_CONTIGUOUS"], \
            "walk cursors must be contiguous int32 (updated in place)"
    ops_buf = np.zeros((B, ops_stride), np.uint8)
    ops_len = np.zeros((B,), np.int32)
    rc = lib.bst_traceback_ad_window_batch(
        dirs_win.ctypes.data, n_steps, W, int(a_base),
        dminq.ctypes.data,
        s_codes.ctypes.data, s_codes.shape[1],
        t_codes.ctypes.data, t_codes.shape[1],
        B, int(ops_stride),
        io_i.ctypes.data, io_j.ctypes.data, io_state.ctypes.data,
        io_done.ctypes.data, ops_buf.ctypes.data, ops_len.ctypes.data,
    )
    assert rc == 0, "bst_traceback_ad_window_batch failed"
    bad = np.nonzero(ops_len < 0)[0]
    assert bad.size == 0, (
        "window walk left the direction plane for pairs %s — wrong "
        "dminq/end cell or a checkpoint/re-solve mismatch"
        % bad[:8].tolist()
    )
    return [
        ops_buf[b, : ops_len[b]].tobytes().decode("ascii")
        for b in range(B)
    ]


def dna_code_map(letters: str = "ACGT", lowercase: bool = True):
    """256-entry byte -> code map for the FASTA packer (-1 = skip)."""
    m = np.full((256,), -1, np.int8)
    for i, ch in enumerate(letters):
        m[ord(ch)] = i
        if lowercase:
            m[ord(ch.lower())] = i
    return m


def fasta_pack(path: str, code_map=None):
    """Stream-parse FASTA into packed codes at C speed.

    Returns ``(codes int8[total], offsets int64[n], lengths int64[n],
    names list[str], header_pos int64[n])`` — ``header_pos[r]`` is the
    byte offset of record r's ``>`` line (the DB ``source_pos``
    contract).

    Raises ValueError if the file contains any non-whitespace sequence
    byte the code map does not cover (e.g. an ``N`` under the plain
    ACGT map): silently skipping a base would SHIFT every downstream
    coordinate of that record — identical strictness to the Python
    reader (``database.read_fasta`` -> ``Alphabet.parse``).  To accept
    ambiguity codes, pass a ``code_map`` that maps them explicitly.
    """
    lib = _load()
    if code_map is None:
        code_map = dna_code_map()
    code_map = np.ascontiguousarray(code_map, np.int8)
    n = ctypes.c_int64()
    total = ctypes.c_int64()
    n_unknown = ctypes.c_int64()
    first_unknown = ctypes.c_int()
    unknown_pos = ctypes.c_int64()
    rc = lib.bst_fasta_scan(
        path.encode(), code_map.ctypes.data,
        ctypes.byref(n), ctypes.byref(total),
        ctypes.byref(n_unknown), ctypes.byref(first_unknown),
        ctypes.byref(unknown_pos),
    )
    assert rc == 0, "cannot read %s" % path
    if int(n_unknown.value):
        raise ValueError(
            "letter %r not in alphabet (%d unmapped byte(s) in %s, "
            "first at file offset %d)" % (
                chr(int(first_unknown.value)), int(n_unknown.value),
                path, int(unknown_pos.value),
            ))
    nrec = int(n.value)
    codes = np.zeros((int(total.value),), np.int8)
    offsets = np.zeros((max(nrec, 1),), np.int64)
    lengths = np.zeros((max(nrec, 1),), np.int64)
    header_pos = np.zeros((max(nrec, 1),), np.int64)
    names_cap = 1 << 20
    while True:
        names_buf = ctypes.create_string_buffer(names_cap)
        needed = ctypes.c_int64()
        got = lib.bst_fasta_pack(
            path.encode(), code_map.ctypes.data,
            codes.ctypes.data, offsets.ctypes.data, lengths.ctypes.data,
            header_pos.ctypes.data,
            names_buf, names_cap, ctypes.byref(needed),
        )
        assert got == nrec, (got, nrec)
        if needed.value <= names_cap:
            break
        # truncated names are untrustworthy (a dropped NUL would shift
        # every later name) — retry with the reported requirement
        names_cap = int(needed.value) + 1
    names = names_buf.raw.split(b"\0")[:nrec]
    return codes, offsets[:nrec], lengths[:nrec], [
        x.decode("ascii", "replace") for x in names
    ], header_pos[:nrec]
