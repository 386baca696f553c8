"""Banded affine-gap DP as a CUDA kernel for Hopper, called through ``jax.ffi``.

The kernel (``biseqt_jax/native/banded_dp.cu``) keeps the contract of
:func:`biseqt_jax.ops.banded_dp.banded_dp` — same ``DPResult``, modes,
per-pair band placement and row-layout direction bytes — and replaces
its ``lax.scan`` (one XLA loop iteration per DP row for the whole batch)
with one thread block per pair that walks the rows in registers.

It takes integer-valued scores only (:func:`supports`): they run in
int32, which the float32 engine sums exactly too, so both engines give
the same scores, end cells and transcripts.  The library is compiled
with ``nvcc`` from the committed source on first use, into
``biseqt_jax/native/build/``; a GPU host without a working ``nvcc``
raises here rather than run another engine.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp

from .banded_dp import NEG, DPResult, ModeFlags, _check_gap_scores

__all__ = ["banded_dp_cuda", "supports", "load", "build_command",
           "MAX_W", "LANE_BLOCK"]

LANE_BLOCK = 128   # band lanes per warp: W is a multiple of this
MAX_W = 2048       # one block of W / 4 threads per pair
MAX_A = 32         # substitution table in shared memory
# int32 scores: the kernel's NEG is -2**30 and anything below -2**29 is
# treated as unreachable, so no live score may come near -2**29
_SCORE_RANGE = 1 << 27

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "native", "banded_dp.cu")
_BUILD = os.path.join(os.path.dirname(_HERE), "native", "build")
_SO = os.path.join(_BUILD, "libbanded_dp_cuda.so")
_TARGET = "biseqt_banded_dp"
_CUDA_ROOTS = ("/usr/local/cuda",)   # the toolkit's default install
_MODE_BITS = (("free_start_edges", 1), ("local_start", 2),
              ("free_end_edges", 4), ("local_end", 8))


def supports(subst, go, ge, W: int, LS: int, LT: int) -> bool:
    """Whether the kernel computes this problem exactly.

    The rule the engine selector applies: a band width that is a
    multiple of 128 up to 2048, an alphabet of at most 32 letters, and
    integer-valued substitution and gap scores small enough that no
    score of a pair can leave int32's safe range.  Anything else runs on
    :func:`~biseqt_jax.ops.banded_dp.banded_dp`.
    """
    sub = np.asarray(subst, np.float64)
    if W % LANE_BLOCK or not 0 < W <= MAX_W:
        return False
    if sub.ndim != 2 or sub.shape[0] != sub.shape[1] or not (
            1 <= sub.shape[0] <= MAX_A):
        return False
    vals = np.concatenate([sub.ravel(), [float(go), float(ge)]])
    if not np.array_equal(vals, np.round(vals)):
        return False
    bound = float(np.max(np.abs(vals))) * (int(LS) + int(LT) + 2 * W + 2)
    return bound < _SCORE_RANGE


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    roots = [os.environ[v] for v in ("CUDA_HOME", "CUDA_PATH")
             if os.environ.get(v)] + list(_CUDA_ROOTS)
    for root in roots:
        cand = os.path.join(root, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError(
        "the CUDA DP kernel needs nvcc (CUDA toolkit) to build "
        "biseqt_jax/native/banded_dp.cu; none found on PATH, CUDA_HOME "
        "or /usr/local/cuda")


def build_command(out: str = _SO):
    """The one command that builds the kernel library from the source."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", out, _SRC,
    ]


def _build():
    os.makedirs(_BUILD, exist_ok=True)
    tmp = "%s.%d.tmp" % (_SO, os.getpid())
    proc = subprocess.run(build_command(tmp), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed to build %s:\n%s"
                           % (_SRC, proc.stderr[-4000:]))
    os.replace(tmp, _SO)


@functools.lru_cache(maxsize=None)
def load() -> str:
    """Build (when the source is newer) and register the kernel; returns
    the FFI target name.  Raises when the library cannot be built or
    loaded — callers never fall back to another engine."""
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
        _build()
    lib = ctypes.cdll.LoadLibrary(_SO)
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.BiseqtBandedDp), platform="CUDA")
    return _TARGET


def mode_bits(flags: ModeFlags) -> int:
    return sum(bit for name, bit in _MODE_BITS if getattr(flags, name))


def kernel_inputs(s_codes, t_codes, s_lens, t_lens, dmin, w_eff, subst,
                  *, W: int):
    """Host-side argument preparation: dtypes, the default effective
    width and the integer substitution table the FFI call takes."""
    B = s_codes.shape[0]
    if w_eff is None:
        w_eff = jnp.full((B,), W, jnp.int32)
    table = np.asarray(subst, np.float64)
    return (jnp.asarray(s_codes).astype(jnp.int8),
            jnp.asarray(t_codes).astype(jnp.int8),
            jnp.asarray(s_lens).astype(jnp.int32),
            jnp.asarray(t_lens).astype(jnp.int32),
            jnp.asarray(dmin).astype(jnp.int32),
            jnp.minimum(jnp.asarray(w_eff).astype(jnp.int32), W),
            jnp.asarray(np.round(table).astype(np.int32)))


def result_shapes(B: int, LS: int, W: int, with_dirs: bool):
    """Output buffers of the FFI call: int32 score / end_i / end_j and
    the direction plane ([B, LS, W] bytes, or empty when score-only)."""
    i32 = jax.ShapeDtypeStruct((B,), jnp.int32)
    dirs = jax.ShapeDtypeStruct((B, LS, W) if with_dirs else (0,),
                                jnp.uint8)
    return (i32, i32, i32, dirs)


def banded_dp_cuda(s_codes, t_codes, s_lens, t_lens, dmin, *, W: int,
                   subst, go, ge, flags: ModeFlags, with_dirs: bool = False,
                   w_eff=None):
    """The CUDA kernel with :func:`~biseqt_jax.ops.banded_dp.banded_dp`'s
    signature and result.  Raises ``ValueError`` for a problem outside
    :func:`supports`."""
    _check_gap_scores(go, ge)
    LS = s_codes.shape[1]
    LT = t_codes.shape[1]
    if not supports(subst, go, ge, W, LS, LT):
        raise ValueError(
            "banded_dp_cuda takes integer scores, W a multiple of %d up "
            "to %d and at most %d letters (see cuda_dp.supports)"
            % (LANE_BLOCK, MAX_W, MAX_A))
    target = load()
    args = kernel_inputs(s_codes, t_codes, s_lens, t_lens, dmin, w_eff,
                         subst, W=W)
    return _call(target, *args, W=int(W), go=int(round(float(go))),
                 ge=int(round(float(ge))), bits=mode_bits(flags),
                 with_dirs=bool(with_dirs))


@functools.partial(jax.jit, static_argnames=("target", "W", "go", "ge",
                                             "bits", "with_dirs"))
def _call(target, s, t, sl, tl, dmin, w_eff, table, *, W, go, ge, bits,
          with_dirs):
    B, LS = s.shape
    score, ei, ej, dirs = jax.ffi.ffi_call(
        target, result_shapes(B, LS, W, with_dirs))(
        s, t, sl, tl, dmin, w_eff, table, W=np.int32(W), go=np.int32(go),
        ge=np.int32(ge), flags=np.int32(bits))
    # the kernel reports an unreachable optimum as its integer NEG
    score = jnp.where(score <= -(1 << 29), NEG, score.astype(jnp.float32))
    if not with_dirs:
        dirs = jnp.zeros((), jnp.uint8)
    return DPResult(score=score, end_i=ei, end_j=ej, dirs=dirs)
