"""The CUDA DP kernel, its wrapper and the engine selector.

The kernel itself runs only on an NVIDIA GPU: those tests carry the
``gpu`` marker and skip elsewhere (run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist``).
Everything around it — the selection rule, argument preparation, the
build command — is host code and is tested here on the CPU.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from biseqt_jax.matrices import BLOSUM62, PAM250, reduced_matrix
from biseqt_jax.ops import cuda_dp, engine
from biseqt_jax.ops.banded_dp import ModeFlags, banded_dp

import dp_cases


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")


UNIT = dp_cases.unit_subst()


@pytest.mark.parametrize("subst,go,ge,W,ok", [
    (UNIT, -2.0, -1.0, 128, True),
    (BLOSUM62, -11.0, -1.0, 256, True),
    (PAM250, -10.0, -2.0, 2048, True),
    (reduced_matrix(BLOSUM62), -11.0, -1.0, 384, True),
    (UNIT, -2.5, -1.0, 128, False),       # fractional gap score
    (UNIT * 0.5, -2.0, -1.0, 128, False),  # fractional substitution
    (UNIT, -2.0, -1.0, 96, False),        # W not a multiple of 128
    (UNIT, -2.0, -1.0, 4096, False),      # W beyond one block
    (np.zeros((40, 40)), -2.0, -1.0, 128, False),  # alphabet > 32
])
def test_supports_rule(subst, go, ge, W, ok):
    assert cuda_dp.supports(subst, go, ge, W, 10_000, 10_000) is ok


def test_supports_bounds_score_range():
    """Scores that could leave int32's safe range go to the lax engine."""
    assert cuda_dp.supports(UNIT * 100, -200.0, -100.0, 128, 10_000,
                            10_000)
    assert not cuda_dp.supports(UNIT * 100, -200.0, -100.0, 128,
                                1_000_000, 1_000_000)


@pytest.mark.parametrize("platform,W,expect", [
    ("cpu", 128, "lax"),
    ("gpu", 128, "cuda"),
    ("gpu", 96, "lax"),
])
def test_select_engine_table(monkeypatch, platform, W, expect):
    loads = []
    monkeypatch.setattr(cuda_dp, "load", lambda: loads.append(1))
    got = engine.select_engine(UNIT, -2.0, -1.0, W, 100, 100,
                               platform=platform)
    assert got == expect
    assert bool(loads) == (expect == "cuda")


def test_select_engine_unknown_platform_raises():
    with pytest.raises(RuntimeError, match="no banded-DP engine"):
        engine.select_engine(UNIT, -2.0, -1.0, 128, 100, 100,
                             platform="metal")


def test_select_engine_missing_gpu_library_raises(monkeypatch, tmp_path):
    """No nvcc on a GPU host: the selector raises instead of quietly
    running the lax engine."""
    cuda_dp.load.cache_clear()
    monkeypatch.setattr(cuda_dp, "_SO", str(tmp_path / "missing.so"))
    monkeypatch.setattr(cuda_dp.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_dp, "_CUDA_ROOTS", ())
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    try:
        with pytest.raises(RuntimeError, match="needs nvcc"):
            engine.select_engine(UNIT, -2.0, -1.0, 128, 100, 100,
                                 platform="gpu")
    finally:
        cuda_dp.load.cache_clear()


def test_build_command_targets_hopper(monkeypatch):
    monkeypatch.setattr(cuda_dp, "_nvcc", lambda: "nvcc")
    cmd = cuda_dp.build_command("out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-I") + 1] == jax.ffi.include_dir()
    assert cmd[-1].endswith("banded_dp.cu") and "out.so" in cmd


@pytest.mark.parametrize("with_dirs", [False, True])
def test_result_shapes(with_dirs):
    score, ei, ej, dirs = cuda_dp.result_shapes(6, 40, 256, with_dirs)
    for r in (score, ei, ej):
        assert r.shape == (6,) and r.dtype == jnp.int32
    assert dirs.dtype == jnp.uint8
    assert dirs.shape == ((6, 40, 256) if with_dirs else (0,))


def test_kernel_inputs_dtypes_and_width(rng):
    case = dp_cases.make_case("ragged", rng)
    (s, t, sl, tl, dmin), kw = dp_cases.engine_args(case)
    got = cuda_dp.kernel_inputs(s, t, sl, tl, dmin, None, BLOSUM62, W=128)
    assert [x.dtype for x in got] == [jnp.int8, jnp.int8] + [jnp.int32] * 5
    np.testing.assert_array_equal(got[5], np.full((dp_cases.B,), 128))
    np.testing.assert_array_equal(got[6], BLOSUM62)
    wide = np.full((dp_cases.B,), 999, np.int32)
    got = cuda_dp.kernel_inputs(s, t, sl, tl, dmin, wide, UNIT, W=128)
    np.testing.assert_array_equal(got[5], np.full((dp_cases.B,), 128))


def test_mode_bits_match_native_flags():
    from biseqt_jax import native

    for flags in dp_cases.FLAGS.values():
        assert cuda_dp.mode_bits(flags) == native._flags_of(flags)


def test_banded_dp_cuda_rejects_unsupported(rng):
    case = dp_cases.make_case("ragged", rng)
    args, kw = dp_cases.engine_args(case)
    kw["go"] = -2.5
    with pytest.raises(ValueError, match="integer scores"):
        cuda_dp.banded_dp_cuda(*args, flags=ModeFlags(), **kw)


# --- on the card -----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", dp_cases.KINDS)
@pytest.mark.parametrize("mode", list(dp_cases.FLAGS))
def test_cuda_matches_lax(gpu, rng, mode, kind):
    case = dp_cases.make_case(kind, rng)
    dp_cases.assert_engines_agree(cuda_dp.banded_dp_cuda, banded_dp, case,
                                  dp_cases.FLAGS[mode])


@pytest.mark.gpu
@pytest.mark.parametrize("W", [256, 384, 1024])
@pytest.mark.parametrize("mode", ["global", "local", "overlap"])
def test_cuda_matches_lax_multi_warp(gpu, rng, mode, W):
    """Bands wider than one warp: the E scan and the up-neighbour cross
    warps through shared memory."""
    case = dp_cases.make_case("ragged", rng, L=3 * W, W=W, w_max=W)
    dp_cases.assert_engines_agree(cuda_dp.banded_dp_cuda, banded_dp, case,
                                  dp_cases.FLAGS[mode])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["global", "local", "overlap"])
def test_cuda_matches_lax_blosum62(gpu, rng, mode):
    case = dp_cases.make_case("ragged", rng, L=300, W=256, A=20,
                              subst=BLOSUM62, go=-11.0, ge=-1.0,
                              w_max=200)
    dp_cases.assert_engines_agree(cuda_dp.banded_dp_cuda, banded_dp, case,
                                  dp_cases.FLAGS[mode])


@pytest.mark.gpu
@pytest.mark.parametrize("alntype", ["B_GLOBAL", "B_LOCAL", "B_OVERLAP"])
def test_aligner_default_backend_on_gpu(gpu, rng, monkeypatch, alntype):
    """pw.Aligner's default backend takes the CUDA kernel on a GPU, and its
    scores and transcripts equal the C++ engine's."""
    from biseqt_jax import pw
    from biseqt_jax.sequence import Alphabet
    from biseqt_jax.stochastics import MutationProcess, rand_seq

    A4 = Alphabet("ACGT")
    S = rand_seq(A4, 3000, rng=rng)
    T, _ = MutationProcess(A4, subst_probs=0.1, go_prob=0.02, ge_prob=0.2,
                           rng=rng).mutate(S)
    kw = dict(alnmode=pw.BANDED_MODE, alntype=getattr(pw, alntype),
              diag_range=(-150, 150), go_score=-3, ge_score=-1)
    calls = []
    kernel = engine.ENGINES["cuda"]
    monkeypatch.setitem(engine.ENGINES, "cuda",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    with pw.Aligner(S, T, **kw) as aln:
        got = aln.solve()
        tx = aln.traceback()
    assert calls, "the default backend did not take the CUDA kernel"
    with pw.Aligner(S, T, backend="native", **kw) as aln:
        want = aln.solve()
        ref = aln.traceback()
    assert got == want
    assert (str(tx.transcript), tx.origin_start, tx.mutate_start) == (
        str(ref.transcript), ref.origin_start, ref.mutate_start)
