"""The lax banded engine against the numpy oracle, and the C++ walker on
its direction bytes — the reference both GPU engines are checked
against (the card-only comparison is in ``test_cuda_dp.py``)."""

import numpy as np
import pytest
import jax.numpy as jnp

from biseqt_jax.matrices import BLOSUM62
from biseqt_jax.ops.banded_dp import ModeFlags, banded_dp, traceback_path

import dp_cases
from oracle import dp_oracle, rescore


def _oracle_scores(case, flags):
    out = []
    for b in range(dp_cases.B):
        lo, hi = dp_cases.band(case, b)
        out.append(dp_oracle(
            case["s"][b, :case["sl"][b]], case["t"][b, :case["tl"][b]],
            case["subst"], case["go"], case["ge"], dmin=lo, dmax=hi,
            **flags._asdict()))
    return np.asarray(out)


def _lax(case, flags, with_dirs=False):
    args, kw = dp_cases.engine_args(case)
    return banded_dp(*args, flags=flags, with_dirs=with_dirs, **kw)


@pytest.mark.parametrize("kind", dp_cases.KINDS)
@pytest.mark.parametrize("mode", list(dp_cases.FLAGS))
def test_banded_dp_matches_oracle(rng, mode, kind):
    flags = dp_cases.FLAGS[mode]
    case = dp_cases.make_case(kind, rng)
    got = np.asarray(_lax(case, flags).score, np.float64)
    np.testing.assert_allclose(got, _oracle_scores(case, flags),
                               rtol=1e-6, atol=1e-3, err_msg=mode)


@pytest.mark.parametrize("mode", ["global", "local", "overlap"])
def test_banded_dp_blosum62_matches_oracle(rng, mode):
    flags = dp_cases.FLAGS[mode]
    case = dp_cases.make_case("ragged", rng, A=20, subst=BLOSUM62,
                              go=-11.0, ge=-1.0)
    got = np.asarray(_lax(case, flags).score, np.float64)
    np.testing.assert_allclose(got, _oracle_scores(case, flags),
                               rtol=1e-6, atol=1e-3, err_msg=mode)


def test_banded_dp_no_wrap_phantom(rng):
    """Adversarial band geometry for lane shifts: a rich bottom-edge
    diagonal (X vs X at d=0) and the global corner on the top edge
    (d=126).  An engine whose lane shifts wrap around lets the
    bottom-edge score reach the corner as an illegal teleported gap."""
    X = rng.integers(0, 4, 200).astype(np.int8)
    Z = rng.integers(0, 4, 126).astype(np.int8)
    S = np.concatenate([X, Z])
    T = X
    subst = dp_cases.unit_subst()
    res = banded_dp(
        jnp.asarray(S[None]), jnp.asarray(np.pad(T, (0, 126))[None]),
        jnp.asarray([326], jnp.int32), jnp.asarray([200], jnp.int32),
        jnp.asarray([-1], jnp.int32), W=128, subst=subst, go=-2.0,
        ge=-1.0, flags=ModeFlags(), w_eff=jnp.asarray([127], jnp.int32))
    want = dp_oracle(S, T, subst, -2.0, -1.0, dmin=0, dmax=126)
    assert float(res.score[0]) == pytest.approx(want, abs=1e-3)


@pytest.mark.parametrize("mode", list(dp_cases.FLAGS))
def test_native_walker_on_lax_dirs(rng, mode):
    """The one C++ walker (row layout) reproduces the numpy walker on
    the lax engine's direction bytes, and every transcript rescores to
    its score."""
    from biseqt_jax import native

    if not native.available():
        pytest.skip("native library unavailable")
    flags = dp_cases.FLAGS[mode]
    case = dp_cases.make_case("ragged", rng)
    res = _lax(case, flags, with_dirs=True)
    walked = dp_cases.walk(res, case, flags)
    dirs = np.asarray(res.dirs)
    for b, got in enumerate(walked):
        if got is None:
            continue
        dmax = int(case["dmin"][b]) + case["W"] - 1
        want = traceback_path(
            dirs[b], case["s"][b], case["t"][b], int(res.end_i[b]),
            int(res.end_j[b]), banded=True, dmax=dmax, flags=flags)
        assert got == want, (mode, b)
        ops, si, sj = got
        score, _, _ = rescore(ops, case["s"][b], case["t"][b], si, sj,
                              case["subst"], case["go"], case["ge"])
        assert score == pytest.approx(float(res.score[b]), abs=1e-3)
