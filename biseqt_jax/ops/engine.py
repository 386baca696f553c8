"""Choice of the banded-DP engine, from the platform and the problem.

=========  =====================================================
platform   engine
=========  =====================================================
``cpu``    ``lax``: :func:`~biseqt_jax.ops.banded_dp.banded_dp`
``gpu``    ``cuda``: :func:`~biseqt_jax.ops.cuda_dp.banded_dp_cuda`
           when :func:`~biseqt_jax.ops.cuda_dp.supports` the
           problem (integer scores, W a multiple of 128 up to
           2048), else ``lax``
other      ``RuntimeError``
=========  =====================================================

On a GPU the CUDA library must build and load: a failure raises and is
never answered by running another engine.
"""

from __future__ import annotations

import jax

from .banded_dp import banded_dp
from . import cuda_dp

__all__ = ["select_engine", "banded_dp_auto", "ENGINES"]

ENGINES = {"lax": banded_dp, "cuda": cuda_dp.banded_dp_cuda}


def select_engine(subst, go, ge, W: int, LS: int, LT: int,
                  platform: str = None) -> str:
    """Name of the engine for this problem on ``platform`` (default: the
    platform JAX computes on)."""
    if platform is None:
        platform = jax.default_backend()
    if platform == "cpu":
        return "lax"
    if platform == "gpu":
        if not cuda_dp.supports(subst, go, ge, W, LS, LT):
            return "lax"
        cuda_dp.load()
        return "cuda"
    raise RuntimeError(
        "no banded-DP engine for platform %r (supported: cpu, gpu)"
        % (platform,))


def banded_dp_auto(s_codes, t_codes, s_lens, t_lens, dmin, *, W: int,
                   subst, go, ge, flags, with_dirs: bool = False,
                   w_eff=None, engine: str = None):
    """Run the selected engine (or the named one) on a batch; arguments
    and result as :func:`~biseqt_jax.ops.banded_dp.banded_dp`."""
    if engine is None:
        engine = select_engine(subst, go, ge, W, s_codes.shape[1],
                               t_codes.shape[1])
    return ENGINES[engine](
        s_codes, t_codes, s_lens, t_lens, dmin, W=W, subst=subst, go=go,
        ge=ge, flags=flags, with_dirs=with_dirs, w_eff=w_eff)
