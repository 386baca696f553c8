"""Utils + profiling tests."""

import json
import os
import time

import pytest

from biseqt_jax.utils import with_dumpfile, ProgressIndicator, Timer
from biseqt_jax import profiling, utils


def test_with_dumpfile(tmp_path):
    calls = []

    @with_dumpfile
    def compute(x):
        calls.append(x)
        return x * 2

    p = str(tmp_path / "r.pkl")
    assert compute(21, dumpfile=p) == 42
    assert compute(21, dumpfile=p) == 42  # cached, no second call
    assert calls == [21]
    assert compute(21, dumpfile=p, ignore_existing=True) == 42
    assert calls == [21, 21]


def test_timer_and_phase():
    with Timer() as t:
        time.sleep(0.01)
    assert t.elapsed >= 0.01
    with profiling.Phase("unit-test", cells=10**9):
        time.sleep(0.005)
    rep = profiling.report(reset=True)
    row = json.loads(rep.splitlines()[-1])
    assert row["phase"] == "unit-test"
    assert row["gcups"] > 0


@pytest.mark.parametrize("env,expect", [
    ({}, os.path.join(utils.CHECKOUT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""},
     os.path.join(utils.CHECKOUT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
])
def test_compile_cache_dir(env, expect):
    assert utils.compile_cache_dir(env) == expect


@pytest.mark.parametrize("preset", [None, "cache-from-env"])
def test_enable_compile_cache_sets_only_without_env(monkeypatch, preset):
    import jax

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    if preset:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", preset)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = utils.enable_compile_cache()
    if preset:
        assert path is None and updates == []
    else:
        assert updates == [("jax_compilation_cache_dir", path)]
        assert path.endswith(".jax_cache")


def test_phase_counts_bytes():
    with profiling.Phase("unit-test-bytes", nbytes=1 << 20):
        pass
    with profiling.Phase("unit-test-bytes", nbytes=1 << 20):
        pass
    assert profiling.counters()["unit-test-bytes"]["bytes"] == 2 << 20
    rows = [json.loads(r) for r in profiling.report(reset=True).splitlines()]
    assert {"phase": "unit-test-bytes", "calls": 2, "bytes": 2 << 20}.items() \
        <= next(r for r in rows if r["phase"] == "unit-test-bytes").items()
