"""Banded-DP throughput of the selected engine on one GPU.

Config-1 shape: 4096 pairs of 10 kbp, band width 100, local alignment,
unit DNA scores (go -2, ge -1).  Two legs, each on fresh inputs per run
and timed to ``block_until_ready``:

* score-only: the DP launch alone;
* transcripts: 2048 homologous pairs, DP with direction bytes, the copy
  of the plane to the host and the C++ walk to MSID strings.

Prints the card's name and power limit, then ONE JSON line.  Exits
non-zero without a result when JAX finds no GPU.

Usage: python bench.py        (one process: it takes the whole card)
"""

import json
import subprocess
import sys
import time

import numpy as np

B, L, LEN, BW, W = 4096, 10240, 10000, 100, 128
B_TX = 2048
RUNS = 5


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def make_batch(seed, n, sub_rate=0.1):
    import jax.numpy as jnp

    rr = np.random.default_rng(seed * 1_000_003 + 11)
    s = rr.integers(0, 4, (n, L), dtype=np.int8)
    t = s.copy()
    flip = rr.random((n, L)) < sub_rate
    t[flip] = (t[flip] + rr.integers(1, 4, int(flip.sum()))) % 4
    lens = np.full((n,), LEN, np.int32)
    host = dict(s=s, t=t, lens=lens,
                dmin=np.full((n,), BW // 2 - W + 1, np.int32))
    dev = [jnp.asarray(x) for x in (s, t, lens, lens, host["dmin"])]
    return host, dev


def main():
    import jax
    import jax.numpy as jnp
    from biseqt_jax import native
    from biseqt_jax.ops.banded_dp import ModeFlags
    from biseqt_jax.ops.engine import banded_dp_auto, select_engine
    from biseqt_jax.utils import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("bench.py needs a GPU; JAX found %r" % dev.platform,
              file=sys.stderr)
        return 1
    enable_compile_cache()
    print(card_line())
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    flags = ModeFlags(local_start=True, local_end=True)
    kw = dict(W=W, subst=subst, go=-2.0, ge=-1.0, flags=flags)
    engine = select_engine(subst, -2.0, -1.0, W, L, L)

    def run(dev_args, n, with_dirs):
        return banded_dp_auto(*dev_args, w_eff=jnp.full((n,), BW, jnp.int32),
                              with_dirs=with_dirs, engine=engine, **kw)

    # score-only
    batches = [make_batch(k, B)[1] for k in range(RUNS + 1)]
    t0 = time.perf_counter()
    run(batches[0], B, False).score.block_until_ready()
    compile_s = time.perf_counter() - t0
    score_s = []
    for args in batches[1:]:
        t0 = time.perf_counter()
        run(args, B, False).score.block_until_ready()
        score_s.append(time.perf_counter() - t0)
    del batches

    # transcripts: DP with dirs, D2H of the plane, C++ walk
    tx_s, d2h_s, walk_s = [], [], []
    for k in range(RUNS + 1):
        host, args = make_batch(100 + k, B_TX)
        t0 = time.perf_counter()
        res = run(args, B_TX, True)
        res.dirs.block_until_ready()
        t1 = time.perf_counter()
        dirs = np.asarray(res.dirs)
        t2 = time.perf_counter()
        ops, _, _ = native.traceback_batch(
            dirs, host["dmin"] + W - 1, host["s"], host["t"], host["lens"],
            host["lens"], np.asarray(res.end_i), np.asarray(res.end_j),
            flags)
        t3 = time.perf_counter()
        if k:
            tx_s.append(t3 - t0)
            d2h_s.append(t2 - t1)
            walk_s.append(t3 - t2)
        assert all(ops), "empty transcript"

    cells = B * LEN * BW
    out = {
        "metric": "banded_dp_gcups",
        "value": cells / float(np.median(score_s)) / 1e9,
        "unit": "GCUPS",
        "engine": engine,
        "score_only_s": score_s,
        "score_only_first_call_s": compile_s,
        "transcripts_gcups": B_TX * LEN * BW / float(np.median(tx_s)) / 1e9,
        "transcripts_s": tx_s,
        "dirs_d2h_s": d2h_s,
        "walk_s": walk_s,
        "dirs_plane_bytes": int(dirs.nbytes),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_line(),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
