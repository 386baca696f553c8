"""FASTA ingest benchmark: 5 Mbp genome -> DB, native packer vs Python reader.

VERDICT round-3 item 5: the reference's `DB.load_fasta` streams a genome
through per-row SQLite inserts (minutes at 5 Mbp); this framework's
native tier must ingest a 5 Mbp FASTA in < 1 s end-to-end (pack + hash +
pool write + SQLite metadata row).

Usage: python experiments/ingest_bench.py [--size 5000000] [--python-too]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    from biseqt_jax.utils import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=5_000_000)
    ap.add_argument("--python-too", action="store_true",
                    help="also time the pure-Python reader tier")
    args = ap.parse_args()

    from biseqt_jax.sequence import Alphabet
    from biseqt_jax.database import DB

    A4 = Alphabet("ACGT")
    rng = np.random.default_rng(7)
    letters = np.frombuffer(b"ACGT", np.uint8)
    out = {"size": args.size}

    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "genome.fa")
        codes = rng.integers(0, 4, args.size)
        txt = letters[codes].tobytes().decode()
        with open(fa, "w") as f:
            f.write(">chr1 synthetic\n")
            for off in range(0, len(txt), 80):
                f.write(txt[off:off + 80] + "\n")

        db_path = os.path.join(td, "db.sqlite")
        t0 = time.perf_counter()
        db = DB(db_path, A4)
        recs = db.load_fasta(fa)
        out["native_ingest_s"] = round(time.perf_counter() - t0, 4)
        assert len(recs) == 1
        t0 = time.perf_counter()
        seq = db.load_from_record(recs[0])
        out["load_record_s"] = round(time.perf_counter() - t0, 4)
        assert len(seq) == args.size
        db.close()

        if args.python_too:
            db2 = DB(os.path.join(td, "db2.sqlite"), A4)
            t0 = time.perf_counter()
            with open(fa) as f:
                recs2 = db2.load_fasta(f, source_file=fa)
            out["python_ingest_s"] = round(time.perf_counter() - t0, 4)
            assert recs2[0].content_id == recs[0].content_id
            db2.close()

    print(json.dumps(out))


if __name__ == "__main__":
    main()
