"""End-to-end user story: FASTA file -> DB -> k-mer index (via event
hooks) -> Word-Blot discovery -> batched banded extension with
transcripts.  The workflow a reference (biseqt) user strings together by
hand, driven through this framework's layers in one test."""

import numpy as np

from biseqt_jax.sequence import Alphabet
from biseqt_jax.database import DB
from biseqt_jax.kmers import KmerIndex
from biseqt_jax.stochastics import rand_seq, MutationProcess
from biseqt_jax.pipeline import discover_and_extend
from biseqt_jax.pw import Alignment

A4 = Alphabet("ACGT")


def _write_fasta(path, named):
    with open(path, "w") as f:
        for name, seq in named:
            f.write(">%s planted\n" % name)
            s = str(seq)
            for k in range(0, len(s), 60):
                f.write(s[k:k + 60] + "\n")


def test_fasta_to_transcripts(tmp_path, rng):
    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.03, ge_prob=0.1,
                        rng=rng)
    core = rand_seq(A4, 600, rng=rng)
    S = rand_seq(A4, 300, rng=rng) + core + rand_seq(A4, 300, rng=rng)
    T = rand_seq(A4, 500, rng=rng) + M.mutate(core)[0] \
        + rand_seq(A4, 100, rng=rng)
    fa = str(tmp_path / "pair.fa")
    _write_fasta(fa, [("S", S), ("T", T)])

    # ingest through the DB; a KmerIndex subscribes via the event hook
    db = DB(str(tmp_path / "meta.db"), A4)
    idx = KmerIndex(8, A4, path=str(tmp_path / "kmers"))
    idx.attach_to(db)
    recs = db.load_fasta(fa)
    assert [r.attrs["name"] for r in recs] == ["S", "T"]
    idx.refresh()
    assert idx.num_seqs == 2 and idx.num_kmers > 0

    # pull the sequences back out of the DB and run the full pipeline
    S2 = db.load_from_record(recs[0])
    T2 = db.load_from_record(recs[1])
    assert str(S2) == str(S) and str(T2) == str(T)
    out = discover_and_extend(
        S2, T2, wordlen=8, K_min=250, p_min=0.6,
        with_transcripts=True,
    )
    assert out, "planted homology not discovered"
    best = out[0]
    assert best["score"] > 250
    aln = Alignment(
        S2, T2, best["transcript"],
        origin_start=best["origin_start"],
        mutate_start=best["mutate_start"],
    )
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    assert aln.calculate_score(subst, -3.0, -1.0) == \
        __import__("pytest").approx(best["score"], abs=1e-3)
    # the transcript covers most of the planted core
    assert len(best["transcript"]) > 450
