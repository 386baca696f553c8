"""Mutation-model tests (ref strategy: tests/test_stochastics.py)."""

import numpy as np
import pytest

from biseqt_jax.sequence import Alphabet, EditTranscript
from biseqt_jax.stochastics import (
    rand_seq, rand_read, MutationProcess,
    binomial_to_normal, normal_neg_log_pvalue,
)

A4 = Alphabet("ACGT")


def test_rand_seq_distribution(rng):
    s = rand_seq(A4, 4000, rng=rng)
    counts = np.bincount(np.asarray(s.contents), minlength=4)
    assert counts.min() > 800  # roughly uniform
    # with skewed p
    s2 = rand_seq(A4, 2000, p=[0.7, 0.1, 0.1, 0.1], rng=rng)
    c2 = np.bincount(np.asarray(s2.contents), minlength=4)
    assert c2[0] > 1200


def test_rand_read(rng):
    s = rand_seq(A4, 500, rng=rng)
    for read, pos in rand_read(s, len_mean=100, len_sd=5, num=20, rng=rng):
        assert s[pos:pos + len(read)] == read
        assert 70 < len(read) < 130


def test_mutate_transcript_consistency(rng):
    M = MutationProcess(A4, subst_probs=0.15, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    s = rand_seq(A4, 300, rng=rng)
    mut, tx = M.mutate(s)
    assert isinstance(tx, EditTranscript)
    # transcript projections must match both sequence lengths exactly
    assert tx.origin_len == len(s)
    assert tx.mutate_len == len(mut)
    # M ops really are matches, S ops mismatches
    i = j = 0
    for op in tx:
        if op == "M":
            assert s[i] == mut[j]
            i += 1
            j += 1
        elif op == "S":
            assert s[i] != mut[j]
            i += 1
            j += 1
        elif op == "I":
            j += 1
        else:
            i += 1


def test_mutate_rates(rng):
    """Observed edit rates track the configured probabilities."""
    M = MutationProcess(A4, subst_probs=0.2, go_prob=0.0, ge_prob=0.0,
                        rng=rng)
    s = rand_seq(A4, 8000, rng=rng)
    _, tx = M.mutate(s)
    ops = str(tx)
    assert ops.count("I") == 0 and ops.count("D") == 0
    sub_rate = ops.count("S") / len(ops)
    # S is observed when the channel picks a different letter: rate = 0.2
    assert 0.16 < sub_rate < 0.24
    # with gaps
    Mg = MutationProcess(A4, subst_probs=0.0, go_prob=0.1, ge_prob=0.0,
                         rng=rng)
    _, txg = Mg.mutate(s)
    g = str(txg)
    gap_rate = (g.count("I") + g.count("D")) / len(g)
    assert 0.06 < gap_rate < 0.14


def test_noisy_read(rng):
    M = MutationProcess(A4, subst_probs=0.1, go_prob=0.05, ge_prob=0.2,
                        rng=rng)
    s = rand_seq(A4, 1000, rng=rng)
    read, start, tx = M.noisy_read(s, len_mean=200, len_sd=10)
    assert 0 <= start <= 1000 - tx.origin_len
    assert tx.mutate_len == len(read)


def test_log_odds_scores():
    M = MutationProcess(A4, subst_probs=0.1, go_prob=0.05, ge_prob=0.2)
    subst, go, ge = M.log_odds_scores()
    subst = np.asarray(subst)
    # diagonal (match) scores positive, off-diagonal negative
    assert (np.diag(subst) > 0).all()
    off = subst[~np.eye(4, dtype=bool)]
    assert (off < 0).all()
    assert go < 0 and ge < 0
    # higher error -> lower match reward
    M2 = MutationProcess(A4, subst_probs=0.3, go_prob=0.05, ge_prob=0.2)
    s2, _, _ = M2.log_odds_scores()
    assert np.asarray(s2)[0, 0] < subst[0, 0]


def test_binomial_to_normal_and_pvalues():
    mu, sd = binomial_to_normal(1000, 0.1)
    assert float(mu) == pytest.approx(100.0)
    assert float(sd) == pytest.approx(np.sqrt(1000 * 0.1 * 0.9), rel=1e-5)
    # far-tail observation -> large neg-log p; mean -> ~log 2
    far = float(normal_neg_log_pvalue(mu, sd, 200.0))
    mid = float(normal_neg_log_pvalue(mu, sd, 100.0))
    assert far > 50
    assert mid == pytest.approx(np.log(2), abs=0.05)
    # stability very far out (no inf/nan)
    huge = float(normal_neg_log_pvalue(mu, sd, 100 + 50 * float(sd)))
    assert np.isfinite(huge) and huge > 1000


def test_mutation_process_matrix_form(rng):
    m = np.full((4, 4), 0.05)
    np.fill_diagonal(m, 0.85)
    M = MutationProcess(A4, subst_probs=m, rng=rng)
    s = rand_seq(A4, 2000, rng=rng)
    mut, tx = M.mutate(s)
    assert 0.1 < str(tx).count("S") / len(tx) < 0.2


def test_device_tier_batch_sim(rng):
    """rand_seq_batch + mutate_batch: calibrated rates, valid outputs."""
    import jax
    import jax.numpy as jnp
    from biseqt_jax.stochastics import rand_seq_batch, mutate_batch
    from biseqt_jax.sequence import PAD

    key = jax.random.PRNGKey(0)
    B, L = 16, 2000
    codes = rand_seq_batch(key, B, L)
    counts = np.bincount(np.asarray(codes).ravel() % 4, minlength=4)
    assert counts.min() > B * L / 4 * 0.9

    lengths = jnp.full((B,), L, jnp.int32)
    mut, mlen = mutate_batch(
        jax.random.PRNGKey(1), codes, lengths,
        subst_prob=0.2, go_prob=0.1, ge_prob=0.2,
    )
    mut_np, mlen_np = np.asarray(mut), np.asarray(mlen)
    # lengths near L (ins/del balance), PAD tails exact
    assert (np.abs(mlen_np - L) < 0.2 * L).all()
    for b in range(B):
        assert (mut_np[b, mlen_np[b]:] == PAD).all()
        assert (mut_np[b, :mlen_np[b]] >= 0).all()
    # substitution rate: compare aligned prefix match rate roughly
    same = (np.asarray(codes) == mut_np[:, :L]).mean()
    assert same < 0.9  # mutations present
    # identity channel: no changes at zero rates
    mut0, mlen0 = mutate_batch(
        jax.random.PRNGKey(2), codes, lengths,
        subst_prob=0.0, go_prob=0.0, ge_prob=0.0,
    )
    assert (np.asarray(mlen0) == L).all()
    assert (np.asarray(mut0)[:, :L] == np.asarray(codes)).all()
