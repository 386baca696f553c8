"""Stochastic models: random sequences, mutation processes, null-model math.

Accelerator rebuild of ``biseqt/stochastics.py — rand_seq, MutationProcess,
binomial_to_normal, normal_neg_log_pvalue, band_radius`` (band radius proper
lives in :mod:`biseqt_jax.blot`).

Two tiers, same math:
  * Host tier (numpy RNG): the object API (``MutationProcess.mutate`` etc.)
    used by tests/experiments where variable-length Python sequences are the
    natural currency.
  * Device tier (jax.random): vectorized batch simulation
    (:func:`rand_seq_batch`, :func:`mutate_batch`) with static shapes and
    capacity-bounded outputs, used to generate benchmark workloads on-device.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .sequence import Alphabet, Sequence, EditTranscript, PAD

__all__ = [
    "rand_seq",
    "rand_read",
    "MutationProcess",
    "binomial_to_normal",
    "normal_neg_log_pvalue",
    "np_log_erfc",
    "rand_seq_batch",
    "mutate_batch",
]


# ---------------------------------------------------------------------------
# Host-tier simulation (object API, mirrors the reference contract)
# ---------------------------------------------------------------------------

def rand_seq(alphabet: Alphabet, size: int, p=None, rng=None) -> Sequence:
    """A random sequence of the given length over ``alphabet``.

    Mirrors ``biseqt/stochastics.py — rand_seq``; letters drawn iid with
    probabilities ``p`` (uniform by default).
    """
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    contents = rng.choice(len(alphabet), size=int(size), p=p)
    return Sequence(alphabet, [int(c) for c in contents])


def rand_read(seq: Sequence, len_mean, len_sd=1.0, num=1, rng=None):
    """Generate lazy random reads (substrings) from ``seq``.

    Mirrors ``biseqt/stochastics.py — MutationProcess`` read sampling: read
    lengths ~ Normal(len_mean, len_sd) clamped to [1, len(seq)], start
    positions uniform.  Yields ``(read, start_pos)`` tuples.  Error-free;
    compose with :meth:`MutationProcess.mutate` for noisy reads.
    """
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    n = len(seq)
    for _ in range(int(num)):
        L = int(round(rng.normal(len_mean, len_sd)))
        L = max(1, min(n, L))
        start = int(rng.integers(0, n - L + 1))
        yield seq[start : start + L], start


class MutationProcess:
    """A per-letter substitution + affine-indel mutation model.

    Mirrors ``biseqt/stochastics.py — MutationProcess``:

    * ``subst_probs``: either a full |Σ|×|Σ| matrix of P(b|a) or a scalar
      uniform error rate (diagonal = 1-p, off-diagonals = p/(|Σ|-1)).
    * ``go_prob``/``ge_prob``: gap-open and gap-extend probabilities of the
      affine indel model (insertions and deletions equally likely).
    * :meth:`mutate` returns the mutant plus the MSID edit transcript — the
      same transcript alphabet the aligner emits, so simulation is its own
      test oracle.
    * :meth:`log_odds_scores` converts the same probabilities into aligner
      scores, keeping simulation and scoring one consistent model.
    """

    def __init__(self, alphabet, subst_probs=None, ge_prob=0.0, go_prob=0.0,
                 insert_dist=None, rng=None):
        assert isinstance(alphabet, Alphabet)
        self.alphabet = alphabet
        n = len(alphabet)
        if subst_probs is None:
            subst_probs = 0.0
        if np.isscalar(subst_probs):
            p = float(subst_probs)
            m = np.full((n, n), p / max(n - 1, 1))
            np.fill_diagonal(m, 1.0 - p)
            self.subst_probs = m
        else:
            self.subst_probs = np.asarray(subst_probs, dtype=np.float64)
            assert self.subst_probs.shape == (n, n)
            assert np.allclose(self.subst_probs.sum(axis=1), 1.0, atol=1e-8)
        assert 0 <= ge_prob < 1 and 0 <= go_prob < 1
        self.go_prob = float(go_prob)
        self.ge_prob = float(ge_prob)
        # distribution over inserted letters (uniform default)
        if insert_dist is None:
            insert_dist = np.full((n,), 1.0 / n)
        self.insert_dist = np.asarray(insert_dist, dtype=np.float64)
        self._rng = (
            rng if isinstance(rng, np.random.Generator)
            else np.random.default_rng(rng)
        )

    # -- simulation -----------------------------------------------------------
    def mutate(self, seq: Sequence, rng=None):
        """Mutate ``seq``; returns ``(mutant, EditTranscript)``.

        At each position: with prob ``go_prob`` open a gap (insertion or
        deletion with equal probability), extending with prob ``ge_prob``;
        otherwise copy the letter through the substitution channel.
        """
        rng = self._rng if rng is None else (
            rng if isinstance(rng, np.random.Generator)
            else np.random.default_rng(rng)
        )
        n = len(self.alphabet)
        out = []
        ops = []
        i = 0
        L = len(seq)
        contents = seq.contents
        while i < L:
            if self.go_prob and rng.random() < self.go_prob:
                # open a gap; decide insertion vs deletion
                if rng.random() < 0.5:
                    # insertion run
                    ops.append("I")
                    out.append(int(rng.choice(n, p=self.insert_dist)))
                    while rng.random() < self.ge_prob:
                        ops.append("I")
                        out.append(int(rng.choice(n, p=self.insert_dist)))
                    # the current origin letter still needs consuming; loop
                    continue
                else:
                    # deletion run
                    ops.append("D")
                    i += 1
                    while i < L and rng.random() < self.ge_prob:
                        ops.append("D")
                        i += 1
                    continue
            a = contents[i]
            b = int(rng.choice(n, p=self.subst_probs[a]))
            out.append(b)
            ops.append("M" if a == b else "S")
            i += 1
        mutant = Sequence(self.alphabet, out)
        return mutant, EditTranscript("".join(ops))

    def noisy_read(self, seq: Sequence, len_mean, len_sd=1.0, rng=None):
        """A single noisy read: sample a substring then mutate it.

        Returns ``(read, start_pos, transcript)``.
        """
        rng = self._rng if rng is None else (
            rng if isinstance(rng, np.random.Generator)
            else np.random.default_rng(rng)
        )
        (clean, start), = list(rand_read(seq, len_mean, len_sd, num=1, rng=rng))
        read, tx = self.mutate(clean, rng=rng)
        return read, start, tx

    # -- score derivation -----------------------------------------------------
    def log_odds_scores(self, null_process=None):
        """Substitution/gap scores from the mutation model via log-odds.

        Mirrors ``biseqt/stochastics.py — MutationProcess.log_odds_scores``:
        S[a][b] = log(P(b|a) / P0(b|a)) against a null process (uniform
        letters by default); gap scores are log probabilities of gap events:
        ``go_score = log(go_prob)``, ``ge_score = log(ge_prob)``.

        Returns ``(subst_scores, go_score, ge_score)``.
        """
        n = len(self.alphabet)
        if null_process is None:
            null = np.full((n, n), 1.0 / n)
        else:
            null = np.asarray(null_process.subst_probs)
        with np.errstate(divide="ignore"):
            subst = np.log(self.subst_probs) - np.log(null)
        go = np.log(self.go_prob) if self.go_prob > 0 else -np.inf
        ge = np.log(self.ge_prob) if self.ge_prob > 0 else -np.inf
        return subst.tolist(), float(go), float(ge)


# ---------------------------------------------------------------------------
# Null-model math (normal approximations, stable log p-values)
# ---------------------------------------------------------------------------

def binomial_to_normal(n, p):
    """Mean and standard deviation of the normal approximating Binomial(n, p).

    Mirrors ``biseqt/stochastics.py — binomial_to_normal``.
    Works on scalars or arrays (numpy or jax).
    """
    mu = n * p
    sd = jnp.sqrt(jnp.asarray(n, dtype=jnp.float32) * p * (1.0 - p))
    return mu, sd


def np_log_erfc(z):
    """Numerically stable ``log(erfc(z))`` for large positive z (jax).

    For z <= 3 uses the direct formula; beyond that the asymptotic expansion
    ``erfc(z) ~ exp(-z^2) / (z sqrt(pi)) (1 - 1/(2 z^2))``.
    """
    z = jnp.asarray(z, dtype=jnp.float32)
    direct = jnp.log(jax.scipy.special.erfc(jnp.minimum(z, 3.0)))
    z_safe = jnp.maximum(z, 3.0)
    asym = (
        -z_safe * z_safe
        - jnp.log(z_safe)
        - 0.5 * jnp.log(jnp.pi)
        + jnp.log1p(-1.0 / (2.0 * z_safe * z_safe))
    )
    return jnp.where(z <= 3.0, direct, asym)


def normal_neg_log_pvalue(mu, sd, x):
    """−log of the upper-tail p-value of Normal(mu, sd) at x, stably.

    Mirrors ``biseqt/stochastics.py — normal_neg_log_pvalue``:
    ``-log P(X >= x)`` with ``X ~ N(mu, sd)``; large positive values mean x
    is far in the upper tail.  Vectorized; safe for sd == 0.
    """
    sd = jnp.asarray(sd, dtype=jnp.float32)
    z = (jnp.asarray(x, dtype=jnp.float32) - mu) / jnp.where(sd > 0, sd, 1.0)
    z = z / jnp.sqrt(2.0)
    # P(X >= x) = erfc(z)/2
    out = -(np_log_erfc(z) - jnp.log(2.0))
    return jnp.where(sd > 0, out, jnp.where(jnp.asarray(x) > mu, jnp.inf, 0.0))


# ---------------------------------------------------------------------------
# Device-tier simulation (jax, static shapes)
# ---------------------------------------------------------------------------

def rand_seq_batch(key, batch, length, alphabet_len=4, p=None):
    """Batch of random code rows, shape ``[batch, length]`` int8 (device)."""
    if p is None:
        return jax.random.randint(
            key, (batch, length), 0, alphabet_len, dtype=jnp.int8
        )
    logits = jnp.log(jnp.asarray(p, dtype=jnp.float32))
    draws = jax.random.categorical(key, logits, shape=(batch, length))
    return draws.astype(jnp.int8)


def mutate_batch(key, codes, lengths, subst_prob, go_prob, ge_prob,
                 alphabet_len=4, max_ins_run=8):
    """Vectorized mutation of a packed batch (capacity-bounded, jit-safe).

    A vectorized reformulation of :meth:`MutationProcess.mutate`: every
    origin position independently draws (a) a substitution through the
    error channel, (b) a deletion flag with the sequential model's
    *marginal* deletion rate ``(go/2)/(1-ge)``, and (c) an insertion run
    of Geometric(ge) length opened with prob go/2.  The mutant is then
    materialized by a static-shape gather: output slot q maps back to its
    origin slot via a searchsorted over the per-position output widths
    (the same ragged-expansion inversion :func:`ops.tables.expand_join`
    uses).

    Run-length coupling of deletions is approximated iid (marginals
    calibrated); the host :class:`MutationProcess` is the exact sequential
    model — this tier exists to fabricate large benchmark workloads
    on-device.

    Returns ``(mut_codes [B, cap], mut_lengths [B])`` with PAD tails.
    """
    B, L = codes.shape
    cap = int(L + max(16, L // 2))
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)

    # substitution channel: replace with a uniformly different letter
    err = jax.random.uniform(k1, (B, L)) < subst_prob
    shift = jax.random.randint(k2, (B, L), 1, alphabet_len)
    sub_codes = jnp.where(
        err,
        (codes.astype(jnp.int32) + shift) % alphabet_len,
        codes.astype(jnp.int32),
    )

    half_go = float(go_prob) / 2.0
    del_rate = min(half_go / max(1.0 - float(ge_prob), 1e-6), 0.49)
    deleted = jax.random.uniform(k3, (B, L)) < del_rate

    # insertion run before each position: open w.p. go/2, len ~ Geom(ge)
    ins_open = jax.random.uniform(k4, (B, L)) < half_go
    u = jax.random.uniform(k5, (B, L), minval=1e-7, maxval=1.0)
    if ge_prob > 0:
        run = 1 + jnp.floor(
            jnp.log(u) / float(np.log(ge_prob))
        ).astype(jnp.int32)
    else:
        run = jnp.ones((B, L), jnp.int32)
    geo = jnp.where(ins_open, jnp.minimum(run, max_ins_run), 0)

    valid = jnp.arange(L, dtype=jnp.int32)[None, :] < lengths[:, None]
    keep = valid & (~deleted)
    out_w = keep.astype(jnp.int32) + jnp.where(valid, geo, 0)
    ends = jnp.cumsum(out_w, axis=1)                  # inclusive
    offs = ends - out_w                               # exclusive
    mut_lengths = jnp.minimum(ends[:, -1], cap).astype(jnp.int32)

    # invert the ragged expansion: output slot q -> origin slot p
    qidx = jnp.arange(cap, dtype=jnp.int32)
    p = jax.vmap(lambda e: jnp.searchsorted(e, qidx, side="right"))(ends)
    p = jnp.minimum(p, L - 1).astype(jnp.int32)
    rank = qidx[None, :] - jnp.take_along_axis(offs, p, axis=1)
    is_ins = rank < jnp.take_along_axis(geo, p, axis=1)
    ins_codes = jax.random.randint(k6, (B, cap), 0, alphabet_len,
                                   dtype=jnp.int32)
    letters = jnp.where(
        is_ins, ins_codes, jnp.take_along_axis(sub_codes, p, axis=1)
    )
    mask = qidx[None, :] < mut_lengths[:, None]
    out = jnp.where(mask, letters, PAD).astype(jnp.int8)
    return out, mut_lengths
