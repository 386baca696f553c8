"""Reference numpy DP oracle: naive O(n*m) affine-gap alignment.

Used to validate the vectorized wavefront engine (all modes, banded and
full).  Deliberately written in the most obvious cell-by-cell style so a
human can audit it against the textbook recurrences.
"""

import numpy as np

NEG = -1e30


def dp_oracle(s, t, subst, go, ge, *, dmin=None, dmax=None,
              free_start_edges=False, local_start=False,
              free_end_edges=False, local_end=False):
    """Returns best score under the mode flags (banded if dmin/dmax given).

    Gap run of length g costs go + g*ge.  H/E/F textbook affine recurrence:
    E = gap in origin (consumes t), F = gap in mutate (consumes s).
    """
    n, m = len(s), len(t)
    H = np.full((n + 1, m + 1), NEG)
    E = np.full((n + 1, m + 1), NEG)
    F = np.full((n + 1, m + 1), NEG)

    def in_band(i, j):
        if dmin is None:
            return True
        return dmin <= i - j <= dmax

    H[0][0] = 0.0 if in_band(0, 0) else NEG
    for j in range(1, m + 1):
        if not in_band(0, j):
            continue
        if local_start or free_start_edges:
            H[0][j] = 0.0
        else:
            H[0][j] = go + ge * j
        E[0][j] = go + ge * j
    for i in range(1, n + 1):
        if not in_band(i, 0):
            continue
        if local_start or free_start_edges:
            H[i][0] = 0.0
        else:
            H[i][0] = go + ge * i
        F[i][0] = go + ge * i

    for i in range(1, n + 1):
        for j in range(1, m + 1):
            if not in_band(i, j):
                continue
            E[i][j] = max(
                H[i][j - 1] + go + ge if in_band(i, j - 1) else NEG,
                E[i][j - 1] + ge if in_band(i, j - 1) else NEG,
            )
            F[i][j] = max(
                H[i - 1][j] + go + ge if in_band(i - 1, j) else NEG,
                F[i - 1][j] + ge if in_band(i - 1, j) else NEG,
            )
            diag = (
                H[i - 1][j - 1] + subst[s[i - 1]][t[j - 1]]
                if in_band(i - 1, j - 1) else NEG
            )
            h = max(diag, E[i][j], F[i][j])
            if local_start:
                h = max(h, 0.0)
            # (free_start_edges needs no clause here: the loop runs
            # j >= 1, and the free i==0 row / j==0 column anchors are
            # fully handled by the boundary init above)
            H[i][j] = h

    if local_end:
        return max(H.max(), 0.0) if local_start else H.max()
    if free_end_edges:
        best = NEG
        for j in range(m + 1):
            best = max(best, H[n][j])
        for i in range(n + 1):
            best = max(best, H[i][m])
        return best
    return H[n][m]


def rescore(ops, s, t, si, sj, subst, go, ge):
    """Score an MSID transcript starting at (si, sj); returns
    ``(score, end_i, end_j)``."""
    score, i, j, prev = 0.0, si, sj, None
    for op in ops:
        if op in "MS":
            score += subst[s[i], t[j]]
            i += 1
            j += 1
        elif op == "I":
            score += ge + (go if prev != "I" else 0.0)
            j += 1
        else:
            score += ge + (go if prev != "D" else 0.0)
            i += 1
        prev = op
    return score, i, j
