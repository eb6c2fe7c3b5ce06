"""The knowledge base's arithmetic in NumPy (paper §III-C): a program's
signatures assigned to their nearest archetype, its fingerprint (the
instruction-weighted share of its intervals in each archetype), and its
CPI estimate (the fingerprint times the CPIs of the archetypes'
simulated representatives); and the test of the build's
representatives: each the row nearest its archetype.
"""
from __future__ import annotations

import numpy as np

_ROWS = 8192


def distances(signatures: np.ndarray, archetypes: np.ndarray) -> np.ndarray:
    """(N, k) Euclidean distances in float64, in blocks of rows."""
    x = np.asarray(signatures, np.float64)
    c = np.asarray(archetypes, np.float64)
    out = np.empty((x.shape[0], c.shape[0]))
    for lo in range(0, x.shape[0], _ROWS):
        diff = x[lo:lo + _ROWS, None, :] - c[None]
        out[lo:lo + _ROWS] = np.sqrt((diff * diff).sum(-1))
    return out


def nearest(signatures: np.ndarray, archetypes: np.ndarray):
    """(nearest archetype (N,), its distance (N,), the distance of the
    second nearest (N,)), in float64."""
    d = distances(signatures, archetypes)
    order = np.argsort(d, axis=1, kind="stable")
    rows = np.arange(d.shape[0])
    return order[:, 0], d[rows, order[:, 0]], d[rows, order[:, 1]]


def assign_tolerance(signatures: np.ndarray, archetypes: np.ndarray
                     ) -> np.ndarray:
    """(N,) the most by which the system's float32 squared distances of a
    row to two archetypes may misorder them: each is x.x - 2 x.c + c.c
    summed in float32 over the signature's width n, off by at most
    gamma(n + 2) (|x| + |c|)^2 (Higham's bound, gamma(m) = m u / (1 - m u),
    u = 2^-24), and two are compared."""
    n = np.asarray(signatures).shape[1] + 2
    u = 2.0 ** -24
    gamma = n * u / (1.0 - n * u)
    xn = np.linalg.norm(np.asarray(signatures, np.float64), axis=1)
    cn = np.linalg.norm(np.asarray(archetypes, np.float64), axis=1).max()
    return 2.0 * gamma * (xn + cn) ** 2


def may_assign(d: np.ndarray, slack: np.ndarray, tol: np.ndarray
               ) -> np.ndarray:
    """(N, k) whether the system may assign each row to each archetype:
    its reference distance `d` lies near enough the nearest that the
    signature's gap (`slack`, from the reference's) and the system's
    float32 rounding (`tol`, on squared distances) may put it first."""
    near = d.min(1, keepdims=True)
    s = np.asarray(slack, np.float64)[:, None]
    return d * d - near * near <= 2.0 * s * (d + near) + tol[:, None]


def representative_gap(ref: np.ndarray, slack: np.ndarray,
                       archetypes: np.ndarray, reps: np.ndarray) -> float:
    """How much nearer its archetype than its representative a row that
    may belong to it (`may_assign`) lies, beyond the signatures' gaps:
    0 where each representative is the row nearest its archetype (where
    no row may belong, every row is a candidate). A representative that
    may not belong to its archetype reads how much farther it lies than
    its nearest."""
    d = distances(ref, archetypes)
    s = np.asarray(slack, np.float64)
    may = may_assign(d, s, assign_tolerance(ref, archetypes))
    near = d.min(1)
    gap = 0.0
    for j, r in enumerate(np.asarray(reps, np.int64)):
        pool = np.flatnonzero(may[:, j]) if may[:, j].any() \
            else np.arange(len(d))
        if not may[r, j] and may[:, j].any():
            gap = max(gap, float(d[r, j] - near[r] - 2.0 * s[r]))
        gap = max(gap, float(d[r, j] - s[r] - (d[pool, j] + s[pool]).min()))
    return max(gap, 0.0)


def fingerprint(assign: np.ndarray, weights: np.ndarray, k: int):
    w = np.asarray(weights, np.float64)
    wp = w / max(w.sum(), 1e-30)
    f = np.zeros(k)
    np.add.at(f, np.asarray(assign, np.int64), wp)
    return f, wp


def estimate(signatures, weights, archetypes, rep_cpi, slack):
    """The reference estimate of one program, with the part of it that
    rounding may move: an interval the system may assign to more than
    one archetype (`may_assign`: its signature's gap from the
    reference's, `slack`, and the system's float32 distances) may go to
    any of them. Returns (fingerprint, estimated CPI, weight share of
    such intervals, the most the estimate can move through them)."""
    d = distances(signatures, archetypes)
    a = np.argsort(d, axis=1, kind="stable")[:, 0]
    f, wp = fingerprint(a, weights, len(archetypes))
    rep = np.asarray(rep_cpi, np.float64)
    est = float((f * rep).sum())
    loose = may_assign(d, slack, assign_tolerance(signatures, archetypes)
                       ).sum(1) > 1
    share = float(wp[loose].sum())
    return f, est, share, share * float(rep.max() - rep.min())
