"""Metric helpers of cross-program estimation (port of the two helpers of
`repro.core.crossprog`; the deprecated one-shot surface is not ported).

  `cpi_accuracy` — the paper's 1 - |est-true|/true, with the divisor
      clamped away from zero and the result clipped into [0, 1].
  `speedup` — (instructions represented) / (instructions simulated).
"""
from __future__ import annotations

import numpy as np

#: Floor for the |true CPI| divisor in the accuracy metric.
ACCURACY_EPS = 1e-9


def cpi_accuracy(est: float, true: float, eps: float = ACCURACY_EPS) -> float:
    """Clamped paper accuracy: 1 - |est - true| / max(|true|, eps),
    clipped into [0, 1]. Always finite, even at true == 0."""
    err = abs(float(est) - float(true)) / max(abs(float(true)), eps)
    return float(np.clip(1.0 - err, 0.0, 1.0))


def speedup(total, simulated) -> float:
    """Simulated-instruction reduction factor.

    Weight-aware: both arguments may be scalars OR arrays of
    per-interval instruction counts — `speedup(n_intervals, k)` keeps
    the legacy uniform-interval behaviour, while
    `speedup(all_weights, all_weights[rep_indices])` accounts for
    non-uniform interval sizes (arrays are summed).
    """
    t = float(np.asarray(total, np.float64).sum())
    s = float(np.asarray(simulated, np.float64).sum())
    return t / max(s, 1e-30)
