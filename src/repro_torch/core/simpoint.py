"""SimPoint methodology (intra-program, paper §IV-B / Fig. 4), port of
`repro.core.simpoint`.

Generic over the signature: pass any (n_intervals, dim) matrix (classic
BBVs or SemanticBBVs) plus the ground-truth per-interval CPI; the
workflow clusters on the device (`kmeans`), picks one representative per
cluster, "simulates" only the representatives, and reports estimated
against true program CPI.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.clustering import kmeans, representatives
from repro_torch.data.isa import stable_hash
from repro_torch.device import Device


@dataclass
class SimPointResult:
    k: int
    assign: np.ndarray
    rep_indices: np.ndarray        # interval index per cluster
    weights: np.ndarray            # cluster occupancy (instruction-weighted)
    est_cpi: float
    true_cpi: float

    @property
    def accuracy(self) -> float:
        """Paper's CPI accuracy: 1 - |est - true| / true (not clamped)."""
        return 1.0 - abs(self.est_cpi - self.true_cpi) / self.true_cpi


def random_projection(x: np.ndarray, dims: int = 15, seed: int = 0
                      ) -> np.ndarray:
    """SimPoint 3.0 projects BBVs to ~15 dims before clustering."""
    if x.shape[1] <= dims:
        return x
    rng = np.random.RandomState(stable_hash("proj", seed))
    proj = rng.randn(x.shape[1], dims) / np.sqrt(dims)
    return x @ proj


def run_simpoint(signatures: np.ndarray, interval_cpis: np.ndarray,
                 interval_weights: Optional[np.ndarray] = None,
                 k: int = 10, seed: int = 0, project_to: int = 0,
                 device: Device = "cuda", init_centroids=None
                 ) -> SimPointResult:
    """signatures: (N, d); interval_cpis: (N,) ground truth (the "gem5
    run", consulted only at the chosen representatives and for the final
    evaluation); interval_weights: per-interval instruction counts
    (default uniform). k-means runs on `device`; `init_centroids`
    ((restarts, k, d), in the projected space) replaces its seeding."""
    n = signatures.shape[0]
    k = min(k, n)
    x = signatures.astype(np.float64)
    if project_to:
        x = random_projection(x, project_to, seed)
    x = x.astype(np.float32)
    cents, assign, _ = kmeans(x, k, seed=seed, device=device,
                              init_centroids=init_centroids)
    reps = representatives(x, cents, assign)
    w = interval_weights if interval_weights is not None else np.ones(n)
    w = w / w.sum()
    # a sum per cluster in row order: np.bincount / np.add.at add in
    # another order and can move the last bit of est_cpi
    cluster_w = np.array([w[assign == c].sum() for c in range(k)])
    # "simulate" only the representative of each cluster
    rep_cpi = interval_cpis[reps]
    est = float((cluster_w * rep_cpi).sum())
    true = float((w * interval_cpis).sum())
    return SimPointResult(k=k, assign=assign, rep_indices=reps,
                          weights=cluster_w, est_cpi=est, true_cpi=true)


def classic_bbv_matrix(intervals, block_order: List[int],
                       block_lens: Dict[int, int]) -> np.ndarray:
    """Traditional BBV baseline: (n_intervals, n_blocks), length-weighted,
    L1-normalized (order-dependent IDs: the paper's strawman)."""
    return np.stack([iv.bbv(block_order, weight_by_len=True,
                            block_lens=block_lens) for iv in intervals])
