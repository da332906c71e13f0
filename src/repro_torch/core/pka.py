"""Principal Kernel Analysis sampling (paper §5.1.3, Table 4).

Cycle-accurate simulation of every kernel is 6-7 orders of magnitude slower
than native execution; AI workloads are highly repetitive, so GainSight
simulates only *representative* kernels:

  1. gather coarse per-kernel counters (reads, writes, hits, misses, time),
  2. standardize + PCA for dimensionality reduction,
  3. k-means over the principal components,
  4. pick the kernel nearest each centroid; weight it by cluster size;
  5. choose k as the smallest cluster count whose weighted representatives
     predict total L2 line writes within a tolerance.

Pure numpy; deterministic (seeded k-means++ initialization).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PKAResult:
    representatives: np.ndarray   # kernel indices chosen for simulation
    weights: np.ndarray           # cluster sizes (simulation multipliers)
    labels: np.ndarray            # cluster id per kernel
    k: int
    sampled_fraction: float       # fraction of total runtime simulated
    speedup: float                # total runtime / sampled runtime


def _pca(x: np.ndarray, n_components: int) -> np.ndarray:
    mu = x.mean(0, keepdims=True)
    sd = x.std(0, keepdims=True) + 1e-12
    xs = (x - mu) / sd
    u, s, _ = np.linalg.svd(xs, full_matrices=False)
    return (u * s)[:, :n_components]


def _kmeans(x: np.ndarray, k: int, seed: int = 0, iters: int = 50):
    rng = np.random.RandomState(seed)
    n = x.shape[0]
    # k-means++ init
    centers = [x[rng.randint(n)]]
    for _ in range(1, k):
        d2 = np.min(
            ((x[:, None, :] - np.asarray(centers)[None]) ** 2).sum(-1), 1)
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(x[rng.choice(n, p=p)])
    c = np.asarray(centers)
    labels = np.zeros(n, np.int64)
    for _ in range(iters):
        d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1)
        labels = d2.argmin(1)
        for j in range(k):
            m = labels == j
            if m.any():
                c[j] = x[m].mean(0)
    return c, labels


def select_kernels(
    features: np.ndarray,
    runtimes: np.ndarray,
    target: np.ndarray,
    k: int | None = None,
    max_k: int = 20,
    tol: float = 0.05,
    n_components: int = 4,
    seed: int = 0,
) -> PKAResult:
    """Pick representative kernels.

    features : [n_kernels, n_counters] coarse profiling counters.
    runtimes : [n_kernels] native per-kernel runtime (for speedup metric).
    target   : [n_kernels] quantity the sampling must predict (the paper
               uses L2 cache-line writes) used for automatic k selection.
    """
    n = features.shape[0]
    n_components = min(n_components, features.shape[1], n)
    z = _pca(features, n_components)
    true_total = float(target.sum())

    def fit(k):
        c, labels = _kmeans(z, k, seed=seed)
        reps, weights = [], []
        for j in range(k):
            m = np.where(labels == j)[0]
            if len(m) == 0:
                continue
            d2 = ((z[m] - c[j]) ** 2).sum(-1)
            reps.append(m[d2.argmin()])
            weights.append(len(m))
        reps = np.asarray(reps)
        weights = np.asarray(weights, np.float64)
        est = float((target[reps] * weights).sum())
        err = abs(est - true_total) / max(abs(true_total), 1e-12)
        return reps, weights, labels, err

    if k is not None:
        reps, weights, labels, _ = fit(k)
    else:
        reps = weights = labels = None
        for kk in range(1, min(max_k, n) + 1):
            reps, weights, labels, err = fit(kk)
            k = kk
            if err <= tol:
                break

    sampled_rt = float(runtimes[reps].sum())
    total_rt = float(runtimes.sum())
    return PKAResult(
        representatives=reps,
        weights=weights,
        labels=labels,
        k=int(k),
        sampled_fraction=sampled_rt / max(total_rt, 1e-12),
        speedup=total_rt / max(sampled_rt, 1e-12),
    )


def weighted_estimate(result: PKAResult, per_kernel: np.ndarray) -> float:
    """Estimate a workload total from representative kernels' values."""
    return float((per_kernel[result.representatives] * result.weights).sum())
