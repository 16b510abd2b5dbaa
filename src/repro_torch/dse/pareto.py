"""Non-dominated sorting over design objectives (all minimised).

Pure numpy, O(N²) pairwise — design archives are thousands of points at
most, so clarity beats asymptotics.  Duplicated objective vectors do not
dominate each other: both stay on the front (distinct designs can tie).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _pairwise_dominance(costs: np.ndarray) -> np.ndarray:
    """(N, N) bool: entry [i, j] = point i dominates point j."""
    c = np.asarray(costs, dtype=np.float64)
    if c.ndim != 2:
        raise ValueError("costs must be (num_points, num_objectives)")
    le = np.all(c[:, None, :] <= c[None, :, :], axis=-1)
    lt = np.any(c[:, None, :] < c[None, :, :], axis=-1)
    return le & lt


def pareto_mask(costs: np.ndarray) -> np.ndarray:
    """(N,) bool — True where no other point dominates (the Pareto front)."""
    return ~_pairwise_dominance(costs).any(axis=0)


def non_dominated_sort(costs: np.ndarray) -> np.ndarray:
    """(N,) int ranks: 0 = Pareto front, 1 = front once rank-0 removed, …"""
    dom = _pairwise_dominance(costs)
    n = dom.shape[0]
    ranks = np.full(n, -1, dtype=np.int64)
    remaining = np.ones(n, dtype=bool)
    rank = 0
    while remaining.any():
        # dominated only counts dominators still in play
        front = remaining & ~(dom & remaining[:, None]).any(axis=0)
        ranks[front] = rank
        remaining &= ~front
        rank += 1
    return ranks


def crowding_distance(costs: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance (within one front): boundary points get inf,
    interior points the normalised perimeter of their objective-space hole."""
    c = np.asarray(costs, dtype=np.float64)
    n, m = c.shape
    if n <= 2:
        return np.full(n, np.inf)
    dist = np.zeros(n)
    for k in range(m):
        order = np.argsort(c[:, k], kind="stable")
        span = c[order[-1], k] - c[order[0], k]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span <= 0:
            continue
        dist[order[1:-1]] += (c[order[2:], k] - c[order[:-2], k]) / span
    return dist


def pareto_order(costs: np.ndarray) -> np.ndarray:
    """Indices sorted by (rank asc, crowding desc) — selection order for
    evolutionary refinement and for pretty-printing fronts."""
    ranks = non_dominated_sort(costs)
    crowd = np.zeros(len(ranks))
    for r in np.unique(ranks):
        sel = ranks == r
        crowd[sel] = crowding_distance(np.asarray(costs)[sel])
    # stable lexicographic: rank ascending, crowding descending
    return np.lexsort((-crowd, ranks))
