"""Arrival schedules and query orders, from a traffic mix and a seed.

Every seed gets the same work in another order: an open loop's gaps are one
multiset, drawn once from the mix's own name and scaled to span the window
exactly, which each seed permutes; requests take the pool's queries in a
permutation drawn from the seed, cycling through the pool."""

from __future__ import annotations

import numpy as np

from gpubench.gen.seeds import rng


def poisson_due(rate_per_s: float, seconds: float, seed: int, mix: str) -> np.ndarray:
    """Due offsets (seconds from the window's start, ascending, the first
    at 0) of ``round(rate * seconds)`` requests whose gaps are exponential."""
    n = max(1, int(round(rate_per_s * seconds)))
    gaps = rng(0, "gaps", mix).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    gaps = gaps[rng(seed, "gap-order", mix).permutation(n)]
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def query_order(n_requests: int, pool: int, seed: int) -> np.ndarray:
    """The pool index of each of ``n_requests`` requests: a permutation of
    the pool drawn from the seed, repeated."""
    perm = rng(seed, "query-order").permutation(pool)
    return perm[np.arange(n_requests) % pool]
