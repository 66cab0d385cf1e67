"""A seeded Gaussian mixture in a configuration's shapes, made on the device.

The configuration's ``mixture`` block sets it:

- ``clusters`` centres ``centre_scale * N(0, I / D)`` (norm about
  ``centre_scale``);
- a row is its centre plus ``spread * N(0, I / D)`` noise (norm about
  ``spread``), scaled to unit length when ``normalize``;
- ``order``: ``"random"`` (each row's centre drawn uniformly) or
  ``"by_cluster"`` (rows in cluster order, clusters of equal size, as a
  corpus inserted cluster by cluster);
- queries: a centre drawn uniformly, plus one offset common to every query
  of norm ``query_shift`` (0: in distribution; above 0: out of distribution,
  as text queries lie against image vectors), plus ``query_spread`` noise.

Rows are made in chunks of :data:`CHUNK`, each from its own generator, so
any range of rows can be made again alone on any device (the reference
does, after the program's state is freed).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.gen.seeds import rng, torch_generator

CHUNK = 1 << 20


def centres(cfg: dict, seed: int, device) -> torch.Tensor:
    m, d = cfg["mixture"], cfg["dim"]
    g = torch_generator(seed, device, "centres")
    return (m["centre_scale"] / math.sqrt(d)) * torch.randn(
        (m["clusters"], d), generator=g, device=device)


def cluster_of(cfg: dict, ids: np.ndarray) -> np.ndarray:
    """Each row's cluster in a ``by_cluster`` corpus."""
    return (np.asarray(ids, np.int64) * cfg["mixture"]["clusters"]) // cfg["rows"]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def rows(cfg: dict, seed: int, start: int, stop: int, device, cents=None) -> torch.Tensor:
    """Rows ``[start, stop)`` of the corpus as an (n, D) float32 tensor on
    ``device``."""
    m, d, n_all = cfg["mixture"], cfg["dim"], cfg["rows"]
    if cents is None:
        cents = centres(cfg, seed, device)
    out = torch.empty((stop - start, d), dtype=torch.float32, device=device)
    noise_scale = m["spread"] / math.sqrt(d)
    for c in range(start // CHUNK, -(-stop // CHUNK)):
        cs, ce = c * CHUNK, min(n_all, (c + 1) * CHUNK)
        g = torch_generator(seed, device, "rows", c)
        if m["order"] == "random":
            lab = torch.randint(m["clusters"], (ce - cs,), generator=g, device=device)
        else:
            lab = (torch.arange(cs, ce, device=device) * m["clusters"]) // n_all
        block = torch.randn((ce - cs, d), generator=g, device=device).mul_(noise_scale)
        block += cents[lab]
        if m["normalize"]:
            block = _unit(block)
        lo, hi = max(start, cs), min(stop, ce)
        out[lo - start:hi - start] = block[lo - cs:hi - cs]
    return out


def queries(cfg: dict, seed: int, device) -> torch.Tensor:
    """The query pool, (``queries``, D) float32 on ``device``."""
    m, d, n = cfg["mixture"], cfg["dim"], cfg["queries"]
    cents = centres(cfg, seed, device)
    g = torch_generator(seed, device, "queries")
    lab = torch.randint(m["clusters"], (n,), generator=g, device=device)
    shift = _unit(torch.randn((1, d), generator=g, device=device)) * m["query_shift"]
    q = cents[lab] + shift + torch.randn((n, d), generator=g, device=device) * (
        m["query_spread"] / math.sqrt(d))
    return _unit(q) if m["normalize"] else q


def deletions(cfg: dict, seed: int) -> list:
    """The ids a ``by_cluster`` corpus loses, one array per delete step:
    one cluster a step, drawn from each segment in turn (segments in a
    drawn order), ``delete_fraction * rows / segments`` ids of it drawn
    without replacement."""
    n_all, n_seg = cfg["rows"], cfg["segments"]
    per_step = int(round(cfg["delete_fraction"] * n_all / n_seg))
    g = rng(seed, "deletions")
    seg_rows = n_all // n_seg
    steps = []
    for j in g.permutation(n_seg):
        first = cluster_of(cfg, np.array([j * seg_rows]))[0]
        last = cluster_of(cfg, np.array([(j + 1) * seg_rows - 1]))[0]
        c = int(g.integers(first, last + 1))
        c_ids = np.arange(-(-c * n_all // cfg["mixture"]["clusters"]),
                          -(-(c + 1) * n_all // cfg["mixture"]["clusters"]), dtype=np.int64)
        c_ids = c_ids[(c_ids >= j * seg_rows) & (c_ids < (j + 1) * seg_rows)]
        steps.append(np.sort(g.choice(c_ids, size=min(per_step, len(c_ids)), replace=False)))
    return steps
