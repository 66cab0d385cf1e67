"""The comparison that decides ``correct``: every answer the window produced
against the plain reference (:mod:`gpubench.reference`).

An answer is one query's k (value, id) pairs as the program delivered them.
Every answer is checked for its ids; the values of every answer to a query
of the reference's sample (:func:`checked_queries`: all the queries the
window asked, or ``check_queries`` of them drawn from the seed, which keeps
the reference shorter than the window) are checked against the reference.
The numbers compared, each against its limit in the configuration's
``limits``:

- ``bad_ids``: answers with an id outside the corpus, an id twice, or a
  value that is not finite. Exact: limit 0.
- ``deleted_ids``: answers holding a deleted id (configurations whose
  ``limits`` name it). Exact: limit 0.
- ``rank_gap``: the widest gap, over answers and ranks, by which the i-th
  best of the answer's rows, scored in float64, lies behind the i-th best
  of the whole corpus, in units of the query's scale (``(|q| + m)^2`` for
  L2, ``|q| m`` for ip; m the largest norm of the exact top-k rows).
- ``value_err``: the widest gap between a delivered value and its row's
  float64 score, in the same units.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import reference
from gpubench.gen.seeds import rng

ROWS_PER_STEP = 8192


def checked_queries(qidx, cap: int, seed: int) -> np.ndarray:
    """The pool queries whose answers the reference checks: every query
    asked, or ``cap`` of them drawn from the seed."""
    asked = np.unique(np.asarray(qidx, np.int64))
    if len(asked) <= cap:
        return asked
    return np.sort(rng(seed, "checked").choice(asked, size=cap, replace=False))


def compare(qidx, vals, ids, truth, blocks, queries, cfg: dict, deleted=(),
            ref=reference) -> dict:
    """``{name: value}`` over the answers ``(qidx (A,), vals (A, k), ids (A,
    k))``. ``truth``: ``(ids, values, scale)`` of :func:`~gpubench.
    reference.exact_topk`, a row a pool query (NaN scale: not checked);
    ``queries``: the (P, D) pool on the reference's device; ``deleted``:
    the deleted ids; ``ref``: the plain reference that scores the
    answers' rows (its ``true_values``)."""
    n, metric = cfg["rows"], cfg["metric"]
    qidx = np.asarray(qidx, np.int64)
    vals = np.asarray(vals, np.float32)
    ids = np.asarray(ids, np.int64)
    out = {}
    srt = np.sort(ids, axis=1)
    bad = ((ids < 0) | (ids >= n)).any(1) | (srt[:, 1:] == srt[:, :-1]).any(1)
    bad |= ~np.isfinite(vals).all(1)
    out["bad_ids"] = int(bad.sum())
    if "deleted_ids" in cfg["limits"]:
        out["deleted_ids"] = int(np.isin(ids, np.asarray(deleted, np.int64)).any(1).sum())
    ok = ~bad & np.isfinite(truth[2].cpu().numpy()[qidx])
    # Equal answers are compared once.
    key = np.concatenate([qidx[ok, None], ids[ok], vals[ok].view(np.int32)], axis=1)
    uniq = np.unique(key, axis=0)
    k = ids.shape[1]
    rank_gap = value_err = 0.0
    dev = queries.device
    ref_vals, ref_scale = truth[1], truth[2]
    for s in range(0, len(uniq), ROWS_PER_STEP):
        u = torch.from_numpy(uniq[s:s + ROWS_PER_STEP]).to(dev)
        q = u[:, 0]
        a_ids = u[:, 1:1 + k]
        a_vals = u[:, 1 + k:].to(torch.int32).view(torch.float32).double()
        true = ref.true_values(blocks, queries[q], a_ids, metric)
        scale = ref_scale[q][:, None]
        ranked = torch.sort(true, dim=1, descending=metric != "l2").values
        gap = (ranked - ref_vals[q]) if metric == "l2" else (ref_vals[q] - ranked)
        rank_gap = max(rank_gap, float((gap / scale).max()))
        value_err = max(value_err, float(((a_vals - true).abs() / scale).max()))
    out["rank_gap"] = rank_gap if len(uniq) else None
    out["value_err"] = value_err if len(uniq) else None
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every number is at or below its limit."""
    return all(v is not None and v <= limits[name] for name, v in numbers.items())
