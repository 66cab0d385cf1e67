"""The plain reference: exact top-k by brute force in plain PyTorch, and its
control in TF32.

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the corpus it generated (or makes again from the seed)
as blocks, with the alive mask the benchmark's own deletions give.

- :func:`exact_topk`: each query's k nearest rows (L2, ascending) or
  largest inner products (``ip``, descending), ties to the lowest id. A
  float32 scan (TF32 off) keeps ``k + MARGIN`` candidates a query; they are
  scored again in float64 and ranked by (float64 value, id).
- :func:`control_topk`: the same scan with the products in TF32 (inputs
  rounded to 10 mantissa bits, products summed in float32), ranked and
  reported by those scores, as a program computing in TF32 would: the
  control that the comparison (:mod:`gpubench.compare`) has to fail.

Rows are scanned in chunks of at most :data:`CHUNK_ELEMS` scores, each
block on its own device, so the reference fits beside the corpus. A chunk's
``keep`` best lie in its ``keep`` groups of :data:`GROUP` rows with the
best maxima (each of those rows lifts its own group's maximum to at least
the ``keep``-th best key), so the selection reads the groups' maxima and
then only those groups' keys.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

MARGIN = 32
CHUNK_ELEMS = 1 << 29
GROUP = 32


@dataclass
class Block:
    """Corpus rows ``[offset, offset + len(rows))`` on one device, with an
    optional (n,) bool alive mask (False: deleted)."""

    rows: torch.Tensor
    offset: int
    alive: torch.Tensor | None = None


def strict_float32() -> None:
    """Float32 products stay float32 (PyTorch may use TF32 otherwise)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest (ties away
    from zero), as the tensor cores take their inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _keys(q, x, metric: str, tf32: bool):
    """(Q, n) float32 keys, larger is better: q.x, or 2 q.x - |x|^2 (L2
    without |q|^2)."""
    qq, xx = (round_tf32(q), round_tf32(x)) if tf32 else (q, x)
    if metric == "l2":
        return torch.addmm(-(x * x).sum(dim=1)[None, :], qq, xx.T, alpha=2.0)
    return qq @ xx.T


def _chunk_top(keys, keep: int):
    """``(values, positions)`` of each row's ``keep`` largest keys: the
    ``keep`` groups with the largest maxima, then the best keys in them."""
    n_q, n = keys.shape
    if n <= keep * GROUP or n % GROUP:
        top = keys.topk(min(keep, n), dim=1)
        return top.values, top.indices
    groups = keys.view(n_q, n // GROUP, GROUP)
    best = groups.amax(dim=2).topk(keep, dim=1).indices
    pos = (best[:, :, None] * GROUP + torch.arange(GROUP, device=keys.device)).reshape(n_q, -1)
    top = keys.gather(1, pos).topk(keep, dim=1)
    return top.values, pos.gather(1, top.indices)


def _scan(blocks, queries, keep: int, metric: str, tf32: bool):
    """The ``keep`` best (keys, global ids) a query over every block, on the
    queries' device."""
    strict_float32()
    dev0 = queries.device
    n_q = queries.shape[0]
    best_k, best_i = [], []
    for b in blocks:
        q = queries.to(b.rows.device)
        step = max(GROUP, CHUNK_ELEMS // n_q // GROUP * GROUP)
        run_k = run_i = None
        for s in range(0, b.rows.shape[0], step):
            e = min(b.rows.shape[0], s + step)
            keys = _keys(q, b.rows[s:e], metric, tf32)
            if b.alive is not None:
                keys.masked_fill_(~b.alive[s:e][None, :], -torch.inf)
            vals, pos = _chunk_top(keys, keep)
            ids = pos + (b.offset + s)
            if run_k is not None:
                cat_k, cat_i = torch.cat([run_k, vals], 1), torch.cat([run_i, ids], 1)
                sel = cat_k.topk(min(keep, cat_k.shape[1]), dim=1).indices
                run_k, run_i = cat_k.gather(1, sel), cat_i.gather(1, sel)
            else:
                run_k, run_i = vals, ids
        best_k.append(run_k.to(dev0))
        best_i.append(run_i.to(dev0))
    keys, ids = torch.cat(best_k, 1), torch.cat(best_i, 1)
    sel = keys.topk(min(keep, keys.shape[1]), dim=1).indices
    return keys.gather(1, sel), ids.gather(1, sel)


def gather_rows(blocks, ids: torch.Tensor) -> torch.Tensor:
    """float64 rows of the global ``ids`` (any shape), on the ids' device:
    shape ``ids.shape + (D,)``."""
    flat = ids.reshape(-1)
    out = torch.empty((flat.shape[0], blocks[0].rows.shape[1]), dtype=torch.float64,
                      device=ids.device)
    for b in blocks:
        sel = (flat >= b.offset) & (flat < b.offset + b.rows.shape[0])
        local = (flat[sel] - b.offset).to(b.rows.device)
        out[sel] = b.rows[local].double().to(ids.device)
    return out.reshape(*ids.shape, -1)


def true_values(blocks, queries, ids: torch.Tensor, metric: str) -> torch.Tensor:
    """float64 scores of (Q, m) global ``ids`` against their (Q, D)
    ``queries``: squared L2 distances, or inner products."""
    x = gather_rows(blocks, ids)
    q = queries.double()[:, None, :]
    if metric == "l2":
        return ((x - q) ** 2).sum(-1)
    return (x * q).sum(-1)


def _lex_best(vals: torch.Tensor, ids: torch.Tensor, k: int, metric: str):
    """Each row's k best by (value, id): ascending values for L2,
    descending for ip, ties to the lower id."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    vals, ids = vals.gather(1, by_id), ids.gather(1, by_id)
    order = torch.argsort(vals, dim=1, stable=True, descending=metric != "l2")[:, :k]
    return vals.gather(1, order), ids.gather(1, order)


def exact_topk(blocks, queries: torch.Tensor, k: int, metric: str):
    """``(ids (Q, k) int64, values (Q, k) float64, scale (Q,) float64)``:
    the exact top-k and the scale a gap is measured in, ``(|q| + m)^2``
    for L2 and ``|q| m`` for ip, m the largest norm among the k rows."""
    keys, cand = _scan(blocks, queries, k + MARGIN, metric, tf32=False)
    vals = true_values(blocks, queries, cand, metric)
    # A deleted row's key is -inf; it stays last (only where fewer than
    # k + MARGIN rows are alive can one be a candidate).
    vals = vals.masked_fill(keys == -torch.inf, torch.inf if metric == "l2" else -torch.inf)
    vals, ids = _lex_best(vals, cand, k, metric)
    qn = torch.linalg.vector_norm(queries.double(), dim=1)
    m = torch.linalg.vector_norm(gather_rows(blocks, ids), dim=-1).amax(dim=1)
    scale = (qn + m) ** 2 if metric == "l2" else qn * m
    return ids, vals, scale


def control_topk(blocks, queries: torch.Tensor, k: int, metric: str):
    """``(values (Q, k) float32, ids (Q, k) int64)`` by TF32 products: the
    control."""
    keys, ids = _scan(blocks, queries, k, metric, tf32=True)
    if metric == "l2":
        keys = (queries * queries).sum(dim=1, keepdim=True) - keys
    return keys, ids
