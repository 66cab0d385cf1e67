"""ColBERT MaxSim late interaction.

The counterpart of :mod:`innr_tpu.ops.maxsim` (reference
``src/maxsim.rs``). ``maxsim`` and ``maxsim_cosine`` score one pair with one
matrix product, a row-max and a sum, and ``batch_maxsim`` is one einsum:
plain PyTorch, as the JAX package leaves them to XLA. Corpus retrieval,
``maxsim_knn`` and ``maxsim_knn_batch``, runs the hand-written CUDA kernel
``maxsim_scores`` (:mod:`innr_tpu_torch.kernels.maxsim_kernel`) for a
corpus on a CUDA device, a batch in one launch, and its plain version for a
corpus on the CPU. There is no size gate: the JAX package scores corpora
under 128 documents with ``batch_maxsim``, which clamps no -inf best when
no ``doc_mask`` is given; this package takes the kernel's function at
every size.

Contracts (reference ``src/maxsim.rs:96-110``): empty query or doc -> 0.0;
all tokens must share one dimension (raises :class:`ContractError`); NOT
commutative — the first argument is always the query. Host data goes to
the default device (the card) unless a tensor says otherwise; retrieval
results are tensors on the corpus's device: float32 scores, int32 indices.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.config import NORM_EPSILON
from innr_tpu_torch.kernels import maxsim_kernel as _kern
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.tensors import as_tensor, empty_topk, host_device

__all__ = [
    "maxsim",
    "maxsim_cosine",
    "batch_maxsim",
    "maxsim_knn",
    "maxsim_knn_batch",
]


def _tokens_2d(tokens, name: str, device=None) -> torch.Tensor:
    """A token list or 2-D array as (T, D) float32, checking ragged input
    (the reference's shared-dimension assert). An empty list is (0, 0)."""
    if hasattr(tokens, "ndim"):
        if tokens.ndim != 2:
            raise ContractError(
                f"innr_tpu_torch::maxsim: {name} tokens must be a (T, D) array "
                f"or a list of equal-length vectors, got ndim={tokens.ndim}")
        return as_tensor(tokens, torch.float32, device)
    toks = list(tokens)
    if not toks:
        return torch.zeros((0, 0), dtype=torch.float32, device=host_device(device))
    dim = len(toks[0])
    for t in toks:
        if len(t) != dim:
            raise ContractError(f"dimension mismatch ({name})")
    return as_tensor(np.asarray(toks, dtype=np.float32), torch.float32, device)


def _pair(query_tokens, doc_tokens, op: str):
    """``(q, d)`` on one device, or None when either side is empty."""
    q = _tokens_2d(query_tokens, "query")
    d = _tokens_2d(doc_tokens, "doc", q.device)
    if q.shape[0] == 0 or d.shape[0] == 0:
        return None, q.device
    if q.shape[1] != d.shape[1]:
        raise ContractError(
            f"innr_tpu_torch::{op}: dimension mismatch ({q.shape[1]} vs {d.shape[1]})")
    return (q, d), q.device


def maxsim(query_tokens, doc_tokens) -> torch.Tensor:
    """``MaxSim(Q, D) = sum_i max_j (q_i . d_j)`` (reference
    ``src/maxsim.rs:96``). Inputs: (Tq, D) and (Td, D) arrays, or lists of
    equal-length vectors. Returns 0.0 if either side is empty."""
    pair, dev = _pair(query_tokens, doc_tokens, "maxsim")
    if pair is None:
        return torch.tensor(0.0, dtype=torch.float32, device=dev)
    q, d = pair
    return torch.matmul(q, d.T).amax(dim=1).sum()


def _unit(rows: torch.Tensor) -> torch.Tensor:
    """Unit rows; zero- or NaN-norm rows become zero rows, so every pair
    cosine with them is 0.0 (the reference's per-pair zero-norm guard)."""
    n = torch.sqrt((rows * rows).sum(dim=1, keepdim=True))
    ok = n > NORM_EPSILON
    return torch.where(ok, rows / torch.where(ok, n, 1.0), 0.0)


def maxsim_cosine(query_tokens, doc_tokens) -> torch.Tensor:
    """MaxSim with cosine similarity per token pair (reference
    ``src/maxsim.rs:168``): rows unit-normalized (zero-norm rows pinned to
    zero), then the same product, row-max and sum."""
    pair, dev = _pair(query_tokens, doc_tokens, "maxsim_cosine")
    if pair is None:
        return torch.tensor(0.0, dtype=torch.float32, device=dev)
    q, d = pair
    return torch.matmul(_unit(q), _unit(d).T).amax(dim=1).sum()


def batch_maxsim(queries, docs, doc_mask=None, query_mask=None) -> torch.Tensor:
    """MaxSim of a batch of queries against a batch of docs, one einsum:
    ``scores[q, n] = sum_i max_j queries[q, i] . docs[n, j]``.

    ``queries``: (Q, Tq, D); ``docs``: (N, Td, D). Returns (Q, N).
    ``doc_mask`` (N, Td) pins masked doc tokens to -inf before the row-max
    and then clamps a -inf best (a fully masked doc) to 0.0; ``query_mask``
    (Q, Tq) drops masked query tokens from the sum. Without ``doc_mask`` no
    -inf is clamped (the JAX package's function)."""
    queries = as_tensor(queries, torch.float32)
    docs = as_tensor(docs, torch.float32, queries.device)
    pair = torch.einsum("qtd,nsd->qnts", queries, docs)
    if doc_mask is not None:
        doc_mask = as_tensor(doc_mask, torch.bool, queries.device)
        pair = torch.where(doc_mask[None, :, None, :], pair, -torch.inf)
    best = pair.amax(dim=3)  # NaN-sticky, as jnp.max
    if doc_mask is not None:
        best = torch.where(best == -torch.inf, 0.0, best)
    if query_mask is not None:
        query_mask = as_tensor(query_mask, torch.bool, queries.device)
        best = torch.where(query_mask[:, None, :], best, 0.0)
    return best.sum(dim=2)


def maxsim_knn(query_tokens, doc_corpus, k: int, doc_mask=None):
    """Top-k documents by MaxSim over an (N, Td, D) multi-vector corpus —
    ColBERT-style late-interaction retrieval. A CUDA corpus runs the fused
    kernel (the (N, Tq, Td) interaction tensor is never formed); a CPU
    corpus its plain version. ``doc_mask`` (N, Td) excludes padded doc
    tokens exactly. Returns ``(scores (k,) descending under IEEE total
    order, indices (k,) int32)``, ties to the lowest document."""
    docs = as_tensor(doc_corpus, torch.float32)
    q = _tokens_2d(query_tokens, "query", docs.device)
    if docs.dim() != 3 or docs.shape[2] != q.shape[1]:
        raise ContractError(
            f"innr_tpu_torch::maxsim_knn: corpus shape {tuple(docs.shape)} incompatible "
            f"with query dim {q.shape[1]}")
    n = int(docs.shape[0])
    if n == 0 or k <= 0 or q.shape[0] == 0:
        return empty_topk((0,), docs.device)
    return _kern.fused_maxsim_knn(q, docs, min(int(k), n), doc_mask)


def maxsim_knn_batch(query_batch, doc_corpus, k: int, doc_mask=None):
    """Top-k documents by MaxSim for a (B, Tq, D) query batch: all B queries
    share one launch, one pass over the (N, Td, D) corpus per tile of
    queries. Ragged queries zero-pad to the Tq rectangle: a zero query
    token's best is 0 (max(0, ...) where every dot is 0), adding nothing.
    Each query's score is its own: a NaN or inf in one query's bests stays
    in that query. Returns ``(scores (B, k), indices (B, k) int32)``."""
    docs = as_tensor(doc_corpus, torch.float32)
    qs = as_tensor(query_batch, torch.float32, docs.device)
    if qs.dim() != 3 or docs.dim() != 3 or docs.shape[2] != qs.shape[2]:
        raise ContractError(
            f"innr_tpu_torch::maxsim_knn_batch: query batch {tuple(qs.shape)} incompatible "
            f"with corpus {tuple(docs.shape)}")
    b, n = int(qs.shape[0]), int(docs.shape[0])
    if n == 0 or k <= 0 or qs.shape[1] == 0 or b == 0:
        return empty_topk((b, 0), docs.device)
    return _kern.fused_maxsim_knn_batch(qs, docs, min(int(k), n), doc_mask)
