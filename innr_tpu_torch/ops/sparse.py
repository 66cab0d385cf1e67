"""Sparse vector ops (positional API): sorted-index dot, sparse retrieval
and sparse MaxSim.

The counterpart of :mod:`innr_tpu.ops.sparse` (reference
``src/sparse.rs``). A sparse vector is an ``(indices, values)`` pair:
``uint32`` indices sorted ascending, held as bit-identical ``int32`` views
(:mod:`innr_tpu_torch.utils.bits`), and float32 values. The dot is the JAX
package's binary-search join (:func:`innr_tpu_torch.kernels.sparse_knn.
join_scores`): each index of one side is searched, as unsigned, in the
other; a duplicate index matches its first occurrence (the reference's
two-pointer walk pairs duplicates one to one; both agree on unique
indices). Padding carries the sentinel index 0xFFFFFFFF and value 0.0 and
contributes nothing, so ragged batches become rectangular tensors.

:class:`SparseCorpus` retrieval (``sparse_knn``, ``sparse_knn_batch``) runs
the hand-written CUDA kernel ``sparse_scan``
(:mod:`innr_tpu_torch.kernels.sparse_knn`) for a corpus on a CUDA device
(a batch of queries in one launch) and its plain version for a corpus on
the CPU. The sparse MaxSim functions are plain torch, as in the JAX
package. Host data goes to the default device (the card) unless a
``device`` is given; a tensor keeps its device. Results are tensors on the
corpus's device: float32 scores, int32 indices.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.kernels import sparse_knn as _sparse
from innr_tpu_torch.kernels.sparse_knn import join_scores
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.bits import as_unsigned
from innr_tpu_torch.utils.order import top_k_total
from innr_tpu_torch.utils.tensors import as_tensor, empty_topk, host_device

__all__ = [
    "sparse_dot",
    "sparse_maxsim",
    "SENTINEL_INDEX",
    "pad_sparse",
    "pad_sparse_docs",
    "SparseCorpus",
    "sparse_knn",
    "sparse_knn_batch",
    "sparse_maxsim_batch",
    "sparse_maxsim_knn",
]

# Index value used for padded (inactive) entries.
SENTINEL_INDEX = np.uint32(0xFFFFFFFF)


def _check_pair(indices, values, name: str, device=None):
    """(int32 index view, float32 values) on ``device`` (a tensor keeps its
    device when none is given)."""
    idx = as_unsigned(indices, 32, device)
    val = as_tensor(values, torch.float32, idx.device)
    if idx.shape[-1] != val.shape[-1]:
        raise ContractError(
            f"sparse_dot: {name} indices/values length mismatch "
            f"({idx.shape[-1]} vs {val.shape[-1]})")
    return idx, val


def _sparse_dot_arrays(a_idx, a_val, b_idx, b_val) -> torch.Tensor:
    """Binary-search join of ``a`` into ``b`` (both sorted ascending)."""
    return join_scores(b_idx, b_val, a_idx, a_val)


def sparse_dot(a_indices, a_values, b_indices, b_values) -> torch.Tensor:
    """Sparse dot over sorted (indices, values) pairs
    (reference ``src/sparse.rs:50``); a duplicate index matches its first
    occurrence in ``b``."""
    a_idx, a_val = _check_pair(a_indices, a_values, "a")
    b_idx, b_val = _check_pair(b_indices, b_values, "b", a_idx.device)
    return _sparse_dot_arrays(a_idx, a_val, b_idx, b_val)


def _pad_np(tokens, width: int | None = None):
    """Sentinel-padded numpy ``((T, width) uint32, (T, width) float32)``."""
    tokens = [(np.asarray(i, dtype=np.uint32).reshape(-1), np.asarray(v, dtype=np.float32)
               .reshape(-1)) for i, v in tokens]
    if width is None:
        width = max((i.size for i, _ in tokens), default=0)
    width = max(int(width), 1)
    idx = np.full((len(tokens), width), SENTINEL_INDEX, dtype=np.uint32)
    val = np.zeros((len(tokens), width), dtype=np.float32)
    for t, (ti, tv) in enumerate(tokens):
        if ti.size > width:
            raise ContractError(f"pad_sparse: token {t} has {ti.size} entries > width {width}")
        idx[t, :ti.size] = ti
        val[t, :ti.size] = tv
    return idx, val


def pad_sparse(tokens, width: int | None = None, device=None):
    """Pad a list of (indices, values) sparse vectors to a rectangular
    ``(T, width)`` pair (sentinel index, 0.0 value) on ``device`` (default:
    the default device, the card)."""
    idx, val = _pad_np(tokens, width)
    dev = host_device(device)
    return as_unsigned(idx, 32, dev), torch.from_numpy(val).to(dev)


def _as_padded_pair(obj, device=None):
    """``(idx, val)`` if ``obj`` is a pre-padded ``((N, L) idx, (N, L) val)``
    tuple, else None. A tuple of two ``(indices, values)`` document pairs is
    a two-document list, not a padded pair."""
    if not (isinstance(obj, tuple) and len(obj) == 2):
        return None
    a, b = obj
    if isinstance(a, (tuple, list)) or isinstance(b, (tuple, list)):
        return None
    if np.ndim(a) != 2:
        return None
    idx = as_unsigned(a, 32, device)
    val = as_tensor(b, torch.float32, idx.device)
    if idx.shape != val.shape:
        raise ContractError(
            f"sparse corpus/queries: padded arrays must be matching 2-D, "
            f"got {tuple(idx.shape)} / {tuple(val.shape)}")
    return idx, val


class SparseCorpus:
    """N sparse documents padded rectangular: (N, L) sorted uint32 indices
    (sentinel-padded; int32 views) and (N, L) float32 values.

    Corpus-scale retrieval over learned sparse embeddings (SPLADE /
    BM25-style): ragged documents become rectangular sentinel-padded
    tensors (:func:`pad_sparse`), and a scan joins the query into every
    document, with no vocabulary-sized dense scatter, so 32-bit hashed
    index spaces work unchanged. ``docs``: a list of ``(indices, values)``
    pairs (sorted ascending, unique indices) or a pre-padded ``((N, L) idx,
    (N, L) val)`` tuple. Host data goes to ``device`` (default: the default
    device, the card); a tensor stays on its device unless ``device`` is
    given."""

    def __init__(self, docs, width: int | None = None, device=None):
        pair = _as_padded_pair(docs, device)
        idx, val = pair if pair is not None else pad_sparse(docs, width, device)
        self.indices = idx.contiguous()
        self.values = val.contiguous()
        self._t = None  # lazy (L, N) entry-major transposes (the kernel's layout)
        self._finite = None  # lazy all-finite flag, kept for API parity

    def _transposed(self):
        """Cached entry-major ``((L, N) idx, (L, N) val)`` pair, the layout
        the sparse scan streams (entry l of neighbouring documents
        contiguous). Made on the first kNN call; doubles the footprint."""
        if self._t is None:
            self._t = (self.indices.T.contiguous(), self.values.T.contiguous())
        return self._t

    def _all_finite(self) -> bool:
        """Cached all-finite check over the values. The JAX package gates
        its kernel's fast sweep on it; the CUDA scan needs no such gate, so
        nothing here reads it."""
        if self._finite is None:
            self._finite = bool(torch.isfinite(self.values).all())
        return self._finite

    @property
    def num_docs(self) -> int:
        return int(self.indices.shape[0])

    @property
    def width(self) -> int:
        return int(self.indices.shape[1])

    def memory_bytes(self) -> int:
        return int(self.indices.numel()) * 8  # u32 index + f32 value per entry

    def knn(self, query, k: int):
        """Top-k largest sparse dots of one ``(indices, values)`` query."""
        return sparse_knn(query, self, k)

    def knn_batch(self, queries, k: int):
        """Multi-query: padded ``((Q, W) idx, (Q, W) val)`` pair or list of
        ``(indices, values)`` pairs."""
        return sparse_knn_batch(queries, self, k)


def _sorted_queries(q_idx, q_val):
    """Each query (last dim) sorted by its index as unsigned, stably, on the
    device. The scan binary-searches into the query, so an unsorted one
    would miss its matches; the JAX kernel path's sweep takes any order,
    and on a duplicate index its lowest position wins, which a stable sort
    keeps first. The sentinel 0xFFFFFFFF sorts last."""
    order = torch.sort(q_idx.to(torch.int64) & 0xFFFFFFFF, dim=-1, stable=True).indices
    return q_idx.gather(-1, order), q_val.gather(-1, order)


def _query_pair(query, name: str, device):
    if not (isinstance(query, tuple) and len(query) == 2):
        raise ContractError(f"{name}: query must be an (indices, values) pair")
    return _sorted_queries(*_check_pair(query[0], query[1], "query", device))


def sparse_knn(query, corpus: SparseCorpus, k: int):
    """Top-k documents by sparse dot product (descending, IEEE total order,
    ties to the lowest document). ``query``: an ``(indices, values)`` pair
    in any order (sorted here, as the JAX kernel path accepts it; on a
    duplicate index the first occurrence counts). Returns ``(scores,
    indices)``."""
    dev = corpus.indices.device
    q_idx, q_val = _query_pair(query, "sparse_knn", dev)
    n = corpus.num_docs
    if n == 0 or k <= 0:
        return empty_topk((0,), dev)
    idx_t, val_t = corpus._transposed()
    return _sparse.fused_sparse_knn(q_idx, q_val, idx_t, val_t, min(int(k), n))


def sparse_knn_batch(queries, corpus: SparseCorpus, k: int):
    """Multi-query sparse retrieval: (Q, W) padded query pair (or a list of
    ``(indices, values)`` pairs, each in any order, as in
    :func:`sparse_knn`) -> ``(scores (Q, k), indices (Q, k))``, one kernel
    pass over the corpus for the batch."""
    dev = corpus.indices.device
    pair = _as_padded_pair(queries, dev)
    q_idx, q_val = _sorted_queries(*(pair if pair is not None
                                     else pad_sparse(queries, device=dev)))
    n, n_q = corpus.num_docs, int(q_idx.shape[0])
    if n == 0 or k <= 0:
        return empty_topk((n_q, 0), dev)
    k = min(int(k), n)
    if n_q == 0:
        return empty_topk((0, k), dev)
    idx_t, val_t = corpus._transposed()
    return _sparse.fused_sparse_knn_batch(q_idx, q_val, idx_t, val_t, k)


def _token_pair(tokens, device):
    """A pre-padded ``(T, W)`` pair, or a token list padded; None for an
    empty list."""
    if isinstance(tokens, tuple) and len(tokens) == 2:
        idx = as_unsigned(tokens[0], 32, device)
        return idx, as_tensor(tokens[1], torch.float32, idx.device)
    if len(tokens) == 0:
        return None
    return pad_sparse(tokens, device=device)


def sparse_maxsim(query_tokens, doc_tokens) -> torch.Tensor:
    """SPLADE-style late interaction over sparse token vectors
    (reference ``src/sparse.rs:119``): ``sum_i max_j sparse_dot(q_i, d_j)``.
    Inputs are lists of ``(indices, values)`` pairs or pre-padded ``(T,
    W)`` pairs from :func:`pad_sparse`, each token in any order (the
    query's are sorted here). Empty query or doc -> 0.0. The max starts from
    -inf, so all-negative overlaps keep the least negative."""
    q = _token_pair(query_tokens, None)
    if q is not None:
        q = _sorted_queries(*q)
    dev = q[0].device if q is not None else host_device()
    d = _token_pair(doc_tokens, dev)
    if q is None or d is None or q[0].shape[0] == 0 or d[0].shape[0] == 0:
        return torch.tensor(0.0, dtype=torch.float32, device=dev)
    total = torch.tensor(0.0, dtype=torch.float32, device=dev)
    for qi, qv in zip(*q):
        total = total + join_scores(qi, qv, *d).max()
    return total


def pad_sparse_docs(docs, width: int | None = None, tokens: int | None = None, device=None):
    """Pad a list of sparse multi-vector documents (each a list of
    ``(indices, values)`` token pairs) to ``((N, T, W) idx, (N, T, W) val,
    (N, T) token_mask)`` on ``device`` (default: the default device).
    Padded tokens are False in the mask: a zero-valued pad token still dots
    to 0.0, which must not win a max over negative scores."""
    padded = [_pad_np(d, width) if len(d) else
              (np.full((0, 1), SENTINEL_INDEX, np.uint32), np.zeros((0, 1), np.float32))
              for d in docs]
    t_max = max((p[0].shape[0] for p in padded), default=0)
    w_max = max((p[0].shape[1] for p in padded), default=1)
    if tokens is not None:
        if t_max > tokens:
            raise ContractError(f"pad_sparse_docs: a doc has {t_max} tokens > tokens={tokens}")
        t_max = tokens
    t_max = max(t_max, 1)
    if width is not None:
        w_max = max(int(width), w_max)
    idx = np.full((len(docs), t_max, w_max), SENTINEL_INDEX, np.uint32)
    val = np.zeros((len(docs), t_max, w_max), np.float32)
    mask = np.zeros((len(docs), t_max), bool)
    for di, (pi, pv) in enumerate(padded):
        t, w = pi.shape
        idx[di, :t, :w] = pi
        val[di, :t, :w] = pv
        mask[di, :t] = True
    dev = host_device(device)
    return as_unsigned(idx, 32, dev), torch.from_numpy(val).to(dev), torch.from_numpy(mask).to(dev)


def _corpus_maxsim_scores(q_idx2, q_val2, d_idx, d_val, d_tok_mask) -> torch.Tensor:
    """MaxSim of one padded (Tq, Wq) query against a padded ``(N, Td, W)``
    corpus -> (N,): ``sum_i max_j sparse_dot(q_i, d_j)`` per document,
    padded document tokens left out of the max, an empty document 0.0."""
    total = torch.zeros(d_idx.shape[0], dtype=torch.float32, device=d_idx.device)
    for qi, qv in zip(q_idx2, q_val2):
        pair = torch.where(d_tok_mask, join_scores(qi, qv, d_idx, d_val), -torch.inf)
        best = pair.max(dim=1).values
        # Only a fully masked document produces -inf (token dots are finite).
        total = total + torch.where(torch.isneginf(best), 0.0, best)
    return total


def _parse_query_tokens(query_tokens, device):
    """A sparse multi-vector query as a padded ``(Tq, W)`` pair: a list of
    ``(indices, values)`` token pairs, a pre-padded pair, or one 1-D pair
    (one token). An empty query parses to ``(0, 1)`` tensors. Each token is
    sorted by index (:func:`_sorted_queries`; padding stays last): the join
    searches each document id in the token, so an unsorted token would miss
    its matches."""
    if isinstance(query_tokens, tuple) and len(query_tokens) == 2 and not (
            isinstance(query_tokens[0], (tuple, list))):
        q_idx = as_unsigned(query_tokens[0], 32, device)
        q_val = as_tensor(query_tokens[1], torch.float32, q_idx.device)
        if q_idx.shape != q_val.shape or q_idx.dim() not in (1, 2):
            raise ContractError(
                f"sparse maxsim: query indices/values must be matching 1-D or 2-D arrays, "
                f"got {tuple(q_idx.shape)} / {tuple(q_val.shape)}")
        if q_idx.dim() == 1:
            q_idx, q_val = q_idx[None, :], q_val[None, :]
        return _sorted_queries(q_idx, q_val)
    return _sorted_queries(*pad_sparse(query_tokens, device=device))


def sparse_maxsim_batch(query_tokens, docs) -> torch.Tensor:
    """SPLADE-style late interaction of one sparse multi-vector query
    against a corpus of sparse multi-vector documents -> (N,) scores.
    ``query_tokens``: list of ``(indices, values)`` pairs or a padded
    ``(Tq, W)`` pair. ``docs``: list of documents or a pre-padded ``(idx,
    val, token_mask)`` triple. Empty query or corpus -> zeros; an empty
    document scores 0.0."""
    if isinstance(docs, tuple) and len(docs) == 3:
        d_idx = as_unsigned(docs[0], 32)
        d_val = as_tensor(docs[1], torch.float32, d_idx.device)
        d_mask = as_tensor(docs[2], torch.bool, d_idx.device)
    else:
        d_idx, d_val, d_mask = pad_sparse_docs(docs)
    q_idx, q_val = _parse_query_tokens(query_tokens, d_idx.device)
    if d_idx.shape[0] == 0 or q_idx.shape[0] == 0:
        return torch.zeros(d_idx.shape[0], dtype=torch.float32, device=d_idx.device)
    return _corpus_maxsim_scores(q_idx, q_val, d_idx, d_val, d_mask)


def sparse_maxsim_knn(query_tokens, docs, k: int):
    """Top-k documents by sparse MaxSim (descending, IEEE total order).
    Returns ``(scores, indices)``; input forms as
    :func:`sparse_maxsim_batch`."""
    scores = sparse_maxsim_batch(query_tokens, docs)
    n = int(scores.shape[0])
    if n == 0 or k <= 0:
        return empty_topk((0,), scores.device)
    vals, idx = top_k_total(scores, min(int(k), n), largest=True)
    return vals, idx.to(torch.int32)
