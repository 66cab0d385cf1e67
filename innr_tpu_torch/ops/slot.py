"""Integer-slot Hamming distance and MinHash retrieval.

The counterpart of :mod:`innr_tpu.ops.slot` (reference ``src/slot.rs``).
Slots are ``uint16`` / ``uint32`` / ``uint64`` values held as bit-identical
``int16`` / ``int32`` / ``int64`` views (:mod:`innr_tpu_torch.utils.bits`):
equality is the same on the views, and the one ordering here
(:func:`slot_compare_counts`) compares on the host as unsigned. u64 slots
are int64 views, where the JAX package splits them into (hi, lo) uint32
pairs. Host data goes to the default device (the card) unless a ``device``
is given; a tensor keeps its device, and a tensor of a view type is taken
as the unsigned type of its width (int32 is uint32).

The corpus scans run on the hand-written CUDA kernel ``slot_scan``
(:mod:`innr_tpu_torch.kernels.slot_knn`) for a corpus on a CUDA device and
on its plain version for a corpus on the CPU: ``slot_knn_u16`` /
``slot_knn_u32`` / ``minhash_knn`` and their ``_batch`` forms. A
:class:`SketchCorpus` keeps the slot-major transpose the kernel streams; a
raw (N, S) tensor on the card is transposed once per call, a copy of the
corpus. Any k runs in the kernel. The JAX package takes its kernel only at
N >= ``MIN_ROWS_PALLAS`` and k <= its pass cap; its other path selects the
same rows.

Return types: counts are int32 tensors (the JAX package returns uint32;
the values are equal), indices int32, similarities float32, all on the
corpus's device. Contracts: the width-specific functions raise on length
mismatch; the generic :func:`slot_hamming` and :func:`slot_compare_counts`
compare over the minimum length. ``minhash_jaccard`` of two empty sketches
is 1.0; ``jaccard_distance`` is 0.0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from innr_tpu_torch.kernels import slot_knn as _slot
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.bits import VIEW_DTYPES, as_unsigned, unsigned_bits, unsigned_to_numpy

__all__ = [
    "SketchCorpus",
    "SlotCounts",
    "slot_hamming",
    "slot_hamming_u16",
    "slot_hamming_u32",
    "slot_hamming_u64",
    "slot_compare_counts",
    "minhash_jaccard",
    "jaccard_distance",
    "batch_slot_hamming_u32",
    "slot_knn_u16",
    "slot_knn_u16_batch",
    "slot_knn_u32",
    "slot_knn_u32_batch",
    "minhash_knn",
    "minhash_knn_batch",
]


@dataclass(frozen=True)
class SlotCounts:
    """(eq, lt, gt) triple from :func:`slot_compare_counts`
    (reference ``src/slot.rs:314``). ``eq + lt + gt`` equals the number of
    compared positions."""

    eq: int = 0
    lt: int = 0
    gt: int = 0


def _check_len(a, b, op: str) -> None:
    if a.shape[-1] != b.shape[-1]:
        raise ContractError(
            f"innr_tpu_torch::{op}: slice length mismatch ({a.shape[-1]} vs {b.shape[-1]})")


def _differing(a, b, bits: int, op: str) -> torch.Tensor:
    a = as_unsigned(a, bits)
    b = as_unsigned(b, bits, a.device)
    _check_len(a, b, op)
    return (a != b).sum(dtype=torch.int32)


def slot_hamming_u32(a, b) -> torch.Tensor:
    """Differing-slot count over u32 slots (reference ``src/slot.rs:95``)."""
    return _differing(a, b, 32, "slot_hamming_u32")


def slot_hamming_u16(a, b) -> torch.Tensor:
    """Differing-slot count over u16 slots, the b=16 b-bit MinHash width
    (reference ``src/slot.rs:158``)."""
    return _differing(a, b, 16, "slot_hamming_u16")


def slot_hamming_u64(a, b) -> torch.Tensor:
    """Differing-slot count over u64 slots (reference ``src/slot.rs:209``),
    compared as int64 views."""
    return _differing(a, b, 64, "slot_hamming_u64")


def _host(x) -> np.ndarray:
    """Slots as a numpy array; a tensor of a view type as its unsigned
    values."""
    if isinstance(x, torch.Tensor):
        if unsigned_bits(x.dtype) is not None:
            return unsigned_to_numpy(x.view(VIEW_DTYPES[x.element_size() * 8]))
        return x.detach().cpu().numpy()
    return np.asarray(x)


def slot_hamming(a, b) -> int:
    """Generic differing-slot count over the *minimum* length, any integer
    width (reference ``src/slot.rs:266``), compared on the host."""
    a, b = _host(a).reshape(-1), _host(b).reshape(-1)
    n = min(a.size, b.size)
    return int(np.sum(a[:n] != b[:n])) if n else 0


def slot_compare_counts(a, b) -> SlotCounts:
    """Per-position (eq, lt, gt) counts over the minimum length
    (reference ``src/slot.rs:299``): an unsigned order, compared on the host
    (a signed compare of the views would put slots >= 2**31 or 2**63
    first)."""
    a, b = _host(a).reshape(-1), _host(b).reshape(-1)
    n = min(a.size, b.size)
    if n == 0:
        return SlotCounts()
    a, b = a[:n], b[:n]
    if a.dtype == np.uint64 or b.dtype == np.uint64:
        a, b = a.astype(np.uint64), b.astype(np.uint64)
    eq = int(np.sum(a == b))
    lt = int(np.sum(a < b))
    return SlotCounts(eq=eq, lt=lt, gt=n - eq - lt)


def _fraction(a, b, same: bool, empty: float, op: str) -> torch.Tensor:
    a = as_unsigned(a, 32)
    b = as_unsigned(b, 32, a.device)
    _check_len(a, b, op)
    n = a.shape[-1]
    if n == 0:
        return torch.tensor(empty, dtype=torch.float32, device=a.device)
    count = ((a == b) if same else (a != b)).sum(dtype=torch.int32)
    return count.to(torch.float32) / torch.tensor(float(n), dtype=torch.float32, device=a.device)


def minhash_jaccard(a, b) -> torch.Tensor:
    """MinHash Jaccard similarity: fraction of matching u32 slots
    (reference ``src/slot.rs:348``). Two empty sketches -> 1.0."""
    return _fraction(a, b, True, 1.0, "minhash_jaccard")


def jaccard_distance(a, b) -> torch.Tensor:
    """MinHash Jaccard distance: fraction of differing u32 slots
    (reference ``src/slot.rs:392``). Two empty sketches -> 0.0."""
    return _fraction(a, b, False, 0.0, "jaccard_distance")


def _dtype_of(x):
    """The dtype of an input without copying a tensor or device array;
    lists through numpy."""
    dt = getattr(x, "dtype", None)
    return dt if dt is not None else np.asarray(x).dtype


def _check_no_narrowing(in_dtype, bits: int, op: str) -> None:
    """Reject silently-wrapping casts: a u32 / u64 sketch fed to a u16 entry
    point (or u64 to u32) would truncate every slot mod 2^b and return
    wrong neighbours with no diagnostic. A tensor of a view type counts as
    the unsigned type of its width."""
    if in_dtype is None:
        return
    in_bits = unsigned_bits(in_dtype)
    if in_bits is not None and in_bits > bits:
        raise ContractError(
            f"innr_tpu_torch::{op}: uint{in_bits} slots passed to a uint{bits} entry point "
            "would be truncated — convert explicitly if intentional")


class SketchCorpus:
    """An (N, S) sketch corpus with a cached slot-major transpose.

    ``sketches`` (N, S) and ``slots_t`` (S, N) are int32 views of uint32
    slots, or int16 views of uint16 (b-bit MinHash b=16: half the bytes).
    The slot scan streams ``slots_t``: caching it means a scan reads the
    corpus once, with no layout copy per call. ``dtype=None`` keeps a
    uint16 input (numpy uint16, a torch int16 / uint16 tensor) at 16 bits
    and makes anything else uint32; a wider input raises. Host data goes
    to ``device``, default :func:`innr_tpu_torch.config.default_device`
    (the card); a tensor stays on its device unless ``device`` is given."""

    __slots__ = ("sketches", "slots_t")

    def __init__(self, sketches, dtype=None, device=None):
        in_dtype = _dtype_of(sketches)
        if dtype is None:
            bits = 16 if unsigned_bits(in_dtype) == 16 else 32
        else:
            bits = unsigned_bits(dtype)
            if bits not in (16, 32):
                raise ContractError("SketchCorpus: dtype must be uint16 or uint32")
        _check_no_narrowing(in_dtype, bits, "SketchCorpus")
        sketches = as_unsigned(sketches, bits, device)
        if sketches.dim() != 2:
            raise ContractError("SketchCorpus: sketches must be 2-D (N, S)")
        self.sketches = sketches.contiguous()
        self.slots_t = self.sketches.T.contiguous()  # (S, N), the kernel's layout

    @property
    def num_sketches(self) -> int:
        return int(self.sketches.shape[0])

    @property
    def num_slots(self) -> int:
        return int(self.sketches.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        """The storage type: torch.int32 (uint32 slots) or torch.int16
        (uint16)."""
        return self.sketches.dtype

    @property
    def bits(self) -> int:
        """The slot width: 16 or 32."""
        return self.sketches.element_size() * 8

    def memory_bytes(self) -> int:
        # Both the row-major sketches and the cached slot-major transpose
        # live on the device.
        return int(self.sketches.numel()) * 2 * self.sketches.element_size()


def _slot_corpus(corpus, bits: int):
    """(SketchCorpus | (N, S) array) -> (sketches, slots_t), checking the
    slot width. A raw corpus's ``slots_t`` is a transposed view: the kernel
    copies it once per call."""
    if isinstance(corpus, SketchCorpus):
        if corpus.bits != bits:
            raise ContractError(
                f"slot kNN: corpus slot dtype uint{corpus.bits} does not match the uint{bits} "
                "entry point")
        return corpus.sketches, corpus.slots_t
    _check_no_narrowing(_dtype_of(corpus), bits, "slot kNN")
    sketches = as_unsigned(corpus, bits)
    if sketches.dim() != 2:
        raise ContractError("slot kNN: the corpus must be 2-D (N, S)")
    return sketches, sketches.T


def _empty(shape, dev):
    return (torch.zeros(shape, dtype=torch.int32, device=dev),
            torch.zeros(shape, dtype=torch.int32, device=dev))


def _sketch_knn(query, corpus, k: int, bits: int, op: str):
    _check_no_narrowing(_dtype_of(query), bits, op)
    sketches, slots_t = _slot_corpus(corpus, bits)
    query = as_unsigned(query, bits, sketches.device)
    if query.dim() != 1:
        raise ContractError(f"{op}: query must be 1-D (S,); use {op}_batch for (Q, S) batches")
    _check_len(query, sketches, op)
    n = int(sketches.shape[0])
    if n == 0 or k <= 0:
        return _empty((0,), sketches.device)
    return _slot.fused_slot_knn(query, slots_t, min(int(k), n))


def _sketch_knn_batch(queries, corpus, k: int, bits: int, op: str):
    _check_no_narrowing(_dtype_of(queries), bits, op)
    sketches, slots_t = _slot_corpus(corpus, bits)
    queries = as_unsigned(queries, bits, sketches.device)
    if queries.dim() != 2:
        raise ContractError(f"{op}: queries must be 2-D (Q, S)")
    _check_len(queries, sketches, op)
    n, n_q = int(sketches.shape[0]), int(queries.shape[0])
    if n == 0 or k <= 0:
        return _empty((n_q, 0), sketches.device)
    k = min(int(k), n)
    if n_q == 0:
        return _empty((0, k), sketches.device)
    return _slot.fused_slot_knn_batch(queries, slots_t, k)


def slot_knn_u32(query, corpus, k: int):
    """Top-k most similar u32 sketches: smallest differing-slot counts.
    ``query``: (S,) uint32; ``corpus``: (N, S) uint32 or a
    :class:`SketchCorpus`. A raw corpus on the card is transposed to the
    kernel's slot-major layout on every call, a copy of the corpus; build a
    :class:`SketchCorpus` once to scan without it. Returns ``(counts
    ascending, indices)``."""
    return _sketch_knn(query, corpus, k, 32, "slot_knn_u32")


def slot_knn_u32_batch(queries, corpus, k: int):
    """Multi-query slot-sketch kNN: one kernel pass reads the corpus once
    for a (Q, S) batch. Returns ``(counts (Q, k) ascending, indices (Q,
    k))``."""
    return _sketch_knn_batch(queries, corpus, k, 32, "slot_knn_u32_batch")


def slot_knn_u16(query, corpus, k: int):
    """Top-k most similar u16 sketches (the b=16 b-bit MinHash width,
    reference ``src/slot.rs:158``): half the bytes of the u32 scan.
    ``corpus``: (N, S) uint16 or a uint16 :class:`SketchCorpus` (a raw
    corpus costs a transposed copy per call, as in :func:`slot_knn_u32`)."""
    return _sketch_knn(query, corpus, k, 16, "slot_knn_u16")


def slot_knn_u16_batch(queries, corpus, k: int):
    """Multi-query u16 sketch kNN (see :func:`slot_knn_u16`)."""
    return _sketch_knn_batch(queries, corpus, k, 16, "slot_knn_u16_batch")


def _minhash_bits(query, corpus) -> int:
    """The CORPUS is the authoritative slot width (a u16 query against a
    raw u32 corpus must not narrow the corpus)."""
    if isinstance(corpus, SketchCorpus):
        return corpus.bits
    corpus_dt = getattr(corpus, "dtype", None)
    if corpus_dt is not None:
        return 16 if unsigned_bits(corpus_dt) == 16 else 32
    return 16 if unsigned_bits(_dtype_of(query)) == 16 else 32


def _similarities(counts, s: int) -> torch.Tensor:
    """``1 - count / S`` in float32, as the JAX package computes it."""
    denom = torch.tensor(float(max(s, 1)), dtype=torch.float32, device=counts.device)
    return 1.0 - counts.to(torch.float32) / denom


def minhash_knn(query, corpus, k: int):
    """Top-k sketches by MinHash Jaccard similarity (descending): the
    matching-slot fraction of :func:`minhash_jaccard`, corpus-wide, over a
    u32 or u16 corpus (the width follows the corpus). Returns
    ``(similarities, indices)``."""
    counts, idx = _sketch_knn(query, corpus, k, _minhash_bits(query, corpus), "minhash_knn")
    return _similarities(counts, np.shape(query)[-1]), idx


def minhash_knn_batch(queries, corpus, k: int):
    """Multi-query MinHash retrieval: (Q, S) sketches -> top-k Jaccard
    similarities (descending) per query, one corpus read for the batch."""
    counts, idx = _sketch_knn_batch(queries, corpus, k, _minhash_bits(queries, corpus),
                                    "minhash_knn_batch")
    return _similarities(counts, np.shape(queries)[-1]), idx


def batch_slot_hamming_u32(query, corpus) -> torch.Tensor:
    """Differing-slot counts of one u32 sketch against an (N, S) u32 corpus
    -> (N,) int32 (plain torch, as the JAX package has no kernel for it)."""
    corpus = as_unsigned(corpus, 32)
    query = as_unsigned(query, 32, corpus.device)
    _check_len(query, corpus, "batch_slot_hamming_u32")
    return (corpus != query[None, :]).sum(dim=1, dtype=torch.int32)
