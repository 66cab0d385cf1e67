"""Fused MaxSim scoring: the CUDA kernel and its plain version.

Replaces the TPU kernels ``innr_tpu/kernels/maxsim_kernel.py:_maxsim_kernel``
(launched by ``fused_maxsim_scores``, one query) and ``_maxsim_kernel_mq``
(``fused_maxsim_scores_batch``, a batch in one corpus pass). Both are one
kernel per document dtype here, with the query count a runtime parameter:
``csrc/maxsim.cu`` (``maxsim_scores``, TF32 wgmma dots, a gate within
:func:`maxsim_margin`, and an exact FP32 FMA re-score of the tokens that
could be each query token's best, so the scores are those of the FMA
arithmetic bit for bit; :func:`maxsim_rescore_stats` reads the re-scored
pairs) for f32 documents and ``csrc/maxsim_bf16.cu``
(``maxsim_scores_bf16``, wgmma on bf16 operands, the whole query batch
resident so that the corpus is read once per batch) for bf16 documents.
Their source notes say what bounds them on the H100.

For document n and query b::

    score[b, n] = sum_i clamp(max over valid j of q[b, i] . d[n, j])

``clamp`` turns -inf into 0 (a fully masked document, or any -inf best);
NaN and +inf propagate (the max is NaN-sticky, as ``jnp.max`` is); masked
document tokens never win. Each query is summed on its own: the TPU
kernel's group-indicator matmul lets a NaN or inf in one query's bests
reach every query of the batch (``ROADMAP.md`` R7), which the function
does not. A batch takes one shared Tq: pad shorter queries with zero
tokens, which add max(0, ...) each, as in the JAX package (R3).

bf16 documents meet the query rounded to bf16: products of two bf16 values
are exact in float32, so the tensor-core kernel and the plain version
compute the JAX package's bf16 function (bf16 operands, float32
accumulation; the order of the sums differs). The
corpus is neither padded nor copied: the kernel takes any Td and D and the
bool mask as bytes. NaN scores come back as the canonical 0x7FC00000.
Selection (``fused_maxsim_knn*``) is :func:`top_k_total` outside the
kernel, as in the JAX package: the k largest, NaN first, ties to the
lowest document.

Dispatch: a CUDA tensor runs the kernel, or the call raises; a CPU tensor,
or :func:`innr_tpu_torch.config.force_reference`, runs the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from innr_tpu_torch import config
from innr_tpu_torch.kernels.row_scan import SMEM_LIMIT
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import canonical_nan, top_k_total
from innr_tpu_torch.utils.padding import round_up
from innr_tpu_torch.utils.tensors import as_tensor

# Elements of the (chunk, Td, B Tq) pair tensor of the plain version per
# document chunk: 2 GiB of float32.
_PLAIN_PAIRS = 1 << 29
# csrc/maxsim.cu: query tokens per tile when several queries share it (one
# pass of two warpgroups of 2 row tiles of 64), the dimensions of a block
# when the tile is staged per block, and the most token positions of a
# document segment (its valid-token list sits in shared memory).
_F32_MAX_TOKENS = 256
_DIM_BLOCK = 128
_SEG_POSITIONS = 1024
# Shared memory of each of two CTAs on one SM (228 KB per SM, 1 KB of it
# reserved per CTA).
_HALF_SM_SMEM = 232_448 // 2 - 1024
# csrc/maxsim_bf16.cu: query tokens per tile when several queries share it
# (one pass of two warpgroups of 4 row tiles of 64).
_BF16_MAX_TOKENS = 512

# Kernel launches (one per scored batch), in all and by document dtype.
# Incremented only where the kernel launches.
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"float32": 0, "bfloat16": 0}
# Diagnostics only, as in kernels/knn.py: each call allocates its own
# scratch, so concurrent calls share none.
# The last f32 launch's (query tokens, documents, device counter of the
# (query token, document token) pairs it re-scored exactly); read by
# maxsim_rescore_stats().
_LAST_RESCORED = None
# Query tokens whose norm is not below this (or not finite) get every pair
# re-scored, and so do document tokens (csrc/maxsim.cu): the bound assumes
# no overflow.
_REGULAR_NORM = 2.0**50
# Added to a computed norm: the most that squares which underflow can take
# from it (sqrt(D) 2^-75 for any D below 2^31).
_NORM_SLACK = 2.0**-59
_U = 2.0**-24  # unit roundoff of float32


class MaxSimMargin(NamedTuple):
    """The f32 kernel's gate margin: the TF32 tensor-core dot s~ of a query
    token q and a document token x lies within

        T = kappa ||q|| ||x|| + abs

    of the exact FMA dot s, for tokens with norms below 2^50."""

    kappa: float
    abs: float


def maxsim_margin(d: int) -> MaxSimMargin:
    """The bound csrc/maxsim.cu's gate uses for dimension D, a bound T_ij
    >= |s~_ij - s_ij| per (query token i, document token j). With P = sum
    |q_k x_k| <= ||q|| ||x|| and u = 2^-24:

    - TF32 operands: the tensor core truncates each f32 operand to 10
      mantissa bits (relative error below 2^-10), so each product is off by
      at most (2 2^-10 + 2^-20) of itself; products of two TF32 values are
      exact in f32, and their f32 accumulation in the tensor core, in an
      order and with a rounding (truncation, possibly) the hardware does
      not state, adds at most 2 (D + 8) 2^-23 (1 + 2^-8) P over the D
      products (``assign.shortlist_margin``'s term). Together eta P.
    - The exact FMA chain: gamma_D P with gamma_D = D u / (1 - D u).
    - The gate's roundings: fl(s~ + T) and fl(s~ - T) round once each, and
      T itself is one fused multiply-add of f32 terms: each at most u
      (|s~| + T) with |s~| <= (1 + eta) P; 4 u (1 + eta) P covers them.
    - Subnormals: a flushed operand, or an underflowing product, costs at
      most 2^-126 (||q|| + ||x|| + 1) per term; with norms below 2^50,
      abs = 2 D 2^-74 covers 4 D of them.
    - A safety factor of 2, which also covers the f32 roundings of the
      norms (the kernel sums ||x||^2 from the staged row; D u relative at
      most) and of kappa ||q||.

    kappa = 2 (eta + gamma_D + 4 u (1 + eta)), abs = 2 D 2^-74. A margin
    that is not finite (D u >= 1/2) admits every pair."""
    d = int(d)
    if d * _U >= 0.5:
        return MaxSimMargin(float("inf"), float("inf"))
    gamma = d * _U / (1.0 - d * _U)
    eta = 2 * 2.0**-10 + 2.0**-20 + 2 * (d + 8) * 2.0**-23 * (1 + 2.0**-8)
    return MaxSimMargin(kappa=2 * (eta + gamma + 4 * _U * (1 + eta)), abs=2 * d * 2.0**-74)


def maxsim_query_terms(q) -> torch.Tensor:
    """(B Tq,) float32 ``kappa (||q_i|| + slack)`` per query token, +inf for
    a token that is not finite or whose norm is not below 2^50 (every pair
    of it is then re-scored)."""
    m = maxsim_margin(q.shape[-1])
    qn = torch.sqrt((q.float() * q.float()).sum(dim=-1)).reshape(-1)
    regular = torch.isfinite(qn) & (qn < _REGULAR_NORM)
    return torch.where(regular, m.kappa * (qn + _NORM_SLACK), torch.inf).to(torch.float32)


def maxsim_rescore_stats():
    """``(query tokens, documents, pairs)`` of the last f32 kernel launch:
    its B Tq query tokens, its N documents and the (query token, document
    token) pairs it re-scored exactly. Reads a device counter
    (synchronises); None before any launch."""
    if _LAST_RESCORED is None:
        return None
    n_tok, n, counter = _LAST_RESCORED
    return n_tok, n, int(counter.item())


def _inputs(q, docs, doc_mask, op: str):
    """``(q (B, Tq, D) float32, docs (N, Td, D) float32 or bfloat16, mask
    (N, Td) bool or None)`` on the documents' device, checked."""
    if not (isinstance(docs, torch.Tensor) and docs.dtype == torch.bfloat16):
        docs = as_tensor(docs, torch.float32)
    q = as_tensor(q, torch.float32, docs.device)
    if q.dim() != 3 or docs.dim() != 3 or q.shape[2] != docs.shape[2]:
        raise ContractError(
            f"innr_tpu_torch::{op}: queries {tuple(q.shape)} and documents "
            f"{tuple(docs.shape)} must be (B, Tq, D) and (N, Td, D)")
    mask = None
    if doc_mask is not None:
        mask = as_tensor(doc_mask, torch.bool, docs.device)
        if tuple(mask.shape) != tuple(docs.shape[:2]):
            raise ContractError(
                f"innr_tpu_torch::{op}: doc_mask {tuple(mask.shape)} must be "
                f"{tuple(docs.shape[:2])}")
    if docs.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16).float()
    return q, docs, mask


def _f32_smem(mt: int, ts: int, d: int, tpw: int, kb: int, seg: int) -> int:
    """Shared memory of csrc/maxsim.cu for a tile of mt query tokens (rows
    of two warpgroups' passes of tpw row tiles each), items of ts document
    tokens and segments of ``seg`` positions: the two item buffers, the
    query tile (resident, kb = 0, or one pass by a block of kb dimensions),
    the token norms, each query token's gate limits (one per warpgroup) and
    best, the segments' token lists."""
    dp = round_up(d, 8)
    q = mt * dp if kb == 0 else 2 * tpw * 64 * kb
    return 4 * (2 * ts * dp + q + ts + 3 * mt) + 4 * 3 * (seg + 1)


def _tiling(n_b: int, tq: int, td: int, d: int) -> tuple[int, int, int, int, int, int, int]:
    """``(queries per tile, tile tokens (a multiple of 64), row tiles per
    warpgroup and pass, document tokens per item, token positions per
    segment, CTAs per SM, dimension block (0: the tile resident))`` for
    ``csrc/maxsim.cu``: as many whole queries as 256 tokens hold (at B =
    16, Tq = 32 half the batch, so the corpus is read twice; one query,
    scored in passes of 256 tokens, when Tq > 256), resident in shared
    memory when it fits beside two items of 8 document tokens, else staged
    per pass in blocks of 128 dimensions; documents in segments of at most
    1024 positions, whose valid tokens are scored in items of the most
    tokens that fit, a multiple of the 64-token chunk when that is at
    least one chunk (up to the segment's length). A resident tile of one
    row tile per warpgroup runs two CTAs per SM when each fits in half the
    SM's shared memory with items of a chunk. Raises :class:`ContractError`
    when not even two items of 8 tokens fit."""
    dp = round_up(d, 8)
    qpt = min(n_b, max(1, _F32_MAX_TOKENS // tq))
    mt = round_up(qpt * tq, 64)
    seg = min(td, _SEG_POSITIONS)

    def ts_max(tpw: int, kb: int, limit: int = SMEM_LIMIT) -> int:
        free = limit - _f32_smem(mt, 0, d, tpw, kb, seg)
        ts = free // (4 * (2 * dp + 1))
        return ts // 64 * 64 if ts >= 64 else ts // 8 * 8

    tpw, kb = (1 if mt // 64 <= 2 else 2), 0
    if ts_max(tpw, 0) < 8:
        kb = min(dp, _DIM_BLOCK)
        if ts_max(tpw, kb) < 8:
            tpw = 1
        if ts_max(tpw, kb) < 8:
            raise ContractError(
                f"innr_tpu_torch::maxsim_scores: Tq={tq}, D={d} need "
                f"{_f32_smem(mt, 8, d, tpw, kb, seg)} bytes of shared memory; a CTA has at "
                f"most {SMEM_LIMIT}")
    ctas, limit = 1, SMEM_LIMIT
    if tpw == 1 and kb == 0 and ts_max(1, 0, _HALF_SM_SMEM) >= 64:
        ctas, limit = 2, _HALF_SM_SMEM
    ts = min(ts_max(tpw, kb, limit), round_up(seg, 8))
    if -(-n_b // qpt) > 65535:
        raise ContractError(f"innr_tpu_torch::maxsim_scores: {n_b} queries in one batch")
    return qpt, mt, tpw, ts, seg, ctas, kb


def _bf16_smem(tt: int, ts: int, d: int) -> int:
    """Shared memory of csrc/maxsim_bf16.cu for a tile of tt query tokens
    and document segments of ts tokens: two segment buffers and the queries
    in bf16, the token lists, the maxes."""
    dp = round_up(d, 16)
    return 2 * (2 * ts * dp + tt * dp) + 4 * (2 * ts + 3 + tt)


def _tiling_bf16(n_b: int, tq: int, td: int, d: int) -> tuple[int, int, int, int]:
    """``(queries per tile, tile tokens (a multiple of 64), row tiles per
    warpgroup and pass, document tokens per segment (a multiple of 8))`` for
    ``csrc/maxsim_bf16.cu``: as many whole queries as 512 tokens hold (at
    B = 16, Tq = 32 the batch, so the corpus is read once; one query, scored
    in passes of 512 tokens, when Tq > 512), halved while not even a segment
    of 8 document tokens fits beside them; then documents in equal segments
    of the most tokens that fit (the whole document when it does). Raises
    :class:`ContractError` when one query and 8 tokens do not fit."""
    dp = round_up(d, 16)
    qpt = min(n_b, max(1, _BF16_MAX_TOKENS // tq))
    while True:
        tt = round_up(qpt * tq, 64)
        ts_max = (SMEM_LIMIT - _bf16_smem(tt, 0, d)) // (4 * dp + 8) // 8 * 8
        if ts_max >= 8:
            break
        if qpt == 1:
            raise ContractError(
                f"innr_tpu_torch::maxsim_scores: bf16 documents with Tq={tq}, D={d} need "
                f"{_bf16_smem(tt, 8, d)} bytes of shared memory for one query; a CTA has at "
                f"most {SMEM_LIMIT}")
        qpt = -(-qpt // 2)
    n_seg = -(-td // ts_max)
    ts = round_up(-(-td // n_seg), 8)
    tiles = tt // 64
    tpw = 1 if tiles <= 2 else 2 if tiles <= 4 else 4
    if -(-n_b // qpt) > 65535:
        raise ContractError(f"innr_tpu_torch::maxsim_scores: {n_b} queries in one batch")
    return qpt, tt, tpw, ts


def maxsim_scores_plain(q_batch, docs, doc_mask=None) -> torch.Tensor:
    """The plain version of the kernel: (B, N) float32 scores of a (B, Tq,
    D) batch. Runs over document chunks so that the (chunk, Td, B Tq) pair
    tensor stays within 2 GiB; NaN scores canonical."""
    return _plain(*_inputs(q_batch, docs, doc_mask, "maxsim_scores_plain"))


def _plain(q, docs, mask) -> torch.Tensor:
    (n_b, tq, d), (n, td, _) = q.shape, docs.shape
    out = torch.zeros((n_b, n), dtype=torch.float32, device=docs.device)
    if n_b == 0 or n == 0 or tq == 0 or td == 0 or d == 0:
        return out
    flat = q.reshape(n_b * tq, d).T
    step = max(1, _PLAIN_PAIRS // (td * n_b * tq))
    for s in range(0, n, step):
        pair = docs[s:s + step].float() @ flat  # (chunk, Td, B Tq)
        if mask is not None:
            pair = torch.where(mask[s:s + step, :, None], pair, -torch.inf)
        best = pair.amax(dim=1)  # NaN-sticky
        best = torch.where(best == -torch.inf, 0.0, best)
        # "+ 0.0": the kernel's sums start from +0.0.
        out[:, s:s + step] = best.reshape(-1, n_b, tq).sum(dim=2).T + 0.0
    return canonical_nan(out)


def _kernel(q, docs, mask) -> torch.Tensor:
    global LAUNCHES, _LAST_RESCORED
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    (n_b, tq, d), (n, td, _) = q.shape, docs.shape
    dev = docs.device
    m_ptr = None if mask is None else mask.data_ptr()
    with torch.cuda.device(dev):
        out = torch.empty((n_b, n), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if docs.dtype == torch.bfloat16:
            qpt, tt, tpw, ts = _tiling_bf16(n_b, tq, td, d)
            rc = lib.innr_maxsim_scores_bf16(
                q.data_ptr(), docs.data_ptr(), m_ptr, out.data_ptr(), n_b, tq, td, d, n, qpt,
                tt, tpw, ts, stream)
        else:
            qpt, mt, tpw, ts, seg, ctas, kb = _tiling(n_b, tq, td, d)
            qterm = maxsim_query_terms(q).contiguous()
            counter = torch.zeros(1, dtype=torch.int64, device=dev)
            rc = lib.innr_maxsim_scores(
                q.data_ptr(), docs.data_ptr(), m_ptr, qterm.data_ptr(), maxsim_margin(d).abs,
                counter.data_ptr(), out.data_ptr(), n_b, tq, td, d, n, qpt, mt, tpw, ts, seg,
                ctas, kb, stream)
            _LAST_RESCORED = (n_b * tq, n, counter)
    if rc != 0:
        raise RuntimeError(f"innr_tpu_torch: maxsim_scores launch failed, cudaError {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[str(docs.dtype).removeprefix("torch.")] += 1
    return out


def fused_maxsim_scores_batch(q_batch, docs, doc_mask=None) -> torch.Tensor:
    """MaxSim scores of a (B, Tq, D) query batch against (N, Td, D)
    documents -> (B, N) float32, in one launch. ``doc_mask``: optional
    (N, Td) bool, False for padded tokens; a document with no valid token
    scores 0.0."""
    q, docs, mask = _inputs(q_batch, docs, doc_mask, "fused_maxsim_scores_batch")
    (n_b, tq, d), (n, td, _) = q.shape, docs.shape
    dev = docs.device
    if dev.type == "cpu" or config.reference_forced():
        return _plain(q, docs, mask)
    if dev.type != "cuda":
        raise ContractError(f"innr_tpu_torch::maxsim_scores: unsupported device {dev}")
    if n > 2**31 - 1:
        raise ContractError(f"innr_tpu_torch::maxsim_scores: {n} documents (< 2**31)")
    if n_b == 0 or n == 0 or tq == 0 or td == 0 or d == 0:
        return torch.zeros((n_b, n), dtype=torch.float32, device=dev)
    return _kernel(q.contiguous(), docs.contiguous(),
                   None if mask is None else mask.contiguous())


def fused_maxsim_scores(q_tokens, docs, doc_mask=None) -> torch.Tensor:
    """MaxSim scores of one (Tq, D) query -> (N,) float32."""
    q = as_tensor(q_tokens, torch.float32, getattr(docs, "device", None))
    if q.dim() != 2:
        raise ContractError(
            f"innr_tpu_torch::fused_maxsim_scores: query must be (Tq, D), got {tuple(q.shape)}")
    return fused_maxsim_scores_batch(q[None], docs, doc_mask)[0]


def _top(scores, k: int):
    vals, idx = top_k_total(canonical_nan(scores), k, largest=True)
    return vals, idx.to(torch.int32)


def fused_maxsim_knn(q_tokens, docs, k: int, doc_mask=None):
    """Top-k documents by MaxSim for one query: ``(scores (k,) descending
    under IEEE total order, indices (k,) int32)``, k in [1, N]."""
    return _top(fused_maxsim_scores(q_tokens, docs, doc_mask), k)


def fused_maxsim_knn_batch(q_batch, docs, k: int, doc_mask=None):
    """Top-k documents by MaxSim for a (B, Tq, D) batch, one corpus pass:
    ``(scores (B, k), indices (B, k) int32)``."""
    return _top(fused_maxsim_scores_batch(q_batch, docs, doc_mask), k)
