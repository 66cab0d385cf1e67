"""Fused MaxSim scoring: the CUDA kernel and its plain version.

Replaces the TPU kernels ``innr_tpu/kernels/maxsim_kernel.py:_maxsim_kernel``
(launched by ``fused_maxsim_scores``, one query) and ``_maxsim_kernel_mq``
(``fused_maxsim_scores_batch``, a batch in one corpus pass). Both are one
kernel per document dtype here, with the query count a runtime parameter:
``csrc/maxsim.cu`` (``maxsim_scores<R>``, FP32 FMAs) for f32
documents and ``csrc/maxsim_bf16.cu`` (``maxsim_scores_bf16``, wgmma on
bf16 operands, the whole query batch resident so that the corpus is read
once per batch) for bf16 documents. Their source notes say what bounds
them on the H100.

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
# csrc/maxsim.cu: warps per CTA at most, doc tokens staged per step.
_MAX_WARPS = 8
_GROUP = 8
# csrc/maxsim_bf16.cu: query tokens per tile when several queries share it
# (one pass of two warpgroups of 4 row tiles of 64).
_BF16_MAX_TOKENS = 512

# Kernel launches (one per scored batch), in all and by document dtype.
# Incremented only where the kernel launches.
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"float32": 0, "bfloat16": 0}


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


def _tiling(n_b: int, tq: int, d: int) -> tuple[int, int, int, int]:
    """``(tokens per lane R, queries per tile, tile tokens, warps)`` for
    ``csrc/maxsim.cu``: whole queries in a tile of 32 R tokens (one query,
    its tokens in steps of 128, when Tq > 128), and the most warps whose
    shared memory fits. Raises :class:`ContractError` when none does."""
    if tq > 128:
        r, qpt, tt = 4, 1, round_up(tq, 128)
    else:
        total = n_b * tq
        r = 1 if total <= 32 else 2 if total <= 64 else 4
        while 32 * r < tq:
            r *= 2
        tt = 32 * r
        qpt = min(n_b, tt // tq)
    d4 = round_up(d, 4)
    warps = _MAX_WARPS
    while warps > 1 and 4 * (d4 * tt + warps * (_GROUP * d4 + tt)) > SMEM_LIMIT:
        warps //= 2
    smem = 4 * (d4 * tt + warps * (_GROUP * d4 + tt))
    if smem > SMEM_LIMIT:
        raise ContractError(
            f"innr_tpu_torch::maxsim_scores: D={d} and a tile of {tt} query tokens need "
            f"{smem} bytes of shared memory; a CTA has at most {SMEM_LIMIT}")
    if -(-n_b // qpt) > 65535:
        raise ContractError(f"innr_tpu_torch::maxsim_scores: {n_b} queries in one batch")
    return r, qpt, tt, warps


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
    global LAUNCHES
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
            r, qpt, tt, warps = _tiling(n_b, tq, d)
            rc = lib.innr_maxsim_scores(
                q.data_ptr(), docs.data_ptr(), m_ptr, out.data_ptr(), n_b, tq, td, d, n, r, qpt,
                tt, warps, stream)
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
