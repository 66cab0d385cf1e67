"""Per-row packed-word scores: the CUDA kernel and its plain version.

Replaces the TPU kernels of ``innr_tpu/kernels/hamming.py``:
``_hamming_kernel`` (``batch_hamming_words``, XOR-popcount counts) and
``_ternary_kernel`` (``batch_ternary_dot_words``, ternary dots). The kernel
is ``csrc/packed.cu`` (``packed_rows``); its source note says what bounds
it on the H100.

Words are the JAX package's ``uint32`` words held as bit-identical int32
(:mod:`innr_tpu_torch.utils.bits`). Both functions return (N,) int32 (the
JAX Hamming form returns uint32; the values are equal).

Dispatch: a CUDA tensor runs the kernel, or the call raises; a CPU tensor,
or :func:`innr_tpu_torch.config.force_reference`, runs the plain version.
"""

from __future__ import annotations

import torch

from innr_tpu_torch import config
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.bits import word_scores

# Kernel launches, in all and by kind. Incremented only where the kernel
# launches.
LAUNCHES = 0
LAUNCHES_BY_KIND = {"binary": 0, "ternary": 0}

# int32 elements per intermediate of the plain version, which runs over
# corpus rows in chunks of this size.
_PLAIN_CHUNK = 1 << 24


def _check(queries, planes, op: str):
    """Contiguous int32 ``(query planes (W,), corpus planes (N, W))``."""
    queries = tuple(q.contiguous() for q in queries)
    planes = tuple(p.contiguous() for p in planes)
    w = planes[0].shape[-1]
    for t in (*queries, *planes):
        if t.dtype != torch.int32 or t.device != planes[0].device:
            raise ContractError(
                f"innr_tpu_torch::{op}: words must be int32 on one device, got "
                f"{t.dtype} on {t.device}"
            )
    if any(p.dim() != 2 or p.shape != planes[0].shape for p in planes) or any(
        tuple(q.shape) != (w,) for q in queries
    ):
        raise ContractError(
            f"innr_tpu_torch::{op}: word-count mismatch (query "
            f"{[tuple(q.shape) for q in queries]}, corpus {[tuple(p.shape) for p in planes]})"
        )
    return queries, planes


def hamming_rows_plain(queries, planes) -> torch.Tensor:
    """The plain version of the kernel: per-row scores (N,) int32 of the
    (W,) query planes against the (N, W) corpus planes (one plane each for
    binary Hamming, two for ternary dots), chunked over rows."""
    queries, planes = _check(queries, planes, "hamming_rows_plain")
    n, w = planes[0].shape
    out = torch.empty(n, dtype=torch.int32, device=planes[0].device)
    step = max(1, _PLAIN_CHUNK // max(1, w))
    qs = [q[None, :] for q in queries]
    for s in range(0, n, step):
        out[s:s + step] = word_scores(qs, [p[s:s + step] for p in planes]).sum(
            dim=1, dtype=torch.int32)
    return out


def _rows_kernel(queries, planes) -> torch.Tensor:
    global LAUNCHES
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    n, w = planes[0].shape
    dev = planes[0].device
    binary = len(planes) == 1
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.int32, device=dev)
        rc = lib.innr_packed_rows(
            0 if binary else 1, queries[0].data_ptr(),
            None if binary else queries[1].data_ptr(), planes[0].data_ptr(),
            None if binary else planes[1].data_ptr(), out.data_ptr(), n, w,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"innr_tpu_torch: packed_rows launch failed, cudaError {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_KIND["binary" if binary else "ternary"] += 1
    return out


def packed_rows(queries, planes, op: str = "packed_rows") -> torch.Tensor:
    """Per-row scores (N,) int32: the kernel for CUDA tensors, the plain
    version for CPU tensors or under ``force_reference``."""
    queries, planes = _check(queries, planes, op)
    dev = planes[0].device
    if dev.type == "cpu" or config.reference_forced():
        return hamming_rows_plain(queries, planes)
    if dev.type != "cuda":
        raise ContractError(f"innr_tpu_torch::{op}: unsupported device {dev}")
    if planes[0].shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    return _rows_kernel(queries, planes)


def batch_hamming_words(query, corpus) -> torch.Tensor:
    """Bit-Hamming counts of one (W,) query against an (N, W) corpus ->
    (N,) int32."""
    return packed_rows((query,), (corpus,), "batch_hamming_words")


def batch_ternary_dot_words(qpos, qneg, pos_corpus, neg_corpus) -> torch.Tensor:
    """Ternary dots of one query's (W,) planes against (N, W) corpus planes
    -> (N,) int32."""
    return packed_rows((qpos, qneg), (pos_corpus, neg_corpus), "batch_ternary_dot_words")
