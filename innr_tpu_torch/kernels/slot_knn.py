"""Fused slot-sketch kNN: the CUDA kernel and its plain version.

Replaces the TPU kernels of ``innr_tpu/kernels/slot_knn.py``:
``_slot_kernel`` (``fused_slot_knn``, one sketch) and ``_slot_kernel_mq``
(``fused_slot_knn_batch``, a batch), the k smallest differing-slot counts
of MinHash / b-bit sketches. The kernel is ``csrc/slot_knn.cu``
(``slot_scan``, then ``knn_merge`` from ``csrc/knn.cu``); its source note
says what bounds it on the H100.

The corpus is slot-major, ``(S, N)``, the JAX package's cached transpose
(``SketchCorpus.slots_t``): slot s of neighbouring sketches is contiguous,
so a warp's loads are coalesced. Slots are the JAX package's ``uint16`` /
``uint32`` held as bit-identical ``int16`` / ``int32`` views
(:mod:`innr_tpu_torch.utils.bits`); equality, all the scan needs, is the
same on the views.

Selection runs on the int64 composites of K1 (:mod:`.knn`) with key
``-count``: the smallest counts, ties to the lowest row. Counts come back
as int32 (the JAX package returns uint32; the values are equal). Any k
runs through K1's exclusion-bounded multi-pass driver
(:func:`.knn._multi_pass`) in passes of at most :func:`.knn.single_pass_k`.

Dispatch: a CUDA tensor runs the kernel, or the call raises; a CPU tensor,
or :func:`innr_tpu_torch.config.force_reference`, runs the plain version.
"""

from __future__ import annotations

import torch

from innr_tpu_torch import config
from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.kernels import row_scan
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import composite_keys, split_composite

# Elements per (Q, S, rows) compare of the plain version, which runs over
# corpus rows in chunks of this size with a running top-k.
_PLAIN_CHUNK = 1 << 25
_BITS = {torch.int16: 16, torch.int32: 32}

# Kernel passes launched (each pass launches slot_scan, then knn_merge), in
# all and by slot type. Incremented only where the kernels launch.
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"uint16": 0, "uint32": 0}


def _check(queries, slots_t, k: int, op: str) -> None:
    if slots_t.dim() != 2 or slots_t.dtype not in _BITS:
        raise ContractError(
            f"innr_tpu_torch::{op}: slots_t must be a 2-D int16 or int32 (uint16 / uint32 "
            f"view) tensor, got {slots_t.dtype} of shape {tuple(slots_t.shape)}")
    if (queries.dim() != 2 or queries.dtype != slots_t.dtype
            or queries.shape[1] != slots_t.shape[0] or queries.device != slots_t.device):
        raise ContractError(
            f"innr_tpu_torch::{op}: queries must be {slots_t.dtype} (Q, {slots_t.shape[0]}) on "
            f"{slots_t.device}, got {queries.dtype} of shape {tuple(queries.shape)} on "
            f"{queries.device}")
    n = slots_t.shape[1]
    if n > _knn._MAX_ROWS:
        raise ContractError(f"innr_tpu_torch::{op}: {n} rows; row indices are int32")
    if not 1 <= k <= n:
        raise ContractError(f"innr_tpu_torch::{op}: k={k} outside [1, {n}]")


def _plain_top(queries, slots_t, k: int, bound=None) -> torch.Tensor:
    """(Q, k) int64 composites of ``-count``, best first."""
    n_q, s = queries.shape
    step = max(row_scan.ROW_TILE, _PLAIN_CHUNK // max(1, n_q * s))
    q = queries[:, :, None]

    def keys_of(a, b):
        return -(slots_t[None, :, a:b] != q).sum(dim=1, dtype=torch.int32)

    return _knn._chunked_top(keys_of, slots_t.shape[1], step, k, bound, slots_t.device)


def slot_knn_plain(queries, slots_t, k: int, excl=None):
    """The plain version of the kernel. ``queries``: (Q, S) int16 / int32
    slots; ``slots_t``: the matching (S, N) corpus. Returns raw ``(keys,
    idx)`` int32 (Q, k), best first, keys ``-count``.

    ``excl``: optional per-query ``(keys, idx)`` bound; only candidates
    strictly after it in (key desc, idx asc) order are kept."""
    _check(queries, slots_t, k, "slot_knn_plain")
    bound = None if excl is None else composite_keys(excl[0], excl[1])
    return split_composite(_plain_top(queries, slots_t, k, bound))


def _scan_pass(queries, slots_t, k: int, bound) -> torch.Tensor:
    """One kernel pass (slot_scan + knn_merge): (Q, k) int64 composites."""
    global LAUNCHES
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    bits = _BITS[slots_t.dtype]
    n_q, s = queries.shape
    n = slots_t.shape[1]
    tile = row_scan.row_scan_tile(n_q, k, 4 * s, "slot_scan")
    out = _knn._scan_and_merge(
        "slot_scan",
        lambda partial, slab_rows, stream: lib.innr_slot_scan(
            bits, queries.data_ptr(), slots_t.data_ptr(), _knn._ptr(bound), partial, n_q, n, s,
            k, tile, slab_rows, stream),
        n_q, n, k, tile, row_scan.ROW_TILE, slots_t.device)
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[f"uint{bits}"] += 1
    return out


def fused_slot_keys_batch(queries, slots_t, k: int):
    """Top-k raw int32 keys (``-count``, larger is better) and int32 row
    indices, both (Q, k), for any k in [1, N]. A non-contiguous ``slots_t``
    (the transpose of a raw (N, S) corpus) is copied once for the kernel."""
    _check(queries, slots_t, k, "fused_slot_keys_batch")
    dev = slots_t.device
    if dev.type == "cpu" or config.reference_forced():
        run_pass = _plain_top
    elif dev.type == "cuda":
        queries, slots_t = queries.contiguous(), slots_t.contiguous()
        run_pass = _scan_pass
    else:
        raise ContractError(f"innr_tpu_torch::slot_knn: unsupported device {dev}")
    comp = _knn._multi_pass(
        lambda pass_k, bound: run_pass(queries, slots_t, pass_k, bound),
        k, _knn.single_pass_k(queries.shape[0]),
    )
    return split_composite(comp)


def fused_slot_knn_batch(q_slots, slots_t, k: int):
    """Top-k smallest differing-slot counts for a (Q, S) sketch batch
    against a slot-major (S, N) corpus: ``(counts (Q, k) int32 ascending,
    indices (Q, k) int32)``."""
    keys, idx = fused_slot_keys_batch(q_slots, slots_t, k)
    return -keys, idx


def fused_slot_knn(q_slots, slots_t, k: int):
    """One (S,) sketch: ``(counts (k,) ascending, indices (k,))``."""
    counts, idx = fused_slot_knn_batch(q_slots[None, :], slots_t, k)
    return counts[0], idx[0]
