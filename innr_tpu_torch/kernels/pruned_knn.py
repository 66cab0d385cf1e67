"""Tile-skipping kNN and threshold scans: the CUDA kernels and their plain
versions.

Replaces the TPU kernels of ``innr_tpu/kernels/pruned_knn.py``:

- K14, ``_pruned_kernel`` (static grid, ``_pruned_raw``) and
  ``_pruned_outer_kernel`` (dynamic pipeline, ``_pruned_raw_dynamic``):
  one kernel here, K1's scan over a survivor tile list (``csrc/knn.cu``,
  ``innr_knn_scan_tiles``: the tensor-core scan with its exact re-score,
  for f32, bf16 and u8 corpora; then K1's ``knn_merge``);
- K15, ``_threshold_kernel_1q`` and ``_threshold_outer_kernel``:
  ``csrc/pruned.cu``, in two forms. ``threshold_dense`` (through
  :func:`threshold_dists`) keeps the TPU kernel's contract, a distance or
  +inf for every row; ``threshold_compact`` (through
  :func:`threshold_survivors`, what ``batch_l2_squared_pruning`` calls)
  writes only the (row, distance) pairs within the threshold, in row
  order. Its plan (:func:`threshold_plan`) runs the bounds, partition and
  padding of :func:`~innr_tpu_torch.prune.plan_threshold_survivors` in one
  launch of ``threshold_plan``, bit for bit that function.

A plan (:mod:`innr_tpu_torch.prune`) is ``(order, n_surv)`` on the device:
the survivor tile ids ascending, then a padded tail. The kernels read
``n_surv`` on the device, so a search never waits for the host between the
plan and the scan. Their source notes say what bounds them on the H100.

No router. The JAX package's ``routed_raw`` picks between its pruned
pipeline and its full scan with a device-side ``lax.cond``, because the
dynamic pipeline cost it 7-14% on the TPU when nothing prunes. Here the tile
scan over every tile measured faster than K1's slab grid on the H100
(``PERF.md`` §5), and swapping a plan for "every tile" would only add
tiles, so the plan always stands: :func:`plan`, then :func:`pruned_keys`.
``config.prune_route_min_elide`` is kept for API parity and has no effect
here.

k above K1's per-pass cap runs K1's exclusion-bounded multi-pass full scan,
as the JAX package does.

A row-id map (``row_ids``, as in :func:`.knn.fused_knn_keys_batch`) reaches
both scans: the tile scan and, above the cap, K1's full scan put each row's
id in its composite, so a permuted layout (:class:`~innr_tpu_torch.ivf.
IVFIndex`) breaks ties by the lowest original index and returns ids.

Dispatch: a CUDA tensor runs the kernels, or the call raises; a CPU tensor,
or :func:`innr_tpu_torch.config.force_reference`, runs the plain versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from innr_tpu_torch import config
from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.prune import plan_survivors, plan_threshold_survivors
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import split_composite
from innr_tpu_torch.utils.padding import round_up

# Launches of the tile scan (knn_scan over a tile list, then knn_merge) and
# of the threshold scan, in all and by corpus dtype. Incremented only where
# the kernels launch.
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"float32": 0, "bfloat16": 0, "uint8": 0}
THRESHOLD_LAUNCHES = 0
# The threshold scan's launches by form, "dense" (threshold_dists) and
# "compact" (threshold_survivors), and by corpus dtype.
THRESHOLD_LAUNCHES_BY_FORM = {form: {"float32": 0, "bfloat16": 0}
                              for form in ("dense", "compact")}
# Launches of the threshold plan's kernel (threshold_plan).
PLAN_LAUNCHES = 0

# Rows of the corpus the plain threshold version scores at a time.
_PLAIN_CHUNK = 1 << 24
# The tile scan cuts live tiles into chunks of these many rows and deals
# the chunks to one wave of K1's resident CTAs (csrc/knn.cu; two, four
# waves, and chunks of 512 or 2048 rows measured slower on the H100:
# PERF.md).
_SCAN_CHUNK_ROWS = 1024
# Corpus dtypes of the threshold scans, as the library numbers them.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory a CTA of the dense threshold scan may hold (sm_90).
_SMEM_BYTES = 232_448


def pruned_tile_n(n: int, d: int, dtype=torch.float32) -> int:
    """Default tile height of a :class:`~innr_tpu_torch.prune.TileSummary`:
    the JAX package's value (sized there for the TPU's scoped memory), so
    that both packages build the same default summary. The CUDA tile scan
    takes any height."""
    bytes_el = 2 if dtype == torch.bfloat16 else 4
    budget = 4 * 1024 * 1024
    per_row = d * bytes_el + 12 * 32
    tile = budget // max(per_row, 1)
    tile = max(512, min(8192, tile))
    return round_up(min(tile, max(n, 128)), 128)


def _row_alive(order, n_surv, tile_n: int, n: int) -> torch.Tensor:
    """(N,) bool: the rows of the tiles ``order[:n_surv]``."""
    n_tiles = order.shape[0]
    live = (torch.arange(n_tiles, device=order.device) < n_surv).to(torch.int32)
    hits = torch.zeros(n_tiles, dtype=torch.int32, device=order.device)
    hits.index_add_(0, order.long(), live)
    return (hits > 0).repeat_interleave(tile_n)[:n]


def _check_plan(order, n_surv, tile_n: int, rows, op: str):
    """``order`` as contiguous int32 and ``n_surv`` as a one-element (or
    0-dim) int32 tensor, both on the corpus's device."""
    if order.dim() != 1 or order.device != rows.device:
        raise ContractError(
            f"innr_tpu_torch::{op}: order must be a 1-D tensor on {rows.device}, got "
            f"{tuple(order.shape)} on {order.device}"
        )
    if int(tile_n) <= 0 or order.shape[0] * int(tile_n) < rows.shape[0]:
        raise ContractError(
            f"innr_tpu_torch::{op}: {order.shape[0]} tiles of {tile_n} rows do not "
            f"cover {rows.shape[0]} rows"
        )
    # Conversions only where needed: each no-op call costs host time on
    # every search.
    if not (isinstance(n_surv, torch.Tensor) and n_surv.dtype is torch.int32
            and n_surv.device == rows.device and (n_surv.dim() == 0 or n_surv.shape == (1,))):
        n_surv = torch.as_tensor(n_surv, device=rows.device).to(torch.int32).reshape(1)
    if order.dtype is not torch.int32 or not order.is_contiguous():
        order = order.to(torch.int32).contiguous()
    return order, n_surv


def _plain_tiles(qs, rows, vals, mask, order, n_surv, tile_n, k, mode, row_ids=None):
    comp = _knn._plain_composites(qs, rows, vals, mask, mode, row_ids)
    alive = _row_alive(order, n_surv, tile_n, rows.shape[0])
    comp = torch.where(alive[None, :], comp, _knn._EMPTY)
    return split_composite(torch.topk(comp, k, dim=1).values)


def pruned_knn_plain(qs, rows, aux, order, n_surv, tile_n: int, k: int, mode: str,
                     row_ids=None):
    """The plain version of the tile scan: ``knn_plain`` over the rows of
    the tiles ``order[:n_surv]`` only. Raw ``(keys, idx)`` int32 (Q, k),
    best first (``idx``: ``row_ids`` of the rows when a map is given); slots
    past the last live row hold ``(INT32_MIN, -1)``."""
    vals, mask = _knn._split_aux(aux, mode, rows.shape[0])
    _knn._check(qs, rows, vals, mask, k, "pruned_knn_plain")
    row_ids = _knn._check_ids(row_ids, rows, "pruned_knn_plain")
    order, n_surv = _check_plan(order, n_surv, tile_n, rows, "pruned_knn_plain")
    return _plain_tiles(qs, rows, vals, mask, order, n_surv, tile_n, k, mode, row_ids)


def _scan_tiles(qs, rows, vals, mask, order, n_surv, tile_n, k, mode, bound, row_ids=None):
    """One tile-scan pass (knn_scan over the tiles, knn_merge of the live
    slabs): (Q, k) int64 composites."""
    global LAUNCHES
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    n_q, d = qs.shape
    n, n_tiles = rows.shape[0], order.shape[0]
    dev = rows.device
    # One wave of resident CTAs (as many per SM as the library's plan for
    # this shape holds), or fewer when there are fewer chunks: one partial
    # list each, whatever the plan keeps.
    chunks = n_tiles * -(-int(tile_n) // _SCAN_CHUNK_ROWS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q_tile, resident = _knn._grid(rows, n_q, k, "tile")
    wave = max(1, sms * resident // -(-n_q // q_tile))
    n_ctas = min(wave, chunks)
    with torch.cuda.device(dev):
        qmeta, m_abs, m_aux, counter = _knn._gate_terms(qs, rows, mode)
        kth = _knn.shared_keys(n_q, n_ctas, dev)
        partial = torch.empty((n_ctas, n_q, k), dtype=torch.int64, device=dev)
        out = torch.empty((n_q, k), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.innr_knn_scan_tiles(
            qs.data_ptr(), rows.data_ptr(), _knn._DTYPES[rows.dtype], _knn._ptr(vals),
            _knn._ptr(mask), _knn._ptr(bound), _knn._ptr(row_ids), _knn._ptr(qmeta), m_abs, m_aux,
            _knn._ptr(counter), kth.data_ptr(), order.data_ptr(), n_surv.data_ptr(),
            partial.data_ptr(), n_q,
            n, d, k, _knn._MODES[mode][0], int(tile_n), _SCAN_CHUNK_ROWS, n_ctas, stream,
        )
        if rc != 0:
            raise RuntimeError(f"innr_tpu_torch: knn_scan_tiles launch failed, cudaError {rc}")
        rc = lib.innr_knn_merge(partial.data_ptr(), out.data_ptr(), n_q, n_ctas, k, stream)
        if rc != 0:
            raise RuntimeError(f"innr_tpu_torch: knn_merge launch failed, cudaError {rc}")
    _knn._note_rescored(rows, n_q, counter)
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[str(rows.dtype).removeprefix("torch.")] += 1
    return out


def pruned_keys(qs, rows, aux, order, n_surv, tile_n: int, k: int, mode: str, row_ids=None):
    """Top-k over the tiles ``order[:n_surv]`` as raw int32 ``(keys, idx)``
    (Q, k), K1's key contract (``idx``: ``row_ids`` of the rows when a map
    is given): the tile kernel for CUDA tensors (k above
    ``knn.single_pass_k`` in K1's exclusion-bounded passes), the plain
    version for CPU tensors."""
    qs, rows = qs.contiguous(), rows.contiguous()
    vals, mask = _knn._split_aux(aux, mode, rows.shape[0])
    _knn._check(qs, rows, vals, mask, k, "pruned_keys")
    row_ids = _knn._check_ids(row_ids, rows, "pruned_keys")
    order, n_surv = _check_plan(order, n_surv, tile_n, rows, "pruned_keys")
    if rows.device.type == "cpu" or config.reference_forced():
        return _plain_tiles(qs, rows, vals, mask, order, n_surv, tile_n, k, mode, row_ids)
    if rows.device.type != "cuda":
        raise ContractError(f"innr_tpu_torch::pruned_keys: unsupported device {rows.device}")
    return split_composite(_knn._multi_pass(
        lambda pass_k, bound: _scan_tiles(qs, rows, vals, mask, order, n_surv, tile_n,
                                          pass_k, mode, bound, row_ids),
        k, _knn.single_pass_k(qs.shape[0])))


def _fast_plan_ok(k: int, summary) -> bool:
    """The masked-max plan needs a tile of >= k rows: every tile but the
    last holds ``tile_n``."""
    return k <= summary.tile_n or summary.n_tiles == 1


_PLAN_MODES = {"cosine": "dot", "cosinem": "dot", "dotm": "dot", "l2m": "l2"}


def plan(qs, rows, summary, k: int, mode: str):
    """The survivor plan the pruned scan of ``mode`` reads: ``(order,
    n_surv)`` on the device. ``qs`` are the queries as the scan gets them
    (unit queries for cosine, against a ``normalized=True`` summary)."""
    # Cosine plans as dot against the unit-row summary with unit queries;
    # masked modes as their base mode (the summary counts valid rows only).
    plan_mode = _PLAN_MODES.get(mode, mode)
    # A bf16 corpus is scored against the bf16-rounded query (knn.cu), a
    # perturbation the f32 slack cannot absorb: plan against the same
    # rounded query, which is exact in f32.
    qs_plan = qs.to(torch.bfloat16).float() if rows.dtype == torch.bfloat16 else qs
    return plan_survivors(qs_plan, summary.centroids, summary.radii, summary.counts, k,
                          plan_mode, fast=_fast_plan_ok(k, summary))


def _pruned_run(qs, rows, aux, summary, k: int, mode: str, row_ids=None):
    """Plan and scan: ``(scores (Q, k), idx (Q, k))``, equal to K1's full
    scan of the same mode (``idx``: ids when ``row_ids`` is given)."""
    if summary.tile_n * summary.n_tiles < rows.shape[0]:
        raise ValueError("TileSummary does not cover the corpus")
    if k > _knn.single_pass_k(qs.shape[0]):
        keys, idx = _knn.fused_knn_keys_batch(qs, rows, aux, k, mode, row_ids)
    else:
        order, n_surv = plan(qs, rows, summary, k, mode)
        keys, idx = pruned_keys(qs, rows, aux, order, n_surv, summary.tile_n, k, mode, row_ids)
    return _knn.decode_keys(keys, mode, qs), idx


def fused_knn_dot_pruned_batch(qs, rows, summary, k: int):
    """Exact top-k MIPS of a (Q, D) batch reading only the survivor tiles:
    ``(scores (Q, k), idx (Q, k))``, equal to ``knn.fused_knn_dot_batch``.
    ``summary``: a :class:`~innr_tpu_torch.prune.TileSummary` of ``rows``."""
    return _pruned_run(qs.contiguous(), rows, None, summary, k, "dot")


def fused_knn_l2_pruned_batch(qs, rows, summary, k: int, norms2=None):
    """Exact top-k smallest L2^2 with tile skipping (see
    :func:`fused_knn_dot_pruned_batch`)."""
    if norms2 is None:
        norms2 = _knn._norms2(rows)
    return _pruned_run(qs.contiguous(), rows, norms2, summary, k, "l2")


def fused_knn_cosine_pruned_batch(qs, rows, summary_norm, k: int, inv=None):
    """Exact top-k cosine with tile skipping. ``summary_norm``: a summary
    built with ``normalized=True``; the plan is the dot plan of the unit
    queries, the scan streams inverse row norms like the full cosine scan
    (a NaN row scores NaN and sorts first, as in K1 and the JAX kernels)."""
    if inv is None:
        inv = _knn.inv_norms(rows)
    return _pruned_run(_knn._unit_queries(qs.contiguous()), rows, inv, summary_norm, k, "cosine")


# ---------------------------------------------------------------------------
# threshold scan
# ---------------------------------------------------------------------------

def threshold_plain(q, rows, norms2, order, n_surv, tile_n: int) -> torch.Tensor:
    """The plain version of the threshold scan: (N,) float32 ``norms2 -
    2 q.r`` on the rows of the tiles ``order[:n_surv]``, +inf elsewhere.
    The query stays float32 against a bf16 corpus (widened), as in the JAX
    kernel."""
    order, n_surv = _check_plan(order, n_surv, tile_n, rows, "threshold_plain")
    n, d = rows.shape
    alive = _row_alive(order, n_surv, tile_n, n)
    out = torch.full((n,), torch.inf, dtype=torch.float32, device=rows.device)
    step = max(1, _PLAIN_CHUNK // max(1, d))
    for s in range(0, n, step):
        dists = norms2[s:s + step] - 2.0 * (rows[s:s + step].float() @ q)
        out[s:s + step] = torch.where(alive[s:s + step], dists, torch.inf)
    return out


def _count(form: str, rows) -> None:
    global THRESHOLD_LAUNCHES
    dtype = str(rows.dtype).removeprefix("torch.")
    THRESHOLD_LAUNCHES += 1
    THRESHOLD_LAUNCHES_BY_FORM[form][dtype] += 1


def _threshold_kernel(q, rows, norms2, order, n_surv, tile_n) -> torch.Tensor:
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    n, d = rows.shape
    dev = rows.device
    with torch.cuda.device(dev):
        out = torch.empty((n,), dtype=torch.float32, device=dev)
        rc = lib.innr_threshold_scan(
            q.data_ptr(), rows.data_ptr(), _DTYPES[rows.dtype], norms2.data_ptr(),
            order.data_ptr(), n_surv.data_ptr(), out.data_ptr(), n, d, int(tile_n),
            order.shape[0], 0, torch.cuda.current_stream(dev).cuda_stream,  # 0: one wave
        )
    if rc != 0:
        raise RuntimeError(f"innr_tpu_torch: threshold_scan launch failed, cudaError {rc}")
    _count("dense", rows)
    return out


def _threshold_args(q, rows, norms2, op: str):
    """``(q, rows, norms2)`` as the kernels take them: float32 contiguous
    query and norms, a contiguous float32 or bf16 corpus, one device."""
    if rows.dim() != 2 or rows.dtype not in _DTYPES:
        raise ContractError(
            f"innr_tpu_torch::{op}: rows must be 2-D float32 or bfloat16, "
            f"got {rows.dtype} of shape {tuple(rows.shape)}"
        )
    n, d = rows.shape
    if q.dtype is not torch.float32 or not q.is_contiguous():
        q = q.to(torch.float32).contiguous()
    if norms2.dtype is not torch.float32 or not norms2.is_contiguous():
        norms2 = norms2.to(torch.float32).contiguous()
    if q.shape != (d,) or norms2.shape != (n,):
        raise ContractError(
            f"innr_tpu_torch::{op}: query {tuple(q.shape)} / norms2 "
            f"{tuple(norms2.shape)} do not fit rows {tuple(rows.shape)}"
        )
    for name, t in (("query", q), ("norms2", norms2)):
        if t.device != rows.device:
            raise ContractError(f"innr_tpu_torch::{op}: {name} on {t.device}, rows on {rows.device}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ContractError(f"innr_tpu_torch::{op}: unsupported device {rows.device}")
    return q, rows if rows.is_contiguous() else rows.contiguous(), norms2


def _check_bitmap(d: int, n_tiles: int, op: str) -> None:
    """The dense kernel keeps the query and a bit per tile in shared
    memory."""
    need = 4 * d + 4 * -(-n_tiles // 32)
    if need > _SMEM_BYTES:
        raise ContractError(
            f"innr_tpu_torch::{op}: a {d}-wide query and {n_tiles} tiles need {need} bytes "
            f"of shared memory, above {_SMEM_BYTES}: use taller tiles"
        )


def threshold_dists(q, rows, norms2, order, n_surv, tile_n: int) -> torch.Tensor:
    """(N,) float32 ``norms2 - 2 q.r`` on the rows of the tiles
    ``order[:n_surv]``, +inf elsewhere: the kernel for CUDA tensors (one
    launch that writes every row), the plain version for CPU tensors."""
    q, rows, norms2 = _threshold_args(q, rows, norms2, "threshold_dists")
    if rows.device.type == "cpu" or config.reference_forced():
        return threshold_plain(q, rows, norms2, order, n_surv, tile_n)
    order, n_surv = _check_plan(order, n_surv, tile_n, rows, "threshold_dists")
    if rows.shape[0] == 0:
        return torch.empty(0, dtype=torch.float32, device=rows.device)
    _check_bitmap(rows.shape[1], order.shape[0], "threshold_dists")
    return _threshold_kernel(q, rows, norms2, order, n_surv, tile_n)


def threshold_survivors_plain(q, rows, norms2, qq, order, n_surv, tile_n: int,
                              threshold: float):
    """The plain version of the compacted scan: the dense plain version plus
    ``qq``, then the keep-mask and its ``nonzero``, over the rows of the
    tiles ``order[:n_surv]``. ``(idx (M,) int64, dists (M,) float32)`` on
    the rows' device, indices ascending.

    A dead tile's row reads +inf, which the keep-mask drops at any
    threshold but +inf and NaN; a plan from
    :func:`~innr_tpu_torch.prune.plan_threshold_survivors` has no dead tile
    at those two, so for its plans this is the dense form's mask as it
    stands. On other plans the rows of dead tiles are never kept, as the
    kernel never reads them."""
    dists = threshold_plain(q, rows, norms2, order, n_surv, tile_n) + qq
    order, n_surv = _check_plan(order, n_surv, tile_n, rows, "threshold_survivors_plain")
    keep = (~(dists > float(np.float32(threshold))) & ~torch.isnan(dists)
            & _row_alive(order, n_surv, tile_n, rows.shape[0]))
    idx = torch.nonzero(keep).flatten()
    return idx, dists[idx]


@functools.lru_cache(maxsize=64)
def _header_words(lib, tile_n: int, n_tiles: int) -> int:
    return lib.innr_threshold_header_words(tile_n, n_tiles)


def _compact_kernel(q, rows, norms2, qq, order, n_surv, tile_n, threshold):
    import ctypes

    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    n, d = rows.shape
    dev = rows.device
    n_tiles = order.shape[0]
    # One buffer: the kernel's header (ticket, M, flags, a status a chunk),
    # then room for every row and its distance. The host side is two calls
    # into the library: each torch operation costs host time per search.
    head = _header_words(lib, int(tile_n), n_tiles)
    with torch.cuda.device(dev):
        buf = torch.empty(head + n + (n + 1) // 2, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.innr_threshold_compact(
            q.data_ptr(), rows.data_ptr(), _DTYPES[rows.dtype], norms2.data_ptr(),
            order.data_ptr(), n_surv.data_ptr(), qq.data_ptr(), float(np.float32(threshold)),
            buf.data_ptr(), n, d, int(tile_n), n_tiles, 0, stream,  # 0: one wave of CTAs
        )
        if rc != 0:
            raise RuntimeError(f"innr_tpu_torch: threshold_compact launch failed, cudaError {rc}")
        _count("compact", rows)
        m_flags = (ctypes.c_longlong * 2)()
        rc = lib.innr_threshold_count(buf.data_ptr(), m_flags, stream)  # the one synchronisation
        if rc != 0:
            raise RuntimeError(f"innr_tpu_torch: threshold_compact failed, cudaError {rc}")
        m, flags = m_flags
        if flags & 2:
            raise RuntimeError("innr_tpu_torch: threshold_compact's look-back gave up waiting")
        if flags & 1:
            raise ContractError(
                "innr_tpu_torch::threshold_survivors: order[:n_surv] must list the live "
                "tiles ascending, as the survivor plans do")
        # Pinned host memory: the copy runs at the link's rate, where
        # pageable memory goes through a staging buffer.
        idx = torch.empty(m, dtype=torch.int64, pin_memory=True)
        dists = torch.empty(m, dtype=torch.float32, pin_memory=True)
        rc = lib.innr_threshold_copy(buf.data_ptr(), head, n, m, idx.data_ptr(),
                                     dists.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"innr_tpu_torch: threshold_compact copy failed, cudaError {rc}")
    return idx, dists


def threshold_survivors(q, rows, norms2, qq, order, n_surv, tile_n: int, threshold: float):
    """The rows of the tiles ``order[:n_surv]`` whose ``norms2 - 2 q.r +
    qq`` is not above ``threshold`` (rounded to float32) and not NaN:
    ``(idx (M,) int64, dists (M,) float32)``, indices ascending. ``qq``: a
    float32 scalar tensor on the rows' device (``||q||^2``). The compacting
    kernel for CUDA tensors (one launch, one synchronisation to read M,
    the M pairs copied to the host; ``order[:n_surv]`` ascending, as the
    plans give it), the plain version for CPU tensors (on the rows'
    device)."""
    q, rows, norms2 = _threshold_args(q, rows, norms2, "threshold_survivors")
    if qq.dtype is not torch.float32:
        qq = qq.to(torch.float32)
    if qq.numel() != 1 or qq.device != rows.device:
        raise ContractError(
            f"innr_tpu_torch::threshold_survivors: qq must be one value on {rows.device}, "
            f"got {tuple(qq.shape)} on {qq.device}")
    if rows.device.type == "cpu" or config.reference_forced():
        return threshold_survivors_plain(q, rows, norms2, qq, order, n_surv, tile_n, threshold)
    order, n_surv = _check_plan(order, n_surv, tile_n, rows, "threshold_survivors")
    if rows.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.float32)
    return _compact_kernel(q, rows, norms2, qq, order, n_surv, tile_n, threshold)


def threshold_plan(qs, cent, rad, threshold: float):
    """``(order, n_surv, alive)`` of
    :func:`~innr_tpu_torch.prune.plan_threshold_survivors`, bit for bit: on
    the card its product and sums as torch calls and the rest (the bounds,
    the partition, the padded tail) in one launch, ``csrc/pruned.cu``
    ``threshold_plan``; on the CPU that function itself."""
    global PLAN_LAUNCHES
    if cent.device.type == "cpu" or config.reference_forced():
        return plan_threshold_survivors(qs, cent, rad, threshold)
    from innr_tpu_torch.kernels import _build

    if qs.dtype is not torch.float32 or cent.dtype is not torch.float32:
        raise ContractError(f"innr_tpu_torch::threshold_plan: float32 queries and centroids, "
                            f"got {qs.dtype} and {cent.dtype}")
    lib = _build.load()
    dev = cent.device
    qd = qs @ cent.T
    qq = (qs * qs).sum(dim=1)
    cc = (cent * cent).sum(dim=1)
    if rad.dtype is not torch.float32 or not rad.is_contiguous():
        rad = rad.to(torch.float32).contiguous()
    n_q, n_tiles = qd.shape
    order = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    n_surv = torch.empty((), dtype=torch.int32, device=dev)
    alive = torch.empty(n_tiles, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.innr_threshold_plan(
            qd.data_ptr(), qq.data_ptr(), cc.data_ptr(), rad.data_ptr(), n_q, n_tiles,
            float(np.float32(threshold)), float(np.float32(config.PRUNE_BOUND_EPS)),
            order.data_ptr(), n_surv.data_ptr(), alive.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"innr_tpu_torch: threshold_plan launch failed, cudaError {rc}")
    PLAN_LAUNCHES += 1
    return order, n_surv, alive


def l2_squared_pruning_survivors(q, rows, norms2, summary, threshold: float):
    """``(idx (M,) int64, dists (M,) float32)`` of the rows whose squared L2
    distance ``norms2 - 2 q.r + ||q||^2`` is not above ``threshold`` and not
    NaN, indices ascending; tiles whose centroid / radius lower bound
    exceeds the threshold are never read (every row of theirs is provably
    above it), and no distance is written for the others' rows that fail.
    The JAX package's ``l2_squared_pruning_scan`` returns the dense (N,)
    form, which its caller masks; here :func:`threshold_dists` keeps that
    contract."""
    order, n_surv, _ = threshold_plan(q[None, :], summary.centroids, summary.radii, threshold)
    return threshold_survivors(q, rows, norms2, (q * q).sum(), order, n_surv, summary.tile_n,
                               threshold)
