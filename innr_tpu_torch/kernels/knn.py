"""Fused streaming score + top-k kNN: the CUDA kernel and its plain version.

Replaces the TPU kernel ``innr_tpu/kernels/knn.py:_knn_kernel`` (launched by
``_fused_knn_raw``; ``_fused_knn_multi`` drives it for large k). The kernel
is ``csrc/knn.cu`` (``knn_scan_tc`` for f32, bf16 and u8 corpora:
tensor-core scores, 3xTF32 for f32, bf16 for bf16 and for u8 codes against
the query's hi/lo bf16 split; a gate within :func:`knn_margin`; an exact
FP32 FMA re-score of the admitted pairs; then ``knn_merge``); its source
note says what it computes, what bounds it on the H100 and what the design
leaves on the table.

Selection runs on int64 composites of (int32 total-order key, row index)
(:mod:`innr_tpu_torch.utils.order`): larger is better, ties go to the lower
row, and the exclusion bound of a resumed pass is one compare. A row-id map
(``row_ids``: (N,) int32, distinct) puts each row's id in the composite in
place of its position, so ties go to the lowest id and the returned indices
are ids: a permuted layout (:class:`~innr_tpu_torch.ivf.IVFIndex`) selects
as a scan of the original order would. The raw form
(:func:`fused_knn_keys_batch`) returns keys that are larger-is-better for
every mode (L2 keys come bit-inverted), ready for a merge across scans
(:func:`innr_tpu_torch.utils.order.merge_parts`); :func:`decode_keys`
turns them into scores, once, after the merge.

Dispatch: a CUDA tensor runs the kernel, or the call raises; a CPU tensor
runs the plain version. :func:`innr_tpu_torch.config.force_reference` sends
every tensor to the plain version. There is no size gate and no fallback.
Both run through the same exclusion-bounded multi-pass driver for k above
:func:`single_pass_k`. On the card a pass takes one of two schedules of the
same scan (:func:`scan_path`, from Q, D, k and the corpus dtype): ``"tile"``,
a grid of slabs x query tiles, one warpgroup a CTA; or ``"wide"``, for f32
corpora at many queries, persistent CTAs whose producer warpgroup fills a
shared-memory ring of row tiles for two consumer warpgroups. While a
profiler records (:mod:`innr_tpu_torch.utils.trace`), each pass of
:func:`fused_knn_keys_batch` is a ``dispatch.k1_pass`` span (``rows``,
``n_q``; on the card ``path``, the pass's schedule, and ``rescored``, its
device counter of re-scored pairs, kept by reference: read it after the
window).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from innr_tpu_torch import config
from innr_tpu_torch.utils import trace as _trace
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import (
    canonical_nan,
    composite_keys,
    invert_total_key,
    split_composite,
    total_order_key_f32,
)
from innr_tpu_torch.utils.padding import round_up

# Per-pass cap on k: the scan keeps a (query tile, k) int64 buffer per CTA
# in shared memory (64 KB for 32 queries at 256; csrc/knn.cu narrows the
# query tile where the buffers would not fit). Larger k runs as
# exclusion-bounded passes.
_K_MAX_PASS = 256
# Slabs are whole multiples of 128 rows (csrc/knn.cu takes any multiple of
# its 64-row tile).
_ROW_TILE = 128
# The scan grid is whole waves of CTAs, and a partial last wave nearly
# doubles the time when each CTA's work is large. K1 asks the library for
# its query tile and the CTAs resident per SM at the launch's shape
# (:func:`_grid`); the other scans sharing :func:`_scan_and_merge` keep 2
# resident CTAs. Small k takes 4 waves; every slab fills a k-long sorted
# buffer per query from empty, which dominates on short slabs at large k,
# so a slab keeps at least _SLAB_ROWS_PER_K * k rows, down to a single
# wave. K1 takes one wave: each slab's buffers admit about k (1 + ln(rows /
# k)) rows per query to the exact re-score, so fewer, longer slabs re-score
# fewer pairs.
_RESIDENT_CTAS = 2
_MAX_WAVES = 4
_SLAB_ROWS_PER_K = 256
# The wide schedule (csrc/knn.cu, its source note has the crossover's
# measurements) from this many queries on, wherever the library has a
# layout for it (innr_knn_grid: f32, D <= 96, D % 4 == 0, two 64-query
# warpgroups fitting at this k). Its grid is every resident CTA of the
# card; each CTA walks items of (query tile pair, slab), at least
# _WIDE_ITEMS_PER_CTA of them and the same count for every CTA, so no SM
# carries a partial extra wave.
_WIDE_MIN_QUERIES = 256
_WIDE_ITEMS_PER_CTA = 8

# mode -> (score: 0 dot, 1 l2, 2 cosine; has a row predicate)
_MODES = {
    "dot": (0, False), "l2": (1, False), "cosine": (2, False),
    "dotm": (0, True), "l2m": (1, True), "cosinem": (2, True),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_EMPTY = torch.iinfo(torch.int64).min
_INT32_MIN = torch.iinfo(torch.int32).min
_MAX_ROWS = 2**31 - 1

# The module-level state below (launch counts, the last launch's
# statistics) is diagnostics only, read by tests and chip_smoke.py: every
# call allocates its own scratch tensors, so concurrent calls (a
# MicroBatcher's flush workers) share none; a count bumped by two threads at
# once may lose one.
# Kernel passes launched (each pass launches knn_scan, then knn_merge), in
# all and by corpus dtype. Incremented only where the kernels launch.
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"float32": 0, "bfloat16": 0, "uint8": 0}
# ... and by schedule (scan_path).
LAUNCHES_BY_PATH = {"wide": 0, "tile": 0}
# This thread's last tensor-core launch: ``stats``, its (rows, queries,
# device counter of the (row, query) pairs it re-scored exactly), read by
# rescore_stats(), and ``path``, its schedule; the counter and the path go
# on its dispatch.k1_pass span. Per thread, so that another flush worker's
# launch never replaces them.
_THIS_THREAD = threading.local()
# Queries whose norm is not below this (or not finite) get every pair
# re-scored, and so do rows (csrc/knn.cu): the bound assumes no overflow.
_REGULAR_NORM = 2.0**50
# Added to a computed norm: the most that squares which underflow can take
# from it (sqrt(D) 2^-75 for any D below 2^31).
_NORM_SLACK = 2.0**-59
_U = 2.0**-24  # unit roundoff of float32
_GRIDS: dict = {}


class KnnMargin(NamedTuple):
    """One mode's gate margin: the tensor-core score s~ of a (row x, query
    q) pair lies within

        T = kappa ||x|| ||q|| f + abs f + aux |a|

    of the exact score s, the FMA chain's (f = |a| for cosine, else 1; a
    the row's aux), for rows and queries with norms below 2^50."""

    kappa: float
    abs: float
    aux: float


def knn_margin(d: int, dtype) -> tuple[KnnMargin, KnnMargin, KnnMargin]:
    """The margins the scan's gate uses for dimension D and a corpus of
    ``dtype`` (float32: 3xTF32 products; bfloat16: bf16 products of the
    bf16-rounded query; uint8: bf16 products of the codes and the query's
    hi/lo bf16 split), indexed by score (0 dot, 1 l2, 2 cosine). With
    P = sum |x_i q_i| <= ||x|| ||q|| and u = 2^-24:

    - Operands. float32: the tensor core sums x_hi q_hi + x_hi q_lo +
      x_lo q_hi, where x_hi, q_hi are the TF32 truncations (10 mantissa
      bits) and x_lo = x - x_hi, q_lo = q - q_hi (below 2^-10 |x|, 2^-10
      |q|) are truncated again; the dropped x_lo q_lo and the two
      truncations leave at most 3 2^-20 |x_i q_i| per product, and every
      product of two TF32 values is exact in f32. bfloat16: the products are
      exact. uint8: codes 0..255 are exact in bf16 (8 significant bits);
      q_hi = bf16(q) is within 2^-8 |q| of q (bf16's unit roundoff), q - q_hi
      is exact in f32, and q_lo = bf16(q - q_hi) is within 2^-8 of that, so
      x q_hi + x q_lo, two products exact in f32 (8 by 8 bits), is within
      2^-16 |x_i q_i| of x_i q_i; |q_hi| + |q_lo| <= (1 + 2^-8)^2 |q|. The f32
      accumulation in the tensor core, in an order and with a rounding
      (truncation, possibly) the hardware does not state, adds at most
      2 (K + 16) 2^-23 (1 + 2^-8) P' over its K products (3 D, with P' <=
      (1 + 2^-9) P, for float32; D and P for bf16; 2 D and P' <= (1 + 2^-6)
      P for uint8), the term of ``assign.shortlist_margin`` with the depth
      of a bf16 step (16). Together eta P.
    - The FMA chain: gamma_D P with gamma_D = D u / (1 - D u). So the two
      dots differ by at most eps P + abs, eps = eta + gamma_D.
    - Subnormals: a flushed operand or low part, or an underflowing
      product, costs at most 2^-126 (||x|| + ||q|| + 1) per term (uint8: a
      flushed q_hi or q_lo, or an underflowing x q_lo, costs at most
      255 2^-126 <= 2^-126 ||x||, two terms per dimension); with norms below
      2^50, abs = D 2^-74 covers 2 D of them.
    - The mode's transform and the compare: dot s = dot, plus 2 u (1 + eps)
      P for the roundings of s~ +- T; l2 s = fl(a - 2 dot): 2 (eps P + abs)
      + 2 u |a| + 4 u (1 + eps) P, plus the compare; cosine s = fl(dot a):
      |a| (eps P + abs + 2 u (1 + eps) P), plus the compare.
    - A safety factor of 2, which also covers the f32 roundings of the
      norms, of kappa ||q|| and of T itself (each a few u relative).

    dot: kappa = 2 (eps + 2 u (1 + eps)), abs = 2 D 2^-74; l2: kappa =
    2 (2 eps + 6 u (1 + eps)), abs = 4 D 2^-74, aux = 4 u; cosine: kappa =
    2 (eps + 3 u (1 + eps)), abs = 2 D 2^-74 (both times |a|)."""
    d = int(d)
    if d * _U >= 0.5:
        inf = float("inf")
        return tuple(KnnMargin(inf, inf, inf) for _ in range(3))
    gamma = d * _U / (1.0 - d * _U)
    if dtype == torch.bfloat16:
        eta = 2 * (d + 16) * 2.0**-23 * (1 + 2.0**-8)
    elif dtype == torch.uint8:
        eta = 2.0**-16 + 2 * (2 * d + 16) * 2.0**-23 * (1 + 2.0**-8) * (1 + 2.0**-6)
    else:
        eta = 3 * 2.0**-20 + 2 * (3 * d + 16) * 2.0**-23 * (1 + 2.0**-8) * (1 + 2.0**-9)
    eps = eta + gamma
    abs_d = d * 2.0**-74
    return (
        KnnMargin(2 * (eps + 2 * _U * (1 + eps)), 2 * abs_d, 0.0),
        KnnMargin(2 * (2 * eps + 6 * _U * (1 + eps)), 4 * abs_d, 4 * _U),
        KnnMargin(2 * (eps + 3 * _U * (1 + eps)), 2 * abs_d, 0.0),
    )


def query_terms(qs, dtype, score: int):
    """Per query ``kappa (||q|| + slack)`` as float32, +inf for a query
    that is not finite or whose norm is not below 2^50 (every pair of it is
    then re-scored); ``qs`` as the scan gets them (bf16 corpora: rounded to
    bf16 first, as the kernel rounds them; f32 and u8: as they are, the
    norm of the exact re-score's operand)."""
    m = knn_margin(qs.shape[1], dtype)[score]
    q = qs.to(torch.bfloat16).float() if dtype == torch.bfloat16 else qs.float()
    qn = torch.linalg.vector_norm(q, dim=1)
    # NaN and +inf norms fail the compare too.
    return torch.where(qn < _REGULAR_NORM, qn, torch.inf).add_(_NORM_SLACK).mul_(m.kappa)


def rescore_stats():
    """``(rows, queries, pairs)`` of this thread's last scan launch (any
    corpus dtype, full or tile scan): its corpus rows, its queries and the
    (row, query) pairs it re-scored exactly. Reads a device counter
    (synchronises); None before any launch. For sums over many launches,
    read the ``rescored`` counters of the ``dispatch.k1_pass`` spans
    (:mod:`innr_tpu_torch.utils.trace`), which need no synchronisation
    until they are read."""
    stats = getattr(_THIS_THREAD, "stats", None)
    if stats is None:
        return None
    n, n_q, counter = stats
    return n, n_q, int(counter.item())


def single_pass_k(n_q: int) -> int:
    """Largest k one kernel pass selects (for any query count)."""
    return _K_MAX_PASS


def scan_path(rows, n_q: int, k: int) -> str:
    """The scan's schedule on the card for ``n_q`` queries and k per pass
    over ``rows``: ``"wide"`` from ``_WIDE_MIN_QUERIES`` queries where the
    library plans a wide layout at this dtype, D and k, else ``"tile"``.
    Both compute the same composites."""
    if n_q < _WIDE_MIN_QUERIES:
        return "tile"
    return "wide" if _grid(rows, n_q, k, "wide")[0] else "tile"


def _split_aux(aux, mode: str, n: int):
    """``aux`` in the JAX package's layout -> (per-row values, predicate):
    None for "dot"; (N,) norms2 / inverse norms for "l2" / "cosine"; (N,)
    predicate for "dotm"; (2, N) [values, predicate] for "l2m" / "cosinem"."""
    if mode not in _MODES:
        raise ContractError(f"innr_tpu_torch::knn: unknown mode {mode!r}")
    score, masked = _MODES[mode]
    if score == 0 and not masked:
        if aux is not None:
            raise ContractError("innr_tpu_torch::knn: mode 'dot' takes no aux")
        return None, None
    want = (2, n) if masked and score != 0 else (n,)
    if aux is None or tuple(aux.shape) != want:
        got = None if aux is None else tuple(aux.shape)
        raise ContractError(
            f"innr_tpu_torch::knn: mode {mode!r} needs aux of shape {want}, got {got}"
        )
    aux = aux.to(torch.float32).contiguous()
    if not masked:
        return aux, None
    if score == 0:
        return None, aux
    return aux[0].contiguous(), aux[1].contiguous()


def _check_ids(row_ids, rows, op: str):
    """``row_ids`` as a contiguous (N,) int32 tensor on the corpus's device,
    or None."""
    if row_ids is None:
        return None
    if (row_ids.dim() != 1 or row_ids.shape[0] != rows.shape[0]
            or row_ids.device != rows.device):
        raise ContractError(
            f"innr_tpu_torch::{op}: row_ids must be ({rows.shape[0]},) on {rows.device}, got "
            f"{tuple(row_ids.shape)} on {row_ids.device}")
    return row_ids.to(torch.int32).contiguous()


def _check(qs, rows, vals, mask, k: int, op: str) -> None:
    if rows.dim() != 2 or rows.dtype not in _DTYPES:
        raise ContractError(
            f"innr_tpu_torch::{op}: rows must be a 2-D float32, bfloat16 or "
            f"uint8 tensor, got {rows.dtype} of shape {tuple(rows.shape)}"
        )
    if qs.dim() != 2 or qs.dtype != torch.float32 or qs.shape[1] != rows.shape[1]:
        raise ContractError(
            f"innr_tpu_torch::{op}: queries must be float32 (Q, {rows.shape[1]}), "
            f"got {qs.dtype} of shape {tuple(qs.shape)}"
        )
    for name, t in (("queries", qs), ("aux", vals), ("mask", mask)):
        if t is not None and t.device != rows.device:
            raise ContractError(
                f"innr_tpu_torch::{op}: {name} on {t.device}, rows on {rows.device}"
            )
    n = rows.shape[0]
    if n > _MAX_ROWS:
        raise ContractError(
            f"innr_tpu_torch::{op}: {n} rows; row indices are int32 (< 2**31)"
        )
    if not 1 <= k <= n:
        raise ContractError(f"innr_tpu_torch::{op}: k={k} outside [1, {n}]")


def _plain_composites(qs, rows, vals, mask, mode: str, row_ids=None) -> torch.Tensor:
    score = _MODES[mode][0]
    q = qs.to(torch.bfloat16).float() if rows.dtype == torch.bfloat16 else qs
    # "+ 0.0" turns a -0.0 sum into +0.0, as the kernel's sums start at +0.0.
    s = q @ rows.float().T + 0.0
    if score == 1:
        s = vals - 2.0 * s
    elif score == 2:
        s = s * vals
    keys = total_order_key_f32(canonical_nan(s))
    if score == 1:
        keys = ~keys
    if mask is not None:
        keys = torch.where(mask > 0, keys, _INT32_MIN)
    ids = torch.arange(rows.shape[0], device=rows.device) if row_ids is None else row_ids
    return composite_keys(keys, ids)


def _plain_top(qs, rows, vals, mask, k: int, mode: str, bound=None,
               row_ids=None) -> torch.Tensor:
    comp = _plain_composites(qs, rows, vals, mask, mode, row_ids)
    if bound is not None:
        comp = torch.where(comp < bound[:, None], comp, _EMPTY)
    return torch.topk(comp, k, dim=1).values


def knn_plain(qs, rows, aux, k: int, mode: str, excl=None, row_ids=None):
    """The plain PyTorch version of the kernel: matmul scores, keys,
    composite top-k. Returns raw ``(keys, idx)`` int32 (Q, k), best first
    (``idx``: ``row_ids`` of the rows when a map is given).

    ``excl``: optional per-query ``(keys, idx)`` bound; only candidates
    strictly after it in (key desc, idx asc) order are kept. Slots past the
    last kept candidate hold ``(INT32_MIN, -1)``."""
    vals, mask = _split_aux(aux, mode, rows.shape[0])
    _check(qs, rows, vals, mask, k, "knn_plain")
    row_ids = _check_ids(row_ids, rows, "knn_plain")
    bound = None if excl is None else composite_keys(excl[0], excl[1])
    return split_composite(_plain_top(qs, rows, vals, mask, k, mode, bound, row_ids))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _slab_rows(n: int, q_tiles: int, k: int, device, row_tile: int,
               resident: int = _RESIDENT_CTAS, max_waves: int = _MAX_WAVES) -> int:
    """Corpus rows per CTA of a scan grid with ``q_tiles`` query tiles:
    whole waves of ``resident`` CTAs per SM, ``max_waves`` for small k,
    fewer as k grows so that a slab keeps ``_SLAB_ROWS_PER_K * k`` rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wave = max(1, sms * resident // q_tiles)
    waves = min(max_waves, max(1, n // (_SLAB_ROWS_PER_K * k * wave)))
    return round_up(-(-n // (wave * waves)), row_tile)


def _wide_slab_rows(n: int, q_tiles: int, n_ctas: int) -> int:
    """Corpus rows per slab of the wide schedule over ``q_tiles`` query
    tiles (two warpgroups' queries each) on a grid of ``n_ctas`` CTAs: the
    grid walks q_tiles x n_slabs items, and n_slabs = n_ctas x
    ceil(_WIDE_ITEMS_PER_CTA / q_tiles) deals every CTA the same count of
    items, at least _WIDE_ITEMS_PER_CTA, or one fewer where rounding the
    slabs up to whole row tiles leaves a last few out (fewer items in all
    where N holds fewer row tiles)."""
    n_slabs = n_ctas * -(-_WIDE_ITEMS_PER_CTA // q_tiles)
    return round_up(-(-n // n_slabs), _ROW_TILE)


def _grid(rows, n_q: int, k: int, path: str) -> tuple[int, int]:
    """(queries per CTA, CTAs resident per SM) of the scan at this shape on
    the schedule ``path``, as the library plans its launch."""
    from innr_tpu_torch.kernels import _build

    key = (rows.dtype, n_q, rows.shape[1], k, path, rows.device)
    if key not in _GRIDS:
        info = (ctypes.c_int * 2)()
        with torch.cuda.device(rows.device):
            rc = _build.load().innr_knn_grid(_DTYPES[rows.dtype], n_q, rows.shape[1], k,
                                             int(path == "wide"), info)
        if rc != 0:
            raise RuntimeError(f"innr_tpu_torch: knn_grid failed, cudaError {rc}")
        _GRIDS[key] = (info[0], max(1, info[1]))
    return _GRIDS[key]


def _gate_terms(qs, rows, mode: str):
    """The scan's per-launch gate inputs: ``(qmeta, m_abs, m_aux, counter)``;
    the counter, one int64 the launch zeroes, collects the re-scored pairs."""
    score = _MODES[mode][0]
    m = knn_margin(qs.shape[1], rows.dtype)[score]
    qmeta = query_terms(qs, rows.dtype, score).contiguous()
    return qmeta, m.abs, m.aux, torch.empty(1, dtype=torch.int64, device=rows.device)


def shared_keys(n_q: int, n_slabs: int, dev) -> torch.Tensor:
    """Space for the scan's shared keys, which the launch sets to INT32_MIN:
    (Q * (1 + n_slabs),) int32, per query a key k rows reach, then each
    query's row of the keys its n_slabs slabs publish (csrc/knn.cu; the tile
    scan of a tile list publishes one key per CTA)."""
    return torch.empty((n_q * (1 + n_slabs),), dtype=torch.int32, device=dev)


def _note_rescored(rows, n_q: int, counter) -> None:
    _THIS_THREAD.stats = (rows.shape[0], n_q, counter)


def _scan_pass(qs, rows, vals, mask, k: int, mode: str, bound, row_ids=None) -> torch.Tensor:
    """One kernel pass (knn_scan + knn_merge): (Q, k) int64 composites."""
    global LAUNCHES
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    n_q, d = qs.shape
    n = rows.shape[0]
    path = scan_path(rows, n_q, k)
    if path == "wide" and (rows.data_ptr() % 16 or qs.data_ptr() % 16):
        path = "tile"  # the ring's bulk copies read 16-byte aligned rows
    q_tile, resident = _grid(rows, n_q, k, path)
    q_tiles = -(-n_q // q_tile)
    n_ctas = 0  # the tile schedule's grid is n_slabs x q_tiles
    if path == "wide":  # every resident CTA of the card, persistent
        n_ctas = resident * torch.cuda.get_device_properties(rows.device).multi_processor_count
        slab_rows = _wide_slab_rows(n, q_tiles, n_ctas)
    else:
        slab_rows = _slab_rows(n, q_tiles, k, rows.device, _ROW_TILE, resident, 1)
    with torch.cuda.device(rows.device):
        qmeta, m_abs, m_aux, counter = _gate_terms(qs, rows, mode)

    def scan(partial, slab_rows, stream):
        kth = shared_keys(n_q, -(-n // slab_rows), rows.device)
        return lib.innr_knn_scan(
            qs.data_ptr(), rows.data_ptr(), _DTYPES[rows.dtype], _ptr(vals), _ptr(mask),
            _ptr(bound), _ptr(row_ids), _ptr(qmeta), m_abs, m_aux, _ptr(counter), kth.data_ptr(), partial, n_q,
            n, d, k, _MODES[mode][0], slab_rows, n_ctas, stream)

    out = _scan_and_merge("knn_scan", scan, n_q, n, k, slab_rows, rows.device)
    _note_rescored(rows, n_q, counter)
    _THIS_THREAD.path = path
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[str(rows.dtype).removeprefix("torch.")] += 1
    LAUNCHES_BY_PATH[path] += 1
    return out


def fused_knn_keys_batch(qs, rows, aux, k: int, mode: str, row_ids=None):
    """Top-k as RAW int32 total-order keys (larger is better for every mode;
    L2 keys come bit-inverted) plus int32 row indices, both (Q, k). With
    ``row_ids`` ((N,) int32, distinct) the indices are the rows' ids, and
    ties go to the lowest id.

    Any k in [1, N]: above :func:`single_pass_k` the kernel runs
    exclusion-bounded passes, each resuming strictly after the previous
    pass's last (key, idx); the concatenation equals one ideal selection."""
    qs = qs.contiguous()
    rows = rows.contiguous()
    vals, mask = _split_aux(aux, mode, rows.shape[0])
    _check(qs, rows, vals, mask, k, "fused_knn_keys_batch")
    row_ids = _check_ids(row_ids, rows, "fused_knn_keys_batch")
    if rows.device.type == "cpu" or config.reference_forced():
        run_pass = _plain_top
    elif rows.device.type == "cuda":
        run_pass = _scan_pass
    else:
        raise ContractError(f"innr_tpu_torch::knn: unsupported device {rows.device}")
    n, n_q = rows.shape[0], qs.shape[0]
    on_card = run_pass is _scan_pass

    def one_pass(pass_k, bound):
        with _trace.span("dispatch.k1_pass", rows=n, n_q=n_q) as span:
            comp = run_pass(qs, rows, vals, mask, pass_k, mode, bound, row_ids)
            if on_card:
                span.set(rescored=_THIS_THREAD.stats[2], path=_THIS_THREAD.path)
            return comp

    return split_composite(_multi_pass(one_pass, k, single_pass_k(n_q)))


def _chunked_top(keys_of, n: int, step: int, k: int, bound, dev) -> torch.Tensor:
    """The plain scans' selection: (Q, k) int64 composites, best first, of
    the int32 keys ``keys_of(s, e)`` ((Q, e - s), larger is better) of
    corpus rows [s, e), taken ``step`` rows at a time and merged into a
    running top-k, so that no (Q, N) intermediate is larger than a chunk's.
    ``bound``: optional (Q,) composites; only candidates below it stay."""
    best = None
    for s in range(0, n, step):
        keys = keys_of(s, min(n, s + step))
        comp = composite_keys(keys, torch.arange(s, s + keys.shape[1], device=dev))
        if bound is not None:
            comp = torch.where(comp < bound[:, None], comp, _EMPTY)
        if best is not None:
            comp = torch.cat([best, comp], dim=1)
        best = torch.topk(comp, min(k, comp.shape[1]), dim=1).values
    return best


def _scan_and_merge(name: str, scan, n_q: int, n: int, k: int, slab_rows: int,
                    dev) -> torch.Tensor:
    """One kernel pass of a slab scan, then knn_merge: (Q, k) int64
    composites. ``scan(partial_ptr, slab_rows, stream)`` launches the scan
    into partial (n_slabs, Q, k), n_slabs = ceil(n / slab_rows), and returns
    its launcher's cudaError."""
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    n_slabs = -(-n // slab_rows)
    with torch.cuda.device(dev):
        partial = torch.empty((n_slabs, n_q, k), dtype=torch.int64, device=dev)
        out = torch.empty((n_q, k), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = scan(partial.data_ptr(), slab_rows, stream)
        if rc != 0:
            raise RuntimeError(f"innr_tpu_torch: {name} launch failed, cudaError {rc}")
        rc = lib.innr_knn_merge(partial.data_ptr(), out.data_ptr(), n_q, n_slabs, k, stream)
        if rc != 0:
            raise RuntimeError(f"innr_tpu_torch: knn_merge launch failed, cudaError {rc}")
    return out


def _multi_pass(run_pass, k: int, cap: int) -> torch.Tensor:
    """ceil(k / cap) passes of ``run_pass(pass_k, bound)``, each keeping only
    candidates strictly after the previous pass's last composite."""
    parts, bound, remaining = [], None, k
    while remaining > 0:
        comp = run_pass(min(cap, remaining), bound)
        parts.append(comp)
        bound = comp[:, -1].contiguous()
        remaining -= comp.shape[1]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def decode_keys(keys, mode: str, qs):
    """K1's raw keys (of one scan, or merged from many) -> float32 scores
    for the (Q, D) queries ``qs`` as the scan got them. L2 keys flip back
    to distances, get the per-query ``||q||^2`` the kernel leaves out (a
    shift that cannot change a selection) and clamp at zero; NaN
    propagates."""
    l2 = mode in ("l2", "l2m")
    vals = invert_total_key(~keys if l2 else keys)
    if l2:
        vals = (vals + (qs * qs).sum(dim=1, keepdim=True)).clamp_min(0.0)
    return vals


def _fused_knn(qs, rows, aux, k: int, mode: str, row_ids=None):
    keys, idx = fused_knn_keys_batch(qs, rows, aux, k, mode, row_ids)
    return decode_keys(keys, mode, qs), idx


def _norms2(rows) -> torch.Tensor:
    r = rows.float()
    return (r * r).sum(dim=1)


def fused_knn_dot(q, rows, k: int):
    """Top-k largest dot products of one query: ``(scores (k,), idx (k,))``."""
    vals, idx = _fused_knn(q[None, :], rows, None, k, "dot")
    return vals[0], idx[0]


def fused_knn_dot_batch(qs, rows, k: int):
    """Top-k MIPS for a (Q, D) batch in one corpus read per pass."""
    return _fused_knn(qs, rows, None, k, "dot")


def fused_knn_l2(q, rows, k: int, norms2=None):
    """Top-k smallest squared L2 distances of one query, clamped at 0.
    Pass precomputed ``norms2`` to skip a corpus read."""
    vals, idx = fused_knn_l2_batch(q[None, :], rows, k, norms2)
    return vals[0], idx[0]


def fused_knn_l2_batch(qs, rows, k: int, norms2=None):
    """Top-k L2^2 for a (Q, D) batch: ``norms2 - 2 q.r`` in the kernel,
    ``||q||^2`` added back after selection."""
    if norms2 is None:
        norms2 = _norms2(rows)
    return _fused_knn(qs, rows, norms2, k, "l2")


def fused_knn_l2_masked_batch(qs, rows, mask, k: int, norms2=None):
    """Top-k smallest L2^2 among rows where ``mask`` (N,) is true. When fewer
    than k rows pass, the tail entries are failing rows; callers trim to the
    passing count."""
    if norms2 is None:
        norms2 = _norms2(rows)
    aux = torch.stack([norms2.float(), mask.to(device=norms2.device, dtype=torch.float32)])
    return _fused_knn(qs, rows, aux, k, "l2m")


def fused_knn_u8_batch(qs, codes, k: int):
    """Top-k raw mixed dots ``sum(q_i * code_i)`` of f32 queries against a
    uint8 corpus; callers apply the affine correction afterwards."""
    if codes.dtype != torch.uint8:
        raise ContractError("innr_tpu_torch::fused_knn_u8_batch expects uint8 codes")
    return _fused_knn(qs, codes, None, k, "dot")


def _unit_queries(qs):
    """Unit query rows; zero/tiny-norm queries become zero rows, so every
    cosine they produce is 0.0."""
    qn = torch.sqrt((qs * qs).sum(dim=1, keepdim=True))
    ok = qn > config.NORM_EPSILON
    return torch.where(ok, qs / torch.where(ok, qn, 1.0), 0.0)


def inv_norms(rows):
    """Per-row guarded inverse norms (zero/tiny-norm rows -> 0.0)."""
    norms = torch.sqrt(_norms2(rows))
    ok = norms > config.NORM_EPSILON
    return torch.where(ok, 1.0 / torch.where(ok, norms, 1.0), 0.0)


def fused_knn_cosine(q, rows, k: int):
    """Top-k by cosine similarity of one query."""
    vals, idx = fused_knn_cosine_batch(q[None, :], rows, k)
    return vals[0], idx[0]


def fused_knn_cosine_batch(qs, rows, k: int, inv=None):
    """Top-k by cosine for a (Q, D) batch: unit queries, per-row inverse
    norms (pass precomputed ``inv`` to skip a corpus read)."""
    if inv is None:
        inv = inv_norms(rows)
    return _fused_knn(_unit_queries(qs), rows, inv, k, "cosine")
