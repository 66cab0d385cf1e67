"""Fused slot-sketch kNN: the CUDA kernels, their plan and their plain versions.

Replaces the TPU kernels of ``innr_tpu/kernels/slot_knn.py``:
``_slot_kernel`` (``fused_slot_knn``, one sketch) and ``_slot_kernel_mq``
(``fused_slot_knn_batch``, a batch), the k smallest differing-slot counts
of MinHash / b-bit sketches. The kernels are in ``csrc/slot_knn.cu``, each
followed by ``knn_merge`` from ``csrc/knn.cu``; its source note says what
bounds them on the H100:

- ``slot_compare`` (mode ``"compare"``): a compare and an add per (row,
  slot, query), each thread on 16-byte vectors of neighbouring rows; query
  tiles of 1, 2 or 4;
- ``slot_table`` (mode ``"table"``): one shared-memory lookup per (row,
  slot) for the whole query tile (a per-slot filter, then a per-slot table
  of (value, query mask)); query tiles of 1-32 (8-32 as planned).

:func:`plan` picks the mode and the query tile: ``"compare"`` up to
:data:`COMPARE_MAX_TILE` queries, the crossover ``scripts/slot_probe.py``
measured on the card, ``"table"`` beyond; a table tile whose shared memory
does not fit is halved, and one that falls to the crossover or does not
fit at all gives way to the compare scan. :func:`slot_table_plain` is a
plain model of the table (the same hashes, filter and probing), for the
tests.

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

Dispatch: a CUDA tensor runs a kernel, or the call raises; a CPU tensor,
or :func:`innr_tpu_torch.config.force_reference`, runs the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

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

# Kernel passes launched (each pass launches slot_compare or slot_table,
# then knn_merge), in all, by slot type and by mode. Incremented only where
# the kernels launch.
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"uint16": 0, "uint32": 0}
LAUNCHES_BY_MODE = {"compare": 0, "table": 0}

# The scans of csrc/slot_knn.cu: mode -> (its id in innr_slot_scan, its
# query tiles).
MODES = {"compare": (0, (1, 2, 4)), "table": (1, (1, 2, 4, 8, 16, 32))}
# Query tiles up to this run slot_compare, larger ones slot_table: the
# crossover scripts/slot_probe.py measured on the H100 (PERF.md section 6).
# The checks on the card set it to 0 or 32 to run one scan at every Q.
COMPARE_MAX_TILE = 4
# slot_table's filter (words per slot) and hash multipliers: kFilterWords,
# kFilterMul and kTableMul in csrc/slot_knn.cu.
FILTER_WORDS = 32
FILTER_MUL = 2654435761
TABLE_MUL = 0x85EBCA6B


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


def compare_rows(bits: int) -> int:
    """Rows per thread of slot_compare: one 16-byte vector of a slot."""
    return 128 // bits


def row_tile(bits: int, mode: str) -> int:
    """Corpus rows per tile of a mode's scan (slabs are whole tiles)."""
    return row_scan.ROW_TILE * (compare_rows(bits) if mode == "compare" else 1)


def table_entries(tile: int) -> int:
    """slot_table's entries per slot: tile + tile // 2 + 1, so at most two
    thirds full and never without an empty entry."""
    return tile + tile // 2 + 1


def _table_home(v, tile: int):
    """A value's first entry in its slot's table: its hash scaled to the
    entries (``table_home`` in ``csrc/slot_knn.cu``)."""
    return (_mul32(v, TABLE_MUL) * table_entries(tile)) >> 32


def smem_bytes(bits: int, mode: str, tile: int, s: int, k: int) -> int:
    """Shared memory of one CTA (``innr_slot_smem_bytes``): the top-k part
    of ``row_scan.cuh`` (buffers, max(16, tile) bounds, the tile's keys),
    then the query words (compare) or the per-slot filters and tables
    (table)."""
    topk = (8 * (max(tile, 8) * k + max(row_scan.MAX_QUERY_TILE, tile))
            + 4 * tile * row_tile(bits, mode))
    if mode == "compare":
        return topk + 4 * s * tile
    return topk + s * (4 * FILTER_WORDS + 8 * table_entries(tile))


def _largest_fitting(bits: int, mode: str, tile: int, s: int, k: int) -> int:
    """``tile`` halved while a CTA of the mode's scan does not fit in shared
    memory (down to 1, which may still not fit)."""
    while tile > 1 and smem_bytes(bits, mode, tile, s, k) > row_scan.SMEM_LIMIT:
        tile //= 2
    return tile


def plan(n_q: int, k: int, s: int, bits: int) -> tuple[str, int]:
    """``(mode, query tile)`` of a pass. The tile is the smallest power of
    two >= n_q, at most 32. Tiles up to :data:`COMPARE_MAX_TILE` run
    ``"compare"``; larger ones ``"table"``, halved while its shared memory
    does not fit. A table tile that falls to :data:`COMPARE_MAX_TILE` or
    below, or does not fit at one query (wide sketches: the table holds
    about 40 times the compare scan's bytes a slot), runs ``"compare"`` at
    its largest tile that fits. Raises :class:`ContractError` naming the
    limit when a one-query compare tile does not fit."""
    tile = 1
    while tile < min(n_q, MODES["table"][1][-1]):
        tile *= 2
    if tile > COMPARE_MAX_TILE:
        t = _largest_fitting(bits, "table", tile, s, k)
        if t > COMPARE_MAX_TILE and smem_bytes(bits, "table", t, s, k) <= row_scan.SMEM_LIMIT:
            return "table", t
    tile = _largest_fitting(bits, "compare", min(tile, MODES["compare"][1][-1]), s, k)
    if smem_bytes(bits, "compare", tile, s, k) > row_scan.SMEM_LIMIT:
        raise ContractError(
            f"innr_tpu_torch::slot_scan: {s} slots need {smem_bytes(bits, 'compare', 1, s, k)} "
            f"bytes of shared memory at k={k} in the compare scan; a CTA has at most "
            f"{row_scan.SMEM_LIMIT}")
    return "compare", tile


class SlotTable(NamedTuple):
    """What :func:`slot_table_plain` finds: each query's equal-slot counts,
    and over every query tile the (slot, row) lookups whose filter passed
    and those that hit the table."""

    equal: torch.Tensor  # (Q, N) int32
    passes: int
    hits: int


def _mul32(v, mul: int):
    """(v * mul) mod 2^32 of unsigned 32-bit values held in int64 (a
    tensor or an int), without leaving int64."""
    return (v * (mul & 0xFFFF) + (((v * (mul >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _filter_bits(p):
    """The two filter bits of hash p within its word p >> 27."""
    if isinstance(p, torch.Tensor):
        one = torch.ones_like(p)
        return (one << ((p >> 22) & 31)) | (one << ((p >> 17) & 31))
    return (1 << ((p >> 22) & 31)) | (1 << ((p >> 17) & 31))


def slot_table_build(tile_q: torch.Tensor, tile: int):
    """One query tile's filters and tables as slot_table builds them in
    shared memory (one slot at a time, the tile's queries in order):
    ``(filter (S, 32), values (S, E), masks (S, E))`` int64, E =
    :func:`table_entries` (tile). ``tile_q``: (<= tile, S) slots as
    unsigned values in int64. A value's entry holds the mask of the tile's
    queries that hold it at that slot; mask 0 is an empty entry."""
    s = tile_q.shape[1]
    e = table_entries(tile)
    filt = [[0] * FILTER_WORDS for _ in range(s)]
    vals = [[0] * e for _ in range(s)]
    masks = [[0] * e for _ in range(s)]
    for sl, col in enumerate(tile_q.T.tolist()):
        f, tv, tm = filt[sl], vals[sl], masks[sl]
        for j, v in enumerate(col):
            p = _mul32(v, FILTER_MUL)
            f[p >> 27] |= _filter_bits(p)
            h = _table_home(v, tile)
            while tm[h] and tv[h] != v:
                h = (h + 1) % e
            tv[h] = v
            tm[h] |= 1 << j
    return tuple(torch.tensor(x, dtype=torch.int64).reshape(s, w)
                 for x, w in ((filt, FILTER_WORDS), (vals, e), (masks, e)))


def _table_lookup(tables, slots, tile: int):
    """``(masks, passed)``, both (S, n): each (slot, row) of ``slots``
    (unsigned values in int64) through the filter, then for the passes
    through the table by linear probing, as slot_table looks it up."""
    filt, vals, masks = tables
    e = vals.shape[1]
    sl = torch.arange(slots.shape[0], device=slots.device).unsqueeze(1)
    p = _mul32(slots, FILTER_MUL)
    want = _filter_bits(p)
    passed = (filt[sl, p >> 27] & want) == want
    h = _table_home(slots, tile)
    found = torch.zeros_like(slots)
    live = passed.clone()
    for _ in range(e):
        if not live.any():
            break
        em, ev = masks[sl, h], vals[sl, h]
        found = torch.where(live & (em != 0) & (ev == slots), em, found)
        live &= (em != 0) & (ev != slots)
        h = (h + 1) % e
    return found, passed


def slot_table_plain(queries, slots_t, tile: int, chunk: int = 1 << 20) -> SlotTable:
    """A plain model of slot_table at query tile ``tile``: each query
    tile's filters and tables built as the kernel builds them
    (:func:`slot_table_build`), every (slot, row) looked up through them
    (:func:`_table_lookup`), and each query's equal count summed from the
    masks found. The counts must equal the direct compare's. Rows go
    ``chunk`` at a time."""
    _check(queries, slots_t, 1, "slot_table_plain")
    n_q, s = queries.shape
    n = slots_t.shape[1]
    low = (1 << _BITS[slots_t.dtype]) - 1
    q = queries.to(torch.int64) & low
    equal = torch.empty((n_q, n), dtype=torch.int32, device=slots_t.device)
    passes = hits = 0
    for q0 in range(0, n_q, tile):
        tables = [x.to(slots_t.device) for x in slot_table_build(q[q0:q0 + tile], tile)]
        for a in range(0, n, chunk):
            b = min(n, a + chunk)
            found, passed = _table_lookup(tables, slots_t[:, a:b].to(torch.int64) & low, tile)
            passes += int(passed.sum())
            hits += int((found != 0).sum())
            for j in range(min(tile, n_q - q0)):
                equal[q0 + j, a:b] = ((found >> j) & 1).sum(dim=0, dtype=torch.int32)
    return SlotTable(equal, passes, hits)


def _scan_pass(queries, slots_t, k: int, bound) -> torch.Tensor:
    """One kernel pass (slot_compare or slot_table, then knn_merge): (Q, k)
    int64 composites."""
    global LAUNCHES
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    bits = _BITS[slots_t.dtype]
    n_q, s = queries.shape
    n = slots_t.shape[1]
    mode, tile = plan(n_q, k, s, bits)
    out = _knn._scan_and_merge(
        f"slot_{mode}",
        lambda partial, slab_rows, stream: lib.innr_slot_scan(
            bits, MODES[mode][0], queries.data_ptr(), slots_t.data_ptr(), _knn._ptr(bound),
            partial, n_q, n, s, k, tile, slab_rows, stream),
        n_q, n, k, _knn._slab_rows(n, -(-n_q // tile), k, slots_t.device, row_tile(bits, mode)),
        slots_t.device)
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[f"uint{bits}"] += 1
    LAUNCHES_BY_MODE[mode] += 1
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
