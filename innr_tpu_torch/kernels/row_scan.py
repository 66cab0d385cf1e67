"""The query tile of the one-row-per-thread scans built on ``csrc/row_scan.cuh``:
``sparse_scan`` (the slot scans plan their own tiles, :func:`.slot_knn.plan`).

A CTA of 256 threads walks its slab in tiles of :data:`ROW_TILE` rows, one
row per thread, for a tile of 1, 2, 4, 8 or 16 queries (a template parameter
of each kernel). Its shared memory holds the top-k buffers, the tile's keys
and the queries; :func:`row_scan_tile` picks the largest query tile that
fits.
"""

from __future__ import annotations

from innr_tpu_torch.utils.asserts import ContractError

# Rows per tile (one per thread of a 256-thread CTA) and the largest query
# tile: kScanRowTile and kScanMaxQueryTile in csrc/row_scan.cuh. Slabs are
# whole tiles.
ROW_TILE = 256
MAX_QUERY_TILE = 16
# Shared memory a CTA may use on the H100 (227 KB, opted in per kernel).
SMEM_LIMIT = 232_448


def query_tile(n_q: int) -> int:
    """Queries per CTA for an ``n_q``-query batch: the smallest power of two
    >= n_q, at most 16."""
    tile = 1
    while tile < min(n_q, MAX_QUERY_TILE):
        tile *= 2
    return tile


def row_scan_tile(n_q: int, k: int, query_bytes: int, op: str) -> int:
    """The largest power of two <= :func:`query_tile` whose shared memory
    fits, ``query_bytes`` per query beside the top-k buffers
    (``topk_smem_bytes`` in ``csrc/row_scan.cuh``). Raises
    :class:`ContractError` naming the limit when a single query does not
    fit."""
    def smem(qt: int) -> int:
        bufs = max(qt, 8)
        return 8 * (bufs * k + MAX_QUERY_TILE) + 4 * qt * ROW_TILE + query_bytes * qt

    tile = query_tile(n_q)
    while tile > 1 and smem(tile) > SMEM_LIMIT:
        tile //= 2
    if smem(tile) > SMEM_LIMIT:
        raise ContractError(
            f"innr_tpu_torch::{op}: a query of {query_bytes} bytes needs {smem(1)} bytes of "
            f"shared memory at k={k}; a CTA has at most {SMEM_LIMIT}")
    return tile
