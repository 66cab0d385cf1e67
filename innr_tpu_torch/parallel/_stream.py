"""Per-shard streaming ingestion for the sharded containers.

The counterpart of :mod:`innr_tpu.parallel._stream`. A host row source
(an ``np.memmap`` slice, a decoder) is asked for exactly one shard's rows
at a time, and each block goes straight to its shard's device, so the
corpus is never materialised on the host. A shard with no rows never calls
the source. This is the plumbing behind every container's
``from_*_source`` constructor.
"""

from __future__ import annotations

import numpy as np

from innr_tpu_torch.utils.asserts import ContractError


def fetch_block(get_rows, start: int, stop: int, width: int, np_dtype, name: str) -> np.ndarray:
    """``get_rows(start, stop)`` copied into a ``(stop - start, width)``
    array of ``np_dtype`` (a memmap slice is read-only); raises
    :class:`ContractError` naming ``name`` on another shape."""
    block = np.array(get_rows(start, stop), dtype=np_dtype)
    if block.shape != (stop - start, width):
        raise ContractError(
            f"{name}: get_rows({start}, {stop}) returned shape {block.shape}, "
            f"want ({stop - start}, {width})")
    return block


def column_major(t):
    """A shard's rows as the contiguous ``(width, rows)`` transpose that the
    packed, slot and sparse scans stream."""
    return t.T.contiguous()
