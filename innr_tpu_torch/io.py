"""npz persistence for the ported containers.

The same file format as :mod:`innr_tpu.io`, so an index saved by either
package loads in the other: ``kind`` plus ``rows`` (float32),
``rows_bf16`` (bfloat16 bits as uint16) or ``codes`` (uint8) for the dense
kinds, and ``words`` or ``pos`` / ``neg`` (uint32 words, the JAX package's
type; this package holds them as bit-identical int32) with ``dimension``
for the packed kinds, ``sketches`` (uint16 or uint32) for ``SketchCorpus``
and ``indices`` (uint32) with ``values`` (float32) for ``SparseCorpus``;
``SegmentedCorpus`` keeps its compacted view: the alive ``rows``
(float32), their permanent ``ids`` (int64), ``dimension`` and ``next_id``,
so a restored index returns the same ids and never reuses a deleted one.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.batch import VerticalBatch
from innr_tpu_torch.ops.binary import PackedBinary, PackedBinaryBatch
from innr_tpu_torch.ops.scalar import QuantizedU8Batch
from innr_tpu_torch.ops.slot import SketchCorpus
from innr_tpu_torch.ops.sparse import SparseCorpus
from innr_tpu_torch.ops.ternary import PackedTernary, PackedTernaryBatch
from innr_tpu_torch.segmented import SegmentedCorpus, _Segment
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.bits import unsigned_to_numpy, words_to_numpy
from innr_tpu_torch.utils.tensors import as_tensor, host_device

__all__ = ["save_npz", "load_npz"]


def save_npz(path: str, obj) -> None:
    """Serialize a container to an npz archive."""
    if isinstance(obj, VerticalBatch):
        rows = obj.rows.cpu()
        if rows.dtype == torch.float32:
            np.savez(path, kind="VerticalBatch", rows=rows.numpy())
        else:
            np.savez(path, kind="VerticalBatch", rows_bf16=rows.view(torch.uint16).numpy())
    elif isinstance(obj, (PackedBinary, PackedBinaryBatch)):
        np.savez(path, kind=type(obj).__name__, words=words_to_numpy(obj.words),
                 dimension=obj.dimension)
    elif isinstance(obj, (PackedTernary, PackedTernaryBatch)):
        np.savez(path, kind=type(obj).__name__, pos=words_to_numpy(obj.pos),
                 neg=words_to_numpy(obj.neg), dimension=obj.dimension)
    elif isinstance(obj, QuantizedU8Batch):
        np.savez(path, kind="QuantizedU8Batch", codes=obj.codes.cpu().numpy())
    elif isinstance(obj, SketchCorpus):
        np.savez(path, kind="SketchCorpus", sketches=unsigned_to_numpy(obj.sketches))
    elif isinstance(obj, SparseCorpus):
        np.savez(path, kind="SparseCorpus", indices=unsigned_to_numpy(obj.indices),
                 values=obj.values.cpu().numpy())
    elif isinstance(obj, SegmentedCorpus):
        segs = obj._segments
        rows = (torch.cat([s.vb.rows[s.alive_dev()] for s in segs]).cpu().numpy() if segs
                else np.zeros((0, obj.dimension), np.float32))
        ids = (np.concatenate([s.ids[s.alive] for s in segs]) if segs
               else np.zeros(0, np.int64))
        np.savez(path, kind="SegmentedCorpus", rows=rows, ids=ids, dimension=obj.dimension,
                 next_id=obj._next_id)
    else:
        raise ContractError(f"save_npz: unsupported container {type(obj).__name__}")


def load_npz(path: str, device=None):
    """Load a container written by :func:`save_npz` or ``innr_tpu.io.save_npz``
    onto ``device`` (default :func:`innr_tpu_torch.config.default_device`,
    the card). bf16 rows, packed words, slots and sparse indices keep their
    exact bits."""
    with np.load(path) as z:
        kind = str(z["kind"])
        if kind == "VerticalBatch":
            if "rows_bf16" in z:
                bits = torch.from_numpy(np.ascontiguousarray(z["rows_bf16"]))
                return VerticalBatch(bits.view(torch.bfloat16), dtype=torch.bfloat16,
                                     device=host_device(device))
            return VerticalBatch.from_numpy(z["rows"], device=device)
        if kind == "QuantizedU8Batch":
            return QuantizedU8Batch.from_numpy(z["codes"], device=device)
        if kind in ("PackedBinary", "PackedBinaryBatch"):
            cls = PackedBinary if kind == "PackedBinary" else PackedBinaryBatch
            return cls.from_numpy(z["words"], int(z["dimension"]), device=device)
        if kind in ("PackedTernary", "PackedTernaryBatch"):
            cls = PackedTernary if kind == "PackedTernary" else PackedTernaryBatch
            return cls.from_numpy(z["pos"], z["neg"], int(z["dimension"]), device=device)
        if kind == "SketchCorpus":
            return SketchCorpus(z["sketches"], device=device)
        if kind == "SparseCorpus":
            return SparseCorpus((z["indices"], z["values"]), device=device)
        if kind == "SegmentedCorpus":
            sc = SegmentedCorpus(int(z["dimension"]), device=host_device(device))
            ids = np.asarray(z["ids"], dtype=np.int64)
            if len(ids):
                sc._segments.append(_Segment(as_tensor(z["rows"], torch.float32, sc.device),
                                             ids))
            sc._next_id = int(z["next_id"])
            return sc
        raise ContractError(f"load_npz: unknown container kind {kind!r}")
