"""Distribution layer: sharded corpora and the cross-shard top-k merge.

The counterpart of :mod:`innr_tpu.parallel`. One process drives every
device of a :class:`~innr_tpu_torch.parallel.sharded.Mesh` (a tuple of
``torch.device``s, which may repeat one card): a container holds one
tensor per shard on its device, each shard runs the port's kernel for its
family on its own device (no host synchronisation between shards), and the
per-shard (raw key, global index) candidates merge on the mesh's first
device by one ``torch.topk`` over int64 composites, bit for bit a
single-device scan of the concatenated corpus. Processes appear only in
:mod:`~innr_tpu_torch.parallel.multihost`, on ``torch.distributed``.

Every family is covered: f32 / bf16 dot, L2, cosine and filtered
(:class:`ShardedCorpus`, with ``prune=True`` on per-shard tile summaries),
1-bit Hamming (:class:`ShardedPackedBinary`), ternary
(:class:`ShardedPackedTernary`), asymmetric u8 (:class:`ShardedQuantizedU8`),
slot sketches / MinHash (:class:`ShardedSlotCorpus`), sparse and sparse
MaxSim (:class:`ShardedSparseCorpus`, :class:`ShardedSparseMaxSimCorpus`),
MaxSim (:class:`ShardedMaxSimCorpus`), the two-stage pipeline
(:class:`ShardedTwoStageIndex`), and the mesh layouts
:class:`QueryParallelIndex`, :class:`GridIndex` and
:class:`HierarchicalCorpus`.
"""

from innr_tpu_torch.parallel import multihost  # noqa: F401
from innr_tpu_torch.parallel.grid import GridIndex, grid_mesh
from innr_tpu_torch.parallel.hierarchical import (  # noqa: F401
    HierarchicalCorpus,
    hierarchical_mesh,
)
from innr_tpu_torch.parallel.query_parallel import QueryParallelIndex
from innr_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    ShardedCorpus,
    default_mesh,
    sharded_knn_cosine,
    sharded_knn_dot,
    sharded_knn_filtered,
    sharded_knn_l2,
)
from innr_tpu_torch.parallel.sharded_maxsim import ShardedMaxSimCorpus
from innr_tpu_torch.parallel.sharded_packed import ShardedPackedBinary, ShardedPackedTernary
from innr_tpu_torch.parallel.sharded_pipeline import ShardedTwoStageIndex
from innr_tpu_torch.parallel.sharded_quant import ShardedQuantizedU8
from innr_tpu_torch.parallel.sharded_slot import ShardedSlotCorpus
from innr_tpu_torch.parallel.sharded_sparse import ShardedSparseCorpus, ShardedSparseMaxSimCorpus

__all__ = [
    "GridIndex",
    "QueryParallelIndex",
    "ShardedCorpus",
    "ShardedPackedBinary",
    "ShardedPackedTernary",
    "ShardedQuantizedU8",
    "ShardedSlotCorpus",
    "ShardedSparseCorpus",
    "ShardedSparseMaxSimCorpus",
    "ShardedMaxSimCorpus",
    "ShardedTwoStageIndex",
    "default_mesh",
    "grid_mesh",
    "sharded_knn_cosine",
    "sharded_knn_dot",
    "sharded_knn_filtered",
    "sharded_knn_l2",
]
