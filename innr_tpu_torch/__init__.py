"""innr_tpu_torch — the PyTorch / CUDA port of innr_tpu, for NVIDIA Hopper.

The JAX package ``innr_tpu`` is the reference; this package mirrors its
module names. Ported so far:

- the batch-kNN main path — :class:`VerticalBatch` and ``batch_knn`` /
  ``batch_knn_dot`` / ``batch_knn_cosine`` / ``batch_knn_filtered`` — and
  the uint8 scalar-quantized kNN, on the fused streaming score + top-k scan
  (``csrc/knn.cu``);
- the packed binary and ternary families and the integer primitives of
  ``ops/quant.py``, on the packed kNN scan (``csrc/packed_knn.cu``) and the
  per-row packed scores (``csrc/packed.cu``);
- :class:`TwoStageIndex`, the coarse-then-rerank pipeline, on both scans;
- npz persistence for those containers;
- tile-skip pruning (``prune=True``, ``batch_knn_adaptive``,
  ``batch_l2_squared_pruning``; :mod:`innr_tpu_torch.prune`), the k-means
  layout passes (``cluster_order``, ``cluster_reorder``) and
  :class:`IVFIndex`, on the pruned tile scan (``csrc/knn.cu``), the
  threshold scan (``csrc/pruned.cu``) and the nearest-centroid pass
  (``csrc/assign.cu``);
- MinHash / b-bit slot sketches (:class:`SketchCorpus`, ``slot_knn_u16``,
  ``slot_knn_u32``, ``minhash_knn`` and their ``_batch`` forms, the
  pairwise slot ops) on the slot scan (``csrc/slot_knn.cu``);
- learned-sparse retrieval (:class:`SparseCorpus`, ``sparse_knn``,
  ``sparse_knn_batch``) on the sparse scan (``csrc/sparse_knn.cu``), the
  sparse MaxSim functions and :mod:`innr_tpu_torch.ops.sparse_ext` (plain
  torch, as in the JAX package);
- ColBERT MaxSim late interaction (``maxsim``, ``maxsim_cosine``,
  ``batch_maxsim``) and MaxSim retrieval (``maxsim_knn``,
  ``maxsim_knn_batch``) on the MaxSim scan (``csrc/maxsim.cu``);
- the mutable serving path: :class:`SegmentedCorpus` (adds, deletes with
  permanent ids, compaction; one K1 scan per segment and a device-side
  merge) and :class:`MicroBatcher` (concurrent single-query callers
  coalesced into one batched search per window), and the host ingest
  encoders of :mod:`~innr_tpu_torch.loader` on the native C runtime;
- the pair ops, plain torch as in the JAX package: dense f32
  (:mod:`~innr_tpu_torch.ops.dense`), float64
  (:mod:`~innr_tpu_torch.ops.dense_f64`), the bit-hack rsqrt
  (:mod:`~innr_tpu_torch.ops.fast_math`), the host :class:`TopK` tracker,
  the :mod:`~innr_tpu_torch.distance` metrics and the backend report.

Corpora on a CUDA device run the hand-written kernels; corpora on the CPU
run their plain PyTorch versions. Host data (numpy, lists, JAX arrays)
given without a ``device`` goes to :func:`config.default_device`, the
card, and raises without one; pass ``device="cpu"`` or
``config.set_default_device("cpu")`` to run on the CPU.

Contracts: dispatching functions raise :class:`ContractError` on shape
mismatch; cosine returns 0.0 for effectively-zero norms (< 1e-9); orderings
follow IEEE total order with ties to the lowest index.
"""

from innr_tpu_torch import (
    backend,
    batch,
    config,
    distance,
    io,
    loader,
    parallel,
    pipeline,
    prune,
    serving,
)
from innr_tpu_torch.distance import (
    Distance,
    DistCosine,
    DistDot,
    DistHamming,
    DistL1,
    DistL2,
    DistSlotU32,
)
from innr_tpu_torch.pipeline import CoarseConfig, TwoStageIndex
from innr_tpu_torch.serving import MicroBatcher
from innr_tpu_torch.segmented import SegmentedCorpus
from innr_tpu_torch.ivf import IVFIndex
from innr_tpu_torch.prune import (
    TileSummary,
    build_tile_summary,
    cluster_order,
    cluster_reorder,
    suggest_tile_n,
)
from innr_tpu_torch.batch import (
    BatchKnnResult,
    VerticalBatch,
    batch_cosine,
    batch_cosine_into,
    batch_dimension_variance,
    batch_dot,
    batch_dot_into,
    batch_knn,
    batch_knn_adaptive,
    batch_knn_cosine,
    batch_knn_dot,
    batch_knn_filtered,
    batch_knn_reordered,
    batch_l2_squared,
    batch_l2_squared_into,
    batch_l2_squared_pruning,
    batch_norms,
    batch_norms_into,
)
from innr_tpu_torch.ops.binary import (
    PackedBinary,
    PackedBinaryBatch,
    batch_binary_hamming,
    binary_dot,
    binary_hamming,
    binary_jaccard,
    binary_knn,
    encode_binary,
    encode_binary_batch,
)
from innr_tpu_torch.ops.dense import (
    angular_distance,
    cosine,
    dot,
    l1_distance,
    l2_distance,
    l2_distance_squared,
    matryoshka_cosine,
    matryoshka_dot,
    norm,
    normalize,
    normalize_with_norm,
)
from innr_tpu_torch.ops.dense_f64 import (
    cosine_f64,
    dot_f64,
    l1_distance_f64,
    l2_distance_f64,
    l2_distance_squared_f64,
    norm_f64,
    normalize_f64,
)
from innr_tpu_torch.ops.fast_math import (
    fast_cosine,
    fast_cosine_dispatch,
    fast_rsqrt,
    fast_rsqrt_precise,
)
from innr_tpu_torch.ops.maxsim import (
    batch_maxsim,
    maxsim,
    maxsim_cosine,
    maxsim_knn,
    maxsim_knn_batch,
)
from innr_tpu_torch.ops.quant import batch_dot_u8, batch_hamming, dot_u8, hamming_distance
from innr_tpu_torch.ops.scalar import (
    QuantizationParams,
    QuantizedU8,
    QuantizedU8Batch,
    QueryContext,
    asymmetric_dot_u8,
    asymmetric_dot_u8_precomputed,
    batch_knn_u8,
    batch_knn_u8_multi,
    mixed_dot_u8_f32,
    quantize_u8,
    query_context,
)
from innr_tpu_torch.ops.slot import (
    SketchCorpus,
    SlotCounts,
    batch_slot_hamming_u32,
    jaccard_distance,
    minhash_jaccard,
    minhash_knn,
    minhash_knn_batch,
    slot_compare_counts,
    slot_hamming,
    slot_hamming_u16,
    slot_hamming_u32,
    slot_hamming_u64,
    slot_knn_u16,
    slot_knn_u16_batch,
    slot_knn_u32,
    slot_knn_u32_batch,
)
from innr_tpu_torch.ops.sparse import (
    SparseCorpus,
    pad_sparse,
    pad_sparse_docs,
    sparse_dot,
    sparse_knn,
    sparse_knn_batch,
    sparse_maxsim,
    sparse_maxsim_batch,
    sparse_maxsim_knn,
)
from innr_tpu_torch.ops.ternary import (
    PackedTernary,
    PackedTernaryBatch,
    asymmetric_dot,
    batch_asymmetric_dot,
    batch_ternary_dot,
    encode_ternary,
    encode_ternary_batch,
    sparsity,
    ternary_dot,
    ternary_hamming,
    ternary_knn,
)
from innr_tpu_torch.ops.topk import TopK
from innr_tpu_torch.utils.asserts import ContractError

__version__ = "0.1.0"
