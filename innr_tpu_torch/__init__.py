"""innr_tpu_torch — the PyTorch / CUDA port of innr_tpu, for NVIDIA Hopper.

The JAX package ``innr_tpu`` is the reference; this package mirrors its
module names. Ported so far: the batch-kNN main path — :class:`VerticalBatch`
and ``batch_knn`` / ``batch_knn_dot`` / ``batch_knn_cosine`` /
``batch_knn_filtered``, the uint8 scalar-quantized kNN, npz persistence for
those containers — over one hand-written CUDA kernel, the fused streaming
score + top-k scan (``csrc/knn.cu``). Corpora on a CUDA device run the
kernel; corpora on the CPU run its plain PyTorch version.

Contracts: dispatching functions raise :class:`ContractError` on shape
mismatch; cosine returns 0.0 for effectively-zero norms (< 1e-9); orderings
follow IEEE total order with ties to the lowest index.
"""

from innr_tpu_torch import backend, batch, config, io
from innr_tpu_torch.batch import (
    BatchKnnResult,
    VerticalBatch,
    batch_cosine,
    batch_cosine_into,
    batch_dimension_variance,
    batch_dot,
    batch_dot_into,
    batch_knn,
    batch_knn_cosine,
    batch_knn_dot,
    batch_knn_filtered,
    batch_l2_squared,
    batch_l2_squared_into,
    batch_norms,
    batch_norms_into,
)
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
from innr_tpu_torch.utils.asserts import ContractError

__version__ = "0.1.0"
