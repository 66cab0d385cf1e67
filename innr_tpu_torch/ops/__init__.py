"""Quantized similarity ops: :mod:`innr_tpu_torch.ops.scalar` (uint8)."""
