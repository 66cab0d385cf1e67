"""Kernel-selection introspection: which execution path will run.

The counterpart of :mod:`innr_tpu.backend`. Display strings are stable:
they appear in logs and bug reports, so renaming one is a breaking change.
"""

from __future__ import annotations

import enum

import torch

from innr_tpu_torch import config

__all__ = ["Backend", "batch_backend"]


class Backend(enum.Enum):
    """An execution path the dispatchers can select."""

    # Hand-written CUDA kernel (csrc/), for tensors on a CUDA device.
    CUDA = "cuda"
    # The kernel's plain PyTorch version, for tensors on the CPU.
    TORCH = "torch"
    # Plain versions forced by config.force_reference, on any device.
    REFERENCE = "reference"

    def __str__(self) -> str:
        return self.value


def batch_backend(num_rows: int, device) -> Backend:
    """Path the batch kNN scans take for a ``num_rows``-row corpus on
    ``device``. The path depends on the device alone: this package has no
    size gate yet, so ``num_rows`` does not change it."""
    if config.reference_forced():
        return Backend.REFERENCE
    kind = torch.device(device).type
    if kind == "cuda":
        return Backend.CUDA
    if kind == "cpu":
        return Backend.TORCH
    raise ValueError(f"batch_backend: unsupported device {device!r}")
