"""Kernel-selection introspection: which execution path will run.

The counterpart of :mod:`innr_tpu.backend`. Display strings are stable:
they appear in logs and bug reports, so renaming one is a breaking change.
"""

from __future__ import annotations

import enum

import torch

from innr_tpu_torch import config

__all__ = ["Backend", "dense_backend", "batch_backend", "slot_backend"]


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


def dense_backend(length: int) -> Backend:
    """Path the single-pair dense f32 ops take for ``length``-dim vectors:
    plain PyTorch on the inputs' device at every length (the JAX package's
    single pairs are XLA reductions; neither package has a kernel for them)."""
    del length
    return Backend.REFERENCE if config.reference_forced() else Backend.TORCH


def slot_backend(length: int) -> Backend:
    """Path the pairwise slot-Hamming ops take for ``length``-slot sketches:
    plain PyTorch, as for :func:`dense_backend`."""
    return dense_backend(length)


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
