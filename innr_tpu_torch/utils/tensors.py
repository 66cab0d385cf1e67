"""Tensor conversion for the public functions' inputs."""

from __future__ import annotations

import numpy as np
import torch


def as_tensor(values, dtype, device=None) -> torch.Tensor:
    """``values`` as a ``dtype`` tensor: a tensor stays on its device unless
    ``device`` is given; host data (numpy, sequences, JAX arrays) goes to
    ``device``, default the CPU."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device if device is not None else values.device, dtype=dtype)
    return torch.as_tensor(np.asarray(values), device=device or "cpu").to(dtype)
