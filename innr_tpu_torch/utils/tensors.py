"""Tensor conversion for the public functions' inputs and results."""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch import config


def host_device(device=None) -> torch.device:
    """The device host data goes to: ``device`` when given, else
    :func:`innr_tpu_torch.config.default_device` (the card). A CUDA device
    without a card raises here, before anything is copied; nothing falls
    back to the CPU."""
    dev = torch.device(device) if device is not None else config.default_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"innr_tpu_torch: host data goes to {dev}, but no CUDA device is "
            "available; pass device='cpu' or call "
            "innr_tpu_torch.config.set_default_device('cpu') to run on the CPU"
        )
    return dev


def as_tensor(values, dtype, device=None) -> torch.Tensor:
    """``values`` as a ``dtype`` tensor: a tensor stays on its device unless
    ``device`` is given; host data (numpy, sequences, JAX arrays) goes to
    :func:`host_device` (``device``, else the default device, the card)."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device if device is not None else values.device, dtype=dtype)
    return torch.as_tensor(np.asarray(values), device=host_device(device)).to(dtype)


def empty_topk(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """An empty top-k result of ``shape``: float32 scores, int32 indices."""
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device))


def to_host(scores, ids) -> tuple[np.ndarray, np.ndarray]:
    """A top-k result on the host: float32 ``scores`` and integer ``ids``
    of one shape on one device -> numpy ``float32`` scores and ``int64``
    ids, by one device-to-host copy of the pair stacked as integers (the
    scores' bits, so NaN payloads and -0.0 survive): int32 beside int32
    ids, or both widened to int64 when the ids are int64. The rest is
    numpy, which keeps the interpreter lock."""
    bits = scores.view(torch.int32)
    if ids.dtype == torch.int64:
        pair = torch.stack([bits.to(torch.int64), ids]).cpu().numpy()
        return pair[0].astype(np.int32).view(np.float32), pair[1]
    pair = torch.stack([bits, ids]).cpu().numpy()
    return pair[0].view(np.float32), pair[1].astype(np.int64)
