"""Process-wide configuration for innr_tpu_torch.

The counterpart of :mod:`innr_tpu.config`. ``INNR_TPU_FORCE_REFERENCE=1``
(the same variable the JAX package reads) forces the plain PyTorch versions
of the kernels at import time; :func:`force_reference` toggles it at run
time. Without it, a CUDA tensor always goes to the hand-written kernel and a
CPU tensor to the plain version: there is no size gate in this package yet
(whether one pays on the GPU is an open, to-be-measured question).

Default device: host data (numpy arrays, sequences, JAX arrays) given to a
constructor or loader without a ``device`` goes to :func:`default_device`,
the CUDA card, as the JAX package puts host arrays on its accelerator.
Without a card that raises; a caller reaches the CPU only by asking for it
(``device="cpu"``, or :func:`set_default_device`). A tensor the caller
passes keeps its device.

Matmul precision: "highest" (the default) means true fp32. It sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and float32 matmul
precision "highest", so the plain version's ``torch.matmul`` on the card
does not round its inputs to TF32. "default" allows TF32 in those matmuls.
The CUDA kernel always multiplies in fp32 FMA, whatever this says.
"""

from __future__ import annotations

import os

import torch

_FORCE_REFERENCE: bool = os.environ.get("INNR_TPU_FORCE_REFERENCE", "0") == "1"

# Threshold for treating an L2 norm as "effectively zero".
NORM_EPSILON: float = 1e-9
NORM_EPSILON_SQ: float = NORM_EPSILON * NORM_EPSILON

# Relative slack on the tile-pruning dead-tile comparisons
# (innr_tpu_torch/prune.py): the planner's triangle bounds and the scan's
# norms^2 - 2 q.r scores are different f32 expansions, so a tile is dead
# only when its optimistic bound fails the threshold by more than this
# times a magnitude scale. The JAX package's value.
PRUNE_BOUND_EPS: float = 1e-4

# The JAX package's router threshold, kept for API parity: the pruned scan
# here always reads the plan as it stands, so the value has no effect
# (innr_tpu_torch/kernels/pruned_knn.py says why).
_PRUNE_ROUTE_MIN_ELIDE: float = 0.10

_MATMUL_PRECISION: str = "highest"

_DEFAULT_DEVICE: torch.device = torch.device("cuda")


def default_device() -> torch.device:
    """Where host data goes when no ``device`` is given (the CUDA card
    unless :func:`set_default_device` said otherwise)."""
    return _DEFAULT_DEVICE


def set_default_device(device) -> torch.device:
    """Set the default device for host data; returns the previous one, so
    that a caller (a context manager, a test fixture) can restore it."""
    global _DEFAULT_DEVICE
    previous, _DEFAULT_DEVICE = _DEFAULT_DEVICE, torch.device(device)
    return previous


def set_prune_route_min_elide(fraction: float) -> None:
    """Set the JAX package's routing threshold, validated as there; no
    effect on this package's pruned scan."""
    global _PRUNE_ROUTE_MIN_ELIDE
    f = float(fraction)
    if not 0.0 <= f <= 1.0:
        raise ValueError("prune route threshold must be in [0, 1]")
    _PRUNE_ROUTE_MIN_ELIDE = f


def prune_route_min_elide() -> float:
    """Current routing threshold (fraction of tiles that must be elided)."""
    return _PRUNE_ROUTE_MIN_ELIDE


def set_matmul_precision(precision: str) -> None:
    """Set score-matmul precision: "highest" (true fp32) or "default"
    (TF32 allowed). Sets PyTorch's process-wide matmul flags."""
    global _MATMUL_PRECISION
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown matmul precision {precision!r}")
    _MATMUL_PRECISION = precision
    tf32 = precision == "default"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def matmul_precision() -> str:
    """The current score-matmul precision name."""
    return _MATMUL_PRECISION


def force_reference(enabled: bool = True) -> None:
    """Force (or unforce) the plain PyTorch versions for every op."""
    global _FORCE_REFERENCE
    _FORCE_REFERENCE = bool(enabled)


def reference_forced() -> bool:
    """True when the plain versions are forced."""
    return _FORCE_REFERENCE


set_matmul_precision(os.environ.get("INNR_TPU_MATMUL_PRECISION", "highest"))
