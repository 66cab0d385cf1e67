"""Process-wide configuration for innr_tpu_torch.

The counterpart of :mod:`innr_tpu.config`. ``INNR_TPU_FORCE_REFERENCE=1``
(the same variable the JAX package reads) forces the plain PyTorch versions
of the kernels at import time; :func:`force_reference` toggles it at run
time. Without it, a CUDA tensor always goes to the hand-written kernel and a
CPU tensor to the plain version: there is no size gate in this package yet
(whether one pays on the GPU is an open, to-be-measured question).

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

_MATMUL_PRECISION: str = "highest"


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
