"""Contract checks.

The counterpart of :mod:`innr_tpu.utils.asserts`: a dispatching function
raises :class:`ContractError` (a ``ValueError``) on input that violates its
documented contract, with a message that names the op.
"""

from __future__ import annotations


class ContractError(ValueError):
    """Raised when an input violates a documented API contract."""


def check_same_length(a, b, op: str) -> None:
    """Raise unless the trailing dimensions of ``a`` and ``b`` match (the
    reference's length-mismatch panic, ``src/dense.rs:56-63``)."""
    if a.shape[-1] != b.shape[-1]:
        raise ContractError(
            f"innr_tpu_torch::{op}: length mismatch ({a.shape[-1]} vs {b.shape[-1]})"
        )
