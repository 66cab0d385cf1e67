"""Contract checks.

The counterpart of :mod:`innr_tpu.utils.asserts`: a dispatching function
raises :class:`ContractError` (a ``ValueError``) on input that violates its
documented contract, with a message that names the op.
"""

from __future__ import annotations


class ContractError(ValueError):
    """Raised when an input violates a documented API contract."""
