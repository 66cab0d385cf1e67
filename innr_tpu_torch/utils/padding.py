"""Padding helpers."""

from __future__ import annotations


def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``x``."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return ((x + multiple - 1) // multiple) * multiple
