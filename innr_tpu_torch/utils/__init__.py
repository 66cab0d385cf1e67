"""Shared helpers: contract errors, total-order keys, padding."""
