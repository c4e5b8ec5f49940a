"""Byte-scan helpers; ports ``_bucket`` of ``coregex_tpu/ops/bytescan.py``
(:20) only."""

from __future__ import annotations


def _bucket(x: int, lo: int = 16) -> int:
    """Smallest power-of-two multiple of `lo` that is >= x (cap sizing)."""
    b = lo
    while b < x:
        b *= 2
    return b
