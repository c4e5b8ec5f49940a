"""Byte-scan helpers; ports ``_bucket`` (:20) and ``_memmem_mask`` (:164)
of ``coregex_tpu/ops/bytescan.py``."""

from __future__ import annotations

from typing import Sequence

import torch


def _bucket(x: int, lo: int = 16) -> int:
    """Smallest power-of-two multiple of `lo` that is >= x (cap sizing)."""
    b = lo
    while b < x:
        b *= 2
    return b


def _memmem_mask(data: torch.Tensor, needle: Sequence[int]) -> torch.Tensor:
    """[n] bool: `needle` starts at the position (shifted compares ANDed;
    starts that would run off the end are False)."""
    n = int(data.shape[0])
    k = len(needle)
    acc = torch.zeros(n, dtype=torch.bool, device=data.device)
    if k > n:
        return acc
    m = n - k + 1
    acc[:m] = data[:m] == needle[0]
    for i in range(1, k):
        acc[:m] &= data[i:i + m] == needle[i]
    return acc
