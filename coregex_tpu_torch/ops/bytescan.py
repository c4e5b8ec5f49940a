"""Byte-scan helpers; ports ``_bucket`` (:20), ``mask_count`` (:28),
``_memmem_mask`` (:164), ``table_to_ranges`` (:314),
``_class_mask_from_table`` (:330) and ``_range_mask`` (:337) of
``coregex_tpu/ops/bytescan.py``."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _bucket(x: int, lo: int = 16) -> int:
    """Smallest power-of-two multiple of `lo` that is >= x (cap sizing)."""
    b = lo
    while b < x:
        b *= 2
    return b


def mask_count(mask: torch.Tensor) -> torch.Tensor:
    """Set entries of a mask, as a 0-dim int32 tensor on its device."""
    return mask.sum(dtype=torch.int32)


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


def table_to_ranges(table) -> Tuple[Tuple[int, int], ...]:
    """256-entry membership table -> inclusive byte ranges."""
    ranges = []
    b = 0
    while b < 256:
        if table[b]:
            e = b
            while e + 1 < 256 and table[e + 1]:
                e += 1
            ranges.append((b, e))
            b = e + 1
        else:
            b += 1
    return tuple(ranges)


def _range_mask(data: torch.Tensor, ranges) -> torch.Tensor:
    """[n] bool: the byte lies in one of the inclusive `ranges`."""
    acc = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    for lo, hi in ranges:
        if lo == hi:
            acc |= data == lo
        else:
            acc |= (data >= lo) & (data <= hi)
    return acc


def _class_mask_from_table(data: torch.Tensor, table: np.ndarray):
    """Membership via range compares: the 256-entry table is decomposed
    into its byte ranges on the host."""
    return _range_mask(data, table_to_ranges(table))
