"""Offset byte-range sieve: a candidate prefilter derived from the DFA.

Ports ``coregex_tpu/ops/sieve.py``: ``offset_byte_ranges`` (:25, host numpy)
and ``sieve_mask`` (:71, torch ops).  From the anchored DFA, the set of bytes
that can appear j bytes into a match, for each offset j < depth; a candidate
start must pass every offset's condition.  On the device that is a few
shifted range compares, whatever the pattern.

depth stops before an offset at which a match could already have ended, so
no true match start is sieved away.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..dfa.dense import DEAD, DenseDFA
from .bytescan import _range_mask

Ranges = Tuple[Tuple[int, int], ...]


def offset_byte_ranges(dfa: DenseDFA, depth: int = 8,
                       max_ranges: int = 8) -> List[Ranges]:
    """The allowed byte ranges at each offset, from the anchored DFA
    (host).  Stops early where an offset admits every byte (no
    selectivity), where it needs more than max_ranges ranges, or where a
    match could already have ended (shorter matches must not be sieved
    away)."""
    S, C = dfa.delta.shape
    cur = set(int(s) for s in dfa.starts if s != DEAD)
    out: List[Ranges] = []
    for _ in range(depth):
        if not cur:
            break
        if any(dfa.match_on[s].any() or dfa.match_eoi[s].any()
               for s in cur):
            break
        allowed_cls = set()
        nxt = set()
        for s in cur:
            for c in range(C):
                t = int(dfa.delta[s, c])
                if t != DEAD:
                    allowed_cls.add(c)
                    nxt.add(t)
        allowed_bytes = np.isin(dfa.classes, list(allowed_cls))
        if allowed_bytes.all():
            break
        ranges: List[Tuple[int, int]] = []
        b = 0
        while b < 256:
            if allowed_bytes[b]:
                e = b
                while e + 1 < 256 and allowed_bytes[e + 1]:
                    e += 1
                ranges.append((b, e))
                b = e + 2
            else:
                b += 1
        if len(ranges) > max_ranges:
            break
        out.append(tuple(ranges))
        cur = nxt
    return out


def sieve_mask(data: torch.Tensor, per_offset: Sequence[Ranges]):
    """[n] bool mask of the positions that pass every offset's condition;
    positions within depth of the end fail (a match needs at least depth
    bytes).  The reference rolls each offset's mask, wrapping its head
    round to the tail, which the last condition masks off; here the shift
    pads with False."""
    n = int(data.shape[0])
    depth = len(per_offset)
    acc = torch.ones(n, dtype=torch.bool, device=data.device)
    for j, ranges in enumerate(per_offset):
        m = _range_mask(data, tuple(ranges))
        if j == 0:
            acc &= m
        elif j < n:
            acc[:n - j] &= m[j:]
    if depth:
        acc[max(0, n - depth + 1):] = False
    return acc
