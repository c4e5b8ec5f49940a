"""Byte-scan helpers; ports ``_bucket`` (:20), ``mask_count`` (:28),
``first_set_index`` (:122-130), ``first_run_geq`` (:133-150),
``_memmem_mask`` (:164), ``literal_self_overlaps`` (:208-215),
``_multi_literal_scan`` (:218-238),
``table_to_ranges`` (:314), ``_class_mask_from_table`` (:330) and
``_range_mask`` (:337) of ``coregex_tpu/ops/bytescan.py``, and two
functions of ``coregex_tpu/meta/batch.py``: the PREFIX_RUN candidate mask
and count (``_prefix_run_cand_kernel_factory``, :229-249, one jit there,
torch ops in one pass here) as ``prefix_run_candidates``, and
``_bulk_count_kernel`` (:168-189) as ``bulk_count``.
``last_set_index`` and ``piece_cuts`` have no counterpart; the second cuts
a result past the span limit into pieces that one compaction each can
hold."""

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


def piece_cuts(counts: np.ndarray, limit: int, take: int = -1):
    """Consecutive blocks with `counts` entries each, cut greedily into
    pieces of at most `limit` entries: [(first block, end block, entries)],
    in order, covering the blocks up to the one where the running total
    reaches `take` (all of them when take < 0).  A block that alone holds
    more than `limit` entries is a piece of its own (callers choose blocks
    that cannot, or accept that)."""
    cum = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
    nb = len(counts)
    if take >= 0:
        nb = min(nb, int(np.searchsorted(cum, take, side="left")))
    out = []
    i = 0
    while i < nb:
        j = int(np.searchsorted(cum, cum[i] + limit, side="right")) - 1
        j = min(max(j, i + 1), nb)
        out.append((i, j, int(cum[j] - cum[i])))
        i = j
    return out


def mask_count(mask: torch.Tensor) -> torch.Tensor:
    """Set entries of a mask, as a 0-dim int32 tensor on its device."""
    return mask.sum(dtype=torch.int32)


def first_set_index(mask: torch.Tensor) -> int:
    """Index of the first set entry of a 1-D bool mask, or its length when
    none is set (one sync)."""
    n = int(mask.shape[0])
    if n == 0:
        return 0
    m = mask.view(torch.uint8)
    i = torch.argmax(m)          # the first maximal entry
    return int(torch.where(m[i] != 0, i, n))


def last_set_index(mask: torch.Tensor, chunk: int = 1 << 24) -> int:
    """Index of the last set entry of a 1-D bool mask, or -1 when none is
    set: chunks of `chunk` entries from the end, one sync each, so a late
    entry costs one chunk's flip, not the mask's."""
    n = int(mask.shape[0])
    for hi in range(n, 0, -chunk):
        lo = max(0, hi - chunk)
        j = first_set_index(mask[lo:hi].flip(0))
        if j < hi - lo:
            return hi - 1 - j
    return -1


def _window_all(mask: torch.Tensor, m: int) -> torch.Tensor:
    """[n] bool: mask[p-m+1 .. p] are all set (False for p < m-1), by
    doubling: windows of w combine into 2w, and two windows of w >= m/2
    overlap into m."""
    acc, w = mask, 1
    while 2 * w <= m:
        nxt = torch.zeros_like(acc)
        nxt[w:] = acc[w:] & acc[:-w]
        acc, w = nxt, 2 * w
    if w < m:
        nxt = torch.zeros_like(acc)
        d = m - w
        nxt[d:] = acc[d:] & acc[:-d]
        acc = nxt
    return acc


def first_run_geq(mask: torch.Tensor, m: int) -> Tuple[int, int]:
    """(start, length) of the first maximal run of set entries with length
    >= m; start == len(mask) when none exists.  The reference takes each
    run's length from a whole-mask cummax of run starts; here the first
    position p where the m entries ending at p are all set lies in the
    first qualifying run, at its start + m - 1, and the run ends at the
    first unset entry after p: bool passes only, no int32 arrays (two
    syncs)."""
    n = int(mask.shape[0])
    p = first_set_index(_window_all(mask, max(m, 1)))
    if p >= n:
        return n, 0
    s = p - max(m, 1) + 1
    e = p + first_set_index(~mask[p:])
    return s, e - s


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


def literal_self_overlaps(lit: bytes) -> bool:
    """True iff the literal has a proper border (can overlap itself), in
    which case its occurrence count differs from its match count."""
    k = len(lit)
    return any(lit[:w] == lit[k - w:] for w in range(1, k))


def _multi_literal_scan(data: torch.Tensor, lits: Sequence[bytes]):
    """Per position: the index of the first literal (in priority order)
    that starts there, or -1, and its length (0 where none): the
    leftmost-first priority of an alternation of literals.  Literals are
    applied in reverse priority so earlier ones overwrite."""
    n = int(data.shape[0])
    best = torch.full((n,), -1, dtype=torch.int32, device=data.device)
    blen = torch.zeros(n, dtype=torch.int32, device=data.device)
    for li in range(len(lits) - 1, -1, -1):
        hit = _memmem_mask(data, lits[li])
        best.masked_fill_(hit, li)
        blen.masked_fill_(hit, len(lits[li]))
    return best, blen


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


def prefix_run_candidates(data: torch.Tensor, cls_ranges, sieve):
    """(mask [n] bool, count 0-dim int32) of a PREFIX_RUN plan's candidate
    starts: the first byte of each maximal run of the leading class,
    sharpened by the offset byte-range sieve (``ops/sieve.py``; no sieve
    when it is empty)."""
    from .sieve import sieve_mask
    mask = _range_mask(data, cls_ranges)
    smask = mask.clone()
    smask[1:] &= ~mask[:-1]
    if sieve:
        smask &= sieve_mask(data, sieve)
    return smask, mask_count(smask)


def bulk_count(starts, ends, data, class_tbl, n: int):
    """(count, overlap, pending) as 0-dim device tensors: the matches of
    PREFIX_RUN candidates `starts` (ascending) with their anchored ends
    (-1: no match).  overlap: Go's selection would drop a candidate (a
    start before a previous end); pending: a match ends inside a class run,
    where a restart could begin a match that is not a candidate.
    `class_tbl` is the class's [256] bool table on the device."""
    from .span_chain import cummax_fast
    valid = ends >= 0
    e = torch.where(valid, ends, -1).to(torch.int32)
    prevmax = torch.cat([e.new_full((1,), -1), cummax_fast(e, -1)[:-1]])
    overlap = (valid & (starts < prevmax)).any()
    if n < 2:
        in_cls = torch.zeros_like(valid)
    else:
        ei = e.clamp(1, n - 1).long()
        in_cls = (class_tbl[data[ei].long()]
                  & class_tbl[data[ei - 1].long()])
    pending = (valid & (e > 0) & (e < n) & in_cls).any()
    return valid.sum(dtype=torch.int32), overlap, pending
