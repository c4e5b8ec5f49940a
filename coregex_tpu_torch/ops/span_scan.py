"""Forward span-event scan: the count scan emitting flag-word streams (K2).

Ports ``coregex_tpu/ops/span_scan.py``: ``DeviceSpanDFA`` (:50-101) as
``DeviceSpanDFA.from_host``, ``_span_full`` (:252-387) as host-driven torch
code, and ``SpanScanner.scan``.  The packed value is
delta*32 + (commits<<2 | first<<1 | flag); the lane walk sums the commits
and packs bit 0 (a candidate match end) and bit 1 (a group's first flag)
into two int32 word streams, 32 positions per word.  The EOI commit and
kind resolve after the scan at the final state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..dfa.countdfa import CountDFA
from ..dfa.dense import CTX_SOT
from .count_scan import (MODE_SPAN, SUB_PASSES, DeviceCountDFA,
                         LaunchCounter, device_table, first_pass_inputs,
                         lane_split, make_word_tiles, plan_geometry, settled,
                         split_fixpoint, state_at_end)

SPAN_KERNEL = LaunchCounter("span_scan")

# LOW_MASK[k] = int32 with bits 0..k-1 set (k = 0..32; 32 -> all ones)
LOW_MASK = ((np.int64(1) << np.arange(33, dtype=np.int64)) - 1).astype(
    np.uint32).view(np.int32)


class DeviceSpanDFA(DeviceCountDFA):
    """Span-event tables on a torch device (ref. DeviceSpanDFA): the
    DeviceCountDFA layout with the event bits in the packed value, plus
    the EOI kind table."""

    @classmethod
    def from_host(cls, cd: CountDFA, device) -> "DeviceSpanDFA":
        if not cd.spans_simple or cd.flag_on is None:
            raise ValueError("span scan requires spans_simple tables")
        emit5 = (cd.flag_on.astype(np.int32)
                 | (cd.first_on.astype(np.int32) << 1)
                 | (cd.emit.astype(np.int32) << 2))
        packed, segmap = cls.segment_tables(cd, emit5)
        d = cls(packed, segmap, cd.starts, cd.eoi_commits, device)
        d.eoi_kind = device_table(cd.eoi_kind, d.device)
        return d


def to_global(words, n: int):
    """Time-major [T4/8, L] words -> position-major [L*T4/8] (lane l's
    words are contiguous, word j covers positions 32j..32j+31), bits at
    positions >= n cleared (ref. _span_full.to_global)."""
    wg = words.t().reshape(-1)
    base = torch.arange(wg.shape[0], dtype=torch.int64,
                        device=wg.device) * 32
    bits = (n - base).clamp(0, 32)
    return wg & torch.as_tensor(LOW_MASK, device=wg.device)[bits]


def span_full(d: DeviceSpanDFA, data_u8, tiles, n: int, L: int, T: int,
              W: int, max_repair: int = 4, k: int = 1):
    """Returns (flag words [L*T/32] position-major with bits >= n masked,
    first words likewise, total match count incl. EOI, EOI kind at the
    final state, converged) — the count and kind as 0-dim device tensors,
    converged a bool — walking k sub-lanes a lane (count_scan.lane_split),
    repaired by count_scan.split_fixpoint.  The reference also returns the
    event count; its only caller discards it, so it is not computed
    here."""
    entries0, offsets0, limits = first_pass_inputs(d.starts, data_u8, n,
                                                   L, T, W, k)
    (cnts, exits, _sync, fw, gw), converged = split_fixpoint(
        MODE_SPAN, SPAN_KERNEL, d, tiles, W, entries0, offsets0, limits,
        max_repair)
    state_n = state_at_end(exits, n, L, T)
    total = cnts.sum(dtype=torch.int64) + d.eoi[state_n, CTX_SOT]
    kind = d.eoi_kind[state_n, CTX_SOT]
    return to_global(fw, n), to_global(gw, n), total, kind, converged


class SpanScanner:
    """Per-pattern forward span-event pipeline (ref. SpanScanner).

    scan(data_dev) -> (flag words, first words, total match count, EOI
    kind, converged) over the corpus word tiles (the count scan's layout,
    so one cached set serves both)."""

    def __init__(self, cd: CountDFA, device):
        self.cd = cd
        self.dsd = DeviceSpanDFA.from_host(cd, device)

    def scan(self, data_dev: torch.Tensor,
             geometry: Optional[Tuple[int, int, int, int]] = None,
             tiles: Optional[torch.Tensor] = None):
        """The repair fixpoint runs until it settles, so `converged` is
        always True (the reference's may be False after 4 rescans)."""
        n = int(data_dev.shape[0])
        L, T, W, _Lc = geometry or plan_geometry(n)
        if tiles is None:
            tiles = make_word_tiles(data_dev, L, T // 4)
        out = span_full(self.dsd, data_dev, tiles, n, L, T, W,
                        max_repair=L + SUB_PASSES, k=lane_split(T, W))
        settled(out[-1], "span scan")
        return out
