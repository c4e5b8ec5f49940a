"""Reset scan emitting flag words at count-scan speed (K3).

Ports ``coregex_tpu/ops/flag_scan.py``: ``ResetFlagTables`` (:49-104,
including ``flag_pre_reset``) as ``ResetFlagTables.from_host``;
``reset_geometry``, ``_sym_base_tiles`` and ``scatter_reset_tiles``
(:122-157); ``_flag_full`` with the entries hint (:296-411);
``FlagResetScanner.scan_tiles``.

The reset bit moves into the alphabet: symbol = 2*segment + reset, and

    delta'[s, sym] = delta[rs ? start : s, cls]
    emit' [s, sym] = match_on[rs and pre_reset ? s : (rs ? start : s), cls]
                     | (rs and s != DEAD and not pre_reset) << 1

The lane walk packs bit 0 into flag words and sums bit 1 (interference).
Symbols index table columns directly, so no byte map is needed.  The flag
at position n (the first pad symbol) is EOI acceptance.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..dfa.dense import DEAD, DenseDFA
from .count_scan import (MODE_FLAG, LaunchCounter, device_table,
                         lane_walk, make_word_tiles, plan_geometry,
                         repair_fixpoint, require_fits, settled)
from .dfa_scan import DFATables
from .span_scan import to_global

FLAG_KERNEL = LaunchCounter("flag_scan")


class ResetFlagTables:
    """Extended-alphabet tables of a dense DFA with a constant reset
    context (ref. ResetFlagTables).  flag_pre_reset=True evaluates the
    flag at a reset position against the OLD run's state (the transition
    still resets) and drops interference accounting: the bidirectional
    span path's reverse scan needs the flag of a match starting exactly at
    the previous match's end."""

    def __init__(self, packed: np.ndarray, bounds: np.ndarray, device):
        self.S, self.NSEG = (int(x) for x in packed.shape)
        require_fits(self.S, self.NSEG, device)
        self.packed_full = device_table(packed, device)
        self.bounds = bounds

    @staticmethod
    def alphabet_fits(t: DFATables) -> bool:
        """The 2C reset symbols fit the u8 symbol tiles: C <= 64."""
        return t.delta.shape[1] <= 64

    @classmethod
    def from_host(cls, dfa: DenseDFA, reset_ctx: int, device,
                  flag_pre_reset: bool = False) -> "ResetFlagTables":
        t = DFATables.from_dense(dfa)
        if not cls.alphabet_fits(t):
            raise ValueError("flag scan packs 2C symbols in u8: C <= 64")
        delta, match = t.delta, t.match_on
        S, C = delta.shape
        start = int(t.host_starts[reset_ctx])
        de = np.zeros((S, 2 * C), dtype=np.int32)
        ee = np.zeros((S, 2 * C), dtype=np.int32)
        for rs in (0, 1):
            for s in range(S):
                s_pre = start if rs else s
                s_flag = s if (rs and flag_pre_reset) else s_pre
                de[s, 2 * np.arange(C) + rs] = delta[s_pre]
                ee[s, 2 * np.arange(C) + rs] = (
                    match[s_flag].astype(np.int32)
                    | ((rs and s != DEAD and not flag_pre_reset) << 1))
        return cls(de * 32 + ee, t.bounds, device)


def reset_geometry(n: int):
    """Geometry of an [n+32]-symbol reset scan (the tile cache and
    scan_tiles must agree)."""
    return plan_geometry(n + 32)


def sym_base_tiles(dev, bounds: Tuple[int, ...], L: int, T4: int):
    """Reset-free symbol word tiles (2*segment, 32 pad symbols appended)
    of a corpus: cacheable per (corpus, tables); per-call reset bits
    scatter into a copy (ref. _sym_base_tiles)."""
    cls = torch.zeros(dev.shape, dtype=torch.uint8, device=dev.device)
    for b in bounds:
        cls += (dev >= b).to(torch.uint8)
    sym = torch.cat([cls * 2, torch.zeros(32, dtype=torch.uint8,
                                          device=dev.device)])
    return make_word_tiles(sym, L, T4)


def scatter_reset_tiles(base_tiles, rq, L: int, T4: int):
    """Copy of the symbol tiles with +1 (the reset bit; symbols are even,
    so no carry) at each position of rq.  Entries of rq that are negative
    or past the tile domain are dropped: the reference's scatter sends
    the -1 of dead entries to its last tile word instead, a byte no scan
    reads (ref. scatter_reset_tiles)."""
    r = rq.to(torch.int64)
    valid = (r >= 0) & (r < L * T4 * 4)
    w = r >> 2
    flat = torch.where(valid, (w % T4) * L + (w // T4), 0)
    val = torch.where(valid, torch.bitwise_left_shift(
        torch.ones_like(r), 8 * (r & 3)), 0).to(torch.int32)
    out = base_tiles.clone().reshape(-1)
    out.index_add_(0, flat, val)
    return out.reshape(base_tiles.shape)


def flag_lanes(packed, tiles, W4, entries, offsets, limits):
    """K3: (flagw, counts, exits, sync) of one reset-scan pass."""
    counts, exits, sync, fw, _ = lane_walk(
        MODE_FLAG, FLAG_KERNEL, packed, None, tiles, W4, entries, offsets,
        limits)
    return fw, counts, exits, sync


def flag_full(packed_full, tiles, n1: int, entries_init, L: int, T: int,
              W: int, max_repair: int = 4):
    """Returns (flag words [L*T/32] position-major with bits >= n1
    masked, interference count tensor, converged bool, lane-entry hint).
    n1 = n + 1 (the EOI position is live).  entries_init: DEAD for a
    fresh scan, or a previous converged scan's hint (states AT lane
    starts: warmup is skipped and the fixpoint check passes in one
    pass)."""
    W4 = W // 4
    dev = tiles.device
    lane_ids = torch.arange(L, dtype=torch.int64, device=dev)
    is_hint = (entries_init != DEAD).any()
    base = torch.zeros(L, dtype=torch.int32, device=dev)
    base[0] = W
    offsets0 = torch.where(is_hint, torch.full_like(base, W), base)
    limits = (n1 - lane_ids * T).clamp(0, T).to(torch.int32)
    real = (lane_ids * T) < n1
    dead = torch.tensor(DEAD, dtype=torch.int32, device=dev)

    def scan_once(entries, offsets):
        return flag_lanes(packed_full, tiles, W4, entries, offsets, limits)

    (fw, cnts, exits, _sync), converged = repair_fixpoint(
        scan_once, entries_init.to(torch.int32).contiguous(), offsets0,
        dead, real, W, max_repair)
    hint = torch.cat([dead.reshape(1), exits[:-1]])
    return to_global(fw, n1), cnts.sum(), converged, hint


class FlagResetScanner:
    """Reset scan with flag-word output (ref. FlagResetScanner)."""

    def __init__(self, dfa: DenseDFA, reset_ctx: int, device,
                 flag_pre_reset: bool = False):
        self.device = torch.device(device)
        self.tables = ResetFlagTables.from_host(
            dfa, reset_ctx, self.device, flag_pre_reset=flag_pre_reset)

    def byte_bounds(self) -> Tuple[int, ...]:
        """Byte segment boundaries for the symbol build."""
        return tuple(int(b) for b in self.tables.bounds if 0 < int(b) < 256)

    def scan_tiles(self, tiles, n: int, entries_hint=None):
        """Scan prebuilt symbol word tiles under reset_geometry(n).
        `entries_hint`: [L] lane entry states from a previous converged
        scan of the same symbols (validated by the fixpoint like any
        guess).  Returns (flag words over the [n+1] domain, interference,
        converged, hint for the next call); the fixpoint runs until it
        settles, so converged is always True."""
        L, T, W, _Lc = reset_geometry(n)
        if entries_hint is None or int(entries_hint.shape[0]) != L:
            entries_hint = torch.full((L,), DEAD, dtype=torch.int32,
                                      device=tiles.device)
        out = flag_full(self.tables.packed_full, tiles, n + 1, entries_hint,
                        L, T, W, max_repair=L)
        settled(out[2], "flag scan")
        return out
