"""Reset scan emitting flag words at count-scan speed (K3).

Ports ``coregex_tpu/ops/flag_scan.py``: ``ResetFlagTables`` (:49-104,
including ``flag_pre_reset``) as ``ResetFlagTables.from_host``;
``reset_symbols`` (:112-119), ``reset_geometry``, ``_sym_base_tiles`` and
``scatter_reset_tiles`` (:122-157); ``_flag_full`` with the entries hint
(:296-411); ``FlagResetScanner.scan_tiles``, ``scan_words`` (:435) and
``scan_words_syms`` (:440).  ``flag_pre_reset=False`` is the interference
mode: a reset that meets a live state counts, so the INNER pipeline
(``meta/batch.py`` ``_inner_spans_dev``) learns that a suffix run was cut
short and declines.

The reset bit moves into the alphabet: symbol = 2*segment + reset, and

    delta'[s, sym] = delta[rs ? start : s, cls]
    emit' [s, sym] = match_on[rs and pre_reset ? s : (rs ? start : s), cls]
                     | (rs and s != DEAD and not pre_reset) << 1

The lane walk packs bit 0 into flag words and sums bit 1 (interference).
Symbols index table columns directly, so no byte map is needed.  The flag
at position n (the first pad symbol) is EOI acceptance.  The 2C-column
table sits in shared memory where it fits and in global memory past it
(``count_scan.lane_instance``; 16-bit values up to
``count_scan.MAX16_ROWS`` rows); the only gate is the alphabet, C <= 64
(``alphabet_fits``).

Changes from the reference: K3 walks k = ``lane_split(T, W)`` sub-lanes a
lane and repairs through ``count_scan.split_fixpoint`` (unsettled
sub-lanes, then whole lanes, until every seam agrees) instead of at most
four rescans of every lane, so the hint holds [k, L] sub-lane entries, and
a hinted scan walks no warmup.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..dfa.dense import DEAD, DenseDFA
from .count_scan import (MODE_FLAG, SUB_PASSES, LaunchCounter, check_table,
                         lane_split, make_word_tiles, packed_device,
                         plan_geometry, settled, split_fixpoint, want_of)
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
        check_table(self.S, self.NSEG)
        self.packed_full = packed_device(packed, device)
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


def reset_symbols(dev, rmask, bounds: Tuple[int, ...]):
    """uint8 symbol stream 2 * segment + reset of a corpus, with 32 pad
    symbols appended so that position n (the EOI flag) always exists."""
    sym = torch.zeros(int(dev.shape[0]) + 32, dtype=torch.uint8,
                      device=dev.device)
    n = int(dev.shape[0])
    for b in bounds:
        sym[:n] += (dev >= b).to(torch.uint8)
    sym[:n] *= 2
    sym[:n] += rmask.to(torch.uint8)
    return sym


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


# reset positions scattered at once: bounded int64 transients at any count
_RESET_CHUNK = 1 << 26


def scatter_reset_tiles(base_tiles, rq, L: int, T4: int, flip_n=None):
    """Copy of the symbol tiles with +1 (the reset bit; symbols are even,
    so no carry) at each position of rq (at flip_n - rq when flip_n is
    given: the reversed positions of forward ends), _RESET_CHUNK at a
    time.  Entries of rq that are negative or past the tile domain are
    dropped: the reference's scatter sends the -1 of dead entries to its
    last tile word instead, a byte no scan reads (ref.
    scatter_reset_tiles)."""
    out = base_tiles.clone().reshape(-1)
    for i in range(0, int(rq.shape[0]), _RESET_CHUNK):
        r = rq[i:i + _RESET_CHUNK].to(torch.int64)
        if flip_n is not None:
            r = flip_n - r
        valid = (r >= 0) & (r < L * T4 * 4)
        w = r >> 2
        idx = torch.where(valid, (w % T4) * L + (w // T4), 0)
        val = torch.where(valid, torch.bitwise_left_shift(
            torch.ones_like(r), 8 * (r & 3)), 0).to(torch.int32)
        out.index_add_(0, idx, val)
    return out.reshape(base_tiles.shape)


class FlagWalk(NamedTuple):
    """The tables split_fixpoint walks for K3: the packed table, no byte
    map (symbols index columns), DEAD as the state before the first
    sub-lane (no run precedes the first reset)."""
    packed: torch.Tensor
    segmap: None = None
    sot: int = DEAD


def flag_full(packed_full, tiles, n1: int, hint, L: int, T: int, W: int,
              k: int, max_repair: int = 4):
    """Returns (flag words [L*T/32] position-major with bits >= n1
    masked, interference count tensor, converged bool, sub-lane entry
    hint [k, L]).  n1 = n + 1 (the EOI position is live).  K3 walks k
    sub-lanes a lane through count_scan.split_fixpoint.  hint: None for a
    fresh scan (DEAD entries, each sub-lane warmed up over the W symbols
    before it), or a previous converged scan's hint, the states AT the
    sub-lanes' starts: then no sub-lane walks a warmup, and the fixpoint
    validates the hint as any guess (one pass when it holds)."""
    dev = tiles.device
    lane_ids = torch.arange(L, dtype=torch.int64, device=dev)
    offsets0 = torch.zeros(L, dtype=torch.int32, device=dev)
    offsets0[0] = W
    limits = (n1 - lane_ids * T).clamp(0, T).to(torch.int32)
    if hint is None:
        entries0 = torch.full((k, L), DEAD, dtype=torch.int32, device=dev)
    else:
        entries0 = hint.to(torch.int32).contiguous()
    (cnts, exits, _sync, fw, _aux), converged = split_fixpoint(
        MODE_FLAG, FLAG_KERNEL, FlagWalk(packed_full), tiles,
        W if hint is None else 0, entries0, offsets0, limits, max_repair)
    return (to_global(fw, n1), cnts.sum(), converged,
            want_of(exits, DEAD).contiguous())


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

    def scan_words(self, dev, rmask):
        """scan_words_syms over the corpus's symbols with resets at
        `rmask` (reset_symbols)."""
        return self.scan_words_syms(
            reset_symbols(dev, rmask, self.byte_bounds()),
            int(dev.shape[0]))

    def scan_words_syms(self, syms, n: int, entries_hint=None):
        """scan_tiles over a prebuilt symbol stream of n + 32 symbols
        (reset_symbols, or a producer's fused build): its word tiles
        under reset_geometry(n)."""
        L, T, _W, _Lc = reset_geometry(n)
        return self.scan_tiles(make_word_tiles(syms, L, T // 4), n,
                               entries_hint)

    def scan_tiles(self, tiles, n: int, entries_hint=None):
        """Scan prebuilt symbol word tiles under reset_geometry(n), k =
        lane_split(T, W) sub-lanes a lane.  `entries_hint`: [k, L]
        sub-lane entry states from a previous converged scan of the same
        symbols (validated by the fixpoint like any guess; one of another
        shape is dropped).  Returns (flag words over the [n+1] domain,
        interference, converged, hint for the next call); the fixpoint
        runs until it settles, so converged is always True."""
        L, T, W, _Lc = reset_geometry(n)
        k = lane_split(T, W)
        if entries_hint is not None and tuple(entries_hint.shape) != (k, L):
            entries_hint = None
        out = flag_full(self.tables.packed_full, tiles, n + 1, entries_hint,
                        L, T, W, k, max_repair=L + SUB_PASSES)
        settled(out[2], "flag scan")
        return out
