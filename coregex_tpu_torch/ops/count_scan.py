"""Corpus count scan for the CountDFA transducer, and the lane walk (K1).

Ports ``coregex_tpu/ops/count_scan.py``: ``size_bucket``, ``plan_geometry``
and ``_byte_ctx`` unchanged; ``_make_word_tiles`` (:165-186; callers cache
the tiles with the corpus, ``utils/corpus_cache.py``); ``DeviceCountDFA`` (:60-108) as ``DeviceCountDFA.from_host``;
``_count_full`` (:341-510) as host-driven torch code; ``CountScanner.count``.

The corpus splits into L lanes of T bytes.  Each lane first warms up over the
W-byte tail of the previous lane from a guessed entry state, then walks its
own bytes through the packed table (value = delta*32 + emit), summing the
emissions.  A bounded fixpoint rescans while some lane's post-warmup state
differs from the previous lane's exit, so the result equals the sequential
scan's.  The fixpoint runs on the host around the launches: one ``.item()``
sync per pass.

The lane walk itself is shared with the span scan (K2) and the flag scan
(K3): :func:`lane_walk` launches ``csrc/lane_scan.cu`` for CUDA tensors and
runs :func:`lane_walk_plain`, the reference's ``impl="gather"`` loop, for CPU
tensors.  The TPU kernel's ``packed_rc`` row/column merge only served the
Mosaic select tree and is left out: the CUDA kernel reads the full
``[S, NSEG]`` table from shared memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..dfa.countdfa import CountDFA
from ..dfa.dense import CTX_NL, CTX_OTHER, CTX_SOT, CTX_WORD
from . import _build

MODE_COUNT, MODE_SPAN, MODE_FLAG = 0, 1, 2

# a block stages the packed table (plus the 256-entry byte map) in shared
# memory; an H100 block can hold at most this many bytes
SMEM_LIMIT = 232448


def device_table(x, device) -> torch.Tensor:
    """Contiguous int32 copy of a host table on `device`."""
    return torch.tensor(np.ascontiguousarray(x, dtype=np.int32),
                        device=device)


def table_fits(S: int, nseg: int) -> bool:
    """Whether a packed [S, nseg] table fits the lane walk's shared memory."""
    return (S * nseg + 256) * 4 <= SMEM_LIMIT


def require_fits(S: int, nseg: int, device) -> None:
    """Raise ValueError when tables for `device` are too large for the
    lane-walk kernel, at table build time (the plain version on the CPU has
    no such limit)."""
    if torch.device(device).type == "cuda" and not table_fits(S, nseg):
        raise ValueError(f"packed table [{S}, {nseg}] exceeds the "
                         f"{SMEM_LIMIT}-byte shared-memory limit")


# ---------------------------------------------------------------------------
# Device tables
# ---------------------------------------------------------------------------

def segment_map(classes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(bounds, byte->segment map [256]) for a byte-class array: segments
    are the maximal byte ranges of constant class (the reference's
    boundary-compare byte map, as a table)."""
    bounds = np.asarray([b for b in range(1, 256)
                         if classes[b] != classes[b - 1]], dtype=np.int32)
    segmap = np.searchsorted(bounds, np.arange(256), side="right")
    return bounds, segmap.astype(np.int32)


class DeviceCountDFA:
    """CountDFA tables on a torch device: packed [S, NSEG] int32 with
    value = delta*32 + emit over byte segments, the byte->segment map,
    start states and EOI commits (ref. count_scan.py:DeviceCountDFA)."""

    def __init__(self, packed: np.ndarray, segmap: np.ndarray,
                 starts: np.ndarray, eoi: np.ndarray, device):
        self.S, self.NSEG = (int(x) for x in packed.shape)
        self.device = torch.device(device)
        require_fits(self.S, self.NSEG, self.device)
        self.packed = device_table(packed, self.device)
        self.segmap = device_table(segmap, self.device)
        self.starts = device_table(starts, self.device)
        self.eoi = device_table(eoi, self.device)

    @staticmethod
    def segment_tables(cd: CountDFA, emit: np.ndarray):
        """(packed, segmap) with packed = delta*32 + emit over segments."""
        bounds, segmap = segment_map(cd.classes)
        seg_starts = np.concatenate([np.zeros(1, np.int64), bounds])
        seg_cls = np.asarray(cd.classes)[seg_starts]
        delta = cd.delta[:, seg_cls].astype(np.int32)
        return delta * 32 + emit[:, seg_cls].astype(np.int32), segmap

    @classmethod
    def from_host(cls, cd: CountDFA, device) -> "DeviceCountDFA":
        packed, segmap = cls.segment_tables(cd, cd.emit)
        return cls(packed, segmap, cd.starts, cd.eoi_commits, device)


# ---------------------------------------------------------------------------
# Geometry + corpus tiling
# ---------------------------------------------------------------------------

def size_bucket(n: int) -> int:
    """Round a corpus length up to a 1/8-power-of-two bucket (<= 12.5%
    padding); geometries derive from the bucket (ref. size_bucket)."""
    if n <= 0:
        return 0
    if n <= 4096:
        step = max(64, (1 << (n.bit_length() - 1)) // 8)
        return -(-n // step) * step
    step = max(1, (1 << (n.bit_length() - 1)) // 8)
    return -(-n // step) * step


def plan_geometry(n: int, lc: int = 1024, tile_bytes: int = 256,
                  warmup: int = 64) -> Tuple[int, int, int, int]:
    """Returns (L, T, W, Lc), identical to the reference's: at most 8192
    lanes, T a multiple of tile_bytes, W a multiple of 4."""
    nb = size_bucket(max(n, 1))
    while lc > 128 and 8 * lc * tile_bytes > 4 * nb:
        lc //= 2
    L = 8 * lc
    T = -(-nb // L)
    T = -(-T // tile_bytes) * tile_bytes
    W = min(warmup, T)
    W = max(4, (W // 4) * 4)
    return L, T, W, lc


def make_word_tiles(data_u8: torch.Tensor, L: int, T4: int) -> torch.Tensor:
    """[n] uint8 -> time-major word tiles [T4, L] int32: word t of lane l
    holds bytes l*T + 4t .. +3, little-endian, zero-padded (the
    reference's [T4, 8, Lc] layout without the TPU's [8, Lc] split)."""
    n = int(data_u8.shape[0])
    pad = L * T4 * 4 - n
    if pad < 0:
        raise ValueError("corpus longer than the geometry")
    buf = torch.zeros(L * T4 * 4, dtype=torch.uint8, device=data_u8.device)
    buf[:n] = data_u8
    return buf.view(torch.int32).reshape(L, T4).t().contiguous()


# ---------------------------------------------------------------------------
# The lane walk: kernel K1 (and K2/K3 through `mode`) and its plain version
# ---------------------------------------------------------------------------

class LaunchCounter:
    """Launches of one CUDA kernel, counted by its wrapper."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


COUNT_KERNEL = LaunchCounter("count_scan")


def lane_walk_plain(mode: int, packed, segmap, tiles, W4: int, entries,
                    offsets, limits):
    """Plain torch lane walk (the reference's impl="gather" scan_once).
    Returns (counts, exits, sync, flagw, firstw); flagw/firstw are
    [T4/8, L] int32 words (None where the mode emits none)."""
    T4, L = (int(x) for x in tiles.shape)
    dev = tiles.device
    nseg = int(packed.shape[1])
    tbl = packed.reshape(-1).long()
    seg = None if segmap is None else segmap.long()
    prev = torch.roll(torch.arange(L, device=dev), 1)
    warm = tiles[T4 - W4:][:, prev]

    def cols(w, k):
        b = ((w >> (8 * k)) & 255).long()
        return b if seg is None else seg[b]

    s = entries.long()
    for tw in range(W4):
        for k in range(4):
            nxt = tbl[s * nseg + cols(warm[tw], k)] >> 5
            s = torch.where((tw * 4 + k) >= offsets, nxt, s)
    sync = s.to(torch.int32)

    cnt = torch.zeros(L, dtype=torch.int64, device=dev)
    emit_words = mode != MODE_COUNT
    flagw = torch.zeros((T4 // 8, L), dtype=torch.int32, device=dev) \
        if emit_words else None
    firstw = torch.zeros_like(flagw) if mode == MODE_SPAN else None
    live_len = int(limits.max()) if L else 0
    for t in range(min(T4, -(-live_len // 4))):
        w = tiles[t]
        for k in range(4):
            live = (t * 4 + k) < limits
            v = tbl[s * nseg + cols(w, k)]
            if mode == MODE_COUNT:
                e = v & 31
            elif mode == MODE_SPAN:
                e = (v >> 2) & 7
            else:
                e = (v >> 1) & 1
            cnt += torch.where(live, e, 0)
            sh = (t % 8) * 4 + k
            if emit_words:
                fb = torch.where(live, v & 1, 0).to(torch.int32)
                flagw[t // 8] |= fb << sh
            if mode == MODE_SPAN:
                gb = torch.where(live, (v >> 1) & 1, 0).to(torch.int32)
                firstw[t // 8] |= gb << sh
            s = torch.where(live, v >> 5, s)
    return (cnt.to(torch.int32), s.to(torch.int32), sync, flagw, firstw)


def _check_lane_args(packed, segmap, tiles, W4, entries, offsets, limits):
    dev = tiles.device
    T4, L = (int(x) for x in tiles.shape)
    named = [("packed", packed), ("tiles", tiles), ("entries", entries),
             ("offsets", offsets), ("limits", limits)]
    if segmap is not None:
        named.append(("segmap", segmap))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, tiles on {dev}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("entries", entries), ("offsets", offsets),
                    ("limits", limits)):
        if tuple(t.shape) != (L,):
            raise ValueError(f"{name} must have shape ({L},)")
    if segmap is not None and tuple(segmap.shape) != (256,):
        raise ValueError("segmap must have shape (256,)")
    if packed.dim() != 2:
        raise ValueError("packed must be [S, NSEG]")
    if T4 % 8 or not 0 < W4 <= T4:
        raise ValueError(f"bad tile geometry T4={T4} W4={W4}")
    S, nseg = (int(x) for x in packed.shape)
    if not table_fits(S, nseg):
        raise ValueError(f"packed table [{S}, {nseg}] exceeds the "
                         f"{SMEM_LIMIT}-byte shared-memory limit")


def lane_walk_cuda(mode: int, packed, segmap, tiles, W4: int, entries,
                   offsets, limits):
    """Launch csrc/lane_scan.cu; same outputs as lane_walk_plain."""
    _check_lane_args(packed, segmap, tiles, W4, entries, offsets, limits)
    T4, L = (int(x) for x in tiles.shape)
    S, nseg = (int(x) for x in packed.shape)
    dev = tiles.device
    counts, exits, sync = (torch.empty(L, dtype=torch.int32, device=dev)
                           for _ in range(3))
    flagw = firstw = None
    if mode != MODE_COUNT:
        flagw = torch.empty((T4 // 8, L), dtype=torch.int32, device=dev)
    if mode == MODE_SPAN:
        firstw = torch.empty_like(flagw)
    lib = _build.lib()
    p = _build.ptr
    with torch.cuda.device(dev):
        st = _build.stream(dev)
        if mode == MODE_COUNT:
            rc = lib.cgx_lane_count(
                p(packed), S, nseg, p(segmap), p(tiles), T4, L, W4,
                p(entries), p(offsets), p(limits), p(counts), p(exits),
                p(sync), st)
        elif mode == MODE_SPAN:
            rc = lib.cgx_lane_span(
                p(packed), S, nseg, p(segmap), p(tiles), T4, L, W4,
                p(entries), p(offsets), p(limits), p(counts), p(exits),
                p(sync), p(flagw), p(firstw), st)
        else:
            rc = lib.cgx_lane_flag(
                p(packed), S, nseg, p(tiles), T4, L, W4, p(entries),
                p(offsets), p(limits), p(counts), p(exits), p(sync),
                p(flagw), st)
    _build.check(rc, "lane_scan")
    return counts, exits, sync, flagw, firstw


def lane_walk(mode: int, counter: LaunchCounter, packed, segmap, tiles,
              W4: int, entries, offsets, limits):
    """The lane walk on the tiles' device: the kernel for CUDA tensors
    (counted on `counter`), the plain version for CPU tensors."""
    if tiles.device.type == "cuda":
        out = lane_walk_cuda(mode, packed, segmap, tiles, W4, entries,
                             offsets, limits)
        counter.launches += 1
        return out
    if tiles.device.type != "cpu":
        raise ValueError(f"unsupported device {tiles.device}")
    return lane_walk_plain(mode, packed, segmap, tiles, W4, entries,
                           offsets, limits)


def count_lanes(packed, segmap, tiles, W4, entries, offsets, limits):
    """K1: (counts, exits, sync) of one count-transducer pass."""
    return lane_walk(MODE_COUNT, COUNT_KERNEL, packed, segmap, tiles, W4,
                     entries, offsets, limits)[:3]


# ---------------------------------------------------------------------------
# Full count: warmup guess + host-driven repair fixpoint + EOI
# ---------------------------------------------------------------------------

def _byte_ctx(b):
    is_word = (((b >= 48) & (b <= 57)) | ((b >= 65) & (b <= 90))
               | (b == 95) | ((b >= 97) & (b <= 122)))
    return torch.where(is_word, CTX_WORD,
                       torch.where(b == 10, CTX_NL, CTX_OTHER))


def first_pass_inputs(starts, data_u8, n: int, L: int, T: int, W: int):
    """(entries0, offsets0, limits) of a transducer scan's first pass:
    entries guessed from the byte before each lane's warmup window, lane 0
    at the true start (ref. _count_full:358-380)."""
    dev = data_u8.device
    lane_ids = torch.arange(L, dtype=torch.int32, device=dev)
    guess_pos = lane_ids * T - W - 1
    prev_b = data_u8[guess_pos.clamp(0, max(n - 1, 0)).long()].to(
        torch.int32)
    ctx = _byte_ctx(prev_b)
    entries0 = torch.where(guess_pos < 0, starts[CTX_SOT],
                           starts[ctx.long()])
    entries0[0] = starts[CTX_SOT]
    offsets0 = torch.zeros(L, dtype=torch.int32, device=dev)
    offsets0[0] = W
    limits = (n - lane_ids * T).clamp(0, T)
    return entries0.contiguous(), offsets0, limits.contiguous()


def repair_fixpoint(scan_once, entries0, offsets0, first_entry, real,
                    W: int, max_repair: int):
    """Run scan_once(entries, offsets) -> (..., exits, sync) until every
    real lane's post-warmup state equals the previous lane's exit, at most
    max_repair rescans.  Returns (outputs of the last pass, converged).

    A rescan enters each lane at the previous lane's exit, and lane 0 at
    the true start, so rescan k makes lanes 0..k exact: max_repair = L
    always converges."""
    def want_of(exits):
        return torch.cat([first_entry.reshape(1).to(torch.int32),
                          exits[:-1]])

    out = scan_once(entries0, offsets0)
    full_w = torch.full_like(offsets0, W)
    k = 0
    while True:
        exits, sync = out[-2], out[-1]
        bad = bool((real & (want_of(exits) != sync)).any())
        if not bad or k >= max_repair:
            return out, not bad
        out = scan_once(want_of(exits).contiguous(), full_w)
        k += 1


def settled(converged: bool, what: str) -> None:
    """Raise if a fixpoint run with max_repair = L did not converge (it
    cannot: see repair_fixpoint)."""
    if not converged:
        raise RuntimeError(f"{what}: repair fixpoint did not settle")


def state_at_end(exits, n: int, L: int, T: int):
    """Exit state of the lane holding byte n-1."""
    lane_n = n // T - 1 if n % T == 0 else n // T
    return exits[min(max(lane_n, 0), L - 1)].long()


def count_full(d: DeviceCountDFA, data_u8, tiles, n: int, L: int, T: int,
               W: int, max_repair: int = 4):
    """Returns (count as a 0-dim int64 tensor, converged bool)."""
    W4 = W // 4
    entries0, offsets0, limits = first_pass_inputs(d.starts, data_u8, n,
                                                   L, T, W)
    lane_ids = torch.arange(L, dtype=torch.int64, device=tiles.device)
    real = (lane_ids * T) < n

    def scan_once(entries, offsets):
        return count_lanes(d.packed, d.segmap, tiles, W4, entries, offsets,
                           limits)

    (counts, exits, _sync), converged = repair_fixpoint(
        scan_once, entries0, offsets0, d.starts[CTX_SOT], real, W,
        max_repair)
    state_n = state_at_end(exits, n, L, T)
    total = counts.sum(dtype=torch.int64) + d.eoi[state_n, CTX_SOT]
    return total, converged


class CountScanner:
    """Per-pattern count pipeline on one torch device; returns exact Go
    match counts (ref. count_scan.py:CountScanner)."""

    def __init__(self, cd: CountDFA, device):
        self.cd = cd
        self.dcd = DeviceCountDFA.from_host(cd, device)

    def count(self, data_dev: torch.Tensor,
              geometry: Optional[Tuple[int, int, int, int]] = None,
              tiles: Optional[torch.Tensor] = None) -> int:
        """Exact count for the device corpus.  The repair fixpoint runs
        until it settles (the reference stops after 4 rescans and falls
        back to its host loop).  `tiles`: the corpus's word tiles under
        the geometry (built when None)."""
        n = int(data_dev.shape[0])
        if n == 0:
            return int(self.cd.eoi_commits[self.cd.starts[CTX_SOT],
                                           CTX_SOT])
        L, T, W, _Lc = geometry or plan_geometry(n)
        if tiles is None:
            tiles = make_word_tiles(data_dev, L, T // 4)
        total, conv = count_full(self.dcd, data_dev, tiles, n, L, T, W,
                                 max_repair=L)
        settled(conv, "count scan")
        return int(total)
