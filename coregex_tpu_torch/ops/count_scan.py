"""Corpus count scan for the CountDFA transducer, and the lane walk (K1).

Ports ``coregex_tpu/ops/count_scan.py``: ``size_bucket``, ``plan_geometry``
and ``_byte_ctx`` unchanged; ``_make_word_tiles`` (:165-186; callers cache
the tiles with the corpus, ``utils/corpus_cache.py``); ``DeviceCountDFA`` (:60-108) as ``DeviceCountDFA.from_host``;
``_count_full`` (:341-510) as host-driven torch code; ``CountScanner.count``.

The corpus splits into L lanes of T bytes (``plan_geometry``, the
reference's rule, so every caller shares one cached set of word tiles),
and for the count scan each lane into k = ``lane_split(T, W)`` sub-lanes
of T/k bytes, so that enough walkers fill the card.  Each sub-lane first
warms up over the W bytes before it from a guessed entry state, then walks
its own bytes through the packed table (value = delta*32 + emit), summing
the emissions.  A fixpoint (``split_fixpoint``) walks again only the
sub-lanes, and then the whole lanes, whose post-warmup state differs from
the previous sub-lane's exit, until none does, so the result equals the
sequential scan's.  It runs on the host around the launches: one
``.item()`` sync per pass.

The lane walk itself is shared with the span scan (K2), the flag scan (K3),
the match scan (K9, ``dfa_scan.ChunkScanner``) and the reset scan
(``MODE_RESET``, ``dfa_scan.ResetScanner``), each split and repaired as K1
(K9 with a dead cut, see :func:`split_fixpoint`): :func:`lane_walk`
launches ``csrc/lane_scan.cu`` for CUDA tensors and
runs :func:`lane_walk_plain`, the reference's ``impl="gather"`` loop, for CPU
tensors.  The TPU kernel's ``packed_rc`` row/column merge only served the
Mosaic select tree and is left out: the CUDA kernel reads the full
``[S, NSEG]`` table, so a table of any size the host pipeline builds runs
on the card.  Every lane walk takes entries and gives counts, exits and
syncs of shape [k, L], row j holding sub-lane j of each lane.

Table residency (``lane_scan.cu``'s header): a table of at most
MAX16_ROWS rows holds 16-bit values (``packed_device``: an int16 tensor,
read as uint16 by the kernel and as ``& 0xFFFF`` by the plain versions,
``table_values``), a larger one int32; the kernel's block takes 128 to
1024 threads, as many walkers as the occupancy calculator lets stay
resident (``lane_block``); and the table takes the shared-memory instance,
its rows skewed to an odd number of words (``lane_pitch``), where that
instance keeps at least MIN_SHARED_WARPS warps an SM (``table_fits``,
``lane_instance``, by ``lane_warps``, the sources' own model of the
occupancy), else the global-memory one.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dfa.countdfa import CountDFA
from ..dfa.dense import CTX_NL, CTX_OTHER, CTX_SOT, CTX_WORD, DEAD
from . import _build

# MODE_RESET walks bytes column << 3 | ctx << 1 | reset and takes the four
# start states in the byte map's place (dfa_scan.ResetScanner)
MODE_COUNT, MODE_SPAN, MODE_FLAG, MODE_MATCH, MODE_RESET = 0, 1, 2, 3, 4
# lane walk launches: pass 0 (with warmup), a pass over the unsettled
# sub-lanes, a pass over the lanes holding one (csrc/lane_scan.cu's Pass)
PASS_FIRST, PASS_SUB, PASS_LANE = 0, 1, 2

# a block stages the packed table (plus the 256-entry byte map) in shared
# memory; an H100 block can hold at most this many bytes (past it the lane
# walk and the window scan read the table from global memory)
SMEM_LIMIT = 232448
# an H100 SM's shared memory, the part of it each resident block reserves,
# its unit of allocation, and the most blocks and threads an SM holds
# (lane_scan.cu's kSmemPerSM, kBlockReserved, kSmemUnit, kMaxBlocksPerSM,
# kMaxThreadsPerSM)
SM_SMEM = 233472
BLOCK_RESERVED = 1024
SMEM_UNIT = 128
SM_BLOCKS = 32
SM_THREADS = 2048
# the lane walk's block sizes (kThreads .. kMaxThreads)
LANE_THREADS = (128, 256, 512, 1024)
# the fewest resident warps an SM for which a table takes the lane walk's
# shared-memory instance (kMinSharedWarps): a block of 1024 threads holds
# 32, and fewer walkers than that leave the chain's latency uncovered
MIN_SHARED_WARPS = 32
# the most rows of a 16-bit table: every value delta*32 + flags stays
# below 2^16 (lane_scan.cu's kMax16)
MAX16_ROWS = 2047
# most sub-lanes a lane for K1-K3, K5, K6 and K9 (lane_split): 64 sub-lanes
# of 3 KiB
# at 1536 MiB, 524,288 walkers, about two waves of resident threads; 16
# and 32 were slower on the H100 (PERF.md)
MAX_SPLIT = 64
# repair passes over sub-lanes before the fixpoint re-walks whole lanes
SUB_PASSES = 2


def device_table(x, device) -> torch.Tensor:
    """Contiguous int32 copy of a host table on `device`."""
    return torch.tensor(np.ascontiguousarray(x, dtype=np.int32),
                        device=device)


def value_bytes(S: int) -> int:
    """Bytes of a packed value of an S-row table: 2 up to MAX16_ROWS rows,
    else 4."""
    return 2 if S <= MAX16_ROWS else 4


def pack16(x) -> np.ndarray:
    """A packed [S, nseg] table (values delta*32 + flags, each in [0,
    2^16)) as int16 bits: values past 2^15 wrap, and ``& 0xFFFF`` reads
    them back.  Refused (ValueError) past MAX16_ROWS rows or for a value
    outside [0, 2^16)."""
    x = np.asarray(x)
    if x.shape[0] > MAX16_ROWS:
        raise ValueError(f"a 16-bit table holds at most {MAX16_ROWS} rows, "
                         f"not {x.shape[0]}")
    if x.size and (int(x.min()) < 0 or int(x.max()) >= 1 << 16):
        raise ValueError("packed values must lie in [0, 2^16)")
    return np.ascontiguousarray(x.astype(np.uint16).view(np.int16))


def packed_device(x, device) -> torch.Tensor:
    """A lane walk's or window scan's packed table on `device`: int16 bits
    of its 16-bit values where it has at most MAX16_ROWS rows (pack16),
    else int32."""
    x = np.asarray(x)
    if value_bytes(int(x.shape[0])) == 2:
        return torch.from_numpy(pack16(x)).to(device)
    return device_table(x, device)


def table_values(packed) -> torch.Tensor:
    """The packed values of an int16 or int32 table as int64, flat."""
    v = packed.reshape(-1).long()
    return v & 0xFFFF if packed.dtype == torch.int16 else v


def wide(packed) -> torch.Tensor:
    """An int16 or int32 packed table as int32 values."""
    if packed.dtype == torch.int16:
        return (packed.to(torch.int32) & 0xFFFF).contiguous()
    return packed


def lane_pitch(nseg: int, width: int) -> int:
    """The row pitch (values a row) of an nseg-column table of
    `width`-byte values in the lane walk's shared memory (lane_scan.cu's
    pitch_of): rounded up to an odd number of words a row where a row
    would span whole words, so walkers that read one column from
    different rows meet in different banks."""
    if width == 4:
        return nseg | 1
    return nseg if nseg & 1 or nseg & 3 == 2 else nseg + 2


def lane_smem_bytes(mode: int, S: int, nseg: int, width: int) -> int:
    """Dynamic shared memory of a lane-walk block (lane_scan.cu's
    smem_bytes): the table of `width`-byte values in shared memory (width
    0: the global-memory instance, no table there), S rows of lane_pitch
    values padded to whole words, and the 256-entry byte map of every mode
    but K3 and the reset mode."""
    tbl = (S * lane_pitch(nseg, width) * width + 3) & ~3 if width else 0
    return tbl + (0 if mode in (MODE_FLAG, MODE_RESET) else 1024)


def lane_block(smem: int) -> Tuple[int, int]:
    """(threads a block, resident warps an SM) of lane-walk blocks taking
    `smem` bytes of shared memory: the smallest block of LANE_THREADS that
    keeps the most warps resident, for a kernel of at most 32 registers a
    thread (lane_scan.cu's block_threads, the occupancy calculator's
    rule); (0, 0) past SMEM_LIMIT."""
    if smem > SMEM_LIMIT:
        return 0, 0
    unit = -(-smem // SMEM_UNIT) * SMEM_UNIT
    best = (0, 0)
    for th in LANE_THREADS:
        warps = min(SM_THREADS // th, SM_BLOCKS,
                    SM_SMEM // (unit + BLOCK_RESERVED)) * th // 32
        if warps > best[1]:
            best = (th, warps)
    return best


def lane_warps(smem: int) -> int:
    """Resident warps an SM of lane-walk blocks taking `smem` bytes of
    shared memory, at the block size that keeps the most (lane_block;
    lane_scan.cu's lane_warps); 0 past SMEM_LIMIT."""
    return lane_block(smem)[1]


def table_fits(S: int, nseg: int, mode: int = MODE_COUNT,
               vbytes: Optional[int] = None) -> bool:
    """Whether a mode's packed [S, nseg] table of vbytes-byte values
    (value_bytes(S), as packed_device packs it, when None) takes the lane
    walk's shared-memory instance: there it keeps at least
    MIN_SHARED_WARPS warps an SM (lane_scan.cu's use_shared)."""
    vb = value_bytes(S) if vbytes is None else vbytes
    return lane_warps(lane_smem_bytes(mode, S, nseg, vb)) \
        >= MIN_SHARED_WARPS


def lane_instance(mode: int, S: int, nseg: int,
                  vbytes: Optional[int] = None) -> str:
    """The lane walk's instance for a mode's [S, nseg] table: "shared"
    (the table in shared memory) or "global" (read with __ldg)."""
    return "shared" if table_fits(S, nseg, mode, vbytes) else "global"


def check_table(S: int, nseg: int) -> None:
    """Raise ValueError for a packed table the kernels cannot index: they
    address it with int32 (s * nseg + column) and pack the next state in
    the value's upper 27 bits.  Far past any table the host pipeline
    builds (DFAOverflow stops it at 20,000 states, 256 segments at most)."""
    if S < 1 or nseg < 1 or S * nseg >= 2 ** 31 or S >= 2 ** 26:
        raise ValueError(f"packed table [{S}, {nseg}] cannot be indexed "
                         f"with int32")


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
    """CountDFA tables on a torch device: packed [S, NSEG] (int16 bits of
    16-bit values up to MAX16_ROWS rows, else int32, packed_device) with
    value = delta*32 + emit over byte segments, the byte->segment map,
    start states and EOI commits (ref. count_scan.py:DeviceCountDFA)."""

    def __init__(self, packed: np.ndarray, segmap: np.ndarray,
                 starts: np.ndarray, eoi: np.ndarray, device):
        self.S, self.NSEG = (int(x) for x in packed.shape)
        self.device = torch.device(device)
        check_table(self.S, self.NSEG)
        self.packed = packed_device(packed, self.device)
        self.segmap = device_table(segmap, self.device)
        self.starts = device_table(starts, self.device)
        self.sot = int(np.asarray(starts)[CTX_SOT])   # the true start state
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


def lane_split(T: int, W: int) -> int:
    """Sub-lanes per lane for the lane walks and the needle scans K5 and K6
    under a geometry of T-byte lanes
    and a W-byte warmup: the largest power of two k <= MAX_SPLIT that
    divides T/32, the lane's flag groups, with T/k >= 4W, so the warmup
    stays within a quarter of a sub-lane's walk.  1 below T = 8W."""
    k = 1
    while (2 * k <= MAX_SPLIT and (T // 32) % (2 * k) == 0
           and T // (2 * k) >= 4 * W):
        k *= 2
    return k


def sub_limits(limits, k: int, Tk: int):
    """Per-sub-lane limits [k*L] in row order (row j = sub-lanes (j, .))
    from the lanes' limits [L]: clamp(limits[l] - j*Tk, 0, Tk)."""
    j = torch.arange(k, dtype=torch.int32, device=limits.device)
    return (limits[None, :] - j[:, None] * Tk).clamp(0, Tk).reshape(-1)


# ---------------------------------------------------------------------------
# The lane walk: kernel K1 (and K2/K3 through `mode`) and its plain version
# ---------------------------------------------------------------------------

class LaunchCounter:
    """Launches of one CUDA kernel, counted by its wrapper, and the repair
    passes of the split fixpoint (split_fixpoint) that walked something:
    passes over sub-lanes and passes over whole lanes."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.sub_passes = 0
        self.lane_passes = 0


COUNT_KERNEL = LaunchCounter("count_scan")
# launches of the global-memory instances of K1, K2, K3 and K9 (tables past
# shared memory), counted beside their kernels' own counters
GLOBAL_KERNELS = {MODE_COUNT: LaunchCounter("count_scan_global"),
                  MODE_SPAN: LaunchCounter("span_scan_global"),
                  MODE_FLAG: LaunchCounter("flag_scan_global"),
                  MODE_MATCH: LaunchCounter("match_scan_global")}


def _count_launch(mode: int, counter: LaunchCounter, packed) -> None:
    """One launch of a lane walk: on its kernel's counter, and on its
    global-memory instance's where the table takes that instance."""
    counter.launches += 1
    g = GLOBAL_KERNELS.get(mode)
    if g is not None and lane_instance(mode, *packed.shape,
                                       packed.element_size()) == "global":
        g.launches += 1


def _step(mode, tbl, seg, nseg, s, w, k):
    """Byte k of words w from states s: (packed values, or for MODE_RESET
    (values, the resets that met a live run)).  MODE_RESET restarts at
    seg[ctx], seg holding the four start states, where the byte's reset
    bit is set."""
    b = ((w >> (8 * k)) & 255).long()
    if mode != MODE_RESET:
        return tbl[s * nseg + (b if seg is None else seg[b])], None
    rs = (b & 1) == 1
    hit = rs & (s != DEAD)
    s = torch.where(rs, seg[(b >> 1) & 3], s)
    return tbl[s * nseg + (b >> 3)], hit


def _walk_plain(mode, tbl, seg, nseg, word, steps: int, s, lim,
                words: bool = True):
    """Walk M columns from states s (int64 [M]) over `steps` words, word(t)
    giving word t of every column, positions >= lim [M] frozen.  Returns
    (counts int64, exit states int64, flag words [steps/8, M] or None, aux):
    aux is the first-flag words of MODE_SPAN, the walk-local position of
    the last set flag (-1 if none) of MODE_MATCH, else None.  words=False
    builds no flag words."""
    M = int(s.shape[0])
    dev = s.device
    cnt = torch.zeros(M, dtype=torch.int64, device=dev)
    emit_words = mode != MODE_COUNT and words
    flagw = torch.zeros((steps // 8, M), dtype=torch.int32, device=dev) \
        if emit_words else None
    firstw = torch.zeros_like(flagw) if mode == MODE_SPAN and words \
        else None
    last = torch.full((M,), -1, dtype=torch.int32, device=dev) \
        if mode == MODE_MATCH else None
    live_len = int(lim.max()) if M else 0
    for t in range(min(steps, -(-live_len // 4))):
        w = word(t)
        for k in range(4):
            live = (t * 4 + k) < lim
            v, hit = _step(mode, tbl, seg, nseg, s, w, k)
            if mode == MODE_COUNT:
                e = v & 31
            elif mode == MODE_SPAN:
                e = (v >> 2) & 7
            elif mode == MODE_FLAG:
                e = (v >> 1) & 1
            elif mode == MODE_RESET:
                e = hit.long()
            else:
                e = v & 1
                last = torch.where(live & (e == 1), t * 4 + k, last)
            cnt += torch.where(live, e, 0)
            sh = (t % 8) * 4 + k
            if emit_words:
                fb = torch.where(live, v & 1, 0).to(torch.int32)
                flagw[t // 8] |= fb << sh
            if firstw is not None:
                gb = torch.where(live, (v >> 1) & 1, 0).to(torch.int32)
                firstw[t // 8] |= gb << sh
            s = torch.where(live, v >> 5, s)
    return cnt, s, flagw, firstw if mode == MODE_SPAN else last


def _lane_words(words, k: int, L: int):
    """Flag words [G, k*L] of sub-lane columns (j, l) -> the lanes' [k*G, L]
    (sub-lane j's groups are rows j*G .. (j+1)*G - 1)."""
    G = int(words.shape[0])
    return words.reshape(G, k, L).permute(1, 0, 2).reshape(k * G, L)


def lane_walk_plain(mode: int, packed, segmap, tiles, W4: int, entries,
                    offsets, limits):
    """Plain torch lane walk (the reference's impl="gather" scan_once), one
    torch step per byte of a sub-lane.  entries [k, L] for k sub-lanes a
    lane; offsets and limits [L]; W4 = 0 walks no warmup (entries are the
    sub-lanes' start states).  Returns (counts, exits, sync, flagw, aux),
    the first three [k, L]; flagw is [T4/8, L] int32 words (None for
    MODE_COUNT); aux is the first-flag words [T4/8, L] of MODE_SPAN, the
    sub-lane-local position of each sub-lane's last set flag [k, L] (-1 if
    none) of MODE_MATCH, else None.  MODE_MATCH counts set flags,
    MODE_RESET the resets that met a live run (segmap: the start states
    [4])."""
    T4, L = (int(x) for x in tiles.shape)
    k = int(entries.shape[0])
    T4k = T4 // k
    dev = tiles.device
    nseg = int(packed.shape[1])
    tbl = table_values(packed)
    seg = None if segmap is None else segmap.long()
    tv = tiles.view(k, T4k, L)
    prev = torch.roll(torch.arange(L, device=dev), 1)

    def warm(tw):
        # sub-lane (0, l) warms up over lane l-1's last W4 words, (j, l)
        # over the W4 words of lane l before its own first word
        return torch.cat([tiles[T4 - W4 + tw][prev],
                          tv[:-1, T4k - W4 + tw].reshape(-1)])

    off = torch.cat([offsets, offsets.new_zeros((k - 1) * L)])
    s = entries.reshape(-1).long()
    for tw in range(W4):
        w = warm(tw)
        for b in range(4):
            nxt = _step(mode, tbl, seg, nseg, s, w, b)[0] >> 5
            s = torch.where((tw * 4 + b) >= off, nxt, s)
    sync = s.to(torch.int32)
    cnt, s, flagw, aux = _walk_plain(
        mode, tbl, seg, nseg, lambda t: tv[:, t].reshape(-1), T4k, s,
        sub_limits(limits, k, T4k * 4))
    if flagw is not None:
        flagw = _lane_words(flagw, k, L)
    if mode == MODE_SPAN:
        aux = _lane_words(aux, k, L)
    elif mode == MODE_MATCH:
        aux = aux.reshape(k, L)
    return (cnt.to(torch.int32).reshape(k, L),
            s.to(torch.int32).reshape(k, L), sync.reshape(k, L), flagw, aux)


def want_of(exits, first: int):
    """The state each sub-lane should enter at: the previous sub-lane's
    exit in corpus order (sub-lane (j, l) is the l*k + j-th), `first` for
    sub-lane (0, 0).  exits [k, L] -> [k, L]."""
    k, L = (int(x) for x in exits.shape)
    flat = exits.t().reshape(-1)
    head = torch.full((1,), first, dtype=flat.dtype, device=flat.device)
    return torch.cat([head, flat[:-1]]).reshape(L, k).t()


def unsettled(exits, sync, limits, first: int, T: int):
    """[k, L] bool: the real sub-lanes whose sync differs from the previous
    sub-lane's exit."""
    k, L = (int(x) for x in exits.shape)
    real = sub_limits(limits, k, T // k).reshape(k, L) > 0
    return real & (sync != want_of(exits, first))


MAP_COLUMNS = 1 << 24   # the most walkers _lane_entries' exit maps take


def _lane_entries(mode, tbl, seg, nseg, tv, lim, want, S: int):
    """The state each sub-lane enters with when every lane walks its k
    sub-lanes in order from want[0] [L] (a sub-lane past the corpus passes
    its entry through): [k, L] int64.  Each sub-lane's exit as a function
    of its entry comes from walking it from all S states at once (no flag
    words; its counts are not read), and the entries from composing those
    maps along the lanes: T/k torch steps, not T.  Past MAP_COLUMNS
    walkers (S x k x L) the entries are a fixpoint instead: from the guess
    `want` [k, L] (the previous pass's exits), every sub-lane walks from
    its entry and each entry becomes its predecessor's exit, until none
    changes.  Round r makes sub-lane r exact, so at most k rounds; a lane
    whose seams settle within a sub-lane takes two or three."""
    k, T4k, L = (int(x) for x in tv.shape)
    dev = tv.device
    entry = want.long().clone()
    if k == 1:
        return entry
    # the step alone matters: MODE_COUNT's emissions are the cheapest
    mode = MODE_RESET if mode == MODE_RESET else MODE_COUNT
    if S * k * L <= MAP_COLUMNS:
        _, ex, _, _ = _walk_plain(
            mode, tbl, seg, nseg,
            lambda t: tv[:, t].reshape(-1).repeat(S), T4k,
            torch.arange(S, device=dev).repeat_interleave(k * L),
            lim.reshape(-1).repeat(S), words=False)
        exit_of = ex.view(S, k, L)
        cols = torch.arange(L, device=dev)
        s = entry[0]
        for j in range(k):
            entry[j] = s
            s = exit_of[s, j, cols]
        return entry
    for _ in range(k):
        _, ex, _, _ = _walk_plain(mode, tbl, seg, nseg,
                                  lambda t: tv[:, t].reshape(-1), T4k,
                                  entry.reshape(-1), lim.reshape(-1),
                                  words=False)
        nxt = torch.cat([entry[:1], ex.view(k, L)[:-1]])
        if torch.equal(nxt, entry):
            break
        entry = nxt
    return entry


def lane_repair_plain(mode: int, whole: bool, packed, segmap, tiles,
                      first: int, limits, prev, exits, counts, sync, flagw,
                      aux, walked):
    """One repair pass of the plain version, in place: every unsettled
    sub-lane (whole=False), or every lane holding one (whole=True), walks
    again from the previous exit in `prev` [k, L], with no warmup; the
    walkers rewrite their sync, counts, flag groups and (MODE_MATCH) last
    flag, `exits` gets every sub-lane's exit (the settled ones, and the
    ones past the corpus, which nothing reads, copy theirs from prev), and
    walked[0] the number of walkers."""
    T4, L = (int(x) for x in tiles.shape)
    k = int(prev.shape[0])
    T4k, G = T4 // k, T4 // k // 8
    nseg = int(packed.shape[1])
    tbl = table_values(packed)
    seg = None if segmap is None else segmap.long()
    lim = sub_limits(limits, k, T4k * 4).reshape(k, L)
    want = want_of(prev, first)
    bad = (lim > 0) & (sync != want)

    def commit(rows, sel, c, s_in, s_out, fw, a):
        sync[rows] = torch.where(sel, s_in.to(torch.int32), sync[rows])
        counts[rows] = torch.where(sel, c.to(torch.int32), counts[rows])
        exits[rows] = torch.where(sel, s_out.to(torch.int32), prev[rows])
        if mode == MODE_MATCH:
            aux[rows] = torch.where(sel, a.reshape(sel.shape), aux[rows])
        for out, w in ((flagw, fw), (aux, a if mode == MODE_SPAN else None)):
            if w is not None:
                lw = _lane_words(w, int(sel.numel()) // L, L).reshape(
                    -1, G, L)
                cur = out.view(k, G, L)[rows]
                out.view(k, G, L)[rows] = torch.where(
                    sel.reshape(-1, 1, L), lw, cur.reshape(-1, G, L)
                ).reshape(cur.shape)

    tv = tiles.view(k, T4k, L)

    def walk(entry):
        return _walk_plain(mode, tbl, seg, nseg,
                           lambda t: tv[:, t].reshape(-1), T4k,
                           entry.reshape(-1).long(), lim.reshape(-1))

    if whole:
        # a lane walks from want[0] through its k sub-lanes in order
        lanes = bad.any(dim=0)
        sel = lanes[None, :].expand(k, L)
        entry = _lane_entries(mode, tbl, seg, nseg, tv, lim, want,
                              int(packed.shape[0]))
        c, s2, fw, a = walk(entry)
        walked.fill_(int(lanes.sum()))
    else:
        sel, entry = bad, want
        c, s2, fw, a = walk(entry)
        walked.fill_(int(bad.sum()))
    commit(slice(None), sel, c.reshape(k, L), entry, s2.reshape(k, L), fw,
           a)


def _check_lane_args(mode, packed, segmap, tiles, W4, entries, offsets,
                     limits):
    dev = tiles.device
    T4, L = (int(x) for x in tiles.shape)
    named = [("packed", packed), ("tiles", tiles), ("entries", entries),
             ("offsets", offsets), ("limits", limits)]
    if segmap is not None:
        named.append(("segmap", segmap))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, tiles on {dev}")
        if t.dtype != torch.int32 and not (name == "packed"
                                           and t.dtype == torch.int16):
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if packed.dim() != 2:
        raise ValueError("packed must be [S, NSEG]")
    S, nseg = (int(x) for x in packed.shape)
    # the table's instance follows its residency (table_fits)
    check_table(S, nseg)
    if packed.dtype == torch.int16 and S > MAX16_ROWS:
        raise ValueError(f"a 16-bit table holds at most {MAX16_ROWS} rows")
    if packed.data_ptr() % 4:
        raise ValueError("packed must be 4-byte aligned")
    if mode == MODE_RESET and nseg > 32:
        raise ValueError(f"reset table [{S}, {nseg}]: at most 32 columns")
    if entries.dim() != 2 or int(entries.shape[1]) != L:
        raise ValueError(f"entries must have shape (k, {L})")
    k = int(entries.shape[0])
    if k & (k - 1) or (T4 // 8) % k:
        raise ValueError(f"entries of shape {tuple(entries.shape)}: lanes "
                         f"split into a power of two that divides T4/8 = "
                         f"{T4 // 8}")
    for name, t in (("offsets", offsets), ("limits", limits)):
        if tuple(t.shape) != (L,):
            raise ValueError(f"{name} must have shape ({L},)")
    seg_len = 4 if mode == MODE_RESET else 256
    if segmap is not None and tuple(segmap.shape) != (seg_len,):
        raise ValueError(f"segmap must have shape ({seg_len},)")
    if T4 % 8 or not 0 <= W4 <= T4 // k:
        raise ValueError(f"bad tile geometry T4={T4} W4={W4} k={k}")


# a lane walk's place for its table (csrc/lane_scan.cu's Place): by the
# rule (lane_instance), or global or shared memory as a check names it
PLACES = {None: -1, "global": 0, "shared": 1}


def lane_walk_cuda(mode: int, packed, segmap, tiles, W4: int, entries,
                   offsets, limits, place: Optional[str] = None):
    """Launch csrc/lane_scan.cu (pass 0); same outputs as lane_walk_plain.
    `place` ("global", "shared"; None: the table's own, lane_instance)
    names the table's instance, for a check that holds each instance
    against the plain version (the kernel refuses a table that does not
    fit shared memory)."""
    _check_lane_args(mode, packed, segmap, tiles, W4, entries, offsets,
                     limits)
    T4, L = (int(x) for x in tiles.shape)
    S, nseg = (int(x) for x in packed.shape)
    k = int(entries.shape[0])
    dev = tiles.device
    counts, exits, sync = (torch.empty(entries.shape, dtype=torch.int32,
                                       device=dev) for _ in range(3))
    flagw = aux = None
    if mode != MODE_COUNT:
        flagw = torch.empty((T4 // 8, L), dtype=torch.int32, device=dev)
    if mode == MODE_SPAN:
        aux = torch.empty_like(flagw)
    elif mode == MODE_MATCH:
        aux = torch.empty(entries.shape, dtype=torch.int32, device=dev)
    lib = _build.lib()
    p = _build.ptr
    tb = (PLACES[place], p(packed), packed.element_size(), S, nseg)
    with torch.cuda.device(dev):
        st = _build.stream(dev)
        if mode == MODE_COUNT:
            rc = lib.cgx_lane_count(
                PASS_FIRST, *tb, p(segmap), p(tiles), T4, L,
                W4, k, p(entries), p(offsets), p(limits), 0, None, p(counts),
                p(exits), p(sync), None, st)
        elif mode == MODE_SPAN:
            rc = lib.cgx_lane_span(
                PASS_FIRST, *tb, p(segmap), p(tiles), T4, L,
                W4, k, p(entries), p(offsets), p(limits), 0, None, p(counts),
                p(exits), p(sync), p(flagw), p(aux), None, st)
        elif mode == MODE_MATCH:
            rc = lib.cgx_lane_match(
                PASS_FIRST, *tb, p(segmap), p(tiles), T4, L,
                W4, k, p(entries), p(offsets), p(limits), 0, None, p(counts),
                p(exits), p(sync), p(flagw), p(aux), None, st)
        elif mode == MODE_RESET:
            rc = lib.cgx_lane_reset(
                PASS_FIRST, *tb, p(segmap), p(tiles), T4, L,
                W4, k, p(entries), p(offsets), p(limits), 0, None, p(counts),
                p(exits), p(sync), p(flagw), None, st)
        else:
            rc = lib.cgx_lane_flag(
                PASS_FIRST, *tb, p(tiles), T4, L, W4, k,
                p(entries), p(offsets), p(limits), 0, None, p(counts),
                p(exits), p(sync), p(flagw), None, st)
    _build.check(rc, "lane_scan")
    return counts, exits, sync, flagw, aux


def lane_repair_cuda(mode: int, whole: bool, packed, segmap, tiles,
                     first: int, limits, prev, exits, counts, sync, flagw,
                     aux, walked, place: Optional[str] = None):
    """Launch one repair pass of csrc/lane_scan.cu (K1, K2, K3, K9 or the
    reset scan); same in-place outputs as lane_repair_plain.  `place` as
    lane_walk_cuda's."""
    _check_lane_args(mode, packed, segmap, tiles, 1, prev, limits, limits)
    for name, t in (("exits", exits), ("counts", counts), ("sync", sync)):
        if (t.shape != prev.shape or t.dtype != torch.int32
                or not t.is_contiguous() or t.device != tiles.device):
            raise ValueError(f"{name} must be int32 like prev")
    if walked.dtype != torch.int32 or walked.device != tiles.device:
        raise ValueError("walked must be an int32 tensor beside the tiles")
    T4, L = (int(x) for x in tiles.shape)
    S, nseg = (int(x) for x in packed.shape)
    k = int(prev.shape[0])
    lib = _build.lib()
    p = _build.ptr
    tb = (PLACES[place], p(packed), packed.element_size(), S, nseg)
    how = PASS_LANE if whole else PASS_SUB
    with torch.cuda.device(tiles.device):
        st = _build.stream(tiles.device)
        if mode == MODE_COUNT:
            rc = lib.cgx_lane_count(
                how, *tb, p(segmap), p(tiles), T4, L, 0, k,
                None, None, p(limits), first, p(prev), p(counts), p(exits),
                p(sync), p(walked), st)
        elif mode == MODE_SPAN:
            rc = lib.cgx_lane_span(
                how, *tb, p(segmap), p(tiles), T4, L, 0, k,
                None, None, p(limits), first, p(prev), p(counts), p(exits),
                p(sync), p(flagw), p(aux), p(walked), st)
        elif mode == MODE_MATCH:
            rc = lib.cgx_lane_match(
                how, *tb, p(segmap), p(tiles), T4, L, 0, k,
                None, None, p(limits), first, p(prev), p(counts), p(exits),
                p(sync), p(flagw), p(aux), p(walked), st)
        elif mode == MODE_RESET:
            rc = lib.cgx_lane_reset(
                how, *tb, p(segmap), p(tiles), T4, L, 0, k,
                None, None, p(limits), first, p(prev), p(counts), p(exits),
                p(sync), p(flagw), p(walked), st)
        else:
            rc = lib.cgx_lane_flag(
                how, *tb, p(tiles), T4, L, 0, k, None, None,
                p(limits), first, p(prev), p(counts), p(exits), p(sync),
                p(flagw), p(walked), st)
    _build.check(rc, "lane_scan")


def lane_walk(mode: int, counter: LaunchCounter, packed, segmap, tiles,
              W4: int, entries, offsets, limits):
    """The lane walk on the tiles' device: the kernel for CUDA tensors
    (counted on `counter`), the plain version for CPU tensors."""
    if tiles.device.type == "cuda":
        out = lane_walk_cuda(mode, packed, segmap, tiles, W4, entries,
                             offsets, limits)
        _count_launch(mode, counter, packed)
        return out
    if tiles.device.type != "cpu":
        raise ValueError(f"unsupported device {tiles.device}")
    return lane_walk_plain(mode, packed, segmap, tiles, W4, entries,
                           offsets, limits)


def lane_repair(mode: int, counter: LaunchCounter, whole: bool, *args):
    """One repair pass on the tiles' device (args as lane_repair_plain's
    after `whole`): the kernel for CUDA tensors, counted on `counter`."""
    tiles = args[2]
    if tiles.device.type == "cuda":
        lane_repair_cuda(mode, whole, *args)
        _count_launch(mode, counter, args[0])
    elif tiles.device.type == "cpu":
        lane_repair_plain(mode, whole, *args)
    else:
        raise ValueError(f"unsupported device {tiles.device}")


def resident_warps(mode: int, S: int, nseg: int,
                   vbytes: Optional[int] = None) -> Tuple[int, int]:
    """(warps that one SM holds at once, threads a block) of a lane walk's
    pass 0 on an [S, nseg] table of vbytes-byte values (value_bytes(S)
    when None), in the instance the table takes (lane_instance), from the
    CUDA occupancy calculator at the launch's own block size."""
    vb = value_bytes(S) if vbytes is None else vbytes
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.lib().cgx_lane_occupancy(
        mode, vb, S, nseg, ctypes.byref(blocks), ctypes.byref(threads)),
        "lane_scan")
    return blocks.value * threads.value // 32, threads.value


def count_lanes(packed, segmap, tiles, W4, entries, offsets, limits):
    """K1: (counts, exits, sync) of one count-transducer pass."""
    return lane_walk(MODE_COUNT, COUNT_KERNEL, packed, segmap, tiles, W4,
                     entries, offsets, limits)[:3]


def lane_aggregates(counts, exits, sync):
    """Per-lane outputs [L] of a split walk's [k, L] ones: counts summed
    over the sub-lanes, the last sub-lane's exit, the first one's sync."""
    return counts.sum(dim=0, dtype=torch.int32), exits[-1], sync[0]


# ---------------------------------------------------------------------------
# Full count: warmup guess + host-driven repair fixpoint + EOI
# ---------------------------------------------------------------------------

def _byte_ctx(b):
    is_word = (((b >= 48) & (b <= 57)) | ((b >= 65) & (b <= 90))
               | (b == 95) | ((b >= 97) & (b <= 122)))
    return torch.where(is_word, CTX_WORD,
                       torch.where(b == 10, CTX_NL, CTX_OTHER))


def first_pass_inputs(starts, data_u8, n: int, L: int, T: int, W: int,
                      k: int = 1):
    """(entries0 [k, L], offsets0 [L], limits [L]) of a transducer scan's
    first pass over k sub-lanes a lane: each sub-lane's entry guessed from
    the byte before its warmup window, sub-lane (0, 0) at the true start
    (ref. _count_full:358-380)."""
    dev = data_u8.device
    lane_ids = torch.arange(L, dtype=torch.int32, device=dev)
    sub = torch.arange(k, dtype=torch.int32, device=dev) * (T // k)
    guess_pos = lane_ids[None, :] * T + sub[:, None] - W - 1
    prev_b = data_u8[guess_pos.clamp(0, max(n - 1, 0)).long()].to(
        torch.int32)
    ctx = _byte_ctx(prev_b)
    entries0 = torch.where(guess_pos < 0, starts[CTX_SOT],
                           starts[ctx.long()])
    entries0[0, 0] = starts[CTX_SOT]
    offsets0 = torch.zeros(L, dtype=torch.int32, device=dev)
    offsets0[0] = W
    limits = (n - lane_ids * T).clamp(0, T)
    return entries0.contiguous(), offsets0, limits.contiguous()


def split_fixpoint(mode: int, counter: LaunchCounter, d: "DeviceCountDFA",
                   tiles, W: int, entries0, offsets0, limits,
                   max_repair: int, dead: Optional[int] = None):
    """K1, K2, K3, K9 or the reset scan over the sub-lanes of entries0 [k,
    L], repaired until every real sub-lane's sync equals the previous
    sub-lane's exit (d.sot for sub-lane (0, 0)).  d holds the walk's
    tables: packed, segmap (None for K3, the start states for the reset
    scan) and sot.  W = 0 walks pass 0 with no warmup.  Returns
    ((counts, exits, sync, flagw, aux), converged), the first three [k, L].

    Pass 0 walks every sub-lane after its warmup.  Each repair pass walks
    only what is unsettled, from the previous pass's exits with no warmup:
    the kernel tests each sub-lane against the exits it reads, and a thread
    with nothing to walk returns after reading two ints, so no compacted
    list is built and the host needs no check of its own; a pass that
    walks nothing ends the loop (one host sync a pass).  First up to
    SUB_PASSES passes over the unsettled sub-lanes, which settle a state
    reaching back less than a sub-lane; then passes over the lanes holding
    one, each lane walking whole from the previous lane's exit, so its own
    seams agree by construction.  A lane pass enters the first unsettled
    lane at an exact state, so it makes at least one more lane exact: at
    most L lane passes settle any input, as L rescans of every lane would,
    and each walks only the lanes that need it.  The loop is
    split_passes, which K7 (seq_scan.SeqScanner) runs too.  At most
    max_repair passes walk; converged says whether the last one settled.

    dead (K9): a state that is absorbing and raises no flag.  Then every
    pass, pass 0 included, ends in the host sync of _finished, which also
    cuts the scan at an exact dead sub-lane; a repair pass runs only when
    a sub-lane is unsettled, so it always walks and its walkers' count is
    not read.  Without the cut a break-at-match DFA that dies early takes
    SUB_PASSES passes, then up to L lane passes that each carry the dead
    state one lane further."""
    counts, exits, sync, flagw, aux = lane_walk(
        mode, counter, d.packed, d.segmap, tiles, W // 4, entries0, offsets0,
        limits)
    T = int(tiles.shape[0]) * 4

    def repair(whole, prev, out, walked):
        lane_repair(mode, counter, whole, d.packed, d.segmap, tiles, d.sot,
                    limits, prev, out, counts, sync, flagw, aux, walked)

    finished = None if dead is None else (
        lambda ex: _finished(counts, ex, sync, flagw, aux, limits, d.sot, T,
                             dead))
    exits, conv = split_passes(counter, exits, repair, max_repair, finished)
    if conv is None:
        conv = not bool(unsettled(exits, sync, limits, d.sot, T).any())
    return (counts, exits, sync, flagw, aux), conv


def split_passes(counter: LaunchCounter, exits, repair, max_repair: int,
                 finished=None):
    """The repair passes of a split walk (split_fixpoint's schedule), after
    its pass 0 gave exits [k, L].  repair(whole, prev, out, walked) runs
    one pass: the unsettled sub-lanes (whole=False) or the lanes holding
    one walk from the exits in prev, every sub-lane's exit goes to out, and
    walked [1] gets the walkers; each pass that walks is counted on
    `counter`.  Up to SUB_PASSES sub-lane passes (none when k = 1), then
    lane passes, at most max_repair in all.  finished(exits), when given,
    is tested before each pass (one host sync), else walked after it: a
    pass that walks nothing ends the loop.  Returns (exits, converged):
    True when settled, None when max_repair passes ran first (the caller
    tests its own outputs)."""
    spare = torch.empty_like(exits)
    walked = torch.zeros(1, dtype=torch.int32, device=exits.device)
    whole = int(exits.shape[0]) == 1
    passes = subs = 0
    while True:
        if finished is not None and finished(exits):
            return exits, True
        if passes >= max_repair:
            return exits, None
        repair(whole, exits, spare, walked)
        exits, spare = spare, exits
        if finished is None and int(walked[0]) == 0:
            return exits, True
        passes += 1
        if whole:
            counter.lane_passes += 1
        else:
            counter.sub_passes += 1
            subs += 1
            whole = subs >= SUB_PASSES


def _finished(counts, exits, sync, flagw, last, limits, first: int, T: int,
              dead: int) -> bool:
    """Whether a K9 scan is done, from one host sync: every real sub-lane
    is settled, or the first real sub-lane (in corpus order, q = l*k + j)
    that exits `dead` comes before the first unsettled one.  Its exit is
    then exact, so every later sub-lane is set, in place, to what the
    absorbing state gives: no flag words, count 0, last -1, exit `dead`
    (the cut).  The limits are first_pass_inputs': they sum to n, and the
    real sub-lanes are those with q*T/k < n."""
    k, L = (int(x) for x in exits.shape)
    q = torch.arange(k * L, device=exits.device)
    real = q * (T // k) < limits.sum()
    ex = exits.t().reshape(-1)
    want = F.pad(ex[:-1], (1, 0), value=first)
    bad = torch.where(real & (sync.t().reshape(-1) != want), q, k * L)
    died = torch.where(real & (ex == dead), q, k * L)
    fb, fd = torch.stack([bad.min(), died.min()]).tolist()
    if fd < fb:
        after = (q > fd).view(L, k).t()
        counts.masked_fill_(after, 0)
        last.masked_fill_(after, -1)
        exits.masked_fill_(after, dead)
        flagw.view(k, -1, L).masked_fill_(after[:, None, :], 0)
        return True
    return fb == k * L


def settled(converged: bool, what: str) -> None:
    """Raise if a fixpoint run with max_repair = L + SUB_PASSES did not
    converge (it cannot: see split_fixpoint)."""
    if not converged:
        raise RuntimeError(f"{what}: repair fixpoint did not settle")


def state_at_end(exits, n: int, L: int, T: int):
    """Exit state of the sub-lane holding byte n-1, from exits [k, L]."""
    k = int(exits.shape[0])
    q = min(max((n - 1) // (T // k), 0), k * L - 1)
    return exits[q % k, q // k].long()


def count_full(d: DeviceCountDFA, data_u8, tiles, n: int, L: int, T: int,
               W: int, max_repair: int = 4, k: int = 1):
    """Returns (count as a 0-dim int64 tensor, converged bool), walking k
    sub-lanes a lane."""
    entries0, offsets0, limits = first_pass_inputs(d.starts, data_u8, n,
                                                   L, T, W, k)
    (counts, exits, _sync, _fw, _aux), converged = split_fixpoint(
        MODE_COUNT, COUNT_KERNEL, d, tiles, W, entries0, offsets0, limits,
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
        """Exact count for the device corpus, each lane split into
        lane_split(T, W) sub-lanes.  The repair fixpoint runs until it
        settles (the reference stops after 4 rescans and falls back to its
        host loop).  `tiles`: the corpus's word tiles under
        the geometry (built when None)."""
        n = int(data_dev.shape[0])
        if n == 0:
            return int(self.cd.eoi_commits[self.cd.starts[CTX_SOT],
                                           CTX_SOT])
        L, T, W, _Lc = geometry or plan_geometry(n)
        if tiles is None:
            tiles = make_word_tiles(data_dev, L, T // 4)
        total, conv = count_full(self.dcd, data_dev, tiles, n, L, T, W,
                                 max_repair=L + SUB_PASSES,
                                 k=lane_split(T, W))
        settled(conv, "count scan")
        return int(total)
