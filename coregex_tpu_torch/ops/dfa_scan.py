"""Dense-DFA scans on a torch device: the chunked match scan (K9) and the
window-flag scan.

Ports from ``coregex_tpu/ops/dfa_scan.py``:

* ``DeviceDFA.from_dense`` (:84-121) as ``DFATables.from_dense``: tables
  expanded from byte classes to byte SEGMENTS (maximal byte ranges of
  constant class) and padded to power-of-two buckets, as the reset flag
  scan reads them, plus the packed ``delta*32 + match`` table over the
  unpadded segments with its byte -> segment map, the EOI flags and the
  start states, as the match and window scans read them.  The reference's
  ``comb`` onehot table serves only the TPU's matmul step and is left out.
* ``ChunkScanner`` (:290-413) with ``scan_device`` and ``scan``: the
  chunked full-corpus match-flag scan.  The TPU runs it as the Pallas
  kernel K9, ``coregex_tpu/ops/pallas_scan.py:35`` ``_kernel``
  (``pallas_call`` at :101), a select tree over a 4-byte class stream, or
  as the XLA ``_chunk_scan_full``; here it is K1's lane walk in
  ``MODE_MATCH`` (``csrc/lane_scan.cu`` ``cgx_lane_match``) over the
  corpus word tiles, split as K1 into k = ``lane_split(T, W)`` sub-lanes a
  lane and repaired by ``count_scan.split_fixpoint``: the match flag of
  every position below the lane's limit as bit words, each sub-lane's
  flag count and last flag position, exits and sync.  K9's ``offsets``
  are the walk's warmup offsets and its ``true_steps`` the per-lane
  limits.  Lanes follow ``plan_geometry`` (at most 8192, where the
  reference's ``_plan_geometry`` takes up to 65536); settled results do
  not depend on the geometry.  The reference splits scans past
  ``SEG_LIMIT`` = 2^29 bytes only for its remote compiler; the port scans
  any corpus in one pass.
* ``flags_count_upto`` (:432-442) and ``flags_last`` (:445-451), from the
  sub-lanes' counts and last positions.
* ``_window_scan_flags`` (:626-674), a ``lax.scan`` loop with no Pallas
  kernel, as ``window_flags``: ``csrc/window_scan.cu``
  ``cgx_window_flags``, one thread per anchored run, walking the corpus
  in 16-byte chunks; and its composition with the last flag as the ends
  form ``window_ends_round`` (``cgx_window_ends``, the same walk): each
  run's last flagged column kept in a register, no bitmap.
* ``WindowScanner.ends_for_starts_device`` (:591-622) as ``window_ends``:
  the ends form forward from every start, one launch a round, the lanes
  still alive compacted by K4 and rerun at four times the window until
  none lives.
* ``_chunk_scan_reset`` (:685-778), a ``lax.scan`` in a ``while_loop``
  repair with no Pallas kernel, behind ``ResetScanner`` (:781-849): the
  lane walk in ``MODE_RESET`` (``cgx_lane_reset``), split and repaired as
  K9, in one launch a pass where the reference goes a 2^29-byte segment
  at a time.

K9 and the window scan hold the packed table (16-bit values up to
``count_scan.MAX16_ROWS`` rows, ``count_scan.packed_device``) in shared
memory where that keeps enough warps resident (``count_scan.lane_instance``,
``window_plan``) and read it from global memory otherwise, so a table of
any size that the host pipeline builds (a list of hundreds of keywords:
0.25-1 MB) runs on the card.

The lanes freeze at their limit, so every flag lies below n.  The
reference also counts the flag at n, which the first NUL pad byte raises;
a flag that the pad raises at n implies the EOI flag at the same state (the
pad byte is a non-word, non-newline byte, and end of text satisfies every
assertion such a byte satisfies), so the exact EOI check at the exit state
gives the same answers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..dfa.dense import CTX_SOT, DEAD, DenseDFA
from . import _build
from .compact2 import compact_pay, pack_words
from .bytescan import _bucket
from .count_scan import (MAX16_ROWS, MODE_MATCH, MODE_RESET, SMEM_LIMIT,
                         SUB_PASSES, LaunchCounter, _byte_ctx, check_table,
                         device_table, first_pass_inputs, lane_pitch,
                         lane_split, make_word_tiles, packed_device,
                         plan_geometry, segment_map, settled, split_fixpoint,
                         state_at_end, table_values, value_bytes)
from .span_chain import _floor_log2
from .span_scan import to_global

MATCH_KERNEL = LaunchCounter("match_scan")
WINDOW_KERNEL = LaunchCounter("window_scan")
WINDOW_ENDS_KERNEL = LaunchCounter("window_ends")
# launches of the window scan's global-memory instance (a table past
# shared memory), counted beside the form's own counter
WINDOW_GLOBAL = {WINDOW_KERNEL: LaunchCounter("window_scan_global"),
                 WINDOW_ENDS_KERNEL: LaunchCounter("window_ends_global")}


@dataclass
class DFATables:
    delta: np.ndarray        # [SP, CP] int32 (segment columns, padded)
    match_on: np.ndarray     # [SP, CP] bool
    bounds: np.ndarray       # [NB] int32 segment boundaries, padded with 256
    host_starts: np.ndarray  # [4]
    match_eoi: np.ndarray    # [S, 4] bool
    packed: np.ndarray       # [S, nseg] int32 delta*32 + match (unpadded)
    segmap: np.ndarray       # [256] int32 byte -> segment

    @classmethod
    def from_dense(cls, dfa: DenseDFA) -> "DFATables":
        S, _C0 = dfa.delta.shape
        bounds, segmap = segment_map(dfa.classes)
        nseg = len(bounds) + 1
        seg_cls = np.asarray(dfa.classes)[
            np.concatenate([np.zeros(1, np.int64), bounds])]
        SP, CP = _bucket(S, 8), _bucket(nseg, 4)
        delta = np.zeros((SP, CP), dtype=np.int32)
        match = np.zeros((SP, CP), dtype=bool)
        delta[:S, :nseg] = dfa.delta[:, seg_cls]
        match[:S, :nseg] = dfa.match_on[:, seg_cls]
        NB = _bucket(max(len(bounds), 1), 4)
        bpad = np.full(NB, 256, dtype=np.int32)
        bpad[:len(bounds)] = bounds
        packed = delta[:S, :nseg] * 32 + match[:S, :nseg].astype(np.int32)
        return cls(delta=delta, match_on=match, bounds=bpad,
                   host_starts=np.asarray(dfa.starts),
                   match_eoi=np.asarray(dfa.match_eoi, dtype=bool),
                   packed=packed, segmap=segmap)


class MatchTables:
    """The packed match table (int16 bits of 16-bit values up to
    MAX16_ROWS rows, else int32), byte map, EOI flags [S, 4], start states
    [4] and true start state (sot) of a DFATables on a torch device: the
    inputs of K9 and of the window scan, in shared or global memory as the
    table's residency sets (count_scan.lane_instance, window_plan)."""

    def __init__(self, t: DFATables, device):
        self.device = torch.device(device)
        self.S, self.NSEG = (int(x) for x in t.packed.shape)
        check_table(self.S, self.NSEG)
        self.packed = packed_device(t.packed, self.device)
        self.segmap = device_table(t.segmap, self.device)
        self.eoi = device_table(t.match_eoi.astype(np.int32), self.device)
        self.starts = device_table(t.host_starts, self.device)
        self.sot = int(t.host_starts[CTX_SOT])


# ---------------------------------------------------------------------------
# The chunked match scan (K9)
# ---------------------------------------------------------------------------

def match_full(mt: MatchTables, data_u8, tiles, n: int, L: int, T: int,
               W: int, k: int):
    """One settled match scan over k sub-lanes a lane: (flagw, counts,
    last, exits) with every sub-lane exact, the last three [k, L].  The
    fixpoint (``count_scan.split_fixpoint``) walks again only unsettled
    sub-lanes, then lanes, with one cut: a sub-lane that ends DEAD on the
    exact chain ends the scan, since DEAD is absorbing and raises no flag,
    so the sub-lanes after it are DEAD with no flags and are set so.  The
    cut is tested with the settling in each pass's one host sync, pass 0
    included, so an early match ends a break-at-match scan after pass 0
    (the reference gives up after 4 rescans and scans on its host)."""
    entries, offsets, limits = first_pass_inputs(mt.starts, data_u8, n, L,
                                                 T, W, k)
    (counts, exits, _sync, fw, last), conv = split_fixpoint(
        MODE_MATCH, MATCH_KERNEL, mt, tiles, W, entries, offsets, limits,
        L + SUB_PASSES, dead=DEAD)
    settled(conv, "match scan")
    return fw, counts, last, exits


class MatchScan(NamedTuple):
    """A settled match scan of n bytes under geometry (L, T), k sub-lanes
    a lane (row j of the [k, L] outputs: sub-lanes (j, .))."""
    flagw: torch.Tensor     # [T4/8, L] time-major flag words
    counts: torch.Tensor    # [k, L] set flags per sub-lane
    last: torch.Tensor      # [k, L] sub-lane-local last flag position or -1
    exits: torch.Tensor     # [k, L] sub-lane exit states
    n: int
    L: int
    T: int


def flags_count_upto(scan: MatchScan) -> torch.Tensor:
    """Set flags at offsets < n, as a 0-dim int64 device tensor (the
    reference's flags_count_upto also counts the flag at n; the port
    answers that with the EOI check, see the module docstring)."""
    return scan.counts.sum(dtype=torch.int64)


def flags_last(scan: MatchScan) -> torch.Tensor:
    """Largest set flag offset < n, or -1, as a 0-dim int64 device tensor:
    sub-lane (j, l) starts at l*T + j*T/k."""
    k = int(scan.last.shape[0])
    dev = scan.last.device
    base = (torch.arange(scan.L, dtype=torch.int64, device=dev)[None, :]
            * scan.T + torch.arange(k, dtype=torch.int64,
                                    device=dev)[:, None] * (scan.T // k))
    return torch.where(scan.last >= 0, base + scan.last, -1).max()


def exit_at_end(scan: MatchScan) -> torch.Tensor:
    """The exact state at offset n (0-dim device tensor): the exit of the
    sub-lane holding byte n-1.  The reference replays that lane's tail on
    its host (:378-396); the lanes here freeze at their limits."""
    return state_at_end(scan.exits, scan.n, scan.L, scan.T)


class ChunkScanner:
    """Full-corpus match-flag scan with exact lane seams (ref.
    ChunkScanner).  ``scan_device`` keeps everything on the device;
    ``scan`` is the host-facing form the tests use."""

    def __init__(self, tables: DFATables, device):
        self.tables = tables
        self.mt = MatchTables(tables, device)

    def scan_device(self, data_dev: torch.Tensor,
                    geometry: Optional[Tuple[int, int, int, int]] = None,
                    tiles: Optional[torch.Tensor] = None) -> MatchScan:
        """The settled scan of a non-empty device corpus over
        lane_split(T, W) sub-lanes a lane; `tiles` are its word tiles under
        the geometry (built when None)."""
        n = int(data_dev.shape[0])
        L, T, W, _Lc = geometry or plan_geometry(n)
        if tiles is None:
            tiles = make_word_tiles(data_dev, L, T // 4)
        fw, counts, last, exits = match_full(self.mt, data_dev, tiles, n, L,
                                             T, W, lane_split(T, W))
        return MatchScan(fw, counts, last, exits, n, L, T)

    def scan(self, data_dev: torch.Tensor) -> Tuple[np.ndarray, int]:
        """Host-facing: (flags bool [n+1], exit state at n); flags[n] is
        the EOI flag at that state."""
        n = int(data_dev.shape[0])
        if n == 0:
            s0 = int(self.tables.host_starts[CTX_SOT])
            return np.array([bool(self.tables.match_eoi[s0, CTX_SOT])]), s0
        sc = self.scan_device(data_dev)
        words = to_global(sc.flagw, n).cpu().numpy()
        out = np.zeros(n + 1, dtype=bool)
        out[:n] = np.unpackbits(words.view(np.uint8),
                                bitorder="little")[:n].astype(bool)
        exit_state = int(exit_at_end(sc))
        out[n] = bool(self.tables.match_eoi[exit_state, CTX_SOT])
        return out, exit_state




# ---------------------------------------------------------------------------
# The window scan: flags form and ends form
# ---------------------------------------------------------------------------

def window_words(W: int) -> int:
    """Flag words per lane of a W-byte window (W + 1 columns)."""
    return (W + 1 + 31) // 32


def window_flags_plain(packed, segmap, eoi, starts_tbl, data, reverse: bool,
                       starts, edge, W: int):
    """Plain torch window-flag scan (the reference's impl="gather"
    _window_scan_flags): B anchored runs of at most W steps.  Returns
    (flagw [NW, B] int32, bit t%32 of word t/32 = column t of a lane,
    alive [B] int32).  With `reverse` the scan reads data backwards
    (scanned position j = byte n-1-j).  `edge` None means n for every
    lane.  See csrc/window_scan.cu for the semantics."""
    dev = data.device
    n = int(data.shape[0])
    B = int(starts.shape[0])
    nseg = int(packed.shape[1])
    tbl = table_values(packed)
    seg = segmap.long()
    eoi4 = eoi.reshape(-1).long()

    def byte_at(j):
        j = j.clamp(0, n - 1)
        return data[n - 1 - j if reverse else j].long()

    st0 = starts.long()
    cut = (torch.full_like(st0, n) if edge is None
           else edge.long().clamp(max=n))
    s = starts_tbl.long()[torch.where(st0 == 0, CTX_SOT,
                                      _byte_ctx(byte_at(st0 - 1)))]
    cut_ctx = torch.where(cut >= n, CTX_SOT, _byte_ctx(byte_at(cut)))
    NW = window_words(W)
    flags = torch.zeros((NW * 32, B), dtype=torch.bool, device=dev)
    for t in range(W):
        pos = st0 + t
        valid = pos < cut
        v = tbl[s * nseg + seg[byte_at(pos)]]
        at_cut = ~valid & (pos == cut) & (s != DEAD)
        flags[t] = (valid & ((v & 1) == 1)) | (
            at_cut & (eoi4[s * 4 + cut_ctx] == 1))
        s = torch.where(valid, v >> 5, DEAD)
    end = st0 + W
    live = s != DEAD
    flags[W] = (end == cut) & live & (eoi4[s * 4 + cut_ctx] == 1)
    alive = (live & (end < cut)).to(torch.int32)
    flagw = pack_words(flags.t().contiguous().reshape(-1), B * NW)
    return flagw.reshape(B, NW).t().contiguous(), alive


def window_last(flagw):
    """Last set column of each lane of a window-flag bitmap [NW, B], or -1:
    the length of the longest anchored match from the lane's start that
    the run flagged."""
    base = torch.arange(int(flagw.shape[0]), dtype=torch.int32,
                        device=flagw.device)[:, None] * 32
    return torch.where(flagw != 0, base + _floor_log2(flagw),
                       -1).amax(dim=0)


def window_ends_plain(packed, segmap, eoi, starts_tbl, data, reverse: bool,
                      starts, edge, W: int, idx=None, out=None,
                      alive_u8: bool = False):
    """Plain torch ends form: window_flags_plain followed by each lane's
    last flag (the reference's composition).  Lane b's end, start + its
    last flagged column or -1, goes to out[idx[b]] (out[b] without idx;
    `out` is allocated when None, and required with idx).  Returns (out,
    alive [B], uint8 with alive_u8, else int32)."""
    flagw, alive = window_flags_plain(packed, segmap, eoi, starts_tbl, data,
                                      reverse, starts, edge, W)
    top = window_last(flagw)
    e = torch.where(top >= 0, starts + top, -1).to(torch.int32)
    if idx is not None:
        out.index_copy_(0, idx.long(), e)
    elif out is None:
        out = e
    else:
        out.copy_(e)
    return out, alive.to(torch.uint8) if alive_u8 else alive


def _check_window_args(packed, segmap, eoi, starts_tbl, data, starts, edge,
                       W, idx=None, out=None):
    dev = data.device
    named = [("packed", packed), ("segmap", segmap), ("eoi", eoi),
             ("starts_tbl", starts_tbl), ("starts", starts), ("edge", edge),
             ("idx", idx), ("out", out)]
    named = [(name, t) for name, t in named if t is not None]
    for name, t in named + [("data", data)]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, data on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named:
        if t.dtype != torch.int32 and not (name == "packed"
                                           and t.dtype == torch.int16):
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if data.dtype != torch.uint8 or data.dim() != 1 or data.numel() == 0:
        raise ValueError("data must be a non-empty 1-D uint8 tensor")
    S, nseg = (int(x) for x in packed.shape)
    B = int(starts.shape[0])
    if (tuple(segmap.shape) != (256,) or tuple(eoi.shape) != (S, 4)
            or tuple(starts_tbl.shape) != (4,) or starts.dim() != 1
            or (edge is not None and tuple(edge.shape) != (B,))
            or (idx is not None and tuple(idx.shape) != (B,))
            or (out is not None and out.dim() != 1)
            or (out is not None and idx is None
                and tuple(out.shape) != (B,))):
        raise ValueError("bad window-scan table or lane shapes")
    if idx is not None and out is None:
        raise ValueError("an idx scatter needs its out array")
    if not 0 < W < 2 ** 31 - 32:
        raise ValueError(f"bad window width {W}")
    # the table's instance follows its residency (window_plan)
    check_table(S, nseg)
    if packed.dtype == torch.int16 and S > MAX16_ROWS:
        raise ValueError(f"a 16-bit table holds at most {MAX16_ROWS} rows")


# window_scan.cu's block (kThreads, one an SM), stage slices (kWarpStage
# down to kMinStage) and a warp's slices (kSlots)
WINDOW_THREADS = 1024
WINDOW_STAGES = (2048, 1024)
WINDOW_SLOTS = 3


class WindowPlan(NamedTuple):
    """A window launch's place for the table (width: the bytes of a value
    in shared memory, 4 or 2; 0: global memory) and stage slice bytes."""
    width: int
    stage: int

    @property
    def shared(self) -> bool:
        return self.width > 0


def window_smem_bytes(width: int, S: int, nseg: int, stage: int) -> int:
    """Dynamic shared memory of a window-scan block (window_scan.cu's
    smem_bytes): the [S, nseg] table of `width`-byte values (0: global
    memory, none) in rows of count_scan.lane_pitch values, padded to
    words, the byte map, padding to 16 bytes and the warps' stage
    rings."""
    words = (S * lane_pitch(nseg, width) * width + 3) // 4 if width else 0
    return (((words + 256 + 3) & ~3) * 4
            + WINDOW_THREADS // 32 * WINDOW_SLOTS * stage)


def window_stage(n: int, B: int, W: int) -> int:
    """The stage slice that B starts over n bytes at window W want
    (window_scan.cu's stage_for): the smaller where 32 starts n / B bytes
    apart, the window and the chunks' alignment fit in it."""
    gap = -(-n // B) if B > 0 else n
    small = WINDOW_STAGES[-1]
    return small if 32 * gap + W + 32 <= small else WINDOW_STAGES[0]


def window_plan(S: int, nseg: int, vbytes: Optional[int] = None,
                stage: int = WINDOW_STAGES[0]) -> WindowPlan:
    """The window scan's launch over an [S, nseg] table of vbytes-byte
    values (count_scan.value_bytes(S), as packed_device packs it, when
    None) for starts that want `stage`-byte slices (window_stage),
    window_scan.cu's plan_of: shared memory where a block fits within
    SMEM_LIMIT, at that slice or else at the smaller one, with int32
    values, else with 16-bit ones; else global memory at that slice."""
    vb = value_bytes(S) if vbytes is None else vbytes
    for st in WINDOW_STAGES[WINDOW_STAGES.index(stage):]:
        for width in (4, 2):
            if width >= vb and window_smem_bytes(width, S, nseg,
                                                 st) <= SMEM_LIMIT:
                return WindowPlan(width, st)
    return WindowPlan(0, stage)


def window_fits(S: int, nseg: int, vbytes: Optional[int] = None) -> bool:
    """Whether the window scan holds an [S, nseg] table in shared memory
    (window_plan; the same at either stage slice); otherwise the kernel
    reads it from global memory."""
    return window_plan(S, nseg, vbytes).shared


def window_plan_cuda(S: int, nseg: int, vbytes: Optional[int] = None,
                     n: int = 1 << 30, B: int = 1, W: int = 64,
                     width: Optional[int] = None) -> Tuple[WindowPlan, int]:
    """(the plan, its resident warps an SM by the occupancy calculator)
    that the CUDA source takes for the table and B starts over n bytes at
    window W (by default: starts that want the larger slice), for the
    ends form at `width` (window_ends_cuda's; None: by the rule), from
    cgx_window_plan; 0 warps where that width does not fit."""
    import ctypes
    vb = value_bytes(S) if vbytes is None else vbytes
    out = [ctypes.c_int(0) for _ in range(3)]
    _build.check(_build.lib().cgx_window_plan(
        -1 if width is None else width, vb, S, nseg, n, B, W,
        *(ctypes.byref(x) for x in out)), "window_scan")
    return WindowPlan(out[0].value, out[1].value), out[2].value


def window_flags_cuda(packed, segmap, eoi, starts_tbl, data, reverse: bool,
                      starts, edge, W: int):
    """Launch csrc/window_scan.cu's flags form; same outputs as
    window_flags_plain (the kernel writes every flag word)."""
    _check_window_args(packed, segmap, eoi, starts_tbl, data, starts, edge,
                       W)
    dev = data.device
    S, nseg = (int(x) for x in packed.shape)
    B = int(starts.shape[0])
    flagw = torch.empty((window_words(W), B), dtype=torch.int32, device=dev)
    alive = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _build.lib()
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = lib.cgx_window_flags(
            p(packed), packed.element_size(), S, nseg, p(segmap), p(eoi),
            p(starts_tbl), p(data), int(data.shape[0]), int(bool(reverse)),
            p(starts), p(edge), B, W, p(flagw), p(alive), _build.stream(dev))
    _build.check(rc, "window_scan")
    return flagw, alive


def window_ends_cuda(packed, segmap, eoi, starts_tbl, data, reverse: bool,
                     starts, edge, W: int, idx=None, out=None,
                     alive_u8: bool = False, width: Optional[int] = None):
    """Launch csrc/window_scan.cu's ends form (cgx_window_ends); same
    arguments and outputs as window_ends_plain.  idx must hold distinct
    slots of out.  `width` names the table's place (0 global memory, 2 or
    4 shared memory with values of that many bytes; None: the plan's,
    window_plan), for a check that holds each place against the plain
    version (the kernel refuses a width that does not fit)."""
    _check_window_args(packed, segmap, eoi, starts_tbl, data, starts, edge,
                       W, idx, out)
    dev = data.device
    S, nseg = (int(x) for x in packed.shape)
    B = int(starts.shape[0])
    if out is None:
        out = torch.empty(B, dtype=torch.int32, device=dev)
    alive = torch.empty(B, dtype=torch.uint8 if alive_u8 else torch.int32,
                        device=dev)
    lib = _build.lib()
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = lib.cgx_window_ends(
            -1 if width is None else width, p(packed), packed.element_size(),
            S, nseg, p(segmap), p(eoi), p(starts_tbl), p(data),
            int(data.shape[0]), int(bool(reverse)), p(starts), p(edge),
            p(idx), B, W, p(out), p(alive), int(bool(alive_u8)),
            _build.stream(dev))
    _build.check(rc, "window_ends")
    return out, alive


def window_args(mt: MatchTables, data, starts, edge, W: int,
                reverse: bool = False):
    """The argument tuple of the window scans' plain and CUDA versions
    (the ends form takes idx, out and alive_u8 after it)."""
    return (mt.packed, mt.segmap, mt.eoi, mt.starts, data, reverse, starts,
            edge, W)


def _on_device(data, cuda, plain, counter, args, kw=None):
    kw = kw or {}
    if data.device.type == "cuda":
        out = cuda(*args, **kw)
        counter.launches += 1
        if not window_fits(*args[0].shape, args[0].element_size()):
            WINDOW_GLOBAL[counter].launches += 1
        return out
    if data.device.type != "cpu":
        raise ValueError(f"unsupported device {data.device}")
    return plain(*args, **kw)


def window_flags(mt: MatchTables, data, starts, edge, W: int,
                 reverse: bool = False):
    """The window-flag scan on the data's device: the kernel for CUDA
    tensors (counted on WINDOW_KERNEL), the plain version for CPU
    tensors.  starts, edge: [B] int32 with 0 <= start <= n."""
    return _on_device(data, window_flags_cuda, window_flags_plain,
                      WINDOW_KERNEL,
                      window_args(mt, data, starts, edge, W, reverse))


def window_ends_round(mt: MatchTables, data, starts, W: int, edge=None,
                      reverse: bool = False, idx=None, out=None,
                      alive_u8: bool = False):
    """One launch of the ends form on the data's device: the kernel for
    CUDA tensors (counted on WINDOW_ENDS_KERNEL), the plain version for
    CPU tensors.  Returns (out, alive) as window_ends_plain."""
    return _on_device(data, window_ends_cuda, window_ends_plain,
                      WINDOW_ENDS_KERNEL,
                      window_args(mt, data, starts, edge, W, reverse),
                      dict(idx=idx, out=out, alive_u8=alive_u8))


def window_ends(mt: MatchTables, data, starts, W: int = 64, out=None):
    """The end of the anchored match from each of the m `starts` ([m]
    int32, ascending or not) under the anchored DFA `mt` (ref.
    ``WindowScanner.ends_for_starts_device``, :591-622): the last flag of
    the run, so the table sets the rule (a break-at-match DFA dies after
    the leftmost-first end; one that keeps every match lives while any
    thread can go on, and its last flag is the longest end).  The ends
    form runs forward, one lane per start, W bytes, one launch a round;
    the last flag of a run that ended is its end (at n, the EOI flag).  The
    lanes still alive are compacted on the device (K4, carrying their
    index and start) and rerun from their starts at 4W, writing their
    ends in place, one sync a round for the alive count, until no lane
    lives.  A window of n + 1 columns ends every run, so the result stays
    exact where the reference stops at its 2^22-byte cap.  Returns (ends
    [m] int32 (`out` when given), -1 where no match, rounds)."""
    n = int(data.shape[0])
    m = int(starts.shape[0])
    ends = (torch.empty(m, dtype=torch.int32, device=data.device)
            if out is None else out)
    todo, cur = None, starts
    rounds = 0
    while True:
        Wc = min(W, n + 1)
        _e, alive = window_ends_round(mt, data, cur, Wc, idx=todo, out=ends,
                                      alive_u8=True)
        rounds += 1
        n_alive = int(alive.sum(dtype=torch.int64))
        if n_alive == 0:
            return ends, rounds
        if Wc > n:
            raise RuntimeError("window scan: a run outlived the corpus")
        B = int(cur.shape[0])
        idx = (torch.arange(B, dtype=torch.int32, device=data.device)
               if todo is None else todo)
        _pos, todo, cur, _c, _ok = compact_pay(alive.view(torch.bool),
                                               [idx, cur],
                                               _bucket(n_alive, 16))
        todo, cur = todo[:n_alive], cur[:n_alive]
        W *= 4


# ---------------------------------------------------------------------------
# The reset scan (ref. _chunk_scan_reset :685-778, ResetScanner :781-849)
# ---------------------------------------------------------------------------

RESET_KERNEL = LaunchCounter("reset_scan")


class ResetWalk(NamedTuple):
    """The tables split_fixpoint walks for the reset scan: the packed [S,
    C] table (delta*32 + match), the four start states in the byte map's
    place, DEAD as the state before the first sub-lane (no run precedes
    the first reset)."""
    packed: torch.Tensor
    segmap: torch.Tensor
    sot: int = DEAD


class ResetScanner:
    """Contiguous anchored runs restarted at marked positions (ref.
    ``ResetScanner``, :781-849): the verification engine of the candidate
    pipeline (``meta/batch.py`` ``_interleaved_ends``).  The corpus goes
    through once, the anchored DFA restarting at each reset position (the
    start state of the context before it), so each candidate's ends come
    out of one contiguous pass.

    The scan is the lane walk in ``MODE_RESET`` (``csrc/lane_scan.cu``
    ``cgx_lane_reset`` on CUDA tensors, counted on RESET_KERNEL; the plain
    walk on CPU ones) over word tiles of the packed bytes under
    ``plan_geometry``, k = ``lane_split(T, W)`` sub-lanes a lane, each
    entering DEAD after its warmup, repaired by ``split_fixpoint``: one
    launch a pass over the whole corpus, positions int32 up to
    MAX_CORPUS.  The reference's geometry (1024-byte lanes, a 1024-byte
    warmup, segments of 2^29 bytes) and its rescans of every lane are not
    kept; settled flags do not depend on the geometry.  At most
    max_repair passes (the reference's 4) repair: past them the scan
    reports converged False and the caller declines, as the reference's
    does.

    Scope gate as the reference's: at most 32 table columns (the segment
    and the reset's context share a byte), else ValueError.  A table past
    shared memory runs from global memory."""

    def __init__(self, dfa: DenseDFA, device, max_repair: int = 4):
        self.device = torch.device(device)
        self.max_repair = max_repair
        t = DFATables.from_dense(dfa)
        if t.delta.shape[1] > 32:
            raise ValueError("reset scan packs class+aux in u8: C <= 32")
        self.walk = ResetWalk(
            packed_device(t.delta * 32 + t.match_on.astype(np.int32),
                          self.device),
            device_table(t.host_starts, self.device))
        self.bounds = tuple(int(b) for b in t.bounds if int(b) < 256)

    def packed(self, data, reset_mask=None, pad: int = 0):
        """The scan's input byte a position: segment << 3 | ctx << 1 |
        reset, ctx the context of the byte before (CTX_SOT at 0); with no
        reset_mask, the reset bits are 0 (a caller that scans several
        reset sets builds this once and sets them in copies).  `pad` zero
        bytes follow the corpus's: a scan over one of them gives the flag
        at n, which a look-free DFA sets whatever the byte."""
        n = int(data.shape[0])
        out = torch.zeros(n + pad, dtype=torch.uint8, device=data.device)
        body = out[:n]
        for b in self.bounds:
            body += (data >= b).to(torch.uint8)
        body <<= 3
        body[:1] |= CTX_SOT << 1
        if n > 1:
            body[1:] |= _byte_ctx(data[:-1]).to(torch.uint8) << 1
        if reset_mask is not None:
            body |= reset_mask.to(torch.uint8)
        return out

    @staticmethod
    def geometry(n1: int) -> Tuple[int, int, int]:
        """(L, T, W) of a scan over n1 positions."""
        L, T, W, _Lc = plan_geometry(n1)
        return L, T, W

    def tiles(self, packed):
        """Word tiles of packed bytes (``packed``) under the geometry of
        their length; reset bits scatter into copies of reset-free ones
        (``flag_scan.scatter_reset_tiles``: bit 0 of a reset-free byte is
        0, so +1 never carries)."""
        L, T, _W = self.geometry(int(packed.shape[0]))
        return make_word_tiles(packed, L, T // 4)

    def scan_tiles(self, tiles, n1: int):
        """Scan word tiles of n1 packed bytes (``tiles``).  Returns (flag
        words [L*T/32] int32 position-major, bit p the anchored run's match
        flag at position p, bits >= n1 clear; converged; interfered: a
        reset met a live run, which may have been cut short; the state
        after position n1 - 1, a 0-dim tensor)."""
        L, T, W = self.geometry(n1)
        k = lane_split(T, W)
        dev = tiles.device
        lanes = torch.arange(L, dtype=torch.int64, device=dev)
        entries0 = torch.full((k, L), DEAD, dtype=torch.int32, device=dev)
        offsets0 = torch.zeros(L, dtype=torch.int32, device=dev)
        offsets0[0] = W
        limits = (n1 - lanes * T).clamp(0, T).to(torch.int32)
        (cnts, exits, _sync, fw, _aux), conv = split_fixpoint(
            MODE_RESET, RESET_KERNEL, self.walk, tiles, W, entries0,
            offsets0, limits, self.max_repair)
        return (to_global(fw, n1), conv, bool(cnts.sum() > 0),
                state_at_end(exits, n1, L, T))

    def scan_device(self, data, reset_mask):
        """scan_tiles over the corpus with resets at `reset_mask` [n]:
        (flag words over the n positions, converged, interfered, the state
        after the corpus)."""
        n = int(data.shape[0])
        return self.scan_tiles(self.tiles(self.packed(data, reset_mask)), n)
