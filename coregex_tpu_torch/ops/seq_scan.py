"""Needle tables, the lane byte stream, and the sequential needle count (K7).

Ports ``coregex_tpu/ops/seq_scan.py``: ``M_MAX``, ``LEN_MAX``,
``needle_phase_plans`` and ``build_mask_tables`` (:53-96) as numpy (that
module imports jax), ``_seq_full`` (:321-405) as host-driven torch code on
``count_scan.repair_fixpoint``, and ``SeqScanner`` (:465-522).

A needle is at most LEN_MAX = 13 NUL-free bytes.  The kernels of this module
and of ``line_scan.py`` compare a 16-byte window at each position against
the needles' phase-0 masks: :func:`needle_table` packs them as an int32
``[J, 8]`` table (four mask words, four value words).  Each lane reads its
own T bytes, the previous lane's last W bytes as warmup (lane 0 reads lane
L-1's, which its offset skips) and the next lane's first 16 bytes as
lookahead (zeros after the last lane); zero padding fakes no NUL-free hit.

Modes of the sequential machine (one packed int32 state per lane):
  MODE_MULTI: leftmost-first, non-overlapping count of a literal set
    (priority = order); the state is the countdown to the current match's
    end.
  MODE_LINE: lines holding a needle, optionally behind a (?m)^prefix with
    the needle at offset >= len(prefix); state bits prev_nl | valid << 1 |
    seen << 2 | since-line-start << 3 (the unanchored machine keeps bits 0
    and 2 only).
The count repairs like the count transducer: lanes enter at guessed states
and rescan until every lane's post-warmup state equals the previous lane's
exit.  A line-mode lane whose warmup holds a newline is exact whatever its
guess, so only the other lanes are checked.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .count_scan import (LaunchCounter, device_table, make_word_tiles,
                         plan_geometry, repair_fixpoint, settled)

MODE_MULTI = 0
MODE_LINE = 1

M_MAX = 4          # max words a phase-shifted needle may span (13+ bytes)
LEN_MAX = 4 * (M_MAX - 1) + 1
MAX_NEEDLES = 64
AHEAD = 4          # lookahead words: the 16-byte window at a lane's end

SEQ_KERNEL = LaunchCounter("seq_scan")


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def needle_phase_plans(needle: bytes) -> List[List[Tuple[int, int]]]:
    """Per phase kk (start byte mod 4): [(mask, value)] per word offset,
    little-endian packing."""
    plans = []
    for kk in range(4):
        mwords = (kk + len(needle) + 3) // 4
        masks = [0] * mwords
        vals = [0] * mwords
        for j, b in enumerate(needle):
            m, lane = (kk + j) // 4, (kk + j) % 4
            masks[m] |= 0xFF << (8 * lane)
            vals[m] |= b << (8 * lane)
        plans.append([(_i32(m), _i32(v)) for m, v in zip(masks, vals)])
    return plans


def build_mask_tables(needles: Sequence[bytes], M: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[J, 4, M] mask/value arrays + [J] lengths; unused word slots hold
    mask 0 / value 0 (always true)."""
    J = len(needles)
    masks = np.zeros((J, 4, M), dtype=np.int64)
    vals = np.zeros((J, 4, M), dtype=np.int64)
    lens = np.zeros((J,), dtype=np.int32)
    for j, nd in enumerate(needles):
        assert 0 < len(nd) <= LEN_MAX and 0 not in nd
        lens[j] = len(nd)
        for kk, plan in enumerate(needle_phase_plans(nd)):
            assert len(plan) <= M
            for m, (mk, vl) in enumerate(plan):
                masks[j, kk, m] = mk
                vals[j, kk, m] = vl
    return (masks.astype(np.int32), vals.astype(np.int32), lens)


def needles_ok(items: Sequence[bytes], line_mode: bool = False) -> bool:
    """The kernels' scope: 1-64 needles of 1-13 NUL-free bytes (zero
    padding must not fake hits), newline-free in line mode."""
    items = [bytes(x) for x in items]
    if not items or len(items) > MAX_NEEDLES:
        return False
    return all(0 < len(x) <= LEN_MAX and 0 not in x
               and (not line_mode or 10 not in x) for x in items)


def needle_table(items: Sequence[bytes], device):
    """(table [J, 8] int32, lens [J] int32) on `device`: the phase-0 masks
    and values of the four words of each needle's 16-byte window."""
    masks, vals, lens = build_mask_tables([bytes(x) for x in items], M_MAX)
    tbl = np.concatenate([masks[:, 0, :], vals[:, 0, :]], axis=1)
    return device_table(tbl, device), device_table(lens, device)


# ---------------------------------------------------------------------------
# Plain versions: the lane byte stream and needle hit planes
# ---------------------------------------------------------------------------

def lane_stream_words(tiles, r0: int, r1: int):
    """Words r0..r1-1 of every lane's stream, [r1 - r0, L] int32: rows
    below 0 are the previous lane's last words (lane 0 reads lane L-1's),
    rows past T4 the next lane's first words (zeros after the last lane)."""
    T4, L = (int(x) for x in tiles.shape)
    dev = tiles.device
    parts = []
    if r0 < 0:
        lo = min(r1, 0)
        prev = torch.roll(torch.arange(L, device=dev), 1)
        parts.append(tiles[T4 + r0:T4 + lo][:, prev])
    a, b = max(r0, 0), min(r1, T4)
    if a < b:
        parts.append(tiles[a:b])
    if r1 > T4:
        a = max(r0, T4)
        nxt = torch.cat([tiles[a - T4:r1 - T4, 1:],
                         torch.zeros((r1 - a, 1), dtype=tiles.dtype,
                                     device=dev)], dim=1)
        parts.append(nxt)
    return torch.cat(parts, dim=0)


def stream_bytes(words):
    """[R, L] int32 words -> [4R, L] int64 bytes, time-major."""
    R, L = (int(x) for x in words.shape)
    b = words.contiguous().view(torch.uint8).reshape(R, L, 4)
    return b.permute(0, 2, 1).reshape(4 * R, L).long()


def host_needles(tbl, lens) -> List[bytes]:
    """The needle bytes a [J, 8] table encodes (for the plain versions)."""
    t = np.asarray(tbl.cpu(), dtype=np.int32).view(np.uint32)
    out = []
    for j, k in enumerate(np.asarray(lens.cpu()).tolist()):
        words = t[j, 4:8].astype("<u4").tobytes()
        out.append(words[:k])
    return out


def hit_plane(B, needle: bytes, P: int):
    """[P, L] bool: `needle` starts at row p of the byte rows B
    ([P + 16, L])."""
    h = B[0:P] == needle[0]
    for i in range(1, len(needle)):
        h = h & (B[i:i + P] == needle[i])
    return h


def chunk_rows(L: int) -> int:
    """Word rows per chunk of a plain version: about 2^24 positions."""
    return max(1, (1 << 22) // max(L, 1))


# ---------------------------------------------------------------------------
# K7: the sequential needle machine, kernel and plain version
# ---------------------------------------------------------------------------

def _check_tables(tbl, lens, tiles):
    dev = tiles.device
    T4 = int(tiles.shape[0])
    for name, t in (("table", tbl), ("lens", lens), ("tiles", tiles)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, tiles on {dev}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    J = int(tbl.shape[0])
    if tbl.dim() != 2 or int(tbl.shape[1]) != 8 or tuple(lens.shape) != (J,):
        raise ValueError("needle table must be [J, 8] with lens [J]")
    if not 0 < J <= MAX_NEEDLES + 1:
        raise ValueError(f"{J} needle slots outside [1, {MAX_NEEDLES + 1}]")
    if T4 < AHEAD:
        raise ValueError(f"lanes of {4 * T4} bytes are shorter than the "
                         f"{4 * AHEAD}-byte lookahead")


def seq_lanes_plain(mode: int, tbl, lens, jh: int, anchored: bool,
                    plen: int, tiles, W4: int, entries, offsets, limits):
    """Plain torch K7: one eager step per byte over all lanes (the
    reference's substep), events from shifted byte compares.  Returns
    (counts, exits, sync) [L] int32."""
    T4, L = (int(x) for x in tiles.shape)
    dev = tiles.device
    nds = host_needles(tbl, lens)
    ln = [len(x) for x in nds]
    s = entries.long().clone()
    sync = entries.long().clone()
    cnt = torch.zeros(L, dtype=torch.int64, device=dev)
    offs = offsets.long() - 4 * W4
    lim = limits.long()
    simple = mode == MODE_LINE and not anchored and plen == 0
    step = chunk_rows(L)
    last = min(T4, -(-int(lim.max()) // 4)) if L else 0
    for r0 in range(-W4, last, step):
        r1 = min(r0 + step, last)
        P = 4 * (r1 - r0)
        B = stream_bytes(lane_stream_words(tiles, r0, r1 + AHEAD))
        if mode == MODE_MULTI:
            wl = torch.zeros((P, L), dtype=torch.int64, device=dev)
            for j, nd in enumerate(nds):
                wl = torch.where((wl == 0) & hit_plane(B, nd, P), ln[j], wl)
        else:
            hit = torch.zeros((P, L), dtype=torch.bool, device=dev)
            for nd in nds[:jh]:
                hit |= hit_plane(B, nd, P)
            isnl = B[:P] == 10
            pfx = hit_plane(B, nds[jh], P) if anchored else None
        for q in range(P):
            cb = 4 * r0 + q
            live_state = (cb >= offs) & (cb < lim)
            if mode == MODE_MULTI:
                commit = (wl[q] > 0) & (s == 0)
                ns = torch.where(commit, wl[q] - 1, (s - 1).clamp(min=0))
            else:
                prev_nl = (s & 1) == 1
                if simple:
                    seen = (((s >> 2) & 1) == 1) & ~prev_nl
                    commit = hit[q] & ~seen
                    seen = seen | commit
                    ns = isnl[q].long() | (seen.long() << 2)
                else:
                    valid = ((s >> 1) & 1) == 1
                    seen = (((s >> 2) & 1) == 1) & ~prev_nl
                    slc = (s >> 3) & 31
                    if anchored:
                        valid = (prev_nl & pfx[q]) | (~prev_nl & valid)
                    else:
                        valid = valid | prev_nl
                    slc = torch.where(prev_nl, 0, (slc + 1).clamp(max=31))
                    commit = hit[q] & valid & ~seen & (slc >= plen)
                    seen = seen | commit
                    ns = (isnl[q].long() | (valid.long() << 1)
                          | (seen.long() << 2) | (slc << 3))
            if cb >= 0:
                cnt += (commit & live_state).long()
            s = torch.where(live_state, ns, s)
            if cb == -1:
                sync = s.clone()
    return (cnt.to(torch.int32), s.to(torch.int32), sync.to(torch.int32))


def seq_lanes_cuda(mode: int, tbl, lens, jh: int, anchored: bool, plen: int,
                   tiles, W4: int, entries, offsets, limits):
    """Launch cgx_seq_lanes of csrc/needle_scan.cu; same outputs as
    seq_lanes_plain."""
    _check_tables(tbl, lens, tiles)
    T4, L = (int(x) for x in tiles.shape)
    if not 0 < W4 <= T4:
        raise ValueError(f"bad warmup W4={W4} for T4={T4}")
    for name, t in (("entries", entries), ("offsets", offsets),
                    ("limits", limits)):
        if (t.device != tiles.device or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != (L,)):
            raise ValueError(f"{name} must be contiguous int32 [{L}] on "
                             f"the tiles' device")
    dev = tiles.device
    counts, exits, sync = (torch.empty(L, dtype=torch.int32, device=dev)
                           for _ in range(3))
    p = _build.ptr
    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = lib.cgx_seq_lanes(
            mode, p(tbl), p(lens), int(tbl.shape[0]), jh, int(anchored),
            plen, p(tiles), T4, L, W4, p(entries), p(offsets), p(limits),
            p(counts), p(exits), p(sync), _build.stream(dev))
    _build.check(rc, "seq_lanes")
    return counts, exits, sync


def seq_lanes(mode: int, tbl, lens, jh: int, anchored: bool, plen: int,
              tiles, W4: int, entries, offsets, limits):
    """K7 on the tiles' device: the kernel for CUDA tensors (counted on
    SEQ_KERNEL), the plain version for CPU tensors."""
    args = (mode, tbl, lens, jh, anchored, plen, tiles, W4, entries,
            offsets, limits)
    if tiles.device.type == "cuda":
        out = seq_lanes_cuda(*args)
        SEQ_KERNEL.launches += 1
        return out
    if tiles.device.type != "cpu":
        raise ValueError(f"unsupported device {tiles.device}")
    return seq_lanes_plain(*args)


# ---------------------------------------------------------------------------
# Host oracles (tests) + the scanner
# ---------------------------------------------------------------------------

def seq_geometry(n: int, M: int) -> Tuple[int, int, int, int]:
    """plan_geometry(n) with K7's warmup: 128 bytes, at least 4M + 4 (ref.
    SeqScanner.count)."""
    L, T, W, Lc = plan_geometry(n, warmup=128)
    return L, T, min(max(W, 4 * M + 4), T), Lc


class SeqScanner:
    """K7 count pipeline for one needle set and mode (ref. SeqScanner).
    count() is exact: the repair fixpoint runs until it settles."""

    def __init__(self, mode: int, needles: Sequence[bytes],
                 prefix: bytes = b"", anchored: bool = False,
                 device="cpu"):
        self.mode = mode
        self.needles = [bytes(nd) for nd in needles]
        self.prefix = bytes(prefix)
        self.anchored = bool(anchored)
        self.plen = len(prefix) if anchored else 0
        items = list(self.needles)
        if mode == MODE_LINE and anchored:
            items = items + [self.prefix]
        if not needles_ok(items, line_mode=mode == MODE_LINE):
            raise ValueError("needle set outside the kernel's scope")
        kmax = max(len(x) for x in items)
        self.M = min(M_MAX, (3 + kmax + 3) // 4)
        self.jh = len(self.needles)
        self.tbl, self.lens = needle_table(items, device)

    @staticmethod
    def supported(needles: Sequence[bytes], prefix: bytes = b"",
                  line_mode: bool = False) -> bool:
        items = list(needles) + ([prefix] if prefix else [])
        return needles_ok(items, line_mode)

    def first_pass(self, data_u8, n: int, L: int, T: int, W: int):
        """(entries0, offsets0, limits, entry0) (ref. _seq_full:339-356)."""
        dev = data_u8.device
        lanes = torch.arange(L, dtype=torch.int64, device=dev)
        limits = (n - lanes * T).clamp(0, T).to(torch.int32)
        if self.mode == MODE_MULTI:
            guess = torch.zeros(L, dtype=torch.int32, device=dev)
            entry0 = 0
        else:
            prev_b = data_u8[(lanes * T - W - 1).clamp(0, n - 1)]
            pnl = (prev_b == 10).to(torch.int32)
            if not self.anchored and self.plen == 0:
                guess, entry0 = pnl, 1
            else:
                base = 0 if self.anchored else 2
                guess, entry0 = pnl | base | (31 << 3), 1 | base
        entries0 = guess.clone()
        entries0[0] = entry0
        offsets0 = torch.zeros(L, dtype=torch.int32, device=dev)
        offsets0[0] = W
        return entries0, offsets0, limits.contiguous(), entry0

    def _clean(self, tiles, W4: int):
        """Lanes exact whatever their entry: lane 0, and in line mode the
        lanes whose warmup bytes hold a newline (ref. _seq_full:358-368)."""
        T4, L = (int(x) for x in tiles.shape)
        clean = torch.zeros(L, dtype=torch.bool, device=tiles.device)
        if self.mode == MODE_LINE:
            wnl = (stream_bytes(lane_stream_words(tiles, -W4, 0)) == 10)
            clean = wnl.any(0)
        clean[0] = True
        return clean

    def count(self, data_dev: torch.Tensor,
              geometry: Optional[Tuple[int, int, int, int]] = None,
              tiles: Optional[torch.Tensor] = None) -> int:
        """Exact count of the device corpus; `geometry` defaults to
        seq_geometry(n), `tiles` (its word tiles) are built when None."""
        n = int(data_dev.shape[0])
        if n == 0:
            return 0
        L, T, W, _Lc = geometry or seq_geometry(n, self.M)
        W = min(max(W, 4 * self.M + 4), T)
        if tiles is None:
            tiles = make_word_tiles(data_dev, L, T // 4)
        W4 = W // 4
        entries0, offsets0, limits, entry0 = self.first_pass(
            data_dev, n, L, T, W)
        lanes = torch.arange(L, dtype=torch.int64, device=tiles.device)
        check = ((lanes * T) < n) & ~self._clean(tiles, W4)

        def scan_once(entries, offsets):
            return seq_lanes(self.mode, self.tbl, self.lens, self.jh,
                             self.anchored, self.plen, tiles, W4, entries,
                             offsets, limits)

        first = torch.tensor(entry0, dtype=torch.int32, device=tiles.device)
        (counts, _exits, _sync), conv = repair_fixpoint(
            scan_once, entries0, offsets0, first, check, W, max_repair=L)
        settled(conv, "sequential needle scan")
        return int(counts.sum(dtype=torch.int64))
