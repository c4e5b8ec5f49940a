"""Needle tables, the lane byte stream, and the sequential needle count (K7).

Ports ``coregex_tpu/ops/seq_scan.py``: ``M_MAX``, ``LEN_MAX``,
``needle_phase_plans`` and ``build_mask_tables`` (:53-96) as numpy (that
module imports jax), ``_seq_full`` (:321-405) as host-driven torch code on
``count_scan.split_passes``, and ``SeqScanner`` (:465-522).

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
The count splits and repairs like the count transducer: each lane splits
into k = ``lane_split(T, W)`` sub-lanes, each warms up over the W bytes
before it from a guessed state, and the split fixpoint's repair passes walk
again only the sub-lanes, then the lanes, whose post-warmup state differs
from the previous sub-lane's exit.  A line-mode sub-lane whose warmup holds
a newline is exact whatever its guess (clean), so it is never checked or
walked again.  The needle image the kernel reads is built once a count, by
its pass 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .count_scan import (PASS_FIRST, PASS_LANE, PASS_SUB, SUB_PASSES,
                         LaunchCounter, device_table, lane_split,
                         make_word_tiles, plan_geometry, settled,
                         split_passes, sub_limits, unsettled, want_of)

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


def sub_lane_tiles(tiles, k: int):
    """The tiles [T4, L] re-laid as k*L lanes of T4/k words, column l*k + j
    holding sub-lane (j, l): the one-walker plain scans then walk the
    sub-lanes in corpus order, a lane's previous lane is the previous
    sub-lane (whose last words are the sub-lane's warmup) and its next
    lane the next sub-lane."""
    T4, L = (int(x) for x in tiles.shape)
    return tiles.reshape(k, T4 // k, L).permute(1, 2, 0).reshape(
        T4 // k, L * k).contiguous()


def from_sub_lanes(x, k: int):
    """[k*L] outputs of the re-laid sub-lanes -> [k, L], row j = sub-lanes
    (j, .)."""
    return x.reshape(-1, k).t().contiguous()


def to_sub_lanes(x):
    """[k, L] -> [k*L] in the re-laid sub-lanes' column order."""
    return x.t().reshape(-1)


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


def _seq_plain(mode: int, nds, jh: int, anchored: bool, plen: int, tiles,
               W4: int, entries, offsets, limits, cols=None):
    """The machine with one walker a lane of `tiles` (the reference's
    substep, one eager torch step per byte), over the lanes `cols` (all
    when None); entries, offsets and limits [M] for those lanes.  Returns
    (counts, exits, sync, nlw) [M]: nlw, in line mode, that a live warmup
    position holds a newline."""
    T4, L = (int(x) for x in tiles.shape)
    dev = tiles.device
    ln = [len(x) for x in nds]
    s = entries.long().clone()
    sync = s.clone()
    M = int(s.shape[0])
    cnt = torch.zeros(M, dtype=torch.int64, device=dev)
    nlw = torch.zeros(M, dtype=torch.bool, device=dev)
    offs = offsets.long() - 4 * W4
    lim = limits.long()
    simple = mode == MODE_LINE and not anchored and plen == 0
    step = chunk_rows(M)
    last = min(T4, -(-int(lim.max()) // 4)) if M else 0
    for r0 in range(-W4, last, step):
        r1 = min(r0 + step, last)
        P = 4 * (r1 - r0)
        B = stream_bytes(lane_stream_words(tiles, r0, r1 + AHEAD))
        if cols is not None:
            B = B[:, cols]
        if mode == MODE_MULTI:
            wl = torch.zeros((P, M), dtype=torch.int64, device=dev)
            for j, nd in enumerate(nds):
                wl = torch.where((wl == 0) & hit_plane(B, nd, P), ln[j], wl)
        else:
            hit = torch.zeros((P, M), dtype=torch.bool, device=dev)
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
                if cb < 0:
                    nlw |= isnl[q] & live_state
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
    return cnt, s, sync, nlw


def seq_lanes_plain(mode: int, tbl, lens, jh: int, anchored: bool,
                    plen: int, tiles, W4: int, entries, offsets, limits):
    """Plain torch K7 pass 0 over k = entries.shape[0] sub-lanes a lane:
    one eager step per byte over all k*L sub-lanes, the tiles re-laid as
    k*L lanes of T4/k words (sub_lane_tiles).  Sub-lane (j, l) warms up
    over the W4 words before it from entries [k, L], skipping warmup
    positions below offsets[l] - 4*W4 when j = 0; limits [L] are the lanes'.
    Returns (counts, exits, sync, clean) [k, L] int32: clean marks (0, 0)
    and, in line mode, the sub-lanes with a newline among their live
    warmup bytes, exact whatever their entry."""
    T4, L = (int(x) for x in tiles.shape)
    k = int(entries.shape[0])
    off = torch.cat([offsets[None], offsets.new_zeros((k - 1, L))])
    cnt, s, sync, nlw = _seq_plain(
        mode, host_needles(tbl, lens), jh, anchored, plen,
        sub_lane_tiles(tiles, k), W4, to_sub_lanes(entries),
        to_sub_lanes(off), to_sub_lanes(sub_limits(limits, k, 4 * T4 // k)
                                        .reshape(k, L)))
    clean = nlw if mode == MODE_LINE else torch.zeros_like(nlw)
    clean[0] = True
    return tuple(from_sub_lanes(x.to(torch.int32), k)
                 for x in (cnt, s, sync, clean))


def seq_repair_plain(mode: int, whole: bool, tbl, lens, jh: int,
                     anchored: bool, plen: int, tiles, first: int, limits,
                     prev, exits, counts, sync, clean, walked, img=None):
    """One repair pass of the plain version, in place (csrc/needle_scan.cu's
    kSub and kLane, count_scan.lane_repair_plain's for K7): every unsettled
    sub-lane (real, not clean, its sync unlike the previous exit in `prev`
    [k, L], `first` for sub-lane (0, 0)) walks from that exit with no
    warmup (whole=False), or every lane holding one walks whole from the
    previous lane's exit, a clean sub-lane 0 from its own sync
    (whole=True).  The walkers rewrite their sync and counts; `exits` gets
    every sub-lane's exit (settled ones copy prev's), walked[0] the number
    of walkers.  img: the kernel's needle image, unused here."""
    T4, L = (int(x) for x in tiles.shape)
    k = int(prev.shape[0])
    T4k = T4 // k
    nds = host_needles(tbl, lens)
    lim = sub_limits(limits, k, 4 * T4k).reshape(k, L)
    want = want_of(prev, first)
    bad = (lim > 0) & (clean == 0) & (sync != want)
    sub = sub_lane_tiles(tiles, k)
    zero = torch.zeros(L, dtype=torch.int32, device=tiles.device)
    if whole:
        lanes = bad.any(dim=0)
        s = torch.where(clean[0] != 0, sync[0], want[0])
        out_c, out_e, out_s = [], [], []
        for j in range(k):
            c, e, _sy, _nlw = _seq_plain(
                mode, nds, jh, anchored, plen, sub, 0, s, zero, lim[j],
                cols=torch.arange(L, device=tiles.device) * k + j)
            out_s.append(s.to(torch.int32))
            out_c.append(c.to(torch.int32))
            out_e.append(e.to(torch.int32))
            s = e
        sel = lanes[None, :].expand(k, L)
        walked.fill_(int(lanes.sum()))
        new_s, new_c, new_e = (torch.stack(x) for x in (out_s, out_c, out_e))
    else:
        c, e, _sy, _nlw = _seq_plain(
            mode, nds, jh, anchored, plen, sub, 0, to_sub_lanes(want),
            torch.zeros(k * L, dtype=torch.int32, device=tiles.device),
            to_sub_lanes(lim))
        sel = bad
        walked.fill_(int(bad.sum()))
        new_s, new_c, new_e = want, from_sub_lanes(c.to(torch.int32), k), \
            from_sub_lanes(e.to(torch.int32), k)
    sync.copy_(torch.where(sel, new_s, sync))
    counts.copy_(torch.where(sel, new_c, counts))
    exits.copy_(torch.where(sel, new_e, prev))


def _check_seq_args(tiles, W4: int, entries, offsets, limits):
    """The [k, L] and [L] arguments of a K7 pass, checked before launch."""
    T4, L = (int(x) for x in tiles.shape)
    if entries.dim() != 2 or int(entries.shape[1]) != L:
        raise ValueError(f"entries must have shape (k, {L})")
    k = int(entries.shape[0])
    if k < 1 or k & (k - 1) or T4 % (8 * k):
        raise ValueError(f"k = {k} sub-lanes: a power of two whose "
                         f"sub-lanes hold whole 8-word groups of T4 = {T4}")
    if not 0 <= W4 <= T4 // k:
        raise ValueError(f"bad warmup W4={W4} for T4/k={T4 // k}")
    for name, t, shape in (("entries", entries, (k, L)),
                           ("offsets", offsets, (L,)),
                           ("limits", limits, (L,))):
        if (t.device != tiles.device or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be contiguous int32 {list(shape)}"
                             f" on the tiles' device")
    return T4, L, k


def needle_image(device):
    """The kernel's needle-image buffer on a CUDA device, None on the CPU:
    K7's pass 0 builds it, its repair passes read it."""
    if torch.device(device).type != "cuda":
        return None
    return torch.empty(_build.lib().cgx_needles_bytes(), dtype=torch.uint8,
                       device=device)


def seq_lanes_cuda(mode: int, tbl, lens, jh: int, anchored: bool, plen: int,
                   tiles, W4: int, entries, offsets, limits, img=None):
    """Launch cgx_seq_lanes' pass 0 (csrc/needle_scan.cu): the needle image
    build into img (allocated when None), then the walk; same outputs as
    seq_lanes_plain."""
    _check_tables(tbl, lens, tiles)
    T4, L, k = _check_seq_args(tiles, W4, entries, offsets, limits)
    dev = tiles.device
    if img is None:
        img = needle_image(dev)
    outs = [torch.empty((k, L), dtype=torch.int32, device=dev)
            for _ in range(4)]
    p = _build.ptr
    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = lib.cgx_seq_lanes(
            PASS_FIRST, mode, p(tbl), p(lens), int(tbl.shape[0]), jh,
            int(anchored), plen, p(tiles), T4, L, W4, k, p(entries),
            p(offsets), p(limits), 0, None, p(img), *[p(o) for o in outs],
            None, _build.stream(dev))
    _build.check(rc, "seq_lanes")
    return tuple(outs)


def seq_repair_cuda(mode: int, whole: bool, tbl, lens, jh: int,
                    anchored: bool, plen: int, tiles, first: int, limits,
                    prev, exits, counts, sync, clean, walked, img=None):
    """Launch one repair pass of cgx_seq_lanes (kSub, or kLane when whole)
    over pass 0's needle image `img`; same in-place outputs as
    seq_repair_plain."""
    _check_tables(tbl, lens, tiles)
    T4, L, k = _check_seq_args(tiles, 0, prev, limits, limits)
    for name, t in (("exits", exits), ("counts", counts), ("sync", sync),
                    ("clean", clean)):
        if (t.shape != prev.shape or t.dtype != torch.int32
                or not t.is_contiguous() or t.device != tiles.device):
            raise ValueError(f"{name} must be int32 like prev")
    if walked.dtype != torch.int32 or walked.device != tiles.device:
        raise ValueError("walked must be an int32 tensor beside the tiles")
    if img is None or img.device != tiles.device:
        raise ValueError("a repair pass reads pass 0's needle image")
    p = _build.ptr
    lib = _build.lib()
    with torch.cuda.device(tiles.device):
        rc = lib.cgx_seq_lanes(
            PASS_LANE if whole else PASS_SUB, mode, p(tbl), p(lens),
            int(tbl.shape[0]), jh, int(anchored), plen, p(tiles), T4, L, 0,
            k, None, None, p(limits), first, p(prev), p(img), p(counts),
            p(exits), p(sync), p(clean), p(walked),
            _build.stream(tiles.device))
    _build.check(rc, "seq_lanes")


def seq_lanes(mode: int, tbl, lens, jh: int, anchored: bool, plen: int,
              tiles, W4: int, entries, offsets, limits, img=None):
    """K7's pass 0 on the tiles' device: the kernel for CUDA tensors
    (counted on SEQ_KERNEL), the plain version for CPU tensors."""
    args = (mode, tbl, lens, jh, anchored, plen, tiles, W4, entries,
            offsets, limits)
    if tiles.device.type == "cuda":
        out = seq_lanes_cuda(*args, img=img)
        SEQ_KERNEL.launches += 1
        return out
    if tiles.device.type != "cpu":
        raise ValueError(f"unsupported device {tiles.device}")
    _check_seq_args(tiles, W4, entries, offsets, limits)
    return seq_lanes_plain(*args)


def seq_repair(*args):
    """One K7 repair pass on the tiles' device (args as seq_repair_plain's):
    the kernel for CUDA tensors, counted on SEQ_KERNEL."""
    tiles = args[7]
    if tiles.device.type == "cuda":
        seq_repair_cuda(*args)
        SEQ_KERNEL.launches += 1
    elif tiles.device.type == "cpu":
        seq_repair_plain(*args)
    else:
        raise ValueError(f"unsupported device {tiles.device}")


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

    def first_pass(self, data_u8, n: int, L: int, T: int, W: int, k: int):
        """(entries0 [k, L], offsets0 [L], limits [L], entry0) of pass 0
        over k sub-lanes a lane: in line mode each sub-lane's entry guessed
        from the byte before its warmup, sub-lane (0, 0) at the true start
        (ref. _seq_full:339-356)."""
        dev = data_u8.device
        lanes = torch.arange(L, dtype=torch.int64, device=dev)
        limits = (n - lanes * T).clamp(0, T).to(torch.int32)
        if self.mode == MODE_MULTI:
            guess = torch.zeros((k, L), dtype=torch.int32, device=dev)
            entry0 = 0
        else:
            sub = torch.arange(k, dtype=torch.int64, device=dev) * (T // k)
            at = lanes[None, :] * T + sub[:, None] - W - 1
            pnl = (data_u8[at.clamp(0, n - 1)] == 10).to(torch.int32)
            if not self.anchored and self.plen == 0:
                guess, entry0 = pnl, 1
            else:
                base = 0 if self.anchored else 2
                guess, entry0 = pnl | base | (31 << 3), 1 | base
        entries0 = guess.contiguous()
        entries0[0, 0] = entry0
        offsets0 = torch.zeros(L, dtype=torch.int32, device=dev)
        offsets0[0] = W
        return entries0, offsets0, limits.contiguous(), entry0

    def scan(self, tiles, data_dev, n: int, T: int, W: int, k: int,
             max_repair: int):
        """K7 over k sub-lanes a lane and its repair passes
        (count_scan.split_passes): ((counts, exits, sync, clean) [k, L],
        converged).  A sub-lane is settled when it is past the corpus,
        clean, or its sync equals the previous sub-lane's exit."""
        L = int(tiles.shape[1])
        e0, o0, lim, entry0 = self.first_pass(data_dev, n, L, T, W, k)
        img = needle_image(tiles.device)
        args = (self.tbl, self.lens, self.jh, self.anchored, self.plen,
                tiles)
        counts, exits, sync, clean = seq_lanes(self.mode, *args, W // 4, e0,
                                               o0, lim, img)

        def repair(whole, prev, out, walked):
            seq_repair(self.mode, whole, *args, entry0, lim, prev, out,
                       counts, sync, clean, walked, img)

        exits, conv = split_passes(SEQ_KERNEL, exits, repair, max_repair)
        if conv is None:
            conv = not bool((unsettled(exits, sync, lim, entry0, T)
                             & (clean == 0)).any())
        return (counts, exits, sync, clean), conv

    def count(self, data_dev: torch.Tensor,
              geometry: Optional[Tuple[int, int, int, int]] = None,
              tiles: Optional[torch.Tensor] = None) -> int:
        """Exact count of the device corpus over lane_split(T, W) sub-lanes
        a lane; `geometry` defaults to seq_geometry(n), `tiles` (its word
        tiles) are built when None.  The repair runs until it settles."""
        n = int(data_dev.shape[0])
        if n == 0:
            return 0
        L, T, W, _Lc = geometry or seq_geometry(n, self.M)
        W = min(max(W, 4 * self.M + 4), T)
        if tiles is None:
            tiles = make_word_tiles(data_dev, L, T // 4)
        (counts, _e, _s, _c), conv = self.scan(
            tiles, data_dev, n, T, W, lane_split(T, W),
            max_repair=L + SUB_PASSES)
        settled(conv, "sequential needle scan")
        return int(counts.sum(dtype=torch.int64))
