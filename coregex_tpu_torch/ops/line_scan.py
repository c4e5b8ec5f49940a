"""Single-launch needle counts: lines holding a needle (K5) and raw hits of a
literal set with exact overlap detection (K6).

Ports ``coregex_tpu/ops/line_scan.py``: ``LineScanner`` with ``_combine``
(:268-400) and ``HitsScanner`` (:536-611).  Both kernels are exact in one
launch: K5 keeps three running maxima per sub-lane (last newline, last
valid line start, last qualifying hit) and counts the commits at the
sub-lane's newlines after its first; the combine stitches each sub-lane's
first line from O(1) outputs per sub-lane.  K6 counts raw hits and flags a
hit that starts inside an earlier hit's reach; on an overlap the caller
counts with K7.  Both walk k = ``lane_split(T, W)`` sub-lanes a lane, as K1
does, and their outputs combine on the device (``LineScanner.verdict``,
``hits_verdict``): one host sync a count.

The wrappers launch ``csrc/needle_scan.cu`` for CUDA tensors and run the
plain versions for CPU tensors: the reference's running-max formulation in
torch (``torch.cummax`` along the time axis of [positions, L] planes), in row
chunks whose maxima carry from one chunk to the next.  Needle tables,
lookahead and scope gates are those of ``seq_scan.py``.

Changes from the reference: the combines run over the sub-lanes on the
device, with the anchored prefix check at the sub-lane bases one gather of
plen bytes per sub-lane instead of a Python loop over the lanes (the host
``_combine`` stays as the plain reference), and the TPU tile-row tuning
variable is gone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .count_scan import (LaunchCounter, lane_split, make_word_tiles,
                         plan_geometry)
from .seq_scan import (AHEAD, _check_tables, chunk_rows, from_sub_lanes,
                       hit_plane, host_needles, lane_stream_words,
                       needle_table, needles_ok, stream_bytes,
                       sub_lane_tiles)

NEG = -(1 << 30)
BIG = 1 << 30

LINE_KERNEL = LaunchCounter("line_scan")
HITS_KERNEL = LaunchCounter("hits_scan")


def _excl_max(x, carry):
    """(exclusive, inclusive) running max along dim 0 from `carry`."""
    incl = torch.maximum(torch.cummax(x, 0).values, carry[None])
    return torch.cat([carry[None], incl[:-1]]), incl


def _chunks(T4: int, L: int):
    step = chunk_rows(L)
    for r0 in range(0, T4, step):
        yield r0, min(r0 + step, T4)


def _running_max(x, lo: int):
    """Inclusive running max of x [..., L, k] in corpus order (row by row,
    each leading index on its own).  It takes two levels, along each row
    and then over the rows' maxima: torch.cummax along one 524,288-entry
    row took 1.4 ms on an H100, as long as K6 itself."""
    incl = torch.cummax(x, -1).values
    rows = torch.cummax(incl[..., -1], -1).values
    before = F.pad(rows[..., :-1], (1, 0), value=lo)
    return torch.maximum(incl, before[..., None])


def _exclusive(incl, lo: int):
    """The exclusive running max [..., L, k] from an inclusive one."""
    flat = incl.flatten(-2)
    return F.pad(flat[..., :-1], (1, 0), value=lo).view(incl.shape)


def _sub_lane_bases(L: int, T: int, k: int, device):
    """[L, k] int64: sub-lane (j, l) starts at byte l*T + j*T/k, the
    (l*k + j)-th sub-lane in corpus order."""
    return torch.arange(k * L, dtype=torch.int64, device=device).view(
        L, k) * (T // k)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def _line_plain(tbl, lens, jh: int, anchored: bool, plen: int, pnl,
                tiles):
    """Plain torch K5, one walker a lane of `tiles`: (cnt, lnl, lp, lh,
    mpre) [L] int32."""
    T4, L = (int(x) for x in tiles.shape)
    dev = tiles.device
    nds = host_needles(tbl, lens)
    full = torch.full((L,), NEG, dtype=torch.int64, device=dev)
    c_ln, c_lp, c_lh = full, full, full
    mpre = torch.full((L,), -1, dtype=torch.int64, device=dev)
    cnt = torch.zeros(L, dtype=torch.int64, device=dev)
    pnl_b = pnl.bool()
    for r0, r1 in _chunks(T4, L):
        P = 4 * (r1 - r0)
        B = stream_bytes(lane_stream_words(tiles, r0, r1 + AHEAD))
        pos = torch.arange(4 * r0, 4 * r1, device=dev)[:, None]
        hit = torch.zeros((P, L), dtype=torch.bool, device=dev)
        for nd in nds[:jh]:
            hit |= hit_plane(B, nd, P)
        isnl = B[:P] == 10
        ln, incl_ln = _excl_max(torch.where(isnl, pos, NEG), c_ln)
        if anchored:
            prev_nl = torch.where(pos == 0, pnl_b[None], ln == pos - 1)
            lps = prev_nl & hit_plane(B, nds[jh], P)
            qual = hit & (ln >= 0) & (pos - ln - 1 >= plen)
            lp, incl_lp = _excl_max(torch.where(lps, pos, NEG), c_lp)
            c_lp = incl_lp[-1]
        else:
            qual = hit
        mpre = torch.maximum(mpre, torch.where(hit & (ln < 0), pos,
                                               -1).max(0).values)
        lh, incl_lh = _excl_max(torch.where(qual, pos, NEG), c_lh)
        commit = isnl & (lh > ln) & (ln >= 0)
        if anchored:
            commit &= lp > ln
        cnt += commit.sum(0)
        c_ln, c_lh = incl_ln[-1], incl_lh[-1]
    return tuple(x.to(torch.int32) for x in (cnt, c_ln, c_lp, c_lh, mpre))


def line_lanes_plain(tbl, lens, jh: int, anchored: bool, plen: int, pnl,
                     tiles):
    """Plain torch K5 over k = pnl.shape[0] sub-lanes a lane: (cnt, lnl,
    lp, lh, mpre) [k, L] int32, row j = sub-lanes (j, .), positions local
    to the sub-lane; pnl [k, L]: the byte before the sub-lane is a newline.
    The one-walker scan runs over the tiles re-laid as k*L lanes."""
    k = int(pnl.shape[0])
    return tuple(from_sub_lanes(x, k) for x in _line_plain(
        tbl, lens, jh, anchored, plen, pnl.t().reshape(-1),
        sub_lane_tiles(tiles, k)))


def line_lanes_cuda(tbl, lens, jh: int, anchored: bool, plen: int, pnl,
                    tiles):
    """Launch cgx_line_lanes of csrc/needle_scan.cu (its needle image
    build, then the walk over k = pnl.shape[0] sub-lanes a lane); same
    outputs as line_lanes_plain."""
    _check_tables(tbl, lens, tiles)
    T4, L = (int(x) for x in tiles.shape)
    k = int(pnl.shape[0]) if pnl.dim() == 2 else 0
    if (pnl.device != tiles.device or pnl.dtype != torch.int32
            or tuple(pnl.shape) != (k, L) or not pnl.is_contiguous()):
        raise ValueError(f"pnl must be contiguous int32 [k, {L}] on the "
                         f"tiles' device")
    _check_split(tiles, k)
    if int(tbl.shape[0]) != jh + int(anchored):
        raise ValueError("the table holds jh needles plus the prefix")
    dev = tiles.device
    lib = _build.lib()
    img = torch.empty(lib.cgx_needles_bytes(), dtype=torch.uint8,
                      device=dev)
    outs = [torch.empty((k, L), dtype=torch.int32, device=dev)
            for _ in range(5)]
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = lib.cgx_line_lanes(p(tbl), p(lens), int(tbl.shape[0]), jh,
                                int(anchored), plen, p(pnl), p(tiles), T4, L,
                                k, p(img), *[p(o) for o in outs],
                                _build.stream(dev))
    _build.check(rc, "line_lanes")
    return tuple(outs)


def line_lanes(tbl, lens, jh: int, anchored: bool, plen: int, pnl, tiles):
    """K5 on the tiles' device over k = pnl.shape[0] sub-lanes a lane: the
    kernel for CUDA tensors (counted on LINE_KERNEL), the plain version for
    CPU tensors."""
    args = (tbl, lens, jh, anchored, plen, pnl, tiles)
    if tiles.device.type == "cuda":
        out = line_lanes_cuda(*args)
        LINE_KERNEL.launches += 1
        return out
    if tiles.device.type != "cpu":
        raise ValueError(f"unsupported device {tiles.device}")
    _check_split(tiles, int(pnl.shape[0]))
    return line_lanes_plain(*args)


class LineScanner:
    """Exact single-launch count of the lines (newline-terminated, plus
    the final unterminated one) that hold a needle; anchored: the line
    starts with `prefix` and the needle sits at offset >= len(prefix)."""

    def __init__(self, needles: Sequence[bytes], prefix: bytes = b"",
                 anchored: bool = False, device="cpu"):
        self.needles = [bytes(nd) for nd in needles]
        self.prefix = bytes(prefix)
        self.anchored = bool(anchored and len(prefix) > 0)
        self.plen = len(prefix) if self.anchored else 0
        items = self.needles + ([self.prefix] if self.anchored else [])
        if not needles_ok(items, line_mode=True):
            raise ValueError("needle set outside the kernel's scope")
        self.jh = len(self.needles)
        self.tbl, self.lens = needle_table(items, device)
        self.prefix_t = torch.tensor(list(self.prefix), dtype=torch.uint8,
                                     device=device)

    @staticmethod
    def supported(needles: Sequence[bytes], prefix: bytes = b"") -> bool:
        items = list(needles) + ([prefix] if prefix else [])
        return needles_ok(items, line_mode=True)

    @staticmethod
    def lane_starts(data_dev: torch.Tensor, L: int, T: int, k: int = 1):
        """[k, L] int32: the byte before sub-lane (j, l), at l*T + j*T/k,
        is a newline (sub-lane (0, 0): the start of text)."""
        n = int(data_dev.shape[0])
        base = _sub_lane_bases(L, T, k, data_dev.device).t().contiguous()
        pnl = (data_dev[(base - 1).clamp(0, n - 1)] == 10).to(torch.int32)
        pnl[0, 0] = 1
        return pnl.contiguous()

    def lane_args(self, data_dev: torch.Tensor, geometry, tiles=None,
                  k: int = 1):
        """The arguments of line_lanes for this scanner and corpus at k
        sub-lanes a lane (the tiles built when None)."""
        L, T = geometry[:2]
        if tiles is None:
            tiles = make_word_tiles(data_dev, L, T // 4)
        return (self.tbl, self.lens, self.jh, self.anchored, self.plen,
                self.lane_starts(data_dev, L, T, k), tiles)

    def count(self, data_dev: torch.Tensor,
              geometry: Optional[Tuple[int, int, int, int]] = None,
              tiles: Optional[torch.Tensor] = None) -> int:
        """K5 over lane_split(T, W) sub-lanes a lane, combined on the
        tiles' device: one host sync a count."""
        n = int(data_dev.shape[0])
        if n == 0:
            return 0
        geometry = geometry or plan_geometry(n)
        _L, T, W, _Lc = geometry
        args = self.lane_args(data_dev, geometry, tiles, lane_split(T, W))
        return int(self.verdict(data_dev, T, args[5], *line_lanes(*args)))

    def verdict(self, data_dev: torch.Tensor, T: int, pnl, cnt, lnl, lpe,
                lhe, mpre):
        """The line count as a 0-dim int64 tensor on the outputs' device,
        from K5's sub-lane outputs [k, L] under lanes of T bytes and their
        pnl [k, L]: _combine's stitching over the k*L sub-lanes in corpus
        order, sub-lane (j, l) at base l*T + j*T/k, its running maxima in
        two levels (_running_max).  Each sub-lane's entry state affects
        only its first line, committed at its first newline (which the
        kernel left out), plus the final unterminated line."""
        NEGH = -(1 << 62)
        k, L = (int(x) for x in cnt.shape)
        base = _sub_lane_bases(L, T, k, cnt.device)
        # [4, L, k]: the outputs in corpus order, then as global positions
        o = torch.stack([lnl, lpe, lhe, mpre]).transpose(1, 2).to(
            torch.int64)
        g = torch.where(o > NEG // 2, o + base, NEGH)
        # the last newline and the last valid line start (anchored)
        incl = _running_max(g[:2], NEGH)
        entry = _exclusive(incl, NEGH)
        entry_ln = entry[0].clamp(min=-1)
        # a hit before the first newline qualifies against the entry line
        pre = (o[3] >= 0) & (g[3] >= entry_ln + (1 + self.plen))
        incl_lh = _running_max(
            torch.maximum(g[2], torch.where(pre, g[3], NEGH)), NEGH)
        final_ln = incl[0, -1, -1].clamp(min=-1)
        final = incl_lh[-1, -1] > final_ln
        qual = (o[0] > NEG // 2) & (
            (_exclusive(incl_lh, NEGH) > entry_ln) | pre)
        if self.anchored:
            # the entry line may start at this sub-lane's byte 0: that
            # event is in its own lpe, not in the entry's
            lp0 = torch.where(self._prefix_at(data_dev, base, pnl.t()),
                              base, NEGH)
            qual &= torch.maximum(entry[1], lp0) > entry_ln
            final &= incl[1, -1, -1] > final_ln
        return cnt.sum(dtype=torch.int64) + qual.sum() + final

    def _prefix_at(self, data_dev, base, pnl):
        """[L, k] bool: a line starts at the sub-lane base (pnl [L, k]) and
        begins with the prefix (one gather of plen bytes per sub-lane)."""
        n = int(data_dev.shape[0])
        idx = (base[..., None] + torch.arange(
            self.plen, device=base.device)).clamp(max=n - 1)
        return ((base + self.plen <= n) & (pnl != 0)
                & (data_dev[idx] == self.prefix_t).all(-1))

    def _prefix_at_bases(self, n: int, bases, data_host) -> np.ndarray:
        """[L] bool: a line starts at the lane base and begins with the
        prefix (one gather of plen bytes per lane); _combine's."""
        pb = np.asarray(data_host, dtype=np.uint8)
        L = len(bases)
        pnl = np.zeros(L, dtype=bool)
        pnl[0] = True
        pnl[1:] = pb[np.clip(bases[1:] - 1, 0, n - 1)] == 10
        fits = bases + self.plen <= n
        idx = np.minimum(bases[:, None] + np.arange(self.plen), n - 1)
        P = np.frombuffer(self.prefix, dtype=np.uint8)
        return fits & pnl & (pb[idx] == P[None, :]).all(axis=1)

    def _combine(self, n, L, T, cnt, lnl, lpe, lhe, mpre, data_host):
        """O(L) host stitching of [L] lanes' outputs (ref. _combine): each
        lane's entry state affects only its first line (committed at the
        lane's first newline, which the kernel left out), plus the final
        unterminated line.  Carries are running maxima of global positions.
        The plain reference of verdict, whose k*L sub-lanes in corpus order
        are its lanes of T/k bytes."""
        NEGH = np.int64(-(1 << 62))
        total = int(cnt.sum())
        bases = np.arange(L, dtype=np.int64) * T
        has_nl = lnl > NEG // 2

        nl_contrib = np.where(has_nl, bases + lnl, NEGH)
        incl_ln = np.maximum.accumulate(nl_contrib)
        entry_ln = np.maximum(np.concatenate([[NEGH], incl_ln[:-1]]), -1)

        lh_contrib = np.where(lhe > NEG // 2, bases + lhe, NEGH)
        mpre_ok = (mpre >= 0) & (bases + mpre >= entry_ln + 1 + self.plen)
        lh_contrib = np.maximum(lh_contrib,
                                np.where(mpre_ok, bases + mpre, NEGH))
        incl_lh = np.maximum.accumulate(lh_contrib)
        entry_lh = np.concatenate([[NEGH], incl_lh[:-1]])

        if self.anchored:
            lp_contrib = np.where(lpe > NEG // 2, bases + lpe, NEGH)
            incl_lp = np.maximum.accumulate(lp_contrib)
            entry_lp = np.concatenate([[NEGH], incl_lp[:-1]])
            # the entry line may start at this lane's position 0: that
            # event is in lpe of this lane, not in entry_lp
            lp0 = np.where(self._prefix_at_bases(n, bases, data_host),
                           bases, NEGH)
            valid = np.maximum(entry_lp, lp0) > entry_ln
            final_valid = incl_lp[-1] > max(int(incl_ln[-1]), -1)
        else:
            valid = np.ones(L, dtype=bool)
            final_valid = True

        s = entry_ln + 1
        qual = (entry_lh > entry_ln) | \
            ((mpre >= 0) & (bases + mpre >= s + self.plen))
        total += int((has_nl & valid & qual).sum())

        final_ln = max(int(incl_ln[-1]), -1)
        if final_valid and int(incl_lh[-1]) > final_ln:
            total += 1
        return total


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def _hits_plain(tbl, lens, tiles):
    """Plain torch K6, one walker a lane of `tiles`: (cnt, ov, fh, reach)
    [L] int32."""
    T4, L = (int(x) for x in tiles.shape)
    dev = tiles.device
    nds = host_needles(tbl, lens)
    c_r = torch.full((L,), NEG, dtype=torch.int64, device=dev)
    ov = torch.zeros(L, dtype=torch.bool, device=dev)
    cnt = torch.zeros(L, dtype=torch.int64, device=dev)
    fh = torch.full((L,), BIG, dtype=torch.int64, device=dev)
    for r0, r1 in _chunks(T4, L):
        P = 4 * (r1 - r0)
        B = stream_bytes(lane_stream_words(tiles, r0, r1 + AHEAD))
        pos = torch.arange(4 * r0, 4 * r1, device=dev)[:, None]
        anyh = torch.zeros((P, L), dtype=torch.bool, device=dev)
        reach = torch.full((P, L), NEG, dtype=torch.int64, device=dev)
        for nd in nds:
            h = hit_plane(B, nd, P)
            anyh |= h
            reach = torch.where(h, torch.maximum(reach, pos + len(nd) - 1),
                                reach)
        run, incl = _excl_max(reach, c_r)
        ov |= (anyh & (run >= pos)).any(0)
        cnt += anyh.sum(0)
        fh = torch.minimum(fh, torch.where(anyh, pos, BIG).min(0).values)
        c_r = incl[-1]
    return tuple(x.to(torch.int32) for x in (cnt, ov, fh, c_r))


def hits_lanes_plain(tbl, lens, tiles, k: int):
    """Plain torch K6 over k sub-lanes a lane: (cnt, ov, fh, reach) [k, L]
    int32, row j = sub-lanes (j, .), positions local to the sub-lane.  The
    one-walker scan runs over the tiles re-laid as k*L lanes."""
    return tuple(from_sub_lanes(x, k)
                 for x in _hits_plain(tbl, lens, sub_lane_tiles(tiles, k)))


def _check_split(tiles, k: int):
    T4 = int(tiles.shape[0])
    if k < 1 or k & (k - 1) or T4 % (8 * k):
        raise ValueError(f"k = {k} sub-lanes: a power of two whose "
                         f"sub-lanes hold whole 8-word groups of T4 = {T4}")


def hits_lanes_cuda(tbl, lens, tiles, k: int):
    """Launch cgx_hits_lanes of csrc/needle_scan.cu (its needle image
    build, then the walk); same outputs as hits_lanes_plain."""
    _check_tables(tbl, lens, tiles)
    _check_split(tiles, k)
    T4, L = (int(x) for x in tiles.shape)
    dev = tiles.device
    lib = _build.lib()
    img = torch.empty(lib.cgx_needles_bytes(), dtype=torch.uint8,
                      device=dev)
    outs = [torch.empty((k, L), dtype=torch.int32, device=dev)
            for _ in range(4)]
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = lib.cgx_hits_lanes(p(tbl), p(lens), int(tbl.shape[0]),
                                p(tiles), T4, L, k, p(img),
                                *[p(o) for o in outs], _build.stream(dev))
    _build.check(rc, "hits_lanes")
    return tuple(outs)


def hits_lanes(tbl, lens, tiles, k: int):
    """K6 on the tiles' device: the kernel for CUDA tensors (counted on
    HITS_KERNEL), the plain version for CPU tensors."""
    if tiles.device.type == "cuda":
        out = hits_lanes_cuda(tbl, lens, tiles, k)
        HITS_KERNEL.launches += 1
        return out
    if tiles.device.type != "cpu":
        raise ValueError(f"unsupported device {tiles.device}")
    _check_split(tiles, k)
    return hits_lanes_plain(tbl, lens, tiles, k)


def cross_lane_overlap(T: int, fh, reach) -> bool:
    """A hit whose reach runs past its lane end covers a later lane's first
    hit: the exclusive running max of the lanes' global reaches (ref.
    HitsScanner.count:601-610).  Host numpy over [L] lanes of T bytes; the
    plain reference of hits_verdict's overlap test."""
    L = len(fh)
    bases = np.arange(L, dtype=np.int64) * T
    glob = np.where(reach > NEG // 2, bases + reach, NEG)
    run = np.concatenate([[NEG], np.maximum.accumulate(glob)[:-1]])
    return bool(((fh < BIG) & (run >= bases + fh)).any())


def hits_verdict(T: int, cnt, ov, fh, reach):
    """(hit count int64, overlap bool) as 0-dim tensors on the outputs'
    device from K6's sub-lane outputs [k, L] under lanes of T bytes: an
    overlap inside a sub-lane (ov), or a hit whose reach runs past its
    sub-lane's end over a later sub-lane's first hit, by an exclusive
    running max of the global reaches in corpus order, sub-lane (j, l) at
    base l*T + j*T/k (cross_lane_overlap's test over the k*L sub-lanes, in
    two levels: _running_max)."""
    k, L = (int(x) for x in cnt.shape)
    # [L, k]: row l holds lane l's sub-lanes, so rows read in corpus order
    fh, reach = fh.t().to(torch.int64), reach.t().to(torch.int64)
    base = _sub_lane_bases(L, T, k, cnt.device)
    glob = torch.where(reach > NEG // 2, base + reach, NEG)
    run = _exclusive(_running_max(glob, NEG), NEG)
    over = ov.any() | ((fh < BIG) & (run >= base + fh)).any()
    return cnt.sum(dtype=torch.int64), over


class HitsScanner:
    """Raw-hit count with exact overlap detection for a literal set.
    count() returns the exact Go count, or None when two hits overlap in
    the data (the caller then counts with K7)."""

    def __init__(self, needles: Sequence[bytes], device="cpu"):
        nds = sorted({bytes(nd) for nd in needles}, key=len)
        if not needles_ok(nds):
            raise ValueError("needle set outside the kernel's scope")
        self.needles = nds
        self.tbl, self.lens = needle_table(nds, device)

    @staticmethod
    def supported(needles: Sequence[bytes]) -> bool:
        return needles_ok(needles)

    def lanes(self, data_dev: torch.Tensor, geometry, tiles=None,
              k: int = 1):
        """K6 outputs (cnt, ov, fh, reach) [k, L] under `geometry`, k
        sub-lanes a lane."""
        L, T, _W, _Lc = geometry
        if tiles is None:
            tiles = make_word_tiles(data_dev, L, T // 4)
        return hits_lanes(self.tbl, self.lens, tiles, k)

    def count(self, data_dev: torch.Tensor,
              geometry: Optional[Tuple[int, int, int, int]] = None,
              tiles: Optional[torch.Tensor] = None) -> Optional[int]:
        """K6 over lane_split(T, W) sub-lanes a lane, combined on the
        tiles' device: one host sync for (count, overlap)."""
        n = int(data_dev.shape[0])
        if n == 0:
            return 0
        geometry = geometry or plan_geometry(n)
        _L, T, W, _Lc = geometry
        total, over = hits_verdict(
            T, *self.lanes(data_dev, geometry, tiles, lane_split(T, W)))
        total, over = torch.stack([total, over.to(torch.int64)]).tolist()
        return None if over else total
