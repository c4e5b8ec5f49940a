"""Ordered stream compaction with payload routing (K4) and the sparse chain.

Ports ``coregex_tpu/ops/compact2.py``: ``compact_pay`` (:316-344) with the
contract of ``_compact_pay_xla`` (:292-308), ``pack_words`` (:351),
``sparse_chain_payloads`` and ``_chain_pay_body`` (:517-588),
``sparse_positions_words`` with ``_chain_body`` (:374-435), and
``_bucket_up`` (:402).  For CUDA tensors
``compact_pay`` launches ``csrc/compact.cu`` at every size (the reference
sends inputs below 4 blocks to XLA): one pass over the mask in tiles of
``TILE`` bytes, loaded in bulk from the mask's first 16-byte aligned byte
on, with the unaligned head and the ragged tail read byte by byte
(``_tile_plan``), then a fill of the slots past the count.  For CPU
tensors it runs the plain scatter version.

The sparse chain extracts set-bit positions from int32 event words in
n/32 + ~12*hits work: nonzero WORDS compact with their values and the
per-word payloads, each word expands to its nonzero BYTES, each byte to its
set BITS; every level is one ordered compaction.  Per-word payloads do
not ride the levels as in the reference (whose TPU kernel cannot gather):
an event's word payload is its word's value, so after level 3 it is one
gather at ``pos >> 5``.  K4 then routes at most two payloads per level,
whatever the number of word payloads.

``word_popcounts`` and ``word_pieces`` have no counterpart: they cut event
words into runs of whole words whose set bits one compaction can hold
(the reference's results end at its span limit).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .bytescan import _bucket, piece_cuts
from .count_scan import LaunchCounter

COMPACT_KERNEL = LaunchCounter("compact_pay")
MAX_PAYLOADS = 4
# csrc/compact.cu's kTile and kStage, mirrored for _tile_plan: the kernel
# refuses a tile count made with another TILE
TILE = 32 * 1024            # mask bytes per tile
_STAGE = 4096               # positions staged per store round


def compact_pay_plain(mask8, pays, cap: int):
    """Plain torch version (the reference's _compact_pay_xla): ordered
    positions of the set entries, payloads routed alike, slots past the
    count filled with n and 0, entries past cap dropped.  Returns
    (pos[cap], *pays[cap], cnt, ok)."""
    n = int(mask8.shape[0])
    dev = mask8.device
    m = mask8 != 0
    cum = torch.cumsum(m.to(torch.int64), 0)
    cnt = cum[-1].to(torch.int32)
    # slot cap is a dump for dropped entries, cut off below
    idx = torch.where(m & (cum <= cap), cum - 1, cap)
    out = torch.full((cap + 1,), n, dtype=torch.int32, device=dev)
    out.scatter_(0, idx, torch.arange(n, dtype=torch.int32, device=dev))
    live = torch.arange(cap, device=dev) < cnt
    pos = torch.where(live, out[:cap], n)
    pouts = []
    for p in pays:
        po = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        po.scatter_(0, idx, p)
        pouts.append(torch.where(live, po[:cap], 0))
    return (pos, *pouts, cnt, cnt <= cap)


class TilePlan(NamedTuple):
    """How csrc/compact.cu reads a mask of n bytes at a byte offset.  The
    wrapper passes head, body and tiles to the kernel and sizes its scratch
    by scratch_words; tail and smem (the kernel's kSmem) are for checks."""
    head: int           # bytes before the first 16-byte aligned one
    body: int           # aligned bytes after them, a multiple of 16
    tail: int           # bytes after the body
    tiles: int          # TILE-byte tiles (tile 0 starts 16 - head bytes early)
    scratch_words: int  # int64 status words, one a tile, plus the ticket
    smem: int           # dynamic shared memory of a block


def _tile_plan(offset: int, n: int) -> TilePlan:
    """The launch arithmetic of csrc/compact.cu for an n-byte mask whose
    first byte lies `offset` bytes past a 16-byte boundary.  The bulk
    copies read [head, head + body), whose ends are 16-byte aligned; the
    kernel reads the head and the tail byte by byte.  Tile t covers mask
    bytes [t*TILE - lead, (t+1)*TILE - lead), lead putting the body's first
    byte on a 16-byte boundary of the tile.  Shared memory holds two tiles
    and two rounds of staged positions, whatever the payload count, since
    payloads are read in output order from device memory."""
    head = min(n, -offset % 16)
    body = (n - head) // 16 * 16
    lead = -head % 16
    tiles = -(-(lead + n) // TILE)
    return TilePlan(head, body, n - head - body, tiles, tiles + 1,
                    2 * TILE + 2 * _STAGE * 4)


def _check_args(mask8, pays) -> None:
    """What csrc/compact.cu takes: a contiguous uint8 mask of n in [1,
    2^31) entries at any byte offset, at most MAX_PAYLOADS contiguous int32
    payloads of n entries on its device."""
    n = int(mask8.shape[0])
    if mask8.dtype != torch.uint8 or not mask8.is_contiguous():
        raise ValueError("mask must be contiguous uint8")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"compaction length {n} outside [1, 2^31)")
    if len(pays) > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payloads")
    for p in pays:
        if (p.device != mask8.device or p.dtype != torch.int32
                or not p.is_contiguous() or tuple(p.shape) != (n,)):
            raise ValueError("payloads must be contiguous int32 [n] on the "
                             "mask's device")


def compact_pay_cuda(mask8, pays, cap: int):
    """Launch csrc/compact.cu; same contract as compact_pay_plain."""
    _check_args(mask8, pays)
    n = int(mask8.shape[0])
    dev = mask8.device
    plan = _tile_plan(mask8.data_ptr() % 16, n)
    pos = torch.empty(cap, dtype=torch.int32, device=dev)
    outs = [torch.empty(cap, dtype=torch.int32, device=dev) for _ in pays]
    scratch = torch.empty(plan.scratch_words, dtype=torch.int64, device=dev)
    scal = torch.empty(2, dtype=torch.int32, device=dev)
    p = _build.ptr
    ins = [p(t) for t in pays] + [0] * (MAX_PAYLOADS - len(pays))
    ops = [p(t) for t in outs] + [0] * (MAX_PAYLOADS - len(outs))
    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = lib.cgx_compact(
            p(mask8), n, plan.head, plan.body, plan.tiles, len(pays), *ins,
            cap, p(pos), *ops, p(scratch), p(scal),
            _build.stream(dev))
    _build.check(rc, "compact")
    return (pos, *outs, scal[0], scal[1] != 0)


def compact_pay(mask, pays=(), cap: int = 16):
    """Positions of the set entries of 1-D `mask` (ascending, int32[cap]
    padded with n) plus each payload compacted by the same permutation.
    Returns (pos, *pays, cnt, ok), all on the mask's device; ok is False
    when cnt exceeded cap (results truncated)."""
    n = int(mask.shape[0])
    npay = len(pays)
    dev = mask.device
    if n == 0:
        z = torch.zeros(cap, dtype=torch.int32, device=dev)
        return (z, *[z] * npay, torch.zeros((), dtype=torch.int32,
                                             device=dev),
                torch.ones((), dtype=torch.bool, device=dev))
    mask8 = mask.view(torch.uint8) if mask.dtype == torch.bool \
        else (mask != 0).to(torch.uint8)
    pays = [q.to(torch.int32).contiguous() for q in pays]
    if dev.type == "cuda":
        out = compact_pay_cuda(mask8.contiguous(), pays, cap)
        COMPACT_KERNEL.launches += 1
        return out
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return compact_pay_plain(mask8, pays, cap)


def _bucket_up(x: int) -> int:
    """Power-of-two word bucket (>= 1024) of the sparse chain."""
    return _bucket(x, 1024)


def pack_words(mask, nw: int):
    """bool/uint8 0-1 mask [nw*32] -> int32 words [nw], bit j of word i =
    mask[32i+j].  Each int64 view of eight mask bytes times
    0x0102040810204080 carries byte t to bit 56 + t; every cross term lands
    below bit 56 or past bit 63, each on its own bit, so nothing carries.
    The top byte is then one byte of the word, and four such bytes view as
    the int32 word (little-endian); the multiply wraps in int64."""
    x = mask.contiguous().view(torch.uint8).view(torch.int64)
    return ((x * 0x0102040810204080) >> 56).to(torch.uint8).view(
        torch.int32)


# positions a block of the piece cut covers: 2^15 blocks at 2^31 positions,
# so the cut's block totals are a small host array
PIECE_BLOCK = 1 << 16


def word_popcounts(words):
    """Set bits of each int32 word, as int32 [nw]: a SWAR popcount of each
    byte (uint8, so shifts are logical), summed four bytes a word."""
    b = words.contiguous().view(torch.uint8)
    x = b - ((b >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.view(-1, 4).sum(1, dtype=torch.int32)


def word_pieces(words, limit: int, take: int = -1, total: int = -1):
    """Runs of whole words of `words` cut from their running popcounts:
    [(first word, end word, set bits)], each run holding at most `limit`
    set bits (a single word may hold more when limit < 32), in order,
    covering the words up to the `take`-th set bit (all when take < 0).
    One sync for the block totals.  A caller that knows the words' `total`
    set bits gets the one run of all of them, with no popcount pass, when
    they fit `limit`."""
    nw = int(words.shape[0])
    if 0 <= total <= limit:
        return [(0, nw, total)]
    wb = max(1, min(PIECE_BLOCK // 32, limit // 32))
    pc = word_popcounts(words)
    nb = -(-nw // wb)
    if nb * wb != nw:
        pc = torch.cat([pc, pc.new_zeros(nb * wb - nw)])
    blocks = pc.view(nb, wb).sum(1, dtype=torch.int64).cpu().numpy()
    return [(b0 * wb, min(b1 * wb, nw), c)
            for b0, b1, c in piece_cuts(blocks, limit, take)]


# the chain's last level compacts 8 entries a byte: at most 2^27 bytes (2^30
# entries) a compaction
_L3_ROWS = 1 << 27


def _chain_pay_body(evw, wordpays, n: int, cap: int):
    """Event words + P per-WORD int32 payload arrays -> (pos[cap],
    pay0[cap], ..., cnt, ok): every event inherits its word's payloads,
    gathered at the event's word after the last level."""
    dev = evw.device
    nwb = int(evw.shape[0])
    capw = min(nwb, cap)
    wpos, wu, cntw, ok1 = compact_pay(evw != 0, [evw], capw)
    capb = min(4 * capw, cap)
    live = (torch.arange(capw, device=dev) < cntw)[:, None]
    j4 = torch.arange(4, dtype=torch.int32, device=dev)[None, :]
    bu = (wu[:, None] >> (8 * j4)) & 0xFF
    m2 = live & (bu != 0)
    base2 = wpos[:, None] * 32 + 8 * j4
    _, bu_c, bbase_c, cntb, ok2 = compact_pay(
        m2.reshape(-1), [bu.reshape(-1), base2.reshape(-1)], capb)
    live3 = (torch.arange(capb, device=dev) < cntb)[:, None]
    j8 = torch.arange(8, dtype=torch.int32, device=dev)[None, :]
    m3 = live3 & (((bu_c[:, None] >> j8) & 1) != 0)
    pos3 = bbase_c[:, None] + j8
    rows = int(m3.shape[0])
    if rows <= _L3_ROWS:
        _, pos, cnt, ok3 = compact_pay(m3.reshape(-1), [pos3.reshape(-1)],
                                       cap)
    else:
        # 8 entries a byte pass the compaction's 2^31 - 1 entries at a cap
        # of 2^28: the bytes go _L3_ROWS at a time, in order (one sync each)
        pos = torch.full((cap,), n, dtype=torch.int32, device=dev)
        total, ok3 = 0, torch.ones((), dtype=torch.bool, device=dev)
        for r0 in range(0, rows, _L3_ROWS):
            r1 = min(rows, r0 + _L3_ROWS)
            _, p, c, okc = compact_pay(m3[r0:r1].reshape(-1),
                                       [pos3[r0:r1].reshape(-1)], cap)
            c = int(c)
            take = max(0, min(c, cap - total))
            pos[total:total + take] = p[:take]
            total += c
            ok3 = ok3 & okc
        cnt = torch.tensor(total, dtype=torch.int32, device=dev)
        ok3 = ok3 & (cnt <= cap)
    live_o = torch.arange(cap, device=dev) < cnt
    pays = []
    if wordpays:
        word = torch.where(live_o, pos >> 5, 0).long()
        pays = [torch.where(live_o, q[word], 0) for q in wordpays]
    pos = torch.where(live_o, pos, n)
    return (pos, *pays, cnt, ok1 & ok2 & ok3)


def sparse_chain_payloads(event_words, word_payloads, n: int, cap: int):
    """Event positions from word-packed `event_words` with, per event, the
    value of each [nw] int32 payload array at the event's WORD.  Inputs
    are padded to the power-of-two word bucket.  Returns (pos[cap],
    pay0[cap], ..., cnt, ok); pos holds n past cnt."""
    nw = int(event_words.shape[0])
    nwb = _bucket_up(max(nw, 1))
    pays = [p.to(torch.int32) for p in word_payloads]
    evw = event_words
    if nwb != nw:
        z = torch.zeros(nwb - nw, dtype=torch.int32, device=evw.device)
        evw = torch.cat([evw, z])
        pays = [torch.cat([p, z]) for p in pays]
    return _chain_pay_body(evw, pays, n, cap)


def sparse_positions_words(words, n: int, cap: int):
    """Set-bit positions of int32 `words` (ref. sparse_positions_words
    :414-435 with _chain_body :374-399): the sparse chain with no word
    payloads, three K4 compactions.  `cap` must bound the hit count (ok
    is False and the result truncated otherwise).  Returns (pos[cap],
    cnt, ok); pos holds n past cnt."""
    return sparse_chain_payloads(words, [], n, cap)
