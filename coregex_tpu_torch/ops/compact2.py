"""Ordered stream compaction with payload routing (K4) and the sparse chain.

Ports ``coregex_tpu/ops/compact2.py``: ``compact_pay`` (:316-344) with the
contract of ``_compact_pay_xla`` (:292-308), ``pack_words`` (:351),
``sparse_chain_payloads`` and ``_chain_pay_body`` (:517-588),
``sparse_positions_words`` with ``_chain_body`` (:374-435), and
``_bucket_up`` (:402).  For CUDA tensors
``compact_pay`` launches ``csrc/compact.cu`` at every size (the reference
sends inputs below 4 blocks to XLA); for CPU tensors it runs the plain
scatter version.

The sparse chain extracts set-bit positions from int32 event words in
n/32 + ~12*hits work: nonzero WORDS compact with their values and the
per-word payloads, each word expands to its nonzero BYTES, each byte to its
set BITS; every level is one ordered compaction.  Per-word payloads do
not ride the levels as in the reference (whose TPU kernel cannot gather):
an event's word payload is its word's value, so after level 3 it is one
gather at ``pos >> 5``.  K4 then routes at most two payloads per level,
whatever the number of word payloads.
"""

from __future__ import annotations

import torch

from . import _build
from .bytescan import _bucket
from .count_scan import LaunchCounter

COMPACT_KERNEL = LaunchCounter("compact_pay")
MAX_PAYLOADS = 4
_CHUNK = 4096   # mask entries per block of csrc/compact.cu


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


def compact_pay_cuda(mask8, pays, cap: int):
    """Launch csrc/compact.cu; same contract as compact_pay_plain."""
    n = int(mask8.shape[0])
    dev = mask8.device
    if mask8.dtype != torch.uint8 or not mask8.is_contiguous():
        raise ValueError("mask must be contiguous uint8")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"compaction length {n} outside [1, 2^31)")
    if len(pays) > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payloads")
    for p in pays:
        if (p.device != dev or p.dtype != torch.int32
                or not p.is_contiguous() or tuple(p.shape) != (n,)):
            raise ValueError("payloads must be contiguous int32 [n] on the "
                             "mask's device")
    nb = -(-n // _CHUNK)
    pos = torch.empty(cap, dtype=torch.int32, device=dev)
    outs = [torch.empty(cap, dtype=torch.int32, device=dev) for _ in pays]
    block_counts = torch.empty(nb, dtype=torch.int32, device=dev)
    block_offs = torch.empty(nb, dtype=torch.int32, device=dev)
    scal = torch.empty(2, dtype=torch.int32, device=dev)
    p = _build.ptr
    ins = [p(t) for t in pays] + [0] * (MAX_PAYLOADS - len(pays))
    ops = [p(t) for t in outs] + [0] * (MAX_PAYLOADS - len(outs))
    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = lib.cgx_compact(
            p(mask8), n, len(pays), *ins, cap, p(pos), *ops,
            p(block_counts), p(block_offs), p(scal), _build.stream(dev))
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
    _, pos, cnt, ok3 = compact_pay(m3.reshape(-1), [pos3.reshape(-1)], cap)
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
