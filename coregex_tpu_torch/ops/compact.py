"""Positions of the set entries of a mask (K8).

Ports ``coregex_tpu/ops/compact.py``: ``compact_positions`` (:240-258) with
the contract of ``_compact_xla`` (:224-232).  The TPU kernel,
``_compact_kernel`` / ``_kernel_init`` (:97-187, launched by
``_compact_call`` :191), left-packs each 16,384-entry block through a
binary-weighted shift network and writes rows at a running offset carried
along the sequential grid.  On Hopper the function is K4's with no
payloads (ordered positions of the set entries), so for CUDA tensors
``compact_positions`` launches ``csrc/compact.cu`` (``cgx_compact``,
``npay = 0``: one pass over the mask, at any length and byte offset) at
every size; the reference sends masks below 4 blocks to XLA.  K8 keeps its own entry point and launch count.  For CPU tensors it
runs the plain scatter version.

``mask_pieces`` and ``compact_positions_into`` have no counterpart: a mask
with more set entries than one compaction may hold (the span limit) is
compacted in pieces cut from its running counts, each piece one K8 launch
with a cap within the limit, written at its offset of one output.
"""

from __future__ import annotations

import torch

from .bytescan import _bucket, piece_cuts
from .compact2 import PIECE_BLOCK, compact_pay_cuda
from .count_scan import LaunchCounter

COMPACT_POS_KERNEL = LaunchCounter("compact_positions")
_PLAIN_CHUNK = 1 << 26   # mask entries per step of the plain version


def compact_positions_plain(mask8, cap: int):
    """Plain torch version (the reference's _compact_xla): the scatter of
    each set entry's position to its rank, slots past the count filled
    with n, entries past cap dropped.  Runs in chunks of 2^26 entries with
    a running rank, so its transients stay bounded at corpus scale.
    Returns (pos int32[cap], count int32), the count being the full
    total."""
    n = int(mask8.shape[0])
    dev = mask8.device
    out = torch.full((cap + 1,), n, dtype=torch.int32, device=dev)
    base = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, n, _PLAIN_CHUNK):
        hi = min(n, lo + _PLAIN_CHUNK)
        m = mask8[lo:hi] != 0
        cum = torch.cumsum(m, 0) + base
        # slot cap is a dump for dropped entries, cut off below
        idx = torch.where(m & (cum <= cap), cum - 1, cap)
        out.scatter_(0, idx, torch.arange(lo, hi, dtype=torch.int32,
                                          device=dev))
        base = cum[-1]
    return out[:cap], base.to(torch.int32)


def compact_positions(mask, cap: int):
    """Positions of the set entries of 1-D `mask` (any integer or bool
    dtype), ascending, as (int32[cap] padded with n, int32 count).  The
    count is the full total, even past cap; callers check count <= cap."""
    n = int(mask.shape[0])
    dev = mask.device
    if n == 0:
        return (torch.zeros(cap, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    mask8 = mask.view(torch.uint8) if mask.dtype == torch.bool \
        else (mask != 0).to(torch.uint8)
    if dev.type == "cuda":
        pos, cnt, _ok = compact_pay_cuda(mask8.contiguous(), [], cap)
        COMPACT_POS_KERNEL.launches += 1
        return pos, cnt
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return compact_positions_plain(mask8, cap)


def mask_pieces(mask, limit: int, take: int = -1, total: int = -1):
    """Position ranges of 1-D `mask` cut from its running counts:
    [(lo, hi, set entries)], each holding at most `limit` set entries, in
    order, covering the mask up to its `take`-th set entry (all of it when
    take < 0).  Blocks are a power of two of at most min(limit,
    PIECE_BLOCK) positions, so no block alone passes the limit.  One sync
    for the block totals, none when the caller knows the mask's `total`
    set entries and they fit `limit` (one piece)."""
    n = int(mask.shape[0])
    if 0 <= total <= limit:
        return [(0, n, total)]
    blk = 1 << (min(limit, PIECE_BLOCK).bit_length() - 1)
    m8 = mask.view(torch.uint8) if mask.dtype == torch.bool \
        else (mask != 0).to(torch.uint8)
    full = n // blk
    sums = [m8[:full * blk].view(full, blk).sum(1, dtype=torch.int64)]
    if n > full * blk:
        sums.append(m8[full * blk:].sum(dtype=torch.int64).reshape(1))
    blocks = torch.cat(sums).cpu().numpy()
    return [(b0 * blk, min(b1 * blk, n), c)
            for b0, b1, c in piece_cuts(blocks, limit, take)]


def compact_positions_into(mask, out, limit: int, take: int = -1,
                           total: int = -1):
    """The positions of the set entries of 1-D `mask`, ascending, written
    into `out` (an int32 1-D view, a column of a span array among them):
    the first `take` of them (all when take < 0), in pieces of at most
    `limit` entries, each one compact_positions with a cap of at most
    _bucket(limit).  Returns (entries written, pieces, ok): ok, a device
    bool, checks each piece's count against its cut.  `total`, where the
    caller knows it, is the mask's set entries (mask_pieces)."""
    off = pieces = 0
    ok = torch.ones((), dtype=torch.bool, device=mask.device)
    for lo, hi, cf in mask_pieces(mask, limit, take, total):
        c = cf if take < 0 else min(cf, take - off)
        if c <= 0:
            continue
        pos, cnt = compact_positions(mask[lo:hi], _bucket(cf, 16))
        ok = ok & (cnt == cf)
        out[off:off + c] = pos[:c] + lo
        off += c
        pieces += 1
    return off, pieces, ok
