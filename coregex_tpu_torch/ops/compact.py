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
"""

from __future__ import annotations

import torch

from .compact2 import compact_pay_cuda
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
