"""Single-pass ordered compaction with the profiling rig's switches (K10).

Ports the rig ``tools/_compact_exp.py``: ``compact_exp`` (:231-272) and its
Pallas kernel ``make_kernel(R, npay, do_route, do_dma, skip_empty,
cond_dma)`` (:67, launched at :243), the experiment that measured where
K4's time went on the TPU.  For CUDA tensors ``compact_exp`` launches
``csrc/compact_exp.cu`` (``cgx_compact_exp``): one pass of persistent
blocks, each taking tiles of CH = R*128 entries by ticket from a ring of
two shared-memory buffers fed by bulk copies, ranking a tile's entries in
one block scan, finding its offset by a chained scan with decoupled
look-back while the next tile's bytes fly, and storing its positions and
payloads in order, so the mask is read from device memory once (K4 takes
three passes).  What bounds it on an H100 is device-memory bytes: the mask
once, the payloads at the set entries, the outputs once.  For CPU tensors
it runs the plain cumsum-and-scatter version, which has K4's contract.

Contract (the rig's): ``n = nc * CH`` entries; returns (pos int32[cap],
*payloads int32[cap], cnt int32) with pos padded with n past cnt and, here,
payloads with 0 (the rig leaves them undefined there).  ``skip_empty`` and
``cond_dma`` change how the kernel works, not what it returns;
``do_route=False`` and ``do_dma=False`` are timing ablations whose results
are invalid, and on the CPU, where they mean nothing, they raise.
"""

from __future__ import annotations

import torch

from . import _build
from .compact2 import MAX_PAYLOADS, _check_args, compact_pay_plain
from .count_scan import LaunchCounter

COMPACT_EXP_KERNEL = LaunchCounter("compact_exp")
ROWS = (128, 256, 512)


def compact_exp_plain(mask8, pays, cap: int):
    """Plain torch version: cumsum plus scatter (compact2's
    compact_pay_plain without its ok flag).  Returns (pos, *pays, cnt)."""
    return compact_pay_plain(mask8, pays, cap)[:-1]


def _check_shape(n: int, R: int, npay: int):
    """The rig's shape rules, for both devices: R in ROWS, 0 < n = nc*CH <
    2^31, at most MAX_PAYLOADS payloads."""
    if R not in ROWS:
        raise ValueError(f"R must be one of {ROWS}")
    if npay > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payloads")
    if not 0 < n < 2 ** 31 or n % (R * 128):
        raise ValueError(f"mask length {n} is not a positive multiple of "
                         f"CH = {R * 128} below 2^31")


def compact_exp_cuda(mask8, pays, cap: int, R: int = 128,
                     do_route: bool = True, do_dma: bool = True,
                     skip_empty: bool = False, cond_dma: bool = False):
    """Launch csrc/compact_exp.cu; same contract as compact_exp_plain.
    The outputs get the rig's slack of ceil(cap/128) + R + 2 rows of 128
    (compact_exp :241) before they are cut to cap."""
    n = int(mask8.shape[0])
    dev = mask8.device
    _check_shape(n, R, len(pays))
    _check_args(mask8, pays)
    if mask8.data_ptr() % 16:
        raise ValueError("mask must be 16-byte aligned")
    ch = R * 128
    nc = n // ch
    out_len = (-(-cap // 128) + R + 2) * 128
    pos = torch.empty(out_len, dtype=torch.int32, device=dev)
    outs = [torch.empty(out_len, dtype=torch.int32, device=dev)
            for _ in pays]
    # status words, the ticket counter, a group accumulator per 32 tiles
    scratch = torch.empty(nc + 1 + -(-nc // 32), dtype=torch.int64,
                          device=dev)
    cnt = torch.empty((), dtype=torch.int32, device=dev)
    p = _build.ptr
    ins = [p(t) for t in pays] + [0] * (MAX_PAYLOADS - len(pays))
    ops = [p(t) for t in outs] + [0] * (MAX_PAYLOADS - len(outs))
    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = lib.cgx_compact_exp(
            p(mask8), nc, R, len(pays), *ins, out_len, p(pos), *ops,
            int(do_route), int(do_dma), int(skip_empty), int(cond_dma),
            p(scratch), p(cnt), _build.stream(dev))
    _build.check(rc, "compact_exp")
    live = torch.arange(cap, device=dev) < cnt
    return (torch.where(live, pos[:cap], n),
            *[torch.where(live, o[:cap], 0) for o in outs], cnt)


def compact_exp(mask, *pays, cap: int, R: int = 128, npay: int = 0,
                do_route: bool = True, do_dma: bool = True,
                skip_empty: bool = False, cond_dma: bool = False):
    """The rig's compact_exp on torch tensors: positions of the set entries
    of the 1-D `mask` (n a multiple of R*128) and `npay` payloads routed
    alike.  Returns (pos[cap], *pays[cap], cnt) on the mask's device."""
    if npay != len(pays):
        raise ValueError(f"npay ({npay}) must equal the number of payloads "
                         f"given ({len(pays)})")
    mask8 = mask.view(torch.uint8) if mask.dtype == torch.bool \
        else (mask != 0).to(torch.uint8)
    pays = [q.to(torch.int32).contiguous() for q in pays]
    if mask.device.type == "cuda":
        out = compact_exp_cuda(mask8.contiguous(), pays, cap, R, do_route,
                               do_dma, skip_empty, cond_dma)
        COMPACT_EXP_KERNEL.launches += 1
        return out
    if mask.device.type != "cpu":
        raise ValueError(f"unsupported device {mask.device}")
    _check_shape(int(mask.shape[0]), R, npay)
    if not (do_route and do_dma):
        raise ValueError("do_route=False and do_dma=False are timing "
                         "ablations of the CUDA kernel")
    return compact_exp_plain(mask8, pays, cap)
