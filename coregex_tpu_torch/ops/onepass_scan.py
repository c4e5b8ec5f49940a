"""Batched OnePass capture extraction: the capture slots of many verified
match spans at once, the device form of the OnePass DFA's host walk
(``dfa/onepass.py`` ``OnePassDFA.apply``).

Ports ``coregex_tpu/ops/onepass_scan.py``.  The reference packs the tables
into a float32 ``comb`` matrix split at bit 16 (:35-81), so that a TPU
matmul gathers a state's row, and runs ``_onepass_window`` (:84-138) once
per power-of-two width bucket (:150-189).  Here the tables stay integers:
``DeviceOnePass`` uploads ``trans [S, C, 2]`` ({next state, slot mask}),
``fin [S, 2]`` ({match_cond, match_slots}) and the byte classes; a -1
transition goes to a dead state whose match_cond is 0, as the reference's
sentinel row does.  The CUDA kernel, ``cgx_onepass_extract`` in
``csrc/onepass_scan.cu``, walks every span to its own end in one launch,
one span a thread of persistent blocks, reading the span's bytes in
aligned 16-byte chunks and writing each block's slots as one coalesced
slab; its tables sit in shared memory where they fit (``mode`` "class"),
else in global memory ("global").  The plain version, for CPU tensors,
steps a state vector over the W + 1 columns of each power-of-two width
bucket, as the reference's scan does.

Results equal the reference's ``extract``: slots [M, NS] (-1 unset) and
ok [M], False for a lane that dies or ends in a non-match state and for
every span wider than MAX_WINDOW (the caller re-extracts those on the
host).  Positions are int32: the corpus is at most MAX_CORPUS bytes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..dfa.onepass import MAX_SLOTS, OnePassDFA
from . import _build
from .count_scan import SMEM_LIMIT, LaunchCounter

MAX_WINDOW = 1 << 14
ONEPASS_KERNEL = LaunchCounter("onepass_extract")
THREADS = 256           # threads a block (onepass_scan.cu's kThreads)
MODES = ("global", "class")     # the tables in global or shared memory


def smem_bytes(S: int, C: int, NS: int, shared_tables: bool) -> int:
    """Dynamic shared memory of a launch (onepass_scan.cu's smem_bytes):
    the slot slab [THREADS, NS | 1] and the classes, and fin and trans
    when the tables sit there."""
    return (4 * THREADS * (NS | 1) + 4 * 256
            + (8 * S + 8 * S * C if shared_tables else 0))


class DeviceOnePass:
    """A OnePass DFA's tables as int32 tensors on `device`.  ``mode`` is
    the kernel's table mode, the first of ``modes`` (those these tables
    allow): "class" holds them in shared memory, "global" reads them from
    global memory."""

    def __init__(self, op: OnePassDFA, device):
        S, C = (int(x) for x in op.delta.shape)
        if op.num_slots > MAX_SLOTS:
            raise ValueError(f"{op.num_slots} slots > {MAX_SLOTS}")
        self.device = torch.device(device)
        self.S, self.C = S, C
        self.start = int(op.start)
        self.num_slots = int(op.num_slots)
        self.NS = max(self.num_slots, 1)

        def int32(*cols):
            """Columns stacked as int32 words (a mask's bit 31 as the
            sign bit, a -1 transition as -1)."""
            x = np.stack([c.astype(np.int64) & 0xFFFFFFFF for c in cols],
                         axis=-1)
            return torch.tensor(x.astype(np.uint32).view(np.int32),
                                device=self.device)

        self.trans = int32(op.delta, op.slotmask)
        self.fin = int32(op.match_cond, op.match_slots)
        self.classes = torch.tensor(op.classes.astype(np.int32),
                                    device=self.device)
        self.device = self.classes.device       # "cuda" -> "cuda:0"
        # the tables sit in shared memory where they fit beside the slots;
        # past that the kernel reads them from global memory
        self.modes = (("class",) if smem_bytes(S, C, self.NS, True)
                      <= SMEM_LIMIT else ()) + ("global",)
        self.mode = self.modes[0]


def _check(d: DeviceOnePass, data, spans) -> None:
    for name, t, dt in (("data", data, torch.uint8),
                        ("spans", spans, torch.int32)):
        if t.device != d.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {d.device}")
    if data.dim() != 1 or spans.dim() != 2 or spans.shape[1] != 2:
        raise ValueError("data must be [n] and spans [M, 2]")
    if data.numel() >= 2 ** 31:
        raise ValueError("corpus past the int32 position range")


def _walk_plain(d: DeviceOnePass, tb, cls, a, e, W: int):
    """The reference's scan (:96-131) of lanes from a to e over W + 1
    columns on a state vector, the dead state as row S of tb."""
    tbl_next, tbl_mask, mcond, mslots = tb
    M, n = int(a.numel()), int(cls.numel())
    iota = torch.arange(d.NS, device=a.device)
    st = torch.full((M,), d.start, dtype=torch.int64, device=a.device)
    slots = torch.full((M, d.NS), -1, dtype=torch.int32, device=a.device)
    ok = torch.zeros(M, dtype=torch.bool, device=a.device)
    for t in range(W + 1):
        pos = a + t
        valid = pos < e
        at_end = pos == e
        idx = st * d.C + cls[pos.clamp(0, n - 1)]
        nxt, mask = tbl_next[idx], tbl_mask[idx]
        cond = mcond[st]
        ok = torch.where(at_end, cond, ok)
        end_bits = ((mslots[st][:, None] >> iota) & 1) > 0
        p32 = pos.to(torch.int32)[:, None]
        slots = torch.where((at_end & cond)[:, None] & end_bits, p32, slots)
        bits = ((mask[:, None] >> iota) & 1) > 0
        slots = torch.where(valid[:, None] & bits, p32, slots)
        st = torch.where(valid, nxt, st)
    return slots, ok


def onepass_plain(d: DeviceOnePass, data, spans):
    """(slots [M, NS] int32, ok [M] bool) of the spans [M, 2] int32 over the
    corpus data [n] uint8: the reference's scan, on a state vector over
    the W + 1 columns of each power-of-two width bucket (W >= 16) of the
    spans no wider than MAX_WINDOW, as the reference buckets them."""
    M, S = int(spans.shape[0]), d.S
    dev = spans.device
    a, e = spans[:, 0].long(), spans[:, 1].long()
    # row S is the dead state: it stays dead, sets nothing, never matches
    trans = torch.cat([d.trans.long().reshape(S * d.C, 2),
                       torch.tensor([[S, 0]], device=dev).expand(d.C, 2)])
    fin = torch.cat([d.fin.long(), torch.zeros((1, 2), dtype=torch.int64,
                                               device=dev)])
    tb = (torch.where(trans[:, 0] < 0, S, trans[:, 0]),
          trans[:, 1] & 0xFFFFFFFF, fin[:, 0] != 0, fin[:, 1] & 0xFFFFFFFF)
    # a corpus of 0 bytes reads byte 0, as the kernel does
    cls = d.classes.long()[data.long() if data.numel()
                           else data.new_zeros(1).long()]
    slots = torch.full((M, d.NS), -1, dtype=torch.int32, device=dev)
    ok = torch.zeros(M, dtype=torch.bool, device=dev)
    width = (e - a).clamp(min=16)
    # bucket k holds the widths in (2^(k-1), 2^k]
    bucket = torch.ceil(torch.log2(width.double())).long()
    for k in sorted(set(bucket[width <= MAX_WINDOW].tolist())):
        sel = torch.nonzero(bucket == k).reshape(-1)
        slots[sel], ok[sel] = _walk_plain(d, tb, cls, a[sel], e[sel], 1 << k)
    return slots, ok


def onepass_cuda(d: DeviceOnePass, data, spans):
    """cgx_onepass_extract on d's tables in d.mode; onepass_plain's
    outputs."""
    _check(d, data, spans)
    if spans.data_ptr() % 8:
        raise ValueError("the kernel reads spans as 8-byte rows")
    if d.mode not in d.modes:
        raise ValueError(f"table mode {d.mode!r} not among {d.modes}")
    M = int(spans.shape[0])
    slots = torch.empty((M, d.NS), dtype=torch.int32, device=d.device)
    ok = torch.empty(M, dtype=torch.bool, device=d.device)
    p = _build.ptr
    with torch.cuda.device(d.device):
        rc = _build.lib().cgx_onepass_extract(
            p(d.trans), p(d.fin), p(d.classes), d.S, d.C, d.NS, d.start,
            MODES.index(d.mode), p(data), int(data.numel()), p(spans), M,
            p(slots), p(ok), _build.stream(d.device))
    _build.check(rc, "onepass_extract")
    return slots, ok


def onepass_extract(d: DeviceOnePass, data, spans):
    """The slots of the spans on d's device: the kernel for CUDA tensors,
    counted on ONEPASS_KERNEL, the plain version for CPU tensors."""
    if spans.device.type == "cuda":
        out = onepass_cuda(d, data, spans)
        ONEPASS_KERNEL.launches += 1
        return out
    if spans.device.type != "cpu":
        raise ValueError(f"unsupported device {spans.device}")
    _check(d, data, spans)
    return onepass_plain(d, data, spans)


class OnePassScanner:
    """Batched capture extraction over verified match spans."""

    def __init__(self, op: OnePassDFA, device):
        self.d = DeviceOnePass(op, device)
        self.op = op

    def extract_device(self, data, spans):
        """(slots [M, NS] int32, ok [M] bool) on the device of the spans
        [M, 2] int32 (BatchEngine.find_all_spans_device's first M rows)
        over the device corpus data [n] uint8."""
        return onepass_extract(self.d, data, spans)

    def extract(self, data, spans: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """spans [M, 2] int64 -> (slots [M, NS] int64, ok [M] bool), the
        reference's extract: spans wider than MAX_WINDOW report ok=False
        (the host re-extracts them)."""
        spans = np.asarray(spans, dtype=np.int64).reshape(-1, 2)
        M = len(spans)
        if M == 0:
            return (np.full((0, self.d.NS), -1, dtype=np.int64),
                    np.zeros(0, dtype=bool))
        n = int(data.numel())
        if spans.min() < 0 or spans.max() > n:
            raise ValueError(f"spans outside the corpus [0, {n}]")
        sp = torch.from_numpy(spans.astype(np.int32)).to(self.d.device)
        slots, ok = self.extract_device(data, sp)
        return slots.cpu().numpy().astype(np.int64), ok.cpu().numpy()
