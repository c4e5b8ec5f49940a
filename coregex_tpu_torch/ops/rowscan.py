"""Batched many-strings scan: one launch over a padded [B, L] row matrix.

Ports ``coregex_tpu/ops/rowscan.py``.  The reference optimizes "match one
pattern against millions of short strings" by stepping the dense DFA over
all rows in lockstep (state vector [B], one gather a column), so that every
row's first byte is dispatched and rejected by the same table lookup (the
reference's first-byte dispatch and FirstByteSet rejection,
nfa/branch_dispatch.go:18-40 and nfa/firstbytes.go:8-41, for free).

Row semantics: each row is its own text (SOT context at column 0, true EOI
at its own length).  Padding beyond a row's length never contributes.

Kernels (``csrc/row_scan.cu``):
  cgx_rows_match      per-row "any match" flag and last flag position
                      (IsMatch and the forward ends of find_index_batch);
                      ref. ``_rows_scan`` (:57-87).  A block ranks a tile
                      of 512 rows by length; each warp then takes 32 rows
                      of like length at a time and stages their next 64
                      columns into shared memory with cp.async (the pieces
                      of rows still walking, two stages in flight); each
                      thread walks its row from there, one table load a
                      byte: the byte-indexed table ``RowTables.tbl_b``
                      where it fits (mode "byte"), else the class-indexed
                      one in shared ("class") or global memory ("global")
  cgx_rows_rev_start  per-row match starts for known ends: the reverse
                      anchored pass of the two-pass find; ref.
                      ``_rows_rev_scan`` (:90-127).  A block answers the
                      rows of its tile of 512 with no end or an empty walk
                      at once and ranks the others by min(end, L),
                      longest first; its warps claim 32 ranked rows at a
                      time, each lane walking its row back in aligned
                      16-byte chunks (the walks are short: no stages), in
                      the same three table modes
The plain versions, for CPU tensors, are the reference's column-lockstep
scans in torch.  The reverse pass's entry states (the reverse DFA's start
for the byte at each end, ref. :159-178, a Python loop over B there) are
one table lookup here (``rev_start_states``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..dfa.dense import CTX_SOT, DEAD, DenseDFA
from . import _build
from .count_scan import SMEM_LIMIT, LaunchCounter

ROWS_KERNEL = LaunchCounter("rows_match")
ROWS_REV_KERNEL = LaunchCounter("rows_rev_start")
_PACK_CHUNK = 1 << 16   # rows a step of pack_rows' scatter


def _pad_pow2(x: int, lo: int = 8) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


def pack_rows(texts: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Pad byte strings into a [B, L] uint8 matrix + [B] int32 lengths.
    B and L round up to powers of two (at least 8), as the reference's
    buckets do.  The bytes are scattered in chunks of rows, not one row a
    Python step."""
    lens = np.fromiter(map(len, texts), dtype=np.int64, count=len(texts))
    B = _pad_pow2(max(1, len(texts)))
    L = _pad_pow2(max(1, int(lens.max()) if len(texts) else 1))
    rows = np.zeros((B, L), dtype=np.uint8)
    flat = rows.reshape(-1)
    for i in range(0, len(texts), _PACK_CHUNK):
        ln = lens[i:i + _PACK_CHUNK]
        data = np.frombuffer(b"".join(texts[i:i + _PACK_CHUNK]),
                             dtype=np.uint8)
        if data.size == 0:
            continue
        # destination of byte j of row r: r * L + j
        base = (np.arange(i, i + len(ln), dtype=np.int64) * L
                - (np.cumsum(ln) - ln))
        flat[np.repeat(base, ln) + np.arange(data.size)] = data
    out = np.zeros((B,), dtype=np.int32)
    out[:len(texts)] = lens
    return rows, out


THREADS = 128           # threads a block (row_scan.cu's kThreads)
# the warps' stages: kThreads / 32 warps x kStages (2) x 32 rows x
# kStageRow (64 columns + 16) bytes
STAGE_BYTES = THREADS // 32 * 2 * 32 * (64 + 16)
BYTE_ROW = 260          # uint8 entries a byte-table row (kByteRow)
BYTE_MAX_S = 128        # delta << 1 | match_on fits a byte (kByteMaxS)
BYTE_SMEM = 48 << 10    # the byte-indexed table where a block's shared
                        # memory stays within this (a few blocks an SM)
MODES = ("global", "class", "byte")   # cgx_rows_match's mode numbers


def match_smem_bytes(S: int, C: int, mode: str) -> int:
    """Dynamic shared memory of a cgx_rows_match launch in a table mode
    (row_scan.cu's match_smem_bytes): the warps' stages, match_eoi's
    column, the table.  cgx_rows_rev_start takes the same less the
    stages, so a mode that fits the one fits the other."""
    b = STAGE_BYTES + (S + 15) // 16 * 16
    if mode == "byte":
        return b + S * BYTE_ROW
    if mode == "class":
        return b + 4 * S * C + 4 * 256
    return b + 4 * 256


def byte_table(tbl: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """tbl_b [S, BYTE_ROW] uint8 = tbl[s, classes[byte]] (delta << 1 |
    match_on, S <= BYTE_MAX_S); the padding past byte 255 is 0."""
    out = np.zeros((tbl.shape[0], BYTE_ROW), dtype=np.uint8)
    out[:, :256] = tbl[:, classes]
    return out


class RowTables:
    """A dense DFA's tables on `device` for the row kernels: delta and
    match_on packed as delta << 1 | match_on [S, C] int32, match_eoi's SOT
    column [S] uint8, classes [256] int32, starts [4] int32, and where it
    fits the byte-indexed tbl_b [S, BYTE_ROW] uint8 (``byte_table``).
    ``mode`` is the row kernels' table mode, the first of ``modes`` (those
    these tables allow)."""

    def __init__(self, dense: DenseDFA, device):
        self.device = torch.device(device)
        S, C = (int(x) for x in dense.delta.shape)
        self.S, self.C = S, C
        packed = ((dense.delta.astype(np.int64) << 1)
                  | dense.match_on.astype(np.int64))
        eoi = dense.match_eoi[:, CTX_SOT]
        self.tbl = torch.tensor(packed.astype(np.int32), device=self.device)
        self.eoi = torch.tensor(eoi.astype(np.uint8), device=self.device)
        self.classes = torch.tensor(dense.classes.astype(np.int32),
                                    device=self.device)
        self.starts = torch.tensor(dense.starts.astype(np.int32),
                                   device=self.device)
        self.device = self.starts.device        # "cuda" -> "cuda:0"
        self.start = int(dense.starts[CTX_SOT])
        # the walks stop at the dead state when nothing after it can flag
        self.stop_dead = bool((dense.delta[DEAD] == DEAD).all()
                              and not dense.match_on[DEAD].any()
                              and not eoi[DEAD])
        self.tbl_b = None
        if S <= BYTE_MAX_S and match_smem_bytes(S, C, "byte") <= BYTE_SMEM:
            self.tbl_b = torch.from_numpy(
                byte_table(packed, dense.classes)).to(self.device)
        self.modes = tuple(m for m, ok in (
            ("byte", self.tbl_b is not None),
            ("class", match_smem_bytes(S, C, "class") <= SMEM_LIMIT),
            ("global", True)) if ok)
        self.mode = self.modes[0]


# the reverse pass's entry context of each byte value (DenseDFA.context_of)
_CTX = np.array([DenseDFA.context_of(b) for b in range(256)],
                dtype=np.int64)


def rev_start_states(tb: RowTables, rows, lens, ends):
    """Entry states [B] int32 of the reverse pass: the start state for the
    context of the byte at each end, or of true EOI where end >= len."""
    B, L = (int(x) for x in rows.shape)
    e = ends.long().clamp(min=0)
    nxt = rows[torch.arange(B, device=rows.device), e.clamp(max=L - 1)]
    ctx = torch.as_tensor(_CTX, device=rows.device)[nxt.long()]
    ctx = torch.where(e >= lens.long(), CTX_SOT, ctx)
    return tb.starts[ctx]


def _check(tb: RowTables, rows, vecs) -> None:
    if (rows.device != tb.device or rows.dtype != torch.uint8
            or rows.dim() != 2 or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous [B, L] uint8 tensor "
                         f"on {tb.device}")
    B = int(rows.shape[0])
    for name, t in vecs:
        if (t.device != tb.device or t.dtype != torch.int32
                or tuple(t.shape) != (B,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{B}] int32 "
                             f"tensor on {tb.device}")
    if rows.shape[1] == 0:
        raise ValueError("rows must have at least one column")


def rows_match_plain(tb: RowTables, rows, lens):
    """(found [B] bool, last [B] int32): the reference's _rows_scan."""
    B, L = (int(x) for x in rows.shape)
    tbl, cls, eoi = tb.tbl.long().reshape(-1), tb.classes.long(), \
        tb.eoi.bool()
    ln = lens.long()
    s = torch.full((B,), tb.start, dtype=torch.int64, device=rows.device)
    last = torch.full((B,), -1, dtype=torch.int64, device=rows.device)
    eoi_hit = torch.zeros(B, dtype=torch.bool, device=rows.device)
    for t in range(L):
        e = tbl[s * tb.C + cls[rows[:, t].long()]]
        in_bounds = t < ln
        last = torch.where(((e & 1) > 0) & in_bounds, t, last)
        # the state at t == len is the end-of-row state: latch its EOI
        eoi_hit |= (t == ln) & eoi[s]
        s = torch.where(in_bounds, e >> 1, s)
    # rows whose length == L never hit the latch inside the loop
    eoi_hit |= (ln == L) & eoi[s]
    last = torch.where(eoi_hit, torch.maximum(last, ln), last)
    return last >= 0, last.to(torch.int32)


def rows_rev_plain(tb: RowTables, rows, ends, s0):
    """starts [B] int32 (-1: none): the reference's _rows_rev_scan from the
    entry states s0."""
    B, L = (int(x) for x in rows.shape)
    tbl, cls, eoi = tb.tbl.long().reshape(-1), tb.classes.long(), \
        tb.eoi.bool()
    run = ends >= 0
    end = ends.long().clamp(min=0)
    ar = torch.arange(B, device=rows.device)
    s = s0.long()
    last = torch.full((B,), -1, dtype=torch.int64, device=rows.device)
    for t in range(L):
        p = end - 1 - t
        live = run & (p >= 0)
        e = tbl[s * tb.C + cls[rows[ar, p.clamp(0, L - 1)].long()]]
        last = torch.where(((e & 1) > 0) & live, t, last)
        s = torch.where(live, e >> 1, s)
    # the window edge at position 0 is the row's true start
    last = torch.where(eoi[s] & run, torch.maximum(last, end), last)
    return torch.where(run & (last >= 0), end - last, -1).to(torch.int32)


def _check_chunks(rows) -> None:
    """The kernels read the rows as aligned 16-byte chunks."""
    if rows.shape[1] % 16 or rows.data_ptr() % 16:
        raise ValueError("the row kernels take a 16-byte aligned matrix of "
                         "a multiple of 16 columns (RowBatch.upload pads "
                         "pack_rows' matrix)")


def _check_mode(tb: RowTables) -> None:
    if tb.mode not in tb.modes:
        raise ValueError(f"table mode {tb.mode!r} not among {tb.modes}")


def rows_match_cuda(tb: RowTables, rows, lens):
    """cgx_rows_match on tb's tables in tb.mode; rows_match_plain's
    outputs."""
    _check(tb, rows, [("lens", lens)])
    _check_chunks(rows)
    _check_mode(tb)
    B, L = (int(x) for x in rows.shape)
    found = torch.empty(B, dtype=torch.bool, device=tb.device)
    last = torch.empty(B, dtype=torch.int32, device=tb.device)
    p = _build.ptr
    with torch.cuda.device(tb.device):
        rc = _build.lib().cgx_rows_match(
            p(tb.tbl), p(tb.eoi), p(tb.classes), p(tb.tbl_b), tb.S, tb.C,
            tb.start, int(tb.stop_dead), MODES.index(tb.mode), p(rows), B,
            L, p(lens), p(found), p(last), _build.stream(tb.device))
    _build.check(rc, "rows_match")
    return found, last


def rows_rev_cuda(tb: RowTables, rows, ends, s0):
    """cgx_rows_rev_start on tb's tables in tb.mode; rows_rev_plain's
    output."""
    _check(tb, rows, [("ends", ends), ("s0", s0)])
    _check_chunks(rows)
    _check_mode(tb)
    B, L = (int(x) for x in rows.shape)
    starts = torch.empty(B, dtype=torch.int32, device=tb.device)
    p = _build.ptr
    with torch.cuda.device(tb.device):
        rc = _build.lib().cgx_rows_rev_start(
            p(tb.tbl), p(tb.eoi), p(tb.classes), p(tb.tbl_b), tb.S, tb.C,
            int(tb.stop_dead), MODES.index(tb.mode), p(rows), B, L, p(ends),
            p(s0), p(starts), _build.stream(tb.device))
    _build.check(rc, "rows_rev_start")
    return starts


def rows_match(tb: RowTables, rows, lens):
    """The forward row scan on the rows' device: the kernel for CUDA
    tensors, counted on ROWS_KERNEL, the plain version for CPU tensors."""
    if rows.device.type == "cuda":
        out = rows_match_cuda(tb, rows, lens)
        ROWS_KERNEL.launches += 1
        return out
    if rows.device.type != "cpu":
        raise ValueError(f"unsupported device {rows.device}")
    _check(tb, rows, [("lens", lens)])
    return rows_match_plain(tb, rows, lens)


def rows_rev_start(tb: RowTables, rows, ends, s0):
    """The reverse row scan on the rows' device (as rows_match)."""
    if rows.device.type == "cuda":
        out = rows_rev_cuda(tb, rows, ends, s0)
        ROWS_REV_KERNEL.launches += 1
        return out
    if rows.device.type != "cpu":
        raise ValueError(f"unsupported device {rows.device}")
    _check(tb, rows, [("ends", ends), ("s0", s0)])
    return rows_rev_plain(tb, rows, ends, s0)


class RowBatch:
    """Per-pattern batched rows matcher on `device`."""

    def __init__(self, fwd_dense: DenseDFA, rev_dense=None, device="cuda"):
        self.device = torch.device(device)
        self.fwd = RowTables(fwd_dense, self.device)
        self.rev = (RowTables(rev_dense, self.device)
                    if rev_dense is not None else None)

    def _dev(self, x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(self.device)

    def upload(self, rows: np.ndarray, lens: np.ndarray):
        """pack_rows' matrix and lengths as tensors on the device, the
        matrix's columns padded with zeros to a multiple of 16 (the
        kernels' chunk; padding past a row's length is never read as
        part of it)."""
        pad = -int(rows.shape[1]) % 16
        if pad:
            rows = np.pad(rows, ((0, 0), (0, pad)))
        return self._dev(rows), self._dev(lens)

    def match_ends_device(self, rows, lens):
        """(found [B] bool, last [B] int32) tensors of device rows."""
        return rows_match(self.fwd, rows, lens)

    def rev_starts_device(self, rows, lens, ends):
        """Match starts [B] int32 (-1: none) of device rows with known
        ends (< 0: skip)."""
        s0 = rev_start_states(self.rev, rows, lens, ends)
        return rows_rev_start(self.rev, rows, ends, s0)

    def match_ends(self, rows: np.ndarray, lens: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        found, last = self.match_ends_device(*self.upload(rows, lens))
        return found.cpu().numpy(), last.cpu().numpy()

    def rev_starts(self, rows: np.ndarray, lens: np.ndarray,
                   ends: np.ndarray) -> np.ndarray:
        """Match starts for rows with known ends (two-pass find)."""
        return self.rev_starts_device(
            *self.upload(rows, lens),
            self._dev(np.asarray(ends, dtype=np.int32))).cpu().numpy()
