"""Bitset-NFA scan: the corpus scan of the BITSET_NFA tier, for patterns
whose DFA overflows.

Ports ``coregex_tpu/ops/nfa_scan.py``: the scope gate (``LookUnsupported``,
``MAX_BITSET_STATES``, ``MAX_CTX_GROUPS``), ``_cls3``, ``_closure_ctx`` and
``_ctx_args`` unchanged; ``DeviceBitsetNFA`` (:125-219) with the same host
tables, plus their packed forms for the kernel; ``_bitset_scan``
(:237-339) as the walk and repair passes of this module; and
``BitsetNFAScanner`` (:342-372).

A live set of Thompson threads is a bitset over the S range states of the
NFA.  One byte step at position p, in the boundary context of p + 1 (class
of byte p, class of byte p + 1, end of text at n: ref. :251-268), is the
reference's ``step`` (:269-288):

    alive = active & cover[b]            the range states that take byte b
    next  = OR of the closure rows of alive's states, from the context's
            closure group (cmap)
    flag  = some alive state's closure reaches MATCH
    next |= start[smap[ctx]]             the unanchored restart

A flag at p means that some match ends at boundary p + 1.  The TPU runs
the OR as a bf16 matmul on the MXU; the CUDA kernel, ``cgx_bitset_scan`` in
``csrc/nfa_scan.cu``, keeps the set in ceil(S/64) 64-bit words and ORs the
closure rows of alive's set bits from shared memory.  The plain version,
for CPU tensors, is the reference's step in torch: float32 0/1 tensors, a
product with the closure table and the reference's ``> 0`` test.

Geometry.  The reference scans at most 256 lanes (``plan_bitset_geometry``,
:222-233) and gives up after 4 repair passes (converged False; its caller
goes to the host).  The port walks the lane walks' geometry: the lanes of
``count_scan.plan_geometry`` over the corpus's cached word tiles, each
split into k = ``lane_split(T, W)`` sub-lanes that warm up over the W
bytes before them from the start closure there.  The repair passes are
the split fixpoint's (``count_scan.split_passes``): a sub-lane whose set
after the warmup differs from the previous sub-lane's exit set walks
again, from that exit; after SUB_PASSES such passes, whole lanes do.  A
warmup set is a subset of the true set (the step is monotone and the true
set holds the start closure), and it is exact when no match attempt that
is still alive started more than W bytes back.  The scan runs until every
seam settles, so it finishes on the device or raises, and its flags are
those of one sequential walk: the reference's, wherever that converged.

Scope (checked when the tables are built, on the host): S <= 512 range
states, at most 4 closure groups, and no empty match from the start
closure in any context.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..nfa.nfa import NFA, Kind, Look, is_word_byte
from . import _build
from .compact2 import pack_words
from .count_scan import (SUB_PASSES, LaunchCounter, lane_split,
                         make_word_tiles, plan_geometry, settled,
                         split_passes, sub_limits)
from .dfa_scan import MatchScan
from .span_scan import to_global

MAX_BITSET_STATES = 512
MAX_CTX_GROUPS = 4

# boundary context classes (prev or next byte)
_C_OTHER, _C_WORD, _C_NL = 0, 1, 2
_N_EOT = 3  # next-class only

BITSET_KERNEL = LaunchCounter("bitset_scan")
# csrc/nfa_scan.cu's passes: pass 0 with warmup, a pass over the unsettled
# sub-lanes, a pass over the lanes holding one (count_scan's PASS_*)
PASS_FIRST, PASS_SUB, PASS_LANE = 0, 1, 2
SMEM_LIMIT = 232448     # shared memory an H100 block can use
# the table shapes csrc/nfa_scan.cu's kernel is specialised on (its Mode):
# no looks (G = Gs = 1: gmap and smap all 0, no byte context at all), and
# looks
MODE_FREE, MODE_LOOK = 0, 1


class LookUnsupported(Exception):
    """Out of bitset scope: too many states/context groups, or nullable."""


def _cls3(b: int) -> int:
    if is_word_byte(b):
        return _C_WORD
    return _C_NL if b == 10 else _C_OTHER


def _closure_ctx(nfa: NFA, sid: int, range_id: dict,
                 pw: bool, pnl: bool, at_start: bool,
                 nw: bool, nnl: bool, at_eoi: bool) -> Tuple[set, bool]:
    """Epsilon closure of `sid` under a full boundary context (mirrors
    determinize.closure_full's look evaluation exactly)."""
    seen = set()
    out: set = set()
    match = False
    stack = [sid]
    while stack:
        s = stack.pop()
        if s in seen:
            continue
        seen.add(s)
        st = nfa.states[s]
        k = st[0]
        if k == Kind.RANGE:
            out.add(range_id[s])
        elif k == Kind.MATCH:
            match = True
        elif k == Kind.SPLIT:
            stack.extend(st[1:])
        elif k == Kind.CAPTURE:
            stack.append(st[2])
        elif k == Kind.LOOK:
            look = st[1]
            ok = False
            if look == Look.BEGIN_TEXT:
                ok = at_start
            elif look == Look.BEGIN_LINE:
                ok = at_start or pnl
            elif look == Look.END_TEXT:
                ok = at_eoi
            elif look == Look.END_LINE:
                ok = at_eoi or nnl
            elif look == Look.WORD_BOUNDARY:
                ok = pw != nw
            elif look == Look.NO_WORD_BOUNDARY:
                ok = pw == nw
            if ok:
                stack.append(st[2])
        # FAIL: drop
    return out, match


def _ctx_args(pc: int, nc: int, at_start: bool = False):
    return dict(pw=pc == _C_WORD, pnl=pc == _C_NL, at_start=at_start,
                nw=nc == _C_WORD, nnl=nc == _C_NL, at_eoi=nc == _N_EOT)


def set_words(S: int) -> int:
    """64-bit words of a bitset over S states."""
    return max(1, -(-S // 64))


def pack_sets_np(bits: np.ndarray) -> np.ndarray:
    """[..., S] 0/1 -> int64 [..., NW]: bit s%64 of word s//64 = state s."""
    S = bits.shape[-1]
    pad = np.zeros(bits.shape[:-1] + (set_words(S) * 64,), dtype=np.uint8)
    pad[..., :S] = bits != 0
    return np.ascontiguousarray(
        np.packbits(pad, axis=-1, bitorder="little")).view(np.int64)


def pack_sets(bits: torch.Tensor) -> torch.Tensor:
    """[M, S] 0/1 tensor -> int64 [M, NW] (pack_sets_np's layout)."""
    M, S = (int(x) for x in bits.shape)
    NW = set_words(S)
    b = torch.zeros((M, NW * 64), dtype=torch.uint8, device=bits.device)
    b[:, :S] = bits != 0
    w = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                     device=bits.device)
    by = (b.view(M, NW * 8, 8) * w).sum(-1, dtype=torch.uint8)
    return by.view(torch.int64).reshape(M, NW)


def unpack_sets(words: torch.Tensor, S: int) -> torch.Tensor:
    """int64 [M, NW] -> float32 [M, S] 0/1."""
    M = int(words.shape[0])
    by = words.contiguous().view(torch.uint8).reshape(M, -1, 1)
    sh = torch.arange(8, dtype=torch.uint8, device=words.device)
    return ((by >> sh) & 1).reshape(M, -1)[:, :S].to(torch.float32)


class BitsetTables(NamedTuple):
    """The kernel's tables on one torch device: bitsets of NW int64 words
    and the two context maps."""
    cover: torch.Tensor     # [256, NW] range states that take each byte
    rows: torch.Tensor      # [G, S, NW] closure rows per group
    mbits: torch.Tensor     # [G, NW] states whose closure reaches MATCH
    startw: torch.Tensor    # [Gs, NW] start closures
    botw: torch.Tensor      # [4, NW] text-start closures
    cmap: torch.Tensor      # [12] int32 context -> closure group
    smap: torch.Tensor      # [12] int32 context -> start group


class DeviceBitsetNFA:
    """Tables of the bitset scan (ref. :125-219).  Host (numpy) tables, as
    the reference's:

    lo/hi: [S] int32 per-range byte bounds.
    ct:    [G, S, S+1] float32 -- group g's closure table; row s = closure
           of state s's target under that boundary context, column S the
           match flag.  cmap[pc*4+nc] -> group id.
    start: [Gs, S] start-closure seeds per context group; smap[12].
    bot:   [4, S] start closures at text start (per next class).

    Their packed forms, int64 bitsets of NW = ceil(S/64) words: ``cover``
    [256, NW] (bit s of byte b's row: lo[s] <= b <= hi[s]), ``rows`` [G, S,
    NW] (ct's closure columns), ``mbits`` [G, NW] (ct's match column),
    ``startw`` [Gs, NW] and ``botw`` [4, NW].  Their bit j is range state
    ``order[j]``, the states sorted by their byte range (lo, then hi): the
    states that take some byte < 128 come first, so that when at most 64
    do (``ascii_word``) a byte < 128 touches word 0 alone, which the
    kernel's ASCII step relies on, and the states of one range sit side by
    side, so that the states a byte takes gather into few bytes and
    nibbles of a set (the kernel's chunk tables).  The plain version walks
    the same order (plain_tables).  ``mode`` is the kernel's
    specialisation: MODE_FREE where G = Gs = 1 (so cmap and smap are all
    0), else MODE_LOOK.
    ``tables`` holds them and the context maps on `device`.  Raises
    LookUnsupported past S or G's limit."""

    def __init__(self, nfa: NFA, device):
        range_states = [i for i, st in enumerate(nfa.states)
                        if st[0] == Kind.RANGE]
        if len(range_states) > MAX_BITSET_STATES:
            raise LookUnsupported(
                f"{len(range_states)} range states > {MAX_BITSET_STATES}")
        rid = {s: j for j, s in enumerate(range_states)}
        S = len(range_states)
        self.S = S
        lo = np.zeros(S, dtype=np.int32)
        hi = np.zeros(S, dtype=np.int32)
        has_looks = nfa.any_look()
        ctxs = ([(pc, nc) for pc in range(3) for nc in range(4)]
                if has_looks else [(0, 0)])

        tables = {}
        cmap = np.zeros(12, dtype=np.int32)
        for (pc, nc) in ctxs:
            ct = np.zeros((S, S + 1), dtype=np.float32)
            for s, j in rid.items():
                st = nfa.states[s]
                lo[j], hi[j] = st[1], st[2]
                tgt, m = _closure_ctx(nfa, st[3], rid,
                                      **_ctx_args(pc, nc))
                for t in tgt:
                    ct[j, t] = 1.0
                if m:
                    ct[j, S] = 1.0
            key = ct.tobytes()
            if key not in tables:
                tables[key] = (len(tables), ct)
            gid = tables[key][0]
            if has_looks:
                cmap[pc * 4 + nc] = gid
        G = len(tables)
        if G > MAX_CTX_GROUPS:
            raise LookUnsupported(f"{G} closure context groups")
        ct_stack = np.stack(
            [t for _, t in sorted(tables.values(), key=lambda x: x[0])],
            axis=0)

        # start seeds per context + BOT variants; nullable in ANY
        # context is out of scope (empty matches end everywhere)
        starts = {}
        smap = np.zeros(12, dtype=np.int32)
        nullable = False
        for (pc, nc) in ctxs:
            sset, m = _closure_ctx(nfa, nfa.start_anchored, rid,
                                   **_ctx_args(pc, nc))
            nullable |= m
            v = np.zeros(S, dtype=np.float32)
            for t in sset:
                v[t] = 1.0
            key = v.tobytes()
            if key not in starts:
                starts[key] = (len(starts), v)
            if has_looks:
                smap[pc * 4 + nc] = starts[key][0]
        start_stack = np.stack(
            [v for _, v in sorted(starts.values(), key=lambda x: x[0])],
            axis=0)
        bot = np.zeros((4, S), dtype=np.float32)
        for nc in range(4 if has_looks else 1):
            sset, m = _closure_ctx(nfa, nfa.start_anchored, rid,
                                   **_ctx_args(0, nc, at_start=True))
            nullable |= m
            for t in sset:
                bot[nc, t] = 1.0
        if not has_looks:
            bot[:] = bot[0]
        self.nullable = bool(nullable)
        self.G = G
        self.Gs = len(starts)
        self.has_looks = has_looks
        self.lo, self.hi, self.ct = lo, hi, ct_stack
        self.start, self.bot, self.cmap, self.smap = (start_stack, bot, cmap,
                                                      smap)
        self.NW = set_words(S)
        self.order = np.lexsort((np.arange(S), hi, lo))
        self.ascii_word = self.NW > 1 and int((lo < 128).sum()) <= 64
        o = self.order
        b = np.arange(256)[:, None]
        self.cover = pack_sets_np((lo[None, o] <= b) & (b <= hi[None, o]))
        self.rows = pack_sets_np(ct_stack[:, o][:, :, o])
        self.mbits = pack_sets_np(ct_stack[:, o, S])
        self.startw = pack_sets_np(start_stack[:, o])
        self.botw = pack_sets_np(bot[:, o])
        self.mode = MODE_FREE if G == 1 and self.Gs == 1 else MODE_LOOK
        self.device = torch.device(device)
        if (self.device.type == "cuda"
                and max(smem_bytes(S, self.NW, G, self.Gs, a)
                        for a in (False, self.ascii_word)) > SMEM_LIMIT):
            raise ValueError("bitset tables exceed the kernel's shared "
                             "memory")

        def dev(x, dtype):
            return torch.tensor(np.ascontiguousarray(x), dtype=dtype,
                                device=self.device)
        self.tables = BitsetTables(
            *(dev(x, torch.int64) for x in (self.cover, self.rows,
                                            self.mbits, self.startw,
                                            self.botw)),
            cmap=dev(cmap, torch.int32), smap=dev(smap, torch.int32))


def chunk_words(NW: int, G: int, ascii: bool) -> int:
    """64-bit words of a block's chunk tables (nfa_scan.cu's chunk_words):
    the closure rows' word 0 ORed by each byte of m's word 0 (the ASCII
    kernels), or the rows ORed by each nibble of m (NW <= 2)."""
    if ascii and NW > 1:
        return G * 8 * 256
    return G * NW * 256 * NW if NW <= 2 else 0


def smem_bytes(S: int, NW: int, G: int, Gs: int, ascii: bool = False) -> int:
    """Shared memory of a cgx_bitset_scan block: the bitset tables, the
    chunk tables and the byte classes (pass 0 on ascii_word tables takes
    the ASCII kernel's)."""
    return 8 * (NW * (256 + G * S + G + Gs) + chunk_words(NW, G, ascii)) \
        + 256


class KernelInfo(NamedTuple):
    """Pass 0's kernel on a table shape, from the CUDA runtime."""
    warps: int          # resident warps an SM (the occupancy calculator)
    registers: int      # registers a thread
    spill_bytes: int    # local-memory bytes a thread


def kernel_info(d: DeviceBitsetNFA) -> KernelInfo:
    """Occupancy, registers and spills of pass 0's kernel on d's tables."""
    info = (ctypes.c_int * 4)()
    _build.check(_build.lib().cgx_bitset_occupancy(
        d.mode, int(d.ascii_word), d.S, d.NW, d.G, d.Gs, info),
        "bitset_scan")
    return KernelInfo(info[0] * info[3] // 32, info[1], info[2])


# ---------------------------------------------------------------------------
# The walk: plain version and kernel
# ---------------------------------------------------------------------------

class PlainTables(NamedTuple):
    """The plain version's tables in the reference's layout, states in the
    packed order (DeviceBitsetNFA.order): ok [256, S] bool (state s takes
    byte b: lo[s] <= b <= hi[s]), float32 0/1 ct [G, S, S+1], start [12, S]
    (the start row of each context, start[smap]), and cmap [12] int64."""
    ok: torch.Tensor
    ct: torch.Tensor
    start: torch.Tensor
    cmap: torch.Tensor


def plain_tables(d: DeviceBitsetNFA, device) -> PlainTables:
    """d's host tables as the plain version reads them, on `device`."""
    b = np.arange(256)[:, None]
    o = d.order

    def f32(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)
    return PlainTables(ok=torch.tensor((d.lo[None, o] <= b)
                                       & (b <= d.hi[None, o]), device=device),
                       ct=f32(d.ct[:, o][:, :, np.append(o, d.S)]),
                       start=f32(d.start[d.smap][:, o]),
                       cmap=torch.tensor(d.cmap, dtype=torch.int64,
                                         device=device))


_CLS = [_cls3(b) for b in range(256)]


def _corpus(tiles, n: int):
    """Word tiles [T4, L] of n bytes -> (the bytes lane after lane with one
    zero byte after the last lane's, uint8 [N]; the context of each step,
    uint8 [N]: class of byte p * 4 + class of byte p + 1, end of text at
    p + 1 = n, as the reference tabulates them at :251-268)."""
    data = torch.cat([tiles.t().contiguous().view(torch.uint8).reshape(-1),
                      tiles.new_zeros(1, dtype=torch.uint8)])
    N = int(data.shape[0])
    cls = torch.tensor(_CLS, dtype=torch.uint8, device=data.device)
    ctx = torch.empty_like(data)
    step = 1 << 26
    for i in range(0, N, step):
        m = min(step, N - i)
        c = cls[data[i:min(i + m + 1, N)].long()]
        nc = c[1:m + 1] if int(c.shape[0]) > m else torch.cat([c[1:], c[-1:]])
        ctx[i:i + m] = c[:m] * 4 + nc
    ctx[n - 1] = _CLS[int(data[n - 1])] * 4 + _N_EOT
    return data, ctx


def _walk_plain(pt: PlainTables, data, ctx, p0, steps: int, active, lim,
                skip, emit: bool):
    """M sets (float32 [M, S] 0/1) walk positions p0 + q (int64 [M]) for q <
    steps, stepping where skip <= q < lim ([M]; skip may be 0) by the
    reference's step (:269-288); `data` and `ctx` from _corpus.  Returns
    (active, flags [M, steps] bool or None)."""
    M, S = (int(x) for x in active.shape)
    G = int(pt.ct.shape[0])
    N = int(data.shape[0])
    dev = data.device
    flags = (torch.zeros((M, steps), dtype=torch.bool, device=dev)
             if emit else None)
    top = min(steps, int(lim.max())) if M else 0
    chunk = max(1, (1 << 24) // max(M, 1))
    for q0 in range(0, top, chunk):
        qs = torch.arange(q0, min(q0 + chunk, top), device=dev)
        pos = (p0[:, None] + qs[None, :]).clamp(0, N - 1)
        byte, cx = data[pos].long(), ctx[pos].long()
        gid = pt.cmap[cx]
        live = (qs[None, :] < lim[:, None]) & (qs[None, :] >= (
            skip[:, None] if torch.is_tensor(skip) else skip))
        mcol = torch.empty((M, int(qs.shape[0])), dtype=torch.float32,
                           device=dev)
        for c in range(int(qs.shape[0])):
            alive = torch.where(pt.ok[byte[:, c]], active, 0.0)
            nxt = alive @ pt.ct[0]
            for g in range(1, G):      # the one group of this context
                nxt = torch.where((gid[:, c] == g)[:, None],
                                  alive @ pt.ct[g], nxt)
            mcol[:, c] = nxt[:, S]
            nr = torch.maximum((nxt[:, :S] > 0).to(torch.float32),
                               pt.start[cx[:, c]])
            active = torch.where(live[:, c, None], nr, active)
        if emit:
            flags[:, q0:q0 + int(qs.shape[0])] = (mcol > 0) & live
    return active, flags


def _sub_starts(L: int, T: int, k: int, device):
    """Global start position of each sub-lane, int64 [k*L] in row order."""
    lane = torch.arange(L, dtype=torch.int64, device=device)
    j = torch.arange(k, dtype=torch.int64, device=device)
    return (lane[None, :] * T + j[:, None] * (T // k)).reshape(-1)


def _flag_outputs(fl, k: int, L: int):
    """Sub-lane flags [k*L, Tk] bool -> (flag words [T/32, L] in the
    kernel's layout, counts [k, L], sub-lane-local last flag [k, L])."""
    Tk = int(fl.shape[1])
    lanes = fl.view(k, L, Tk).permute(1, 0, 2).reshape(-1)
    fw = pack_words(lanes, L * k * Tk // 32).view(L, -1).t().contiguous()
    counts = fl.sum(dim=1, dtype=torch.int32).view(k, L)
    pos = torch.arange(Tk, dtype=torch.int32, device=fl.device)
    last = torch.where(fl, pos, -1).amax(dim=1).to(torch.int32).view(k, L)
    return fw, counts, last


def bitset_walk_plain(d: DeviceBitsetNFA, tiles, W4: int, entries, offsets,
                      limits, n: int):
    """Pass 0 of the plain version over k sub-lanes a lane: sub-lane (j, l)
    walks from entries[j, l] over the W4 words before its first word
    (lane l-1's last ones for j = 0; lane 0 skips positions below
    offsets[0]), then its own T/k bytes up to its share of limits[l].
    entries [k, L, NW] int64; offsets, limits [L] int32.  Returns (counts
    [k, L] int32, exits [k, L, NW], sync [k, L, NW] (the sets after the
    warmup), flagw [T4/8, L] int32 in K9's layout, last [k, L] int32
    (sub-lane-local position of the last flag, -1 if none))."""
    T4, L = (int(x) for x in tiles.shape)
    k, _L, NW = (int(x) for x in entries.shape)
    T, S = 4 * T4, d.S
    dev = tiles.device
    pt = plain_tables(d, dev)
    data, ctx = _corpus(tiles, n)
    x = _sub_starts(L, T, k, dev)
    W = 4 * W4
    skip = torch.cat([offsets, offsets.new_zeros((k - 1) * L)])
    act = unpack_sets(entries.reshape(-1, NW), S)
    act, _ = _walk_plain(pt, data, ctx, x - W, W, act,
                         torch.full_like(skip, W), skip, False)
    sync = pack_sets(act)
    act, fl = _walk_plain(pt, data, ctx, x, T // k, act,
                          sub_limits(limits, k, T // k), 0, True)
    fw, counts, last = _flag_outputs(fl, k, L)
    return (counts, pack_sets(act).view(k, L, NW), sync.view(k, L, NW), fw,
            last)


def _want(prev, first):
    """The set each sub-lane should enter with: the previous sub-lane's
    exit in corpus order, `first` [NW] for sub-lane (0, 0).  [k, L, NW]."""
    k, L, NW = (int(x) for x in prev.shape)
    flat = prev.permute(1, 0, 2).reshape(-1, NW)
    return torch.cat([first.view(1, NW), flat[:-1]]).view(L, k, NW) \
        .permute(1, 0, 2)


def bitset_repair_plain(d: DeviceBitsetNFA, whole: bool, tiles, n: int,
                        limits, first, prev, exits, counts, sync, flagw,
                        last, walked):
    """One repair pass of the plain version, in place: each unsettled real
    sub-lane (whole=False), or each lane holding one (whole=True), walks
    again, with no warmup, from the previous sub-lane's exit in `prev` [k,
    L, NW] (`first` [NW] for sub-lane (0, 0)); the walkers rewrite their
    sync, counts, last and flag groups, `exits` gets every sub-lane's exit
    (the others copy theirs from prev) and walked[0] the walkers."""
    T4, L = (int(x) for x in tiles.shape)
    k, _L, NW = (int(x) for x in prev.shape)
    T, S = 4 * T4, d.S
    Tk = T // k
    dev = tiles.device
    pt = plain_tables(d, dev)
    data, ctx = _corpus(tiles, n)
    lim = sub_limits(limits, k, Tk).view(k, L)
    want = _want(prev, first)
    bad = (lim > 0) & (sync != want).any(dim=2)
    x = _sub_starts(L, T, k, dev).view(k, L)
    if whole:
        lanes = bad.any(dim=0)
        sel = lanes[None, :].expand(k, L)
        s_in, s_out, fls = [], [], []
        act = unpack_sets(want[0], S)
        for j in range(k):
            s_in.append(pack_sets(act))
            act, fl = _walk_plain(pt, data, ctx, x[j], Tk, act, lim[j], 0,
                                  True)
            s_out.append(pack_sets(act))
            fls.append(fl)
        s_in, s_out = torch.stack(s_in), torch.stack(s_out)
        fl = torch.cat(fls)
        walked.fill_(int(lanes.sum()))
    else:
        sel = bad
        s_in = want
        act, fl = _walk_plain(pt, data, ctx, x.reshape(-1), Tk,
                              unpack_sets(want.reshape(-1, NW), S),
                              lim.reshape(-1), 0, True)
        s_out = pack_sets(act).view(k, L, NW)
        walked.fill_(int(bad.sum()))
    fw, c, la = _flag_outputs(fl, k, L)
    sync.copy_(torch.where(sel[..., None], s_in, sync))
    exits.copy_(torch.where(sel[..., None], s_out, prev))
    counts.copy_(torch.where(sel, c, counts))
    last.copy_(torch.where(sel, la, last))
    G = T4 // 8 // k
    rows = sel.t().repeat_interleave(G, dim=1).t()       # [k*G, L]
    flagw.copy_(torch.where(rows, fw, flagw))


def _check_scan_args(tb: BitsetTables, tiles, W4: int, entries, limits,
                     n: int):
    dev = tiles.device
    for name, t in zip(BitsetTables._fields, tb):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"table {name} must be contiguous on {dev}")
    for name, t, dt in (("tiles", tiles, torch.int32),
                        ("entries", entries, torch.int64),
                        ("limits", limits, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {dev}")
    T4, L = (int(x) for x in tiles.shape)
    G, S, NW = (int(x) for x in tb.rows.shape)
    Gs = int(tb.startw.shape[0])
    if (not 1 <= NW <= 8 or tuple(tb.cover.shape) != (256, NW)
            or tuple(tb.mbits.shape) != (G, NW)
            or int(tb.startw.shape[1]) != NW
            or smem_bytes(S, NW, G, Gs) > SMEM_LIMIT):
        raise ValueError("bad bitset tables")
    if entries.dim() != 3 or tuple(entries.shape[1:]) != (L, NW):
        raise ValueError(f"entries must have shape (k, {L}, {NW})")
    k = int(entries.shape[0])
    if k & (k - 1) or T4 % 8 or (T4 // 8) % k or not 0 <= W4 <= T4 // k:
        raise ValueError(f"bad geometry T4={T4} W4={W4} k={k}")
    if tuple(limits.shape) != (L,) or not 0 < n <= 4 * T4 * L:
        raise ValueError("bad limits or corpus length")


def _launch(pass_, d, tiles, W4, k, n, entries, offsets, limits, first,
            prev, counts, last, exits, sync, flagw, walked):
    T4, L = (int(x) for x in tiles.shape)
    tb = d.tables
    p = _build.ptr
    with torch.cuda.device(tiles.device):
        rc = _build.lib().cgx_bitset_scan(
            pass_, d.mode, int(d.ascii_word), p(tb.cover), p(tb.rows),
            p(tb.mbits), p(tb.startw), p(tb.cmap), p(tb.smap),
            d.S, d.NW, d.G, d.Gs,
            p(tiles), T4, L, W4, k, n, p(entries), p(offsets), p(limits),
            p(first), p(prev), p(counts), p(last), p(exits), p(sync),
            p(flagw), p(walked), _build.stream(tiles.device))
    _build.check(rc, "bitset_scan")


def bitset_walk_cuda(d: DeviceBitsetNFA, tiles, W4: int, entries, offsets,
                     limits, n: int):
    """Launch pass 0 of csrc/nfa_scan.cu on d's tables; bitset_walk_plain's
    outputs."""
    tb = d.tables
    _check_scan_args(tb, tiles, W4, entries, limits, n)
    if (offsets.dtype != torch.int32 or offsets.shape != limits.shape
            or offsets.device != tiles.device):
        raise ValueError("offsets must be int32 like limits")
    T4, L = (int(x) for x in tiles.shape)
    k = int(entries.shape[0])
    dev = tiles.device
    counts, last = (torch.empty((k, L), dtype=torch.int32, device=dev)
                    for _ in range(2))
    exits, sync = torch.empty_like(entries), torch.empty_like(entries)
    flagw = torch.empty((T4 // 8, L), dtype=torch.int32, device=dev)
    _launch(PASS_FIRST, d, tiles, W4, k, n, entries, offsets, limits, None,
            None, counts, last, exits, sync, flagw, None)
    return counts, exits, sync, flagw, last


def bitset_repair_cuda(d: DeviceBitsetNFA, whole: bool, tiles, n: int,
                       limits, first, prev, exits, counts, sync, flagw,
                       last, walked):
    """Launch one repair pass of csrc/nfa_scan.cu on d's tables;
    bitset_repair_plain's in-place outputs."""
    tb = d.tables
    _check_scan_args(tb, tiles, 0, prev, limits, n)
    k, L, NW = (int(x) for x in prev.shape)
    for name, t, shape, dt in (
            ("first", first, (NW,), torch.int64),
            ("exits", exits, (k, L, NW), torch.int64),
            ("sync", sync, (k, L, NW), torch.int64),
            ("counts", counts, (k, L), torch.int32),
            ("last", last, (k, L), torch.int32),
            ("flagw", flagw, (int(tiles.shape[0]) // 8, L), torch.int32),
            ("walked", walked, (1,), torch.int32)):
        if (tuple(t.shape) != shape or t.dtype != dt
                or not t.is_contiguous() or t.device != tiles.device):
            raise ValueError(f"{name} must be a contiguous {dt} tensor of "
                             f"shape {shape} beside the tiles")
    _launch(PASS_LANE if whole else PASS_SUB, d, tiles, 0, k, n, None,
            None, limits, first, prev, counts, last, exits, sync, flagw,
            walked)


def bitset_walk(d: DeviceBitsetNFA, tiles, *args):
    """Pass 0 on the tiles' device (arguments as bitset_walk_plain's after
    the tiles): the kernel for CUDA tensors, counted on BITSET_KERNEL, the
    plain version for CPU tensors."""
    if tiles.device.type == "cuda":
        out = bitset_walk_cuda(d, tiles, *args)
        BITSET_KERNEL.launches += 1
        return out
    if tiles.device.type != "cpu":
        raise ValueError(f"unsupported device {tiles.device}")
    return bitset_walk_plain(d, tiles, *args)


def bitset_repair(d: DeviceBitsetNFA, whole: bool, tiles, *args):
    """One repair pass on the tiles' device (arguments as
    bitset_repair_plain's after the tiles)."""
    if tiles.device.type == "cuda":
        bitset_repair_cuda(d, whole, tiles, *args)
        BITSET_KERNEL.launches += 1
    elif tiles.device.type == "cpu":
        bitset_repair_plain(d, whole, tiles, *args)
    else:
        raise ValueError(f"unsupported device {tiles.device}")


# ---------------------------------------------------------------------------
# The settled scan
# ---------------------------------------------------------------------------

def first_inputs(d: DeviceBitsetNFA, data_u8, n: int, L: int, T: int,
                 W: int, k: int):
    """(entries [k, L, NW], offsets [L], limits [L], first [NW]) of a scan's
    pass 0 over k sub-lanes a lane: each sub-lane's warmup from x0 = its
    start - W enters with the start closure of boundary x0, in the context
    of bytes x0 - 1 and x0 (ref. :312-318); at x0 <= 0 with the text-start
    closure ``bot`` of byte 0's class, which is `first`, sub-lane (0, 0)'s
    exact entry (its offset W skips its warmup)."""
    dev = data_u8.device
    x0 = _sub_starts(L, T, k, dev) - W
    cls = torch.tensor(_CLS, dtype=torch.int64, device=dev)

    def cls_at(p):
        return cls[data_u8[p.clamp(0, n - 1)].long()]
    first = d.tables.botw[int(_cls3(int(data_u8[0])))]
    seed = d.tables.startw[d.tables.smap[cls_at(x0 - 1) * 4
                                         + cls_at(x0)].long()]
    entries = torch.where((x0 <= 0)[:, None], first[None, :], seed)
    offsets = torch.zeros(L, dtype=torch.int32, device=dev)
    offsets[0] = W
    limits = (n - torch.arange(L, dtype=torch.int64, device=dev) * T
              ).clamp(0, T).to(torch.int32)
    return (entries.reshape(k, L, d.NW).contiguous(), offsets, limits,
            first.contiguous())


def _unsettled(exits, sync, limits, first, T: int):
    k = int(exits.shape[0])
    real = sub_limits(limits, k, T // k).view(k, -1) > 0
    return real & (sync != _want(exits, first)).any(dim=2)


def bitset_full(d: DeviceBitsetNFA, data_u8, tiles, n: int, L: int, T: int,
                W: int, k: int) -> MatchScan:
    """The settled scan of n bytes under geometry (L, T, W) at k sub-lanes a
    lane: pass 0, then split_fixpoint's repair passes until every real
    sub-lane enters with its predecessor's exit.  Returns a MatchScan
    whose exits are the sub-lanes' exit sets [k, L, NW]; the flags, counts
    and last positions read as K9's (dfa_scan.flags_count_upto,
    flags_last, span_scan.to_global)."""
    entries, offsets, limits, first = first_inputs(d, data_u8, n, L, T, W, k)
    counts, exits, sync, flagw, last = bitset_walk(
        d, tiles, W // 4, entries, offsets, limits, n)

    def repair(whole, prev, out, walked):
        bitset_repair(d, whole, tiles, n, limits, first, prev, out, counts,
                      sync, flagw, last, walked)

    exits, conv = split_passes(BITSET_KERNEL, exits, repair, L + SUB_PASSES)
    if conv is None:
        conv = not bool(_unsettled(exits, sync, limits, first, T).any())
    settled(conv, "bitset scan")
    return MatchScan(flagw, counts, last, exits, n, L, T)


class BitsetNFAScanner:
    """Unanchored all-ends scan of one byte NFA, forward (match ends) or
    reverse over the flipped corpus (match starts) (ref. :342-372).
    Raises LookUnsupported out of scope, nullable patterns included."""

    def __init__(self, nfa: NFA, device):
        self.d = DeviceBitsetNFA(nfa, device)
        if self.d.nullable:
            # empty matches end everywhere; the candidate set degenerates
            raise LookUnsupported("nullable pattern")

    def scan_device(self, data_u8, geometry=None, tiles=None,
                    k=None) -> MatchScan:
        """The settled scan of a non-empty device corpus under geometry (L,
        T, W) (plan_geometry's when None) at k sub-lanes a lane
        (lane_split's when None); `tiles` are its word tiles (built when
        None)."""
        n = int(data_u8.shape[0])
        L, T, W = (geometry or plan_geometry(n))[:3]
        if k is None:
            k = lane_split(T, W)
        if tiles is None:
            tiles = make_word_tiles(data_u8, L, T // 4)
        return bitset_full(self.d, data_u8, tiles, n, L, T, W, k)

    def flags(self, data_u8, geometry=None, k=None) -> np.ndarray:
        """Host-facing: bool [n], flag p set iff a match ends at p + 1."""
        n = int(data_u8.shape[0])
        if n == 0:
            return np.zeros(0, dtype=bool)
        sc = self.scan_device(data_u8, geometry, k=k)
        words = to_global(sc.flagw, n).cpu().numpy()
        return np.unpackbits(words.view(np.uint8),
                             bitorder="little")[:n].astype(bool)

    def ends(self, data_u8) -> np.ndarray:
        """Sorted boundaries p in 1..n where some match ends (ref. ends,
        which also returns its converged flag: this scan always settles)."""
        return np.flatnonzero(self.flags(data_u8)).astype(np.int64) + 1
