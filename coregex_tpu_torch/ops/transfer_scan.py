"""The all-entries transfer walk: phase 1 of the sharded scans.

Ports the device loops of ``coregex_tpu/parallel/``: ``shard.py:37``
``_local_transfer_fn`` (a shard's transfer function F, F[s] = the state
after the shard when it is entered in state s) with the flag count of
``shard.py:47`` ``_local_flag_scan`` taken for every entry at once, and
``sharded_count.py:83`` (the count transducer's (F, E), E[s] = the matches
the shard commits when it is entered in state s; its probe's copy at
:162).  The reference steps an [S]-vector of states over its shard, one
gather a byte, in a ``lax.scan``; no Pallas kernel.

Here each of D shards splits into G pieces (``sub_lanes``), the kernel
``cgx_transfer_walk`` (``csrc/transfer_scan.cu``) gives every piece's map
from all S entries, and ``compose`` folds each shard's G maps in a
log-depth tree of torch gathers: F_ab[s] = F_b[F_a[s]], E_ab[s] = E_a[s] +
E_b[F_a[s]].  Both modes walk the lane walk's packed table (value =
delta*32 + emission over byte segments, summing v & 31): MODE_DFA takes
K9's match table (``dfa_scan.MatchTables``), whose emission is the match
flag, so E is each entry's flag total; MODE_COUNT takes K1's count table
(``count_scan.DeviceCountDFA``), whose emission is the transducer's emit.
One table build serves K1 or K9 and this walk.

The kernel does not walk S walkers a byte: walkers that reach one state
merge.  A warp takes a piece in SUB sub-pieces; it walks each sub-piece
from all S entries until, at a 16-byte chunk boundary, the entries that
are not in a silent state (``silent_states``: a state that every byte
leads back to, emitting nothing; the dead state is one) hold one state
(or at most MAX_REPS states, past the first EARLY bytes or where they
cost the warp no extra round of walks); each distinct state is then one
walker, a representative, that a lane walks to the sub-piece's end, and
each entry keeps its representative and the count it ran up before the
merge.  ``transfer_walk_merged`` is a plain model of
that bookkeeping for the tests.  The plain version, for CPU tensors,
walks every sub-piece from all S entries with ``count_scan._walk_plain``
and composes each piece's SUB maps with ``compose``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .count_scan import MODE_COUNT as _WALK_COUNT
from .count_scan import SMEM_LIMIT, LaunchCounter, _walk_plain, wide

MODE_DFA, MODE_COUNT = 0, 1
# launches of the walk in each mode: the counterparts of shard.py:37 and
# sharded_count.py:83
TRANSFER_KERNEL = LaunchCounter("transfer_walk")
TRANSFER_COUNT_KERNEL = LaunchCounter("transfer_count")
COUNTERS = (TRANSFER_KERNEL, TRANSFER_COUNT_KERNEL)

SUB = 32              # sub-pieces a piece: one a lane of the kernel's warp
WALKERS = 1 << 17     # sub-pieces (merged walkers) a launch aims at
MIN_SUB = 256         # fewest bytes a sub-piece takes while others have more
MAX_PIECE = 1 << 26   # a walker's 32-bit count holds 31 x 2^26
MAX_STATES = 512      # the kernel's limit, PHASE1_STATE_LIMIT's
# the kernel's merge rule (csrc/transfer_scan.cu, the same constants)
EARLY = 128           # bytes of a sub-piece before more than one walker
MAX_REPS = 8          # most walkers a sub-piece hands over
LATE = 256            # bytes between merge tests past EARLY
ITEMS = 128           # walkers a warp's worklist holds
BYTE_STATES = 128     # the kernel's byte-indexed table up to this S
MAX_WARPS = 16        # warps a block of the kernel, fewer where they
                      # do not fit shared memory


def sub_lanes(m: int, D: int, walkers: int = WALKERS) -> int:
    """Pieces G a shard of m bytes splits into so that D x G x SUB
    sub-pieces reach `walkers` (with walkers merged, about one a
    sub-piece, whatever the table's S), each sub-piece at least MIN_SUB
    bytes (G = 1 below that) and each piece at most MAX_PIECE."""
    g = min(-(-walkers // (SUB * D)), max(1, m // (SUB * MIN_SUB)))
    return max(g, -(-m // MAX_PIECE), 1)


def piece_len(m: int, G: int) -> int:
    """Bytes of a piece, a multiple of 16: pieces g * pl .. min((g + 1) *
    pl, m) - 1 of a shard, the last ones shorter or empty."""
    q = -(-m // G)
    return max(16, -(-q // 16) * 16)


def sub_len(pl: int) -> int:
    """Bytes of a sub-piece of a piece of pl bytes, a multiple of 16:
    sub-piece j holds the piece's bytes j * sl .. min((j + 1) * sl, len)
    - 1, the last ones shorter or empty."""
    return piece_len(pl, SUB)


def silent_states(packed) -> torch.Tensor:
    """bool [S]: the states s with packed[s, k] == s * 32 for every segment
    k, which no byte leaves and which emit nothing (the dead state is
    one)."""
    S = int(packed.shape[0])
    own = torch.arange(S, device=packed.device, dtype=packed.dtype) * 32
    return (packed == own[:, None]).all(1)


def smem_bytes(S: int, nseg: int, warps: int = 1) -> int:
    """Dynamic shared memory of a cgx_transfer_walk block of `warps` warps
    (the kernel takes up to MAX_WARPS, as many as fit): the segment map
    and the transposed table, where S <= BYTE_STATES the int16 table
    indexed by byte, the silent flags, and for each warp a worklist of
    ITEMS walkers (offset, state, exit, count), 32 compacted walkers'
    states and an owner array of S int16."""
    def pad8(x):
        return -(-x // 8) * 8
    return (pad8(4 * (256 + S * nseg))
            + (pad8(2 * 256 * S) if S <= BYTE_STATES else 0) + pad8(S)
            + warps * (ITEMS * 16 + 128 + pad8(2 * S)))


def walk_gate(S: int, nseg: int) -> bool:
    """Whether the walk takes an [S, nseg] table: at most MAX_STATES
    states (transfer_walk_cuda's gate) and a one-warp block within
    SMEM_LIMIT (_check's), on the CPU as on the card, so a caller can
    decline before it uploads anything."""
    return S <= MAX_STATES and smem_bytes(S, nseg) <= SMEM_LIMIT


def _check(packed, segmap, data, m: int, D: int, G: int) -> None:
    dev = data.device
    for name, t in (("packed", packed), ("segmap", segmap)):
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev}")
    if packed.dim() != 2 or tuple(segmap.shape) != (256,):
        raise ValueError("packed must be [S, NSEG] and segmap [256]")
    if data.dtype != torch.uint8 or data.dim() != 1 \
            or not data.is_contiguous():
        raise ValueError("data must be a contiguous 1-D uint8 tensor")
    if D < 1 or G < 1 or m < 0 or int(data.shape[0]) != D * m:
        raise ValueError(f"data of {int(data.shape[0])} bytes is not "
                         f"D = {D} shards of m = {m} bytes")
    if piece_len(m, G) > MAX_PIECE:
        raise ValueError(f"pieces of {piece_len(m, G)} bytes exceed "
                         f"{MAX_PIECE}")
    if smem_bytes(*(int(x) for x in packed.shape)) > SMEM_LIMIT:
        raise ValueError(f"packed table {tuple(packed.shape)} exceeds the "
                         f"shared-memory limit")


def _piece_bounds(m: int, D: int, G: int, dev):
    """Bytes [P] of each piece, and the piece and sub-piece lengths."""
    pl = piece_len(m, G)
    lens = (m - torch.arange(G, device=dev) * pl).clamp(0, pl).repeat(D)
    return lens, pl, sub_len(pl)


def transfer_walk_plain(packed, segmap, data, m: int, D: int, G: int):
    """(F, E) [D*G, S] int32 of every piece from every entry, as the kernel
    gives them: every sub-piece walked from all S entries at once, one
    torch step a byte (``count_scan._walk_plain`` over zero-padded
    sub-piece words), and each piece's SUB maps composed by ``compose``."""
    S, nseg = (int(x) for x in packed.shape)
    dev = data.device
    P = D * G
    lens, pl, sl = _piece_bounds(m, D, G, dev)
    # each shard zero-padded to G pieces, each piece to SUB sub-pieces:
    # words [sl / 4, P * SUB]
    pieces = torch.nn.functional.pad(data.view(D, m), (0, G * pl - m)) \
        .reshape(P, pl)
    words = torch.nn.functional.pad(pieces, (0, SUB * sl - pl)) \
        .reshape(P * SUB, sl).view(torch.int32).t().contiguous()
    sub_lens = (lens[:, None] - torch.arange(SUB, device=dev) * sl) \
        .clamp(0, sl).reshape(-1)
    walkers = P * SUB * S

    def word(t):
        return words[t][:, None].expand(P * SUB, S).reshape(walkers)

    cnt, fin, _, _ = _walk_plain(
        _WALK_COUNT, packed.reshape(-1).long(), segmap.long(), nseg, word,
        sl // 4, torch.arange(S, device=dev).repeat(P * SUB),
        sub_lens.repeat_interleave(S))
    F, E = compose(fin.reshape(P * SUB, S), cnt.reshape(P * SUB, S), P)
    return F.to(torch.int32), E.to(torch.int32)


def transfer_walk_merged(packed, segmap, data, m: int, D: int, G: int,
                         max_reps: int = MAX_REPS, early: int = EARLY,
                         late: int = LATE):
    """A plain model of the kernel's bookkeeping, for the tests; (F, E) as
    transfer_walk_plain.  Each sub-piece is walked from all S entries; at
    each 16-byte chunk boundary while fewer than `early` bytes are walked,
    and every `late` bytes after, the distinct states of the entries not
    in a silent state are counted, and when there are at most 1 (at most
    `max_reps` from `early` bytes on, or at once where they add no round
    to the walkers' walks) and the piece's worklist has room for them
    (ITEMS), each becomes a walker that walks on alone; an
    entry then keeps its walker and its count so far, one in a silent
    state its state.  Past 32 entries, a test that finds at most 32 live
    states, but too many to merge, walks those states on in their place
    (the kernel's one round a byte), each entry keeping which it joined.
    A sub-piece that never merges ends with every entry's own exit.  Each
    piece's map is then its sub-pieces' codes followed from every entry,
    through the walkers' exits and counts."""
    S, nseg = (int(x) for x in packed.shape)
    dev = data.device
    tbl, seg = packed.reshape(-1).long(), segmap.long()
    silent = silent_states(packed)
    lens, pl, sl = _piece_bounds(m, D, G, dev)
    F = torch.empty((D * G, S), dtype=torch.int64, device=dev)
    E = torch.empty_like(F)
    raw = data.tolist()

    def walk(s, c, lo, hi):
        for x in raw[lo:hi]:
            v = tbl[s * nseg + seg[x]]
            c = c + (v & 31)
            s = v >> 5
        return s, c

    def take(R, nitems, walked, rest):
        """Whether R walkers go on the worklist: one, or at most max_reps
        once `early` bytes are walked or where they add no round of 32 to
        the walks, as the `rest` sub-pieces to come would take one each."""
        rounds = -(-(nitems + R + rest) // 32)
        return nitems + R <= ITEMS and (R <= 1 or R <= max_reps and (
            walked >= early or rounds <= -(-(nitems + 1 + rest) // 32)))

    for p in range(D * G):
        lo = p // G * m + p % G * pl
        hi = lo + int(lens[p])
        work = []                # walkers: (state, start, end)
        codes = []               # per sub-piece: (code [S], count [S])
        nsub = -(-(hi - lo) // sl)
        for j, a in enumerate(range(lo, hi, sl)):
            b = min(a + sl, hi)
            # walkers: the entries, or once at most 32 of more than 32
            # entries are live, those states (lvl: each entry's walker, or
            # -1 - its silent state; c0: its count then)
            s = torch.arange(S, device=dev)
            c = torch.zeros(S, dtype=torch.int64, device=dev)
            lvl = c0 = None
            at, tested, code = a, a, None
            while at < b:
                end = min((at & ~15) + 16, b)
                s, c = walk(s, c, at, end)
                at = end
                if at == b or (at - a >= early and at - tested < late):
                    continue
                tested = at
                live = ~silent[s]
                reps, idx = torch.unique(s[live], return_inverse=True)
                if take(len(reps), len(work), at - a, nsub - 1 - j):
                    code = s.clone()
                    code[live] = -1 - (len(work) + idx)
                    work += [(int(r), at, b) for r in reps]
                    break
                if lvl is None and S > 32 and len(reps) <= 32:
                    lvl = -1 - s
                    lvl[live] = idx
                    s, c0, c = reps, c, torch.zeros_like(reps)
            code = s if code is None else code
            if lvl is not None:
                own = lvl >= 0
                i = lvl.clamp(min=0)
                code = torch.where(own, code[i], -1 - lvl)
                c = c0 + torch.where(own, c[i], 0)
            codes.append((code, c))
        fin, cnt = [], []
        for r, a, b in work:
            f, e = walk(torch.tensor(r), torch.tensor(0), a, b)
            fin.append(int(f))
            cnt.append(int(e))
        fin = torch.tensor(fin + [0], dtype=torch.int64, device=dev)
        cnt = torch.tensor(cnt + [0], dtype=torch.int64, device=dev)
        st = torch.arange(S, device=dev)
        tot = torch.zeros(S, dtype=torch.int64, device=dev)
        for code, c in codes:
            x, tot = code[st], tot + c[st]
            rep = x < 0
            i = torch.where(rep, -1 - x, len(fin) - 1)
            tot = tot + torch.where(rep, cnt[i], 0)
            st = torch.where(rep, fin[i], x)
        F[p], E[p] = st, tot
    return F.to(torch.int32), E.to(torch.int32)


def transfer_walk_cuda(packed, segmap, data, m: int, D: int, G: int):
    """Launch cgx_transfer_walk; transfer_walk_plain's outputs.  The
    kernel's scratch, each sub-piece's entry codes and counts, is [D*G*SUB,
    S] int32 twice."""
    _check(packed, segmap, data, m, D, G)
    if data.data_ptr() % 16:
        raise ValueError("the transfer walk reads 16-byte aligned data")
    S, nseg = (int(x) for x in packed.shape)
    if S > MAX_STATES:
        raise ValueError(f"{S} states exceed the walk's {MAX_STATES}")
    dev = data.device
    F = torch.empty((D * G, S), dtype=torch.int32, device=dev)
    E = torch.empty_like(F)
    if m == 0:
        F.copy_(torch.arange(S, dtype=torch.int32, device=dev))
        E.zero_()
        return F, E
    X = torch.empty((D * G * SUB, S), dtype=torch.int32, device=dev)
    Y = torch.empty_like(X)
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = _build.lib().cgx_transfer_walk(
            p(packed), S, nseg, p(segmap), p(data), m, piece_len(m, G), G,
            D, p(F), p(E), p(X), p(Y), _build.stream(dev))
    _build.check(rc, "transfer_walk")
    return F, E


def transfer_pieces(mode: int, packed, segmap, data, m: int, D: int,
                    G: int):
    """The pieces' maps on the data's device: the kernel for CUDA tensors
    (counted on the mode's counter), the plain version for CPU tensors."""
    if data.device.type == "cuda":
        out = transfer_walk_cuda(packed, segmap, data, m, D, G)
        COUNTERS[mode].launches += 1
        return out
    if data.device.type != "cpu":
        raise ValueError(f"unsupported device {data.device}")
    _check(packed, segmap, data, m, D, G)
    return transfer_walk_plain(packed, segmap, data, m, D, G)


def compose(F, E, D: int):
    """Each shard's map from its G pieces' maps in order: F, E [D*G, S]
    -> [D, S] (F int64, E int64), pairs composed level by level
    (F_ab[s] = F_b[F_a[s]], E_ab[s] = E_a[s] + E_b[F_a[s]]; an odd piece
    out passes to the next level)."""
    S = int(F.shape[1])
    F = F.reshape(D, -1, S).long()
    E = E.reshape(D, -1, S).long()
    while F.shape[1] > 1:
        h = F.shape[1] // 2
        fa, fb = F[:, 0:2 * h:2], F[:, 1:2 * h:2]
        ea, eb = E[:, 0:2 * h:2], E[:, 1:2 * h:2]
        f = torch.gather(fb, 2, fa)
        e = ea + torch.gather(eb, 2, fa)
        if F.shape[1] % 2:
            f = torch.cat([f, F[:, -1:]], dim=1)
            e = torch.cat([e, E[:, -1:]], dim=1)
        F, E = f, e
    return F[:, 0], E[:, 0]


def transfer_maps(mode: int, packed, segmap, data, D: int,
                  G: int = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F, E) [D, S] int64 of the D equal shards of `data` (1-D uint8 on
    one device), each walked from all S entries: pieces of G a shard
    (``sub_lanes`` when None), one walk, the tree.  `packed` may hold the
    lane walk's 16-bit values (``count_scan.packed_device``): the walk
    reads int32 ones."""
    packed = wide(packed)
    n = int(data.shape[0])
    if n % D:
        raise ValueError(f"{n} bytes do not split into {D} shards")
    m = n // D
    G = sub_lanes(m, D) if G is None else G
    F, E = transfer_pieces(mode, packed, segmap, data, m, D, G)
    return compose(F, E, D)
