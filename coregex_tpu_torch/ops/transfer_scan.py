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
``cgx_transfer_walk`` (``csrc/transfer_scan.cu``) walks every piece from
all S entries at once, and ``compose`` folds each shard's G maps in a
log-depth tree of torch gathers: F_ab[s] = F_b[F_a[s]], E_ab[s] = E_a[s] +
E_b[F_a[s]].  Both modes walk the lane walk's packed table (value =
delta*32 + emission over byte segments, summing v & 31): MODE_DFA takes
K9's match table (``dfa_scan.MatchTables``), whose emission is the match
flag, so E is each entry's flag total; MODE_COUNT takes K1's count table
(``count_scan.DeviceCountDFA``), whose emission is the transducer's emit.
One table build serves K1 or K9 and this walk.  The plain version, for CPU
tensors, walks all S entries of every piece with ``count_scan._walk_plain``
as ``count_scan._lane_entries`` composes exit maps.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .count_scan import MODE_COUNT as _WALK_COUNT
from .count_scan import LaunchCounter, _walk_plain, table_fits

MODE_DFA, MODE_COUNT = 0, 1
# launches of the walk in each mode: the counterparts of shard.py:37 and
# sharded_count.py:83
TRANSFER_KERNEL = LaunchCounter("transfer_walk")
TRANSFER_COUNT_KERNEL = LaunchCounter("transfer_count")
COUNTERS = (TRANSFER_KERNEL, TRANSFER_COUNT_KERNEL)

WALKERS = 1 << 19     # walkers a launch aims at: K1's 524,288
MIN_PIECE = 256       # fewest bytes a piece takes while others have more
MAX_PIECE = 1 << 26   # a walker's 32-bit count holds 31 x 2^26


def sub_lanes(S: int, m: int, D: int, walkers: int = WALKERS) -> int:
    """Pieces G a shard of m bytes splits into so that S x D x G walkers
    reach `walkers`, each piece at least MIN_PIECE bytes (G = 1 below
    that) and at most MAX_PIECE."""
    g = min(-(-walkers // (S * D)), max(1, m // MIN_PIECE))
    return max(g, -(-m // MAX_PIECE), 1)


def piece_len(m: int, G: int) -> int:
    """Bytes of a piece, a multiple of 16: pieces g * pl .. min((g + 1) *
    pl, m) - 1 of a shard, the last ones shorter or empty."""
    q = -(-m // G)
    return max(16, -(-q // 16) * 16)


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
    if not table_fits(*(int(x) for x in packed.shape)):
        raise ValueError(f"packed table {tuple(packed.shape)} exceeds the "
                         f"shared-memory limit")


def transfer_walk_plain(packed, segmap, data, m: int, D: int, G: int):
    """(F, E) [D*G, S] int32 of every piece from every entry, as the kernel
    gives them: one torch step a byte of a piece, all S x D x G walkers at
    once (``count_scan._walk_plain`` over zero-padded piece words)."""
    S, nseg = (int(x) for x in packed.shape)
    dev = data.device
    P, pl = D * G, piece_len(m, G)
    # each shard zero-padded to G pieces: words [pl / 4, P]
    words = torch.nn.functional.pad(data.view(D, m), (0, G * pl - m)) \
        .reshape(P, pl).view(torch.int32).t().contiguous()
    lens = (m - torch.arange(G, device=dev) * pl).clamp(0, pl)
    walkers = P * S

    def word(t):
        return words[t][:, None].expand(P, S).reshape(walkers)

    cnt, fin, _, _ = _walk_plain(
        _WALK_COUNT, packed.reshape(-1).long(), segmap.long(), nseg, word,
        pl // 4, torch.arange(S, device=dev).repeat(P),
        lens.repeat(D).repeat_interleave(S))
    return (fin.to(torch.int32).reshape(P, S),
            cnt.to(torch.int32).reshape(P, S))


def transfer_walk_cuda(packed, segmap, data, m: int, D: int, G: int):
    """Launch cgx_transfer_walk; transfer_walk_plain's outputs."""
    _check(packed, segmap, data, m, D, G)
    if data.data_ptr() % 16:
        raise ValueError("the transfer walk reads 16-byte aligned data")
    S, nseg = (int(x) for x in packed.shape)
    dev = data.device
    F = torch.empty((D * G, S), dtype=torch.int32, device=dev)
    E = torch.empty_like(F)
    if m == 0:
        F.copy_(torch.arange(S, dtype=torch.int32, device=dev))
        E.zero_()
        return F, E
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = _build.lib().cgx_transfer_walk(
            p(packed), S, nseg, p(segmap), p(data), m, piece_len(m, G), G,
            D, p(F), p(E), _build.stream(dev))
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
    (``sub_lanes`` when None), one walk, the tree."""
    n = int(data.shape[0])
    if n % D:
        raise ValueError(f"{n} bytes do not split into {D} shards")
    m = n // D
    S = int(packed.shape[0])
    G = sub_lanes(S, m, D) if G is None else G
    F, E = transfer_pieces(mode, packed, segmap, data, m, D, G)
    return compose(F, E, D)
