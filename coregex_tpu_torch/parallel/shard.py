"""Corpus sharding over a mesh of torch devices: the two-phase exact scan.

Ports ``coregex_tpu/parallel/shard.py``: ``make_sharded_count`` (:56-103),
``make_sharded_flags`` (:106-138), ``make_sharded_ends`` (:141-187),
``default_mesh`` (:190-195), ``pad_and_stack`` (:202-224) and
``make_sharded_multi_count`` (:227-272).  The reference's mesh is a
``jax.sharding.Mesh`` and its programs ``shard_map`` bodies; here ``Mesh``
is a list of torch devices, in which a device may repeat: a *virtual* mesh,
several shards on one card, the counterpart of the reference's
``--xla_force_host_platform_device_count``.

  phase 1 - each shard's transfer function F (F[s] = the state after the
            shard when it is entered in state s) and, for every entry, the
            flag total E[s], from one all-entries walk
            (``ops/transfer_scan.py``, the kernel ``cgx_transfer_walk`` in
            MODE_DFA); the shards that share a device share one launch;
  gather  - the shards' [S] maps move to ``mesh.devices[0]``;
  fold    - shard d's exact entry is F_{d-1}(... F_0(sot)) (the reference's
            fold, :78-83).

The count is then the entries' flag totals plus the EOI flag at the final
state, counted once (the reference rescans each shard from its entry to
count its flags, :47; phase 1 already holds every entry's total).  Flags
and ends rescan each shard from its folded entry with K9
(``dfa_scan.match_full``'s settled scan, sub-lane (0, 0) entered at that
state rather than at sot), and ends compact each shard's flags with K8
(``ops/compact.py`` ``compact_positions``) into a buffer of `cap`
positions.  The reference's programs are jitted; the port's run eagerly.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dfa.dense import CTX_SOT, DEAD
from ..ops.compact import compact_positions
from ..ops.count_scan import (MODE_MATCH, SUB_PASSES, first_pass_inputs,
                              lane_split, make_word_tiles, plan_geometry,
                              settled, split_fixpoint)
from ..ops.dfa_scan import MATCH_KERNEL, DFATables, MatchTables
from ..ops.span_scan import to_global
from ..ops.transfer_scan import MODE_DFA, transfer_maps


def _normal(device) -> torch.device:
    """A device with its index ("cuda" -> "cuda:<current>")."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D mesh of torch devices along `axis`, one corpus shard a device
    in order.  A device may appear several times (a virtual mesh).
    ``shape[axis]`` is the number of shards, as the reference's tests read
    it; ``process_count`` and ``process_index`` place this process's
    devices in a multi-process world (``parallel/distributed.py``)."""

    def __init__(self, devices: Sequence, axis: str = "data",
                 process_count: int = 1, process_index: int = 0):
        self.devices = tuple(_normal(d) for d in devices)
        self.axis = axis
        self.process_count = process_count
        self.process_index = process_index
        self.shape = {axis: len(self.devices) * process_count}

    @property
    def size(self) -> int:
        """Shards this process holds."""
        return len(self.devices)

    def runs(self) -> List[Tuple[torch.device, int, int]]:
        """(device, d0, d1): the runs of consecutive shards on one device."""
        out = []
        for d, dev in enumerate(self.devices):
            if out and out[-1][0] == dev:
                out[-1] = (dev, out[-1][1], d + 1)
            else:
                out.append((dev, d, d + 1))
        return out

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis!r})"


def default_mesh(n_devices: Optional[int] = None, device=None,
                 axis: str = "data") -> Mesh:
    """The visible devices of `device`'s type (CUDA when None): every
    CUDA device, or the one CPU device; the first n_devices of them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, axis)


Run = Tuple[torch.device, int, int, torch.Tensor]


def place(mesh: Mesh, data) -> List[Run]:
    """(device, d0, d1, bytes) for each run of the mesh: shards d0 .. d1-1
    of `data` (a host uint8 array or a 1-D uint8 tensor of mesh.size
    equal shards), contiguous and 16-byte aligned on the run's device.
    Bytes already there are used in place where they are aligned."""
    n = len(data)
    D = mesh.size
    if D < 1 or n % D:
        raise ValueError(f"a corpus of {n} bytes does not split into {D} "
                         f"equal shards")
    m = n // D
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.require(data, np.uint8, ["C", "W"]))
    out = []
    for dev, d0, d1 in mesh.runs():
        part = data[d0 * m:d1 * m]
        if part.device != dev or not part.is_contiguous():
            part = part.to(dev, copy=True).contiguous()
        elif dev.type == "cuda" and part.data_ptr() % 16:
            part = part.clone()
        out.append((dev, d0, d1, part))
    return out


def fold(Fs, first: int):
    """(entries [D] int64, final state) of D shards in order from state
    `first`: entries[0] = first, entries[d + 1] = Fs[d][entries[d]], the
    final state Fs[D - 1][entries[D - 1]] (the reference's fold)."""
    e = torch.full((), first, dtype=torch.int64, device=Fs.device)
    entries = []
    for d in range(int(Fs.shape[0])):
        entries.append(e)
        e = Fs[d, e]
    return torch.stack(entries), e


def gather_maps(runs: List[Run], maps, device):
    """Each run's (F, E) [k, S] moved to `device` and stacked in shard
    order: (Fs, Es) [D, S]."""
    Fs = torch.cat([F.to(device) for F, _ in maps])
    Es = torch.cat([E.to(device) for _, E in maps])
    return Fs, Es


class _Tables:
    """A DFA's match tables on each device of a mesh, built once each."""

    def __init__(self, tables: DFATables):
        self.tables = tables
        self._on = {}

    def on(self, device) -> MatchTables:
        mt = self._on.get(device)
        if mt is None:
            mt = self._on[device] = MatchTables(self.tables, device)
        return mt


def phase1(tb: _Tables, runs: List[Run], device):
    """Phase 1 and the gather: every shard's (F, E) [D, S] on `device`
    (one all-entries walk a run)."""
    maps = []
    for dev, d0, d1, part in runs:
        mt = tb.on(dev)
        maps.append(transfer_maps(MODE_DFA, mt.packed, mt.segmap, part,
                                  d1 - d0))
    return gather_maps(runs, maps, device)


def sharded_total(tb: _Tables, Fs, Es) -> torch.Tensor:
    """Every shard's flags from its folded entry plus the EOI flag at the
    final state: a 0-dim int64 tensor on Fs's device."""
    mt = tb.on(Fs.device)
    entries, fin = fold(Fs, mt.sot)
    return (Es.gather(1, entries[:, None]).sum()
            + mt.eoi[fin, CTX_SOT].long())


def make_sharded_count(mesh: Mesh, tables: DFATables, axis: str = "data",
                       vector_out: bool = False):
    """fn(data) -> the all-match-ends count (an int) of a corpus of n bytes,
    n divisible by the mesh size (a host uint8 array, or a uint8 tensor).
    `vector_out` returns a [D] int64 tensor on ``mesh.devices[0]`` whose
    every entry is the total, as the reference's per-shard vector."""
    tb = _Tables(tables)
    dev0 = mesh.devices[0]

    def run(data):
        if len(data) == 0:
            mt = tb.on(dev0)
            total = mt.eoi[mt.sot, CTX_SOT].long()
        else:
            total = sharded_total(tb, *phase1(tb, place(mesh, data), dev0))
        if vector_out:
            return total.expand(mesh.size).clone()
        return int(total)

    return run


def shard_flags(mt: MatchTables, part, entry: int):
    """The match flags [m] bool of one shard's bytes `part` from its exact
    entry state: K9's settled scan (``dfa_scan.match_full``) with sub-lane
    (0, 0) entered at `entry`, its flag words unpacked."""
    m = int(part.shape[0])
    if m == 0:
        return torch.zeros(0, dtype=torch.bool, device=part.device)
    L, T, W, _ = plan_geometry(m)
    k = lane_split(T, W)
    tiles = make_word_tiles(part, L, T // 4)
    entries, offsets, limits = first_pass_inputs(mt.starts, part, m, L, T, W,
                                                 k)
    entries[0, 0] = entry
    at = SimpleNamespace(packed=mt.packed, segmap=mt.segmap, sot=entry)
    (_c, _ex, _sync, fw, _last), conv = split_fixpoint(
        MODE_MATCH, MATCH_KERNEL, at, tiles, W, entries, offsets, limits,
        L + SUB_PASSES, dead=DEAD)
    settled(conv, "sharded match scan")
    words = to_global(fw, m).contiguous().view(torch.uint8)
    bit = torch.arange(8, dtype=torch.uint8, device=part.device)
    return ((words[:, None] >> bit) & 1).reshape(-1)[:m].bool()


def _shard_entries(tb: _Tables, runs: List[Run], dev0) -> List[int]:
    """Every shard's exact entry state (phase 1, the gather, the fold; one
    sync)."""
    Fs, _Es = phase1(tb, runs, dev0)
    entries, _fin = fold(Fs, tb.on(dev0).sot)
    return entries.tolist()


def _each_shard(tb: _Tables, runs: List[Run], entries: List[int]):
    """(d, m, device, the shard's flags [m] bool) in shard order."""
    for dev, d0, d1, part in runs:
        m = int(part.shape[0]) // (d1 - d0)
        for d in range(d0, d1):
            yield d, m, dev, shard_flags(tb.on(dev), part[(d - d0) * m:
                                                          (d - d0 + 1) * m],
                                         entries[d])


def make_sharded_flags(mesh: Mesh, tables: DFATables, axis: str = "data"):
    """fn(data) -> the match-end flag mask [n] bool on ``mesh.devices[0]``
    (flag j: a match ends after byte j; the EOI flag is not included), n
    divisible by the mesh size."""
    tb = _Tables(tables)
    dev0 = mesh.devices[0]

    def run(data):
        if len(data) == 0:
            return torch.zeros(0, dtype=torch.bool, device=dev0)
        runs = place(mesh, data)
        entries = _shard_entries(tb, runs, dev0)
        return torch.cat([f.to(dev0) for _d, _m, _dev, f in
                          _each_shard(tb, runs, entries)])

    return run


def make_sharded_ends(mesh: Mesh, tables: DFATables, cap: int,
                      axis: str = "data"):
    """fn(data) -> (positions [D*cap] int32, counts [D] int32) on
    ``mesh.devices[0]``: each shard's flag offsets as global positions,
    ascending, in its own buffer of `cap` slots padded with D*m, and its
    full flag count (a count above cap: that shard overflowed and the
    caller falls back).  n must be divisible by the mesh size; positions
    past a caller's zero padding are the caller's to drop."""
    tb = _Tables(tables)
    dev0 = mesh.devices[0]
    D = mesh.size

    def run(data):
        n = len(data)
        if n == 0:
            return (torch.zeros(D * cap, dtype=torch.int32, device=dev0),
                    torch.zeros(D, dtype=torch.int32, device=dev0))
        runs = place(mesh, data)
        entries = _shard_entries(tb, runs, dev0)
        pos, cnt = [], []
        for d, m, dev, flags in _each_shard(tb, runs, entries):
            idx, c = compact_positions(flags, cap)
            del flags
            pos.append(torch.where(idx < m, idx + d * m, D * m).to(
                torch.int32).to(dev0))
            cnt.append(c.reshape(1).to(dev0))
        return torch.cat(pos), torch.cat(cnt)

    return run


# ---------------------------------------------------------------------------
# Several patterns at once: corpus shards x patterns
# ---------------------------------------------------------------------------

def pad_and_stack(tables: Sequence[DFATables]):
    """Several patterns' tables stacked and zero-padded to one shape:
    (delta [P, S, NSEG] int32, match_on [P, S, NSEG] bool, match_eoi
    [P, S, 4] bool, starts [P, 4] int32, segmap [P, 256] int32) as numpy
    arrays, over each pattern's byte segments (the reference stacks class
    tables, :202-224)."""
    S = max(t.packed.shape[0] for t in tables)
    NSEG = max(t.packed.shape[1] for t in tables)
    P = len(tables)
    delta = np.zeros((P, S, NSEG), dtype=np.int32)
    match_on = np.zeros((P, S, NSEG), dtype=bool)
    match_eoi = np.zeros((P, S, 4), dtype=bool)
    starts = np.zeros((P, 4), dtype=np.int32)
    segmap = np.zeros((P, 256), dtype=np.int32)
    for i, t in enumerate(tables):
        s, c = t.packed.shape
        delta[i, :s, :c] = t.packed >> 5
        match_on[i, :s, :c] = (t.packed & 1).astype(bool)
        match_eoi[i, :s] = t.match_eoi
        starts[i] = t.host_starts
        segmap[i] = t.segmap
    return delta, match_on, match_eoi, starts, segmap


def make_sharded_multi_count(mesh: Mesh, stacked, num_states: int,
                             data_axis: str = "data",
                             pattern_axis: str = "pattern"):
    """fn(data) -> the per-pattern match-end counts [P] int64 on
    ``mesh.devices[0]`` of a corpus sharded over the mesh, from
    ``pad_and_stack``'s tables: each pattern's phase 1, gather and fold as
    ``make_sharded_count``'s (the reference shards the patterns over a
    second mesh axis; here they take turns on the data axis)."""
    delta, match_on, match_eoi, starts, segmap = stacked
    P = int(delta.shape[0])
    if num_states < int(delta.shape[1]):
        raise ValueError(f"stacked tables hold {int(delta.shape[1])} "
                         f"states, more than {num_states}")
    per = []
    for i in range(P):
        t = DFATables(delta=delta[i], match_on=match_on[i], bounds=None,
                      host_starts=starts[i], match_eoi=match_eoi[i],
                      packed=delta[i] * 32 + match_on[i].astype(np.int32),
                      segmap=segmap[i])
        per.append(_Tables(t))
    dev0 = mesh.devices[0]

    def run(data):
        runs = place(mesh, data)
        return torch.stack([sharded_total(tb, *phase1(tb, runs, dev0))
                            for tb in per])

    return run
