"""Sharded exact Go count: the count transducer over a mesh of devices.

Ports ``coregex_tpu/parallel/sharded_count.py``: ``Phase1TooWide`` and
``PHASE1_STATE_LIMIT`` (:43-51), ``ShardedGoCount`` (:54-127) and
``ShardedPhaseProbe`` (:130-224).  The count transducer
(``dfa/countdfa.py``) turns Go's FindAll restart loop into one weighted
DFA, so its count distributes as a plain DFA scan does:

  phase 1 - each shard's (F, E) for all S entries, E[s] the matches the
            shard commits when entered in state s: the all-entries walk
            ``cgx_transfer_walk`` in MODE_COUNT over K1's count table
            (``ops/transfer_scan.py``), one launch for the shards that share
            a device;
  gather  - the [S] maps move to ``mesh.devices[0]``;
  phase 2 - the fold of the predecessors' F gives each shard's entry; the
            count is the sum of E[entry], with no rescan.

A corpus of n bytes is cut at the largest multiple of the mesh size; the
tail of fewer bytes than shards is walked on the host from the folded final
state, as the reference does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..dfa.countdfa import CountDFA
from ..dfa.dense import CTX_SOT
from ..ops.count_scan import DeviceCountDFA
from ..ops.transfer_scan import MODE_COUNT, transfer_maps
from .shard import Mesh, fold, gather_maps, place


class Phase1TooWide(Exception):
    """Phase 1 walks every one of the S entry states (S table lookups a
    byte); past PHASE1_STATE_LIMIT states the reference retires the sharded
    path for the single-device scan."""


# the reference's gate (its break-even against one device sits in the
# hundreds of states on its CPU mesh, docs/SCALING.md)
PHASE1_STATE_LIMIT = 512


def _host(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        return data.cpu().numpy()
    return np.asarray(data, dtype=np.uint8)


class ShardedGoCount:
    """Per-(pattern, mesh) sharded counter of the count transducer `cd`."""

    def __init__(self, cd: CountDFA, mesh: Mesh, axis: str = "data",
                 state_limit: int = PHASE1_STATE_LIMIT):
        if cd.num_states > state_limit:
            raise Phase1TooWide(f"{cd.num_states} states > {state_limit}")
        self.cd = cd
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.size
        self.sot = int(cd.starts[CTX_SOT])
        self._tables = {}

    def tables(self, device) -> DeviceCountDFA:
        """K1's count table on `device`, built once."""
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = DeviceCountDFA.from_host(self.cd,
                                                                device)
        return t

    def phase1(self, runs):
        """Each run's (F, E) [k, S] on its device."""
        out = []
        for dev, d0, d1, part in runs:
            t = self.tables(dev)
            out.append(transfer_maps(MODE_COUNT, t.packed, t.segmap, part,
                                     d1 - d0))
        return out

    def phase2(self, Fs, Es):
        """(the shards' count, the state after the last shard) as 0-dim
        tensors: the fold and E[entry] summed."""
        entries, fin = fold(Fs, self.sot)
        return Es.gather(1, entries[:, None]).sum(), fin

    def count(self, data) -> int:
        """Exact Go match count of `data`: a host uint8 array, or a 1-D
        uint8 tensor (on the mesh's first device, its shards are used in
        place)."""
        n = len(data)
        cd = self.cd
        if n == 0:
            return int(cd.eoi_commits[self.sot, CTX_SOT])
        cut = (n // self.ndev) * self.ndev
        if cut == 0:
            return cd.count_scan(_host(data))
        runs = place(self.mesh, data[:cut])
        Fs, Es = gather_maps(runs, self.phase1(runs), self.mesh.devices[0])
        total, s = (int(x) for x in torch.stack(self.phase2(Fs, Es)).tolist())
        # host tail: fewer bytes than shards, from the exact folded state
        for c in cd.classes[_host(data[cut:])]:
            total += int(cd.emit[s, c])
            s = int(cd.delta[s, c])
        return total + int(cd.eoi_commits[s, CTX_SOT])


class _Clock:
    """Seconds of a piece of work on a mesh's devices: CUDA events on every
    card after a synchronize (the longest of them), or the host clock on
    the CPU."""

    def __init__(self, devices):
        self.cuda = sorted({d for d in devices if d.type == "cuda"},
                           key=str)

    def __call__(self, fn):
        for d in self.cuda:
            torch.cuda.synchronize(d)
        if not self.cuda:
            t0 = time.perf_counter()
            out = fn()
            return time.perf_counter() - t0, out
        ev = []
        for d in self.cuda:
            with torch.cuda.device(d):
                a = torch.cuda.Event(enable_timing=True)
                a.record()
                ev.append((d, a))
        out = fn()
        spans = []
        for d, a in ev:
            with torch.cuda.device(d):
                b = torch.cuda.Event(enable_timing=True)
                b.record()
                spans.append((a, b))
        for d in self.cuda:
            torch.cuda.synchronize(d)
        return max(a.elapsed_time(b) for a, b in spans) / 1e3, out


class ShardedPhaseProbe:
    """The sharded count's three parts timed apart: phase 1 (the
    all-entries walks and their trees), the collective (the maps gathered
    on the first device) and phase 2 (the fold and the sum), for the
    reference's scaling model (docs/SCALING.md)."""

    def __init__(self, cd: CountDFA, mesh: Mesh, axis: str = "data"):
        self.counter = ShardedGoCount(cd, mesh, axis,
                                      state_limit=cd.num_states)
        self.mesh = mesh
        self.ndev = mesh.size

    def measure(self, data, reps: int = 3):
        """{phase: best seconds over reps} for one corpus cut to a multiple
        of the mesh, and "count": the matches of the cut part that its
        shards commit (no EOI commit, as the reference's probe)."""
        sc = self.counter
        cut = (len(data) // self.ndev) * self.ndev
        runs = place(self.mesh, data[:cut])
        clock = _Clock(self.mesh.devices)
        dev0 = self.mesh.devices[0]
        best = {"phase1_scan": float("inf"), "collective": float("inf"),
                "phase2_fold": float("inf")}
        for _ in range(max(1, reps)):
            t1, maps = clock(lambda: sc.phase1(runs))
            tg, (Fs, Es) = clock(lambda: gather_maps(runs, maps, dev0))
            t2, (tot, _fin) = clock(lambda: sc.phase2(Fs, Es))
            for k, t in (("phase1_scan", t1), ("collective", tg),
                         ("phase2_fold", t2)):
                best[k] = min(best[k], t)
        best["count"] = int(tot)
        return best
