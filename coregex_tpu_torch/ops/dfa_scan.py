"""Host table prep of a dense DFA for the device scans.

Ports the table prep of ``coregex_tpu/ops/dfa_scan.py:DeviceDFA.from_dense``
(:84-120): transition and match tables expanded from byte classes to byte
SEGMENTS (maximal byte ranges of constant class) and padded to power-of-two
buckets, with the segment boundaries padded to a bucket with 256s.  Only
what the reset flag scan reads is kept: the reference's ``comb`` onehot
table serves only the TPU's matmul scan, and its EOI and byte-class tables
serve scans not ported yet.  The arrays stay numpy; consumers upload what
they use.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..dfa.dense import DenseDFA
from .bytescan import _bucket


@dataclass
class DFATables:
    delta: np.ndarray        # [SP, CP] int32 (segment columns, padded)
    match_on: np.ndarray     # [SP, CP] bool
    bounds: np.ndarray       # [NB] int32 segment boundaries, padded with 256
    host_starts: np.ndarray  # [4]

    @classmethod
    def from_dense(cls, dfa: DenseDFA) -> "DFATables":
        S, _C0 = dfa.delta.shape
        classes = dfa.classes
        bounds = [b for b in range(1, 256) if classes[b] != classes[b - 1]]
        nseg = len(bounds) + 1
        seg_cls = np.asarray([classes[b] for b in [0] + bounds],
                             dtype=np.int64)
        SP, CP = _bucket(S, 8), _bucket(nseg, 4)
        delta = np.zeros((SP, CP), dtype=np.int32)
        match = np.zeros((SP, CP), dtype=bool)
        delta[:S, :nseg] = dfa.delta[:, seg_cls]
        match[:S, :nseg] = dfa.match_on[:, seg_cls]
        NB = _bucket(max(len(bounds), 1), 4)
        bpad = np.full(NB, 256, dtype=np.int32)
        bpad[:len(bounds)] = bounds
        return cls(delta=delta, match_on=match, bounds=bpad,
                   host_starts=np.asarray(dfa.starts))
